"""What-if surfaces: the reduced expected-time-to-target artifact.

The port's part of erasurehead_tpu/whatif/: :mod:`surface` (save, load and
the adapt bandit's cold-start priors). The grid spec, the arrival sampler and
the engine that build surfaces are not ported yet (ROADMAP queue A).
"""

from erasurehead_tpu_torch.whatif.surface import Surface

__all__ = ["Surface"]
