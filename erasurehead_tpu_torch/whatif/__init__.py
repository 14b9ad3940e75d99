"""What-if engine: Monte-Carlo policy search over the scheme x regime grid.

The port of erasurehead_tpu/whatif/. The simulator already batches
trajectories (trainer.train_cohort) and the scheme registry makes every
collection policy a data object; this package composes them into a
policy-search engine:

  - :mod:`spec` enumerates (scheme, W, s, num_collect, deadline, decode,
    arrival-regime) grid points from registry descriptors, with
    per-point feasibility filtered through each descriptor's own config
    validation (infeasible points are recorded with a reason, never
    dispatched);
  - :mod:`sampler` draws seeded arrival times on the device in one batched
    threefry pass (exp / heavytail / adversary / targeted regimes, plus
    trace replay), so one cohort dispatch simulates many (policy, seed)
    trajectories;
  - :mod:`engine` groups grid points into cohort dispatches through the
    sweep engine and reduces trajectories into expected-time-to-target
    surfaces;
  - :mod:`surface` holds the reduced artifact (.npz + JSONL rows, byte-equal
    to the JAX package's): the ErasureHead Fig. 4-6 family from
    simulation alone, and the adapt/ bandit's cold-start priors.

Entry point: ``python -m erasurehead_tpu_torch.cli whatif`` (engine.main).
"""

from erasurehead_tpu_torch.whatif.sampler import RegimeSpec, sample_arrivals
from erasurehead_tpu_torch.whatif.spec import (
    GridPoint,
    GridSpec,
    PolicySpec,
    enumerate_points,
)
from erasurehead_tpu_torch.whatif.surface import Surface
from erasurehead_tpu_torch.whatif.engine import run_whatif

__all__ = [
    "GridPoint",
    "GridSpec",
    "PolicySpec",
    "RegimeSpec",
    "Surface",
    "enumerate_points",
    "run_whatif",
    "sample_arrivals",
]
