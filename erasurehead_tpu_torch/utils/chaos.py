"""Straggler-regime injection armed by an environment variable.

The regime part of erasurehead_tpu/utils/chaos.py: a deterministic mid-run
straggler-regime change (parallel/straggler.RegimeShift), read by
train/trainer.default_arrivals. Not a fault (nothing crashes), but it makes
non-stationary straggling reproducible for tests and runs. The fault sites
of the JAX module (kills and raises at named sites) are not ported yet.
"""

from __future__ import annotations

import os

#: env var arming a straggler-regime shift
#: (``kind:round[:param[:param2]]``): ``heavytail:50[:alpha]`` switches
#: the delay stream from exponential to Pareto(alpha)-tailed at round 50;
#: ``adversary:50[:worker[:slowdown]]`` turns one worker adversarially
#: slow from round 50 (arXiv:1901.08166's fixed-straggler worst case);
#: ``targeted:50[:group[:slowdown]]`` slows EVERY replica of one coded
#: partition group at once, the fractional-repetition worst case of the
#: same paper (the attacked workers come from the run's layout in
#: trainer.default_arrivals; see straggler.targeted_workers). Unset, arrival
#: schedules are the stationary stream.
REGIME_ENV = "ERASUREHEAD_REGIME"


def parse_regime(spec: str):
    """Parse :data:`REGIME_ENV`; loud on malformed specs (a typo'd regime
    run silently staying stationary would invalidate the experiment)."""
    from erasurehead_tpu_torch.parallel.straggler import RegimeShift

    parts = spec.split(":")
    if len(parts) < 2:
        raise ValueError(
            f"{REGIME_ENV}={spec!r}: want kind:round[:param[:param2]]"
        )
    kind = parts[0]
    try:
        rnd = int(parts[1])
    except ValueError:
        raise ValueError(
            f"{REGIME_ENV}={spec!r}: round must be an int"
        ) from None
    if kind == "heavytail":
        alpha = float(parts[2]) if len(parts) > 2 else 1.2
        return RegimeShift(kind=kind, round=rnd, alpha=alpha)
    if kind == "adversary":
        worker = int(parts[2]) if len(parts) > 2 else 0
        slowdown = float(parts[3]) if len(parts) > 3 else 5.0
        return RegimeShift(
            kind=kind, round=rnd, worker=worker, slowdown=slowdown
        )
    if kind == "targeted":
        group = int(parts[2]) if len(parts) > 2 else 0
        slowdown = float(parts[3]) if len(parts) > 3 else 5.0
        return RegimeShift(
            kind=kind, round=rnd, group=group, slowdown=slowdown
        )
    raise ValueError(
        f"{REGIME_ENV}={spec!r}: kind must be heavytail|adversary|targeted"
    )


def active_regime():
    """The armed RegimeShift, or None when the env var is unset."""
    spec = os.environ.get(REGIME_ENV)
    return parse_regime(spec) if spec else None
