"""Straggler injection: seeded per-iteration arrival-delay schedules.

The reference injects stragglers by making every worker sleep an
Exponential(mean 0.5 s) delay, with numpy's global RNG re-seeded to the
iteration index so the whole delay matrix is deterministic and identical on
every rank (src/naive.py:140-149). Here straggling enters as a simulated
*arrival time* per (round, worker), drawn from the same MT19937 streams, so
the matrix matches the reference (and the JAX package) bit for bit.

This is the stationary subset of erasurehead_tpu/parallel/straggler.py:
recorded-trace replay and mid-run regime shifts are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def reference_delay_schedule(
    rounds: int, n_workers: int, mean: float = 0.5, seed_offset: int = 0
) -> np.ndarray:
    """[rounds, n_workers] delay matrix, bit-exact with the reference:
    ``np.random.RandomState(i).exponential(mean, n_workers)`` for round i
    (src/naive.py:141-147)."""
    out = np.empty((rounds, n_workers))
    for i in range(rounds):
        out[i] = np.random.RandomState(i + seed_offset).exponential(
            mean, n_workers
        )
    return out


@dataclasses.dataclass(frozen=True)
class ArrivalModel:
    """Turns injected delays into per-(round, worker) arrival times:
    arrival = compute_time * worker_speed + delay. The default (compute time
    0) is the reference's pure-delay regime."""

    compute_time: float = 0.0
    worker_speed: np.ndarray | None = None  # [W] multiplier on compute_time

    def arrivals(self, delays: np.ndarray) -> np.ndarray:
        base = self.compute_time
        if self.worker_speed is not None:
            base = self.compute_time * np.asarray(self.worker_speed)[None, :]
        return np.asarray(delays) + base


def arrival_schedule(
    rounds: int,
    n_workers: int,
    add_delay: bool,
    mean: float = 0.5,
    arrival_model: ArrivalModel | None = None,
) -> np.ndarray:
    """The full [rounds, W] arrival-time matrix for a run.

    With ``add_delay=False`` the reference's workers reply with no injected
    sleep; that is all-zero arrivals, with ties broken by worker index in the
    collection rules."""
    if add_delay:
        delays = reference_delay_schedule(rounds, n_workers, mean)
    else:
        delays = np.zeros((rounds, n_workers))
    model = arrival_model or ArrivalModel()
    return model.arrivals(delays)
