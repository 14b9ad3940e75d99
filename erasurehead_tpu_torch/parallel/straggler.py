"""Straggler injection: seeded per-iteration arrival-delay schedules.

The reference injects stragglers by making every worker sleep an
Exponential(mean 0.5 s) delay, with numpy's global RNG re-seeded to the
iteration index so the whole delay matrix is deterministic and identical on
every rank (src/naive.py:140-149). Here straggling enters as a simulated
*arrival time* per (round, worker), drawn from the same MT19937 streams, so
the matrix matches the reference (and the JAX package,
erasurehead_tpu/parallel/straggler.py) bit for bit.

Beyond the stationary stream, as in the JAX package: a heterogeneous
cluster (:class:`ArrivalModel`, :func:`model_from_config`: a compute time
and a seeded per-worker speed spread), a deterministic mid-run regime shift
(:class:`RegimeShift`: heavy-tailed delays, one adversarial worker, or a
targeted attack on one coded partition group), and the replay of a
recorded arrival trace (:func:`load_arrival_trace`,
:func:`replay_arrival_trace`). All of it is host float64 numpy.
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


def model_from_config(cfg) -> "ArrivalModel | None":
    """ArrivalModel for a RunConfig's heterogeneity fields (None when the
    config is in the reference's pure-delay regime)."""
    if not cfg.compute_time and not cfg.worker_speed_spread:
        return None
    speed = None
    if cfg.worker_speed_spread:
        rng = np.random.default_rng(cfg.seed + 10_007)
        s = float(cfg.worker_speed_spread)
        speed = rng.uniform(1.0 - s, 1.0 + s, cfg.n_workers)
    return ArrivalModel(compute_time=cfg.compute_time, worker_speed=speed)


@dataclasses.dataclass(frozen=True)
class RegimeShift:
    """A deterministic mid-run change of the straggler regime.

    The reference's delay model is stationary (the same Exponential(0.5)
    stream every round); the worst-case analyses the retrieved papers run
    are not — "Fundamental Limits of Approximate Gradient Coding"
    (arXiv:1901.08166) shows the cost of straggling concentrates in
    adversarial/non-stationary patterns. Three kinds:

      - ``"heavytail"``: Exponential(mean) delays through round
        ``round``-1, then Pareto(``alpha``)-tailed delays (seeded per
        round like the reference's own stream, so the whole matrix stays
        deterministic and shared across schemes). Small ``alpha`` =
        heavier tail; alpha <= 1 has infinite mean — every round pays
        some worker's catastrophic delay.
      - ``"adversary"``: from round ``round`` on, worker ``worker`` turns
        adversarially slow (+``slowdown`` simulated seconds on top of its
        drawn delay) — the fixed-straggler worst case of 1901.08166,
        where any scheme that must hear from that worker stalls every
        round.
      - ``"targeted"``: from round ``round`` on, EVERY replica of coded
        partition group ``group`` turns slow at once (+``slowdown`` each)
        — 1901.08166's worst case for fractional-repetition codes, where
        replication buys nothing because the adversary slows the whole
        replica set instead of one worker. The attacked worker set is
        derived from the run's layout (:func:`targeted_workers`: all
        workers holding partition ``group`` — for FRC exactly the
        partition's repetition group), so the same ``slowdown`` budget
        spread over unrelated workers leaves every group a fast member
        while the targeted form stalls one group every round.

    The adaptive controller (adapt/) reacts to these: a policy tuned to
    the pre-shift regime stops being the best arm at ``round``.
    """

    kind: str  # "heavytail" | "adversary" | "targeted"
    round: int  # first round of the new regime
    alpha: float = 1.2  # heavytail: Pareto tail index
    worker: int = 0  # adversary: which worker turns slow
    slowdown: float = 5.0  # adversary/targeted: extra seconds per round
    group: int = 0  # targeted: which coded partition group is attacked

    def __post_init__(self):
        if self.kind not in ("heavytail", "adversary", "targeted"):
            raise ValueError(
                f"regime kind must be heavytail/adversary/targeted, "
                f"got {self.kind!r}"
            )
        if self.round < 0:
            raise ValueError(f"regime round must be >= 0, got {self.round}")
        if self.kind == "heavytail" and self.alpha <= 0:
            raise ValueError(f"heavytail alpha must be > 0, got {self.alpha}")
        if self.kind in ("adversary", "targeted") and self.slowdown < 0:
            raise ValueError(
                f"{self.kind} slowdown must be >= 0, got {self.slowdown}"
            )
        if self.kind == "targeted" and self.group < 0:
            raise ValueError(
                f"targeted group must be >= 0, got {self.group}"
            )


#: seed offset separating the post-shift heavy-tail stream from the
#: reference's own exponential stream (which seeds RandomState(i))
_REGIME_SEED_BASE = 104_729


def targeted_workers(layout, group: int) -> tuple[int, ...]:
    """The worker set a ``"targeted"`` regime attacks: every worker
    holding partition ``group % P`` of ``layout`` — for fractional
    repetition exactly the members of that partition's repetition group
    (all its replicas, the pattern arXiv:1901.08166 proves worst-case for
    FRC), and for any other layout the partition's full replica set."""
    assignment = np.asarray(layout.assignment)
    p = int(group) % int(layout.n_partitions)
    workers = np.flatnonzero((assignment == p).any(axis=1))
    if workers.size == 0:
        raise ValueError(
            f"targeted regime: no worker holds partition {p} of layout "
            f"{layout.name!r} — nothing to attack"
        )
    return tuple(int(w) for w in workers)


def apply_regime_shift(
    delays: np.ndarray,
    shift: RegimeShift,
    mean: float = 0.5,
    workers=None,
) -> np.ndarray:
    """Rewrite a [R, W] delay matrix's rounds >= shift.round per the shift
    (deterministic: heavy-tail rounds re-seed per round exactly like
    :func:`reference_delay_schedule`, so every scheme in a paired sweep
    sees the identical shifted stream). ``workers`` is the resolved
    attacked set for the ``"targeted"`` kind (:func:`targeted_workers` —
    the caller resolves it because only the caller holds the layout)."""
    out = np.array(delays, dtype=np.float64, copy=True)
    R, W = out.shape
    r0 = min(max(int(shift.round), 0), R)
    if shift.kind == "heavytail":
        for i in range(r0, R):
            rs = np.random.RandomState(_REGIME_SEED_BASE + i)
            # Pareto(alpha) - shifted to start at 0, scaled so the
            # pre-shift mean survives as the scale unit; alpha near 1
            # makes the per-round max routinely 10-100x the mean
            out[i] = mean * rs.pareto(shift.alpha, W)
    elif shift.kind == "adversary":
        out[r0:, shift.worker % W] += shift.slowdown
    elif shift.kind == "targeted":
        if workers is None:
            raise ValueError(
                "targeted regime shift needs the resolved attacked worker "
                "set (straggler.targeted_workers(layout, group)); the "
                "delay matrix alone cannot name a coded group"
            )
        idx = np.asarray(sorted(int(w) % W for w in workers), dtype=int)
        out[r0:, idx] += shift.slowdown
    return out


def load_arrival_trace(trace) -> np.ndarray:
    """A recorded per-round arrival-time trace as a float64 [R, W] matrix.

    ``trace`` is an array (validated and passed through) or a path:
    ``.npy`` / ``.npz`` (an ``arrivals`` entry, else the first array) /
    anything else is read as whitespace/comma-delimited text, one round
    per line. A 1-D trace is a single round. Values are per-(round,
    worker) arrival delays in simulated seconds; negative entries are
    refused (the collection rules' time axis starts at 0)."""
    if isinstance(trace, (str, bytes)):
        path = str(trace)
        if path.endswith(".npy"):
            arr = np.load(path)
        elif path.endswith(".npz"):
            with np.load(path) as z:
                key = "arrivals" if "arrivals" in z.files else z.files[0]
                arr = z[key]
        else:
            arr = np.loadtxt(path, delimiter="," if path.endswith(".csv") else None)
    else:
        arr = trace
    arr = np.asarray(arr, dtype=np.float64)
    if arr.ndim == 1:
        arr = arr[None, :]
    if arr.ndim != 2 or arr.size == 0:
        raise ValueError(
            f"arrival trace must be a non-empty [rounds, workers] matrix, "
            f"got shape {arr.shape}"
        )
    if (arr < 0).any():
        raise ValueError("arrival trace has negative arrival times")
    return arr


def replay_arrival_trace(
    trace, rounds: int, n_workers: int, speed: np.ndarray | None = None
) -> np.ndarray:
    """Tile a recorded trace (:func:`load_arrival_trace`) over ``rounds``
    rounds, with an optional [W] per-worker speed multiplier on every row
    (heterogeneous replay: worker w's recorded delays scale by
    ``speed[w]``). The trace's worker count must match the run's — a
    silently broadcast mismatch would replay the wrong cluster."""
    arr = load_arrival_trace(trace)
    if arr.shape[1] != n_workers:
        raise ValueError(
            f"arrival trace has {arr.shape[1]} workers but the run has "
            f"{n_workers}; record and replay must agree"
        )
    reps = -(-rounds // arr.shape[0])  # ceil
    out = np.tile(arr, (reps, 1))[:rounds]
    if speed is not None:
        speed = np.asarray(speed, dtype=np.float64)
        if speed.shape != (n_workers,) or (speed <= 0).any():
            raise ValueError(
                f"trace speed multipliers must be [W] positives, got "
                f"{speed!r}"
            )
        out = out * speed[None, :]
    return out


def arrival_schedule(
    rounds: int,
    n_workers: int,
    add_delay: bool,
    mean: float = 0.5,
    arrival_model: ArrivalModel | None = None,
    regime: RegimeShift | None = None,
    trace=None,
    trace_speed: np.ndarray | None = None,
    regime_workers=None,
) -> np.ndarray:
    """The full [rounds, W] arrival-time matrix for a run.

    With ``add_delay=False`` the reference's workers reply in compute order
    with no injected sleep (main.py arg add_delay, src/naive.py:140); we model
    that as all-zero arrivals (ties broken by worker index in the collection
    rules, documented there). ``regime`` applies a deterministic mid-run
    straggler-regime change (:class:`RegimeShift`) on top of the drawn
    delays — the adversary kind applies even with delays off (a slow
    worker is slow whether or not the exponential stream is injected).

    ``trace`` replaces the drawn delay stream with a recorded per-round
    trace (path or array; :func:`replay_arrival_trace` — tiled over
    ``rounds``, ``trace_speed`` scales each worker's recorded delays),
    replacing i.i.d.-exponential-only injection with real cluster replay;
    ``add_delay`` is ignored (the trace IS the delay schedule) while
    ``regime`` and the ``arrival_model`` compute terms still compose on
    top, so heterogeneity studies run against recorded streams too.

    ``regime_workers`` is the resolved attacked worker set for a
    ``"targeted"`` regime (:func:`targeted_workers`); like the adversary
    kind, a targeted attack applies even with delays off (a slowed group
    is slow whether or not the exponential stream is injected)."""
    if trace is not None:
        delays = replay_arrival_trace(trace, rounds, n_workers, trace_speed)
    elif add_delay:
        delays = reference_delay_schedule(rounds, n_workers, mean)
    else:
        delays = np.zeros((rounds, n_workers))
    if regime is not None and (
        add_delay
        or trace is not None
        or regime.kind in ("adversary", "targeted")
    ):
        delays = apply_regime_shift(delays, regime, mean, regime_workers)
    model = arrival_model or ArrivalModel()
    return model.arrivals(delays)


def threefry_delay_schedule(key, rounds: int, n_workers: int, mean: float = 0.5,
                            device=None):
    """[rounds, n_workers] float32 tensor of ``mean * exponential`` draws,
    round r drawn under ``fold_in(key, r)``: the counterpart of
    erasurehead_tpu/parallel/straggler.jax_delay_schedule, whose numbers it
    reproduces (utils/threefry.py; not bit-matched to the reference's numpy
    stream). ``key`` is a utils/threefry key, e.g. ``threefry.key(seed)``."""
    import torch

    from erasurehead_tpu_torch.utils import threefry

    rows = [mean * threefry.exponential(threefry.fold_in(key, r), n_workers, device)
            for r in range(rounds)]
    if not rows:
        return torch.zeros((0, n_workers), device=device)
    return torch.stack(rows)
