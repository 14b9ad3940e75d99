"""Seeded Monte-Carlo arrival sampling for the what-if engine.

The port of erasurehead_tpu/whatif/sampler.py. The reference's delay model
is one stream: i.i.d. Exponential(0.5) per (round, worker), re-seeded per
round (parallel/straggler.reference_delay_schedule). A what-if surface
needs MANY independent draws of MANY regimes: the straggler-regime
families of the retrieved papers (heavy Pareto tails, fixed adversaries and
targeted replica-group attacks from arXiv:1901.08166) plus recorded-trace
replay. So this module batches the draw itself: one pass of the threefry
cipher on the run's device produces the whole ``[n_seeds, rounds,
workers]`` arrival block, and the engine feeds each seed's slice to the
host collection rules exactly as a single run's schedule.

Determinism contract: every draw is a pure function of (seed, regime,
shape) through JAX's counter-based threefry (utils/threefry.py): the key of
(seed, round) is ``fold_in(key(seed), round)``, folded on the host in
integers, and the draw is ``exponential(key, (W,))``, in float32, with
JAX's bits; the exponentials agree with JAX's within the last-ulp rounding
of ``log1p``/``expm1``. Rerunning an identical grid spec redraws identical
arrivals, which is what makes a what-if surface bitwise-rehydratable. The
drawn streams are the sampler's OWN universe (threefry, not the reference's
MT19937): what-if surfaces are comparable to each other, and the paired-
comparison contract holds because every policy at the same (W, regime,
seed) grid coordinate reads the same slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from erasurehead_tpu_torch.parallel import straggler
from erasurehead_tpu_torch.utils import threefry
from erasurehead_tpu_torch.utils.device import resolve_device

#: the arrival-regime families a grid point may run under
REGIME_KINDS = ("exp", "heavytail", "adversary", "targeted", "trace")


@dataclasses.dataclass(frozen=True)
class RegimeSpec:
    """One straggler regime a grid axis enumerates.

    ``kind``:

      - ``"exp"``       — the reference's stationary stream: i.i.d.
        Exponential(``mean``) delays every round;
      - ``"heavytail"`` — Exponential through round ``shift_round``-1,
        then Pareto(``alpha``)-tailed delays scaled by ``mean`` (small
        alpha = heavier tail; alpha <= 1 has infinite mean);
      - ``"adversary"`` — Exponential plus ``slowdown`` extra seconds on
        worker ``worker`` from round ``shift_round`` on (the fixed-
        straggler worst case of arXiv:1901.08166);
      - ``"targeted"``  — Exponential plus ``slowdown`` on EVERY replica
        of coded partition group ``group`` from ``shift_round`` on
        (1901.08166's fractional-repetition worst case; the attacked
        worker set is layout-resolved per grid point, straggler.
        targeted_workers);
      - ``"trace"``     — replay a recorded [R?, W] arrival trace
        (straggler.replay_arrival_trace), rotated by a seeded round
        offset per Monte-Carlo seed so seeds stay independent draws.

    ``compute_time`` adds a uniform per-round compute cost on top of the
    delay draw — with ``compute_slots=True`` it scales by each worker's
    SLOT COUNT from the grid point's layout, so coded redundancy costs
    (s+1)x compute per round exactly as it did on the reference cluster
    (the axis the AGC-vs-exact crossover lives on).
    """

    kind: str = "exp"
    mean: float = 0.5
    alpha: float = 1.2
    shift_round: int = 0
    worker: int = 0
    slowdown: float = 5.0
    group: int = 0
    trace: Optional[str] = None
    compute_time: float = 0.0
    compute_slots: bool = False

    def __post_init__(self):
        if self.kind not in REGIME_KINDS:
            raise ValueError(
                f"regime kind must be one of {REGIME_KINDS}, got "
                f"{self.kind!r}"
            )
        if self.mean < 0:
            raise ValueError(f"regime mean must be >= 0, got {self.mean}")
        if self.kind == "heavytail" and self.alpha <= 0:
            raise ValueError(
                f"heavytail alpha must be > 0, got {self.alpha}"
            )
        if self.kind in ("adversary", "targeted") and self.slowdown < 0:
            raise ValueError(
                f"{self.kind} slowdown must be >= 0, got {self.slowdown}"
            )
        if self.kind == "trace" and not self.trace:
            raise ValueError("trace regime needs a trace path/array")
        if self.shift_round < 0:
            raise ValueError(
                f"shift_round must be >= 0, got {self.shift_round}"
            )
        if self.compute_time < 0:
            raise ValueError(
                f"compute_time must be >= 0, got {self.compute_time}"
            )

    @property
    def tag(self) -> str:
        """Short label for surface rows / grid-point names."""
        if self.kind == "exp":
            base = f"exp{self.mean:g}"
        elif self.kind == "heavytail":
            base = f"heavytail{self.alpha:g}x{self.mean:g}"
        elif self.kind == "adversary":
            base = f"adversary{self.slowdown:g}"
        elif self.kind == "targeted":
            base = f"targeted{self.slowdown:g}g{self.group}"
        else:
            base = "trace"
        if self.compute_time:
            base += f"+c{self.compute_time:g}"
            if self.compute_slots:
                base += "xslots"
        return base

    def payload(self) -> dict:
        """JSON form for the spec hash / saved surface header."""
        out = {"kind": self.kind, "mean": self.mean}
        if self.kind == "heavytail":
            out["alpha"] = self.alpha
        if self.kind in ("adversary", "targeted"):
            out["slowdown"] = self.slowdown
        if self.kind == "adversary":
            out["worker"] = self.worker
        if self.kind == "targeted":
            out["group"] = self.group
        if self.kind == "trace":
            out["trace"] = str(self.trace)
        if self.shift_round:
            out["shift_round"] = self.shift_round
        if self.compute_time:
            out["compute_time"] = self.compute_time
            out["compute_slots"] = self.compute_slots
        return out


def _batch_draw(regime: RegimeSpec, rounds: int, n_workers: int, seeds, mask, dev):
    """The batched draw for one regime: seeds -> [S, R, W] float32 on
    ``dev``. Every (seed, round) key is folded on the host and the whole
    block enciphers in one pass (utils/threefry.py: a [S*R, 2] key tensor),
    so the launch count is the same for one seed as for hundreds. The
    arithmetic is JAX's ``_batch_draw_fn`` in float32: ``mean * e``, the
    heavytail transform ``mean * expm1(e / alpha)`` from ``shift_round``,
    the attacked-worker mask's ``slowdown`` added from ``shift_round``."""
    keys = [threefry.fold_in(threefry.key(int(s)), r) for s in seeds for r in range(rounds)]
    e = threefry.exponential(threefry.key_tensor(keys, dev), n_workers)
    e = e.reshape(len(seeds), rounds, n_workers)
    mean = float(regime.mean)
    out = mean * e
    shifted = (torch.arange(rounds, device=dev) >= int(regime.shift_round))[:, None]
    if regime.kind == "heavytail":
        # Pareto(alpha) via the exponential inverse-CDF transform:
        # U = exp(-E) uniform, X = U^(-1/alpha) - 1 = expm1(E/alpha)
        out = torch.where(shifted, mean * torch.expm1(e / float(regime.alpha)), out)
    elif regime.kind in ("adversary", "targeted"):
        # one worker for adversary, a layout-resolved replica group for
        # targeted, as a [W] mask
        w = torch.as_tensor(mask, dtype=torch.float32, device=dev)
        out = out + float(regime.slowdown) * shifted * w[None, :]
    return out


def sample_arrivals(
    regime: RegimeSpec,
    rounds: int,
    n_workers: int,
    seeds,
    layout=None,
    slots_per_worker: Optional[np.ndarray] = None,
    device=None,
) -> np.ndarray:
    """Draw the regime's full Monte-Carlo arrival block: ``[len(seeds),
    rounds, n_workers]`` float64 arrival times, one deterministic draw per
    seed.

    ``layout`` resolves the ``"targeted"`` kind's attacked worker set
    (straggler.targeted_workers — only the layout knows which workers
    replicate the attacked group) and, with ``compute_slots``, each
    worker's slot count; ``slots_per_worker`` overrides the latter.
    ``device`` is where the draw runs: ``cuda`` unless ``"cpu"`` is asked
    for (the trace replay and the compute time are host float64).
    """
    seeds = np.asarray(list(seeds), dtype=np.int64)
    if seeds.ndim != 1 or seeds.size == 0:
        raise ValueError(f"seeds must be a non-empty 1-D list, got {seeds!r}")

    if regime.kind == "trace":
        base = straggler.replay_arrival_trace(
            regime.trace, rounds, n_workers
        )
        # independent per-seed draws from one recorded stream: rotate the
        # replay window by a seeded round offset (seed 0 = the raw trace)
        out = np.stack(
            [np.roll(base, -(int(s) % rounds), axis=0) for s in seeds]
        ).astype(np.float64)
    else:
        mask = np.zeros(n_workers, dtype=np.float64)
        if regime.kind == "adversary":
            mask[regime.worker % n_workers] = 1.0
        elif regime.kind == "targeted":
            if layout is None:
                raise ValueError(
                    "targeted regime needs the grid point's layout to "
                    "resolve the attacked replica group "
                    "(straggler.targeted_workers)"
                )
            for w in straggler.targeted_workers(layout, regime.group):
                mask[w % n_workers] = 1.0
        dev = resolve_device(device)
        block = _batch_draw(regime, int(rounds), int(n_workers), seeds, mask, dev)
        out = block.cpu().numpy().astype(np.float64)

    if regime.compute_time:
        per_worker = np.full(n_workers, float(regime.compute_time))
        if regime.compute_slots:
            if slots_per_worker is None:
                if layout is None:
                    raise ValueError(
                        "compute_slots needs the grid point's layout (or "
                        "an explicit slots_per_worker) to price each "
                        "worker's redundant compute"
                    )
                slots_per_worker = slot_counts(layout)
            per_worker = per_worker * np.asarray(
                slots_per_worker, dtype=np.float64
            )
        out = out + per_worker[None, None, :]
    return out


def slot_counts(layout) -> np.ndarray:
    """[W] slots (partition copies) each worker computes per round — the
    faithful compute price of the layout's redundancy ((s+1) for the
    replication/MDS families, ragged for sparse-graph codes)."""
    assignment = np.asarray(layout.assignment)
    return (assignment >= 0).sum(axis=1).astype(np.float64)
