"""Worker-failure injection, detection and failover, and the elastic restart.

The port's copy of erasurehead_tpu/parallel/failures.py. The reference has
straggler injection but no failure handling: a dead worker leaves the
master's Waitany loop blocked forever (naive waits for all W,
src/naive.py:103-110; AGC for num_collect arrivals or full group coverage,
src/approximate_coding.py:144; README.md:120-122 lists real straggler
termination as future work). Here failures are infinite arrival times in
the precomputed schedule; detection and feasibility are exact host checks
ahead of the run, and failover rewrites only the unreachable rounds'
collection into a best-effort unbiased decode over the survivors.

Would each scheme's master ever exit its wait loop when workers die:

  naive          any death => hangs forever           src/naive.py:103-110
  cyclic MDS     alive < W-s => hangs                 src/coded.py:137
  FRC            any group fully dead => hangs        src/replication.py:143-155
  AGC            alive < num_collect AND some group
                 fully dead => hangs                  src/approximate_coding.py:144
  avoidstragg    alive < W-s => hangs                 src/avoidstragg.py:106-114
  partial *      any death => hangs (needs ALL
                 uncoded first-parts)                 src/partial_coded.py:174-191

Failover decode (replacing only infeasible rounds):
  uncoded layouts   collect all alive, rescale P/alive (the avoidstragg
                    unbiasedness rescale, src/avoidstragg.py:116)
  FRC layouts       first alive member per group; fully dead groups are
                    erased, AGC-style (src/approximate_coding.py:155-158)
  MDS layouts       lstsq decode weights over the alive rows of B: exact
                    while alive >= W-s, least-squares best effort below
  partial layouts   no failover (their uncoded first parts are structurally
                    required); analyze() reports, plan_run raises

Everything but :func:`train_elastic` is host float64 numpy, byte-equal to
the JAX package's; :func:`train_elastic` runs its two phases through the
port's trainers on the run's device.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from erasurehead_tpu_torch.ops import blocks, codes
from erasurehead_tpu_torch.ops.codes import CodingLayout
from erasurehead_tpu_torch.parallel import collect

DEAD = np.inf  # a dead worker's arrival time


def inject_worker_death(arrivals: np.ndarray, deaths: Mapping[int, int]) -> np.ndarray:
    """Kill worker w from round r onward: ``deaths = {worker: round}``."""
    out = np.array(arrivals, dtype=np.float64, copy=True)
    R = out.shape[0]
    for w, r in deaths.items():
        if not 0 <= w < out.shape[1]:
            raise ValueError(f"worker {w} out of range")
        out[max(0, r):R, w] = DEAD
    return out


def detect_dead(arrivals: np.ndarray, timeout: float) -> np.ndarray:
    """[R, W] bool: the workers the master would presume dead, no arrival
    by ``timeout`` simulated seconds into the round. Non-finite times are
    dead whatever the timeout, and so are negative ones: ``arrivals`` may be
    a telemetry block carrying the reference's -1 never-collected sentinel
    (src/coded.py:171-173), which must never read as an early arrival."""
    t = np.asarray(arrivals)
    return ~np.isfinite(t) | (t > timeout) | (t < 0.0)


@dataclasses.dataclass(frozen=True)
class FeasibilityReport:
    """Would each round's collection rule ever exit its wait loop?"""

    feasible: np.ndarray  # [R] bool
    dead: np.ndarray  # [R, W] bool (presumed dead per detect_dead)
    scheme: object  # utils.config.Scheme
    reason: str  # the human-readable rule that was applied

    @property
    def all_feasible(self) -> bool:
        return bool(self.feasible.all())

    @property
    def first_infeasible(self) -> Optional[int]:
        bad = np.flatnonzero(~self.feasible)
        return int(bad[0]) if bad.size else None


def analyze(
    scheme,
    layout: CodingLayout,
    arrivals: np.ndarray,
    num_collect: int | None = None,
    timeout: float = np.inf,
) -> FeasibilityReport:
    """Per-round feasibility of the scheme's stop condition (the table of
    the module docstring), from the scheme descriptor's ``feasibility``
    core (schemes/builtin.py) with the shared death detection."""
    from erasurehead_tpu_torch import schemes
    from erasurehead_tpu_torch.utils.config import as_scheme

    scheme = as_scheme(scheme)
    desc = schemes.get(scheme)
    dead = detect_dead(arrivals, timeout)
    feasible, reason = desc.feasibility(layout, dead, num_collect=num_collect)
    return FeasibilityReport(
        feasible=np.asarray(feasible), dead=dead, scheme=scheme, reason=reason
    )


class InfeasibleRunError(RuntimeError):
    def __init__(self, report: FeasibilityReport):
        self.report = report
        super().__init__(
            f"scheme {report.scheme.value}: collection unreachable from round "
            f"{report.first_infeasible} ({report.reason}; the reference's "
            "master would block in Waitany forever)"
        )


def failover_schedule(
    schedule: collect.CollectionSchedule,
    layout: CodingLayout,
    arrivals: np.ndarray,
    report: FeasibilityReport,
    timeout: float,
) -> collect.CollectionSchedule:
    """Rewrite the infeasible rounds: collect everyone alive at ``timeout``
    and decode best-effort per the layout (module docstring). Feasible
    rounds are untouched: the scheme's own rule already exits there."""
    if report.all_feasible:
        return schedule
    if layout.slot_is_coded is not None and not np.all(layout.slot_is_coded):
        raise InfeasibleRunError(report)  # partial layouts: see the docstring
    weights = np.array(schedule.message_weights, copy=True)
    sim = np.array(schedule.sim_time, copy=True)
    wtimes = np.array(schedule.worker_times, copy=True)
    collected = np.array(schedule.collected, copy=True)
    t = np.asarray(arrivals, dtype=np.float64)
    for r in np.flatnonzero(~report.feasible):
        alive = ~report.dead[r]
        collected[r] = alive
        wtimes[r] = np.where(alive, t[r], collect.NEVER)
        sim[r] = timeout
        if layout.B is not None:  # MDS: best-effort lstsq over the alive rows
            weights[r] = codes.mds_decode_weights_host(layout.B, alive[None, :])[0]
        elif layout.groups is not None:  # FRC/AGC: the first alive per group
            win = collect._group_winners(
                np.where(alive, t[r], DEAD)[None, :], layout.groups
            )[0]
            weights[r] = (win & alive).astype(np.float64)
        else:  # uncoded: the avoidstragg rescale over the survivors
            k = int(alive.sum())
            if k == 0:
                raise InfeasibleRunError(report)
            weights[r] = alive * (layout.n_workers / k)
    return collect.CollectionSchedule(
        message_weights=weights,
        sim_time=sim,
        worker_times=wtimes,
        collected=collected,
    )


def plan_run(
    scheme,
    layout: CodingLayout,
    arrivals: np.ndarray,
    num_collect: int | None = None,
    timeout: float = np.inf,
    on_infeasible: str = "error",  # "error" | "failover"
    deadline: float | None = None,
    decode: str = "fixed",
) -> tuple[collect.CollectionSchedule, FeasibilityReport]:
    """The run's collection schedule with failure handling:
    ``on_infeasible="error"`` raises :class:`InfeasibleRunError` where the
    reference would hang, ``"failover"`` degrades those rounds
    (:func:`failover_schedule`)."""
    if on_infeasible == "failover" and not np.isfinite(timeout):
        # failover stamps sim_time[r] = timeout on the rewritten rounds; an
        # infinite timeout would corrupt every simulated-time view
        raise ValueError(
            "on_infeasible='failover' requires a finite timeout "
            f"(got {timeout!r}) — it becomes the rewritten rounds' sim_time"
        )
    report = analyze(scheme, layout, arrivals, num_collect, timeout)
    schedule = collect.build_schedule(
        scheme, arrivals, layout, num_collect=num_collect,
        deadline=deadline, decode=decode,
    )
    if report.all_feasible:
        return schedule, report
    if on_infeasible == "error":
        raise InfeasibleRunError(report)
    if on_infeasible != "failover":
        raise ValueError(f"on_infeasible must be error|failover, got {on_infeasible!r}")
    return (
        failover_schedule(schedule, layout, arrivals, report, timeout),
        report,
    )


def survivor_config(
    cfg,
    n_survivors: int,
    survivor_overrides: Optional[dict] = None,
    lr_schedule=None,
):
    """The survivor phase's RunConfig for ``n_survivors`` workers, validated
    up front through the scheme registry: ``num_collect`` is clamped to W',
    and a structural constraint W' breaks (FRC's ``(s+1) | W'``, the
    partial schemes' partition counts) raises naming ``survivor_overrides``
    as the fix. ``survivor_overrides`` wins over the derived fields."""
    overrides = dict(
        n_workers=n_survivors,
        num_collect=(
            None if cfg.num_collect is None else min(cfg.num_collect, n_survivors)
        ),
    )
    if lr_schedule is not None:
        overrides["lr_schedule"] = lr_schedule
    overrides.update(survivor_overrides or {})
    try:
        # RunConfig.__post_init__ delegates to the scheme descriptor's
        # validate_config, the single home of scheme invariants
        return dataclasses.replace(cfg, **overrides)
    except ValueError as e:
        raise ValueError(
            f"survivor phase invalid for scheme "
            f"{cfg.scheme.value!r} at W'={n_survivors}: {e}. Pass "
            f"survivor_overrides= adjusting the violated knob (e.g. a "
            f"smaller n_stragglers where FRC requires (s+1) | W')"
        ) from e


@dataclasses.dataclass(frozen=True)
class ElasticReport:
    """What an elastic restart did (train_elastic)."""

    death_round: int  # the first round run under the survivor layout
    dead_workers: tuple[int, ...]
    n_workers_before: int
    n_workers_after: int


def train_elastic(
    cfg,
    dataset,
    deaths: Mapping[int, int],
    *,
    device=None,
    survivor_overrides: Optional[dict] = None,
    dynamic: bool = False,
    init_params=None,
    mesh=None,
):
    """Elastic recovery: re-shard onto the survivors and keep training.

    At the earliest death round the run stops, the whole dataset re-shards
    over the surviving worker count under a fresh layout of the same scheme,
    the optimizer state (params and momentum) carries over unchanged, and
    training continues to ``cfg.rounds`` on the same lr schedule: the loss
    curve is continuous through the failure and every partition keeps
    contributing (nothing is erased, unlike failover's dropped groups). Each
    phase truncates rows to its own partition-count multiple, so up to W-1
    tail rows can differ between phases; the merged ``n_train`` is the
    common prefix.

    ``deaths``: {worker_id: round}. All deaths re-shard at the earliest
    round (one restart); deaths at rounds >= cfg.rounds never happen inside
    the run and are ignored. ``survivor_overrides``: RunConfig fields for
    the survivor phase (e.g. a smaller n_stragglers when W' breaks FRC's
    divisibility). Returns (TrainResult, ElasticReport); the merged
    artifacts keep the original worker numbering, the dead workers'
    columns carrying the reference's -1 sentinel after the restart.

    ``dynamic=True`` runs both phases through trainer.train_dynamic (the
    on-device control plane), else through trainer.train's restart
    contract. ``device`` is the run's (cuda unless "cpu" is asked for),
    ``init_params`` the first phase's as train() takes it, and ``mesh`` the
    first phase's worker mesh (parallel/mesh.py; None: the auto mesh). As
    in the JAX package the survivor phase takes the auto mesh over W',
    which shrinks the worker group (7 survivors over 2 processes run on
    one; the other rank contributes zeros and stays a replica)."""
    from erasurehead_tpu_torch.train import trainer

    W = cfg.n_workers
    if not deaths:
        raise ValueError("deaths is empty — nothing to recover from")
    if not all(0 <= w < W for w in deaths):
        raise ValueError(f"dead workers {sorted(deaths)} outside [0, {W})")
    # a death at round >= cfg.rounds never happens inside this run: that
    # worker survives the whole horizon and must not be evicted
    effective = {w: r for w, r in deaths.items() if r < cfg.rounds}
    if not effective:
        raise ValueError(
            f"no death occurs before rounds={cfg.rounds}; nothing to recover"
        )
    dead = sorted(effective)
    death_round = min(effective.values())
    if death_round < 1:
        raise ValueError(
            f"earliest death round {death_round} must be in (0, rounds)"
        )
    survivors = [w for w in range(W) if w not in set(dead)]
    W2 = len(survivors)
    if W2 < 1:
        raise ValueError("no survivors")

    # one resolved lr schedule drives both phases (phase 1 takes its
    # prefix), so the per-round lr stays continuous through the restart
    lr_full = cfg.resolve_lr_schedule()
    # the survivor config before phase 1: an invalid W' fails fast
    cfg2 = survivor_config(cfg, W2, survivor_overrides, lr_schedule=lr_full)
    train_fn = trainer.train_dynamic if dynamic else trainer.train
    phase1 = train_fn(
        dataclasses.replace(cfg, rounds=death_round, lr_schedule=lr_full[:death_round]),
        dataset, device=device, init_params=init_params, mesh=mesh,
    )
    phase2 = train_fn(
        cfg2, dataset, device=device,
        initial_state=phase1.final_state, initial_round=death_round,
    )

    history = blocks.tree_map(
        lambda a, b: torch.cat([a, b.to(a.device)]),
        phase1.params_history, phase2.params_history,
    )
    R = cfg.rounds
    timeset = np.concatenate([phase1.timeset, phase2.timeset[death_round:]])
    # survivor-phase clocks map back to the original worker ids; the dead
    # columns carry the -1 never-collected sentinel (src/coded.py:171-173)
    wt = -np.ones((R, W))
    col = np.zeros((R, W), dtype=bool)
    wt[:death_round] = phase1.worker_times
    col[:death_round] = phase1.collected
    wt[death_round:, survivors] = phase2.worker_times[death_round:]
    col[death_round:, survivors] = phase2.collected[death_round:]
    wall = phase1.wall_time + phase2.wall_time
    result = trainer.TrainResult(
        params_history=history,
        final_params=phase2.final_params,
        timeset=timeset,
        worker_times=wt,
        collected=col,
        sim_total_time=float(timeset.sum()),
        wall_time=wall,
        steps_per_sec=R / wall if wall > 0 else 0.0,
        # the phases truncate rows to their own partition multiples; the
        # merged loss replay is honest over the common prefix of rows
        n_train=min(phase1.n_train, phase2.n_train),
        config=cfg,
        layout=phase1.layout,
        final_state=phase2.final_state,
        lowering=phase2.lowering,
    )
    report = ElasticReport(
        death_round=death_round,
        dead_workers=tuple(dead),
        n_workers_before=W,
        n_workers_after=W2,
    )
    return result, report
