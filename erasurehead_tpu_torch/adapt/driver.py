"""train_adaptive: run the trainer in chunks under the bandit's chosen arms.

The port of erasurehead_tpu/adapt/driver.py, a THIN composition of the
trainer:

  - each chunk is a plain ``trainer.train`` call covering rounds [lo, hi)
    through the ``initial_state``/``initial_round`` mid-schedule restart
    contract (the elastic-recovery hook), so every chunk's math, data
    cache and decode-error accounting are exactly the single run's;
  - the arrival matrix is drawn ONCE for the whole horizon
    (trainer.default_arrivals: the ``ERASUREHEAD_REGIME`` shift applies
    here) and every arm sees the same stream;
  - arm switches are weight-table switches: arms must share the base
    config's layout-stack signature (validated up front), so the stack
    the first chunk uploads is the one every later chunk finds in the
    device data cache (train/cache.py): no re-upload mid-run.

Between chunks the controller reads the chunk's own telemetry (sim seconds,
decode-error mean, raw arrival stats) and decides the next arm; each
decision is a typed ``adapt`` event (obs/events.py). Under the default
``reward_mode="progress"`` the reward also needs the training loss at each
chunk boundary: the probe evaluates it on the full training set, which is
put on the run's device once per call. Decisions are deterministic given
(controller seed, arrival schedule), so a rerun replays the same sequence
bitwise (chaos site ``adapt`` arms a mid-adaptation fault).

Across processes (``mesh=``, forwarded into every chunk's train(), as the
JAX driver does; None: train()'s own rule per chunk) every rank runs the
same driver: the controller's inputs are the simulated clocks, the decode
errors and the raw arrival schedule, which every rank builds alike from the
same seeds, and the boundary loss of the ``progress`` reward, which each
rank computes from its bitwise-equal params and then takes from rank 0
(parallel/backend.agree), so every rank makes the same decisions and joins
the same collectives. The wall clock (``decision_wall``) is only reported.

Deviations from the JAX driver: ``device=`` sits beside ``mesh=``, and
``init_params`` (as train() takes it) replaces the first chunk's seeded
init, e.g. with a JAX run's draw for parity.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from erasurehead_tpu_torch.adapt.controller import (
    AdaptiveController,
    Arm,
    ChunkStats,
    ControllerConfig,
)
from erasurehead_tpu_torch.utils.config import RunConfig


@dataclasses.dataclass
class AdaptiveResult:
    """A merged TrainResult plus the controller's decision record."""

    result: object  # trainer.TrainResult over the full horizon
    decisions: list  # one per chunk (controller.decisions)
    arms: list
    #: per-chunk (arm label, ChunkStats) pairs, decision order
    chunk_stats: list
    #: the controller's own cost: wall seconds spent in choose/observe,
    #: the boundary loss probes and event emission across all chunks
    decision_overhead_s: float
    #: everything outside the chunk train() calls and the decisions (each
    #: chunk's set-up: schedule, cache lookup, weights upload; history
    #: stitching): the chunked dispatch's fixed cost
    driver_overhead_s: float
    #: sum of the chunks' round-loop wall seconds
    train_wall_s: float
    #: whole-run wall seconds (train + driver + decisions)
    total_wall_s: float


def default_arms(cfg: RunConfig) -> list:
    """A registry-compatible arm set for ``cfg``: the config's own policy
    plus the uncoded-layout alternatives every straggler regime ranks
    differently (wait-for-all, ignore-stragglers and, when the config
    carries a deadline, deadline collection). All share the deduped
    partition-major stack; in faithful mode only stack-compatible arms
    survive the driver's validation."""
    arms = [Arm(cfg.scheme.value, cfg.num_collect, cfg.deadline)]

    def add(arm: Arm):
        if all(a.label != arm.label for a in arms):
            arms.append(arm)

    add(Arm("naive"))
    add(Arm("avoidstragg"))
    if cfg.deadline is not None:
        add(Arm("deadline", deadline=cfg.deadline))
    return arms


def _arm_config(cfg: RunConfig, arm: Arm, rounds: int) -> RunConfig:
    return dataclasses.replace(
        cfg, rounds=rounds, lr_schedule=cfg.resolve_lr_schedule()[:rounds],
        **arm.overrides(),
    )


def _validate_arms(cfg: RunConfig, arms: Sequence[Arm]) -> list:
    """Every arm must (a) validate as a config and (b) build the SAME
    device data stack as the base config: the no-re-upload contract that
    makes arm switches cheap. Returns the arms' layouts."""
    from erasurehead_tpu_torch import schemes
    from erasurehead_tpu_torch.train import cache as cache_lib
    from erasurehead_tpu_torch.train import trainer
    from erasurehead_tpu_torch.utils.config import ComputeMode

    faithful = cfg.compute_mode == ComputeMode.FAITHFUL
    base_sig = cache_lib.layout_stack_signature(
        trainer.build_layout(cfg), worker_major=faithful
    )
    layouts = []
    for arm in arms:
        if schemes.get(arm.scheme).partial:
            raise ValueError(
                f"arm {arm.label!r}: partial two-part schemes change the "
                "partition count and cannot share the base data stack"
            )
        lay = trainer.build_layout(_arm_config(cfg, arm, cfg.rounds))
        sig = cache_lib.layout_stack_signature(lay, worker_major=faithful)
        if sig != base_sig:
            raise ValueError(
                f"arm {arm.label!r} builds a different device data stack "
                "than the base config (layout-stack signatures differ); "
                "adaptive arm switches must be weight-table-only — use "
                "compute_mode='deduped' (partition-major stacks are "
                "scheme-independent) or stack-compatible schemes"
            )
        layouts.append(lay)
    return layouts


def _cat_history(pieces):
    """The chunks' [n, ...] histories joined along the round axis."""
    from erasurehead_tpu_torch.ops import blocks

    if len(pieces) == 1:
        return pieces[0]
    return blocks.tree_map(lambda *xs: torch.cat(xs), *pieces)


def train_adaptive(
    cfg: RunConfig,
    dataset,
    arms: Optional[Sequence[Arm]] = None,
    controller: Optional[ControllerConfig] = None,
    device=None,
    arrivals: Optional[np.ndarray] = None,
    priors: Optional[dict] = None,
    init_params=None,
    mesh=None,
) -> AdaptiveResult:
    """Train ``cfg.rounds`` rounds, re-choosing the collection policy at
    every ``controller.chunk_rounds`` boundary (module docstring).

    ``cfg`` provides everything but the per-chunk policy: model, data shape,
    update rule, decode mode, memory knobs. ``arms`` defaults to
    :func:`default_arms`. ``priors`` ({arm label: simulated expected reward},
    e.g. a what-if surface's ``adapt_priors``) seeds the bandit's cold start.
    ``device`` defaults to ``cuda``; ``init_params`` replaces the first
    chunk's seeded init as train() takes it; ``mesh`` (None: train()'s
    rule) is every chunk's worker mesh. Returns an
    :class:`AdaptiveResult` whose ``result`` reads like one
    ``trainer.train`` result over the full horizon (history on the run's
    device, clocks with the -1 sentinel, the decode-error series stitched
    from the chunks)."""
    from erasurehead_tpu_torch.models.glm import params_from_numpy
    from erasurehead_tpu_torch.obs import events as obs_events
    from erasurehead_tpu_torch.parallel import backend
    from erasurehead_tpu_torch.train import evaluate as evaluate_lib
    from erasurehead_tpu_torch.train import trainer
    from erasurehead_tpu_torch.utils import chaos as chaos_lib
    from erasurehead_tpu_torch.utils.device import resolve_device

    if cfg.arrival_mode != "simulated":
        raise ValueError(
            "train_adaptive drives the scan trainer in chunks; "
            "arrival_mode='measured' has no chunked implementation"
        )
    arms = list(arms) if arms is not None else default_arms(cfg)
    ctl_cfg = controller or ControllerConfig()
    _validate_arms(cfg, arms)
    ctl = AdaptiveController(arms, ctl_cfg, priors=priors)
    dev = resolve_device(device)

    # shift_source="regime": the live estimator (obs/regime.py) watches
    # every ROUND of the raw arrival schedule and hands its change-point
    # verdict to observe()
    estimator = None
    if ctl_cfg.shift_source == "regime":
        from erasurehead_tpu_torch.obs import regime as regime_lib

        estimator = regime_lib.ArrivalRegimeEstimator(shift_factor=ctl_cfg.shift_factor)

    if arrivals is None:
        arrivals = trainer.default_arrivals(cfg)
    arrivals = np.asarray(arrivals, dtype=np.float64)
    if arrivals.shape != (cfg.rounds, cfg.n_workers):
        raise ValueError(
            f"arrivals shape {arrivals.shape} != "
            f"({cfg.rounds}, {cfg.n_workers})"
        )

    R, W = cfg.rounds, cfg.n_workers
    run_id = obs_events.new_run_id() if obs_events.current() else None
    state = None
    pieces = []  # per-chunk params_history trees, on the run's device
    timeset = np.zeros(R)
    worker_times = np.full((R, W), -1.0)
    collected = np.zeros((R, W), dtype=bool)
    decode_err = np.zeros(R)
    chunk_stats: list = []
    train_wall = 0.0
    decision_wall = 0.0
    last_res = None
    t_total0 = time.perf_counter()
    loss_prev: Optional[float] = None
    _loss_of = None
    if ctl_cfg.reward_mode == "progress":
        # the chunk-boundary loss probe: the training loss of one iterate on
        # the full training set (the first curve of evaluate.replay), whose
        # rows go to the device once here, not once a probe
        probe_model = trainer.build_model(cfg)
        X_probe = evaluate_lib.to_device(dataset.X_train, dev)
        y_probe = evaluate_lib.to_device(dataset.y_train, dev)

        def _loss_of(params) -> float:
            # rank 0's value on every rank: the reward steers the bandit,
            # whose choices every rank must make alike
            with torch.no_grad():
                return backend.agree(float(probe_model.loss_mean(params, X_probe, y_probe)))

        if init_params is None:
            p0 = probe_model.init_params(cfg.seed, dataset.n_features, dev)
        else:
            p0 = params_from_numpy(init_params, dev)
        _loss_of(p0)  # warm-up outside the timed region
        t_dec0 = time.perf_counter()
        loss_prev = _loss_of(p0)
        decision_wall += time.perf_counter() - t_dec0
    lo = 0
    while lo < R:
        hi = min(lo + ctl_cfg.chunk_rounds, R)
        # chaos site "adapt": a kill here is a preemption mid-adaptation;
        # rerunning replays the decision prefix bitwise (determinism)
        chaos_lib.maybe_fire("adapt")
        t_dec = time.perf_counter()
        idx, reason = ctl.choose()
        decision_wall += time.perf_counter() - t_dec
        arm = arms[idx]
        arm_cfg = _arm_config(cfg, arm, hi)
        res = trainer.train(
            arm_cfg, dataset, device=dev, arrivals=arrivals[:hi],
            init_params=init_params if state is None else None,
            initial_state=state, initial_round=lo if state is not None else 0,
            mesh=mesh,
        )
        state = res.final_state
        last_res = res
        train_wall += res.wall_time
        # the chunk's own telemetry: clocks + decode errors for [lo, hi)
        timeset[lo:hi] = res.timeset[lo:hi]
        worker_times[lo:hi] = res.worker_times[lo:hi]
        collected[lo:hi] = res.collected[lo:hi]
        decode_err[lo:hi] = res.decode_error[lo:hi]
        pieces.append(res.params_history)
        t_dec = time.perf_counter()
        # arrival stats for SHIFT DETECTION come from the raw schedule
        # window, not the collected-masked worker_times: masked stats are
        # policy-dependent (avoidstragg never stamps the straggler it
        # skipped), and a policy-dependent detector would read every arm
        # switch as a regime change
        raw_rows = arrivals[lo:hi]
        raw = raw_rows[np.isfinite(raw_rows)]
        loss_delta = None
        if loss_prev is not None:
            loss_now = _loss_of(res.final_params)
            loss_delta = loss_prev - loss_now
            loss_prev = loss_now
        stats = ChunkStats(
            n_rounds=hi - lo,
            sim_time=float(res.timeset[lo:hi].sum()),
            decode_error_mean=float(res.decode_error[lo:hi].mean()),
            arrival_mean=float(raw.mean()) if raw.size else None,
            arrival_p90=float(np.quantile(raw, 0.9)) if raw.size else None,
            loss_delta=loss_delta,
        )
        verdict = None
        if estimator is not None:
            # the same raw (policy-independent) rows the jump rule reads,
            # but per round
            estimator.update_rounds(lo, raw_rows)
            verdict = estimator.poll_shift()
        shift = ctl.observe(idx, stats, regime_shift=verdict)
        chunk_stats.append((arm.label, stats))
        obs_events.emit(
            "adapt",
            run_id=run_id,
            round=lo,
            n_rounds=hi - lo,
            arm=arm.label,
            scheme=arm.scheme,
            num_collect=arm.num_collect,
            deadline=arm.deadline,
            reason=reason,
            reward=round(ctl.reward(stats), 8),
            sim_per_round=round(stats.sim_per_round, 8),
            decode_error_mean=round(stats.decode_error_mean, 10),
            regime_shift=bool(shift),
            values=ctl.snapshot()["values"],
        )
        decision_wall += time.perf_counter() - t_dec
        lo = hi

    history = _cat_history(pieces)
    total_wall = time.perf_counter() - t_total0
    driver_overhead = max(total_wall - train_wall - decision_wall, 0.0)
    merged = trainer.TrainResult(
        params_history=history,
        final_params=state.params,
        final_state=state,
        timeset=timeset,
        worker_times=worker_times,
        collected=collected,
        sim_total_time=float(timeset.sum()),
        wall_time=train_wall,
        steps_per_sec=R / train_wall if train_wall > 0 else 0.0,
        n_train=last_res.n_train,
        config=cfg,
        layout=last_res.layout,
        decode_error=decode_err,
        lowering=last_res.lowering,
        cache_info=last_res.cache_info,
    )
    return AdaptiveResult(
        result=merged,
        decisions=list(ctl.decisions),
        arms=arms,
        chunk_stats=chunk_stats,
        decision_overhead_s=decision_wall,
        driver_overhead_s=driver_overhead,
        train_wall_s=train_wall,
        total_wall_s=total_wall,
    )
