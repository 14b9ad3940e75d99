"""Experiment harness: the AGC vs EGC vs uncoded comparisons.

The port of erasurehead_tpu/train/experiments.py's library entry points.
The reference's experimental frame: for each scheme and straggler count,
train under the same seeded delay schedule and compare (a) the effective
iteration rate and (b) the time to a target loss, both on the simulated
master clock.

:func:`compare` runs a set of configs on one dataset under one shared
arrival schedule (a paired comparison) and summarizes each run;
:func:`straggler_sweep` is the reference's headline figure, each scheme
across straggler counts. Configs that share a device data stack
(:func:`plan_cohorts`) run as one trajectory cohort
(train/trainer.train_cohort): a deduped 7-scheme x 4-seed sweep reads X
once a round for all 28 trajectories instead of 28 times.

A cohort that runs out of device memory (``torch.cuda.OutOfMemoryError``)
is bisected into halves, down to sequential ``train()`` on the same device:
the JAX package's own degradation. Every other exception propagates
untouched, a kernel's launch failure included: nothing is retried.

Not ported: the sweep journal and resume, event emission, the JAX
``baseline_suite``, ``main`` and its ``sweep`` CLI, streamed cohorts and
per-label arrival schedules.

:data:`COUNTERS` counts the harness's dispatches under the JAX package's
metric names.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from erasurehead_tpu_torch import schemes
from erasurehead_tpu_torch.data.synthetic import Dataset
from erasurehead_tpu_torch.ops import blocks
from erasurehead_tpu_torch.parallel import straggler
from erasurehead_tpu_torch.train import evaluate, trainer
from erasurehead_tpu_torch.utils.config import (
    RunConfig,
    resolve_arrival_trace,
    resolve_batch_trajectories,
)

#: dispatch counters since the last :func:`reset_counters`:
#:   cohort.dispatches       train_cohort calls (one a cohort, one a half)
#:   cohort.trajectories     trajectories handed to those calls
#:   cohort.sequential_runs  train() calls of the plan (singletons, "off")
#:   cohort.split            cohorts bisected after running out of memory
#:   cohort.sequential_fallback  trajectories sent to train() by that bisection
#:   sweep.diverged          rows quarantined as diverged
COUNTERS = {
    name: 0
    for name in (
        "cohort.dispatches", "cohort.trajectories", "cohort.sequential_runs",
        "cohort.split", "cohort.sequential_fallback", "sweep.diverged",
    )
}


def reset_counters() -> None:
    for name in COUNTERS:
        COUNTERS[name] = 0


@dataclasses.dataclass
class RunSummary:
    label: str
    config: RunConfig
    sim_total_time: float
    sim_steps_per_sec: float
    real_steps_per_sec: float
    final_train_loss: float
    final_test_loss: float
    final_auc: float
    time_to_target: Optional[float]  # simulated seconds; None if never reached
    training_loss: np.ndarray
    timeset: np.ndarray
    #: free-form caveat carried into the saved row
    note: Optional[str] = None
    #: suite config name, carried as its own row field
    suite: Optional[str] = None
    #: the cohort dispatch of this run (TrainResult.cohort: cohort_size,
    #: cohort_lowering, cohort_dispatches, stack_mode); None for a
    #: sequential train() run. The JAX package's sweep-cache telemetry,
    #: under the same row key
    cache: Optional[dict] = None
    #: mean per-round decode-error norm (obs/decode.py): 0.0 for exact
    #: schemes, > 0 where the decode was approximate
    decode_error_mean: Optional[float] = None
    #: "ok", or "diverged" when the final params or the loss tail went
    #: NaN/Inf (the row is kept, rendered distinctly and left out of the
    #: target-loss aggregation)
    status: str = "ok"

    def row(self) -> dict:
        def fin(v, nd):
            # diverged rows carry NaN losses; round(NaN) would make
            # save_summaries emit non-strict JSON
            return round(v, nd) if v is not None and np.isfinite(v) else None

        out = {
            "label": self.label,
            "scheme": self.config.scheme.value,
            "n_stragglers": self.config.n_stragglers,
            "num_collect": self.config.num_collect,
            "status": self.status,
            "sim_total_time": round(self.sim_total_time, 4),
            "sim_steps_per_sec": round(self.sim_steps_per_sec, 4),
            "real_steps_per_sec": round(self.real_steps_per_sec, 2),
            "final_train_loss": fin(self.final_train_loss, 6),
            "final_test_loss": fin(self.final_test_loss, 6),
            "final_auc": fin(self.final_auc, 6),
            "time_to_target": round(self.time_to_target, 4)
            if self.time_to_target is not None
            else None,
            "decode_error_mean": round(self.decode_error_mean, 8)
            if self.decode_error_mean is not None
            else None,
        }
        if self.suite:
            out["suite"] = self.suite
        if self.note:
            out["note"] = self.note
        if self.cache is not None:
            out["cache"] = self.cache
        return out


def time_to_target_loss(
    training_loss: np.ndarray, timeset: np.ndarray, target: float
) -> Optional[float]:
    """Simulated wall-clock until train loss first reaches ``target``
    (cumulative sum of per-iteration times, the reference's total-elapsed
    clock, src/naive.py:155-156)."""
    reached = np.flatnonzero(training_loss <= target)
    if reached.size == 0:
        return None
    return float(np.cumsum(timeset)[reached[0]])


def plan_cohorts(configs: dict) -> list:
    """Group config labels into trajectory cohorts: ``[(labels, batchable),
    ...]`` in first-seen order. Each ``batchable=True`` group is one
    :func:`trainer.cohort_signature` key (one data stack, one lowering);
    an ineligible config comes back as its own ``batchable=False``
    singleton. Deduped stacks are scheme-independent, so a whole 7-scheme x
    N-seed compare() is one cohort."""
    groups: dict = {}
    order: list = []
    for label, cfg in configs.items():
        key = trainer.cohort_signature(cfg)
        if key is None:
            key = ("__sequential__", label)
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(label)
    return [(groups[k], k[0] != "__sequential__") for k in order]


def _train_one(label, configs, dataset, arrivals, device, init_params):
    return trainer.train(
        configs[label], dataset, device=device, arrivals=arrivals,
        init_params=None if init_params is None else init_params.get(label),
    )


def _dispatch_cohort(labels, configs, dataset, arrivals, device, init_params) -> dict:
    """One cohort through train_cohort; on ``torch.cuda.OutOfMemoryError``
    bisect into halves (half the live set per dispatch), bottoming out at
    sequential train() on the same device. Returns label -> TrainResult."""
    COUNTERS["cohort.dispatches"] += 1
    COUNTERS["cohort.trajectories"] += len(labels)
    try:
        results = trainer.train_cohort(
            [configs[l] for l in labels], dataset, arrivals=arrivals, device=device,
            init_params=None if init_params is None else [init_params[l] for l in labels],
        )
        return dict(zip(labels, results))
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
    if len(labels) == 1:
        COUNTERS["cohort.sequential_fallback"] += 1
        return {labels[0]: _train_one(labels[0], configs, dataset, arrivals, device, init_params)}
    mid = len(labels) // 2
    COUNTERS["cohort.split"] += 1
    out = _dispatch_cohort(labels[:mid], configs, dataset, arrivals, device, init_params)
    out.update(_dispatch_cohort(labels[mid:], configs, dataset, arrivals, device, init_params))
    return out


def _run_configs(
    configs: dict,
    dataset: Dataset,
    arrivals,
    batch: str,
    *,
    device=None,
    init_params=None,
    on_result: Optional[Callable] = None,
) -> dict:
    """Train every config, dispatching cohorts per the resolved ``batch``
    mode ("on"/"off"/"auto"); returns label -> TrainResult. Singletons under
    "auto", every config under "off" and ineligible configs run through
    sequential train(). ``on_result(label, result)`` is called as each
    result lands."""
    raw: dict = {}

    def finish(label, result):
        raw[label] = result
        if on_result is not None:
            on_result(label, result)

    if batch == "off":
        plan = [([label], False) for label in configs]
    else:
        plan = plan_cohorts(configs)
    min_size = 1 if batch == "on" else 2
    for labels, batchable in plan:
        if batchable and len(labels) >= min_size:
            results = _dispatch_cohort(
                list(labels), configs, dataset, arrivals, device, init_params
            )
            for label in labels:
                finish(label, results[label])
        else:
            for label in labels:
                COUNTERS["cohort.sequential_runs"] += 1
                finish(label, _train_one(label, configs, dataset, arrivals, device, init_params))
    return raw


def _diverged(result, ev, tail: int = 8) -> bool:
    """NaN/Inf anywhere in the final params, or in the tail of the
    training-loss curve."""
    for leaf in blocks.tree_leaves(result.final_params):
        if not bool(torch.isfinite(leaf).all()):
            return True
    tail_losses = np.asarray(ev.training_loss)[-tail:]
    return bool(tail_losses.size) and not bool(np.isfinite(tail_losses).all())


def _validate_shared_shape(configs: dict) -> None:
    """compare()'s paired-schedule contract: every config shares rounds and
    n_workers."""
    if not configs:
        raise ValueError("compare() needs at least one config")
    rounds = {c.rounds for c in configs.values()}
    workers = {c.n_workers for c in configs.values()}
    if len(rounds) != 1 or len(workers) != 1:
        detail = ", ".join(
            f"{label!r}: rounds={cfg.rounds}, workers={cfg.n_workers}"
            for label, cfg in configs.items()
        )
        raise ValueError(
            "compare() configs must share rounds and n_workers (one "
            f"arrival schedule pairs the whole set); got {detail}"
        )


def _default_target_loss(summaries: dict) -> Optional[float]:
    """compare()'s default loss target: 1.05x the uncoded baseline's final
    train loss when a converged 'naive' row exists, else the worst final
    loss across converged rows; None when nothing converged."""
    ok = {
        label: s
        for label, s in summaries.items()
        if s.status == "ok" and np.isfinite(s.final_train_loss)
    }
    if "naive" in ok:
        return 1.05 * float(ok["naive"].final_train_loss)
    if ok:
        return float(max(s.final_train_loss for s in ok.values()))
    return None


def compare(
    configs: dict,
    dataset: Dataset,
    target_loss: Optional[float] = None,
    arrivals: Optional[np.ndarray] = None,
    batch: Optional[str] = None,
    *,
    device=None,
    init_params: Optional[dict] = None,
) -> list:
    """Train every config on ``dataset`` under one shared arrival schedule
    and summarize, one :class:`RunSummary` per label in ``configs`` order.

    ``arrivals`` None draws that schedule (the reference's exponential
    stream), or replays the recorded trace the first config names
    (``arrival_trace``, else ``ERASUREHEAD_ARRIVAL_TRACE``).

    ``target_loss`` defaults to 1.05x the 'naive' row's final train loss if
    there is one, else the worst final loss (diverged rows left out).
    ``batch`` is the trajectory-batching mode ("on"/"off"/"auto"; None =
    :func:`utils.config.resolve_batch_trajectories`, which reads
    ``ERASUREHEAD_BATCH_TRAJECTORIES``): under "auto" and "on" the configs
    that share a data stack run as one cohort. ``device`` as in
    ``trainer.train`` (cuda unless "cpu" is asked for); ``init_params`` maps
    a label to its initial params (``train(init_params=...)``'s form).

    A trajectory whose final params or loss tail went NaN/Inf gets
    ``status="diverged"``, ``time_to_target=None``, and the sweep goes on."""
    _validate_shared_shape(configs)
    if arrivals is None:
        any_cfg = next(iter(configs.values()))
        # a recorded arrival trace (config field or env) replaces the drawn
        # exponential stream as the sweep's one shared schedule: the
        # paired-comparison contract holds either way
        arrivals = straggler.arrival_schedule(
            any_cfg.rounds, any_cfg.n_workers, add_delay=True,
            mean=any_cfg.delay_mean,
            trace=resolve_arrival_trace(any_cfg.arrival_trace),
        )
    summaries: dict = {}

    def finish(label, res):
        cfg = configs[label]
        n = res.n_train
        ev = evaluate.replay(
            trainer.build_model(cfg), cfg.model, res.params_history,
            dataset.X_train[:n], dataset.y_train[:n], dataset.X_test, dataset.y_test,
        )
        diverged = _diverged(res, ev)
        if diverged:
            COUNTERS["sweep.diverged"] += 1
        summaries[label] = RunSummary(
            label=label,
            config=res.config,
            sim_total_time=res.sim_total_time,
            sim_steps_per_sec=(
                res.config.rounds / res.sim_total_time
                if res.sim_total_time > 0
                else float("inf")  # zero arrival schedule (no delays)
            ),
            real_steps_per_sec=res.steps_per_sec,
            final_train_loss=float(ev.training_loss[-1]),
            final_test_loss=float(ev.testing_loss[-1]),
            final_auc=float(ev.auc[-1]),
            time_to_target=None,  # assigned below, once the target exists
            training_loss=ev.training_loss,
            timeset=res.timeset,
            cache=res.cohort,
            decode_error_mean=(
                float(np.mean(res.decode_error))
                if res.decode_error is not None and len(res.decode_error)
                else None
            ),
            status="diverged" if diverged else "ok",
        )

    _run_configs(
        configs, dataset, arrivals, resolve_batch_trajectories(batch),
        device=device, init_params=init_params, on_result=finish,
    )
    if target_loss is None:
        target_loss = _default_target_loss(summaries)
    for s in summaries.values():
        s.time_to_target = (
            time_to_target_loss(s.training_loss, s.timeset, target_loss)
            if s.status == "ok" and target_loss is not None
            else None
        )
    return [summaries[label] for label in configs]


def straggler_sweep(
    base: RunConfig,
    dataset: Dataset,
    scheme_stragglers: dict,
    **compare_kw,
) -> list:
    """The reference's headline figure: each scheme across straggler counts
    (time to target loss vs n_stragglers). A scheme whose descriptor has a
    ``sweep_num_collect`` hook collects that many workers where ``base``
    would collect all. ``compare_kw`` passes through to :func:`compare`."""
    if not scheme_stragglers or not any(scheme_stragglers.values()):
        raise ValueError(
            "straggler_sweep needs at least one (scheme, straggler-count) "
            f"entry; got {scheme_stragglers!r}"
        )
    configs = {}
    for scheme, s_values in scheme_stragglers.items():
        for s in s_values:
            cfg = dataclasses.replace(base, scheme=scheme, n_stragglers=s)
            collect_override = schemes.get(cfg.scheme).sweep_num_collect
            if collect_override is not None and cfg.num_collect >= cfg.n_workers:
                cfg = dataclasses.replace(cfg, num_collect=collect_override(cfg.n_workers))
            configs[f"{scheme}_s{s}"] = cfg
    return compare(configs, dataset, **compare_kw)


def save_summaries(summaries: Sequence[RunSummary], path: str) -> None:
    with open(path, "w") as f:
        json.dump([s.row() for s in summaries], f, indent=2)


def format_table(summaries: Sequence[RunSummary]) -> str:
    header = (
        f"{'label':22s} {'sim it/s':>9s} {'real it/s':>10s} "
        f"{'train loss':>11s} {'AUC':>7s} {'t->target':>10s} "
        f"{'dec err':>8s}"
    )
    lines = [header, "-" * len(header)]
    for s in summaries:
        auc = f"{s.final_auc:7.4f}" if np.isfinite(s.final_auc) else "      -"
        ttt = (
            f"{s.time_to_target:10.3f}"
            if s.time_to_target is not None
            else "         -"
        )
        derr = (
            f"{s.decode_error_mean:8.4f}"
            if s.decode_error_mean is not None
            else "       -"
        )
        # quarantined rows render distinctly: a NaN printed as a number
        # reads like a measurement
        loss = (
            f"{s.final_train_loss:11.6f}"
            if s.status == "ok" and np.isfinite(s.final_train_loss)
            else f"{'diverged' if s.status == 'diverged' else '-':>11s}"
        )
        lines.append(
            f"{s.label:22s} {s.sim_steps_per_sec:9.3f} "
            f"{s.real_steps_per_sec:10.1f} {loss} "
            f"{auc} {ttt} {derr}"
        )
    return "\n".join(lines)
