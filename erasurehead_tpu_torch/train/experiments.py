"""Experiment harness: the AGC vs EGC vs uncoded comparisons.

The port of erasurehead_tpu/train/experiments.py. The reference's
experimental frame: for each scheme and straggler count, train under the
same seeded delay schedule and compare (a) the effective iteration rate and
(b) the time to a target loss, both on the simulated master clock.

:func:`compare` runs a set of configs on one dataset under one shared
arrival schedule (a paired comparison) and summarizes each run;
:func:`straggler_sweep` is the reference's headline figure, each scheme
across straggler counts; :func:`baseline_suite` the five BASELINE.json
configs, which :func:`main` (``python -m
erasurehead_tpu_torch.train.experiments``, or the CLI's ``sweep``
subcommand) runs and prints. Configs that share a device data stack
(:func:`plan_cohorts`) run as one trajectory cohort
(train/trainer.train_cohort): a deduped 7-scheme x 4-seed sweep reads X
once a round for all 28 trajectories instead of 28 times.

A sweep journal (train/journal.py) makes a sweep preemption-safe: each
trajectory's row is journaled as it finishes, and a resumed sweep
rehydrates the journaled rows instead of training them again.

A cohort that runs out of device memory (``torch.cuda.OutOfMemoryError``,
or a chaos ``raise`` at site ``cohort`` whose message carries an
out-of-memory marker, utils/chaos.py) is bisected into halves, down to
sequential ``train()`` on the same device, after the data cache's pins are
dropped: the JAX package's own degradation. Every other exception
propagates untouched, a kernel's launch failure included: nothing is
retried.

Run telemetry: ``main --events PATH`` captures the whole suite into one
events.jsonl (obs/events.capture; render it with the CLI's ``report``). The
harness's own degradations are ``warning`` records, as in the JAX package:
``cohort_dispatch`` (a cohort failed), ``cohort_split`` (it was bisected),
``cohort_fallback`` (a singleton went to sequential ``train()``) and
``divergence`` (a quarantined row).

:data:`COUNTERS` reads the harness's counters from the metrics registry
(obs/metrics.py) under the JAX package's names.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from collections.abc import Mapping
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from erasurehead_tpu_torch import schemes
from erasurehead_tpu_torch.data.synthetic import Dataset
from erasurehead_tpu_torch.obs import events as obs_events
from erasurehead_tpu_torch.obs.metrics import REGISTRY as _METRICS
from erasurehead_tpu_torch.obs.metrics import warn_once
from erasurehead_tpu_torch.ops import blocks
from erasurehead_tpu_torch.parallel import straggler
from erasurehead_tpu_torch.train import cache as cache_lib
from erasurehead_tpu_torch.train import evaluate, trainer
from erasurehead_tpu_torch.train import journal as journal_lib
from erasurehead_tpu_torch.utils import chaos as chaos_lib
from erasurehead_tpu_torch.utils.config import (
    ModelKind,
    RunConfig,
    resolve_arrival_trace,
    resolve_batch_trajectories,
    resolve_resume_sweep,
    resolve_sweep_journal,
)


class _CounterView(Mapping):
    """Read-only view of named registry counters."""

    def __init__(self, names):
        self._names = tuple(names)

    def __getitem__(self, name):
        if name not in self._names:
            raise KeyError(name)
        return _METRICS.counter(name).value

    def __iter__(self):
        return iter(self._names)

    def __len__(self):
        return len(self._names)


#: dispatch counters since the last :func:`reset_counters`:
#:   cohort.dispatches       train_cohort calls (one a cohort, one a half)
#:   cohort.trajectories     trajectories handed to those calls
#:   cohort.sequential_runs  train() calls of the plan (singletons, "off")
#:   cohort.split            cohorts bisected after running out of memory
#:   cohort.sequential_fallback  trajectories sent to train() by that bisection
#:   sweep.diverged          rows quarantined as diverged
COUNTERS = _CounterView((
    "cohort.dispatches", "cohort.trajectories", "cohort.sequential_runs",
    "cohort.split", "cohort.sequential_fallback", "sweep.diverged",
))


def reset_counters() -> None:
    for name in COUNTERS:
        _METRICS.counter(name).reset()


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


def _arrivals_for(arrivals, label):
    """One trajectory's arrival matrix when ``arrivals`` may be a per-label
    dict (the what-if engine gives every (point, seed) trajectory its own
    draw); a shared matrix / None passes through untouched."""
    if isinstance(arrivals, dict):
        return arrivals[label]
    return arrivals


def _arrivals_arg(arrivals, labels):
    """The ``arrivals`` argument for a ``train_cohort`` dispatch of
    ``labels``: a per-label dict becomes the per-trajectory list
    train_cohort expects (in label order); anything else passes through."""
    if isinstance(arrivals, dict):
        return [arrivals[l] for l in labels]
    return arrivals


def _train_one(label, configs, dataset, arrivals, device, init_params):
    return trainer.train(
        configs[label], dataset, device=device, arrivals=_arrivals_for(arrivals, label),
        init_params=None if init_params is None else init_params.get(label),
    )


#: substrings that make an injected cohort fault (utils/chaos.py, site
#: "cohort") an out-of-memory failure: the JAX package's markers
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory")


def _dispatch_cohort(labels, configs, dataset, arrivals, device, init_params) -> dict:
    """One cohort through train_cohort; on ``torch.cuda.OutOfMemoryError``
    (or an injected chaos fault whose message carries an out-of-memory
    marker) drop the data cache's pins, then bisect into halves (half the
    live set per dispatch), bottoming out at sequential train() on the same
    device. Any other injected fault propagates. ``arrivals`` is a shared
    matrix, None, or a per-label dict, which threads through the halves and
    the sequential fallback. Returns label -> TrainResult."""
    _METRICS.counter("cohort.dispatches").inc()
    _METRICS.counter("cohort.trajectories").inc(len(labels))
    try:
        results = trainer.train_cohort(
            [configs[l] for l in labels], dataset, arrivals=_arrivals_arg(arrivals, labels),
            device=device,
            init_params=None if init_params is None else [init_params[l] for l in labels],
        )
        return dict(zip(labels, results))
    except (torch.cuda.OutOfMemoryError, chaos_lib.ChaosInjection) as e:
        if isinstance(e, chaos_lib.ChaosInjection) and not any(
            m in str(e) for m in _OOM_MARKERS
        ):
            raise
        head = (str(e).splitlines() or [type(e).__name__])[0][:160]
        obs_events.emit(
            "warning",
            kind="cohort_dispatch",
            message=(
                f"cohort dispatch failed (oom) for {len(labels)} "
                f"trajectories {list(labels)}: {head}"
            ),
        )
        warn_once(
            "cohort_dispatch",
            f"sweep: cohort dispatch failed (oom); degrading via bisection "
            f"— first failure: {list(labels)}: {head}",
        )
        # the halves re-upload what they need, without contending with
        # stacks no live run is using
        cache_lib.drop_data_cache()
        torch.cuda.empty_cache()
    if len(labels) == 1:
        _METRICS.counter("cohort.sequential_fallback").inc()
        obs_events.emit(
            "warning",
            kind="cohort_fallback",
            message=(
                f"trajectory {labels[0]!r} falls back to sequential "
                f"train() after cohort dispatch failure"
            ),
        )
        return {labels[0]: _train_one(labels[0], configs, dataset, arrivals, device, init_params)}
    mid = len(labels) // 2
    _METRICS.counter("cohort.split").inc()
    obs_events.emit(
        "warning",
        kind="cohort_split",
        message=(
            f"bisecting failed cohort {list(labels)} -> {list(labels[:mid])} + "
            f"{list(labels[mid:])}"
        ),
    )
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
                _METRICS.counter("cohort.sequential_runs").inc()
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
    journal=None,
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

    ``journal`` is a :class:`train.journal.SweepJournal` (None = the ambient
    ``ERASUREHEAD_SWEEP_JOURNAL`` journal, if any): every finished
    trajectory's row is journaled as it completes, and in resume mode a
    trajectory whose (label, config, data, arrivals) key is journaled
    already is rehydrated instead of trained. ``time_to_target`` is derived
    from the curves for fresh and rehydrated rows alike, so a resumed
    sweep's rows equal an uninterrupted one's. After each row the
    ``"trajectory"`` chaos site fires (utils/chaos.py).

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
    if journal is None:
        journal = journal_lib.from_env()
    keys: dict = {}
    summaries: dict = {}
    pending: dict = {}
    for label, cfg in configs.items():
        if journal is not None:
            keys[label] = journal_lib.trajectory_key(label, cfg, dataset, arrivals)
            rec = journal.lookup(keys[label])
            if rec is not None:
                summaries[label] = journal_lib.rehydrate_summary(rec["row"], cfg)
                _METRICS.counter("sweep_journal.resumed").inc()
                continue
        pending[label] = cfg

    def finish(label, res):
        """Per-trajectory completion: eval replay, divergence quarantine,
        journal append, chaos site; an interruption loses at most the
        in-flight dispatch."""
        cfg = pending[label]
        n = res.n_train
        ev = evaluate.replay(
            trainer.build_model(cfg), cfg.model, res.params_history,
            dataset.X_train[:n], dataset.y_train[:n], dataset.X_test, dataset.y_test,
        )
        diverged = _diverged(res, ev)
        if diverged:
            _METRICS.counter("sweep.diverged").inc()
            obs_events.emit(
                "warning",
                kind="divergence",
                message=(
                    f"trajectory {label!r} (scheme "
                    f"{res.config.scheme.value}, seed {res.config.seed}) "
                    "diverged (NaN/Inf final params or loss tail); row "
                    "quarantined as status=diverged, sweep continues"
                ),
            )
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
        if journal is not None:
            journal.record(keys[label], label, summaries[label])
        chaos_lib.maybe_fire("trajectory")

    if pending:
        _run_configs(
            pending, dataset, arrivals, resolve_batch_trajectories(batch),
            device=device, init_params=init_params, on_result=finish,
        )
    # one shared target across rehydrated and fresh rows, derived from the
    # (bit-stable) curves: a resumed sweep and an uninterrupted one agree
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


#: reference nnz a row of the real one-hot matrices: covtype's binned
#: one-hot has 12 active categories a row, amazon's hashed-interaction
#: encoding 44 (the JAX package's tests/test_data.py pins both)
ONEHOT_NNZ = {"covtype": 12, "amazon": 44}

#: caveat attached to every synthetic stand-in classification row, so a
#: saved row cannot be misread as divergent or random
STANDIN_NOTE = (
    "synthetic stand-in: labels drawn from a unit-logit-variance "
    "logistic model (data/synthetic.generate_*), whose Bayes-optimal "
    "classifier has log-loss ~0.60 and AUC ~0.74 (Monte-Carlo) — "
    "train loss near 0.60 is AT the generator's floor, not underfit"
)


def baseline_suite(
    scale: float = 1.0,
    data_dir: Optional[str] = None,
    rounds: int = 100,
    batch: Optional[str] = None,
    journal=None,
    *,
    device=None,
    init_params: Optional[dict] = None,
) -> dict:
    """Reproduce the five BASELINE.json comparison configs.

    Real datasets (covtype / amazon / kc_house) are used when prepared under
    ``data_dir`` in the reference layout; otherwise each config falls back to
    a synthetic stand-in of the same structure (one-hot CSR with the real
    set's nnz a row for covtype and amazon, linear-model data for
    least-squares, GMM otherwise) at ``scale`` x a canonical size, and the
    suite labels record the substitution. Returns {config_name: summaries}.
    ``batch`` and ``journal`` thread into every :func:`compare` (a journal
    makes the whole suite preemption-safe); ``device`` as in
    ``trainer.train``. ``init_params`` maps a row label ("naive",
    "cyccoded_s2", "agc_collect_N-3", "avoidstragg_s1", ...,
    "partialrepcoded_s3", "mlp_agc") to its initial params, e.g. a JAX
    run's draw for parity."""
    from erasurehead_tpu_torch.data import io as data_io
    from erasurehead_tpu_torch.data.synthetic import (
        generate_gmm,
        generate_linear,
        generate_onehot,
    )

    def _rows(rows, parts):
        n = max(parts * 8, int(rows * scale))
        return parts * max(1, round(n / parts))  # a multiple of n_partitions

    _cache: dict = {}

    def get_data(name, parts, fallback):
        """Prepared real dataset if present under data_dir, else a synthetic
        stand-in of the same structure. Memoized per (name, parts)."""
        key = (name, parts)
        if key in _cache:
            return _cache[key]
        if data_dir is not None:
            path = os.path.join(data_dir, name, str(parts))
            if data_io.has_reference_layout(path):
                _cache[key] = (data_io.read_reference_layout(path, parts), name)
                return _cache[key]
        rows, cols = fallback
        if name in ONEHOT_NNZ:
            # one-hot CSR with the real dataset's nnz a row, so the suite
            # takes the sparse path the actual workload would take
            nnz = min(ONEHOT_NNZ[name], cols)
            ds = generate_onehot(_rows(rows, parts), cols, parts, n_fields=nnz, seed=0)
        else:
            maker = (
                generate_linear
                if name in ("kc_house_data", "synthetic-linear")
                else generate_gmm
            )
            ds = maker(_rows(rows, parts), cols, parts, seed=0)
        _cache[key] = (ds, f"synthetic({name}-shaped)")
        return _cache[key]

    def preset_cfg(dataset_name, ds, src=None, **kw):
        """Config carrying the dataset's reference lr preset (main.py:37-46)
        and alpha = 1/n_train for the data in use. A synthetic stand-in of
        a real classification set runs at a stand-in-convergent constant lr
        (the real set's preset does not transfer): the stable constant lr
        scales as 1/nnz a row (1.0 at nnz 12); ``artificial`` keeps its
        preset, and the linear preset transfers as is."""
        n_train = ds.X_train.shape[0]
        cfg = RunConfig.for_dataset(
            dataset_name, rounds=rounds, add_delay=True,
            **{"n_rows": n_train, "n_cols": ds.X_train.shape[1], **kw},
        )
        is_standin = src is not None and src != dataset_name
        if (is_standin and dataset_name != "artificial"
                and cfg.model is not ModelKind.LINEAR
                and "lr_schedule" not in kw):
            nnz = ONEHOT_NNZ.get(dataset_name)
            cfg = dataclasses.replace(
                cfg, lr_schedule=1.0 if nnz is None else min(1.0, 12.0 / nnz)
            )
        return cfg

    def tag(summaries, name, src=None, dataset_name=None):
        """Record the suite config name on each row, and annotate stand-in
        classification rows with the generator's ceiling."""
        for s in summaries:
            s.suite = name
            if (src is not None and src != dataset_name
                    and s.config.model is not ModelKind.LINEAR):
                s.note = STANDIN_NOTE
        return summaries

    def run(configs, ds, **kw):
        inits = None
        if init_params is not None:
            inits = {label: init_params[label] for label in configs if label in init_params}
        return compare(configs, ds, batch=batch, journal=journal, device=device,
                       init_params=inits or None, **kw)

    out: dict = {}

    # 1. Logistic on covtype, uncoded, 8 workers (BASELINE.json configs[0])
    W = 8
    ds, src = get_data("covtype", W, (2048, 64))
    cfg = preset_cfg(
        "covtype", ds, src, scheme="naive", n_workers=W, n_stragglers=0,
        update_rule="GD",
    )
    name = f"1_naive_covtype[{src}]"
    out[name] = tag(run({"naive": cfg}, ds), name, src, "covtype")

    # 2. Logistic on amazon, exact cyclic-MDS coding, s=2 (configs[1])
    ds, src = get_data("amazon", W, (2048, 64))
    cfg = preset_cfg(
        "amazon", ds, src, scheme="cyccoded", n_workers=W, n_stragglers=2,
        update_rule="AGD",
    )
    name = f"2_egc_amazon[{src}]"
    out[name] = tag(run({"cyccoded_s2": cfg}, ds), name, src, "amazon")

    # 3. Least-squares on kc_house, AGC with num_collect=N-3 (configs[2])
    W3 = 9  # AGC needs (s+1) | W
    ds, src = get_data("kc_house_data", W3, (2048, 64))
    cfg = preset_cfg(
        "kc_house_data", ds, src, scheme="approx", model=ModelKind.LINEAR,
        n_workers=W3, n_stragglers=2, num_collect=W3 - 3, update_rule="AGD",
    )
    name = f"3_agc_kc_house[{src}]"
    out[name] = tag(run({"agc_collect_N-3": cfg}, ds), name, src, "kc_house_data")

    # 4. Synthetic: partial_replication vs avoidstragg over n_stragglers
    #    (configs[3]): partial and plain schemes need different partition
    #    counts, so per-config compares share one arrival schedule, then
    #    time_to_target is re-anchored on one shared loss target
    W4 = 12
    arr = straggler.arrival_schedule(rounds, W4, add_delay=True, mean=0.5)
    sweep: list = []
    for s in (1, 2, 3):
        for scheme, ppw in (
            ("avoidstragg", 0),
            # ppw = n_separate (2 unique) + (s+1) replicated slots
            ("partialrepcoded", s + 3),
        ):
            parts = (ppw - s) * W4 if ppw else W4
            d, _ = get_data("artificial", parts, (2048, 64))
            c = preset_cfg(
                "artificial", d, scheme=scheme, n_workers=W4, n_stragglers=s,
                update_rule="AGD", partitions_per_worker=ppw,
            )
            sweep.extend(run({f"{scheme}_s{s}": c}, d, arrivals=arr))
    # diverged rows stay out of the anchor: a NaN min() would void every
    # row's time_to_target
    anchors = [
        s.final_train_loss
        for s in sweep
        if s.status == "ok" and np.isfinite(s.final_train_loss)
    ]
    shared_target = 1.05 * min(anchors) if anchors else None
    for s in sweep:
        s.time_to_target = (
            time_to_target_loss(s.training_loss, s.timeset, shared_target)
            if shared_target is not None and s.status == "ok"
            else None
        )
    out["4_partialrep_vs_avoidstragg_sweep"] = tag(
        sweep, "4_partialrep_vs_avoidstragg_sweep"
    )

    # 5. 2-layer MLP on covtype-shaped data, AGC (configs[4])
    ds, src = get_data("covtype", W, (2048, 64))
    cfg = preset_cfg(
        "covtype", ds, src, scheme="approx", model=ModelKind.MLP, n_workers=W,
        n_stragglers=1, num_collect=W - 2, update_rule="GD",
    )
    name = f"5_mlp_agc[{src}]"
    out[name] = tag(run({"mlp_agc": cfg}, ds), name, src, "covtype")
    return out


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


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m erasurehead_tpu_torch.train.experiments`` (and the CLI's
    ``sweep`` subcommand): run the BASELINE.json suite (scaled down by
    default) and print its tables."""
    import argparse

    p = argparse.ArgumentParser(prog="erasurehead-tpu-torch-experiments")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--rounds", type=int, default=30)
    p.add_argument("--data-dir", default=None, help="prepared real data root")
    p.add_argument("--out", default=None, help="write summaries JSON here")
    p.add_argument("--figures", default=None,
                   help="render comparison PNGs into this directory "
                        "(needs matplotlib)")
    p.add_argument("--events", default=None,
                   help="write a run-telemetry events.jsonl for the whole "
                        "suite here (obs/; render with the CLI's report)")
    p.add_argument("--batch-trajectories", default=None,
                   choices=["on", "off", "auto"],
                   help="trajectory-batched sweep dispatch "
                        "(trainer.train_cohort): configs sharing a device "
                        "data stack run as ONE cohort round loop. Default: "
                        "ERASUREHEAD_BATCH_TRAJECTORIES env, else auto "
                        "(batch cohorts of >= 2)")
    p.add_argument("--sweep-journal", default=None, metavar="DIR",
                   help="journal each trajectory's summary row into "
                        "DIR/sweep_journal.jsonl as it finishes "
                        "(train/journal.py): the suite becomes "
                        "preemption-safe. Default: "
                        "ERASUREHEAD_SWEEP_JOURNAL env, else off")
    p.add_argument("--resume-sweep", action="store_true",
                   help="skip trajectories the sweep journal already "
                        "completed (matching config + data + arrival "
                        "digests), rehydrating their rows: a resumed "
                        "suite's output is row-for-row identical to an "
                        "uninterrupted one. Requires --sweep-journal (or "
                        "the env var); ERASUREHEAD_RESUME_SWEEP=1 does "
                        "the same")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the suite computes; cuda raises when there is no card")
    ns = p.parse_args(argv)

    journal_dir = resolve_sweep_journal(ns.sweep_journal)
    resume = resolve_resume_sweep(True if ns.resume_sweep else None)
    if resume and journal_dir is None:
        p.error("--resume-sweep requires --sweep-journal DIR (or "
                "ERASUREHEAD_SWEEP_JOURNAL)")
    journal = (
        journal_lib.SweepJournal(journal_dir, resume=resume) if journal_dir else None
    )
    sink = obs_events.capture(ns.events) if ns.events else contextlib.nullcontext()
    try:
        with sink:
            suite = baseline_suite(
                scale=ns.scale, data_dir=ns.data_dir, rounds=ns.rounds,
                batch=ns.batch_trajectories, journal=journal, device=ns.device,
            )
    finally:
        if journal is not None:
            journal.close()
    if journal is not None:
        print(f"sweep journal -> {journal.path}")
    all_rows: list = []
    for name, summaries in suite.items():
        print(f"\n== {name} ==")
        print(format_table(summaries))
        all_rows.extend(summaries)
        if ns.figures:
            from erasurehead_tpu_torch.train import plots

            fig = plots.save_comparison_figure(
                summaries, os.path.join(ns.figures, f"{name}.png"), title=name
            )
            if fig:
                print(f"figure -> {fig}")
    if ns.out:
        save_summaries(all_rows, ns.out)
        print(f"\nsummaries -> {ns.out}")
    if ns.events:
        print(f"events -> {ns.events} (render: python -m erasurehead_tpu_torch.cli report)")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
