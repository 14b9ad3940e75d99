"""Structured JSONL event log: the machine-readable record of a run.

The port of erasurehead_tpu/obs/events.py. One line per event, every line a
JSON object with three envelope fields, ``type`` (one of :data:`SCHEMA`),
``seq`` (monotonic per logger) and ``t`` (unix seconds), plus the type's
payload. The schema is the JAX package's whole schema, serve and fleet
records included, so this validator accepts every file the JAX package's
does and returns the same error strings.

Contract: emission is host-side and happens after a trainer's timed round
loop. Telemetry observes and never changes a run: with a capture on or off
(and a ``--trace-dir`` trace on or off) the params, clocks, masks and kernel
launch counts are bitwise equal. The trainers emit into whatever logger
:func:`capture` has installed, and every :func:`emit` also reaches the
in-process observers (:func:`add_observer`, obs/timeseries.py); with neither
installed every ``emit`` is a no-op, so library callers pay nothing.

Deviation from the JAX package: :class:`EventLogger` opens in append mode
by default (the JAX package's default is "w"); :func:`capture` still
truncates.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import itertools
import json
import os
import threading
import time
from typing import IO, Iterable, Optional

import numpy as np

#: record type -> required payload keys (the envelope ``type``/``seq``/``t``
#: is always present). Optional fields may ride along; unknown TYPES are a
#: validation error — add new types here first.
SCHEMA: dict[str, tuple] = {
    # one per run: identity of what was trained and how it lowered
    "run_start": ("run_id", "scheme", "platform", "config_hash", "mesh"),
    # one per AOT chunk compile (hit or miss) of the training executable
    "compile": ("run_id", "seconds", "cache_hit"),
    # one per device-data stacking/upload (hit = stacks reused)
    "data_upload": ("run_id", "bytes", "cache_hit"),
    # chunked per-round telemetry: simulated clock + masked arrival stats
    "rounds": ("run_id", "first_round", "n_rounds", "sim_time_s"),
    # chunked per-round AGC decode-error norms (obs/decode.py). An
    # optional ``layer`` field (non-negative int) tags a per-layer
    # gradient-space series under blockwise coding (obs/decode.
    # block_decode_error): each (run_id, trajectory, layer) triple is its
    # own monotone round stream — the decode-error-vs-depth record
    "decode": ("run_id", "first_round", "n_rounds", "error_mean",
               "error_max", "exact"),
    # eval replay summary (emitted by callers that run the eval, e.g. cli)
    "eval": ("run_id", "final_train_loss", "final_test_loss"),
    # anomaly channel (recompile detector, obs/detect.py)
    "warning": ("kind", "message"),
    # one per trajectory-batched cohort dispatch (trainer.train_cohort):
    # composition (schemes/seeds) and how many compiled dispatches the
    # cohort cost — the record behind report's "7 schemes x 4 seeds = N
    # dispatches" line
    "cohort": ("run_id", "n_trajectories", "schemes", "seeds",
               "dispatches"),
    # one per run: the wall-clock / cache / arrival / decode summary the
    # report command renders (obs/report.py)
    "run_end": ("run_id", "wall_time_s", "steps_per_sec"),
    # registry snapshot written once when a capture closes (obs/metrics.py)
    "metrics": ("snapshot",),
    # sweep-journal record (train/journal.py): one per finished sweep
    # trajectory — its identity key (config signature + data/arrival
    # digest), completion status ("ok" | "diverged"), and the full
    # RunSummary rehydration payload that lets --resume-sweep reproduce the
    # row without re-training. The journal file is an events.jsonl like any
    # other (same envelope, same validator).
    "sweep_trajectory": ("key", "label", "status", "row"),
    # serve daemon (the JAX package's serve/; the port's
    # serve plane is still to come): one per accepted client
    # request — which tenant asked for which trajectory
    "request": ("tenant", "request_id", "label"),
    # one per packed cohort the packer hands to the dispatch engine:
    # how many pending trajectories (across how many tenants) share this
    # dispatch — the record behind report's packed-dispatch ratio
    "pack": ("n_trajectories", "labels", "tenants"),
    # one per admission decision: the cohort's estimated device footprint
    # against the serve budget ("admitted" rides along as an optional
    # field; admitted=false = the request QUEUES instead of joining)
    "admit": ("est_bytes", "budget_bytes"),
    # one per admission-pressure eviction: the controller dropped the
    # sweep data cache's HBM pins (or timed a request out of the packing
    # window) to make room — "reason" says which
    "evict": ("reason",),
    # one per backpressure rejection (HTTP 429 / socket "rejected" /
    # in-process ServeOverloadedError): which tenant was pushed back and
    # why ("overloaded" when the intake queue crossed its high-water
    # mark, "unauthorized" when an HTTP bearer token failed). The
    # optional ``retry_after_s`` is the deferral-derived schedule quote
    # the client's capped-exponential backoff honors.
    "reject": ("tenant", "reason"),
    # one per result-streaming lifecycle transition on a network front
    # connection: "event" says which ("open" when a reader attaches,
    # "overflow" when a slow reader's bounded outbox dropped journaled
    # rows — the client re-fetches by resubmitting, "close" when the
    # reader detaches). Optional ``dropped`` counts rows shed so far.
    "stream": ("tenant", "event"),
    # one per daemon warm restart (serve/wal.py replay): how many intake
    # WAL records were read, how many re-dispatched because their rows
    # were not yet journaled, and how many rehydrated straight from the
    # per-tenant journals without a dispatch
    "restart": ("wal_records", "resubmitted", "rehydrated"),
    # one per adaptive-controller decision (adapt/driver.py): which
    # (scheme, collect, deadline) arm ran the chunk starting at "round",
    # and why (warmup / exploit / explore / regime_shift). Seeded and
    # telemetry-driven, so a resumed run replays the identical sequence —
    # the event log is the decision journal.
    "adapt": ("round", "arm", "reason"),
    # one per elastic-membership decision or completed chunk
    # (elastic/driver.py): "action" says what happened at chunk-boundary
    # "round" — a worker declared dead from its own telemetry (the -1
    # sentinel persisting / detect_dead tripping), a join accepted, a
    # re-layout onto n_workers workers, a collapsed-arrival probe, or a
    # finished chunk's science row ("chunk" records carry the sim clock,
    # decode-error mean and params digest that make a killed->resumed run
    # rehydrate its rows bitwise from this journal). Deterministic given
    # (config, world, chaos env), so the event log doubles as the
    # membership decision journal.
    "membership": ("round", "action", "n_workers"),
    # one per what-if engine phase (whatif/): "kind" says
    # which — "grid" after feasibility enumeration (point counts ride
    # along), "point" per reduced surface row (label + feasibility +
    # expected time-to-target), "surface" when the artifact saves,
    # "rehydrate" when an identical spec loads the saved surface instead
    # of re-simulating. Every record carries the grid's spec_hash, so a
    # surface artifact is attributable to its event stream and a
    # rehydrated run is distinguishable from a simulated one.
    "whatif": ("spec_hash", "kind"),
    # one per staged partition window of a streamed run
    # (data/prefetch.Prefetcher): which window index moved how many
    # host→device bytes over which partition ranges. ``ranges`` is the
    # staged span in consume order — a list of [lo, hi) pairs, one when
    # the window is a plain contiguous slice, two when an
    # assignment-aware plan's halo wraps past the partition count
    # (data/sharding.StreamWindowPlan). The optional window-plan fields
    # ``plan_mode`` (:data:`STREAM_PLAN_MODES`), ``halo`` and
    # ``group_workers`` say which body the window serves; ``fetch_s`` /
    # ``partitions`` carry the stage's disk+PCIe seconds and its first
    # range — the per-window record behind the report's prefetch
    # section and the bench extra's overlap-efficiency figure
    "prefetch": ("run_id", "window", "bytes", "ranges"),
    # one per shard-store disk transaction (data/store.py): "kind" says
    # which (:data:`IO_KINDS` — a window read off the mmapped shards, or
    # a store write by data/prepare.py) and ``bytes`` how much moved
    "io": ("kind", "bytes"),
    # one per pipelined run (cfg.pipeline_depth > 0; parallel/pipeline.py):
    # how far ahead of the synchronous round barrier the dispatches ran —
    # mean/max per-round dispatch-ahead seconds and the total overlap the
    # pipeline bought (the simulated-clock win's direct record, emitted
    # host-side from the precomputed schedule: zero compiles)
    "dispatch_ahead": ("run_id", "first_round", "n_rounds",
                      "pipeline_depth", "ahead_mean_s", "ahead_max_s",
                      "overlap_total_s"),
    # one per pipelined run's post-hoc error decomposition (obs/decode.
    # emit_staleness_split, invoked by tools — needs an eval replay, so
    # never emitted from inside train()): mean gradient-space staleness
    # error ||g_stale - g_fresh|| vs coding error ||g_hat - g_full||, and
    # staleness's share of the combined error — the record that says
    # whether tau=1 noise or erasure-coding noise dominates the regime
    "stale_decode": ("run_id", "first_round", "n_rounds",
                     "staleness_error_mean", "coding_error_mean",
                     "staleness_share"),
    # one per run: the wall-clock attribution ledger (obs/critical_path.py)
    # — where the run's measured host wall and simulated master clock
    # actually went. ``components`` attributes the HOST wall (decode+update
    # execution vs prefetch-stall vs compile, real seconds of the timed
    # region); ``sim_components`` attributes the SIMULATED clock
    # (fastest-arrival compute floor vs straggler-wait vs pipelined
    # dispatch-gap). Each ledger's values must sum to its measured total
    # within 5% — the validator enforces the reconciliation, so a ledger
    # that silently drops a bucket is a schema error, not a report footnote
    "critical_path": ("run_id", "wall_s", "sim_total_s", "components",
                      "sim_components", "fractions"),
    # arrival-regime estimator output (obs/regime.py): the rolling
    # exp-rate + heavy-tail classification of the masked arrival stream
    # at round ``round``, and whether a change-point fired there.
    # ``rate`` is 1/mean of the rolling window (arrivals/sim-second);
    # optional ``tail_index`` carries the Hill estimate behind the kind
    "regime": ("round", "kind", "rate", "n", "shifted"),
    # one per SLO tracker evaluation window (obs/exporter.SloTracker):
    # the tenant's time-to-last-row SLO, how many requests the window
    # scored, how many breached, and the burn rate (breach fraction /
    # error budget — > 1 means the budget is burning faster than allowed)
    "slo": ("tenant", "slo_s", "window_requests", "breaches",
            "burn_rate"),
    # one per serve-fleet membership/deploy action (serve/fleet.py,
    # serve/router.py, server.adopt_wal): "action" says what happened to
    # "replica" (:data:`FLEET_ACTIONS`) — a completed health probe, a
    # replica whose evidential miss streak is growing ("suspect" carries
    # ``streak``/``k``), a death declared after K consecutive evidential
    # misses, a peer adopting a dead replica's intake WAL ("adopt"
    # carries ``records``), a rolling-deploy phase transition
    # ("deploy_phase" carries ``phase``), a replica joining the ring, or
    # a router failover redirect ("route" carries ``endpoint``). The
    # fleet's decision journal: zero-downtime drills are attributable
    # record by record.
    "fleet": ("action", "replica"),
    # one per autotune-decision resolution (tune/):
    # which race's verdict resolved an auto knob, at which shape
    # signature on which device kind, and where the choice came from
    # ("race" = a racer run just measured it, "cache" = the persisted
    # decision cache, "default" = no cached decision — the hardcoded
    # fallback stood). Observation-only and process-deduped: resolution
    # reads the cache, never the event stream, so telemetry on/off
    # cannot change a single lowering choice
    "tune": ("race", "device_kind", "shape", "choice", "source"),
}

#: adapt decision reasons (adapt/controller.AdaptiveController.choose)
ADAPT_REASONS = ("warmup", "exploit", "explore", "regime_shift")

#: arrival-regime classifications (obs/regime.ArrivalRegimeEstimator):
#: "exp" = light (exponential-like) tail, "heavytail" = Pareto-like tail
#: by the rolling Hill index, "unknown" = not enough masked arrivals yet
REGIME_KINDS = ("exp", "heavytail", "unknown")

#: critical-path reconciliation tolerance: each attribution ledger's
#: component sum must land within this fraction of its measured total
#: (the acceptance bar the validator enforces on every critical_path line)
CRITICAL_PATH_TOL = 0.05

#: membership actions (elastic/controller.py): deaths/joins are detector
#: decisions, "relayout" commits them into a fresh W'-worker layout,
#: "probe" marks a collapsed-arrival re-evaluation, "chunk" is a finished
#: chunk's journal row
MEMBERSHIP_ACTIONS = ("death", "join", "relayout", "probe", "chunk")

#: result-stream lifecycle events (serve network fronts): a reader
#: attached, a slow reader's bounded outbox shed journaled rows, a
#: reader detached
STREAM_EVENTS = ("open", "overflow", "close")

#: streamed window-plan modes (data/sharding.plan_stream_windows): the
#: body the staged window serves — partition-major deduped, worker-major
#: materialized faithful, or the ring-transport faithful body
STREAM_PLAN_MODES = ("deduped", "materialized", "ring")

#: backpressure rejection reasons (serve/server.py + serve/http_front.py)
REJECT_REASONS = ("overloaded", "unauthorized")

#: what-if engine phases (whatif/engine.py): "grid" = enumeration +
#: feasibility filter, "point" = one reduced surface row, "surface" =
#: artifact saved, "rehydrate" = identical spec served from its artifact
WHATIF_KINDS = ("grid", "point", "surface", "rehydrate")

#: shard-store io transaction kinds (data/store.py): a windowed read off
#: the mmapped shards, or a store write (data/prepare.py ``--store``)
IO_KINDS = ("shard_read", "store_write")

#: serve-fleet actions (serve/fleet.py + serve/router.py): "probe" = a
#: completed health probe (ok or evidential miss), "suspect" = a growing
#: consecutive-miss streak short of K, "declare_dead" = the K-streak rule
#: fired (never a single timeout), "adopt" = a peer adopted the dead
#: replica's intake WAL, "deploy_phase" = a rolling-deploy transition,
#: "join" = a replica (re)entered the ring, "route" = a router failover
#: redirect away from an unreachable primary
FLEET_ACTIONS = (
    "probe", "suspect", "declare_dead", "adopt", "deploy_phase",
    "join", "route",
)

#: sweep_trajectory completion statuses (train/journal.py); "diverged"
#: rows are quarantined, not retried — divergence is deterministic under
#: the journaled (config, data, arrivals) key
TRAJECTORY_STATUSES = ("ok", "diverged")

#: autotune races (tune.TUNE_CHOICES keys):
#: every "tune" event's ``race`` field must name one of these knob pairs
TUNE_RACES = (
    "block_decode", "glm_fused", "layer_coding", "ring_pipeline",
    "stack_mode",
)

#: where a tune decision came from: a just-run race, the persisted
#: decision cache, or the hardcoded fallback (no cached verdict)
TUNE_SOURCES = ("race", "cache", "default")

#: rounds-style chunk size: small runs get one chunk, long runs stay O(R/100)
ROUND_CHUNK = 100

def _jsonable(v):
    """Best-effort JSON coercion for record payload values."""
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if hasattr(v, "value") and not isinstance(v, (int, float, str, bool)):
        return v.value  # enums
    return v


def _checked_payload(type: str, fields: dict) -> dict:
    """Validate ``fields`` against :data:`SCHEMA` and JSON-coerce them: the
    shared gate of file emission and in-process observers."""
    required = SCHEMA.get(type)
    if required is None:
        raise ValueError(f"unknown event type {type!r}; known: {sorted(SCHEMA)}")
    missing = [k for k in required if k not in fields]
    if missing:
        raise ValueError(f"event {type!r} missing required {missing}")
    return {k: _jsonable(v) for k, v in fields.items()}


class EventLogger:
    """JSONL writer that writes each record whole before ``emit`` returns
    (a killed process keeps every record emitted before the kill).

    ``emit`` is safe under concurrent writers:

      - threads sharing one logger: a lock makes the seq draw and the write
        one step, so ``seq`` stays strictly monotonic per logger;
      - processes appending to one file (``mode="a"``, the default): the
        file is opened with O_APPEND and every record is ONE unbuffered
        ``write()`` of a whole line, so concurrent appenders' lines land
        whole (each writer restarts seq at 0, which the validator reads as
        a new stream).

    ``mode="w"`` truncates first (a single writer's run log)."""

    def __init__(self, path: str, mode: str = "a"):
        if mode not in ("a", "w"):
            raise ValueError(f"EventLogger mode must be 'a' or 'w', got {mode!r}")
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f: Optional[IO] = open(path, mode + "b", buffering=0)
        self._seq = itertools.count()
        self._lock = threading.Lock()

    def emit(self, type: str, **fields) -> dict:
        payload = _checked_payload(type, fields)
        with self._lock:
            if self._f is None:
                raise ValueError(f"event logger {self.path!r} is closed")
            rec = {"type": type, "seq": next(self._seq), "t": round(time.time(), 3)}
            rec.update(payload)
            self._f.write((json.dumps(rec) + "\n").encode())  # one write(2), O_APPEND
        return rec

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


# ---------------------------------------------------------------------------
# the process-current sink: the trainers emit into whatever capture() set, so
# no entry point grows a logger parameter

_current: Optional[EventLogger] = None
_run_counter = itertools.count(1)

#: in-process event observers (obs/timeseries.py's live attach): callables
#: invoked host-side with each emitted record dict. They see the same typed
#: stream a capture writes; with no capture installed they still receive the
#: records, stamped with a process-local seq
_observers: list = []
_observer_seq = itertools.count()


def current() -> Optional[EventLogger]:
    return _current


def active() -> bool:
    """Would an :func:`emit` reach anyone (a capture or an observer)? The
    trainers draw a run id exactly then."""
    return _current is not None or bool(_observers)


def add_observer(fn) -> None:
    """Attach an in-process event observer: ``fn(record)`` is called
    host-side, synchronously, for every :func:`emit`. An observer's
    exception is reported once on stderr and swallowed: a consumer must
    never break the producer."""
    _observers.append(fn)


def remove_observer(fn) -> None:
    """Detach a previously added observer (a no-op if absent)."""
    try:
        _observers.remove(fn)
    except ValueError:
        pass


def _notify_observers(rec: dict) -> None:
    for fn in list(_observers):
        try:
            fn(rec)
        except Exception as e:  # noqa: BLE001 — observers are passive
            from erasurehead_tpu_torch.obs.metrics import warn_once

            warn_once(
                f"event-observer-{type(e).__name__}",
                f"event observer {fn!r} raised {e!r}; record dropped "
                f"from the live stream (the event log is unaffected)",
            )


#: per-thread holding lists of :func:`deferred`
_local = threading.local()


@contextlib.contextmanager
def deferred():
    """Hold this thread's emissions for the block: each :func:`emit` inside
    it is checked and appended to the yielded list as a ``(type, fields)``
    pair instead of being written; :func:`replay` emits them later. The
    prefetcher's staging thread holds its reads' records this way, so that
    nothing is written while a trainer's round loop runs."""
    prev = getattr(_local, "held", None)
    held: list = []
    _local.held = held
    try:
        yield held
    finally:
        _local.held = prev


def replay(held: list) -> None:
    """Emit the records a :func:`deferred` block held, in order."""
    for type, fields in held:
        emit(type, **fields)


def emit(type: str, **fields) -> bool:
    """Emit into the current capture; a no-op (False) when none is
    installed. In-process observers see the record either way: the file is
    the durable log, the observers the live plane. Inside a
    :func:`deferred` block on this thread the record is held instead."""
    held = getattr(_local, "held", None)
    if held is not None:
        _checked_payload(type, fields)
        held.append((type, fields))
        return False
    if _current is not None:
        rec = _current.emit(type, **fields)
        _notify_observers(rec)
        return True
    if _observers:
        rec = {"type": type, "seq": next(_observer_seq), "t": round(time.time(), 3)}
        rec.update(_checked_payload(type, fields))
        _notify_observers(rec)
    return False


@contextlib.contextmanager
def capture(path: str, mode: str = "w"):
    """Install an :class:`EventLogger` at ``path`` as the process-current
    sink for the block. On exit a closing ``metrics`` record snapshots the
    registry (obs/metrics.py) and the file is closed. Nested captures stack
    (the inner wins, the outer is restored)."""
    global _current
    logger = EventLogger(path, mode=mode)
    prev = _current
    _current = logger
    try:
        yield logger
    finally:
        _current = prev
        try:
            from erasurehead_tpu_torch.obs.metrics import REGISTRY

            logger.emit("metrics", snapshot=REGISTRY.snapshot())
        except ValueError:
            pass  # already closed by the caller
        logger.close()


def new_run_id() -> str:
    """Short process-unique run id; the pid suffix keeps ids distinct when
    several processes append to one file."""
    return f"run-{next(_run_counter):03d}-{os.getpid():x}"


def config_hash(cfg) -> str:
    """Stable short hash of a RunConfig's full field set. The port's
    RunConfig has a subset of the JAX package's fields, so the two hash the
    same run differently."""
    d = {k: _jsonable(v) for k, v in sorted(dataclasses.asdict(cfg).items())}
    blob = json.dumps(d, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


# ---------------------------------------------------------------------------
# arrival statistics: the masking home of the -1 never-arrived sentinel

def arrival_summary(worker_times) -> dict:
    """Masked latency stats over a [.., W] arrival block.

    ``worker_times`` carries the reference's ``-1`` sentinel for workers the
    master never collected; it is masked out, never averaged in. Quantiles
    are None when no worker arrived at all."""
    wt = np.asarray(worker_times, dtype=np.float64)
    arrived = wt[wt >= 0.0]
    n_never = int(wt.size - arrived.size)
    if arrived.size == 0:
        return {
            "p50": None, "p90": None, "p99": None, "mean": None,
            "n_arrivals": 0, "n_never": n_never,
        }
    q50, q90, q99 = np.quantile(arrived, [0.5, 0.9, 0.99])
    return {
        "p50": round(float(q50), 6),
        "p90": round(float(q90), 6),
        "p99": round(float(q99), 6),
        "mean": round(float(arrived.mean()), 6),
        "n_arrivals": int(arrived.size),
        "n_never": n_never,
    }


def _decode_fields(err) -> dict:
    """A ``decode`` chunk's error summary over one block of a series."""
    err = np.asarray(err, dtype=np.float64)
    return {
        "error_mean": round(float(err.mean()), 10) if err.size else 0.0,
        "error_max": round(float(err.max()), 10) if err.size else 0.0,
        "exact": bool((err == 0.0).all()),
    }


def emit_round_chunks(
    run_id: str,
    *,
    start_round: int,
    timeset: np.ndarray,
    worker_times: np.ndarray,
    decode_error: Optional[np.ndarray] = None,
    update_norm: Optional[np.ndarray] = None,
    chunk: int = ROUND_CHUNK,
    trajectory: Optional[str] = None,
) -> None:
    """Emit a run's ``rounds`` (and ``decode``) chunk records, one pair per
    ``chunk`` rounds from ``start_round``. All inputs are host numpy the run
    already produced; a no-op when nobody listens. ``update_norm`` is the
    [R-1] per-round optimizer-step norm (the host-visible gradient-magnitude
    proxy); its entry r describes the step into round r+1.

    ``trajectory`` tags a cohort member's series (a cohort emits one chunk
    stream per trajectory under its single run_id); the validator's
    per-round monotonicity then applies per (run_id, trajectory) stream."""
    if not active():
        return
    rounds = len(timeset)
    traj = {} if trajectory is None else {"trajectory": trajectory}
    for lo in range(start_round, rounds, chunk):
        hi = min(lo + chunk, rounds)
        fields = dict(
            run_id=run_id,
            first_round=lo,
            n_rounds=hi - lo,
            sim_time_s=round(float(np.sum(timeset[lo:hi])), 6),
            arrival=arrival_summary(worker_times[lo:hi]),
            **traj,
        )
        if update_norm is not None and len(update_norm):
            un = update_norm[max(lo - start_round - 1, 0):hi - start_round - 1]
            if len(un):
                fields["update_norm_mean"] = round(float(np.mean(un)), 8)
        emit("rounds", **fields)
        if decode_error is not None:
            emit("decode", run_id=run_id, first_round=lo, n_rounds=hi - lo,
                 **_decode_fields(decode_error[lo:hi]), **traj)


def emit_layer_decode_chunks(
    run_id: str,
    layer_errors: np.ndarray,
    *,
    start_round: int = 0,
    chunk: int = ROUND_CHUNK,
    trajectory: Optional[str] = None,
) -> None:
    """Emit per-layer ``decode`` chunk streams of a blockwise-coded run:
    ``layer_errors`` is the [R, L] gradient-space table of
    obs/decode.block_decode_error (per_block or cumulative, the caller
    picks), and each layer l becomes its own round-chunked stream tagged
    ``layer=l``: the decode-error-vs-depth series. A no-op when nobody
    listens."""
    if not active():
        return
    err_rl = np.asarray(layer_errors, dtype=np.float64)
    rounds = err_rl.shape[0]
    traj = {} if trajectory is None else {"trajectory": trajectory}
    for layer in range(err_rl.shape[1]):
        for lo in range(start_round, rounds, chunk):
            hi = min(lo + chunk, rounds)
            emit("decode", run_id=run_id, first_round=lo, n_rounds=hi - lo,
                 **_decode_fields(err_rl[lo:hi, layer]), layer=layer, **traj)


# ---------------------------------------------------------------------------
# validation

def validate_lines(lines: Iterable[str]) -> list[str]:
    """Schema-check an events.jsonl; returns human-readable error strings
    (empty = valid). Checks: every line parses as a JSON object; record
    types are known; required keys are present; ``seq`` is strictly
    monotonic per emitting logger run; chunked ``rounds``/``decode``
    records have strictly increasing ``first_round`` per (run_id,
    trajectory) stream (cohort dispatches emit one tagged stream per
    trajectory); ``cohort`` records are internally consistent
    (n_trajectories matches the seeds list, dispatches >= 1);
    ``sweep_trajectory`` journal records carry a known status, a non-empty
    key, and an object row; serve records are internally consistent
    (``request`` names tenant/request_id/label, ``pack``'s trajectory
    count matches its label list, ``admit`` carries non-negative byte
    figures, ``evict`` names its reason, ``reject`` carries a tenant and
    a known reason (:data:`REJECT_REASONS`) plus an optional
    non-negative retry-after, ``stream`` carries a tenant and a known
    lifecycle event (:data:`STREAM_EVENTS`), ``restart`` carries
    non-negative WAL-replay counts); ``membership`` records carry a
    non-negative round, a known action (:data:`MEMBERSHIP_ACTIONS`), a
    positive worker count and — when present — a list of non-negative
    worker ids; ``fleet`` records carry a known action
    (:data:`FLEET_ACTIONS`), a non-empty replica name, non-negative
    streak/k/records counts when present, and ``declare_dead`` must
    carry ``streak >= k`` (a death declared on fewer than K consecutive
    evidential misses is a schema error, not a policy choice);
    ``whatif`` records carry a non-empty ``spec_hash`` and a
    known ``kind`` (:data:`WHATIF_KINDS`), point records a non-empty
    label and a bool feasibility verdict, grid records non-negative point
    counts; ``prefetch`` records carry a non-negative window index and
    byte count and a ``ranges`` list of well-formed ``[lo, hi)`` int
    pairs (plus, when present, non-negative ``fetch_s`` seconds, a
    known ``plan_mode`` (:data:`STREAM_PLAN_MODES`) and non-negative
    ``halo`` / ``group_workers`` ints);
    ``io`` records carry a known kind (:data:`IO_KINDS`) and a
    non-negative byte count; ``tune`` records carry a known race
    (:data:`TUNE_RACES`), a known source (:data:`TUNE_SOURCES`) and
    non-empty device_kind/shape/choice strings; ``dispatch_ahead`` records carry a positive
    pipeline depth and non-negative overlap seconds; ``stale_decode``
    records carry non-negative error norms and a staleness share in
    [0, 1]; every ``run_start`` has a matching later ``run_end``."""
    errors: list = []
    # seq checking is multi-stream: a file may interleave several
    # append-mode loggers (concurrent journal writers). Each stream is
    # append-only from 0, so every record's seq must either open a stream
    # (0) or continue one; the multiset maps "next expected seq" -> number
    # of streams expecting it.
    seq_streams: dict = {}
    seen_seq = False
    last_round: dict = {}  # (run_id, type, trajectory, layer) -> first_round
    started: set = set()
    ended: set = set()
    for i, line in enumerate(lines, 1):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            errors.append(f"line {i}: not JSON ({e})")
            continue
        if not isinstance(rec, dict):
            errors.append(f"line {i}: not a JSON object")
            continue
        rtype = rec.get("type")
        if rtype not in SCHEMA:
            errors.append(f"line {i}: unknown record type {rtype!r}")
            continue
        missing = [k for k in SCHEMA[rtype] if k not in rec]
        if missing:
            errors.append(f"line {i}: {rtype} missing required {missing}")
        seq = rec.get("seq")
        if not isinstance(seq, int):
            errors.append(f"line {i}: missing/invalid seq")
        else:
            if seq == 0 or not seen_seq:
                # a new logger run; the file's first record may also be the
                # tail of a rotated stream
                seq_streams[seq + 1] = seq_streams.get(seq + 1, 0) + 1
            elif seq_streams.get(seq):
                seq_streams[seq] -= 1
                if not seq_streams[seq]:
                    del seq_streams[seq]
                seq_streams[seq + 1] = seq_streams.get(seq + 1, 0) + 1
            else:
                errors.append(
                    f"line {i}: non-monotonic seq {seq} (continues no "
                    f"logger stream; expected one of "
                    f"{sorted(seq_streams) or [0]})"
                )
            seen_seq = True
        if rtype in ("rounds", "decode"):
            errors += _round_stream_errors(i, rec, rtype, last_round)
        check = _CHECKS.get(rtype)
        if check is not None:
            errors += check(i, rec)
        if rtype == "run_start":
            started.add(rec.get("run_id"))
        if rtype == "run_end":
            ended.add(rec.get("run_id"))
    for rid in sorted(started - ended, key=str):
        errors.append(f"run {rid!r}: run_start without run_end")
    return errors


def _round_stream_errors(i: int, rec: dict, rtype: str, last_round: dict) -> list:
    """A ``rounds``/``decode`` chunk's ``first_round`` must advance per
    (run_id, type, trajectory, layer) stream."""
    errors: list = []
    layer = rec.get("layer")
    if layer is not None and (not isinstance(layer, int) or layer < 0):
        errors.append(
            f"line {i}: {rtype} layer must be a non-negative "
            f"int, got {layer!r}"
        )
        layer = None
    key = (rec.get("run_id"), rtype, rec.get("trajectory"), layer)
    fr = rec.get("first_round")
    if isinstance(fr, int):
        prev = last_round.get(key)
        if prev is not None and fr <= prev:
            errors.append(
                f"line {i}: {rtype} first_round {fr} not after "
                f"{prev} for run {key[0]!r}"
                + (f" trajectory {key[2]!r}" if key[2] is not None else "")
                + (f" layer {key[3]}" if key[3] is not None else "")
            )
        last_round[key] = fr
    return errors


def _cohort_errors(i: int, rec: dict) -> list:
    errors: list = []
    n = rec.get("n_trajectories")
    seeds = rec.get("seeds")
    if isinstance(seeds, list) and isinstance(n, int) and len(seeds) != n:
        errors.append(
            f"line {i}: cohort n_trajectories {n} != "
            f"{len(seeds)} seeds"
        )
    disp = rec.get("dispatches")
    if isinstance(disp, int) and disp < 1:
        errors.append(
            f"line {i}: cohort dispatches must be >= 1, got {disp}"
        )
    return errors


def _sweep_trajectory_errors(i: int, rec: dict) -> list:
    errors: list = []
    status = rec.get("status")
    if status not in TRAJECTORY_STATUSES:
        errors.append(
            f"line {i}: sweep_trajectory status must be one of "
            f"{TRAJECTORY_STATUSES}, got {status!r}"
        )
    if "row" in rec and not isinstance(rec.get("row"), dict):
        errors.append(
            f"line {i}: sweep_trajectory row must be an object "
            f"(the RunSummary rehydration payload)"
        )
    key = rec.get("key")
    if not isinstance(key, str) or not key:
        errors.append(
            f"line {i}: sweep_trajectory key must be a non-empty "
            f"string"
        )
    return errors


def _request_errors(i: int, rec: dict) -> list:
    errors: list = []
    for field in ("tenant", "request_id", "label"):
        v = rec.get(field)
        if not isinstance(v, str) or not v:
            errors.append(
                f"line {i}: request {field} must be a non-empty "
                f"string, got {v!r}"
            )
    return errors


def _pack_errors(i: int, rec: dict) -> list:
    errors: list = []
    n = rec.get("n_trajectories")
    labels = rec.get("labels")
    tenants = rec.get("tenants")
    if not isinstance(labels, list):
        errors.append(f"line {i}: pack labels must be a list")
    elif isinstance(n, int) and len(labels) != n:
        errors.append(
            f"line {i}: pack n_trajectories {n} != "
            f"{len(labels)} labels"
        )
    if not isinstance(tenants, list) or not tenants:
        errors.append(
            f"line {i}: pack tenants must be a non-empty list"
        )
    return errors


def _admit_errors(i: int, rec: dict) -> list:
    errors: list = []
    for field in ("est_bytes", "budget_bytes"):
        v = rec.get(field)
        # budget_bytes None = unbounded (no budget configured)
        if v is None and field == "budget_bytes":
            continue
        if not isinstance(v, (int, float)) or v < 0:
            errors.append(
                f"line {i}: admit {field} must be a non-negative "
                f"number, got {v!r}"
            )
    return errors


def _evict_errors(i: int, rec: dict) -> list:
    errors: list = []
    reason = rec.get("reason")
    if not isinstance(reason, str) or not reason:
        errors.append(
            f"line {i}: evict reason must be a non-empty string, "
            f"got {reason!r}"
        )
    return errors


def _reject_errors(i: int, rec: dict) -> list:
    errors: list = []
    tenant = rec.get("tenant")
    if not isinstance(tenant, str) or not tenant:
        errors.append(
            f"line {i}: reject tenant must be a non-empty string, "
            f"got {tenant!r}"
        )
    reason = rec.get("reason")
    if reason not in REJECT_REASONS:
        errors.append(
            f"line {i}: reject reason must be one of "
            f"{REJECT_REASONS}, got {reason!r}"
        )
    ra = rec.get("retry_after_s")
    if ra is not None and (
        not isinstance(ra, (int, float)) or ra < 0
    ):
        errors.append(
            f"line {i}: reject retry_after_s must be a "
            f"non-negative number, got {ra!r}"
        )
    return errors


def _stream_errors(i: int, rec: dict) -> list:
    errors: list = []
    tenant = rec.get("tenant")
    if not isinstance(tenant, str) or not tenant:
        errors.append(
            f"line {i}: stream tenant must be a non-empty string, "
            f"got {tenant!r}"
        )
    ev = rec.get("event")
    if ev not in STREAM_EVENTS:
        errors.append(
            f"line {i}: stream event must be one of "
            f"{STREAM_EVENTS}, got {ev!r}"
        )
    dropped = rec.get("dropped")
    if dropped is not None and (
        not isinstance(dropped, int) or dropped < 0
    ):
        errors.append(
            f"line {i}: stream dropped must be a non-negative "
            f"int, got {dropped!r}"
        )
    return errors


def _restart_errors(i: int, rec: dict) -> list:
    errors: list = []
    for field in ("wal_records", "resubmitted", "rehydrated"):
        v = rec.get(field)
        if not isinstance(v, int) or v < 0:
            errors.append(
                f"line {i}: restart {field} must be a "
                f"non-negative int, got {v!r}"
            )
    return errors


def _adapt_errors(i: int, rec: dict) -> list:
    errors: list = []
    rnd = rec.get("round")
    if not isinstance(rnd, int) or rnd < 0:
        errors.append(
            f"line {i}: adapt round must be a non-negative int, "
            f"got {rnd!r}"
        )
    arm = rec.get("arm")
    if not isinstance(arm, str) or not arm:
        errors.append(
            f"line {i}: adapt arm must be a non-empty string, "
            f"got {arm!r}"
        )
    reason = rec.get("reason")
    if reason not in ADAPT_REASONS:
        errors.append(
            f"line {i}: adapt reason must be one of "
            f"{ADAPT_REASONS}, got {reason!r}"
        )
    return errors


def _membership_errors(i: int, rec: dict) -> list:
    errors: list = []
    rnd = rec.get("round")
    if not isinstance(rnd, int) or rnd < 0:
        errors.append(
            f"line {i}: membership round must be a non-negative "
            f"int, got {rnd!r}"
        )
    action = rec.get("action")
    if action not in MEMBERSHIP_ACTIONS:
        errors.append(
            f"line {i}: membership action must be one of "
            f"{MEMBERSHIP_ACTIONS}, got {action!r}"
        )
    nw = rec.get("n_workers")
    if not isinstance(nw, int) or nw < 1:
        errors.append(
            f"line {i}: membership n_workers must be a positive "
            f"int, got {nw!r}"
        )
    workers = rec.get("workers")
    if workers is not None and (
        not isinstance(workers, list)
        or any(
            not isinstance(w, int) or w < 0 for w in workers
        )
    ):
        errors.append(
            f"line {i}: membership workers must be a list of "
            f"non-negative worker ids, got {workers!r}"
        )
    return errors


def _fleet_errors(i: int, rec: dict) -> list:
    errors: list = []
    action = rec.get("action")
    if action not in FLEET_ACTIONS:
        errors.append(
            f"line {i}: fleet action must be one of "
            f"{FLEET_ACTIONS}, got {action!r}"
        )
    replica = rec.get("replica")
    if not isinstance(replica, str) or not replica:
        errors.append(
            f"line {i}: fleet replica must be a non-empty "
            f"string, got {replica!r}"
        )
    for field in ("streak", "k", "records", "replayed"):
        v = rec.get(field)
        if v is not None and (
            not isinstance(v, int) or v < 0
        ):
            errors.append(
                f"line {i}: fleet {field} must be a non-negative "
                f"int, got {v!r}"
            )
    if action == "declare_dead":
        streak, k = rec.get("streak"), rec.get("k")
        if (
            isinstance(streak, int)
            and isinstance(k, int)
            and streak < k
        ):
            errors.append(
                f"line {i}: fleet declare_dead with streak "
                f"{streak} < k {k} — death must follow K "
                "consecutive evidential misses, never fewer"
            )
    return errors


def _whatif_errors(i: int, rec: dict) -> list:
    errors: list = []
    kind = rec.get("kind")
    if kind not in WHATIF_KINDS:
        errors.append(
            f"line {i}: whatif kind must be one of "
            f"{WHATIF_KINDS}, got {kind!r}"
        )
    sh = rec.get("spec_hash")
    if not isinstance(sh, str) or not sh:
        errors.append(
            f"line {i}: whatif spec_hash must be a non-empty "
            f"string, got {sh!r}"
        )
    if kind == "point":
        if not isinstance(rec.get("label"), str) or not rec.get(
            "label"
        ):
            errors.append(
                f"line {i}: whatif point record must carry a "
                f"non-empty label, got {rec.get('label')!r}"
            )
        if not isinstance(rec.get("feasible"), bool):
            errors.append(
                f"line {i}: whatif point record must carry a "
                f"bool feasible, got {rec.get('feasible')!r}"
            )
    if kind == "grid":
        for field in ("n_points", "n_feasible", "n_infeasible"):
            v = rec.get(field)
            if v is not None and (
                not isinstance(v, int) or v < 0
            ):
                errors.append(
                    f"line {i}: whatif grid {field} must be a "
                    f"non-negative int, got {v!r}"
                )
    return errors


def _prefetch_errors(i: int, rec: dict) -> list:
    errors: list = []
    for field in ("window", "bytes"):
        v = rec.get(field)
        if not isinstance(v, int) or v < 0:
            errors.append(
                f"line {i}: prefetch {field} must be a "
                f"non-negative int, got {v!r}"
            )
    rngs = rec.get("ranges")
    ok_ranges = isinstance(rngs, list) and all(
        isinstance(r, list)
        and len(r) == 2
        and all(isinstance(v, int) and v >= 0 for v in r)
        and r[0] < r[1]
        for r in rngs
    ) and len(rngs) >= 1
    if "ranges" in rec and not ok_ranges:
        errors.append(
            f"line {i}: prefetch ranges must be a non-empty "
            f"list of [lo, hi) non-negative int pairs with "
            f"lo < hi, got {rngs!r}"
        )
    pm = rec.get("plan_mode")
    if pm is not None and pm not in STREAM_PLAN_MODES:
        errors.append(
            f"line {i}: prefetch plan_mode must be one of "
            f"{STREAM_PLAN_MODES}, got {pm!r}"
        )
    for field in ("halo", "group_workers"):
        v = rec.get(field)
        if v is not None and (not isinstance(v, int) or v < 0):
            errors.append(
                f"line {i}: prefetch {field} must be a "
                f"non-negative int, got {v!r}"
            )
    fs = rec.get("fetch_s")
    if fs is not None and (
        not isinstance(fs, (int, float)) or fs < 0
    ):
        errors.append(
            f"line {i}: prefetch fetch_s must be a non-negative "
            f"number, got {fs!r}"
        )
    return errors


def _dispatch_ahead_errors(i: int, rec: dict) -> list:
    errors: list = []
    pd = rec.get("pipeline_depth")
    if not isinstance(pd, int) or pd < 1:
        errors.append(
            f"line {i}: dispatch_ahead pipeline_depth must be a "
            f"positive int (the event only exists for pipelined "
            f"runs), got {pd!r}"
        )
    for field in ("ahead_mean_s", "ahead_max_s", "overlap_total_s"):
        v = rec.get(field)
        if not isinstance(v, (int, float)) or v < 0:
            errors.append(
                f"line {i}: dispatch_ahead {field} must be a "
                f"non-negative number, got {v!r}"
            )
    return errors


def _stale_decode_errors(i: int, rec: dict) -> list:
    errors: list = []
    for field in ("staleness_error_mean", "coding_error_mean"):
        v = rec.get(field)
        if not isinstance(v, (int, float)) or v < 0:
            errors.append(
                f"line {i}: stale_decode {field} must be a "
                f"non-negative number, got {v!r}"
            )
    share = rec.get("staleness_share")
    if not isinstance(share, (int, float)) or not 0 <= share <= 1:
        errors.append(
            f"line {i}: stale_decode staleness_share must be a "
            f"number in [0, 1], got {share!r}"
        )
    return errors


def _critical_path_errors(i: int, rec: dict) -> list:
    errors: list = []
    for total_field, comp_field in (
        ("wall_s", "components"),
        ("sim_total_s", "sim_components"),
    ):
        total = rec.get(total_field)
        comps = rec.get(comp_field)
        if not isinstance(total, (int, float)) or total < 0:
            errors.append(
                f"line {i}: critical_path {total_field} must be a "
                f"non-negative number, got {total!r}"
            )
            continue
        if not isinstance(comps, dict) or not all(
            isinstance(v, (int, float)) and v >= 0
            for v in comps.values()
        ):
            errors.append(
                f"line {i}: critical_path {comp_field} must map "
                f"bucket names to non-negative seconds, got "
                f"{comps!r}"
            )
            continue
        # the reconciliation contract: the ledger sums to its
        # measured total within CRITICAL_PATH_TOL — an attribution
        # that loses (or invents) wall-clock is a schema error
        s = sum(comps.values())
        if abs(s - total) > CRITICAL_PATH_TOL * total + 1e-9:
            errors.append(
                f"line {i}: critical_path {comp_field} sum "
                f"{s:.6f}s does not reconcile with {total_field} "
                f"{total:.6f}s within {CRITICAL_PATH_TOL:.0%}"
            )
    fractions = rec.get("fractions")
    if not isinstance(fractions, dict) or not all(
        isinstance(v, (int, float)) and 0 <= v <= 1
        for v in fractions.values()
    ):
        errors.append(
            f"line {i}: critical_path fractions must map bucket "
            f"names to numbers in [0, 1], got {fractions!r}"
        )
    return errors


def _regime_errors(i: int, rec: dict) -> list:
    errors: list = []
    kind = rec.get("kind")
    if kind not in REGIME_KINDS:
        errors.append(
            f"line {i}: regime kind must be one of "
            f"{REGIME_KINDS}, got {kind!r}"
        )
    rate = rec.get("rate")
    if not isinstance(rate, (int, float)) or rate < 0:
        errors.append(
            f"line {i}: regime rate must be a non-negative "
            f"number, got {rate!r}"
        )
    rnd = rec.get("round")
    if not isinstance(rnd, int) or rnd < 0:
        errors.append(
            f"line {i}: regime round must be a non-negative int, "
            f"got {rnd!r}"
        )
    n = rec.get("n")
    if not isinstance(n, int) or n < 0:
        errors.append(
            f"line {i}: regime n must be a non-negative int, "
            f"got {n!r}"
        )
    if not isinstance(rec.get("shifted"), bool):
        errors.append(
            f"line {i}: regime shifted must be a bool, got "
            f"{rec.get('shifted')!r}"
        )
    return errors


def _slo_errors(i: int, rec: dict) -> list:
    errors: list = []
    tenant = rec.get("tenant")
    if not isinstance(tenant, str) or not tenant:
        errors.append(
            f"line {i}: slo tenant must be a non-empty string, "
            f"got {tenant!r}"
        )
    slo_s = rec.get("slo_s")
    if not isinstance(slo_s, (int, float)) or slo_s <= 0:
        errors.append(
            f"line {i}: slo slo_s must be a positive number, "
            f"got {slo_s!r}"
        )
    burn = rec.get("burn_rate")
    if not isinstance(burn, (int, float)) or burn < 0:
        errors.append(
            f"line {i}: slo burn_rate must be a non-negative "
            f"number, got {burn!r}"
        )
    reqs = rec.get("window_requests")
    breaches = rec.get("breaches")
    if not isinstance(reqs, int) or reqs < 0:
        errors.append(
            f"line {i}: slo window_requests must be a "
            f"non-negative int, got {reqs!r}"
        )
    elif (
        not isinstance(breaches, int)
        or not 0 <= breaches <= reqs
    ):
        errors.append(
            f"line {i}: slo breaches must be an int in "
            f"[0, window_requests], got {breaches!r}"
        )
    return errors


def _tune_errors(i: int, rec: dict) -> list:
    errors: list = []
    race = rec.get("race")
    if race not in TUNE_RACES:
        errors.append(
            f"line {i}: tune race must be one of {TUNE_RACES}, "
            f"got {race!r}"
        )
    source = rec.get("source")
    if source not in TUNE_SOURCES:
        errors.append(
            f"line {i}: tune source must be one of "
            f"{TUNE_SOURCES}, got {source!r}"
        )
    for field in ("device_kind", "shape", "choice"):
        v = rec.get(field)
        if not isinstance(v, str) or not v:
            errors.append(
                f"line {i}: tune {field} must be a non-empty "
                f"string, got {v!r}"
            )
    return errors


def _io_errors(i: int, rec: dict) -> list:
    errors: list = []
    kind = rec.get("kind")
    if kind not in IO_KINDS:
        errors.append(
            f"line {i}: io kind must be one of {IO_KINDS}, "
            f"got {kind!r}"
        )
    v = rec.get("bytes")
    if not isinstance(v, int) or v < 0:
        errors.append(
            f"line {i}: io bytes must be a non-negative int, "
            f"got {v!r}"
        )
    return errors

#: record type -> its own checks (the validator runs them after the envelope)
_CHECKS = {
    "cohort": _cohort_errors,
    "sweep_trajectory": _sweep_trajectory_errors,
    "request": _request_errors,
    "pack": _pack_errors,
    "admit": _admit_errors,
    "evict": _evict_errors,
    "reject": _reject_errors,
    "stream": _stream_errors,
    "restart": _restart_errors,
    "adapt": _adapt_errors,
    "membership": _membership_errors,
    "fleet": _fleet_errors,
    "whatif": _whatif_errors,
    "prefetch": _prefetch_errors,
    "dispatch_ahead": _dispatch_ahead_errors,
    "stale_decode": _stale_decode_errors,
    "critical_path": _critical_path_errors,
    "regime": _regime_errors,
    "slo": _slo_errors,
    "tune": _tune_errors,
    "io": _io_errors,
}


def validate_file(path: str) -> list:
    with open(path) as f:
        return validate_lines(f)
