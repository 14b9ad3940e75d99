"""Structured JSONL records: the writer, the process-current sink and the validator.

The parts of erasurehead_tpu/obs/events.py the sweep journal
(train/journal.py), the adaptive and elastic drivers (adapt/, elastic/,
obs/regime.py), the tune plane (tune/) and the what-if engine (whatif/)
need. One line per record, every line a JSON object with
three envelope fields, ``type`` (one of :data:`SCHEMA`), ``seq`` (monotonic
per logger) and ``t`` (unix seconds), plus the type's payload.

Ported: :class:`EventLogger` (append-safe across threads and processes),
the emission core (:func:`capture` installs a logger as the process-current
sink, :func:`emit` writes into it and is a no-op without one,
:func:`current`, :func:`new_run_id`), :func:`config_hash`,
:func:`validate_lines` / :func:`validate_file` for the envelope and the
``sweep_trajectory``, ``adapt``, ``membership``, ``regime``, ``whatif``
and ``tune`` records, and :func:`arrival_summary`. Not ported: the other
record types, in-process observers, the closing ``metrics`` record of a
capture and the trainers' own event emission (they wait for the obs
plane).
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
#: is always present); an unknown type is a validation error
SCHEMA: dict = {
    # sweep-journal record (train/journal.py): one per finished sweep
    # trajectory: its identity key (config hash + data and arrival digests),
    # its completion status and the full RunSummary rehydration payload
    "sweep_trajectory": ("key", "label", "status", "row"),
    # one per adaptive-controller decision (adapt/driver.py): which
    # (scheme, collect, deadline) arm ran the chunk starting at "round",
    # and why (warmup / exploit / explore / regime_shift)
    "adapt": ("round", "arm", "reason"),
    # one per elastic-membership decision or finished chunk
    # (elastic/driver.py): "action" says what happened at chunk-boundary
    # "round"; "chunk" records carry the chunk's science row (sim clock,
    # decode-error mean, params digest) that a resumed run rehydrates
    "membership": ("round", "action", "n_workers"),
    # arrival-regime estimator output (obs/regime.py): the rolling rate and
    # tail classification of the masked arrival stream at "round", and
    # whether a change-point fired there
    "regime": ("round", "kind", "rate", "n", "shifted"),
    # one per what-if engine phase (whatif/engine.py): "kind" says which:
    # "grid" after feasibility enumeration (point counts ride along),
    # "point" per reduced surface row (label + feasibility + expected
    # time-to-target), "surface" when the artifact saves, "rehydrate" when
    # an identical spec loads the saved surface instead of re-simulating;
    # every record carries the grid's spec_hash
    "whatif": ("spec_hash", "kind"),
    # one per autotune-decision resolution (tune/): which race's verdict
    # resolved an auto knob, at which shape signature on which device
    # kind, and where the choice came from ("race" = a racer run just
    # measured it, "cache" = the persisted decision cache, "default" = no
    # cached decision, the hardcoded fallback stood). Observation only and
    # deduplicated per process
    "tune": ("race", "device_kind", "shape", "choice", "source"),
}

#: sweep_trajectory completion statuses; "diverged" rows are quarantined,
#: not retried: divergence is deterministic under the journaled key
TRAJECTORY_STATUSES = ("ok", "diverged")

#: adapt decision reasons (adapt/controller.AdaptiveController.choose)
ADAPT_REASONS = ("warmup", "exploit", "explore", "regime_shift")

#: arrival-regime classifications (obs/regime.ArrivalRegimeEstimator):
#: "exp" = light (exponential-like) tail, "heavytail" = Pareto-like tail by
#: the rolling Hill index, "unknown" = not enough masked arrivals yet
REGIME_KINDS = ("exp", "heavytail", "unknown")

#: what-if engine phases (whatif/engine.py): "grid" = enumeration +
#: feasibility filter, "point" = one reduced surface row, "surface" =
#: artifact saved, "rehydrate" = identical spec served from its artifact
WHATIF_KINDS = ("grid", "point", "surface", "rehydrate")

#: autotune races (tune.TUNE_CHOICES keys): every "tune" record's ``race``
#: field must name one of these knob pairs
TUNE_RACES = (
    "block_decode", "glm_fused", "layer_coding", "ring_pipeline",
    "stack_mode",
)

#: where a tune decision came from: a just-run race, the persisted
#: decision cache, or the hardcoded fallback (no cached verdict)
TUNE_SOURCES = ("race", "cache", "default")

#: membership actions (elastic/controller.py): deaths and joins are detector
#: decisions, "relayout" commits them into a fresh W'-worker layout,
#: "probe" marks a collapsed-arrival re-evaluation, "chunk" is a finished
#: chunk's journal row
MEMBERSHIP_ACTIONS = ("death", "join", "relayout", "probe", "chunk")


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
    """Validate ``fields`` against :data:`SCHEMA` and JSON-coerce them."""
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
# the process-current sink: the drivers emit into whatever capture() set, so
# no entry point grows a logger parameter

_current: Optional[EventLogger] = None
_run_counter = itertools.count(1)


def current() -> Optional[EventLogger]:
    return _current


def emit(type: str, **fields) -> bool:
    """Emit into the current capture; a no-op (False) when none is
    installed."""
    if _current is None:
        return False
    _current.emit(type, **fields)
    return True


@contextlib.contextmanager
def capture(path: str, mode: str = "w"):
    """Install an :class:`EventLogger` at ``path`` as the process-current
    sink for the block; the file is closed on exit. Nested captures stack
    (the inner wins, the outer is restored)."""
    global _current
    logger = EventLogger(path, mode=mode)
    prev = _current
    _current = logger
    try:
        yield logger
    finally:
        _current = prev
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


def validate_lines(lines: Iterable[str]) -> list:
    """Schema-check a JSONL record file; returns human-readable error
    strings (empty = valid). Checks: every line parses as a JSON object; the
    record type is known; required keys are present; ``seq`` continues a
    logger stream (several append-mode writers may interleave, each
    restarting at 0); a ``sweep_trajectory`` record carries a known status,
    a non-empty key and an object row; an ``adapt`` record a non-negative
    round, a non-empty arm and a known reason; a ``membership`` record a
    non-negative round, a known action, a positive worker count and, when
    present, a list of non-negative worker ids; a ``regime`` record a known
    kind, a non-negative rate, round and sample count, and a bool
    ``shifted``; a ``whatif`` record a non-empty spec hash and a known kind
    (a point record a non-empty label and a bool feasible, a grid record
    non-negative point counts); a ``tune`` record a known race and source
    and non-empty device kind, shape and choice."""
    errors: list = []
    # "next expected seq" -> number of streams expecting it
    seq_streams: dict = {}
    seen_seq = False
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
        if rtype == "sweep_trajectory":
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
                    f"line {i}: sweep_trajectory key must be a non-empty string"
                )
        if rtype == "adapt":
            errors += _adapt_errors(i, rec)
        if rtype == "membership":
            errors += _membership_errors(i, rec)
        if rtype == "regime":
            errors += _regime_errors(i, rec)
        if rtype == "whatif":
            errors += _whatif_errors(i, rec)
        if rtype == "tune":
            errors += _tune_errors(i, rec)
    return errors


def _adapt_errors(i: int, rec: dict) -> list:
    errors = []
    rnd = rec.get("round")
    if not isinstance(rnd, int) or rnd < 0:
        errors.append(f"line {i}: adapt round must be a non-negative int, got {rnd!r}")
    arm = rec.get("arm")
    if not isinstance(arm, str) or not arm:
        errors.append(f"line {i}: adapt arm must be a non-empty string, got {arm!r}")
    reason = rec.get("reason")
    if reason not in ADAPT_REASONS:
        errors.append(f"line {i}: adapt reason must be one of {ADAPT_REASONS}, got {reason!r}")
    return errors


def _membership_errors(i: int, rec: dict) -> list:
    errors = []
    rnd = rec.get("round")
    if not isinstance(rnd, int) or rnd < 0:
        errors.append(
            f"line {i}: membership round must be a non-negative int, got {rnd!r}"
        )
    action = rec.get("action")
    if action not in MEMBERSHIP_ACTIONS:
        errors.append(
            f"line {i}: membership action must be one of {MEMBERSHIP_ACTIONS}, "
            f"got {action!r}"
        )
    nw = rec.get("n_workers")
    if not isinstance(nw, int) or nw < 1:
        errors.append(f"line {i}: membership n_workers must be a positive int, got {nw!r}")
    workers = rec.get("workers")
    if workers is not None and (
        not isinstance(workers, list)
        or any(not isinstance(w, int) or w < 0 for w in workers)
    ):
        errors.append(
            f"line {i}: membership workers must be a list of non-negative "
            f"worker ids, got {workers!r}"
        )
    return errors


def _regime_errors(i: int, rec: dict) -> list:
    errors = []
    kind = rec.get("kind")
    if kind not in REGIME_KINDS:
        errors.append(f"line {i}: regime kind must be one of {REGIME_KINDS}, got {kind!r}")
    rate = rec.get("rate")
    if not isinstance(rate, (int, float)) or rate < 0:
        errors.append(f"line {i}: regime rate must be a non-negative number, got {rate!r}")
    rnd = rec.get("round")
    if not isinstance(rnd, int) or rnd < 0:
        errors.append(f"line {i}: regime round must be a non-negative int, got {rnd!r}")
    n = rec.get("n")
    if not isinstance(n, int) or n < 0:
        errors.append(f"line {i}: regime n must be a non-negative int, got {n!r}")
    if not isinstance(rec.get("shifted"), bool):
        errors.append(f"line {i}: regime shifted must be a bool, got {rec.get('shifted')!r}")
    return errors


def _whatif_errors(i: int, rec: dict) -> list:
    errors = []
    kind = rec.get("kind")
    if kind not in WHATIF_KINDS:
        errors.append(f"line {i}: whatif kind must be one of {WHATIF_KINDS}, got {kind!r}")
    sh = rec.get("spec_hash")
    if not isinstance(sh, str) or not sh:
        errors.append(f"line {i}: whatif spec_hash must be a non-empty string, got {sh!r}")
    if kind == "point":
        label = rec.get("label")
        if not isinstance(label, str) or not label:
            errors.append(
                f"line {i}: whatif point record must carry a non-empty label, got {label!r}"
            )
        if not isinstance(rec.get("feasible"), bool):
            errors.append(
                f"line {i}: whatif point record must carry a bool feasible, "
                f"got {rec.get('feasible')!r}"
            )
    if kind == "grid":
        for field in ("n_points", "n_feasible", "n_infeasible"):
            v = rec.get(field)
            if v is not None and (not isinstance(v, int) or v < 0):
                errors.append(
                    f"line {i}: whatif grid {field} must be a non-negative int, got {v!r}"
                )
    return errors


def _tune_errors(i: int, rec: dict) -> list:
    errors = []
    race = rec.get("race")
    if race not in TUNE_RACES:
        errors.append(f"line {i}: tune race must be one of {TUNE_RACES}, got {race!r}")
    source = rec.get("source")
    if source not in TUNE_SOURCES:
        errors.append(f"line {i}: tune source must be one of {TUNE_SOURCES}, got {source!r}")
    for field in ("device_kind", "shape", "choice"):
        v = rec.get(field)
        if not isinstance(v, str) or not v:
            errors.append(f"line {i}: tune {field} must be a non-empty string, got {v!r}")
    return errors


def validate_file(path: str) -> list:
    with open(path) as f:
        return validate_lines(f)
