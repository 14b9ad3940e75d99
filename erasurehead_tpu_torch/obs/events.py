"""Structured JSONL records: the sweep journal's writer, hash and validator.

The parts of erasurehead_tpu/obs/events.py the sweep journal
(train/journal.py) needs. One line per record, every line a JSON object with
three envelope fields, ``type`` (one of :data:`SCHEMA`), ``seq`` (monotonic
per logger) and ``t`` (unix seconds), plus the type's payload.

Ported: :class:`EventLogger` (append-safe across threads and processes),
:func:`config_hash`, :func:`validate_lines` / :func:`validate_file` for the
envelope and the ``sweep_trajectory`` record, and :func:`arrival_summary`
for the artifact writer. Not ported: the other record types, ``capture()``,
``emit()`` and the trainers' event emission (they wait for the obs plane).
"""

from __future__ import annotations

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
}

#: sweep_trajectory completion statuses; "diverged" rows are quarantined,
#: not retried: divergence is deterministic under the journaled key
TRAJECTORY_STATUSES = ("ok", "diverged")


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
    """Append-only JSONL writer (a killed process keeps every record emitted
    before the kill).

    ``emit`` is safe under concurrent writers:

      - threads sharing one logger: a lock makes the seq draw and the write
        one step, so ``seq`` stays strictly monotonic per logger;
      - processes appending to one file: the file is opened with O_APPEND
        and every record is ONE unbuffered ``write()`` of a whole line, so
        concurrent appenders' lines land whole (each writer restarts seq at
        0, which the validator reads as a new stream).

    The JAX package's single-writer ``mode="w"`` run logs wait for the obs
    plane."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f: Optional[IO] = open(path, "ab", buffering=0)
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
    a non-empty key and an object row."""
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
    return errors


def validate_file(path: str) -> list:
    with open(path) as f:
        return validate_lines(f)
