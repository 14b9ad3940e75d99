"""Sweep journal: per-trajectory persistence and resume for the sweep runner.

The port of erasurehead_tpu/train/journal.py. A multi-scheme, multi-seed
comparison is all-or-nothing without it: one preemption or diverging
trajectory and the whole ``experiments.compare`` loop dies with nothing
persisted. This module journals each trajectory's finished summary row as
it completes, into an append-only JSONL file written through
obs/events.EventLogger (one whole line per write) and checked by
obs/events.validate_file.

Each ``sweep_trajectory`` record carries:

  - ``key``    — the trajectory's identity: a digest over the row label,
                 the FULL RunConfig (obs/events.config_hash — a superset of
                 ``RunConfig.static_signature``), the dataset content
                 digest, and the arrival-schedule digest. A resumed sweep
                 only reuses a row when all four match — change a seed, a
                 dataset, or the delay stream and the trajectory re-runs.
                 The port's RunConfig has fewer fields than the JAX
                 package's, so the two packages' journals do not share
                 keys;
  - ``status`` — ``"ok"`` or ``"diverged"`` (divergence is deterministic
                 under the key, so diverged rows resume as diverged rather
                 than burning the rounds again);
  - ``row``    — the full UNROUNDED RunSummary payload (loss curves and
                 clocks with their dtypes), so a rehydrated row is
                 bit-identical to the one the interrupted run computed:
                 JSON float round-trips are exact (repr round-trip), and
                 arrays restore to their original dtype.

Enable by passing a :class:`SweepJournal` to ``experiments.compare`` /
``straggler_sweep`` / ``baseline_suite`` (the CLIs expose
``--sweep-journal DIR`` / ``--resume-sweep``), or ambiently via
``ERASUREHEAD_SWEEP_JOURNAL=DIR`` (+ ``ERASUREHEAD_RESUME_SWEEP=1``) —
:func:`from_env` hands every sweep entry point one shared process journal.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Optional

import numpy as np

from erasurehead_tpu_torch.obs import events as events_lib
from erasurehead_tpu_torch.obs.metrics import REGISTRY as _METRICS

#: journal file name inside the journal directory
JOURNAL_NAME = "sweep_journal.jsonl"

#: arrays larger than this are digested by a strided sample + exact shape/
#: dtype/checksums instead of full bytes (hashing a paper-scale matrix
#: would cost more than the sweep step the journal is protecting)
_FULL_HASH_MAX_BYTES = 64 * 1024 * 1024

#: RunSummary fields persisted verbatim (floats/str/None/dict — JSON
#: round-trips them exactly); arrays and config are handled separately
_SCALAR_FIELDS = (
    "label", "sim_total_time", "sim_steps_per_sec", "real_steps_per_sec",
    "final_train_loss", "final_test_loss", "final_auc", "time_to_target",
    "note", "suite", "cache", "decode_error_mean", "status",
)


def _hash_update_array(h, arr: np.ndarray) -> None:
    arr = np.ascontiguousarray(arr)
    h.update(str(arr.shape).encode())
    h.update(str(arr.dtype).encode())
    if arr.nbytes <= _FULL_HASH_MAX_BYTES:
        h.update(arr.tobytes())
        return
    # paper-scale: exact shape/dtype + strided sample + global checksums.
    # A probabilistic content digest — documented tradeoff: a collision
    # needs two same-shaped datasets agreeing on the sample AND the sums.
    flat = arr.reshape(-1)
    stride = max(1, flat.size * flat.itemsize // _FULL_HASH_MAX_BYTES)
    h.update(np.ascontiguousarray(flat[::stride]).tobytes())
    if np.issubdtype(arr.dtype, np.number):
        h.update(np.asarray(
            [np.float64(flat.sum(dtype=np.float64))]
        ).tobytes())


def dataset_digest(dataset) -> str:
    """Content digest of a Dataset, memoized on the object (sweeps reuse
    one dataset object; the digest is computed once per process). Sparse
    matrices digest their underlying buffers."""
    tok = getattr(dataset, "_sweep_journal_digest", None)
    if tok is not None:
        return tok
    h = hashlib.sha256()
    for name in ("X_train", "y_train", "X_test", "y_test"):
        part = getattr(dataset, name, None)
        if part is None:
            continue
        h.update(name.encode())
        if hasattr(part, "tocsr") and not isinstance(part, np.ndarray):
            csr = part.tocsr()
            for buf in (csr.data, csr.indices, csr.indptr):
                _hash_update_array(h, np.asarray(buf))
        else:
            _hash_update_array(h, np.asarray(part))
    tok = h.hexdigest()[:16]
    try:
        dataset._sweep_journal_digest = tok
    except (AttributeError, TypeError):
        pass  # uncacheable object: recompute next time
    return tok


def arrivals_digest(arrivals) -> str:
    h = hashlib.sha256()
    _hash_update_array(h, np.asarray(arrivals, dtype=np.float64))
    return h.hexdigest()[:16]


def trajectory_key(label: str, cfg, dataset, arrivals) -> str:
    """The journal identity of one sweep trajectory: label + full config
    hash + data digest + arrival digest. Anything that can change the
    row's numbers is in here — a resumed sweep can only reuse a row whose
    inputs are provably the same."""
    payload = json.dumps(
        {
            "label": label,
            "config": events_lib.config_hash(cfg),
            "data": dataset_digest(dataset),
            "arrivals": arrivals_digest(arrivals),
        },
        sort_keys=True,
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:24]


#: RunSummary.row() keys that legitimately differ between a resumed sweep
#: and an uninterrupted one: real wall-clock and cache telemetry are
#: measurements of THIS process, not of the science. Everything else —
#: labels, simulated clocks, losses, decode-error columns — must match
#: bitwise (the kill→resume invariance the chaos harness pins).
VOLATILE_ROW_KEYS = ("real_steps_per_sec", "cache")


def science_row(row: dict) -> dict:
    """A summary row with the run-local volatile keys dropped — the part
    of the row the kill→resume invariance contract covers."""
    return {k: v for k, v in row.items() if k not in VOLATILE_ROW_KEYS}


def _pack_array(arr) -> dict:
    arr = np.asarray(arr)
    return {"values": arr.tolist(), "dtype": str(arr.dtype)}


def _unpack_array(blob) -> np.ndarray:
    return np.asarray(blob["values"], dtype=np.dtype(blob["dtype"]))


def summary_payload(summary) -> dict:
    """The RunSummary -> journal ``row`` payload: every field needed to
    rebuild the summary bit-identically, UNROUNDED (``RunSummary.row()``'s
    rounding happens at render time, identically for fresh and rehydrated
    rows). ``config`` is intentionally absent — the resuming sweep supplies
    the config object, and the key already pins its content."""
    out = {f: getattr(summary, f) for f in _SCALAR_FIELDS}
    out["training_loss"] = _pack_array(summary.training_loss)
    out["timeset"] = _pack_array(summary.timeset)
    return out


def rehydrate_summary(row: dict, cfg):
    """Journal ``row`` payload -> RunSummary (import deferred: experiments
    imports this module)."""
    from erasurehead_tpu_torch.train.experiments import RunSummary

    kw = {f: row.get(f) for f in _SCALAR_FIELDS}
    kw["training_loss"] = _unpack_array(row["training_loss"])
    kw["timeset"] = _unpack_array(row["timeset"])
    if kw.get("status") is None:
        kw["status"] = "ok"
    return RunSummary(config=cfg, **kw)


class SweepJournal:
    """Append-only sweep journal over ``<dir>/sweep_journal.jsonl``.

    ``resume=True`` makes :meth:`lookup` serve previously journaled rows;
    with ``resume=False`` the journal only records (a restart that wants a
    fresh measurement of everything can journal without skipping). The
    writer opens lazily in append mode, so constructing a journal never
    clobbers an interrupted run's records.

    Safe under CONCURRENT WRITERS (threads of one process, and several
    processes sharing one journal file):

      - within a process, a lock serializes the lazy logger open, the
        append, and the completed-map update;
      - across processes, the append-mode EventLogger (obs/events.py)
        emits each record as ONE ``write()`` on an O_APPEND fd, so
        interleaved writers produce interleaved whole LINES, never torn
        ones — every record any writer flushed survives, and a resuming
        reader sees the union (last record per key wins, as before).
    """

    def __init__(self, directory: str, resume: bool = False):
        self.directory = directory
        self.path = os.path.join(directory, JOURNAL_NAME)
        self.resume = bool(resume)
        self._logger: Optional[events_lib.EventLogger] = None
        self._completed: dict[str, dict] = {}
        self._lock = threading.Lock()
        if os.path.exists(self.path):
            self._load()

    def _load(self) -> None:
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    # a kill mid-write can leave one torn final line; every
                    # complete line before it is intact (per-line flush)
                    continue
                if (
                    isinstance(rec, dict)
                    and rec.get("type") == "sweep_trajectory"
                    and isinstance(rec.get("key"), str)
                    and isinstance(rec.get("row"), dict)
                ):
                    self._completed[rec["key"]] = rec  # last record wins

    def __len__(self) -> int:
        return len(self._completed)

    def lookup(self, key: str) -> Optional[dict]:
        """The journaled record for ``key`` (resume mode only)."""
        if not self.resume:
            return None
        return self._completed.get(key)

    def record(self, key: str, label: str, summary) -> None:
        """Append one finished trajectory. Flushed before returning — a
        kill any time after this call preserves the row. Thread-safe (see
        class docstring)."""
        payload = summary_payload(summary)
        with self._lock:
            if self._logger is None:
                self._logger = events_lib.EventLogger(self.path)
            self._logger.emit(
                "sweep_trajectory",
                key=key,
                label=label,
                status=summary.status,
                scheme=summary.config.scheme.value,
                row=payload,
            )
            self._completed[key] = {
                "type": "sweep_trajectory", "key": key, "label": label,
                "status": summary.status, "row": payload,
            }
        _METRICS.counter("sweep_journal.records").inc()

    def close(self) -> None:
        with self._lock:
            if self._logger is not None:
                self._logger.close()
                self._logger = None


# ---------------------------------------------------------------------------
# ambient (env-driven) journal: lets EVERY sweep entry point — compare,
# straggler_sweep, baseline_suite, the CLIs — journal/resume without each
# one growing plumbing. One shared instance per (dir, resume) resolution.

_env_journal: Optional[SweepJournal] = None
_env_key: Optional[tuple] = None


def from_env() -> Optional[SweepJournal]:
    """The process's ambient journal per ``ERASUREHEAD_SWEEP_JOURNAL`` /
    ``ERASUREHEAD_RESUME_SWEEP`` (utils/config resolvers), or None when
    unset. Cached so repeated ``compare()`` calls share one writer."""
    from erasurehead_tpu_torch.utils.config import (
        resolve_resume_sweep,
        resolve_sweep_journal,
    )

    global _env_journal, _env_key
    directory = resolve_sweep_journal()
    if directory is None:
        return None
    key = (directory, resolve_resume_sweep())
    if _env_journal is None or _env_key != key:
        if _env_journal is not None:
            _env_journal.close()
        _env_journal = SweepJournal(directory, resume=key[1])
        _env_key = key
    return _env_journal


def reset_env_journal() -> None:
    """Drop the cached ambient journal (tests)."""
    global _env_journal, _env_key
    if _env_journal is not None:
        _env_journal.close()
    _env_journal = None
    _env_key = None
