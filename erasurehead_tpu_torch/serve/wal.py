"""Intake write-ahead log: no accepted request is ever lost to a crash.

The port of erasurehead_tpu/serve/wal.py, whole.

The per-tenant journals (train/journal.py) persist *finished* rows; this
WAL persists *acceptances*. Every config-resolvable request the daemon
admits is appended — as a ``request`` event record carrying the full wire
payload (serve/queue.config_payload) plus its idempotency digest — BEFORE
any dispatch work happens, through the same O_APPEND single-write
EventLogger the journals use (one ``write(2)`` per line, so a kill can
tear at most the final line).

On restart, :meth:`IntakeWAL.replay` hands the daemon back its working
set: every WAL record, deduped by digest (last acceptance wins). The
server resubmits each one through its normal intake path — records whose
rows already landed in the tenant's journal rehydrate bitwise with no
dispatch; the rest re-dispatch, warm against the kernel library already
built in the daemon's ``cache_dir`` (ops/kernels.set_build_dir). The
``restart`` record holds the split.

Requests carrying an in-process dataset OBJECT are not WAL'd (a live
array isn't serializable as an acceptance, and its submitter died with
the process anyway); the network fronts are always config-resolvable, so
everything that arrived over a socket is covered.

The WAL is append-only and never compacted in-place: replay cost is one
JSON parse per acceptance since the journal directory was created, and
rotating the directory rotates the WAL with the journals it indexes.

Fleet adoption (:meth:`IntakeWAL.adopt`, reached through the HTTP front's
``POST /v1/adopt``): when a serve-fleet replica is declared DEAD,
a designated peer adopts its WAL — locking it with an O_EXCL sentinel so
the double-adoption race has exactly one winner, refusing a WAL whose
owner still answers /healthz, and deduplicating against the adopter's
own acceptances by request_digest. Accepted-never-lost thereby survives
daemon *death*, not just daemon restart.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

from erasurehead_tpu_torch.obs import events as events_lib

#: WAL file name inside the serve journal directory
WAL_NAME = "intake_wal.jsonl"

#: sentinel written beside an adopted WAL (O_EXCL): exactly one peer may
#: ever adopt a dead replica's acceptances — the loser of the race gets
#: :class:`WalAdoptionError`, not a duplicate replay
ADOPT_SENTINEL_SUFFIX = ".adopted"


class WalAdoptionError(RuntimeError):
    """Adoption refused: the WAL is already adopted (sentinel exists) or
    its owner still answers /healthz (adopting a live daemon's WAL would
    double-dispatch its working set)."""


class IntakeWAL:
    """Append-only acceptance log over ``<journal_dir>/intake_wal.jsonl``.

    Thread-safe: intake runs on the serve loop but resubmission helpers
    may append from client threads. The writer opens lazily in append
    mode so constructing the WAL never clobbers a crashed daemon's
    records."""

    def __init__(self, directory: str):
        self.directory = directory
        self.path = os.path.join(directory, WAL_NAME)
        self._logger: Optional[events_lib.EventLogger] = None
        self._lock = threading.Lock()
        self._seen: set[str] = set()
        if os.path.exists(self.path):
            for rec in self._read():
                self._seen.add(rec["digest"])

    def _read(self) -> list[dict]:
        return read_records(self.path)

    def __len__(self) -> int:
        return len(self._seen)

    def seen(self, digest: str) -> bool:
        return digest in self._seen

    def append(
        self,
        *,
        tenant: str,
        request_id: str,
        label: str,
        digest: str,
        config_payload: dict,
        data_seed: int = 0,
        target_loss: Optional[float] = None,
        priority: int = 0,
    ) -> bool:
        """Record one acceptance; returns False (and writes nothing) when
        the digest is already WAL'd — the resubmission coalesces onto the
        in-flight original, and one acceptance record is enough to
        rehydrate both."""
        with self._lock:
            if digest in self._seen:
                return False
            if self._logger is None:
                self._logger = events_lib.EventLogger(self.path, mode="a")
            self._logger.emit(
                "request",
                tenant=tenant,
                request_id=request_id,
                label=label,
                digest=digest,
                config=config_payload,
                data_seed=int(data_seed),
                target_loss=target_loss,
                priority=int(priority),
            )
            self._seen.add(digest)
        return True

    def replay(self) -> list[dict]:
        """The deduped working set: one record per digest, last
        acceptance wins, in first-acceptance order."""
        return dedup_records(read_records(self.path))

    def adopt(self, path: str, *, owner_alive=None) -> list[dict]:
        """Adopt a DEAD peer's WAL at ``path``: lock it (O_EXCL sentinel
        beside the WAL file), read its deduped working set, and return
        the records whose digests this WAL has not itself accepted —
        the adopter resubmits those through its normal intake, which
        WALs them again locally (so the acceptances now survive the
        adopter's own death too).

        ``replay()`` assumes the WAL belongs to the live process; this
        is the explicit cross-process entry point, and it refuses two
        ways a naive replay would double-dispatch:

          - ``owner_alive`` (a callable; e.g. a /healthz probe of the
            owner) returning True — adopting a live daemon's WAL would
            re-dispatch its in-flight working set;
          - a sentinel already present — exactly one peer wins the
            adoption race; the loser raises instead of replaying the
            same acceptances a second time.
        """
        src = os.path.abspath(path)
        if src == os.path.abspath(self.path):
            raise WalAdoptionError(
                f"a WAL cannot adopt itself ({src}); adoption is the "
                "cross-replica entry point — same-process restarts use "
                "replay()"
            )
        if owner_alive is not None and owner_alive():
            raise WalAdoptionError(
                f"refusing to adopt {src}: its owner still answers "
                "/healthz — adoption is for DEAD replicas (declared by "
                "the K-streak rule), not slow ones"
            )
        sentinel = src + ADOPT_SENTINEL_SUFFIX
        try:
            fd = os.open(
                sentinel, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644
            )
        except FileExistsError:
            raise WalAdoptionError(
                f"{src} is already adopted (sentinel {sentinel} "
                "exists): exactly one peer replays a dead replica's "
                "acceptances"
            ) from None
        with os.fdopen(fd, "w") as f:
            json.dump({"adopter_wal": os.path.abspath(self.path)}, f)
            f.write("\n")
        if not os.path.exists(src):
            return []
        with self._lock:
            seen = set(self._seen)
        return [
            rec
            for rec in dedup_records(read_records(src))
            if rec["digest"] not in seen
        ]

    def close(self) -> None:
        with self._lock:
            if self._logger is not None:
                self._logger.close()
                self._logger = None


def read_records(path: str) -> list[dict]:
    """Every well-formed acceptance record in a WAL file, in file order
    (tolerating a torn final line from a kill mid-write). Module-level so
    adoption can read a DEAD peer's WAL without constructing an
    :class:`IntakeWAL` over its directory (which would open a writer seam
    on a file the owner may still hold)."""
    if not os.path.exists(path):
        return []
    records: list[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn final line from a kill mid-write
            if (
                isinstance(rec, dict)
                and rec.get("type") == "request"
                and isinstance(rec.get("digest"), str)
                and isinstance(rec.get("config"), dict)
            ):
                records.append(rec)
    return records


def dedup_records(records: list[dict]) -> list[dict]:
    """One record per digest, last acceptance wins, first-acceptance
    order — the replay/adoption working-set view of a raw record list."""
    by_digest: dict[str, dict] = {}
    order: list[str] = []
    for rec in records:
        d = rec["digest"]
        if d not in by_digest:
            order.append(d)
        by_digest[d] = rec
    return [by_digest[d] for d in order]
