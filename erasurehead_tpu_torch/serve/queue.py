"""Serve request/result model: what a client submits and what it gets back.

The port of erasurehead_tpu/serve/queue.py. The serve daemon's unit of work
is one trajectory request: a labeled RunConfig from some tenant, optionally
carrying its own dataset, arrival schedule and loss target. The in-process
API hands the submitter a :class:`RequestHandle`; results stream back onto
it as the packed cohort dispatches land (one :class:`ServeResult` per
request, in completion order, not submission order).

The socket and HTTP fronts (serve/server.SocketFront, serve/http_front.py)
carry the same model as JSON lines, the JAX package's protocol byte for
byte; :func:`config_from_payload` is the single place a wire payload
becomes a RunConfig, so a front can never accept a field the in-process
surface would refuse.

Every payload field of the JAX package names a RunConfig field of the
port, so the port serves every payload the JAX package serves. The request
digest hashes the port's own ``events.config_hash``, so it never equals the
JAX package's digest for the same request (as the journal key does not).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import queue as queue_lib
import secrets
import threading
from typing import Any, Optional

import numpy as np

from erasurehead_tpu_torch.obs import events as events_lib
from erasurehead_tpu_torch.utils.config import RunConfig

_request_ids = itertools.count(1)
_id_lock = threading.Lock()
#: this process's share of every request id it makes: a fleet's replicas
#: (and a replica restarted by a deploy) each count from 1, and a client
#: holding streams from several of them dedups rows by request id
_PROCESS_TOKEN = secrets.token_hex(4)


def new_request_id(tenant: str) -> str:
    """Request id unique across processes, tenant-prefixed for readable
    logs (the JAX package's is unique within one process only, so two
    replicas of a fleet can hand one tenant the same id)."""
    with _id_lock:
        n = next(_request_ids)
    return f"{tenant}-req-{_PROCESS_TOKEN}-{n:04d}"


@dataclasses.dataclass
class RunRequest:
    """One tenant's trajectory request.

    ``dataset`` is optional: in-process clients may pass a real Dataset
    (requests sharing one OBJECT share a device stack and can pack);
    config-only requests (the network fronts) are resolved by the server's
    memoized dataset pool, keyed on the config's data-defining fields plus
    ``data_seed``, so same-shape requests from different tenants resolve to
    the SAME dataset object and pack while the trajectory ``seed`` stays
    free to differ. ``arrivals`` is optional the same way (None = the
    per-config default schedule, trainer.default_arrivals)."""

    tenant: str
    label: str
    config: RunConfig
    dataset: Optional[Any] = None
    arrivals: Optional[np.ndarray] = None
    target_loss: Optional[float] = None
    data_seed: int = 0
    request_id: str = ""
    #: scheduling priority: higher dispatches sooner WITHIN a tenant's own
    #: queue (weighted-fair packing keeps tenants from outbidding each
    #: other)
    priority: int = 0
    #: client retry attempt number (0 = first try), carried on the wire so
    #: the request record can count retries that followed a 429
    retry: int = 0

    def __post_init__(self):
        if not self.tenant or not isinstance(self.tenant, str):
            raise ValueError(
                f"request tenant must be a non-empty string, got "
                f"{self.tenant!r}"
            )
        if not self.label or not isinstance(self.label, str):
            raise ValueError(
                f"request label must be a non-empty string, got "
                f"{self.label!r}"
            )
        if not self.request_id:
            self.request_id = new_request_id(self.tenant)


@dataclasses.dataclass
class ServeResult:
    """One finished trajectory, delivered back to its submitter.

    ``status``: ``"ok"`` / ``"diverged"`` (quarantined row, the daemon went
    on) / ``"error"`` (the dispatch failed; ``error`` carries the head of
    the exception). ``row`` is the UNROUNDED journal payload
    (train/journal.summary_payload), the form the bitwise
    packed-vs-alone contract is checked in; ``summary`` is the full
    RunSummary for in-process consumers (None over the wire)."""

    request_id: str
    tenant: str
    label: str
    status: str
    row: Optional[dict] = None
    summary: Optional[Any] = None
    error: Optional[str] = None
    resumed: bool = False  # rehydrated from the tenant's journal, no dispatch


class RequestHandle:
    """The submitter's view of one in-flight request."""

    def __init__(self, request: RunRequest):
        self.request = request
        self._q: "queue_lib.Queue[ServeResult]" = queue_lib.Queue()
        self._result: Optional[ServeResult] = None
        # the tenant-journal identity key, assigned at server intake once
        # the dataset/arrivals are resolved (None = journaling off)
        self.journal_key: Optional[str] = None
        # admission-time ETA quote in simulated seconds (serve/admission.
        # EtaQuoter); None = no surface or no matching feasible row
        self.eta_s: Optional[float] = None
        # deliver-once: a request-timeout watchdog and the dispatch that
        # eventually lands must not both count or reply
        self._delivered = False
        self._deliver_lock = threading.Lock()
        # handles coalesced onto this one by request digest (an idempotent
        # resubmission of an in-flight request): they receive a copy of
        # this handle's result, re-tagged with their own ids
        self._followers: list["RequestHandle"] = []
        # resolved from the daemon's dataset pool at intake (no in-process
        # dataset): across ranks the followers resolve it by the same key
        self.pooled = False

    @property
    def request_id(self) -> str:
        return self.request.request_id

    def _deliver(self, result: ServeResult) -> bool:
        """Deliver once; later deliveries are dropped. Returns whether THIS
        call was the delivery. Followers get a re-tagged copy."""
        with self._deliver_lock:
            if self._delivered:
                return False
            self._delivered = True
            followers = list(self._followers)
        self._q.put(result)
        for f in followers:
            f._deliver(
                dataclasses.replace(
                    result,
                    request_id=f.request_id,
                    label=f.request.label,
                    resumed=True,
                )
            )
        return True

    def _follow(self, follower: "RequestHandle") -> bool:
        """Attach ``follower`` to receive this handle's result (digest
        coalescing). False when this handle already delivered: the caller
        serves the follower from the journal instead."""
        with self._deliver_lock:
            if self._delivered:
                return False
            self._followers.append(follower)
            return True

    def result(self, timeout: Optional[float] = None) -> ServeResult:
        """Block until this request's result lands (memoized after the first
        call). Raises ``queue.Empty`` on timeout."""
        if self._result is None:
            self._result = self._q.get(timeout=timeout)
        return self._result

    def done(self) -> bool:
        return self._result is not None or not self._q.empty()


#: RunConfig fields a wire payload may set: the JAX package's set, the
#: plain-JSON subset (enums accept their string values; lr_schedule a number
#: or list). Deliberately absent: input_dir/is_real_data and arrival_trace
#: (a remote client must not point the daemon at host paths)
CONFIG_PAYLOAD_FIELDS = frozenset(
    {
        "scheme", "model", "n_workers", "n_stragglers", "rounds",
        "num_collect", "add_delay", "delay_mean", "compute_time",
        "worker_speed_spread", "update_rule", "alpha", "lr_schedule",
        "dataset", "n_rows", "n_cols", "partitions_per_worker",
        "compute_mode", "stack_mode", "ring_pipeline", "stack_dtype",
        "donate", "seed", "dtype", "use_pallas", "sparse_lanes",
        "dense_margin_cols", "flat_grad", "margin_flat", "deadline",
        "decode", "layer_coding", "deep_layers",
        "scan_unroll", "sparse_format", "fields_scatter", "fields_margin",
        "stack_residency", "stream_window",
    }
)

class ServeOverloadedError(RuntimeError):
    """Backpressure: the daemon's intake queue crossed its high-water mark
    and this request was REJECTED rather than accepted-then-starved.
    ``retry_after_s`` is the deferral-derived quote (the HTTP front's
    Retry-After header, the socket front's ``rejected`` reply) a client's
    backoff should honor. Nothing was enqueued, journaled or WAL'd:
    resubmitting is always safe."""

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


def request_digest(
    tenant: str,
    label: str,
    config: RunConfig,
    data_seed: int = 0,
    target_loss: Optional[float] = None,
) -> str:
    """The request's idempotency key: everything that determines WHAT a
    config-resolvable request computes (tenant, label, full config hash,
    data seed, loss target), NOT the request_id, priority or retry count.
    The intake WAL dedupes on it, and a resubmission after a crash or a 429
    coalesces onto the in-flight original."""
    payload = json.dumps(
        {
            "tenant": tenant,
            "label": label,
            "config": events_lib.config_hash(config),
            "data_seed": int(data_seed),
            "target_loss": target_loss,
        },
        sort_keys=True,
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:24]


def config_payload(cfg: RunConfig) -> Optional[dict]:
    """RunConfig -> the wire payload that reconstructs it (the fields that
    differ from their defaults), or None when the config sets a field
    outside :data:`CONFIG_PAYLOAD_FIELDS` (not expressible on the wire, so
    not WAL-replayable). ``config_from_payload(config_payload(cfg)) ==
    cfg``: a WAL-rehydrated request's journal key is the original's."""
    payload: dict = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.default is not dataclasses.MISSING:
            default = f.default
        elif f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
            default = f.default_factory()  # type: ignore[misc]
        else:
            default = None
        if v == default:
            continue
        if f.name not in CONFIG_PAYLOAD_FIELDS:
            return None
        if hasattr(v, "value") and not isinstance(v, (int, float, bool)):
            v = v.value  # enums serialize as their string values
        elif isinstance(v, tuple):
            v = list(v)
        payload[f.name] = v
    return payload


def config_from_payload(payload: dict) -> RunConfig:
    """Wire JSON -> RunConfig, refusing unknown or unserveable fields loudly
    (a typo'd knob must fail the request, not silently train the default).
    RunConfig.__post_init__ does the semantic validation."""
    if not isinstance(payload, dict):
        raise ValueError(
            f"config payload must be a JSON object, got "
            f"{type(payload).__name__}"
        )
    unknown = sorted(set(payload) - CONFIG_PAYLOAD_FIELDS)
    if unknown:
        raise ValueError(
            f"config payload has unserveable field(s) {unknown}; "
            f"accepted: {sorted(CONFIG_PAYLOAD_FIELDS)}"
        )
    return RunConfig(**payload)


# ---------------------------------------------------------------------------
# the daemon across ranks (serve/server.SweepServer over a process group of
# several): the message rank 0 broadcasts for each dispatch, from which
# every other rank runs the same dispatch over the worker mesh

#: the message that ends the other ranks' follower loops
STOP_MESSAGE = {"op": "stop"}


def config_entry(cfg: RunConfig) -> dict:
    """One config as a broadcast carries it: its wire payload, or, for a
    config the wire cannot express (an in-process request may set any
    field), the RunConfig itself, which the broadcast pickles."""
    payload = config_payload(cfg)
    return {"payload": payload} if payload is not None else {"config": cfg}


def config_from_entry(entry: dict) -> RunConfig:
    """Inverse of :func:`config_entry`."""
    if "payload" in entry:
        return config_from_payload(entry["payload"])
    return entry["config"]


def dataset_payload(dataset) -> dict:
    """An in-process dataset's arrays (its dataclass fields), without the
    marks this process's caches put on the object: what crosses to the
    other ranks once per dataset token."""
    return {f.name: getattr(dataset, f.name) for f in dataclasses.fields(dataset)}


def dispatch_message(dispatch_id: str, batchable: bool, ids, configs: dict,
                     arrivals: dict) -> dict:
    """What rank 0 broadcasts for one dispatch: its id, whether it goes
    through the cohort engine, the trajectory ids in dispatch order (the
    padded seats included), each one's config entry and arrival matrix.
    Rank 0 adds, in broadcast order (serve/server.SweepServer._lead), how
    the other ranks find the dataset (``data``: ``{"pool": entry,
    "data_seed": n}`` for a request resolved from the daemon's dataset
    pool, ``{"token": t, "arrays": payload or None}`` for an in-process
    dataset, its arrays sent unless the other ranks still hold its token)
    and ``evict``: whether an admission eviction came since the last
    broadcast, which the other ranks then repeat."""
    ids = list(ids)
    return {
        "op": "dispatch",
        "dispatch_id": dispatch_id,
        "batchable": bool(batchable),
        "ids": ids,
        "configs": {rid: config_entry(configs[rid]) for rid in ids},
        "arrivals": {rid: arrivals[rid] for rid in ids},
    }
