"""The serve daemon: multi-tenant sweep-as-a-service over the cohort engine.

The port of erasurehead_tpu/serve/server.py. ``SweepServer`` is a
long-running loop that turns CONCURRENT CLIENTS into the batch dimension
the cohort engine already exploits per sweep: clients submit labeled
trajectory requests (in-process ``submit()``, or the socket and HTTP
fronts behind ``python -m erasurehead_tpu_torch.cli serve``); a packer
bin-packs compatible pending requests into shared cohort dispatches
(serve/packer.py — key = cohort signature + dataset identity); an admission controller bounds the in-flight device memory
(serve/admission.py); and each request's summary row streams back to its
submitter as the dispatch lands, journaled per tenant (train/journal.py)
so the sweep's resume/quarantine machinery becomes per-tenant fault
isolation.

Contracts:

  - packing is a pure throughput lever: every batchable request
    dispatches through the cohort engine (singletons included), and a
    cohort's per-trajectory results are bitwise independent of how it
    packed — a packed request and
    the same request dispatched alone produce IDENTICAL journal rows
    (pinned in tests/test_torch_serve.py and by chip_smoke.py's serve
    phase on the card);
  - fault isolation: a dispatch failure degrades through the harness's
    out-of-memory ladder (bisect / sequential, experiments.
    _dispatch_cohort) and, beyond it, fails only ITS cohort's requests
    (status="error") — the daemon and every other tenant's work continue;
    divergence quarantines the single row (status="diverged"), exactly as
    in a local sweep;
  - per-tenant resume: each tenant's rows journal to
    ``<journal_dir>/<tenant>/sweep_journal.jsonl``; a resubmitted request
    whose (label, config, data, arrivals) key is already journaled is
    REHYDRATED bitwise without a dispatch.

All dispatching happens on a small thread pool (two threads by default),
on the daemon's one device (``device=``: ``cuda`` unless ``"cpu"`` is asked
for; the constructor raises where there is no card). The dispatch threads
launch on their current stream, which is the device's default stream for
every thread: the two dispatches' host work overlaps, their device work
runs in launch order on one stream, so the data cache's shared stacks need
no cross-stream guard. A dispatch's ``torch.cuda.synchronize`` waits for
its neighbour's launches too, so ``real_steps_per_sec`` under concurrency
is a shared-device figure. The admission controller is what keeps the
concurrency from overcommitting device memory.

Across ranks (a process group of several, e.g. ``torchrun
--nproc-per-node N -m erasurehead_tpu_torch.cli serve``): rank 0
(``backend.is_writer()``) owns the socket and HTTP fronts, admission, the
WAL, the journals and the event log; every other rank runs
:meth:`SweepServer.follow`. Every rank constructs its SweepServer at the
same point (the constructor forms the group the dispatches are broadcast
in). For each dispatch rank 0 broadcasts one message (serve/queue.
dispatch_message: the configs, the arrivals, how to find the dataset, an
admission eviction to repeat) in a group with no timeout
(parallel/backend.untimed_group), since a follower waits there for as long
as the daemon stays idle, and every rank runs the same ``_dispatch_cohort`` or
``_train_one_guarded`` over the worker mesh, B1 inside ``train`` and
``train_cohort`` on each rank's slice; rank 0 answers. The ranks agree on
each dispatch's outcome twice (after the followers resolved the dataset,
and after the run), so a failure on any rank fails that cohort's requests
on rank 0 and the daemon lives on; inside the run the harness's guard
agrees on each attempt (train/experiments._attempt), so the ranks retry or
bisect together. Collectives must meet in the same order
on every rank, so across ranks the daemon runs one dispatch at a time,
serialized by rank 0's broadcast, where the JAX package's two dispatch
threads overlap on one mesh: a deliberate deviation. A failure on one rank
only, inside a dispatch's collectives, is seen by the others when their
collectives time out (parallel/backend.DEFAULT_TIMEOUT_S); the daemon then
answers that cohort with the error, and a group that lost a rank fails
every later dispatch the same way. ``stop()`` ends the followers. A follower
whose rank 0 died ends at its next collective, whose connection closes
(``cli serve`` exits 1 there). In ``cli serve`` across ranks a SIGTERM to
rank 0 drains and stops the daemon as SIGINT does, so a group stops between
dispatches and no rank is left inside a collective; a follower leaves both
signals to rank 0 (the serve fleet signals a replica's whole group).

``cache_dir`` names the directory the kernel library is built into and
loaded from, where the JAX package names its persistent compilation cache:
a restarted daemon pointed at the same directory builds nothing. The
kernel library is the port's only compiled artifact; the round loops are
eager. The build directory is one per process, so ``cli serve`` (:func:`main`)
sets it (ops/kernels.set_build_dir) before it constructs the daemon;
``SweepServer`` only records its ``cache_dir``.
"""

from __future__ import annotations

import contextlib
import collections
import dataclasses
import itertools
import math
import os
import queue as queue_lib
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from erasurehead_tpu_torch.data.synthetic import Dataset
from erasurehead_tpu_torch.obs import events as events_lib
from erasurehead_tpu_torch.obs.metrics import REGISTRY as _METRICS
from erasurehead_tpu_torch.parallel import backend as backend_lib
from erasurehead_tpu_torch.serve import admission as admission_lib
from erasurehead_tpu_torch.serve import queue as serve_queue
from erasurehead_tpu_torch.serve import packer as packer_lib
from erasurehead_tpu_torch.serve import wal as wal_lib
from erasurehead_tpu_torch.serve.queue import (
    RequestHandle,
    RunRequest,
    ServeOverloadedError,
    ServeResult,
    config_payload,
    request_digest,
)
from erasurehead_tpu_torch.train import cache as cache_lib
from erasurehead_tpu_torch.train import experiments, trainer
from erasurehead_tpu_torch.train import journal as journal_lib
from erasurehead_tpu_torch.utils import chaos
from erasurehead_tpu_torch.utils.config import RunConfig
from erasurehead_tpu_torch.utils.device import resolve_device

#: how long the packing window stays open once a request arrives: the
#: daemon trades this much latency for whatever packs in behind it
DEFAULT_WINDOW_S = 0.02

#: inbox sentinel that wakes the loop for shutdown (None would be
#: indistinguishable from a get() timeout)
_STOP = object()

#: default packed-dispatch width (requests per cohort dispatch)
DEFAULT_MAX_COHORT = 32
#: concurrent dispatch threads (the admission controller is the real
#: bound; 2 keeps a second cohort's host work and upload going while one
#: runs)
DEFAULT_DISPATCH_WORKERS = 2


def _summarize(
    request: RunRequest, result
) -> "experiments.RunSummary":
    """One dispatch result -> the request's RunSummary row, mirroring
    experiments.compare's per-trajectory completion (eval replay,
    divergence quarantine, request-local time_to_target)."""
    from erasurehead_tpu_torch.train import evaluate

    cfg = request.config
    dataset = request.dataset
    model = trainer.build_model(cfg)
    n = result.n_train
    ev = evaluate.replay(
        model,
        cfg.model,
        result.params_history,
        dataset.X_train[:n],
        dataset.y_train[:n],
        dataset.X_test,
        dataset.y_test,
    )
    diverged = experiments._diverged(result, ev)
    if diverged:
        _METRICS.counter("sweep.diverged").inc()
        events_lib.emit(
            "warning",
            kind="divergence",
            message=(
                f"serve: request {request.request_id!r} (tenant "
                f"{request.tenant!r}, scheme {cfg.scheme.value}) diverged; "
                "row quarantined as status=diverged, daemon continues"
            ),
        )
    summary = experiments.RunSummary(
        label=request.label,
        config=result.config,
        sim_total_time=result.sim_total_time,
        sim_steps_per_sec=(
            result.config.rounds / result.sim_total_time
            if result.sim_total_time > 0
            else float("inf")
        ),
        real_steps_per_sec=result.steps_per_sec,
        final_train_loss=float(ev.training_loss[-1]),
        final_test_loss=float(ev.testing_loss[-1]),
        final_auc=float(ev.auc[-1]),
        time_to_target=None,
        training_loss=ev.training_loss,
        timeset=result.timeset,
        cache=result.cache_info,
        decode_error_mean=(
            float(np.mean(result.decode_error))
            if result.decode_error is not None and len(result.decode_error)
            else None
        ),
        status="diverged" if diverged else "ok",
    )
    if request.target_loss is not None and summary.status == "ok":
        summary.time_to_target = experiments.time_to_target_loss(
            summary.training_loss, summary.timeset, request.target_loss
        )
    return summary


#: in-process datasets a follower keeps by rank 0's token (and rank 0's
#: record of the tokens it sent): the data cache's bound
RANK_DATASETS_MAX = cache_lib.DATA_CACHE_MAX


def _lru_touch(lru: collections.OrderedDict, key, value) -> None:
    """Mark ``key`` used in ``lru``, holding ``value`` (None keeps what it
    holds), then drop the least recently used keys beyond
    :data:`RANK_DATASETS_MAX`."""
    if value is not None or key not in lru:
        lru[key] = value
    lru.move_to_end(key)
    while len(lru) > RANK_DATASETS_MAX:
        lru.popitem(last=False)


class RankDispatchError(RuntimeError):
    """A dispatch across ranks failed on some rank: every rank learns it
    from the agreement after the step that failed, and goes on."""


class SweepServer:
    """In-process serve daemon (see module docstring).

    Use as a context manager, or ``start()``/``stop()`` explicitly::

        with SweepServer(budget_bytes=2 << 30,
                         request_timeout_s=120) as srv:
            h = srv.submit(tenant="alice", label="agc", config=cfg,
                           dataset=data)
            row = h.result()

    ``request_timeout_s`` is the server-side result deadline (a config
    knob, not a per-call literal): on expiry the daemon delivers a typed
    timeout error and emits a ``request_timeout`` warning, so a stalled
    dispatch is distinguishable from a client-side queue timeout.

    ``device`` is where every dispatch runs: ``cuda`` by default, ``"cpu"``
    when asked for; constructing a daemon for the card where there is none
    raises.
    """

    def __init__(
        self,
        budget_bytes: Optional[int] = None,
        max_cohort: int = DEFAULT_MAX_COHORT,
        window_s: float = DEFAULT_WINDOW_S,
        journal_dir: Optional[str] = None,
        resume: bool = True,
        dispatch_workers: int = DEFAULT_DISPATCH_WORKERS,
        pad_cohorts: bool = True,
        eta_surface=None,
        max_pending: Optional[int] = None,
        request_timeout_s: Optional[float] = None,
        fair: bool = True,
        tenant_quota: Optional[int] = None,
        cache_dir: Optional[str] = None,
        replica_name: Optional[str] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        # across ranks (module docstring): this rank follows rank 0's
        # dispatches when it is not rank 0; rank 0 serializes its
        # dispatches' collectives under _ranks_lock and broadcasts each one
        # in _control, where a follower may wait between dispatches as long
        # as the daemon stays idle. Rank 0 sends an in-process dataset's
        # arrays when its token is not among the RANK_DATASETS_MAX it sent
        # last (_sent_tokens); a follower keeps the same tokens
        # (_rank_datasets): both go through _lru_touch in broadcast order,
        # so they drop the same ones. _evictions_sent: the serve.evictions
        # count at the last broadcast (an admission eviction since then is
        # passed on to the followers)
        self._world = backend_lib.world_size()
        self._follower = not backend_lib.is_writer()
        self._control = backend_lib.untimed_group() if self._world > 1 else None
        self._ranks_lock = threading.Lock()
        self._sent_tokens: collections.OrderedDict = collections.OrderedDict()
        self._rank_datasets: collections.OrderedDict = collections.OrderedDict()
        self._evictions_sent = _METRICS.counter("serve.evictions").value
        self._followers_released = False
        #: dispatches rank 0 broadcast to the followers (each follower's
        #: follow() returns the same count)
        self.dispatches_led = 0
        self.admission = admission_lib.AdmissionController(budget_bytes)
        # admission-time ETA quotes from a what-if surface
        # (whatif/surface.Surface; None = quoting off): each accepted
        # request learns its simulated expected time-to-target up front
        self.eta = (
            admission_lib.EtaQuoter(eta_surface)
            if eta_surface is not None
            else None
        )
        self.max_cohort = int(max_cohort)
        # fixed-width dispatch: pad every batchable cohort to exactly
        # max_cohort trajectories (replicating the first request's config;
        # pad results are discarded), so that a request's row is bitwise
        # the same whether it dispatched alone or packed with strangers:
        # the cohort matmul's kernel choice and reduction order depend on
        # the batch WIDTH, not on the other columns' values, so with the
        # width pinned a column's result depends only on its own
        # trajectory (tests/test_torch_serve.py holds a request alone, in
        # column 0, against the same request packed into another column).
        # The cost is padded-column compute on light traffic: the padded
        # columns ride the same read of the stack on the card, real work on
        # the CPU; pad_cohorts=False trades the pin back for it.
        self.pad_cohorts = bool(pad_cohorts)
        self.window_s = float(window_s)
        self.journal_dir = journal_dir
        self.resume = bool(resume)
        # ---- overload robustness knobs -----------------------------------
        # high-water mark on OUTSTANDING accepted requests (queued +
        # dispatched-but-unfinished): beyond it, submit() REJECTS
        # (ServeOverloadedError / HTTP 429 / socket "rejected") with a
        # deferral-derived retry-after, instead of accepting work it can
        # only starve. None = unbounded (the historical in-process
        # behavior).
        if max_pending is not None and max_pending < 1:
            raise ValueError(
                f"max_pending must be >= 1 (or None), got {max_pending}"
            )
        self.max_pending = max_pending
        # per-request result deadline, measured from intake: on expiry
        # the daemon DELIVERS a typed timeout error (and emits a
        # request_timeout warning) instead of leaving the submitter to an
        # indistinguishable queue.Empty. None = wait forever.
        if request_timeout_s is not None and request_timeout_s <= 0:
            raise ValueError(
                f"request_timeout_s must be positive (or None), got "
                f"{request_timeout_s}"
            )
        self.request_timeout_s = request_timeout_s
        # weighted-fair packing across tenants (packer.fair_windows);
        # tenant_quota hard-caps one tenant's slots per dispatch window
        self.fair = bool(fair)
        self.tenant_quota = tenant_quota
        # warm restarts: the kernel library's build directory, recorded
        # here; the process's entry point (main) points the kernel layer at
        # it before the daemon exists, so a bounced daemon on the same
        # directory builds nothing
        self.cache_dir = cache_dir
        self._inbox: "queue_lib.Queue[Optional[RequestHandle]]" = (
            queue_lib.Queue()
        )
        self._pending: list[RequestHandle] = []
        self._journals: dict[str, journal_lib.SweepJournal] = {}
        self._journal_lock = threading.Lock()
        self._datasets: dict[tuple, object] = {}
        self._executor = ThreadPoolExecutor(
            max_workers=max(1, int(dispatch_workers)),
            thread_name_prefix="eh-serve-dispatch",
        )
        self._dispatch_ids = itertools.count(1)
        self._in_flight = 0
        # dispatches running their train_cohort/train call right now, and
        # a count of dispatch starts: a dispatch measures its peak device
        # bytes only when it started alone and no other started before it
        # ended (the peak counter is one per device); guarded by
        # _state_lock
        self._running = 0
        self._dispatch_starts = 0
        self._gen = 0  # bumped on arrivals/completions; gates re-packing
        self._state_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._drain = True
        # accepted-but-undispatched depth (inbox + pending) and
        # dispatched-but-unfinished request count: their sum is the
        # outstanding-work depth the max_pending high-water mark bounds
        # (counting only the undispatched half would let work pile up
        # unbounded in the executor's internal queue while the mark
        # reads zero); guarded by _state_lock
        self._queued = 0
        self._in_flight_requests = 0
        # EWMA of dispatch wall seconds — the admission-deferral estimate
        # behind retry-after quotes; guarded by _state_lock
        self._dispatch_ewma_s: Optional[float] = None
        # digest -> in-flight handle: idempotent resubmission coalesces
        # onto the original instead of double-dispatching
        self._by_digest: dict[str, RequestHandle] = {}
        self._digest_lock = threading.Lock()
        # delivered-result listeners (the HTTP front's stream hub).
        # Contract: a listener MUST NOT block — it runs on the dispatch
        # pool; network fronts buffer into bounded per-connection
        # outboxes and shed on overflow (the rows are journaled).
        self._result_listeners: list[Callable[[ServeResult], None]] = []
        # intake WAL (journal_dir only): acceptances persisted before any
        # dispatch work, replayed on start()
        self.wal: Optional[wal_lib.IntakeWAL] = (
            wal_lib.IntakeWAL(journal_dir)
            if journal_dir and not self._follower else None
        )
        self._watch: dict[str, tuple[RequestHandle, float]] = {}
        self._watch_lock = threading.Lock()
        self._watchdog: Optional[threading.Thread] = None
        # fleet identity (serve/fleet.py): set when this daemon is one
        # replica of a fleet — gossiped on /healthz, stamped onto fleet
        # events, and the name the router's hash ring knows it by
        self.replica_name = replica_name
        # WALs this daemon adopted from dead peers (adopt_wal)
        self.adoptions_total = 0
        # WAL-replay accounting (populated by _replay_wal)
        self._replay_records = 0
        self._replay_outstanding = 0
        self._replay_resubmitted = 0
        self._replay_rehydrated = 0

    # ---- lifecycle -------------------------------------------------------

    def _warm(self) -> None:
        # Preload the autotune decision cache ONCE, before any request
        # can dispatch: every auto-knob resolution inside a cohort
        # dispatch is then a warm in-memory dict lookup. Races never run
        # in this process — a daemon serving latency-bound tenants
        # resolves from verdicts `cli tune` persisted, or
        # from the hardcoded fallbacks, never from a measurement taken
        # on the request path.
        from erasurehead_tpu_torch import tune as tune_lib

        tune_lib.get_cache().decisions()
        if self.device.type == "cuda":
            # build (into the process's build directory: cli serve's
            # --cache-dir) and load the kernel library now: nvcc never runs
            # on the request path, and a warm restart on the same directory
            # builds nothing
            from erasurehead_tpu_torch.ops import kernels as kernels_lib

            kernels_lib.load_library()

    def start(self) -> "SweepServer":
        if self._follower:
            raise RuntimeError(
                f"rank {torch.distributed.get_rank()} of {self._world} "
                "follows rank 0's dispatches: call follow(), not start()"
            )
        if self._thread is not None:
            raise RuntimeError("serve loop already started")
        self._warm()
        self._thread = threading.Thread(
            target=self._loop, name="eh-serve-loop", daemon=True
        )
        self._thread.start()
        if self.request_timeout_s is not None:
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, name="eh-serve-watchdog",
                daemon=True,
            )
            self._watchdog.start()
        self._replay_wal()
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop the loop. ``drain=True`` (default) finishes every pending
        and in-flight request first; ``drain=False`` fails pending
        requests with status="error" and returns as soon as in-flight
        dispatches land. Across ranks the followers are then released
        (their :meth:`follow` returns)."""
        if self._thread is None:
            self._release_followers()
            return
        self._drain = drain
        self._stopping = True
        self._inbox.put(_STOP)
        self._thread.join(timeout=timeout)
        self._thread = None
        if self._watchdog is not None:
            self._watchdog.join(timeout=2)
            self._watchdog = None
        self._executor.shutdown(wait=True)
        for j in self._journals.values():
            j.close()
        self._journals.clear()
        if self.wal is not None:
            self.wal.close()
        self._release_followers()

    def __enter__(self) -> "SweepServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- client surface --------------------------------------------------

    def submit(
        self,
        request: Optional[RunRequest] = None,
        *,
        tenant: Optional[str] = None,
        label: Optional[str] = None,
        config: Optional[RunConfig] = None,
        dataset=None,
        arrivals=None,
        target_loss: Optional[float] = None,
        data_seed: int = 0,
        priority: int = 0,
        retry: int = 0,
        _replayed: bool = False,
    ) -> RequestHandle:
        """Submit one trajectory request; returns immediately with the
        handle its result will land on. Thread-safe (any number of client
        threads may submit concurrently). Raises
        :class:`ServeOverloadedError` when ``max_pending`` is set and the
        intake queue is at its high-water mark (``_replayed`` marks WAL
        rehydration traffic, which was accepted before the crash and is
        never re-rejected)."""
        if request is None:
            request = RunRequest(
                tenant=tenant, label=label, config=config, dataset=dataset,
                arrivals=arrivals, target_loss=target_loss,
                data_seed=data_seed, priority=priority, retry=retry,
            )
        if self._thread is None or self._stopping:
            raise RuntimeError("serve loop is not running")
        if (
            self.max_pending is not None
            and not _replayed
            and self.queued_depth() >= self.max_pending
        ):
            retry_after = self.retry_after_s(request.config)
            _METRICS.counter("serve.rejected").inc()
            events_lib.emit(
                "reject",
                tenant=request.tenant,
                reason="overloaded",
                label=request.label,
                retry_after_s=round(retry_after, 3),
                queued=self.queued_depth(),
                max_pending=self.max_pending,
            )
            raise ServeOverloadedError(
                f"serve: intake queue at high-water mark "
                f"({self.max_pending} accepted-but-undispatched); retry "
                f"in {retry_after:.3f}s",
                retry_after_s=retry_after,
            )
        handle = RequestHandle(request)
        handle.replayed = _replayed
        # the digest covers config-resolvable requests only: a live
        # dataset OBJECT has no wire identity, so in-process requests
        # carrying one keep the historical always-dispatch semantics
        handle.digest = None
        if request.dataset is None:
            handle.digest = request_digest(
                request.tenant, request.label, request.config,
                data_seed=request.data_seed,
                target_loss=request.target_loss,
            )
            if self.wal is not None:
                payload = config_payload(request.config)
                if payload is not None:
                    # WAL'd HERE, before the accepted reply goes out:
                    # once a front says "accepted", the acceptance is on
                    # disk — a kill any time after cannot lose it
                    self.wal.append(
                        tenant=request.tenant,
                        request_id=request.request_id,
                        label=request.label,
                        digest=handle.digest,
                        config_payload=payload,
                        data_seed=request.data_seed,
                        target_loss=request.target_loss,
                        priority=request.priority,
                    )
        # crash site: acceptance is on disk, nothing dispatched yet — a
        # kill here must rehydrate this request on restart
        chaos.maybe_fire("serve_intake")
        if self.eta is not None:
            # quoted HERE, before the enqueue, so the submitter (and the
            # socket front's "accepted" reply) reads the ETA immediately
            # rather than racing the intake loop
            handle.eta_s = self.eta.quote(request.config)
        _METRICS.counter("serve.requests").inc()
        with self._state_lock:
            self._queued += 1
        self._inbox.put(handle)
        return handle

    def queued_depth(self) -> int:
        """Outstanding accepted requests — undispatched (inbox +
        pending) plus dispatched-but-unfinished — the quantity the
        ``max_pending`` high-water mark bounds."""
        with self._state_lock:
            return self._queued + self._in_flight_requests

    def retry_after_s(self, config: Optional[RunConfig] = None) -> float:
        """The deferral-derived schedule quote a rejected client's
        backoff honors: (observed EWMA dispatch wall seconds — the
        admission deferral estimate) x (packing windows queued ahead).
        Before any dispatch has been observed, the what-if ETA quoter
        seeds the per-dispatch term (simulated seconds are the only
        cost model the daemon has yet), clamped so a pessimistic surface
        can't quote minutes. Deterministic given daemon state."""
        with self._state_lock:
            queued = self._queued
            ewma = self._dispatch_ewma_s
        per_dispatch = ewma
        if per_dispatch is None and self.eta is not None and (
            config is not None
        ):
            eta = self.eta.quote(config)
            if eta is not None:
                per_dispatch = min(float(eta), 30.0)
        if per_dispatch is None:
            per_dispatch = 1.0
        windows = max(1, math.ceil((queued + 1) / self.max_cohort))
        return float(min(60.0, max(self.window_s, per_dispatch * windows)))

    def add_result_listener(
        self, fn: Callable[[ServeResult], None]
    ) -> None:
        """Subscribe to every delivered result (the network fronts'
        streaming hub). ``fn`` runs on the delivering thread and MUST NOT
        block — buffer into a bounded outbox and shed on overflow (rows
        are journaled; a shed client re-fetches by resubmitting)."""
        self._result_listeners.append(fn)

    # ---- loop internals --------------------------------------------------

    def _journal_for(self, tenant: str) -> Optional[journal_lib.SweepJournal]:
        if self.journal_dir is None:
            return None
        # called from the intake loop AND dispatch executor threads:
        # check-then-insert under a lock, or two concurrent dispatches
        # for a new tenant each open a journal (fd leak + the loser's
        # in-memory resume map silently diverging from the winner's)
        with self._journal_lock:
            j = self._journals.get(tenant)
            if j is None:
                j = journal_lib.SweepJournal(
                    os.path.join(self.journal_dir, tenant),
                    resume=self.resume,
                )
                self._journals[tenant] = j
        return j

    def _resolve_dataset(self, request: RunRequest):
        """The request's dataset: as submitted, or from the daemon's
        memoized pool. The pool key is the config's data-defining fields
        plus ``data_seed`` — NOT the trajectory seed — so same-shape
        requests from different tenants resolve to the same object and
        can pack into one dispatch (packer.pack_key keys on object
        identity via cache.dataset_token)."""
        if request.dataset is not None:
            return request.dataset
        return self._pooled_dataset(request.config, request.data_seed)

    def _pooled_dataset(self, cfg: RunConfig, data_seed: int):
        """The pool's dataset for ``cfg``'s data-defining fields and
        ``data_seed``, loaded once (on every rank alike: the followers
        resolve a wire request's dataset by the same key)."""
        key = (
            cfg.dataset, cfg.n_rows, cfg.n_cols, cfg.n_workers,
            cfg.n_stragglers, cfg.partitions_per_worker, cfg.model.value,
            cfg.is_real_data, cfg.input_dir, data_seed,
        )
        ds = self._datasets.get(key)
        if ds is None:
            from erasurehead_tpu_torch.cli import load_dataset

            ds = load_dataset(dataclasses.replace(cfg, seed=data_seed))
            self._datasets[key] = ds
        return ds

    def _finish(self, handle: RequestHandle, result: ServeResult) -> bool:
        """Single delivery point: deliver once, fan out to any coalesced
        followers, release the digest slot, notify stream listeners.
        Returns whether this call won the delivery (a dispatch landing
        after the watchdog already timed the request out loses)."""
        if not handle._deliver(result):
            return False
        digest = getattr(handle, "digest", None)
        if digest is not None:
            with self._digest_lock:
                if self._by_digest.get(digest) is handle:
                    del self._by_digest[digest]
        _METRICS.counter("serve.results").inc()
        # completion marker (phase="done"): the live-telemetry plane's
        # per-request terminus — the SLO tracker's time-to-last-row and
        # the timeseries reducer's per-tenant goodput both pair this
        # record with the intake "request" line (report counts only
        # intake records, so request totals stay one-per-request)
        events_lib.emit(
            "request",
            tenant=result.tenant,
            request_id=result.request_id,
            label=result.label,
            phase="done",
            status=result.status,
            resumed=result.resumed,
        )
        for fn in self._result_listeners:
            try:
                fn(result)
            except Exception:  # noqa: BLE001 — a front must not kill us
                pass
        return True

    def _dec_queued(self, n: int = 1) -> None:
        with self._state_lock:
            self._queued -= n

    def _fail(self, handle: RequestHandle, error: str) -> None:
        _METRICS.counter("serve.errors").inc()
        req = handle.request
        events_lib.emit(
            "warning",
            kind="serve_error",
            message=(
                f"serve: request {req.request_id!r} (tenant "
                f"{req.tenant!r}) failed: {error.splitlines()[0][:200]}"
            ),
        )
        self._finish(
            handle,
            ServeResult(
                request_id=req.request_id, tenant=req.tenant,
                label=req.label, status="error", error=error,
            ),
        )

    def _intake(self, handle: RequestHandle) -> None:
        """Admit one arriving request into the pending set: emit its
        ``request`` event, coalesce digest duplicates onto the in-flight
        original, resolve its dataset and arrivals, and serve it
        straight from the tenant's journal when resumable. (The WAL
        append happened in ``submit`` — acceptance durability precedes
        the accepted reply.) Every exit path balances the submit-side
        ``_queued`` increment except the pending append (dispatch
        decrements it)."""
        req = handle.request
        events_lib.emit(
            "request",
            tenant=req.tenant,
            request_id=req.request_id,
            label=req.label,
            scheme=req.config.scheme.value,
            eta_s=handle.eta_s,
            priority=req.priority,
            retry=req.retry,
            digest=handle.digest,
        )
        if handle.digest is not None:
            with self._digest_lock:
                live = self._by_digest.get(handle.digest)
                if live is not None and live._follow(handle):
                    # idempotent resubmission: ride the in-flight
                    # original instead of double-dispatching
                    _METRICS.counter("serve.coalesced").inc()
                    self._dec_queued()
                    self._classify_replay(handle, resubmitted=False)
                    return
                self._by_digest[handle.digest] = handle
        handle.pooled = req.dataset is None
        try:
            req.dataset = self._resolve_dataset(req)
            if req.arrivals is None:
                req.arrivals = trainer.default_arrivals(req.config)
        except Exception as e:  # noqa: BLE001 — isolate to this request
            self._dec_queued()
            self._classify_replay(handle, resubmitted=True)
            self._fail(handle, f"{type(e).__name__}: {e}")
            return
        journal = self._journal_for(req.tenant)
        if journal is not None:
            key = journal_lib.trajectory_key(
                req.label, req.config, req.dataset, req.arrivals
            )
            handle.journal_key = key
            rec = journal.lookup(key)
            if rec is not None:
                _METRICS.counter("serve.resumed").inc()
                summary = journal_lib.rehydrate_summary(
                    rec["row"], req.config
                )
                self._dec_queued()
                self._classify_replay(handle, resubmitted=False)
                self._finish(
                    handle,
                    ServeResult(
                        request_id=req.request_id, tenant=req.tenant,
                        label=req.label, status=rec.get("status", "ok"),
                        row=rec["row"], summary=summary, resumed=True,
                    ),
                )
                return
        else:
            handle.journal_key = None
        self._classify_replay(handle, resubmitted=True)
        if self.request_timeout_s is not None:
            with self._watch_lock:
                self._watch[req.request_id] = (
                    handle, time.monotonic() + self.request_timeout_s,
                )
        self._pending.append(handle)

    # ---- warm restart: WAL replay ---------------------------------------

    def _classify_replay(self, handle, resubmitted: bool) -> None:
        """Count one replayed handle's intake outcome toward the pending
        ``restart`` event (no-op for ordinary traffic); emits the event
        once the last replayed acceptance is classified."""
        if not getattr(handle, "replayed", False):
            return
        with self._state_lock:
            if resubmitted:
                self._replay_resubmitted += 1
            else:
                self._replay_rehydrated += 1
            self._replay_outstanding -= 1
            done = self._replay_outstanding == 0
            counts = (
                self._replay_records,
                self._replay_resubmitted,
                self._replay_rehydrated,
            )
        if done:
            _METRICS.counter("serve.restarts").inc()
            events_lib.emit(
                "restart",
                wal_records=counts[0],
                resubmitted=counts[1],
                rehydrated=counts[2],
            )

    def _replay_wal(self) -> None:
        """Re-serve the working set a previous daemon accepted but never
        finished: resubmit every WAL acceptance through the normal intake
        path. Records whose rows are already journaled rehydrate with no
        dispatch; the rest re-dispatch, warm against the kernel library in
        ``cache_dir`` (a restart builds nothing). Nobody waits on these handles: the point is that the
        rows land in the per-tenant journals, where the original
        submitters' idempotent resubmissions find them."""
        if self.wal is None:
            return
        records = self.wal.replay()
        with self._state_lock:
            self._replay_records = len(records)
            self._replay_outstanding = len(records)
            self._replay_resubmitted = 0
            self._replay_rehydrated = 0
        if not records:
            return
        self._resubmit_records(records)

    def _resubmit_records(self, records: list) -> None:
        """Resubmit WAL acceptance records through the normal intake
        path (shared by warm-restart replay and fleet adoption). The
        ORIGINAL request_id is preserved: a client holding the accepted
        id sees the replayed result under the same identity, so its
        request_id dedup makes cross-replica delivery exactly-once."""
        from erasurehead_tpu_torch.serve.queue import (
            RunRequest,
            config_from_payload,
        )

        for rec in records:
            try:
                req = RunRequest(
                    tenant=rec["tenant"], label=rec["label"],
                    config=config_from_payload(rec["config"]),
                    target_loss=rec.get("target_loss"),
                    data_seed=int(rec.get("data_seed", 0)),
                    priority=int(rec.get("priority", 0)),
                    request_id=str(rec.get("request_id") or ""),
                )
                self.submit(request=req, _replayed=True)
            except Exception as e:  # noqa: BLE001 — one bad WAL record
                # must not strand the rest of the working set
                events_lib.emit(
                    "warning",
                    kind="wal_replay_error",
                    message=(
                        f"serve: WAL record {rec.get('digest')!r} "
                        f"(tenant {rec.get('tenant')!r}) failed to "
                        f"replay: {type(e).__name__}: {e}"
                    ),
                )
                with self._state_lock:
                    self._replay_outstanding -= 1

    # ---- fleet: adopting a dead peer's WAL -------------------------------

    def adopt_wal(
        self,
        path: str,
        *,
        owner_alive=None,
        dead_replica: str = "unknown",
    ) -> dict:
        """Adopt a DEAD fleet peer's intake WAL and replay its accepted
        working set through this daemon's normal intake (serve/wal.py
        ``adopt``: O_EXCL sentinel lock, refusal while the owner still
        answers /healthz, dedup against this daemon's own acceptances by
        request_digest). Resubmission WALs each record locally, so the
        adopted acceptances now survive THIS daemon's death too; rows
        already journaled per-tenant rehydrate with no dispatch. Returns
        the adoption accounting; raises
        :class:`~erasurehead_tpu_torch.serve.wal.WalAdoptionError` when the
        adoption is refused (already adopted / owner alive)."""
        if self.wal is None:
            raise RuntimeError(
                "adopt_wal needs a journal_dir-backed daemon: adoption "
                "replays acceptances into this daemon's own WAL"
            )
        records = self.wal.adopt(path, owner_alive=owner_alive)
        self.adoptions_total += 1
        _METRICS.counter("serve.adoptions").inc()
        events_lib.emit(
            "fleet",
            action="adopt",
            replica=dead_replica,
            records=len(records),
            adopter=self.replica_name,
        )
        with self._state_lock:
            # adoption reuses the restart accounting: the `restart`
            # event that fires when the last adopted record classifies
            # is the adoption's replay ledger
            self._replay_records = len(records)
            self._replay_outstanding = len(records)
            self._replay_resubmitted = 0
            self._replay_rehydrated = 0
        if records:
            self._resubmit_records(records)
        return {"records": len(records), "wal_path": path}

    # ---- request-timeout watchdog ---------------------------------------

    def _watchdog_loop(self) -> None:
        """Deliver a TYPED timeout error for any request that has not
        produced a result within ``request_timeout_s`` of intake — the
        submitter (and the socket front's relay) gets a distinguishable
        reply instead of an indistinguishable queue.Empty. The late
        dispatch, when it eventually lands, loses the deliver-once race
        and its row still journals (a resubmission rehydrates it)."""
        while True:
            if self._stopping and self._thread is None:
                return
            now = time.monotonic()
            expired: list[RequestHandle] = []
            with self._watch_lock:
                for rid in list(self._watch):
                    h, deadline = self._watch[rid]
                    if h._delivered:
                        del self._watch[rid]
                    elif deadline <= now:
                        del self._watch[rid]
                        expired.append(h)
                empty = not self._watch
            for h in expired:
                req = h.request
                _METRICS.counter("serve.timeouts").inc()
                events_lib.emit(
                    "warning",
                    kind="request_timeout",
                    message=(
                        f"serve: request {req.request_id!r} (tenant "
                        f"{req.tenant!r}, label {req.label!r}) produced "
                        f"no result within request_timeout_s="
                        f"{self.request_timeout_s:g}s; typed timeout "
                        f"error delivered"
                    ),
                )
                self._finish(
                    h,
                    ServeResult(
                        request_id=req.request_id, tenant=req.tenant,
                        label=req.label, status="error",
                        error=(
                            f"RequestTimeout: no result within "
                            f"{self.request_timeout_s:g}s (server "
                            f"request_timeout_s; the dispatch may still "
                            f"land and journal — resubmit to re-fetch)"
                        ),
                    ),
                )
            if self._stopping and empty and not expired:
                return
            time.sleep(0.05)

    def _loop(self) -> None:
        last_packed_gen = -1
        stop_seen = False
        while True:
            # ---- gather: block briefly, then hold the packing window
            # open so a burst of concurrent submissions packs together
            arrivals: list[RequestHandle] = []
            try:
                item = self._inbox.get(timeout=0.05)
                if item is _STOP:
                    stop_seen = True
                else:
                    arrivals.append(item)
            except queue_lib.Empty:
                pass
            if arrivals:
                deadline = time.monotonic() + self.window_s
                while time.monotonic() < deadline:
                    try:
                        nxt = self._inbox.get_nowait()
                    except queue_lib.Empty:
                        time.sleep(self.window_s / 10)
                        continue
                    if nxt is _STOP:
                        stop_seen = True
                    else:
                        arrivals.append(nxt)
            for h in arrivals:
                self._intake(h)
            if arrivals:
                with self._state_lock:
                    self._gen += 1

            # ---- pack + admit whatever the budget allows; deferred
            # cohorts retry when the generation moves (new arrivals, or a
            # dispatch completed and released its admission charge)
            with self._state_lock:
                gen = self._gen
            if self._pending and gen != last_packed_gen:
                last_packed_gen = gen
                self._try_dispatch()

            # ---- exit once stopping and (drained or drain=False)
            if stop_seen:
                if not self._drain and self._pending:
                    for h in self._pending:
                        self._dec_queued()
                        self._fail(h, "server stopped before dispatch")
                    self._pending.clear()
                with self._state_lock:
                    in_flight = self._in_flight
                if (
                    not self._pending
                    and in_flight == 0
                    and self._inbox.empty()
                ):
                    return
                # else keep looping: in-flight dispatches still land, and
                # drain mode keeps packing the remaining pending set

    def _try_dispatch(self) -> None:
        """One packing pass over the pending set: dispatch every cohort
        the admission controller lets through, keep the rest pending."""
        by_id = {h.request.request_id: h for h in self._pending}
        packs = packer_lib.plan_packs(
            [h.request for h in self._pending],
            max_cohort=self.max_cohort,
            fair=self.fair,
            tenant_quota=self.tenant_quota,
        )
        dispatched: set[str] = set()
        for cohort in packs:
            dispatch_id = f"disp-{next(self._dispatch_ids):04d}"
            width = (
                self.max_cohort
                if (cohort.batchable and self.pad_cohorts)
                else len(cohort.requests)
            )
            if not self.admission.try_admit(cohort, dispatch_id, width=width):
                continue  # stays pending; retried on the next generation
            for req in cohort.requests:
                dispatched.add(req.request_id)
            handles = [by_id[r.request_id] for r in cohort.requests]
            events_lib.emit(
                "pack",
                n_trajectories=len(cohort.requests),
                labels=cohort.labels,
                tenants=cohort.tenants,
                cohort=cohort.key_digest,
                dispatch_id=dispatch_id,
                batchable=cohort.batchable,
            )
            _METRICS.counter("serve.dispatches").inc()
            if len(cohort.requests) > 1:
                _METRICS.counter("serve.packed_trajectories").inc(
                    len(cohort.requests)
                )
            with self._state_lock:
                self._in_flight += 1
            self._executor.submit(
                self._run_cohort, cohort, handles, dispatch_id
            )
        if dispatched:
            with self._state_lock:
                self._queued -= len(dispatched)
                self._in_flight_requests += len(dispatched)
            self._pending = [
                h for h in self._pending
                if h.request.request_id not in dispatched
            ]

    def _measured(self, dispatch):
        """Run ``dispatch()`` and return ``(its result, its peak device
        bytes above its start)``; the peak is None on the CPU, and None
        unless this dispatch started with no other running and none started
        before it ended: the device has one peak counter, which a
        concurrent dispatch would inflate or reset."""
        cuda = self.device.type == "cuda"
        with self._state_lock:
            alone = self._running == 0
            self._running += 1
            self._dispatch_starts += 1
            starts = self._dispatch_starts
        base = None
        if cuda and alone:
            torch.cuda.reset_peak_memory_stats(self.device)
            base = torch.cuda.memory_allocated(self.device)
        try:
            out = dispatch()
        finally:
            with self._state_lock:
                self._running -= 1
                alone = alone and self._dispatch_starts == starts
        peak = None
        if base is not None and alone:
            peak = torch.cuda.max_memory_allocated(self.device) - base
        return out, peak

    def _dispatch_fn(self, batchable: bool, ids, configs, arrivals, dataset):
        """The dispatch of ``ids``, as a call: a batchable cohort through
        the harness's guarded cohort engine, otherwise each run through
        sequential train(), the bottom of the harness's ladder, retried on
        a transient failure (experiments._train_one_guarded), as the JAX
        daemon's non-batchable path. Every rank runs the same call."""
        if batchable:
            return lambda: experiments._dispatch_cohort(
                list(ids), configs, dataset, arrivals, self.device, None,
            )
        return lambda: {
            rid: experiments._train_one_guarded(
                rid, configs, dataset, arrivals, self.device, None,
            )
            for rid in ids
        }

    # ---- across ranks ----------------------------------------------------

    def _data_spec(self, handle: RequestHandle) -> dict:
        """How the followers find a dispatch's dataset (serve/queue.
        dispatch_message): by the pool's key for a pooled request, else
        by rank 0's dataset token, with the arrays unless the token is among
        the followers' last :data:`RANK_DATASETS_MAX`. Called under
        ``_ranks_lock``, in broadcast order."""
        req = handle.request
        if handle.pooled:
            return {"pool": serve_queue.config_entry(req.config),
                    "data_seed": req.data_seed}
        tok = cache_lib.dataset_token(req.dataset)
        sent = tok in self._sent_tokens
        _lru_touch(self._sent_tokens, tok, True)
        return {"token": tok,
                "arrays": None if sent else serve_queue.dataset_payload(req.dataset)}

    def _lead(self, msg: dict, handle: RequestHandle, run):
        """Rank 0's side of one dispatch across ranks: complete ``msg`` with
        how to find ``handle``'s dataset and whether an admission eviction
        came since the last broadcast, broadcast it, then run it with the
        followers (:meth:`_agreed`). One dispatch at a time: the ranks'
        collectives must meet in one order."""
        with self._ranks_lock:
            msg["data"] = self._data_spec(handle)
            evictions = _METRICS.counter("serve.evictions").value
            msg["evict"] = evictions != self._evictions_sent
            self._evictions_sent = evictions
            backend_lib.agree(msg, self._control)
            self.dispatches_led += 1
            return self._agreed(lambda: None, run)

    @staticmethod
    def _agreed(prepare, run):
        """Run one dispatch on every rank together: ``prepare()`` (a
        follower resolves the configs and the dataset), then the ranks
        agree that every one prepared before any collective of ``run()``
        starts, then ``run()``, then they agree on its outcome. Raises,
        naming each rank that failed and its error, when any rank failed:
        on rank 0 that fails the cohort's requests."""
        out = None
        for step in (prepare, run):
            err = None
            try:
                out = step()
            except Exception as e:  # noqa: BLE001 — agreed on below
                err = f"{type(e).__name__}: {e}"
                if not backend_lib.is_writer():
                    # rank 0 answers with the message; the trace stays here
                    traceback.print_exc()
            errs = backend_lib.every_rank(err)
            failed = [(r, e) for r, e in enumerate(errs) if e is not None]
            if failed:
                raise RankDispatchError(
                    "dispatch failed across ranks: "
                    + "; ".join(f"rank {r}: {e}" for r, e in failed)
                )
        return out

    def follow(self) -> int:
        """Serve rank 0's dispatches on this rank (not rank 0) until rank 0
        stops: each broadcast dispatch message is resolved (configs,
        arrivals, the dataset by the pool's key or rank 0's token) and run
        with the same call rank 0 runs, over the worker mesh; the results
        are rank 0's to deliver. A dispatch that fails on any rank is
        reported by rank 0, and this rank goes on to the next. Returns the
        number of dispatches followed."""
        if not self._follower:
            raise RuntimeError("rank 0 serves the requests: call start()")
        self._warm()
        n = 0
        while True:
            # no bound on the wait: the daemon may stay idle for days
            msg = backend_lib.agree(None, self._control)
            if msg["op"] == "stop":
                return n
            n += 1
            self._take_message(msg)
            state: dict = {}

            def prepare(msg=msg):
                configs = {rid: serve_queue.config_from_entry(e)
                           for rid, e in msg["configs"].items()}
                state["run"] = self._dispatch_fn(
                    msg["batchable"], msg["ids"], configs, msg["arrivals"],
                    self._message_dataset(msg["data"]),
                )

            try:
                self._agreed(prepare, lambda: state["run"]())
            except RankDispatchError:
                pass  # rank 0 fails the cohort's requests with the errors

    def _take_message(self, msg: dict) -> None:
        """A follower's bookkeeping for a dispatch message, before it runs
        the dispatch (and whether or not it can): repeat an admission
        eviction of rank 0's, and keep the dataset's arrays by rank 0's
        token, dropping the tokens rank 0 drops."""
        if msg["evict"]:
            self._evict_caches()
        data = msg["data"]
        if "token" in data:
            _lru_touch(self._rank_datasets, data["token"], data["arrays"])

    def _message_dataset(self, data: dict):
        """A follower's dataset for a dispatch message's ``data`` (its
        arrays, kept by :meth:`follow`, become one Dataset object per
        token, so the data cache hits across dispatches)."""
        if "token" not in data:
            return self._pooled_dataset(
                serve_queue.config_from_entry(data["pool"]), data["data_seed"]
            )
        held = self._rank_datasets.get(data["token"])
        if held is None:
            raise RuntimeError(
                f"rank {torch.distributed.get_rank()} holds no dataset for "
                f"token {data['token']}"
            )
        if not isinstance(held, Dataset):
            held = Dataset(**held)
            self._rank_datasets[data["token"]] = held
        return held

    @staticmethod
    def _evict_caches() -> None:
        """A follower's side of an admission eviction on rank 0 (serve/
        admission.AdmissionController.try_admit): drop the same caches'
        pins."""
        cache_lib.drop_data_cache()
        if cache_lib.exec_cache_bytes():
            cache_lib.drop_executables()

    def _release_followers(self) -> None:
        """Across ranks, rank 0 ends the followers' loops (once)."""
        if self._world == 1 or self._follower or self._followers_released:
            return
        with self._ranks_lock:
            self._followers_released = True
            backend_lib.agree(serve_queue.STOP_MESSAGE, self._control)

    def _run_cohort(self, cohort, handles, dispatch_id: str) -> None:
        """Dispatch one admitted cohort (executor thread) and deliver each
        request's result as it is summarized. Failures here are isolated:
        this cohort's requests get status="error", the daemon lives on."""
        t_start = time.monotonic()
        try:
            # crash site: one FLEET REPLICA dies mid-dispatch — a peer
            # must adopt its WAL and replay the accepted working set
            # (serve/fleet.py arms it on one replica's process)
            chaos.maybe_fire("fleet_replica")
            # crash site: accepted + WAL'd, rows not yet journaled — the
            # warm-restart working set a kill here leaves behind
            chaos.maybe_fire("serve_dispatch")
            ids = [h.request.request_id for h in handles]
            configs = {h.request.request_id: h.request.config for h in handles}
            arrivals = {
                h.request.request_id: h.request.arrivals for h in handles
            }
            dataset = handles[0].request.dataset
            if cohort.batchable:
                dispatch_ids = list(ids)
                if self.pad_cohorts and len(ids) < self.max_cohort:
                    # fixed-width dispatch (see __init__): fill the empty
                    # seats with the first request's trajectory; the pad
                    # columns' results are computed and dropped
                    first = handles[0].request
                    for i in range(self.max_cohort - len(ids)):
                        pid = f"_pad{i}_{dispatch_id}"
                        configs[pid] = first.config
                        arrivals[pid] = first.arrivals
                        dispatch_ids.append(pid)
            else:
                dispatch_ids = ids
            run = self._dispatch_fn(
                cohort.batchable, dispatch_ids, configs, arrivals, dataset
            )
            if self._world > 1:
                msg = serve_queue.dispatch_message(
                    dispatch_id, cohort.batchable, dispatch_ids, configs,
                    arrivals,
                )
                # the peak is measured inside the ranks' one-at-a-time
                # section: only there does a dispatch run alone
                results, peak = self._lead(msg, handles[0],
                                           lambda: self._measured(run))
            else:
                results, peak = self._measured(run)
            self.admission.observe(cohort, {"device_peak_bytes": peak})
            for h in handles:
                req = h.request
                summary = _summarize(req, results[req.request_id])
                payload = journal_lib.summary_payload(summary)
                journal = self._journal_for(req.tenant)
                if journal is not None and h.journal_key is not None:
                    journal.record(h.journal_key, req.label, summary)
                events_lib.emit(
                    "sweep_trajectory",
                    key=h.journal_key or req.request_id,
                    label=req.label,
                    status=summary.status,
                    row=payload,
                    tenant=req.tenant,
                    request_id=req.request_id,
                )
                # crash site: row journaled, reply not yet delivered —
                # the submitter re-fetches by resubmitting (rehydrates)
                chaos.maybe_fire("serve_reply")
                self._finish(
                    h,
                    ServeResult(
                        request_id=req.request_id, tenant=req.tenant,
                        label=req.label, status=summary.status,
                        row=payload, summary=summary,
                    ),
                )
        except Exception as e:  # noqa: BLE001 — tenant isolation boundary
            err = f"{type(e).__name__}: {e}"
            for h in handles:
                self._fail(h, err)
        finally:
            wall = time.monotonic() - t_start
            self.admission.release(dispatch_id)
            with self._state_lock:
                # EWMA of dispatch wall seconds: the deferral estimate
                # behind retry_after_s quotes (alpha=0.3 — recent
                # traffic shape wins, one outlier doesn't)
                prev = self._dispatch_ewma_s
                self._dispatch_ewma_s = (
                    wall if prev is None else 0.7 * prev + 0.3 * wall
                )
                self._in_flight -= 1
                self._in_flight_requests -= len(handles)
                self._gen += 1


@contextlib.contextmanager
def serving(**kw):
    """``with serving(...) as srv:`` — a started SweepServer that stops
    (draining) on exit."""
    srv = SweepServer(**kw)
    srv.start()
    try:
        yield srv
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# thin unix-socket front: newline-delimited JSON over AF_UNIX. One line in:
#   {"op": "submit", "tenant": ..., "label": ..., "config": {...},
#    "target_loss"?: float, "data_seed"?: int, "priority"?: int,
#    "retry"?: int}
# lines out (interleaved, tagged by request_id):
#   {"type": "accepted", "request_id": ...}
#   {"type": "rejected", "retry_after_s": float, "message": ...}
#                                            (backpressure — resubmit
#                                             after retry_after_s)
#   {"type": "result", "request_id", "tenant", "label", "status",
#    "row"?: {...}, "error"?: ..., "resumed": bool}
#   {"type": "error", "message": ...}        (malformed request line)
# The protocol is the queue model verbatim (serve/queue.py); RunConfig
# payloads go through config_from_payload, so the socket surface can never
# accept a config the in-process surface would refuse.


def main(argv=None) -> int:
    """``python -m erasurehead_tpu_torch.cli serve``: run the daemon behind
    a unix socket (and, with ``--http``, an HTTP front) until interrupted
    (SIGINT drains and stops it). Clients: serve/client.ServeClient and
    HttpServeClient, or any tool that can write JSON lines to an AF_UNIX
    stream. ``--device cpu`` runs the dispatches on the CPU; the default is
    the card, and the daemon refuses to start where there is none. Under
    ``torchrun`` (a process group of several) rank 0 serves the fronts and
    the other ranks follow its dispatches (module docstring)."""
    import argparse

    from erasurehead_tpu_torch.utils.config import (
        resolve_serve_budget,
        resolve_serve_max_cohort,
    )

    p = argparse.ArgumentParser(
        prog="python -m erasurehead_tpu_torch.cli serve",
        description=(
            "Multi-tenant sweep-as-a-service daemon: packs concurrent "
            "clients' compatible run requests into shared cohort "
            "dispatches under a device-memory admission budget"
        ),
    )
    p.add_argument("--socket", default="/tmp/erasurehead-serve.sock",
                   help="unix socket path for the client front")
    p.add_argument("--budget", default=None,
                   help="in-flight device-memory admission budget: bytes with an "
                        "optional k/m/g/t suffix (e.g. 2g). Default: "
                        "ERASUREHEAD_SERVE_BUDGET env, else unbounded")
    p.add_argument("--max-cohort", type=int, default=None,
                   help="packed dispatch width. Default: "
                        "ERASUREHEAD_SERVE_MAX_COHORT env, else "
                        f"{DEFAULT_MAX_COHORT}")
    p.add_argument("--no-pad", action="store_true",
                   help="dispatch cohorts at their natural width instead "
                        "of padding to --max-cohort (saves compute on "
                        "light CPU traffic; makes a row's bits depend on "
                        "how it happened to pack)")
    p.add_argument("--window-ms", type=float, default=20.0,
                   help="packing window: how long a request waits for "
                        "compatible traffic to pack in behind it")
    p.add_argument("--journal-dir", default=None,
                   help="per-tenant sweep journals land under "
                        "DIR/<tenant>/ (train/journal.py); resubmitted "
                        "identical requests rehydrate without a dispatch")
    p.add_argument("--no-resume", action="store_true",
                   help="journal without serving rows back from it")
    p.add_argument("--dispatch-workers", type=int,
                   default=DEFAULT_DISPATCH_WORKERS,
                   help="concurrent dispatch threads (admission bounds "
                        "the memory, this bounds the overlap)")
    p.add_argument("--events", default=None,
                   help="write the daemon's serve/run event log here "
                        "(request/pack/admit/evict records; render with "
                        "`cli report`)")
    p.add_argument("--eta-surface", default=None, metavar="DIR",
                   help="quote each accepted request an expected "
                        "time-to-target from a what-if surface artifact "
                        "(`cli whatif --out DIR`); the quote "
                        "rides the socket front's accepted reply and the "
                        "request event as eta_s")
    p.add_argument("--http", default=None, metavar="HOST:PORT",
                   help="also listen on an HTTP/1.1 JSONL front "
                        "(serve/http_front.py): POST /v1/submit, "
                        "chunked-streaming GET /v1/stream, GET /healthz. "
                        "PORT 0 picks a free port (printed)")
    p.add_argument("--auth-tokens", default=None, metavar="FILE",
                   help="JSON {token: tenant} map; when set, the HTTP "
                        "front requires Authorization: Bearer <token> "
                        "and derives the tenant from it (the AF_UNIX "
                        "front stays filesystem-permission trust)")
    p.add_argument("--cache-dir", default=None, metavar="DIR",
                   help="build the CUDA kernel library into and load it "
                        "from DIR: a restarted daemon on the same DIR "
                        "re-serves its working set with no new build")
    p.add_argument("--max-pending", type=int, default=None,
                   help="backpressure high-water mark on accepted-but-"
                        "undispatched requests; beyond it submissions "
                        "are rejected (HTTP 429 / socket 'rejected') "
                        "with a deferral-derived retry-after. Default: "
                        "unbounded")
    p.add_argument("--request-timeout", type=float, default=None,
                   metavar="SECONDS",
                   help="per-request result deadline from intake; on "
                        "expiry the daemon delivers a typed timeout "
                        "error (and emits a request_timeout warning) "
                        "instead of leaving the client to a silent "
                        "queue timeout. Default: wait forever")
    p.add_argument("--tenant-quota", type=int, default=None,
                   help="hard cap on one tenant's slots per packed "
                        "dispatch window (weighted-fair packing already "
                        "round-robins tenants; the quota is the "
                        "absolute bound, closing windows short when "
                        "only over-quota traffic remains)")
    p.add_argument("--no-fair", action="store_true",
                   help="disable weighted-fair packing: windows fill "
                        "FIFO by arrival, letting one chatty tenant "
                        "monopolize dispatches")
    p.add_argument("--slo-ttlr", type=float, default=None, metavar="SECONDS",
                   help="arm the per-tenant SLO tracker on the http front "
                        "(obs/exporter.SloTracker): requests whose "
                        "time-to-last-row exceeds this emit burn-rate "
                        "`slo` events and surface on /metrics; needs "
                        "--http")
    p.add_argument("--slo-budget", type=float, default=0.1,
                   help="error budget for --slo-ttlr: tolerated breach "
                        "fraction per window (burn rate 1.0 = breaching "
                        "exactly this often; default 0.1)")
    p.add_argument("--replica-name", default=None, metavar="NAME",
                   help="fleet identity: the name this daemon is known "
                        "by in a fleet; gossiped on /healthz and stamped "
                        "onto fleet events")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="where the dispatches run (default: cuda; the "
                        "daemon refuses to start without a card unless "
                        "--device cpu)")
    ns = p.parse_args(argv)
    budget = resolve_serve_budget(ns.budget)
    max_cohort = resolve_serve_max_cohort(
        ns.max_cohort, default=DEFAULT_MAX_COHORT
    )
    # torchrun's process group, if any: rank 0 serves the fronts, every
    # other rank follows its dispatches; every rank leaves the group
    # cleanly on the way out (parallel/backend.joined)
    with backend_lib.joined(device=ns.device):
        if not backend_lib.is_writer():
            return _follow(ns)
        return _serve(ns, budget, max_cohort)


def _follow(ns) -> int:
    """``cli serve`` on a rank other than 0: follow rank 0's dispatches until
    rank 0 drains and stops. An interrupt or a SIGTERM is rank 0's to handle
    (a signal sent to the whole process group reaches every rank): this rank
    ends when rank 0 releases it (exit 0), or when rank 0 is gone (exit 1,
    at its next collective). Its last line counts the dispatches it followed
    and the kernels it launched."""
    import json as json_lib
    import signal

    from erasurehead_tpu_torch.ops import kernels as kernels_lib

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
    if ns.cache_dir is not None:
        from erasurehead_tpu_torch.ops import kernels as kernels_lib

        kernels_lib.set_build_dir(ns.cache_dir)
    srv = SweepServer(device=ns.device, cache_dir=ns.cache_dir)
    print(
        f"serve: rank {torch.distributed.get_rank()} follows rank 0 "
        f"(device {srv.device})",
        flush=True,
    )
    rank = torch.distributed.get_rank()
    try:
        n = srv.follow()
    except RuntimeError as e:  # DistBackendError too
        # e.g. rank 0's connection closed under a collective: it is gone
        print(f"serve: rank {rank} ends: {type(e).__name__}: "
              f"{str(e).splitlines()[0][:300]}", flush=True)
        return 1
    print(f"serve: rank {rank} followed {n} dispatches (launches "
          f"{json_lib.dumps(dict(kernels_lib.LAUNCHES), sort_keys=True)})",
          flush=True)
    return 0


def _serve(ns, budget, max_cohort) -> int:
    """``cli serve`` alone, or on rank 0 of a process group."""

    eta_surface = None
    if ns.eta_surface:
        from erasurehead_tpu_torch.whatif import Surface

        eta_surface = Surface.load(ns.eta_surface)
    # append, never truncate: a bounced daemon (fleet rolling deploy,
    # warm restart) reuses its events path, and the pre-bounce records
    # — adoptions, restart ledgers — are evidence the validators read.
    # validate_lines' seq checking is multi-stream for exactly this.
    capture = (
        events_lib.capture(ns.events, mode="a")
        if ns.events
        else contextlib.nullcontext()
    )
    from erasurehead_tpu_torch.ops import kernels as kernels_lib

    if ns.cache_dir is not None:
        # before any kernel loads in this process: the daemon's start()
        # builds into (or loads from) this directory
        kernels_lib.set_build_dir(ns.cache_dir)
    world = backend_lib.world_size()
    if world > 1 and threading.current_thread() is threading.main_thread():
        # across ranks a SIGTERM drains and stops as SIGINT does: the ranks
        # stop between dispatches, none inside a collective
        import signal

        def _terminate(signum, frame):
            raise KeyboardInterrupt

        signal.signal(signal.SIGTERM, _terminate)
    with capture:
        srv = SweepServer(
            budget_bytes=budget,
            max_cohort=max_cohort,
            window_s=ns.window_ms / 1000.0,
            journal_dir=ns.journal_dir,
            resume=not ns.no_resume,
            dispatch_workers=ns.dispatch_workers,
            pad_cohorts=not ns.no_pad,
            eta_surface=eta_surface,
            max_pending=ns.max_pending,
            request_timeout_s=ns.request_timeout,
            fair=not ns.no_fair,
            tenant_quota=ns.tenant_quota,
            cache_dir=ns.cache_dir,
            replica_name=ns.replica_name,
            device=ns.device,
        )
        srv.start()
        front = SocketFront(srv, ns.socket)
        http_front = None
        if ns.http:
            import json as json_lib

            from erasurehead_tpu_torch.serve.http_front import (
                HttpFront,
                parse_hostport,
            )

            tokens = None
            if ns.auth_tokens:
                with open(ns.auth_tokens) as f:
                    tokens = json_lib.load(f)
            host, port = parse_hostport(ns.http)
            http_front = HttpFront(
                srv, host=host, port=port, tokens=tokens,
                slo_ttlr_s=ns.slo_ttlr, slo_budget=ns.slo_budget,
            )
        budget_str = f"{budget} bytes" if budget is not None else "unbounded"
        print(
            f"serve: listening on {ns.socket} (budget {budget_str}, "
            f"max cohort {max_cohort}, window {ns.window_ms:g} ms, "
            f"device {srv.device})",
            flush=True,
        )
        if http_front is not None:
            print(
                f"serve: http front on {http_front.host}:"
                f"{http_front.port} "
                f"(auth {'on' if ns.auth_tokens else 'off'})",
                flush=True,
            )
        try:
            while True:
                time.sleep(0.5)
        except KeyboardInterrupt:
            print("serve: draining and shutting down", flush=True)
        finally:
            if http_front is not None:
                http_front.close()
            front.close()
            srv.stop()
        if world > 1:
            import json as json_lib

            print(f"serve: rank 0 led {srv.dispatches_led} dispatches across "
                  f"{world} ranks (launches "
                  f"{json_lib.dumps(dict(kernels_lib.LAUNCHES), sort_keys=True)})",
                  flush=True)
    return 0


class SocketFront:
    """AF_UNIX listener bridging socket clients onto a SweepServer."""

    def __init__(self, server: SweepServer, path: str):
        import socket as socket_lib

        self.server = server
        self.path = path
        if os.path.exists(path):
            os.unlink(path)
        self._sock = socket_lib.socket(
            socket_lib.AF_UNIX, socket_lib.SOCK_STREAM
        )
        self._sock.bind(path)
        self._sock.listen(16)
        self._sock.settimeout(0.2)
        self._closing = False
        self._threads: list[threading.Thread] = []
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="eh-serve-socket", daemon=True
        )
        self._accept_thread.start()

    def close(self) -> None:
        import socket as socket_lib

        self._closing = True
        self._accept_thread.join(timeout=5)
        self._sock.close()
        # shut down accepted connections so their recv() unblocks and the
        # per-connection threads see _closing and exit
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket_lib.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=2)
        self._threads.clear()
        if os.path.exists(self.path):
            os.unlink(self.path)

    def _accept_loop(self) -> None:
        import socket as socket_lib

        while not self._closing:
            try:
                conn, _ = self._sock.accept()
            except socket_lib.timeout:
                continue
            except OSError:
                return
            # a finite recv timeout is what lets _serve_conn honor
            # _closing between lines instead of blocking forever
            conn.settimeout(0.5)
            with self._conns_lock:
                self._conns.add(conn)
            self._threads = [t for t in self._threads if t.is_alive()]
            t = threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            )
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn) -> None:
        import json as json_lib
        import socket as socket_lib

        from erasurehead_tpu_torch.serve.queue import config_from_payload

        wlock = threading.Lock()

        def send(obj: dict) -> None:
            line = (json_lib.dumps(obj) + "\n").encode()
            with wlock:
                try:
                    conn.sendall(line)
                except OSError:
                    pass  # client went away; results are still journaled

        def relay(handle: RequestHandle) -> None:
            # poll rather than block forever: a close() mid-dispatch must
            # be able to retire this thread (the row is still journaled)
            while True:
                try:
                    res = handle.result(timeout=0.5)
                    break
                except queue_lib.Empty:
                    if self._closing:
                        return
            send(
                {
                    "type": "result",
                    "request_id": res.request_id,
                    "tenant": res.tenant,
                    "label": res.label,
                    "status": res.status,
                    "row": res.row,
                    "error": res.error,
                    "resumed": res.resumed,
                }
            )

        buf = b""
        try:
            with conn:
                while not self._closing:
                    try:
                        chunk = conn.recv(1 << 16)
                    except socket_lib.timeout:
                        continue  # idle; re-check _closing
                    except OSError:
                        return
                    if not chunk:
                        return
                    buf += chunk
                    while b"\n" in buf:
                        raw, buf = buf.split(b"\n", 1)
                        if not raw.strip():
                            continue
                        try:
                            msg = json_lib.loads(raw)
                            if msg.get("op") != "submit":
                                raise ValueError(
                                    f"unknown op {msg.get('op')!r} "
                                    "(only 'submit')"
                                )
                            cfg = config_from_payload(
                                msg.get("config") or {}
                            )
                            handle = self.server.submit(
                                tenant=msg["tenant"],
                                label=msg["label"],
                                config=cfg,
                                target_loss=msg.get("target_loss"),
                                data_seed=int(msg.get("data_seed", 0)),
                                priority=int(msg.get("priority", 0)),
                                retry=int(msg.get("retry", 0)),
                            )
                        except ServeOverloadedError as e:
                            # backpressure, not failure: the client's
                            # capped-exponential backoff honors the quote
                            send(
                                {
                                    "type": "rejected",
                                    "retry_after_s": e.retry_after_s,
                                    "message": str(e),
                                }
                            )
                            continue
                        except Exception as e:  # noqa: BLE001 — per-line
                            send(
                                {
                                    "type": "error",
                                    "message": f"{type(e).__name__}: {e}",
                                }
                            )
                            continue
                        send(
                            {
                                "type": "accepted",
                                "request_id": handle.request_id,
                                # what-if ETA quote (simulated seconds to
                                # the loss target; None = no surface row)
                                "eta_s": handle.eta_s,
                            }
                        )
                        threading.Thread(
                            target=relay, args=(handle,), daemon=True
                        ).start()
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
