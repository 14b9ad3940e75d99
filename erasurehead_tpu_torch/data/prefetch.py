"""Host-to-device prefetch pipeline for streamed partition stacks.

The port of erasurehead_tpu/data/prefetch.py. The streamed trainer
(train/trainer._train_streamed, ``stack_residency="streamed"``) consumes the
shard store (data/store.py) one window of partitions per chunk of rounds.
Done naively, every chunk boundary would serialize disk, host, copy and
compute; here a staging thread reads window ``i+1`` from the shard mmaps
into a ring of reusable host buffers and copies it to the device while
chunk ``i`` computes. ``get(i)`` hands the trainer the staged window and
counts only the wait that compute failed to hide (``stats()``).

On the card (``device`` of type cuda) the overlap needs what the JAX
package got from an asynchronous ``device_put``:

- each ring slot's host buffers are pinned (``pin_memory=True``) and the
  store's ``read_ranges`` fills them through ``.numpy()`` views: a copy from
  pageable memory would run synchronously;
- the staging thread runs ``put`` (which copies with ``non_blocking=True``)
  on its own ``torch.cuda.Stream`` and records an event there;
- it waits on that event before it counts ``fetch_s`` and before the host
  slot can be reused (the JAX module's ``block_until_ready``);
- ``get(i)`` makes the consuming stream wait on the event
  (``wait_event``), not the host, and calls ``record_stream`` on the
  window's tensors, so the caching allocator does not hand their memory
  back to the copy stream while the consuming stream still reads it.

On the CPU the same class runs with plain host buffers and no stream: the
device the caller asked for, not a fallback. ``put`` must return tensors
that do not alias the host buffers it is given (they are refilled).

The ring is bounded: the staging thread takes a ring slot before it reads
a window and ``get`` gives it back, so at most ``depth`` windows (default 2,
double buffering) are staged and not yet consumed, whatever the dataset's
size. With the window being consumed that is ``depth + 1`` windows of device
memory at most, plus one staging temporary.

Each staged window leaves its records in :attr:`Prefetcher.records`, in
window order: the records its read emitted (the store's ``io``), held on the
staging thread (obs/events.deferred), and its ``prefetch`` payload (window
index, bytes, ranges, fetch seconds, the plan's fields). The staging thread
writes no record itself; the trainer emits them after its round loop.

Every staged window fires the ``prefetch`` chaos site (utils/chaos.
maybe_fire): ``ERASUREHEAD_CHAOS=raise:prefetch:N`` fails the Nth window's
stage and the trainer's next ``get``; ``kill:prefetch:N`` is a preemption
for the sweep journal's kill and resume.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from erasurehead_tpu_torch.obs import events as events_lib
from erasurehead_tpu_torch.obs.metrics import REGISTRY, warn_once
from erasurehead_tpu_torch.ops.features import QuantizedStack
from erasurehead_tpu_torch.utils import chaos as chaos_lib

#: ring depth: windows staged ahead of the one being consumed
DEFAULT_DEPTH = 2


def _norm_window(spec) -> tuple:
    """One consume-order entry as a tuple of (lo, hi) ranges: a plain
    ``(lo, hi)`` pair or a plan's range tuple (data/sharding.
    StreamWindowPlan.ranges[k])."""
    spec = tuple(spec)
    if len(spec) == 2 and not isinstance(spec[0], (tuple, list)):
        return ((int(spec[0]), int(spec[1])),)
    return tuple((int(lo), int(hi)) for lo, hi in spec)


def _host_leaves(X, y) -> list:
    """The numpy arrays of a host window (a QuantizedStack's q and scale)."""
    xs = [X.q, X.scale] if isinstance(X, QuantizedStack) else [X]
    return xs + [y]


class Prefetcher:
    """Bounded staging pipeline over a schedule of partition windows.

    ``windows`` is the exact consume-order sequence of windows the trainer
    will request, one entry per chunk of rounds (repeats allowed). ``put``
    maps one window's host tensors ``(X, y)`` (``X`` a tensor or a
    QuantizedStack of tensors) to device tensors; it runs on the staging
    thread, which is the overlap. ``get(i)`` must be called for
    ``i = 0, 1, ...`` in order. ``device`` is where ``put`` puts the
    window: a cuda device pins the host buffers and stages on a copy
    stream (module docstring). ``plan_fields`` (a dict, e.g.
    ``StreamWindowPlan.event_fields()``) rides every ``prefetch`` record.

    An error on the staging thread (a torn store, a chaos ``raise``)
    surfaces at the next ``get``, never silently and never deadlocked."""

    def __init__(
        self,
        store,
        windows: Sequence[tuple],
        put: Callable,
        *,
        depth: int = DEFAULT_DEPTH,
        device="cpu",
        plan_fields: Optional[dict] = None,
    ):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.store = store
        self.windows = [_norm_window(w) for w in windows]
        self._put = put
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._ready: queue.Queue = queue.Queue()
        # ring slots: the staging thread takes one before it reads a window,
        # get() gives it back; slot i % depth's host buffers back window i,
        # free again once that window's copy has finished
        self._free = threading.Semaphore(depth)
        self._stop = threading.Event()
        self._bufs = [dict() for _ in range(depth)]
        self._pinned = [dict() for _ in range(depth)]
        self._next_get = 0
        self._blocked_s = 0.0
        self._blocked_after_first_s = 0.0
        self._fetch_s = 0.0
        self._fetch_after_first_s = 0.0
        self._bytes = 0
        self._staged = 0
        self._plan_fields = dict(plan_fields or {})
        #: per staged window, in order: (the records its stage emitted, as
        #: (type, fields) pairs; its prefetch payload without run_id)
        self.records: list = []
        self._thread = threading.Thread(target=self._run, name="eh-prefetch", daemon=True)
        self._thread.start()

    # -- staging thread -----------------------------------------------------

    def _slot_buffers(self, slot: int, ranges) -> dict:
        """Slot ``slot``'s host buffers for a window of ``ranges``. On the
        card they are numpy views of pinned tensors of the store's window
        shapes, allocated at the slot's first use and reused after."""
        bufs = self._bufs[slot]
        if not self._cuda:
            return bufs
        n_parts = sum(hi - lo for lo, hi in ranges)
        pinned = self._pinned[slot]
        dtypes = self.store.window_dtypes()
        for key, shape in self.store.window_shapes(n_parts).items():
            t = pinned.get(key)
            if t is None or tuple(t.shape) != shape or bufs[key].dtype != dtypes[key]:
                dtype = torch.from_numpy(np.empty(0, dtypes[key])).dtype
                pinned[key] = t = torch.empty(shape, dtype=dtype, pin_memory=True)
                bufs[key] = t.numpy()
        return bufs

    def _as_tensors(self, slot: int, X, y):
        """The host window as tensors: the pinned tensor behind each array
        the read filled in place, else a tensor over the array."""
        pinned = {id(self._bufs[slot][k]): t for k, t in self._pinned[slot].items()}

        def tensor(a):
            t = pinned.get(id(a))
            return t if t is not None else torch.from_numpy(a)

        if isinstance(X, QuantizedStack):
            return QuantizedStack(tensor(X.q), tensor(X.scale)), tensor(y)
        return tensor(X), tensor(y)

    def _stage(self, i: int, ranges):
        slot = i % len(self._bufs)
        X, y = self.store.read_ranges(ranges, out=self._slot_buffers(slot, ranges))
        n_bytes = sum(a.nbytes for a in _host_leaves(X, y))
        Xt, yt = self._as_tensors(slot, X, y)
        if not self._cuda:
            return self._put(Xt, yt), None, n_bytes
        with torch.cuda.stream(self._stream):
            dev = self._put(Xt, yt)
            event = torch.cuda.Event()
            event.record(self._stream)
        # the copy has landed: the host slot may be refilled, and fetch_s
        # counts the read and the transfer, not their enqueueing
        event.synchronize()
        return dev, event, n_bytes

    def _run(self) -> None:
        for i, ranges in enumerate(self.windows):
            self._free.acquire()
            if self._stop.is_set():
                return
            try:
                chaos_lib.maybe_fire("prefetch")
                t0 = time.perf_counter()
                with events_lib.deferred() as held:
                    dev, event, n_bytes = self._stage(i, ranges)
                dt = time.perf_counter() - t0
            except BaseException as e:  # noqa: BLE001 — raised at get()
                self._ready.put((i, None, None, e))
                return
            self._fetch_s += dt
            if i:
                self._fetch_after_first_s += dt
            self._bytes += n_bytes
            self._staged += 1
            self.records.append((held, dict(
                window=i,
                bytes=n_bytes,
                partitions=[ranges[0][0], ranges[0][1]],
                ranges=[[lo, hi] for lo, hi in ranges],
                fetch_s=round(dt, 6),
                **self._plan_fields,
            )))
            self._ready.put((i, dev, event, None))

    # -- consumer side ------------------------------------------------------

    def get(self, i: int):
        """Device tensors of window ``i`` (strictly in order). Blocks until
        staged; the wait is counted as unhidden transfer time."""
        if i != self._next_get:
            raise ValueError(
                f"prefetch windows are consumed in order; expected "
                f"{self._next_get}, got {i}"
            )
        t0 = time.perf_counter()
        idx, dev, event, err = self._ready.get()
        waited = time.perf_counter() - t0
        self._blocked_s += waited
        if i:
            self._blocked_after_first_s += waited
        if err is not None:
            raise err
        if idx != i:
            raise RuntimeError(f"prefetch ring out of order: {idx} != {i}")
        self._next_get += 1
        self._free.release()
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            # a QuantizedStack is a pytree: its q and scale are leaves
            for t in pytree.tree_leaves(dev):
                t.record_stream(consumer)
        return dev

    def stats(self) -> dict:
        """Pipeline telemetry for ``cache_info``: windows staged, host bytes
        read, seconds staging (``fetch_s``) and waiting in ``get``
        (``blocked_s``), and ``overlap_efficiency``, the share of
        steady-state staging time hidden behind compute: 1 - blocked/fetch
        over every window after the first (the first has nothing to hide
        behind), 1.0 when there is nothing after it."""
        fetch = self._fetch_after_first_s
        blocked = self._blocked_after_first_s
        eff = 1.0 if fetch <= 0 else max(0.0, 1.0 - blocked / fetch)
        return {
            "windows": self._staged,
            "bytes": int(self._bytes),
            "fetch_s": round(self._fetch_s, 6),
            "blocked_s": round(self._blocked_s, 6),
            "overlap_efficiency": round(eff, 4),
        }

    def close(self, join_timeout_s: float = 10.0) -> None:
        """Stop the staging thread and drop what it staged (idempotent).

        Bounded: the drain and the join observe one ``join_timeout_s``
        deadline. A thread that outlives it (a hung shard read or copy) is
        reported once on stderr and counted in ``prefetch.join_timeout``
        (obs/metrics); it is a daemon, so it never blocks process exit."""
        t = self._thread
        if t is None:
            return
        self._thread = None
        self._stop.set()
        self._free.release()  # wake a staging thread waiting for a slot
        deadline = time.monotonic() + max(0.0, float(join_timeout_s))
        while True:
            try:
                self._ready.get_nowait()
            except queue.Empty:
                if not t.is_alive() or time.monotonic() >= deadline:
                    break
                time.sleep(0.005)
        t.join(timeout=max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            REGISTRY.counter("prefetch.join_timeout").inc()
            msg = (
                f"prefetch staging thread {t.name!r} did not exit within "
                f"{float(join_timeout_s):g}s of close(); a stage is "
                "wedged (hung shard read or device transfer) and the "
                "daemon thread leaks until process exit"
            )
            warn_once("prefetch-join-timeout", msg)
            events_lib.emit("warning", kind="prefetch_join_timeout", message=msg)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
