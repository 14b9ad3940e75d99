"""The sweep engine's caches: captured round loops and device data stacks.

The port of erasurehead_tpu/train/cache.py. The experiment harness
(train/experiments.compare, straggler_sweep, baseline_suite) and the serve
daemon run many configs over the same dataset; only the per-round weight
tables, learning rates and seeds differ. Two module-level caches keep the
work that does not depend on those:

  - the **executable cache** (:func:`get_or_compile`) maps a labelled
    static signature (everything that changes the round loop's program:
    the kind of loop, the device, ``RunConfig.static_signature_fields``,
    the resolved lowering (parallel/step.lowering_signature), the mesh, the
    state and stack shapes, alpha, the row count) plus the chunk length to
    the loop's captured CUDA graphs (train/graphs.py): the Nth run of a
    signature copies its carry and tables into the graphs' static buffers
    and replays, with no warm-up and no capture. On the CPU the entry is
    the eager loop's marker: nothing is captured there, and the counts
    follow the JAX package's run for run;
  - the **data cache** (:func:`get_or_build_data`) maps (dataset identity,
    layout stacking signature, storage, device) to the device-resident
    stack, so repeated runs reuse the upload.

A deliberate deviation: a CUDA graph bakes in the address of every tensor
it reads, so an entry holds references to the data stack it was captured on,
and the trainer's key carries that stack's identity (:func:`stack_token`).
An executable hit therefore needs a data hit, where the JAX package's
executable takes X as an argument and is shared by any stack of its shape.
Dropping a stack from the data cache (:func:`drop_data_cache`, or its LRU
bound) drops the executable entries that hold it, or the memory would not
come back.

Over a worker mesh (parallel/mesh.py) each rank caches its own slice of the
stack: the key carries :func:`mesh_signature` and the stack transport.

A cached stack is shared by later runs: nothing in the trainer writes into
it, and the statics a sparse stack builds at first use (the scatter plans,
ops/features._Segments) are deterministic, so cached and uncached runs are
bitwise identical (tests/test_torch_sweep_cache.py, tests/test_torch_graphs.py).

Disable both with ``ERASUREHEAD_SWEEP_CACHE=0`` in the environment (read at
import), ``--sweep-cache off`` on the CLI, or :func:`set_enabled`. The
counts land in the ``sweep_cache.*`` counters (obs/metrics.py) and in
``TrainResult.cache_info``.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import threading
from collections import OrderedDict
from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from erasurehead_tpu_torch.obs.metrics import REGISTRY as _METRICS
from erasurehead_tpu_torch.train import graphs

#: LRU bounds: sweeps cycle over a handful of signatures and stacks; the
#: caps only guard against unbounded growth in a long-lived process
EXEC_CACHE_MAX = 32
DATA_CACHE_MAX = 8
#: device bytes the executable cache's programs may pin (their static
#: buffers, graphs.Program.nbytes, and the shared graph pool once,
#: graphs.pool_bytes) before the least recently used go; the pool lives as
#: long as a graph holds it, and a deep cohort's holds its per-slot
#: activations
EXEC_CACHE_BYTES = 8 << 30


class CacheStats:
    """Cumulative cache counts (process lifetime; reset by :func:`clear`): a
    live view over the ``sweep_cache.*`` counters of the metrics registry.

    Fields: ``exec_hits`` / ``exec_misses`` / ``data_hits`` /
    ``data_misses``; ``compile_seconds_saved``: warm-up and capture seconds
    not spent thanks to executable hits (each hit credits the measured cost
    of the miss that made its entry); ``bytes_reused``: device bytes not
    rebuilt and copied again thanks to data hits."""

    FIELDS = (
        "exec_hits", "exec_misses", "data_hits", "data_misses",
        "compile_seconds_saved", "bytes_reused",
    )

    @staticmethod
    def counter(field: str):
        if field not in CacheStats.FIELDS:
            raise AttributeError(field)
        return _METRICS.counter(f"sweep_cache.{field}")

    def __getattr__(self, name: str):
        return CacheStats.counter(name).value

    def snapshot(self) -> dict:
        return {f: CacheStats.counter(f).value for f in self.FIELDS}

    def reset(self) -> None:
        for f in self.FIELDS:
            CacheStats.counter(f).reset()


_stats = CacheStats()
#: key -> (entry, capture_seconds)
_exec_cache: "OrderedDict[Any, tuple[Any, float]]" = OrderedDict()
#: key -> (stack, device_bytes)
_data_cache: "OrderedDict[Any, tuple[Any, int]]" = OrderedDict()
#: guards both caches: the serve daemon's dispatch threads look up, insert
#: and drop entries concurrently. A build or a capture runs outside it (two
#: threads missing one key both build; the second insert wins)
_lock = threading.RLock()

_enabled = os.environ.get("ERASUREHEAD_SWEEP_CACHE", "1").lower() not in (
    "0", "off", "false",
)

_token_counter = itertools.count()


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


def clear() -> None:
    """Drop both caches and reset the counters (tests; memory pressure)."""
    with _lock:
        _exec_cache.clear()
        _data_cache.clear()
    _stats.reset()
    from erasurehead_tpu_torch.obs import detect

    # the caches are the detector's notion of "already captured here"
    detect.reset()


def stats() -> CacheStats:
    return _stats


def data_cache_bytes() -> int:
    """Device bytes the cache's entries pin: what :func:`drop_data_cache`
    would release."""
    with _lock:
        return sum(nbytes for _, nbytes in _data_cache.values())


def drop_data_cache() -> int:
    """Release the cache's references to device stacks; returns the bytes
    whose pin was dropped (counted in ``sweep_cache.data_dropped_bytes``).
    The memory-pressure response: the harness's out-of-memory guard
    (experiments._dispatch_cohort) and the serve daemon's admission
    controller call it. The executable entries that hold a dropped stack go
    too (their graphs read it). Stacks a live run still holds stay alive;
    only the caches' pins go."""
    with _lock:
        released = data_cache_bytes()
        tokens = {_entry_token(data) for data, _ in _data_cache.values()}
        _data_cache.clear()
        _drop_exec_holding(tokens)
    _METRICS.counter("sweep_cache.data_dropped_bytes").inc(released)
    return released


def _entry_token(data):
    """The stack token of a data-cache entry's ``(X, y, n_train)`` (None for
    an entry of another shape)."""
    y = data[1] if isinstance(data, tuple) and len(data) > 1 else None
    return stack_token(y) if isinstance(y, torch.Tensor) else None


def _drop_exec_holding(tokens: set) -> None:
    """Drop the executable entries whose graphs read a stack in ``tokens``
    (under :data:`_lock`)."""
    for key in [k for k, (entry, _) in _exec_cache.items()
                if tokens & set(getattr(entry, "holds", ()))]:
        del _exec_cache[key]


# ---------------------------------------------------------------------------
# cache keys


def dataset_token(dataset) -> Any:
    """Stable identity token for a dataset object.

    Hashing the contents would cost more than the copy the cache avoids;
    instead the first sighting brands the object with a process-unique
    token (``id()`` is unsafe: ids are reused after garbage collection). An
    object that refuses attributes gets a fresh token every call, which
    makes the cache a no-op for it rather than a hazard."""
    tok = getattr(dataset, "_sweep_cache_token", None)
    if tok is None:
        tok = next(_token_counter)
        try:
            dataset._sweep_cache_token = tok
        except (AttributeError, TypeError):
            return next(_token_counter)
    return tok


def layout_stack_signature(
    layout, *, worker_major: bool, stack_dtype: str = "float32",
    dtype: str = "float32", sparse_format: str = "padded",
) -> tuple:
    """Content signature of the device stack a (layout, stacking mode,
    storage) builds: the data cache's key component and the cohort grouping
    key (train/trainer.cohort_signature).

    The partition-major stack (deduped mode) depends only on
    ``n_partitions``: it is scheme-independent, so a whole multi-scheme
    compare() shares one upload and one cohort. The worker-major stack
    (faithful mode) gathers through ``layout.assignment``, so its content
    is the key: schemes sharing an assignment (FRC and AGC) share a stack;
    cyclic MDS has its own. The storage follows, as in the JAX package's
    upload key: the resolved stack dtype with the data dtype (an int8 and
    a float32 stack of the same content never share), and the sparse
    format."""
    if worker_major:
        assignment = np.asarray(layout.assignment)
        content = ("workers", assignment.shape, assignment.tobytes())
    else:
        content = ("parts", int(layout.n_partitions))
    return content + ((stack_dtype, dtype), sparse_format)


def mesh_signature(mesh, device) -> tuple:
    """A worker mesh as a cache key: the JAX package's (axis names, axis
    sizes, device ids), the ids being the group's world ranks, then the
    world size and the device kind (the CUDA device name, or ``cpu``)."""
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return (tuple(mesh.axis_names), tuple(mesh.shape.values()), tuple(mesh.ranks), mesh.world,
            kind)


def tree_signature(tree) -> tuple:
    """Tree structure plus each leaf's (shape, dtype): the shape part of an
    executable's key (the JAX package's tree_signature over a pytree)."""
    leaves, spec = pytree.tree_flatten(tree)
    return (
        str(spec),
        tuple(
            (tuple(getattr(leaf, "shape", ())), str(getattr(leaf, "dtype", type(leaf))))
            for leaf in leaves
        ),
    )


def stack_token(t: torch.Tensor) -> int:
    """A process-unique identity of the stack holding the tensor ``t`` (the
    trainers pass the stack's labels, which every stack kind carries as one
    tensor): the first sighting brands it, as :func:`dataset_token` brands a
    dataset. The executable key carries it, since a captured graph reads the
    stack at its address."""
    tok = getattr(t, "_eh_stack_token", None)
    if tok is None:
        tok = next(_token_counter)
        t._eh_stack_token = tok
    return tok


def device_nbytes(obj) -> int:
    """Total bytes of the tensors inside ``obj``: a tensor, a tuple, list or
    dict of them, or a dataclass holding them (the sparse and int8 stacks,
    ops/features.py). The trainer reports it as ``stack_bytes``."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(device_nbytes(part) for part in obj)
    return 0


# ---------------------------------------------------------------------------
# lookup


def get_or_build_data(key, build: Callable[[], Any]):
    """The stack for ``key``, built (stacked and copied to the device) on a
    miss. Returns ``(data, hit)``. ``key`` None, or the cache disabled,
    builds without counting."""
    if not _enabled or key is None:
        return build(), False
    with _lock:
        entry = _data_cache.get(key)
        if entry is not None:
            _data_cache.move_to_end(key)
    if entry is not None:
        data, nbytes = entry
        CacheStats.counter("data_hits").inc()
        CacheStats.counter("bytes_reused").inc(nbytes)
        return data, True
    data = build()
    CacheStats.counter("data_misses").inc()
    with _lock:
        _data_cache[key] = (data, device_nbytes(data))
        while len(_data_cache) > DATA_CACHE_MAX:
            _, (old, _) = _data_cache.popitem(last=False)
            _drop_exec_holding({_entry_token(old)})
    return data, False


def get_or_compile(key, compile_fn: Callable[[], tuple[Any, float]]):
    """The round loop's executable for ``key`` (train/graphs.py: captured
    CUDA graphs on the card, the eager loop's marker on the CPU).

    ``compile_fn`` runs on a miss and returns ``(entry, seconds)``: the
    measured warm-up and capture cost, credited to ``compile_seconds_saved``
    on every later hit. Returns ``(entry, hit)``. With the cache disabled
    every call compiles and nothing is counted."""
    if not _enabled:
        return compile_fn()[0], False
    with _lock:
        found = _exec_cache.get(key)
        if found is not None:
            _exec_cache.move_to_end(key)
    if found is not None:
        entry, secs = found
        CacheStats.counter("exec_hits").inc()
        CacheStats.counter("compile_seconds_saved").inc(secs)
        return entry, True
    try:
        entry, secs = compile_fn()
    except torch.cuda.OutOfMemoryError:
        # the cached programs' pools are the memory to give back: drop them
        # and capture once more (a second failure propagates)
        if not drop_executables():
            raise
        entry, secs = compile_fn()
    CacheStats.counter("exec_misses").inc()
    with _lock:
        _exec_cache[key] = (entry, secs)
        while len(_exec_cache) > 1 and (len(_exec_cache) > EXEC_CACHE_MAX
                                        or exec_cache_bytes() > EXEC_CACHE_BYTES):
            _exec_cache.popitem(last=False)
    return entry, False


def exec_cache_bytes() -> int:
    """Device bytes the executable cache's programs pin: their static
    buffers, and the shared graph pools they hold, each counted once (what
    :func:`drop_executables` would release)."""
    with _lock:
        static = sum(getattr(entry, "nbytes", 0) for entry, _ in _exec_cache.values())
    return static + graphs.pool_bytes()


def drop_executables() -> int:
    """Drop every executable entry and return the allocator's freed pools
    to the device; returns the entries dropped."""
    with _lock:
        n = len(_exec_cache)
        _exec_cache.clear()
    if n and torch.cuda.is_available():
        import gc

        gc.collect()
        torch.cuda.empty_cache()
    return n
