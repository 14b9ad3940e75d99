"""The sweep engine's device data cache, and the cohort grouping key.

The port of erasurehead_tpu/train/cache.py's data cache. The experiment
harness (train/experiments.compare, straggler_sweep, baseline_suite) runs
many configs over the same dataset; only the per-round weight tables differ.
Without the cache every ``train()`` call rebuilds its stack on the host
(the partition stack, the worker-major gather) and copies it to the device
again. The cache maps (dataset identity, layout stacking signature, storage,
device) to the device-resident stack, so repeated runs reuse the upload.

The JAX module's executable cache (``get_or_compile``) and its persistent
compilation cache have no counterpart: the port's round loop is eager
PyTorch with nothing compiled per run. A CUDA-graph cache (ROADMAP A5r, the
compiled round loop) will take their place, so the JAX ``exec_*``
statistics are not reported.

Over a worker mesh (parallel/mesh.py) each rank caches its own slice of the
stack: the key carries :func:`mesh_signature` and the stack transport.

A cached stack is shared by later runs: nothing in the trainer writes into
it, and the statics a sparse stack builds at first use (the scatter plans,
ops/features._Segments) are deterministic, so cached and uncached runs are
bitwise identical (tests/test_torch_sweep_cache.py).

Disable with ``ERASUREHEAD_SWEEP_CACHE=0`` in the environment (read at
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

from erasurehead_tpu_torch.obs.metrics import REGISTRY as _METRICS

#: LRU bound: sweeps cycle over a handful of stacks; the cap only guards
#: against unbounded growth in a long-lived process
DATA_CACHE_MAX = 8


class CacheStats:
    """Cumulative cache counts (process lifetime; reset by :func:`clear`): a
    live view over the ``sweep_cache.*`` counters of the metrics registry.

    Fields: ``data_hits`` / ``data_misses``; ``bytes_reused``: device bytes
    not rebuilt and copied again thanks to data hits."""

    FIELDS = ("data_hits", "data_misses", "bytes_reused")

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
#: key -> (stack, device_bytes)
_data_cache: "OrderedDict[Any, tuple[Any, int]]" = OrderedDict()
#: guards :data:`_data_cache`: the serve daemon's dispatch threads look up,
#: insert and drop entries concurrently. A build runs outside it (two
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
    """Drop the cache and reset the counters (tests; memory pressure)."""
    with _lock:
        _data_cache.clear()
    _stats.reset()


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
    (experiments._dispatch_cohort) calls it before it bisects a cohort.
    Stacks a live run still holds stay alive; only the cache's pins go."""
    with _lock:
        released = data_cache_bytes()
        _data_cache.clear()
    _METRICS.counter("sweep_cache.data_dropped_bytes").inc(released)
    return released


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
            _data_cache.popitem(last=False)
    return data, False
