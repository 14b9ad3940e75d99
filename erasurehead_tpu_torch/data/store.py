"""On-disk shard store: the out-of-core home of the partition stack
(``stack_residency="streamed"``, utils/config.RunConfig).

The port of erasurehead_tpu/data/store.py, with its layout byte for byte,
so a store written by either package opens in the other. The reference
sharded by writing one file per partition and having every MPI rank load
its assignment at startup (src/approximate_coding.py:39-69): disk was the
partition store, but residency was all or nothing. Here the store keeps that
layout (partition-major ``.npy`` shards, each a contiguous group of
partitions) and makes residency a window: the streamed trainer maps the
shards read-only (``np.load(..., mmap_mode="r")``) and copies out only the
window the next chunk of rounds needs, which data/prefetch.py stages behind
the current chunk's compute.

A directory holds ``shard_NNNNN.npy`` (the partitions' rows),
``labels_NNNNN.npy``, for an int8 store ``scale_NNNNN.npy``, the eval split
``X_test.npy``/``y_test.npy`` and ``store_meta.json`` (:data:`STORE_VERSION`).

Two store dtypes:

- ``float32``: shards hold the source rows as they are. A full-window read
  reassembles the training split bitwise, so :meth:`ShardStore.dataset`
  hands the resident trainer an identical dataset (a streamed run whose
  window covers every partition is bitwise the resident run).
- ``int8``: partitions are quantized at write time by the quantizer the
  resident ``stack_dtype="int8"`` path uses (ops/features.QuantizedStack),
  per partition, so the stored ``(q, scale)`` pair is what a resident run
  computes from the same rows; streamed int8 runs reuse the tables as they
  are (quantizing a dequantized stack again is not bitwise stable).

Identity: the store carries the source dataset's sweep-journal digest
(train/journal.dataset_digest), and :meth:`ShardStore.dataset` brands the
datasets it rebuilds with it and with a content-addressed cache token, so
the device data cache and the sweep journal key streamed runs as they key
runs over the source dataset.

Every transaction is an ``io`` record (obs/events.py): a store write
(kind ``store_write``, the bytes written) and every window read (kind
``shard_read``, the bytes of the arrays it returns). A read on the
prefetcher's staging thread is held there (obs/events.deferred) and emitted
by the trainer after its round loop.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from erasurehead_tpu_torch.data.synthetic import Dataset
from erasurehead_tpu_torch.obs import events as events_lib
from erasurehead_tpu_torch.ops.features import QuantizedStack

#: store layout version (a directory of another version is refused)
STORE_VERSION = 1

#: metadata file inside a store directory
META_NAME = "store_meta.json"

#: shard payload target: partitions are grouped so that one shard file is
#: about this many bytes (one mmap and one sequential read per window edge)
SHARD_TARGET_BYTES = 64 << 20

#: on-disk dtypes (the run's ``stack_dtype`` still sets the device
#: representation: a float32 store feeds any of them, an int8 store needs
#: ``stack_dtype="int8"``)
STORE_DTYPES = ("float32", "int8")


def _emit_io(kind: str, n_bytes: int, **extra) -> None:
    events_lib.emit("io", kind=kind, bytes=int(n_bytes), **extra)


def partitions_per_shard(rows: int, n_features: int, itemsize: int, n_partitions: int) -> int:
    """Partitions grouped into one shard file (about SHARD_TARGET_BYTES)."""
    per_part = max(1, rows * n_features * itemsize)
    return int(min(n_partitions, max(1, SHARD_TARGET_BYTES // per_part)))


def write_store(
    dataset: Dataset,
    directory: str,
    n_partitions: int,
    *,
    stack_dtype: str = "float32",
    group: Optional[int] = None,
) -> "ShardStore":
    """Shard ``dataset``'s training split into ``directory``.

    Rows follow the trainer's partition convention (sharding.
    partition_stack): rows_per_partition = n_samples // P, the trailing
    remainder dropped. Dense features only. ``stack_dtype="int8"``
    quantizes each partition at write time. The eval split is stored as it
    is."""
    if stack_dtype not in STORE_DTYPES:
        raise ValueError(
            f"store stack_dtype must be one of {STORE_DTYPES}, "
            f"got {stack_dtype!r}"
        )
    X = dataset.X_train
    if not isinstance(X, np.ndarray):
        raise ValueError(
            "shard store holds dense stacks only; this dataset's "
            f"features are {type(X).__name__} — stream sparse data "
            "through its CSR artifacts (data/io.py) instead"
        )
    n = dataset.n_samples
    rows = n // n_partitions
    if rows == 0:
        raise ValueError(f"{n} samples cannot fill {n_partitions} partitions")
    # the source's digest, before truncation or quantization: the store
    # inherits the identity the sweep journal gives the source (imported
    # here: train/ imports data/)
    from erasurehead_tpu_torch.train import journal as journal_lib

    digest = journal_lib.dataset_digest(dataset)
    F = int(X.shape[1])
    Xp = np.ascontiguousarray(X[: rows * n_partitions].reshape(n_partitions, rows, F))
    yp = np.ascontiguousarray(
        np.asarray(dataset.y_train)[: rows * n_partitions].reshape(n_partitions, rows)
    )
    G = int(group) if group else partitions_per_shard(rows, F, Xp.dtype.itemsize, n_partitions)
    if G < 1:
        raise ValueError(f"shard group must be >= 1, got {G}")
    os.makedirs(directory, exist_ok=True)
    shard_parts = []
    total = 0
    for i, lo in enumerate(range(0, n_partitions, G)):
        hi = min(lo + G, n_partitions)
        block = Xp[lo:hi]
        if stack_dtype == "int8":
            qs = QuantizedStack.quantize(block)
            np.save(os.path.join(directory, f"shard_{i:05d}.npy"), qs.q)
            np.save(os.path.join(directory, f"scale_{i:05d}.npy"), qs.scale)
            total += qs.q.nbytes + qs.scale.nbytes
        else:
            np.save(os.path.join(directory, f"shard_{i:05d}.npy"), block)
            total += block.nbytes
        np.save(os.path.join(directory, f"labels_{i:05d}.npy"), yp[lo:hi])
        total += yp[lo:hi].nbytes
        shard_parts.append(hi - lo)
    np.save(os.path.join(directory, "X_test.npy"), np.asarray(dataset.X_test))
    np.save(os.path.join(directory, "y_test.npy"), np.asarray(dataset.y_test))
    meta = {
        "version": STORE_VERSION,
        "name": dataset.name,
        "n_partitions": int(n_partitions),
        "rows_per_partition": int(rows),
        "n_features": F,
        "source_dtype": str(Xp.dtype),
        "label_dtype": str(yp.dtype),
        "stack_dtype": stack_dtype,
        "shard_parts": shard_parts,
        "digest": digest,
    }
    with open(os.path.join(directory, META_NAME), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    _emit_io("store_write", total, path=directory, shards=len(shard_parts))
    return ShardStore(directory)


class ShardStore:
    """Read side of a shard-store directory: memory-mapped partition
    shards and the metadata that keys streamed runs.

    Shards open lazily with ``np.load(..., mmap_mode="r")``: opening a store
    reads only its metadata, and a window read pages in only the rows it
    copies out. Reads fill fresh or caller-provided host arrays (the
    prefetcher passes views of pinned buffers), never the mmaps themselves,
    so no copy to the device faults pages in."""

    def __init__(self, directory: str):
        self.directory = directory
        path = os.path.join(directory, META_NAME)
        with open(path) as f:
            meta = json.load(f)
        if meta.get("version") != STORE_VERSION:
            raise ValueError(
                f"{path}: store version {meta.get('version')!r} != "
                f"{STORE_VERSION} (rewrite the store with this build's "
                f"data/prepare.py)"
            )
        self.meta = meta
        self.n_partitions: int = int(meta["n_partitions"])
        self.rows_per_partition: int = int(meta["rows_per_partition"])
        self.n_features: int = int(meta["n_features"])
        self.stack_dtype: str = meta["stack_dtype"]
        self.quantized: bool = self.stack_dtype == "int8"
        self.digest: str = meta["digest"]
        # first partition of each shard: shard s covers [starts[s], starts[s+1])
        self._starts = np.concatenate([[0], np.cumsum(meta["shard_parts"])]).astype(np.int64)
        self._mmaps: dict = {}

    @property
    def cache_token(self) -> tuple:
        """Device data cache brand (train/cache.dataset_token):
        content-addressed, so two opens of one store, or a killed and a
        resumed process, key the same cached stacks."""
        return ("shard-store", self.digest, self.stack_dtype)

    def partition_bytes(self) -> int:
        """Host and transfer bytes of one partition's window slice: payload,
        labels and an int8 store's scale row (the unit the stream-window
        budget is charged in)."""
        rows, F = self.rows_per_partition, self.n_features
        label = np.dtype(self.meta["label_dtype"]).itemsize
        if self.quantized:
            return rows * F + F * 4 + rows * label
        src = np.dtype(self.meta["source_dtype"]).itemsize
        return rows * F * src + rows * label

    def window_dtypes(self) -> dict:
        """The host dtype of each array a read fills, by its ``out`` key."""
        dtypes = {
            "X": np.dtype(np.int8 if self.quantized else self.meta["source_dtype"]),
            "y": np.dtype(self.meta["label_dtype"]),
        }
        if self.quantized:
            dtypes["scale"] = np.dtype(np.float32)
        return dtypes

    def window_shapes(self, n_parts: int) -> dict:
        """The shape of each array a read of ``n_parts`` partitions fills,
        by its ``out`` key."""
        rows, F = self.rows_per_partition, self.n_features
        shapes = {"X": (n_parts, rows, F), "y": (n_parts, rows)}
        if self.quantized:
            shapes["scale"] = (n_parts, F)
        return shapes

    def _mmap(self, prefix: str, shard: int):
        key = (prefix, shard)
        arr = self._mmaps.get(key)
        if arr is None:
            arr = np.load(
                os.path.join(self.directory, f"{prefix}_{shard:05d}.npy"), mmap_mode="r"
            )
            self._mmaps[key] = arr
        return arr

    def read_window(self, lo: int, hi: int, out: Optional[dict] = None):
        """Partitions [lo, hi) as host arrays: ``(X, y)``, ``X`` a
        ``[hi-lo, rows, F]`` ndarray (float32 store) or a QuantizedStack of
        numpy leaves (int8 store), ``y`` ``[hi-lo, rows]``. ``out``, a dict
        of preallocated buffers under ``"X"``/``"y"`` (and ``"scale"``), is
        filled in place where shape and dtype match."""
        return self.read_ranges(((lo, hi),), out=out)

    def read_ranges(self, ranges, out: Optional[dict] = None):
        """A sequence of contiguous partition ranges as one stacked host
        window, concatenated in order (a slot-group's span that wraps the
        partition axis is two ranges: data/sharding.plan_stream_windows).
        Same buffer contract as :meth:`read_window`. Emits the read's
        ``io`` record."""
        ranges = [(int(lo), int(hi)) for lo, hi in ranges]
        if not ranges:
            raise ValueError("read_ranges needs at least one range")
        for lo, hi in ranges:
            if not 0 <= lo < hi <= self.n_partitions:
                raise ValueError(
                    f"window [{lo}, {hi}) outside [0, {self.n_partitions}) partitions"
                )
        w = sum(hi - lo for lo, hi in ranges)
        out = out if out is not None else {}
        shapes, dtypes = self.window_shapes(w), self.window_dtypes()
        for key, shape in shapes.items():
            b = out.get(key)
            if b is None or b.shape != shape or b.dtype != dtypes[key]:
                out[key] = np.empty(shape, dtypes[key])
        X, y, scale = out["X"], out["y"], out.get("scale") if self.quantized else None
        off = 0
        for lo, hi in ranges:
            p = lo
            while p < hi:
                s = int(np.searchsorted(self._starts, p, side="right")) - 1
                blk_lo, blk_hi = int(self._starts[s]), int(self._starts[s + 1])
                a, b = p - blk_lo, min(hi, blk_hi) - blk_lo
                dst = slice(off + p - lo, off + p - lo + (b - a))
                X[dst] = self._mmap("shard", s)[a:b]
                y[dst] = self._mmap("labels", s)[a:b]
                if scale is not None:
                    scale[dst] = self._mmap("scale", s)[a:b]
                p += b - a
            off += hi - lo
        _emit_io(
            "shard_read",
            X.nbytes + y.nbytes + (scale.nbytes if scale is not None else 0),
            partitions=[ranges[0][0], ranges[0][1]],
            ranges=[[lo, hi] for lo, hi in ranges],
        )
        if self.quantized:
            return QuantizedStack(X, scale), y
        return X, y

    def eval_split(self):
        """The eval split, read whole (it is small and stays on the host)."""
        X_test = np.load(os.path.join(self.directory, "X_test.npy"))
        y_test = np.load(os.path.join(self.directory, "y_test.npy"))
        return X_test, y_test

    def dataset(self) -> Dataset:
        """A Dataset equal to the resident one: a streamed run whose window
        covers every partition trains on this through the resident path
        (bitwise for a float32 store).

        An int8 store dequantizes for the row-major view and also brands
        the object with the stored stack (``_store_prequantized``), which
        the trainer's int8 stacking reuses as it is. Branded with the
        source's digest and the content-addressed cache token."""
        P, rows = self.n_partitions, self.rows_per_partition
        X, y = self.read_window(0, P)
        pre = None
        if self.quantized:
            pre = X
            X = pre.q.astype(pre.scale.dtype) * pre.scale[..., None, :]
        X_test, y_test = self.eval_split()
        ds = Dataset(
            X_train=np.ascontiguousarray(X.reshape(P * rows, -1)),
            y_train=np.ascontiguousarray(y.reshape(P * rows)),
            X_test=X_test,
            y_test=y_test,
            name=self.meta.get("name", "shard-store"),
        )
        ds._sweep_journal_digest = self.digest
        ds._sweep_cache_token = self.cache_token
        ds._shard_store = self
        if pre is not None:
            ds._store_prequantized = pre
        return ds

    def close(self) -> None:
        self._mmaps.clear()


def open_store(directory: str) -> ShardStore:
    """Open an existing store directory (raises when there is none)."""
    if not os.path.exists(os.path.join(directory, META_NAME)):
        raise FileNotFoundError(
            f"{directory!r} is not a shard store (no {META_NAME}; write "
            f"one with `python -m erasurehead_tpu_torch.data.prepare ... "
            f"--store DIR`)"
        )
    return ShardStore(directory)
