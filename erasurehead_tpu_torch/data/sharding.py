"""Partitioning a dataset and materializing the (possibly redundant) worker stack.

The reference shards by writing one file per partition and having each MPI
rank load its assigned (rotated/replicated) partitions (src/approximate_coding.py:39-69).
Here, as in erasurehead_tpu/data/sharding.py, the same assignment becomes
array indexing on the host: a partition-major stack [P, rows, F], and for the
faithful compute mode a worker-major stack [W, S, rows, F] gathered through
``CodingLayout.assignment`` (the redundancy is real memory). The trainer moves
the stack it needs to the device once.

A CSR dataset stacks as a container of host numpy leaves
(ops/features.PaddedRows or FieldOnehot, per ``sparse_format``); every leaf
leads with the partition axis, so the worker-major gather is one indexed
take per leaf.

Row-count convention (the reference's src/coded.py:23): rows_per_partition =
n_samples // P, trailing remainder rows dropped from training.

A streamed run (``stack_residency="streamed"``) stages windows of the stack
from a shard store (data/store.py) instead: :func:`plan_stream_windows` says
which partitions each window stages and how its slot-groups gather them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sps
from torch.utils import _pytree as pytree

from erasurehead_tpu_torch.data.synthetic import Dataset
from erasurehead_tpu_torch.ops.codes import CodingLayout
from erasurehead_tpu_torch.ops.features import (
    FieldOnehot,
    PaddedRows,
    infer_field_sizes,
    take_lead,
)


def _stack_leaves(containers):
    """One container whose leaves stack the given containers' leaves on a
    new leading (partition) axis."""
    spec = pytree.tree_structure(containers[0])
    leaves = [pytree.tree_leaves(c) for c in containers]
    return pytree.tree_unflatten([np.stack(ls) for ls in zip(*leaves)], spec)


def partition_stack(dataset: Dataset, n_partitions: int, sparse_format: str = "padded"):
    """[P, rows, F] + [P, rows] partition-major arrays (host).

    ``sparse_format`` picks the sparse stack: "padded" (PaddedRows),
    "fields" (FieldOnehot; raises when the data is not
    exactly-one-hot-per-field) or "auto" (fields where the structure
    allows, else padded)."""
    n = dataset.n_samples
    rows = n // n_partitions
    if rows == 0:
        raise ValueError(f"{n} samples cannot fill {n_partitions} partitions")
    X, y = dataset.X_train, dataset.y_train
    if sps.issparse(X):
        X = X[: rows * n_partitions]
        # field structure is a whole-matrix property: infer once so every
        # partition shares the same block offsets (tables must agree)
        sizes = None
        if sparse_format in ("fields", "auto"):
            sizes = infer_field_sizes(X)
            if sizes is None and sparse_format == "fields":
                raise ValueError(
                    "sparse_format='fields' requires exactly-one-hot-per-"
                    "field data (uniform nnz/row, unit values, disjoint "
                    "ordered field blocks); use 'auto' or 'padded'"
                )
        parts = [X[i * rows : (i + 1) * rows] for i in range(n_partitions)]
        if sizes is not None:
            Xp = _stack_leaves([FieldOnehot.from_scipy(p, field_sizes=sizes) for p in parts])
        else:
            nnz = max(int(np.diff(p.indptr).max()) for p in parts)
            # from_scipy builds host numpy leaves (the JAX package's
            # _padded_host): nothing touches the device before the upload
            Xp = _stack_leaves([PaddedRows.from_scipy(p, nnz) for p in parts])
    else:
        if sparse_format == "fields":
            raise ValueError(
                "sparse_format='fields' requires sparse (CSR) features; "
                "this dataset is dense — use 'auto' or 'padded'"
            )
        Xp = X[: rows * n_partitions].reshape(n_partitions, rows, -1)
    yp = y[: rows * n_partitions].reshape(n_partitions, rows)
    return Xp, yp


def worker_stack(layout: CodingLayout, Xp, yp):
    """[W, S, rows, F] + [W, S, rows]: the redundant worker-major stacks,
    gathered through the assignment (leaf by leaf for a container: a
    QuantizedStack's scale table rides the same gather as its payload)."""
    return take_lead(Xp, layout.assignment), yp[layout.assignment]


#: bytes an element of each stack dtype takes on the device (numpy has no
#: bfloat16, so the stack dtypes are named)
STACK_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}


def estimate_worker_stack_bytes(dataset: Dataset, layout: CodingLayout, dtype) -> int:
    """Host-side estimate of the MATERIALIZED faithful stack's device bytes
    (the JAX package's footprint estimate; the serve daemon's admission
    charge builds on it). ``dtype`` names the stack dtype ("float32",
    "bfloat16", "int8"; a numpy dtype is taken too). Dense:
    W * S * rows * F * itemsize; sparse stacks are scaled from the CSR
    payload (indices + values per stored entry); an int8 stack adds one
    float32 scale row per slot block. An estimate, not an accounting."""
    X = dataset.X_train
    rows = dataset.n_samples // layout.n_partitions
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    itemsize = STACK_ITEMSIZE[name]
    if sps.issparse(X):
        nnz_per_row = X.nnz / max(1, X.shape[0])
        per_row = nnz_per_row * (np.dtype(np.int32).itemsize + itemsize)
    else:
        per_row = X.shape[1] * itemsize
    est = int(layout.n_workers * layout.n_slots * rows * per_row)
    if name == "int8":
        # a quantized stack is payload PLUS one float32 scale row per slot
        # block ([W, S, F] after the worker gather)
        est += layout.n_workers * layout.n_slots * X.shape[1] * 4
    return est


# ---------------------------------------------------------------------------
# stream windows (stack_residency="streamed"; train/trainer._train_streamed)

#: the ROADMAP step that brings the ring transport of faithful windows
RING_STEP = "ROADMAP queue A, A9 (the multi-device ring transport)"


@dataclasses.dataclass(frozen=True)
class StreamWindowPlan:
    """The windows a streamed run stages, the JAX package's plan.

    Deduped plans are windows of the partition axis: window k stages
    partitions ``[k*window, (k+1)*window)``. Faithful (``"materialized"``)
    plans are windows of the coded assignment: contiguous slot-groups of
    ``group_workers`` workers whose assigned partitions all fall inside the
    staged span ``[k*window, k*window + window + halo) mod P``. The
    ``halo`` is the assignment's forward reach past the window edge (``s``
    for the cyclic ``{w..w+s} mod P`` supports).

    ``ranges[k]`` is the tuple of contiguous partition ranges staged for
    window k (two when the halo wraps the partition axis), ordered so that
    staged position ``i`` holds partition ``(k*window + i) mod P``.
    ``local_assignment[wl, s]`` maps slot-group worker ``wl``'s slot ``s``
    to its staged position; it is the same for every window (the planner
    refuses assignments that are not window-uniform), so one worker-major
    gather serves every window."""

    mode: str  # "deduped" | "materialized"
    n_partitions: int
    window: int  # partition-window size (divides P)
    n_windows: int
    halo: int  # staged partitions past the window edge (0 for deduped)
    group_workers: int  # workers per slot-group (0 for deduped)
    ranges: tuple  # per window k: ((lo, hi), ...) contiguous staged ranges
    local_assignment: Optional[np.ndarray]  # [gw, S] staged positions

    @property
    def staged_partitions(self) -> int:
        """Partitions staged per window (window + halo)."""
        return self.window + self.halo

    def event_fields(self) -> dict:
        """The window-plan fields every staged ``prefetch`` record carries
        (obs/events.SCHEMA)."""
        return {
            "plan_mode": self.mode,
            "halo": int(self.halo),
            "group_workers": int(self.group_workers),
        }

    def sub_layout(self):
        """The one-window layout a ring plan is built over: the ring
        transport is not ported, so this raises."""
        raise NotImplementedError(
            "sub_layout() plans the ring transport of a stream window, "
            f"which waits for {RING_STEP}"
        )


def plan_stream_windows(layout: CodingLayout, window: int, *, mode: str = "deduped") -> StreamWindowPlan:
    """The staged windows a streamed run of ``layout`` consumes.

    ``window`` is the partition-window size (a divisor of P, from
    trainer._resolve_stream_window). Deduped plans are plain partition
    windows. Faithful plans split the worker axis into ``P // window``
    contiguous slot-groups and stage each group's whole assigned span,
    window plus halo, refusing when the worker axis does not split evenly
    or the assignment is not window-uniform. ``mode="ring"`` raises: its
    transport waits for A9."""
    P = int(layout.n_partitions)
    window = int(window)
    if window < 1 or P % window:
        raise ValueError(
            f"stream window must be a divisor of n_partitions={P}, got {window}"
        )
    n_windows = P // window
    if mode == "deduped":
        return StreamWindowPlan(
            mode=mode, n_partitions=P, window=window, n_windows=n_windows,
            halo=0, group_workers=0,
            ranges=tuple(((k * window, (k + 1) * window),) for k in range(n_windows)),
            local_assignment=None,
        )
    if mode == "ring":
        raise NotImplementedError(
            f"stream window mode 'ring' needs the ring transport, which "
            f"waits for {RING_STEP}; use mode 'materialized'"
        )
    if mode != "materialized":
        raise ValueError(
            f"stream window mode must be 'deduped', 'materialized' or "
            f"'ring', got {mode!r}"
        )
    W = int(layout.n_workers)
    if W % n_windows:
        raise ValueError(
            f"{W} workers cannot split into {n_windows} equal slot-groups "
            f"(window {window} of {P} partitions); pick a stream window "
            f"whose count divides the worker axis"
        )
    gw = W // n_windows
    assignment = np.asarray(layout.assignment)
    local = None
    halo = 0
    for k in range(n_windows):
        loc = (assignment[k * gw : (k + 1) * gw] - k * window) % P
        halo = max(halo, int(loc.max()) + 1 - window)
        if local is None:
            local = loc.astype(np.int64)
        elif not np.array_equal(local, loc):
            raise ValueError(
                f"assignment is not window-uniform: slot-group {k} "
                f"touches a different local partition pattern than group "
                "0, so no single chunk executable (or ring hop table) can "
                "serve every window — run this scheme resident, or with "
                "a stream window covering every partition"
            )
    halo = max(0, min(halo, P - window))
    staged = window + halo
    ranges = []
    for k in range(n_windows):
        lo = k * window
        hi = lo + staged
        ranges.append(((lo, hi),) if hi <= P else ((lo, P), (0, hi - P)))
    return StreamWindowPlan(
        mode=mode, n_partitions=P, window=window, n_windows=n_windows,
        halo=halo, group_workers=gw, ranges=tuple(ranges), local_assignment=local,
    )
