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

``stack_mode="ring"`` drops the materialized redundancy: only the
partition-major stack is resident, each rank holding its ``[P/D, rows, F]``
shard, and every round each rank rebuilds its workers' slot buffer from its
ring neighbours' shards (:class:`RingPlan`; the transport is
parallel/step.make_ring_faithful_grad_fn). Same science, 1/(s+1) of the
device data.

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


def worker_stack(layout: CodingLayout, Xp, yp, workers: slice = slice(None)):
    """[W, S, rows, F] + [W, S, rows]: the redundant worker-major stacks,
    gathered through the assignment (leaf by leaf for a container: a
    QuantizedStack's scale table rides the same gather as its payload).
    ``workers`` gathers only those workers' rows (a rank's slice)."""
    assignment = np.asarray(layout.assignment)[workers]
    return take_lead(Xp, assignment), yp[assignment]


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
# the ring-streamed faithful stack (stack_mode="ring")

#: stack_mode="auto" switches faithful runs to the ring transport once the
#: materialized worker stack would exceed this many device bytes (summed over
#: the ranks); below it the redundant stack is cheap and the materialized
#: mode keeps its transport-free round
RING_AUTO_MIN_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class RingPlan:
    """The static transport plan that turns the partition-major stack into
    each rank's worker-major slot buffer over ring neighbour hops (the JAX
    package's plan, byte for byte).

    ``sel[d, h, wl, s]`` is the index INTO THE VISITING BLOCK (the partition
    shard first held by rank ``(d + h) % D``) that fills local worker
    ``wl``'s slot ``s`` on rank ``d`` at fill step ``h``, or -1 when that
    slot is not filled at this hop. Hop 0 is the rank's own block (no
    communication); ring-local assignments (cyclic supports, block-local
    FRC groups) need ``1 + ceil(s / Pl)`` fill steps, and any other
    assignment at most a full rotation of ``D``: the same program with more
    hops, never another code path."""

    n_devices: int
    n_hops: int  # fill steps; n_hops - 1 ring shifts a round
    sel: np.ndarray  # [D, n_hops, Wl, S] int32, -1 = not filled this hop

    @property
    def local_workers(self) -> int:
        return self.sel.shape[2]

    @property
    def n_slots(self) -> int:
        return self.sel.shape[3]


def plan_ring_transport(layout: CodingLayout, n_devices: int) -> RingPlan:
    """The :class:`RingPlan` of ``layout`` on a ring of ``n_devices`` ranks.
    Both the worker axis (the compute split) and the partition axis (the
    data split) must fold evenly onto the ring."""
    W, S, P = layout.n_workers, layout.n_slots, layout.n_partitions
    D = int(n_devices)
    if W % D or P % D:
        raise ValueError(
            f"ring stack mode needs n_workers={W} and n_partitions={P} "
            f"divisible by the {D} worker-axis devices"
        )
    Wl, Pl = W // D, P // D
    assignment = np.asarray(layout.assignment)
    sel = np.full((D, _ring_hops(layout, D), Wl, S), -1, dtype=np.int32)
    for w in range(W):
        d = w // Wl
        for s in range(S):
            p = int(assignment[w, s])
            hop = (p // Pl - d) % D
            sel[d, hop, w % Wl, s] = p % Pl
    return RingPlan(n_devices=D, n_hops=sel.shape[1], sel=sel)


def _ring_hops(layout: CodingLayout, n_devices: int) -> int:
    """Fill steps needed: 1 + the farthest forward ring distance from any
    worker's rank to a rank holding one of its assigned partitions."""
    W, P = layout.n_workers, layout.n_partitions
    D = n_devices
    Wl, Pl = W // D, P // D
    assignment = np.asarray(layout.assignment)
    dev_of_w = np.arange(W)[:, None] // Wl
    hop = (assignment // Pl - dev_of_w) % D
    return int(hop.max()) + 1


def resolve_ring_stack(stack_mode: str, layout: CodingLayout, dataset: Dataset,
                       n_devices: int, dtype, *, device=None,
                       supported: bool = True) -> bool:
    """Should this faithful run stream its stack over the ring?

    "ring" forces (plan_ring_transport checks the divisibility at use);
    "materialized" keeps the reference's redundancy as device memory;
    "auto" picks ring only where the stack is redundant (storage overhead
    above 1), folds onto the worker axis, and a cached ``stack_mode`` race
    verdict at this pre-stack shape says "ring" or, without one, the
    footprint estimate crosses :data:`RING_AUTO_MIN_BYTES`. The verdict
    replaces only the threshold: the structural gates stand.
    ``supported=False`` (a path with no ring body) pins auto to
    materialized. ``dtype`` names the stack dtype ("float32", "bfloat16",
    "int8"); ``device`` is the run's (the verdict's device dimension)."""
    if stack_mode == "ring":
        return True
    if stack_mode != "auto" or not supported:
        return False
    if layout.storage_overhead <= 1.0:
        return False  # nothing redundant to stream
    W, P, D = layout.n_workers, layout.n_partitions, int(n_devices)
    if W % D or P % D:
        return False
    from erasurehead_tpu_torch import tune as tune_lib

    rows = dataset.n_samples // layout.n_partitions
    sig = tune_lib.stack_mode_signature(layout, rows, dataset.X_train.shape[1], dtype)
    by_footprint = estimate_worker_stack_bytes(dataset, layout, dtype) >= RING_AUTO_MIN_BYTES
    choice = tune_lib.lookup(
        "stack_mode", sig, device_kind=tune_lib.default_device_kind(device),
        fallback="ring" if by_footprint else "materialized",
    )
    if choice is not None:
        return choice == "ring"
    return by_footprint


# ---------------------------------------------------------------------------
# stream windows (stack_residency="streamed"; train/trainer._train_streamed)

@dataclasses.dataclass(frozen=True)
class _WindowedLayout:
    """The layout of one staged window of a :class:`StreamWindowPlan`: the
    four attributes :func:`plan_ring_transport` reads, the assignment
    localized to staged positions. Every window shares it (the planner
    enforces window-uniformity), so one ring hop table serves every window
    of the stream."""

    n_workers: int
    n_slots: int
    n_partitions: int
    assignment: np.ndarray  # [gw, S] staged positions


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
    gather, and one ring hop table, serve every window.

    A ring (``"ring"``) plan stages the same span partition-major and
    rebuilds the slot-group's worker slots every round over the ring
    transport of :meth:`sub_layout`; the staged order is the ring-hop order
    (position ``i``'s block arrives at fill step ``i // (staged / D)``)."""

    mode: str  # "deduped" | "materialized" | "ring"
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

    def shard(self, index: Optional[int], size: int) -> "WindowShard":
        """What the rank at position ``index`` of a worker axis of ``size``
        stages of every window (``index`` None: a rank outside the worker
        group, which stages nothing). Deduped: its ``window / size``
        partitions. Ring: its ``staged / size`` span of the staged
        positions, the block the ring plan gives it. Materialized: the
        staged positions its ``group_workers / size`` workers' slots read,
        and their slots' indices into what it stages. The caller checks the
        divisibility (mesh.check_divisible)."""
        S = 0 if self.local_assignment is None else int(self.local_assignment.shape[1])
        local = None
        if index is None:
            pos = np.zeros(0, dtype=np.int64)
            if self.mode == "materialized":
                local = np.zeros((0, S), dtype=np.int64)
        elif self.mode == "deduped":
            per = self.window // size
            pos = np.arange(index * per, (index + 1) * per)
        elif self.mode == "ring":
            per = self.staged_partitions // size
            pos = np.arange(index * per, (index + 1) * per)
        else:
            per = self.group_workers // size
            rows = self.local_assignment[index * per:(index + 1) * per]
            pos = np.unique(rows)
            local = np.searchsorted(pos, rows).astype(np.int64)
        P = self.n_partitions
        ranges = []
        for k in range(self.n_windows):
            parts = (k * self.window + pos) % P
            cuts = np.flatnonzero(np.diff(parts) != 1) + 1
            ranges.append(tuple((int(run[0]), int(run[-1]) + 1)
                                for run in np.split(parts, cuts) if run.size))
        return WindowShard(ranges=tuple(ranges), n_partitions=int(pos.size),
                           local_assignment=local)

    def sub_layout(self) -> _WindowedLayout:
        """The one-window layout a sub-:class:`RingPlan` is built over
        (``plan_ring_transport(plan.sub_layout(), D)``). A full-cover plan
        localizes to the identity, so its hop table is byte-identical to
        the resident ``plan_ring_transport(layout, D)``: a full-cover
        streamed ring run is bitwise the resident ring run."""
        if self.local_assignment is None:
            raise ValueError(
                "deduped stream windows have no slot-groups (no ring "
                "transport to plan); sub_layout() is a faithful/ring-"
                "mode call"
            )
        return _WindowedLayout(
            n_workers=self.group_workers,
            n_slots=int(self.local_assignment.shape[1]),
            n_partitions=self.staged_partitions,
            assignment=self.local_assignment,
        )


@dataclasses.dataclass(frozen=True)
class WindowShard:
    """One rank's share of every window of a :class:`StreamWindowPlan`
    (StreamWindowPlan.shard): ``ranges[k]`` the contiguous partition ranges
    it stages of window k (empty outside the worker group), in staged
    order, ``n_partitions`` in all (the same for every window);
    ``local_assignment`` (materialized plans) its workers' slots as indices
    into what it stages."""

    ranges: tuple
    n_partitions: int
    local_assignment: Optional[np.ndarray]


def plan_stream_windows(layout: CodingLayout, window: int, *, mode: str = "deduped") -> StreamWindowPlan:
    """The staged windows a streamed run of ``layout`` consumes.

    ``window`` is the partition-window size (a divisor of P, from
    trainer._resolve_stream_window). Deduped plans are plain partition
    windows. Faithful plans split the worker axis into ``P // window``
    contiguous slot-groups and stage each group's whole assigned span,
    window plus halo, refusing when the worker axis does not split evenly
    or the assignment is not window-uniform. Ring plans are the faithful
    plans whose windows the ring transport fills (the same ranges, halo
    and slot-groups)."""
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
    if mode not in ("materialized", "ring"):
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
