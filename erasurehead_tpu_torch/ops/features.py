"""Feature-matrix products over dense, sparse and compressed stacks, in float32.

The port of erasurehead_tpu/ops/features.py. All model code routes matrix
products through :func:`matvec` / :func:`rmatvec`, so every stack kind is
interchangeable:

  - a dense tensor [..., n, F] (float32 or bfloat16 data);
  - :class:`PaddedRows`: row-sparse with a fixed number of stored entries a
    row (``indices``/``values`` [..., n, nnz]);
  - :class:`FieldOnehot`: exactly one active column in each of K disjoint
    field blocks a row (``local`` [..., n, K]), the structure of the
    reference's real one-hot workloads (covtype, amazon);
  - :class:`QuantizedStack`: an int8 payload with per-block float32 scales,
    which the step dequantizes before any product (:func:`maybe_dequantize`).

Leading (slot) dimensions are carried through: ``matvec`` of a [W, S, n, .]
stack gives [W, S, n] margins and ``rmatvec`` [W, S, F] per-slot gradients,
as the JAX package's per-slot ``vmap`` does; :func:`flatten_rows` folds them
into the row axis for the flat lowering (one accumulator for the stack).

Determinism: every scatter is a sum over entries grouped by target column in
an order fixed once per stack (:class:`_Segments`: entries sorted by target
at first use and cached on the container, then ``torch.segment_reduce``),
so reruns on the card are bitwise equal. PyTorch's ``index_add_`` and
``scatter_add_`` would accumulate with atomics there. The same holds for the
gradient of a PaddedRows gather that autodiff takes (:func:`_gather_rows`).

The JAX package's TPU layout devices have no counterpart on the card and
are exact there anyway: ``dense_margin_cols`` (validated, no effect) and the
lane replication of ``sparse_lanes``. A lane width still changes the
FieldOnehot pairing plan (:func:`fields_margin_plan` shrinks the pair cap by
the lane width), so the port builds the same tables and gathers scalars
from them.

Precision: products run in float32 with TF32 off
(utils/device.pin_float32_precision), the counterpart of the JAX package's
``Precision.HIGHEST``. bfloat16 data is upcast to float32 before the product
(the JAX package casts the vector operand down and accumulates in float32).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch
from torch.utils import _pytree as pytree

# Max entries of one fused pair table (both directions), as in the JAX
# package: pairs over it take per-field singles (amazon-class ~5.5k-category
# fields always do).
PAIR_TABLE_CAP = 1 << 21

# Budget for one lane-replicated margin table in the JAX package; here it only
# shapes the pairing plan (fields_margin_plan), since gathers stay scalar.
LANE_TABLE_BYTES_CAP = 1 << 28  # 256 MB

# One-hot chunk byte budget: the chunk row count C keeps one [C, B_max]
# float32 one-hot within this, rounded down to a multiple of 512 (floor 512).
# The JAX package's budget is 32 MB; on the card the one-hot lowering's cost
# is one launch each per field and chunk, so the chunks are 8x larger (the
# margin's rows are independent; the scatter sums its chunk partials in
# order, so only where those partials split moves).
_ONEHOT_CHUNK_BYTES = 1 << 28  # 256 MB

# A segment sum whose targets average fewer entries than this reduces one
# target a thread (segment_reduce's kernel for 2-D data); longer segments go
# through CUB's segmented reduce, a block a target (its kernel for 1-D data).
# Both sum each target's entries in their fixed order.
_SHORT_SEGMENT = 64

FIELDS_SCATTER_MODES = ("pairs", "onehot")
FIELDS_MARGIN_MODES = ("tables", "onehot")


def validate_margin_cols(C: Optional[int]) -> Optional[int]:
    """Normalize/validate a margin-cols width: None, or an int in [2, 128].
    The knob is a TPU lowering device with no effect on the card; the rule
    and its message are the JAX package's."""
    if C is None:
        return None
    C = int(C)
    if C < 2 or C > 128:
        raise ValueError(f"dense margin cols must be in [2, 128], got {C}")
    return C


def validate_lanes(L: Optional[int]) -> Optional[int]:
    """Normalize/validate a lane width: None, or a power of two in [1, 1024]."""
    if L is None:
        return None
    L = int(L)
    if L < 1 or L > 1024 or (L & (L - 1)):
        raise ValueError(
            f"sparse lane width must be a power of two in [1, 1024], got {L}"
        )
    return L


def fields_margin_plan(field_sizes, lanes=None, itemsize=4):
    """The pairing plan the margin matvec uses at a given lane width: lane
    replication shrinks the pair cap so one [entries, L] table stays within
    LANE_TABLE_BYTES_CAP (``itemsize`` bytes an entry)."""
    cap = PAIR_TABLE_CAP
    if lanes is not None:
        cap = min(cap, LANE_TABLE_BYTES_CAP // (itemsize * lanes))
    return _greedy_pairing(tuple(field_sizes), cap=cap)


def _greedy_pairing(field_sizes, cap=PAIR_TABLE_CAP):
    """Static pairing plan: adjacent fields fuse when their pair table fits.

    Returns a tuple of ("pair", i, j) / ("single", i) entries covering every
    field exactly once."""
    plan, k, K = [], 0, len(field_sizes)
    while k < K:
        if k + 1 < K and field_sizes[k] * field_sizes[k + 1] <= cap:
            plan.append(("pair", k, k + 1))
            k += 2
        else:
            plan.append(("single", k))
            k += 1
    return tuple(plan)


def infer_field_sizes(csr) -> Optional[tuple]:
    """Detect the one-hot field structure of a CSR matrix, or None.

    Checks: uniform nnz/row K, all values 1.0, and (after per-row sorting)
    the k-th entry of every row lives in a column range disjoint from and
    left of the (k+1)-th's. Observed ranges become the field blocks; gaps
    between them fold left, so the blocks tile [0, hi[-1]]."""
    csr = csr.tocsr()
    n = csr.shape[0]
    if n == 0 or csr.nnz == 0 or csr.nnz % n:
        return None
    K = csr.nnz // n
    counts = np.diff(csr.indptr)
    if not np.all(counts == K) or not np.all(csr.data == 1.0):
        return None
    idx = np.sort(csr.indices.reshape(n, K), axis=1)
    lo, hi = idx.min(axis=0), idx.max(axis=0)
    if np.any(hi[:-1] >= lo[1:]):
        return None
    bounds = np.concatenate([[-1], hi])
    return tuple(int(b) for b in np.diff(bounds))


# ---------------------------------------------------------------------------
# deterministic scatter: entries grouped by target in a fixed order


@dataclasses.dataclass(frozen=True)
class _Segments:
    """Scatter-add plan over a fixed set of target keys: the entries sorted
    by target once (stable), the entry count and key of every target that
    has entries, and the number of targets. :meth:`sum` then reduces each
    target's entries in that order (``torch.segment_reduce``: no atomics)
    and places the sums; targets without entries are 0."""

    order: torch.Tensor  # [E] int64
    counts: torch.Tensor  # [U] int64, entries of each nonempty target
    targets: torch.Tensor  # [U] int64, sorted
    size: int

    @classmethod
    def of(cls, keys: torch.Tensor, size: int) -> "_Segments":
        sorted_keys, order = torch.sort(keys.reshape(-1).long(), stable=True)
        targets, counts = torch.unique_consecutive(sorted_keys, return_counts=True)
        return cls(order, counts, targets, int(size))

    def sum(self, contrib: torch.Tensor) -> torch.Tensor:
        """[E, *t] entry contributions -> [size, *t] per-target sums."""
        short = contrib.ndim == 1 and self.order.numel() < _SHORT_SEGMENT * self.counts.numel()
        if short:
            contrib = contrib.unsqueeze(1)
        out = _segment_sum(contrib, self.order, self.counts, self.targets, self.size)
        return out.squeeze(1) if short else out


@torch.library.custom_op("erasurehead_tpu_torch::segment_sum", mutates_args=())
def _segment_sum(
    contrib: torch.Tensor, order: torch.Tensor, counts: torch.Tensor,
    targets: torch.Tensor, size: int,
) -> torch.Tensor:
    out = contrib.new_zeros((size,) + tuple(contrib.shape[1:]))
    if counts.numel() == 0:
        return out
    vals = torch.segment_reduce(
        contrib.index_select(0, order), "sum", lengths=counts, axis=0, unsafe=True
    )
    return out.index_copy(0, targets, vals)


@_segment_sum.register_fake
def _(contrib, order, counts, targets, size):
    return contrib.new_empty((size,) + tuple(contrib.shape[1:]))


def _segment_sum_vmap(info, in_dims, contrib, order, counts, targets, size):
    """A batch of contributions (a cohort's trajectories under
    ``torch.func.vmap``) reduces as trailing columns of one segment sum;
    the plan itself is never batched."""
    if any(d is not None for d in in_dims[1:]):
        raise NotImplementedError("a scatter plan is a static of the stack; it is not batched")
    if in_dims[0] is None:
        return _segment_sum(contrib, order, counts, targets, size), None
    out = _segment_sum(contrib.movedim(in_dims[0], -1), order, counts, targets, size)
    return out, out.ndim - 1


_segment_sum.register_vmap(_segment_sum_vmap)


class _ScatterRows(torch.autograd.Function):
    """The gradient of :class:`_GatherRows` in its rows: each row's entries
    of ``grad`` [*idx.shape, *t] summed in index order (entries sorted
    stably by row, then ``torch.segment_reduce``), [n, *t]."""

    @staticmethod
    def forward(grad, idx, n):
        trail = tuple(grad.shape[idx.ndim:])
        return _Segments.of(idx, n).sum(grad.reshape((-1,) + trail))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[1])

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return _GatherRows.apply(g, idx), None, None

    @staticmethod
    def vmap(info, in_dims, grad, idx, n):
        """A batch of gradients (a cohort's trajectories) sums as trailing
        columns of one segment sum over the shared indices."""
        g_dim, i_dim = in_dims[:2]
        if i_dim is not None:
            raise NotImplementedError("the gather's indices are flattened before its gradient")
        if g_dim is None:
            return _ScatterRows.apply(grad, idx, n), None
        out = _ScatterRows.apply(grad.movedim(g_dim, -1), idx, n)
        return out, out.ndim - 1


class _GatherRows(torch.autograd.Function):
    """``v[idx]`` whose gradient in ``v`` is :class:`_ScatterRows`, a
    deterministic segment sum, where ``index_select``'s backward would add
    with atomics on the card."""

    @staticmethod
    def forward(v, idx):
        return v.index_select(0, idx.reshape(-1)).reshape(tuple(idx.shape) + tuple(v.shape[1:]))

    @staticmethod
    def setup_context(ctx, inputs, output):
        v, idx = inputs
        ctx.save_for_backward(idx)
        ctx.n = v.shape[0]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return _ScatterRows.apply(grad, idx, ctx.n), None

    @staticmethod
    def vmap(info, in_dims, v, idx):
        """Batched indices (a stack's slots under ``torch.func.vmap``)
        gather as one flat index; batched rows (a cohort's trajectories)
        offset each trajectory's indices into the stacked rows."""
        v_dim, i_dim = in_dims
        if v_dim is None:
            return _GatherRows.apply(v, idx), i_dim
        v = v.movedim(v_dim, 0)
        B, F = v.shape[0], v.shape[1]
        if i_dim is None:
            idx = idx.expand((B,) + tuple(idx.shape))
        else:
            idx = idx.movedim(i_dim, 0)
        offsets = (torch.arange(B, device=idx.device, dtype=idx.dtype) * F).reshape(
            (B,) + (1,) * (idx.ndim - 1))
        return _GatherRows.apply(v.reshape((B * F,) + tuple(v.shape[2:])), idx + offsets), 0


def _gather_rows(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``v`` [F, *t] at every index of ``idx``: [*idx.shape, *t].
    The autodiff families on a PaddedRows stack (mlp, deepmlp, moe,
    attention) differentiate it, so their reruns are bitwise on the card."""
    return _GatherRows.apply(v, idx)


def _cached(X, key, build):
    """A per-stack static derived from the stack's own indices (a scatter
    plan, a fused code), built at first use and kept on the container."""
    val = X._cache.get(key)
    if val is None:
        val = X._cache[key] = build()
    return val


def _slot_offsets(M: int, stride: int, device) -> torch.Tensor:
    return torch.arange(M, device=device, dtype=torch.int64) * stride


# ---------------------------------------------------------------------------
# the stack containers


@dataclasses.dataclass(eq=False)
class PaddedRows:
    """Row-sparse matrix with a fixed number of stored entries per row.

    ``values[..., r, k]`` sits at column ``indices[..., r, k]``; padding
    entries carry value 0.0 (their index may repeat a real one: a zero value
    makes them inert in both directions). Leaves are numpy arrays on the
    host (as :meth:`from_scipy` builds them) or tensors on the run's device
    (:func:`to_device`)."""

    indices: object  # [..., n, nnz] int32
    values: object  # [..., n, nnz] float
    n_cols: int
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def shape(self):
        """Leading dims + (rows, n_cols)."""
        return tuple(self.indices.shape[:-1]) + (self.n_cols,)

    @classmethod
    def from_scipy(cls, csr, nnz: int | None = None) -> "PaddedRows":
        """Convert a scipy CSR matrix, padding every row to ``nnz`` entries
        (host numpy leaves)."""
        csr = csr.tocsr()
        counts = np.diff(csr.indptr)
        width = int(counts.max()) if nnz is None else nnz
        if counts.max() > width:
            raise ValueError(f"row with {counts.max()} nnz exceeds width {width}")
        n = csr.shape[0]
        idx = np.zeros((n, width), dtype=np.int32)
        val = np.zeros((n, width), dtype=csr.data.dtype)
        rows = np.repeat(np.arange(n), counts)
        cols = np.arange(csr.indptr[-1]) - np.repeat(csr.indptr[:-1], counts)
        idx[rows, cols] = csr.indices
        val[rows, cols] = csr.data
        return cls(idx, val, int(csr.shape[1]))

    @classmethod
    def from_dense(cls, dense: np.ndarray, nnz: int) -> "PaddedRows":
        import scipy.sparse as sps

        return cls.from_scipy(sps.csr_matrix(dense), nnz)

    def to_dense(self) -> torch.Tensor:
        """[n, n_cols] dense tensor of a two-dimensional stack."""
        idx, val = torch.as_tensor(self.indices).long(), torch.as_tensor(self.values)
        n, width = idx.shape
        out = torch.zeros((n, self.n_cols), dtype=val.dtype, device=val.device)
        rows = torch.arange(n, device=idx.device).repeat_interleave(width)
        return out.index_put_((rows, idx.reshape(-1)), val.reshape(-1), accumulate=True)


@dataclasses.dataclass(eq=False)
class FieldOnehot:
    """Exactly-one-hot-per-field sparse rows: row r activates one column
    (value 1.0) inside each of K disjoint field blocks; ``local[..., r, k]``
    is its category within field k.

    The container also carries its lowering (the JAX package's module-wide
    switches, set per run from RunConfig): ``margin`` "tables" (fused pair
    tables ``T[a, b] = beta_i[a] + beta_j[b]`` gathered by the code
    ``local_i * B_j + local_j``, plan :func:`fields_margin_plan` at
    ``lanes``) or "onehot" (per-field one-hot matmuls); ``scatter`` "pairs"
    (sums into the pair tables' cells, then their row and column sums) or
    "onehot" (per-field one-hot matmuls)."""

    local: object  # [..., n, K] int32
    field_sizes: tuple
    n_cols: int
    margin: str = "tables"
    scatter: str = "pairs"
    lanes: Optional[int] = None
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def offsets(self):
        return np.concatenate([[0], np.cumsum(self.field_sizes)]).astype(int)

    @property
    def shape(self):
        """Leading dims + (rows, n_cols)."""
        return tuple(self.local.shape[:-1]) + (self.n_cols,)

    @classmethod
    def from_scipy(cls, csr, field_sizes=None) -> "FieldOnehot":
        """Build from a CSR matrix (host numpy leaf); infers the field blocks
        when not given. Raises ValueError if the matrix is not
        exactly-one-hot-per-field."""
        csr = csr.tocsr().copy()
        csr.sum_duplicates()
        if field_sizes is None:
            field_sizes = infer_field_sizes(csr)
            if field_sizes is None:
                raise ValueError(
                    "matrix is not field-structured one-hot "
                    "(uniform nnz/row, all-ones values, k-th entry of every "
                    "row inside the k-th disjoint column block)"
                )
        sizes = tuple(int(b) for b in field_sizes)
        K = len(sizes)
        n = csr.shape[0]
        counts = np.diff(csr.indptr)
        if not np.all(counts == K):
            raise ValueError(f"every row must have exactly {K} entries")
        idx = np.sort(csr.indices.reshape(n, K), axis=1)
        offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        local = idx - offs[:-1][None, :]
        if (local < 0).any() or (local >= np.asarray(sizes)[None, :]).any():
            raise ValueError("row entries fall outside their field blocks")
        if not np.all(csr.data == 1.0):
            raise ValueError("field-structured one-hot requires unit values")
        return cls(np.asarray(local, np.int32), sizes, int(csr.shape[1]))

    def with_lowering(self, margin="tables", scatter="pairs", lanes=None) -> "FieldOnehot":
        if margin not in FIELDS_MARGIN_MODES:
            raise ValueError(f"fields margin mode must be tables/onehot, got {margin!r}")
        if scatter not in FIELDS_SCATTER_MODES:
            raise ValueError(f"fields scatter mode must be pairs/onehot, got {scatter!r}")
        return FieldOnehot(self.local, self.field_sizes, self.n_cols, margin, scatter,
                           validate_lanes(lanes))

    def to_dense(self) -> torch.Tensor:
        """[n, n_cols] float32 dense tensor of a two-dimensional stack."""
        local = torch.as_tensor(self.local).long()
        n, K = local.shape
        out = torch.zeros((n, self.n_cols), dtype=torch.float32, device=local.device)
        cols = local + torch.as_tensor(self.offsets[:-1], device=local.device)[None, :]
        rows = torch.arange(n, device=local.device).repeat_interleave(K)
        return out.index_put_(
            (rows, cols.reshape(-1)), torch.ones(n * K, device=local.device), accumulate=True
        )


@dataclasses.dataclass(eq=False)
class QuantizedStack:
    """int8-compressed dense feature stack with per-block scale tables
    (``stack_dtype="int8"``): ``q[..., r, f] = round(X[..., r, f] /
    scale[..., f])`` clipped to [-127, 127], ``scale`` the per-(leading
    block, feature) absmax/127. Both leaves lead with the block axes, so the
    scale table rides the worker-major gather with its payload. The step
    dequantizes first (parallel/step._dq): the float32 values exist only as
    a temporary of the round."""

    q: object  # [..., rows, F] int8
    scale: object  # [..., F] float32

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def dtype(self):
        return self.q.dtype

    def dequantize(self):
        """[..., rows, F] float reconstruction, q * scale broadcast over the
        rows axis (exact for the quantizer's values)."""
        return self.q.to(self.scale.dtype) * self.scale[..., None, :]

    @classmethod
    def quantize(cls, X) -> "QuantizedStack":
        """Symmetric per-(block, feature) int8 quantization of a dense
        [..., rows, F] host stack (numpy in, numpy leaves out). All-zero
        columns get scale 1.0 and reconstruct to exact zeros."""
        X = np.asarray(X)
        if not np.issubdtype(X.dtype, np.floating):
            raise ValueError(
                f"stack_dtype='int8' quantizes float stacks; got {X.dtype}"
            )
        absmax = np.abs(X).max(axis=-2)  # [..., F]
        scale = (np.where(absmax > 0, absmax, 1.0) / 127.0).astype(np.float32)
        q = np.clip(np.rint(X / scale[..., None, :]), -127, 127).astype(np.int8)
        return cls(q, scale)


def maybe_dequantize(X):
    """Identity for ordinary stacks; the float32 reconstruction of a
    :class:`QuantizedStack`."""
    return X.dequantize() if isinstance(X, QuantizedStack) else X


Features = Union[torch.Tensor, PaddedRows, FieldOnehot, QuantizedStack]

# pytrees: torch.func.vmap splits a container's leaves along their leading
# axis, and tree maps reach its leaves; the lowering knobs are static context
pytree.register_pytree_node(
    PaddedRows,
    lambda X: ([X.indices, X.values], X.n_cols),
    lambda leaves, n_cols: PaddedRows(leaves[0], leaves[1], n_cols),
    serialized_type_name="erasurehead_tpu_torch.ops.features.PaddedRows",
)
pytree.register_pytree_node(
    FieldOnehot,
    lambda X: ([X.local], (X.field_sizes, X.n_cols, X.margin, X.scatter, X.lanes)),
    lambda leaves, ctx: FieldOnehot(leaves[0], *ctx),
    serialized_type_name="erasurehead_tpu_torch.ops.features.FieldOnehot",
)
pytree.register_pytree_node(
    QuantizedStack,
    lambda X: ([X.q, X.scale], None),
    lambda leaves, _: QuantizedStack(leaves[0], leaves[1]),
    serialized_type_name="erasurehead_tpu_torch.ops.features.QuantizedStack",
)

_CONTAINERS = (PaddedRows, FieldOnehot, QuantizedStack)


def is_container(X) -> bool:
    return isinstance(X, _CONTAINERS)


def to_device(X, device, float_dtype: torch.dtype):
    """A host stack (numpy, or a container of numpy leaves) as tensors on
    ``device``: float leaves in ``float_dtype``, integer leaves as they are.
    A QuantizedStack keeps its int8 payload and float32 scales."""

    def put(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dtype is None and t.is_floating_point():
            dtype = float_dtype
        return t.to(device=device, dtype=dtype)

    if isinstance(X, QuantizedStack):
        return QuantizedStack(put(X.q), put(X.scale, torch.float32))
    if is_container(X):
        return pytree.tree_map(put, X)
    return put(X)


def take_lead(X, index):
    """Index the leading (partition) axis of every leaf: the worker-major
    gather of a host stack through ``layout.assignment``."""
    if is_container(X):
        return pytree.tree_map(lambda leaf: leaf[index], X)
    return X[index]


def lead_shape(X) -> tuple:
    """The stack's leading (slot) dims."""
    return tuple(X.shape[:-2])


def reshape_lead(X, lead: tuple):
    """The stack with its leading dims reshaped to ``lead`` (views)."""
    if isinstance(X, QuantizedStack):
        return QuantizedStack(X.q.reshape(lead + tuple(X.q.shape[-2:])),
                              X.scale.reshape(lead + tuple(X.scale.shape[-1:])))
    if is_container(X):
        return pytree.tree_map(lambda leaf: leaf.reshape(lead + tuple(leaf.shape[-2:])), X)
    return X.reshape(lead + tuple(X.shape[-2:]))


def flatten_rows(X: Features) -> Features:
    """Collapse every leading (slot) axis of a stack into the row axis:
    dense [..., R, F] -> [M*R, F], PaddedRows leaves [..., R, nnz] ->
    [M*R, nnz], FieldOnehot local [..., R, K] -> [M*R, K]. The flat
    gradient lowering (parallel/step.make_flat_grad_fn) makes the whole
    stack one matvec/rmatvec call: one accumulator instead of one a slot.
    A container's flat view is kept on it, with its scatter plans."""
    if isinstance(X, (PaddedRows, FieldOnehot)):
        return _cached(X, "flat", lambda: pytree.tree_map(
            lambda leaf: leaf.reshape(-1, leaf.shape[-1]), X))
    return X.reshape(-1, X.shape[-1])


def n_rows(X: Features) -> int:
    return X.shape[0]


# ---------------------------------------------------------------------------
# products


def _f32(X: torch.Tensor) -> torch.Tensor:
    return X if X.dtype == torch.float32 else X.float()


def matvec(X: Features, v: torch.Tensor) -> torch.Tensor:
    """X @ v for a dense [..., n, F] tensor, PaddedRows or FieldOnehot; v
    is a vector [F] ([..., n] out) or a weight matrix [F, H] ([..., n, H])."""
    if isinstance(X, FieldOnehot):
        return _fields_matvec(X, v)
    if isinstance(X, PaddedRows):
        vals = _f32(X.values)
        gathered = _gather_rows(v, X.indices)  # [..., n, nnz] or [..., n, nnz, H]
        if v.ndim == 1:
            return (vals * gathered).sum(-1)
        return (vals.unsqueeze(-1) * gathered).sum(-2)
    return torch.matmul(_f32(X), v)


def rmatvec(X: Features, r: torch.Tensor) -> torch.Tensor:
    """X^T @ r per leading (slot) entry: r [..., n] gives [..., F], and for
    the sparse stacks r [..., n, H] gives [..., F, H]. Sparse scatters are
    deterministic (see :class:`_Segments`)."""
    if isinstance(X, FieldOnehot):
        return _fields_rmatvec(X, r)
    if isinstance(X, PaddedRows):
        return _padded_rmatvec(X, r)
    return torch.matmul(r.unsqueeze(-2), _f32(X)).squeeze(-2)


def _padded_rmatvec(X: PaddedRows, r: torch.Tensor) -> torch.Tensor:
    lead = lead_shape(X)
    M = int(np.prod(lead))
    n, nnz = X.indices.shape[-2:]
    F = X.n_cols

    def plan():
        keys = X.indices.reshape(M, n * nnz).long() + _slot_offsets(M, F, X.indices.device)[:, None]
        return _Segments.of(keys, M * F)

    seg = _cached(X, ("scatter", len(lead)), plan)
    trail = tuple(r.shape[len(lead) + 1:])  # () or (H,)
    vals = _f32(X.values).reshape(lead + (n, nnz) + (1,) * len(trail))
    contrib = vals * r.unsqueeze(len(lead) + 1)  # [..., n, nnz, *trail]
    return seg.sum(contrib.reshape((-1,) + trail)).reshape(lead + (F,) + trail)


def _fused_code(X: FieldOnehot, entry) -> torch.Tensor:
    """Each row's index into a plan entry's table, [..., n] int64: the
    pair code ``local_i * B_j + local_j`` or a single's ``local_i``."""

    def build():
        if entry[0] == "pair":
            _, i, j = entry
            return X.local[..., i].long() * X.field_sizes[j] + X.local[..., j].long()
        return X.local[..., entry[1]].long()

    return _cached(X, ("code", entry), build)


def _entry_size(sizes, entry) -> int:
    return sizes[entry[1]] * sizes[entry[2]] if entry[0] == "pair" else sizes[entry[1]]


def _plan_tables(plan, sizes, v):
    """One fused sum table a plan entry: a pair's outer sum over its two
    fields' categories (flattened), or a single's slice of v."""
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    for entry in plan:
        if entry[0] == "pair":
            _, i, j = entry
            bi, bj = v[offs[i]:offs[i + 1]], v[offs[j]:offs[j + 1]]
            yield entry, (bi[:, None] + bj[None, :]).reshape(-1)
        else:
            yield entry, v[offs[entry[1]]:offs[entry[1] + 1]]


def _fields_matvec(X: FieldOnehot, v: torch.Tensor) -> torch.Tensor:
    """sum_k v[off_k + local[..., k]]."""
    offs, sizes = X.offsets, X.field_sizes
    if v.ndim > 1:
        # matrix rhs (the first layer of the deep families): per-field row
        # gathers of H-wide rows
        out = 0.0
        for k in range(len(sizes)):
            loc = X.local[..., k]
            out = out + v[offs[k]:offs[k + 1]].index_select(0, loc.reshape(-1)).reshape(
                tuple(loc.shape) + tuple(v.shape[1:]))
        return out
    if X.margin == "onehot":
        return _onehot_fields_matvec(X, v)
    out = 0.0
    plan = fields_margin_plan(sizes, X.lanes, itemsize=v.element_size())
    for entry, table in _plan_tables(plan, sizes, v):
        code = _fused_code(X, entry)
        out = out + table.index_select(0, code.reshape(-1)).reshape(code.shape)
    return out


def _onehot_chunk(X: FieldOnehot, M: int = 1) -> int:
    """Rows a one-hot chunk: one [C, B_max] float32 one-hot (for each of
    ``M`` slots) within _ONEHOT_CHUNK_BYTES, a multiple of 512, at least
    512 (the JAX package's rule at M = 1, with its budget)."""
    return max(512, _ONEHOT_CHUNK_BYTES // (4 * M * max(X.field_sizes)) // 512 * 512)


def _field_onehot(l_col: torch.Tensor, B: int, buf: torch.Tensor) -> torch.Tensor:
    """Exact 0/1 one-hot [..., C, B] of an integer column [..., C], built in
    ``buf`` (one buffer serves every field and chunk of a product: a fresh
    chunk-sized allocation a field costs the CPU its page faults)."""
    oh = buf[: l_col.numel() * B].view(tuple(l_col.shape) + (B,))
    return oh.zero_().scatter_(-1, l_col.long().unsqueeze(-1), 1.0)


def _onehot_fields_matvec(X: FieldOnehot, v: torch.Tensor) -> torch.Tensor:
    """X @ v via per-field one-hot matmuls over row chunks: p += onehot
    [C, B_k] @ v_k for each field; no gathers."""
    offs, sizes = X.offsets, X.field_sizes
    rows = X.local.reshape(-1, len(sizes))
    C = _onehot_chunk(X)
    buf = torch.empty(min(C, rows.shape[0]) * max(sizes), dtype=v.dtype, device=v.device)
    parts = []
    for c0 in range(0, rows.shape[0], C):
        lc = rows[c0:c0 + C]
        p = 0.0
        for k, B in enumerate(sizes):
            p = p + _field_onehot(lc[:, k], B, buf) @ v[offs[k]:offs[k + 1]]
        parts.append(p)
    return torch.cat(parts).reshape(tuple(X.local.shape[:-1]))


def _assemble(blocks, n_cols: int, lead: tuple, trail: tuple) -> torch.Tensor:
    """Per-field blocks [M, B_k, *trail], in field order, as the [..., F,
    *trail] gradient (columns past the last field block are 0)."""
    M = int(np.prod(lead))
    used = sum(b.shape[1] for b in blocks)
    if used < n_cols:
        blocks = list(blocks) + [blocks[0].new_zeros((M, n_cols - used) + trail)]
    return torch.cat(blocks, dim=1).reshape(lead + (n_cols,) + trail)


def _onehot_fields_rmatvec(X: FieldOnehot, r: torch.Tensor) -> torch.Tensor:
    """X^T @ r via per-field one-hot matmuls over row chunks of each slot:
    g_k = sum over chunks of r [C] @ onehot [C, B_k]; chunk partials are
    summed in order."""
    lead = lead_shape(X)
    M = int(np.prod(lead))
    K = len(X.field_sizes)
    n = X.local.shape[-2]
    loc = X.local.reshape(M, n, K)
    rs = r.reshape(M, n)
    C = _onehot_chunk(X, M)
    buf = torch.empty(M * min(C, n) * max(X.field_sizes), dtype=r.dtype, device=r.device)
    partials = [[] for _ in range(K)]
    for c0 in range(0, n, C):
        lc, rc = loc[:, c0:c0 + C], rs[:, c0:c0 + C].unsqueeze(-2)  # [M, 1, C]
        for k, B in enumerate(X.field_sizes):
            partials[k].append(torch.matmul(rc, _field_onehot(lc[..., k], B, buf)).squeeze(-2))
    blocks = [torch.stack(p).sum(0) for p in partials]  # [M, B_k]
    return _assemble(blocks, X.n_cols, lead, ())


def _fields_rmatvec(X: FieldOnehot, r: torch.Tensor) -> torch.Tensor:
    """X^T @ r: sums into the pair tables' cells, then their row and
    column sums ("pairs"); per-field one-hot matmuls ("onehot"); a matrix
    r [..., n, H] sums per field."""
    lead = lead_shape(X)
    M = int(np.prod(lead))
    sizes = X.field_sizes
    dev = X.local.device
    trail = tuple(r.shape[len(lead) + 1:])
    if not trail and X.scatter == "onehot":
        return _onehot_fields_rmatvec(X, r)
    plan = _greedy_pairing(sizes) if not trail else tuple(("single", k) for k in range(len(sizes)))
    contrib = r.reshape((-1,) + trail)  # one entry a row and plan entry
    blocks = []
    for entry in plan:
        T = _entry_size(sizes, entry)

        def segments(entry=entry, T=T):
            code = _fused_code(X, entry).reshape(M, -1)
            return _Segments.of(code + _slot_offsets(M, T, dev)[:, None], M * T)

        acc = _cached(X, ("scatter", entry), segments).sum(contrib)  # [M*T, *trail]
        if entry[0] == "pair":
            t = acc.reshape((M, sizes[entry[1]], sizes[entry[2]]) + trail)
            blocks += [t.sum(2), t.sum(1)]
        else:
            blocks.append(acc.reshape((M, T) + trail))
    return _assemble(blocks, X.n_cols, lead, trail)
