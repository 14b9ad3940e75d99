"""Sequence-parallel exact attention over a mesh axis, and its oracle.

The port of erasurehead_tpu/parallel/ring.py. Each process of a sequence
axis (a row of a 2-D mesh, parallel/mesh.worker_seq_mesh) holds one
contiguous shard of the sequence; the two canonical forms of sequence
parallelism reproduce full attention from those shards:

  - **ring** (:func:`ring_attention_shard`): the K/V shards rotate around the
    axis one hop at a time (mesh.WorkerMesh.axis_shift, the JAX package's
    ``lax.ppermute``) while the local Q shard folds every visiting block into
    a flash-style online softmax (running row max and normaliser), so the
    full [T, T] score matrix is never formed on one process; causal masking
    uses global positions from the rank's axis position. N shards take N - 1
    hops (the JAX scan's N-th rotation, which only restores ownership, is
    not made);
  - **Ulysses** (:func:`ulysses_attention_shard`): one all-to-all re-shards
    the stacked sequence-sharded q/k/v into head-sharded full sequences,
    each process runs :func:`reference_attention` for its own heads, and a
    second all-to-all restores the sequence sharding.

Both are plain functions of the rank's shard and the mesh (the JAX package
runs them under ``shard_map``); their collectives are differentiable, so one
backward pass through them gives each rank its share of the gradient. The
math is exact attention, equal to the oracle up to float32 reduction order.
"""

from __future__ import annotations

import functools

import torch

SEQ_AXIS = "seq"
_NEG_INF = -1e30  # additive mask value; finite so exp() never NaNs


def _block_update(acc, m, l, scores, v_blk):
    """Fold one visiting K/V block into the online-softmax state.

    acc [..., Tq, d] unnormalised output; m [..., Tq] running row max;
    l [..., Tq] running normaliser; scores [..., Tq, Tk]; v_blk [..., Tk, d].
    """
    m_new = torch.maximum(m, scores.amax(dim=-1))
    # rescale the previous state to the new max, then add this block
    corr = torch.exp(m - m_new)
    p = torch.exp(scores - m_new.unsqueeze(-1))
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr.unsqueeze(-1) + p @ v_blk
    return acc_new, m_new, l_new


def _seq_axis(mesh) -> tuple:
    """(shards, this rank's position) of the mesh's sequence axis."""
    if mesh.axis_name is None:
        raise ValueError(
            "sequence-parallel attention needs a mesh with a model-internal "
            "axis (parallel/mesh.worker_seq_mesh)"
        )
    return mesh.shards, mesh.axis_index


def ring_attention_shard(q, k, v, *, mesh, causal: bool = False, scale=None):
    """Exact attention of this rank's queries against the FULL sequence.

    q [..., Tq, d], k and v [..., Tk, d]: this rank's contiguous shards of
    the sequence (leading dims are batch dims, e.g. rows and heads). At step
    s the K/V buffer holds the shard of axis position (idx - s) mod N; after
    each step but the last it moves one position along the axis."""
    n, idx = _seq_axis(mesh)
    Tq, d = q.shape[-2:]
    Tk = k.shape[-2]
    scale = (d ** -0.5) if scale is None else scale
    in_dtype = q.dtype
    q = q.float() * scale
    dev = q.device
    # global positions for causal masking (shards are contiguous slices)
    q_pos = idx * Tq + torch.arange(Tq, device=dev)

    acc = torch.zeros(q.shape, device=dev)
    m = torch.full(q.shape[:-1], _NEG_INF, device=dev)
    l = torch.zeros(q.shape[:-1], device=dev)
    kv = torch.stack([k, v])
    for s in range(n):
        k_buf, v_buf = kv.unbind(0)
        scores = q @ k_buf.float().transpose(-1, -2)  # [..., Tq, Tk]
        if causal:
            owner = (idx - s) % n
            k_pos = owner * Tk + torch.arange(Tk, device=dev)
            scores = torch.where(q_pos[:, None] >= k_pos[None, :], scores, _NEG_INF)
        acc, m, l = _block_update(acc, m, l, scores, v_buf.float())
        if s < n - 1:
            kv = mesh.axis_shift(kv)
    # fully masked rows (none for causal contiguous shards) normalise to 0
    return (acc / torch.clamp(l, min=1e-30).unsqueeze(-1)).to(in_dtype)


def make_ring_attention_fn(mesh, *, causal: bool = False):
    """The ring over ``mesh``'s sequence axis, as a function of the rank's
    [T/N, d] (or [..., T/N, d]) shards, giving the rank's output shard."""
    return functools.partial(ring_attention_shard, mesh=mesh, causal=causal)


def ulysses_attention_shard(q, k, v, *, mesh, causal: bool = False, scale=None):
    """All-to-all ("Ulysses") sequence parallelism: q, k, v [..., T/N, H, d]
    (this rank's sequence shard, all heads). One all-to-all over the stacked
    [3, ..., T/N, H, d] re-shards them to head-sharded full sequences
    [3, ..., T, H/N, d], :func:`reference_attention` runs per head, and a
    second all-to-all restores the sequence sharding: two collectives a
    call, against the ring's N - 1 hops. Needs H divisible by the axis
    size."""
    n, _ = _seq_axis(mesh)
    H = q.shape[-2]
    if H % n:
        raise ValueError(f"heads={H} must be divisible by axis size {n}")
    qkv = torch.stack([q, k, v])  # [3, ..., T/N, H, d]
    qh, kh, vh = mesh.axis_all_to_all(qkv, split_dim=-2, concat_dim=-3).unbind(0)
    heads = lambda x: x.transpose(-3, -2)  # [..., T, H/N, d] <-> [..., H/N, T, d]
    out = heads(reference_attention(heads(qh), heads(kh), heads(vh), causal=causal, scale=scale))
    return mesh.axis_all_to_all(out, split_dim=-3, concat_dim=-2)


def make_ulysses_attention_fn(mesh, *, causal: bool = False):
    """Ulysses over ``mesh``'s sequence axis, as a function of the rank's
    [T/N, H, d] (or [..., T/N, H, d]) shards, giving the rank's output
    shard."""
    return functools.partial(ulysses_attention_shard, mesh=mesh, causal=causal)


def reference_attention(q, k, v, *, causal: bool = False, scale=None):
    """softmax(QKᵀ·scale)V in float32, with an optional causal mask;
    ``scale`` defaults to 1/√d. q [..., T, d], k and v [..., Tk, d]: any
    leading dims are batch dims (the JAX function takes [T, d] and is
    vmapped). The output takes q's dtype."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    scores = (q.float() * scale) @ k.float().transpose(-1, -2)
    if causal:
        T, Tk = scores.shape[-2:]
        idx_q = torch.arange(T, device=scores.device)[:, None]
        idx_k = torch.arange(Tk, device=scores.device)[None, :]
        scores = torch.where(idx_q >= idx_k, scores, _NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return (w @ v.float()).to(q.dtype)
