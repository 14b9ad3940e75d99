"""Attention's single-device oracle: erasurehead_tpu/parallel/ring.py's
``reference_attention``.

The JAX module also holds the sequence-parallel transports (ring attention
over ``lax.ppermute``, Ulysses over ``all_to_all``) that span a sequence
over several devices; they wait for ROADMAP A9b (the model-internal
axes). Every rank of the worker mesh runs the attention family in this
plain form.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30  # additive mask value; finite so exp() never NaNs


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
