"""Single-block attention classifier: erasurehead_tpu/models/attention.py.

Each data row is a sequence: the flat feature vector [F] reshapes to
[T, d_in] with T = F // d_in tokens. An embedding to d_model, one
multi-head self-attention block (parallel/ring.reference_attention per
head), a residual, a mean pool over the tokens and a logistic head give the
margin; logistic loss on it (models/glm.MarginClassifierBase), gradients by
autodiff. Its summed loss is additive over row shards, so it trains under
the same gradient-coding protocol as every other family, layer-coded too:
its six leaves are six coded blocks.

``seq_axis`` composes sequence parallelism with the coded DP on a 2-D
(workers, seq) mesh (parallel/mesh.worker_seq_mesh, ``seq_shards``): each
member of the seq axis takes its token slice of the rows, attention spans
the axis in either canonical form (``sp_form``): "ring" (K/V rotate one hop
at a time, parallel/ring.ring_attention_shard) or "ulysses" (one
all-to-all to head-sharded full sequences, plain attention per head, one
back; needs n_heads % seq_shards == 0), and the members' partial token sums
of the pooled activations are summed over the axis, so every member holds
the same margins.
"""

from __future__ import annotations

import numpy as np
import torch

from erasurehead_tpu_torch.models.glm import MarginClassifierBase, normal_init
from erasurehead_tpu_torch.ops.features import FieldOnehot, PaddedRows
from erasurehead_tpu_torch.parallel.ring import (
    reference_attention,
    ring_attention_shard,
    ulysses_attention_shard,
)


class AttentionModel(MarginClassifierBase):
    name = "attention"

    def __init__(
        self,
        d_in: int = 8,
        d_model: int = 16,
        n_heads: int = 2,
        seq_axis: str | None = None,
        sp_form: str = "ring",
        mesh=None,
    ):
        if d_model % n_heads:
            raise ValueError(f"{d_model=} must be divisible by {n_heads=}")
        if sp_form not in ("ring", "ulysses"):
            raise ValueError(f"sp_form must be ring/ulysses, got {sp_form!r}")
        self.d_in = d_in
        self.d_model = d_model
        self.n_heads = n_heads
        # when set, predict runs on a rank of ``mesh``, whose model-internal
        # axis is this one (the trainer's for_mesh hook arranges it)
        self.seq_axis = seq_axis
        self.sp_form = sp_form
        self.mesh = mesh

    def for_mesh(self, mesh):
        """Trainer hook: a sequence-parallel copy when the mesh has a seq
        axis, self otherwise (scoped to step construction; eval replay
        stays unsharded)."""
        from erasurehead_tpu_torch.parallel.mesh import axis_active
        from erasurehead_tpu_torch.parallel.ring import SEQ_AXIS

        if axis_active(mesh, SEQ_AXIS):
            return AttentionModel(self.d_in, self.d_model, self.n_heads,
                                  seq_axis=SEQ_AXIS, sp_form=self.sp_form, mesh=mesh)
        return self

    def _heads(self, x):
        """[..., m] -> [..., H, m/H] per-head split (concat-projection
        convention: wq/wk/wv stay [m, m]; heads are views)."""
        H = self.n_heads
        return x.reshape(*x.shape[:-1], H, self.d_model // H)

    def _merge(self, x):
        return x.reshape(*x.shape[:-2], self.d_model)

    def init_params(self, seed: int, n_features: int, device="cpu"):
        """The JAX package's scales from a numpy draw (glm.normal_init)."""
        if n_features % self.d_in:
            raise ValueError(
                f"n_features={n_features} must be divisible by d_in={self.d_in} "
                f"(rows reshape to [T, {self.d_in}] token sequences)"
            )
        d, m = self.d_in, self.d_model
        s_in, s_m = 1.0 / np.sqrt(d), 1.0 / np.sqrt(m)
        return normal_init(seed, {
            "embed": ((d, m), s_in),
            "wq": ((m, m), s_m),
            "wk": ((m, m), s_m),
            "wv": ((m, m), s_m),
            "w_out": ((m,), s_m),
            "b_out": ((), 0.0),
        }, device)

    def predict(self, params, X):
        if isinstance(X, (PaddedRows, FieldOnehot)):
            raise TypeError(
                "the attention model requires dense features (rows reshape "
                "to token sequences); sparse data is not supported"
            )
        Xd = X.float()
        if self.seq_axis is not None:
            T = Xd.shape[-1] // self.d_in
            return self._predict_seq(params, Xd.reshape(*Xd.shape[:-1], T, self.d_in), T)
        n, F = Xd.shape
        tokens = Xd.reshape(n, F // self.d_in, self.d_in)  # a view
        h = tokens @ params["embed"]  # [n, T, m]
        # per head: [n, T, H, dh] -> [n, H, T, dh], attention over T
        q = self._heads(h @ params["wq"]).transpose(1, 2)
        k = self._heads(h @ params["wk"]).transpose(1, 2)
        v = self._heads(h @ params["wv"]).transpose(1, 2)
        a = self._merge(reference_attention(q, k, v).transpose(1, 2))  # [n, T, m]
        pooled = (h + a).mean(dim=1)  # residual + mean pool, [n, m]
        return pooled @ params["w_out"] + params["b_out"]

    def _predict_seq(self, params, tokens, T):
        """Sequence-parallel forward: this member embeds and projects only
        its token slice, ring or Ulysses attention supplies the
        full-sequence context, and the pooled activations are summed over
        the axis. tokens [..., n, T, d_in], with any leading slot dims."""
        mesh = self.mesh
        s = mesh.shards
        if T % s:
            raise ValueError(
                f"T={T} tokens must divide over {s} sequence shards"
            )
        Tl = T // s
        lo = mesh.axis_index * Tl
        h_l = tokens[..., lo:lo + Tl, :] @ params["embed"]  # [..., n, Tl, m]
        q = self._heads(h_l @ params["wq"])  # [..., n, Tl, H, dh]
        k = self._heads(h_l @ params["wk"])
        v = self._heads(h_l @ params["wv"])
        if self.sp_form == "ulysses":
            # one all-to-all to head-sharded full sequences and back
            # (ulysses_attention_shard checks n_heads % axis size)
            a_l = ulysses_attention_shard(q, k, v, mesh=mesh)
        else:
            # the ring per row and head: [..., n, H, Tl, dh]
            a_l = ring_attention_shard(
                q.transpose(-3, -2), k.transpose(-3, -2), v.transpose(-3, -2), mesh=mesh
            ).transpose(-3, -2)
        pooled = mesh.axis_psum((h_l + self._merge(a_l)).sum(dim=-2)) / T  # [..., n, m]
        return pooled @ params["w_out"] + params["b_out"]
