"""Single-block attention classifier, the unsharded form of
erasurehead_tpu/models/attention.py.

Each data row is a sequence: the flat feature vector [F] reshapes to
[T, d_in] with T = F // d_in tokens. An embedding to d_model, one
multi-head self-attention block (parallel/ring.reference_attention per
head), a residual, a mean pool over the tokens and a logistic head give the
margin; logistic loss on it (models/glm.MarginClassifierBase), gradients by
autodiff. Its summed loss is additive over row shards, so it trains under
the same gradient-coding protocol as every other family, layer-coded too:
its six leaves are six coded blocks.

The sequence-parallel forms of the JAX package (``seq_axis``: ring or
Ulysses attention over a mesh axis) are not ported: ``sp_form`` is
validated and kept, ``seq_axis`` is always None (the constructor takes
none) and :meth:`for_mesh` returns the model itself.
"""

from __future__ import annotations

import numpy as np
import torch

from erasurehead_tpu_torch.models.glm import MarginClassifierBase, normal_init
from erasurehead_tpu_torch.ops.features import FieldOnehot, PaddedRows
from erasurehead_tpu_torch.parallel.ring import reference_attention


class AttentionModel(MarginClassifierBase):
    name = "attention"

    def __init__(
        self,
        d_in: int = 8,
        d_model: int = 16,
        n_heads: int = 2,
        sp_form: str = "ring",
    ):
        if d_model % n_heads:
            raise ValueError(f"{d_model=} must be divisible by {n_heads=}")
        if sp_form not in ("ring", "ulysses"):
            raise ValueError(f"sp_form must be ring/ulysses, got {sp_form!r}")
        self.d_in = d_in
        self.d_model = d_model
        self.n_heads = n_heads
        self.seq_axis = None  # no sequence axis on one device
        self.sp_form = sp_form

    def for_mesh(self, mesh):
        """The JAX trainer's hook for a sequence-parallel copy: one device
        has no sequence axis, so the model itself."""
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
