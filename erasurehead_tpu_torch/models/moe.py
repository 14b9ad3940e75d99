"""Mixture-of-experts classifier, the unsharded form of erasurehead_tpu/models/moe.py.

``n_experts`` small tanh expert MLPs stacked on a leading expert axis and a
softmax gate: margins = sum_e gate_e(x) * expert_e(x), the dense ("soft")
form, with logistic loss on the margin (models/glm.MarginClassifierBase).
The expert-parallel form (``ep_axis``) is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from erasurehead_tpu_torch.models.glm import MarginClassifierBase, normal_init
from erasurehead_tpu_torch.ops.features import matvec


class MoEModel(MarginClassifierBase):
    name = "moe"
    # per-layer gradient coding (ops/blocks.py): every expert-stacked leaf
    # splits along the expert axis, so each expert's gradient shard is its
    # own coded block; the gate stays one block
    block_split_leaves = ("W1", "b1", "w2", "b2")

    def __init__(self, hidden: int = 16, n_experts: int = 4):
        self.hidden = hidden
        self.n_experts = n_experts

    def init_params(self, seed: int, n_features: int, device="cpu"):
        """The JAX package's scales from a numpy draw (glm.normal_init)."""
        E, H = self.n_experts, self.hidden
        return normal_init(seed, {
            "W1": ((E, n_features, H), 1.0 / np.sqrt(n_features)),
            "b1": ((E, H), 0.0),
            "w2": ((E, H), 1.0 / np.sqrt(H)),
            "b2": ((E,), 0.0),
            "Wg": ((n_features, E), 1.0 / np.sqrt(n_features)),
            "bg": ((E,), 0.0),
        }, device)

    def predict(self, params, X):
        gate = torch.softmax(matvec(X, params["Wg"]) + params["bg"], dim=1)
        margins = torch.stack([
            torch.tanh(matvec(X, params["W1"][e]) + params["b1"][e])
            @ params["w2"][e] + params["b2"][e]
            for e in range(self.n_experts)
        ], dim=1)  # [n, E]
        return (gate * margins).sum(dim=1)
