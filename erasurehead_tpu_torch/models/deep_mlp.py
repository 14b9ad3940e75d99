"""Deep MLP classifier, the unsharded form of erasurehead_tpu/models/deep_mlp.py.

An input projection F -> H, then ``n_layers`` hidden tanh transforms H -> H
stacked as one [L, H, H] leaf, then a linear head; logistic loss on the
margin (models/glm.MarginClassifierBase). The pipeline-parallel form
(``pp_axis``, the GPipe schedule) is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from erasurehead_tpu_torch.models.glm import MarginClassifierBase, normal_init
from erasurehead_tpu_torch.ops.features import matvec


class DeepMLPModel(MarginClassifierBase):
    name = "deepmlp"
    # per-layer gradient coding (ops/blocks.py): the stacked [L, H, H] hidden
    # transforms and their biases split along the layer axis, so each hidden
    # layer's gradient is its own coded block
    block_split_leaves = ("W", "b")

    def __init__(self, hidden: int = 32, n_layers: int = 4):
        self.hidden = hidden
        self.n_layers = n_layers

    def init_params(self, seed: int, n_features: int, device="cpu"):
        """The JAX package's scales from a numpy draw (glm.normal_init)."""
        H, L = self.hidden, self.n_layers
        return normal_init(seed, {
            "W_in": ((n_features, H), 1.0 / np.sqrt(n_features)),
            "b_in": ((H,), 0.0),
            "W": ((L, H, H), 1.0 / np.sqrt(H)),
            "b": ((L, H), 0.0),
            "w_out": ((H,), 1.0 / np.sqrt(H)),
            "b_out": ((), 0.0),
        }, device)

    def predict(self, params, X):
        h = torch.tanh(matvec(X, params["W_in"]) + params["b_in"])
        for j in range(self.n_layers):
            h = torch.tanh(h @ params["W"][j] + params["b"][j])
        return h @ params["w_out"] + params["b_out"]
