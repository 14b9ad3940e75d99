"""Two-layer MLP classifier, the unsharded form of erasurehead_tpu/models/mlp.py.

margins = tanh(X W1 + b1) @ w2 + b2, labels in {-1, +1}, logistic loss on the
margin (models/glm.MarginClassifierBase). Params are a dict of tensors;
gradients are autodiff of the summed loss. The tensor-parallel form
(``tp_axis``) is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from erasurehead_tpu_torch.models.glm import MarginClassifierBase, normal_init
from erasurehead_tpu_torch.ops.features import matvec


class MLPModel(MarginClassifierBase):
    name = "mlp"

    def __init__(self, hidden: int = 64):
        self.hidden = hidden

    def init_params(self, seed: int, n_features: int, device="cpu"):
        """The JAX package's scales from a numpy draw (glm.normal_init)."""
        H = self.hidden
        return normal_init(seed, {
            "W1": ((n_features, H), 1.0 / np.sqrt(n_features)),
            "b1": ((H,), 0.0),
            "w2": ((H,), 1.0 / np.sqrt(H)),
            "b2": ((), 0.0),
        }, device)

    def predict(self, params, X):
        h = torch.tanh(matvec(X, params["W1"]) + params["b1"])
        return matvec(h, params["w2"]) + params["b2"]
