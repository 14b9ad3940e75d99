"""Two-layer MLP classifier: erasurehead_tpu/models/mlp.py.

margins = tanh(X W1 + b1) @ w2 + b2, labels in {-1, +1}, logistic loss on the
margin (models/glm.MarginClassifierBase). Params are a dict of tensors;
gradients are autodiff of the summed loss.

``tp_axis`` composes tensor parallelism with the coded DP on a 2-D
(workers, model) mesh (parallel/mesh.worker_tp_mesh, ``tp_shards``): the
Megatron split of a 2-layer block. Each member of the model axis takes its
column block of W1 and b1, applies the tanh to its hidden slice (elementwise,
so the split is exact) and its row block of w2; the partial margins are
summed over the axis (mesh.WorkerMesh.axis_psum), so every member holds the
same margins. Params stay replicated; the step takes one backward pass of the
weighted loss of all the rank's slots (parallel/step.py).
"""

from __future__ import annotations

import numpy as np
import torch

from erasurehead_tpu_torch.models.glm import MarginClassifierBase, normal_init
from erasurehead_tpu_torch.ops.features import matvec


class MLPModel(MarginClassifierBase):
    name = "mlp"

    def __init__(self, hidden: int = 64, tp_axis: str | None = None, mesh=None):
        self.hidden = hidden
        # when set, predict runs on a rank of ``mesh``, whose model-internal
        # axis is this one (the trainer's for_mesh hook arranges it)
        self.tp_axis = tp_axis
        self.mesh = mesh

    def for_mesh(self, mesh):
        """Trainer hook: a tensor-parallel copy when the mesh has a model
        axis, self otherwise (scoped to step construction; eval replay
        stays unsharded)."""
        from erasurehead_tpu_torch.parallel.mesh import MODEL_AXIS, axis_active

        if axis_active(mesh, MODEL_AXIS):
            return MLPModel(self.hidden, tp_axis=MODEL_AXIS, mesh=mesh)
        return self

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
        if self.tp_axis is not None:
            return self._predict_tp(params, X)
        h = torch.tanh(matvec(X, params["W1"]) + params["b1"])
        return matvec(h, params["w2"]) + params["b2"]

    def _predict_tp(self, params, X):
        """Tensor-parallel forward: this member computes its hidden slice
        only; the partial margins are summed over the model axis. X may
        carry leading slot dims ([..., n, F])."""
        mesh = self.mesh
        p = mesh.shards
        H = params["b1"].shape[0]
        if H % p:
            raise ValueError(f"hidden={H} must divide over {p} tp shards")
        Hl = H // p
        cols = slice(mesh.axis_index * Hl, (mesh.axis_index + 1) * Hl)
        h_l = torch.tanh(matvec(X, params["W1"][:, cols]) + params["b1"][cols])
        return mesh.axis_psum(matvec(h_l, params["w2"][cols])) + params["b2"]
