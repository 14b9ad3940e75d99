"""Mixture-of-experts classifier: erasurehead_tpu/models/moe.py.

``n_experts`` small tanh expert MLPs stacked on a leading expert axis and a
softmax gate: margins = sum_e gate_e(x) * expert_e(x), the dense ("soft")
form, with logistic loss on the margin (models/glm.MarginClassifierBase).

``ep_axis`` composes expert parallelism with the coded DP on a 2-D
(workers, expert) mesh (``ep_shards``): each member of the expert axis
evaluates its contiguous block of experts, weighted by the replicated gate,
and the partial margins are summed over the axis (mesh.WorkerMesh.axis_psum),
so every member holds the same margins.
"""

from __future__ import annotations

import numpy as np
import torch

from erasurehead_tpu_torch.models.glm import MarginClassifierBase, normal_init
from erasurehead_tpu_torch.ops.features import matvec

EXPERT_AXIS = "expert"


class MoEModel(MarginClassifierBase):
    name = "moe"
    # per-layer gradient coding (ops/blocks.py): every expert-stacked leaf
    # splits along the expert axis, so each expert's gradient shard is its
    # own coded block; the gate stays one block
    block_split_leaves = ("W1", "b1", "w2", "b2")

    def __init__(self, hidden: int = 16, n_experts: int = 4,
                 ep_axis: str | None = None, mesh=None):
        self.hidden = hidden
        self.n_experts = n_experts
        # when set, predict runs on a rank of ``mesh``, whose model-internal
        # axis is this one (the trainer's for_mesh hook arranges it)
        self.ep_axis = ep_axis
        self.mesh = mesh

    def for_mesh(self, mesh):
        """Trainer hook: an expert-parallel copy when the mesh has an
        expert axis (scoped to step construction; eval stays unsharded)."""
        from erasurehead_tpu_torch.parallel.mesh import axis_active

        if axis_active(mesh, EXPERT_AXIS):
            return MoEModel(self.hidden, self.n_experts, ep_axis=EXPERT_AXIS, mesh=mesh)
        return self

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

    def _gate(self, params, X):
        return torch.softmax(matvec(X, params["Wg"]) + params["bg"], dim=-1)

    def predict(self, params, X):
        if self.ep_axis is not None:
            return self._predict_ep(params, X)
        gate = self._gate(params, X)
        margins = torch.stack([
            torch.tanh(matvec(X, params["W1"][e]) + params["b1"][e])
            @ params["w2"][e] + params["b2"][e]
            for e in range(self.n_experts)
        ], dim=1)  # [n, E]
        return (gate * margins).sum(dim=1)

    def _predict_ep(self, params, X):
        """Expert-parallel forward: this member evaluates only its block of
        experts; the gate-weighted partial margins are summed over the
        expert axis. X may carry leading slot dims ([..., n, F])."""
        mesh = self.mesh
        p = mesh.shards
        E = self.n_experts
        if E % p:
            raise ValueError(f"n_experts={E} must divide over {p} ep shards")
        per = E // p
        lo = mesh.axis_index * per
        gate_l = self._gate(params, X)[..., lo:lo + per]  # the gate is replicated
        margins_l = torch.stack([
            torch.tanh(matvec(X, params["W1"][e]) + params["b1"][e])
            @ params["w2"][e] + params["b2"][e]
            for e in range(lo, lo + per)
        ], dim=-1)  # [..., n, per]
        return mesh.axis_psum((gate_l * margins_l).sum(dim=-1))
