"""Deep MLP classifier: erasurehead_tpu/models/deep_mlp.py.

An input projection F -> H, then ``n_layers`` hidden tanh transforms H -> H
stacked as one [L, H, H] leaf, then a linear head; logistic loss on the
margin (models/glm.MarginClassifierBase).

``pp_axis`` composes pipeline parallelism with the coded DP on a 2-D
(workers, pipe) mesh (``pp_shards``): the layers split contiguously over
the stages of the pipe axis, and a GPipe schedule streams M microbatches of
each slot's rows through them in M + p - 1 steps. At step t stage i holds
the activations of microbatch t - i: a one-hop shift hands each stage's
output to its successor (mesh.WorkerMesh.axis_shift, non-cyclic: stage 0
receives zeros), stage 0 injects microbatch t, and the last stage emits the
margins of microbatch t - (p - 1), which are summed over the axis so every
stage holds them. Every stage runs every step's ops, as the JAX package's
SPMD program does, and selects with ``torch.where``: the ranks build the same
graph. Params stay replicated (each stage applies only its layers).
"""

from __future__ import annotations

import numpy as np
import torch

from erasurehead_tpu_torch.models.glm import MarginClassifierBase, normal_init
from erasurehead_tpu_torch.ops.features import matvec

PIPE_AXIS = "pipe"


class DeepMLPModel(MarginClassifierBase):
    name = "deepmlp"
    # per-layer gradient coding (ops/blocks.py): the stacked [L, H, H] hidden
    # transforms and their biases split along the layer axis, so each hidden
    # layer's gradient is its own coded block
    block_split_leaves = ("W", "b")

    def __init__(self, hidden: int = 32, n_layers: int = 4,
                 microbatches: int = 0, pp_axis: str | None = None, mesh=None):
        self.hidden = hidden
        self.n_layers = n_layers
        self.microbatches = microbatches  # 0: the pipe axis size (one a stage)
        # when set, predict runs on a rank of ``mesh``, whose model-internal
        # axis is this one (the trainer's for_mesh hook arranges it)
        self.pp_axis = pp_axis
        self.mesh = mesh

    def for_mesh(self, mesh):
        """Trainer hook: a pipeline-parallel copy when the mesh has a pipe
        axis (scoped to step construction; eval replay stays unsharded)."""
        from erasurehead_tpu_torch.parallel.mesh import axis_active

        if axis_active(mesh, PIPE_AXIS):
            return DeepMLPModel(self.hidden, self.n_layers, self.microbatches,
                                pp_axis=PIPE_AXIS, mesh=mesh)
        return self

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
        if self.pp_axis is not None:
            return self._predict_pp(params, X)
        h = torch.tanh(matvec(X, params["W_in"]) + params["b_in"])
        for j in range(self.n_layers):
            h = torch.tanh(h @ params["W"][j] + params["b"][j])
        return h @ params["w_out"] + params["b_out"]

    def _predict_pp(self, params, X):
        """GPipe-schedule forward over the pipe axis (module docstring). X is
        [..., n, F], n a slot's rows: each slot's rows split into M
        microbatches. The input projection runs up front on the whole batch
        on every stage (only stage 0's is used), so sparse stacks stay out
        of the microbatch indexing; the pipeline streams dense activations."""
        mesh = self.mesh
        p, i = mesh.shards, mesh.axis_index
        L = self.n_layers
        if L % p:
            raise ValueError(f"n_layers={L} must divide over {p} pp stages")
        per_stage = L // p
        n = X.shape[-2]
        M = self.microbatches or p
        if n % M:
            raise ValueError(f"{n} rows must divide into {M} pipeline microbatches")
        mb, H = n // M, self.hidden
        h = torch.tanh(matvec(X, params["W_in"]) + params["b_in"])  # [..., n, H]
        lead = tuple(h.shape[:-2])
        Hmb = h.reshape(*lead, M, mb, H)
        first = torch.tensor(i == 0, device=h.device)
        last = torch.tensor(i == p - 1, device=h.device)
        zeros = h.new_zeros(lead + (mb, H))

        act, outs = zeros, []
        for t in range(M + p - 1):
            # the previous step's activations move one stage on; stage 0 has
            # no predecessor and receives zeros
            received = mesh.axis_shift(act, cyclic=False)
            inject = Hmb[..., t, :, :] if t < M else zeros
            x_in = torch.where(first, inject, received)
            for j in range(i * per_stage, (i + 1) * per_stage):
                x_in = torch.tanh(x_in @ params["W"][j] + params["b"][j])
            act = x_in
            if t >= p - 1:  # microbatch t - (p - 1) leaves the last stage
                outs.append(act @ params["w_out"] + params["b_out"])  # [..., mb]
        out = torch.stack(outs, dim=-2)  # [..., M, mb]
        # the margins live on the last stage; the sum gives them to every stage
        margins = mesh.axis_psum(torch.where(last, out, torch.zeros_like(out)))
        return margins.reshape(*lead, n)
