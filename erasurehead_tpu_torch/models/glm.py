"""Convex GLM models: logistic regression and least-squares linear regression.

The reference's two model families: a dense parameter vector ``beta`` trained
by (accelerated) gradient descent on row-sharded data. Gradients follow the
reference's *sum* (not mean) convention, so per-partition gradients add
linearly, which is what makes "message = linear combination of partition
gradients" work. Same closed forms as erasurehead_tpu/models/glm.py:

  - logistic gradient  -X^T (y / (exp((X beta) * y) + 1))  (src/naive.py:137-139)
  - linear gradient    -2 X^T (y - X beta)                 (src/naive.py:341-346)
  - logistic loss      sum softplus(-y * X beta)           (src/util.py:136-137)
  - squared loss       sum (y - X beta)^2                  (src/util.py:139-141)

X may carry leading batch dimensions ([..., n, F] with y [..., n]); the
gradient then comes back per batch entry ([..., F]). X is a dense tensor or
a sparse stack (ops/features.PaddedRows, FieldOnehot): every product goes
through ``features.matvec``/``rmatvec``, as does the first layer of the mlp,
deepmlp and moe families.

:class:`MarginClassifierBase` is the shared loss of the non-GLM classifier
families (models/mlp.py, deep_mlp.py, moe.py): softplus loss on ``predict``'s
margin, gradients by autodiff (``torch.func.grad``).

Deviation from the JAX package: :meth:`init_params` draws from a seeded
``torch.Generator``, which cannot reproduce JAX's threefry ``jax.random.normal``
draw. Runs that must start where a JAX run starts pass its draw to
``train.trainer.train(init_params=...)``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F_nn

from erasurehead_tpu_torch.ops.features import matvec, rmatvec


def params_from_numpy(tree, device="cpu"):
    """A params tree of numpy arrays as the port's tensors (float32, on
    ``device``): a dict maps key by key, anything else is one tensor. This
    carries a JAX run's draw across (``np.asarray`` of each leaf), and the
    port's own numpy-seeded inits go through it too."""

    def one(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    if isinstance(tree, dict):
        return {k: one(v) for k, v in tree.items()}
    return one(tree)


def normal_init(seed: int, shapes: dict, device="cpu"):
    """Params from ``shapes``, which maps key -> (shape, scale): standard
    normal times the scale, or zeros where the scale is 0. One numpy
    Generator draws the leaves in the dict's order.

    Deviation from the JAX package: its families draw from threefry keys,
    which numpy cannot reproduce; the scales are the same. Runs that must
    start where a JAX run starts pass its draw to
    ``train.trainer.train(init_params=...)``."""
    rng = np.random.default_rng(int(seed))
    out = {}
    for key, (shape, scale) in shapes.items():
        out[key] = (
            rng.standard_normal(shape) * scale if scale else np.zeros(shape)
        )
    return params_from_numpy(out, device)


class MarginClassifierBase:
    """Logistic-margin loss of the non-GLM classifier families (the JAX
    package's models/glm.py::MarginClassifierBase): params are a dict of
    tensors, ``predict`` maps one [n, F] batch to [n] margins, labels are in
    {-1, +1}.

    ``grads_via_loss``: the gradient is autodiff of the summed loss, not a
    closed form, so the step takes the monolithic path's gradient as one
    ``torch.func.grad`` of the weighted loss (parallel/step.py)."""

    grads_via_loss = True

    # the mesh of a model-internal axis (the families' for_mesh copies set it)
    mesh = None

    def row_losses(self, params, X, y):
        """Every row's loss, [..., n]: the terms :meth:`loss_sum` adds."""
        # logaddexp(0, z) is jax.nn.softplus; torch's softplus switches to
        # the identity above its threshold (20) and differs there
        z = -y * self.predict(params, X)
        return torch.logaddexp(torch.zeros_like(z), z)

    def loss_sum(self, params, X, y):
        return self.row_losses(params, X, y).sum()

    def loss_mean(self, params, X, y):
        return self.loss_sum(params, X, y) / y.shape[0]

    def grad_sum(self, params, X, y):
        """Gradient of the summed loss. On a rank of a model-internal axis
        (``mesh`` set) the forward runs collectives, which ``torch.func``
        cannot trace: the JAX package's standalone recipe instead, one
        backward pass of the loss scaled by 1/axis size, then every leaf
        summed over the axis (leaves the axis replicates arrive whole on
        each member and the sum undoes the scaling; leaves it splits arrive
        as member slices and the sum assembles them)."""
        if self.mesh is None:
            return torch.func.grad(self.loss_sum)(params, X, y)
        keys = sorted(params)
        with torch.enable_grad():
            live = {k: params[k].detach().requires_grad_() for k in keys}
            loss = self.loss_sum(live, X, y) / self.mesh.shards
            grads = torch.autograd.grad(loss, [live[k] for k in keys],
                                        materialize_grads=True)
        return {k: self.mesh._axis_all_reduce(g) for k, g in zip(keys, grads)}


class _GLMBase:
    def init_params(
        self, seed: int, n_features: int, device="cpu"
    ) -> torch.Tensor:
        """Standard-normal float32 init from a seeded torch.Generator."""
        gen = torch.Generator().manual_seed(int(seed))
        return torch.randn(n_features, generator=gen).to(device)

    def predict(self, params, X):
        return matvec(X, params)

    def loss_mean(self, params, X, y):
        return self.loss_sum(params, X, y) / y.shape[-1]


class LogisticModel(_GLMBase):
    """Binary logistic regression with labels in {-1, +1}."""

    name = "logistic"

    def margin_residual(self, margins, y):
        """r such that grad_sum = -X^T r, written the reference's way:
        y / (exp(m*y) + 1)  (src/naive.py:137-139)."""
        return y / (torch.exp(margins * y) + 1.0)

    def grad_sum(self, params, X, y):
        r = self.margin_residual(matvec(X, params), y)
        return -rmatvec(X, r)

    def loss_sum(self, params, X, y):
        # softplus rather than the reference's literal log(1+exp(.)), which
        # overflows float32 for large negative margins
        return F_nn.softplus(-y * matvec(X, params)).sum(-1)


class LinearModel(_GLMBase):
    """Least-squares linear regression (kc_house_data task)."""

    name = "linear"

    def margin_residual(self, margins, y):
        """r such that grad_sum = -X^T r: 2 (y - X beta)."""
        return 2.0 * (y - margins)

    def grad_sum(self, params, X, y):
        r = self.margin_residual(matvec(X, params), y)
        return -rmatvec(X, r)

    def loss_sum(self, params, X, y):
        resid = y - matvec(X, params)
        return (resid**2).sum(-1)
