"""The port's mlp, deepmlp and moe families against the JAX package's.

Params are the JAX family's own draw, carried across as numpy
(models/glm.params_from_numpy); data is made with numpy from a seed. The
forward pass, the summed loss and the autodiff gradient must agree to
rtol 1e-5, atol 1e-6: float32 products and sums taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erasurehead_tpu.models.deep_mlp import DeepMLPModel as JDeepMLP
from erasurehead_tpu.models.mlp import MLPModel as JMLP
from erasurehead_tpu.models.moe import MoEModel as JMoE
from erasurehead_tpu_torch.models.deep_mlp import DeepMLPModel
from erasurehead_tpu_torch.models.glm import params_from_numpy
from erasurehead_tpu_torch.models.mlp import MLPModel
from erasurehead_tpu_torch.models.moe import MoEModel
from erasurehead_tpu_torch.ops import blocks

RTOL, ATOL = 1e-5, 1e-6
N, F = 40, 24

FAMILIES = {
    "mlp": (lambda: JMLP(hidden=8), lambda: MLPModel(hidden=8)),
    "deepmlp": (lambda: JDeepMLP(hidden=8, n_layers=3), lambda: DeepMLPModel(hidden=8, n_layers=3)),
    "moe": (lambda: JMoE(hidden=6, n_experts=3), lambda: MoEModel(hidden=6, n_experts=3)),
}


def _setup(name, seed=0, x_scale=1.0):
    j_make, t_make = FAMILIES[name]
    jm, tm = j_make(), t_make()
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.key(seed), F))
    rng = np.random.default_rng(seed + 11)
    X = (rng.standard_normal((N, F)) * x_scale).astype(np.float32)
    y = np.sign(rng.standard_normal(N)).astype(np.float32)
    return jm, tm, jp, X, y


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_predict_and_loss_match_jax(name):
    jm, tm, jp, X, y = _setup(name)
    tp = params_from_numpy(jp)
    want = np.asarray(jm.predict(_j(jp), jnp.asarray(X)))
    got = tm.predict(tp, torch.from_numpy(X))
    assert tuple(got.shape) == (N,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    for fn in ("loss_sum", "loss_mean"):
        want = float(getattr(jm, fn)(_j(jp), jnp.asarray(X), jnp.asarray(y)))
        got = float(getattr(tm, fn)(tp, torch.from_numpy(X), torch.from_numpy(y)))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_grad_sum_matches_jax(name):
    jm, tm, jp, X, y = _setup(name, seed=1)
    want = jm.grad_sum(_j(jp), jnp.asarray(X), jnp.asarray(y))
    got = tm.grad_sum(params_from_numpy(jp), torch.from_numpy(X), torch.from_numpy(y))
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == np.shape(want[k]), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, atol=ATOL, err_msg=k)


def test_loss_is_jax_softplus_at_large_margins():
    """Margins of +-60 (beyond torch softplus's threshold of 20): the loss
    is logaddexp(0, z), as jax.nn.softplus computes it."""
    jm, tm, jp, X, y = _setup("mlp", seed=2, x_scale=200.0)
    want = float(jm.loss_sum(_j(jp), jnp.asarray(X), jnp.asarray(y)))
    got = float(tm.loss_sum(params_from_numpy(jp), torch.from_numpy(X), torch.from_numpy(y)))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_own_init_has_the_jax_shapes_and_scales(name):
    """The port's numpy draw cannot reproduce threefry, but it has the JAX
    family's keys, shapes and zero leaves, and the same scale."""
    jm, tm, jp, _, _ = _setup(name)
    tp = tm.init_params(0, F)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == np.shape(jp[k]) and tp[k].dtype == torch.float32, k
        if not np.any(jp[k]):
            assert not tp[k].any(), k
        else:
            ratio = float(tp[k].std()) / float(np.std(jp[k]))
            assert 0.5 < ratio < 2.0, (k, ratio)
    again = tm.init_params(0, F)
    for a, b in zip(blocks.tree_leaves(tp), blocks.tree_leaves(again)):
        assert torch.equal(a, b)
