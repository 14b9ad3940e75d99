"""The port's stacks, GLM models, dense products, metrics and optimizer
against the JAX package.

Stacks are host numpy gathers and must match bitwise. Device numerics are
float32 on both sides with products at full precision (HIGHEST in JAX, TF32
off here) but reduced in different orders, so they match to float32
reduction tolerance: rtol 1e-5 (atol 1e-5 where values can cross zero).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erasurehead_tpu.data import sharding as j_sharding
from erasurehead_tpu.models import glm as j_glm
from erasurehead_tpu.models import metrics as j_metrics
from erasurehead_tpu.ops import codes as j_codes
from erasurehead_tpu.ops import features as j_features
from erasurehead_tpu.train import optimizer as j_opt
from erasurehead_tpu_torch.data import sharding as t_sharding
from erasurehead_tpu_torch.data.synthetic import generate_gmm
from erasurehead_tpu_torch.models import glm as t_glm
from erasurehead_tpu_torch.models import metrics as t_metrics
from erasurehead_tpu_torch.ops import codes as t_codes
from erasurehead_tpu_torch.ops import features as t_features
from erasurehead_tpu_torch.train import optimizer as t_opt
from erasurehead_tpu_torch.utils.device import pin_float32_precision

pin_float32_precision()
RTOL, ATOL = 1e-5, 1e-5


def _data(n, F, seed, linear=False):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, F)).astype(np.float32)
    if linear:
        y = rng.standard_normal(n).astype(np.float32)
    else:
        y = np.sign(rng.standard_normal(n)).astype(np.float32)
    beta = (0.3 * rng.standard_normal(F)).astype(np.float32)
    return X, y, beta


@pytest.mark.parametrize("layout_name", ["frc", "cyclic", "uncoded"])
@pytest.mark.parametrize("W,s", [(6, 2), (12, 3)])
def test_partition_and_worker_stacks_bitwise(layout_name, W, s):
    ds = generate_gmm(W * 10, 17, W, seed=W)
    # three extra rows: the ragged tail that stacking drops
    ds.X_train = np.concatenate([ds.X_train, ds.X_train[:3]])
    ds.y_train = np.concatenate([ds.y_train, ds.y_train[:3]])
    # the JAX package's stacking reads only these four fields
    import erasurehead_tpu.data.synthetic as j_syn

    jds = j_syn.Dataset(ds.X_train, ds.y_train, ds.X_test, ds.y_test)
    layouts = {
        "frc": (j_codes.frc_layout(W, s), t_codes.frc_layout(W, s)),
        "cyclic": (j_codes.cyclic_mds_layout(W, s), t_codes.cyclic_mds_layout(W, s)),
        "uncoded": (j_codes.uncoded_layout(W), t_codes.uncoded_layout(W)),
    }
    jl, tl = layouts[layout_name]
    jXp, jyp = j_sharding.partition_stack(jds, jl.n_partitions)
    tXp, typ = t_sharding.partition_stack(ds, tl.n_partitions)
    jXw, jyw = j_sharding.worker_stack(jl, jXp, jyp)
    tXw, tyw = t_sharding.worker_stack(tl, tXp, typ)
    for got, want in ((tXp, jXp), (typ, jyp), (tXw, jXw), (tyw, jyw)):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


MODELS = [
    ("logistic", j_glm.LogisticModel, t_glm.LogisticModel, False),
    ("linear", j_glm.LinearModel, t_glm.LinearModel, True),
]


@pytest.mark.parametrize("name,JM,TM,linear", MODELS)
@pytest.mark.parametrize("n,F", [(64, 8), (300, 33)])
def test_glm_grad_and_loss_match(name, JM, TM, linear, n, F):
    X, y, beta = _data(n, F, n + F, linear)
    jm, tm = JM(), TM()
    jargs = (jnp.asarray(beta), jnp.asarray(X), jnp.asarray(y))
    targs = (torch.from_numpy(beta), torch.from_numpy(X), torch.from_numpy(y))
    for fn in ("grad_sum", "loss_sum", "loss_mean", "predict"):
        want = np.asarray(getattr(jm, fn)(*jargs[: 2 if fn == "predict" else 3]))
        got = getattr(tm, fn)(*targs[: 2 if fn == "predict" else 3]).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=fn)
    m = X @ beta
    np.testing.assert_allclose(
        tm.margin_residual(torch.from_numpy(m), torch.from_numpy(y)).numpy(),
        np.asarray(jm.margin_residual(jnp.asarray(m), jnp.asarray(y))),
        rtol=RTOL, atol=ATOL,
    )


def test_batched_grad_sum_is_per_slot_grad():
    """A [W, S, rows, F] stack gives one gradient per slot, as the JAX
    package's vmapped grad_sum does."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((3, 2, 10, 5)).astype(np.float32)
    y = np.sign(rng.standard_normal((3, 2, 10))).astype(np.float32)
    beta = rng.standard_normal(5).astype(np.float32)
    got = t_glm.LogisticModel().grad_sum(
        torch.from_numpy(beta), torch.from_numpy(X), torch.from_numpy(y)
    ).numpy()
    jm = j_glm.LogisticModel()
    for w in range(3):
        for s in range(2):
            want = np.asarray(
                jm.grad_sum(jnp.asarray(beta), jnp.asarray(X[w, s]), jnp.asarray(y[w, s]))
            )
            np.testing.assert_allclose(got[w, s], want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,F", [(50, 7), (129, 64)])
def test_dense_matvec_rmatvec_match(n, F):
    X, r, v = _data(n, F, 11)
    np.testing.assert_allclose(
        t_features.matvec(torch.from_numpy(X), torch.from_numpy(v)).numpy(),
        np.asarray(j_features.matvec(jnp.asarray(X), jnp.asarray(v))),
        rtol=RTOL, atol=ATOL,
    )
    np.testing.assert_allclose(
        t_features.rmatvec(torch.from_numpy(X), torch.from_numpy(r)).numpy(),
        np.asarray(j_features.rmatvec(jnp.asarray(X), jnp.asarray(r))),
        rtol=RTOL, atol=ATOL,
    )


@pytest.mark.parametrize("n", [40, 257])
def test_loss_metrics_match(n):
    rng = np.random.default_rng(n)
    y = np.sign(rng.standard_normal(n)).astype(np.float32)
    m = (3 * rng.standard_normal(n)).astype(np.float32)
    np.testing.assert_allclose(
        t_metrics.log_loss_mean(torch.from_numpy(y), torch.from_numpy(m)).item(),
        float(j_metrics.log_loss_mean(jnp.asarray(y), jnp.asarray(m))),
        rtol=RTOL,
    )
    np.testing.assert_allclose(
        t_metrics.mse_mean(torch.from_numpy(y), torch.from_numpy(m)).item(),
        float(j_metrics.mse_mean(jnp.asarray(y), jnp.asarray(m))),
        rtol=RTOL,
    )


@pytest.mark.parametrize("n,seed", [(31, 0), (200, 1), (1000, 2)])
def test_auc_equal_on_tie_free_scores(n, seed):
    rng = np.random.default_rng(seed)
    y = np.sign(rng.standard_normal(n)).astype(np.float32)
    scores = rng.permutation(n).astype(np.float32) / n  # distinct
    got = t_metrics.auc(torch.from_numpy(y), torch.from_numpy(scores))
    want = np.asarray(j_metrics.auc(jnp.asarray(y), jnp.asarray(scores)))
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()


def test_auc_midranks_on_ties():
    y = np.array([1, -1, 1, -1, 1, -1], np.float32)
    scores = np.array([0.5, 0.5, 0.9, 0.1, 0.5, 0.9], np.float32)
    got = t_metrics.auc(torch.from_numpy(y), torch.from_numpy(scores)).item()
    want = float(j_metrics.auc(jnp.asarray(y), jnp.asarray(scores)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("rule", ["GD", "AGD", "ADAM"])
def test_optimizer_updates_match(rule):
    rng = np.random.default_rng(5)
    p0 = rng.standard_normal(9).astype(np.float32)
    gs = rng.standard_normal((4, 9)).astype(np.float32)
    jstate = j_opt.init_state(jnp.asarray(p0), rule)
    tstate = t_opt.init_state(torch.from_numpy(p0), rule)
    jup, tup = j_opt.make_update_fn(rule), t_opt.make_update_fn(rule)
    for i, g in enumerate(gs):
        eta = np.float32(0.5 / (i + 1))
        jstate = jup(jstate, jnp.asarray(g), jnp.float32(eta), 0.01, 100, jnp.float32(i))
        tstate = tup(tstate, torch.from_numpy(g), float(eta), 0.01, 100, float(i))
        np.testing.assert_allclose(
            tstate.params.numpy(), np.asarray(jstate.params), rtol=RTOL, atol=1e-6
        )
