"""The port's sparse gradients on the card: each lowering's gradient
against its CPU result (rtol/atol 1e-5), a rerun the same bits (the
scatters sum in an order fixed once per stack, no atomics), and whole
sparse runs with no kernel launch. Every test is marked ``cuda`` and skips
without a card.

The module imports the port only, so that it also runs where the JAX
package is not installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_sparse_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from erasurehead_tpu_torch.data import sharding as t_sharding
from erasurehead_tpu_torch.data import synthetic as t_syn
from erasurehead_tpu_torch.ops import codes as t_codes
from erasurehead_tpu_torch.ops import features as tf
from erasurehead_tpu_torch.ops import kernels as t_kernels
from erasurehead_tpu_torch.parallel import step as t_step
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils import config as t_config

N_ROWS, N_COLS, W, FIELDS, ROUNDS = 600, 60, 6, 6, 5


@pytest.fixture(scope="module")
def tds():
    return t_syn.generate_onehot(N_ROWS, N_COLS, W, n_fields=FIELDS, seed=0)


def _kw(**kw):
    base = dict(
        scheme="approx", n_workers=W, n_stragglers=1, num_collect=4, rounds=ROUNDS,
        n_rows=N_ROWS, n_cols=N_COLS, update_rule="AGD", lr_schedule=1.0,
        add_delay=True, seed=0,
    )
    base.update(kw)
    return base


def _card_cases(tds):
    Xp, yp = t_sharding.partition_stack(tds, W, "padded")
    Xf, _ = t_sharding.partition_stack(tds, W, "fields")
    layout = t_codes.cyclic_mds_layout(W, 1)
    return layout, {"padded": Xp, "fields": Xf}, yp


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,knobs", [
    ("padded", {}), ("fields", dict(margin="tables", scatter="pairs")),
    ("fields", dict(margin="onehot", scatter="onehot")),
])
@pytest.mark.parametrize("flat", [False, True])
def test_cuda_sparse_gradients_match_cpu_and_rerun_bitwise(tds, fmt, knobs, flat):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's scatter order is what this checks")
    layout, stacks, yp = _card_cases(tds)
    Xw, yw = t_sharding.worker_stack(layout, stacks[fmt], yp)
    model = t_trainer.build_model(t_config.RunConfig(**_kw()))
    fn = t_step.make_flat_grad_fn(model) if flat else t_step.make_faithful_grad_fn(model)
    rng = np.random.default_rng(0)
    beta = torch.from_numpy(rng.standard_normal(N_COLS).astype(np.float32))
    w = torch.from_numpy(rng.random(Xw.shape[:2]).astype(np.float32))
    out = {}
    for dev in ("cpu", "cuda"):
        X = tf.to_device(Xw, dev, torch.float32)
        if fmt == "fields":
            X = X.with_lowering(**knobs)
        y = torch.from_numpy(np.asarray(yw, np.float32)).to(dev)
        out[dev] = [fn(beta.to(dev), X, y, w.to(dev)) for _ in range(2)]
    torch.testing.assert_close(out["cuda"][0].cpu(), out["cpu"][0], rtol=1e-5, atol=1e-5)
    assert torch.equal(out["cuda"][0], out["cuda"][1])


@pytest.mark.cuda
def test_cuda_sparse_runs_launch_no_kernel_and_rerun_bitwise(tds):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for fmt in ("padded", "fields"):
        cfg = t_config.RunConfig(**_kw(sparse_format=fmt))
        t_kernels.reset_launches()
        a, b = (t_trainer.train(cfg, tds) for _ in range(2))
        assert all(v == 0 for v in t_kernels.LAUNCHES.values())
        assert torch.equal(a.params_history, b.params_history)
        c = t_trainer.train(dataclasses.replace(cfg), tds, device="cpu")
        torch.testing.assert_close(a.params_history.cpu(), c.params_history, rtol=1e-4, atol=1e-5)
