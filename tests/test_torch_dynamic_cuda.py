"""Card-side pins of the on-device and measured trainers: ``train_dynamic``'s
round loop makes no host synchronisation on the table-decoded and rescaling
schemes (it runs under ``torch.cuda.set_sync_debug_mode("error")``), launches
the fused GLM kernel once a round and follows the CPU run; ``train_measured``
excludes workers given real extra compute (a work multiplier) on the card's
own clock, and decodes with one launch of the decode kernel a round. Every
test is marked ``cuda`` and skips without a card.

The module imports the port only, so that it also runs where the JAX
package is not installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_dynamic_cuda.py``.
"""

import numpy as np
import pytest
import torch

from erasurehead_tpu_torch.data import synthetic as t_syn
from erasurehead_tpu_torch.ops import kernels as t_kernels
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils import config as t_config

W, ROUNDS, N_ROWS, N_COLS = 12, 10, 12 * 400, 64


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _cfg(scheme, **kw):
    base = dict(scheme=scheme, n_workers=W, n_stragglers=2, rounds=ROUNDS, n_rows=N_ROWS,
                n_cols=N_COLS, update_rule="AGD", lr_schedule=1.0, add_delay=True, seed=0)
    base.update(kw)
    return t_config.RunConfig(**base)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme,kw", [
    ("approx", dict(num_collect=8)), ("cyccoded", {}), ("avoidstragg", {}),
    ("deadline", dict(deadline=0.5)), ("partialcyccoded", dict(partitions_per_worker=4)),
    ("partialrepcoded", dict(partitions_per_worker=4)), ("randreg", dict(num_collect=8)),
])
def test_dynamic_loop_is_sync_free_and_follows_the_cpu(scheme, kw):
    _card()
    cfg = _cfg(scheme, **kw)
    P = W * (cfg.partitions_per_worker - cfg.n_stragglers) if cfg.partitions_per_worker else W
    ds = t_syn.generate_gmm(N_ROWS, N_COLS, P, seed=0)
    t_kernels.reset_launches()
    gpu = t_trainer.train_dynamic(cfg, ds, _sync_debug_mode="error")
    assert t_kernels.LAUNCHES == {"fused_glm_grad": ROUNDS, "fused_block_decode": 0}
    cpu = t_trainer.train_dynamic(cfg, ds, device="cpu")
    np.testing.assert_array_equal(gpu.collected, cpu.collected)
    np.testing.assert_allclose(gpu.timeset, cpu.timeset, rtol=1e-6)
    np.testing.assert_allclose(gpu.params_history.cpu().numpy(), cpu.params_history.numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_dynamic_layer_coded_decodes_once_a_round():
    _card()
    cfg = _cfg("approx", num_collect=8, model="deepmlp", update_rule="GD", lr_schedule=0.5,
               layer_coding="on")
    ds = t_syn.generate_gmm(N_ROWS, N_COLS, W, seed=0)
    t_kernels.reset_launches()
    t_trainer.train_dynamic(cfg, ds, _sync_debug_mode="error")
    assert t_kernels.LAUNCHES == {"fused_glm_grad": 0, "fused_block_decode": ROUNDS}


@pytest.mark.cuda
def test_measured_real_clock_excludes_the_slow_workers():
    _card()
    cfg = _cfg("avoidstragg", add_delay=False, rounds=6)
    ds = t_syn.generate_gmm(N_ROWS, N_COLS, W, seed=0)
    mult = np.ones(W, dtype=np.int64)
    mult[:2] = 400
    t_kernels.reset_launches()
    res = t_trainer.train_measured(cfg, ds, work_multiplier=mult)
    assert t_kernels.LAUNCHES == {"fused_glm_grad": 0, "fused_block_decode": 6}
    slow_out = (res.worker_times[:, :2] == -1.0).all(axis=1)
    assert slow_out.sum() > 3, res.worker_times
    assert res.collected[slow_out][:, 2:].all()
    assert (res.timeset > 0).all()
