"""Card-side pins of the adaptive and elastic drivers: ``train_adaptive``
launches the fused GLM kernel once a round at the deduped stack whatever
arm a chunk runs, finds the first chunk's stack in the data cache on every
later chunk, and decides as its CPU run does under the telemetry-only
reward; ``train_elastic_online`` launches the kernel at the stack of each
epoch's worker set, a round a launch, and its layer-coded form the decode
kernel once a round, with the CPU run's decisions. Every test is marked
``cuda`` and skips without a card.

The module imports the port only, so that it also runs where the JAX
package is not installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_adapt_cuda.py``.
"""

import numpy as np
import pytest
import torch

from erasurehead_tpu_torch import adapt, elastic
from erasurehead_tpu_torch.data import synthetic as t_syn
from erasurehead_tpu_torch.ops import kernels as t_kernels
from erasurehead_tpu_torch.parallel import straggler
from erasurehead_tpu_torch.train import cache as t_cache
from erasurehead_tpu_torch.utils import config as t_config

W, ROUNDS, CHUNK, N_COLS = 12, 40, 5, 64
N_ROWS = W * 11 * 40  # divides by 12 and by the 11 survivors


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _cfg(**kw):
    base = dict(scheme="approx", n_workers=W, n_stragglers=1, num_collect=8, rounds=ROUNDS,
                n_rows=N_ROWS, n_cols=N_COLS, update_rule="AGD", lr_schedule=1.0,
                add_delay=True, seed=0)
    base.update(kw)
    return t_config.RunConfig(**base)


def _record_shapes(monkeypatch):
    shapes, orig = [], t_kernels.fused_glm_grad

    def wrapped(beta, X, y, w, kind="logistic"):
        shapes.append(tuple(X.shape))
        return orig(beta, X, y, w, kind)

    monkeypatch.setattr(t_kernels, "fused_glm_grad", wrapped)
    return shapes


@pytest.mark.cuda
def test_adaptive_launches_once_a_round_from_one_upload(monkeypatch):
    _card()
    cfg = _cfg(compute_mode="deduped")
    ds = t_syn.generate_gmm(N_ROWS, N_COLS, W, seed=0)
    shift = straggler.RegimeShift(kind="adversary", round=20, worker=0, slowdown=8.0)
    arr = straggler.arrival_schedule(ROUNDS, W, add_delay=True, regime=shift)
    ctl = adapt.ControllerConfig(chunk_rounds=CHUNK, reward_mode="time_error")
    shapes = _record_shapes(monkeypatch)
    t_cache.clear()
    t_kernels.reset_launches()
    gpu = adapt.train_adaptive(cfg, ds, controller=ctl, arrivals=arr)
    assert t_kernels.LAUNCHES == {"fused_glm_grad": ROUNDS, "fused_block_decode": 0}
    assert shapes == [(W, N_ROWS // W, N_COLS)] * ROUNDS
    stats = t_cache.stats()
    assert (stats.data_misses, stats.data_hits) == (1, ROUNDS // CHUNK - 1)
    cpu = adapt.train_adaptive(cfg, ds, controller=ctl, arrivals=arr, device="cpu")
    assert gpu.decisions == cpu.decisions
    assert gpu.result.timeset.tobytes() == cpu.result.timeset.tobytes()
    np.testing.assert_allclose(gpu.result.params_history.cpu().numpy(),
                               cpu.result.params_history.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_elastic_relays_the_kernel_onto_the_survivors(monkeypatch):
    _card()
    cfg = _cfg(n_stragglers=0, num_collect=None, scheme="naive")
    ds = t_syn.generate_gmm(N_ROWS, N_COLS, W, seed=0)
    ecfg = elastic.ElasticConfig(chunk_rounds=CHUNK, death_rounds=3, timeout=4.0)
    shapes = _record_shapes(monkeypatch)
    t_kernels.reset_launches()
    gpu = elastic.train_elastic_online(cfg, ds, elastic=ecfg, deaths={5: 7})
    assert t_kernels.LAUNCHES == {"fused_glm_grad": ROUNDS, "fused_block_decode": 0}
    relayout = gpu.epochs[1]["start_round"]
    assert shapes == [(W, N_ROWS // W, N_COLS)] * relayout + \
        [(W - 1, N_ROWS // (W - 1), N_COLS)] * (ROUNDS - relayout)
    assert (gpu.result.worker_times[relayout:, 5] == -1.0).all()
    cpu = elastic.train_elastic_online(cfg, ds, elastic=ecfg, deaths={5: 7}, device="cpu")
    assert gpu.decisions == cpu.decisions and gpu.epochs == cpu.epochs
    np.testing.assert_allclose(gpu.result.params_history.cpu().numpy(),
                               cpu.result.params_history.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_elastic_layer_coded_decodes_once_a_round():
    _card()
    cfg = _cfg(model="deepmlp", layer_coding="on", block_decode="fused", update_rule="GD",
               lr_schedule=0.5, rounds=20)
    ds = t_syn.generate_gmm(N_ROWS, N_COLS, W, seed=0)
    ecfg = elastic.ElasticConfig(chunk_rounds=10, death_rounds=2, timeout=4.0)
    t_kernels.reset_launches()
    res = elastic.train_elastic_online(cfg, ds, elastic=ecfg, deaths={4: 0})
    assert t_kernels.LAUNCHES == {"fused_glm_grad": 0, "fused_block_decode": 20}
    assert [e["n_workers"] for e in res.epochs] == [W, W - 1]
