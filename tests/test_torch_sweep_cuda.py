"""Card-side pins of the sweep runner and pipelined training: the data
cache never hands a CPU run a card stack (and hits on the card), a
pipelined GLM run launches the fused GLM kernel once a round on stale
params with the host's schedule and the CPU run's losses, a pipelined
layer-coded deep run launches the decode kernel once a round, and a
journaled sweep resumed after a fault is bitwise the uninterrupted one
under batch "off". Every test is marked ``cuda`` and skips without a card.

The module imports the port only, so that it also runs where the JAX
package is not installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_sweep_cuda.py``.
"""

import numpy as np
import pytest
import torch

from erasurehead_tpu_torch.data import synthetic as t_syn
from erasurehead_tpu_torch.ops import blocks
from erasurehead_tpu_torch.ops import kernels as t_kernels
from erasurehead_tpu_torch.parallel import pipeline as t_pipeline
from erasurehead_tpu_torch.train import cache as t_cache
from erasurehead_tpu_torch.train import evaluate as t_evaluate
from erasurehead_tpu_torch.train import experiments as t_exp
from erasurehead_tpu_torch.train import journal as t_journal
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils import chaos as t_chaos
from erasurehead_tpu_torch.utils import config as t_config

W, ROUNDS, N_ROWS, N_COLS = 6, 8, 1200, 32


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.fixture(scope="module")
def data():
    return t_syn.generate_gmm(N_ROWS, N_COLS, W, seed=0)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(t_chaos.CHAOS_ENV, raising=False)
    t_chaos.reset()
    t_cache.clear()
    yield
    t_cache.clear()


def _cfg(**kw):
    base = dict(
        scheme="approx", n_workers=W, n_stragglers=1, num_collect=4, rounds=ROUNDS,
        n_rows=N_ROWS, n_cols=N_COLS, update_rule="GD", lr_schedule=1.0, add_delay=True,
        seed=0,
    )
    base.update(kw)
    return t_config.RunConfig(**base)


def _loss(res, ds):
    n = res.n_train
    ev = t_evaluate.replay(t_trainer.build_model(res.config), res.config.model,
                           res.params_history, ds.X_train[:n], ds.y_train[:n],
                           ds.X_test, ds.y_test)
    return np.asarray(ev.training_loss)


@pytest.mark.cuda
def test_cache_keys_the_device(data):
    _card()
    gpu = t_trainer.train(_cfg(), data)
    cpu = t_trainer.train(_cfg(), data, device="cpu")
    again = t_trainer.train(_cfg(), data)
    assert (gpu.cache_info["data_hit"], cpu.cache_info["data_hit"],
            again.cache_info["data_hit"]) == (False, False, True)
    assert cpu.final_params.device.type == "cpu" and again.final_params.is_cuda
    assert [h.cpu().numpy().tobytes() for h in blocks.tree_leaves(gpu.params_history)] == \
        [h.cpu().numpy().tobytes() for h in blocks.tree_leaves(again.params_history)]


@pytest.mark.cuda
def test_pipelined_glm_on_the_card(data):
    _card()
    cfg = _cfg(pipeline_depth=1)
    t_kernels.reset_launches()
    gpu = t_trainer.train(cfg, data)
    assert t_kernels.LAUNCHES == {"fused_glm_grad": ROUNDS, "fused_block_decode": 0}
    assert gpu.fused
    want = t_pipeline.pipelined_schedule(cfg, t_trainer.default_arrivals(cfg),
                                         t_trainer.build_layout(cfg))
    assert gpu.timeset.tobytes() == want.sim_time.tobytes()
    cpu = t_trainer.train(cfg, data, device="cpu")
    g, c = _loss(gpu, data), _loss(cpu, data)
    assert np.all(np.abs(g - c) <= 1e-4 * np.abs(c))
    sync = t_trainer.train(_cfg(), data)
    assert not np.array_equal(_loss(sync, data)[2:], g[2:])


@pytest.mark.cuda
def test_pipelined_deep_layer_coded_on_the_card(data):
    _card()
    cfg = _cfg(pipeline_depth=1, model="deepmlp", layer_coding="on", block_decode="fused",
               lr_schedule=0.5)
    t_kernels.reset_launches()
    gpu = t_trainer.train(cfg, data)
    assert t_kernels.LAUNCHES == {"fused_glm_grad": 0, "fused_block_decode": ROUNDS}
    cpu = t_trainer.train(cfg, data, device="cpu")
    g, c = _loss(gpu, data), _loss(cpu, data)
    assert np.all(np.abs(g - c) <= 1e-4 * np.abs(c))


@pytest.mark.cuda
def test_journal_resume_is_bitwise_on_the_card(data, tmp_path, monkeypatch):
    _card()
    configs = {s: _cfg(scheme=s, update_rule="AGD", **({"num_collect": 4} if s == "approx"
                                                       else {"num_collect": None}))
               for s in ("naive", "approx", "avoidstragg", "cyccoded")}
    base = t_exp.compare(dict(configs), data, batch="off")
    monkeypatch.setenv(t_chaos.CHAOS_ENV, "raise:trajectory:2")
    t_chaos.reset()
    j = t_journal.SweepJournal(str(tmp_path))
    with pytest.raises(t_chaos.ChaosInjection):
        t_exp.compare(dict(configs), data, batch="off", journal=j)
    j.close()
    monkeypatch.delenv(t_chaos.CHAOS_ENV)
    resumed = t_exp.compare(dict(configs), data, batch="off",
                            journal=t_journal.SweepJournal(str(tmp_path), resume=True))
    for a, b in zip(base, resumed):
        assert a.training_loss.tobytes() == b.training_loss.tobytes()
        assert t_journal.science_row(a.row()) == t_journal.science_row(b.row())
