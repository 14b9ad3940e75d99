"""Card-side pins of the attention family, the arrival models and
checkpoint/resume: layer-coded attention through the decode kernel (one
launch a round, none of the GLM kernel) against its CPU run, fused against
treewise bitwise, regime-shifted clocks the same bytes as on the CPU, and a
resumed card run bitwise equal to the tail of the uninterrupted one. Every
test is marked ``cuda`` and skips without a card.

The module imports the port only, so that it also runs where the JAX
package is not installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_attention_cuda.py``.
"""

import numpy as np
import pytest
import torch

from erasurehead_tpu_torch.data import synthetic as t_syn
from erasurehead_tpu_torch.ops import blocks
from erasurehead_tpu_torch.ops import kernels as t_kernels
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils import chaos as t_chaos
from erasurehead_tpu_torch.utils import config as t_config

W, ROUNDS, N_ROWS, N_COLS = 6, 6, 1200, 32


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.fixture(scope="module")
def data():
    return t_syn.generate_gmm(N_ROWS, N_COLS, W, seed=0)


def _cfg(**kw):
    base = dict(
        scheme="approx", model="attention", n_workers=W, n_stragglers=1, num_collect=4,
        rounds=ROUNDS, n_rows=N_ROWS, n_cols=N_COLS, update_rule="GD", lr_schedule=0.5,
        add_delay=True, seed=0, layer_coding="on", block_decode="fused",
    )
    base.update(kw)
    return t_config.RunConfig(**base)


def _bits(tree):
    return [leaf.cpu().numpy().tobytes() for leaf in blocks.tree_leaves(tree)]


@pytest.mark.cuda
@pytest.mark.parametrize("compute_mode", ["faithful", "deduped"])
def test_layer_coded_attention_on_the_card(data, compute_mode):
    _card()
    cfg = _cfg(compute_mode=compute_mode)
    t_kernels.reset_launches()
    gpu = t_trainer.train(cfg, data)
    assert t_kernels.LAUNCHES == {"fused_glm_grad": 0, "fused_block_decode": ROUNDS}
    cpu = t_trainer.train(cfg, data, device="cpu")
    for a, b in zip(blocks.tree_leaves(gpu.params_history), blocks.tree_leaves(cpu.params_history)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4, atol=1e-5)
    tree = t_trainer.train(_cfg(compute_mode=compute_mode, block_decode="treewise"), data)
    assert _bits(tree.params_history) == _bits(gpu.params_history)


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["heavytail:2:1.2", "targeted:1:0:5.0"])
def test_regime_clocks_are_the_cpu_bytes(data, monkeypatch, regime):
    _card()
    monkeypatch.setenv(t_chaos.REGIME_ENV, regime)
    cfg = _cfg(model="logistic", scheme="repcoded", layer_coding="auto", update_rule="AGD",
               compute_time=0.1, worker_speed_spread=0.3)
    gpu, cpu = t_trainer.train(cfg, data), t_trainer.train(cfg, data, device="cpu")
    assert gpu.timeset.tobytes() == cpu.timeset.tobytes()
    assert gpu.worker_times.tobytes() == cpu.worker_times.tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("model,rule", [("logistic", "AGD"), ("logistic", "ADAM"),
                                        ("attention", "GD")])
def test_resumed_card_run_is_bitwise_the_tail(data, tmp_path, model, rule):
    _card()
    cfg = _cfg(model=model, update_rule=rule, lr_schedule=0.05 if rule == "ADAM" else 0.5,
               layer_coding="on" if model == "attention" else "auto")
    full = t_trainer.train(cfg, data)
    saved = t_trainer.train(cfg, data, checkpoint_dir=str(tmp_path), checkpoint_every=2)
    assert _bits(saved.params_history) == _bits(full.params_history)
    resumed = t_trainer.train(cfg, data, checkpoint_dir=str(tmp_path), resume=True)
    assert resumed.start_round == 4
    tail = blocks.tree_map(lambda h: h[4:], full.params_history)
    assert _bits(resumed.params_history) == _bits(tail)
    assert blocks.tree_leaves(resumed.final_params)[0].device.type == "cuda"
