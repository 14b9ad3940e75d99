"""Card-side pins of the tune plane and the what-if engine: a ``glm_fused``
race on the card keys its verdict by the card's name, and the next
``use_pallas="auto"`` run launches B1 once a round if the verdict is
``pallas`` and never if it is ``xla``; a ``block_decode`` race's tuned
"auto" run launches B2 once a round, bitwise the forced run of its verdict;
the sampler's block on the card is within 2 ulps of the CPU's and its draw
launches as many kernels for one seed as for eight; a what-if grid on the
card gives the CPU's rows within rtol 1e-4 and launches no B1 under cohort
batching. Every test is marked ``cuda`` and skips without a card.

The module imports the port only, so that it also runs where the JAX
package is not installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_tune_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from erasurehead_tpu_torch import tune
from erasurehead_tpu_torch.data import synthetic as t_syn
from erasurehead_tpu_torch.ops import kernels as t_kernels
from erasurehead_tpu_torch.train import trainer
from erasurehead_tpu_torch.tune import races
from erasurehead_tpu_torch.utils import config as t_config
from erasurehead_tpu_torch.whatif import GridSpec, PolicySpec, RegimeSpec, run_whatif
from erasurehead_tpu_torch.whatif import sampler

W, ROUNDS, N_ROWS, N_COLS = 8, 10, 8 * 64, 32


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.fixture(autouse=True)
def isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv(tune.ENV_PATH, str(tmp_path / "tune.json"))
    tune.reset()
    tune.reset_emitted()
    yield
    tune.reset()
    tune.reset_emitted()


def _cfg(**kw):
    base = dict(scheme="approx", n_workers=W, n_stragglers=1, num_collect=6, rounds=ROUNDS,
                n_rows=N_ROWS, n_cols=N_COLS, update_rule="AGD", lr_schedule=1.0,
                add_delay=True, seed=0)
    base.update(kw)
    return t_config.RunConfig(**base)


@pytest.mark.cuda
@pytest.mark.parametrize("verdict,launches", [("pallas", ROUNDS), ("xla", 0)])
def test_glm_fused_verdict_decides_b1(verdict, launches):
    _card()
    cfg = _cfg()
    ds = t_syn.generate_gmm(N_ROWS, N_COLS, W, seed=0)
    res = races.race_glm_fused(cfg, ds, reps=2, device="cuda")
    assert res.device_kind == torch.cuda.get_device_name(0)
    assert tune.get_cache().lookup(res.device_kind, "glm_fused", res.shape) == res.choice
    tune.get_cache().record(res.device_kind, "glm_fused", res.shape, verdict)
    t_kernels.reset_launches()
    out = trainer.train(cfg, ds, device="cuda")
    assert t_kernels.LAUNCHES["fused_glm_grad"] == launches
    assert out.lowering == ("fused" if verdict == "pallas" else "per_slot")
    forced = trainer.train(
        dataclasses.replace(cfg, use_pallas="on" if verdict == "pallas" else "off"), ds,
        device="cuda")
    assert torch.equal(out.final_params, forced.final_params)


@pytest.mark.cuda
def test_tuned_block_decode_launches_b2_bitwise_its_forced_run():
    _card()
    cfg = _cfg(model="deepmlp", update_rule="GD", lr_schedule=0.5, layer_coding="on")
    ds = t_syn.generate_gmm(N_ROWS, N_COLS, W, seed=0)
    res = races.race_block_decode(cfg, ds, reps=1, device="cuda")
    t_kernels.reset_launches()
    auto = trainer.train(dataclasses.replace(cfg, block_decode="auto"), ds, device="cuda")
    assert t_kernels.LAUNCHES == {"fused_glm_grad": 0, "fused_block_decode": ROUNDS}
    forced = trainer.train(dataclasses.replace(cfg, block_decode=res.choice), ds, device="cuda")
    for k in sorted(auto.final_params):
        assert torch.equal(auto.final_params[k], forced.final_params[k])


def _ulps(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


@pytest.mark.cuda
def test_sampler_on_card_matches_cpu_and_launches_flat():
    _card()
    for reg in (RegimeSpec(), RegimeSpec(kind="adversary", slowdown=8.0, worker=0)):
        a = sampler.sample_arrivals(reg, 30, 30, range(8), device="cuda")
        b = sampler.sample_arrivals(reg, 30, 30, range(8), device="cpu")
        assert _ulps(a, b).max() <= 2

    def kernels_of(seeds, rounds):
        sampler.sample_arrivals(RegimeSpec(), rounds, 30, seeds, device="cuda")  # warm
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            sampler.sample_arrivals(RegimeSpec(), rounds, 30, seeds, device="cuda")
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages() if e.device_type.name == "CUDA")

    assert kernels_of([0], 30) == kernels_of(list(range(8)), 30)


@pytest.mark.cuda
def test_whatif_grid_on_card_matches_cpu():
    _card()
    spec = GridSpec(policies=(PolicySpec("naive"), PolicySpec("approx", num_collect=4)),
                    n_workers=(W,), n_stragglers=(1,),
                    regimes=(RegimeSpec(), RegimeSpec(kind="adversary", slowdown=4.0)),
                    n_seeds=3, rounds=ROUNDS, n_rows=N_ROWS, n_cols=N_COLS)
    cpu = run_whatif(spec, device="cpu")
    t_kernels.reset_launches()
    # one loss target on both sides, so both threshold on one number
    card = run_whatif(dataclasses.replace(spec, target_loss=cpu.target_loss), device="cuda",
                      batch="auto")
    assert t_kernels.LAUNCHES["fused_glm_grad"] == 0
    for a, b in zip(card.rows, cpu.rows):
        for k, v in b.items():
            if isinstance(v, float):
                np.testing.assert_allclose(a[k], v, rtol=1e-4, err_msg=k)
            else:
                assert a[k] == v, k
