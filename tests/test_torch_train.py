"""The port's trainer, replay, artifacts and CLI against the JAX package.

Both trainers run the fused-gradient path (``use_pallas="on"``): the JAX
package runs its Pallas kernel in interpret mode on the CPU, the port its
kernel's plain PyTorch version. The port cannot reproduce JAX's threefry
init draw, so it is handed the JAX draw. The control plane must match byte
for byte; the iterate history to the JAX package's own trainer tolerance
(tests/test_kernels.py: rtol 2e-4, atol 1e-5), since float32 sums are taken
in another order and AGD carries the difference forward.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from erasurehead_tpu import cli as j_cli
from erasurehead_tpu.data.synthetic import generate_gmm as j_generate_gmm
from erasurehead_tpu.models.glm import LogisticModel as JLogistic
from erasurehead_tpu.train import evaluate as j_evaluate
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.utils.config import RunConfig as JRunConfig
from erasurehead_tpu_torch import cli as t_cli
from erasurehead_tpu_torch.data.synthetic import generate_gmm
from erasurehead_tpu_torch.ops import kernels as t_kernels
from erasurehead_tpu_torch.train import evaluate as t_evaluate
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils.config import RunConfig

W, ROWS, COLS, ROUNDS = 8, 128, 32, 4


def _cfg_kw(scheme, compute_mode, **extra):
    return dict(
        scheme=scheme, n_workers=W, n_stragglers=1, rounds=ROUNDS,
        num_collect=4 if scheme == "approx" else None,
        n_rows=ROWS, n_cols=COLS, lr_schedule=1.0, update_rule="AGD",
        add_delay=True, seed=0, compute_mode=compute_mode, use_pallas="on",
        **extra,
    )


def _jax_init(seed=0):
    return np.asarray(JLogistic().init_params(jax.random.key(seed), COLS), np.float32)


@pytest.mark.parametrize("scheme", ["approx", "naive", "cyccoded"])
@pytest.mark.parametrize("compute_mode", ["faithful", "deduped"])
def test_train_matches_jax_trainer(scheme, compute_mode):
    data = generate_gmm(ROWS, COLS, n_partitions=W, seed=0)
    jdata = j_generate_gmm(ROWS, COLS, n_partitions=W, seed=0)
    want = j_trainer.train(JRunConfig(**_cfg_kw(scheme, compute_mode)), jdata)
    got = t_trainer.train(
        RunConfig(**_cfg_kw(scheme, compute_mode)), data,
        device="cpu", init_params=_jax_init(),
    )
    for field in ("timeset", "worker_times", "collected"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    assert got.sim_total_time == want.sim_total_time
    assert got.n_train == want.n_train
    assert got.decode_error.tobytes() == want.decode_error.tobytes()
    hist_t = got.params_history.numpy()
    hist_j = np.asarray(want.params_history)
    np.testing.assert_allclose(hist_t, hist_j, rtol=2e-4, atol=1e-5)

    n = got.n_train
    ev_t = t_evaluate.replay(
        t_trainer.build_model(got.config), "logistic", got.params_history,
        data.X_train[:n], data.y_train[:n], data.X_test, data.y_test,
    )
    ev_j = j_evaluate.replay(
        j_trainer.build_model(want.config), "logistic", want.params_history,
        jdata.X_train[:n], jdata.y_train[:n], jdata.X_test, jdata.y_test,
    )
    for field in ("training_loss", "testing_loss", "auc"):
        np.testing.assert_allclose(
            getattr(ev_t, field), getattr(ev_j, field), rtol=2e-4, atol=1e-5,
            err_msg=field,
        )


@pytest.mark.parametrize("scheme", ["approx", "repcoded", "avoidstragg"])
def test_two_pass_and_fused_paths_agree(scheme):
    """use_pallas="off" (the two-pass gradient) and the fused path, faithful
    and deduped, all decode the same gradient; only sum order differs."""
    data = generate_gmm(ROWS, COLS, n_partitions=W, seed=1)
    hist = {}
    for mode in ("faithful", "deduped"):
        for use in ("on", "off"):
            cfg = RunConfig(**{**_cfg_kw(scheme, mode), "use_pallas": use})
            res = t_trainer.train(cfg, data, device="cpu")
            assert res.fused == (use == "on")
            hist[mode, use] = res.params_history.numpy()
    ref = hist["faithful", "off"]
    for key, h in hist.items():
        np.testing.assert_allclose(h, ref, rtol=2e-4, atol=1e-5, err_msg=str(key))


@pytest.mark.parametrize("use", ["auto", "on"])
def test_fused_path_takes_rows_wider_than_a_cta(use):
    """A dense stack of 20,000 columns (rows a cluster of CTAs splits on the
    card) takes the fused kernel under "auto" and "on", and decodes the
    gradient the two-pass form does."""
    cols = 20000
    data = generate_gmm(ROWS, cols, n_partitions=W, seed=3)
    hist = {}
    for u in (use, "off"):
        cfg = RunConfig(**{**_cfg_kw("naive", "faithful"), "n_cols": cols, "use_pallas": u})
        res = t_trainer.train(cfg, data, device="cpu")
        assert res.fused == (u != "off")
        hist[u] = res.params_history.numpy()
    np.testing.assert_allclose(hist[use], hist["off"], rtol=2e-4, atol=1e-5)


def test_linear_bf16_and_gd_run_finite():
    from erasurehead_tpu_torch.data.synthetic import generate_linear

    data = generate_linear(ROWS, COLS, n_partitions=W, seed=2)
    for rule in ("GD", "ADAM"):
        cfg = RunConfig(**{
            **_cfg_kw("naive", "faithful"), "model": "linear",
            "dtype": "bfloat16", "update_rule": rule, "lr_schedule": 0.05,
        })
        res = t_trainer.train(cfg, data, device="cpu")
        assert res.params_history.shape == (ROUNDS, COLS)
        assert torch.isfinite(res.params_history).all()


@pytest.mark.parametrize("use", ["auto", "on"])
def test_trainer_refuses_a_stack_the_kernel_declines(monkeypatch, use):
    """No quiet fallback: where the fused kernel declines a stack, "auto" and
    "on" raise; only "off" takes the two-pass gradient."""
    monkeypatch.setattr(t_kernels, "unsupported_reason", lambda X: "declined here")
    data = generate_gmm(ROWS, COLS, n_partitions=W, seed=0)
    cfg = RunConfig(**{**_cfg_kw("naive", "faithful"), "use_pallas": use})
    with pytest.raises(ValueError, match="declined here"):
        t_trainer.train(cfg, data, device="cpu")
    off = RunConfig(**{**_cfg_kw("naive", "faithful"), "use_pallas": "off"})
    assert not t_trainer.train(off, data, device="cpu").fused


def test_cuda_requested_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = generate_gmm(ROWS, COLS, n_partitions=W, seed=0)
    cfg = RunConfig(**_cfg_kw("naive", "faithful"))
    with pytest.raises(RuntimeError, match="cuda"):
        t_trainer.train(cfg, data)
    with pytest.raises(RuntimeError, match="cuda"):
        t_trainer.train(cfg, data, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        t_cli.main(["--rows", "64", "--cols", "8", "--rounds", "1", "--quiet"])


def test_cli_writes_the_jax_artifact_names(tmp_path):
    flags = [
        "--scheme", "approx", "--workers", "6", "--stragglers", "2",
        "--num-collect", "3", "--rounds", "3", "--rows", "120",
        "--cols", "16", "--add-delay", "--quiet",
    ]
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    assert j_cli.main(flags + ["--output-dir", str(jdir)]) == 0
    assert t_cli.main(flags + ["--output-dir", str(tdir), "--device", "cpu"]) == 0
    names = sorted(os.listdir(tdir))
    assert names == sorted(os.listdir(jdir))
    assert len([n for n in names if n.endswith(".dat")]) == 5
    for name in names:
        if name.endswith("timeset.dat"):  # control plane: same bytes
            assert (tdir / name).read_bytes() == (jdir / name).read_bytes()
        if name.endswith("manifest.json"):
            tman = json.loads((tdir / name).read_text())
            jman = json.loads((jdir / name).read_text())
            assert sorted(tman) == sorted(jman)
            for key in ("sim_total_time", "n_train", "arrival", "decode_error_mean"):
                assert tman[key] == jman[key], key


def test_cli_refuses_an_on_disk_dataset(tmp_path):
    """A CSR (.npz) reference layout of data that is not one-hot per field
    loads, and the trainer refuses it where it stacks the partitions as
    FieldOnehot (``--sparse-format fields``), with the JAX package's
    message; as PaddedRows (the default) it trains."""
    import scipy.sparse as sps

    from erasurehead_tpu_torch.data import io as t_io
    from erasurehead_tpu_torch.data.synthetic import Dataset

    dense = generate_gmm(64, 8, n_partitions=4, seed=0)
    sparse = Dataset(
        sps.csr_matrix(dense.X_train), dense.y_train,
        sps.csr_matrix(dense.X_test), dense.y_test,
    )
    t_io.write_reference_layout(sparse, str(tmp_path / "artificial-data" / "64x8" / "4"), 4)
    flags = ["--workers", "4", "--rows", "64", "--cols", "8", "--rounds", "1",
             "--input-dir", str(tmp_path), "--device", "cpu", "--quiet"]
    with pytest.raises(ValueError, match="requires exactly-one-hot-per-field data"):
        t_cli.main(flags + ["--sparse-format", "fields"])
    assert t_cli.main(flags) == 0


def test_cpu_run_launches_no_kernel():
    data = generate_gmm(ROWS, COLS, n_partitions=W, seed=0)
    before = t_kernels.LAUNCHES["fused_glm_grad"]
    t_trainer.train(RunConfig(**_cfg_kw("naive", "faithful")), data, device="cpu")
    assert t_kernels.LAUNCHES["fused_glm_grad"] == before
