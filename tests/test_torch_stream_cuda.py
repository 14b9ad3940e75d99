"""Card-side pins of out-of-core streaming: the prefetcher stages through
pinned host buffers on its own copy stream and hands the consuming stream
windows equal to the host's reads; a windowed streamed GLM run launches the
fused GLM kernel once a round on each staged window, stays within the
prefetcher's residency bound, reruns bitwise and follows the CPU run; the
kernel holds its tolerance against its plain version at the window shapes.
Every test is marked ``cuda`` and skips without a card.

The module imports the port only, so that it also runs where the JAX
package is not installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_stream_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from erasurehead_tpu_torch.data import prefetch as t_prefetch
from erasurehead_tpu_torch.data import store as t_store
from erasurehead_tpu_torch.data import synthetic as t_syn
from erasurehead_tpu_torch.ops import features as t_features
from erasurehead_tpu_torch.ops import kernels as t_kernels
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils import config as t_config

W, ROUNDS, N_ROWS, N_COLS = 6, 8, 1200, 32


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("stream_cuda")
    ds = t_syn.generate_gmm(N_ROWS, N_COLS, W, seed=0)
    for dtype in ("float32", "int8"):
        t_store.write_store(ds, str(root / dtype), W, stack_dtype=dtype, group=4)
    return root


def _cfg(**kw):
    base = dict(
        scheme="cyccoded", n_workers=W, n_stragglers=2, rounds=ROUNDS, n_rows=N_ROWS,
        n_cols=N_COLS, update_rule="AGD", lr_schedule=1.0, add_delay=True, seed=0,
        stack_residency="streamed", stream_window=3,
    )
    base.update(kw)
    return t_config.RunConfig(**base)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_prefetcher_pins_and_stages_on_its_stream(store_dir, dtype):
    _card()
    st = t_store.open_store(str(store_dir / dtype))
    dev = torch.device("cuda")
    windows = [(0, 3), ((4, 6), (0, 1)), (3, 6)]

    def put(X, y):
        # the staging thread's copy stream, not the default one
        assert torch.cuda.current_stream(dev) != torch.cuda.default_stream(dev)
        leaves = [X.q, X.scale, y] if isinstance(X, t_features.QuantizedStack) else [X, y]
        assert all(t.is_pinned() for t in leaves)
        up = lambda t: t.to(dev, non_blocking=True, copy=True)  # noqa: E731
        if isinstance(X, t_features.QuantizedStack):
            return t_features.QuantizedStack(up(X.q), up(X.scale)), up(y)
        return up(X), up(y)

    pf = t_prefetch.Prefetcher(st, windows, put, device=dev)
    try:
        assert pf._stream != torch.cuda.current_stream(dev)
        for i, w in enumerate(windows):
            X, y = pf.get(i)
            Xh, yh = st.read_ranges(t_prefetch._norm_window(w))
            got = X.q if dtype == "int8" else X
            want = Xh.q if dtype == "int8" else Xh
            assert got.is_cuda and torch.equal(got.cpu(), torch.from_numpy(want))
            assert torch.equal(y.cpu(), torch.from_numpy(yh))
    finally:
        pf.close()
    assert pf.stats()["windows"] == len(windows)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_mode", ["faithful", "deduped"])
def test_windowed_run_launches_b1_each_round_within_the_bound(store_dir, compute_mode):
    _card()
    ds = t_store.open_store(str(store_dir / "float32")).dataset()
    cfg = _cfg(compute_mode=compute_mode)
    runs = []
    for _ in range(2):
        t_kernels.reset_launches()
        runs.append(t_trainer.train(cfg, ds, device="cuda"))
        assert t_kernels.LAUNCHES == {"fused_glm_grad": ROUNDS, "fused_block_decode": 0}
    a, b = runs
    assert a.lowering == "fused"
    assert torch.equal(a.params_history, b.params_history)
    ci = a.cache_info
    assert ci["device_peak_bytes"] <= (t_prefetch.DEFAULT_DEPTH + 2) * ci["stack_bytes"]
    cpu = t_trainer.train(cfg, ds, device="cpu")
    np.testing.assert_allclose(a.params_history.cpu().numpy(), cpu.params_history.numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_int8_window_launches_no_kernel(store_dir):
    _card()
    ds = t_store.open_store(str(store_dir / "int8")).dataset()
    t_kernels.reset_launches()
    res = t_trainer.train(_cfg(stack_dtype="int8"), ds, device="cuda")
    assert t_kernels.LAUNCHES == {"fused_glm_grad": 0, "fused_block_decode": 0}
    assert res.lowering == "per_slot"
    full = t_trainer.train(dataclasses.replace(_cfg(stack_dtype="int8"), stream_window=None),
                           ds, device="cuda")
    assert torch.isfinite(full.params_history).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(30, 4400, 128), (3, 70400, 128), (9, 200, 32)])
def test_b1_at_window_shapes(shape):
    _card()
    g = torch.Generator().manual_seed(sum(shape))
    M, R, F = shape
    X = (torch.randn(M, R, F, generator=g) * (10 / F**0.5)).cuda()
    y = torch.randn(M, R, generator=g).sign().cuda()
    b = (torch.randn(F, generator=g) * 0.1).cuda()
    w = torch.rand(M, generator=g).cuda()
    got = t_kernels.fused_glm_grad(b, X, y, w, "logistic")
    want = t_kernels.reference_glm_grad(b, X, y, w, "logistic")
    s = t_kernels._residual("logistic", torch.einsum("mrf,f->mr", X, b), y) * w[:, None]
    scale = torch.einsum("mrf,mr->f", X.abs(), s.abs())
    assert ((got - want).abs() <= 1e-5 * scale + 1e-6).all()
