"""The port's sparse (PaddedRows, FieldOnehot) and int8 stacks through the
trainer, the cohort engine, the replay and the CLI, against the JAX package.

Oracle: JAX's ``trainer.train`` / ``train_cohort`` on the same configs,
started from its own init draw (``trainer._init_params_f32``), at about
600 x 60 with 6 one-hot fields, W = 6, s = 1, 5 rounds. Control-plane arrays
must be the same bytes; the replayed training loss and the iterates match
within rtol 2e-5 / atol 1e-6 (float32 products reduced in other orders).
Refusals carry the JAX package's messages. The card's sparse gradients
are held to their CPU results in tests/test_torch_sparse_cuda.py.
"""

import json

import jax
import numpy as np
import pytest
import torch

from erasurehead_tpu import cli as j_cli
from erasurehead_tpu.data import synthetic as j_syn
from erasurehead_tpu.train import evaluate as j_evaluate
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.utils import config as j_config
from erasurehead_tpu_torch import cli as t_cli
from erasurehead_tpu_torch.data import io as t_io
from erasurehead_tpu_torch.data import synthetic as t_syn
from erasurehead_tpu_torch.ops import codes as t_codes
from erasurehead_tpu_torch.ops import features as tf
from erasurehead_tpu_torch.ops import kernels as t_kernels
from erasurehead_tpu_torch.parallel import step as t_step
from erasurehead_tpu_torch.train import cache as t_cache
from erasurehead_tpu_torch.train import evaluate as t_evaluate
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils import config as t_config

N_ROWS, N_COLS, W, FIELDS, ROUNDS = 600, 60, 6, 6, 5
TOL = dict(rtol=2e-5, atol=1e-6)


@pytest.fixture(scope="module")
def onehot():
    return (t_syn.generate_onehot(N_ROWS, N_COLS, W, n_fields=FIELDS, seed=0),
            j_syn.generate_onehot(N_ROWS, N_COLS, W, n_fields=FIELDS, seed=0))


@pytest.fixture(scope="module")
def dense():
    return (t_syn.generate_gmm(N_ROWS, N_COLS, W, seed=0),
            j_syn.generate_gmm(N_ROWS, N_COLS, W, seed=0))


def _kw(**kw):
    base = dict(
        scheme="approx", n_workers=W, n_stragglers=1, num_collect=4, rounds=ROUNDS,
        n_rows=N_ROWS, n_cols=N_COLS, update_rule="AGD", lr_schedule=1.0,
        add_delay=True, seed=0,
    )
    base.update(kw)
    return base


def _jax_init(cfg):
    model = j_trainer.build_model(cfg)
    params = j_trainer._init_params_f32(cfg, model, cfg.n_cols)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def _replayed(res, ds, evaluate, trainer):
    n = res.n_train
    return evaluate.replay(
        trainer.build_model(res.config), res.config.model, res.params_history,
        ds.X_train[:n], ds.y_train[:n], ds.X_test, ds.y_test,
    ).training_loss


def _history(res):
    h = res.params_history
    if isinstance(h, dict):
        return {k: v.numpy() for k, v in h.items()}
    return h.numpy()


def _assert_run_matches(got, want, tds, jds):
    for field in ("timeset", "worker_times", "collected"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    assert got.decode_error.tobytes() == want.decode_error.tobytes()
    assert got.n_train == want.n_train
    np.testing.assert_allclose(
        _replayed(got, tds, t_evaluate, t_trainer),
        _replayed(want, jds, j_evaluate, j_trainer), **TOL)
    hist = _history(got)
    jhist = jax.tree.map(np.asarray, want.params_history)
    if isinstance(hist, dict):
        for k in hist:
            np.testing.assert_allclose(hist[k], jhist[k], **TOL, err_msg=k)
    else:
        np.testing.assert_allclose(hist, jhist, **TOL)


def _train_both(data, **kw):
    tds, jds = data
    jcfg = j_config.RunConfig(**_kw(**kw))
    want = j_trainer.train(jcfg, jds)
    got = t_trainer.train(t_config.RunConfig(**_kw(**kw)), tds, device="cpu",
                          init_params=_jax_init(jcfg))
    return got, want


# (data, config knobs, the port's resolved lowering)
LOWERINGS = [
    ("onehot", dict(sparse_format="padded"), "per_slot"),
    ("onehot", dict(sparse_format="padded", flat_grad="on"), "flat"),
    ("onehot", dict(sparse_format="fields"), "flat"),
    ("onehot", dict(sparse_format="auto"), "flat"),
    ("onehot", dict(sparse_format="fields", flat_grad="off"), "per_slot"),
    ("onehot", dict(sparse_format="fields", fields_scatter="onehot",
                    fields_margin="onehot"), "flat"),
    ("onehot", dict(sparse_format="fields", flat_grad="off", fields_scatter="onehot",
                    fields_margin="onehot"), "per_slot"),
    ("onehot", dict(sparse_format="fields", sparse_lanes=8), "flat"),
    ("onehot", dict(sparse_format="padded", sparse_lanes=8, model="linear"), "per_slot"),
    ("dense", dict(margin_flat="on"), "margin_flat"),
    ("dense", dict(flat_grad="on"), "flat"),
    ("dense", dict(stack_dtype="int8"), "per_slot"),
    ("dense", dict(stack_dtype="int8", flat_grad="on"), "flat"),
    ("dense", dict(dense_margin_cols=8, use_pallas="off"), "per_slot"),
]


@pytest.mark.parametrize("compute_mode", ["faithful", "deduped"])
@pytest.mark.parametrize("data_name,knobs,lowering", LOWERINGS,
                         ids=["-".join(f"{k}={v}" for k, v in kw.items()) or "none"
                              for _, kw, _ in LOWERINGS])
def test_train_matches_jax_trainer(request, compute_mode, data_name, knobs, lowering):
    data = request.getfixturevalue(data_name)
    got, want = _train_both(data, compute_mode=compute_mode, **knobs)
    assert got.lowering == lowering
    assert not got.fused  # no kernel takes a sparse or int8 stack, or a forced lowering
    _assert_run_matches(got, want, *data)


def test_dense_auto_still_takes_the_fused_kernel(dense):
    res = t_trainer.train(t_config.RunConfig(**_kw()), dense[0], device="cpu")
    assert res.fused and res.lowering == "fused"


def test_mlp_on_a_padded_stack_matches_jax(onehot):
    got, want = _train_both(onehot, model="mlp", update_rule="GD", lr_schedule=0.1,
                            sparse_format="padded")
    assert got.lowering == "per_slot"
    _assert_run_matches(got, want, *onehot)


COHORT_CASES = [
    (dict(sparse_format="fields", compute_mode="deduped"), "flat_vmap"),
    (dict(sparse_format="fields", compute_mode="faithful"), "flat_vmap"),
    (dict(sparse_format="padded", compute_mode="deduped"), "per_slot_vmap"),
    (dict(sparse_format="padded", compute_mode="deduped", flat_grad="on"), "flat_vmap"),
]


@pytest.mark.parametrize("knobs,lowering", COHORT_CASES)
def test_sparse_cohort_matches_jax_cohort(onehot, knobs, lowering):
    tds, jds = onehot
    schemes = ("approx", "repcoded") if knobs["compute_mode"] == "faithful" else (
        "approx", "naive", "cyccoded")
    kws = [_kw(scheme=s, num_collect=4 if s == "approx" else None, **knobs) for s in schemes]
    want = j_trainer.train_cohort([j_config.RunConfig(**kw) for kw in kws], jds)
    got = t_trainer.train_cohort(
        [t_config.RunConfig(**kw) for kw in kws], tds, device="cpu",
        init_params=[_jax_init(j_config.RunConfig(**kw)) for kw in kws],
    )
    for g, w in zip(got, want):
        assert g.cohort["cohort_lowering"] == w.cache_info["cohort_lowering"] == lowering
        assert g.lowering == lowering
        _assert_run_matches(g, w, tds, jds)


# ---------------------------------------------------------------------------
# refusals, with the JAX package's messages


def _both_raise(fn_t, fn_j, exc=ValueError):
    """Both raise the same message; a dense stack's type is named as each
    package names it (JAX's ArrayImpl, the port's Tensor)."""
    with pytest.raises(exc) as want:
        fn_j()
    with pytest.raises(exc) as got:
        fn_t()
    assert str(got.value) == str(want.value).replace("X=ArrayImpl", "X=Tensor")
    return str(got.value)


CONFIG_REFUSALS = [
    dict(stack_dtype="int8", use_pallas="on"),
    dict(flat_grad="on", margin_flat="on"),
    dict(margin_flat="on", use_pallas="on"),
    dict(layer_coding="on", flat_grad="on"),
    dict(layer_coding="on", margin_flat="on"),
    dict(stack_dtype="int4"),
    dict(sparse_format="csr"),
    dict(fields_scatter="atomic"),
    dict(fields_margin="gather"),
    dict(flat_grad="yes"),
    dict(margin_flat="maybe"),
    dict(sparse_lanes=3),
    dict(dense_margin_cols=1),
    dict(sparse_format="fields", fields_margin="onehot", sparse_lanes=8),
]


@pytest.mark.parametrize("knobs", CONFIG_REFUSALS)
def test_config_refusals_match_jax(knobs):
    _both_raise(lambda: t_config.RunConfig(**_kw(**knobs)),
                lambda: j_config.RunConfig(**_kw(**knobs)))


def test_auto_format_with_lanes_pins_padded_as_jax():
    kw = _kw(sparse_format="auto", sparse_lanes=8)
    assert t_config.RunConfig(**kw).sparse_format == j_config.RunConfig(**kw).sparse_format == "padded"


TRAIN_REFUSALS = [
    ("onehot", dict(sparse_format="padded", use_pallas="on")),
    ("onehot", dict(sparse_format="fields", use_pallas="on")),
    ("onehot", dict(sparse_format="fields", margin_flat="on")),
    ("onehot", dict(sparse_format="padded", stack_dtype="int8")),
    ("dense", dict(sparse_format="fields")),
    ("dense", dict(use_pallas="on", flat_grad="on")),
    ("dense", dict(model="mlp", flat_grad="on")),
    ("dense", dict(model="mlp", margin_flat="on")),
]


@pytest.mark.parametrize("data_name,knobs", TRAIN_REFUSALS)
def test_train_refusals_match_jax(request, data_name, knobs):
    tds, jds = request.getfixturevalue(data_name)
    msg = _both_raise(
        lambda: t_trainer.train(t_config.RunConfig(**_kw(**knobs)), tds, device="cpu"),
        lambda: j_trainer.train(j_config.RunConfig(**_kw(**knobs)), jds),
    )
    assert msg


def test_fields_refuses_data_that_is_not_one_hot(tmp_path):
    """A CSR dataset that is not one-hot per field refuses FieldOnehot."""
    import scipy.sparse as sps

    tds, _ = t_syn.generate_gmm(N_ROWS, N_COLS, W, seed=1), None
    sparse = t_syn.Dataset(sps.csr_matrix(tds.X_train), tds.y_train,
                           sps.csr_matrix(tds.X_test), tds.y_test)
    jsparse = j_syn.Dataset(sparse.X_train, sparse.y_train, sparse.X_test, sparse.y_test)
    _both_raise(
        lambda: t_trainer.train(t_config.RunConfig(**_kw(sparse_format="fields")), sparse,
                                device="cpu"),
        lambda: j_trainer.train(j_config.RunConfig(**_kw(sparse_format="fields")), jsparse),
    )
    res = t_trainer.train(t_config.RunConfig(**_kw(sparse_format="auto")), sparse, device="cpu")
    assert isinstance(t_trainer._device_stack(
        res.config, sparse, res.layout, True, torch.device("cpu"))[0], tf.PaddedRows)


def test_cohort_refuses_forced_flat_on_an_autodiff_family(onehot):
    tds, jds = onehot
    kw = _kw(model="mlp", flat_grad="on", sparse_format="padded", compute_mode="deduped")
    _both_raise(lambda: t_trainer.train_cohort([t_config.RunConfig(**kw)] * 2, tds, device="cpu"),
                lambda: j_trainer.train_cohort([j_config.RunConfig(**kw)] * 2, jds))


# ---------------------------------------------------------------------------
# signatures, launches, the CLI


@pytest.mark.parametrize("kw", [
    dict(stack_dtype="int8"), dict(sparse_format="fields", fields_scatter="onehot"),
    dict(sparse_lanes=8, dense_margin_cols=4, fields_margin="onehot"),
    dict(flat_grad="on", stack_dtype="bfloat16"),
])
def test_static_signature_keeps_jax_keys_and_order(kw):
    t = t_config.RunConfig(**_kw(**kw)).static_signature_fields()
    j = j_config.RunConfig(**_kw(**kw)).static_signature_fields()
    assert list(t) == [k for k in j if k in t]
    assert t == {k: j[k] for k in t}
    for key in ("stack_dtype", "sparse_lanes", "dense_margin_cols", "sparse_format",
                "fields_scatter", "fields_margin"):
        assert key in t
    assert t_config.RunConfig(**_kw(**kw)).resolve_stack_dtype() == \
        j_config.RunConfig(**_kw(**kw)).resolve_stack_dtype()


def test_stack_signature_keys_format_and_storage():
    layout = t_codes.cyclic_mds_layout(W, 1)
    sig = lambda **kw: t_cache.layout_stack_signature(layout, worker_major=True, **kw)  # noqa: E731
    base = sig()
    assert base[:3] == ("workers",) + base[1:3] and base[3:] == (("float32", "float32"), "padded")
    assert sig(stack_dtype="int8") != base
    assert sig(sparse_format="fields") != base
    assert sig(dtype="bfloat16") != base
    assert t_cache.layout_stack_signature(layout, worker_major=False)[:2] == ("parts", W)
    cfgs = [t_config.RunConfig(**_kw(compute_mode="deduped", **kw))
            for kw in ({}, dict(stack_dtype="int8"), dict(sparse_format="fields"))]
    assert len({t_trainer.cohort_signature(c) for c in cfgs}) == 3


def test_cpu_sparse_and_int8_runs_launch_no_kernel(onehot, dense):
    t_kernels.reset_launches()
    t_trainer.train(t_config.RunConfig(**_kw(sparse_format="fields")), onehot[0], device="cpu")
    t_trainer.train(t_config.RunConfig(**_kw(stack_dtype="int8")), dense[0], device="cpu")
    assert all(v == 0 for v in t_kernels.LAUNCHES.values())


def test_cohort_lowering_order_matches_jax(onehot, dense):
    model = t_trainer.build_model(t_config.RunConfig(**_kw()))
    Xd = torch.zeros(2, 3, 4)
    Xq = tf.QuantizedStack(torch.zeros(2, 3, 4, dtype=torch.int8), torch.ones(2, 4))
    Xf = tf.FieldOnehot(torch.zeros(2, 3, 2, dtype=torch.int32), (2, 2), 4)
    Xp = tf.PaddedRows(torch.zeros(2, 3, 2, dtype=torch.int32), torch.zeros(2, 3, 2), 4)
    for X, auto in ((Xd, "cohort_matmul"), (Xq, "cohort_matmul"), (Xf, "flat_vmap"),
                    (Xp, "per_slot_vmap")):
        _, name = t_step.make_cohort_grad_fn(model, None, X, faithful=False, layer_coding="off",
                                             block_decode="auto", flat_grad="auto")
        assert name == auto
        assert t_step.supports_cohort_matmul(model, X) == (auto == "cohort_matmul")


def test_csr_input_dir_trains_through_the_cli(tmp_path, onehot):
    """A covtype-named CSR layout under --input-dir trains through both CLIs:
    the same simulated clock bytes and manifest keys, the port's loss
    finite and falling (each CLI starts from its own init draw)."""
    tds, _ = onehot
    for root in ("t", "j"):
        t_io.write_reference_layout(tds, str(tmp_path / root / "covtype" / str(W)), W)
    flags = ["--dataset", "covtype", "--rows", str(N_ROWS), "--cols", str(N_COLS),
             "--scheme", "approx", "--workers", str(W), "--stragglers", "1",
             "--num-collect", "4", "--rounds", "5", "--lr", "1.0", "--add-delay",
             "--sparse-format", "fields", "--quiet"]
    tdir, jdir = tmp_path / "t_out", tmp_path / "j_out"
    assert t_cli.main(flags + ["--input-dir", str(tmp_path / "t"), "--output-dir", str(tdir),
                               "--device", "cpu"]) == 0
    assert j_cli.main(flags + ["--input-dir", str(tmp_path / "j"), "--output-dir", str(jdir)]) == 0
    names = sorted(p.name for p in tdir.iterdir())
    assert names == sorted(p.name for p in jdir.iterdir())
    for name in names:
        if name.endswith("timeset.dat"):
            assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name
        if name.endswith("manifest.json"):
            tman, jman = json.loads((tdir / name).read_text()), json.loads((jdir / name).read_text())
            assert sorted(tman) == sorted(jman)
            assert tman["n_train"] == jman["n_train"]
        if name.endswith("training_loss.dat"):
            loss = np.loadtxt(tdir / name)
            assert np.isfinite(loss).all() and loss[-1] < loss[0]
