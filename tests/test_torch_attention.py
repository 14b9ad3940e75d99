"""The port's attention family and block decode error against the JAX package.

Oracles:
  - ``parallel/ring.reference_attention``, causal and not, against JAX's;
  - ``AttentionModel.predict``/``loss_sum``/``grad_sum`` against JAX's
    unsharded model on JAX's own parameter draw, carried across with
    ``params_from_numpy`` (float32 products in another order: rtol 1e-5,
    atol 1e-6);
  - the layer-coded attention trajectory against JAX's monolithic
    ``layer_coding="off"`` trajectory (the JAX trainer refuses layer-coded
    autodiff families on jax >= 0.6), at the JAX deep-coding tests'
    tolerance (rtol 5e-4, atol 5e-5);
  - inside the port: the fused and treewise decodes bitwise equal, and a
    2-trajectory cohort against its sequential runs;
  - ``obs/decode.block_decode_error`` against JAX's function called
    directly on the same layout, weights and block table (JAX's
    ``TestDecodeErrorVsDepth`` tests are not the oracle).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erasurehead_tpu.data.synthetic import generate_gmm as j_generate_gmm
from erasurehead_tpu.models.attention import AttentionModel as JAttention
from erasurehead_tpu.obs import decode as j_decode
from erasurehead_tpu.ops.features import PaddedRows as JPaddedRows
from erasurehead_tpu.parallel import ring as j_ring
from erasurehead_tpu.parallel import straggler as j_straggler
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.utils.config import RunConfig as JRunConfig
from erasurehead_tpu_torch import cli as t_cli
from erasurehead_tpu_torch.data.sharding import partition_stack
from erasurehead_tpu_torch.data.synthetic import generate_gmm
from erasurehead_tpu_torch.models.attention import AttentionModel
from erasurehead_tpu_torch.models.glm import params_from_numpy
from erasurehead_tpu_torch.obs import decode as t_decode
from erasurehead_tpu_torch.ops import blocks
from erasurehead_tpu_torch.ops import features as t_features
from erasurehead_tpu_torch.parallel import ring as t_ring
from erasurehead_tpu_torch.parallel import step as t_step
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils.config import ModelKind, RunConfig

W, ROUNDS = 8, 3
N_ROWS, N_COLS = 256, 64
MODEL_TOL = dict(rtol=1e-5, atol=1e-6)
TRAJ_TOL = dict(rtol=5e-4, atol=5e-5)


def _kw(**kw):
    """tests/test_deep_coding.py::_cfg's run, attention."""
    base = dict(
        scheme="approx", model="attention", n_workers=W, n_stragglers=1,
        num_collect=6, rounds=ROUNDS, n_rows=N_ROWS, n_cols=N_COLS,
        update_rule="GD", lr_schedule=0.1, add_delay=True,
        compute_mode="deduped", seed=3,
    )
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def data():
    return generate_gmm(N_ROWS, N_COLS, n_partitions=W, seed=0)


@pytest.fixture(scope="module")
def jdata():
    return j_generate_gmm(N_ROWS, N_COLS, n_partitions=W, seed=0)


def _jax_init(jcfg):
    model = j_trainer.build_model(jcfg)
    return jax.tree.map(np.asarray, j_trainer._init_params_f32(jcfg, model, N_COLS))


def _leaves(tree):
    if isinstance(tree, dict):
        return [np.asarray(tree[k], np.float64) for k in sorted(tree)]
    return [np.asarray(tree, np.float64)]


def _close(a, b, tol):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape
        np.testing.assert_allclose(x, y, **tol)


def _hist(res):
    return blocks.tree_map(lambda h: h.numpy(), res.params_history)


# ---------------------------------------------------------------------------
# the oracle attention


@pytest.mark.parametrize("T,Tk,d", [(16, 16, 8), (5, 9, 3), (1, 1, 4)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("scale", [None, 0.3])
def test_reference_attention_matches_jax(T, Tk, d, causal, scale):
    rng = np.random.default_rng(T * 100 + Tk + d)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((T, d), (Tk, d), (Tk, d)))
    want = np.asarray(j_ring.reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                 causal=causal, scale=scale))
    got = t_ring.reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal, scale=scale)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_attention_batches_like_jax_vmap(causal):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((4, 3, 7, 8)).astype(np.float32) for _ in range(3))
    fn = lambda a, b, c: j_ring.reference_attention(a, b, c, causal=causal)  # noqa: E731
    want = np.asarray(jax.vmap(jax.vmap(fn))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = t_ring.reference_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)
    assert t_ring._NEG_INF == j_ring._NEG_INF


# ---------------------------------------------------------------------------
# the model against JAX's


F_MODEL, ROWS_MODEL = 32, 64


@pytest.fixture(scope="module")
def model_case():
    rng = np.random.default_rng(21)
    X = (rng.standard_normal((ROWS_MODEL, F_MODEL)) / 2).astype(np.float32)
    y = np.sign(rng.standard_normal(ROWS_MODEL)).astype(np.float32)
    jm = JAttention()
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.key(5), F_MODEL))
    return jm, jp, X, y


def test_defaults_and_init_scales_match():
    t, j = AttentionModel(), JAttention()
    assert (t.d_in, t.d_model, t.n_heads, t.sp_form) == (j.d_in, j.d_model, j.n_heads, j.sp_form)
    assert t.seq_axis is None and t.for_mesh(None) is t
    tp = t.init_params(0, F_MODEL)
    jp = j.init_params(jax.random.key(0), F_MODEL)
    assert sorted(tp) == sorted(jp)
    for key in tp:
        assert tuple(tp[key].shape) == tuple(jp[key].shape) and tp[key].dtype == torch.float32
    # the same scales: 1/sqrt(d_in) for the embedding, 1/sqrt(d_model) else
    other = t.init_params(1, 64)
    assert abs(float(other["embed"].std()) - 8 ** -0.5) < 0.1
    assert abs(float(other["wq"].std()) - 16 ** -0.5) < 0.05
    assert float(tp["b_out"]) == 0.0


def test_predict_loss_and_grad_match_jax(model_case):
    jm, jp, X, y = model_case
    tm, tp = AttentionModel(), params_from_numpy(jp)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    jpa = jax.tree.map(jnp.asarray, jp)
    np.testing.assert_allclose(tm.predict(tp, Xt).numpy(),
                               np.asarray(jm.predict(jpa, jnp.asarray(X))), **MODEL_TOL)
    np.testing.assert_allclose(float(tm.loss_sum(tp, Xt, yt)),
                               float(jm.loss_sum(jpa, jnp.asarray(X), jnp.asarray(y))), **MODEL_TOL)
    want = jm.grad_sum(jpa, jnp.asarray(X), jnp.asarray(y))
    got = tm.grad_sum(tp, Xt, yt)
    assert sorted(got) == sorted(want)
    _close({k: v.numpy() for k, v in got.items()}, want, MODEL_TOL)


@pytest.mark.parametrize("heads,d_model,d_in", [(4, 16, 8), (1, 8, 4), (2, 12, 16)])
def test_other_widths_match_jax(heads, d_model, d_in):
    rng = np.random.default_rng(heads)
    X = rng.standard_normal((9, 32)).astype(np.float32)
    y = np.sign(rng.standard_normal(9)).astype(np.float32)
    jm = JAttention(d_in=d_in, d_model=d_model, n_heads=heads)
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.key(heads), 32))
    tm = AttentionModel(d_in=d_in, d_model=d_model, n_heads=heads)
    jpa = jax.tree.map(jnp.asarray, jp)
    got = tm.grad_sum(params_from_numpy(jp), torch.from_numpy(X), torch.from_numpy(y))
    _close({k: v.numpy() for k, v in got.items()},
           jm.grad_sum(jpa, jnp.asarray(X), jnp.asarray(y)), MODEL_TOL)


def test_per_slot_grads_under_vmap_match_jax(model_case):
    """Every slot's gradient, vmapped over a [4, 16, F] stack: the slot's
    [rows, F] reshapes to tokens as a view inside the vmap."""
    jm, jp, X, y = model_case
    Xs, ys = X.reshape(4, 16, F_MODEL), y.reshape(4, 16)
    jpa = jax.tree.map(jnp.asarray, jp)
    want = jax.vmap(lambda a, b: jm.grad_sum(jpa, a, b))(jnp.asarray(Xs), jnp.asarray(ys))
    got = t_step.per_slot_grads(AttentionModel(), params_from_numpy(jp),
                                torch.from_numpy(Xs), torch.from_numpy(ys), 1)
    _close({k: v.numpy() for k, v in got.items()}, want, MODEL_TOL)


def _refusal(t_call, j_call, exc):
    with pytest.raises(exc) as want:
        j_call()
    with pytest.raises(exc) as got:
        t_call()
    assert str(got.value) == str(want.value)


def test_refusals_carry_jax_messages(model_case):
    jm, jp, X, y = model_case
    _refusal(lambda: AttentionModel(d_model=16, n_heads=3),
             lambda: JAttention(d_model=16, n_heads=3), ValueError)
    _refusal(lambda: AttentionModel(sp_form="tree"), lambda: JAttention(sp_form="tree"), ValueError)
    _refusal(lambda: AttentionModel().init_params(0, 30),
             lambda: JAttention().init_params(jax.random.key(0), 30), ValueError)
    padded = t_features.PaddedRows(indices=torch.zeros(4, 2, dtype=torch.int32),
                                   values=torch.zeros(4, 2), n_cols=F_MODEL)
    jpadded = JPaddedRows(indices=jnp.zeros((4, 2), jnp.int32), values=jnp.zeros((4, 2)),
                          n_cols=F_MODEL)
    _refusal(lambda: AttentionModel().predict(params_from_numpy(jp), padded),
             lambda: jm.predict(jax.tree.map(jnp.asarray, jp), jpadded), TypeError)


@pytest.mark.parametrize("kw", [
    dict(seq_shards=0), dict(sp_form="tree"), dict(seq_shards=2, model="mlp"),
])
def test_config_refusals_carry_jax_messages(kw):
    full = _kw(**kw)
    _refusal(lambda: RunConfig(**full), lambda: JRunConfig(**full), ValueError)
    if "seq_shards" in kw:  # the --seq-shards flag reaches the same check
        argv = ["--model", full["model"], "--seq-shards", str(kw["seq_shards"])]
        _refusal(lambda: t_cli._flags_to_config(t_cli._flags_parser().parse_args(argv)),
                 lambda: JRunConfig(**full), ValueError)


def test_seq_shards_over_one_is_refused_on_one_device():
    """One process is one device: a 2-shard sequence axis cannot form, and
    the trainer raises the JAX trainer's device-count refusal."""
    ns = t_cli._flags_parser().parse_args(["--model", "attention", "--seq-shards", "2"])
    cfg = t_cli._flags_to_config(ns)
    assert cfg.seq_shards == 2 and cfg.model is ModelKind.ATTENTION
    with pytest.raises(ValueError) as want:  # JAX's rule on its 8 devices
        j_trainer._auto_2d_mesh(4, "seq", 9)
    assert str(want.value) == "seq shards=9 exceeds the 8 available devices"
    with pytest.raises(ValueError, match=r"^seq shards=2 exceeds the 1 available devices$"):
        t_trainer.train(RunConfig(**_kw(seq_shards=2, rounds=1)),
                        generate_gmm(N_ROWS, N_COLS, W, seed=0), device="cpu")


def test_config_and_cli_carry_the_attention_knobs():
    assert ModelKind("attention") is ModelKind.ATTENTION
    cfg = RunConfig(**_kw(sp_form="ulysses"))
    assert t_trainer.build_model(cfg).sp_form == "ulysses"
    # the two forms are two steps under a sequence axis: keyed as JAX keys them
    assert cfg.static_signature_fields()["sp_form"] == "ulysses"
    assert JRunConfig(**_kw(sp_form="ulysses")).static_signature_fields()["sp_form"] == "ulysses"
    assert t_trainer.cohort_signature(cfg) != t_trainer.cohort_signature(RunConfig(**_kw()))
    ns = t_cli._flags_parser().parse_args(["--model", "attention", "--sp-form", "ulysses",
                                           "--seq-shards", "1"])
    got = t_cli._flags_to_config(ns)
    assert got.model is ModelKind.ATTENTION and got.sp_form == "ulysses"
    assert got.seq_shards == 1


# ---------------------------------------------------------------------------
# training: layer-coded against JAX's monolithic trajectory


@pytest.mark.parametrize("block_decode", ["fused", "treewise"])
@pytest.mark.parametrize("compute_mode", ["faithful", "deduped"])
def test_layer_coded_trajectory_matches_jax_monolithic(data, jdata, compute_mode, block_decode):
    jcfg = JRunConfig(**_kw(compute_mode=compute_mode, layer_coding="off"))
    want = j_trainer.train(jcfg, jdata)
    cfg = RunConfig(**_kw(compute_mode=compute_mode, layer_coding="on",
                          block_decode=block_decode))
    got = t_trainer.train(cfg, data, device="cpu", init_params=_jax_init(jcfg))
    assert got.lowering == "layer_block"
    for field in ("timeset", "worker_times", "collected", "decode_error"):
        a, b = np.asarray(getattr(got, field)), np.asarray(getattr(want, field))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    _close(_hist(got), want.params_history, TRAJ_TOL)


def test_monolithic_trajectory_matches_jax(data, jdata):
    jcfg = JRunConfig(**_kw(compute_mode="faithful", layer_coding="off"))
    want = j_trainer.train(jcfg, jdata)
    got = t_trainer.train(RunConfig(**_kw(compute_mode="faithful", layer_coding="off")), data,
                          device="cpu", init_params=_jax_init(jcfg))
    assert got.lowering == "per_slot"
    _close(_hist(got), want.params_history, TRAJ_TOL)


@pytest.mark.parametrize("compute_mode", ["faithful", "deduped"])
def test_fused_and_treewise_are_bitwise_equal(data, compute_mode):
    runs = [
        t_trainer.train(RunConfig(**_kw(compute_mode=compute_mode, layer_coding="on",
                                        block_decode=bd, rounds=4)), data, device="cpu")
        for bd in ("fused", "treewise")
    ]
    for a, b in zip(_leaves(_hist(runs[0])), _leaves(_hist(runs[1]))):
        assert a.tobytes() == b.tobytes()


def test_two_trajectory_cohort_matches_sequential_runs(data):
    cfgs = [RunConfig(**_kw(compute_mode="faithful", layer_coding="on", block_decode="fused",
                            lr_schedule=lr, seed=s)) for lr, s in ((0.1, 0), (0.05, 1))]
    assert all(t_trainer.cohort_eligible(c) for c in cfgs)
    got = t_trainer.train_cohort(cfgs, data, device="cpu")
    for c, g in zip(cfgs, got):
        assert g.cohort["cohort_lowering"] == "layer_block_vmap"
        single = t_trainer.train(c, data, device="cpu")
        for f in ("timeset", "worker_times", "decode_error"):
            assert np.asarray(getattr(g, f)).tobytes() == np.asarray(getattr(single, f)).tobytes()
        _close(_hist(g), _hist(single), TRAJ_TOL)


def test_attention_cli_run_writes_artifacts(tmp_path):
    argv = ["--scheme", "approx", "--workers", "4", "--stragglers", "1", "--num-collect", "3",
            "--rounds", "3", "--rows", "64", "--cols", "16", "--model", "attention",
            "--update-rule", "GD", "--lr", "0.5", "--layer-coding", "on", "--device", "cpu",
            "--output-dir", str(tmp_path), "--quiet", "--add-delay"]
    assert t_cli.main(argv) == 0
    loss = np.loadtxt(tmp_path / "approx_acc_1_training_loss.dat")
    assert loss.shape == (3,) and np.isfinite(loss).all()


# ---------------------------------------------------------------------------
# the decode-error-vs-depth series


@pytest.mark.parametrize("model,scheme,extra", [
    ("attention", "approx", {"num_collect": 5}),
    ("attention", "cyccoded", {}),
    ("deepmlp", "approx", {"num_collect": 6}),
    ("deepmlp", "avoidstragg", {}),
    ("moe", "repcoded", {}),
])
def test_block_decode_error_matches_jax(data, model, scheme, extra):
    cfg = RunConfig(**_kw(model=model, scheme=scheme, rounds=7, **extra))
    layout = t_trainer.build_layout(cfg)
    arr = j_straggler.arrival_schedule(7, W, True, 0.5)
    sched = t_trainer.build_schedule(cfg, arr, layout)
    tm = t_trainer.build_model(cfg)
    params = tm.init_params(1, N_COLS)
    spec = blocks.model_block_spec(tm, params)
    Xp, yp = partition_stack(data, layout.n_partitions)
    table = blocks.partition_block_table(tm, spec, params, torch.from_numpy(Xp),
                                         torch.from_numpy(yp))
    want = j_decode.block_decode_error(layout, sched.message_weights, table)
    got = t_decode.block_decode_error(layout, sched.message_weights, table)
    assert sorted(got) == sorted(want)
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), key
    # non-decreasing in depth every round
    assert (np.diff(got["cumulative"], axis=1) >= 0).all()
