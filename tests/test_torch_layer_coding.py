"""The port's layer-coded (blockwise) training against the JAX package.

Oracles:
  (a) GLMs: the JAX trainer trains ``layer_coding="on"`` for a GLM, so the
      port's run is held to it flag for flag: control plane byte-equal,
      iterates to the JAX trainer tolerance (rtol 2e-4, atol 1e-5: float32
      sums in another order, carried forward by AGD).
  (b) mlp, deepmlp, moe: the JAX trainer refuses ``layer_coding="on"`` for
      its autodiff families on jax >= 0.6 (its implicit-psum gate), so the
      port's layer-coded run is held to JAX's monolithic
      ``layer_coding="off"`` run with the JAX deep-coding tests' own
      tolerance (rtol 5e-4, atol 5e-5; tests/test_deep_coding.py::_close).
  (c) one round's decoded gradient against JAX's pieces: per-slot
      ``grad_sum`` under ``jax.vmap``, then JAX's Pallas decode kernel (in
      interpret mode) leaf by leaf, s-major for the faithful contract.
  (d) inside the port: the fused and treewise lowerings are bitwise equal
      (both reduce through the one decode kernel in the same order), and
      layer coding on agrees with off.
Params start from JAX's draw (trainer._init_params_f32), carried across.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erasurehead_tpu import cli as j_cli
from erasurehead_tpu.data.synthetic import generate_gmm as j_generate_gmm
from erasurehead_tpu.ops import kernels as j_kernels
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.utils.config import RunConfig as JRunConfig
from erasurehead_tpu_torch import cli as t_cli
from erasurehead_tpu_torch.data.sharding import partition_stack, worker_stack
from erasurehead_tpu_torch.data.synthetic import generate_gmm
from erasurehead_tpu_torch.models.glm import params_from_numpy
from erasurehead_tpu_torch.ops import blocks
from erasurehead_tpu_torch.parallel import step as t_step
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils.config import RunConfig

W, ROUNDS = 8, 3
N_ROWS, N_COLS = 256, 64


def _kw(**kw):
    """tests/test_deep_coding.py::_cfg's run: W=8, 256 x 64, 3 rounds, GD."""
    base = dict(
        scheme="approx", model="mlp", n_workers=W, n_stragglers=1,
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
    p = j_trainer._init_params_f32(jcfg, model, N_COLS)
    return jax.tree.map(np.asarray, p)


def _leaves(tree):
    """Leaves in sorted-key order (JAX's order for a dict) as numpy."""
    if isinstance(tree, dict):
        return [np.asarray(tree[k]) for k in sorted(tree)]
    return [np.asarray(tree)]


def _close(a, b, rtol, atol):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape
        np.testing.assert_allclose(
            np.asarray(x, np.float64), np.asarray(y, np.float64), rtol=rtol, atol=atol
        )


def _hist(res):
    return blocks.tree_map(lambda h: h.numpy(), res.params_history)


# ---------------------------------------------------------------------------
# (a) GLM: the JAX trainer's own layer-coded run


@pytest.mark.parametrize("block_decode", ["fused", "treewise"])
@pytest.mark.parametrize("compute_mode", ["faithful", "deduped"])
@pytest.mark.parametrize("scheme", ["approx", "cyccoded"])
def test_glm_layer_coded_matches_jax_trainer(data, jdata, scheme, compute_mode, block_decode):
    kw = _kw(
        model="logistic", scheme=scheme, compute_mode=compute_mode,
        num_collect=6 if scheme == "approx" else None, update_rule="AGD",
        lr_schedule=1.0, layer_coding="on", block_decode=block_decode,
    )
    jcfg = JRunConfig(**kw)
    want = j_trainer.train(jcfg, jdata)
    got = t_trainer.train(RunConfig(**kw), data, device="cpu", init_params=_jax_init(jcfg))
    assert got.layer_coded and not got.fused
    for field in ("timeset", "worker_times", "collected", "decode_error"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    _close(_hist(got), want.params_history, rtol=2e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# (b) deep families: the JAX trainer's monolithic run


@pytest.mark.parametrize("block_decode", ["fused", "treewise"])
@pytest.mark.parametrize(
    "model,compute_mode",
    [("deepmlp", "faithful"), ("deepmlp", "deduped"), ("moe", "deduped"), ("mlp", "faithful")],
)
def test_deep_layer_coded_matches_jax_monolithic(data, jdata, model, compute_mode, block_decode):
    jcfg = JRunConfig(**_kw(model=model, compute_mode=compute_mode, layer_coding="off"))
    want = j_trainer.train(jcfg, jdata)
    cfg = RunConfig(**_kw(
        model=model, compute_mode=compute_mode, layer_coding="on", block_decode=block_decode,
    ))
    got = t_trainer.train(cfg, data, device="cpu", init_params=_jax_init(jcfg))
    assert got.layer_coded
    np.testing.assert_array_equal(got.timeset, want.timeset)
    np.testing.assert_array_equal(got.decode_error, want.decode_error)
    _close(_hist(got), want.params_history, rtol=5e-4, atol=5e-5)


# ---------------------------------------------------------------------------
# (c) one round's decode against JAX's per-slot grads + Pallas decode


_ROUND_CASES = {}


def _round_case(data, model, faithful):
    """One round's inputs and JAX's decoded gradient: per-slot grads, then
    its Pallas decode (interpret mode) per leaf, s-major for "ws"
    (step._fused_layer_block_local_body's order). Cached per case: both
    port lowerings are held to the same oracle."""
    key = (model, faithful)
    if key in _ROUND_CASES:
        return _ROUND_CASES[key]
    jcfg = JRunConfig(**_kw(model=model))
    jmodel = j_trainer.build_model(jcfg)
    jp_np = _jax_init(jcfg)
    jp = jax.tree.map(jnp.asarray, jp_np)
    layout = t_trainer.build_layout(RunConfig(**_kw(model=model)))
    Xp, yp = partition_stack(data, layout.n_partitions)
    rng = np.random.default_rng(9)
    if faithful:
        Xs, ys = worker_stack(layout, Xp, yp)
        ws = rng.standard_normal(Xs.shape[:2]).astype(np.float32)
        ws[::3, 0] = 0.0
    else:
        Xs, ys = Xp, yp
        ws = rng.standard_normal(Xs.shape[:1]).astype(np.float32)
    contract = "ws" if faithful else "p"
    per = lambda X, y: jmodel.grad_sum(jp, X, y)
    for _ in contract:
        per = jax.vmap(per)
    grads = per(jnp.asarray(Xs), jnp.asarray(ys))
    wf = jnp.asarray(ws.T.reshape(-1) if faithful else ws)
    want = {}
    for k, leaf in grads.items():
        if faithful:
            leaf = jnp.moveaxis(leaf, 1, 0)
        g2 = leaf.reshape(wf.shape[0], -1)
        dec = j_kernels.fused_block_decode(wf, g2, use_pallas=True, interpret=True)
        want[k] = np.asarray(dec).reshape(leaf.shape[len(contract):])
    _ROUND_CASES[key] = (jp_np, np.asarray(Xs), np.asarray(ys), ws, want)
    return _ROUND_CASES[key]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("model", ["deepmlp", "moe"])
def test_one_round_decode_matches_jax_pieces(data, model, faithful, fused):
    jp_np, Xs, ys, ws, want = _round_case(data, model, faithful)
    tmodel = t_trainer.build_model(RunConfig(**_kw(model=model)))
    tp = params_from_numpy(jp_np)
    spec = blocks.model_block_spec(tmodel, tp)
    fn = t_step.make_layer_block_grad_fn(tmodel, spec, faithful=faithful, fused=fused)
    got = fn(tp, torch.from_numpy(Xs), torch.from_numpy(ys), torch.from_numpy(ws))
    assert sorted(got) == sorted(want)
    # per-slot float32 autodiff in another order, then a weighted sum
    _close(got, want, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# (d) inside the port


@pytest.mark.parametrize("compute_mode", ["faithful", "deduped"])
@pytest.mark.parametrize("model", ["logistic", "mlp", "deepmlp", "moe"])
def test_fused_equals_treewise_bitwise_and_on_matches_off(data, model, compute_mode):
    runs = {}
    for lc, bd in (("on", "fused"), ("on", "treewise"), ("off", "auto")):
        cfg = RunConfig(**_kw(
            model=model, compute_mode=compute_mode, layer_coding=lc,
            block_decode=bd, use_pallas="off",
        ))
        runs[lc, bd] = t_trainer.train(cfg, data, device="cpu")
        assert runs[lc, bd].layer_coded == (lc == "on")
    fused, tree, off = (_leaves(_hist(r)) for r in runs.values())
    for a, b in zip(fused, tree):
        assert a.tobytes() == b.tobytes()
    _close(_hist(runs["on", "fused"]), _hist(runs["off", "auto"]), rtol=5e-4, atol=5e-5)


def test_auto_resolutions():
    """layer_coding "auto" is off (as in the JAX package); block_decode
    "auto" is fused (the port's stance: the tune plane is not ported)."""
    model = t_trainer.build_model(RunConfig(model="deepmlp"))
    assert t_step.supports_layer_coding(model)
    assert not t_step.resolve_layer_coding("auto", model)
    assert t_step.resolve_layer_coding("on", model)
    assert t_step.resolve_block_decode("auto")
    assert not t_step.resolve_block_decode("treewise")


@pytest.mark.parametrize("use_pallas", ["auto", "off"])
def test_glm_layer_coding_on_takes_the_blockwise_decode(data, use_pallas):
    """use_pallas "auto" on a GLM with layer_coding "on" takes the blockwise
    decode, not the fused GLM kernel (the JAX trainer's dispatch)."""
    cfg = RunConfig(**_kw(model="logistic", layer_coding="on", use_pallas=use_pallas))
    res = t_trainer.train(cfg, data, device="cpu")
    assert res.layer_coded and not res.fused
    assert tuple(res.params_history.shape) == (ROUNDS, N_COLS)


def test_deep_history_is_a_dict_of_round_stacks(data):
    cfg = RunConfig(**_kw(model="deepmlp", deep_layers=2, layer_coding="on", update_rule="ADAM"))
    res = t_trainer.train(cfg, data, device="cpu")
    hist = res.params_history
    assert sorted(hist) == ["W", "W_in", "b", "b_in", "b_out", "w_out"]
    assert tuple(hist["W"].shape) == (ROUNDS, 2, 32, 32)
    assert tuple(hist["b_out"].shape) == (ROUNDS,)
    for k, v in hist.items():
        assert torch.isfinite(v).all(), k
        assert torch.equal(v[-1], res.final_params[k]), k


# ---------------------------------------------------------------------------
# (e) refusals and the CLI


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(layer_coding="sometimes"), "layer_coding must be auto/on/off"),
        (dict(block_decode="rowwise"), "block_decode must be auto/fused/treewise"),
        (dict(deep_layers=-1), "deep_layers must be >= 0"),
        (
            dict(layer_coding="on", use_pallas="on"),
            "layer_coding='on' and use_pallas='on' both force a gradient lowering; force at most one",
        ),
    ],
)
def test_config_refusals_carry_the_jax_messages(kw, match):
    with pytest.raises(ValueError, match=match) as t_err:
        RunConfig(**kw)
    with pytest.raises(ValueError) as j_err:
        JRunConfig(**kw)
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("model", ["mlp", "deepmlp", "moe"])
def test_use_pallas_on_needs_a_glm(data, model):
    cfg = RunConfig(**_kw(model=model, use_pallas="on"))
    with pytest.raises(ValueError, match="use_pallas='on' needs a dense logistic/linear stack"):
        t_trainer.train(cfg, data, device="cpu")


def test_deep_cuda_requested_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        t_cli.main([
            "--model", "deepmlp", "--layer-coding", "on", "--rows", "64",
            "--cols", "8", "--rounds", "1", "--quiet",
        ])


def test_cli_deepmlp_writes_the_jax_artifact_names(tmp_path):
    flags = [
        "--scheme", "approx", "--workers", "6", "--stragglers", "2",
        "--num-collect", "3", "--rounds", "3", "--rows", "120",
        "--cols", "16", "--add-delay", "--model", "deepmlp", "--lr", "0.5",
        "--deep-layers", "2", "--quiet",
    ]
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    assert j_cli.main(flags + ["--layer-coding", "off", "--output-dir", str(jdir)]) == 0
    assert t_cli.main(flags + [
        "--layer-coding", "on", "--block-decode", "treewise",
        "--output-dir", str(tdir), "--device", "cpu",
    ]) == 0
    names = sorted(os.listdir(tdir))
    assert names == sorted(os.listdir(jdir))
    assert len([n for n in names if n.endswith(".dat")]) == 5
    (manifest,) = [n for n in names if n.endswith("manifest.json")]
    config = json.loads((tdir / manifest).read_text())["config"]
    assert (config["model"], config["layer_coding"], config["block_decode"], config["deep_layers"]) == (
        "deepmlp", "on", "treewise", 2,
    )
    for name in names:
        if name.endswith(".dat"):
            assert np.isfinite(np.loadtxt(tdir / name)).all(), name
