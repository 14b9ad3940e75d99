"""The port's trajectory cohorts (train_cohort, train_batch, the cohort
decode, replay_batch) against the JAX package's.

Oracles, as tests/test_cohort.py states them for the JAX package:
  - JAX's own train_cohort on the same configs, started from its init draws
    (trainer._init_params_f32): control-plane arrays byte-equal, iterates
    within rtol 2e-5 / atol 1e-6 (float32 products reduced in another
    order), bfloat16 data within rtol 5e-2 / atol 5e-3 (the JAX cohort
    rounds the params to bfloat16 before its products, the port widens the
    data to float32);
  - each cohort member against the port's own sequential train(), at the
    same tolerances (autodiff families: rtol 5e-4 / atol 5e-5);
  - the layer-coded logistic cohort against JAX's; the layer-coded deepmlp
    cohort against JAX's monolithic (layer_coding="off") cohort, since the
    JAX trainer refuses layer-coded autodiff families on jax >= 0.6;
  - the cohort decode's plain version bitwise against its per-trajectory
    loop and within the B2 tolerance of ``jax.vmap`` of JAX's
    fused_block_decode, XLA and Pallas (interpret mode); the ``cuda``
    tests hold the kernel to it bitwise on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erasurehead_tpu.data.synthetic import generate_gmm as j_generate_gmm
from erasurehead_tpu.ops import kernels as j_kernels
from erasurehead_tpu.parallel import straggler as j_straggler
from erasurehead_tpu.train import evaluate as j_evaluate
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.utils import config as j_config
from erasurehead_tpu_torch.data.synthetic import generate_gmm
from erasurehead_tpu_torch.ops import blocks
from erasurehead_tpu_torch.ops import kernels as t_kernels
from erasurehead_tpu_torch.train import evaluate as t_evaluate
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils import config as t_config

W, ROUNDS = 8, 6
N_ROWS, N_COLS = 512, 24

SCHEME_EXTRAS = {  # tests/test_cohort.py's seven schemes
    "naive": {},
    "cyccoded": {},
    "repcoded": {},
    "approx": {"num_collect": 6},
    "avoidstragg": {},
    "randreg": {"num_collect": 6},
    "deadline": {"deadline": 1.0},
}
GLM_TOL = dict(rtol=2e-5, atol=1e-6)
BF16_TOL = dict(rtol=5e-2, atol=5e-3)
AUTODIFF_TOL = dict(rtol=5e-4, atol=5e-5)


def _kw(**kw):
    """tests/test_cohort.py::_cfg's run."""
    base = dict(
        scheme="approx", n_workers=W, n_stragglers=1, num_collect=6,
        rounds=ROUNDS, n_rows=N_ROWS, n_cols=N_COLS, update_rule="AGD",
        lr_schedule=0.5, add_delay=True, seed=3,
    )
    base.update(kw)
    return base


def _seven(**common):
    return [
        _kw(scheme=s, **{"compute_mode": "deduped", **common, **extra})
        for s, extra in SCHEME_EXTRAS.items()
    ]


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


def _hist(res):
    return blocks.tree_map(lambda h: h.numpy(), res.params_history)


def _assert_close(got, want, tol):
    for a, b in zip(_leaves(got), _leaves(want)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **tol)


def _assert_control_plane_equal(got, want):
    for field in ("timeset", "worker_times", "collected", "decode_error"):
        a, b = np.asarray(getattr(got, field)), np.asarray(getattr(want, field))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    assert got.sim_total_time == want.sim_total_time


def _cohort_pair(kws, data, jdata, **call):
    """The same cohort through JAX's train_cohort and the port's, the port
    started from JAX's init draws."""
    want = j_trainer.train_cohort([j_config.RunConfig(**kw) for kw in kws], jdata, **call)
    got = t_trainer.train_cohort(
        [t_config.RunConfig(**kw) for kw in kws], data, device="cpu",
        init_params=[_jax_init(r.config) for r in want], **call,
    )
    assert [r.config.seed for r in got] == [r.config.seed for r in want]
    return got, want


# ---------------------------------------------------------------------------
# config: the static signature and the batching switch


SIGNATURE_GRID = [
    {},
    dict(compute_mode="deduped", dtype="bfloat16"),
    dict(model="deepmlp", update_rule="GD", layer_coding="on", block_decode="fused"),
    dict(model="moe", deep_layers=2, update_rule="ADAM"),
    dict(model="linear", layer_coding="off", block_decode="treewise"),
    dict(scheme="cyccoded", use_pallas="off", seed=5),
]


@pytest.mark.parametrize("kw", SIGNATURE_GRID)
def test_static_signature_fields_are_jax_shared_keys(kw):
    t = t_config.RunConfig(**_kw(**kw)).static_signature_fields()
    j = j_config.RunConfig(**_kw(**kw)).static_signature_fields()
    # the port's keys are JAX's, in JAX's order, with JAX's values
    assert list(t) == [k for k in j if k in t]
    assert t == {k: j[k] for k in t}
    assert t_config.RunConfig(**_kw(**kw)).static_signature() == tuple(t.values())


@pytest.mark.parametrize(
    "flag,env",
    [
        (None, None), (None, ""), (None, "0"), (None, "1"), (None, "true"),
        (None, "no"), (None, "auto"), (None, " On "), ("on", "0"), ("off", None),
        ("auto", "1"), ("YES", None), ("sometimes", None), (None, "2"),
    ],
)
def test_resolve_batch_trajectories_matches_jax(flag, env, monkeypatch):
    monkeypatch.delenv(t_config.BATCH_TRAJECTORIES_ENV, raising=False)
    assert t_config.BATCH_TRAJECTORIES_ENV == j_config.BATCH_TRAJECTORIES_ENV
    try:
        want = j_config.resolve_batch_trajectories(flag, env=env)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            t_config.resolve_batch_trajectories(flag, env=env)
        assert str(got.value) == str(e)
        return
    assert t_config.resolve_batch_trajectories(flag, env=env) == want


def test_resolve_batch_trajectories_reads_the_environment(monkeypatch):
    monkeypatch.setenv(t_config.BATCH_TRAJECTORIES_ENV, "off")
    assert t_config.resolve_batch_trajectories() == "off"
    assert t_config.resolve_batch_trajectories("on") == "on"


# ---------------------------------------------------------------------------
# train_cohort against JAX's train_cohort


COHORT_CASES = {
    "deduped_seven": (_seven(), {}),
    "deduped_seven_bf16": (_seven(dtype="bfloat16"), {}),
    "faithful_repcoded_approx": (
        [_kw(scheme="repcoded", seed=0), _kw(scheme="approx", seed=1)], {},
    ),
    "lr_alpha_variants": (
        [
            _kw(compute_mode="deduped", lr_schedule=lr, alpha=a, seed=s)
            for lr, a, s in ((0.5, None, 0), (0.2, 0.01, 0), (1.0, 0.001, 7))
        ],
        {},
    ),
    "gd_linear_deduped": (
        [_kw(model="linear", update_rule="GD", lr_schedule=0.01, compute_mode="deduped",
             scheme=s, **SCHEME_EXTRAS[s]) for s in ("naive", "approx")],
        {},
    ),
}


@pytest.mark.parametrize("case", list(COHORT_CASES))
def test_train_cohort_matches_jax_cohort(case, data, jdata):
    kws, call = COHORT_CASES[case]
    got, want = _cohort_pair(kws, data, jdata, **call)
    tol = BF16_TOL if case.endswith("bf16") else GLM_TOL
    for g, w in zip(got, want):
        assert g.cohort["cohort_lowering"] == w.cache_info["cohort_lowering"] == "cohort_matmul"
        assert g.cohort["stack_mode"] == w.cache_info["stack_mode"]
        assert g.cohort["cohort_size"] == w.cache_info["cohort_size"] == len(kws)
        _assert_control_plane_equal(g, w)
        _assert_close(_hist(g), w.params_history, tol)
        assert g.n_train == w.n_train


def test_seeds_with_shared_arrivals_match_jax(data, jdata):
    arr = j_straggler.arrival_schedule(ROUNDS, W, add_delay=True, mean=0.5)
    kws = [_kw(compute_mode="deduped")]
    got, want = _cohort_pair(kws, data, jdata, seeds=[0, 5], arrivals=arr)
    assert [r.config.seed for r in got] == [0, 5]
    for g, w in zip(got, want):
        _assert_control_plane_equal(g, w)
        _assert_close(_hist(g), w.params_history, GLM_TOL)


def test_per_trajectory_arrival_list(data):
    arrs = [j_straggler.arrival_schedule(ROUNDS, W, True, mean=m) for m in (0.5, 2.0)]
    cfgs = [t_config.RunConfig(**_kw(compute_mode="deduped", seed=s)) for s in (0, 1)]
    got = t_trainer.train_cohort(cfgs, data, arrivals=arrs, device="cpu")
    for c, a, g in zip(cfgs, arrs, got):
        single = t_trainer.train(c, data, arrivals=a, device="cpu")
        _assert_control_plane_equal(g, single)
    with pytest.raises(ValueError, match="got 1 arrival matrices for 2 trajectories"):
        t_trainer.train_cohort(cfgs, data, arrivals=arrs[:1], device="cpu")


# ---------------------------------------------------------------------------
# each member against the port's own sequential train()


MEMBER_CASES = {
    "deduped_seven": (_seven(), GLM_TOL, "cohort_matmul"),
    "faithful_frc": ([_kw(scheme="repcoded"), _kw(scheme="approx", seed=4)], GLM_TOL,
                     "cohort_matmul"),
    "bf16": (_seven(dtype="bfloat16")[:3], GLM_TOL, "cohort_matmul"),
    "adam_off": ([_kw(compute_mode="deduped", update_rule="ADAM", lr_schedule=0.05,
                      use_pallas="off", seed=s) for s in (0, 1)], GLM_TOL, "cohort_matmul"),
    "mlp_per_slot": (
        [_kw(compute_mode="deduped", model="mlp", update_rule="GD", lr_schedule=0.1, seed=s)
         for s in (0, 1)],
        AUTODIFF_TOL, "per_slot_vmap",
    ),
    "deepmlp_layer_faithful": (
        [_kw(model="deepmlp", update_rule="GD", lr_schedule=lr, seed=s, layer_coding="on",
             block_decode="fused", deep_layers=2) for lr in (0.5, 0.25) for s in (0, 1)],
        AUTODIFF_TOL, "layer_block_vmap",
    ),
    "moe_layer_treewise": (
        [_kw(model="moe", update_rule="GD", lr_schedule=0.1, seed=s, layer_coding="on",
             block_decode="treewise", compute_mode="deduped") for s in (0, 1)],
        AUTODIFF_TOL, "layer_block_vmap",
    ),
}


@pytest.mark.parametrize("case", list(MEMBER_CASES))
def test_members_match_sequential_train(case, data):
    kws, tol, lowering = MEMBER_CASES[case]
    cfgs = [t_config.RunConfig(**kw) for kw in kws]
    before = dict(t_kernels.LAUNCHES)
    got = t_trainer.train_cohort(cfgs, data, device="cpu")
    assert t_kernels.LAUNCHES == before  # the CPU path launches nothing
    for c, g in zip(cfgs, got):
        assert g.cohort == {
            "cohort_size": len(cfgs), "cohort_lowering": lowering,
            "cohort_dispatches": 1,
            "stack_mode": "deduped" if c.compute_mode.value == "deduped" else "materialized",
        }
        assert g.layer_coded == (lowering == "layer_block_vmap") and not g.fused
        single = t_trainer.train(c, data, device="cpu")
        _assert_control_plane_equal(g, single)
        _assert_close(_hist(g), _hist(single), tol)
        _assert_close(g.final_params, single.final_params, tol)
        assert g.steps_per_sec > 0 and g.wall_time > 0


@pytest.mark.parametrize("block_decode", ["fused", "treewise"])
@pytest.mark.parametrize("compute_mode", ["faithful", "deduped"])
def test_layer_coded_logistic_cohort_matches_jax(data, jdata, compute_mode, block_decode):
    kws = [
        _kw(scheme=s, compute_mode=compute_mode, layer_coding="on", block_decode=block_decode,
            lr_schedule=1.0, seed=sd, **SCHEME_EXTRAS[s])
        for s, sd in (("approx", 0), ("repcoded", 1))
    ]
    got, want = _cohort_pair(kws, data, jdata)
    for g, w in zip(got, want):
        assert g.cohort["cohort_lowering"] == w.cache_info["cohort_lowering"] == "layer_block_vmap"
        _assert_control_plane_equal(g, w)
        _assert_close(_hist(g), w.params_history, GLM_TOL)


@pytest.mark.parametrize("block_decode", ["fused", "treewise"])
@pytest.mark.parametrize("compute_mode", ["faithful", "deduped"])
def test_deepmlp_cohort_matches_jax_monolithic_cohort(data, jdata, compute_mode, block_decode):
    common = dict(model="deepmlp", update_rule="GD", compute_mode=compute_mode, deep_layers=2)
    variants = [dict(lr_schedule=lr, seed=s) for lr in (0.5, 0.25) for s in (0, 1)]
    jcfgs = [j_config.RunConfig(**_kw(**common, **v, layer_coding="off")) for v in variants]
    want = j_trainer.train_cohort(jcfgs, jdata)
    assert want[0].cache_info["cohort_lowering"] == "per_slot_vmap"
    tcfgs = [t_config.RunConfig(**_kw(**common, **v, layer_coding="on", block_decode=block_decode))
             for v in variants]
    got = t_trainer.train_cohort(tcfgs, data, device="cpu",
                                 init_params=[_jax_init(c) for c in jcfgs])
    for g, w in zip(got, want):
        assert g.cohort["cohort_lowering"] == "layer_block_vmap"
        _assert_control_plane_equal(g, w)
        _assert_close(_hist(g), w.params_history, AUTODIFF_TOL)


def test_fused_and_treewise_cohorts_are_bitwise_equal(data):
    runs = []
    for bd in ("fused", "treewise"):
        cfgs = [t_config.RunConfig(**_kw(model="deepmlp", update_rule="GD", deep_layers=2,
                                         layer_coding="on", block_decode=bd, seed=s))
                for s in (0, 1)]
        runs.append(t_trainer.train_cohort(cfgs, data, device="cpu"))
    for a, b in zip(*runs):
        for x, y in zip(_leaves(_hist(a)), _leaves(_hist(b))):
            assert x.tobytes() == y.tobytes()


# ---------------------------------------------------------------------------
# grouping and refusals


def test_cohort_signature_groups_as_jax_does():
    keys = {t_trainer.cohort_signature(t_config.RunConfig(**kw)) for kw in _seven()}
    assert len(keys) == 1
    faithful = {
        s: t_trainer.cohort_signature(t_config.RunConfig(**_kw(scheme=s, **e)))
        for s, e in SCHEME_EXTRAS.items()
    }
    assert faithful["approx"] == faithful["repcoded"]
    assert faithful["approx"] != faithful["cyccoded"]
    assert t_trainer.cohort_signature(t_config.RunConfig(**_kw(use_pallas="on"))) is None
    assert not t_trainer.cohort_eligible(t_config.RunConfig(**_kw(use_pallas="on")))
    assert t_trainer.cohort_eligible(t_config.RunConfig(**_kw(use_pallas="off")))


def _refusal_pair(kws, data, jdata, **call):
    with pytest.raises(ValueError) as j_err:
        j_trainer.train_cohort([j_config.RunConfig(**kw) for kw in kws], jdata, **call)
    with pytest.raises(ValueError) as t_err:
        t_trainer.train_cohort([t_config.RunConfig(**kw) for kw in kws], data,
                               device="cpu", **call)
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize(
    "kws",
    [
        [],
        [_kw(use_pallas="on")],
        [_kw(), _kw(dtype="bfloat16")],  # mixed static signature
        [_kw(), _kw(rounds=ROUNDS + 1)],
        [_kw(compute_mode="deduped"), _kw(compute_mode="deduped", n_workers=4, num_collect=3)],
        [_kw(scheme="repcoded"), _kw(scheme="cyccoded")],  # different stacks
    ],
    ids=["empty", "pallas_on", "signature", "rounds", "workers", "stack"],
)
def test_cohort_refusals_carry_the_jax_messages(kws, data, jdata):
    _refusal_pair(kws, data, jdata)


def test_train_batch_matches_jax_and_keeps_its_refusals(data, jdata):
    kw = _kw(compute_mode="deduped")
    want = j_trainer.train_batch(j_config.RunConfig(**kw), jdata, [3, 11])
    cfg = t_config.RunConfig(**kw)
    got = t_trainer.train_batch(cfg, data, [3, 11], device="cpu")
    assert [r.config.seed for r in got] == [3, 11]
    assert got[0].cohort["cohort_size"] == 2 and got[0].cohort["cohort_dispatches"] == 1
    for g, w in zip(got, want):
        _assert_control_plane_equal(g, w)
    for bad_kw, seeds in (
        (_kw(scheme="cyccoded"), [0, 1]),  # seed-dependent layout
        (_kw(), []),
        (_kw(use_pallas="on"), [0]),
    ):
        with pytest.raises(ValueError) as j_err:
            j_trainer.train_batch(j_config.RunConfig(**bad_kw), jdata, seeds)
        with pytest.raises(ValueError) as t_err:
            t_trainer.train_batch(t_config.RunConfig(**bad_kw), data, seeds, device="cpu")
        assert str(t_err.value) == str(j_err.value)


def test_init_params_count_must_match(data):
    cfgs = [t_config.RunConfig(**_kw(compute_mode="deduped", seed=s)) for s in (0, 1)]
    with pytest.raises(ValueError, match="got 1 initial params for 2 trajectories"):
        t_trainer.train_cohort(cfgs, data, device="cpu", init_params=[np.zeros(N_COLS)])


def test_cohort_without_a_card_raises(monkeypatch, data):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_config.RunConfig(**_kw(compute_mode="deduped"))
    with pytest.raises(RuntimeError, match="cuda"):
        t_trainer.train_cohort([cfg], data)
    with pytest.raises(RuntimeError, match="cuda"):
        t_trainer.train_batch(cfg, data, [0, 1])


# ---------------------------------------------------------------------------
# the cohort decode's plain version


DEEP_SHAPES = [(2, 32, 32), (24, 32), (2, 32), (32,), (), (32,)]  # deepmlp, 2 layers


def _decode_case(B, lead, shapes, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    ws = rng.standard_normal((B,) + lead).astype(np.float32)
    ws.reshape(B, -1)[:, ::3] = 0.0
    leaves = [rng.standard_normal((B,) + lead + s).astype(np.float32) for s in shapes]
    return torch.from_numpy(ws), [torch.from_numpy(l).to(dtype) for l in leaves]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,lead", [(1, (6, 3)), (4, (6, 3)), (3, (18,))])
def test_cohort_decode_is_the_per_trajectory_loop(B, lead, dtype):
    contract = "ws" if len(lead) == 2 else "p"
    ws, leaves = _decode_case(B, lead, DEEP_SHAPES, seed=B + len(lead), dtype=dtype)
    before = dict(t_kernels.LAUNCHES)
    got = t_kernels.fused_block_decode_cohort(ws, leaves, contract)
    assert t_kernels.LAUNCHES == before
    for i, (out, shape) in enumerate(zip(got, DEEP_SHAPES)):
        assert out.dtype == dtype and tuple(out.shape) == (B,) + shape
        for b in range(B):
            want = t_kernels.fused_block_decode_leaves(ws[b], [leaf[b] for leaf in leaves])[i]
            assert torch.equal(out[b], want)
    ref = t_kernels.reference_block_decode_cohort(ws, leaves, contract)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def _s_major_batched(ws, leaf):
    """[B, M] weights and [B, M, D] rows in the contract's reduction order."""
    B = ws.shape[0]
    if ws.ndim == 3:
        return (np.ascontiguousarray(ws.swapaxes(1, 2)).reshape(B, -1),
                np.ascontiguousarray(leaf.swapaxes(1, 2)).reshape(B, ws[0].size, -1))
    return ws, leaf.reshape(B, ws.shape[1], -1)


@pytest.mark.parametrize("lead", [(6, 3), (18,)])
def test_cohort_decode_matches_jax_vmap(lead):
    contract = "ws" if len(lead) == 2 else "p"
    B = 3
    ws, leaves = _decode_case(B, lead, [(3, 5), (130,), ()], seed=21)
    got = t_kernels.fused_block_decode_cohort(ws, leaves, contract)
    for out, leaf in zip(got, leaves):
        wf, g = _s_major_batched(ws.numpy(), leaf.numpy())
        tol = 1e-6 * np.abs(wf[:, :, None] * g).sum(1) + 1e-7
        jw, jg = jnp.asarray(wf), jnp.asarray(g)
        for use_pallas in (False, True):
            want = jax.vmap(lambda w, x: j_kernels.fused_block_decode(
                w, x, use_pallas=use_pallas, interpret=use_pallas))(jw, jg)
            assert (np.abs(out.numpy().reshape(B, -1) - np.asarray(want)) <= tol).all()


def test_cohort_decode_matches_jax_vmap_bf16():
    ws, leaves = _decode_case(2, (6, 3), [(130,), (7,)], seed=22, dtype=torch.bfloat16)
    got = t_kernels.fused_block_decode_cohort(ws, leaves, "ws")
    for out, leaf in zip(got, leaves):
        got32 = out.float().numpy().reshape(2, -1)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(got32), 1e-30))) - 7)
        wf, g = _s_major_batched(ws.numpy(), leaf.float().numpy())
        jw, jg = jnp.asarray(wf), jnp.asarray(g).astype(jnp.bfloat16)
        for use_pallas in (False, True):
            want = jax.vmap(lambda w, x: j_kernels.fused_block_decode(
                w, x, use_pallas=use_pallas, interpret=use_pallas))(jw, jg)
            assert (np.abs(got32 - np.asarray(want.astype(jnp.float32))) <= ulp).all()


@pytest.mark.parametrize(
    "bad,contract",
    [
        (dict(ws=torch.zeros(2, 3)), "ws"),  # a 2-D ws is [B, P], not [B, W, S]
        (dict(ws=torch.zeros(2, 6, 1)), "p"),
        (dict(), "pw"),
        (dict(leaves=[torch.zeros(3, 6, 4)]), "p"),  # B differs
        (dict(leaves=[torch.zeros(2, 4, 6).transpose(1, 2)]), "p"),  # non-contiguous
        (dict(ws=torch.zeros(2, 6, dtype=torch.float64)), "p"),
        (dict(leaves=[]), "p"),
    ],
)
def test_cohort_decode_refuses_what_the_kernel_does_not_take(bad, contract):
    args = dict(ws=torch.zeros(2, 6), leaves=[torch.zeros(2, 6, 4), torch.zeros(2, 6)])
    args.update(bad)
    with pytest.raises(ValueError):
        t_kernels.fused_block_decode_cohort(args["ws"], args["leaves"], contract)


# ---------------------------------------------------------------------------
# replay_batch


@pytest.mark.parametrize("model", ["logistic", "linear", "deepmlp"])
def test_replay_batch_is_replay_per_lane_and_matches_jax(model, data, jdata):
    kws = [_kw(model=model, compute_mode="deduped", update_rule="GD",
               lr_schedule=0.01 if model == "linear" else 0.1, seed=s, deep_layers=2)
           for s in (0, 1, 2)]
    got = t_trainer.train_cohort([t_config.RunConfig(**kw) for kw in kws], data, device="cpu")
    tmodel = t_trainer.build_model(got[0].config)
    hists = blocks.tree_map(lambda *h: torch.stack(h), *[r.params_history for r in got])
    n = got[0].n_train
    args = (data.X_train[:n], data.y_train[:n], data.X_test, data.y_test)
    batch = t_evaluate.replay_batch(tmodel, model, hists, *args)
    assert batch.training_loss.shape == (3, ROUNDS)
    jhists = blocks.tree_map(lambda h: jnp.asarray(h.numpy()), hists)
    jmodel = j_trainer.build_model(j_config.RunConfig(**kws[0]))
    jargs = (jdata.X_train[:n], jdata.y_train[:n], jdata.X_test, jdata.y_test)
    want = j_evaluate.replay_batch(jmodel, model, jhists, *jargs)
    for b, r in enumerate(got):
        lane = t_evaluate.replay(tmodel, model, r.params_history, *args)
        for field in ("training_loss", "testing_loss", "auc"):
            a, w = getattr(batch, field)[b], getattr(lane, field)
            assert a.tobytes() == w.tobytes(), field
    for field in ("training_loss", "testing_loss", "auc"):
        np.testing.assert_allclose(getattr(batch, field), getattr(want, field),
                                   rtol=1e-5, atol=1e-6, err_msg=field)


# ---------------------------------------------------------------------------
# on the card


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,lead,shapes",
    [
        (1, (30, 3), DEEP_SHAPES),
        (4, (30, 3), DEEP_SHAPES),
        (28, (30, 3), DEEP_SHAPES),
        (4, (90,), DEEP_SHAPES),  # the [B, P] contract
        (3, (30, 3), [(d,) for d in range(1, 41)]),  # 40 leaves: two launches
    ],
)
def test_cuda_cohort_decode_bitwise(B, lead, shapes, dtype):
    _cuda_or_skip()
    contract = "ws" if len(lead) == 2 else "p"
    ws, leaves = _decode_case(B, lead, shapes, seed=B, dtype=dtype)
    ws, leaves = ws.cuda(), [leaf.cuda() for leaf in leaves]
    before = t_kernels.LAUNCHES["fused_block_decode"]
    got = t_kernels.fused_block_decode_cohort(ws, leaves, contract)
    assert t_kernels.LAUNCHES["fused_block_decode"] == before + -(-len(shapes) // 32)
    want = t_kernels.reference_block_decode_cohort(ws, leaves, contract)
    per = [t_kernels.fused_block_decode_leaves(ws[b], [leaf[b] for leaf in leaves])
           for b in range(B)]
    torch.cuda.synchronize()
    for i, out in enumerate(got):
        assert torch.equal(out, want[i])
        assert all(torch.equal(out[b], per[b][i]) for b in range(B))
