"""The port's on-device control plane against the JAX package's.

Mirrors tests/test_dynamic.py, with JAX's functions called directly as the
oracle on the same numpy inputs:

  - utils/threefry: the bits bitwise equal to ``jax.random.bits`` over a
    grid of seeds and rounds, the exponentials (and the delay schedule)
    within relative 1e-6 of JAX's (``log1p`` rounds differently by an ulp);
  - every built-in scheme's dynamic rule against JAX's jnp rule and the
    port's host rule (parallel/collect.py) on shared float32 arrival
    matrices, deadline's empty round included, with tests/test_dynamic.py's
    tolerances; the float32 solve checked by its reconstruction;
  - the straggler-pattern rank and the float64 decode table: the table
    byte-equal to JAX's, the rank equal for every pattern at W = 30, s <= 3;
  - ``train_dynamic`` against JAX's ``train_dynamic``: collected sets equal,
    clocks within relative 1e-6, iterates within rtol 1e-4 / atol 1e-5;
    the split restart bitwise; the flat lowerings allclose to the per-slot
    one; the refusals with JAX's messages.
"""

import itertools
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erasurehead_tpu import schemes as j_schemes
from erasurehead_tpu.data.synthetic import generate_gmm as j_generate_gmm
from erasurehead_tpu.ops import codes as j_codes
from erasurehead_tpu.parallel import dynamic as j_dynamic
from erasurehead_tpu.parallel import straggler as j_straggler
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.utils.config import RunConfig as JRunConfig
from erasurehead_tpu_torch import schemes as t_schemes
from erasurehead_tpu_torch.data.synthetic import generate_gmm
from erasurehead_tpu_torch.ops import blocks
from erasurehead_tpu_torch.ops import codes as t_codes
from erasurehead_tpu_torch.parallel import collect as t_collect
from erasurehead_tpu_torch.parallel import dynamic as t_dynamic
from erasurehead_tpu_torch.parallel import step as t_step
from erasurehead_tpu_torch.parallel import straggler as t_straggler
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils import threefry
from erasurehead_tpu_torch.utils.config import PipelineRefusal, RunConfig

R, W, S = 8, 12, 2

#: the scheme-specific knobs each built-in needs at W = 12, s = 2
KNOBS = {
    "approx": dict(num_collect=8),
    "randreg": dict(num_collect=8),
    "sparsegraph": dict(num_collect=8),
    "expander": dict(num_collect=8),
    "deadline": dict(deadline=1.0),
    "partialcyccoded": dict(partitions_per_worker=S + 2),
    "partialrepcoded": dict(partitions_per_worker=S + 2),
}


@pytest.fixture(scope="module")
def arrivals():
    # float32, as the on-device rules take them; one round where nobody
    # makes deadline's cutoff
    t = j_straggler.arrival_schedule(R, W, add_delay=True).astype(np.float32)
    t[2] += 10.0
    return t


# ---------------------------------------------------------------------------
# threefry


@pytest.mark.parametrize("seed", [0, 1, 8, 12345, 2**31 - 1])
def test_threefry_bits_and_exponentials_match_jax(seed):
    for r in (0, 1, 3, 99, 2**31 + 3):
        jk = jax.random.fold_in(jax.random.key(seed), r)
        tk = threefry.fold_in(threefry.key(seed), r)
        want = np.asarray(jax.random.bits(jk, (257,), jnp.uint32)).astype(np.int64)
        got = threefry.random_bits(tk, 257).numpy()
        assert got.dtype == np.int64 and np.array_equal(got, want), (seed, r)
        je = np.asarray(jax.random.exponential(jk, (257,)))
        te = threefry.exponential(tk, 257).numpy()
        assert te.dtype == np.float32
        np.testing.assert_allclose(te, je, rtol=1e-6, atol=0)
        ju = np.asarray(jax.random.uniform(jk, (257,)))
        assert np.array_equal(threefry.uniform(tk, 257).numpy(), ju)


def test_threefry_delay_schedule_matches_jax():
    want = np.asarray(j_straggler.jax_delay_schedule(jax.random.key(4), 6, W, mean=0.5))
    got = t_straggler.threefry_delay_schedule(threefry.key(4), 6, W, mean=0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the rules


def _rows(rule, t, tensor):
    if tensor is jnp.asarray:
        rule = jax.jit(rule)  # as JAX's train_dynamic runs it
    outs = [rule(tensor(t[r])) for r in range(t.shape[0])]
    return (
        np.stack([np.asarray(o.message_weights, np.float32) for o in outs]),
        np.array([float(o.sim_time) for o in outs]),
        np.stack([np.asarray(o.collected) for o in outs]),
    )


def _cfg_kw(scheme, **kw):
    return dict(scheme=scheme, n_workers=W, n_stragglers=S, rounds=R, n_rows=16 * W,
                n_cols=16, **KNOBS.get(scheme, {}), **kw)


@pytest.mark.parametrize("scheme", t_schemes.names())
def test_every_dynamic_rule_matches_jax_and_host(arrivals, scheme):
    cfg = RunConfig(**_cfg_kw(scheme))
    jcfg = JRunConfig(**_cfg_kw(scheme))
    layout = t_trainer.build_layout(cfg)
    jlayout = j_trainer.build_layout(jcfg)
    assert np.array_equal(layout.assignment, np.asarray(jlayout.assignment))
    kw = dict(num_collect=cfg.num_collect, deadline=cfg.deadline)
    rule = t_schemes.get(scheme).dynamic_rule(layout, device="cpu", **kw)
    jrule = j_schemes.get(scheme).dynamic_rule(jlayout, **kw)
    w, sim, col = _rows(rule, arrivals, torch.from_numpy)
    jw, jsim, jcol = _rows(jrule, arrivals, jnp.asarray)
    host = t_trainer.build_schedule(cfg, arrivals.astype(np.float64), layout)
    np.testing.assert_array_equal(col, jcol)
    np.testing.assert_array_equal(col, host.collected)
    np.testing.assert_allclose(sim, jsim, rtol=1e-6)
    np.testing.assert_allclose(sim, host.sim_time, rtol=1e-6)
    # the MDS family decodes through the float64 table (W = 12 fits its cap)
    np.testing.assert_allclose(w, jw, rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(w, host.message_weights, rtol=2e-4, atol=1e-4)


def test_deadline_rule_empty_round(arrivals):
    rs = t_dynamic.collect_deadline(torch.from_numpy(arrivals[2]), 1.0)
    assert not rs.collected.any() and float(rs.message_weights.abs().sum()) == 0.0
    assert float(rs.sim_time) == 1.0


@pytest.mark.parametrize("num_collect", [4, 7, 10])
def test_agc_rule_matches_jax(arrivals, num_collect):
    layout = t_codes.frc_layout(W, S)
    onehot = torch.from_numpy(t_dynamic._group_onehot(layout.groups)).float()
    jonehot = jnp.asarray(j_dynamic._group_onehot(layout.groups))
    got = _rows(lambda t: t_dynamic.collect_agc(t, onehot, num_collect), arrivals,
                torch.from_numpy)
    want = _rows(lambda t: j_dynamic.collect_agc_jnp(t, jonehot, num_collect), arrivals,
                 jnp.asarray)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("partial", [False, True])
def test_float32_solve_reconstructs(arrivals, partial):
    """Without a table the MDS rules take the float32 solve: collected sets
    and clocks equal to JAX's and the host's, the decode reconstructing the
    all-ones vector (small W keeps float32 conditioning safe)."""
    if partial:
        layout = t_codes.partial_cyclic_layout(W, S + 2, S, seed=0)
        B = torch.from_numpy(layout.B).float()
        rule = lambda t: t_dynamic.collect_partial(  # noqa: E731
            t, variant="mds", frac=layout.uncoded_frac, n_stragglers=S, B=B)
        jrule = lambda t: j_dynamic.collect_partial_jnp(  # noqa: E731
            t, variant="mds", frac=layout.uncoded_frac, n_stragglers=S,
            B=jnp.asarray(layout.B, jnp.float32))
        host = t_collect.collect_partial(arrivals.astype(np.float64), layout, "mds")
    else:
        layout = t_codes.cyclic_mds_layout(W, S, seed=0)
        B = torch.from_numpy(layout.B).float()
        rule = lambda t: t_dynamic.collect_first_k_mds(t, B, S)  # noqa: E731
        jrule = lambda t: j_dynamic.collect_first_k_mds_jnp(  # noqa: E731
            t, jnp.asarray(layout.B, jnp.float32), S)
        host = t_collect.collect_first_k_mds(arrivals.astype(np.float64), layout.B, S)
    w, sim, col = _rows(rule, arrivals, torch.from_numpy)
    jw, jsim, jcol = _rows(jrule, arrivals, jnp.asarray)
    np.testing.assert_array_equal(col, jcol)
    np.testing.assert_array_equal(col, host.collected)
    np.testing.assert_allclose(sim, host.sim_time, rtol=1e-6)
    np.testing.assert_allclose(w @ layout.B, np.ones((R, W)), atol=5e-3)
    np.testing.assert_allclose(jw @ layout.B, np.ones((R, W)), atol=5e-3)
    assert (w[~col] == 0).all()


def test_ranks_tie_break_matches_order():
    t = torch.tensor([0.0, 0.0, 1.0, 0.0])
    assert t_dynamic._ranks(t).tolist() == [0, 1, 3, 2]  # index order among ties
    assert np.asarray(j_dynamic._ranks(jnp.asarray(t.numpy()))).tolist() == [0, 1, 3, 2]


def test_supports_dynamic_agrees_with_the_rule():
    for name in t_schemes.names():
        desc = t_schemes.get(name)
        assert desc.supports_dynamic == (desc.dynamic_rule is not None), name
        assert desc.capabilities() == j_schemes.get(name).capabilities(), name


def test_table_cap_warns_as_jax():
    """randreg collecting half of W = 30 needs C(30, 15) rows: no table, the
    JAX package's warning, the float32 solve."""
    cfg = RunConfig(scheme="randreg", n_workers=30, n_stragglers=2, num_collect=15,
                    n_rows=480, n_cols=8)
    jcfg = JRunConfig(scheme="randreg", n_workers=30, n_stragglers=2, num_collect=15,
                      n_rows=480, n_cols=8)
    with pytest.warns(UserWarning) as got:
        t_schemes.get("randreg").dynamic_rule(t_trainer.build_layout(cfg), num_collect=15,
                                              device="cpu")
    with warnings.catch_warnings(record=True) as want:
        warnings.simplefilter("always")
        j_schemes.get("randreg").dynamic_rule(j_trainer.build_layout(jcfg), num_collect=15)
    assert [str(w.message) for w in got] == [str(w.message) for w in want]


def test_expand_slot_weights_tensor_path():
    layout = t_codes.partial_cyclic_layout(W, S + 2, S, seed=0)
    mw = np.random.default_rng(0).normal(size=(3, W))
    host = t_step.expand_slot_weights(mw, layout.coeffs, np.asarray(layout.slot_is_coded))
    assert host.dtype == np.float64
    got = t_step.expand_slot_weights(
        torch.from_numpy(mw), torch.from_numpy(layout.coeffs),
        torch.from_numpy(np.asarray(layout.slot_is_coded)))
    assert isinstance(got, torch.Tensor) and np.array_equal(got.numpy(), host)


# ---------------------------------------------------------------------------
# the decode table and the pattern rank


def test_decode_table_byte_equal_to_jax():
    B = t_codes.cyclic_mds_layout(30, S, seed=0).B
    table = t_codes.build_decode_table(B, S)
    jtable = j_codes.build_decode_table(B, S)
    for field in ("table", "offsets", "comb"):
        a, b = getattr(table, field), getattr(jtable, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    # lookups against the host float64 solve, and JAX's traced rank
    rng = np.random.default_rng(S)
    masks = np.ones((20, 30), bool)
    comb = torch.from_numpy(table.comb.astype(np.int64))
    for m in masks:
        m[rng.choice(30, size=rng.integers(0, S + 1), replace=False)] = False
        assert int(j_codes.straggler_pattern_index_jnp(jnp.asarray(~m), S, jtable.comb)) == \
            int(t_codes.straggler_pattern_index_t(torch.from_numpy(~m), S, comb))
    got = np.stack([table.lookup(torch.from_numpy(m)).numpy() for m in masks])
    want = t_codes.mds_decode_weights_host(B, masks)
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(got @ B, np.ones((20, 30)), atol=5e-3)


def test_every_pattern_rank_at_w30():
    """The rank of every straggler set of size 0..3 at W = 30 (4,526 sets) is
    its row in the enumeration: the traced rank (vmapped over the sets) and
    the host rank."""
    s = 3
    comb = torch.tensor([[math.comb(n, r) for r in range(s + 1)] for n in range(31)])
    masks, rows = [], []
    for r in range(s + 1):
        for k, pattern in enumerate(itertools.combinations(range(30), r)):
            mask = np.zeros(30, bool)
            mask[list(pattern)] = True
            masks.append(mask)
            rows.append(k)
            assert t_codes.straggler_pattern_index(mask) == k
    got = torch.func.vmap(lambda m: t_codes.straggler_pattern_index_t(m, s, comb))(
        torch.from_numpy(np.stack(masks)))
    assert got.tolist() == rows


def test_exact_only_table_and_enumeration_match_jax():
    """The first-k rules index only the exactly-s block: built alone it fits
    a cap the 0..s range exceeds (1 + 12 + 66 + 220 rows against 220)."""
    B = t_codes.cyclic_mds_layout(W, 3, seed=0).B
    assert t_codes.build_decode_table(B, 3, cap_rows=250) is None
    assert j_codes.build_decode_table(B, 3, cap_rows=250) is None
    table = t_codes.build_decode_table(B, 3, cap_rows=250, exact_only=True)
    jtable = j_codes.build_decode_table(B, 3, cap_rows=250, exact_only=True)
    assert table.offsets.tolist() == [0, 0, 0, 0]
    assert table.table.shape == (math.comb(W, 3), W)
    assert table.table.tobytes() == jtable.table.tobytes()
    assert t_codes.enumerate_decode_table(B, 2).tobytes() == \
        j_codes.enumerate_decode_table(B, 2).tobytes()
    mask = np.ones(W, bool)
    mask[[1, 5, 9]] = False
    got = table.lookup(torch.from_numpy(mask)).numpy()
    want = t_codes.mds_decode_weights_host(B, mask[None])[0]
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=2e-4, atol=1e-4)


def test_mds_decode_weights_matches_jax():
    B = t_codes.cyclic_mds_layout(W, S, seed=1).B.astype(np.float32)
    mask = np.ones(W, bool)
    mask[[3, 7]] = False
    got = t_codes.mds_decode_weights(torch.from_numpy(B), torch.from_numpy(mask)).numpy()
    want = np.asarray(j_codes.mds_decode_weights(jnp.asarray(B), jnp.asarray(mask)))
    assert (got[~mask] == 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# train_dynamic


def _train_kw(scheme, **kw):
    base = dict(scheme=scheme, n_workers=W, n_stragglers=S, rounds=10, n_rows=16 * W,
                n_cols=16, lr_schedule=1.0, update_rule="AGD", add_delay=True, seed=0)
    base.update({**KNOBS.get(scheme, {}), **kw})
    if scheme == "deadline":
        base["deadline"] = 1.5
    return base


def _jax_init(jcfg, n_cols=16):
    model = j_trainer.build_model(jcfg)
    return jax.tree.map(np.asarray, j_trainer._init_params_f32(jcfg, model, n_cols))


def _hist(res):
    return [h.numpy() for h in blocks.tree_leaves(res.params_history)]


def _parts(cfg):
    return (cfg.partitions_per_worker - cfg.n_stragglers) * W if cfg.partitions_per_worker else W


@pytest.mark.parametrize("scheme,extra", [
    ("approx", {}), ("cyccoded", {}), ("naive", {}), ("deadline", {}),
    ("partialrepcoded", {}), ("partialcyccoded", {}),
    ("approx", dict(model="mlp", update_rule="GD")),
])
def test_train_dynamic_matches_jax(scheme, extra):
    kw = _train_kw(scheme, **extra)
    cfg, jcfg = RunConfig(**kw), JRunConfig(**kw)
    data = generate_gmm(cfg.n_rows, cfg.n_cols, n_partitions=_parts(cfg), seed=0)
    jdata = j_generate_gmm(cfg.n_rows, cfg.n_cols, n_partitions=_parts(cfg), seed=0)
    want = j_trainer.train_dynamic(jcfg, jdata)
    got = t_trainer.train_dynamic(cfg, data, device="cpu", init_params=_jax_init(jcfg))
    assert got.lowering == ("fused" if cfg.model.value == "logistic" else "per_slot")
    np.testing.assert_array_equal(got.collected, want.collected)
    np.testing.assert_allclose(got.timeset, want.timeset, rtol=1e-6)
    np.testing.assert_allclose(got.worker_times, want.worker_times, rtol=1e-6)
    assert ((got.worker_times == -1.0) == ~got.collected).all()
    for a, b in zip(_hist(got), [np.asarray(x) for x in jax.tree.leaves(want.params_history)]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def _approx_kw(rounds, lr, **kw):
    return {**dict(scheme="approx", n_workers=W, n_stragglers=2, num_collect=8, rounds=rounds,
                   n_rows=16 * W, n_cols=12, lr_schedule=lr, update_rule="AGD",
                   add_delay=True, seed=0), **kw}


def test_train_dynamic_split_restart_is_bitwise():
    """Per-round randomness is fold_in(key, absolute round) and lr is
    indexed absolutely, so a run split at any round and resumed from its
    carried state replays the unsplit run exactly."""
    rounds, split = 10, 4
    data = generate_gmm(16 * W, 12, n_partitions=W, seed=0)
    full = t_trainer.train_dynamic(RunConfig(**_approx_kw(rounds, 0.5)), data, device="cpu")
    lr_full = RunConfig(**_approx_kw(rounds, 0.5)).resolve_lr_schedule()
    p1 = t_trainer.train_dynamic(RunConfig(**_approx_kw(split, lr_full[:split])), data,
                                 device="cpu")
    p2 = t_trainer.train_dynamic(RunConfig(**_approx_kw(rounds, lr_full)), data, device="cpu",
                                 initial_state=p1.final_state, initial_round=split)
    assert torch.equal(p2.params_history, full.params_history[split:])
    assert torch.equal(p1.params_history, full.params_history[:split])
    assert (p2.worker_times[:split] == -1.0).all() and (p2.timeset[:split] == 0.0).all()
    assert not p2.collected[:split].any()
    assert p2.timeset[split:].tobytes() == full.timeset[split:].tobytes()
    assert p2.start_round == split


@pytest.mark.parametrize("knob", ["flat_grad", "margin_flat"])
def test_train_dynamic_flat_lowerings_match_per_slot(knob):
    data = generate_gmm(16 * W, 12, n_partitions=W, seed=0)
    ref = t_trainer.train_dynamic(RunConfig(**_approx_kw(8, 0.5, use_pallas="off")), data,
                                  device="cpu")
    got = t_trainer.train_dynamic(RunConfig(**_approx_kw(8, 0.5, **{knob: "on"})), data,
                                  device="cpu")
    assert ref.lowering == "per_slot" and got.lowering == knob.replace("_grad", "")
    np.testing.assert_allclose(got.params_history.numpy(), ref.params_history.numpy(),
                               rtol=2e-4, atol=2e-5)


def test_train_dynamic_layer_coded_matches_per_slot():
    kw = _approx_kw(6, 0.5, model="deepmlp", update_rule="GD")
    data = generate_gmm(16 * W, 12, n_partitions=W, seed=0)
    ref = t_trainer.train_dynamic(RunConfig(**kw), data, device="cpu")
    got = t_trainer.train_dynamic(RunConfig(**kw, layer_coding="on"), data, device="cpu")
    assert got.layer_coded and not ref.layer_coded
    for a, b in zip(_hist(got), _hist(ref)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def _message(fn):
    with pytest.raises(ValueError) as ei:
        fn()
    return ei.value


def test_train_dynamic_refusals_match_jax():
    data = generate_gmm(16 * W, 12, n_partitions=W, seed=0)
    jdata = j_generate_gmm(16 * W, 12, n_partitions=W, seed=0)
    for kw, call in (
        (_approx_kw(6, 0.5), dict(initial_round=3)),
        (_approx_kw(6, 0.5, decode="optimal"), {}),
        (_approx_kw(6, 0.5, update_rule="GD", pipeline_depth=1), {}),
    ):
        got = _message(lambda: t_trainer.train_dynamic(RunConfig(**kw), data, device="cpu",
                                                       **call))
        want = _message(lambda: j_trainer.train_dynamic(JRunConfig(**kw), jdata, **call))
        assert str(got) == str(want)
        assert type(got).__name__ == type(want).__name__
    ref = _message(lambda: t_trainer.train_dynamic(
        RunConfig(**_approx_kw(6, 0.5, update_rule="GD", pipeline_depth=1)), data,
        device="cpu"))
    assert isinstance(ref, PipelineRefusal) and ref.reason == "dynamic_rule"
    # train()'s own restart guard, and its refusals of resume and pipelining
    got = _message(lambda: t_trainer.train(RunConfig(**_approx_kw(6, 0.5)), data,
                                           device="cpu", initial_round=3))
    want = _message(lambda: j_trainer.train(JRunConfig(**_approx_kw(6, 0.5)), jdata,
                                            initial_round=3))
    assert str(got) == str(want)
