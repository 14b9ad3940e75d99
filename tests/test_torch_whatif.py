"""The port's what-if engine (whatif/ spec, sampler, engine, ``cli whatif``)
against the JAX package's.

Spec: ``enumerate_points`` gives JAX's labels, feasibility and reasons (the
port's own validators refuse exactly where JAX's do), and ``spec_hash``
equals JAX's for the same ``GridSpec``.

Sampler: the batched threefry draw's bits equal ``jax.random.bits`` under
JAX's (seed, round) keys and do not grow in op count with seeds x rounds;
for the exp, adversary and targeted regimes every value is within 2
float32 ulps of JAX's block (the last-ulp rounding of ``log1p``). The
heavytail transform ``mean * expm1(e / alpha)`` is within 2 ulps of its
float64 value on the port's own ``e``; against JAX it also carries XLA's
CPU ``expm1`` error (up to 5 ulps) and the base draw's difference times the
transform's condition number ``x e^x / expm1(x)`` at ``x = e / alpha``, and
is held to that sum per value. Trace rotation and ``compute_slots`` pricing
are host float64 and exact.

Engine: on a tiny grid started from JAX's init draw, the rows' label,
feasible, reason, n_seeds, n_diverged and reach_fraction equal JAX's and the
numeric fields are within rtol 1e-4, with ``target_loss`` pinned to JAX's.
Rehydration and an identical-spec rerun are bitwise, the AGC-vs-exact
crossover of JAX's ``test_agc_vs_exact_crossover_reproduced`` is
reproduced from the port's own init, ``whatif`` records validate and
``cli whatif`` writes a surface.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.whatif import engine as j_engine
from erasurehead_tpu.whatif import sampler as j_sampler
from erasurehead_tpu.whatif import spec as j_spec
from erasurehead_tpu_torch import cli as t_cli
from erasurehead_tpu_torch import tune as t_tune
from erasurehead_tpu_torch.obs import events as t_events
from erasurehead_tpu_torch.train import experiments as t_experiments
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils import threefry
from erasurehead_tpu_torch.whatif import (
    GridSpec,
    PolicySpec,
    RegimeSpec,
    Surface,
    run_whatif,
    sample_arrivals,
)
from erasurehead_tpu_torch.whatif import engine as t_engine
from erasurehead_tpu_torch.whatif import sampler as t_sampler
from erasurehead_tpu_torch.whatif import spec as t_spec

W, R = 6, 10
SEEDS = [0, 1, 7]

#: the engine's categorical row fields (equal) and numeric ones (rtol 1e-4)
EXACT_FIELDS = ("label", "scheme", "n_workers", "n_stragglers", "num_collect", "deadline",
                "decode", "regime", "pipeline_depth", "feasible", "reason", "n_seeds",
                "n_diverged", "reach_fraction")
NUMERIC_FIELDS = ("expected_time_to_target", "time_to_target_std", "sim_time_per_round",
                  "decode_error_mean", "final_loss_mean")


@pytest.fixture(autouse=True)
def isolated_cache(tmp_path, monkeypatch):
    """The engine's runs resolve their auto knobs from an empty tune cache
    of their own, never the host's."""
    monkeypatch.setenv(t_tune.ENV_PATH, str(tmp_path / "tune.json"))
    t_tune.reset()
    t_tune.reset_emitted()
    yield
    t_tune.reset()
    t_tune.reset_emitted()


def _both(fn):
    """``fn`` applied to the port's and JAX's whatif spec modules."""
    return fn(t_spec), fn(j_spec)


# ---------------------------------------------------------------------------
# spec: enumeration and hash


SPECS = {
    "policies": dict(
        policies="naive,cyccoded,approx:c4,approx:f0.5,deadline,deadline:d1.5,avoidstragg,"
                 "partialcyccoded:p3,partialrepcoded:p2,repcoded,randreg:c4,sparsegraph",
        workers="6,8", stragglers="1,2", regimes="exp:0.5,heavytail:1.2:0.3"),
    "regimes": dict(
        policies="naive,approx:c4", workers="6", stragglers="1",
        regimes="exp,adversary:5:2,targeted:5:1,heavytail,exp:0.1+c0.2,exp+c0.3xslots"),
    "staleness": dict(
        policies="approx:c4,cyccoded,avoidstragg,naive", workers="6,9", stragglers="1,2",
        regimes="exp", pipeline_depths="0,1"),
    "infeasible": dict(
        policies="approx:c9,repcoded,cyccoded,partialcyccoded:p1,deadline", workers="5,7",
        stragglers="1,3", regimes="exp"),
}


def _grid(m, text, **kw):
    return m.GridSpec(
        policies=m.parse_policies(text["policies"]),
        n_workers=m.parse_ints(text["workers"]),
        n_stragglers=m.parse_ints(text["stragglers"]),
        regimes=m.parse_regimes(text["regimes"]),
        pipeline_depths=m.parse_ints(text.get("pipeline_depths", "0")),
        **kw,
    )


@pytest.mark.parametrize("name", list(SPECS))
def test_enumeration_equals_jax(name):
    t_pts, j_pts = _both(lambda m: m.enumerate_points(_grid(m, SPECS[name])))
    assert len(t_pts) == len(j_pts) > 0
    for a, b in zip(t_pts, j_pts):
        assert (a.label, a.feasible, a.reason, a.n_workers, a.n_stragglers, a.pipeline_depth) \
            == (b.label, b.feasible, b.reason, b.n_workers, b.n_stragglers, b.pipeline_depth)
        if a.feasible:
            assert a.config.num_collect == b.config.num_collect
            assert a.config.deadline == b.config.deadline
    assert any(not p.feasible for p in t_pts) or name == "regimes"


@pytest.mark.parametrize("name", list(SPECS))
@pytest.mark.parametrize("extra", [{}, dict(n_seeds=3, rounds=12, target_loss=0.2, lr=0.5),
                                   dict(model="linear", decode="optimal", model_seed=3)],
                         ids=["defaults", "shape", "model"])
def test_spec_hash_equals_jax(name, extra):
    t_g, j_g = _both(lambda m: _grid(m, SPECS[name], **extra))
    assert t_g.payload() == j_g.payload()
    assert t_g.spec_hash() == j_g.spec_hash()


@pytest.mark.parametrize("bad", ["approx:x4", ":c4", "approx:cz"])
def test_bad_policy_refused_as_jax(bad):
    for m in (t_spec, j_spec):
        with pytest.raises(ValueError, match="policy"):
            m.parse_policies(bad)


@pytest.mark.parametrize("bad", ["weird", "trace", "exp+cz", "adversary:a"])
def test_bad_regime_refused_as_jax(bad):
    for m in (t_spec, j_spec):
        with pytest.raises(ValueError):
            m.parse_regimes(bad)


# ---------------------------------------------------------------------------
# sampler


def _ulps(a, b) -> np.ndarray:
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def test_batched_bits_equal_jax():
    keys = [threefry.fold_in(threefry.key(s), r) for s in SEEDS for r in range(R)]
    bits = threefry.random_bits(threefry.key_tensor(keys), W)
    assert bits.shape == (len(SEEDS) * R, W)
    ref = np.stack([
        np.asarray(jax.random.bits(jax.random.fold_in(jax.random.PRNGKey(s), r), (W,),
                                   dtype=jnp.uint32))
        for s in SEEDS for r in range(R)
    ]).astype(np.int64)
    np.testing.assert_array_equal(bits.numpy(), ref)
    # and each row equals the scalar-key draw train_dynamic uses
    np.testing.assert_array_equal(
        bits.numpy(), np.stack([threefry.random_bits(k, W).numpy() for k in keys]))


def _count_ops(fn) -> int:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return sum(e.count for e in prof.key_averages() if e.key.startswith("aten::"))


def test_batched_draw_ops_do_not_grow_with_seeds_x_rounds():
    reg = RegimeSpec(kind="adversary", slowdown=3.0)
    one = _count_ops(lambda: sample_arrivals(reg, 2, W, [0], device="cpu"))
    many = _count_ops(lambda: sample_arrivals(reg, 30, W, list(range(8)), device="cpu"))
    assert one == many


SAMPLER_REGIMES = {
    "exp": dict(kind="exp"),
    "exp_small_mean": dict(kind="exp", mean=0.1),
    "adversary": dict(kind="adversary", slowdown=5.0, worker=2, shift_round=4),
    "adversary_wraps": dict(kind="adversary", slowdown=0.5, worker=W + 1),
    "exp_compute": dict(kind="exp", compute_time=0.3),
}


@pytest.mark.parametrize("name", list(SAMPLER_REGIMES))
def test_sampler_within_2_ulps_of_jax(name):
    kw = SAMPLER_REGIMES[name]
    a = t_sampler.sample_arrivals(t_sampler.RegimeSpec(**kw), R, W, SEEDS, device="cpu")
    b = j_sampler.sample_arrivals(j_sampler.RegimeSpec(**kw), R, W, SEEDS)
    assert a.dtype == b.dtype == np.float64 and a.shape == b.shape == (len(SEEDS), R, W)
    assert _ulps(a, b).max() <= 2
    np.testing.assert_allclose(a, b, rtol=2.4e-7, atol=0)


def _layouts(scheme="repcoded", s=1):
    from erasurehead_tpu.utils.config import RunConfig as JRunConfig
    from erasurehead_tpu_torch.utils.config import RunConfig

    kw = dict(scheme=scheme, n_workers=W, n_stragglers=s, n_rows=96, n_cols=8)
    return (t_trainer.build_layout(RunConfig(**kw)), j_trainer.build_layout(JRunConfig(**kw)))


@pytest.mark.parametrize("group", [0, 1, 4])
def test_targeted_within_2_ulps_of_jax(group):
    t_lay, j_lay = _layouts()
    kw = dict(kind="targeted", slowdown=5.0, group=group, shift_round=3)
    a = t_sampler.sample_arrivals(t_sampler.RegimeSpec(**kw), R, W, SEEDS, layout=t_lay,
                                  device="cpu")
    b = j_sampler.sample_arrivals(j_sampler.RegimeSpec(**kw), R, W, SEEDS, layout=j_lay)
    assert _ulps(a, b).max() <= 2
    with pytest.raises(ValueError, match="layout"):
        t_sampler.sample_arrivals(t_sampler.RegimeSpec(**kw), R, W, SEEDS, device="cpu")


@pytest.mark.parametrize("alpha,mean,shift", [(1.2, 0.5, 3), (0.7, 0.5, 0), (2.5, 1.0, 8)])
def test_heavytail_against_jax(alpha, mean, shift):
    kw = dict(kind="heavytail", alpha=alpha, mean=mean, shift_round=shift)
    a = t_sampler.sample_arrivals(t_sampler.RegimeSpec(**kw), R, W, SEEDS, device="cpu")
    b = j_sampler.sample_arrivals(j_sampler.RegimeSpec(**kw), R, W, SEEDS)
    # the base draws, e: the port's and JAX's within 2 ulps
    keys = [threefry.fold_in(threefry.key(s), r) for s in SEEDS for r in range(R)]
    e = threefry.exponential(threefry.key_tensor(keys), W).reshape(len(SEEDS), R, W).numpy()
    e_jax = np.stack([
        np.asarray(jax.random.exponential(jax.random.fold_in(jax.random.PRNGKey(s), r), (W,)))
        for s in SEEDS for r in range(R)
    ]).reshape(e.shape)
    de = _ulps(e, e_jax)
    assert de.max() <= 2
    # the port's transform against the float64 transform of its own e:
    # within 2 ulps (torch's expm1 is within 1 ulp of float64's)
    x32 = (e / np.float32(alpha)).astype(np.float32)
    exact = mean * np.expm1(x32.astype(np.float64))
    assert _ulps(a[:, shift:], exact[:, shift:]).max() <= 2
    # pre-shift rounds are the exp regime's
    assert (_ulps(a[:, :shift], b[:, :shift]) <= 2).all()
    # end to end against JAX: XLA's CPU expm1 is up to 5 ulps from
    # float64's (measured over 200,000 draws), plus the port's 2, plus the
    # base draw's difference times the transform's condition number
    # x e^x / expm1(x) at x = e / alpha (>= 1)
    x = x32.astype(np.float64)
    kappa = np.where(x > 0, x * np.exp(x) / np.expm1(np.maximum(x, 1e-30)), 1.0)
    bound = 5 + 2 + kappa * de
    assert (_ulps(a, b)[:, shift:] <= bound[:, shift:]).all()


def test_trace_rotation_and_compute_slots_exact(tmp_path):
    trace = np.arange(R * W, dtype=float).reshape(R, W) / 7.0
    path = os.path.join(tmp_path, "trace.npy")
    np.save(path, trace)
    t_lay, j_lay = _layouts("cyccoded", 2)
    blocks = []
    for kw in (dict(kind="trace", trace=path),
               dict(kind="trace", trace=path, compute_time=0.25, compute_slots=True)):
        a = t_sampler.sample_arrivals(t_sampler.RegimeSpec(**kw), R, W, [0, 1, 13],
                                      layout=t_lay, device="cpu")
        b = j_sampler.sample_arrivals(j_sampler.RegimeSpec(**kw), R, W, [0, 1, 13],
                                      layout=j_lay)
        np.testing.assert_array_equal(a, b)
        blocks.append(a)
    np.testing.assert_array_equal(t_sampler.slot_counts(t_lay), j_sampler.slot_counts(j_lay))
    np.testing.assert_array_equal(blocks[0][0], trace)  # seed 0: the raw replay
    np.testing.assert_array_equal(blocks[0][1], np.roll(trace, -1, axis=0))
    np.testing.assert_array_equal(blocks[0][2], np.roll(trace, -3, axis=0))  # 13 % R


def test_sampler_deterministic_and_seed_independent():
    reg = RegimeSpec(mean=0.5)
    a = sample_arrivals(reg, R, W, [0, 1, 2], device="cpu")
    np.testing.assert_array_equal(a, sample_arrivals(reg, R, W, [0, 1, 2], device="cpu"))
    assert not np.array_equal(a[0], a[1]) and (a >= 0).all()
    # a seed's block does not depend on the other seeds drawn with it
    np.testing.assert_array_equal(a[2], sample_arrivals(reg, R, W, [2], device="cpu")[0])


# ---------------------------------------------------------------------------
# engine


def _tiny(m, **kw):
    base = dict(
        policies=(m.PolicySpec("naive"), m.PolicySpec("cyccoded"),
                  m.PolicySpec("approx", num_collect=4), m.PolicySpec("repcoded"),
                  m.PolicySpec("approx", num_collect=9)),  # infeasible: 9 > W
        n_workers=(W,), n_stragglers=(1,),
        regimes=(m.RegimeSpec(mean=0.5), m.RegimeSpec(kind="adversary", slowdown=3.0),
                 m.RegimeSpec(kind="targeted", slowdown=2.0, group=1)),
        n_seeds=2, rounds=R, n_rows=96, n_cols=8,
    )
    base.update(kw)
    return m.GridSpec(**base)


def _jax_init(spec):
    cfg = next(p.config for p in j_spec.enumerate_points(spec) if p.feasible)
    return np.asarray(j_trainer._init_params_f32(cfg, j_trainer.build_model(cfg), cfg.n_cols))


@pytest.fixture(scope="module")
def jax_surface():
    spec = _tiny(j_spec)
    return spec, j_engine.run_whatif(spec)


@pytest.mark.parametrize("batch", ["auto", "off"])
def test_rows_equal_jax(jax_surface, batch):
    j_grid, j_surf = jax_surface
    spec = _tiny(t_spec, target_loss=j_surf.target_loss)
    surf = run_whatif(spec, device="cpu", batch=batch, init_params=_jax_init(j_grid))
    assert _tiny(t_spec).spec_hash() == j_grid.spec_hash()
    assert len(surf.rows) == len(j_surf.rows) == 15
    assert sum(not r["feasible"] for r in surf.rows) == 3
    for a, b in zip(surf.rows, j_surf.rows):
        assert {k: a[k] for k in EXACT_FIELDS} == {k: b[k] for k in EXACT_FIELDS}
        for k in NUMERIC_FIELDS:
            if b[k] is None:
                assert a[k] is None, (a["label"], k)
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-12,
                                           err_msg=f"{a['label']} {k}")
    assert surf.stats["n_trajectories"] == j_surf.stats["n_trajectories"] == 24


def test_default_target_is_jax_rule():
    spec = _tiny(t_spec, regimes=(RegimeSpec(mean=0.5),))
    surf = run_whatif(spec, device="cpu")
    finals = [r["final_loss_mean"] for r in surf.feasible_rows()]
    assert surf.target_loss >= 1.05 * max(finals) - 1e-5  # per-trajectory worst, x 1.05
    assert all(r["reach_fraction"] == 1.0 for r in surf.feasible_rows())


def test_rehydration_and_rerun_bitwise(tmp_path, monkeypatch):
    spec = _tiny(t_spec, regimes=(RegimeSpec(mean=0.5),), n_seeds=3)
    a_dir, b_dir = str(tmp_path / "a"), str(tmp_path / "b")
    surf = run_whatif(spec, out_dir=a_dir, device="cpu")
    assert Surface.load(a_dir).rows == surf.rows
    # rehydration: no simulation at all
    monkeypatch.setattr(t_experiments, "_run_configs",
                        lambda *a, **k: pytest.fail("rehydration re-simulated"))
    again = run_whatif(spec, out_dir=a_dir, device="cpu")
    assert again.stats is None and again.rows == surf.rows
    monkeypatch.undo()
    run_whatif(spec, out_dir=b_dir, rehydrate=False, device="cpu")
    for name in ("surface_rows.jsonl", "surface.npz"):
        assert open(os.path.join(a_dir, name), "rb").read() == \
            open(os.path.join(b_dir, name), "rb").read(), name


def test_infeasible_points_never_dispatched(monkeypatch):
    seen = []
    real = t_experiments._run_configs

    def spy(configs, *a, **k):
        seen.extend(configs)
        return real(configs, *a, **k)

    monkeypatch.setattr(t_experiments, "_run_configs", spy)
    spec = _tiny(t_spec, regimes=(RegimeSpec(mean=0.5),))
    surf = run_whatif(spec, device="cpu")
    bad = [r["label"] for r in surf.rows if not r["feasible"]]
    assert bad and not any(l.split("#")[0] in bad for l in seen)
    assert len(seen) == 4 * spec.n_seeds


def test_per_label_arrivals_reach_each_trajectory():
    """Every (point, seed) trajectory gets its own slice, batched or not:
    the naive rows' clocks are the per-round max of exactly their draw."""
    spec = _tiny(t_spec, policies=(PolicySpec("naive"),), regimes=(RegimeSpec(mean=0.5),),
                 n_seeds=3)
    block = sample_arrivals(RegimeSpec(mean=0.5), R, W, range(3), device="cpu")
    for batch in ("on", "off"):
        surf = run_whatif(spec, device="cpu", batch=batch)
        (row,) = surf.rows
        want = float(np.mean([block[i].max(axis=1).sum() for i in range(3)])) / R
        assert row["sim_time_per_round"] == round(want, 6)


def test_agc_vs_exact_crossover_reproduced():
    """JAX's crossover pin, on the port with its own init: under a mild
    compute-dominated regime the exact code reaches the target first;
    under heavy straggling AGC wins, and the finder locates the flip."""
    spec = GridSpec(
        policies=(PolicySpec("cyccoded"), PolicySpec("approx", num_collect=4)),
        n_workers=(W,), n_stragglers=(1,),
        regimes=(RegimeSpec(mean=0.05, compute_time=0.3), RegimeSpec(mean=2.0)),
        n_seeds=3, rounds=60, n_rows=96, n_cols=8, target_loss=0.145,
    )
    surf = run_whatif(spec, device="cpu")
    x = surf.crossover("approx", "cyccoded", axis="regime")
    winners = {v: winner for v, _a, _b, winner in x["points"]}
    assert winners == {"exp0.05+c0.3": "cyccoded", "exp2": "approx"}
    assert x["crossover"] == "exp2"
    assert "<- crossover" in surf.format_crossover_table("approx", "cyccoded", "regime")


def test_whatif_records_emitted_and_valid(tmp_path):
    spec = _tiny(t_spec, policies=(PolicySpec("naive"), PolicySpec("deadline")),
                 regimes=(RegimeSpec(mean=0.5),))
    path = str(tmp_path / "events.jsonl")
    with t_events.capture(path):
        surf = run_whatif(spec, out_dir=str(tmp_path / "s"), device="cpu")
        run_whatif(spec, out_dir=str(tmp_path / "s"), device="cpu")  # rehydrates
    assert t_events.validate_file(path) == []
    recs = [r for r in map(json.loads, open(path)) if r["type"] == "whatif"]
    kinds = [r["kind"] for r in recs]
    assert kinds == ["grid", "point", "point", "surface", "rehydrate"]
    assert (recs[0]["n_points"], recs[0]["n_infeasible"]) == (2, 1)
    assert all(r["spec_hash"] == spec.spec_hash() for r in recs)
    assert [r["label"] for r in recs if r["kind"] == "point"] == [r["label"] for r in surf.rows]


def test_whatif_validator_rejects_malformed_records():
    lines = [
        json.dumps({"type": "whatif", "seq": 0, "t": 0.0, "spec_hash": "", "kind": "grid"}),
        json.dumps({"type": "whatif", "seq": 1, "t": 0.0, "spec_hash": "abc", "kind": "nope"}),
        json.dumps({"type": "whatif", "seq": 2, "t": 0.0, "spec_hash": "abc", "kind": "point",
                    "feasible": "yes"}),
        json.dumps({"type": "whatif", "seq": 3, "t": 0.0, "spec_hash": "abc", "kind": "grid",
                    "n_points": -1}),
    ]
    text = "\n".join(t_events.validate_lines(lines))
    for needle in ("spec_hash", "kind", "feasible", "label", "n_points"):
        assert needle in text


def test_cli_whatif_subcommand(tmp_path, capsys):
    out = str(tmp_path / "surface")
    argv = ["whatif", "--policies", "naive,approx:c4", "--workers", str(W), "--stragglers", "1",
            "--regimes", "exp:0.5,adversary:4", "--seeds", "2", "--rounds", "8", "--rows", "96",
            "--cols", "8", "--out", out, "--crossover", "approx,naive", "--device", "cpu"]
    assert t_cli.main(argv) == 0
    printed = capsys.readouterr().out
    assert "8 simulated runs" in printed and "winner" in printed
    for name in ("surface_rows.jsonl", "surface.npz"):
        assert os.path.exists(os.path.join(out, name))
    assert t_events.validate_file(os.path.join(out, "events.jsonl")) == []
    surf = Surface.load(out)
    assert [r["label"] for r in surf.rows] == [
        "naive@W6s1/exp0.5", "naive@W6s1/adversary4", "approx:c4@W6s1/exp0.5",
        "approx:c4@W6s1/adversary4"]
    assert t_cli.main(argv + ["--quiet"]) == 0  # rehydrates
    assert capsys.readouterr().out == ""
    with pytest.raises(SystemExit):
        t_cli.main(["whatif", "--policies", "approx:z", "--device", "cpu"])


def test_whatif_exports_match_jax():
    import erasurehead_tpu.whatif as j_whatif
    import erasurehead_tpu_torch.whatif as t_whatif

    assert t_whatif.__all__ == j_whatif.__all__
    assert t_engine.run_whatif.__name__ == "run_whatif"
