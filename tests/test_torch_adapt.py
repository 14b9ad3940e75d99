"""The port's adaptive collection (adapt/, whatif/surface.py and the CLI's
--adapt flags) against the JAX package's.

The controller is host float64 numpy with a seeded numpy Generator in both
packages, so on the same ChunkStats sequences its decisions, values and
state dicts must be EQUAL (with and without what-if priors, under both
shift sources). A surface saved by JAX's ``Surface.save`` loads in the port
with equal rows and priors, and the port saves the same bytes.

``train_adaptive`` runs both drivers on the same arrivals from JAX's init
draw. Under ``reward_mode="time_error"`` the rewards read only host float64
telemetry, so the decisions equal JAX's bitwise; the clocks, masks and
decode errors are equal and the iterates within rtol 1e-4 / atol 1e-5.
Under ``"progress"`` the reward reads the float32 loss at each chunk
boundary, whose last bits differ between the packages: the arms and
reasons must still be equal, and the test asserts that every exploit
decision's best and second-best values lie at least 100x the loss
disagreement apart, so a near-tie cannot pass silently. (JAX's own
``test_train_adaptive_switches_on_regime_shift`` is red; these hold the
port to JAX's outputs, not to that test.)

Inside the port: chunks after the first find the stack in the data cache,
a chaos ``raise`` at site ``adapt`` leaves the journaled decision prefix of
the uninterrupted run, and the ``adapt`` records validate as JAX's do.
"""

import argparse
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from erasurehead_tpu import cli as j_cli
from erasurehead_tpu.adapt import controller as j_ctl
from erasurehead_tpu.adapt import driver as j_driver
from erasurehead_tpu.data.synthetic import generate_gmm as j_generate_gmm
from erasurehead_tpu.obs import events as j_events
from erasurehead_tpu.parallel import straggler as j_straggler
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.utils import chaos as j_chaos
from erasurehead_tpu.utils.config import RunConfig as JRunConfig
from erasurehead_tpu.whatif.surface import ROW_FIELDS, Surface as JSurface
from erasurehead_tpu_torch import adapt as t_adapt
from erasurehead_tpu_torch import cli as t_cli
from erasurehead_tpu_torch.adapt import controller as t_ctl
from erasurehead_tpu_torch.adapt import driver as t_driver
from erasurehead_tpu_torch.data.synthetic import generate_gmm
from erasurehead_tpu_torch.models.glm import LogisticModel
from erasurehead_tpu_torch.obs import events as t_events
from erasurehead_tpu_torch.train import cache as t_cache
from erasurehead_tpu_torch.utils import chaos as t_chaos
from erasurehead_tpu_torch.utils.config import RunConfig
from erasurehead_tpu_torch.whatif import Surface as TSurface

W, R, CHUNK, SHIFT = 6, 40, 5, 20
N_ROWS, N_COLS = 96, 8
#: the bound the test asserts on the port's and JAX's boundary losses
LOSS_TOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_chaos(monkeypatch):
    for mod in (t_chaos, j_chaos):
        monkeypatch.delenv(mod.CHAOS_ENV, raising=False)
        monkeypatch.delenv(mod.REGIME_ENV, raising=False)
        mod.reset()
    yield
    t_chaos.reset()
    j_chaos.reset()


def _kw(**kw):
    base = dict(scheme="naive", n_workers=W, n_stragglers=1, rounds=R, n_rows=N_ROWS,
                n_cols=N_COLS, lr_schedule=1.0, add_delay=True, compute_mode="deduped",
                update_rule="GD", seed=0)
    base.update(kw)
    return base


ARMS = (("naive", None, None), ("avoidstragg", None, None), ("deadline", None, 1.5))


def _arms(mod):
    return [mod.Arm(s, num_collect=c, deadline=d) for s, c, d in ARMS]


@pytest.fixture(scope="module")
def arrivals():
    shift = j_straggler.RegimeShift(kind="adversary", round=SHIFT, worker=0, slowdown=8.0)
    return j_straggler.arrival_schedule(R, W, add_delay=True, regime=shift)


@pytest.fixture(scope="module")
def data():
    return generate_gmm(N_ROWS, N_COLS, W, seed=0)


@pytest.fixture(scope="module")
def jdata():
    return j_generate_gmm(N_ROWS, N_COLS, W, seed=0)


def _jax_init(jcfg):
    return np.asarray(j_trainer._init_params_f32(jcfg, j_trainer.build_model(jcfg), jcfg.n_cols))


# ---------------------------------------------------------------------------
# the controller on the same telemetry


def _stats_seq(mod, seed, n, progress):
    """n ChunkStats drawn from a seeded generator, an arrival jump midway."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        mean = float(rng.uniform(0.2, 0.6)) * (6.0 if i >= n // 2 else 1.0)
        sim = float(rng.uniform(1.0, 5.0))
        out.append(mod.ChunkStats(
            n_rounds=5, sim_time=sim, decode_error_mean=float(rng.uniform(0.0, 0.3)),
            arrival_mean=mean if i % 7 != 3 else None, arrival_p90=2 * mean,
            loss_delta=float(rng.normal(0.05, 0.05)) if progress else None,
        ))
    return out


CONTROLLER_CASES = {
    "greedy": dict(epsilon=0.0, seed=0),
    "explore": dict(epsilon=0.3, seed=7, discount=0.8),
    "progress": dict(epsilon=0.2, seed=3, reward_mode="progress"),
    "time_error": dict(epsilon=0.1, seed=1, reward_mode="time_error", error_penalty=5.0),
    "regime_source": dict(epsilon=0.1, seed=2, shift_source="regime", shift_factor=2.0),
    "running_mean": dict(epsilon=0.0, seed=0, discount=1.0),
}
PRIORS = (None, {"naive": -2.0, "avoidstragg": -0.5, "deadline:d1.5": -1.0}, {"naive": -0.1})


@pytest.mark.parametrize("case", list(CONTROLLER_CASES))
@pytest.mark.parametrize("priors", range(len(PRIORS)))
def test_controller_matches_jax(case, priors):
    kw = CONTROLLER_CASES[case]
    progress = case == "progress"  # the other cases' stats carry no loss delta
    t = t_ctl.AdaptiveController(_arms(t_ctl), t_ctl.ControllerConfig(**kw), priors=PRIORS[priors])
    j = j_ctl.AdaptiveController(_arms(j_ctl), j_ctl.ControllerConfig(**kw), priors=PRIORS[priors])
    t_seq, j_seq = _stats_seq(t_ctl, 11, 24, progress), _stats_seq(j_ctl, 11, 24, progress)
    for i, (ts, js) in enumerate(zip(t_seq, j_seq)):
        ti, tr = t.choose()
        ji, jr = j.choose()
        assert (ti, tr) == (ji, jr), i
        verdict = (i % 5 == 4) if kw.get("shift_source") == "regime" and i % 3 else None
        assert t.observe(ti, ts, regime_shift=verdict) == j.observe(ji, js, regime_shift=verdict)
        assert t.reward(ts) == j.reward(js)
        assert t.snapshot() == j.snapshot()
    assert t.decisions == j.decisions
    assert t.state_dict() == j.state_dict()
    assert {d["reason"] for d in t.decisions} >= {"regime_shift"} or case == "regime_source"


@pytest.mark.parametrize("case", ["explore", "progress"])
def test_controller_state_dict_round_trips_across_packages(case):
    """A state saved mid-run by either package restores in the other (through
    JSON, as the elastic driver's aux sidecar holds it) and continues with the
    same decisions, the exploration rng included."""
    kw = CONTROLLER_CASES[case]
    t = t_ctl.AdaptiveController(_arms(t_ctl), t_ctl.ControllerConfig(**kw))
    j = j_ctl.AdaptiveController(_arms(j_ctl), j_ctl.ControllerConfig(**kw))
    t_seq, j_seq = _stats_seq(t_ctl, 5, 20, True), _stats_seq(j_ctl, 5, 20, True)
    for k in range(8):
        t.observe(t.choose()[0], t_seq[k])
        j.observe(j.choose()[0], j_seq[k])
    t2 = t_ctl.AdaptiveController(_arms(t_ctl), t_ctl.ControllerConfig(**kw))
    t2.load_state_dict(json.loads(json.dumps(j.state_dict())))
    j2 = j_ctl.AdaptiveController(_arms(j_ctl), j_ctl.ControllerConfig(**kw))
    j2.load_state_dict(json.loads(json.dumps(t.state_dict())))
    for k in range(8, 20):
        for a, b, ts, js in ((t2, j, t_seq, j_seq), (t, j2, t_seq, j_seq)):
            ai, bi = a.choose()[0], b.choose()[0]
            assert ai == bi
            a.observe(ai, ts[k])
            b.observe(bi, js[k])
    assert t2.decisions == j.decisions and t.decisions == j2.decisions
    with pytest.raises(ValueError, match="arm sets must match"):
        t_ctl.AdaptiveController(_arms(t_ctl)[:2]).load_state_dict(t.state_dict())


@pytest.mark.parametrize("kw", [
    dict(chunk_rounds=0), dict(discount=1.5), dict(epsilon=1.0), dict(reward_mode="speed"),
    dict(shift_factor=1.0), dict(shift_source="oracle"), dict(prior_weight=0.0),
])
def test_controller_config_refusals_match_jax(kw):
    with pytest.raises(ValueError) as got:
        t_ctl.ControllerConfig(**kw)
    with pytest.raises(ValueError) as want:
        j_ctl.ControllerConfig(**kw)
    assert str(got.value) == str(want.value)


def test_controller_refusals_and_arms_match_jax():
    for mod in (t_ctl, j_ctl):
        with pytest.raises(ValueError, match="at least one arm"):
            mod.AdaptiveController([])
        with pytest.raises(ValueError, match="duplicate"):
            mod.AdaptiveController([mod.Arm("naive"), mod.Arm("naive")])
    with pytest.raises(ValueError) as got:
        t_ctl.AdaptiveController(_arms(t_ctl), priors={"nonesuch": -1.0})
    with pytest.raises(ValueError) as want:
        j_ctl.AdaptiveController(_arms(j_ctl), priors={"nonesuch": -1.0})
    assert str(got.value) == str(want.value)
    for s, c, d in ARMS + (("approx", 4, None), ("deadline", 3, 0.25)):
        ta, ja = t_ctl.Arm(s, c, d), j_ctl.Arm(s, c, d)
        assert ta.label == ja.label and ta.overrides() == ja.overrides()


@pytest.mark.parametrize("kw", [dict(scheme="approx", num_collect=4), dict(scheme="naive"),
                                dict(scheme="deadline", deadline=0.7)])
def test_default_arms_match_jax(kw):
    got = t_driver.default_arms(RunConfig(**_kw(**kw)))
    want = j_driver.default_arms(JRunConfig(**_kw(**kw)))
    assert [a.label for a in got] == [a.label for a in want]


# ---------------------------------------------------------------------------
# what-if surfaces


def _surface_rows():
    rows = []
    specs = [("naive", None, None, 1.4, 0.0), ("avoidstragg", None, None, 0.9, 0.21),
             ("deadline", None, 1.5, 1.1, 0.12), ("approx", 4, None, 0.6, 0.3),
             ("approx", 5, None, 0.8, 0.1)]
    for i, (scheme, c, d, spr, err) in enumerate(specs):
        for regime, scale in (("exp", 1.0), ("adversary", 3.0)):
            rows.append({k: None for k in ROW_FIELDS} | dict(
                label=f"{scheme}{'' if c is None else f':c{c}'}@{regime}", scheme=scheme,
                n_workers=W, n_stragglers=1, num_collect=c, deadline=d, decode="fixed",
                regime=regime, pipeline_depth=0, feasible=True, reason=None, n_seeds=4,
                n_diverged=0, reach_fraction=1.0, expected_time_to_target=30.0 * spr * scale,
                time_to_target_std=1.5, sim_time_per_round=spr * scale,
                decode_error_mean=err, final_loss_mean=0.4 + 0.01 * i))
    rows.append({k: None for k in ROW_FIELDS} | dict(
        label="cyccoded@exp", scheme="cyccoded", n_workers=W, n_stragglers=4, regime="exp",
        feasible=False, reason="s >= W", n_seeds=4))
    return rows


@pytest.fixture
def saved_surface(tmp_path):
    surf = JSurface(spec_payload={"schemes": ["naive", "approx"], "seeds": 4},
                    spec_hash="0123abcd", target_loss=0.45, rows=_surface_rows())
    out = str(tmp_path / "surface")
    surf.save(out)
    return surf, out


def test_surface_saved_by_jax_loads_in_the_port(saved_surface, tmp_path):
    jsurf, out = saved_surface
    got = TSurface.load(out)
    want = JSurface.load(out)
    assert got.rows == want.rows and got.spec_hash == want.spec_hash
    assert got.spec_payload == want.spec_payload and got.target_loss == want.target_loss
    assert TSurface.saved_hash(out) == JSurface.saved_hash(out) == "0123abcd"
    assert TSurface.saved_hash(str(tmp_path / "nowhere")) is None
    arms_t = _arms(t_ctl) + [t_ctl.Arm("approx", 4), t_ctl.Arm("approx", 7), t_ctl.Arm("randreg")]
    arms_j = _arms(j_ctl) + [j_ctl.Arm("approx", 4), j_ctl.Arm("approx", 7), j_ctl.Arm("randreg")]
    for kw in ({}, dict(n_workers=W, n_stragglers=1), dict(regime="adversary", error_penalty=3.0)):
        assert got.adapt_priors(arms_t, **kw) == want.adapt_priors(arms_j, **kw)
    assert "randreg" not in got.adapt_priors(arms_t)  # the surface cannot speak for it
    cfg, jcfg = RunConfig(**_kw(scheme="approx", num_collect=4)), \
        JRunConfig(**_kw(scheme="approx", num_collect=4))
    assert got.eta(cfg) == want.eta(jcfg) and got.eta(cfg, regime="adversary") == \
        want.eta(jcfg, regime="adversary")
    assert got.crossover("approx", "naive") == want.crossover("approx", "naive")
    assert got.format_table() == want.format_table()
    assert got.format_crossover_table("approx", "avoidstragg") == \
        want.format_crossover_table("approx", "avoidstragg")
    # the port writes the same bytes
    again = str(tmp_path / "again")
    TSurface(got.spec_payload, got.spec_hash, got.target_loss, got.rows).save(again)
    for name in ("surface_rows.jsonl", "surface.npz"):
        with open(os.path.join(out, name), "rb") as a, open(os.path.join(again, name), "rb") as b:
            assert a.read() == b.read(), name


def test_surface_load_refusals_match_jax(tmp_path):
    for content in ("", json.dumps({"type": "sweep"}) + "\n"):
        d = tmp_path / f"bad{len(content)}"
        d.mkdir()
        (d / "surface_rows.jsonl").write_text(content)
        with pytest.raises(ValueError) as got:
            TSurface.load(str(d))
        with pytest.raises(ValueError) as want:
            JSurface.load(str(d))
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        TSurface({}, "h", None, []).crossover("a", "b", axis="seed")
    with pytest.raises(ValueError) as want:
        JSurface({}, "h", None, []).crossover("a", "b", axis="seed")
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# train_adaptive against JAX's


def _adaptive_pair(arrivals, data, jdata, tmp_path, kw=(), ctl=(), priors=None):
    kw, ctl = dict(kw), dict(ctl)
    jcfg, cfg = JRunConfig(**_kw(**kw)), RunConfig(**_kw(**kw))
    j_path, t_path = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    with j_events.capture(j_path):
        want = j_driver.train_adaptive(
            jcfg, jdata, arms=_arms(j_ctl),
            controller=j_ctl.ControllerConfig(chunk_rounds=CHUNK, seed=0, **ctl),
            arrivals=arrivals, priors=priors)
    t_cache.clear()
    stats0 = t_cache.stats().snapshot()
    with t_events.capture(t_path):
        got = t_driver.train_adaptive(
            cfg, data, arms=_arms(t_ctl),
            controller=t_ctl.ControllerConfig(chunk_rounds=CHUNK, seed=0, **ctl),
            arrivals=arrivals, priors=priors, device="cpu", init_params=_jax_init(jcfg))
    cache = {k: t_cache.stats().snapshot()[k] - stats0[k] for k in ("data_hits", "data_misses")}

    def records(path):
        drop = ("seq", "t", "run_id")
        return [{k: v for k, v in json.loads(line).items() if k not in drop}
                for line in open(path) if json.loads(line)["type"] == "adapt"]

    assert t_events.validate_file(t_path) == []
    return got, want, records(t_path), records(j_path), cache


def _same_telemetry(got, want):
    g, w = got.result, want.result
    for field in ("timeset", "worker_times", "collected", "decode_error"):
        a, b = getattr(g, field), np.asarray(getattr(w, field))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    assert g.sim_total_time == w.sim_total_time and g.n_train == w.n_train
    np.testing.assert_allclose(g.params_history.numpy(), np.asarray(w.params_history),
                               rtol=1e-4, atol=1e-5)
    assert [label for label, _ in got.chunk_stats] == [label for label, _ in want.chunk_stats]
    assert [a.label for a in got.arms] == [a.label for a in want.arms]


ADAPT_CASES = {
    "time_error": dict(ctl=dict(reward_mode="time_error")),
    "regime_estimator": dict(ctl=dict(reward_mode="time_error", shift_source="regime")),
    "priors": dict(ctl=dict(reward_mode="time_error", epsilon=0.3),
                   priors={"naive": -0.5, "deadline:d1.5": -3.0}),
}


@pytest.mark.parametrize("case", list(ADAPT_CASES) + ["faithful_frc"])
def test_train_adaptive_matches_jax_bitwise_decisions(case, arrivals, data, jdata, tmp_path):
    if case == "faithful_frc":
        got, want, t_recs, j_recs, cache = _faithful_pair(arrivals, data, jdata, tmp_path)
    else:
        spec = ADAPT_CASES[case]
        got, want, t_recs, j_recs, cache = _adaptive_pair(
            arrivals, data, jdata, tmp_path, ctl=spec["ctl"], priors=spec.get("priors"))
    assert got.decisions == want.decisions
    assert t_recs == j_recs
    _same_telemetry(got, want)
    assert cache == {"data_misses": 1, "data_hits": R // CHUNK - 1}
    assert got.result.params_history.shape[0] == R
    if case == "time_error":
        assert "regime_shift" in [d["reason"] for d in got.decisions]


def _faithful_pair(arrivals, data, jdata, tmp_path):
    """approx faithful with a collect-count variant and repcoded: all three
    lay FRC's assignment, so they share one worker-major stack."""
    kw = _kw(scheme="approx", n_stragglers=1, num_collect=4, compute_mode="faithful")
    jcfg, cfg = JRunConfig(**kw), RunConfig(**kw)
    arms = (("approx", 4, None), ("approx", 6, None), ("repcoded", None, None))
    j_path, t_path = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    with j_events.capture(j_path):
        want = j_driver.train_adaptive(
            jcfg, jdata, arms=[j_ctl.Arm(*a) for a in arms],
            controller=j_ctl.ControllerConfig(chunk_rounds=CHUNK, reward_mode="time_error"),
            arrivals=arrivals)
    t_cache.clear()
    stats0 = t_cache.stats().snapshot()
    with t_events.capture(t_path):
        got = t_driver.train_adaptive(
            cfg, data, arms=[t_ctl.Arm(*a) for a in arms],
            controller=t_ctl.ControllerConfig(chunk_rounds=CHUNK, reward_mode="time_error"),
            arrivals=arrivals, device="cpu", init_params=_jax_init(jcfg))
    cache = {k: t_cache.stats().snapshot()[k] - stats0[k] for k in ("data_hits", "data_misses")}
    drop = ("seq", "t", "run_id")
    recs = [[{k: v for k, v in json.loads(line).items() if k not in drop} for line in open(p)
             if json.loads(line)["type"] == "adapt"] for p in (t_path, j_path)]
    return got, want, recs[0], recs[1], cache


def test_train_adaptive_progress_matches_jax_with_a_margin(arrivals, data, jdata, tmp_path):
    """reward_mode="progress": the same arms and reasons as JAX; the values
    within float32 loss noise; every exploit decision's best value beats the
    second best by at least 100x what that noise can move a value."""
    got, want, t_recs, j_recs, cache = _adaptive_pair(arrivals, data, jdata, tmp_path)
    assert [(d["arm"], d["reason"], d["chunk"]) for d in got.decisions] == \
        [(d["arm"], d["reason"], d["chunk"]) for d in want.decisions]
    _same_telemetry(got, want)
    # the boundary losses the rewards read: the port's and JAX's agree
    # within LOSS_TOL (each package's own model on its own iterates)
    model = LogisticModel()
    X, y = torch.from_numpy(data.X_train).float(), torch.from_numpy(data.y_train).float()
    hist_t, hist_j = got.result.params_history, torch.from_numpy(
        np.asarray(want.result.params_history))
    ends = [CHUNK * k - 1 for k in range(1, R // CHUNK + 1)]
    loss_diff = max(abs(float(model.loss_mean(hist_t[e], X, y))
                        - float(model.loss_mean(hist_j[e], X, y))) for e in ends)
    assert loss_diff <= LOSS_TOL
    # a value is a discounted mean of loss_delta / sim_time: LOSS_TOL moves
    # each loss_delta by at most 2 * LOSS_TOL
    min_sim = min(s.sim_time for _, s in got.chunk_stats)
    value_tol = 2 * LOSS_TOL / min_sim
    exploits = [d for d in got.decisions if d["reason"] == "exploit"]
    assert exploits, "no exploit decision to hold"
    for d in exploits:
        best, second = sorted(d["values"], reverse=True)[:2]
        assert best - second >= 100 * value_tol, d
    for d, e in zip(got.decisions, want.decisions):
        np.testing.assert_allclose(d["values"], e["values"], rtol=0, atol=value_tol)
    for a, b in zip(t_recs, j_recs):
        assert {k: v for k, v in a.items() if k not in ("reward", "values")} == \
            {k: v for k, v in b.items() if k not in ("reward", "values")}
    assert cache == {"data_misses": 1, "data_hits": R // CHUNK - 1}
    assert got.decision_overhead_s > 0 and got.total_wall_s >= got.train_wall_s


def test_arm_validation_refusals_match_jax(data, jdata):
    cases = [
        (_kw(rounds=4), [("naive", None, None), ("partialrepcoded", None, None)]),
        (_kw(rounds=4, compute_mode="faithful"), [("naive", None, None), ("cyccoded", None, None)]),
        (_kw(rounds=4, arrival_mode="measured"), [("naive", None, None)]),
    ]
    for kw, arms in cases:
        with pytest.raises(ValueError) as got:
            t_driver.train_adaptive(RunConfig(**kw), data, arms=[t_ctl.Arm(*a) for a in arms],
                                    device="cpu")
        with pytest.raises(ValueError) as want:
            j_driver.train_adaptive(JRunConfig(**kw), jdata, arms=[j_ctl.Arm(*a) for a in arms])
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="arrivals shape"):
        t_driver.train_adaptive(RunConfig(**_kw()), data, arrivals=np.zeros((3, W)), device="cpu")


def test_adapt_chaos_raise_keeps_the_decision_prefix(arrivals, data, tmp_path, monkeypatch):
    kw = dict(arms=_arms(t_ctl), arrivals=arrivals, device="cpu",
              controller=t_ctl.ControllerConfig(chunk_rounds=CHUNK, seed=0))
    baseline = t_driver.train_adaptive(RunConfig(**_kw()), data, **kw)
    path = str(tmp_path / "killed.jsonl")
    monkeypatch.setenv(t_chaos.CHAOS_ENV, "raise:adapt:3:PREEMPTED")
    with pytest.raises(t_chaos.ChaosInjection, match="PREEMPTED"):
        with t_events.capture(path):
            t_driver.train_adaptive(RunConfig(**_kw()), data, **kw)
    monkeypatch.delenv(t_chaos.CHAOS_ENV)
    t_chaos.reset()
    killed = [rec for rec in map(json.loads, open(path)) if rec["type"] == "adapt"]
    assert len(killed) == 2  # chunks 0 and 1 committed before the fault
    for rec, d in zip(killed, baseline.decisions):
        assert (rec["arm"], rec["reason"], rec["round"]) == (d["arm"], d["reason"], d["chunk"] * CHUNK)
    rerun = t_driver.train_adaptive(RunConfig(**_kw()), data, **kw)
    assert rerun.decisions == baseline.decisions
    assert torch.equal(rerun.result.final_params, baseline.result.final_params)


def test_train_adaptive_needs_a_card_by_default(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        t_adapt.train_adaptive(RunConfig(**_kw(rounds=4)), data)


def _adapt_rec(seq, **kw):
    return json.dumps({"type": "adapt", "seq": seq, "t": 0.0, **kw})


def test_adapt_records_validate_as_jax():
    lines = [
        _adapt_rec(0, round=0, arm="naive", reason="warmup"),
        _adapt_rec(1, round=-5, arm="naive", reason="exploit"),
        _adapt_rec(2, round=5, arm="", reason="exploit"),
        _adapt_rec(3, round=10, arm="naive", reason="guess"),
        _adapt_rec(4, round=15, reason="explore"),
    ]
    got, want = t_events.validate_lines(lines), j_events.validate_lines(lines)
    assert got == want and len(got) == 5
    assert t_events.validate_lines(lines[:1]) == []


# ---------------------------------------------------------------------------
# the CLI

CLI_BASE = ["--scheme", "approx", "--workers", str(W), "--stragglers", "1", "--num-collect",
            "4", "--rounds", "20", "--rows", "240", "--cols", "8", "--add-delay", "--quiet",
            "--device", "cpu", "--compute-mode", "deduped"]

BAD_FLAGS = [
    ["--death-timeout", "2.0"],
    ["--elastic", "on", "--arrival-mode", "measured"],
    ["--elastic", "on", "--checkpoint-dir", "d", "--checkpoint-every", "2"],
    ["--elastic", "on", "--adapt", "on"],
    ["--elastic", "on", "--kill-workers", "1:2", "--on-death", "failover",
     "--death-timeout", "2.0"],
    ["--elastic-chunk", "0"],
    ["--death-rounds", "0"],
    ["--adapt", "on", "--arrival-mode", "measured"],
    ["--adapt", "on", "--checkpoint-dir", "d", "--checkpoint-every", "2"],
    ["--adapt", "on", "--kill-workers", "1:2"],
    ["--adapt-chunk", "0"],
    ["--adapt-arms", "naive"],
    ["--adapt-priors", "surface"],
]


def _refusal(cli, argv, capsys):
    parser = cli._flags_parser()
    ns = parser.parse_args(argv)
    with pytest.raises(SystemExit) as exc:
        cli._validate_checkpoint_flags(parser, ns)
    return exc.value.code, capsys.readouterr().err.strip().splitlines()[-1]


@pytest.mark.parametrize("argv", BAD_FLAGS, ids=lambda a: "_".join(a).strip("-"))
def test_cli_refusals_carry_jax_messages(argv, capsys):
    got = _refusal(t_cli, argv, capsys)
    want = _refusal(j_cli, argv, capsys)
    assert got[0] == want[0] == 2
    assert got[1].split("error: ", 1)[1] == want[1].split("error: ", 1)[1]
    with pytest.raises(SystemExit) as exc:  # and through main()
        t_cli.main(CLI_BASE + argv)
    assert exc.value.code == 2


@pytest.mark.parametrize("argv", [
    ["--elastic", "on", "--death-timeout", "2.0"],
    ["--kill-workers", "1:2", "--on-death", "failover", "--death-timeout", "2.0"],
    ["--adapt", "on", "--adapt-arms", "naive,approx:c4", "--adapt-chunk", "4"],
    ["--elastic", "on", "--kill-workers", "1:2", "--death-rounds", "2"],
])
def test_cli_accepts_what_jax_accepts(argv):
    for cli in (t_cli, j_cli):
        parser = cli._flags_parser()
        cli._validate_checkpoint_flags(parser, parser.parse_args(argv))
    assert isinstance(t_cli._flags_parser().parse_args(argv), argparse.Namespace)


def test_run_refusals_match_jax():
    cfg, jcfg = RunConfig(**_kw()), JRunConfig(**_kw())
    for kw in (dict(death_timeout=2.0), dict(elastic="on", death_timeout=None)):
        t_kw = dict(kw)
        if kw.get("elastic"):
            cfg_t = dataclasses.replace(cfg, arrival_mode="measured")
            cfg_j = dataclasses.replace(jcfg, arrival_mode="measured")
        else:
            cfg_t, cfg_j = cfg, jcfg
        with pytest.raises(ValueError) as got:
            t_cli.run(cfg_t, device="cpu", **t_kw)
        with pytest.raises(ValueError) as want:
            j_cli.run(cfg_j, **kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", ["naive,approx:c4,deadline:d1.5", "avoidstragg:c3:d2"])
def test_parse_arms_matches_jax(spec):
    got, want = t_cli._parse_arms(spec), j_cli._parse_arms(spec)
    assert [a.label for a in got] == [a.label for a in want]


@pytest.mark.parametrize("spec", ["naive,:c4", "approx:x4", "approx:cfour"])
def test_parse_arms_refusals_match_jax(spec):
    with pytest.raises(ValueError) as got:
        t_cli._parse_arms(spec)
    with pytest.raises(ValueError) as want:
        j_cli._parse_arms(spec)
    assert str(got.value) == str(want.value)


def test_cli_adapt_run(tmp_path, capsys, saved_surface):
    _, surface_dir = saved_surface
    out = str(tmp_path / "adapt")
    argv = [a for a in CLI_BASE if a != "--quiet"] + [
        "--adapt", "on", "--adapt-chunk", "5", "--adapt-arms", "approx:c4,naive,avoidstragg",
        "--adapt-priors", surface_dir, "--output-dir", out]
    assert t_cli.main(argv) == 0
    printed = capsys.readouterr().out
    assert "adapt priors <- " in printed and "(spec 0123abcd): 3 arm(s) primed" in printed
    assert "adaptive collection: 4 decision(s)" in printed
    ts = np.loadtxt(os.path.join(out, "approx_acc_1_timeset.dat"))
    loss = np.loadtxt(os.path.join(out, "approx_acc_1_training_loss.dat"))
    assert ts.shape == (20,) and np.isfinite(loss).all()
