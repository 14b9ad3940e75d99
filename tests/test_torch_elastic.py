"""The port's online elastic membership (elastic/, the chaos membership
grammar and the CLI's --elastic flags) against the JAX package's.

The membership controller is host float64 numpy over the port's
parallel/failures.py in both packages, so on the inputs of
tests/test_elastic.py its observations, commits, decisions and snapshots
must be equal. ``train_elastic_online`` runs both drivers from JAX's init
draw on scripted deaths, a scripted revive, chaos membership specs, an AGC
run whose dead workers only the absence backstop can catch, and the
composed adapt bandit: decisions, epochs, clocks, masks and decode errors
equal, iterates within rtol 1e-4 / atol 1e-5, the chunk rows equal but for
the params digest (the port hashes its own float32 bytes).

Inside the port: a run killed by a chaos ``raise`` at site ``elastic`` and
resumed from its checkpoint rehydrates the finished chunks' rows from the
journal and ends with the uninterrupted run's rows (``science_fields``) and
final params, bitwise; every chunk of an epoch after its first finds the
stack in the data cache; the ``membership`` records validate as JAX's do.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from erasurehead_tpu import adapt as j_adapt
from erasurehead_tpu import elastic as j_elastic
from erasurehead_tpu.data.synthetic import generate_gmm as j_generate_gmm
from erasurehead_tpu.elastic import controller as j_ctl
from erasurehead_tpu.obs import events as j_events
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.utils import chaos as j_chaos
from erasurehead_tpu.utils.config import RunConfig as JRunConfig
from erasurehead_tpu_torch import adapt as t_adapt
from erasurehead_tpu_torch import cli as t_cli
from erasurehead_tpu_torch import elastic as t_elastic
from erasurehead_tpu_torch.data.synthetic import generate_gmm
from erasurehead_tpu_torch.elastic import controller as t_ctl
from erasurehead_tpu_torch.obs import events as t_events
from erasurehead_tpu_torch.train import cache as t_cache
from erasurehead_tpu_torch.utils import chaos as t_chaos
from erasurehead_tpu_torch.utils.config import RunConfig

W, R, CHUNK = 8, 30, 5


@pytest.fixture(autouse=True)
def _clean_chaos(monkeypatch):
    for mod in (t_chaos, j_chaos):
        monkeypatch.delenv(mod.CHAOS_ENV, raising=False)
        mod.reset()
    yield
    t_chaos.reset()
    j_chaos.reset()


@pytest.fixture(scope="module")
def data():
    return generate_gmm(32 * W, 16, n_partitions=W, seed=0)


@pytest.fixture(scope="module")
def jdata():
    return j_generate_gmm(32 * W, 16, n_partitions=W, seed=0)


def _kw(**kw):
    base = dict(scheme="naive", n_workers=W, n_stragglers=0, rounds=R, n_rows=32 * W,
                n_cols=16, lr_schedule=1.0, update_rule="AGD", add_delay=True, seed=0)
    base.update(kw)
    return base


def _ecfg(mod, **kw):
    base = dict(chunk_rounds=CHUNK, death_rounds=3, timeout=4.0)
    base.update(kw)
    return mod.ElasticConfig(**base)


# ---------------------------------------------------------------------------
# the membership controller on tests/test_elastic.py's inputs


def _drive(mod, n, ecfg_kw, steps):
    """Run one script of ("observe", args, kwargs) / ("commit", round) /
    ("join", worker, round) steps; returns every step's outcome and the
    final snapshot."""
    ctl = mod.MembershipController(n, _ecfg(mod, **ecfg_kw))
    out = []
    for step in steps:
        if step[0] == "observe":
            obs = ctl.observe_chunk(*step[1], **step[2])
            out.append(dataclasses.asdict(obs))
        elif step[0] == "commit":
            change = ctl.commit(step[1])
            out.append(None if change is None else dataclasses.asdict(change))
        else:
            out.append(ctl.request_join(step[1], round=step[2]))
        out.append((ctl.active, ctl.dead, ctl.epoch, sorted(ctl._pending_deaths)))
    return out, ctl.snapshot(), ctl.decisions


STREAK = np.array([[0.1, 0.2, -1.0, -1.0], [0.1, 0.2, -1.0, -1.0], [0.1, 0.2, 0.3, -1.0]])
EARLY = np.array([[0.1, 0.2, -1.0]] * 4)
SCRIPTS = {
    "streaks_and_k_rule": (4, dict(death_rounds=3), [
        ("observe", (0, STREAK), {}), ("commit", 3),
        ("observe", (3, STREAK[:2, :3]), {}), ("observe", (5, STREAK[:1, :3]), {}),
        ("commit", 6)]),
    "streaks_carry_across_chunks": (4, dict(death_rounds=3), [
        ("observe", (0, STREAK[:2]), {}),
        ("observe", (2, np.array([[0.1, 0.2, -1.0, -1.0]])), {}), ("commit", 3)]),
    "timeout_trip": (3, dict(death_rounds=2, timeout=1.0), [
        ("observe", (0, np.array([[0.1, 0.2, 50.0], [0.1, 0.2, 60.0]])), {}), ("commit", 2)]),
    "evidential_gate": (3, dict(death_rounds=2, timeout=4.0, absence_rounds=100), [
        ("observe", (0, EARLY), dict(sim_time=np.full(4, 0.3), window=4.0)),
        ("observe", (4, EARLY[:2]), dict(sim_time=np.full(2, 4.0), window=4.0)),
        ("commit", 6)]),
    "absence_backstop": (3, dict(death_rounds=2, timeout=4.0, absence_rounds=6), [
        ("observe", (0, np.array([[0.1, -1.0, -1.0], [0.1, -1.0, -1.0], [0.1, 0.2, -1.0]])),
         dict(sim_time=np.full(3, 0.3), window=4.0)),
        ("observe", (3, np.array([[0.1, 0.3, -1.0]] * 3)),
         dict(sim_time=np.full(3, 0.3), window=4.0)),
        ("commit", 6)]),
    "collapse_probe": (3, dict(death_rounds=4, shift_factor=2.0), [
        ("observe", (0, np.array([[0.1, 0.2, -1.0], [0.1, 0.2, -1.0]])), {}),
        ("observe", (2, np.array([[3.0, 2.0, -1.0], [1.5, 2.5, -1.0]])), {}), ("commit", 4)]),
    "join_and_min_workers": (3, dict(death_rounds=1, min_workers=2), [
        ("observe", (0, np.array([[0.1, -1.0, -1.0]])), {}), ("commit", 1),
        ("join", 1, 2), ("join", 2, 2), ("commit", 2), ("join", 0, 3), ("commit", 3)]),
    "snapshot_state": (4, {}, [
        ("observe", (0, np.array([[0.1, 0.2, -1.0, 5.0]] * 2)), {}), ("join", 3, 2)]),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_membership_controller_matches_jax(name):
    n, ecfg_kw, steps = SCRIPTS[name]
    got = _drive(t_ctl, n, ecfg_kw, steps)
    want = _drive(j_ctl, n, ecfg_kw, steps)
    assert got == want
    snap = json.loads(json.dumps(got[1]))  # through JSON, as the aux sidecar
    for a, b in ((t_ctl.MembershipController.restore(snap, _ecfg(t_ctl, **ecfg_kw)),
                  j_ctl.MembershipController.restore(snap, _ecfg(j_ctl, **ecfg_kw))),):
        assert a.snapshot() == b.snapshot() == got[1]


def test_membership_controller_refusals_match_jax():
    for call in (lambda m: m.MembershipController(0),
                 lambda m: m.MembershipController(3).observe_chunk(0, np.zeros((2, 4))),
                 lambda m: m.MembershipController(3).request_join(5)):
        with pytest.raises(ValueError) as got:
            call(t_ctl)
        with pytest.raises(ValueError) as want:
            call(j_ctl)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(chunk_rounds=0), dict(death_rounds=0),
                                dict(timeout=float("inf")), dict(timeout=0.0),
                                dict(min_workers=0), dict(shift_factor=1.0),
                                dict(absence_rounds=2)])
def test_elastic_config_refusals_match_jax(kw):
    with pytest.raises(ValueError) as got:
        t_ctl.ElasticConfig(**kw)
    with pytest.raises(ValueError) as want:
        j_ctl.ElasticConfig(**kw)
    assert str(got.value) == str(want.value)


def test_probe_streak_detector_matches_jax():
    outcomes = [("a", False, True), ("b", False, True), ("a", False, False), ("a", False, True),
                ("b", True, True), ("a", False, True), ("c", False, True), ("a", True, True)]
    dets = [mod.ProbeStreakDetector(["a", "b", "c"], k=3) for mod in (t_ctl, j_ctl)]
    for member, ok, evidential in outcomes:
        assert dets[0].observe(member, ok, evidential) == dets[1].observe(member, ok, evidential)
        assert dets[0].snapshot() == dets[1].snapshot()
        assert dets[0].is_dead("a") == dets[1].is_dead("a")
    back = t_ctl.ProbeStreakDetector.restore(json.loads(json.dumps(dets[1].snapshot())))
    assert back.snapshot() == dets[1].snapshot() and back.members == ("a", "b", "c")
    for mod in (t_ctl, j_ctl):
        with pytest.raises(ValueError, match="raw timeout"):
            mod.ProbeStreakDetector(k=1)
        with pytest.raises(KeyError):
            mod.ProbeStreakDetector(["a"]).observe("z", True)


def test_auto_survivor_config_and_join_offers_match_jax():
    cfg = RunConfig(**_kw(scheme="repcoded", n_stragglers=1))
    jcfg = JRunConfig(**_kw(scheme="repcoded", n_stragglers=1))
    for n in (8, 7, 6, 5, 4):
        got, want = t_ctl.auto_survivor_config(cfg, n), j_ctl.auto_survivor_config(jcfg, n)
        assert (got.n_workers, got.n_stragglers, got.num_collect) == \
            (want.n_workers, want.n_stragglers, want.num_collect)
    with pytest.raises(ValueError) as got:
        t_ctl.auto_survivor_config(cfg, 5, survivor_overrides={"n_stragglers": 1})
    with pytest.raises(ValueError) as want:
        j_ctl.auto_survivor_config(jcfg, 5, survivor_overrides={"n_stragglers": 1})
    assert str(got.value) == str(want.value)
    for revives, active, r in (({7: 21, 3: 5}, (0, 1, 2, 4), 20), (None, (0,), 3),
                               ({1: 0}, (0, 1), 9)):
        assert t_ctl.default_join_offers(revives, active, r) == \
            j_ctl.default_join_offers(revives, active, r)


# ---------------------------------------------------------------------------
# the chaos membership grammar


def test_chaos_membership_fires_matches_jax(monkeypatch):
    spec = "5:worker_death:2,1:worker_death:3+,2:worker_revive:4"
    monkeypatch.setenv(t_chaos.CHAOS_ENV, spec)
    for site in t_chaos.MEMBERSHIP_SITES:
        for b in range(1, 7):
            assert t_chaos.membership_fires(site, b) == j_chaos.membership_fires(site, b)
        for _ in range(6):
            assert t_chaos.fire_membership(site) == j_chaos.fire_membership(site)
    # a membership spec never fires through maybe_fire
    for mod in (t_chaos, j_chaos):
        mod.maybe_fire("worker_death")
        assert mod.active().mode == "member" and mod.active().worker == 5
    for call in (lambda m: m.membership_fires("trajectory", 1),
                 lambda m: m.membership_fires("worker_death", 0),
                 lambda m: m.fire_membership("elastic")):
        with pytest.raises(ValueError) as got:
            call(t_chaos)
        with pytest.raises(ValueError) as want:
            call(j_chaos)
        assert str(got.value) == str(want.value)
    monkeypatch.delenv(t_chaos.CHAOS_ENV)
    assert t_chaos.membership_fires("worker_death", 2) == ()
    assert t_chaos.fire_membership("worker_revive") == ()


# ---------------------------------------------------------------------------
# train_elastic_online against JAX's


def _jax_init(jcfg):
    return np.asarray(j_trainer._init_params_f32(jcfg, j_trainer.build_model(jcfg), jcfg.n_cols))


ROW_SCIENCE = ("round", "action", "n_rounds", "n_workers", "workers", "epoch", "sim_time",
               "decode_error_mean", "arm", "n_stragglers")

ONLINE_CASES = {
    "scripted_deaths": dict(deaths={6: 7, 7: 7}),
    "scripted_revive": dict(rounds=40, deaths={7: 6}, revives={7: 21}),
    "chaos_membership": dict(rounds=40, chaos="3:worker_death:2,3:worker_revive:5"),
    "agc_absence": dict(rounds=40, kw=dict(scheme="approx", n_stragglers=1, num_collect=4),
                        ecfg=dict(chunk_rounds=8, death_rounds=3), deaths={6: 5, 7: 5}),
    "adapt_composed": dict(kw=dict(n_stragglers=1, compute_mode="deduped"), deaths={7: 7},
                           arms=("naive", "avoidstragg")),
    "deadline_window": dict(kw=dict(scheme="deadline", deadline=1.0), deaths={2: 3},
                            ecfg=dict(death_rounds=2)),
}


def _online_pair(case, data, jdata, monkeypatch):
    spec = ONLINE_CASES[case]
    kw = _kw(rounds=spec.get("rounds", R), **spec.get("kw", {}))
    cfg, jcfg = RunConfig(**kw), JRunConfig(**kw)
    common = dict(deaths=spec.get("deaths"), revives=spec.get("revives"))
    if spec.get("chaos"):
        monkeypatch.setenv(t_chaos.CHAOS_ENV, spec["chaos"])
    want = j_elastic.train_elastic_online(
        jcfg, jdata, elastic=_ecfg(j_ctl, **spec.get("ecfg", {})),
        adapt_arms=[j_adapt.Arm(a) for a in spec["arms"]] if "arms" in spec else None, **common)
    t_cache.clear()
    stats0 = t_cache.stats().snapshot()
    got = t_elastic.train_elastic_online(
        cfg, data, elastic=_ecfg(t_ctl, **spec.get("ecfg", {})), device="cpu",
        adapt_arms=[t_adapt.Arm(a) for a in spec["arms"]] if "arms" in spec else None,
        init_params=_jax_init(jcfg), **common)
    cache = {k: t_cache.stats().snapshot()[k] - stats0[k] for k in ("data_hits", "data_misses")}
    return got, want, cache


@pytest.mark.parametrize("case", list(ONLINE_CASES))
def test_train_elastic_online_matches_jax(case, data, jdata, monkeypatch):
    got, want, cache = _online_pair(case, data, jdata, monkeypatch)
    assert got.decisions == want.decisions
    assert got.epochs == want.epochs
    assert got.arm_decisions == want.arm_decisions
    assert [{k: r[k] for k in ROW_SCIENCE} for r in got.rows] == \
        [{k: r[k] for k in ROW_SCIENCE} for r in want.rows]
    g, w = got.result, want.result
    for field in ("timeset", "worker_times", "collected", "decode_error"):
        a, b = getattr(g, field), np.asarray(getattr(w, field))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    assert g.n_train == w.n_train and g.sim_total_time == w.sim_total_time
    np.testing.assert_allclose(g.params_history.numpy(), np.asarray(w.params_history),
                               rtol=1e-4, atol=1e-5)
    # every chunk of an epoch after its first finds its stack in the cache
    # (an epoch whose worker set an earlier one had hits from its start)
    n_chunks = len(got.rows)
    distinct = len({e["workers"] for e in got.epochs})
    assert cache["data_misses"] == distinct and cache["data_hits"] == n_chunks - distinct
    if case == "adapt_composed":
        assert {d["epoch"] for d in got.arm_decisions} == {0, 1}
        first1 = next(d for d in got.arm_decisions if d["epoch"] == 1)
        assert first1["reason"] == "warmup"
    if case in ("scripted_revive", "chaos_membership"):
        assert [e["n_workers"] for e in got.epochs] == [W, W - 1, W]


def test_scripted_deaths_relayout_and_sentinels(data):
    res = t_elastic.train_elastic_online(RunConfig(**_kw()), data, elastic=_ecfg(t_ctl),
                                         deaths={6: 7, 7: 7}, device="cpu")
    relayouts = [d for d in res.decisions if d["action"] == "relayout"]
    assert [(d["round"], d["n_workers"]) for d in relayouts] == [(10, 6)]
    assert (res.result.worker_times[10:, 6:] == -1.0).all()
    assert not res.result.collected[10:, 6:].any()
    assert (res.result.timeset[7:10] == 4.0).all()  # priced at the timeout
    hist = res.result.params_history
    assert hist.shape[0] == R and bool(torch.isfinite(hist).all())
    again = t_elastic.train_elastic_online(RunConfig(**_kw()), data, elastic=_ecfg(t_ctl),
                                           deaths={6: 7, 7: 7}, device="cpu")
    # the port's digests are stable: a rerun has the same rows, bitwise
    assert [t_elastic.science_fields(r) for r in again.rows] == \
        [t_elastic.science_fields(r) for r in res.rows]
    assert torch.equal(again.result.params_history, hist)


def test_driver_refusals_match_jax(data, jdata):
    cases = [
        dict(kw=_kw(scheme="partialrepcoded", n_stragglers=1, partitions_per_worker=4)),
        dict(kw=_kw(arrival_mode="measured")),
        dict(kw=_kw(), resume=True),
        dict(kw=_kw(), arrivals=np.zeros((3, W))),
        dict(kw=_kw(), deaths={W: 2}),
    ]
    for case in cases:
        extra = {k: v for k, v in case.items() if k != "kw"}
        with pytest.raises(ValueError) as got:
            t_elastic.train_elastic_online(RunConfig(**case["kw"]), data, elastic=_ecfg(t_ctl),
                                           device="cpu", **extra)
        with pytest.raises(ValueError) as want:
            j_elastic.train_elastic_online(JRunConfig(**case["kw"]), jdata,
                                           elastic=_ecfg(j_ctl), **extra)
        assert str(got.value) == str(want.value)


def test_train_elastic_online_needs_a_card_by_default(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        t_elastic.train_elastic_online(RunConfig(**_kw()), data)


# ---------------------------------------------------------------------------
# kill -> resume, the journal and its records


def test_chaos_kill_resume_rehydrates_rows_bitwise(data, tmp_path, monkeypatch):
    """A membership chaos spec changes the world at boundary 2; a raise at
    the ``elastic`` site's 5th boundary stops the run after four chunks. The
    resume (the membership spec still armed: it replays by absolute boundary,
    never fires again) restores the ledger from the aux sidecar, rehydrates
    the four rows from the journal and ends bitwise on the uninterrupted
    run."""
    cfg = RunConfig(**_kw(rounds=40))
    world = "3:worker_death:2,3:worker_revive:6"
    monkeypatch.setenv(t_chaos.CHAOS_ENV, world)
    base = t_elastic.train_elastic_online(cfg, data, elastic=_ecfg(t_ctl), device="cpu")
    assert [e["n_workers"] for e in base.epochs] == [W, W - 1, W]
    run_dir = str(tmp_path / "run")
    kw = dict(elastic=_ecfg(t_ctl), device="cpu", journal_dir=run_dir,
              checkpoint_dir=os.path.join(run_dir, "ck"))
    monkeypatch.setenv(t_chaos.CHAOS_ENV, world + ",raise:elastic:5:PREEMPTED")
    t_chaos.reset()
    with pytest.raises(t_chaos.ChaosInjection, match="PREEMPTED"):
        t_elastic.train_elastic_online(cfg, data, **kw)
    monkeypatch.setenv(t_chaos.CHAOS_ENV, world)
    t_chaos.reset()
    res = t_elastic.train_elastic_online(cfg, data, resume=True, **kw)
    assert res.resumed_from == 4 * CHUNK and res.result.start_round == 4 * CHUNK
    assert [t_elastic.science_fields(r) for r in res.rows] == \
        [t_elastic.science_fields(r) for r in base.rows]
    assert res.decisions == base.decisions
    assert torch.equal(res.result.final_params, base.result.final_params)
    assert torch.equal(res.result.params_history, base.result.params_history[4 * CHUNK:])
    for field in ("timeset", "worker_times", "collected", "decode_error"):
        assert getattr(res.result, field).tobytes() == getattr(base.result, field).tobytes()
    # the journal holds both processes' records and validates
    assert t_events.validate_file(res.journal_path) == []
    recs = [json.loads(line) for line in open(res.journal_path)]
    actions = [r["action"] for r in recs]
    assert actions.count("chunk") == len(base.rows)
    assert "death" in actions and "join" in actions and actions.count("relayout") == 2


def test_membership_records_validate_as_jax(data, tmp_path):
    path = str(tmp_path / "events.jsonl")
    with t_events.capture(path):
        res = t_elastic.train_elastic_online(RunConfig(**_kw()), data, elastic=_ecfg(t_ctl),
                                             deaths={7: 7}, journal_dir=str(tmp_path),
                                             device="cpu")
    for p in (path, res.journal_path):
        assert t_events.validate_file(p) == [] == j_events.validate_file(p)
    lines = [json.dumps({"type": "membership", "seq": i, "t": 0.0, **kw}) for i, kw in enumerate([
        dict(round=0, action="relayout", n_workers=4),
        dict(round=-1, action="death", n_workers=4),
        dict(round=1, action="resurrect", n_workers=4),
        dict(round=2, action="join", n_workers=0),
        dict(round=3, action="chunk", n_workers=4, workers=[1, -2]),
        dict(round=4, action="probe"),
    ])]
    got, want = t_events.validate_lines(lines), j_events.validate_lines(lines)
    assert got == want and len(got) == 6


def test_deep_layer_coded_elastic(tmp_path):
    """deepmlp layer-coded through the driver: the decode's per-slot trees
    re-lay onto the survivors like the GLM's stack."""
    kw = _kw(model="deepmlp", layer_coding="on", update_rule="GD", lr_schedule=0.5,
             scheme="approx", n_stragglers=1, num_collect=4, rounds=20)
    data = generate_gmm(32 * W, 16, n_partitions=W, seed=0)
    res = t_elastic.train_elastic_online(RunConfig(**kw), data, device="cpu",
                                         elastic=_ecfg(t_ctl, chunk_rounds=10, death_rounds=2),
                                         deaths={5: 0})
    assert [d["action"] for d in res.decisions][-1] == "relayout"
    assert [e["n_workers"] for e in res.epochs] == [W, W - 1]
    assert res.result.lowering == "layer_block"
    assert all(bool(torch.isfinite(h).all()) for h in res.result.params_history.values())


# ---------------------------------------------------------------------------
# the CLI


def test_cli_elastic_run(tmp_path, capsys):
    out = str(tmp_path / "elastic")
    argv = ["--scheme", "naive", "--workers", "6", "--stragglers", "0", "--rounds", "20",
            "--rows", "240", "--cols", "8", "--add-delay", "--device", "cpu", "--output-dir",
            out, "--elastic", "on", "--elastic-chunk", "5", "--death-rounds", "2",
            "--death-timeout", "2.0", "--kill-workers", "1:4,2:4"]
    assert t_cli.main(argv) == 0
    printed = capsys.readouterr().out
    assert "elastic membership: 4 chunk(s), 1 re-layout(s) across 2 epoch(s)" in printed
    assert "relayout" in printed
    wt = np.loadtxt(os.path.join(out, "naive_acc_worker_timeset.dat"))
    ts = np.loadtxt(os.path.join(out, "naive_acc_timeset.dat"))
    assert wt.shape == (20, 6) and (wt[10:, 1:3] == -1.0).all()
    assert (ts[4:6] == 2.0).all()  # the undetected deaths cost the timeout
