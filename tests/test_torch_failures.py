"""The port's worker-failure handling (parallel/failures.py) against the JAX
package's.

Mirrors tests/test_failures.py on its inputs (R, W, S = 6, 12, 2, the
reference's seeded arrivals), with JAX's functions as the oracle:

  - injection, detection, the feasibility table, plan_run's error and
    failover modes, failover_schedule's refusals and survivor_config: every
    array byte-equal to JAX's, every error message equal;
  - train_elastic, through train's restart contract and through
    train_dynamic: iterates allclose to JAX's from JAX's init draw, the
    clocks and -1 columns equal, the report the same;
  - the CLI's --kill-workers/--on-death/--death-timeout: its refusals
    (exit code 2, JAX's messages) and a failover and an elastic run.
"""

import os

import numpy as np
import pytest
import torch

from erasurehead_tpu.data.synthetic import generate_gmm as j_generate_gmm
from erasurehead_tpu.ops import codes as j_codes
from erasurehead_tpu.parallel import failures as j_failures
from erasurehead_tpu.parallel import straggler as j_straggler
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.utils.config import RunConfig as JRunConfig
from erasurehead_tpu_torch import cli as t_cli
from erasurehead_tpu_torch.data.synthetic import generate_gmm
from erasurehead_tpu_torch.ops import codes as t_codes
from erasurehead_tpu_torch.parallel import failures as t_failures
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils.config import RunConfig

R, W, S = 6, 12, 2


@pytest.fixture(scope="module")
def arrivals():
    return j_straggler.arrival_schedule(R, W, add_delay=True)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _same_schedule(a, b):
    return all(_same(getattr(a, f), getattr(b, f))
               for f in ("message_weights", "sim_time", "worker_times", "collected"))


def test_inject_and_detect_match_jax(arrivals):
    deaths = {3: 2, 7: 0}
    t = t_failures.inject_worker_death(arrivals, deaths)
    assert _same(t, j_failures.inject_worker_death(arrivals, deaths))
    assert np.isfinite(arrivals).all()  # the input untouched
    wt = np.array(arrivals, copy=True)
    wt[:, 3] = -1.0  # the never-collected sentinel
    wt[2, 5] = 500.0
    for timeout in (np.inf, 100.0, 1.0):
        for a in (t, wt):
            assert _same(t_failures.detect_dead(a, timeout), j_failures.detect_dead(a, timeout))
    with pytest.raises(ValueError, match="out of range"):
        t_failures.inject_worker_death(arrivals, {W: 1})


LAYOUTS = {
    "naive": lambda: t_codes.uncoded_layout(W),
    "cyccoded": lambda: t_codes.cyclic_mds_layout(W, S, seed=0),
    "repcoded": lambda: t_codes.frc_layout(W, S),
    "approx": lambda: t_codes.frc_layout(W, S),
    "avoidstragg": lambda: t_codes.uncoded_layout(W, n_stragglers=S),
    "randreg": lambda: t_codes.random_regular_layout(W, S, seed=0),
    "deadline": lambda: t_codes.uncoded_layout(W),
    "partialcyccoded": lambda: t_codes.partial_cyclic_layout(W, S + 2, S, seed=0),
    "partialrepcoded": lambda: t_codes.partial_frc_layout(W, S + 2, S),
}
J_LAYOUTS = {
    "naive": lambda: j_codes.uncoded_layout(W),
    "cyccoded": lambda: j_codes.cyclic_mds_layout(W, S, seed=0),
    "repcoded": lambda: j_codes.frc_layout(W, S),
    "approx": lambda: j_codes.frc_layout(W, S),
    "avoidstragg": lambda: j_codes.uncoded_layout(W, n_stragglers=S),
    "randreg": lambda: j_codes.random_regular_layout(W, S, seed=0),
    "deadline": lambda: j_codes.uncoded_layout(W),
    "partialcyccoded": lambda: j_codes.partial_cyclic_layout(W, S + 2, S, seed=0),
    "partialrepcoded": lambda: j_codes.partial_frc_layout(W, S + 2, S),
}
KW = {"approx": dict(num_collect=6), "randreg": dict(num_collect=8),
      "deadline": dict(deadline=1.0)}
DEATHS = ({0: 0}, {0: 0, 1: 0}, {0: 0, 1: 0, 2: 0}, {0: 3, 3: 4}, {5: 1, 6: 1, 7: 1, 8: 1})


def _outcome(fn):
    """(schedule, report) or the raised error's type name and message."""
    try:
        return fn()
    except (ValueError, RuntimeError) as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("scheme", list(LAYOUTS))
def test_analyze_and_plan_run_match_jax(arrivals, scheme):
    layout, jlayout = LAYOUTS[scheme](), J_LAYOUTS[scheme]()
    kw = KW.get(scheme, {})
    for deaths in DEATHS:
        t = t_failures.inject_worker_death(arrivals, deaths)
        rep = t_failures.analyze(scheme, layout, t, num_collect=kw.get("num_collect"))
        jrep = j_failures.analyze(scheme, jlayout, t, num_collect=kw.get("num_collect"))
        assert _same(rep.feasible, jrep.feasible) and _same(rep.dead, jrep.dead)
        assert rep.reason == jrep.reason and rep.first_infeasible == jrep.first_infeasible
        for mode, timeout in (("error", np.inf), ("failover", 50.0), ("failover", np.inf)):
            got = _outcome(lambda: t_failures.plan_run(
                scheme, layout, t, timeout=timeout, on_infeasible=mode, **kw))
            want = _outcome(lambda: j_failures.plan_run(
                scheme, jlayout, t, timeout=timeout, on_infeasible=mode, **kw))
            if isinstance(want[0], str):
                assert got == want, (deaths, mode)
            else:
                assert _same_schedule(got[0], want[0]), (deaths, mode)
                assert _same(got[1].feasible, want[1].feasible)


def test_failover_schedule_refusals_match_jax(arrivals):
    # every worker dead from round 1: nothing left to rescale over
    t = t_failures.inject_worker_death(arrivals, {w: 1 for w in range(W)})
    errors = []
    for failures, layout in ((t_failures, t_codes.uncoded_layout(W)),
                             (j_failures, j_codes.uncoded_layout(W))):
        rep = failures.analyze("naive", layout, t)
        sched = t_trainer.build_schedule(RunConfig(n_workers=W, rounds=R), arrivals,
                                         t_codes.uncoded_layout(W))
        errors.append(_outcome(lambda: failures.failover_schedule(sched, layout, t, rep, 50.0)))
    assert errors[0] == errors[1] and errors[0][0] == "InfeasibleRunError"
    assert "round 1" in errors[0][1]
    got = _outcome(lambda: t_failures.plan_run("naive", t_codes.uncoded_layout(W), t,
                                               timeout=1.0, on_infeasible="retry"))
    want = _outcome(lambda: j_failures.plan_run("naive", j_codes.uncoded_layout(W), t,
                                                timeout=1.0, on_infeasible="retry"))
    assert got == want


def test_survivor_config_matches_jax():
    kw = dict(scheme="approx", n_workers=8, n_stragglers=1, num_collect=6, rounds=10,
              n_rows=256, n_cols=8, lr_schedule=1.0, add_delay=True)
    got = _outcome(lambda: t_failures.survivor_config(RunConfig(**kw), 5))
    want = _outcome(lambda: j_failures.survivor_config(JRunConfig(**kw), 5))
    assert got == want and "survivor_overrides" in got[1]
    cfg2 = t_failures.survivor_config(RunConfig(**kw), 5, {"n_stragglers": 0})
    assert cfg2.n_workers == 5 and cfg2.num_collect == 5


def _elastic_kw(**kw):
    base = dict(scheme="approx", n_workers=8, n_stragglers=1, num_collect=6, rounds=12,
                n_rows=48 * 8, n_cols=16, lr_schedule=1.0, update_rule="AGD",
                add_delay=True, seed=0)
    base.update(kw)
    return base


def _jax_init(jcfg):
    model = j_trainer.build_model(jcfg)
    return np.asarray(j_trainer._init_params_f32(jcfg, model, jcfg.n_cols))


@pytest.mark.parametrize("dynamic", [False, True])
def test_train_elastic_matches_jax(dynamic):
    kw = _elastic_kw(**({"scheme": "deadline", "deadline": 0.6} if dynamic else {}))
    cfg, jcfg = RunConfig(**kw), JRunConfig(**kw)
    data = generate_gmm(cfg.n_rows, cfg.n_cols, n_partitions=8, seed=0)
    jdata = j_generate_gmm(cfg.n_rows, cfg.n_cols, n_partitions=8, seed=0)
    deaths = {6: 5, 7: 7, 2: 100}
    got, rep = t_failures.train_elastic(cfg, data, deaths, device="cpu", dynamic=dynamic,
                                        init_params=_jax_init(jcfg))
    want, jrep = j_failures.train_elastic(jcfg, jdata, deaths, dynamic=dynamic)
    assert rep == t_failures.ElasticReport(**jrep.__dict__)
    assert rep.death_round == 5 and rep.dead_workers == (6, 7) and rep.n_workers_after == 6
    assert got.n_train == want.n_train
    np.testing.assert_array_equal(got.collected, want.collected)
    np.testing.assert_array_equal(got.worker_times == -1.0, want.worker_times == -1.0)
    assert (got.worker_times[5:, 6:] == -1.0).all() and not got.collected[5:, 6:].any()
    np.testing.assert_allclose(got.worker_times, want.worker_times, rtol=1e-6)
    np.testing.assert_allclose(got.timeset, want.timeset, rtol=1e-6)
    np.testing.assert_allclose(got.params_history.numpy(), np.asarray(want.params_history),
                               rtol=1e-4, atol=1e-5)


def test_train_elastic_validation_matches_jax():
    kw = dict(scheme="naive", n_workers=4, n_stragglers=0, rounds=6, n_rows=64, n_cols=8,
              lr_schedule=1.0, add_delay=True, seed=0)
    data = generate_gmm(64, 8, n_partitions=4, seed=0)
    jdata = j_generate_gmm(64, 8, n_partitions=4, seed=0)
    for deaths in ({}, {9: 2}, {1: 0}, {2: 100}):
        got = _outcome(lambda: t_failures.train_elastic(RunConfig(**kw), data, deaths,
                                                        device="cpu"))
        want = _outcome(lambda: j_failures.train_elastic(JRunConfig(**kw), jdata, deaths))
        assert got == want
    # FRC's (s+1) | W' is checked before any training
    bad = dict(scheme="approx", n_workers=8, n_stragglers=1, num_collect=6, rounds=10,
               n_rows=64, n_cols=8, lr_schedule=1.0, add_delay=True)
    got = _outcome(lambda: t_failures.train_elastic(
        RunConfig(**bad), generate_gmm(64, 8, n_partitions=8, seed=0), {5: 4, 6: 4, 7: 4},
        device="cpu"))
    assert got[0] == "ValueError" and "survivor_overrides" in got[1]


def test_train_restart_contract():
    """train's initial_state/initial_round: a run split at round 4 and
    resumed from its carried state replays the unsplit run's iterates (the
    control plane is the same precomputed schedule)."""
    kw = _elastic_kw(rounds=10)
    data = generate_gmm(48 * 8, 16, n_partitions=8, seed=0)
    lr = RunConfig(**kw).resolve_lr_schedule()
    full = t_trainer.train(RunConfig(**kw), data, device="cpu")
    p1 = t_trainer.train(RunConfig(**{**kw, "rounds": 4, "lr_schedule": lr[:4]}), data,
                         device="cpu")
    p2 = t_trainer.train(RunConfig(**kw), data, device="cpu",
                         initial_state=p1.final_state, initial_round=4)
    assert p2.start_round == 4 and torch.equal(p2.params_history, full.params_history[4:])
    assert p2.timeset.tobytes() == full.timeset.tobytes()
    jdata = j_generate_gmm(48 * 8, 16, n_partitions=8, seed=0)
    for call in (dict(initial_round=3), dict(initial_state=p1.final_state, initial_round=10),
                 dict(initial_state=p1.final_state, initial_round=2, resume=True)):
        got = _outcome(lambda: t_trainer.train(RunConfig(**kw), data, device="cpu", **call))
        # JAX refuses these before it reads the donor state
        jcall = {k: ("donor" if k == "initial_state" else v) for k, v in call.items()}
        want = _outcome(lambda: j_trainer.train(JRunConfig(**kw), jdata, **jcall))
        assert got == want
    # pipelined runs and the windowed streamed path refuse the restart
    pipe = dict(kw, update_rule="GD", pipeline_depth=1)
    got = _outcome(lambda: t_trainer.train(RunConfig(**pipe), data, device="cpu",
                                           initial_state=p1.final_state, initial_round=4))
    assert got[0] == "PipelineRefusal" and "initial_state/initial_round" in got[1]
    streamed = dict(kw, stack_residency="streamed", stream_window=2, compute_mode="deduped")
    got = _outcome(lambda: t_trainer.train(RunConfig(**streamed), data, device="cpu",
                                           initial_state=p1.final_state, initial_round=4))
    assert got[0] == "ValueError" and "mid-schedule restart" in got[1]


CLI_BASE = ["--scheme", "approx", "--workers", "6", "--stragglers", "1", "--num-collect",
            "4", "--rounds", "6", "--rows", "240", "--cols", "8", "--add-delay", "--quiet",
            "--device", "cpu"]


@pytest.mark.parametrize("extra,msg", [
    (["--on-death", "failover"], "--on-death requires --kill-workers"),
    (["--kill-workers", "1:2", "--death-timeout", "2.0"],
     "--death-timeout only applies to --on-death failover"),
    (["--kill-workers", "1:2", "--on-death", "failover"],
     "--on-death failover requires --death-timeout"),
    (["--kill-workers", "1:2", "--checkpoint-dir", "ck", "--checkpoint-every", "2"],
     "--kill-workers does not compose with checkpointing"),
])
def test_cli_refusals(capsys, extra, msg):
    with pytest.raises(SystemExit) as ei:
        t_cli.main(CLI_BASE + extra)
    assert ei.value.code == 2 and msg in capsys.readouterr().err


def test_cli_death_runs(tmp_path):
    kills = ["--kill-workers", "0:2,1:2,2:3"]
    # error mode: naive needs every worker, so round 2 cannot complete
    with pytest.raises(t_failures.InfeasibleRunError, match="round 2"):
        t_cli.main(["--scheme", "naive"] + CLI_BASE[2:] + kills)
    with pytest.raises(ValueError, match="bad --kill-workers entry"):
        t_cli.main(CLI_BASE + ["--kill-workers", "x"])
    with pytest.raises(ValueError, match="outside"):
        t_cli.main(CLI_BASE + ["--kill-workers", "9:1"])
    out = str(tmp_path / "failover")
    assert t_cli.main(["--scheme", "naive"] + CLI_BASE[2:] + kills + [
        "--on-death", "failover", "--death-timeout", "2.0", "--output-dir", out]) == 0
    ts = np.loadtxt(os.path.join(out, "naive_acc_timeset.dat"))
    wt = np.loadtxt(os.path.join(out, "naive_acc_worker_timeset.dat"))
    assert (ts[2:] == 2.0).all() and (wt[2:, :2] == -1.0).all() and (wt[3:, 2] == -1.0).all()
    out = str(tmp_path / "elastic")
    elastic = ["--scheme", "approx", "--workers", "6", "--stragglers", "0", "--num-collect",
               "3", "--rounds", "6", "--rows", "240", "--cols", "8", "--add-delay", "--quiet",
               "--device", "cpu", "--output-dir", out, "--on-death", "elastic"]
    assert t_cli.main(elastic + kills) == 0
    wt = np.loadtxt(os.path.join(out, "approx_acc_0_worker_timeset.dat"))
    assert wt.shape == (6, 6) and (wt[2:, :3] == -1.0).all()
    assert ((wt[:2] >= 0).sum(axis=1) == 3).all()  # collect 3 of 6 before the restart
