"""Pipelined tau=1 training of the port (parallel/pipeline.py, the trainer's
stale-params carry) against the JAX package's.

Mirrors tests/test_pipeline.py, with JAX's functions called directly as the
oracle:

  - the staleness schedule, and the pipelined schedule byte-equal to JAX's
    (host float64 on both sides) over schemes x seeds x delay means; at
    depth 0 it is bitwise the synchronous schedule of every scheme;
  - every refusal with JAX's ``reason`` and message;
  - the cohort planner routes pipelined configs to sequential runs;
  - pipelined trajectories (GLM, and deepmlp layer-coded against JAX's
    monolithic run) within the port's trainer tolerances of JAX's, from
    JAX's init draw; reruns bitwise; the trajectory really stale;
  - a pipelined sweep killed after its second journaled trajectory resumes
    to identical rows;
  - ``obs/decode.staleness_error_series`` against JAX's.
"""

import dataclasses

import jax
import numpy as np
import pytest

from erasurehead_tpu import schemes as j_schemes
from erasurehead_tpu.data.synthetic import generate_gmm as j_generate_gmm
from erasurehead_tpu.obs import decode as j_decode
from erasurehead_tpu.parallel import collect as j_collect
from erasurehead_tpu.parallel import pipeline as j_pipeline
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.utils.config import PipelineRefusal as JPipelineRefusal
from erasurehead_tpu.utils.config import RunConfig as JRunConfig
from erasurehead_tpu_torch import cli as t_cli
from erasurehead_tpu_torch.data.synthetic import generate_gmm
from erasurehead_tpu_torch.obs import decode as t_decode
from erasurehead_tpu_torch.obs import events as t_events
from erasurehead_tpu_torch.ops import blocks
from erasurehead_tpu_torch.parallel import pipeline as t_pipeline
from erasurehead_tpu_torch.parallel import step as t_step
from erasurehead_tpu_torch.train import experiments as t_exp
from erasurehead_tpu_torch.train import journal as t_journal
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils import chaos as t_chaos
from erasurehead_tpu_torch.utils.config import PipelineRefusal, RunConfig

W, R = 4, 6
N_ROWS, N_COLS = 64, 8

#: the scheme-specific knobs each built-in needs at W = 6, s = 1
KNOBS = {
    "approx": dict(num_collect=3),
    "randreg": dict(num_collect=3),
    "sparsegraph": dict(num_collect=3),
    "expander": dict(num_collect=3),
    "deadline": dict(deadline=0.5),
    "partialcyccoded": dict(partitions_per_worker=4),
    "partialrepcoded": dict(partitions_per_worker=4),
}
TOLERANT = [n for n in j_schemes.names() if j_schemes.get(n).staleness_tolerant]


def _kw(**kw):
    # avoidstragg + GD: the staleness-tolerant reference combination, at
    # an explicit lr (tests/test_pipeline.py::_cfg)
    base = dict(
        scheme="avoidstragg", n_workers=W, n_stragglers=1, rounds=R,
        n_rows=N_ROWS, n_cols=N_COLS, update_rule="GD", lr_schedule=1.0,
        add_delay=True, seed=0, compute_mode="deduped",
    )
    base.update(kw)
    return base


def _scheme_kw(scheme, **kw):
    return dict(scheme=scheme, n_workers=6, n_stragglers=1, rounds=20,
                update_rule="GD", **KNOBS.get(scheme, {}), **kw)


@pytest.fixture(scope="module")
def data():
    return generate_gmm(N_ROWS, N_COLS, n_partitions=W, seed=0)


@pytest.fixture(scope="module")
def jdata():
    return j_generate_gmm(N_ROWS, N_COLS, n_partitions=W, seed=0)


@pytest.fixture(autouse=True)
def _chaos_clean(monkeypatch):
    monkeypatch.delenv(t_chaos.CHAOS_ENV, raising=False)
    t_chaos.reset()
    yield
    t_chaos.reset()


def _jax_init(jcfg, n_cols=N_COLS):
    model = j_trainer.build_model(jcfg)
    return jax.tree.map(np.asarray, j_trainer._init_params_f32(jcfg, model, n_cols))


def _hist(res):
    return [np.asarray(h) for h in blocks.tree_leaves(
        blocks.tree_map(lambda h: h.numpy(), res.params_history))]


def _jleaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


SCHEDULE_FIELDS = ("message_weights", "sim_time", "worker_times", "collected",
                   "dispatch", "done", "dispatch_ahead", "staleness")


def _same_bytes(a, b, fields):
    for f in fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


# ---------------------------------------------------------------------------
# schedules


@pytest.mark.parametrize("rounds,depth", [(5, 1), (4, 0), (1, 1), (0, 1)])
def test_staleness_schedule_is_jax(rounds, depth):
    got = t_pipeline.staleness_schedule(rounds, depth)
    want = j_pipeline.staleness_schedule(rounds, depth)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("scheme", j_schemes.names())
def test_tau0_schedule_bitwise_synchronous(scheme):
    """Depth 0 collapses exactly onto the synchronous schedule of every
    scheme (relative times never round-trip through the absolute clock),
    and onto JAX's pipelined schedule."""
    cfg = RunConfig(**_scheme_kw(scheme))
    t = t_trainer.default_arrivals(cfg)
    layout = t_trainer.build_layout(cfg)
    sync = t_trainer.build_schedule(cfg, t, layout)
    pipe = t_pipeline.pipelined_schedule(cfg, t, layout)
    _same_bytes(pipe, sync, SCHEDULE_FIELDS[:4])
    assert np.all(pipe.dispatch_ahead == 0.0) and np.all(pipe.staleness == 0)
    jcfg = JRunConfig(**_scheme_kw(scheme))
    _same_bytes(pipe, j_pipeline.pipelined_schedule(jcfg, t, j_trainer.build_layout(jcfg)),
                SCHEDULE_FIELDS)


TAU1_GRID = [
    (scheme, seed, mean, decode)
    for scheme in TOLERANT
    for seed in (0, 1)
    for mean in (0.5, 2.0)
    for decode in ("fixed", "optimal")
    if decode == "fixed" or j_schemes.get(scheme).optimal_decode is not None
]


@pytest.mark.parametrize("scheme,seed,mean,decode", TAU1_GRID)
def test_tau1_schedule_byte_equal_jax(scheme, seed, mean, decode):
    kw = _scheme_kw(scheme, pipeline_depth=1, seed=seed, delay_mean=mean, decode=decode)
    cfg, jcfg = RunConfig(**kw), JRunConfig(**kw)
    t = j_trainer.default_arrivals(jcfg)
    assert t.tobytes() == t_trainer.default_arrivals(cfg).tobytes()
    got = t_pipeline.pipelined_schedule(cfg, t, t_trainer.build_layout(cfg))
    want = j_pipeline.pipelined_schedule(jcfg, t, j_trainer.build_layout(jcfg))
    _same_bytes(got, want, SCHEDULE_FIELDS)
    assert np.all(np.diff(got.done) >= 0.0) and np.all(got.dispatch_ahead >= 0.0)
    assert t_pipeline.overlap_summary(got) == j_pipeline.overlap_summary(want)


# ---------------------------------------------------------------------------
# refusals


@pytest.mark.parametrize(
    "kw,reason",
    [
        ({"scheme": "cyccoded"}, "exact_decode"),
        ({"scheme": "repcoded"}, "exact_decode"),
        ({"scheme": "naive"}, "exact_decode"),
        ({"scheme": "partialcyccoded", "partitions_per_worker": 3}, "exact_decode"),
        ({"update_rule": "AGD"}, "momentum_unproven"),
        ({"update_rule": "ADAM"}, "momentum_unproven"),
    ],
)
def test_refusals_at_config_are_jax(kw, reason):
    with pytest.raises(PipelineRefusal) as got:
        RunConfig(**_kw(pipeline_depth=1, **kw))
    with pytest.raises(JPipelineRefusal) as want:
        JRunConfig(**_kw(pipeline_depth=1, **kw))
    assert got.value.reason == want.value.reason == reason
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)


def test_depth_out_of_range_is_a_valueerror():
    with pytest.raises(ValueError) as got:
        RunConfig(**_kw(pipeline_depth=2))
    with pytest.raises(ValueError) as want:
        JRunConfig(**_kw(pipeline_depth=2))
    assert str(got.value) == str(want.value)


def _refusal(fn):
    with pytest.raises(Exception) as ei:
        fn()
    return ei.value


def test_refusals_at_train_are_jax(data, jdata, tmp_path):
    kw = _kw(pipeline_depth=1)
    cfg, jcfg = RunConfig(**kw), JRunConfig(**kw)
    ck = str(tmp_path / "ck")
    sched = j_collect.build_schedule(
        jcfg.scheme, j_trainer.default_arrivals(jcfg), j_trainer.build_layout(jcfg)
    )
    cases = [
        ("checkpoint_restart", dict(checkpoint_dir=ck)),
        ("checkpoint_restart", dict(resume=True)),
        ("custom_schedule", dict(schedule=sched)),
    ]
    for reason, extra in cases:
        got = _refusal(lambda: t_trainer.train(cfg, data, device="cpu", **extra))
        want = _refusal(lambda: j_trainer.train(jcfg, jdata, **extra))
        assert isinstance(got, PipelineRefusal) and isinstance(want, JPipelineRefusal)
        assert got.reason == want.reason == reason
        assert str(got) == str(want)
    got = _refusal(lambda: t_trainer.train_cohort([cfg, cfg], data, device="cpu"))
    want = _refusal(lambda: j_trainer.train_cohort([jcfg, jcfg], jdata))
    assert got.reason == want.reason == "cohort_batch" and str(got) == str(want)


def test_cli_refusals(tmp_path):
    base = ["--workers", "4", "--stragglers", "1", "--rows", "64", "--cols", "8",
            "--rounds", "3", "--update-rule", "GD", "--pipeline-depth", "1",
            "--device", "cpu", "--quiet", "--output-dir", str(tmp_path)]
    for extra, reason in ((["--scheme", "cyccoded"], "exact_decode"),
                          (["--scheme", "approx", "--num-collect", "3", "--update-rule",
                            "AGD"], "momentum_unproven"),
                          (["--scheme", "approx", "--num-collect", "3", "--checkpoint-dir",
                            str(tmp_path / "ck"), "--checkpoint-every", "1"],
                           "checkpoint_restart")):
        with pytest.raises(PipelineRefusal) as ei:
            t_cli.main(base + extra)
        assert ei.value.reason == reason


def test_cohort_planner_routes_pipelined_singletons():
    cfgs = {
        "sync0": RunConfig(**_kw(seed=0)),
        "sync1": RunConfig(**_kw(seed=1)),
        "pipe0": RunConfig(**_kw(seed=0, pipeline_depth=1)),
        "pipe1": RunConfig(**_kw(seed=1, pipeline_depth=1)),
    }
    plan = t_exp.plan_cohorts(cfgs)
    assert plan == [(["sync0", "sync1"], True), (["pipe0"], False), (["pipe1"], False)]
    assert not t_trainer.cohort_eligible(cfgs["pipe0"])
    assert cfgs["pipe0"].static_signature_fields()["pipeline_depth"] == 1


def test_staleness_slot_params():
    assert t_step.staleness_slot_params("live", "stale", 0) == "live"
    assert t_step.staleness_slot_params("live", "stale", 1) == "stale"


# ---------------------------------------------------------------------------
# trajectories


@pytest.mark.parametrize("scheme,compute_mode", [
    ("avoidstragg", "deduped"), ("approx", "faithful"), ("deadline", "deduped"),
])
def test_pipelined_glm_matches_jax(data, jdata, scheme, compute_mode):
    extra = {"approx": dict(num_collect=3), "deadline": dict(deadline=0.5)}.get(scheme, {})
    kw = _kw(pipeline_depth=1, scheme=scheme, compute_mode=compute_mode, **extra)
    jcfg = JRunConfig(**kw)
    want = j_trainer.train(jcfg, jdata, measure=False)
    got = t_trainer.train(RunConfig(**kw), data, device="cpu", init_params=_jax_init(jcfg))
    for field in ("timeset", "worker_times", "collected", "decode_error"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    for a, b in zip(_hist(got), _jleaves(want.params_history)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-5)
    assert got.cache_info["pipeline_depth"] == want.cache_info["pipeline_depth"] == 1
    assert got.cache_info["pipeline_params_slot_bytes"] == \
        want.cache_info["pipeline_params_slot_bytes"] == N_COLS * 4


def test_pipelined_deep_layer_coded_matches_jax():
    """deepmlp layer-coded (the decode kernel's path) pipelined, against
    JAX's monolithic pipelined run (the deep families' parity target)."""
    Wd, rows, cols = 8, 256, 64
    kw = dict(scheme="approx", model="deepmlp", n_workers=Wd, n_stragglers=1,
              num_collect=6, rounds=4, n_rows=rows, n_cols=cols, update_rule="GD",
              lr_schedule=0.1, add_delay=True, compute_mode="faithful", seed=3,
              pipeline_depth=1)
    jcfg = JRunConfig(**kw, layer_coding="off")
    want = j_trainer.train(jcfg, j_generate_gmm(rows, cols, n_partitions=Wd, seed=0),
                           measure=False)
    got = t_trainer.train(RunConfig(**kw, layer_coding="on", block_decode="fused"),
                          generate_gmm(rows, cols, n_partitions=Wd, seed=0), device="cpu",
                          init_params=_jax_init(jcfg, cols))
    assert got.layer_coded
    np.testing.assert_array_equal(got.timeset, want.timeset)
    for a, b in zip(_hist(got), _jleaves(want.params_history)):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-5)


def test_pipelined_run_deterministic_and_stale(data):
    a = t_trainer.train(RunConfig(**_kw(pipeline_depth=1)), data, device="cpu")
    b = t_trainer.train(RunConfig(**_kw(pipeline_depth=1)), data, device="cpu")
    for x, y in zip(_hist(a), _hist(b)):
        assert x.tobytes() == y.tobytes()
    assert a.timeset.tobytes() == b.timeset.tobytes()
    sync = t_trainer.train(RunConfig(**_kw()), data, device="cpu")
    for s, p in zip(_hist(sync), _hist(a)):
        # rounds 0 and 1 both step from g(p0); round 1's iterate differs
        # only by the stale gradient, so the histories part after round 0
        assert s[0].tobytes() == p[0].tobytes()
        assert not np.array_equal(s[-1], p[-1])
    # depth 0 is the synchronous run itself
    zero = t_trainer.train(dataclasses.replace(RunConfig(**_kw()), pipeline_depth=0), data,
                           device="cpu")
    for s, z in zip(_hist(sync), _hist(zero)):
        assert s.tobytes() == z.tobytes()


def test_pipelined_kill_resume_rows_identical(data, tmp_path, monkeypatch):
    configs = {
        "pipe_a": RunConfig(**_kw(pipeline_depth=1, seed=0)),
        "pipe_b": RunConfig(**_kw(pipeline_depth=1, seed=1)),
        "sync": RunConfig(**_kw(seed=0)),
    }
    baseline = t_exp.compare(dict(configs), data, device="cpu")
    jdir = str(tmp_path / "journal")
    monkeypatch.setenv(t_chaos.CHAOS_ENV, "raise:trajectory:2")
    t_chaos.reset()
    j = t_journal.SweepJournal(jdir, resume=False)
    with pytest.raises(t_chaos.ChaosInjection):
        t_exp.compare(dict(configs), data, journal=j, device="cpu")
    j.close()
    monkeypatch.delenv(t_chaos.CHAOS_ENV)
    t_chaos.reset()
    j2 = t_journal.SweepJournal(jdir, resume=True)
    assert len(j2) == 2
    resumed = t_exp.compare(dict(configs), data, journal=j2, device="cpu")
    j2.close()
    assert [t_journal.science_row(s.row()) for s in baseline] == \
        [t_journal.science_row(s.row()) for s in resumed]
    for a, b in zip(baseline, resumed):
        assert a.training_loss.tobytes() == b.training_loss.tobytes()
        assert a.timeset.tobytes() == b.timeset.tobytes()
    assert t_events.validate_file(j2.path) == []


@pytest.mark.parametrize("depth", [1, 0])
def test_staleness_error_series_matches_jax(data, jdata, depth):
    kw = _kw(pipeline_depth=depth)
    jcfg = JRunConfig(**kw)
    init = _jax_init(jcfg)
    res = t_trainer.train(RunConfig(**kw), data, device="cpu", init_params=init)
    tau = t_pipeline.staleness_schedule(R, depth)
    got = t_decode.staleness_error_series(
        t_trainer.build_model(res.config), res.params_history, tau,
        data.X_train, data.y_train, init,
    )
    hist = np.asarray(res.params_history.numpy())
    want = j_decode.staleness_error_series(
        j_trainer.build_model(jcfg), hist, tau, jdata.X_train, jdata.y_train, init,
    )
    assert got.dtype == want.dtype == np.float64 and got.shape == (R,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    assert (got[tau == 0] == 0.0).all()
    assert (got[tau > 0] > 0.0).all() if depth else (got == 0.0).all()


def test_cli_pipelined_run_writes_artifacts(tmp_path):
    args = ["--scheme", "approx", "--workers", "4", "--stragglers", "1", "--num-collect", "3",
            "--rows", "64", "--cols", "8", "--rounds", "4", "--update-rule", "GD",
            "--lr", "1.0", "--add-delay", "--pipeline-depth", "1", "--device", "cpu",
            "--quiet"]
    res, _, paths = t_cli.run(t_cli._flags_to_config(t_cli._flags_parser().parse_args(args)),
                              output_dir=str(tmp_path), device="cpu", quiet=True)
    assert res.config.pipeline_depth == 1
    cfg = res.config
    want = t_pipeline.pipelined_schedule(cfg, t_trainer.default_arrivals(cfg),
                                         t_trainer.build_layout(cfg))
    assert res.timeset.tobytes() == want.sim_time.tobytes()
    assert all(np.isfinite(np.loadtxt(p)).all() for k, p in paths.items()
               if str(p).endswith(".dat"))
