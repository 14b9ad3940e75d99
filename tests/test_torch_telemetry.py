"""The trainers' run telemetry against the JAX package's, and the
observation-only contract.

Each case trains the same config on both packages under a capture, the port
from JAX's init draw, on the CPU (``use_pallas="off"`` on both sides, so the
JAX package's auto gate adds no warning of its own): a faithful approx run,
a cyccoded run, a pipelined run, a deduped cohort, a windowed streamed run
and a measured-arrival run. Per run (the records that carry its run_id):

  - the record types and their order are equal (a streamed run's
    ``prefetch`` records, which JAX writes from its staging thread, are
    compared apart, in window order);
  - the key sets are equal (``compile`` means the kernel library's load
    here, and ``mesh``, ``platform``, ``config_hash`` and ``lowering`` carry
    the port's own values: the documented deviations are in values only);
  - the host-derived fields are exactly equal: the simulated clock, the
    masked arrival summaries, the decode errors, the critical path's sim
    ledger, the cohort's composition, the dispatch-ahead fields (a measured
    run's arrivals are real timings, so only its types and keys compare);
  - ``update_norm_mean`` within rtol 1e-4 (the iterates match to the
    trainers' float32 tolerance); wall fields are present, not compared.

Both packages' ``report.render`` give the same text on each log, JAX-written
and port-written, and both validators accept them. Runs with a capture, an
attached reducer and a ``device_trace`` are bitwise the runs without. Also:
the determinism audit, ``resolve_telemetry``, the CLI's ``--telemetry`` and
``--trace-dir``, and the harness's and checkpoint's warning records.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from erasurehead_tpu.data import store as j_store
from erasurehead_tpu.data.synthetic import generate_gmm as j_generate_gmm
from erasurehead_tpu.obs import events as j_events
from erasurehead_tpu.obs import report as j_report
from erasurehead_tpu.parallel import straggler as j_straggler
from erasurehead_tpu.train import experiments as j_exp
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.utils import chaos as j_chaos
from erasurehead_tpu.utils import config as j_config
from erasurehead_tpu_torch import cli as t_cli
from erasurehead_tpu_torch import tune as t_tune
from erasurehead_tpu_torch.data import store as t_store
from erasurehead_tpu_torch.data.synthetic import generate_gmm
from erasurehead_tpu_torch.obs import events as t_events
from erasurehead_tpu_torch.obs import report as t_report
from erasurehead_tpu_torch.obs.timeseries import TimeseriesReducer
from erasurehead_tpu_torch.ops import blocks
from erasurehead_tpu_torch.parallel import straggler as t_straggler
from erasurehead_tpu_torch.train import cache as t_cache
from erasurehead_tpu_torch.train import checkpoint as t_ckpt
from erasurehead_tpu_torch.train import experiments as t_exp
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.tune import cache as t_tune_cache
from erasurehead_tpu_torch.utils import audit as t_audit
from erasurehead_tpu_torch.utils import chaos as t_chaos
from erasurehead_tpu_torch.utils import config as t_config
from erasurehead_tpu_torch.utils.tracing import device_trace

W, ROWS, COLS, ROUNDS = 8, 256, 16, 12
NORM_RTOL = 1e-4


def _kw(**kw):
    base = dict(scheme="approx", n_workers=W, n_stragglers=1, num_collect=5, rounds=ROUNDS,
                n_rows=ROWS, n_cols=COLS, lr_schedule=1.0, update_rule="AGD", add_delay=True,
                seed=0, use_pallas="off")
    base.update(kw)
    return base


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for mod in (t_chaos, j_chaos):
        monkeypatch.delenv(mod.CHAOS_ENV, raising=False)
        mod.reset()
    monkeypatch.delenv(t_config.TELEMETRY_ENV, raising=False)
    monkeypatch.delenv(t_config.STREAM_WINDOW_ENV, raising=False)
    yield
    t_chaos.reset()
    j_chaos.reset()


@pytest.fixture(scope="module")
def data():
    return generate_gmm(ROWS, COLS, n_partitions=W, seed=0)


@pytest.fixture(scope="module")
def jdata():
    return j_generate_gmm(ROWS, COLS, n_partitions=W, seed=0)


def _jax_init(jcfg):
    return np.asarray(j_trainer._init_params_f32(jcfg, j_trainer.build_model(jcfg), COLS))


def _records(path):
    return [json.loads(line) for line in open(path)]


# ---------------------------------------------------------------------------
# the cases: (port runner, JAX runner), each given (data, jdata, tmp dir)


def _single(**kw):
    def run(data, jdata, tmp):
        jcfg, cfg = j_config.RunConfig(**_kw(**kw)), t_config.RunConfig(**_kw(**kw))
        return (lambda: t_trainer.train(cfg, data, device="cpu", init_params=_jax_init(jcfg)),
                lambda: j_trainer.train(jcfg, jdata))
    return run


def _cohort(data, jdata, tmp):
    kws = [_kw(compute_mode="deduped"), _kw(scheme="naive", num_collect=None,
                                            compute_mode="deduped", seed=1)]
    jcfgs = [j_config.RunConfig(**k) for k in kws]
    cfgs = [t_config.RunConfig(**k) for k in kws]
    inits = [_jax_init(c) for c in jcfgs]
    return (lambda: t_trainer.train_cohort(cfgs, data, device="cpu", init_params=inits),
            lambda: j_trainer.train_cohort(jcfgs, jdata))


def _streamed(data, jdata, tmp):
    kw = _kw(compute_mode="deduped", stack_residency="streamed", stream_window=2)
    jcfg, cfg = j_config.RunConfig(**kw), t_config.RunConfig(**kw)
    tdir = str(tmp / "store")
    if not os.path.exists(tdir):
        t_store.write_store(data, tdir, W)
    return (lambda: t_trainer.train(cfg, t_store.open_store(tdir).dataset(), device="cpu",
                                    init_params=_jax_init(jcfg)),
            lambda: j_trainer.train(jcfg, j_store.open_store(tdir).dataset()))


def _measured(data, jdata, tmp):
    kw = _kw(scheme="avoidstragg", n_stragglers=2, num_collect=None, arrival_mode="measured")
    jcfg, cfg = j_config.RunConfig(**kw), t_config.RunConfig(**kw)
    return (lambda: t_trainer.train_measured(cfg, data, device="cpu",
                                             init_params=_jax_init(jcfg), _clock=lambda: 0.0),
            lambda: j_trainer.train_measured(jcfg, jdata))


CASES = {
    "approx": _single(),
    "cyccoded": _single(scheme="cyccoded", num_collect=None),
    "pipelined": _single(update_rule="GD", pipeline_depth=1),
    "cohort": _cohort,
    "streamed": _streamed,
    "measured": _measured,
}


@pytest.fixture(scope="module")
def logs(data, jdata, tmp_path_factory):
    """Every case once on both packages, each under its own capture."""
    out = {}
    for name, case in CASES.items():
        tmp = tmp_path_factory.mktemp(name)
        run_t, run_j = case(data, jdata, tmp)
        t_cache.clear()
        t_path, j_path = str(tmp / "t.jsonl"), str(tmp / "j.jsonl")
        with t_events.capture(t_path):
            got = run_t()
        with j_events.capture(j_path):
            want = run_j()
        out[name] = (t_path, j_path, got, want)
    return out


def _run_records(path, run_id):
    return [r for r in _records(path) if r.get("run_id") == run_id and r["type"] != "warning"]


def _first(res):
    return res[0] if isinstance(res, list) else res


#: fields computed on the host from the control plane: equal on both sides
HOST_FIELDS = {
    "rounds": ("first_round", "n_rounds", "sim_time_s", "arrival", "trajectory"),
    "decode": ("first_round", "n_rounds", "error_mean", "error_max", "exact", "trajectory",
               "layer"),
    "run_end": ("sim_total_time_s", "arrival", "decode_error_mean", "decode_error_max",
                "batch_size", "cohort_size"),
    "cohort": ("n_trajectories", "schemes", "seeds", "dispatches", "lowering"),
    "dispatch_ahead": ("first_round", "n_rounds", "pipeline_depth", "ahead_mean_s",
                       "ahead_max_s", "overlap_total_s"),
    "critical_path": ("sim_total_s", "sim_components", "overlap_hidden_s", "transport"),
    "run_start": ("scheme", "model", "n_workers", "n_stragglers", "rounds", "compute_mode",
                  "stack_mode", "dtype"),
    "prefetch": ("window", "bytes", "partitions", "ranges", "plan_mode", "halo",
                 "group_workers"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_emission_matches_jax(logs, name):
    t_path, j_path, got, want = logs[name]
    g, w = _first(got), _first(want)
    assert g.run_id is not None and w.run_id is not None
    if isinstance(got, list):
        assert {r.run_id for r in got} == {g.run_id}
    tr, jr = _run_records(t_path, g.run_id), _run_records(j_path, w.run_id)
    t_pf = [r for r in tr if r["type"] == "prefetch"]
    j_pf = sorted((r for r in jr if r["type"] == "prefetch"), key=lambda r: r["window"])
    tr = [r for r in tr if r["type"] != "prefetch"]
    jr = [r for r in jr if r["type"] != "prefetch"]
    assert [r["type"] for r in tr] == [r["type"] for r in jr]
    assert len(t_pf) == len(j_pf) == (4 if name == "streamed" else 0)
    measured = name == "measured"
    for a, b in zip(tr + t_pf, jr + j_pf):
        assert set(a) == set(b), (a["type"], set(a) ^ set(b))
        if measured and a["type"] in ("rounds", "run_end", "decode"):
            continue  # real per-worker timings: the arrivals differ
        for f in HOST_FIELDS.get(a["type"], ()):
            assert a.get(f) == b.get(f), (a["type"], f)
        if "update_norm_mean" in b:
            np.testing.assert_allclose(a["update_norm_mean"], b["update_norm_mean"],
                                       rtol=NORM_RTOL)
        if a["type"] == "critical_path":
            for k in ("compute", "straggler_wait", "dispatch_gap"):
                assert a["fractions"][k] == b["fractions"][k], k
    for rec in tr:
        if rec["type"] in ("run_end", "critical_path"):
            assert rec.get("wall_time_s", rec.get("wall_s")) >= 0
    kinds = [r["type"] for r in tr]
    assert kinds[:2] == ["run_start", "data_upload"] and "run_end" in kinds
    assert ("compile" in kinds) == (not measured)
    assert ("critical_path" in kinds) == (not measured)
    assert ("dispatch_ahead" in kinds) == (name == "pipelined")
    start = tr[0]
    assert start["platform"] == "cpu" and start["mesh"] == [["workers"], [1], [0]]
    end = next(r for r in tr if r["type"] == "run_end")
    assert end["steps_per_sec"] == round(g.steps_per_sec, 4)
    if name == "streamed":
        cp = next(r for r in tr if r["type"] == "critical_path")
        assert cp["components"]["prefetch_stall_s"] == round(
            min(g.cache_info["prefetch"]["blocked_s"], g.wall_time), 6)
        # the staged windows' reads, after the store.dataset() read of the
        # whole store
        ios = [r for r in _records(t_path) if r["type"] == "io"]
        assert [r["ranges"] for r in ios] == [[[0, W]]] + [r["ranges"] for r in t_pf]


@pytest.mark.parametrize("name", list(CASES))
def test_logs_validate_and_render_as_jax(logs, name):
    t_path, j_path, _, _ = logs[name]
    for path in (t_path, j_path):
        assert t_events.validate_file(path) == [] == j_events.validate_file(path)
        assert t_report.render([path]) == j_report.render([path])
    assert _records(t_path)[-1]["type"] == "metrics"
    if name == "cohort":
        cohort = [r for r in _records(t_path) if r["type"] == "cohort"]
        assert len(cohort) == 1 and cohort[0]["dispatches"] == 1
        trajs = {r.get("trajectory") for r in _records(t_path) if r["type"] == "rounds"}
        assert trajs == {"0:approx:s0", "1:naive:s1"}
        assert "cohort dispatches" in t_report.render([t_path])


def test_report_renders_both_logs_together(logs):
    paths = [logs["approx"][0], logs["approx"][1], logs["cohort"][0]]
    text = t_report.render(paths)
    assert text == j_report.render(paths) and "critical path" in text


# ---------------------------------------------------------------------------
# observation only


def _observed(run):
    """The run with a capture, an attached reducer and a trace around it."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        red = TimeseriesReducer()
        with t_events.capture(os.path.join(d, "e.jsonl")), red.attach(), \
                device_trace(os.path.join(d, "trace"), device="cpu"):
            res = run()
        assert red.snapshot()["consumed"] > 0
        assert t_events.validate_file(os.path.join(d, "e.jsonl")) == []
    return res


def _bitwise(a, b):
    for x, y in zip(blocks.tree_leaves(a.params_history), blocks.tree_leaves(b.params_history)):
        assert torch.equal(x, y)
    for f in ("timeset", "worker_times", "collected"):
        assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
    assert a.run_id is None and b.run_id is not None


@pytest.mark.parametrize("name", list(CASES))
def test_telemetry_and_trace_never_change_a_run(data, jdata, tmp_path, name):
    run_t, _ = CASES[name](data, jdata, tmp_path)
    plain = run_t()
    seen = _observed(run_t)
    for a, b in zip(plain if isinstance(plain, list) else [plain],
                    seen if isinstance(seen, list) else [seen]):
        _bitwise(a, b)


# ---------------------------------------------------------------------------
# the other records


def test_checkpoint_invalid_is_a_warning_record(data, tmp_path):
    cfg = t_config.RunConfig(**_kw(rounds=6))
    ck = str(tmp_path / "ck")
    t_trainer.train(cfg, data, device="cpu", checkpoint_dir=ck, checkpoint_every=2)
    os.remove(os.path.join(ck, "round_4", t_ckpt.COMMIT_MARKER))
    path = str(tmp_path / "e.jsonl")
    with t_events.capture(path):
        res = t_trainer.train(cfg, data, device="cpu", checkpoint_dir=ck, checkpoint_every=2,
                              resume=True)
    assert res.start_round == 2
    warns = [r for r in _records(path) if r["type"] == "warning"]
    assert [w["kind"] for w in warns] == ["checkpoint_invalid"] and "round_4" in warns[0]["message"]
    chunks = [r for r in _records(path) if r["type"] == "rounds"]
    assert [c["first_round"] for c in chunks] == [2]
    assert t_events.validate_file(path) == []


def test_use_pallas_declined_on_a_cached_xla_verdict(data, tmp_path, monkeypatch):
    monkeypatch.setenv(t_tune_cache.ENV_PATH, str(tmp_path / "tune.json"))
    t_tune.reset()
    t_tune.reset_emitted()
    try:
        cfg = t_config.RunConfig(**_kw(use_pallas="auto", rounds=3))
        model, X = t_trainer.resolved_stack(cfg, data, device="cpu")
        sig = t_tune.glm_fused_signature(X.shape, X.dtype, "logistic")
        t_tune.get_cache().record("cpu", "glm_fused", sig, "xla")
        t_trainer._pallas_declined_seen.clear()
        path = str(tmp_path / "e.jsonl")
        with t_events.capture(path):
            a = t_trainer.train(cfg, data, device="cpu")
            t_trainer.train(cfg, data, device="cpu")
        warns = [r for r in _records(path) if r["type"] == "warning"
                 and r["kind"] != "recompile"]
        assert a.lowering == "per_slot"
        assert [w["kind"] for w in warns] == ["use_pallas_declined"]  # once per reason
        assert sig in warns[0]["message"]
    finally:
        t_tune.reset()
        t_tune.reset_emitted()


def test_harness_warnings_match_jax(data, jdata, tmp_path, monkeypatch):
    """The OOM bisection's cohort_dispatch/cohort_split/cohort_fallback and a
    quarantined row's divergence: the same kinds and messages as JAX's."""
    labels = {"approx": _kw(compute_mode="deduped"),
              "naive": _kw(scheme="naive", num_collect=None, compute_mode="deduped",
                           lr_schedule=1e30)}
    t = {k: t_config.RunConfig(**v) for k, v in labels.items()}
    j = {k: j_config.RunConfig(**v) for k, v in labels.items()}
    init = {k: _jax_init(c) for k, c in j.items()}
    t_real, j_real = t_trainer.train_cohort, j_trainer.train_cohort

    def t_oom(cfgs, *a, **k):
        if len(cfgs) > 1:
            raise torch.cuda.OutOfMemoryError("RESOURCE_EXHAUSTED: injected")
        return t_real(cfgs, *a, **k)

    def j_oom(cfgs, *a, **k):
        if len(cfgs) > 1:
            raise j_chaos.ChaosInjection("RESOURCE_EXHAUSTED: injected")
        return j_real(cfgs, *a, **k)

    monkeypatch.setattr(t_trainer, "train_cohort", t_oom)
    monkeypatch.setattr(j_trainer, "train_cohort", j_oom)
    paths = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    with t_events.capture(paths[0]):
        got = t_exp.compare(t, data, batch="on", device="cpu", init_params=init)
    with j_events.capture(paths[1]):
        want = j_exp.compare(j, jdata, batch="on")
    assert [s.status for s in got] == [s.status for s in want]
    warns = [[(r["kind"], r["message"]) for r in _records(p) if r["type"] == "warning"
              and r["kind"] != "recompile"] for p in paths]
    assert warns[0] == warns[1]
    assert {k for k, _ in warns[0]} == {"cohort_dispatch", "cohort_split", "divergence"}


# ---------------------------------------------------------------------------
# the determinism audit


def _audit_cfg(**kw):
    return t_config.RunConfig(**_kw(rounds=5, **kw))


def test_audit_replays_bitwise(data):
    res = t_audit.audit(_audit_cfg(), data, device="cpu")
    assert set(res) == {"schedule", "training"} and all(res.values())
    assert res["training"].max_abs_diff == 0.0


def test_audit_detects_divergence():
    r = t_audit._compare(np.zeros(4), np.array([0.0, 0.0, 1e-3, 0.0]), "x")
    assert not r and r.max_abs_diff == 1e-3
    r = t_audit._compare(np.zeros(3), np.zeros(4), "y")
    assert not r and "shape" in r.what


def test_audit_training_notices_a_reduction_that_varies(data, monkeypatch):
    """A run whose history differs between two replays is reported."""
    real = t_trainer.train
    calls = []

    def jitter(cfg, ds, **kw):
        res = real(cfg, ds, **kw)
        calls.append(1)
        if len(calls) == 2:
            res.params_history[-1, 0] += 1e-6
        return res

    monkeypatch.setattr(t_trainer, "train", jitter)
    res = t_audit.audit_training_determinism(_audit_cfg(), data, device="cpu")
    assert not res and res.max_abs_diff > 0


def test_audit_covers_deadline_and_heterogeneous_schemes(monkeypatch):
    cfg = t_config.RunConfig(scheme="deadline", deadline=1.0, n_workers=4, n_stragglers=0,
                             rounds=5, n_rows=64, n_cols=8, lr_schedule=1.0, add_delay=True)
    assert t_audit.audit_schedule_determinism(cfg)
    cfg = _audit_cfg(compute_time=2.0, worker_speed_spread=0.5)
    expected = t_straggler.model_from_config(cfg)
    seen = []
    real = t_straggler.arrival_schedule

    def spy(*args, **kw):
        seen.append(kw.get("arrival_model"))
        return real(*args, **kw)

    monkeypatch.setattr(t_straggler, "arrival_schedule", spy)
    assert t_audit.audit_schedule_determinism(cfg)
    assert len(seen) == 2
    for model in seen:
        np.testing.assert_array_equal(model.worker_speed, expected.worker_speed)
    # the schedule it audits is JAX's
    jcfg = j_config.RunConfig(**_kw(rounds=5, compute_time=2.0, worker_speed_spread=0.5))
    jm = j_straggler.model_from_config(jcfg)
    np.testing.assert_array_equal(jm.worker_speed, expected.worker_speed)


def test_audit_needs_a_card_by_default(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        t_audit.audit(_audit_cfg(), data)


# ---------------------------------------------------------------------------
# the CLI


@pytest.mark.parametrize("flag,out_dir,env", [
    (None, False, None), (None, True, None), ("on", False, None), ("off", True, "on"),
    ("auto", True, None), ("auto", False, "on"), (None, False, "on"), (None, True, "auto"),
    (None, False, "auto"), (None, False, "0"), (None, False, "YES"), (None, False, ""),
    ("maybe", False, None), (None, False, "sometimes"),
])
def test_resolve_telemetry_is_jax(flag, out_dir, env):
    def call(fn):
        try:
            return fn(flag, out_dir, env=env)
        except ValueError as e:
            return str(e)

    assert call(t_config.resolve_telemetry) == call(j_config.resolve_telemetry)
    assert t_config.TELEMETRY_ENV == j_config.TELEMETRY_ENV


CLI_ARGS = ["--scheme", "approx", "--workers", str(W), "--stragglers", "1", "--num-collect",
            "5", "--rounds", str(ROUNDS), "--rows", str(ROWS), "--cols", str(COLS),
            "--add-delay", "--device", "cpu", "--quiet"]


def _artifacts(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))
            if f.endswith(".dat")}


def test_cli_telemetry_auto_and_trace(tmp_path, monkeypatch):
    plain = str(tmp_path / "plain")
    t_cli.main(CLI_ARGS + ["--output-dir", plain, "--telemetry", "off"])
    assert not os.path.exists(os.path.join(plain, "events.jsonl"))
    out, trace = str(tmp_path / "out"), str(tmp_path / "trace")
    _, _, paths = t_cli.run(t_cli._flags_to_config(t_cli._flags_parser().parse_args(CLI_ARGS)),
                            output_dir=out, quiet=True, device="cpu", telemetry="auto",
                            trace_dir=trace)
    events = os.path.join(out, "events.jsonl")
    assert paths["events"] == events
    assert t_events.validate_file(events) == [] == j_events.validate_file(events)
    kinds = [r["type"] for r in _records(events) if r.get("run_id")]
    assert kinds == ["run_start", "data_upload", "compile", "rounds", "decode", "run_end",
                     "critical_path", "eval"]
    assert _artifacts(out) == _artifacts(plain)
    (tfile,) = os.listdir(trace)
    assert tfile.endswith(".pt.trace.json")
    names = [e.get("name") for e in json.load(open(os.path.join(trace, tfile)))["traceEvents"]]
    assert names.count("eh_scan/coded_step") == names.count("eh_scan/update") == ROUNDS
    # the env var turns it on without the flag
    monkeypatch.setenv(t_config.TELEMETRY_ENV, "on")
    env_out = str(tmp_path / "env")
    t_cli.main(CLI_ARGS + ["--output-dir", env_out])
    assert os.path.exists(os.path.join(env_out, "events.jsonl"))


def test_cli_prints_the_events_path(tmp_path, capsys):
    out = str(tmp_path / "out")
    t_cli.main([a for a in CLI_ARGS if a != "--quiet"] + ["--output-dir", out,
                                                          "--telemetry", "on"])
    assert f"events -> {os.path.join(out, 'events.jsonl')}" in capsys.readouterr().out


def test_cli_elastic_journals_with_telemetry(tmp_path):
    out = str(tmp_path / "out")
    t_cli.main(CLI_ARGS + ["--output-dir", out, "--telemetry", "on", "--elastic", "on",
                           "--elastic-chunk", "4"])
    journals = [f for f in os.listdir(out) if f.endswith(".jsonl") and f != "events.jsonl"]
    assert journals
    for f in journals + ["events.jsonl"]:
        assert t_events.validate_file(os.path.join(out, f)) == []
    recs = _records(os.path.join(out, "events.jsonl"))
    assert sum(r["type"] == "run_start" for r in recs) == ROUNDS // 4


def test_stale_decode_split_is_a_tool_record(data, tmp_path):
    cfg = t_config.RunConfig(**_kw(update_rule="GD", pipeline_depth=1))
    path = str(tmp_path / "e.jsonl")
    from erasurehead_tpu_torch.obs import decode as t_decode

    with t_events.capture(path):
        res = t_trainer.train(cfg, data, device="cpu")
        payload = t_decode.emit_staleness_split(res.run_id, res, data)
    assert 0.0 < payload["staleness_share"] < 1.0
    recs = [r for r in _records(path) if r["type"] == "stale_decode"]
    assert len(recs) == 1 and recs[0]["n_rounds"] == ROUNDS
    assert t_events.validate_file(path) == []
    sync = t_trainer.train(dataclasses.replace(cfg, pipeline_depth=0), data, device="cpu")
    assert t_decode.emit_staleness_split(None, sync, data)["staleness_share"] == 0.0


def test_no_listener_means_no_run_id(data):
    assert not t_events.active()
    res = t_trainer.train(t_config.RunConfig(**_kw(rounds=2)), data, device="cpu")
    assert res.run_id is None


@pytest.mark.parametrize("stack_dtype", ["float32", "int8"])
def test_store_io_records_match_jax(data, jdata, tmp_path, stack_dtype):
    """A store write and a window read are ``io`` records with JAX's kinds,
    byte counts and ranges."""
    recs = {}
    for name, store_lib, ds in (("t", t_store, data), ("j", j_store, jdata)):
        path = str(tmp_path / f"{name}.jsonl")
        with (t_events if name == "t" else j_events).capture(path):
            st = store_lib.write_store(ds, str(tmp_path / name), W, stack_dtype=stack_dtype,
                                       group=3)
            st.read_ranges([(6, 8), (0, 1)])
        recs[name] = [{k: v for k, v in r.items() if k not in ("t", "path")}
                      for r in _records(path) if r["type"] == "io"]
    assert recs["t"] == recs["j"]
    assert [r["kind"] for r in recs["t"]] == ["store_write", "shard_read"]
