"""The port's telemetry plane (obs/) against the JAX package's, record by
record, on synthetic inputs made from numpy seeds.

Everything here is host Python and float64 numpy on both sides, so it must
be exactly equal: the validator's error strings on a corpus with one good
record of every type and malformed variants of every check; histogram
quantiles and registry exports; the critical-path ledgers on random
schedules (pipelined dispatch/done clocks included); the timeseries
reducer's snapshot and gauges on one record stream; the Prometheus text of
one registry state and gauge map; the SLO tracker's rows; the report's text
on a log that carries every section. Also the port's own: the reducer's
memory bound, tail and attach, the observer plane with no capture, a
deferred block, and ``cli top`` / ``cli report --validate``.
"""

import json
import threading

import numpy as np
import pytest

from erasurehead_tpu.obs import critical_path as j_cpath
from erasurehead_tpu.obs import events as j_events
from erasurehead_tpu.obs import exporter as j_exporter
from erasurehead_tpu.obs import metrics as j_metrics
from erasurehead_tpu.obs import report as j_report
from erasurehead_tpu.obs import timeseries as j_ts
from erasurehead_tpu_torch import cli as t_cli
from erasurehead_tpu_torch.obs import critical_path as t_cpath
from erasurehead_tpu_torch.obs import events as t_events
from erasurehead_tpu_torch.obs import exporter as t_exporter
from erasurehead_tpu_torch.obs import metrics as t_metrics
from erasurehead_tpu_torch.obs import report as t_report
from erasurehead_tpu_torch.obs import timeseries as t_ts

# ---------------------------------------------------------------------------
# a corpus: one good payload of every record type

CP_GOOD = dict(
    run_id="r1", wall_s=2.0, sim_total_s=3.0,
    components={"decode_update_s": 1.5, "prefetch_stall_s": 0.5},
    sim_components={"compute_s": 1.0, "straggler_wait_s": 2.0, "dispatch_gap_s": 0.0},
    fractions={"decode_update": 0.75, "prefetch_stall": 0.25, "compute": 0.333333,
               "straggler_wait": 0.666667, "dispatch_gap": 0.0},
    overlap_hidden_s=0.0, transport="none",
)
GOOD = {
    "run_start": dict(run_id="r1", scheme="approx", platform="cpu", config_hash="abc",
                      mesh=[["workers"], [1], [0]]),
    "compile": dict(run_id="r1", seconds=0.1, cache_hit=False),
    "data_upload": dict(run_id="r1", bytes=100, cache_hit=False),
    "rounds": dict(run_id="r1", first_round=0, n_rounds=5, sim_time_s=1.5,
                   arrival={"p50": 0.1, "p90": 0.2, "p99": 0.3, "mean": 0.15,
                            "n_arrivals": 20, "n_never": 0}),
    "decode": dict(run_id="r1", first_round=0, n_rounds=5, error_mean=0.1,
                   error_max=0.2, exact=False),
    "eval": dict(run_id="r1", final_train_loss=0.5, final_test_loss=0.6),
    "warning": dict(kind="divergence", message="m"),
    "cohort": dict(run_id="r2", n_trajectories=2, schemes=["approx"], seeds=[0, 1],
                   dispatches=1, lowering="cohort_matmul"),
    "run_end": dict(run_id="r1", wall_time_s=2.0, steps_per_sec=2.5,
                    arrival={"p50": 0.1, "p90": 0.2, "p99": 0.3, "n_arrivals": 20,
                             "n_never": 2}, decode_error_mean=0.1),
    "metrics": dict(snapshot={"a": 1}),
    "sweep_trajectory": dict(key="k", label="l", status="ok", row={"final_train_loss": 0.3}),
    "request": dict(tenant="alice", request_id="q1", label="a"),
    "pack": dict(n_trajectories=2, labels=["a", "b"], tenants=["alice"]),
    "admit": dict(est_bytes=10, budget_bytes=None, admitted=False),
    "evict": dict(reason="pressure"),
    "reject": dict(tenant="bob", reason="overloaded", retry_after_s=0.5),
    "stream": dict(tenant="alice", event="overflow", dropped=3),
    "restart": dict(wal_records=3, resubmitted=1, rehydrated=2),
    "adapt": dict(round=0, arm="approx", reason="warmup", decode_error_mean=0.1,
                  sim_per_round=0.2),
    "membership": dict(round=5, action="death", n_workers=6, workers=[1, 2]),
    "whatif": dict(spec_hash="s", kind="point", label="p", feasible=True),
    "prefetch": dict(run_id="r1", window=0, bytes=64, ranges=[[0, 2], [5, 6]], fetch_s=0.01,
                     plan_mode="materialized", halo=1, group_workers=3),
    "io": dict(kind="shard_read", bytes=64),
    "dispatch_ahead": dict(run_id="r1", first_round=0, n_rounds=5, pipeline_depth=1,
                           ahead_mean_s=0.1, ahead_max_s=0.2, overlap_total_s=0.5),
    "stale_decode": dict(run_id="r1", first_round=0, n_rounds=5, staleness_error_mean=0.1,
                         coding_error_mean=0.2, staleness_share=0.333),
    "critical_path": CP_GOOD,
    "regime": dict(round=10, kind="heavytail", rate=2.0, n=30, shifted=True, tail_index=1.4),
    "slo": dict(tenant="alice", slo_s=1.0, window_requests=4, breaches=1, burn_rate=2.5),
    "fleet": dict(action="declare_dead", replica="r0", streak=3, k=3),
    "tune": dict(race="glm_fused", device_kind="cpu", shape="s", choice="pallas",
                 source="default"),
}

# malformed variants, each aimed at one check
BAD = [
    ("cohort", dict(n_trajectories=3, dispatches=0)),
    ("sweep_trajectory", dict(status="lost", row=[1], key="")),
    ("request", dict(tenant="", label=7)),
    ("pack", dict(labels="a", tenants=[])),
    ("pack", dict(n_trajectories=3)),
    ("admit", dict(est_bytes=-1, budget_bytes="x")),
    ("evict", dict(reason="")),
    ("reject", dict(tenant="", reason="nope", retry_after_s=-2)),
    ("stream", dict(tenant=None, event="boom", dropped=-1)),
    ("restart", dict(wal_records=-1, resubmitted=1.5)),
    ("adapt", dict(round=-1, arm="", reason="guess")),
    ("membership", dict(round=-3, action="resurrect", n_workers=0, workers=[1, -2])),
    ("fleet", dict(action="explode", replica="", streak=-1)),
    ("fleet", dict(action="declare_dead", streak=1, k=3)),
    ("whatif", dict(spec_hash="", kind="nope")),
    ("whatif", dict(kind="point", label="", feasible="yes")),
    ("whatif", dict(kind="grid", n_points=-1, n_feasible=1.5)),
    ("prefetch", dict(window=-1, bytes=1.5, ranges=[[3, 1]])),
    ("prefetch", dict(ranges=[], plan_mode="ring2", halo=-1, group_workers="a", fetch_s=-1)),
    ("prefetch", dict(ranges=[[0, 1, 2]])),
    ("io", dict(kind="disk", bytes=-5)),
    ("dispatch_ahead", dict(pipeline_depth=0, ahead_mean_s=-1, overlap_total_s="x")),
    ("stale_decode", dict(staleness_error_mean=-0.1, staleness_share=1.5)),
    ("critical_path", dict(wall_s=2.0, components={"decode_update_s": 1.0})),
    ("critical_path", dict(sim_total_s=-1.0, fractions={"compute": 1.5})),
    ("critical_path", dict(components={"decode_update_s": -1.0}, sim_components=[1])),
    ("regime", dict(kind="weird", rate=-1, round=-1, n=1.5, shifted="no")),
    ("slo", dict(tenant="", slo_s=0, burn_rate=-1, window_requests=2, breaches=5)),
    ("slo", dict(window_requests=-1)),
    ("tune", dict(race="warp", source="guess", device_kind="", shape=3)),
    ("rounds", dict(layer=-1)),
    ("decode", dict(layer="x")),
]


def _line(rtype, seq, **fields):
    return json.dumps({"type": rtype, "seq": seq, "t": 1.0, **fields})


def _corpus() -> list:
    lines = [_line(rtype, i, **fields) for i, (rtype, fields) in enumerate(GOOD.items())]
    seq = len(lines)
    for rtype, over in BAD:
        lines.append(_line(rtype, seq, **{**GOOD[rtype], **over}))
        seq += 1
    for rtype, fields in GOOD.items():  # one missing required key of each type
        req = j_events.SCHEMA[rtype]
        lines.append(_line(rtype, seq, **{k: v for k, v in fields.items() if k != req[0]}))
        seq += 1
    lines += [
        # non-monotone round streams: plain, per trajectory, per layer
        _line("rounds", seq, **GOOD["rounds"]),
        _line("decode", seq + 1, **{**GOOD["decode"], "first_round": 0}),
        _line("rounds", seq + 2, **{**GOOD["rounds"], "trajectory": "0:a:s0"}),
        _line("rounds", seq + 3, **{**GOOD["rounds"], "trajectory": "0:a:s0"}),
        _line("decode", seq + 4, **{**GOOD["decode"], "layer": 1}),
        _line("decode", seq + 5, **{**GOOD["decode"], "layer": 1}),
        # envelope faults
        _line("bogus", seq + 6),
        '{"type": "io", "t": 1.0, "kind": "shard_read", "bytes": 1}',
        _line("io", 999, kind="shard_read", bytes=1),
        "not json at all",
        "[1, 2]",
        "",
        # a run that never ends
        _line("run_start", seq + 7, **{**GOOD["run_start"], "run_id": "dangling"}),
    ]
    return lines


def test_schema_and_constants_are_jax():
    assert t_events.SCHEMA == j_events.SCHEMA and len(t_events.SCHEMA) == 30
    for name in ("ADAPT_REASONS", "REGIME_KINDS", "CRITICAL_PATH_TOL", "MEMBERSHIP_ACTIONS",
                 "STREAM_EVENTS", "STREAM_PLAN_MODES", "REJECT_REASONS", "WHATIF_KINDS",
                 "IO_KINDS", "FLEET_ACTIONS", "TRAJECTORY_STATUSES", "TUNE_RACES",
                 "TUNE_SOURCES", "ROUND_CHUNK"):
        assert getattr(t_events, name) == getattr(j_events, name), name


def test_validator_returns_jax_error_strings():
    lines = _corpus()
    good = lines[: len(GOOD)]
    assert t_events.validate_lines(good) == [] == j_events.validate_lines(good)
    got, want = t_events.validate_lines(lines), j_events.validate_lines(lines)
    assert got == want
    assert len(got) > 2 * len(BAD)
    for needle in ("unknown record type", "not JSON", "not a JSON object", "non-monotonic seq",
                   "not after", "does not reconcile", "prefetch ranges", "without run_end",
                   "missing/invalid seq"):
        assert any(needle in e for e in got), needle


@pytest.mark.parametrize("i", range(len(BAD)))
def test_validator_parity_per_malformed_record(i):
    rtype, over = BAD[i]
    lines = [_line(rtype, 0, **{**GOOD[rtype], **over})]
    got = t_events.validate_lines(lines)
    assert got == j_events.validate_lines(lines) and got


def test_emit_refuses_what_jax_refuses(tmp_path):
    log = t_events.EventLogger(str(tmp_path / "e.jsonl"))
    for rtype, fields in (("bogus", {}), ("run_start", {"run_id": "x"})):
        with pytest.raises(ValueError) as got:
            log.emit(rtype, **fields)
        with pytest.raises(ValueError) as want:
            j_events._checked_payload(rtype, fields)
        assert str(got.value) == str(want.value)
    log.close()


def test_round_chunks_match_jax(tmp_path):
    """emit_round_chunks and emit_layer_decode_chunks on the same arrays
    write the same payloads (the -1 sentinel masked, 100-round chunks)."""
    rng = np.random.default_rng(0)
    R, W = 250, 6
    timeset = rng.exponential(0.5, R)
    wt = rng.exponential(0.5, (R, W))
    wt[rng.random((R, W)) < 0.2] = -1.0
    err = np.where(rng.random(R) < 0.3, 0.0, rng.random(R))
    un = rng.random(R - 1)
    layers = rng.random((R, 3))
    out = {}
    for name, lib in (("t", t_events), ("j", j_events)):
        path = str(tmp_path / f"{name}.jsonl")
        with lib.capture(path):
            lib.emit_round_chunks("r", start_round=20, timeset=timeset, worker_times=wt,
                                  decode_error=err, update_norm=un[19:],
                                  trajectory="0:approx:s0")
            lib.emit_layer_decode_chunks("r", layers, start_round=20)
        out[name] = [{k: v for k, v in json.loads(line).items() if k != "t"}
                     for line in open(path)][:-1]
    assert out["t"] == out["j"] and len(out["t"]) == 3 * 2 + 3 * 3


def test_capture_closes_with_the_metrics_snapshot(tmp_path):
    path = str(tmp_path / "e.jsonl")
    t_metrics.REGISTRY.counter("test.obs.capture").inc(3)
    with t_events.capture(path):
        t_events.emit("warning", kind="k", message="m")
    recs = [json.loads(line) for line in open(path)]
    assert [r["type"] for r in recs] == ["warning", "metrics"]
    assert recs[-1]["snapshot"]["test.obs.capture"] == 3
    assert recs[-1]["snapshot"] == t_metrics.REGISTRY.snapshot()
    assert t_events.validate_file(path) == []


# ---------------------------------------------------------------------------
# the observer plane


def test_observers_see_records_without_a_capture():
    seen = []
    t_events.add_observer(seen.append)
    try:
        assert t_events.current() is None and t_events.active()
        assert t_events.emit("warning", kind="k", message="m") is False
    finally:
        t_events.remove_observer(seen.append)
    t_events.remove_observer(seen.append)  # absent: a no-op
    assert not t_events.active()
    assert [r["type"] for r in seen] == ["warning"] and {"seq", "t"} <= set(seen[0])


def test_a_raising_observer_never_breaks_the_producer(tmp_path, capsys):
    def bad(rec):
        raise RuntimeError("observer fault")

    t_metrics.reset_warnings()
    t_events.add_observer(bad)
    try:
        with t_events.capture(str(tmp_path / "e.jsonl")):
            assert t_events.emit("warning", kind="k", message="m") is True
    finally:
        t_events.remove_observer(bad)
    assert "observer fault" in capsys.readouterr().err


def test_deferred_holds_this_threads_records(tmp_path):
    path = str(tmp_path / "e.jsonl")
    other = []
    with t_events.capture(path):
        with t_events.deferred() as held:
            t_events.emit("io", kind="shard_read", bytes=8)
            thread = threading.Thread(target=lambda: other.append(
                t_events.emit("io", kind="store_write", bytes=4)))
            thread.start()
            thread.join()
            with pytest.raises(ValueError, match="missing required"):
                t_events.emit("io", kind="shard_read")
        assert [r["kind"] for r in map(json.loads, open(path))] == ["store_write"]
        t_events.replay(held)
    kinds = [json.loads(line).get("kind") for line in open(path)]
    assert kinds == ["store_write", "shard_read", None] and other == [True]


# ---------------------------------------------------------------------------
# metrics


def _fill(lib, seed=0):
    reg = lib.MetricsRegistry()
    rng = np.random.default_rng(seed)
    reg.counter("sweep_cache.data_hits").inc(7)
    reg.counter("a.float_counter").inc(2.5)
    reg.gauge("train.steps_per_sec").set(1234.5)
    h = reg.histogram("round.seconds")
    for v in rng.exponential(1.0, 5000):  # past MAX_SAMPLE: the decimation
        h.observe(v)
    reg.histogram("empty.hist")
    reg.histogram("few.hist").observe(3.0)
    return reg


def test_histogram_and_registry_exports_are_jax():
    t, j = _fill(t_metrics), _fill(j_metrics)
    assert t.snapshot() == j.snapshot()
    assert t.export_typed() == j.export_typed()
    th, jh = t.histogram("round.seconds"), j.histogram("round.seconds")
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert th.quantile(q) == jh.quantile(q)
    assert th.mean == jh.mean and th.count == 5000
    assert t.histogram("empty.hist").quantile(0.5) is None
    with pytest.raises(TypeError, match="already registered as Counter"):
        t.gauge("sweep_cache.data_hits")
    t.reset()
    assert t.snapshot()["sweep_cache.data_hits"] == 0


# ---------------------------------------------------------------------------
# critical path


def _schedule(rng, R, W, pipelined):
    timeset = rng.exponential(1.0, R)
    wt = rng.exponential(0.8, (R, W))
    wt[rng.random((R, W)) < 0.15] = -1.0
    collected = (rng.random((R, W)) < 0.6) & (wt >= 0)
    collected[0] = False  # a round with no usable arrival
    kw = {}
    if pipelined:
        done = np.cumsum(timeset)
        kw = dict(dispatch=done - rng.uniform(0.0, 2.0, R), done=done)
    return timeset, wt, collected, kw


@pytest.mark.parametrize("seed,pipelined", [(0, False), (1, True), (2, True), (3, False)])
def test_attribute_equals_jax_exactly(seed, pipelined):
    rng = np.random.default_rng(seed)
    timeset, wt, collected, kw = _schedule(rng, 40, 7, pipelined)
    stall = float(rng.uniform(0, 3))
    got = t_cpath.attribute(timeset, wt, collected, wall_s=2.5, prefetch_stall_s=stall, **kw)
    want = j_cpath.attribute(timeset, wt, collected, wall_s=2.5, prefetch_stall_s=stall, **kw)
    assert got.payload() == want.payload()
    for k in want.per_round:
        assert got.per_round[k].tobytes() == want.per_round[k].tobytes(), k
    assert t_cpath.render_lines(got.payload()) == j_cpath.render_lines(want.payload())
    line = _line("critical_path", 0, run_id="r", **got.payload())
    assert t_events.validate_lines([line]) == [] == j_events.validate_lines([line])


def test_attribute_result_and_from_events(tmp_path):
    class Res:
        timeset = np.array([1.0, 2.0])
        worker_times = np.array([[0.5, -1.0], [1.0, 2.0]])
        collected = np.array([[True, False], [True, True]])
        wall_time = 0.5
        cache_info = {"prefetch": {"blocked_s": 0.125}, "stack_mode": "deduped"}

    got, want = t_cpath.attribute_result(Res), j_cpath.attribute_result(Res)
    assert got.payload() == want.payload()
    assert got.components["prefetch_stall_s"] == 0.125
    path = str(tmp_path / "e.jsonl")
    with t_events.capture(path):
        assert t_cpath.emit_event("r9", got)
    recs = [json.loads(line) for line in open(path)]
    assert list(t_cpath.from_events(recs)) == ["r9"]
    assert t_cpath.from_events(recs) == j_cpath.from_events(recs)


# ---------------------------------------------------------------------------
# timeseries reducer


def _stream(seed=0, n=400):
    rng = np.random.default_rng(seed)
    recs = []
    t = 1000.0
    for i in range(n):
        t += float(rng.exponential(0.3))
        kind = rng.integers(0, 12)
        base = {"seq": i, "t": round(t, 3)}
        if kind == 0:
            recs.append({**base, "type": "rounds", "run_id": "r", "first_round": i,
                         "n_rounds": int(rng.integers(1, 100)),
                         "sim_time_s": float(rng.random()),
                         "arrival": {"p50": float(rng.random()), "p90": 0.5, "p99": None,
                                     "mean": 0.2, "n_arrivals": int(rng.integers(0, 30))}})
        elif kind == 1:
            recs.append({**base, "type": "decode", "run_id": "r", "first_round": i,
                         "n_rounds": 10, "error_mean": float(rng.random()),
                         "error_max": float(rng.random()), "exact": bool(rng.random() < 0.3)})
        elif kind == 2:
            recs.append({**base, "type": "compile", "cache_hit": bool(rng.random() < 0.5)})
        elif kind == 3:
            recs.append({**base, "type": "data_upload", "cache_hit": bool(rng.random() < 0.5)})
        elif kind == 4:
            recs.append({**base, "type": "prefetch", "bytes": int(rng.integers(0, 1 << 20)),
                         "fetch_s": float(rng.random())})
        elif kind == 5:
            recs.append({**base, "type": "stale_decode", "staleness_share": float(rng.random())})
        elif kind == 6:
            tenant = f"ten{int(rng.integers(0, 4))}"
            done = rng.random() < 0.5
            recs.append({**base, "type": "request", "tenant": tenant,
                         "request_id": f"q{i}", "label": "l",
                         **({"phase": "done", "status": "ok"} if done else {})})
        elif kind == 7:
            recs.append({**base, "type": "reject", "tenant": "ten1", "reason": "overloaded"})
        elif kind == 8:
            recs.append({**base, "type": "critical_path", **CP_GOOD})
        elif kind == 9:
            recs.append({**base, "type": "regime", "round": i, "kind": "heavytail",
                         "rate": float(rng.random()), "n": 5, "shifted": False,
                         "tail_index": 1.2})
        elif kind == 10:
            recs.append({**base, "type": "slo", "tenant": f"ten{int(rng.integers(0, 3))}",
                         "slo_s": 1.0, "window_requests": 3, "breaches": 1,
                         "burn_rate": float(rng.random() * 3)})
        else:
            recs.append({**base, "type": "run_end", "run_id": "r", "wall_time_s": 1.0,
                         "steps_per_sec": 3.0})
    return recs


def test_reducer_snapshot_and_gauges_are_jax():
    recs = _stream()
    got, want = t_ts.TimeseriesReducer(window_s=2.0), j_ts.TimeseriesReducer(window_s=2.0)
    for rec in recs:
        got.consume(rec)
        want.consume(rec)
    for line in ("{torn", '"bare"', ""):
        assert got.consume_line(line) == want.consume_line(line)
    assert got.snapshot() == want.snapshot()
    assert got.gauges() == want.gauges()
    assert len(got.snapshot()["windows"]) > 10


def test_reducer_memory_is_bounded():
    red = t_ts.TimeseriesReducer(window_s=1.0, max_windows=3)
    for i in range(10):
        red.consume({"type": "rounds", "t": float(i), "n_rounds": 1, "sim_time_s": 0.1})
    w = red.snapshot()["windows"]
    assert len(w) == 3 and w[0]["t0"] == 7.0
    for i in range(t_ts.MAX_TENANTS + 10):
        red.consume({"type": "request", "t": 9.5, "tenant": f"t{i}", "request_id": str(i)})
    tenants = red.snapshot()["windows"][-1]["tenants"]
    assert len(tenants) == t_ts.MAX_TENANTS + 1 and tenants["..."]["requests"] == 10
    for i in range(t_ts.MAX_TENANTS + 5):
        red.consume({"type": "slo", "t": 9.6, "tenant": f"s{i}", "burn_rate": 1.0})
    assert len(red.snapshot()["slo"]) == t_ts.MAX_TENANTS
    with pytest.raises(ValueError):
        t_ts.TimeseriesReducer(window_s=0)


def test_reducer_tail_and_attach(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    recs = _stream(seed=1, n=50)
    with open(path, "w") as f:
        for rec in recs:
            f.write(json.dumps(rec) + "\n")
        f.write("{partial garbage\n")
        f.write(json.dumps(recs[0]))  # a final line without its newline
    got, want = t_ts.tail_path(path, window_s=3.0), j_ts.tail_path(path, window_s=3.0)
    assert got.snapshot() == want.snapshot()
    assert got.snapshot()["consumed"] == 51 and got.snapshot()["malformed"] == 1
    assert t_ts.tail_path(str(tmp_path / "absent.jsonl")).snapshot()["consumed"] == 0

    red = t_ts.TimeseriesReducer()
    with red.attach():
        t_events.emit("rounds", run_id="x", first_round=0, n_rounds=2, sim_time_s=0.5,
                      arrival={})
    t_events.emit("rounds", run_id="x", first_round=2, n_rounds=2, sim_time_s=0.5, arrival={})
    assert red.snapshot()["consumed"] == 1 and not t_events.active()
    handle = red.attach()
    handle()
    assert not t_events.active()


# ---------------------------------------------------------------------------
# exporter


def _gauges(lib):
    return {
        "plain_gauge": 1.5,
        lib.prom_key("arrival_seconds", quantile="p50"): 0.25,
        lib.prom_key("tenant_requests", tenant='we"ird\\name\nx'): 3.0,
        lib.prom_key("9starts.with-digit"): float("nan"),
        **lib.fleet_gauges({"replicas": {"a": {"alive": True, "pressure": 0.5},
                                         "b": {"alive": False}},
                            "redirects_total": 2, "adoptions_total": 1}),
    }


def test_prometheus_text_is_jax():
    got = t_exporter.render_prometheus(_fill(t_metrics), _gauges(t_exporter))
    want = j_exporter.render_prometheus(_fill(j_metrics), _gauges(j_exporter))
    assert got == want
    assert '# TYPE erasurehead_round_seconds summary' in got
    assert 'tenant="we\\"ird\\\\name\\nx"' in got
    assert t_exporter.render_prometheus() == "\n"
    assert t_exporter.PROM_CONTENT_TYPE == j_exporter.PROM_CONTENT_TYPE


def test_slo_tracker_rows_are_jax(tmp_path):
    rng = np.random.default_rng(3)
    recs = []
    for i in range(60):
        t0 = 100.0 + i
        tenant = f"ten{i % 3}"
        recs.append({"type": "request", "request_id": f"q{i}", "tenant": tenant, "t": t0})
        recs.append({"type": "request", "request_id": f"q{i}", "tenant": tenant,
                     "t": t0 + float(rng.exponential(1.0)), "phase": "done"})
    recs.append({"type": "run_end", "t": 1.0})
    trackers = [lib.SloTracker(1.0, budget=0.2, window_s=30.0, max_open=8)
                for lib in (t_exporter, j_exporter)]
    for tr in trackers:
        for rec in recs:
            tr.observe(rec)
        tr.observe_submit("late", "ten9", t=170.0)
        tr.observe_done("late", t=173.0)
    path = str(tmp_path / "slo.jsonl")
    with t_events.capture(path):
        got = trackers[0].evaluate(now=175.0)
    want = trackers[1].evaluate(now=175.0)
    assert got == want and got and any(r["burn_rate"] > 1 for r in got)
    assert t_events.validate_file(path) == []
    assert sum(json.loads(line)["type"] == "slo" for line in open(path)) == len(got)
    with pytest.raises(ValueError):
        t_exporter.SloTracker(0.0)


def test_load_metrics_json(tmp_path):
    path = str(tmp_path / "e.jsonl")
    with open(path, "w") as f:
        f.write(_line("metrics", 0, snapshot={"x": 1}) + "\n{torn\n\n")
        f.write(_line("metrics", 1, snapshot={"x": 2}) + "\n")
    assert t_exporter.load_metrics_json(path) == j_exporter.load_metrics_json(path) == {"x": 2}


# ---------------------------------------------------------------------------
# report, top


def _report_log(path):
    """A log that carries every report section: runs (a cohort, a pipelined
    run, a streamed run with io), the serve, fleet, slo, tune, adapt,
    membership and regime records, journal rows and warnings."""
    lines, seq = [], 0

    def add(rtype, **fields):
        nonlocal seq
        lines.append(_line(rtype, seq, **fields))
        seq += 1

    for rid, scheme in (("run-1", "approx"), ("run-2", "cyccoded")):
        add("run_start", **{**GOOD["run_start"], "run_id": rid, "scheme": scheme})
        add("data_upload", run_id=rid, bytes=10, cache_hit=rid == "run-2")
        add("compile", run_id=rid, seconds=0.5, cache_hit=False)
        add("rounds", **{**GOOD["rounds"], "run_id": rid})
        add("decode", **{**GOOD["decode"], "run_id": rid})
        add("decode", **{**GOOD["decode"], "run_id": rid, "layer": 0})
        add("prefetch", **{**GOOD["prefetch"], "run_id": rid})
        add("dispatch_ahead", **{**GOOD["dispatch_ahead"], "run_id": rid})
        add("stale_decode", **{**GOOD["stale_decode"], "run_id": rid})
        add("run_end", run_id=rid, wall_time_s=1.0, steps_per_sec=2.0, exec_hits=0,
            exec_misses=1, arrival=GOOD["run_end"]["arrival"])
        add("critical_path", **{**CP_GOOD, "run_id": rid})
        add("regime", **{**GOOD["regime"], "run_id": rid})
        add("warning", kind="use_pallas_declined", message="x", run_id=rid)
    add("cohort", **{**GOOD["cohort"], "run_id": "run-2"})
    for rtype in ("io", "sweep_trajectory", "request", "pack", "admit", "evict", "reject",
                  "stream", "restart", "adapt", "membership", "fleet", "slo", "tune",
                  "regime"):
        add(rtype, **GOOD[rtype])
    add("io", kind="store_write", bytes=1 << 20)
    add("request", tenant="alice", request_id="q1", label="a", phase="done", retry=1)
    add("sweep_trajectory", key="k2", label="l2", status="diverged", row={}, tenant="alice")
    add("sweep_trajectory", key="k3", label="l3", status="diverged", row={})
    add("membership", round=9, action="relayout", n_workers=5, n_workers_before=6)
    add("membership", round=9, action="chunk", n_workers=5, sim_time=1.0, arm="approx")
    add("fleet", action="adopt", replica="r1", records=4, adopter="r2")
    add("fleet", action="route", replica="r1", hop=1)
    add("fleet", action="deploy_phase", replica="r1", phase="drain")
    add("fleet", action="probe", replica="r1")
    add("warning", kind="serve_error", message="boom (tenant 'alice')")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n{torn line\n")


def test_report_text_is_jax_on_every_section(tmp_path):
    path = str(tmp_path / "e.jsonl")
    _report_log(path)
    empty = str(tmp_path / "empty.jsonl")
    open(empty, "w").close()
    for paths in ([path], [path, empty], [empty]):
        assert t_report.render(paths) == j_report.render(paths)
    text = t_report.render([path])
    for needle in ("cohort dispatches", "critical path", "pipelined training", "out-of-core",
                   "arrival regime", "serve (multi-tenant", "slo burn rate", "autotuned",
                   "adaptive controller", "elastic membership", "serve fleet",
                   "sweep journal", "warning(s)"):
        assert needle in text, needle
    assert t_report.load_runs([path]) == j_report.load_runs([path])


def test_report_validate_exit_codes_are_jax(tmp_path, capsys):
    good, bad = str(tmp_path / "good.jsonl"), str(tmp_path / "bad.jsonl")
    with open(good, "w") as f:
        f.write(_line("warning", 0, kind="k", message="m") + "\n")
    with open(bad, "w") as f:
        f.write("\n".join(_corpus()) + "\n")
    for path, code in ((good, 0), (bad, 1)):
        assert t_cli.main(["report", "--validate", path]) == code
        got = capsys.readouterr().out
        assert j_report.main(["--validate", path]) == code
        assert got == capsys.readouterr().out


def test_cli_top_renders_one_frame(tmp_path, capsys):
    path = str(tmp_path / "e.jsonl")
    with open(path, "w") as f:
        for rec in _stream(seed=2, n=80):
            f.write(json.dumps(rec) + "\n")
    assert t_cli.main(["top", path, "--slo-ttlr", "0.5"]) == 0
    got = capsys.readouterr().out
    assert j_exporter.top_main([path, "--slo-ttlr", "0.5"]) == 0
    assert got == capsys.readouterr().out
    assert got.startswith("erasurehead-tpu top") and "critical path:" in got
    assert t_cli.main(["top", str(tmp_path / "absent.jsonl")]) == 1
