"""The port's arrival models against the JAX package, byte for byte.

Regime shifts, recorded-trace replay and the heterogeneous-cluster model
are host float64 numpy on both sides, with the same MT19937 / PCG64 draws,
so every arrival matrix must be identical bytes. The oracle is JAX's
functions called directly (``straggler.*``, ``chaos.parse_regime``,
``trainer.default_arrivals``), not its regime-shift training tests.
"""

import dataclasses

import numpy as np
import pytest

from erasurehead_tpu import cli as j_cli
from erasurehead_tpu.parallel import straggler as j_straggler
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.utils import chaos as j_chaos
from erasurehead_tpu.utils import config as j_config
from erasurehead_tpu_torch import cli as t_cli
from erasurehead_tpu_torch.data.synthetic import generate_gmm
from erasurehead_tpu_torch.parallel import straggler as t_straggler
from erasurehead_tpu_torch.train import experiments as t_experiments
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils import chaos as t_chaos
from erasurehead_tpu_torch.utils import config as t_config

W, S, ROUNDS, SEED = 6, 1, 13, 4
TRACE_ROUNDS = 5
REGIMES = (None, "heavytail:3:1.5", "adversary:2:1:4.0", "targeted:4:1:2.5")
TRACES = (None, "npy", "npz", "npz_first", "csv", "txt", "one_round")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """One recorded [5, W] trace in every format the loader reads, plus a
    single-round (1-D) trace."""
    root = tmp_path_factory.mktemp("traces")
    arr = np.random.default_rng(11).exponential(0.7, (TRACE_ROUNDS, W))
    paths = {
        "npy": root / "t.npy", "npz": root / "t.npz", "npz_first": root / "first.npz",
        "csv": root / "t.csv", "txt": root / "t.txt", "one_round": root / "one.npy",
    }
    np.save(paths["npy"], arr)
    np.savez(paths["npz"], other=arr[::-1], arrivals=arr)
    np.savez(paths["npz_first"], arr)
    np.savetxt(paths["csv"], arr, delimiter=",")
    np.savetxt(paths["txt"], arr)
    np.save(paths["one_round"], arr[2])
    return {k: str(v) for k, v in paths.items()}


def _cfg_pair(**kw):
    base = dict(
        scheme="repcoded", n_workers=W, n_stragglers=S, rounds=ROUNDS, seed=SEED,
        add_delay=True,
    )
    base.update(kw)
    return j_config.RunConfig(**base), t_config.RunConfig(**base)


# ---------------------------------------------------------------------------
# straggler.*: the whole grid


@pytest.mark.parametrize("compute_time", [0.0, 0.1])
@pytest.mark.parametrize("spread", [0.0, 0.3])
@pytest.mark.parametrize("trace", TRACES)
@pytest.mark.parametrize("add_delay", [True, False])
@pytest.mark.parametrize("regime", REGIMES)
def test_arrival_schedule_bytes(traces, regime, add_delay, trace, spread, compute_time):
    jcfg, tcfg = _cfg_pair(compute_time=compute_time, worker_speed_spread=spread)
    j_model, t_model = j_straggler.model_from_config(jcfg), t_straggler.model_from_config(tcfg)
    assert (j_model is None) == (t_model is None)
    if t_model is not None:
        assert t_model.compute_time == j_model.compute_time
        if j_model.worker_speed is None:
            assert t_model.worker_speed is None
        else:
            _same(t_model.worker_speed, j_model.worker_speed)
    path = traces[trace] if trace else None
    speed = None
    if path and spread:
        speed = np.random.default_rng(SEED + 10_007).uniform(1 - spread, 1 + spread, W)
    j_reg = j_chaos.parse_regime(regime) if regime else None
    t_reg = t_chaos.parse_regime(regime) if regime else None
    j_workers = t_workers = None
    if regime and regime.startswith("targeted"):
        j_workers = j_straggler.targeted_workers(j_trainer.build_layout(jcfg), j_reg.group)
        t_workers = t_straggler.targeted_workers(t_trainer.build_layout(tcfg), t_reg.group)
        assert t_workers == j_workers
    args = (ROUNDS, W, add_delay, 0.5)
    want = j_straggler.arrival_schedule(
        *args, arrival_model=j_model, regime=j_reg, trace=path, trace_speed=speed,
        regime_workers=j_workers,
    )
    got = t_straggler.arrival_schedule(
        *args, arrival_model=t_model, regime=t_reg, trace=path, trace_speed=speed,
        regime_workers=t_workers,
    )
    _same(got, want)


@pytest.mark.parametrize("trace", [t for t in TRACES if t])
def test_load_and_replay_trace_bytes(traces, trace):
    _same(t_straggler.load_arrival_trace(traces[trace]),
          j_straggler.load_arrival_trace(traces[trace]))
    speed = np.linspace(0.5, 1.5, W)
    for rounds, sp in ((3, None), (12, speed), (1, speed)):
        _same(t_straggler.replay_arrival_trace(traces[trace], rounds, W, sp),
              j_straggler.replay_arrival_trace(traces[trace], rounds, W, sp))
    arr = np.load(traces["npy"])
    _same(t_straggler.load_arrival_trace(arr), j_straggler.load_arrival_trace(arr))


@pytest.mark.parametrize("kind,kw", [
    ("heavytail", dict(round=0, alpha=0.7)),
    ("heavytail", dict(round=ROUNDS + 3)),
    ("adversary", dict(round=5, worker=W + 2, slowdown=0.0)),
    ("targeted", dict(round=1, group=3)),
])
def test_apply_regime_shift_bytes(kind, kw):
    delays = j_straggler.reference_delay_schedule(ROUNDS, W, 0.5)
    workers = (1, W + 4) if kind == "targeted" else None
    _same(
        t_straggler.apply_regime_shift(delays, t_straggler.RegimeShift(kind=kind, **kw), 0.9,
                                       workers),
        j_straggler.apply_regime_shift(delays, j_straggler.RegimeShift(kind=kind, **kw), 0.9,
                                       workers),
    )


@pytest.mark.parametrize("scheme,extra", [
    ("repcoded", {}), ("approx", {"num_collect": 4}), ("cyccoded", {}),
    ("partialrepcoded", {"partitions_per_worker": 3}), ("sparsegraph", {"num_collect": 4}),
])
@pytest.mark.parametrize("group", [0, 1, 5, 17])
def test_targeted_workers_match(scheme, extra, group):
    jcfg, tcfg = _cfg_pair(scheme=scheme, **extra)
    assert t_straggler.targeted_workers(t_trainer.build_layout(tcfg), group) == \
        j_straggler.targeted_workers(j_trainer.build_layout(jcfg), group)


# ---------------------------------------------------------------------------
# refusals carry JAX's messages


def _same_error(t_call, j_call, exc=ValueError):
    with pytest.raises(exc) as want:
        j_call()
    with pytest.raises(exc) as got:
        t_call()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(kind="burst", round=1), dict(kind="heavytail", round=-1),
    dict(kind="heavytail", round=2, alpha=0.0), dict(kind="adversary", round=2, slowdown=-1.0),
    dict(kind="targeted", round=2, slowdown=-0.5), dict(kind="targeted", round=2, group=-1),
])
def test_regime_shift_refusals(kw):
    _same_error(lambda: t_straggler.RegimeShift(**kw), lambda: j_straggler.RegimeShift(**kw))


def test_targeted_shift_needs_its_workers():
    d = np.zeros((3, W))
    _same_error(
        lambda: t_straggler.apply_regime_shift(d, t_straggler.RegimeShift("targeted", 1)),
        lambda: j_straggler.apply_regime_shift(d, j_straggler.RegimeShift("targeted", 1)),
    )


@pytest.mark.parametrize("bad", ["workers", "negative", "empty", "three_d", "speed", "speed_shape"])
def test_trace_refusals(traces, bad):
    arr = np.load(traces["npy"])
    args, kw = (arr, 4, W), {}
    if bad == "workers":
        args = (traces["csv"], 4, W + 1)
    elif bad == "negative":
        args = (arr - 1.0, 4, W)
    elif bad == "empty":
        args = (np.zeros((0, W)), 4, W)
    elif bad == "three_d":
        args = (arr[None], 4, W)
    elif bad == "speed":
        kw = dict(speed=-np.ones(W))
    else:
        kw = dict(speed=np.ones(W + 1))
    _same_error(lambda: t_straggler.replay_arrival_trace(*args, **kw),
                lambda: j_straggler.replay_arrival_trace(*args, **kw))


# ---------------------------------------------------------------------------
# the env-armed regime and the trace resolver


PARSE_OK = ["heavytail:50", "heavytail:0:0.8", "adversary:7", "adversary:3:2",
            "adversary:3:2:1.5", "targeted:9", "targeted:9:4", "targeted:9:4:0.25"]
PARSE_BAD = ["heavytail", "heavytail:x", "wave:3", "heavytail:-1", "heavytail:3:0",
             "targeted:3:-1", "adversary:2:0:-3"]


@pytest.mark.parametrize("spec", PARSE_OK)
def test_parse_regime_matches(spec):
    got, want = t_chaos.parse_regime(spec), j_chaos.parse_regime(spec)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("spec", PARSE_BAD)
def test_parse_regime_refusals(spec):
    _same_error(lambda: t_chaos.parse_regime(spec), lambda: j_chaos.parse_regime(spec))


def test_active_regime_reads_the_environment(monkeypatch):
    assert t_chaos.REGIME_ENV == j_chaos.REGIME_ENV
    monkeypatch.delenv(t_chaos.REGIME_ENV, raising=False)
    assert t_chaos.active_regime() is None
    monkeypatch.setenv(t_chaos.REGIME_ENV, "adversary:4:2:3.0")
    assert dataclasses.asdict(t_chaos.active_regime()) == \
        dataclasses.asdict(j_chaos.active_regime())


@pytest.mark.parametrize("flag,env", [(None, None), ("a.npy", None), (None, "b.csv"),
                                      ("a.npy", "b.csv"), ("", "b.csv"), (None, "")])
def test_resolve_arrival_trace_matches(flag, env):
    assert t_config.ARRIVAL_TRACE_ENV == j_config.ARRIVAL_TRACE_ENV
    assert t_config.resolve_arrival_trace(flag, env) == j_config.resolve_arrival_trace(flag, env)


@pytest.mark.parametrize("spread", [0.0, 0.25])
@pytest.mark.parametrize("trace", [None, "npy", "cfg_env"])
@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("scheme,extra", [
    ("repcoded", {}), ("approx", {"num_collect": 4}), ("cyccoded", {}),
])
def test_default_arrivals_match(monkeypatch, traces, scheme, extra, regime, trace, spread):
    if regime:
        monkeypatch.setenv(t_chaos.REGIME_ENV, regime)
    else:
        monkeypatch.delenv(t_chaos.REGIME_ENV, raising=False)
    monkeypatch.delenv(t_config.ARRIVAL_TRACE_ENV, raising=False)
    kw = dict(scheme=scheme, worker_speed_spread=spread, compute_time=0.05, **extra)
    if trace == "npy":
        kw["arrival_trace"] = traces["npy"]
    elif trace == "cfg_env":
        monkeypatch.setenv(t_config.ARRIVAL_TRACE_ENV, traces["csv"])
    jcfg, tcfg = _cfg_pair(**kw)
    _same(t_trainer.default_arrivals(tcfg), j_trainer.default_arrivals(jcfg))


def test_targeted_regime_reaches_a_training_run(monkeypatch):
    """A targeted attack on repcoded: the run's simulated clocks are JAX's
    schedule's, and they differ from the stationary run's."""
    monkeypatch.setenv(t_chaos.REGIME_ENV, "targeted:2:1:5.0")
    jcfg, tcfg = _cfg_pair(rounds=4, n_rows=96, n_cols=8)
    data = generate_gmm(96, 8, W, 0)
    res = t_trainer.train(tcfg, data, device="cpu")
    arr = j_trainer.default_arrivals(jcfg)
    sched = t_trainer.build_schedule(tcfg, arr, t_trainer.build_layout(tcfg))
    _same(res.timeset, sched.sim_time)
    _same(res.worker_times, sched.worker_times)
    monkeypatch.delenv(t_chaos.REGIME_ENV)
    calm = t_trainer.train(tcfg, data, device="cpu")
    assert (res.timeset[2:] > calm.timeset[2:]).all()
    _same(res.timeset[:2], calm.timeset[:2])


# ---------------------------------------------------------------------------
# the CLI and the harness


def _parse_both(argv):
    t = t_cli._flags_to_config(t_cli._flags_parser().parse_args(argv))
    j = j_cli._flags_to_config(j_cli._flags_parser().parse_args(argv))
    return t, j


@pytest.mark.parametrize("argv", [
    [],
    ["--compute-time", "0.2"],
    ["--worker-speed-spread", "0.3", "--compute-time", "0.05"],
    ["--arrival-trace", "trace.npy", "--worker-speed-spread", "0.1"],
])
def test_cli_flags_reach_run_config(argv):
    t, j = _parse_both(["--workers", str(W), "--stragglers", "1"] + argv)
    for field in ("compute_time", "worker_speed_spread", "arrival_trace"):
        assert getattr(t, field) == getattr(j, field), field
    defaults = {a.dest: a.default for a in t_cli._flags_parser()._actions}
    jdefaults = {a.dest: a.default for a in j_cli._flags_parser()._actions}
    for dest in ("compute_time", "worker_speed_spread", "arrival_trace"):
        assert defaults[dest] == jdefaults[dest]


@pytest.mark.parametrize("via", ["config", "env"])
def test_compare_replays_one_shared_trace(monkeypatch, traces, via):
    """compare() with no arrivals: the recorded trace of the set's first
    config (or the env var) is the one schedule every row shares, the
    JAX branch's bytes."""
    monkeypatch.delenv(t_chaos.REGIME_ENV, raising=False)
    monkeypatch.delenv(t_config.ARRIVAL_TRACE_ENV, raising=False)
    path = traces["txt"]
    common = dict(n_workers=W, n_stragglers=S, rounds=4, n_rows=96, n_cols=8,
                  compute_mode="deduped", lr_schedule=0.5)
    if via == "config":
        common["arrival_trace"] = path
    else:
        monkeypatch.setenv(t_config.ARRIVAL_TRACE_ENV, path)
    configs = {
        "approx": t_config.RunConfig(scheme="approx", num_collect=4, **common),
        "naive": t_config.RunConfig(scheme="naive", **common),
    }
    data = generate_gmm(96, 8, W, 0)
    rows = t_experiments.compare(configs, data, batch="off", device="cpu")
    arr = j_straggler.arrival_schedule(4, W, add_delay=True, mean=0.5, trace=path)
    for row in rows:
        cfg = configs[row.label]
        sched = t_trainer.build_schedule(cfg, arr, t_trainer.build_layout(cfg))
        _same(row.timeset, sched.sim_time)
