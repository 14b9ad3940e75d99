"""The port's arrival-regime estimator (obs/regime.py) and its ``regime``
records against the JAX package's.

Both are host float64 numpy over the same rows, so every estimate, every
change-point and every emitted record must be equal, not merely close:
the Hill index on exponential, Pareto and degenerate samples; the
estimator's per-round estimates and ``poll_shift`` over reference arrival
streams with an adversary shift, a heavy-tail shift and the -1 sentinel;
and the ``regime`` records the validator accepts and rejects.
"""

import dataclasses
import json

import numpy as np
import pytest

from erasurehead_tpu.obs import events as j_events
from erasurehead_tpu.obs import regime as j_regime
from erasurehead_tpu.parallel import straggler as j_straggler
from erasurehead_tpu_torch.obs import events as t_events
from erasurehead_tpu_torch.obs import regime as t_regime

W, R = 8, 60


def _samples(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "exp":
        return rng.exponential(0.5, n)
    if kind == "pareto":
        return rng.pareto(1.2, n) + 1.0
    if kind == "masked":
        x = rng.exponential(0.5, n)
        x[::3] = -1.0
        x[1::7] = np.inf
        return x
    return np.full(n, 0.25)  # degenerate: every sample the threshold


@pytest.mark.parametrize("kind", ["exp", "pareto", "masked", "constant"])
@pytest.mark.parametrize("n", [3, 5, 40, 400])
@pytest.mark.parametrize("top_frac", [0.1, 0.3])
def test_hill_index_matches_jax(kind, n, top_frac):
    x = _samples(kind, n, seed=n)
    got, want = t_regime.hill_index(x, top_frac), j_regime.hill_index(x, top_frac)
    assert got == want


def _stream(kind):
    """[R, W] reference arrival rows: stationary, an adversary from round
    30, a heavy tail from round 30, or never-collected -1 columns."""
    if kind == "adversary":
        shift = j_straggler.RegimeShift(kind="adversary", round=30, worker=0, slowdown=20.0)
        return j_straggler.arrival_schedule(R, W, add_delay=True, regime=shift)
    if kind == "heavytail":
        shift = j_straggler.RegimeShift(kind="heavytail", round=30, alpha=1.1)
        return j_straggler.arrival_schedule(R, W, add_delay=True, regime=shift)
    arr = j_straggler.arrival_schedule(R, W, add_delay=True)
    if kind == "sentinel":
        arr = arr.copy()
        arr[20:, :5] = -1.0  # most of the cluster goes silent
    return arr


ESTIMATOR_KW = [
    {},
    dict(window_rounds=8, detect_rounds=2, min_samples=4, shift_factor=2.0),
    dict(window_rounds=16, emit_every=5, heavy_tail_below=3.0, top_frac=0.2),
]


@pytest.mark.parametrize("kind", ["stationary", "adversary", "heavytail", "sentinel"])
@pytest.mark.parametrize("kw", range(len(ESTIMATOR_KW)))
def test_estimator_matches_jax(kind, kw, tmp_path):
    arr = _stream(kind)
    kwargs = ESTIMATOR_KW[kw]
    est_t = t_regime.ArrivalRegimeEstimator(**kwargs, run_id="r")
    est_j = j_regime.ArrivalRegimeEstimator(**kwargs, run_id="r")
    t_path, j_path = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    polls = []
    with t_events.capture(t_path), j_events.capture(j_path):
        for lo in range(0, R, 10):  # chunks, as adapt/driver.py feeds it
            got = est_t.update_rounds(lo, arr[lo:lo + 10])
            want = est_j.update_rounds(lo, arr[lo:lo + 10])
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.payload() == want.payload()
            polls.append((est_t.poll_shift(), est_j.poll_shift()))
        assert est_t.estimate() == t_regime.RegimeEstimate(**dataclasses.asdict(est_j.estimate()))
    assert all(a == b for a, b in polls)
    t_recs = [json.loads(line) for line in open(t_path) if json.loads(line)["type"] == "regime"]
    j_recs = [json.loads(line) for line in open(j_path) if json.loads(line)["type"] == "regime"]
    drop = ("seq", "t")
    assert [{k: v for k, v in r.items() if k not in drop} for r in t_recs] == \
        [{k: v for k, v in r.items() if k not in drop} for r in j_recs]
    assert t_events.validate_file(t_path) == []
    if kind == "adversary":
        assert any(p[0] for p in polls), "the shift never fired"
        assert any(r["shifted"] for r in t_recs)


def test_estimator_per_round_update_matches_jax():
    arr = _stream("adversary")
    est_t, est_j = t_regime.ArrivalRegimeEstimator(), j_regime.ArrivalRegimeEstimator()
    for r in range(R):
        got, want = est_t.update(r, arr[r]), est_j.update(r, arr[r])
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert est_t.poll_shift() == est_j.poll_shift()


@pytest.mark.parametrize("kw", [dict(window_rounds=0), dict(detect_rounds=0),
                                dict(shift_factor=1.0)])
def test_estimator_refusals_match_jax(kw):
    with pytest.raises(ValueError) as got:
        t_regime.ArrivalRegimeEstimator(**kw)
    with pytest.raises(ValueError) as want:
        j_regime.ArrivalRegimeEstimator(**kw)
    assert str(got.value) == str(want.value)


def _rec(seq, **kw):
    return json.dumps({"type": "regime", "seq": seq, "t": 0.0, **kw})


REGIME_LINES = [
    _rec(0, round=0, kind="exp", rate=2.0, n=16, shifted=False),  # valid
    _rec(1, round=3, kind="lognormal", rate=2.0, n=16, shifted=False),
    _rec(2, round=4, kind="heavytail", rate=-1.0, n=16, shifted=True),
    _rec(3, round=-1, kind="unknown", rate=0.0, n=0, shifted=False),
    _rec(4, round=5, kind="exp", rate=1.0, n=1.5, shifted=False),
    _rec(5, round=6, kind="exp", rate=1.0, n=3, shifted="yes"),
    _rec(6, round=7, kind="exp", rate=1.0, n=3),  # missing shifted
]


def test_regime_records_validate_as_jax():
    got, want = t_events.validate_lines(REGIME_LINES), j_events.validate_lines(REGIME_LINES)
    assert got == want
    assert len(got) == 7  # the missing field also fails the bool check
    assert t_events.validate_lines(REGIME_LINES[:1]) == []


def test_emit_without_capture_is_a_no_op(tmp_path):
    assert t_events.current() is None
    assert t_events.emit("regime", round=0, kind="exp", rate=1.0, n=1, shifted=False) is False
    path = str(tmp_path / "e.jsonl")
    with t_events.capture(path) as log:
        assert t_events.current() is log
        with t_events.capture(str(tmp_path / "inner.jsonl")) as inner:
            assert t_events.current() is inner  # the inner capture wins
        assert t_events.current() is log
        assert t_events.emit("regime", round=0, kind="exp", rate=1.0, n=1, shifted=False)
        with pytest.raises(ValueError, match="missing required"):
            t_events.emit("regime", round=0)
    assert t_events.current() is None
    # the closing record of a capture snapshots the metrics registry
    assert [json.loads(line)["type"] for line in open(path)] == ["regime", "metrics"]
    a, b = t_events.new_run_id(), t_events.new_run_id()
    assert a != b and a.startswith("run-")
