"""The port's sweep journal (train/journal.py), its record writer and
validator (obs/events.py) and the chaos faults (utils/chaos.py) against the
JAX package's.

Mirrors tests/test_resilience.py, with JAX's functions called directly:

  - the content digests byte-equal to JAX's, dense and CSR, with the
    strided branch over the full-hash cap;
  - a journaled row round-trips bitwise with its dtypes; a torn last line
    is skipped; the last record of a key wins; threads append whole lines;
  - a sweep interrupted after its second journaled trajectory and resumed
    gives rows bitwise equal to the uninterrupted sweep's under batch
    "off", "auto" and "on"; changed inputs re-run; the ambient journal;
    diverged rows resume as diverged;
  - the validator's verdicts are JAX's;
  - chaos spec parsing and firing with JAX's messages, the refusal of sites
    the port does not instrument, a real kill's exit code, and the
    ``checkpoint`` site inside checkpoint.save.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from erasurehead_tpu.data.synthetic import generate_gmm as j_generate_gmm
from erasurehead_tpu.data.synthetic import generate_onehot as j_generate_onehot
from erasurehead_tpu.obs import events as j_events
from erasurehead_tpu.train import journal as j_journal
from erasurehead_tpu.utils import chaos as j_chaos
from erasurehead_tpu_torch.data.synthetic import generate_gmm, generate_onehot
from erasurehead_tpu_torch.obs import events as t_events
from erasurehead_tpu_torch.obs.metrics import REGISTRY
from erasurehead_tpu_torch.parallel import straggler
from erasurehead_tpu_torch.train import checkpoint as t_checkpoint
from erasurehead_tpu_torch.train import experiments as t_exp
from erasurehead_tpu_torch.train import journal as t_journal
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils import chaos as t_chaos
from erasurehead_tpu_torch.utils.config import (
    RESUME_SWEEP_ENV,
    SWEEP_JOURNAL_ENV,
    RunConfig,
    resolve_resume_sweep,
    resolve_sweep_journal,
)

W, R = 4, 6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def gmm():
    return generate_gmm(64, 8, n_partitions=W, seed=0)


def _base(**kw):
    # deduped: the partition-major stack is scheme-independent, so all four
    # schemes form one cohort under batch "auto"/"on"
    d = dict(
        scheme="naive", n_workers=W, n_stragglers=1, rounds=R,
        n_rows=64, n_cols=8, update_rule="AGD", lr_schedule=1.0,
        add_delay=True, seed=0, compute_mode="deduped",
    )
    d.update(kw)
    return RunConfig(**d)


def _configs():
    return {
        "naive": _base(),
        "avoid_s1": _base(scheme="avoidstragg"),
        "agc": _base(scheme="approx", num_collect=3),
        "cyc": _base(scheme="cyccoded"),
    }


@pytest.fixture(autouse=True)
def _chaos_clean(monkeypatch):
    for mod in (t_chaos, j_chaos):
        monkeypatch.delenv(mod.CHAOS_ENV, raising=False)
        mod.reset()
    yield
    t_chaos.reset()
    j_chaos.reset()


def _counter(name):
    return REGISTRY.counter(name).value


def _science(rows):
    return [t_journal.science_row(s.row()) for s in rows]


# ---------------------------------------------------------------------------
# digests


@pytest.mark.parametrize("cap", [None, 256])
@pytest.mark.parametrize("kind", ["dense", "csr"])
def test_dataset_digest_is_jax(monkeypatch, kind, cap):
    """Same bytes, same digest; ``cap`` lowers the full-hash cap on both
    sides so the strided-sample branch (with its float64 checksum) runs."""
    if cap is not None:
        monkeypatch.setattr(t_journal, "_FULL_HASH_MAX_BYTES", cap)
        monkeypatch.setattr(j_journal, "_FULL_HASH_MAX_BYTES", cap)
    if kind == "dense":
        t_ds, j_ds = generate_gmm(96, 8, 4, seed=1), j_generate_gmm(96, 8, 4, seed=1)
    else:
        t_ds = generate_onehot(96, 40, 4, n_fields=5, seed=1)
        j_ds = j_generate_onehot(96, 40, 4, n_fields=5, seed=1)
    got, want = t_journal.dataset_digest(t_ds), j_journal.dataset_digest(j_ds)
    assert got == want and len(got) == 16
    # memoized on the object
    assert t_ds._sweep_journal_digest == got
    assert t_journal.dataset_digest(t_ds) == got


@pytest.mark.parametrize("cap", [None, 64])
def test_arrivals_digest_is_jax(monkeypatch, cap):
    if cap is not None:
        monkeypatch.setattr(t_journal, "_FULL_HASH_MAX_BYTES", cap)
        monkeypatch.setattr(j_journal, "_FULL_HASH_MAX_BYTES", cap)
    arr = straggler.arrival_schedule(R, W, add_delay=True, mean=0.5)
    assert t_journal.arrivals_digest(arr) == j_journal.arrivals_digest(arr)
    other = straggler.arrival_schedule(R, W, add_delay=True, mean=0.9)
    assert t_journal.arrivals_digest(arr) != t_journal.arrivals_digest(other)


def test_trajectory_key_pins_every_input(gmm):
    arr = t_trainer.default_arrivals(_base())
    key = t_journal.trajectory_key("naive", _base(), gmm, arr)
    assert key == t_journal.trajectory_key("naive", _base(), gmm, arr)
    assert len(key) == 24
    for changed in (
        t_journal.trajectory_key("other", _base(), gmm, arr),
        t_journal.trajectory_key("naive", _base(seed=1), gmm, arr),
        t_journal.trajectory_key("naive", _base(), generate_gmm(64, 8, W, seed=5), arr),
        t_journal.trajectory_key("naive", _base(), gmm, arr + 1.0),
    ):
        assert changed != key


# ---------------------------------------------------------------------------
# the journal file


def _rows(gmm):
    return t_exp.compare({"naive": _base(), "agc": _base(scheme="approx", num_collect=3)},
                         gmm, batch="off", device="cpu")


def test_payload_round_trips_bitwise(gmm):
    for s in _rows(gmm):
        payload = json.loads(json.dumps(t_journal.summary_payload(s)))
        back = t_journal.rehydrate_summary(payload, s.config)
        for f in t_journal._SCALAR_FIELDS:
            if f != "time_to_target":
                assert getattr(back, f) == getattr(s, f), f
        for f in ("training_loss", "timeset"):
            a, b = getattr(s, f), getattr(back, f)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
        assert back.config is s.config


def test_torn_line_skipped_and_last_record_wins(gmm, tmp_path):
    rows = _rows(gmm)
    j = t_journal.SweepJournal(str(tmp_path), resume=True)
    j.record("k1", "naive", rows[0])
    j.record("k2", "agc", rows[1])
    j.record("k1", "naive", rows[1])  # a later record of the same key
    j.close()
    with open(j.path, "a") as f:
        f.write('{"type": "sweep_trajectory", "key": "k3", "ro')  # torn by a kill
    again = t_journal.SweepJournal(str(tmp_path), resume=True)
    assert len(again) == 2
    assert again.lookup("k1")["row"]["label"] == "agc"
    assert again.lookup("k3") is None
    assert t_journal.SweepJournal(str(tmp_path), resume=False).lookup("k1") is None


def test_threads_append_whole_lines(gmm, tmp_path):
    """More writer threads than cores, with a short switch interval: every
    record lands as one whole line and the count is exact."""
    rows = _rows(gmm)
    j = t_journal.SweepJournal(str(tmp_path))
    before = _counter("sweep_journal.records")
    n_threads, per = 2 * (os.cpu_count() or 4), 25

    def writer(tag):
        for i in range(per):
            j.record(f"{tag}-{i}", tag, rows[i % 2])

    threads = [threading.Thread(target=writer, args=(f"w{t}",)) for t in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    j.close()
    assert _counter("sweep_journal.records") - before == n_threads * per
    assert len(t_journal.SweepJournal(str(tmp_path), resume=True)) == n_threads * per
    assert t_events.validate_file(j.path) == []
    assert j_events.validate_file(j.path) == []


# ---------------------------------------------------------------------------
# kill -> resume


@pytest.mark.parametrize("batch", ["off", "auto", "on"])
def test_kill_resume_rows_identical(gmm, tmp_path, monkeypatch, batch):
    """A sweep interrupted after its 2nd journaled trajectory, resumed from
    the journal, gives rows identical (losses bitwise) to the uninterrupted
    sweep's."""
    baseline = t_exp.compare(_configs(), gmm, batch=batch, device="cpu")
    jdir = str(tmp_path / f"journal_{batch}")
    monkeypatch.setenv(t_chaos.CHAOS_ENV, "raise:trajectory:2")
    t_chaos.reset()
    j = t_journal.SweepJournal(jdir, resume=False)
    with pytest.raises(t_chaos.ChaosInjection):
        t_exp.compare(_configs(), gmm, batch=batch, journal=j, device="cpu")
    j.close()
    monkeypatch.delenv(t_chaos.CHAOS_ENV)
    t_chaos.reset()

    j2 = t_journal.SweepJournal(jdir, resume=True)
    assert len(j2) == 2
    before = _counter("sweep_journal.resumed")
    resumed = t_exp.compare(_configs(), gmm, batch=batch, journal=j2, device="cpu")
    j2.close()
    assert _counter("sweep_journal.resumed") - before == 2
    assert _science(baseline) == _science(resumed)
    for a, b in zip(baseline, resumed):
        assert a.training_loss.dtype == b.training_loss.dtype
        assert a.training_loss.tobytes() == b.training_loss.tobytes()
        assert a.timeset.tobytes() == b.timeset.tobytes()
    assert t_events.validate_file(j2.path) == []
    assert j_events.validate_file(j2.path) == []


@pytest.mark.parametrize("change", ["arrivals", "seed", "dataset"])
def test_resume_key_rejects_changed_inputs(gmm, tmp_path, change):
    configs = {"naive": _base(), "avoid": _base(scheme="avoidstragg")}
    arr1 = straggler.arrival_schedule(R, W, add_delay=True, mean=0.5)
    jdir = str(tmp_path / "j")
    j = t_journal.SweepJournal(jdir)
    t_exp.compare(dict(configs), gmm, arrivals=arr1, journal=j, device="cpu")
    j.close()
    arr, ds, cfgs = arr1, gmm, dict(configs)
    if change == "arrivals":
        arr = straggler.arrival_schedule(R, W, add_delay=True, mean=0.9)
    elif change == "seed":
        cfgs = {k: _base(scheme=c.scheme, seed=7) for k, c in configs.items()}
    else:
        ds = generate_gmm(64, 8, n_partitions=W, seed=3)
    before = _counter("sweep_journal.resumed")
    t_exp.compare(cfgs, ds, arrivals=arr, journal=t_journal.SweepJournal(jdir, resume=True),
                  device="cpu")
    assert _counter("sweep_journal.resumed") == before
    t_exp.compare(dict(configs), gmm, arrivals=arr1,
                  journal=t_journal.SweepJournal(jdir, resume=True), device="cpu")
    assert _counter("sweep_journal.resumed") == before + 2


def test_ambient_env_journal(gmm, tmp_path, monkeypatch):
    jdir = str(tmp_path / "ambient")
    monkeypatch.setenv(SWEEP_JOURNAL_ENV, jdir)
    t_journal.reset_env_journal()
    try:
        first = t_exp.compare({"naive": _base()}, gmm, device="cpu")
        assert os.path.exists(os.path.join(jdir, "sweep_journal.jsonl"))
        monkeypatch.setenv(RESUME_SWEEP_ENV, "1")
        t_journal.reset_env_journal()
        before = _counter("sweep_journal.resumed")
        again = t_exp.compare({"naive": _base()}, gmm, device="cpu")
        assert _counter("sweep_journal.resumed") == before + 1
        assert _science(first) == _science(again)
    finally:
        t_journal.reset_env_journal()


@pytest.mark.parametrize("flag,env,want", [
    (None, None, None), ("d", None, "d"), (None, "e", "e"), ("d", "e", "d"), (None, "", None),
])
def test_resolve_sweep_journal(flag, env, want):
    assert resolve_sweep_journal(flag, env=env) == want


@pytest.mark.parametrize("flag,env,want", [
    (None, None, False), (True, "0", True), (None, "yes", True), (None, "off", False),
    (None, "", False),
])
def test_resolve_resume_sweep(flag, env, want):
    assert resolve_resume_sweep(flag, env=env) is want


def test_resolve_resume_sweep_refuses_junk():
    with pytest.raises(ValueError, match=RESUME_SWEEP_ENV):
        resolve_resume_sweep(None, env="maybe")


def test_diverged_rows_resume_as_diverged(gmm, tmp_path):
    configs = {"boom": _base(scheme="avoidstragg", lr_schedule=1e12), "naive": _base()}
    jdir = str(tmp_path / "j")
    j = t_journal.SweepJournal(jdir)
    first = t_exp.compare(dict(configs), gmm, batch="off", journal=j, device="cpu")
    j.close()
    assert [s.status for s in first] == ["diverged", "ok"]
    before = _counter("sweep_journal.resumed")
    again = t_exp.compare(dict(configs), gmm, batch="off",
                          journal=t_journal.SweepJournal(jdir, resume=True), device="cpu")
    assert _counter("sweep_journal.resumed") == before + 2
    assert [s.status for s in again] == ["diverged", "ok"]
    assert _science(first) == _science(again)


# ---------------------------------------------------------------------------
# the record validator


def test_validator_verdicts_are_jax(tmp_path):
    good = {
        "type": "sweep_trajectory", "seq": 0, "t": 0.0, "key": "abc",
        "label": "x", "status": "ok", "row": {"final_train_loss": 0.1},
    }
    lines = [json.dumps(rec) for rec in (
        good,
        dict(good, seq=1, status="exploded"),
        dict(good, seq=2, row=[1, 2]),
        dict(good, seq=3, key=""),
        dict(good, seq=9),  # continues no stream
        {k: v for k, v in good.items() if k != "label"} | {"seq": 4},
        dict(good, type="nonsense", seq=5),
    )] + ["not json", "[1, 2]"]
    got = t_events.validate_lines(lines)
    assert got == j_events.validate_lines(lines)
    assert len(got) == 8
    path = str(tmp_path / "j.jsonl")
    with open(path, "w") as f:
        f.write("\n".join(lines[:4]) + "\n")
    assert t_events.validate_file(path) == j_events.validate_file(path)


def test_logger_refuses_unknown_records(tmp_path):
    log = t_events.EventLogger(str(tmp_path / "e.jsonl"))
    with pytest.raises(ValueError, match="unknown event type"):
        log.emit("run_start", run_id="x")
    with pytest.raises(ValueError, match="missing required"):
        log.emit("sweep_trajectory", key="k")
    log.close()
    with pytest.raises(ValueError, match="closed"):
        log.emit("sweep_trajectory", key="k", label="l", status="ok", row={})


def test_config_hash_is_stable():
    assert t_events.config_hash(_base()) == t_events.config_hash(_base())
    assert t_events.config_hash(_base()) != t_events.config_hash(_base(seed=1))


# ---------------------------------------------------------------------------
# chaos


GOOD_SPECS = [
    "kill:trajectory:2", "raise:trajectory:1+:UNAVAILABLE", "stall:checkpoint:3:0.5",
    "stall:trajectory:1", "raise:checkpoint:2", "kill:trajectory:1,raise:checkpoint:2+",
    "raise:cohort:1:out of memory", "raise:adapt:3:PREEMPTED",
    "3:worker_death:2,3:worker_revive:5,kill:elastic:4", "0:worker_death:2+",
]
BAD_SPECS = [
    "boom", "kill:nowhere:1", "raise:trajectory:x", "raise:trajectory:0",
    "explode:trajectory:1", "stall:trajectory:1:abc", "stall:trajectory:1:-1",
    "kill:worker_death:2", "-1:worker_revive:1",
]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_chaos_specs_parse_as_jax(spec):
    got, want = t_chaos.parse_specs(spec), j_chaos.parse_specs(spec)
    assert [dataclasses.asdict(s) for s in got] == [dataclasses.asdict(s) for s in want]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_chaos_specs_refused_as_jax(spec):
    with pytest.raises(ValueError) as got:
        t_chaos.parse_spec(spec)
    with pytest.raises(ValueError) as want:
        j_chaos.parse_spec(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("site", sorted(t_chaos.UNWIRED_SITES))
def test_unwired_sites_refused(site):
    """A spec JAX accepts at a site the port does not instrument is refused,
    naming the ROADMAP step that brings it: never silently ignored."""
    spec = f"3:{site}:2" if site in j_chaos.MEMBERSHIP_SITES else f"raise:{site}:2"
    j_chaos.parse_spec(spec)
    with pytest.raises(ValueError, match="ROADMAP") as ei:
        t_chaos.parse_spec(spec)
    assert site in str(ei.value) and t_chaos.UNWIRED_SITES[site] in str(ei.value)
    assert set(t_chaos.SITES) == set(j_chaos.SITES)
    assert set(t_chaos.WIRED_SITES) | set(t_chaos.UNWIRED_SITES) == set(t_chaos.SITES)


@pytest.mark.parametrize("spec", ["raise:trajectory:2:BOOM", "raise:checkpoint:2+"])
def test_maybe_fire_fires_as_jax(monkeypatch, spec):
    monkeypatch.setenv(t_chaos.CHAOS_ENV, spec)
    site = spec.split(":")[1]
    for _ in range(4):
        outcome = []
        for mod in (t_chaos, j_chaos):
            try:
                mod.maybe_fire(site)
                mod.maybe_fire("trajectory" if site == "checkpoint" else "checkpoint")
                outcome.append(None)
            except (t_chaos.ChaosInjection, j_chaos.ChaosInjection) as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1]
    assert t_chaos.active() == t_chaos.parse_spec(spec)


def test_unarmed_maybe_fire_is_a_noop():
    t_chaos.maybe_fire("trajectory")
    assert t_chaos.active() is None and t_chaos.active_specs() == []


def test_kill_exits_with_the_kill_code():
    code = ("from erasurehead_tpu_torch.utils import chaos; "
            "chaos.maybe_fire('trajectory'); print('survived'); chaos.maybe_fire('trajectory')")
    p = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=60,
        env={**os.environ, t_chaos.CHAOS_ENV: "kill:trajectory:2"},
    )
    assert p.returncode == t_chaos.KILL_EXIT == j_chaos.KILL_EXIT == 43
    assert p.stdout.strip() == "survived"


def test_checkpoint_site_leaves_no_valid_round(gmm, tmp_path, monkeypatch):
    cfg = _base(rounds=8, compute_mode="faithful")
    ck = str(tmp_path / "ck")
    monkeypatch.setenv(t_chaos.CHAOS_ENV, "raise:checkpoint:2")
    t_chaos.reset()
    with pytest.raises(t_chaos.ChaosInjection, match="checkpoint"):
        t_trainer.train(cfg, gmm, device="cpu", checkpoint_dir=ck, checkpoint_every=2)
    # the first save committed; the second never started writing
    assert t_checkpoint.latest(ck).endswith("round_2")
    assert sorted(os.listdir(ck)) == ["round_2"]
    monkeypatch.setenv(t_chaos.CHAOS_ENV, "raise:checkpoint:1")
    t_chaos.reset()
    state = t_trainer.train(cfg, gmm, device="cpu").final_state
    solo = str(tmp_path / "solo")
    with pytest.raises(t_chaos.ChaosInjection):
        t_checkpoint.save(os.path.join(solo, "round_4"), state, 4)
    assert not os.path.exists(solo) and t_checkpoint.latest(solo) is None
