"""The port's measured autotuning plane (tune/) against the JAX package's.

The decision cache is pure Python in both packages: for equal decisions the
port's ``canonical_bytes`` equals JAX's byte for byte, and a round trip, a
corrupt file, a stale stamp and a missing file behave as JAX's do. The
racer's verdicts, ``decisive`` flags and timings equal JAX's
``racer.race`` under the same scripted clock. ``glm_fused_signature``
equals JAX's for the same stack shape and dtype, and ``run_shape_signature``
equals JAX's at the same run but for the dense stack's type name
(``Tensor`` against ``ArrayImpl``): ``trainer.resolved_stack`` builds JAX's
stack shapes.

Inside the port: ``lookup`` emits ``source="cache"`` on a hit and
``"default"`` on a miss, records validate and the validator rejects an
unknown race or source; the resolvers walk explicit > env > cache >
constant; a cached verdict flips ``layer_coding``, ``block_decode`` and
``use_pallas`` "auto" (``TrainResult.lowering`` shows it), and the tuned
"auto" run is bitwise the forced run it resolved to (JAX's version of that
test is red: these hold the port to its own forced runs). A chaos kill at
``tune_race`` exits 43 and leaves the cache's bytes as they were; the ring
races skip and record nothing.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from erasurehead_tpu import tune as j_tune
from erasurehead_tpu.data.synthetic import generate_gmm as j_generate_gmm
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.tune import cache as j_cache
from erasurehead_tpu.tune import racer as j_racer
from erasurehead_tpu.utils.config import RunConfig as JRunConfig
from erasurehead_tpu_torch import tune as t_tune
from erasurehead_tpu_torch.data.synthetic import generate_gmm
from erasurehead_tpu_torch.obs import events as t_events
from erasurehead_tpu_torch.parallel import step as t_step
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.tune import cache as t_cache
from erasurehead_tpu_torch.tune import racer as t_racer
from erasurehead_tpu_torch.tune import races as t_races
from erasurehead_tpu_torch.utils import chaos as t_chaos
from erasurehead_tpu_torch.utils.config import RunConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, N_ROWS, N_COLS = 4, 256, 16


@pytest.fixture(autouse=True)
def isolated_cache(tmp_path, monkeypatch):
    """Every test gets its own decision cache file and clean dedup sets;
    the memoized caches are dropped on both sides."""
    path = str(tmp_path / "tune.json")
    monkeypatch.setenv(t_cache.ENV_PATH, path)
    monkeypatch.delenv(t_step.BLOCK_DECODE_ENV, raising=False)
    monkeypatch.delenv(t_chaos.CHAOS_ENV, raising=False)
    for lib in (t_tune, j_tune):
        lib.reset()
        lib.reset_emitted()
    yield path
    for lib in (t_tune, j_tune):
        lib.reset()
        lib.reset_emitted()


@pytest.fixture(scope="module")
def gmm():
    return generate_gmm(N_ROWS, N_COLS, W, seed=0)


def _kw(**kw):
    base = dict(scheme="approx", model="deepmlp", n_workers=W, n_stragglers=1,
                num_collect=3, rounds=3, n_rows=N_ROWS, n_cols=N_COLS,
                update_rule="AGD", lr_schedule=0.5, add_delay=True, seed=0)
    base.update(kw)
    return base


def _cfg(**kw):
    return RunConfig(**_kw(**kw))


class FakeTimer:
    """Scripted clock: returns the next value per call."""

    def __init__(self, values):
        self._vals = iter(values)

    def __call__(self):
        return next(self._vals)


def _records(path, rtype="tune"):
    return [r for r in map(json.loads, open(path)) if r["type"] == rtype]


# ---------------------------------------------------------------------------
# decision cache


DECISION_SETS = {
    "one": {"cpu|block_decode|sig": "fused"},
    "mixed": {
        "NVIDIA H100 80GB HBM3|glm_fused|glm=logistic|X=(30, 3, 4400, 128)|float32": "xla",
        "cpu|layer_coding|model=DeepMLPModel|nl=4|X=Tensor(8, 2, 32, 32)|float32": "treewise",
        "cpu|block_decode|sig": "fused",
    },
    "unicode": {"dev é|stack_mode|s": "ring", "a|b|c": "pallas"},
    "empty": {},
}


@pytest.mark.parametrize("name", list(DECISION_SETS))
def test_canonical_bytes_equal_jax(name):
    d = DECISION_SETS[name]
    assert t_cache.canonical_bytes(d) == j_cache.canonical_bytes(d)
    # insertion order does not matter
    rev = dict(reversed(list(d.items())))
    assert t_cache.canonical_bytes(rev) == t_cache.canonical_bytes(d)


def _drive_cache(lib, path):
    """One script of cache operations; returns what each step saw."""
    seen = []
    c = lib.DecisionCache(path)
    seen.append(c.lookup("cpu", "block_decode", "x"))  # missing file
    c.record("cpu", "block_decode", "x", "fused")
    c.record("cpu", "layer_coding", "x", "treewise")
    seen.append(lib.DecisionCache(path).lookup("cpu", "block_decode", "x"))  # round trip
    other = lib.DecisionCache(path)
    other.record("cpu", "block_decode", "x", "treewise")
    seen.append(c.lookup("cpu", "block_decode", "x"))  # stale stamp: c re-reads
    with open(path, "w") as f:
        f.write("{not json")
    seen.append(c.decisions())  # corrupt file == empty cache
    c.record("cpu", "glm_fused", "y", "pallas")  # heals it
    seen.append(c.decisions())
    seen.append(open(path, "rb").read())
    return seen


def test_cache_behaves_as_jax(tmp_path):
    t = _drive_cache(t_cache, str(tmp_path / "t" / "tune.json"))
    j = _drive_cache(j_cache, str(tmp_path / "j" / "tune.json"))
    assert t == j
    assert t[:3] == [None, "fused", "treewise"] and t[3] == {}


def test_default_path_is_the_ports_own(isolated_cache, monkeypatch):
    assert t_cache.default_path() == isolated_cache
    assert t_tune.get_cache().decisions() == {}
    monkeypatch.delenv(t_cache.ENV_PATH)
    assert t_cache.ENV_PATH == j_cache.ENV_PATH == "ERASUREHEAD_TUNE_CACHE"
    assert t_cache.default_path().endswith(
        os.path.join(".cache", "erasurehead_tpu_torch", "tune.json"))
    assert t_cache.default_path() != j_cache.default_path()


# ---------------------------------------------------------------------------
# racer, under one scripted clock on both sides


RACER_CASES = {
    # sorted order times "fused" first
    "decisive": ([0.0, 1.0, 10.0, 20.0], 1, "treewise"),
    "tie": ([0.0, 0.95, 0.0, 1.0], 1, "treewise"),
    "fallback_wins": ([0.0, 10.0, 0.0, 1.0], 1, "treewise"),
    "min_over_reps": ([0.0, 5.0, 10.0, 11.0, 0.0, 10.0, 20.0, 30.0], 2, "treewise"),
    "fallback_fused": ([0.0, 1.0, 10.0, 20.0], 1, "fused"),
    "edge_of_margin": ([0.0, 0.9, 0.0, 1.0], 1, "treewise"),
}


@pytest.mark.parametrize("case", list(RACER_CASES))
def test_racer_verdicts_equal_jax(case):
    script, reps, fallback = RACER_CASES[case]
    out = []
    for lib in (t_racer, j_racer):
        res = lib.race(
            "block_decode", "sig", {"treewise": lambda: None, "fused": lambda: None},
            fallback=fallback, reps=reps, timer=FakeTimer(script), record=False,
            device_kind="cpu",
        )
        out.append((res.choice, res.decisive, res.timings, res.fallback, res.device_kind))
    assert out[0] == out[1]


def test_racer_unknown_fallback_raises_as_jax():
    for lib in (t_racer, j_racer):
        with pytest.raises(ValueError, match="fallback"):
            lib.race("block_decode", "sig", {"fused": lambda: None}, fallback="nope",
                     reps=1, record=False, device_kind="cpu")


def test_race_records_choice_and_emits_record(isolated_cache, tmp_path):
    path = str(tmp_path / "events.jsonl")
    with t_events.capture(path):
        t_racer.race("block_decode", "shape-sig", {"treewise": lambda: None, "fused": lambda: None},
                     fallback="treewise", reps=1, timer=FakeTimer([0.0, 1.0, 10.0, 20.0]),
                     device_kind="cpu")
    assert t_tune.get_cache().lookup("cpu", "block_decode", "shape-sig") == "fused"
    (rec,) = _records(path)
    assert (rec["choice"], rec["source"], rec["device_kind"]) == ("fused", "race", "cpu")
    assert t_events.validate_file(path) == []


# ---------------------------------------------------------------------------
# lookup, records, validator


def test_lookup_sources_and_dedup(tmp_path):
    t_tune.get_cache().record("cpu", "block_decode", "s", "fused")
    path = str(tmp_path / "events.jsonl")
    with t_events.capture(path):
        assert t_tune.lookup("block_decode", "s", device_kind="cpu") == "fused"
        assert t_tune.lookup("block_decode", "s", device_kind="cpu") == "fused"  # deduped
        assert t_tune.lookup("layer_coding", "s", device_kind="cpu", fallback="treewise") is None
        assert t_tune.lookup("glm_fused", "s", device_kind="cpu") is None  # no fallback: silent
    recs = _records(path)
    assert [(r["race"], r["source"], r["choice"]) for r in recs] == [
        ("block_decode", "cache", "fused"), ("layer_coding", "default", "treewise")]
    assert t_events.validate_file(path) == []


def test_validator_rejects_unknown_race_and_source():
    line = json.dumps({"type": "tune", "seq": 0, "t": 0.0, "race": "bogus",
                       "device_kind": "cpu", "shape": "s", "choice": "x", "source": "vibes"})
    errors = t_events.validate_lines([line])
    assert any("race" in e for e in errors) and any("source" in e for e in errors)
    empty = json.dumps({"type": "tune", "seq": 0, "t": 0.0, "race": "glm_fused",
                        "device_kind": "", "shape": "s", "choice": "pallas", "source": "race"})
    assert any("device_kind" in e for e in t_events.validate_lines([empty]))


def test_vocabularies_equal_jax():
    assert t_tune.TUNE_CHOICES == j_tune.TUNE_CHOICES
    assert tuple(sorted(t_tune.TUNE_CHOICES)) == t_events.TUNE_RACES
    assert t_events.TUNE_SOURCES == ("race", "cache", "default")
    assert t_racer.TIE_MARGIN == j_racer.TIE_MARGIN
    assert t_racer.DEFAULT_REPS == j_racer.DEFAULT_REPS


def test_device_kind_is_the_runs_device():
    assert t_tune.default_device_kind("cpu") == "cpu"
    if torch.cuda.is_available():
        assert t_tune.default_device_kind() == torch.cuda.get_device_name(0)
    else:  # the port's default device is cuda, and it raises without a card
        with pytest.raises(RuntimeError, match="cuda"):
            t_tune.default_device_kind()


# ---------------------------------------------------------------------------
# signatures


@pytest.mark.parametrize("shape", [(30, 3, 4400, 128), (90, 4400, 128), (3, 2, 2200, 15509)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["logistic", "linear"])
def test_glm_fused_signature_equals_jax(shape, dtype, kind):
    t_sig = t_tune.glm_fused_signature(torch.Size(shape), getattr(torch, dtype), kind)
    assert t_sig == j_tune.glm_fused_signature(shape, str(jnp.dtype(dtype)), kind)


@pytest.mark.parametrize("kw", [
    dict(),  # deepmlp, faithful [W, S, rows, F]
    dict(model="logistic"),
    dict(model="moe", compute_mode="deduped"),  # partition-major [P, rows, F]
    dict(model="deepmlp", deep_layers=2, scheme="cyccoded", num_collect=None),
], ids=["deepmlp", "logistic", "moe_deduped", "deepmlp2_cyccoded"])
def test_run_shape_signature_equals_jax(kw, gmm):
    t_model, t_X = t_trainer.resolved_stack(_cfg(**kw), gmm, device="cpu")
    j_model, j_X = j_trainer.resolved_stack(JRunConfig(**_kw(**kw)), j_generate_gmm(
        N_ROWS, N_COLS, n_partitions=W, seed=0))
    t_sig = t_tune.run_shape_signature(t_model, t_X)
    j_sig = j_tune.run_shape_signature(j_model, j_X)
    assert "X=Tensor(" in t_sig and "torch" not in t_sig
    assert t_sig == j_sig.replace(f"X={type(j_X).__name__}(", "X=Tensor(")


# ---------------------------------------------------------------------------
# resolvers walk the ladder


def _stack(gmm, **kw):
    return t_trainer.resolved_stack(_cfg(**kw), gmm, device="cpu")


def _record(race, model, X, choice):
    t_tune.get_cache().record("cpu", race, t_tune.run_shape_signature(model, X), choice)


def test_block_decode_ladder(gmm, monkeypatch):
    model, X = _stack(gmm)
    # 4. the constant
    assert t_step.resolve_block_decode("auto", model, X) is t_step.BLOCK_DECODE_FUSED_DEFAULT
    # 3. a cached verdict beats it
    _record("block_decode", model, X, "treewise")
    assert t_step.resolve_block_decode("auto", model, X) is False
    # 2. the env beats the cache
    monkeypatch.setenv(t_step.BLOCK_DECODE_ENV, "fused")
    assert t_step.resolve_block_decode("auto", model, X) is True
    # 1. an explicit value beats the env
    assert t_step.resolve_block_decode("treewise", model, X) is False
    monkeypatch.setenv(t_step.BLOCK_DECODE_ENV, "treewise")
    assert t_step.resolve_block_decode("fused", model, X) is True
    assert t_step.resolve_block_decode("auto", model, X) is False
    monkeypatch.setenv(t_step.BLOCK_DECODE_ENV, "bogus")  # not a choice: ignored
    assert t_step.resolve_block_decode("auto", model, X) is False  # the cache's


def test_layer_coding_ladder(gmm):
    model, X = _stack(gmm)
    assert t_step.resolve_layer_coding("auto", model, X) is t_step.LAYER_CODING_DEFAULT
    _record("layer_coding", model, X, "blockwise")
    assert t_step.resolve_layer_coding("auto", model, X) is True
    assert t_step.resolve_layer_coding("off", model, X) is False
    assert t_step.resolve_layer_coding("auto", model) is t_step.LAYER_CODING_DEFAULT  # no X


def test_a_verdict_keys_by_device_kind(gmm):
    model, X = _stack(gmm)
    t_tune.get_cache().record("NVIDIA H100 80GB HBM3", "block_decode",
                              t_tune.run_shape_signature(model, X), "treewise")
    # a card's verdict never resolves a CPU run
    assert t_step.resolve_block_decode("auto", model, X) is t_step.BLOCK_DECODE_FUSED_DEFAULT


def test_race_signature_is_resolve_signature(gmm):
    """The shape key the race persists is the key the next run computes."""
    cfg = _cfg(rounds=2, layer_coding="on")
    res = t_races.race_block_decode(cfg, gmm, reps=1, timer=FakeTimer([0.0, 10.0, 0.0, 1.0]),
                                    device="cpu")
    assert res.choice == "treewise" and res.decisive
    model, X = t_trainer.resolved_stack(cfg, gmm, device="cpu")
    assert res.shape == t_tune.run_shape_signature(model, X)
    assert t_step.resolve_block_decode("auto", model, X) is False


def _leaves(res):
    p = res.final_params
    return [p] if isinstance(p, torch.Tensor) else [p[k] for k in sorted(p)]


def _bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b))) and \
        np.array_equal(a.timeset, b.timeset)


def test_tuned_block_decode_run_is_bitwise_its_forced_run(gmm, tmp_path):
    cfg = _cfg(rounds=2, layer_coding="on")
    t_races.race_block_decode(cfg, gmm, reps=1, timer=FakeTimer([0.0, 10.0, 0.0, 1.0]),
                              device="cpu")
    path = str(tmp_path / "events.jsonl")
    with t_events.capture(path):
        auto = t_trainer.train(dataclasses.replace(cfg, block_decode="auto"), gmm, device="cpu")
    dark = t_trainer.train(dataclasses.replace(cfg, block_decode="auto"), gmm, device="cpu")
    forced = t_trainer.train(dataclasses.replace(cfg, block_decode="treewise"), gmm, device="cpu")
    assert _bitwise(auto, forced) and _bitwise(dark, forced)
    assert auto.lowering == "layer_block"
    assert [(r["race"], r["source"], r["choice"]) for r in _records(path)] == [
        ("block_decode", "cache", "treewise")]
    assert t_events.validate_file(path) == []


def test_tuned_layer_coding_flips_auto(gmm):
    cfg = _cfg(rounds=2)
    before = t_trainer.train(cfg, gmm, device="cpu")
    assert before.lowering == "per_slot"
    model, X = t_trainer.resolved_stack(cfg, gmm, device="cpu")
    _record("layer_coding", model, X, "blockwise")
    auto = t_trainer.train(cfg, gmm, device="cpu")
    forced = t_trainer.train(dataclasses.replace(cfg, layer_coding="on"), gmm, device="cpu")
    assert auto.lowering == forced.lowering == "layer_block"
    assert _bitwise(auto, forced)


@pytest.mark.parametrize("verdict,lowering,forced", [
    ("xla", "per_slot", "off"), ("pallas", "fused", "on")])
def test_tuned_glm_fused_flips_use_pallas_auto(gmm, tmp_path, verdict, lowering, forced):
    cfg = _cfg(model="logistic", rounds=3)
    assert t_trainer.train(cfg, gmm, device="cpu").lowering == "fused"  # no verdict: B1
    _, X = t_trainer.resolved_stack(cfg, gmm, device="cpu")
    sig = t_tune.glm_fused_signature(X.shape, X.dtype, "logistic")
    t_tune.get_cache().record("cpu", "glm_fused", sig, verdict)
    path = str(tmp_path / "events.jsonl")
    with t_events.capture(path):
        auto = t_trainer.train(cfg, gmm, device="cpu")
    ref = t_trainer.train(dataclasses.replace(cfg, use_pallas=forced), gmm, device="cpu")
    assert auto.lowering == ref.lowering == lowering
    assert _bitwise(auto, ref)
    assert [(r["race"], r["shape"], r["source"], r["choice"]) for r in _records(path)
            if r["race"] == "glm_fused"] == [("glm_fused", sig, "cache", verdict)]


def test_glm_fused_race_on_the_cpu(gmm):
    cfg = _cfg(model="logistic")
    res = t_races.race_glm_fused(cfg, gmm, reps=1, device="cpu")
    _, X = t_trainer.resolved_stack(cfg, gmm, device="cpu")
    assert res.shape == t_tune.glm_fused_signature(X.shape, X.dtype, "logistic")
    assert res.fallback == "pallas" and set(res.timings) == {"pallas", "xla"}
    assert t_tune.get_cache().lookup("cpu", "glm_fused", res.shape) == res.choice
    with pytest.raises(ValueError, match="dense GLM"):
        t_races.race_glm_fused(_cfg(), gmm, reps=1, device="cpu")


def test_ring_races_skip_and_record_nothing(gmm, isolated_cache):
    """The ring races race for real in one process (they skipped before the
    ring transport was ported): ring_pipeline under the partition-major
    stack's run signature, stack_mode under JAX's pre-stack signature, each
    verdict recorded, the trajectories of both candidates bitwise equal."""
    cfg = _cfg(model="logistic")
    pipe = t_races.race_ring_pipeline(cfg, gmm, reps=1, device="cpu")
    mode = t_races.race_stack_mode(cfg, gmm, reps=1, device="cpu")
    assert set(pipe.timings) == {"sequential", "pipelined"} and pipe.fallback == "sequential"
    assert set(mode.timings) == {"materialized", "ring"} and mode.fallback == "materialized"
    model, Xp = t_trainer.resolved_stack(dataclasses.replace(cfg, stack_mode="ring"), gmm,
                                         device="cpu")
    assert tuple(Xp.shape) == (W, N_ROWS // W, N_COLS)  # partition-major
    assert pipe.shape == t_tune.run_shape_signature(model, Xp)
    layout = t_trainer.build_layout(cfg)
    jlayout = j_trainer.build_layout(JRunConfig(**_kw(model="logistic")))
    assert mode.shape == j_tune.stack_mode_signature(jlayout, N_ROWS // W, N_COLS, "float32")
    assert mode.shape == t_tune.stack_mode_signature(layout, N_ROWS // W, N_COLS, "float32")
    decisions = t_tune.get_cache().decisions()
    assert decisions[f"cpu|ring_pipeline|{pipe.shape}"] == pipe.choice
    assert decisions[f"cpu|stack_mode|{mode.shape}"] == mode.choice
    runs = [t_trainer.train(dataclasses.replace(cfg, **kw), gmm, device="cpu").params_history
            for kw in (dict(), dict(stack_mode="ring", ring_pipeline="off"),
                       dict(stack_mode="ring", ring_pipeline="on"))]
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])


# ---------------------------------------------------------------------------
# the CLI and the kill drill


TINY = ["--model", "logistic", "--workers", "4", "--stragglers", "1", "--num-collect", "3",
        "--rows", "128", "--cols", "8", "--rounds", "2", "--reps", "1", "--device", "cpu"]


def _cli(args, cache, chaos=None):
    env = dict(os.environ, ERASUREHEAD_TUNE_CACHE=cache, PYTHONPATH=REPO)
    env.pop(t_chaos.CHAOS_ENV, None)
    if chaos:
        env[t_chaos.CHAOS_ENV] = chaos
    return subprocess.run([sys.executable, "-m", "erasurehead_tpu_torch.cli", "tune"] + args,
                          env=env, capture_output=True, text=True, timeout=300, cwd=REPO)


def test_kill_mid_race_leaves_cache_bytes(tmp_path):
    cache = str(tmp_path / "tune.json")
    seed = t_cache.DecisionCache(cache)
    seed.record("cpu", "block_decode", "older", "treewise")
    before = open(cache, "rb").read()
    killed = _cli(["--race", "glm_fused"] + TINY, cache, chaos="kill:tune_race:1")
    assert killed.returncode == t_chaos.KILL_EXIT == 43, killed.stderr
    assert open(cache, "rb").read() == before
    rerun = _cli(["--race", "glm_fused", "--json"] + TINY, cache)
    assert rerun.returncode == 0, rerun.stderr
    out = json.loads(rerun.stdout.strip().splitlines()[-1])
    assert out["platform"] == "cpu" and out["device_kind"] == "cpu"
    shape = out["races"]["glm_fused"]["shape"]
    assert shape == "glm=logistic|X=(4, 2, 32, 8)|float32"
    decisions = t_cache.DecisionCache(cache).decisions()
    assert set(decisions) == {"cpu|block_decode|older", f"cpu|glm_fused|{shape}"}


def test_cli_race_all_skips_the_ring_races(tmp_path, capsys):
    """``--race all`` runs all five races: the ring races no longer skip."""
    from erasurehead_tpu_torch import cli as t_cli

    assert t_cli.main(["tune", "--race", "all"] + TINY) == 0
    out = capsys.readouterr().out
    assert "SKIPPED" not in out
    assert "ring_pipeline: choice=" in out and "stack_mode: choice=" in out
    keys = {k.split("|")[1] for k in t_tune.get_cache().decisions()}
    assert keys == {"block_decode", "layer_coding", "glm_fused", "ring_pipeline", "stack_mode"}


def test_tune_race_site_is_wired():
    assert "tune_race" in t_chaos.WIRED_SITES and "tune_race" not in t_chaos.UNWIRED_SITES
    spec = t_chaos.parse_spec("kill:tune_race:1")
    assert (spec.mode, spec.site, spec.count) == ("kill", "tune_race", 1)
