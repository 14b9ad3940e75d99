"""The compiled round loop (train/graphs.py, the executable cache, the
recompile detector, donation and its lint) against the JAX package, on the
CPU.

The card replays captured CUDA graphs of each trainer's one round body; the
CPU runs that body uncaptured (graphs.run_eager), row by row over the same
round tables, and tests/test_torch_graphs_cuda.py holds the replays bitwise
the uncaptured runs on the card. What is held, at W = 12, s = 2, 432 x 24,
20 rounds, from the JAX package's init draw:

  - ``donate`` and ``scan_unroll``: defaults, validation messages, the CLI
    flags and ``static_signature_fields()`` equal to the JAX package's;
  - ``step.lowering_signature`` equal to JAX's for every family and knob
    setting but the stack type's name (and the documented block_decode
    default), and moved by a tune verdict;
  - one sequence of configs through both packages gives equal
    ``exec_hits`` / ``exec_misses`` run by run (JAX
    tests/test_sweep_cache.py:100-125);
  - the recompile detector's cases (JAX tests/test_telemetry.py:311-360),
    the trainer's warning naming scan_unroll, stack_dtype, ring_pipeline
    and donate;
  - ``scan_unroll`` 1, 2, 4 and R bitwise each other and within rtol 2e-4 /
    atol 1e-5 of JAX's (JAX tests/test_train.py:1073-1110), train and
    train_dynamic;
  - the round body's run, its executable-cache hit and its run under
    ``graphs.disabled()`` bitwise each other: every rule, pipelined,
    chunked, deep, dynamic, cohorts;
  - the six donation contracts of JAX tests/test_donation.py, and a read
    after donation that raises;
  - the donation-safety lint on JAX's fixtures restated for the port.
"""

import dataclasses
import itertools
import os
import textwrap

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from erasurehead_tpu import cli as j_cli
from erasurehead_tpu.data.synthetic import generate_gmm as j_generate_gmm
from erasurehead_tpu.data.synthetic import generate_onehot as j_generate_onehot
from erasurehead_tpu.obs import detect as j_detect
from erasurehead_tpu.parallel import step as j_step
from erasurehead_tpu.train import cache as j_cache
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.utils.config import RunConfig as JRunConfig
from erasurehead_tpu_torch import cli as t_cli
from erasurehead_tpu_torch import tune as t_tune
from erasurehead_tpu_torch.analysis import runner
from erasurehead_tpu_torch.data.synthetic import generate_gmm, generate_onehot
from erasurehead_tpu_torch.obs import detect
from erasurehead_tpu_torch.obs import events as t_events
from erasurehead_tpu_torch.ops import kernels
from erasurehead_tpu_torch.parallel import step as t_step
from erasurehead_tpu_torch.train import cache, experiments, graphs, trainer
from erasurehead_tpu_torch.utils import chaos
from erasurehead_tpu_torch.utils.config import RunConfig

W, S, ROWS, COLS, ROUNDS = 12, 2, 432, 24, 20
RTOL, ATOL = 2e-4, 1e-5


def _kw(**kw):
    base = dict(scheme="approx", n_workers=W, n_stragglers=S, num_collect=8, rounds=ROUNDS,
                n_rows=ROWS, n_cols=COLS, lr_schedule=1.0, update_rule="AGD",
                add_delay=True, seed=0)
    base.update(kw)
    return base


def _cfg(**kw):
    return RunConfig(**_kw(**kw))


def _jcfg(**kw):
    return JRunConfig(**_kw(**kw))


@pytest.fixture(scope="module")
def data():
    return generate_gmm(ROWS, COLS, n_partitions=W, seed=0)


@pytest.fixture(scope="module")
def jdata():
    return j_generate_gmm(ROWS, COLS, n_partitions=W, seed=0)


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    """Empty caches and detectors, no chaos, an empty tune cache."""
    monkeypatch.setenv("ERASUREHEAD_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.delenv(chaos.CHAOS_ENV, raising=False)
    monkeypatch.delenv(t_step.BLOCK_DECODE_ENV, raising=False)
    t_tune.reset()
    chaos.reset()
    cache.clear()
    cache.set_enabled(True)
    j_cache.clear()
    yield
    cache.clear()
    j_cache.clear()
    chaos.reset()
    t_tune.reset()


def _jax_init(jcfg):
    return np.asarray(j_trainer._init_params_f32(jcfg, j_trainer.build_model(jcfg), COLS))


def _leaves(tree):
    return pytree.tree_leaves(tree)


def _bitwise(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _same_run(a, b) -> bool:
    return (_bitwise(a.params_history, b.params_history)
            and _bitwise(a.final_params, b.final_params)
            and np.array_equal(a.timeset, b.timeset)
            and np.array_equal(a.worker_times, b.worker_times)
            and np.array_equal(a.collected, b.collected))


def _exec(res):
    return [res.cache_info["exec_hits"], res.cache_info["exec_misses"]]


# ---------------------------------------------------------------------------
# the two fields


def test_fields_defaults_validation_and_signature_keys_equal_jax():
    assert (RunConfig().donate, RunConfig().scan_unroll) == (JRunConfig().donate,
                                                            JRunConfig().scan_unroll) == ("auto", 1)
    for kw in (dict(scan_unroll=0), dict(scan_unroll=-3), dict(donate="maybe")):
        with pytest.raises(ValueError) as want:
            JRunConfig(**kw)
        with pytest.raises(ValueError) as got:
            RunConfig(**kw)
        assert str(got.value) == str(want.value)
    for kw in (dict(), dict(donate="off", scan_unroll=4), dict(donate="on")):
        got, want = RunConfig(**kw).static_signature_fields(), JRunConfig(**kw).static_signature_fields()
        assert list(got) == list(want)
        assert (got["donate"], got["scan_unroll"]) == (want["donate"], want["scan_unroll"])
    assert RunConfig(scan_unroll=2).static_signature() != RunConfig().static_signature()
    assert RunConfig(donate="off").static_signature() != RunConfig().static_signature()


@pytest.mark.parametrize("flags", [[], ["--donate", "off", "--scan-unroll", "5"],
                                   ["--donate", "on"]])
def test_cli_flags_as_jax_parses_them(flags):
    base = ["--scheme", "naive", "--workers", "4", "--rounds", "3"]
    got = t_cli._flags_to_config(t_cli._flags_parser().parse_args(base + flags))
    want = j_cli._flags_to_config(j_cli._flags_parser().parse_args(base + flags))
    assert (got.donate, got.scan_unroll) == (want.donate, want.scan_unroll)


# ---------------------------------------------------------------------------
# lowering_signature

FAMILIES = ("logistic", "linear", "mlp", "deepmlp", "moe")
KNOBS = dict(flat_grad=("auto", "on", "off"), margin_flat=("auto", "on", "off"),
             layer_coding=("auto", "on", "off"), block_decode=("fused", "treewise"))


def _stacks(model, mode, data, jdata, **kw):
    cfg_kw = _kw(model=model, compute_mode=mode, update_rule="GD", lr_schedule=0.5, **kw)
    t_model, t_X = trainer.resolved_stack(RunConfig(**cfg_kw), data, device="cpu")
    j_model, j_X = j_trainer.resolved_stack(JRunConfig(**cfg_kw), jdata)
    return cfg_kw, (t_model, t_X), (j_model, j_X)


@pytest.mark.parametrize("model", FAMILIES)
@pytest.mark.parametrize("mode", ["faithful", "deduped"])
def test_lowering_signature_equals_jax(model, mode, data, jdata):
    """Every knob setting resolves as the JAX package resolves it; only the
    stack type's name (a tensor here, a jax Array there) differs."""
    cfg_kw, (tm, tX), (jm, jX) = _stacks(model, mode, data, jdata)
    for values in itertools.product(*KNOBS.values()):
        knobs = dict(zip(KNOBS, values))
        kw = {**cfg_kw, **knobs}
        try:
            jcfg = JRunConfig(**kw)
        except ValueError as refused:  # a combination both configs refuse
            with pytest.raises(ValueError) as ei:
                RunConfig(**kw)
            assert str(ei.value) == str(refused)
            continue
        got = t_step.lowering_signature(RunConfig(**kw), tm, tX)
        want = j_step.lowering_signature(jcfg, jm, jX)
        if not j_step.supports_layer_coding(jm):
            # the documented deviation (step.supports_layer_coding): JAX's
            # gate refuses the autodiff families, the port's takes them, so
            # their blockwise decode resolves as JAX's would for a GLM
            want = want[:2] + ({"on": True, "off": False, "auto": False}[
                knobs["layer_coding"]],) + want[3:]
        assert got[:4] == want[:4], knobs
        assert got[4] == type(tX).__name__


@pytest.mark.parametrize("fmt", ["padded", "fields"])
def test_lowering_signature_sparse_stacks_equal_jax(fmt):
    rows, cols = 480, 60
    data = generate_onehot(rows, cols, W, n_fields=4, seed=0)
    jdata = j_generate_onehot(rows, cols, W, n_fields=4, seed=0)
    kw = _kw(n_rows=rows, n_cols=cols, sparse_format=fmt, block_decode="fused")
    tm, tX = trainer.resolved_stack(RunConfig(**kw), data, device="cpu")
    jm, jX = j_trainer.resolved_stack(JRunConfig(**kw), jdata)
    for flat in ("auto", "on", "off"):
        got = t_step.lowering_signature(RunConfig(**{**kw, "flat_grad": flat}), tm, tX)
        want = j_step.lowering_signature(JRunConfig(**{**kw, "flat_grad": flat}), jm, jX)
        assert got == want[:4] + (type(tX).__name__,)
        assert got[4] == type(jX).__name__ == ("PaddedRows" if fmt == "padded" else "FieldOnehot")


def test_lowering_signature_block_decode_auto_and_tune_verdicts(data, jdata, monkeypatch):
    """``block_decode="auto"``: the env override resolves both packages
    alike; without one the port's documented default is the fused lowering
    (step.BLOCK_DECODE_FUSED_DEFAULT), JAX's the treewise one. A tune
    verdict landing in the cache moves the port's key."""
    cfg_kw, (tm, tX), (jm, jX) = _stacks("deepmlp", "faithful", data, jdata)
    kw = {**cfg_kw, "block_decode": "auto", "layer_coding": "auto"}
    for env in ("fused", "treewise"):
        monkeypatch.setenv(t_step.BLOCK_DECODE_ENV, env)
        assert (t_step.lowering_signature(RunConfig(**kw), tm, tX)[:4]
                == j_step.lowering_signature(JRunConfig(**kw), jm, jX)[:4])
    monkeypatch.delenv(t_step.BLOCK_DECODE_ENV)
    assert t_step.lowering_signature(RunConfig(**kw), tm, tX)[3] is t_step.BLOCK_DECODE_FUSED_DEFAULT
    before = t_step.lowering_signature(RunConfig(**kw), tm, tX)
    sig = t_tune.run_shape_signature(tm, tX)
    t_tune.get_cache().record("cpu", "layer_coding", sig, "blockwise")
    after = t_step.lowering_signature(RunConfig(**kw), tm, tX)
    assert before[2] is False and after[2] is True


# ---------------------------------------------------------------------------
# the executable cache: the JAX package's sequence, run by run


def test_exec_hits_and_misses_follow_jax_run_by_run(data, jdata, tmp_path):
    """approx then repcoded hit (their weight tables are tables, and FRC
    shares AGC's stack); dtype, flat_grad, update_rule, scan_unroll and
    compute_mode each miss; a checkpoint-chunked run makes one entry per
    chunk length."""
    seq = [dict(), dict(scheme="repcoded", num_collect=None), dict(dtype="bfloat16"),
           dict(flat_grad="on", use_pallas="off"), dict(update_rule="GD"), dict(scan_unroll=2),
           dict(compute_mode="deduped"), "chunked", dict(), dict(seed=3, lr_schedule=0.25)]
    got, want = [], []
    for k, step in enumerate(seq):
        ck = {} if step != "chunked" else dict(checkpoint_every=7)
        kw = {} if step == "chunked" else step
        t_ck = dict(checkpoint_dir=str(tmp_path / f"t{k}"), **ck) if ck else {}
        j_ck = dict(checkpoint_dir=str(tmp_path / f"j{k}"), **ck) if ck else {}
        got.append(_exec(trainer.train(_cfg(**kw), data, device="cpu", **t_ck)))
        want.append(_exec(j_trainer.train(_jcfg(**kw), jdata, **j_ck)))
    assert got == want
    assert got[1] == [1, 0] and got[7] == [0, 2] and got[-1] == [1, 0]
    assert cache.stats().exec_hits == sum(h for h, _ in got)
    assert cache.stats().compile_seconds_saved > 0


def test_executor_and_cache_fields(data):
    res = trainer.train(_cfg(), data, device="cpu")
    info = res.cache_info
    assert (info["executor"], info["eager_reason"], info["donation"]) == ("cpu", None, True)
    assert info["memory_analysis"] == {"executor": "cpu"}
    hit = trainer.train(_cfg(), data, device="cpu")
    assert hit.cache_info["executor"] == "cpu" and _exec(hit) == [1, 0]
    with graphs.disabled():
        eager = trainer.train(_cfg(), data, device="cpu")
    assert eager.cache_info["executor"] == "eager" and _exec(eager) == [0, 0]
    assert eager.cache_info["eager_reason"] == "graphs.disabled()"
    assert _same_run(res, hit) and _same_run(res, eager)


class _Held:
    """An executable entry holding a data stack (a program's ``holds``)."""

    nbytes = 0

    def __init__(self, *tokens):
        self.holds = tokens


def _held_entry(data, **kw):
    """Run once to cache the stack, then cache an entry that holds it."""
    trainer.train(_cfg(**kw), data, device="cpu")
    token = next(cache._entry_token(d) for d, _ in reversed(cache._data_cache.values()))
    cache.get_or_compile(("held",) + tuple(sorted(kw.items())), lambda: (_Held(token), 0.0))
    return token


def test_drop_data_cache_drops_the_programs_holding_a_stack(data):
    _held_entry(data)
    assert sum(isinstance(e, _Held) for e, _ in cache._exec_cache.values()) == 1
    cache.drop_data_cache()
    assert not any(isinstance(e, _Held) for e, _ in cache._exec_cache.values())
    res = trainer.train(_cfg(), data, device="cpu")
    # the key carries the stack's identity: a new stack, a new entry
    assert _exec(res) == [0, 1] and res.cache_info["data_hit"] is False


def test_data_lru_eviction_drops_programs_and_exec_lru(data, monkeypatch):
    monkeypatch.setattr(cache, "DATA_CACHE_MAX", 1)
    _held_entry(data)
    _held_entry(data, compute_mode="deduped")  # evicts the first stack
    assert sum(isinstance(e, _Held) for e, _ in cache._exec_cache.values()) == 1
    monkeypatch.setattr(cache, "EXEC_CACHE_MAX", 2)
    for u in (1, 2, 3):
        trainer.train(_cfg(compute_mode="deduped", scan_unroll=u), data, device="cpu")
    assert len(cache._exec_cache) == 2


def test_cache_disabled_counts_nothing(data):
    """With the caches off every run compiles (a miss in its own counts, as
    in the JAX package) and the process counters stay at zero."""
    cache.set_enabled(False)
    try:
        a = trainer.train(_cfg(), data, device="cpu")
        b = trainer.train(_cfg(), data, device="cpu")
    finally:
        cache.set_enabled(True)
    assert _exec(a) == _exec(b) == [0, 1]
    assert cache.stats().exec_hits == cache.stats().exec_misses == 0
    assert _same_run(a, b)


# ---------------------------------------------------------------------------
# the recompile detector


def test_recompile_detector_names_changed_fields():
    for mod in (detect, j_detect):
        mod.reset()
        a = {"kind": "scan", "dtype": "float32", "scan_unroll": 1, "chunk_rounds": 5}
        assert mod.observe(dict(a)) is None
        diff = mod.observe({**a, "scan_unroll": 2})
        assert diff is not None and diff["changed"] == ["scan_unroll"]
        assert "1 -> 2" in diff["detail"]["scan_unroll"]
        assert mod.observe({**a, "chunk_rounds": 3}) is None
        diff = mod.observe(dict(a))
        assert diff is not None and diff["changed"] == []
    assert detect.EXPECTED_VARYING == j_detect.EXPECTED_VARYING == frozenset({"chunk_rounds"})


def test_cache_clear_resets_the_detector():
    detect.observe({"kind": "scan", "x": 1})
    cache.clear()
    assert detect.observe({"kind": "scan", "x": 2}) is None


def _recompile_changed(cfg_a, cfg_b, data, tmp_path, tag):
    import json

    cache.clear()
    path = str(tmp_path / f"events_{tag}.jsonl")
    with t_events.capture(path):
        trainer.train(cfg_a, data, device="cpu")
        trainer.train(cfg_b, data, device="cpu")
    recs = [r for r in map(json.loads, open(path)) if r["type"] == "warning"
            and r["kind"] == "recompile"]
    assert recs, f"expected a recompile warning for {tag}"
    assert t_events.validate_file(path) == []
    return recs[-1]["changed"]


@pytest.mark.parametrize("knob,a,b,extra", [
    ("scan_unroll", 1, 2, {}),
    ("stack_dtype", "auto", "int8", {}),
    ("ring_pipeline", "off", "on", dict(compute_mode="faithful", stack_mode="ring")),
    ("donate", "on", "off", {}),
])
def test_recompile_warning_names_the_knob(knob, a, b, extra, data, tmp_path):
    base = {"compute_mode": "deduped", **extra}
    changed = _recompile_changed(_cfg(**base, **{knob: a}), _cfg(**base, **{knob: b}), data,
                                 tmp_path, knob)
    assert knob in changed


# ---------------------------------------------------------------------------
# scan_unroll: rounds per replay, the same math


def test_scan_unroll_bitwise_and_within_jax(data, jdata):
    jcfg = _jcfg()
    init = _jax_init(jcfg)
    base = trainer.train(_cfg(), data, device="cpu", init_params=init)
    for u in (1, 2, 4, ROUNDS, 3):
        run = trainer.train(_cfg(scan_unroll=u), data, device="cpu", init_params=init)
        with graphs.disabled():
            eager = trainer.train(_cfg(scan_unroll=u), data, device="cpu", init_params=init)
        assert _same_run(run, base) and _same_run(eager, base), u
        assert _exec(run) == ([1, 0] if u == _cfg().scan_unroll else [0, 1]), u
        want = j_trainer.train(_jcfg(scan_unroll=u), jdata, measure=False)
        np.testing.assert_allclose(run.params_history.numpy(), np.asarray(want.params_history),
                                   rtol=RTOL, atol=ATOL)


def test_scan_unroll_dynamic_bitwise_and_within_jax(data, jdata):
    init = _jax_init(_jcfg())
    base = trainer.train_dynamic(_cfg(), data, device="cpu", init_params=init)
    for u in (1, 4, ROUNDS):
        run = trainer.train_dynamic(_cfg(scan_unroll=u), data, device="cpu", init_params=init)
        assert _same_run(run, base), u
    want = j_trainer.train_dynamic(_jcfg(scan_unroll=4), jdata)
    np.testing.assert_allclose(base.params_history.numpy(), np.asarray(want.params_history),
                               rtol=RTOL, atol=ATOL)
    assert np.array_equal(base.collected, np.asarray(want.collected))


# ---------------------------------------------------------------------------
# the one round body: its run, its cache hit and its run under disabled()


@pytest.mark.parametrize("kw", [
    dict(), dict(update_rule="GD"), dict(update_rule="ADAM", lr_schedule=0.05),
    dict(update_rule="GD", pipeline_depth=1), dict(compute_mode="deduped"),
    dict(model="deepmlp", update_rule="GD", lr_schedule=0.5, layer_coding="on"),
    dict(model="mlp", update_rule="GD", lr_schedule=0.5),
    dict(stack_dtype="int8"), dict(compute_mode="faithful", stack_mode="ring"),
    dict(scheme="cyccoded", num_collect=None, scan_unroll=6),
], ids=["agd", "gd", "adam", "pipelined", "deduped", "deep", "mlp", "int8", "ring",
        "cyccoded_unroll6"])
def test_round_body_run_hit_and_disabled(kw, data):
    first = trainer.train(_cfg(**kw), data, device="cpu")
    hit = trainer.train(_cfg(**kw), data, device="cpu")
    with graphs.disabled():
        eager = trainer.train(_cfg(**kw), data, device="cpu")
    assert _same_run(first, hit) and _same_run(first, eager)
    assert _exec(first) == [0, 1] and _exec(hit) == [1, 0] and _exec(eager) == [0, 0]


def test_round_body_chunks_and_resume(data, tmp_path):
    eager = trainer.train(_cfg(), data, device="cpu")
    chunked = trainer.train(_cfg(), data, device="cpu", checkpoint_dir=str(tmp_path / "a"),
                            checkpoint_every=7)
    resumed = trainer.train(_cfg(), data, device="cpu", checkpoint_dir=str(tmp_path / "a"),
                            checkpoint_every=7, resume=True)
    assert _exec(chunked) == [0, 2]
    assert _same_run(eager, chunked)
    assert resumed.start_round == 14 and _exec(resumed) == [1, 0]
    assert torch.equal(resumed.params_history, eager.params_history[14:])


@pytest.mark.parametrize("kw", [dict(), dict(scheme="cyccoded", num_collect=None),
                                dict(model="deepmlp", update_rule="GD", lr_schedule=0.5,
                                     layer_coding="on")], ids=["approx", "cyccoded", "deep"])
def test_round_body_dynamic_run_hit_and_disabled(kw, data):
    first = trainer.train_dynamic(_cfg(**kw), data, device="cpu")
    hit = trainer.train_dynamic(_cfg(**kw), data, device="cpu")
    with graphs.disabled():
        eager = trainer.train_dynamic(_cfg(**kw), data, device="cpu")
    assert _same_run(first, hit) and _same_run(first, eager)
    assert first.cache_info["executor"] == "cpu" and _exec(hit) == [1, 0]


def test_dynamic_float32_solve_stays_eager_by_name(data, monkeypatch):
    """A rule without a decode table (C(W, s) past the table's cap: randreg
    collecting 15 of 30 on the card) takes the float32 solve, whose SVD
    synchronises with the host: the run keeps its eager loop, by name."""
    from erasurehead_tpu_torch.ops import codes

    cfg = _cfg(scheme="randreg", rounds=3)
    tabled = trainer.train_dynamic(cfg, data, device="cpu")
    monkeypatch.setattr(codes, "build_decode_table", lambda *a, **k: None)
    solved = trainer.train_dynamic(cfg, data, device="cpu")
    assert tabled.cache_info["executor"] == "cpu"
    assert solved.cache_info["executor"] == "eager"
    assert "pinv" in solved.cache_info["eager_reason"] and _exec(solved) == [0, 0]


@pytest.mark.parametrize("kw", [dict(compute_mode="deduped"), dict(),
                                dict(update_rule="ADAM", lr_schedule=0.05),
                                dict(model="deepmlp", update_rule="GD", lr_schedule=0.5,
                                     layer_coding="on")],
                         ids=["deduped", "faithful", "adam", "deep"])
def test_round_body_cohort_run_hit_and_disabled(kw, data):
    cfgs = [_cfg(seed=s, **kw) for s in (0, 1, 2)]
    first = trainer.train_cohort(cfgs, data, device="cpu")
    hit = trainer.train_cohort(cfgs, data, device="cpu")
    with graphs.disabled():
        eager = trainer.train_cohort(cfgs, data, device="cpu")
    assert all(_same_run(a, b) and _same_run(a, c) for a, b, c in zip(first, hit, eager))
    assert first[0].cache_info["executor"] == "cpu" and _exec(first[0]) == [0, 1]
    assert _exec(hit[0]) == [1, 0] and eager[0].cache_info["executor"] == "eager"


def test_eager_executor_rows_outputs_and_launch_tally():
    """The uncaptured executor calls the round body once a round with row i
    of every table and writes its outputs at row i; a program refuses a
    device that is not CUDA; a replay adds the captured tally."""
    def round_fn(carry, row, consts):
        new = carry["x"] + row["v"] * consts["k"]
        return {"x": new}, (new, row["v"])

    hist, seen = torch.empty(7), torch.empty(7)
    final = graphs.run_eager(round_fn, {"x": torch.ones(())}, {"v": torch.arange(7.0)},
                             {"k": torch.tensor(1.0)}, (hist, seen))
    assert float(final["x"]) == 1 + 21 and hist.tolist() == [1, 2, 4, 7, 11, 16, 22]
    assert seen.tolist() == list(range(7))
    with pytest.raises(ValueError, match="CUDA"):
        graphs.Program(round_fn, {"x": torch.zeros(())}, {"v": torch.arange(2.0)}, {},
                       n=2, unroll=1)
    tally = {}
    with kernels.recording(tally):
        kernels._count_launch("fused_glm_grad")
    kernels.reset_launches()
    kernels.add_launches(tally)
    kernels.add_launches(tally)
    assert tally == {"fused_glm_grad": 1} and kernels.LAUNCHES["fused_glm_grad"] == 2
    kernels.reset_launches()


# ---------------------------------------------------------------------------
# donation: the JAX package's contracts


@pytest.fixture(params=["cpu", "disabled"])
def executor(request):
    if request.param == "disabled":
        with graphs.disabled():
            yield request.param
    else:
        yield request.param


def _cached_stacks():
    return [t for data, _ in cache._data_cache.values() for t in _leaves(data[:2])
            if isinstance(t, torch.Tensor)]


def test_donating_run_never_donates_cached_stacks(data, executor):
    first = trainer.train(_cfg(donate="on"), data, device="cpu")
    assert first.cache_info["donation"] is True
    stacks = _cached_stacks()
    assert stacks and not any(isinstance(t, graphs.Donated) for t in stacks)
    second = trainer.train(_cfg(donate="on"), data, device="cpu")
    assert second.cache_info["data_hit"]
    assert second.cache_info["exec_hits"] == (1 if executor == "cpu" else 0)
    assert _same_run(first, second)
    assert all(torch.isfinite(t.float()).all() for t in _cached_stacks())


def test_donation_is_bitwise_invisible(data, executor):
    on = trainer.train(_cfg(donate="on"), data, device="cpu")
    off = trainer.train(_cfg(donate="off"), data, device="cpu")
    assert (on.cache_info["donation"], off.cache_info["donation"]) == (True, False)
    assert _same_run(on, off)
    auto = trainer.train(_cfg(), data, device="cpu")
    assert auto.cache_info["donation"] is trainer.DONATE_DEFAULT


def test_auto_donation_resolves_to_the_default():
    """The JAX package turns auto off under its persistent compilation
    cache; the port writes no executable to disk, so auto is the default."""
    assert trainer._resolve_donate(_cfg()) is trainer.DONATE_DEFAULT is True
    assert trainer._resolve_donate(_cfg(donate="on")) is True
    assert trainer._resolve_donate(_cfg(donate="off")) is False


def test_donation_checkpoint_chunked_path(data, tmp_path, executor):
    on = trainer.train(_cfg(rounds=12, donate="on"), data, device="cpu",
                       checkpoint_dir=str(tmp_path / "on"), checkpoint_every=5)
    off = trainer.train(_cfg(rounds=12, donate="off"), data, device="cpu",
                        checkpoint_dir=str(tmp_path / "off"), checkpoint_every=5)
    assert _same_run(on, off)


def test_donation_cohort_bitwise(data, executor):
    cfgs = [_cfg(compute_mode="deduped", donate="on", seed=s) for s in (0, 1)]
    on = trainer.train_cohort(cfgs, data, device="cpu")
    off = trainer.train_cohort([dataclasses.replace(c, donate="off") for c in cfgs], data,
                               device="cpu")
    assert on[0].cache_info["donation"] is True
    assert all(_same_run(a, b) for a, b in zip(on, off))
    assert not any(isinstance(t, graphs.Donated) for t in _cached_stacks())
    rerun = trainer.train_cohort(cfgs, data, device="cpu")
    assert rerun[0].cache_info["data_hit"]
    assert all(_same_run(a, b) for a, b in zip(on, rerun))


def test_donation_survives_oom_bisection_and_cache_drop(data, monkeypatch, executor):
    """A donating sweep whose first cohort runs out of memory: the harness
    drops the data cache's pins (with the programs holding them) and
    bisects; the rows match the sequential sweep's."""
    configs = {f"{s}_d": _cfg(scheme=s, compute_mode="deduped", donate="on",
                              num_collect=8 if s == "approx" else None)
               for s in ("naive", "avoidstragg", "approx", "cyccoded")}
    off_rows = experiments.compare(dict(configs), data, batch="off", device="cpu")
    dropped = cache._METRICS.counter("sweep_cache.data_dropped_bytes").value
    real, seen = trainer.train_cohort, []

    def oom_once(cfgs, *a, **k):
        if not seen:
            seen.append(True)
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
        return real(cfgs, *a, **k)

    monkeypatch.setattr(trainer, "train_cohort", oom_once)
    rows = experiments.compare(dict(configs), data, batch="on", device="cpu")
    assert cache._METRICS.counter("sweep_cache.data_dropped_bytes").value > dropped
    got = {r.label: r for r in rows}
    for row in off_rows:
        np.testing.assert_allclose(got[row.label].final_train_loss, row.final_train_loss,
                                   rtol=1e-4)


@pytest.mark.parametrize("entry", ["train", "train_dynamic"])
def test_a_read_after_donation_raises(data, entry, executor):
    run = getattr(trainer, entry)
    lr = _cfg().resolve_lr_schedule()
    p1 = run(_cfg(rounds=4, lr_schedule=lr[:4]), data, device="cpu")
    kept = run(_cfg(rounds=4, lr_schedule=lr[:4]), data, device="cpu")
    run(_cfg(lr_schedule=lr, donate="on"), data, device="cpu",
        initial_state=p1.final_state, initial_round=4)
    with pytest.raises(RuntimeError, match="donated"):
        p1.final_params + 1
    with pytest.raises(RuntimeError, match="donated"):
        np.asarray(p1.final_state.params)
    assert torch.isfinite(p1.params_history).all()  # the history is a copy
    run(_cfg(lr_schedule=lr, donate="off"), data, device="cpu",
        initial_state=kept.final_state, initial_round=4)
    assert torch.isfinite(kept.final_params + 1).all()


# ---------------------------------------------------------------------------
# the donation-safety lint on JAX's fixtures, restated for the port

DONATION_BAD = '''
"""donation-safety violation: a donated carry read after the donating call."""

from erasurehead_tpu_torch.train import graphs
from erasurehead_tpu_torch.train.graphs import donates


@donates(0, 1)
def run(state, weights):
    return state, weights


def train(state0, xs, weights):
    final, _ = run(state0, weights)
    return final, state0  # state0's storage was released: invalid read


def train_bound(state0, xs):
    step = donates(0)(lambda s, x: s)
    out = step(state0, xs)  # a name bound to a donating function
    return out + state0  # read after donation through the binding
'''

DONATION_OK = '''
"""Clean counterpart: consume-and-replace rebinding, copies passed as
fresh expressions, and the trainers' initial_state restart idiom."""

import torch

from erasurehead_tpu_torch.train import trainer
from erasurehead_tpu_torch.train.graphs import donates


@donates(0, 1)
def run(state, weights):
    return state, weights


def train(state0, xs, weights):
    run(state0.clone(), weights.clone())  # a warm-up on clones
    state = state0
    for chunk in (xs, xs):
        state, _ = run(state, weights[: len(chunk)])  # rebind from the result
    return state


def restart(cfg, ds, state, chunks):
    for lo in chunks:
        res = trainer.train(cfg, ds, initial_state=state, initial_round=lo if state else 0)
        state = res.final_state
    return state
'''


def test_donation_lint_on_the_restated_fixtures(tmp_path):
    bad, ok = tmp_path / "donation_bad.py", tmp_path / "donation_ok.py"
    bad.write_text(textwrap.dedent(DONATION_BAD))
    ok.write_text(textwrap.dedent(DONATION_OK))
    findings = [f for f in runner.lint_paths([str(bad)]).unsuppressed
                if f.checker == "donation-safety"]
    assert len(findings) >= 2  # the decorated call and the bound donating name
    assert all("state0" in f.message for f in findings)
    assert runner.lint_paths([str(ok)]).unsuppressed == []


def test_donation_lint_flags_a_trainer_restart_read(tmp_path):
    src = tmp_path / "restart_bad.py"
    src.write_text(textwrap.dedent('''
        from erasurehead_tpu_torch.train import trainer


        def restart(cfg, ds, state):
            res = trainer.train(cfg, ds, initial_state=state, initial_round=4)
            return res, state.params
    '''))
    findings = runner.lint_paths([str(src)], checkers=["donation-safety"]).unsuppressed
    assert len(findings) == 1 and "'state'" in findings[0].message
    assert "keyword 'initial_state'" in findings[0].message


def test_shipped_tree_lints_clean_with_the_fifth_checker():
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(trainer.__file__)))
    report = runner.lint_paths([pkg])
    assert report.unsuppressed == []
    assert "donation-safety" in runner.CHECKERS
    assert {"train", "train_dynamic", "release", "run"} <= set(runner.LintContext.load().donating)


def test_exec_cache_bytes_bound_and_capture_oom_retry(monkeypatch):
    """The cache keeps its programs' pinned bytes under EXEC_CACHE_BYTES
    (least recently used first, the newest always kept), and a capture
    that runs out of memory drops the cached programs and captures once
    more; a second failure propagates."""
    class Entry:
        holds = ()

        def __init__(self, nbytes):
            self.nbytes = nbytes

    monkeypatch.setattr(cache, "EXEC_CACHE_BYTES", 100)
    for k in range(3):
        cache.get_or_compile(("k", k), lambda: (Entry(40), 0.0))
    assert list(cache._exec_cache) == [("k", 1), ("k", 2)] and cache.exec_cache_bytes() == 80
    cache.get_or_compile(("big",), lambda: (Entry(500), 0.0))
    assert list(cache._exec_cache) == [("big",)]
    calls = []

    def oom_once():
        calls.append(1)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
        return Entry(1), 0.0

    entry, hit = cache.get_or_compile(("after",), oom_once)
    assert not hit and len(calls) == 2 and list(cache._exec_cache) == [("after",)]

    def oom_always():
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")

    cache._exec_cache.clear()
    with pytest.raises(torch.cuda.OutOfMemoryError):
        cache.get_or_compile(("never",), oom_always)


def test_the_shared_pool_is_counted_once_while_held(monkeypatch):
    """The executable cache's pinned bytes are its programs' static buffers
    plus each shared graph pool once, and a pool no program holds counts
    nothing (its handle is taken anew at the next capture)."""
    import types

    class Entry:
        holds = ()

        def __init__(self, nbytes):
            self.nbytes = nbytes

    held = types.SimpleNamespace(holders={object()}, reserved=700)
    free = types.SimpleNamespace(holders=set(), reserved=500)
    monkeypatch.setattr(graphs, "_pools", {0: held, 1: free})
    assert graphs.pool_bytes() == 700
    cache.get_or_compile(("a",), lambda: (Entry(10), 0.0))
    cache.get_or_compile(("b",), lambda: (Entry(20), 0.0))
    assert cache.exec_cache_bytes() == 10 + 20 + 700


def test_admission_charges_and_evicts_the_programs(monkeypatch, tmp_path):
    """The serve daemon's admission charges the executable cache's pins
    (static buffers and the shared pool) beside the data cache's, and an
    evict verdict drops the programs too, reporting their bytes."""
    import json
    import types

    from erasurehead_tpu_torch.serve import admission

    pinned = {"bytes": 600}
    dropped = []
    monkeypatch.setattr(cache, "exec_cache_bytes", lambda: pinned["bytes"])

    def drop():
        dropped.append(pinned["bytes"])
        pinned["bytes"] = 0
        return 1

    monkeypatch.setattr(cache, "drop_executables", drop)
    ctl = admission.AdmissionController(budget_bytes=1000)
    monkeypatch.setattr(ctl, "charge_for", lambda cohort, width=None: 500)
    cohort = types.SimpleNamespace(key_digest="c0", requests=[None])
    path = str(tmp_path / "events.jsonl")
    with t_events.capture(path):
        assert ctl.try_admit(cohort, "d1")  # idle, 600 + 500 over: evict, then admit
        pinned["bytes"] = 600
        assert ctl.try_admit(cohort, "d2")  # 500 + 600 + 500 over, the pins close it
        pinned["bytes"] = 600
        assert not ctl.try_admit(cohort, "d3")  # 1000 in flight: defer, pins kept
    assert dropped == [600, 600] and pinned["bytes"] == 600
    recs = [json.loads(line) for line in open(path)]
    assert [r["released_bytes"] for r in recs if r["type"] == "evict"] == [600, 600]
    assert [r["admitted"] for r in recs if r["type"] == "admit"] == [True, True, False]


@pytest.mark.parametrize("model,fmt,executor", [
    ("logistic", "padded", "cpu"), ("logistic", "fields", "cpu"),
    ("mlp", "fields", "cpu"), ("mlp", "padded", "eager"), ("deepmlp", "padded", "eager"),
])
def test_sparse_stacks_graph_or_eager_by_name(model, fmt, executor):
    """The closed-form GLMs' sparse plans are statics of the stack and
    capture (the CPU counts them as its executable); an autodiff family's
    PaddedRows gather sizes its gradient's scatter plan on the host every
    round (a capture is invalidated on the card), so that pair keeps the
    eager loop, named, before any lookup; the round body is the same."""
    rows, cols = 480, 60
    data = generate_onehot(rows, cols, W, n_fields=4, seed=0)
    cfg = _cfg(model=model, n_rows=rows, n_cols=cols, sparse_format=fmt, rounds=4,
               update_rule="GD", lr_schedule=0.5)
    res = trainer.train(cfg, data, device="cpu")
    with graphs.disabled():
        eager = trainer.train(cfg, data, device="cpu")
    assert res.cache_info["executor"] == executor
    assert (res.cache_info["eager_reason"] is None) == (executor == "cpu")
    assert _exec(res) == ([0, 1] if executor == "cpu" else [0, 0])
    assert _same_run(eager, res)


def test_the_key_consults_the_tune_cache_without_records(data, tmp_path):
    """The executable key resolves the lowering knobs again after the run
    has: its consultation writes no ``tune`` record, so a run's records are
    the eager run's (a deep auto run that resolves treewise records
    layer_coding alone)."""
    import json

    cfg = _cfg(model="deepmlp", update_rule="GD", lr_schedule=0.5, block_decode="auto",
               rounds=3)
    kinds = {}
    for mode in ("cpu", "eager"):
        t_tune.reset_emitted()
        path = str(tmp_path / f"{mode}.jsonl")
        with t_events.capture(path):
            if mode == "eager":
                with graphs.disabled():
                    trainer.train(cfg, data, device="cpu")
            else:
                trainer.train(cfg, data, device="cpu")
        kinds[mode] = sorted(r["race"] for r in map(json.loads, open(path))
                             if r["type"] == "tune")
    assert kinds["cpu"] == kinds["eager"] == ["layer_coding"]
