"""The port's experiment harness (train/experiments.py) against the JAX
package's: cohort planning, compare(), straggler_sweep(), the summary rows
and table, and the dispatch guard.

compare() runs JAX's and the port's harness on the same configs and
arrivals, the port started from JAX's init draws: the rows' control-plane
numbers (simulated clocks, decode error, labels, collect counts) must be
equal, the losses within the cohort tolerance of tests/test_cohort.py
(rtol 2e-5, atol 1e-6). The guard's out-of-memory bisection is held to the
JAX guard's counts under the same injected failure pattern, and so is its
transient retry: a cohort retried with backoff before it degrades, a
sequential run retried alone.
"""

import json

import jax
import numpy as np
import pytest
import torch

from erasurehead_tpu import schemes as j_schemes
from erasurehead_tpu.data.synthetic import generate_gmm as j_generate_gmm
from erasurehead_tpu.obs.metrics import REGISTRY
from erasurehead_tpu.train import experiments as j_exp
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.utils import chaos as j_chaos
from erasurehead_tpu.utils.config import RunConfig as JRunConfig
from erasurehead_tpu_torch import schemes as t_schemes
from erasurehead_tpu_torch.data.synthetic import generate_gmm
from erasurehead_tpu_torch.ops import kernels as t_kernels
from erasurehead_tpu_torch.train import experiments as t_exp
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils import chaos as t_chaos
from erasurehead_tpu_torch.utils.config import RunConfig

W, ROUNDS = 8, 6
N_ROWS, N_COLS = 512, 24
SCHEME_EXTRAS = {
    "naive": {},
    "cyccoded": {},
    "repcoded": {},
    "approx": {"num_collect": 6},
    "avoidstragg": {},
    "randreg": {"num_collect": 6},
    "deadline": {"deadline": 1.0},
}
JAX_COUNTERS = (
    "cohort.dispatches", "cohort.trajectories", "cohort.sequential_runs",
    "cohort.retry", "cohort.split", "cohort.sequential_fallback", "sweep.diverged",
)
#: the guard's degradation counters, which the port counts as JAX does
GUARD_COUNTERS = ("cohort.retry", "cohort.split", "cohort.sequential_fallback")


def _kw(**kw):
    base = dict(
        scheme="approx", n_workers=W, n_stragglers=1, num_collect=6,
        rounds=ROUNDS, n_rows=N_ROWS, n_cols=N_COLS, update_rule="AGD",
        lr_schedule=0.5, add_delay=True, seed=3,
    )
    base.update(kw)
    return base


def _labelled(**common):
    """label -> kwargs: the seven schemes, each with its extras."""
    return {s: _kw(scheme=s, **{**common, **e}) for s, e in SCHEME_EXTRAS.items()}


@pytest.fixture(scope="module")
def data():
    return generate_gmm(N_ROWS, N_COLS, n_partitions=W, seed=0)


@pytest.fixture(scope="module")
def jdata():
    return j_generate_gmm(N_ROWS, N_COLS, n_partitions=W, seed=0)


@pytest.fixture(autouse=True)
def fresh_counters():
    t_exp.reset_counters()
    for name in JAX_COUNTERS:
        REGISTRY.counter(name).reset()
    yield


def _jax_counts():
    return {name: REGISTRY.counter(name).value for name in JAX_COUNTERS}


def _jax_init(jcfg):
    model = j_trainer.build_model(jcfg)
    return jax.tree.map(np.asarray, j_trainer._init_params_f32(jcfg, model, N_COLS))


def _pair(kw_by_label):
    t = {label: RunConfig(**kw) for label, kw in kw_by_label.items()}
    j = {label: JRunConfig(**kw) for label, kw in kw_by_label.items()}
    return t, j


# ---------------------------------------------------------------------------
# planning


def _seeded(common, seeds):
    return {
        f"{s}_seed{sd}": _kw(scheme=s, seed=sd, **{**common, **e})
        for s, e in SCHEME_EXTRAS.items() for sd in seeds
    }


PLAN_SETS = {
    "deduped_7x2": _seeded(dict(compute_mode="deduped"), (0, 1)),
    "faithful_7": _labelled(),
    "mixed_bf16": {
        "a": _kw(compute_mode="deduped"),
        "b16": _kw(compute_mode="deduped", dtype="bfloat16"),
        "c": _kw(compute_mode="deduped", scheme="repcoded"),
    },
    "mixed_pallas_on": {
        "a": _kw(compute_mode="deduped"),
        "on": _kw(compute_mode="deduped", use_pallas="on"),
        "off": _kw(compute_mode="deduped", use_pallas="off", seed=4),
    },
    "mixed_layer_coding": {
        "lc": _kw(compute_mode="deduped", layer_coding="on"),
        "a": _kw(compute_mode="deduped"),
        "lc2": _kw(compute_mode="deduped", layer_coding="on", seed=1),
        "lc_tree": _kw(compute_mode="deduped", layer_coding="on", block_decode="treewise"),
    },
    "mixed_models": {
        "glm": _kw(compute_mode="deduped"),
        "mlp": _kw(compute_mode="deduped", model="mlp"),
        "deep": _kw(compute_mode="deduped", model="deepmlp", deep_layers=2),
        "deep3": _kw(compute_mode="deduped", model="deepmlp", deep_layers=3),
        "partial": _kw(scheme="partialrepcoded", partitions_per_worker=3,
                       compute_mode="deduped"),
    },
}


@pytest.mark.parametrize("name", list(PLAN_SETS))
def test_plan_cohorts_matches_jax(name):
    t, j = _pair(PLAN_SETS[name])
    assert t_exp.plan_cohorts(t) == j_exp.plan_cohorts(j)


def test_the_deduped_seven_by_two_plan_is_one_cohort():
    plan = t_exp.plan_cohorts(_pair(PLAN_SETS["deduped_7x2"])[0])
    assert plan == [(list(PLAN_SETS["deduped_7x2"]), True)]


@pytest.mark.parametrize("name", sorted(t_schemes.names()))
def test_sweep_num_collect_matches_jax(name):
    t, j = t_schemes.get(name).sweep_num_collect, j_schemes.get(name).sweep_num_collect
    assert (t is None) == (j is None)
    if t is not None:
        assert [t(w) for w in (4, 8, 30, 31)] == [j(w) for w in (4, 8, 30, 31)]


# ---------------------------------------------------------------------------
# rows, table, targets


def _summary(mod, cfg, **kw):
    base = dict(
        label="approx", config=cfg, sim_total_time=12.3456789,
        sim_steps_per_sec=0.48612345, real_steps_per_sec=1234.5678,
        final_train_loss=0.123456789, final_test_loss=0.2345678912,
        final_auc=0.87654321, time_to_target=5.4321987,
        training_loss=np.array([0.7, 0.3, 0.123456789]),
        timeset=np.array([1.0, 2.0, 3.0]), decode_error_mean=0.0123456789,
    )
    base.update(kw)
    return mod.RunSummary(**base)


SUMMARY_CASES = {
    "plain": {},
    "diverged": dict(final_train_loss=float("nan"), final_test_loss=float("inf"),
                     final_auc=float("nan"), time_to_target=None, status="diverged"),
    "no_target_no_error": dict(time_to_target=None, decode_error_mean=None),
    "suite_note_cache": dict(suite="1_naive", note="a caveat",
                             cache={"cohort_size": 4, "cohort_dispatches": 1}),
    "long_label": dict(label="a_rather_long_label_beyond_22", final_auc=float("nan")),
}


@pytest.mark.parametrize("case", list(SUMMARY_CASES))
def test_row_and_table_match_jax(case, tmp_path):
    kw = _kw(scheme="cyccoded", n_stragglers=2, num_collect=None)
    t = _summary(t_exp, RunConfig(**kw), **SUMMARY_CASES[case])
    j = _summary(j_exp, JRunConfig(**kw), **SUMMARY_CASES[case])
    assert t.row() == j.row()
    assert t_exp.format_table([t, t]) == j_exp.format_table([j, j])
    t_exp.save_summaries([t], str(tmp_path / "t.json"))
    j_exp.save_summaries([j], str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    json.loads((tmp_path / "t.json").read_text())  # strict JSON, no NaN tokens


@pytest.mark.parametrize(
    "loss,target",
    [
        ([0.9, 0.5, 0.4, 0.45], 0.5),
        ([0.9, 0.8], 0.1),
        ([0.2, 0.1], 0.3),
        ([np.nan, 0.3, 0.2], 0.25),
    ],
)
def test_time_to_target_loss_matches_jax(loss, target):
    ts = np.array([0.5, 1.25, 2.0, 0.75])[: len(loss)]
    loss = np.array(loss)
    assert t_exp.time_to_target_loss(loss, ts, target) == j_exp.time_to_target_loss(loss, ts, target)


@pytest.mark.parametrize(
    "rows",
    [
        {"naive": (0.5, "ok"), "approx": (0.6, "ok")},
        {"naive": (float("nan"), "diverged"), "approx": (0.6, "ok"), "avoidstragg": (0.4, "ok")},
        {"approx": (float("nan"), "diverged")},
        {"approx": (0.3, "ok"), "repcoded": (float("inf"), "ok")},
    ],
)
def test_default_target_loss_matches_jax(rows):
    def sums(mod, cfg_cls):
        cfg = cfg_cls(**_kw())
        return {
            label: _summary(mod, cfg, label=label, final_train_loss=loss, status=status)
            for label, (loss, status) in rows.items()
        }

    assert t_exp._default_target_loss(sums(t_exp, RunConfig)) == j_exp._default_target_loss(
        sums(j_exp, JRunConfig)
    )


@pytest.mark.parametrize(
    "kw_by_label",
    [{}, {"a": _kw(), "b": _kw(rounds=ROUNDS + 2)}, {"a": _kw(), "b": _kw(n_workers=4, num_collect=3)}],
    ids=["empty", "rounds", "workers"],
)
def test_shared_shape_refusals_match_jax(kw_by_label, data):
    t, j = _pair(kw_by_label)
    with pytest.raises(ValueError) as j_err:
        j_exp._validate_shared_shape(j)
    with pytest.raises(ValueError) as t_err:
        t_exp.compare(t, data, device="cpu")
    assert str(t_err.value) == str(j_err.value)


def test_straggler_sweep_refuses_an_empty_grid(data):
    for grid in ({}, {"approx": []}):
        with pytest.raises(ValueError) as j_err:
            j_exp.straggler_sweep(JRunConfig(**_kw()), None, grid)
        with pytest.raises(ValueError) as t_err:
            t_exp.straggler_sweep(RunConfig(**_kw()), data, grid, device="cpu")
        assert str(t_err.value) == str(j_err.value)


# ---------------------------------------------------------------------------
# compare() and straggler_sweep() against the JAX harness


def _rows_match(got, want):
    assert [s.label for s in got] == [s.label for s in want]
    for g, w in zip(got, want):
        gr, wr = g.row(), w.row()
        for key in ("label", "scheme", "n_stragglers", "num_collect", "status",
                    "sim_total_time", "sim_steps_per_sec", "decode_error_mean"):
            assert gr[key] == wr[key], (g.label, key)
        np.testing.assert_allclose(g.training_loss, w.training_loss, rtol=2e-5, atol=1e-6)
        for key in ("final_train_loss", "final_test_loss", "final_auc"):
            np.testing.assert_allclose(gr[key], wr[key], rtol=2e-5, atol=2e-6, err_msg=key)
        assert (g.time_to_target is None) == (w.time_to_target is None)
        if g.time_to_target is not None:
            assert g.time_to_target == w.time_to_target
        np.testing.assert_array_equal(g.timeset, w.timeset)


COMPARE_SETS = {
    "deduped_7x2": (_seeded(dict(compute_mode="deduped"), (0, 1)), "auto"),
    "faithful_7": (_labelled(), "auto"),
    "faithful_7_off": (_labelled(), "off"),
    "deduped_on": ({k: v for k, v in _labelled(compute_mode="deduped").items()
                    if k in ("approx", "naive")}, "on"),
}


@pytest.mark.parametrize("name", list(COMPARE_SETS))
def test_compare_matches_jax(name, data, jdata):
    kw_by_label, batch = COMPARE_SETS[name]
    t, j = _pair(kw_by_label)
    want = j_exp.compare(j, jdata, batch=batch)
    counts = _jax_counts()
    got = t_exp.compare(t, data, batch=batch, device="cpu",
                        init_params={label: _jax_init(c) for label, c in j.items()})
    _rows_match(got, want)
    for name_ in ("cohort.dispatches", "cohort.trajectories", "cohort.sequential_runs"):
        assert t_exp.COUNTERS[name_] == counts[name_], name_
    for g, w in zip(got, want):
        assert (g.cache is not None) == (w.cache.get("cohort_dispatches") is not None)
        if g.cache is not None:
            for key in ("cohort_size", "cohort_lowering", "cohort_dispatches", "stack_mode"):
                assert g.cache[key] == w.cache[key], key


def test_compare_batched_matches_sequential(data):
    t, _ = _pair(_labelled(compute_mode="deduped"))
    batched = t_exp.compare(dict(t), data, batch="auto", device="cpu")
    assert t_exp.COUNTERS["cohort.dispatches"] == 1
    assert t_exp.COUNTERS["cohort.trajectories"] == 7
    t_exp.reset_counters()
    sequential = t_exp.compare(dict(t), data, batch="off", device="cpu")
    assert t_exp.COUNTERS["cohort.dispatches"] == 0
    assert t_exp.COUNTERS["cohort.sequential_runs"] == 7
    for b, s in zip(batched, sequential):
        np.testing.assert_allclose(b.training_loss, s.training_loss, rtol=2e-5, atol=1e-6)
        assert b.decode_error_mean == s.decode_error_mean
        assert b.cache["cohort_size"] == 7 and s.cache is None


def test_compare_reads_the_batching_environment(data, monkeypatch):
    monkeypatch.setenv("ERASUREHEAD_BATCH_TRAJECTORIES", "0")
    t, _ = _pair({k: v for k, v in _labelled(compute_mode="deduped").items()
                  if k in ("approx", "repcoded")})
    t_exp.compare(t, data, device="cpu")
    assert t_exp.COUNTERS["cohort.dispatches"] == 0
    assert t_exp.COUNTERS["cohort.sequential_runs"] == 2


@pytest.mark.parametrize("grid", [{"approx": [1, 3], "cyccoded": [1, 2, 3]}, {"randreg": [1, 2]}])
def test_straggler_sweep_matches_jax(grid, data, jdata):
    base = dict(compute_mode="deduped", num_collect=None, lr_schedule=0.5)
    jbase, tbase = JRunConfig(**_kw(**base)), RunConfig(**_kw(**base))
    want = j_exp.straggler_sweep(jbase, jdata, grid, batch="auto")
    init = {s.label: _jax_init(s.config) for s in want}
    got = t_exp.straggler_sweep(tbase, data, grid, batch="auto", device="cpu", init_params=init)
    assert [s.label for s in got] == [s.label for s in want]
    assert [s.config.num_collect for s in got] == [s.config.num_collect for s in want]
    _rows_match(got, want)


def test_divergence_is_quarantined_as_jax_does(data, jdata):
    kw_by_label = {
        "naive": _kw(scheme="naive", compute_mode="deduped", lr_schedule=1e30,
                     update_rule="GD"),
        "approx": _kw(compute_mode="deduped"),
    }
    t, j = _pair(kw_by_label)
    want = j_exp.compare(j, jdata, batch="off")
    got = t_exp.compare(t, data, batch="off", device="cpu",
                        init_params={label: _jax_init(c) for label, c in j.items()})
    assert [s.status for s in got] == [s.status for s in want] == ["diverged", "ok"]
    assert t_exp.COUNTERS["sweep.diverged"] == REGISTRY.counter("sweep.diverged").value == 1
    assert got[0].time_to_target is None and got[0].row()["final_train_loss"] is None
    assert "diverged" in t_exp.format_table(got)


# ---------------------------------------------------------------------------
# the dispatch guard


@pytest.mark.parametrize("above", [2, 0], ids=["above_two", "always"])
def test_oom_bisection_matches_the_jax_guard(above, data, jdata, monkeypatch):
    """A cohort of more than ``above`` trajectories runs out of memory: the
    port bisects down to sequential train() as the JAX guard does, with its
    split/fallback counts, and the rows equal an undisturbed compare()."""
    labels = ("approx", "repcoded", "naive", "avoidstragg")
    t, j = _pair({k: v for k, v in _labelled(compute_mode="deduped").items() if k in labels})
    init = {label: _jax_init(c) for label, c in j.items()}
    clean = t_exp.compare(dict(t), data, batch="auto", device="cpu", init_params=init)
    t_exp.reset_counters()

    t_real, j_real = t_trainer.train_cohort, j_trainer.train_cohort

    def t_oom(cfgs, *a, **k):
        if len(cfgs) > above:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
        return t_real(cfgs, *a, **k)

    def j_oom(cfgs, *a, **k):
        if len(cfgs) > above:
            raise j_chaos.ChaosInjection("RESOURCE_EXHAUSTED: injected")
        return j_real(cfgs, *a, **k)

    monkeypatch.setattr(t_trainer, "train_cohort", t_oom)
    monkeypatch.setattr(j_trainer, "train_cohort", j_oom)
    want = j_exp.compare(j, jdata, batch="auto")
    got = t_exp.compare(dict(t), data, batch="auto", device="cpu", init_params=init)
    for name in ("cohort.split", "cohort.sequential_fallback"):
        assert t_exp.COUNTERS[name] == REGISTRY.counter(name).value, name
    # the port counts every train_cohort call, the failed ones too (where
    # the JAX package counts inside train_cohort, so a real out-of-memory
    # failure counts there as well; this injected one never reaches it)
    counts = dict(split=1, sequential_fallback=0, dispatches=3, trajectories=8) if above else \
        dict(split=3, sequential_fallback=4, dispatches=7, trajectories=12)
    for name, n in counts.items():
        assert t_exp.COUNTERS[f"cohort.{name}"] == n, name
    _rows_match(got, want)
    for g, c in zip(got, clean):
        np.testing.assert_allclose(g.training_loss, c.training_loss, rtol=2e-5, atol=1e-6)
        assert g.decode_error_mean == c.decode_error_mean


@pytest.mark.parametrize("spec", ["raise:cohort:1:CUDA out of memory",
                                  "raise:cohort:1+:out of memory", "raise:cohort:1"])
def test_injected_cohort_oom_bisects_as_jax(spec, data, jdata, monkeypatch):
    """ERASUREHEAD_CHAOS at site ``cohort`` with an out-of-memory message
    (the default message is RESOURCE_EXHAUSTED): the port's compare()
    bisects as the JAX guard does, with its split and fallback counts, and
    finishes with the rows of an undisturbed compare()."""
    labels = ("approx", "repcoded", "naive", "avoidstragg")
    t, j = _pair({k: v for k, v in _labelled(compute_mode="deduped").items() if k in labels})
    init = {label: _jax_init(c) for label, c in j.items()}
    clean = t_exp.compare(dict(t), data, batch="on", device="cpu", init_params=init)
    t_exp.reset_counters()
    monkeypatch.setenv(t_chaos.CHAOS_ENV, spec)
    for mod in (t_chaos, j_chaos):
        mod.reset()
    want = j_exp.compare(j, jdata, batch="on")
    got = t_exp.compare(dict(t), data, batch="on", device="cpu", init_params=init)
    for name in ("cohort.split", "cohort.sequential_fallback"):
        assert t_exp.COUNTERS[name] == REGISTRY.counter(name).value, name
    assert t_exp.COUNTERS["cohort.split"] >= 1
    _rows_match(got, want)
    for g, c in zip(got, clean):
        np.testing.assert_allclose(g.training_loss, c.training_loss, rtol=2e-5, atol=1e-6)
        assert g.decode_error_mean == c.decode_error_mean


@pytest.fixture
def quick_backoff(monkeypatch):
    for mod in (t_exp, j_exp):
        monkeypatch.setattr(mod, "COHORT_BACKOFF_S", 0.001)


@pytest.mark.parametrize("marker", t_exp._TRANSIENT_MARKERS)
def test_injected_transient_retries_as_jax(marker, data, jdata, monkeypatch, quick_backoff):
    """ERASUREHEAD_CHAOS=raise:cohort:1:<transient marker>: the port's
    compare() retries the same cohort once, as the JAX guard does (one
    ``cohort.retry``, no split), and returns every row, equal to JAX's."""
    labels = ("approx", "repcoded", "naive", "avoidstragg")
    t, j = _pair({k: v for k, v in _labelled(compute_mode="deduped").items() if k in labels})
    init = {label: _jax_init(c) for label, c in j.items()}
    monkeypatch.setenv(t_chaos.CHAOS_ENV, f"raise:cohort:1:{marker}")
    for mod in (t_chaos, j_chaos):
        mod.reset()
    want = j_exp.compare(j, jdata, batch="on")
    got = t_exp.compare(dict(t), data, batch="on", device="cpu", init_params=init)
    for name in GUARD_COUNTERS:
        assert t_exp.COUNTERS[name] == REGISTRY.counter(name).value, name
    assert t_exp.COUNTERS["cohort.retry"] == 1 and t_exp.COUNTERS["cohort.split"] == 0
    # the port counts the failed train_cohort call too
    assert t_exp.COUNTERS["cohort.dispatches"] == 2
    _rows_match(got, want)


def test_sticky_transient_retries_then_degrades_as_jax(data, jdata, monkeypatch,
                                                       quick_backoff):
    """Every cohort dispatch fails with UNAVAILABLE: each cohort retries
    COHORT_MAX_RETRIES times, then bisects down to sequential train(), with
    JAX's retry, split and fallback counts and JAX's rows."""
    labels = ("approx", "repcoded")
    t, j = _pair({k: v for k, v in _labelled(compute_mode="deduped").items() if k in labels})
    init = {label: _jax_init(c) for label, c in j.items()}
    monkeypatch.setenv(t_chaos.CHAOS_ENV, "raise:cohort:1+:UNAVAILABLE")
    for mod in (t_chaos, j_chaos):
        mod.reset()
    want = j_exp.compare(j, jdata, batch="on")
    got = t_exp.compare(dict(t), data, batch="on", device="cpu", init_params=init)
    for name in GUARD_COUNTERS:
        assert t_exp.COUNTERS[name] == REGISTRY.counter(name).value, name
    # the pair, then each half: three dispatches, each retried the cap
    assert t_exp.COUNTERS["cohort.retry"] == 3 * t_exp.COHORT_MAX_RETRIES
    assert t_exp.COUNTERS["cohort.split"] == 1
    assert t_exp.COUNTERS["cohort.sequential_fallback"] == 2
    _rows_match(got, want)


def test_train_one_guarded_retries_a_transient_and_passes_others(data, monkeypatch,
                                                                quick_backoff, tmp_path):
    """The sequential guard: a transient failure of train() is retried
    (``cohort.retry``, a ``cohort_retry`` warning), a transient that
    outlasts COHORT_MAX_RETRIES propagates, and any other failure
    propagates at once."""
    t, _ = _pair({"approx": _kw(compute_mode="deduped")})
    real, fails = t_trainer.train, []

    def flaky(*a, **k):
        if fails:
            raise fails.pop()
        return real(*a, **k)

    monkeypatch.setattr(t_trainer, "train", flaky)
    path = str(tmp_path / "events.jsonl")
    fails[:] = [t_chaos.ChaosInjection("UNAVAILABLE: injected")]
    with t_exp.obs_events.capture(path):
        res = t_exp._train_one_guarded("approx", t, data, None, "cpu", None)
    assert res.params_history.shape[0] == ROUNDS
    assert t_exp.COUNTERS["cohort.retry"] == 1
    kinds = [json.loads(line).get("kind") for line in open(path)]
    assert kinds.count("cohort_retry") == 1
    fails[:] = [t_chaos.ChaosInjection("ABORTED: injected")] * (t_exp.COHORT_MAX_RETRIES + 1)
    with pytest.raises(t_chaos.ChaosInjection, match="ABORTED"):
        t_exp._train_one_guarded("approx", t, data, None, "cpu", None)
    assert t_exp.COUNTERS["cohort.retry"] == 1 + t_exp.COHORT_MAX_RETRIES
    for err in (t_chaos.ChaosInjection("BOOM"),
                RuntimeError("fused_glm_grad launch failed: CUDA error 700 (UNAVAILABLE)"),
                torch.cuda.OutOfMemoryError("CUDA out of memory")):
        fails[:] = [err]
        with pytest.raises(type(err)):
            t_exp._train_one_guarded("approx", t, data, None, "cpu", None)
    assert t_exp.COUNTERS["cohort.retry"] == 1 + t_exp.COHORT_MAX_RETRIES


def test_the_guard_classifies_torch_runtime_failures():
    """The guarded types are the runtime's (and the chaos stand-in); each is
    classified by JAX's markers, a device out-of-memory error always as
    out-of-memory."""
    types = t_exp._guarded_error_types()
    assert t_chaos.ChaosInjection in types and torch.cuda.OutOfMemoryError in types
    assert torch.distributed.DistBackendError in types
    if hasattr(torch, "AcceleratorError"):
        assert torch.AcceleratorError in types
    assert RuntimeError not in types
    kind = t_exp._dispatch_error_kind
    assert kind(torch.cuda.OutOfMemoryError("CUDA error")) == "oom"
    assert kind(torch.distributed.DistBackendError("gloo: UNAVAILABLE peer")) == "transient"
    for marker in t_exp._TRANSIENT_MARKERS:
        assert kind(t_chaos.ChaosInjection(marker)) == j_exp._dispatch_error_kind(
            j_chaos.ChaosInjection(marker)) == "transient"
    assert kind(t_chaos.ChaosInjection("RESOURCE_EXHAUSTED")) == "oom"
    assert kind(t_chaos.ChaosInjection("BOOM")) is None
    assert [t_exp._backoff(a) for a in (1, 2, 3)] == [j_exp._backoff(a) for a in (1, 2, 3)]


@pytest.mark.parametrize("peer, want", [
    (("oom", "OutOfMemoryError: CUDA out of memory"),
     dict(retry=0, split=1, agreements=3, out="c1")),
    (("transient", "ChaosInjection: UNAVAILABLE: injected"),
     dict(retry=1, split=0, agreements=2, out="c2")),
    (("other", "RuntimeError: BOOM"), dict(raises="rank 1: RuntimeError: BOOM", agreements=1)),
], ids=["oom", "transient", "other"])
def test_ranks_take_one_branch_after_each_attempt(peer, want, monkeypatch, quick_backoff):
    """Across ranks each attempt ends in an agreement on its outcome: this
    rank's cohort dispatch succeeds, rank 1's first attempt fails, and this
    rank bisects, retries or raises as rank 1 does, so the ranks'
    collectives go on meeting."""
    cfg = RunConfig(**_kw(compute_mode="deduped"))
    peers, seen = [peer], []

    def every_rank(value):
        seen.append(value)
        return [value, peers.pop() if peers else None]

    monkeypatch.setattr(t_exp.backend_lib, "world_size", lambda: 2)
    monkeypatch.setattr(t_exp.backend_lib, "every_rank", every_rank)
    monkeypatch.setattr(t_trainer, "train_cohort",
                        lambda cfgs, *a, **k: [f"c{len(cfgs)}"] * len(cfgs))
    run = lambda: t_exp._dispatch_cohort(["a", "b"], {"a": cfg, "b": cfg}, None, None,
                                         "cpu", None)
    if "raises" in want:
        with pytest.raises(t_exp.RankAttemptError, match=want["raises"]):
            run()
    else:
        assert run() == {"a": want["out"], "b": want["out"]}
        assert t_exp.COUNTERS["cohort.retry"] == want["retry"]
        assert t_exp.COUNTERS["cohort.split"] == want["split"]
    assert seen == [None] * want["agreements"]


def test_a_rank_failure_joins_the_agreement_before_it_propagates(monkeypatch):
    """Across ranks a failure the guard does not handle is still agreed on
    (the other ranks raise too) and then propagates untouched; a sequential
    run retries a transient of another rank's."""
    cfg = RunConfig(**_kw(compute_mode="deduped"))
    peers, seen = [], []

    def every_rank(value):
        seen.append(value)
        return [value, peers.pop() if peers else None]

    boom = t_chaos.ChaosInjection("BOOM")

    def fail(*a, **k):
        raise boom

    monkeypatch.setattr(t_exp.backend_lib, "world_size", lambda: 2)
    monkeypatch.setattr(t_exp.backend_lib, "every_rank", every_rank)
    monkeypatch.setattr(t_exp, "COHORT_BACKOFF_S", 0.001)
    monkeypatch.setattr(t_trainer, "train_cohort", fail)
    with pytest.raises(t_chaos.ChaosInjection) as raised:
        t_exp._dispatch_cohort(["a"], {"a": cfg}, None, None, "cpu", None)
    assert raised.value is boom and seen == [("other", "ChaosInjection: BOOM")]
    seen.clear()
    peers[:] = [("transient", "DistBackendError: UNAVAILABLE")]
    monkeypatch.setattr(t_trainer, "train", lambda *a, **k: "seq")
    assert t_exp._train_one_guarded("a", {"a": cfg}, None, None, "cpu", None) == "seq"
    assert seen == [None, None] and t_exp.COUNTERS["cohort.retry"] == 1


def test_other_injected_cohort_faults_propagate(data, monkeypatch):
    monkeypatch.setenv(t_chaos.CHAOS_ENV, "raise:cohort:1:BOOM")
    t_chaos.reset()
    t, _ = _pair({k: v for k, v in _labelled(compute_mode="deduped").items()
                  if k in ("approx", "repcoded")})
    with pytest.raises(t_chaos.ChaosInjection, match="BOOM"):
        t_exp.compare(t, data, batch="on", device="cpu")
    assert t_exp.COUNTERS["cohort.split"] == 0


def test_other_failures_propagate_untouched(data, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("fused_block_decode launch failed: CUDA error 700")

    monkeypatch.setattr(t_trainer, "train_cohort", broken)
    t, _ = _pair({k: v for k, v in _labelled(compute_mode="deduped").items()
                  if k in ("approx", "repcoded")})
    with pytest.raises(RuntimeError, match="launch failed"):
        t_exp.compare(t, data, batch="auto", device="cpu")
    assert t_exp.COUNTERS["cohort.split"] == 0
    assert t_exp.COUNTERS["cohort.sequential_fallback"] == 0


def test_compare_without_a_card_raises(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t, _ = _pair({"approx": _kw(compute_mode="deduped"), "naive": _kw(scheme="naive")})
    with pytest.raises(RuntimeError, match="cuda"):
        t_exp.compare(t, data)
    with pytest.raises(RuntimeError, match="cuda"):
        t_exp.straggler_sweep(RunConfig(**_kw()), data, {"approx": [1]})


def test_cpu_compare_launches_no_kernel(data):
    before = dict(t_kernels.LAUNCHES)
    t, _ = _pair({"approx": _kw(compute_mode="deduped", layer_coding="on"),
                  "naive": _kw(scheme="naive", compute_mode="deduped", layer_coding="on")})
    rows = t_exp.compare(t, data, device="cpu")
    assert t_kernels.LAUNCHES == before
    assert all(r.cache["cohort_lowering"] == "layer_block_vmap" for r in rows)
