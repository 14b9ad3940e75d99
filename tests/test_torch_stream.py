"""The port's out-of-core streaming (the prefetcher, the windowed and
cohort-streamed trainers, the residency front) against the JAX package's.

Oracles:
  - the Prefetcher's contract as JAX's: in-order ``get`` (JAX's message), a
    staging error raised at the next ``get``, a wedged stage bounded by
    ``close()`` (counted in ``prefetch.join_timeout``, warned once), the
    ``prefetch`` chaos site with JAX's message, and JAX's byte counts;
  - a streamed run whose window covers every partition bitwise the port's
    resident run (f32 and int8, deduped and faithful, exact and AGC);
  - windowed deduped and materialized runs from each package's store of the
    same data, the port started from JAX's init draw: params history within
    rtol 1e-5 / atol 1e-6 of JAX's ``_train_streamed`` (another reduction
    order: the port's ladder takes the fused kernel's plain version),
    control plane byte-equal, plan fields of ``cache_info`` and the
    prefetcher's windows and bytes equal; two runs bitwise;
  - the device-side materialized gather bitwise the host gather JAX does;
  - a streamed cohort within the cohort tests' rtol 2e-5 / atol 1e-6 of its
    members' sequential streamed runs, a full-cover streamed cohort bitwise
    the resident cohort, and a journaled streamed compare failed by
    ``raise:prefetch:N`` and resumed with bitwise rows;
  - every refusal of the slice, message for message with JAX's.
"""

import dataclasses
import threading
import time

import jax
import numpy as np
import pytest
import torch

from erasurehead_tpu.data import prefetch as j_prefetch
from erasurehead_tpu.data import store as j_store
from erasurehead_tpu.data.synthetic import generate_gmm as j_generate_gmm
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.utils import chaos as j_chaos
from erasurehead_tpu.utils import config as j_config
from erasurehead_tpu_torch import cli as t_cli
from erasurehead_tpu_torch.data import prefetch as t_prefetch
from erasurehead_tpu_torch.data import sharding as t_sharding
from erasurehead_tpu_torch.data import store as t_store
from erasurehead_tpu_torch.data.synthetic import generate_gmm
from erasurehead_tpu_torch.obs import metrics as t_metrics
from erasurehead_tpu_torch.ops import features as t_features
from erasurehead_tpu_torch.train import cache as t_cache
from erasurehead_tpu_torch.train import experiments as t_exp
from erasurehead_tpu_torch.train import journal as t_journal
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils import chaos as t_chaos
from erasurehead_tpu_torch.utils import config as t_config

W, ROWS, COLS, ROUNDS = 6, 6 * 32, 8, 8
TOL = dict(rtol=1e-5, atol=1e-6)
COHORT_TOL = dict(rtol=2e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for env in (t_chaos.CHAOS_ENV, t_config.STREAM_WINDOW_ENV):
        monkeypatch.delenv(env, raising=False)
    t_chaos.reset()
    j_chaos.reset()
    t_cache.clear()
    yield
    t_chaos.reset()
    j_chaos.reset()


@pytest.fixture(scope="module")
def data():
    return generate_gmm(ROWS, COLS, n_partitions=W, seed=0)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Each package's store of the same data, float32 and int8, one
    directory each (the files are byte-equal: tests/test_torch_store.py)."""
    root = tmp_path_factory.mktemp("stores")
    src = generate_gmm(ROWS, COLS, n_partitions=W, seed=0)
    jsrc = j_generate_gmm(ROWS, COLS, n_partitions=W, seed=0)
    out = {}
    for dtype in ("float32", "int8"):
        t_store.write_store(src, str(root / f"t_{dtype}"), W, stack_dtype=dtype, group=4)
        j_store.write_store(jsrc, str(root / f"j_{dtype}"), W, stack_dtype=dtype, group=4)
        out[dtype] = (str(root / f"t_{dtype}"), str(root / f"j_{dtype}"))
    return out


def _kw(**kw):
    base = dict(
        scheme="cyccoded", n_workers=W, n_stragglers=2, rounds=ROUNDS, n_rows=ROWS,
        n_cols=COLS, lr_schedule=0.5, update_rule="AGD", add_delay=True, seed=0,
    )
    base.update(kw)
    return base


def _refusal(fn_t, fn_j, exc=ValueError):
    with pytest.raises(exc) as got:
        fn_t()
    with pytest.raises(exc) as want:
        fn_j()
    assert str(got.value) == str(want.value)
    return str(got.value)


# ---------------------------------------------------------------------------
# the prefetcher


def _copy(X, y):
    return t_features.QuantizedStack(X.q.clone(), X.scale.clone()) if isinstance(
        X, t_features.QuantizedStack) else X.clone(), y.clone()


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_prefetcher_in_order_and_bytes_as_jax(stores, dtype):
    tdir, jdir = stores[dtype]
    windows = [(0, 2), ((4, 6), (0, 1)), (2, 5), (0, 2)]
    st = t_store.open_store(tdir)
    with t_prefetch.Prefetcher(st, windows, _copy) as pf:
        _refusal(lambda: pf.get(1), lambda: j_prefetch.Prefetcher(
            j_store.open_store(jdir), windows, lambda X, y: jax.device_put((X, y))).get(1))
        for i, w in enumerate(windows):
            X, y = pf.get(i)
            Xh, yh = st.read_ranges(t_prefetch._norm_window(w))
            assert torch.equal(y, torch.from_numpy(yh))
            got = X.q if dtype == "int8" else X
            assert torch.equal(got, torch.from_numpy(Xh.q if dtype == "int8" else Xh))
    jp = j_prefetch.Prefetcher(j_store.open_store(jdir), windows,
                               lambda X, y: jax.device_put((X, y)))
    for i in range(len(windows)):
        jp.get(i)
    jp.close()
    got, want = pf.stats(), jp.stats()
    assert got["windows"] == want["windows"] == len(windows)
    assert got["bytes"] == want["bytes"]
    assert 0.0 <= got["overlap_efficiency"] <= 1.0


class _FailingStore:
    """Reads window 0, fails on window 1."""

    def __init__(self, store):
        self.store, self.calls = store, 0

    def read_ranges(self, ranges, out=None):
        self.calls += 1
        if self.calls == 2:
            raise OSError("torn shard")
        return self.store.read_ranges(ranges, out=out)


def test_prefetcher_raises_a_staging_error_at_get(stores):
    st = _FailingStore(t_store.open_store(stores["float32"][0]))
    pf = t_prefetch.Prefetcher(st, [(0, 1), (1, 2), (2, 3)], _copy)
    pf.get(0)
    with pytest.raises(OSError, match="torn shard"):
        pf.get(1)
    pf.close()
    assert pf.stats()["windows"] == 1


def test_prefetcher_close_bounds_wedged_stage(capsys):
    """The JAX package's test_prefetcher_close_bounds_wedged_stage: a hung
    stage no longer holds close() forever; the leak is counted and warned
    about once."""
    release = threading.Event()
    entered = threading.Event()

    class WedgedStore:
        def read_ranges(self, ranges, out=None):
            entered.set()
            release.wait()  # a hung shard read
            return np.zeros((1, 2, 2), np.float32), np.zeros((1, 2), np.float32)

    t_metrics.reset_warnings()
    counter = t_metrics.REGISTRY.counter("prefetch.join_timeout")
    before = counter.value
    try:
        for _ in range(2):
            entered.clear()
            pf = t_prefetch.Prefetcher(WedgedStore(), [(0, 1)], _copy)
            # close only once the stage is wedged: a staging thread that a
            # loaded host starts late would see the stop flag and exit in time
            assert entered.wait(5.0)
            t0 = time.monotonic()
            pf.close(join_timeout_s=0.3)
            assert time.monotonic() - t0 < 5.0  # bounded, not forever
            pf.close()  # idempotent
        assert counter.value == before + 2
        assert capsys.readouterr().err.count("did not exit") == 1  # warned once
    finally:
        release.set()  # let the daemon threads finish before teardown


def test_prefetch_chaos_site_fails_the_window_as_jax(stores, monkeypatch):
    monkeypatch.setenv(t_chaos.CHAOS_ENV, "raise:prefetch:2:UNAVAILABLE")
    tdir, jdir = stores["float32"]
    windows = [(0, 1), (1, 2), (2, 3)]
    tp = t_prefetch.Prefetcher(t_store.open_store(tdir), windows, _copy)
    jp = j_prefetch.Prefetcher(j_store.open_store(jdir), windows,
                               lambda X, y: jax.device_put((X, y)))
    tp.get(0)
    jp.get(0)
    _refusal(lambda: tp.get(1), lambda: jp.get(1), exc=RuntimeError)
    tp.close()
    jp.close()


# ---------------------------------------------------------------------------
# full cover == resident, bitwise


@pytest.mark.parametrize("mode", ["faithful", "deduped"])
@pytest.mark.parametrize("scheme,extra", [
    ("repcoded", {}), ("approx", {"num_collect": 4}),
], ids=["exact", "agc"])
@pytest.mark.parametrize("stack_dtype", ["float32", "int8"])
def test_streamed_single_window_bitwise_resident(data, stack_dtype, scheme, extra, mode,
                                                 tmp_path):
    cfg = t_config.RunConfig(**_kw(scheme=scheme, compute_mode=mode,
                                   stack_dtype=stack_dtype, **extra))
    r = t_trainer.train(cfg, data, device="cpu")
    st = t_store.write_store(data, str(tmp_path / "s"), W,
                             stack_dtype="int8" if stack_dtype == "int8" else "float32")
    ds = st.dataset()
    s = t_trainer.train(dataclasses.replace(cfg, stack_residency="streamed"), ds, device="cpu")
    assert r.cache_info["residency"] == "resident" and s.cache_info["residency"] == "streamed"
    assert r.lowering == s.lowering == ("fused" if stack_dtype == "float32" else "per_slot")
    assert torch.equal(r.params_history, s.params_history)
    assert torch.equal(r.final_params, s.final_params)
    # the window plan over every partition is the resident stack too
    d = t_trainer._train_streamed(dataclasses.replace(cfg, stack_residency="streamed"),
                                  ds, st, W, device="cpu")
    assert torch.equal(r.params_history, d.params_history)


# ---------------------------------------------------------------------------
# windowed runs against JAX's block trainer

PLAN_FIELDS = ("residency", "stream_window", "n_windows", "stream_halo",
               "stream_group_workers", "stack_mode", "stack_bytes")
WINDOWED = [
    ("deduped_f32", dict(scheme="approx", num_collect=4, compute_mode="deduped"), "float32", 2),
    ("deduped_int8", dict(scheme="approx", num_collect=4, compute_mode="deduped",
                          stack_dtype="int8"), "int8", 3),
    ("materialized_f32", dict(scheme="cyccoded"), "float32", 3),
    ("materialized_int8", dict(scheme="repcoded", stack_dtype="int8"), "float32", 3),
]


@pytest.mark.parametrize("name,kw,store_dtype,window", WINDOWED, ids=[w[0] for w in WINDOWED])
def test_windowed_matches_jax_train_streamed(stores, name, kw, store_dtype, window):
    tdir, jdir = stores[store_dtype]
    full = _kw(stack_residency="streamed", stream_window=window, **kw)
    jcfg, tcfg = j_config.RunConfig(**full), t_config.RunConfig(**full)
    # each package trains from the store the other wrote
    jds = j_store.open_store(tdir).dataset()
    want = j_trainer.train(jcfg, jds)
    init = np.asarray(j_trainer._init_params_f32(jcfg, j_trainer.build_model(jcfg), COLS))
    ds = t_store.open_store(jdir).dataset()
    got = t_trainer.train(tcfg, ds, device="cpu", init_params=init)
    again = t_trainer.train(tcfg, t_store.open_store(tdir).dataset(), device="cpu",
                            init_params=init)
    assert got.lowering == ("per_slot" if tcfg.resolve_stack_dtype() == "int8" else "fused")
    np.testing.assert_allclose(got.params_history.numpy(), np.asarray(want.params_history),
                               **TOL)
    assert torch.equal(got.params_history, again.params_history)
    assert got.n_train == want.n_train == window * (ROWS // W)
    for field in ("timeset", "worker_times", "collected", "decode_error"):
        assert getattr(got, field).tobytes() == np.asarray(getattr(want, field)).tobytes()
    for f in PLAN_FIELDS:
        assert got.cache_info[f] == want.cache_info[f], f
    for f in ("windows", "bytes"):
        assert got.cache_info["prefetch"][f] == want.cache_info["prefetch"][f], f
    assert got.cache_info["data_hit"] is False and got.cache_info["device_peak_bytes"] is None


@pytest.mark.parametrize("quantize,store_dtype,data_dtype", [
    (False, "float32", torch.float32), (False, "float32", torch.bfloat16),
    (True, "int8", torch.float32), (True, "float32", torch.float32),
])
def test_device_gather_bitwise_host_gather(stores, quantize, store_dtype, data_dtype):
    """The materialized window's worker-major gather on the device equals
    the host gather JAX's put does, bit for bit."""
    st = t_store.open_store(stores[store_dtype][0])
    lay = t_trainer.build_layout(t_config.RunConfig(**_kw()))
    plan = t_sharding.plan_stream_windows(lay, 3, mode="materialized")
    put = t_trainer._make_stream_put(plan, torch.device("cpu"), quantize, data_dtype)
    local = plan.local_assignment
    for ranges in plan.ranges:
        Xh, yh = st.read_ranges(ranges)
        if isinstance(Xh, t_features.QuantizedStack):
            Xt = t_features.QuantizedStack(torch.from_numpy(Xh.q), torch.from_numpy(Xh.scale))
        else:
            Xt = torch.from_numpy(Xh)
        Xd, yd = put(Xt, torch.from_numpy(yh))
        want_y = torch.from_numpy(yh[local]).to(data_dtype).float()
        assert torch.equal(yd, want_y)
        if quantize:
            qs = Xh if isinstance(Xh, t_features.QuantizedStack) else (
                t_features.QuantizedStack.quantize(Xh))
            assert Xd.q.numpy().tobytes() == qs.q[local].tobytes()
            assert Xd.scale.numpy().tobytes() == qs.scale[local].tobytes()
        else:
            assert torch.equal(Xd, torch.from_numpy(Xh[local]).to(data_dtype))
        # fresh tensors: the host buffers may be refilled
        src = Xt.q if isinstance(Xt, t_features.QuantizedStack) else Xt
        out = Xd.q if quantize else Xd
        assert out.untyped_storage().data_ptr() != src.untyped_storage().data_ptr()


# ---------------------------------------------------------------------------
# streamed cohorts


def test_streamed_cohort_matches_sequential(stores):
    ds = t_store.open_store(stores["float32"][0]).dataset()
    for kw in (dict(compute_mode="deduped", scheme="approx", num_collect=4), {}):
        cfgs = [t_config.RunConfig(**_kw(stack_residency="streamed", stream_window=3,
                                         seed=s, **kw)) for s in (0, 1, 2)]
        assert len({t_trainer.cohort_signature(c) for c in cfgs}) == 1
        seq = [t_trainer.train(c, ds, device="cpu") for c in cfgs]
        co = t_trainer.train_cohort(cfgs, ds, device="cpu")
        for a, b in zip(seq, co):
            np.testing.assert_allclose(b.params_history.numpy(), a.params_history.numpy(),
                                       **COHORT_TOL)
            assert a.timeset.tobytes() == b.timeset.tobytes()
            assert a.n_train == b.n_train
        ci = co[0].cache_info
        assert ci["cohort_size"] == 3 and ci["cohort_dispatches"] == 1
        assert ci["cohort_lowering"] == co[0].lowering == "cohort_matmul"
        for f in PLAN_FIELDS:
            assert ci[f] == seq[0].cache_info[f], f
        assert ci["prefetch"]["windows"] == seq[0].cache_info["prefetch"]["windows"]


def test_full_cover_streamed_cohort_bitwise_resident(data):
    res = [t_config.RunConfig(**_kw(seed=s)) for s in (0, 1)]
    streamed = [dataclasses.replace(c, stack_residency="streamed") for c in res]
    a = t_trainer.train_cohort(res, data, device="cpu")
    b = t_trainer.train_cohort(streamed, data, device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x.params_history, y.params_history)
        assert y.cache_info["residency"] == "streamed"


def test_journaled_streamed_compare_resumes_bitwise(stores, tmp_path, monkeypatch):
    """raise:prefetch:N fails the third trajectory's second window; the
    resumed journal sweep rehydrates the first two and gives the
    uninterrupted sweep's rows."""
    ds = t_store.open_store(stores["float32"][0]).dataset()
    configs = {s: t_config.RunConfig(**_kw(scheme=s, compute_mode="deduped",
                                           stack_residency="streamed", stream_window=2,
                                           **({"num_collect": 4} if s == "approx" else {})))
               for s in ("naive", "approx", "avoidstragg")}

    def science(rows):
        return [t_journal.science_row(r.row()) for r in rows]

    base = t_exp.compare(dict(configs), ds, batch="off", device="cpu")
    jdir = str(tmp_path / "j")
    monkeypatch.setenv(t_chaos.CHAOS_ENV, "raise:prefetch:10")
    t_chaos.reset()
    j = t_journal.SweepJournal(jdir)
    with pytest.raises(t_chaos.ChaosInjection, match="prefetch"):
        t_exp.compare(dict(configs), ds, batch="off", journal=j, device="cpu")
    j.close()
    monkeypatch.delenv(t_chaos.CHAOS_ENV)
    j2 = t_journal.SweepJournal(jdir, resume=True)
    assert len(j2) == 2
    resumed = t_exp.compare(dict(configs), ds, batch="off", journal=j2, device="cpu")
    j2.close()
    assert science(resumed) == science(base)
    for a, b in zip(base, resumed):
        assert a.training_loss.tobytes() == b.training_loss.tobytes()


# ---------------------------------------------------------------------------
# refusals, message for message


def _pair(stores, dtype="float32"):
    tdir, jdir = stores[dtype]
    return t_store.open_store(tdir).dataset(), j_store.open_store(jdir).dataset()


@pytest.mark.parametrize("kw", [
    dict(use_pallas="on"), dict(layer_coding="on"),
    dict(scheme="partialcyccoded", n_stragglers=1, partitions_per_worker=4),
])
def test_windowed_refusals_match_jax(stores, kw):
    tds, jds = _pair(stores)
    full = _kw(stack_residency="streamed", stream_window=1, compute_mode="faithful", **kw)
    if kw.get("scheme") == "partialcyccoded":
        tds = generate_gmm(18 * 4, COLS, n_partitions=18, seed=0)
        jds = j_generate_gmm(18 * 4, COLS, n_partitions=18, seed=0)
    _refusal(lambda: t_trainer.train(t_config.RunConfig(**full), tds, device="cpu"),
             lambda: j_trainer.train(j_config.RunConfig(**full), jds))


def test_budget_remedy_and_window_uniformity_match_jax(stores, monkeypatch):
    tds, jds = _pair(stores)
    monkeypatch.setenv(t_config.STREAM_WINDOW_ENV, "1")
    kw = _kw(stack_residency="streamed", compute_mode="deduped", use_pallas="on")
    msg = _refusal(lambda: t_trainer.train(t_config.RunConfig(**kw), tds, device="cpu"),
                   lambda: j_trainer.train(j_config.RunConfig(**kw), jds))
    assert t_config.STREAM_WINDOW_ENV in msg
    monkeypatch.delenv(t_config.STREAM_WINDOW_ENV)
    rr = dict(scheme="randreg", n_workers=6, n_stragglers=2, rounds=2, lr_schedule=0.5,
              update_rule="GD", add_delay=True, seed=0, stack_residency="streamed",
              stream_window=3)
    msg = _refusal(lambda: t_trainer.train(t_config.RunConfig(**rr), tds, device="cpu"),
                   lambda: j_trainer.train(j_config.RunConfig(**rr), jds))
    assert "window-uniform" in msg


def test_store_and_restart_refusals_match_jax(stores, tmp_path):
    tds, jds = _pair(stores)
    multi = _kw(stack_residency="streamed", stream_window=2, compute_mode="deduped")
    ck = dict(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1)
    _refusal(lambda: t_trainer.train(t_config.RunConfig(**multi), tds, device="cpu", **ck),
             lambda: j_trainer.train(j_config.RunConfig(**multi), jds, **ck))
    pipe = dict(multi, scheme="approx", num_collect=4, update_rule="GD", pipeline_depth=1)
    msg = _refusal(lambda: t_trainer.train(t_config.RunConfig(**pipe), tds, device="cpu"),
                   lambda: j_trainer.train(j_config.RunConfig(**pipe), jds),
                   )
    assert "windowed streamed" in msg
    # a quantized store refuses a float32 run, and a store refuses another
    # partition count (the stores sit in one directory for both packages)
    tq, jq = _pair(stores, "int8")
    tq._shard_store.directory = jq._shard_store.directory
    _refusal(lambda: t_trainer.train(t_config.RunConfig(**multi), tq, device="cpu"),
             lambda: j_trainer.train(j_config.RunConfig(**multi), jq))
    tds._shard_store.directory = jds._shard_store.directory
    other = dict(multi, n_workers=3, n_stragglers=1)
    _refusal(lambda: t_trainer.train(t_config.RunConfig(**other), tds, device="cpu"),
             lambda: j_trainer.train(j_config.RunConfig(**other), jds))
    # the block trainer's own int8 refusal, reached directly
    tst = t_store.open_store(stores["int8"][0])
    jst = j_store.open_store(stores["int8"][1])
    _refusal(lambda: t_trainer._train_streamed(t_config.RunConfig(**multi), tq, tst, 2,
                                               device="cpu"),
             lambda: j_trainer._train_streamed(j_config.RunConfig(**multi), jq, jst, 2))


def test_cohort_eligibility_and_signature_as_jax():
    for kw in (dict(stack_residency="streamed", stream_window=1),
               dict(stack_residency="streamed", layer_coding="on"),
               dict(stack_residency="auto", layer_coding="on"), dict()):
        tcfg, jcfg = t_config.RunConfig(**_kw(**kw)), j_config.RunConfig(**_kw(**kw))
        assert t_trainer.cohort_eligible(tcfg) == j_trainer.cohort_eligible(jcfg)
    plain = t_trainer.cohort_signature(t_config.RunConfig(**_kw()))
    streamed = t_trainer.cohort_signature(t_config.RunConfig(**_kw(stack_residency="streamed")))
    assert plain != streamed


def test_cli_residency_flags(tmp_path, monkeypatch):
    # the in-memory dataset is written to a temporary store: keep it here
    monkeypatch.setattr(__import__("tempfile"), "tempdir", str(tmp_path))
    args = ["--scheme", "approx", "--workers", "6", "--stragglers", "1", "--num-collect", "4",
            "--rows", str(ROWS), "--cols", str(COLS), "--rounds", "4", "--add-delay",
            "--compute-mode", "deduped"]
    p = t_cli._flags_parser()
    cfg = t_cli._flags_to_config(p.parse_args(args + ["--stack-residency", "streamed",
                                                      "--stream-window", "2"]))
    assert (cfg.stack_residency, cfg.stream_window) == ("streamed", 2)
    with pytest.raises(SystemExit):
        p.parse_args(args + ["--stack-residency", "disk"])
    with pytest.raises(ValueError, match="no effect under stack_residency='resident'"):
        t_cli._flags_to_config(p.parse_args(args + ["--stream-window", "2"]))
    res, ev, paths = t_cli.run(cfg, output_dir=str(tmp_path), quiet=True, device="cpu")
    assert res.cache_info["n_windows"] == 3 and res.lowering == "fused"
    assert len(ev.training_loss) == 4 and np.isfinite(ev.training_loss).all()
