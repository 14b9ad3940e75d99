"""The port's shard store, stream-window plans and streaming knobs against
the JAX package's.

Oracles, all exact (host numpy on both sides):
  - a store written by each package from the same data: the same files,
    byte for byte (shards, labels, int8 scales, eval split, metadata), and
    each package reads the other's store bitwise, with the same digest,
    cache token and partition bytes; JAX's refusals message for message;
  - ``plan_stream_windows`` over every built-in scheme's layout at W = 6 and
    every window dividing P, deduped and materialized: ranges, halo,
    slot-groups and local assignment equal, or the same refusal;
  - ``_stream_group_slot_weights`` byte-equal over schemes and windows;
    ``parse_bytes``, ``resolve_stream_budget`` and
    ``_resolve_stream_window`` equal over a grid; the config's residency
    validation with JAX's messages.
"""

import numpy as np
import pytest

from erasurehead_tpu.data import sharding as j_sharding
from erasurehead_tpu.data import store as j_store
from erasurehead_tpu.data.synthetic import generate_gmm as j_generate_gmm
from erasurehead_tpu.train import journal as j_journal
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.utils import config as j_config
from erasurehead_tpu_torch.data import sharding as t_sharding
from erasurehead_tpu_torch.data import store as t_store
from erasurehead_tpu_torch.data.synthetic import Dataset, generate_gmm
from erasurehead_tpu_torch.train import cache as t_cache
from erasurehead_tpu_torch.train import journal as t_journal
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils import chaos as t_chaos
from erasurehead_tpu_torch.utils import config as t_config

P, ROWS, COLS = 4, 198, 8  # 49 rows a partition, 2 trailing rows dropped


@pytest.fixture(scope="module")
def data():
    return generate_gmm(ROWS, COLS, n_partitions=2, seed=0), j_generate_gmm(
        ROWS, COLS, n_partitions=2, seed=0)


def _write_both(data, tmp_path, **kw):
    tdir, jdir = tmp_path / "t", tmp_path / "j"
    t_store.write_store(data[0], str(tdir), P, **kw)
    j_store.write_store(data[1], str(jdir), P, **kw)
    return tdir, jdir


@pytest.mark.parametrize("kw", [
    {}, dict(stack_dtype="int8"), dict(group=3), dict(stack_dtype="int8", group=1),
], ids=["f32", "int8", "f32_group3", "int8_group1"])
def test_store_files_equal_jax(data, tmp_path, kw):
    tdir, jdir = _write_both(data, tmp_path, **kw)
    names = sorted(p.name for p in jdir.iterdir())
    assert sorted(p.name for p in tdir.iterdir()) == names
    assert "store_meta.json" in names and "X_test.npy" in names
    for name in names:
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name


@pytest.mark.parametrize("stack_dtype", ["float32", "int8"])
def test_each_package_reads_the_other_store(data, tmp_path, stack_dtype):
    tdir, jdir = _write_both(data, tmp_path, stack_dtype=stack_dtype, group=3)
    for reader, other in ((t_store, jdir), (j_store, tdir)):
        mine = reader.open_store(str(other))
        theirs = (j_store if reader is t_store else t_store).open_store(str(other))
        assert mine.digest == theirs.digest == j_journal.dataset_digest(data[1])
        assert mine.cache_token == theirs.cache_token
        assert mine.partition_bytes() == theirs.partition_bytes()
        # a read straddling shards, and a wrapped two-range span
        for ranges in (((1, 4),), ((3, 4), (0, 2))):
            a, b = mine.read_ranges(ranges), theirs.read_ranges(ranges)
            for x, z in zip(a, b):
                for u, v in zip(*(([x.q, x.scale], [z.q, z.scale]) if hasattr(x, "q")
                                  else ([x], [z]))):
                    assert u.dtype == v.dtype and u.tobytes() == np.asarray(v).tobytes()
        dt, dj = mine.dataset(), theirs.dataset()
        for field in ("X_train", "y_train", "X_test", "y_test"):
            x, z = getattr(dt, field), getattr(dj, field)
            assert x.dtype == z.dtype and x.tobytes() == np.asarray(z).tobytes(), field
        assert t_journal.dataset_digest(dt) == j_journal.dataset_digest(dj)
        assert t_cache.dataset_token(dt) == mine.cache_token
        if stack_dtype == "int8":
            assert dt._store_prequantized.q.tobytes() == dj._store_prequantized.q.tobytes()


def test_store_int8_tables_are_the_resident_quantizer(data, tmp_path):
    """The write-time tables are what the resident int8 stacking computes:
    a full-cover int8 run reuses them (trainer._build_stack)."""
    st = t_store.write_store(data[0], str(tmp_path / "q"), P, stack_dtype="int8")
    ds = st.dataset()
    lay = t_trainer.build_layout(t_config.RunConfig(n_workers=P, n_stragglers=1,
                                                    stack_dtype="int8"))
    X, _, _ = t_trainer._build_stack(
        t_config.RunConfig(n_workers=P, n_stragglers=1, stack_dtype="int8",
                           compute_mode="deduped"), ds, lay, False, "cpu")
    ref = t_store.QuantizedStack.quantize(
        data[0].X_train[: P * (ROWS // P)].reshape(P, ROWS // P, COLS))
    assert X.q.numpy().tobytes() == ref.q.tobytes()
    assert X.scale.numpy().tobytes() == ref.scale.tobytes()


def _refusal(fn_t, fn_j, exc=ValueError):
    with pytest.raises(exc) as got:
        fn_t()
    with pytest.raises(exc) as want:
        fn_j()
    assert str(got.value) == str(want.value)
    return str(got.value)


def test_store_refusals_match_jax(data, tmp_path):
    for kw in (dict(stack_dtype="int4"),):
        _refusal(lambda: t_store.write_store(data[0], str(tmp_path / "a"), P, **kw),
                 lambda: j_store.write_store(data[1], str(tmp_path / "b"), P, **kw))
    _refusal(lambda: t_store.write_store(data[0], str(tmp_path / "a"), ROWS + 1),
             lambda: j_store.write_store(data[1], str(tmp_path / "b"), ROWS + 1))
    _refusal(lambda: t_store.write_store(data[0], str(tmp_path / "a"), P, group=-1),
             lambda: j_store.write_store(data[1], str(tmp_path / "b"), P, group=-1))
    sparse = Dataset(X_train=__import__("scipy.sparse").sparse.csr_matrix(data[0].X_train),
                     y_train=data[0].y_train, X_test=data[0].X_test, y_test=data[0].y_test)
    msg = _refusal(lambda: t_store.write_store(sparse, str(tmp_path / "a"), P),
                   lambda: j_store.write_store(sparse, str(tmp_path / "b"), P))
    assert "dense stacks only" in msg
    # open_store's message names each package's own prepare module
    with pytest.raises(FileNotFoundError, match="erasurehead_tpu_torch.data.prepare"):
        t_store.open_store(str(tmp_path / "nope"))
    tdir, _ = _write_both(data, tmp_path)
    meta = (tdir / "store_meta.json").read_text().replace('"version": 1', '"version": 2')
    (tdir / "store_meta.json").write_text(meta)
    _refusal(lambda: t_store.open_store(str(tdir)), lambda: j_store.open_store(str(tdir)))
    st = t_store.open_store(str(tmp_path / "j"))
    for ranges in ((), ((0, 5),), ((3, 3),)):
        _refusal(lambda: st.read_ranges(ranges),
                 lambda: j_store.open_store(str(tmp_path / "j")).read_ranges(ranges))


# ---------------------------------------------------------------------------
# stream-window plans

KNOBS = {
    "approx": dict(num_collect=3), "randreg": dict(num_collect=3),
    "sparsegraph": dict(num_collect=3), "expander": dict(num_collect=3),
    "deadline": dict(deadline=0.5),
    "partialcyccoded": dict(partitions_per_worker=4),
    "partialrepcoded": dict(partitions_per_worker=4),
}
SCHEMES = t_config.Scheme.__members__.values()


def _layouts(scheme, **kw):
    kw = dict(scheme=scheme, n_workers=6, n_stragglers=1, **KNOBS.get(scheme, {}), **kw)
    return (t_trainer.build_layout(t_config.RunConfig(**kw)),
            j_trainer.build_layout(j_config.RunConfig(**kw)))


def _plan_or_message(mod, layout, window, mode):
    try:
        return mod.plan_stream_windows(layout, window, mode=mode)
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("scheme", [s.value for s in SCHEMES])
def test_plan_stream_windows_matches_jax(scheme):
    tl, jl = _layouts(scheme)
    n_part = int(tl.n_partitions)
    for window in [w for w in range(1, n_part + 1) if n_part % w == 0] + [0, n_part + 1]:
        for mode in ("deduped", "materialized", "ring", "bogus"):
            got = _plan_or_message(t_sharding, tl, window, mode)
            want = _plan_or_message(j_sharding, jl, window, mode)
            if isinstance(want, str):
                assert got == want, (window, mode)
                continue
            for f in ("mode", "n_partitions", "window", "n_windows", "halo",
                      "group_workers", "ranges", "staged_partitions"):
                assert getattr(got, f) == getattr(want, f), (window, mode, f)
            if want.local_assignment is None:
                assert got.local_assignment is None
            else:
                a, b = got.local_assignment, np.asarray(want.local_assignment)
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _sub_or_message(plan):
    try:
        return plan.sub_layout()
    except ValueError as e:
        return str(e)


def test_ring_windows_wait_for_the_ring_transport():
    """The ring transport of stream windows, which this test once found
    refused: every ring plan's sub-layout and its ring plan on 1, 2 and 3
    ranks equal JAX's, field by field, for every window of the swept
    schemes; a full-cover plan localizes to the identity, so its ring plan
    is the resident one byte for byte; a deduped plan's sub_layout()
    refuses with JAX's message."""
    n_plans = 0
    for scheme in [s.value for s in SCHEMES]:
        tl, jl = _layouts(scheme)
        n_part = int(tl.n_partitions)
        for window in [w for w in range(1, n_part + 1) if n_part % w == 0]:
            got = _plan_or_message(t_sharding, tl, window, "ring")
            want = _plan_or_message(j_sharding, jl, window, "ring")
            if isinstance(want, str):
                assert got == want
                continue
            n_plans += 1
            ts, js = got.sub_layout(), want.sub_layout()
            for f in ("n_workers", "n_slots", "n_partitions"):
                assert getattr(ts, f) == getattr(js, f), (scheme, window, f)
            assert ts.assignment.tobytes() == np.asarray(js.assignment).tobytes()
            for D in (1, 2, 3):
                try:
                    jr = j_sharding.plan_ring_transport(js, D)
                except ValueError as e:
                    with pytest.raises(ValueError) as err:
                        t_sharding.plan_ring_transport(ts, D)
                    assert str(err.value) == str(e)
                    continue
                rp = t_sharding.plan_ring_transport(ts, D)
                assert (rp.n_devices, rp.n_hops) == (jr.n_devices, jr.n_hops)
                assert rp.sel.tobytes() == np.asarray(jr.sel).tobytes()
            if window == n_part:  # full cover: the resident ring plan
                assert got.halo == 0
                for D in (1, 2):
                    if int(tl.n_workers) % D or n_part % D:
                        continue
                    assert t_sharding.plan_ring_transport(ts, D).sel.tobytes() == \
                        t_sharding.plan_ring_transport(tl, D).sel.tobytes()
    assert n_plans > 20
    tl, jl = _layouts("cyccoded")
    assert _sub_or_message(t_sharding.plan_stream_windows(tl, 3)) == \
        _sub_or_message(j_sharding.plan_stream_windows(jl, 3))


@pytest.mark.parametrize("scheme", [s.value for s in SCHEMES])
def test_window_shards_split_each_window_over_the_ranks(scheme):
    """Each rank's share of a window (StreamWindowPlan.shard): deduped and
    ring shards are disjoint spans of the staged window in staged order
    whose union is the whole window (ring: window and halo); a materialized
    shard stages exactly the partitions its workers' slots read, and its
    local assignment picks, from what it stages, the partitions the plan's
    local assignment names; a rank outside the group stages nothing."""
    tl, _ = _layouts(scheme)
    n_part, n_work = int(tl.n_partitions), int(tl.n_workers)
    seen = 0
    for window in [w for w in range(1, n_part + 1) if n_part % w == 0]:
        for mode in ("deduped", "materialized", "ring"):
            plan = _plan_or_message(t_sharding, tl, window, mode)
            if isinstance(plan, str):
                continue
            axis = window if mode == "deduped" else plan.group_workers
            for D in [d for d in (1, 2, 3) if axis % d == 0 and (
                    mode != "ring" or plan.staged_partitions % d == 0)]:
                seen += 1
                shards = [plan.shard(d, D) for d in range(D)]
                outside = plan.shard(None, D)
                assert outside.n_partitions == 0
                assert all(r == () for r in outside.ranges)
                for k in range(plan.n_windows):
                    whole = [p for lo, hi in plan.ranges[k] for p in range(lo, hi)]
                    got = [[p for lo, hi in sh.ranges[k] for p in range(lo, hi)] for sh in shards]
                    assert [len(g) for g in got] == [sh.n_partitions for sh in shards]
                    if mode != "materialized":
                        assert sum(got, []) == whole, (scheme, window, mode, D, k)
                        continue
                    gw = plan.group_workers // D
                    for d, (sh, g) in enumerate(zip(shards, got)):
                        rows = plan.local_assignment[d * gw:(d + 1) * gw]
                        assert sorted(g) == sorted({whole[i] for i in rows.ravel()})
                        assert [[g[i] for i in r] for r in sh.local_assignment] == \
                            [[whole[i] for i in r] for r in rows]
    assert seen > 0 or n_work < 2


@pytest.mark.parametrize("scheme,window,kw", [
    ("cyccoded", 3, dict(n_stragglers=2)), ("cyccoded", 2, {}), ("repcoded", 2, {}),
    ("approx", 3, dict(n_stragglers=2, num_collect=3)), ("naive", 1, {}),
    ("repcoded", 3, dict(n_stragglers=2)), ("avoidstragg", 3, {}), ("expander", 3, {}),
])
def test_stream_group_slot_weights_byte_equal(scheme, window, kw):
    kw = {**dict(scheme=scheme, n_workers=6, n_stragglers=1, rounds=12, add_delay=True,
                 seed=3), **KNOBS.get(scheme, {}), **kw}
    tcfg, jcfg = t_config.RunConfig(**kw), j_config.RunConfig(**kw)
    tl, jl = t_trainer.build_layout(tcfg), j_trainer.build_layout(jcfg)
    arr = j_trainer.default_arrivals(jcfg)
    assert arr.tobytes() == t_trainer.default_arrivals(tcfg).tobytes()
    ts = t_trainer.build_schedule(tcfg, arr, tl)
    from erasurehead_tpu.parallel import collect as j_collect

    js = j_collect.build_schedule(jcfg.scheme, arr, jl, num_collect=jcfg.num_collect,
                                  deadline=jcfg.deadline, decode=jcfg.decode)
    tp = t_sharding.plan_stream_windows(tl, window, mode="materialized")
    jp = j_sharding.plan_stream_windows(jl, window, mode="materialized")
    got = t_trainer._stream_group_slot_weights(tl, tp, ts)
    want = j_trainer._stream_group_slot_weights(jl, jp, js)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# budgets, windows and the config

BYTES = ["1", "1048576", "2g", "512m", "1.5k", " 3T ", "0", "-4", "abc", "", "k", "2.5"]


@pytest.mark.parametrize("val", BYTES)
def test_parse_bytes_matches_jax(val):
    try:
        want = j_config.parse_bytes(val)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            t_config.parse_bytes(val)
        assert str(got.value) == str(e)
    else:
        assert t_config.parse_bytes(val) == want


@pytest.mark.parametrize("flag,env", [
    (None, None), (None, ""), (None, "64m"), ("1g", "64m"), ("", "2k"), ("7", None),
])
def test_resolve_stream_budget_matches_jax(flag, env, monkeypatch):
    assert t_config.STREAM_WINDOW_ENV == j_config.STREAM_WINDOW_ENV
    monkeypatch.delenv(t_config.STREAM_WINDOW_ENV, raising=False)
    assert t_config.resolve_stream_budget(flag, env) == j_config.resolve_stream_budget(flag, env)
    if env is not None:
        monkeypatch.setenv(t_config.STREAM_WINDOW_ENV, env)
    assert t_config.resolve_stream_budget(flag) == j_config.resolve_stream_budget(flag)


@pytest.mark.parametrize("budget", [None, "1", "100", "1000", "5000", "1m"])
@pytest.mark.parametrize("stream_window", [None, 1, 4, 5, 7, 30])
def test_resolve_stream_window_matches_jax(budget, stream_window, monkeypatch):
    monkeypatch.delenv(t_config.STREAM_WINDOW_ENV, raising=False)
    if budget is not None:
        monkeypatch.setenv(t_config.STREAM_WINDOW_ENV, budget)
    kw = dict(n_workers=4, n_stragglers=1, stack_residency="auto", stream_window=stream_window)
    tcfg, jcfg = t_config.RunConfig(**kw), j_config.RunConfig(**kw)
    assert t_trainer._resolve_residency(tcfg) == j_trainer._resolve_residency(jcfg)
    for n_part in (1, 6, 12, 30, 31):
        for part_bytes in (1, 48, 250, 4096):
            assert (t_trainer._resolve_stream_window(tcfg, n_part, part_bytes)
                    == j_trainer._resolve_stream_window(jcfg, n_part, part_bytes))


@pytest.mark.parametrize("kw", [
    dict(stack_residency="disk"), dict(stream_window=2),
    dict(stack_residency="streamed", stream_window=0),
    dict(stack_residency="auto", stream_window=-3),
])
def test_residency_config_refusals_match_jax(kw):
    _refusal(lambda: t_config.RunConfig(**kw), lambda: j_config.RunConfig(**kw))


def test_residency_keys_sit_at_jax_positions():
    kw = dict(stack_residency="streamed", stream_window=3)
    t = t_config.RunConfig(**kw).static_signature_fields()
    j = j_config.RunConfig(**kw).static_signature_fields()
    assert list(t) == [k for k in j if k in t]
    assert t["stack_residency"] == "streamed" and t["stream_window"] == 3
    assert t == {k: j[k] for k in t}
    assert (t_config.RunConfig().static_signature()
            != t_config.RunConfig(stack_residency="streamed").static_signature())


def test_prefetch_chaos_site_is_wired():
    assert "prefetch" in t_chaos.WIRED_SITES and "prefetch" not in t_chaos.UNWIRED_SITES
    assert t_chaos.parse_spec("raise:prefetch:2").site == "prefetch"
