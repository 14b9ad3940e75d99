"""The ring transport of stream windows in one process, against the JAX package.

A faithful streamed run whose transport resolves to the ring (``stack_mode``
"ring", or "auto" on a redundant layout: JAX's ``_resolve_stream_ring``)
stages each window partition-major, window plus halo, and rebuilds the
slot-group's worker slots every round through the ring transport of the
plan's sub-layout. Oracles:

  - the resolved transport as JAX's, for every ``stack_mode`` on redundant
    and non-redundant layouts: ``cache_info["stack_mode"]``, the
    ``run_start`` record's ``stack_mode``, the ``data_upload`` record's
    ``ring`` and every ``prefetch`` record's plan fields and ranges, and the
    staged window's bytes (the W = 6 cyccoded window-3 run under "auto" is
    the config whose transport the port once resolved to "materialized");
  - windowed ring runs from each package's store of the same data, the port
    started from JAX's init draw: params within rtol 1e-5 / atol 1e-6 of
    JAX's ``train`` (JAX's ring and materialized runs are bitwise equal, the
    port's ring runs the fused kernel's plain version on the rebuilt slots),
    the control plane byte-equal, the plan fields and the prefetcher's
    windows and bytes equal;
  - a full-cover ring window bitwise the port's resident ring run (its
    sub-plan is the resident plan), float32 and int8;
  - a streamed ring cohort within the cohort tests' rtol 2e-5 / atol 1e-6 of
    its members' sequential streamed runs; at full cover bitwise the
    resident ring cohort;
  - the refusals that stay, message for message with JAX's: the forced
    kernel with the ring, a 2-D mesh, a mesh that does not fold the window;
  - ``estimate_stack_bytes`` charging a ring window staged, as JAX's does.

The runs across processes are in tests/test_torch_stream_mesh.py.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from erasurehead_tpu.data import store as j_store
from erasurehead_tpu.data.synthetic import generate_gmm as j_generate_gmm
from erasurehead_tpu.obs import events as j_events
from erasurehead_tpu.parallel.mesh import worker_mesh as j_worker_mesh
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.utils import config as j_config
from erasurehead_tpu_torch.data import store as t_store
from erasurehead_tpu_torch.data.synthetic import generate_gmm
from erasurehead_tpu_torch.obs import events as t_events
from erasurehead_tpu_torch.parallel import mesh as mesh_lib
from erasurehead_tpu_torch.train import cache as t_cache
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils import config as t_config

W, ROWS, COLS, ROUNDS = 6, 6 * 32, 8, 8
TOL = dict(rtol=1e-5, atol=1e-6)
COHORT_TOL = dict(rtol=2e-5, atol=1e-6)
PLAN_FIELDS = ("residency", "stream_window", "n_windows", "stream_halo",
               "stream_group_workers", "stack_mode", "stack_bytes", "ring_pipeline")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(t_config.STREAM_WINDOW_ENV, raising=False)
    t_cache.clear()


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Each package's store of the same data, float32 and int8."""
    root = tmp_path_factory.mktemp("ring_stores")
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
        n_cols=COLS, lr_schedule=0.5, update_rule="GD", add_delay=True, seed=0,
        stack_residency="streamed", stream_window=3,
    )
    base.update(kw)
    return base


def _init(jcfg):
    return np.asarray(j_trainer._init_params_f32(jcfg, j_trainer.build_model(jcfg), COLS))


def _records(path):
    return [json.loads(ln) for ln in open(path).read().splitlines() if ln.strip()]


def _of(recs, kind):
    return [r for r in recs if (r.get("type") or r.get("event")) == kind]


# ---------------------------------------------------------------------------
# the resolved transport (the repair: "auto" resolves as JAX's does)

TRANSPORTS = [
    ("cyccoded_auto", dict(stack_mode="auto")),
    ("cyccoded_ring", dict(stack_mode="ring")),
    ("cyccoded_materialized", dict(stack_mode="materialized")),
    ("repcoded_auto", dict(scheme="repcoded", stack_mode="auto")),
    ("naive_auto", dict(scheme="naive", n_stragglers=1, stack_mode="auto", stream_window=2)),
    ("approx_auto", dict(scheme="approx", num_collect=4, stack_mode="auto")),
]


@pytest.mark.parametrize("name,kw", TRANSPORTS, ids=[t[0] for t in TRANSPORTS])
def test_stream_transport_resolves_as_jax(stores, name, kw, tmp_path):
    tdir, jdir = stores["float32"]
    full = _kw(**kw)
    jcfg, tcfg = j_config.RunConfig(**full), t_config.RunConfig(**full)
    jpath, tpath = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    with j_events.capture(jpath):
        want = j_trainer.train(jcfg, j_store.open_store(jdir).dataset())
    with t_events.capture(tpath):
        got = t_trainer.train(tcfg, t_store.open_store(tdir).dataset(), device="cpu",
                              init_params=_init(jcfg))
    mode = want.cache_info["stack_mode"]
    if name == "cyccoded_auto":
        assert mode == "ring"  # the config the port once resolved otherwise
    assert got.cache_info["stack_mode"] == mode
    for f in PLAN_FIELDS:
        assert got.cache_info[f] == want.cache_info[f], f
    for f in ("windows", "bytes"):
        assert got.cache_info["prefetch"][f] == want.cache_info["prefetch"][f], f
    np.testing.assert_allclose(got.params_history.numpy(), np.asarray(want.params_history),
                               **TOL)
    jrec, trec = _records(jpath), _records(tpath)
    assert _of(trec, "run_start")[0]["stack_mode"] == _of(jrec, "run_start")[0]["stack_mode"]
    assert _of(trec, "data_upload")[0]["ring"] == _of(jrec, "data_upload")[0]["ring"] == (
        mode == "ring")
    tpre, jpre = _of(trec, "prefetch"), _of(jrec, "prefetch")
    assert len(tpre) == len(jpre) >= 2
    for a, b in zip(tpre, jpre):
        for f in ("plan_mode", "halo", "group_workers", "ranges", "bytes", "window"):
            assert a[f] == b[f], f
    assert t_events.validate_lines(open(tpath).read().splitlines()) == []


# ---------------------------------------------------------------------------
# windowed ring runs against JAX's block trainer

WINDOWED = [
    ("cyccoded_w3", dict(), "float32"),
    ("cyccoded_w2", dict(stream_window=2, n_stragglers=1), "float32"),
    ("cyccoded_w3_pipelined", dict(ring_pipeline="on", update_rule="AGD"), "float32"),
    ("repcoded_w3", dict(scheme="repcoded"), "float32"),
    ("repcoded_w2", dict(scheme="repcoded", n_stragglers=1, stream_window=2), "float32"),
    ("approx_w3", dict(scheme="approx", num_collect=4), "float32"),
    ("avoidstragg_w3", dict(scheme="avoidstragg", n_stragglers=1), "float32"),
    ("cyccoded_int8", dict(stack_dtype="int8"), "int8"),
    ("cyccoded_int8_from_f32", dict(stack_dtype="int8", update_rule="AGD"), "float32"),
]


@pytest.mark.parametrize("name,kw,store_dtype", WINDOWED, ids=[w[0] for w in WINDOWED])
def test_windowed_ring_matches_jax(stores, name, kw, store_dtype):
    tdir, jdir = stores[store_dtype]
    full = _kw(stack_mode="ring", **kw)
    jcfg, tcfg = j_config.RunConfig(**full), t_config.RunConfig(**full)
    # each package trains from the store the other wrote
    want = j_trainer.train(jcfg, j_store.open_store(tdir).dataset())
    init = _init(jcfg)
    got = t_trainer.train(tcfg, t_store.open_store(jdir).dataset(), device="cpu",
                          init_params=init)
    again = t_trainer.train(tcfg, t_store.open_store(tdir).dataset(), device="cpu",
                            init_params=init)
    assert got.cache_info["stack_mode"] == want.cache_info["stack_mode"] == "ring"
    dense = tcfg.resolve_stack_dtype() != "int8"
    assert got.lowering == ("fused" if dense else "per_slot")
    np.testing.assert_allclose(got.params_history.numpy(), np.asarray(want.params_history),
                               **TOL)
    assert torch.equal(got.params_history, again.params_history)
    assert got.n_train == want.n_train
    for field in ("timeset", "worker_times", "collected", "decode_error"):
        assert getattr(got, field).tobytes() == np.asarray(getattr(want, field)).tobytes()
    for f in PLAN_FIELDS:
        assert got.cache_info[f] == want.cache_info[f], f
    for f in ("windows", "bytes"):
        assert got.cache_info["prefetch"][f] == want.cache_info["prefetch"][f], f
    # one staged window: window + halo partitions, partition-major
    ci = got.cache_info
    assert ci["stream_staged_partitions"] == ci["stream_window"] + ci["stream_halo"]
    # JAX's ring and materialized windows train alike: so do the port's
    mat = t_trainer.train(dataclasses.replace(tcfg, stack_mode="materialized"),
                          t_store.open_store(tdir).dataset(), device="cpu", init_params=init)
    assert mat.cache_info["stack_mode"] == "materialized"
    assert torch.equal(mat.params_history, got.params_history)


# ---------------------------------------------------------------------------
# full cover: the streamed ring body is the resident ring body


@pytest.mark.parametrize("stack_dtype", ["float32", "int8"])
@pytest.mark.parametrize("pipeline", ["off", "on"])
def test_full_cover_ring_bitwise_resident_ring(stores, stack_dtype, pipeline):
    st = t_store.open_store(stores["int8" if stack_dtype == "int8" else "float32"][0])
    ds = st.dataset()
    cfg = t_config.RunConfig(**_kw(stack_mode="ring", stack_dtype=stack_dtype,
                                   stack_residency="resident", stream_window=None,
                                   ring_pipeline=pipeline))
    r = t_trainer.train(cfg, ds, device="cpu")
    s = t_trainer._train_streamed(dataclasses.replace(cfg, stack_residency="streamed"),
                                  ds, st, W, device="cpu")
    assert r.cache_info["stack_mode"] == s.cache_info["stack_mode"] == "ring"
    assert s.cache_info["stream_halo"] == 0 and s.cache_info["n_windows"] == 1
    assert r.cache_info["ring_pipeline"] == s.cache_info["ring_pipeline"]
    assert r.lowering == s.lowering
    assert torch.equal(r.params_history, s.params_history)
    assert torch.equal(r.final_params, s.final_params)


# ---------------------------------------------------------------------------
# streamed ring cohorts


def test_ring_cohort_matches_sequential(stores):
    ds = t_store.open_store(stores["float32"][0]).dataset()
    for kw in (dict(stack_mode="ring"), dict(stack_mode="auto", scheme="repcoded")):
        cfgs = [t_config.RunConfig(**_kw(seed=s, **kw)) for s in (0, 1, 2)]
        seq = [t_trainer.train(c, ds, device="cpu") for c in cfgs]
        co = t_trainer.train_cohort(cfgs, ds, device="cpu")
        for a, b in zip(seq, co):
            np.testing.assert_allclose(b.params_history.numpy(), a.params_history.numpy(),
                                       **COHORT_TOL)
            assert a.timeset.tobytes() == b.timeset.tobytes()
            assert a.n_train == b.n_train
        ci = co[0].cache_info
        assert ci["cohort_size"] == 3 and ci["cohort_dispatches"] == 1
        assert ci["stack_mode"] == seq[0].cache_info["stack_mode"] == "ring"
        assert co[0].cohort["stack_mode"] == "ring"
        for f in PLAN_FIELDS:
            assert ci[f] == seq[0].cache_info[f], f
        assert ci["prefetch"]["windows"] == seq[0].cache_info["prefetch"]["windows"]


def test_ring_cohort_matches_jax(stores):
    tdir, jdir = stores["float32"]
    kws = [_kw(stack_mode="ring", seed=s) for s in (0, 1)]
    jcfgs = [j_config.RunConfig(**k) for k in kws]
    want = j_trainer.train_cohort(jcfgs, j_store.open_store(jdir).dataset())
    got = t_trainer.train_cohort([t_config.RunConfig(**k) for k in kws],
                                 t_store.open_store(tdir).dataset(), device="cpu",
                                 init_params=[_init(c) for c in jcfgs])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.params_history.numpy(), np.asarray(b.params_history),
                                   **COHORT_TOL)
        assert a.cache_info["stack_mode"] == b.cache_info["stack_mode"] == "ring"


def test_ring_cohort_full_cover_bitwise_resident(stores):
    st = t_store.open_store(stores["float32"][0])
    ds = st.dataset()
    res = [t_config.RunConfig(**_kw(stack_mode="ring", seed=s, stack_residency="resident",
                                    stream_window=None)) for s in (0, 1)]
    streamed = [dataclasses.replace(c, stack_residency="streamed") for c in res]
    a = t_trainer.train_cohort(res, ds, device="cpu")
    b = t_trainer._train_cohort_streamed(streamed, st, W, arrivals=None,
                                         device=torch.device("cpu"), init_params=None,
                                         t_call=0.0)
    for x, y in zip(a, b):
        assert torch.equal(x.params_history, y.params_history)
        assert x.cache_info["stack_mode"] == y.cache_info["stack_mode"] == "ring"


# ---------------------------------------------------------------------------
# refusals that stay, and the admission estimate


def _refusal(fn_t, fn_j):
    with pytest.raises(ValueError) as got:
        fn_t()
    with pytest.raises(ValueError) as want:
        fn_j()
    assert str(got.value) == str(want.value)
    return str(got.value)


def test_ring_refusals_match_jax(stores):
    tdir, jdir = stores["float32"]
    tds, jds = t_store.open_store(tdir).dataset(), j_store.open_store(jdir).dataset()
    # the forced kernel has no ring body (the config's refusal) ...
    _refusal(lambda: t_config.RunConfig(**_kw(stack_mode="ring", use_pallas="on")),
             lambda: j_config.RunConfig(**_kw(stack_mode="ring", use_pallas="on")))
    # ... and no windowed body under "auto"
    kw = _kw(stack_mode="auto", use_pallas="on")
    _refusal(lambda: t_trainer.train(t_config.RunConfig(**kw), tds, device="cpu"),
             lambda: j_trainer.train(j_config.RunConfig(**kw), jds))
    # a mesh that does not fold the slot-group (3 workers on 2 devices)
    two = mesh_lib.WorkerMesh(ranks=(0, 1), world=2)
    for mode in ("ring", "materialized"):
        kw = _kw(stack_mode=mode)
        msg = _refusal(
            lambda: t_trainer.train(t_config.RunConfig(**kw), tds, device="cpu", mesh=two),
            lambda: j_trainer.train(j_config.RunConfig(**kw), jds, mesh=j_worker_mesh(2)))
        assert "stream slot-group workers=3" in msg
    # ring: 4 workers fold onto 2 devices, the 5 staged partitions do not
    # (cyccoded at W = 8, window 4 with halo 1 over a 2-device mesh)
    kw8 = _kw(stack_mode="ring", n_workers=8, n_stragglers=1, stream_window=4, n_rows=8 * 8)
    tds8 = generate_gmm(64, COLS, n_partitions=8, seed=0)
    jds8 = j_generate_gmm(64, COLS, n_partitions=8, seed=0)
    msg = _refusal(
        lambda: t_trainer.train(t_config.RunConfig(**kw8), tds8, device="cpu", mesh=two),
        lambda: j_trainer.train(j_config.RunConfig(**kw8), jds8, mesh=j_worker_mesh(2)))
    assert "staged stream window=5" in msg
    # deduped: the window's partitions must fold
    kw = _kw(compute_mode="deduped", scheme="approx", num_collect=4)
    msg = _refusal(
        lambda: t_trainer.train(t_config.RunConfig(**kw), tds, device="cpu", mesh=two),
        lambda: j_trainer.train(j_config.RunConfig(**kw), jds, mesh=j_worker_mesh(2)))
    assert "stream_window=3" in msg
    # a 2-D mesh has no windowed body: the config's axis is refused with
    # JAX's message, and so is an explicit 2-D mesh
    kw = _kw(model="mlp", tp_shards=2, update_rule="GD")
    _refusal(lambda: t_trainer.train(t_config.RunConfig(**kw), tds, device="cpu"),
             lambda: j_trainer.train(j_config.RunConfig(**kw), jds))
    grid = mesh_lib.WorkerMesh(ranks=(0, 1), world=2, axis_name="model", shards=2)
    with pytest.raises(ValueError, match="no model-parallel"):
        t_trainer.train(t_config.RunConfig(**_kw(stack_mode="ring")), tds, device="cpu",
                        mesh=grid)


@pytest.mark.parametrize("kw", [
    dict(stack_mode="ring"), dict(stack_mode="ring", stream_window=2, n_stragglers=1),
    dict(stack_mode="materialized"), dict(stack_mode="auto"),
    dict(compute_mode="deduped", scheme="approx", num_collect=4),
    dict(stack_mode="ring", stream_window=6), dict(stack_mode="ring", stack_dtype="int8"),
])
def test_estimate_stack_bytes_charges_ring_windows_staged(kw):
    tds = generate_gmm(ROWS, COLS, n_partitions=W, seed=0)
    jds = j_generate_gmm(ROWS, COLS, n_partitions=W, seed=0)
    full = _kw(**kw)
    assert t_trainer.estimate_stack_bytes(t_config.RunConfig(**full), tds) == \
        j_trainer.estimate_stack_bytes(j_config.RunConfig(**full), jds)
