"""Streamed windows and the drivers over train() across processes, against JAX.

Gloo clusters of 2 and 4 CPU processes (tests/test_torch_multiproc._launch:
children of one file-store rendezvous, each running a list of configs, so
each cluster boots once), launched from threads while this process runs the
JAX package's references on a CPU mesh of as many devices:

  - streamed deduped, materialized and ring windows (``train``), and a
    streamed cohort of five schemes (deduped) and of two seeds (ring): on
    2 ranks, and on 4 where the window folds onto 3 (deduped, materialized)
    or 2 (ring: ``gcd(group workers, staged partitions)``) and the other
    ranks add zeros. Params bitwise across ranks, within rtol 1e-5 /
    atol 1e-6 of JAX's ``train``/``train_cohort`` on the same mesh (the
    cohorts within the cohort tests' rtol 2e-5) and of the port's world-1
    run, host series byte-equal across ranks and to JAX's; each rank stages
    only its share of a window (its bytes the world-1 window's share);
  - ``train_adaptive`` under both reward modes (``time_error`` on an
    explicit ``mesh=`` of both ranks): the decisions equal JAX's on a
    2-device mesh and equal across ranks (the ``progress`` reward's
    boundary loss is rank 0's, parallel/backend.agree), params bitwise
    across ranks and within rtol 1e-4 / atol 1e-5 of JAX's;
  - ``train_elastic_online`` whose second epoch (7 survivors of 8) re-folds
    from 2 ranks to 1: decisions, epochs and rows as JAX's, params within
    rtol 1e-4 / atol 1e-5, the journal and the checkpoints written once;
    on an explicit ``mesh=`` of both ranks that epoch refused as JAX's is;
  - ``run_whatif``: rows as JAX's (rtol 1e-4, its own engine test's
    tolerance), equal across ranks, the surface written by rank 0 alone;
  - a tune verdict that one rank's cache file holds and the other's does
    not: both ranks take rank 0's lowering and stay bitwise equal;
  - the CLI (``--stack-residency streamed --stack-mode ring``, ``--adapt
    on``, ``--elastic on``) inside the 2-rank group: one copy of each
    artifact, the timeset bytes of the world-1 run. (The serve daemon across
    ranks is in tests/test_torch_serve_ranks.py.)
"""

import concurrent.futures
import json
import os
import textwrap

import numpy as np
import pytest

from erasurehead_tpu import adapt as j_adapt
from erasurehead_tpu import elastic as j_elastic
from erasurehead_tpu.data.synthetic import generate_gmm as j_generate_gmm
from erasurehead_tpu.parallel.mesh import worker_mesh as j_worker_mesh
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.utils.config import RunConfig as JRunConfig
from erasurehead_tpu.whatif import engine as j_engine
from erasurehead_tpu.whatif import spec as j_spec
from erasurehead_tpu_torch import cli as t_cli
from erasurehead_tpu_torch.data import store as t_store
from erasurehead_tpu_torch.data.synthetic import generate_gmm
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils.config import RunConfig
from test_torch_multiproc import _launch, _ok

TOL = dict(rtol=1e-5, atol=1e-6)
COHORT_TOL = dict(rtol=2e-5, atol=1e-6)
DRIVER_TOL = dict(rtol=1e-4, atol=1e-5)

W8, ROWS8, COLS = 8, 8 * 24, 8
STREAM = dict(scheme="cyccoded", n_workers=W8, n_stragglers=2, rounds=8, n_rows=ROWS8,
              n_cols=COLS, lr_schedule=0.5, update_rule="AGD", add_delay=True, seed=0,
              stack_residency="streamed", stream_window=4)
STREAMED_2 = {
    "dedup": dict(STREAM, compute_mode="deduped", scheme="approx", n_stragglers=1,
                  num_collect=6),
    "mat": dict(STREAM),
    "ring": dict(STREAM, stack_mode="ring"),
    "ring_on": dict(STREAM, stack_mode="ring", ring_pipeline="on"),
    "auto": dict(STREAM, stack_mode="auto"),
}
COHORT_SCHEMES = {"naive": {}, "cyccoded": {}, "repcoded": {},
                  "approx": dict(num_collect=6), "avoidstragg": {}}
COHORTS_2 = {
    "co_dedup": [dict(STREAM, compute_mode="deduped", n_stragglers=1, scheme=s, **x)
                 for s, x in COHORT_SCHEMES.items()],
    "co_ring": [dict(STREAM, stack_mode="ring", seed=s) for s in (0, 1)],
}
ADAPT = dict(scheme="naive", n_workers=W8, n_stragglers=1, rounds=20, n_rows=ROWS8,
             n_cols=COLS, lr_schedule=1.0, add_delay=True, compute_mode="deduped",
             update_rule="GD", seed=0)
ADAPT_ARMS = (("naive", None, None), ("avoidstragg", None, None), ("deadline", None, 1.5))
ADAPT_MODES = ("progress", "time_error")
ADAPT_CHUNK = 5
ELASTIC = dict(scheme="naive", n_workers=W8, n_stragglers=0, rounds=20, n_rows=ROWS8,
               n_cols=COLS, lr_schedule=1.0, update_rule="AGD", add_delay=True, seed=0)
ELASTIC_DEATHS = {7: 7}
ELASTIC_CFG = dict(chunk_rounds=5, death_rounds=3, timeout=4.0)
TUNE = dict(scheme="approx", n_workers=W8, n_stragglers=1, num_collect=6, rounds=4,
            n_rows=ROWS8, n_cols=COLS, lr_schedule=1.0, update_rule="AGD", add_delay=True,
            seed=0)
W12 = dict(STREAM, n_workers=12, n_rows=12 * 16, stream_window=6)
STREAMED_4 = {
    "dedup": dict(W12, compute_mode="deduped", scheme="approx", num_collect=8),
    "mat": dict(W12),
    "ring": dict(W12, stack_mode="ring"),
}
#: the worker group each 4-rank run folds onto (the mesh=None rule)
FOLD_4 = {"dedup": 3, "mat": 3, "ring": 2}
CLI_BASE = ["--rows", str(ROWS8), "--cols", str(COLS), "--add-delay", "--device", "cpu",
            "--quiet", "--rounds", "8", "--workers", str(W8)]
CLI_RUNS = {
    "ring": ["--scheme", "cyccoded", "--stragglers", "2", "--stack-residency", "streamed",
             "--stack-mode", "ring", "--stream-window", "4"],
    "adapt": ["--scheme", "naive", "--stragglers", "1", "--compute-mode", "deduped",
              "--update-rule", "GD", "--adapt", "on", "--adapt-chunk", "4"],
    "elastic": ["--scheme", "naive", "--stragglers", "1", "--elastic", "on",
                "--elastic-chunk", "4", "--kill-workers", "7:2"],
}


def _whatif_spec(m):
    return m.GridSpec(
        policies=(m.PolicySpec("naive"), m.PolicySpec("approx", num_collect=4),
                  m.PolicySpec("cyccoded")),
        n_workers=(6,), n_stragglers=(1,), regimes=(m.RegimeSpec(mean=0.5),),
        n_seeds=2, rounds=8, n_rows=96, n_cols=COLS,
    )


def _jax_init(kw):
    jcfg = JRunConfig(**kw)
    return np.asarray(j_trainer._init_params_f32(jcfg, j_trainer.build_model(jcfg), kw["n_cols"]))


def _whatif_init():
    spec = _whatif_spec(j_spec)
    cfg = next(p.config for p in j_spec.enumerate_points(spec) if p.feasible)
    return np.asarray(j_trainer._init_params_f32(cfg, j_trainer.build_model(cfg), cfg.n_cols))


_PRELUDE = textwrap.dedent("""
    import dataclasses, json, os
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from erasurehead_tpu_torch.parallel import backend

    backend.initialize_distributed(os.environ["EH_INIT"], device="cpu",
                                   timeout_s=float(os.environ["EH_TIMEOUT"]))
    from erasurehead_tpu_torch.data import store as store_lib
    from erasurehead_tpu_torch.train import trainer
    from erasurehead_tpu_torch.utils.config import RunConfig

    RANK = torch.distributed.get_rank()
    spec = json.load(open(os.environ["EH_SPEC"]))
    inits = dict(np.load(os.environ["EH_INITS"]))
    out = {}

    def keep(tag, res):
        out[tag] = res.params_history.numpy()
        for f in ("timeset", "worker_times", "collected", "decode_error"):
            out[f"{tag}:{f}"] = np.asarray(getattr(res, f))
        ci = res.cache_info
        for f in ("stack_mode", "stack_bytes", "stream_staged_partitions", "ring_pipeline"):
            out[f"{tag}:{f}"] = np.array(str(ci.get(f)))
        pf = ci.get("prefetch") or {"bytes": -1, "windows": -1}
        out[f"{tag}:pf_bytes"] = np.array(pf["bytes"])
        out[f"{tag}:pf_windows"] = np.array(pf["windows"])
        out[f"{tag}:lowering"] = np.array(res.lowering)

    def save():
        np.savez(os.path.join(os.environ["EH_OUT"], f"rank{RANK}.npz"), **out)
""")

_CHILD_2 = _PRELUDE + textwrap.dedent("""
    from erasurehead_tpu_torch import adapt, cli, elastic, tune
    from erasurehead_tpu_torch.data.synthetic import generate_gmm
    from erasurehead_tpu_torch.whatif import GridSpec, PolicySpec, RegimeSpec, run_whatif

    ds = store_lib.open_store(spec["store"]).dataset()
    for name, kw in spec["streamed"].items():
        keep(name, trainer.train(RunConfig(**kw), ds, device="cpu", init_params=inits[name]))
    for name, kws in spec["cohorts"].items():
        res = trainer.train_cohort([RunConfig(**k) for k in kws], ds, device="cpu",
                                   init_params=[inits[f"{name}{b}"] for b in range(len(kws))])
        for b, r in enumerate(res):
            keep(f"{name}{b}", r)

    mem = generate_gmm(spec["adapt"]["n_rows"], spec["adapt"]["n_cols"],
                       spec["adapt"]["n_workers"], seed=0)
    arms = [adapt.Arm(s, num_collect=c, deadline=d) for s, c, d in spec["arms"]]
    from erasurehead_tpu_torch.parallel import mesh as mesh_lib

    for mode in spec["adapt_modes"]:
        # time_error on an explicit mesh of both ranks, progress on the auto one
        ares = adapt.train_adaptive(
            RunConfig(**spec["adapt"]), mem, arms=arms,
            controller=adapt.ControllerConfig(chunk_rounds=spec["adapt_chunk"], seed=0,
                                              reward_mode=mode),
            device="cpu", init_params=inits["adapt"],
            mesh=mesh_lib.worker_mesh(2) if mode == "time_error" else None)
        keep(f"adapt_{mode}", ares.result)
        out[f"adapt_{mode}:decisions"] = np.array(json.dumps(ares.decisions))

    root = os.environ["EH_OUT"]
    eres = elastic.train_elastic_online(
        RunConfig(**spec["elastic"]), mem, elastic=elastic.ElasticConfig(**spec["ecfg"]),
        deaths={int(k): v for k, v in spec["deaths"].items()}, device="cpu",
        journal_dir=os.path.join(root, "journal"), checkpoint_dir=os.path.join(root, "ckpt"),
        init_params=inits["elastic"])
    keep("elastic", eres.result)
    out["elastic:decisions"] = np.array(json.dumps(eres.decisions))
    out["elastic:epochs"] = np.array(json.dumps(eres.epochs))
    out["elastic:rows"] = np.array(json.dumps([elastic.science_fields(r) for r in eres.rows]))
    # an explicit mesh of both ranks does not fold the 7 survivors: refused
    try:
        elastic.train_elastic_online(
            RunConfig(**spec["elastic"]), mem, elastic=elastic.ElasticConfig(**spec["ecfg"]),
            deaths={int(k): v for k, v in spec["deaths"].items()}, device="cpu",
            mesh=mesh_lib.worker_mesh(2))
        out["elastic_mesh2:refusal"] = np.array("")
    except ValueError as e:
        out["elastic_mesh2:refusal"] = np.array(str(e))

    ws = spec["whatif"]
    grid = GridSpec(
        policies=tuple(PolicySpec(*p) for p in ws["policies"]), n_workers=(6,),
        n_stragglers=(1,), regimes=(RegimeSpec(mean=0.5),), n_seeds=2, rounds=8, n_rows=96,
        n_cols=ws["n_cols"], target_loss=ws["target_loss"])
    surf = run_whatif(grid, out_dir=os.path.join(root, "surface"), device="cpu",
                      init_params=inits["whatif"])
    out["whatif:rows"] = np.array(json.dumps(surf.rows))

    # a tune verdict only this rank's cache file holds
    tcfg = RunConfig(**spec["tune"])
    tds = generate_gmm(tcfg.n_rows, tcfg.n_cols, tcfg.n_workers, seed=0)
    model, X = trainer.resolved_stack(tcfg, tds, device="cpu")
    sig = tune.glm_fused_signature(X.shape, X.dtype, model.name)
    if RANK == 1:
        tune.get_cache().record("cpu", "glm_fused", sig, "xla")
    out["tune:own_verdict"] = np.array(str(tune.get_cache().lookup("cpu", "glm_fused", sig)))
    keep("tune", trainer.train(tcfg, tds, device="cpu"))

    for name, argv in spec["cli"].items():
        assert cli.main(argv + ["--output-dir", os.path.join(root, "cli_" + name)]) == 0
    save()
""")

_CHILD_4 = _PRELUDE + textwrap.dedent("""
    ds = store_lib.open_store(spec["store"]).dataset()
    for name, kw in spec["streamed"].items():
        keep(name, trainer.train(RunConfig(**kw), ds, device="cpu", init_params=inits[name]))
    save()
""")


def _store(root, kw, name):
    path = os.path.join(root, name)
    t_store.write_store(generate_gmm(kw["n_rows"], COLS, n_partitions=kw["n_workers"], seed=0),
                        path, kw["n_workers"])
    return path


def _jdata(kw):
    return j_generate_gmm(kw["n_rows"], COLS, n_partitions=kw["n_workers"], seed=0)


_JAX: dict = {}


def _jax_refs():
    """Every JAX reference the clusters are held against."""
    jds8 = _jdata(STREAM)
    for name, kw in STREAMED_2.items():
        _JAX[("2", name)] = j_trainer.train(JRunConfig(**kw), jds8, mesh=j_worker_mesh(2),
                                            measure=False)
    for name, kws in COHORTS_2.items():
        _JAX[("2", name)] = j_trainer.train_cohort([JRunConfig(**k) for k in kws], jds8,
                                                   mesh=j_worker_mesh(2), measure=False)
    jmem = j_generate_gmm(ROWS8, COLS, W8, seed=0)
    for mode in ADAPT_MODES:
        _JAX[("adapt", mode)] = j_adapt.train_adaptive(
            JRunConfig(**ADAPT), jmem, arms=[j_adapt.Arm(s, num_collect=c, deadline=d)
                                             for s, c, d in ADAPT_ARMS],
            controller=j_adapt.ControllerConfig(chunk_rounds=ADAPT_CHUNK, seed=0,
                                                reward_mode=mode),
            mesh=j_worker_mesh(2))
    _JAX["elastic"] = j_elastic.train_elastic_online(
        JRunConfig(**ELASTIC), jmem, elastic=j_elastic.ElasticConfig(**ELASTIC_CFG),
        deaths=ELASTIC_DEATHS)
    try:
        j_elastic.train_elastic_online(
            JRunConfig(**ELASTIC), jmem, elastic=j_elastic.ElasticConfig(**ELASTIC_CFG),
            deaths=ELASTIC_DEATHS, mesh=j_worker_mesh(2))
        _JAX["elastic_mesh2"] = ""
    except ValueError as e:
        _JAX["elastic_mesh2"] = str(e)
    jds12 = _jdata(W12)
    for name, kw in STREAMED_4.items():
        _JAX[("4", name)] = j_trainer.train(JRunConfig(**kw), jds12,
                                            mesh=j_worker_mesh(FOLD_4[name]), measure=False)


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stream_mesh"))
    store8, store12 = _store(root, STREAM, "s8"), _store(root, W12, "s12")
    inits2 = {name: _jax_init(kw) for name, kw in STREAMED_2.items()}
    for name, kws in COHORTS_2.items():
        inits2.update({f"{name}{b}": _jax_init(k) for b, k in enumerate(kws)})
    inits2.update(adapt=_jax_init(ADAPT), elastic=_jax_init(ELASTIC), whatif=_whatif_init())
    spec2 = {"store": store8, "streamed": STREAMED_2, "cohorts": COHORTS_2, "adapt": ADAPT,
             "arms": ADAPT_ARMS, "adapt_modes": ADAPT_MODES, "adapt_chunk": ADAPT_CHUNK,
             "elastic": ELASTIC, "ecfg": ELASTIC_CFG,
             "deaths": {str(k): v for k, v in ELASTIC_DEATHS.items()}, "tune": TUNE,
             "cli": {n: CLI_BASE + a for n, a in CLI_RUNS.items()}}
    inits4 = {name: _jax_init(kw) for name, kw in STREAMED_4.items()}
    spec4 = {"store": store12, "streamed": STREAMED_4}
    outs = {2: os.path.join(root, "two"), 4: os.path.join(root, "four")}
    tune_env = {r: {"ERASUREHEAD_TUNE_CACHE": os.path.join(root, f"tune{r}.json")}
                for r in range(2)}
    # the what-if rows are compared at JAX's loss target: the JAX grid runs
    # first, the rest of the references while the clusters run
    _JAX["whatif_first"] = j_engine.run_whatif(_whatif_spec(j_spec))
    jwhatif_target = _JAX["whatif_first"].target_loss
    spec2["whatif"] = {"policies": [("naive",), ("approx", 4), ("cyccoded",)],
                       "n_cols": COLS, "target_loss": jwhatif_target}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        launched = {2: pool.submit(_launch, 2, _CHILD_2, outs[2], spec2, inits2, tune_env),
                    4: pool.submit(_launch, 4, _CHILD_4, outs[4], spec4, inits4)}
        _jax_refs()
        for n in launched:
            _ok(launched[n].result())
    ranks = {n: [dict(np.load(os.path.join(outs[n], f"rank{r}.npz"))) for r in range(n)]
             for n in outs}
    return ranks[2], ranks[4], outs, inits2, store8


def _host_series_equal(a, b, tag):
    for f in ("timeset", "worker_times", "collected", "decode_error"):
        assert a[f"{tag}:{f}"].tobytes() == b[f"{tag}:{f}"].tobytes(), (tag, f)


def _jax_series_equal(rank, tag, want):
    for f in ("timeset", "worker_times", "collected", "decode_error"):
        got, exp = rank[f"{tag}:{f}"], np.asarray(getattr(want, f))
        assert got.tobytes() == exp.astype(got.dtype).tobytes(), (tag, f)


# ---------------------------------------------------------------------------
# streamed windows on 2 ranks


@pytest.mark.parametrize("name", list(STREAMED_2))
def test_two_rank_streamed_matches_jax_and_world_one(clusters, name):
    ranks, _, _, inits2, store8 = clusters
    kw = STREAMED_2[name]
    want = _JAX[("2", name)]
    for r in ranks:
        np.testing.assert_allclose(r[name], np.asarray(want.params_history), **TOL)
        _jax_series_equal(r, name, want)
        assert str(r[f"{name}:stack_mode"]) == want.cache_info["stack_mode"]
        assert str(r[f"{name}:lowering"]) == "fused"
    assert np.array_equal(ranks[0][name], ranks[1][name])
    _host_series_equal(ranks[0], ranks[1], name)
    one = t_trainer.train(RunConfig(**kw), t_store.open_store(store8).dataset(), device="cpu",
                          init_params=inits2[name])
    np.testing.assert_allclose(ranks[0][name], one.params_history.numpy(), **TOL)
    # each rank stages its share of the window and no more
    ci = one.cache_info
    for r in ranks:
        if ci["stack_mode"] == "materialized":
            # its workers' gather, over the partitions those workers read
            assert int(str(r[f"{name}:stack_bytes"])) * 2 == ci["stack_bytes"]
            assert int(str(r[f"{name}:stream_staged_partitions"])) == 4  # of 6 staged
        else:
            assert int(str(r[f"{name}:stack_bytes"])) * 2 == ci["stack_bytes"]
            assert int(r[f"{name}:pf_bytes"]) * 2 == ci["prefetch"]["bytes"]
            assert int(str(r[f"{name}:stream_staged_partitions"])) * 2 == \
                ci["stream_staged_partitions"]
    if name.startswith("ring"):
        assert np.array_equal(ranks[0][name], ranks[0]["mat"])  # JAX's ring == materialized
        assert str(ranks[0][f"{name}:ring_pipeline"]) == (
            "pipelined" if name == "ring_on" else "sequential")


@pytest.mark.parametrize("name", list(COHORTS_2))
def test_two_rank_streamed_cohort_matches_jax(clusters, name):
    ranks, *_ = clusters
    want = _JAX[("2", name)]
    assert len(want) == len(COHORTS_2[name])
    for b, w in enumerate(want):
        tag = f"{name}{b}"
        np.testing.assert_allclose(ranks[0][tag], np.asarray(w.params_history), **COHORT_TOL)
        assert np.array_equal(ranks[0][tag], ranks[1][tag])
        _host_series_equal(ranks[0], ranks[1], tag)
        assert str(ranks[0][f"{tag}:stack_mode"]) == w.cache_info["stack_mode"]
        # each member matches its sequential streamed run on the ranks
    np.testing.assert_allclose(ranks[0]["co_ring0"], ranks[0]["ring"], **COHORT_TOL)


# ---------------------------------------------------------------------------
# the drivers on 2 ranks


@pytest.mark.parametrize("mode", ADAPT_MODES)
def test_two_rank_train_adaptive_matches_jax(clusters, mode):
    ranks, *_ = clusters
    want = _JAX[("adapt", mode)]
    tag = f"adapt_{mode}"
    decisions = [json.loads(str(r[f"{tag}:decisions"])) for r in ranks]
    assert decisions[0] == decisions[1]
    assert [(d["arm"], d["reason"], d["chunk"]) for d in decisions[0]] == \
        [(d["arm"], d["reason"], d["chunk"]) for d in want.decisions]
    if mode == "time_error":
        assert decisions[0] == json.loads(json.dumps(want.decisions))
    assert np.array_equal(ranks[0][tag], ranks[1][tag])
    _host_series_equal(ranks[0], ranks[1], tag)
    _jax_series_equal(ranks[0], tag, want.result)
    np.testing.assert_allclose(ranks[0][tag], np.asarray(want.result.params_history),
                               **DRIVER_TOL)


def test_two_rank_elastic_refolds_and_matches_jax(clusters):
    ranks, _, outs, *_ = clusters
    want = _JAX["elastic"]
    for field in ("decisions", "epochs", "rows"):
        assert str(ranks[0][f"elastic:{field}"]) == str(ranks[1][f"elastic:{field}"])
    assert json.loads(str(ranks[0]["elastic:decisions"])) == json.loads(
        json.dumps(want.decisions))
    epochs = json.loads(str(ranks[0]["elastic:epochs"]))
    assert [e["n_workers"] for e in epochs] == [e["n_workers"] for e in want.epochs] == [8, 7]
    assert np.array_equal(ranks[0]["elastic"], ranks[1]["elastic"])
    _host_series_equal(ranks[0], ranks[1], "elastic")
    _jax_series_equal(ranks[0], "elastic", want.result)
    np.testing.assert_allclose(ranks[0]["elastic"], np.asarray(want.result.params_history),
                               **DRIVER_TOL)
    # rank 0 alone journals and checkpoints: one row per chunk
    rows = json.loads(str(ranks[0]["elastic:rows"]))
    with open(os.path.join(outs[2], "journal", "elastic_journal.jsonl")) as f:
        chunks = [r for r in map(json.loads, f) if r.get("action") == "chunk"]
    assert len(chunks) == len(rows) == 4
    assert sorted(os.listdir(os.path.join(outs[2], "ckpt"))) == [
        "round_10", "round_15", "round_20", "round_5"]


def test_two_rank_elastic_on_an_explicit_mesh_refuses_as_jax(clusters):
    """mesh= is forwarded into every chunk: a mesh of both ranks cannot hold
    the 7 survivors, and both packages refuse that epoch alike."""
    ranks, *_ = clusters
    want = _JAX["elastic_mesh2"]
    assert "n_workers=7" in want
    assert [str(r["elastic_mesh2:refusal"]) for r in ranks] == [want, want]


def test_two_rank_whatif_matches_jax_and_rank_zero_writes(clusters):
    ranks, _, outs, *_ = clusters
    want = _JAX["whatif_first"]
    rows = [json.loads(str(r["whatif:rows"])) for r in ranks]
    assert rows[0] == rows[1]
    assert len(rows[0]) == len(want.rows) == 3
    for a, b in zip(rows[0], want.rows):
        assert (a["label"], a["feasible"], a["n_seeds"], a["n_diverged"], a["reach_fraction"]) \
            == (b["label"], b["feasible"], b["n_seeds"], b["n_diverged"], b["reach_fraction"])
        for k in ("expected_time_to_target", "sim_time_per_round", "final_loss_mean"):
            if b[k] is None:
                assert a[k] is None
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-12)
    surface = sorted(os.listdir(os.path.join(outs[2], "surface")))
    assert surface and not any(n.startswith(".") for n in surface)


def test_tune_verdict_is_rank_zeros(clusters):
    """Rank 1's cache file says the two-pass gradient won; rank 0's has no
    verdict. Every rank takes rank 0's lowering (the fused kernel's), so
    the ranks stay bitwise equal."""
    ranks, *_ = clusters
    assert str(ranks[1]["tune:own_verdict"]) == "xla"
    assert str(ranks[0]["tune:own_verdict"]) == "None"
    assert str(ranks[0]["tune:lowering"]) == str(ranks[1]["tune:lowering"]) == "fused"
    assert np.array_equal(ranks[0]["tune"], ranks[1]["tune"])


@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_two_rank_cli_writes_once(clusters, name, tmp_path, monkeypatch):
    _, _, outs, *_ = clusters
    monkeypatch.setattr(__import__("tempfile"), "tempdir", str(tmp_path))
    got_dir = os.path.join(outs[2], "cli_" + name)
    one_dir = str(tmp_path / "one")
    assert t_cli.main(CLI_BASE + CLI_RUNS[name] + ["--output-dir", one_dir]) == 0
    names = sorted(os.listdir(one_dir))
    assert sorted(os.listdir(got_dir)) == names
    for n in names:
        if n.endswith("timeset.dat"):
            assert open(os.path.join(got_dir, n), "rb").read() == \
                open(os.path.join(one_dir, n), "rb").read()
        elif n.endswith("loss.dat"):
            np.testing.assert_allclose(np.loadtxt(os.path.join(got_dir, n)),
                                       np.loadtxt(os.path.join(one_dir, n)), rtol=1e-5)


# ---------------------------------------------------------------------------
# 4 ranks: the window folds onto 3 (or 2), the other ranks add zeros


@pytest.mark.parametrize("name", list(STREAMED_4))
def test_four_rank_streamed_folds_and_matches_jax(clusters, name):
    ranks = clusters[1]
    want = _JAX[("4", name)]
    fold = FOLD_4[name]
    for r in ranks:
        np.testing.assert_allclose(r[name], np.asarray(want.params_history), **TOL)
        assert np.array_equal(r[name], ranks[0][name])
        _host_series_equal(r, ranks[0], name)
    for i, r in enumerate(ranks):
        staged = int(str(r[f"{name}:stream_staged_partitions"]))
        assert (staged > 0) == (i < fold), (i, staged)
        assert (int(r[f"{name}:pf_windows"]) > 0) == (i < fold)
