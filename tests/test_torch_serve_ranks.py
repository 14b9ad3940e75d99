"""The serve daemon across ranks: a gloo group of 2 CPU processes against the
one-process daemon and the JAX package's daemon.

The cluster (tests/test_torch_multiproc._launch: children of one file-store
rendezvous) runs two phases, both ranks starting every trajectory from the
JAX package's init draw of its seed:

  - ``cli serve --device cpu`` on both ranks: rank 0 serves the socket front
    and a client thread in its process submits wire requests, two that
    pack into one cohort dispatch and one that goes through sequential
    train() (``use_pallas="on"``, the non-batchable path), then interrupts
    rank 0, which drains and releases rank 1;
  - the library daemon (``SweepServer`` on rank 0, ``follow()`` on rank 1)
    with in-process datasets: the arrays cross once per dataset token, a
    dispatch that rank 1 alone fails to prepare fails its request on rank
    0 (naming rank 1's error), and the daemon serves the next.

Both ranks exit 0. Each row equals the one-process daemon's row of the same
request: statuses and simulated clocks exactly, losses within rtol 2e-5 /
atol 1e-6 (the tolerance of the one-process daemon against a local
compare(); the all-reduce adds the ranks' partial sums in another order).
The packed rows are within rtol 1e-4 of the JAX daemon's (its rows against
the one-process daemon's, tests/test_torch_serve.py).
"""

import concurrent.futures
import json
import os
import textwrap
import types

import numpy as np
import pytest
import torch

from erasurehead_tpu.serve import server as j_server
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.utils.config import RunConfig as JRunConfig
from erasurehead_tpu_torch.data.synthetic import generate_gmm
from erasurehead_tpu_torch.models import glm as t_glm
from erasurehead_tpu_torch.obs.metrics import REGISTRY
from erasurehead_tpu_torch.serve import server as serve_server
from erasurehead_tpu_torch.train import cache
from erasurehead_tpu_torch.train import journal as journal_lib
from erasurehead_tpu_torch.utils.config import RunConfig
from test_torch_multiproc import _launch, _ok

W, R, ROWS, COLS = 4, 10, 256, 16
BASE = {"scheme": "naive", "n_workers": W, "n_stragglers": 1, "rounds": R, "n_rows": ROWS,
        "n_cols": COLS, "lr_schedule": 0.5, "add_delay": True, "compute_mode": "deduped"}
#: wire payloads: two that pack, one for the sequential path
WIRE = {
    "naive": dict(BASE),
    "agc": dict(BASE, scheme="approx", num_collect=3, seed=1),
    "fused": dict(BASE, compute_mode="faithful", use_pallas="on", seed=2),
}
#: in-process requests, one dispatch each; rank 1 fails to prepare the third
LIB = {"a": dict(BASE, seed=3), "b": dict(BASE, scheme="approx", num_collect=3, seed=4),
       "broken": dict(BASE, seed=5), "after": dict(BASE, seed=6)}
MAX_COHORT = 4
TOL = dict(rtol=2e-5, atol=1e-6)
JAX_RTOL = 1e-4
#: the idle cluster's collective timeout, and the gap between its requests
#: (longer: a follower that waited in a timed collective would time out)
IDLE_TIMEOUT_S, IDLE_GAP_S = 5.0, 7.5
IDLE_LIB = ("a", "after")

_CHILD = textwrap.dedent("""
    import json, os, signal, threading, time
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from erasurehead_tpu_torch.parallel import backend

    backend.initialize_distributed(os.environ["EH_INIT"], device="cpu",
                                   timeout_s=float(os.environ["EH_TIMEOUT"]))
    from erasurehead_tpu_torch import cli
    from erasurehead_tpu_torch.data.synthetic import generate_gmm
    from erasurehead_tpu_torch.models import glm
    from erasurehead_tpu_torch.serve import server
    from erasurehead_tpu_torch.serve.client import ServeClient
    from erasurehead_tpu_torch.utils.config import RunConfig

    RANK = torch.distributed.get_rank()
    spec = json.load(open(os.environ["EH_SPEC"]))
    inits = dict(np.load(os.environ["EH_INITS"]))
    glm.LogisticModel.init_params = (
        lambda self, seed, F, device="cpu": torch.from_numpy(inits[str(seed)]).to(device))
    root = os.environ["EH_OUT"]
    sock = os.path.join(root, "serve.sock")
    out = {}

    # phase 1: cli serve across both ranks, wire requests on rank 0's socket
    if RANK == 0:
        def client():
            while True:
                try:
                    c = ServeClient(sock)
                    break
                except Exception:
                    time.sleep(0.05)
            for label, payload in spec["wire"].items():
                c.submit("t", label, payload, timeout=60)
            rows = [c.result(timeout=120) for _ in spec["wire"]]
            c.close()
            out["wire"] = {r["label"]: r for r in rows}
            os.kill(os.getpid(), signal.SIGINT)

        threading.Thread(target=client, daemon=True).start()
    assert cli.main(["serve", "--socket", sock, "--device", "cpu", "--window-ms", "300",
                     "--max-cohort", str(spec["max_cohort"])]) == 0

    # phase 2: the library daemon with in-process datasets
    if RANK == 0:
        ds = generate_gmm(spec["rows"], spec["cols"], spec["workers"], seed=0)
        rows = {}
        with server.serving(device="cpu", window_s=0.01, max_cohort=spec["max_cohort"]) as srv:
            for label, kw in spec["lib"].items():
                res = srv.submit(tenant="u", label=label, config=RunConfig(**kw),
                                 dataset=ds).result(timeout=120)
                rows[label] = {"status": res.status, "row": res.row, "error": res.error}
        out["lib"] = rows
    else:
        real, seen = server.SweepServer._message_dataset, []

        def flaky(self, data):
            seen.append(data.get("arrays") is not None)
            if len(seen) == 3:
                raise RuntimeError("rank 1 cannot resolve this dataset")
            return real(self, data)

        server.SweepServer._message_dataset = flaky
        out["followed"] = server.SweepServer(device="cpu").follow()
        out["arrays_sent"] = seen
    with open(os.path.join(root, f"rank{RANK}.json"), "w") as f:
        json.dump(out, f)
""")


#: the idle cluster: the library daemon with a short collective timeout and
#: a gap longer than it between two requests; the ranks meet at files
#: before the group forms, so neither rank's imports eat the timeout
_IDLE_CHILD = textwrap.dedent("""
    import json, os, time
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from erasurehead_tpu_torch.data.synthetic import generate_gmm
    from erasurehead_tpu_torch.models import glm
    from erasurehead_tpu_torch.parallel import backend
    from erasurehead_tpu_torch.serve import server
    from erasurehead_tpu_torch.utils.config import RunConfig

    RANK = int(os.environ["RANK"])
    root = os.environ["EH_OUT"]
    open(os.path.join(root, f"ready{RANK}"), "w").close()
    while not all(os.path.exists(os.path.join(root, f"ready{r}")) for r in range(2)):
        time.sleep(0.01)
    backend.initialize_distributed(os.environ["EH_INIT"], device="cpu",
                                   timeout_s=float(os.environ["EH_TIMEOUT"]))
    spec = json.load(open(os.environ["EH_SPEC"]))
    inits = dict(np.load(os.environ["EH_INITS"]))
    glm.LogisticModel.init_params = (
        lambda self, seed, F, device="cpu": torch.from_numpy(inits[str(seed)]).to(device))
    out = {}
    if RANK == 0:
        ds = generate_gmm(spec["rows"], spec["cols"], spec["workers"], seed=0)
        rows = {}
        with server.serving(device="cpu", window_s=0.01, max_cohort=spec["max_cohort"]) as srv:
            for label, kw in spec["lib"].items():
                res = srv.submit(tenant="u", label=label, config=RunConfig(**kw),
                                 dataset=ds).result(timeout=120)
                rows[label] = {"status": res.status, "row": res.row, "error": res.error}
                time.sleep(spec["idle_s"])
        out["lib"] = rows
    else:
        out["followed"] = server.SweepServer(device="cpu").follow()
    with open(os.path.join(root, f"rank{RANK}.json"), "w") as f:
        json.dump(out, f)
""")


def _jax_init(kw):
    jcfg = JRunConfig(**kw)
    return np.asarray(j_trainer._init_params_f32(jcfg, j_trainer.build_model(jcfg), COLS))


def _summary(row, kw):
    return journal_lib.rehydrate_summary(row, RunConfig(**kw))


def _rows_agree(got, want, tol):
    assert got.status == want.status == "ok"
    assert got.sim_total_time == want.sim_total_time
    np.testing.assert_array_equal(got.timeset, want.timeset)
    np.testing.assert_allclose(got.training_loss, want.training_loss, **tol)
    np.testing.assert_allclose(got.final_auc, want.final_auc, **tol)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The cluster's outputs, and the one-process daemon's and the JAX
    daemon's rows of the same requests (computed while the cluster runs)."""
    out = str(tmp_path_factory.mktemp("serve2"))
    inits = {str(kw.get("seed", 0)): _jax_init(kw) for kw in [*WIRE.values(), *LIB.values()]}
    spec = {"wire": WIRE, "lib": LIB, "max_cohort": MAX_COHORT, "rows": ROWS, "cols": COLS,
            "workers": W}
    idle_out = str(tmp_path_factory.mktemp("serve2idle"))
    idle_spec = {**spec, "lib": {k: LIB[k] for k in IDLE_LIB}, "idle_s": IDLE_GAP_S}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        launched = pool.submit(_launch, 2, _CHILD, out, spec, inits)
        idle = pool.submit(_launch, 2, _IDLE_CHILD, idle_out, idle_spec, inits,
                           timeout_s=IDLE_TIMEOUT_S)
        with j_server.serving(window_s=0.3, max_cohort=MAX_COHORT) as srv:
            handles = {label: srv.submit(tenant="t", label=label, config=JRunConfig(**kw))
                       for label, kw in WIRE.items() if label != "fused"}
            jax_rows = {label: h.result(timeout=300).summary for label, h in handles.items()}
        mp = pytest.MonkeyPatch()
        try:
            mp.setattr(t_glm.LogisticModel, "init_params",
                       lambda self, seed, F, device="cpu": torch.tensor(
                           inits[str(seed)], device=device))
            cache.clear()
            with serve_server.serving(device="cpu", window_s=0.3, max_cohort=MAX_COHORT) as srv:
                handles = {label: srv.submit(tenant="t", label=label, config=RunConfig(**kw))
                           for label, kw in WIRE.items()}
                one_wire = {label: h.result(timeout=120) for label, h in handles.items()}
            ds = generate_gmm(ROWS, COLS, W, seed=0)
            with serve_server.serving(device="cpu", window_s=0.01, max_cohort=MAX_COHORT) as srv:
                one_lib = {label: srv.submit(tenant="u", label=label, config=RunConfig(**kw),
                                             dataset=ds).result(timeout=120)
                           for label, kw in LIB.items()}
        finally:
            mp.undo()
            cache.clear()
        results = launched.result()
        _ok(results)
        idle_results = idle.result()
    ranks = [json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(2)]
    ranks[1]["log"] = results[1][1]
    return ranks, one_wire, one_lib, jax_rows, (idle_results, idle_out)


def test_wire_rows_across_two_ranks_equal_the_one_process_daemons(served):
    """Rank 1 of ``cli serve`` followed both dispatches (the packed cohort
    and the sequential run) and every row is the one-process daemon's."""
    ranks, one_wire, _, _, _ = served
    assert "serve: rank 1 follows rank 0" in ranks[1]["log"]
    assert "serve: rank 1 followed 2 dispatches" in ranks[1]["log"]
    got = ranks[0]["wire"]
    assert sorted(got) == sorted(WIRE)
    for label, kw in WIRE.items():
        assert got[label]["status"] == "ok", got[label]["error"]
        _rows_agree(_summary(got[label]["row"], kw), one_wire[label].summary, TOL)


def test_packed_wire_rows_across_two_ranks_match_the_jax_daemon(served):
    ranks, _, _, jax_rows, _ = served
    for label, want in jax_rows.items():
        got = _summary(ranks[0]["wire"][label]["row"], WIRE[label])
        _rows_agree(got, want, dict(rtol=JAX_RTOL))


def test_in_process_datasets_cross_once_and_a_rank_failure_fails_its_cohort(served):
    """Rank 1 follows all four dispatches; the dataset's arrays crossed with
    the first only. Rank 1's failure to prepare the third fails that request
    on rank 0 with rank 1's error, and the daemon serves the fourth."""
    ranks, _, one_lib, _, _ = served
    assert ranks[1]["followed"] == len(LIB)
    assert ranks[1]["arrays_sent"] == [True, False, False, False]
    got = ranks[0]["lib"]
    broken = got.pop("broken")
    assert broken["status"] == "error"
    assert "rank 1: RuntimeError: rank 1 cannot resolve this dataset" in broken["error"]
    for label, res in got.items():
        assert res["status"] == "ok", res["error"]
        _rows_agree(_summary(res["row"], LIB[label]), one_lib[label].summary, TOL)


def test_a_follower_rank_cannot_start_the_fronts(monkeypatch):
    """In a world of two, the rank that is not rank 0 follows: start()
    refuses, and rank 0 cannot follow."""
    monkeypatch.setattr(serve_server.backend_lib, "world_size", lambda: 2)
    monkeypatch.setattr(serve_server.backend_lib, "is_writer", lambda: False)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda *a: 1)
    with pytest.raises(RuntimeError, match="call follow"):
        serve_server.SweepServer(device="cpu").start()
    monkeypatch.setattr(serve_server.backend_lib, "is_writer", lambda: True)
    with pytest.raises(RuntimeError, match="call start"):
        serve_server.SweepServer(device="cpu").follow()


def test_a_follower_outlives_an_idle_gap_longer_than_the_timeout(served):
    """The followers wait for the next dispatch in a group with no timeout
    (parallel/backend.untimed_group): with a collective timeout of
    IDLE_TIMEOUT_S and a longer gap between two requests, both are served,
    their rows are the one-process daemon's, rank 1 followed both, and both
    ranks exit 0."""
    _, _, one_lib, _, (results, out) = served
    _ok(results)
    ranks = [json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(2)]
    assert ranks[1]["followed"] == len(IDLE_LIB)
    got = ranks[0]["lib"]
    assert sorted(got) == sorted(IDLE_LIB)
    for label, res in got.items():
        assert res["status"] == "ok", res["error"]
        _rows_agree(_summary(res["row"], LIB[label]), one_lib[label].summary, TOL)


def _handle(ds):
    return types.SimpleNamespace(pooled=False, request=types.SimpleNamespace(dataset=ds))


def test_followers_keep_the_dataset_tokens_rank0_keeps():
    """Rank 0 resends a dataset's arrays once the followers have dropped its
    token; both sides hold at most RANK_DATASETS_MAX tokens and drop the same
    ones, so a follower always holds the dataset a message names, as one
    object per token."""
    cap = serve_server.RANK_DATASETS_MAX
    datasets = [generate_gmm(16, 4, 2, seed=k) for k in range(cap + 2)]
    lead = serve_server.SweepServer(device="cpu")
    follower = serve_server.SweepServer(device="cpu")
    order = [*range(cap + 2), cap + 1, 0, 1, 0]
    sent = []
    for k in order:
        data = lead._data_spec(_handle(datasets[k]))
        sent.append(data["arrays"] is not None)
        follower._take_message({"evict": False, "data": data})
        got = follower._message_dataset(data)
        np.testing.assert_array_equal(got.X_train, datasets[k].X_train)
        assert follower._message_dataset(data) is got
        assert list(follower._rank_datasets) == list(lead._sent_tokens)
        assert len(lead._sent_tokens) <= cap
    # 0 and 1 were the least recently used when cap + 1 distinct tokens came
    assert sent == [True] * (cap + 2) + [False, True, True, False]


def test_an_admission_eviction_reaches_the_followers(monkeypatch):
    """An admission eviction on rank 0 (``serve.evictions``) since the last
    broadcast rides on the next dispatch message, once, and a follower
    drops its caches' pins for it."""
    lead = serve_server.SweepServer(device="cpu")
    ds = generate_gmm(16, 4, 2, seed=0)
    msgs = []
    for evict in (True, False):
        if evict:
            REGISTRY.counter("serve.evictions").inc()
        msg = {"op": "dispatch"}
        assert lead._lead(msg, _handle(ds), lambda: 7) == 7
        msgs.append(msg)
    assert [m["evict"] for m in msgs] == [True, False]
    dropped = []
    monkeypatch.setattr(serve_server.cache_lib, "drop_data_cache", lambda: dropped.append(1))
    follower = serve_server.SweepServer(device="cpu")
    for m in msgs:
        follower._take_message(m)
    assert dropped == [1]
