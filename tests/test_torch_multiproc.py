"""The port across processes: gloo groups of 2 and 4 CPU processes against JAX.

Each cluster is booted once for several configs (a module-scoped fixture per
world size): the children import torch and the port only, join a gloo group
through torchrun's environment (parallel/backend.initialize_distributed) and
save every rank's results; this process runs the JAX package's trainers on
an N-device worker mesh of the test harness's CPU devices, and the port's
world-1 runs, for the reference. Tolerances: JAX's own multi-device trainer
tolerance, rtol 2e-4 / atol 1e-5 (the deep families rtol 5e-4 / atol 5e-5,
as tests/test_torch_layer_coding.py holds them); against the port's world-1
run rtol 1e-5 (the all-reduce adds the ranks' partial sums in another
order); across ranks, ring against materialized and rerun against run,
bitwise. Every spawn has its own time limit and kills its children on
failure.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time
import uuid

import numpy as np
import pytest

from erasurehead_tpu.data.synthetic import generate_gmm as j_generate_gmm
from erasurehead_tpu.parallel import failures as j_failures
from erasurehead_tpu.parallel.mesh import worker_mesh as j_worker_mesh
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.utils.config import RunConfig as JRunConfig
from erasurehead_tpu_torch.data.synthetic import generate_gmm
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils.config import RunConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 240

GLM = dict(n_stragglers=1, rounds=4, n_rows=64, n_cols=16, lr_schedule=1.0,
           update_rule="AGD", add_delay=True, seed=0)
SCENARIOS_2 = {
    "agc": dict(GLM, scheme="approx", n_workers=4, num_collect=3),
    "cyc": dict(GLM, scheme="cyccoded", n_workers=4),
    "dynamic": dict(GLM, scheme="cyccoded", n_workers=4, rounds=6),
    "deep": dict(GLM, scheme="approx", n_workers=4, num_collect=3, rounds=3,
                 model="deepmlp", update_rule="GD", lr_schedule=0.5),
    "elastic": dict(GLM, scheme="deadline", deadline=0.8, n_workers=8, rounds=12,
                    n_rows=256, n_cols=24),
    "measured": dict(GLM, scheme="approx", n_workers=4, num_collect=3, rounds=3,
                     add_delay=False, arrival_mode="measured"),
}
COHORT_SEEDS = (0, 1)
ELASTIC_DEATHS = {3: 5}
W30 = dict(GLM, n_workers=30, n_stragglers=2, rounds=2, n_rows=240)
SCHEMES_30 = {
    "naive": dict(n_stragglers=1),
    "cyccoded": {},
    "repcoded": {},
    "approx": dict(num_collect=15),
    "avoidstragg": {},
    "partialcyccoded": dict(partitions_per_worker=4),
    "partialrepcoded": dict(partitions_per_worker=4),
}
CKPT = dict(GLM, scheme="approx", n_workers=4, num_collect=3, rounds=12)


def _data(kw):
    return generate_gmm(kw["n_rows"], kw["n_cols"], kw["n_workers"], seed=0)


def _jdata(kw):
    return j_generate_gmm(kw["n_rows"], kw["n_cols"], n_partitions=kw["n_workers"], seed=0)


def _jax_init(kw):
    jcfg = JRunConfig(**kw)
    p = j_trainer._init_params_f32(jcfg, j_trainer.build_model(jcfg), kw["n_cols"])
    if isinstance(p, dict):
        return {k: np.asarray(v) for k, v in p.items()}
    return np.asarray(p)


def _flat_inits(inits: dict) -> dict:
    """{scenario: array or {leaf: array}} -> npz keys scenario[/leaf]."""
    out = {}
    for name, p in inits.items():
        if isinstance(p, dict):
            out.update({f"{name}/{k}": v for k, v in p.items()})
        else:
            out[name] = p
    return out


# the child: every scenario's port runs in one group, results per rank
_PRELUDE = textwrap.dedent("""
    import dataclasses, json, os
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from erasurehead_tpu_torch.parallel import backend

    backend.initialize_distributed(os.environ["EH_INIT"], device="cpu",
                                   timeout_s=float(os.environ["EH_TIMEOUT"]))
    from erasurehead_tpu_torch.data.synthetic import generate_gmm
    from erasurehead_tpu_torch.parallel import failures
    from erasurehead_tpu_torch.train import trainer
    from erasurehead_tpu_torch.utils.config import RunConfig

    RANK = torch.distributed.get_rank()
    spec = json.load(open(os.environ["EH_SPEC"]))
    inits = dict(np.load(os.environ["EH_INITS"])) if os.environ.get("EH_INITS") else {}
    out = {}

    def data(kw):
        return generate_gmm(kw["n_rows"], kw["n_cols"], kw["n_workers"], seed=0)

    def init(name):
        if name in inits:
            return inits[name]
        leaves = {k.split("/", 1)[1]: v for k, v in inits.items() if k.startswith(name + "/")}
        return leaves or None

    def keep(tag, res):
        h = res.params_history
        if isinstance(h, dict):
            for k in sorted(h):
                out[f"{tag}/{k}"] = h[k].numpy()
        else:
            out[tag] = h.numpy()
        out[f"{tag}:worker_times"] = res.worker_times
        out[f"{tag}:collected"] = res.collected
""")

_CHILD_2 = _PRELUDE + textwrap.dedent("""
    for name in ("agc", "cyc"):
        kw = spec[name]
        cfg, ds = RunConfig(**kw), data(kw)
        for tag, c in (("", cfg), ("~rerun", cfg),
                       ("~ring_off", dataclasses.replace(cfg, stack_mode="ring", ring_pipeline="off")),
                       ("~ring_on", dataclasses.replace(cfg, stack_mode="ring", ring_pipeline="on"))):
            res = trainer.train(c, ds, device="cpu", init_params=init(name))
            keep(name + tag, res)
            out[name + tag + ":stack_mode"] = np.array(res.cache_info["stack_mode"])
    kw = spec["agc"]
    for b, res in enumerate(trainer.train_cohort(
            [dataclasses.replace(RunConfig(**kw), seed=s) for s in spec["cohort_seeds"]],
            data(kw), device="cpu", init_params=[init(f"cohort{s}") for s in spec["cohort_seeds"]])):
        keep(f"cohort{b}", res)
    kw = spec["dynamic"]
    keep("dynamic", trainer.train_dynamic(RunConfig(**kw), data(kw), device="cpu",
                                          init_params=init("dynamic")))
    kw = spec["deep"]
    keep("deep", trainer.train(RunConfig(**kw, layer_coding="on"), data(kw), device="cpu",
                               init_params=init("deep")))
    kw = spec["elastic"]
    res, rep = failures.train_elastic(RunConfig(**kw), data(kw),
                                      {int(k): v for k, v in spec["deaths"].items()},
                                      device="cpu", dynamic=True, init_params=init("elastic"))
    keep("elastic", res)
    out["elastic:n_workers_after"] = np.array(rep.n_workers_after)
    kw = spec["measured"]
    mult = np.ones(kw["n_workers"], np.int64)
    mult[0] = 40  # one slow worker
    keep("measured", trainer.train_measured(RunConfig(**kw), data(kw), device="cpu",
                                            work_multiplier=mult, init_params=init("measured")))
    np.savez(os.path.join(os.environ["EH_OUT"], f"rank{RANK}.npz"), **out)
""")

_CHILD_4 = _PRELUDE + textwrap.dedent("""
    kw = spec["w30"]
    keep("w30", trainer.train(RunConfig(**kw, scheme="approx", num_collect=15), data(kw),
                              device="cpu", init_params=init("w30")))
    ds = data(kw)
    for scheme, extra in spec["schemes"].items():
        cfg = RunConfig(**{**kw, "scheme": scheme, **extra})
        for tag, c in (("", cfg),
                       ("~ring_off", dataclasses.replace(cfg, stack_mode="ring", ring_pipeline="off")),
                       ("~ring_on", dataclasses.replace(cfg, stack_mode="ring", ring_pipeline="on"))):
            res = trainer.train(c, ds, device="cpu")
            keep(scheme + tag, res)
            out[scheme + tag + ":stack_mode"] = np.array(res.cache_info["stack_mode"])
    np.savez(os.path.join(os.environ["EH_OUT"], f"rank{RANK}.npz"), **out)
""")

_CHILD_CKPT = _PRELUDE + textwrap.dedent("""
    kw = spec["ckpt"]
    ckpt = {}
    if os.environ.get("EH_CKPT"):
        ckpt = dict(checkpoint_dir=os.environ["EH_CKPT"], checkpoint_every=2,
                    resume=os.environ.get("EH_RESUME") == "1")
    res = trainer.train(RunConfig(**kw), data(kw), device="cpu", **ckpt)
    np.save(os.path.join(os.environ["EH_OUT"], f"final{RANK}.npy"), res.final_params.numpy())
""")


def _launch(n, code, out_dir, spec, inits=None, rank_env=None, timeout_s=60.0):
    """Start ``n`` children of one gloo group (torchrun's RANK/WORLD_SIZE)
    and wait for all of them within SPAWN_TIMEOUT_S; a child still running
    then is killed, and so is every child when this raises. The group meets
    at a file store new to this launch (``EH_INIT``), not at a TCP port: a
    port found free here could be taken by another process before rank 0
    binds it, which is how cluster tests fail under a loaded test run.
    Returns ``[(returncode, log)]`` in rank order."""
    os.makedirs(out_dir, exist_ok=True)
    spec_path = os.path.join(out_dir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = {k: v for k, v in os.environ.items() if not k.startswith("ERASUREHEAD_")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", WORLD_SIZE=str(n),
               EH_INIT="file://" + os.path.join(out_dir, f"rdzv-{uuid.uuid4().hex}"),
               EH_SPEC=spec_path, EH_OUT=out_dir, EH_TIMEOUT=str(timeout_s))
    if inits is not None:
        env["EH_INITS"] = os.path.join(out_dir, "inits.npz")
        np.savez(env["EH_INITS"], **_flat_inits(inits))
    procs = []
    try:
        for r in range(n):
            extra = (rank_env or {}).get(r, {})
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code],
                env={**env, "RANK": str(r), "LOCAL_RANK": str(r), **extra},
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO,
            ))
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0].decode()
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGKILL)
                p.wait()
    return [(p.returncode, log) for p, log in zip(procs, logs)]


def _ok(results):
    for r, (rc, log) in enumerate(results):
        assert rc == 0, f"rank {r} exited {rc}:\n{log[-3000:]}"


def _load(out_dir, n):
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(n)]


def _leaves(rank, tag):
    """The history leaves of ``tag`` in sorted-key order."""
    if tag in rank:
        return [rank[tag]]
    return [rank[k] for k in sorted(rank) if k.startswith(tag + "/")]


def _jleaves(tree):
    if isinstance(tree, dict):
        return [np.asarray(tree[k]) for k in sorted(tree)]
    return [np.asarray(tree)]


def _bitwise(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """The 2-process cluster's per-rank results and this process's references."""
    out = str(tmp_path_factory.mktemp("mesh2"))
    inits = {name: _jax_init(kw) for name, kw in SCENARIOS_2.items()}
    inits.update({f"cohort{s}": _jax_init(dict(SCENARIOS_2["agc"], seed=s)) for s in COHORT_SEEDS})
    spec = {**SCENARIOS_2, "cohort_seeds": list(COHORT_SEEDS),
            "deaths": {str(k): v for k, v in ELASTIC_DEATHS.items()}}
    _ok(_launch(2, _CHILD_2, out, spec, inits))
    return _load(out, 2), inits


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """The 4-process cluster: W = 30 folds onto a worker group of 3."""
    out = str(tmp_path_factory.mktemp("mesh4"))
    inits = {"w30": _jax_init(dict(W30, scheme="approx", num_collect=15))}
    _ok(_launch(4, _CHILD_4, out, {"w30": W30, "schemes": SCHEMES_30}, inits))
    return _load(out, 4), inits


# ---------------------------------------------------------------------------
# world size 2


def test_two_rank_agc_matches_jax_two_device_mesh(two):
    ranks, inits = two
    kw = SCENARIOS_2["agc"]
    want = j_trainer.train(JRunConfig(**kw), _jdata(kw), mesh=j_worker_mesh(2), measure=False)
    np.testing.assert_allclose(ranks[0]["agc"], np.asarray(want.params_history),
                               rtol=2e-4, atol=1e-5)
    assert ranks[0]["agc:worker_times"].tobytes() == want.worker_times.tobytes()
    assert ranks[0]["agc:collected"].tobytes() == want.collected.tobytes()


def test_two_rank_agc_matches_the_ports_world_one_run(two):
    ranks, inits = two
    kw = SCENARIOS_2["agc"]
    one = t_trainer.train(RunConfig(**kw), _data(kw), device="cpu", init_params=inits["agc"])
    np.testing.assert_allclose(ranks[0]["agc"], one.params_history.numpy(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["agc", "cyc", "dynamic", "deep", "elastic", "measured",
                                  "cohort0", "cohort1"])
def test_ranks_are_bitwise_equal(two, name):
    ranks, _ = two
    assert _bitwise(_leaves(ranks[0], name), _leaves(ranks[1], name))
    for field in ("worker_times", "collected"):
        assert np.array_equal(ranks[0][f"{name}:{field}"], ranks[1][f"{name}:{field}"])


def test_rerun_is_bitwise(two):
    ranks, _ = two
    assert _bitwise(_leaves(ranks[0], "agc"), _leaves(ranks[0], "agc~rerun"))


@pytest.mark.parametrize("name", ["agc", "cyc"])
def test_two_rank_ring_off_and_on_are_bitwise_materialized(two, name):
    ranks, _ = two
    for r in ranks:
        assert str(r[name + ":stack_mode"]) == "materialized"
        for tag in ("~ring_off", "~ring_on"):
            assert str(r[name + tag + ":stack_mode"]) == "ring"
            assert _bitwise(_leaves(r, name), _leaves(r, name + tag)), (name, tag)


def test_two_rank_cohort_matches_jax(two):
    ranks, inits = two
    kw = SCENARIOS_2["agc"]
    cfgs = [JRunConfig(**dict(kw, seed=s)) for s in COHORT_SEEDS]
    want = j_trainer.train_cohort(cfgs, _jdata(kw), mesh=j_worker_mesh(2), measure=False)
    for b, w in enumerate(want):
        np.testing.assert_allclose(ranks[0][f"cohort{b}"], np.asarray(w.params_history),
                                   rtol=2e-4, atol=1e-5)


def test_two_rank_dynamic_matches_jax(two):
    ranks, _ = two
    kw = SCENARIOS_2["dynamic"]
    want = j_trainer.train_dynamic(JRunConfig(**kw), _jdata(kw), mesh=j_worker_mesh(2))
    np.testing.assert_array_equal(ranks[0]["dynamic:collected"], want.collected)
    np.testing.assert_allclose(ranks[0]["dynamic"], np.asarray(want.params_history),
                               rtol=2e-4, atol=1e-5)


def test_two_rank_layer_coded_deep_matches_jax(two):
    ranks, _ = two
    kw = SCENARIOS_2["deep"]
    want = j_trainer.train(JRunConfig(**kw, layer_coding="off"), _jdata(kw),
                           mesh=j_worker_mesh(2), measure=False)
    got, exp = _leaves(ranks[0], "deep"), _jleaves(want.params_history)
    assert len(got) == len(exp) > 1
    for a, b in zip(got, exp):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-5)


def test_two_rank_train_elastic_shrinks_the_group_and_matches_jax(two):
    ranks, _ = two
    kw = SCENARIOS_2["elastic"]
    want, rep = j_failures.train_elastic(JRunConfig(**kw), _jdata(kw), ELASTIC_DEATHS,
                                         mesh=j_worker_mesh(2), dynamic=True, measure=False)
    assert int(ranks[0]["elastic:n_workers_after"]) == rep.n_workers_after == 7
    np.testing.assert_array_equal(ranks[0]["elastic:collected"], want.collected)
    np.testing.assert_allclose(ranks[0]["elastic"], np.asarray(want.params_history),
                               rtol=2e-4, atol=1e-5)


def test_measured_cluster_replicas_agree(two):
    ranks, _ = two
    kw = SCENARIOS_2["measured"]
    wt = ranks[0]["measured:worker_times"]
    assert wt.shape == (kw["rounds"], kw["n_workers"])
    assert np.isfinite(ranks[0]["measured"]).all()
    # every worker was timed on one rank and the row met on both: the
    # collected workers carry a positive measured time
    collected = ranks[0]["measured:collected"]
    assert (wt[collected] > 0).all() and collected.any(axis=1).all()


# ---------------------------------------------------------------------------
# world size 4: W = 30 folds onto 3 ranks, the fourth holds no slots


def test_w30_over_four_processes_matches_jax_three_device_mesh(four):
    ranks, _ = four
    kw = dict(W30, scheme="approx", num_collect=15)
    want = j_trainer.train(JRunConfig(**kw), _jdata(kw), mesh=j_worker_mesh(3), measure=False)
    np.testing.assert_allclose(ranks[0]["w30"], np.asarray(want.params_history),
                               rtol=2e-4, atol=1e-5)
    for r in ranks[1:]:  # the rank outside the worker group too
        assert np.array_equal(r["w30"], ranks[0]["w30"])


@pytest.mark.parametrize("scheme", list(SCHEMES_30))
def test_world_three_ring_off_and_on_are_bitwise_materialized(four, scheme):
    ranks, _ = four
    for r in ranks:
        assert str(r[scheme + ":stack_mode"]) == "materialized"
        for tag in ("~ring_off", "~ring_on"):
            assert str(r[scheme + tag + ":stack_mode"]) == "ring"
            assert _bitwise(_leaves(r, scheme), _leaves(r, scheme + tag)), (scheme, tag)
        assert _bitwise(_leaves(r, scheme), _leaves(ranks[0], scheme))


# ---------------------------------------------------------------------------
# checkpoint: rank 0 writes, every rank reads; a rank killed mid-run


def test_killed_rank_resumes_where_the_uninterrupted_run_lands(tmp_path):
    spec = {"ckpt": CKPT}
    ref = str(tmp_path / "ref")
    _ok(_launch(2, _CHILD_CKPT, ref, spec))
    ckdir = str(tmp_path / "ckpt")
    killed = str(tmp_path / "killed")
    # rank 0 dies at its second save (round 4; round_2 committed); rank 1's
    # next all-reduce then fails instead of waiting for it
    results = _launch(2, _CHILD_CKPT, killed, spec, timeout_s=20.0,
                      rank_env={0: {"EH_CKPT": ckdir, "ERASUREHEAD_CHAOS": "kill:checkpoint:2"},
                                1: {"EH_CKPT": ckdir}})
    assert results[0][0] == 43, results[0][1][-2000:]
    assert results[1][0] != 0
    assert sorted(os.listdir(ckdir)) == ["round_2"]
    resumed = str(tmp_path / "resumed")
    _ok(_launch(2, _CHILD_CKPT, resumed, spec,
                rank_env={r: {"EH_CKPT": ckdir, "EH_RESUME": "1"} for r in (0, 1)}))
    for r in (0, 1):
        want = np.load(os.path.join(ref, f"final{r}.npy"))
        assert np.array_equal(np.load(os.path.join(resumed, f"final{r}.npy")), want)
    assert sorted(os.listdir(ckdir)) == ["round_10", "round_2", "round_4", "round_6", "round_8"]


# ---------------------------------------------------------------------------
# the CLI under torchrun: rank 0 alone writes the artifacts


CLI_ARGS = ["--scheme", "approx", "--workers", "4", "--stragglers", "1", "--num-collect", "3",
            "--rounds", "4", "--rows", "64", "--cols", "16", "--add-delay", "--device", "cpu",
            "--quiet"]


def test_torchrun_cli_across_two_processes(tmp_path):
    from erasurehead_tpu_torch import cli as t_cli

    env = {k: v for k, v in os.environ.items() if not k.startswith("ERASUREHEAD_")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out2 = str(tmp_path / "two")
    # --standalone: torchrun's rendezvous store binds a free port itself and
    # the workers share it (a port picked here and passed as --master-port
    # can be taken by another process first)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
           "-m", "erasurehead_tpu_torch.cli", *CLI_ARGS, "--output-dir", out2]
    proc = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=SPAWN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out1 = str(tmp_path / "one")
    assert t_cli.main(CLI_ARGS + ["--output-dir", out1]) == 0
    names = sorted(os.listdir(out1))
    assert sorted(os.listdir(out2)) == names  # one writer: no file twice, none missing
    for name in names:
        if name.endswith("timeset.dat"):  # the host control plane: the same bytes
            assert open(os.path.join(out2, name), "rb").read() == \
                open(os.path.join(out1, name), "rb").read()
        elif name.endswith("loss.dat"):
            np.testing.assert_allclose(np.loadtxt(os.path.join(out2, name)),
                                       np.loadtxt(os.path.join(out1, name)), rtol=1e-5)

