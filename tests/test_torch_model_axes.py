"""The model-internal axes across processes against the JAX package.

Two gloo groups of CPU processes, each booted once (module-scoped fixtures):

- **4 processes**: every rank builds the 2-D meshes ``(1, 2)`` (ranks 0 and
  1; ranks 2 and 3 outside the grid add zeros) and ``(2, 2)`` of every axis
  and takes one decoded gradient of the same numpy stack and JAX's initial
  params, faithful ([W, S, rows, F]) and deduped ([P, rows, F]): tensor
  parallel mlp, pipeline parallel deepmlp (one microbatch a stage, and
  ``microbatches`` = 4 > p), expert parallel moe, sequence parallel
  attention under ring and Ulysses. This process holds them against the
  JAX package's grad functions on its ``worker_plus_axis_mesh`` of the same
  shape, at rtol 2e-4 / atol 2e-5 (tests/test_train.py's tolerance). Then
  5-round ``train`` trajectories at 2 shards on the auto mesh (2, 2), a
  ``train_dynamic`` run and a 2-trajectory cohort.
- **2 processes**: the same trajectories on the auto mesh (1, 2).

Trajectories are held against JAX's ``train`` at the same shards, at the
tolerance JAX's own test of that axis uses (tp rtol 2e-4 / atol 2e-5,
tests/test_train.py; pp and ep 5e-4 / 5e-5; seq rtol 5e-2 / atol 2e-5,
tests/test_ring.py), and every rank's params are bitwise equal. The
refusals (config, CLI, trainer, model) are compared with JAX's messages in
this process.
"""

import concurrent.futures
import dataclasses
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erasurehead_tpu import cli as j_cli
from erasurehead_tpu.data.synthetic import generate_gmm as j_generate_gmm
from erasurehead_tpu.models.attention import AttentionModel as JAttention
from erasurehead_tpu.models.deep_mlp import DeepMLPModel as JDeep, PIPE_AXIS
from erasurehead_tpu.models.mlp import MLPModel as JMLP
from erasurehead_tpu.models.moe import EXPERT_AXIS, MoEModel as JMoE
from erasurehead_tpu.parallel import step as j_step
from erasurehead_tpu.parallel.mesh import MODEL_AXIS, worker_mesh as j_worker_mesh
from erasurehead_tpu.parallel.mesh import worker_plus_axis_mesh as j_2d_mesh
from erasurehead_tpu.parallel.ring import SEQ_AXIS
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.utils.compat import shard_map
from erasurehead_tpu.utils.config import RunConfig as JRunConfig
from erasurehead_tpu_torch import cli as t_cli
from erasurehead_tpu_torch.data.synthetic import generate_gmm
from erasurehead_tpu_torch.models.attention import AttentionModel
from erasurehead_tpu_torch.models.deep_mlp import DeepMLPModel
from erasurehead_tpu_torch.models.glm import params_from_numpy
from erasurehead_tpu_torch.models.mlp import MLPModel
from erasurehead_tpu_torch.models.moe import MoEModel
from erasurehead_tpu_torch.parallel import mesh as t_mesh
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils.config import RunConfig
from jax.sharding import Mesh, PartitionSpec as P
from test_torch_multiproc import _launch, _ok

GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
W, S, ROWS = 4, 2, 12
MESHES = ((1, 2), (2, 2))

# family -> (JAX model, axis, features): the one-step gradient cases
GRAD_CASES = {
    "tp": (lambda: JMLP(hidden=16), MODEL_AXIS, 24),
    "pp": (lambda: JDeep(hidden=8, n_layers=4), PIPE_AXIS, 16),
    "pp_mb4": (lambda: JDeep(hidden=8, n_layers=4, microbatches=4), PIPE_AXIS, 16),
    "ep": (lambda: JMoE(hidden=8, n_experts=4), EXPERT_AXIS, 16),
    "seq_ring": (lambda: JAttention(), SEQ_AXIS, 64),
    "seq_ulysses": (lambda: JAttention(sp_form="ulysses"), SEQ_AXIS, 64),
}

BASE = dict(scheme="approx", n_workers=4, n_stragglers=1, num_collect=3, rounds=5,
            n_rows=192, update_rule="GD", add_delay=True, seed=0)
# family -> (config, trajectory tolerance of JAX's own test of that axis)
TRAJ = {
    "tp": (dict(BASE, model="mlp", n_cols=24, lr_schedule=0.5, tp_shards=2),
           dict(rtol=2e-4, atol=2e-5)),
    "pp": (dict(BASE, model="deepmlp", n_cols=16, lr_schedule=0.5, pp_shards=2),
           dict(rtol=5e-4, atol=5e-5)),
    "ep": (dict(BASE, model="moe", n_cols=16, lr_schedule=0.5, ep_shards=2),
           dict(rtol=5e-4, atol=5e-5)),
    "seq_ring": (dict(BASE, model="attention", n_cols=64, seq_shards=2),
                 dict(rtol=5e-2, atol=2e-5)),
    "seq_ulysses": (dict(BASE, model="attention", n_cols=64, seq_shards=2, sp_form="ulysses"),
                    dict(rtol=5e-2, atol=2e-5)),
}


def _grad_inputs():
    """The stacks, weights and JAX's initial params of every gradient case."""
    rng = np.random.default_rng(0)
    d = {"ws": rng.uniform(size=(W, S)).astype(np.float32)}
    for name, (make, _, F) in GRAD_CASES.items():
        d[f"{name}/X"] = rng.standard_normal((W, S, ROWS, F)).astype(np.float32)
        d[f"{name}/y"] = np.sign(rng.standard_normal((W, S, ROWS))).astype(np.float32)
        for k, v in make().init_params(jax.random.PRNGKey(0), F).items():
            d[f"{name}/p/{k}"] = np.asarray(v)
    return d


def _jax_init(kw):
    jcfg = JRunConfig(**kw)
    p = j_trainer._init_params_f32(jcfg, j_trainer.build_model(jcfg), kw["n_cols"])
    return {k: np.asarray(v) for k, v in p.items()}


_PRELUDE = textwrap.dedent("""
    import json, os
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from erasurehead_tpu_torch.parallel import backend

    backend.initialize_distributed(os.environ["EH_INIT"], device="cpu",
                                   timeout_s=float(os.environ["EH_TIMEOUT"]))
    from erasurehead_tpu_torch.data.synthetic import generate_gmm
    from erasurehead_tpu_torch.train import trainer
    from erasurehead_tpu_torch.utils.config import RunConfig

    RANK = torch.distributed.get_rank()
    spec = json.load(open(os.environ["EH_SPEC"]))
    d = dict(np.load(os.environ["EH_INITS"]))
    out = {}

    def params(prefix):
        n = len(prefix)
        return {k[n:]: torch.tensor(v) for k, v in d.items() if k.startswith(prefix)}

    for name, kw in spec["traj"].items():
        ds = generate_gmm(kw["n_rows"], kw["n_cols"], kw["n_workers"], seed=0)
        res = trainer.train(RunConfig(**kw), ds, device="cpu", init_params=params(f"traj/{name}/"))
        for k in sorted(res.params_history):
            out[f"traj/{name}/{k}"] = res.params_history[k].numpy()
""")

_CHILD_4 = _PRELUDE + textwrap.dedent("""
    from erasurehead_tpu_torch.models.attention import AttentionModel
    from erasurehead_tpu_torch.models.deep_mlp import DeepMLPModel
    from erasurehead_tpu_torch.models.mlp import MLPModel
    from erasurehead_tpu_torch.models.moe import MoEModel
    from erasurehead_tpu_torch.parallel import mesh as mesh_lib, step

    models = {
        "tp": MLPModel(hidden=16), "pp": DeepMLPModel(hidden=8, n_layers=4),
        "pp_mb4": DeepMLPModel(hidden=8, n_layers=4, microbatches=4),
        "ep": MoEModel(hidden=8, n_experts=4), "seq_ring": AttentionModel(),
        "seq_ulysses": AttentionModel(sp_form="ulysses"),
    }
    ws = torch.tensor(d["ws"])
    for name, model in models.items():
        p = params(f"{name}/p/")
        X, y = torch.tensor(d[f"{name}/X"]), torch.tensor(d[f"{name}/y"])
        for wd, shards in spec["meshes"]:
            mesh = mesh_lib.worker_plus_axis_mesh(spec["axes"][name], shards, wd)
            m = model.for_mesh(mesh)
            lo, hi = mesh.slice(X.shape[0])
            tag = f"grad/{name}/{wd}x{shards}"
            g = step.make_faithful_grad_fn(m, mesh)(p, X[lo:hi], y[lo:hi], ws[lo:hi])
            out.update({f"{tag}/faithful/{k}": v.numpy() for k, v in g.items()})
            g = step.make_deduped_grad_fn(m, mesh)(p, X[lo:hi, 0], y[lo:hi, 0], ws[lo:hi, 0])
            out.update({f"{tag}/deduped/{k}": v.numpy() for k, v in g.items()})
    # the standalone recipe: grad_sum on a rank of a 4-shard sequence axis
    seq4 = mesh_lib.worker_seq_mesh(4, 1)
    X, y = torch.tensor(d["seq_ring/X"])[0, 0], torch.tensor(d["seq_ring/y"])[0, 0]
    g = AttentionModel().for_mesh(seq4).grad_sum(params("seq_ring/p/"), X, y)
    out.update({f"grad_sum/{k}": v.numpy() for k, v in g.items()})
    kw = spec["traj"]["tp"]
    ds = generate_gmm(kw["n_rows"], kw["n_cols"], kw["n_workers"], seed=0)
    res = trainer.train_dynamic(RunConfig(**kw), ds, device="cpu", init_params=params("traj/tp/"))
    out.update({f"dynamic/{k}": v.numpy() for k, v in res.params_history.items()})
    kw = spec["traj"]["ep"]
    ds = generate_gmm(kw["n_rows"], kw["n_cols"], kw["n_workers"], seed=0)
    for b, res in enumerate(trainer.train_cohort(
            [RunConfig(**kw), RunConfig(**{**kw, "lr_schedule": 0.25})], ds, device="cpu",
            init_params=[params("traj/ep/")] * 2)):
        out.update({f"cohort{b}/{k}": v.numpy() for k, v in res.params_history.items()})
        out[f"cohort{b}:lowering"] = np.array(res.lowering)
    np.savez(os.path.join(os.environ["EH_OUT"], f"rank{RANK}.npz"), **out)
""")

_CHILD_2 = _PRELUDE + textwrap.dedent("""
    np.savez(os.path.join(os.environ["EH_OUT"], f"rank{RANK}.npz"), **out)
""")


def _traj_spec_and_inits():
    spec = {name: kw for name, (kw, _) in TRAJ.items()}
    inits = {f"traj/{name}/{k}": v for name, kw in spec.items() for k, v in _jax_init(kw).items()}
    return spec, inits


_JAX_GRADS, _JAX_TRAJ = {}, {}


def _jax_grad(d, name, wd, shards, mode):
    """JAX's decoded gradient of a GRAD_CASES case on its (wd, shards) 2-D
    mesh, cached. Jitted: an eager shard_map dispatches op by op (seconds a
    call)."""
    key = (name, wd, shards, mode)
    if key not in _JAX_GRADS:
        make, axis, _ = GRAD_CASES[name]
        model, mesh = make(), j_2d_mesh(axis, shards, wd)
        params = {k: jnp.asarray(v) for k, v in _rank_tree(d, f"{name}/p/").items()}
        X, y, ws = jnp.asarray(d[f"{name}/X"]), jnp.asarray(d[f"{name}/y"]), jnp.asarray(d["ws"])
        if mode == "faithful":
            fn, args = j_step.make_faithful_grad_fn, (X, y, ws)
        else:
            fn, args = j_step.make_deduped_grad_fn, (X[:, 0], y[:, 0], ws[:, 0])
        g = jax.jit(fn(model.for_mesh(mesh), mesh))(params, *args)
        _JAX_GRADS[key] = {k: np.asarray(v) for k, v in g.items()}
    return _JAX_GRADS[key]


def _jax_train(name):
    """JAX's train at the config's shards on its auto 2-D mesh, cached."""
    if name not in _JAX_TRAJ:
        kw = TRAJ[name][0]
        ds = j_generate_gmm(kw["n_rows"], kw["n_cols"], n_partitions=kw["n_workers"], seed=0)
        res = j_trainer.train(JRunConfig(**kw), ds, measure=False)
        _JAX_TRAJ[name] = {k: np.asarray(v) for k, v in res.params_history.items()}
    return _JAX_TRAJ[name]


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """Both clusters, each launched from a thread (their children are
    processes), while this process computes the JAX references."""
    traj, inits = _traj_spec_and_inits()
    d = {**_grad_inputs(), **inits}
    spec4 = {"traj": traj, "meshes": MESHES,
             "axes": {name: axis for name, (_, axis, _) in GRAD_CASES.items()}}
    runs = {4: (_CHILD_4, spec4, d), 2: (_CHILD_2, {"traj": traj}, inits)}
    outs = {n: str(tmp_path_factory.mktemp(f"axes{n}")) for n in runs}
    with concurrent.futures.ThreadPoolExecutor(len(runs)) as pool:
        launched = {n: pool.submit(_launch, n, code, outs[n], spec, data)
                    for n, (code, spec, data) in runs.items()}
        for name in GRAD_CASES:
            for wd, shards in MESHES:
                for mode in ("faithful", "deduped"):
                    _jax_grad(d, name, wd, shards, mode)
        for name in TRAJ:
            _jax_train(name)
        for n in runs:
            _ok(launched[n].result())
    ranks = {n: [dict(np.load(os.path.join(outs[n], f"rank{r}.npz"))) for r in range(n)]
             for n in runs}
    return ranks, d


@pytest.fixture(scope="module")
def four(clusters):
    ranks, d = clusters
    return ranks[4], d


@pytest.fixture(scope="module")
def two(clusters):
    return clusters[0][2]


def _rank_tree(rank, prefix):
    n = len(prefix)
    return {k[n:]: v for k, v in rank.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# one step: the decoded gradient on (1, 2) and (2, 2) meshes


@pytest.mark.parametrize("mode", ["faithful", "deduped"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_decoded_gradient_matches_jax_2d_mesh(four, name, shape, mode):
    ranks, d = four
    wd, shards = shape
    want = _jax_grad(d, name, wd, shards, mode)
    got = _rank_tree(ranks[0], f"grad/{name}/{wd}x{shards}/{mode}/")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **GRAD_TOL, err_msg=k)
    for r in ranks[1:]:  # every rank, inside the grid or not, holds the same gradient
        other = _rank_tree(r, f"grad/{name}/{wd}x{shards}/{mode}/")
        assert all(np.array_equal(other[k], got[k]) for k in got)


def test_grad_sum_on_a_sequence_axis_matches_the_unsharded_oracle(four):
    """JAX's tests/test_ring.py::test_seq_grad_matches_oracle: the loss
    scaled by 1/axis size, then every leaf summed over the axis, gives the
    unsharded gradient on every rank (4 shards of 8 tokens)."""
    ranks, d = four
    params = {k: jnp.asarray(v) for k, v in _rank_tree(d, "seq_ring/p/").items()}
    X, y = jnp.asarray(d["seq_ring/X"][0, 0]), jnp.asarray(d["seq_ring/y"][0, 0])
    want = jax.jit(JAttention().grad_sum)(params, X, y)
    for r in ranks:
        got = _rank_tree(r, "grad_sum/")
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), **GRAD_TOL, err_msg=k)


# ---------------------------------------------------------------------------
# trajectories: 5 rounds of train() at 2 shards


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(TRAJ))
def test_trajectory_matches_jax_train(two, four, world, name):
    ranks = two if world == 2 else four[0]
    want = _jax_train(name)
    got = _rank_tree(ranks[0], f"traj/{name}/")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k][-1], want[k][-1], **TRAJ[name][1], err_msg=k)
    for r in ranks[1:]:
        other = _rank_tree(r, f"traj/{name}/")
        assert all(np.array_equal(other[k], got[k]) for k in got), "ranks differ"


def test_train_dynamic_under_tp_matches_jax(four):
    ranks, d = four
    kw = TRAJ["tp"][0]
    ds = j_generate_gmm(kw["n_rows"], kw["n_cols"], n_partitions=kw["n_workers"], seed=0)
    want = j_trainer.train_dynamic(JRunConfig(**kw), ds, mesh=j_2d_mesh(MODEL_AXIS, 2, 2))
    got = _rank_tree(ranks[0], "dynamic/")
    for k, v in want.params_history.items():
        np.testing.assert_allclose(got[k], np.asarray(v), **TRAJ["tp"][1], err_msg=k)
    assert all(np.array_equal(_rank_tree(r, "dynamic/")[k], got[k]) for r in ranks for k in got)


def test_cohort_under_ep_matches_its_sequential_runs(four):
    ranks, d = four
    kw = TRAJ["ep"][0]
    got = _rank_tree(ranks[0], "cohort0/")
    want = _rank_tree(ranks[0], "traj/ep/")
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert str(ranks[0]["cohort0:lowering"]) == "per_slot_vmap"  # JAX's lowering name
    ds = j_generate_gmm(kw["n_rows"], kw["n_cols"], n_partitions=kw["n_workers"], seed=0)
    jres = j_trainer.train(JRunConfig(**{**kw, "lr_schedule": 0.25}), ds, measure=False)
    for k, v in jres.params_history.items():
        np.testing.assert_allclose(_rank_tree(ranks[0], "cohort1/")[k][-1], np.asarray(v)[-1],
                                   **TRAJ["ep"][1], err_msg=k)


# ---------------------------------------------------------------------------
# refusals, with JAX's messages


def _same_refusal(t_call, j_call, exc=ValueError):
    with pytest.raises(exc) as want:
        j_call()
    with pytest.raises(exc) as got:
        t_call()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(model="logistic", tp_shards=2), dict(model="mlp", tp_shards=0),
    dict(model="mlp", tp_shards=2, arrival_mode="measured"),
    dict(model="mlp", pp_shards=2), dict(model="deepmlp", pp_shards=0),
    dict(model="deepmlp", pp_shards=2, arrival_mode="measured"),
    dict(model="deepmlp", ep_shards=2), dict(model="moe", ep_shards=-1),
    dict(model="moe", ep_shards=2, arrival_mode="measured"),
    dict(model="mlp", seq_shards=2), dict(model="attention", seq_shards=0),
    dict(model="attention", seq_shards=2, arrival_mode="measured"),
    dict(model="mlp", tp_shards=2, seq_shards=2), dict(model="moe", ep_shards=2, pp_shards=2),
    dict(model="attention", sp_form="tree"),
])
def test_config_refusals_carry_jax_messages(kw):
    full = dict(scheme="approx", n_workers=4, n_stragglers=1, num_collect=3, **kw)
    _same_refusal(lambda: RunConfig(**full), lambda: JRunConfig(**full))


@pytest.mark.parametrize("argv", [
    ["--model", "logistic", "--tp-shards", "2"], ["--model", "mlp", "--pp-shards", "2"],
    ["--model", "deepmlp", "--ep-shards", "2"], ["--model", "moe", "--seq-shards", "2"],
    ["--model", "mlp", "--tp-shards", "0"],
    ["--model", "mlp", "--tp-shards", "2", "--seq-shards", "2"],
])
def test_cli_refusals_carry_jax_messages(argv):
    _same_refusal(lambda: t_cli._flags_to_config(t_cli._flags_parser().parse_args(argv)),
                  lambda: j_cli._flags_to_config(j_cli._flags_parser().parse_args(argv)))


@pytest.mark.parametrize("flag,field", [("--tp-shards", "tp_shards"), ("--pp-shards", "pp_shards"),
                                        ("--ep-shards", "ep_shards"), ("--seq-shards", "seq_shards")])
def test_cli_flags_parse_as_jax_parses_them(flag, field):
    model = {"tp_shards": "mlp", "pp_shards": "deepmlp", "ep_shards": "moe",
             "seq_shards": "attention"}[field]
    argv = ["--model", model, flag, "2", "--sp-form", "ulysses"]
    got = t_cli._flags_to_config(t_cli._flags_parser().parse_args(argv))
    want = j_cli._flags_to_config(j_cli._flags_parser().parse_args(argv))
    for f in ("seq_shards", "tp_shards", "pp_shards", "ep_shards", "sp_form"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.static_signature_fields()[field] == want.static_signature_fields()[field] == 2
    t_act, j_act = (next(a for a in parser._actions if flag in a.option_strings)
                    for parser in (t_cli._flags_parser(), j_cli._flags_parser()))
    assert (t_act.help, t_act.default, t_act.type) == (j_act.help, j_act.default, j_act.type)


@pytest.mark.parametrize("name", ["tp", "pp", "ep", "seq_ring"])
def test_one_process_refuses_shards_above_its_device_count(name):
    """One process is one device: JAX's device-count refusal (its rule,
    checked on its 8 devices with 9 shards)."""
    kw = dict(TRAJ[name][0], rounds=1)
    axis, shards = t_trainer._model_axis_request(RunConfig(**kw))
    with pytest.raises(ValueError) as want:
        j_trainer._auto_2d_mesh(4, axis, 9)
    assert str(want.value) == f"{axis} shards=9 exceeds the 8 available devices"
    with pytest.raises(ValueError) as got:
        t_trainer.train(RunConfig(**kw), generate_gmm(kw["n_rows"], kw["n_cols"], 4, seed=0),
                        device="cpu")
    assert str(got.value) == f"{axis} shards={shards} exceeds the 1 available devices"


def test_explicit_mesh_must_carry_the_axis():
    kw = dict(TRAJ["tp"][0], rounds=1)
    _same_refusal(
        lambda: t_trainer.train(RunConfig(**kw), generate_gmm(192, 24, 4, seed=0), device="cpu",
                                mesh=t_mesh.worker_mesh(1)),
        lambda: j_trainer.train(JRunConfig(**kw), j_generate_gmm(192, 24, n_partitions=4, seed=0),
                                mesh=j_worker_mesh(1), measure=False))


def test_layer_coding_on_under_an_axis_is_refused_with_jax_message():
    kw = dict(TRAJ["tp"][0], rounds=1, layer_coding="on")
    fake = t_mesh.WorkerMesh(ranks=(0, 1), world=2, axis_name=MODEL_AXIS, shards=2)
    _same_refusal(
        lambda: t_trainer._check_layer_coding(RunConfig(**kw), MLPModel().for_mesh(fake)),
        lambda: j_trainer.train(JRunConfig(**kw), j_generate_gmm(192, 24, n_partitions=4, seed=0),
                                measure=False))


def test_streamed_windows_refuse_a_model_axis_with_jax_message():
    kw = dict(TRAJ["ep"][0], stack_residency="streamed", stream_window=2, compute_mode="deduped")
    _same_refusal(lambda: t_trainer._check_streamed_compat(RunConfig(**kw)),
                  lambda: j_trainer._check_streamed_compat(JRunConfig(**kw)))
    assert not t_trainer.cohort_eligible(RunConfig(**kw))
    assert not j_trainer.cohort_eligible(JRunConfig(**kw))


def _fake(axis, shards):
    """A mesh row seen from rank 0 without a group: the model refusals fire
    before any collective."""
    return t_mesh.WorkerMesh(ranks=tuple(range(shards)), world=shards, axis_name=axis,
                             shards=shards)


def _jax_predict(model, axis, shards, F, n=6):
    mesh = Mesh(np.asarray(jax.devices()[:shards]), (axis,))
    params = model.init_params(jax.random.PRNGKey(0), F)
    return lambda: shard_map(lambda p, x: model.predict(p, x), mesh=mesh,
                             in_specs=(P(), P()), out_specs=P())(params, jnp.ones((n, F)))


@pytest.mark.parametrize("case", ["hidden", "layers", "microbatches", "experts", "tokens",
                                  "heads"])
def test_model_refusals_carry_jax_messages(case):
    F, n = 8, 6
    if case == "hidden":
        t_m, j_m = MLPModel(hidden=6), JMLP(hidden=6, tp_axis=MODEL_AXIS)
        axis, shards = MODEL_AXIS, 4
    elif case == "layers":
        t_m, j_m = DeepMLPModel(hidden=8, n_layers=4), JDeep(hidden=8, n_layers=4, pp_axis=PIPE_AXIS)
        axis, shards = PIPE_AXIS, 3
    elif case == "microbatches":
        t_m = DeepMLPModel(hidden=8, n_layers=4, microbatches=4)
        j_m = JDeep(hidden=8, n_layers=4, microbatches=4, pp_axis=PIPE_AXIS)
        axis, shards = PIPE_AXIS, 2
    elif case == "experts":
        t_m, j_m = MoEModel(hidden=8, n_experts=4), JMoE(hidden=8, n_experts=4, ep_axis=EXPERT_AXIS)
        axis, shards = EXPERT_AXIS, 3
    elif case == "tokens":  # F = 56: 7 tokens over 2 shards
        F = 56
        t_m, j_m = AttentionModel(), JAttention(seq_axis=SEQ_AXIS)
        axis, shards = SEQ_AXIS, 2
    else:  # 2 heads over 4 shards, under Ulysses
        F = 64
        t_m, j_m = AttentionModel(sp_form="ulysses"), JAttention(seq_axis=SEQ_AXIS, sp_form="ulysses")
        axis, shards = SEQ_AXIS, 4
    t_m = t_m.for_mesh(_fake(axis, shards))
    params = params_from_numpy(
        jax.tree.map(np.asarray, j_m.init_params(jax.random.PRNGKey(0), F)))
    _same_refusal(lambda: t_m.predict(params, torch.ones(n, F)),
                  _jax_predict(j_m, axis, shards, F, n))


def test_for_mesh_swaps_in_the_axis_variant_only_on_its_axis():
    tp = _fake(MODEL_AXIS, 2)
    assert MLPModel().for_mesh(tp).tp_axis == MODEL_AXIS
    assert DeepMLPModel().for_mesh(tp).pp_axis is None
    assert MoEModel().for_mesh(_fake(EXPERT_AXIS, 2)).ep_axis == EXPERT_AXIS
    assert AttentionModel(sp_form="ulysses").for_mesh(_fake(SEQ_AXIS, 2)).sp_form == "ulysses"
    one = t_mesh.worker_mesh()
    for m in (MLPModel(), DeepMLPModel(), MoEModel(), AttentionModel()):
        assert m.for_mesh(one) is m
    assert dataclasses.replace(tp, rank=1).axis_index == 1


def test_serve_daemon_refuses_shards_above_its_one_device():
    """The wire carries JAX's field set, which has no shard fields: both
    packages refuse them as unserveable, and a config with one is no
    payload. A daemon is one process, so an in-process request at 2 shards
    fails with the trainer's device-count refusal, and the daemon lives on."""
    from erasurehead_tpu.serve import queue as j_queue
    from erasurehead_tpu_torch.serve import queue as t_queue, server as t_server

    kw = dict(TRAJ["tp"][0], rounds=2)
    assert t_queue.config_payload(RunConfig(**kw)) is None
    assert j_queue.config_payload(JRunConfig(**kw)) is None
    _same_refusal(lambda: t_queue.config_from_payload({"tp_shards": 2}),
                  lambda: j_queue.config_from_payload({"tp_shards": 2}))
    ds = generate_gmm(192, 24, 4, seed=0)
    with t_server.serving(device="cpu", window_s=0.01) as srv:
        bad = srv.submit(tenant="t", label="tp", config=RunConfig(**kw), dataset=ds).result(timeout=120)
        ok = srv.submit(tenant="t", label="plain", config=RunConfig(**dict(kw, tp_shards=1)),
                        dataset=ds).result(timeout=120)
    assert bad.status == "error" and "model shards=2 exceeds the 1 available devices" in bad.error
    assert ok.status == "ok"


@pytest.mark.parametrize("wd,shards", [(1, 2), (2, 2), (4, 2), (2, 4), (1, 8)])
def test_grid_positions_and_signature_match_jax(wd, shards):
    """World rank r sits where JAX's grid ``devs[:need].reshape(wd, shards)``
    puts device r; ranks past the grid hold no slots; the run_start mesh
    signature is JAX's (axes, sizes, ids)."""
    from erasurehead_tpu.train import cache as j_cache

    jm = j_2d_mesh(MODEL_AXIS, shards, wd)
    grid = np.vectorize(lambda d: d.id)(jm.devices)
    world = 8
    for r in range(world):
        m = t_mesh.WorkerMesh(ranks=tuple(range(wd * shards)), rank=r, world=world,
                              axis_name=MODEL_AXIS, shards=shards)
        if r >= wd * shards:
            assert not m.member and m.slice(8) == (8, 8)
            continue
        (i,), (a,) = np.nonzero(grid == r)
        assert (m.index, m.axis_index) == (i, a)
        assert m.row() == tuple(grid[i]) and m.column() == tuple(grid[:, a])
        assert m.slice(8) == (i * 8 // wd, (i + 1) * 8 // wd)
    assert m.shape == dict(jm.shape)
    assert t_trainer._mesh_signature(m, torch.device("cpu")) == j_cache.mesh_signature(jm)
