"""The port's worker mesh, distributed init and ring plan against the JAX package.

One process: ``initialize_distributed`` with no cluster, the mesh's rules
(a prefix of the world, the auto-mesh divisor, divisibility, the 2-D meshes'
refusal), ``mesh_signature``, the ring plan's ``sel`` and ``n_hops``
byte-equal to JAX's (data/sharding.plan_ring_transport), the ``stack_mode``
and ``ring_pipeline`` validation with JAX's messages, and the ring transport
at world size 1 (one hop: a per-round local gather) bitwise the materialized
run. The runs across processes are in tests/test_torch_multiproc.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from erasurehead_tpu.data import sharding as j_sharding
from erasurehead_tpu.ops import codes as j_codes
from erasurehead_tpu.parallel import backend as j_backend
from erasurehead_tpu.parallel import mesh as j_mesh
from erasurehead_tpu.train import cache as j_cache
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.utils.config import RunConfig as JRunConfig
from erasurehead_tpu_torch.data import sharding
from erasurehead_tpu_torch.data.synthetic import generate_gmm
from erasurehead_tpu_torch.ops import codes
from erasurehead_tpu_torch.parallel import backend, mesh as mesh_lib
from erasurehead_tpu_torch.train import cache as cache_lib, trainer
from erasurehead_tpu_torch.utils.config import RunConfig


@pytest.fixture
def no_cluster_env(monkeypatch):
    for name in backend.CLUSTER_ENV:
        monkeypatch.delenv(name, raising=False)


# ---------------------------------------------------------------------------
# backend


def test_initialize_distributed_is_a_noop_alone(no_cluster_env):
    info = backend.initialize_distributed()
    assert not torch.distributed.is_initialized()
    assert info == backend.initialize_distributed()  # idempotent
    assert set(info) == set(j_backend.topology_info())
    assert (info["process_index"], info["process_count"], info["global_devices"]) == (0, 1, 1)
    assert backend.group_device() is None and backend.world_size() == 1


def test_rank_without_world_size_raises_naming_it(no_cluster_env, monkeypatch):
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        backend.initialize_distributed(device="cpu")
    monkeypatch.delenv("RANK")
    with pytest.raises(ValueError, match="no world size"):
        backend.initialize_distributed(rank=0, device="cpu")
    with pytest.raises(ValueError, match="RANK"):
        backend.initialize_distributed(world_size=2, device="cpu")
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# the mesh


def test_worker_mesh_is_this_process_without_a_group():
    m = mesh_lib.worker_mesh()
    assert (m.ranks, m.rank, m.world, m.size, m.index) == ((0,), 0, 1, 1, 0)
    assert m.member and not m.distributed and m.device is None
    assert m.shape == {mesh_lib.WORKER_AXIS: 1} and m.axis_names == ("workers",)
    assert m.slice(30) == (0, 30)
    grad = torch.arange(4.0)
    assert m.all_reduce(grad) is grad  # the identity: no collective
    with pytest.raises(ValueError, match="asked for 2 devices, have 1"):
        mesh_lib.worker_mesh(2)


@pytest.mark.parametrize("world", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("need", [4, 12, 30])
def test_auto_mesh_is_the_largest_divisor(monkeypatch, world, need):
    """The JAX trainer's _auto_mesh rule: W = 30 over 4 processes uses 3."""
    monkeypatch.setattr(backend, "world_size", lambda: world)
    got = mesh_lib.auto_mesh(need)
    assert got.size == max(d for d in range(1, world + 1) if need % d == 0)
    assert got.ranks == tuple(range(got.size))
    if world == 8:  # the test harness's 8 CPU devices
        assert got.size == j_trainer._auto_mesh(need).shape["workers"]


def test_auto_mesh_w30_over_four_processes_uses_three(monkeypatch):
    monkeypatch.setattr(backend, "world_size", lambda: 4)
    assert mesh_lib.auto_mesh(30).size == 3


def test_ranks_outside_the_worker_group_hold_no_slots():
    m = mesh_lib.WorkerMesh(ranks=(0, 1, 2), rank=3, world=4)
    assert not m.member and m.index is None and m.slice(30) == (30, 30)
    m1 = dataclasses.replace(m, rank=1)
    assert m1.member and m1.index == 1 and m1.slice(30) == (10, 20) and m1.slice(60) == (20, 40)


@pytest.mark.parametrize("n,d", [(7, 3), (30, 4), (10, 3)])
def test_check_divisible_matches_jax(n, d):
    jm = j_mesh.worker_mesh(d)
    with pytest.raises(ValueError) as want:
        j_mesh.check_divisible(n, jm, "n_workers")
    with pytest.raises(ValueError) as got:
        mesh_lib.check_divisible(n, mesh_lib.WorkerMesh(ranks=tuple(range(d))), "n_workers")
    assert str(got.value) == str(want.value)
    mesh_lib.check_divisible(12, mesh_lib.WorkerMesh(ranks=(0, 1, 2)), "n_workers")


def test_axis_active():
    m = mesh_lib.WorkerMesh(ranks=(0, 1))
    assert mesh_lib.axis_active(m, mesh_lib.WORKER_AXIS)
    assert not mesh_lib.axis_active(mesh_lib.WorkerMesh(ranks=(0,)), mesh_lib.WORKER_AXIS)
    assert not mesh_lib.axis_active(m, mesh_lib.MODEL_AXIS)
    assert mesh_lib.axis_active(m, "workers") == j_mesh.axis_active(j_mesh.worker_mesh(2), "workers")


def test_ring_order_devices_passes_the_order_through():
    order = [3, 1, 2, 0]
    assert mesh_lib.ring_order_devices(order) == order
    devs = jax.devices()[:4]
    assert j_mesh.ring_order_devices(devs) == list(devs)  # JAX on CPU devices too


@pytest.mark.parametrize("make", [
    lambda: mesh_lib.worker_seq_mesh(2, 2),
    lambda: mesh_lib.worker_tp_mesh(2, 2),
    lambda: mesh_lib.worker_plus_axis_mesh("pipe", 2, 2),
])
def test_two_dimensional_meshes_name_a9b(make):
    """One process without a group is one device: a 2x2 grid cannot form,
    and the refusal is JAX's on one device (the 2-D meshes themselves run
    across processes, tests/test_torch_model_axes.py)."""
    with pytest.raises(ValueError) as want:
        j_mesh.worker_plus_axis_mesh("pipe", 2, 2, devices=jax.devices()[:1])
    with pytest.raises(ValueError) as got:
        make()
    assert str(got.value) == str(want.value) == "mesh 2x2 needs 4 devices, have 1"


def test_require_one_process_names_a9b(monkeypatch):
    mesh_lib.require_one_process("x")
    with pytest.raises(ValueError, match="world size 2 it waits for ROADMAP A9b"):
        mesh_lib.require_one_process("x", mesh_lib.WorkerMesh(ranks=(0, 1), world=2))


def test_mesh_signature():
    m = mesh_lib.worker_mesh()
    assert cache_lib.mesh_signature(m, torch.device("cpu")) == (("workers",), (1,), (0,), 1, "cpu")
    # the run_start record keeps the JAX package's (axes, sizes, ids) shape
    assert trainer._mesh_signature(m, torch.device("cpu")) == (("workers",), (1,), (0,))
    jm = j_mesh.worker_mesh(1)
    assert trainer._mesh_signature(m, torch.device("cpu")) == j_cache.mesh_signature(jm)
    four = mesh_lib.WorkerMesh(ranks=(0, 1, 2), rank=3, world=4)
    assert cache_lib.mesh_signature(four, torch.device("cpu")) == (("workers",), (3,), (0, 1, 2), 4, "cpu")


# ---------------------------------------------------------------------------
# the ring plan, byte-equal to JAX's


def _layouts():
    """(port layout, JAX layout) pairs: cyclic, FRC and general assignments."""
    return {
        "cyclic": (codes.cyclic_mds_layout(12, 2), j_codes.cyclic_mds_layout(12, 2)),
        "frc": (codes.frc_layout(12, 2), j_codes.frc_layout(12, 2)),
        "randreg": (codes.random_regular_layout(12, 3, seed=7),
                    j_codes.random_regular_layout(12, 3, seed=7)),
        "partial_cyclic": (codes.partial_cyclic_layout(12, 4, 2),
                           j_codes.partial_cyclic_layout(12, 4, 2)),
        "partial_frc": (codes.partial_frc_layout(12, 4, 2), j_codes.partial_frc_layout(12, 4, 2)),
    }


@pytest.mark.parametrize("name", ["cyclic", "frc", "randreg", "partial_cyclic", "partial_frc"])
@pytest.mark.parametrize("D", [1, 2, 3, 4, 6])
def test_ring_plan_is_byte_equal_to_jax(name, D):
    layout, jlayout = _layouts()[name]
    got = sharding.plan_ring_transport(layout, D)
    want = j_sharding.plan_ring_transport(jlayout, D)
    assert (got.n_devices, got.n_hops) == (want.n_devices, want.n_hops)
    assert got.sel.dtype == want.sel.dtype and got.sel.tobytes() == want.sel.tobytes()
    assert sharding._ring_hops(layout, D) == j_sharding._ring_hops(jlayout, D)
    assert (got.local_workers, got.n_slots) == (want.local_workers, want.n_slots)


def test_ring_plan_hop_counts():
    cyc, frc = codes.cyclic_mds_layout(12, 2), codes.frc_layout(12, 2)
    assert sharding.plan_ring_transport(cyc, 4).n_hops == 2  # 1 + ceil(s / Pl)
    assert sharding.plan_ring_transport(frc, 4).n_hops == 1  # block-local groups
    assert sharding.plan_ring_transport(cyc, 1).n_hops == 1  # one rank: a local gather


def test_ring_plan_divisibility_guard_matches_jax():
    with pytest.raises(ValueError) as want:
        j_sharding.plan_ring_transport(j_codes.cyclic_mds_layout(12, 2), 5)
    with pytest.raises(ValueError, match="divisible") as got:
        sharding.plan_ring_transport(codes.cyclic_mds_layout(12, 2), 5)
    assert str(got.value) == str(want.value)


def test_ring_auto_resolves_by_footprint_as_jax(monkeypatch):
    layout, jlayout = codes.frc_layout(8, 1), j_codes.frc_layout(8, 1)
    from erasurehead_tpu.data.synthetic import generate_gmm as j_generate_gmm

    data, jdata = generate_gmm(64, 16, 8, seed=0), j_generate_gmm(64, 16, n_partitions=8, seed=0)
    for threshold in (1 << 30, 1):
        monkeypatch.setattr(sharding, "RING_AUTO_MIN_BYTES", threshold)
        monkeypatch.setattr(j_sharding, "RING_AUTO_MIN_BYTES", threshold)
        for mode in ("auto", "ring", "materialized"):
            for D in (1, 3):
                got = sharding.resolve_ring_stack(mode, layout, data, D, "float32", device="cpu")
                want = j_sharding.resolve_ring_stack(mode, jlayout, jdata, D, np.float32)
                assert got == want, (threshold, mode, D)
    assert not sharding.resolve_ring_stack("auto", layout, data, 1, "float32", device="cpu",
                                           supported=False)
    assert not sharding.resolve_ring_stack(
        "auto", codes.uncoded_layout(8), data, 1, "float32", device="cpu")  # nothing redundant


# ---------------------------------------------------------------------------
# config


@pytest.mark.parametrize("kw", [
    dict(stack_mode="bogus"),
    dict(ring_pipeline="sometimes"),
    dict(stack_mode="ring", compute_mode="deduped"),
    dict(stack_mode="ring", arrival_mode="measured"),
    dict(stack_mode="ring", use_pallas="on"),
])
def test_ring_config_validation_matches_jax(kw):
    base = dict(scheme="approx", n_workers=8, n_stragglers=1)
    with pytest.raises(ValueError) as want:
        JRunConfig(**base, **kw)
    with pytest.raises(ValueError) as got:
        RunConfig(**base, **kw)
    assert str(got.value) == str(want.value)


def test_ring_fields_are_keyed_as_jax_keys_them():
    for kw in (dict(), dict(stack_mode="ring", ring_pipeline="on"), dict(stack_mode="auto")):
        got = RunConfig(scheme="approx", **kw).static_signature_fields()
        want = JRunConfig(scheme="approx", **kw).static_signature_fields()
        for key in ("stack_mode", "ring_pipeline"):
            assert got[key] == want[key]
        order = [k for k in want if k in got]
        assert list(got) == order  # JAX's order, restricted to the port's fields
    assert RunConfig().stack_mode == JRunConfig().stack_mode == "materialized"
    assert RunConfig().ring_pipeline == JRunConfig().ring_pipeline == "auto"
    missing = {f.name for f in dataclasses.fields(JRunConfig)} - {
        f.name for f in dataclasses.fields(RunConfig)}
    assert missing == set()  # donate and scan_unroll came with the compiled round loop


# ---------------------------------------------------------------------------
# the ring transport in one process: one hop, a local gather


def _cfg(**kw):
    base = dict(scheme="naive", n_workers=12, n_stragglers=1, rounds=3, n_rows=96,
                n_cols=16, lr_schedule=0.5, update_rule="AGD", add_delay=True, seed=0)
    base.update(kw)
    return RunConfig(**base)


@pytest.fixture(scope="module")
def gmm12():
    return generate_gmm(96, 16, 24, seed=0)


@pytest.mark.parametrize("scheme,extra", [
    ("naive", {}),
    ("cyccoded", dict(n_stragglers=2)),
    ("repcoded", dict(n_stragglers=2)),
    ("approx", dict(n_stragglers=2, num_collect=6)),
    ("avoidstragg", dict(n_stragglers=2)),
    ("partialcyccoded", dict(n_stragglers=2, partitions_per_worker=4)),
    ("partialrepcoded", dict(n_stragglers=2, partitions_per_worker=4)),
])
def test_one_process_ring_is_bitwise_materialized(gmm12, scheme, extra):
    cfg = _cfg(scheme=scheme, **extra)
    m = trainer.train(cfg, gmm12, device="cpu")
    for pipe, name in (("off", "sequential"), ("on", "pipelined")):
        r = trainer.train(dataclasses.replace(cfg, stack_mode="ring", ring_pipeline=pipe),
                          gmm12, device="cpu")
        assert r.cache_info["stack_mode"] == "ring" and r.cache_info["ring_pipeline"] == name
        assert r.lowering == m.lowering
        assert torch.equal(r.params_history, m.params_history), (scheme, pipe)
        if m.layout.storage_overhead > 1:  # the resident stack holds no redundancy
            assert r.cache_info["stack_bytes"] < m.cache_info["stack_bytes"]
    assert m.cache_info["stack_mode"] == "materialized" and m.cache_info["ring_pipeline"] is None


@pytest.mark.parametrize("extra", [
    dict(use_pallas="off"),
    dict(flat_grad="on"),
    dict(margin_flat="on"),
    dict(dtype="bfloat16"),
    dict(model="deepmlp", update_rule="GD", layer_coding="on"),
    dict(model="mlp", update_rule="GD"),
])
def test_one_process_ring_composes_with_every_lowering(gmm12, extra):
    cfg = _cfg(scheme="approx", n_stragglers=2, num_collect=6, **extra)
    m = trainer.train(cfg, gmm12, device="cpu")
    r = trainer.train(dataclasses.replace(cfg, stack_mode="ring"), gmm12, device="cpu")
    assert r.lowering == m.lowering
    for a, b in zip(_leaves(m.params_history), _leaves(r.params_history)):
        assert torch.equal(a, b), extra


def _leaves(tree):
    return [tree[k] for k in sorted(tree)] if isinstance(tree, dict) else [tree]


def test_one_process_ring_dynamic_and_cohort(gmm12):
    cfg = _cfg(scheme="cyccoded", n_stragglers=2)
    ring = dataclasses.replace(cfg, stack_mode="ring")
    assert torch.equal(trainer.train_dynamic(ring, gmm12, device="cpu").params_history,
                       trainer.train_dynamic(cfg, gmm12, device="cpu").params_history)
    got = trainer.train_cohort(ring, gmm12, seeds=[0, 1], device="cpu")
    want = trainer.train_cohort(cfg, gmm12, seeds=[0, 1], device="cpu")
    assert got[0].cohort["stack_mode"] == "ring" and want[0].cohort["stack_mode"] == "materialized"
    for g, w in zip(got, want):
        assert torch.equal(g.params_history, w.params_history)


def test_ring_stack_is_partition_major(gmm12):
    cfg = _cfg(scheme="cyccoded", n_stragglers=2, stack_mode="ring")
    model, X = trainer.resolved_stack(cfg, gmm12, device="cpu")
    assert tuple(X.shape) == (12, 8, 16)  # [P, rows, F]
    _, Xw = trainer.resolved_stack(dataclasses.replace(cfg, stack_mode="materialized"),
                                   gmm12, device="cpu")
    assert tuple(Xw.shape) == (12, 3, 8, 16)  # [W, S, rows, F]
    assert trainer.estimate_stack_bytes(cfg, gmm12) * 3 == trainer.estimate_stack_bytes(
        dataclasses.replace(cfg, stack_mode="materialized"), gmm12)


def test_windowed_ring_streaming_names_a9b(gmm12):
    """Windowed ring streaming, which this test once found refused (naming
    ROADMAP A9b), runs: at world size 1 the ring fill of a staged window is
    a local gather, so the run is bitwise the windowed materialized run,
    while its window stays partition-major (window plus halo) and "auto"
    resolves to the ring on this redundant layout."""
    cfg = _cfg(scheme="cyccoded", n_stragglers=2, stack_mode="ring",
               stack_residency="streamed", stream_window=6, compute_mode="faithful")
    ring = trainer.train(cfg, gmm12, device="cpu")
    auto = trainer.train(dataclasses.replace(cfg, stack_mode="auto"), gmm12, device="cpu")
    mat = trainer.train(dataclasses.replace(cfg, stack_mode="materialized"), gmm12, device="cpu")
    assert ring.cache_info["stack_mode"] == auto.cache_info["stack_mode"] == "ring"
    assert ring.cache_info["ring_pipeline"] == "sequential"
    assert mat.cache_info["stack_mode"] == "materialized"
    assert torch.equal(ring.params_history, mat.params_history)
    assert torch.equal(auto.params_history, mat.params_history)
    ci = ring.cache_info
    assert (ci["stream_halo"], ci["stream_group_workers"], ci["stream_staged_partitions"]) == (2, 6, 8)
    assert ci["stack_bytes"] == 8 * 8 * (16 + 1) * 4  # [8, rows, F] and [8, rows], float32
    assert mat.cache_info["stack_bytes"] == 6 * 3 * 8 * (16 + 1) * 4  # [gw, S, rows, F]
