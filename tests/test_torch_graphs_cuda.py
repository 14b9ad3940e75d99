"""Card-side pins of the compiled round loop (train/graphs.py): a run
replayed from its captured CUDA graphs is bitwise the same run's eager loop
(``graphs.disabled()``) on ``train``, ``train_dynamic``, ``train_cohort``
and the deep path, with the eager loop's launch counts; a second run of a
signature is an executable hit; ``scan_unroll`` sets the replays a chunk;
a program's tail graph and round counter, and its shared pool's bytes.
Every test is marked ``cuda`` and skips without a card.

The module imports the port only, so that it also runs where the JAX
package is not installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_graphs_cuda.py``.
"""

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from erasurehead_tpu_torch.data import synthetic as t_syn
from erasurehead_tpu_torch.ops import kernels as t_kernels
from erasurehead_tpu_torch.train import cache as t_cache
from erasurehead_tpu_torch.train import graphs as t_graphs
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils import config as t_config

W, ROUNDS, N_ROWS, N_COLS = 12, 10, 12 * 400, 64


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the CUDA kernels have no CPU mode")


def _cfg(**kw):
    base = dict(scheme="approx", num_collect=8, n_workers=W, n_stragglers=2, rounds=ROUNDS,
                n_rows=N_ROWS, n_cols=N_COLS, update_rule="AGD", lr_schedule=1.0,
                add_delay=True, seed=0)
    base.update(kw)
    return t_config.RunConfig(**base)


def _same(a, b) -> bool:
    def eq(x, y):
        lx, ly = pytree.tree_leaves(x), pytree.tree_leaves(y)
        return len(lx) == len(ly) and all(torch.equal(p, q) for p, q in zip(lx, ly))

    return (eq(a.params_history, b.params_history) and eq(a.final_params, b.final_params)
            and np.array_equal(a.timeset, b.timeset)
            and np.array_equal(a.worker_times, b.worker_times)
            and np.array_equal(a.collected, b.collected))


def _launched(run):
    t_kernels.reset_launches()
    out = run()
    torch.cuda.synchronize()
    return out, dict(t_kernels.LAUNCHES)


@pytest.fixture(scope="module")
def data():
    return t_syn.generate_gmm(N_ROWS, N_COLS, n_partitions=W, seed=0)


@pytest.mark.cuda
@pytest.mark.parametrize("entry,kw,want", [
    ("train", dict(), {"fused_glm_grad": ROUNDS, "fused_block_decode": 0}),
    ("train", dict(update_rule="ADAM", lr_schedule=0.05),
     {"fused_glm_grad": ROUNDS, "fused_block_decode": 0}),
    ("train", dict(update_rule="GD", pipeline_depth=1),
     {"fused_glm_grad": ROUNDS, "fused_block_decode": 0}),
    ("train", dict(model="deepmlp", update_rule="GD", lr_schedule=0.5, layer_coding="on"),
     {"fused_glm_grad": 0, "fused_block_decode": ROUNDS}),
    ("train_dynamic", dict(), {"fused_glm_grad": ROUNDS, "fused_block_decode": 0}),
    ("train_dynamic", dict(model="deepmlp", update_rule="GD", lr_schedule=0.5,
                           layer_coding="on"),
     {"fused_glm_grad": 0, "fused_block_decode": ROUNDS}),
], ids=["train", "adam", "pipelined", "deep", "dynamic", "dynamic_deep"])
def test_graph_run_is_bitwise_its_eager_run(entry, kw, want, data):
    _card()
    t_cache.clear()
    run = lambda: getattr(t_trainer, entry)(_cfg(**kw), data)  # noqa: E731
    first, first_l = _launched(run)
    hit, hit_l = _launched(run)
    with t_graphs.disabled():
        eager, eager_l = _launched(run)
    assert first_l == hit_l == eager_l == want
    assert first.cache_info["executor"] == "graph" and eager.cache_info["executor"] == "eager"
    assert [hit.cache_info["exec_hits"], hit.cache_info["exec_misses"]] == [1, 0]
    assert _same(first, eager) and _same(hit, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("kw,want", [
    (dict(compute_mode="deduped"), {"fused_glm_grad": 0, "fused_block_decode": 0}),
    (dict(model="deepmlp", update_rule="GD", lr_schedule=0.5, layer_coding="on"),
     {"fused_glm_grad": 0, "fused_block_decode": ROUNDS}),
], ids=["deduped", "deep"])
def test_graph_cohort_is_bitwise_its_eager_cohort(kw, want, data):
    _card()
    t_cache.clear()
    cfgs = [_cfg(seed=s, **kw) for s in (0, 1, 2, 3)]
    graph, graph_l = _launched(lambda: t_trainer.train_cohort(cfgs, data))
    with t_graphs.disabled():
        eager, eager_l = _launched(lambda: t_trainer.train_cohort(cfgs, data))
    assert graph_l == eager_l == want
    assert all(_same(a, b) for a, b in zip(graph, eager))


@pytest.mark.cuda
def test_scan_unroll_sets_the_replays_and_a_new_seed_hits(data):
    _card()
    t_cache.clear()
    base = t_trainer.train(_cfg(), data)
    for u, replays in ((1, ROUNDS), (4, 3), (ROUNDS, 1)):
        res = t_trainer.train(_cfg(scan_unroll=u), data)
        assert res.cache_info["memory_analysis"]["replays"] == replays
        assert _same(res, base)
    other = _cfg(seed=4, lr_schedule=np.linspace(2.0, 1.0, ROUNDS))
    hit = t_trainer.train(other, data)
    with t_graphs.disabled():
        eager = t_trainer.train(other, data)
    assert [hit.cache_info["exec_hits"], hit.cache_info["exec_misses"]] == [1, 0]
    assert _same(hit, eager)


@pytest.mark.cuda
def test_program_tail_counter_and_shared_pool():
    """A program's u-round graph and tail graph cover n rounds in order,
    reading each round's row at the device counter and writing its output
    there; the shared pool's bytes count once (graphs.pool_bytes) whatever
    the number of programs holding it."""
    import gc

    _card()
    t_cache.clear()
    gc.collect()  # the earlier tests' programs let go of the pool: a new one

    def round_fn(carry, row, consts):
        new = carry["x"] + row["v"] * consts["k"]
        return {"x": new}, new

    dev = torch.device("cuda")
    table = {"v": torch.arange(7.0, device=dev)}
    progs = [t_graphs.Program(round_fn, {"x": torch.zeros((), device=dev)}, table,
                              {"k": torch.tensor(2.0, device=dev)}, n=7, unroll=u)
             for u in (3, 7)]
    assert [(p.unroll, p.tail, p.replays) for p in progs] == [(3, 1, 3), (7, 0, 1)]
    for prog in progs:
        hist = torch.empty(7, device=dev)
        final = prog.run({"x": torch.ones((), device=dev)}, table,
                         {"k": torch.tensor(1.0, device=dev)}, hist)
        assert float(final["x"]) == 1 + 21 and hist.tolist() == [1, 2, 4, 7, 11, 16, 22]
    assert t_graphs.pool_bytes() == progs[-1].memory_analysis()["graph_pool_bytes"]
    assert t_graphs.pool_bytes() == sum(p.memory_analysis()["pool_growth_bytes"] for p in progs)
