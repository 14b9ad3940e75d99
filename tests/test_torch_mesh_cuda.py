"""Card-side pins of the worker mesh (parallel/mesh.py, parallel/backend.py).

(a) A world-1 NCCL group formed in this process from a FileStore: the GLM
main path (materialized, ring with ``ring_pipeline`` off and on) and the
layer-coded deep path are bitwise the same runs with no group, with exact
kernel launch counts. (b) Two processes on the one card under gloo (NCCL
refuses two ranks on one GPU): B1 at a rank's stack against its plain
version, the ranks' params bitwise equal, ring bitwise materialized, and
within float32 reduction-order tolerance (rtol 1e-5) of the world-1 run.
Every test is marked ``cuda`` and skips without a card.

The module imports the port only, so that it also runs where the JAX
package is not installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_mesh_cuda.py``.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from erasurehead_tpu_torch.data import synthetic as t_syn
from erasurehead_tpu_torch.ops import kernels as t_kernels
from erasurehead_tpu_torch.parallel import backend as t_backend
from erasurehead_tpu_torch.parallel import mesh as t_mesh
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils import config as t_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, ROUNDS, N_ROWS, N_COLS = 12, 10, 12 * 400, 64
TRANSPORTS = ({}, dict(stack_mode="ring", ring_pipeline="off"),
              dict(stack_mode="ring", ring_pipeline="on"))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _cfg(**kw):
    base = dict(scheme="cyccoded", n_workers=W, n_stragglers=2, rounds=ROUNDS, n_rows=N_ROWS,
                n_cols=N_COLS, update_rule="AGD", lr_schedule=1.0, add_delay=True, seed=0)
    base.update(kw)
    return t_config.RunConfig(**base)


def _leaves(res):
    h = res.params_history
    return [h[k] for k in sorted(h)] if isinstance(h, dict) else [h]


def _counted(fn):
    t_kernels.reset_launches()
    res = fn()
    torch.cuda.synchronize()
    return res, dict(t_kernels.LAUNCHES)


@pytest.mark.cuda
def test_world_one_nccl_group_is_bitwise_the_run_without_a_group(tmp_path):
    _card()
    ds = t_syn.generate_gmm(N_ROWS, N_COLS, W, seed=0)
    cfg = _cfg()
    deep = _cfg(scheme="approx", num_collect=8, model="deepmlp", update_rule="GD",
                lr_schedule=0.5, layer_coding="on")
    ref, _ = _counted(lambda: t_trainer.train(cfg, ds))
    ref_deep, _ = _counted(lambda: t_trainer.train(deep, ds))
    store = torch.distributed.FileStore(str(tmp_path / "store"), 1)
    t_backend.initialize_distributed(world_size=1, rank=0, store=store, device="cuda")
    try:
        mesh = t_mesh.worker_mesh()
        assert mesh.distributed and mesh.backend == "nccl" and mesh.device.type == "cuda"
        for kw in TRANSPORTS:
            res, launches = _counted(lambda kw=kw: t_trainer.train(dataclasses.replace(cfg, **kw), ds))
            assert launches == {"fused_glm_grad": ROUNDS, "fused_block_decode": 0}, kw
            assert all(torch.equal(a, b) for a, b in zip(_leaves(res), _leaves(ref))), kw
        res, launches = _counted(lambda: t_trainer.train(deep, ds))
        assert launches == {"fused_glm_grad": 0, "fused_block_decode": ROUNDS}
        assert all(torch.equal(a, b) for a, b in zip(_leaves(res), _leaves(ref_deep)))
    finally:
        t_backend.shutdown()


_CHILD = textwrap.dedent("""
    import dataclasses, json, os, sys
    import numpy as np
    import torch

    from erasurehead_tpu_torch.data import synthetic as t_syn
    from erasurehead_tpu_torch.ops import kernels as t_kernels
    from erasurehead_tpu_torch.parallel import backend as t_backend
    from erasurehead_tpu_torch.train import trainer as t_trainer
    from erasurehead_tpu_torch.utils import config as t_config

    t_backend.initialize_distributed(device="cuda", backend="gloo", timeout_s=120)
    rank = torch.distributed.get_rank()
    kw = json.loads(os.environ["EH_CFG"])
    cfg = t_config.RunConfig(**kw)
    ds = t_syn.generate_gmm(kw["n_rows"], kw["n_cols"], kw["n_workers"], seed=0)
    g = torch.Generator().manual_seed(rank)
    M = kw["n_workers"] // 2 * 3
    X = torch.randn(M, 400, kw["n_cols"], generator=g).cuda()
    y = torch.sign(torch.randn(M, 400, generator=g)).cuda()
    b, w = torch.randn(kw["n_cols"], generator=g).cuda(), torch.randn(M, generator=g).cuda()
    got = t_kernels.fused_glm_grad(b, X, y, w, "logistic")
    want = t_kernels.reference_glm_grad(b, X, y, w, "logistic")
    out = {"b1_rel_err": np.array(float((got - want).abs().max() / want.abs().max()))}
    for name, extra in json.loads(os.environ["EH_TRANSPORTS"]).items():
        t_kernels.reset_launches()
        res = t_trainer.train(dataclasses.replace(cfg, **extra), ds)
        torch.cuda.synchronize()
        out[name] = res.params_history.cpu().numpy()
        out[name + ":b1"] = np.array(t_kernels.LAUNCHES["fused_glm_grad"])
    np.savez(os.path.join(os.environ["EH_OUT"], f"rank{rank}.npz"), **out)
    t_backend.shutdown()
""")


@pytest.mark.cuda
def test_world_two_on_one_card_under_gloo(tmp_path):
    _card()
    import json

    kw = dict(scheme="cyccoded", n_workers=W, n_stragglers=2, rounds=ROUNDS, n_rows=N_ROWS,
              n_cols=N_COLS, update_rule="AGD", lr_schedule=1.0, add_delay=True, seed=0)
    transports = {f"t{i}": kw_t for i, kw_t in enumerate(TRANSPORTS)}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": REPO, "WORLD_SIZE": "2", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "EH_OUT": str(tmp_path),
           "EH_CFG": json.dumps(kw), "EH_TRANSPORTS": json.dumps(transports)}
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD], env={**env, "RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO)
             for r in (0, 1)]
    try:
        logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in (0, 1)]
    ds = t_syn.generate_gmm(N_ROWS, N_COLS, W, seed=0)
    one = t_trainer.train(t_config.RunConfig(**kw), ds).params_history.cpu().numpy()
    for r in ranks:
        assert float(r["b1_rel_err"]) < 1e-5  # float32 sums in another order
        for name in transports:
            assert int(r[name + ":b1"]) == ROUNDS
            assert np.array_equal(r[name], ranks[0]["t0"]), name
    np.testing.assert_allclose(ranks[0]["t0"], one, rtol=1e-5, atol=1e-6)
