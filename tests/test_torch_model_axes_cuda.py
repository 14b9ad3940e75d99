"""Card-side pins of the model-internal axes (parallel/mesh.py's 2-D meshes,
parallel/ring.py, the models' ``for_mesh`` variants).

Two processes on the one card under gloo (NCCL refuses two ranks on one
GPU), each axis at 2 shards on the (1, 2) mesh: tensor-parallel mlp,
pipeline-parallel deepmlp, expert-parallel moe and sequence-parallel
attention under ring and Ulysses, 5 rounds each. The ranks' params are
bitwise equal; the trajectory is within the JAX package's test tolerance of
that axis of the unsharded run on the card (tp rtol 2e-4 / atol 2e-5; pp and
ep 5e-4 / 5e-5; seq rtol 5e-2 / atol 2e-5); neither kernel launches (the
model axes take the flattened-slot autograd step). Every test is marked
``cuda`` and skips without a card.

The module imports the port only: ``python -m pytest --noconftest -m cuda
tests/test_torch_model_axes_cuda.py``.
"""

import json
import os
import subprocess
import sys
import textwrap
import uuid

import numpy as np
import pytest
import torch

from erasurehead_tpu_torch.data import synthetic as t_syn
from erasurehead_tpu_torch.train import trainer as t_trainer
from erasurehead_tpu_torch.utils import config as t_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(scheme="approx", n_workers=6, n_stragglers=1, num_collect=4, rounds=5,
            n_rows=6 * 200, update_rule="GD", lr_schedule=0.5, add_delay=True, seed=0)
AXES = {
    "tp": (dict(BASE, model="mlp", n_cols=32, tp_shards=2), dict(rtol=2e-4, atol=2e-5)),
    "pp": (dict(BASE, model="deepmlp", n_cols=32, pp_shards=2), dict(rtol=5e-4, atol=5e-5)),
    "ep": (dict(BASE, model="moe", n_cols=32, ep_shards=2), dict(rtol=5e-4, atol=5e-5)),
    "seq_ring": (dict(BASE, model="attention", n_cols=64, seq_shards=2, update_rule="AGD",
                      lr_schedule=10.0), dict(rtol=5e-2, atol=2e-5)),
    "seq_ulysses": (dict(BASE, model="attention", n_cols=64, seq_shards=2, sp_form="ulysses",
                         update_rule="AGD", lr_schedule=10.0), dict(rtol=5e-2, atol=2e-5)),
}

_CHILD = textwrap.dedent("""
    import json, os
    import numpy as np
    import torch

    from erasurehead_tpu_torch.data import synthetic as t_syn
    from erasurehead_tpu_torch.ops import kernels as t_kernels
    from erasurehead_tpu_torch.parallel import backend as t_backend
    from erasurehead_tpu_torch.train import trainer as t_trainer
    from erasurehead_tpu_torch.utils import config as t_config

    t_backend.initialize_distributed(os.environ["EH_INIT"], device="cuda", backend="gloo",
                                     timeout_s=120)
    rank = torch.distributed.get_rank()
    out = {}
    for name, kw in json.loads(os.environ["EH_AXES"]).items():
        ds = t_syn.generate_gmm(kw["n_rows"], kw["n_cols"], kw["n_workers"], seed=0)
        t_kernels.reset_launches()
        res = t_trainer.train(t_config.RunConfig(**kw), ds)
        torch.cuda.synchronize()
        for k, v in res.params_history.items():
            out[f"{name}/{k}"] = v.cpu().numpy()
        out[f"{name}:launches"] = np.array(sum(t_kernels.LAUNCHES.values()))
    np.savez(os.path.join(os.environ["EH_OUT"], f"rank{rank}.npz"), **out)
    t_backend.shutdown()
""")


@pytest.mark.cuda
def test_model_axes_on_one_card_under_gloo(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card run of the model axes")
    axes = {name: kw for name, (kw, _) in AXES.items()}
    env = {**os.environ, "PYTHONPATH": REPO, "WORLD_SIZE": "2", "LOCAL_RANK": "0",
           "EH_INIT": "file://" + str(tmp_path / f"rdzv-{uuid.uuid4().hex}"),
           "EH_OUT": str(tmp_path), "EH_AXES": json.dumps(axes)}
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
    for name, (kw, tol) in AXES.items():
        unsharded = {k: v for k, v in kw.items() if not k.endswith("_shards")}
        ds = t_syn.generate_gmm(kw["n_rows"], kw["n_cols"], kw["n_workers"], seed=0)
        one = t_trainer.train(t_config.RunConfig(**unsharded), ds).params_history
        for k, v in one.items():
            got = ranks[0][f"{name}/{k}"]
            assert np.array_equal(ranks[1][f"{name}/{k}"], got), (name, k)
            np.testing.assert_allclose(got[-1], v[-1].cpu().numpy(), **tol, err_msg=f"{name}/{k}")
        assert int(ranks[0][f"{name}:launches"]) == 0
