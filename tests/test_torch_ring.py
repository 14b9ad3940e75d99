"""Ring and Ulysses attention across processes against the JAX package.

One gloo group of 4 CPU processes (a module-scoped fixture): each child
forms the sequence meshes ``worker_seq_mesh(2, 1)`` (ranks 0 and 1; ranks 2
and 3 outside the grid) and ``worker_seq_mesh(4, 1)``, runs
parallel/ring.py's ring and Ulysses transports on its shard of the same
numpy inputs, causal and not, then one backward pass of a fixed cotangent
through them, and saves its output and input-gradient shards. This process
holds the outputs against the JAX package's ``make_ring_attention_fn`` /
``make_ulysses_attention_fn`` on its 2- and 4-device CPU meshes, at the JAX
test's tolerance against its oracle (rtol 2e-5 / atol 2e-6), and the input
gradients against autograd through the port's ``reference_attention`` over
the whole sequence (rtol 1e-4 / atol 1e-5: the online softmax and the
all-to-all reduce in another order). The refusal of a head count that the
axis does not divide is JAX's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import textwrap
import torch
from jax.sharding import Mesh

from erasurehead_tpu.parallel import ring as j_ring
from erasurehead_tpu_torch.parallel import ring as t_ring
from test_torch_multiproc import _launch, _ok

T, D, H = 64, 16, 8
SHARDS = (2, 4)
OUT_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs():
    rng = np.random.default_rng(7)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return {
        "q": f(T, D), "k": f(T, D), "v": f(T, D), "cot": f(T, D),
        "qh": f(T, H, D), "kh": f(T, H, D), "vh": f(T, H, D), "coth": f(T, H, D),
        "q6": f(T, 6, D),
    }


_CHILD = textwrap.dedent("""
    import os
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from erasurehead_tpu_torch.parallel import backend

    backend.initialize_distributed(os.environ["EH_INIT"], device="cpu",
                                   timeout_s=float(os.environ["EH_TIMEOUT"]))
    from erasurehead_tpu_torch.parallel import mesh as mesh_lib, ring

    RANK = torch.distributed.get_rank()
    d = {k: torch.tensor(v) for k, v in np.load(os.environ["EH_INITS"]).items()}
    out = {}
    for n in (2, 4):
        mesh = mesh_lib.worker_seq_mesh(n, 1)  # every rank builds every mesh
        if not mesh.member:
            continue
        a, Tl = mesh.axis_index, d["q"].shape[0] // n
        part = lambda x: x[a * Tl:(a + 1) * Tl].clone().requires_grad_()
        for causal in (False, True):
            for form, names in (("ring", ("q", "k", "v", "cot")), ("ulysses", ("qh", "kh", "vh", "coth"))):
                q, k, v = (part(d[x]) for x in names[:3])
                make = ring.make_ring_attention_fn if form == "ring" else ring.make_ulysses_attention_fn
                o = make(mesh, causal=causal)(q, k, v)
                (o * d[names[3]][a * Tl:(a + 1) * Tl]).sum().backward()
                tag = f"{form}/{n}/{int(causal)}"
                out[tag] = o.detach().numpy()
                for x, t in zip("qkv", (q, k, v)):
                    out[f"{tag}/d{x}"] = t.grad.numpy()
        try:
            ring.make_ulysses_attention_fn(mesh)(*(d["q6"][a * Tl:(a + 1) * Tl],) * 3)
        except ValueError as e:
            out[f"refusal/{n}"] = np.array(str(e))
    np.savez(os.path.join(os.environ["EH_OUT"], f"rank{RANK}.npz"), **out)
""")


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ring4"))
    inputs = _inputs()
    _ok(_launch(4, _CHILD, out, {}, inputs))
    return [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(4)], inputs


def _gather(ranks, n, key):
    """The sequence shards of ranks 0..n-1, in axis order."""
    return np.concatenate([ranks[r][key] for r in range(n)])


def _seq_mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), (j_ring.SEQ_AXIS,))


def _reference(inputs, form, causal):
    """Output and input gradients by autograd through the port's oracle."""
    names = ("q", "k", "v", "cot") if form == "ring" else ("qh", "kh", "vh", "coth")
    q, k, v = (torch.tensor(inputs[x]).requires_grad_() for x in names[:3])
    heads = (lambda x: x) if form == "ring" else (lambda x: x.transpose(0, 1))
    o = heads(t_ring.reference_attention(heads(q), heads(k), heads(v), causal=causal))
    (o * torch.tensor(inputs[names[3]])).sum().backward()
    return o.detach().numpy(), {x: t.grad.numpy() for x, t in zip("qkv", (q, k, v))}


def test_ranks_outside_the_grid_run_nothing(cluster):
    ranks, _ = cluster
    assert not any(k.startswith(("ring/2", "ulysses/2")) for r in (2, 3) for k in ranks[r])
    assert all("ring/4/0" in ranks[r] for r in range(4))


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax_ring_attention(cluster, n, causal):
    ranks, inputs = cluster
    q, k, v = (jnp.asarray(inputs[x]) for x in "qkv")
    want = np.asarray(j_ring.make_ring_attention_fn(_seq_mesh(n), causal=causal)(q, k, v))
    np.testing.assert_allclose(_gather(ranks, n, f"ring/{n}/{int(causal)}"), want, **OUT_TOL)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax_ulysses_attention(cluster, n, causal):
    ranks, inputs = cluster
    q, k, v = (jnp.asarray(inputs[x]) for x in ("qh", "kh", "vh"))
    want = np.asarray(j_ring.make_ulysses_attention_fn(_seq_mesh(n), causal=causal)(q, k, v))
    np.testing.assert_allclose(_gather(ranks, n, f"ulysses/{n}/{int(causal)}"), want, **OUT_TOL)


@pytest.mark.parametrize("form", ["ring", "ulysses"])
@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("causal", [False, True])
def test_input_gradients_match_autograd_through_the_oracle(cluster, form, n, causal):
    ranks, inputs = cluster
    out, grads = _reference(inputs, form, causal)
    tag = f"{form}/{n}/{int(causal)}"
    np.testing.assert_allclose(_gather(ranks, n, tag), out, **OUT_TOL)
    for x in "qkv":
        np.testing.assert_allclose(_gather(ranks, n, f"{tag}/d{x}"), grads[x], **GRAD_TOL,
                                   err_msg=f"d{x}")


def test_ulysses_refuses_indivisible_heads_with_jax_message(cluster):
    ranks, _ = cluster
    q = jnp.zeros((T, 6, D), jnp.float32)
    with pytest.raises(ValueError) as want:
        j_ring.make_ulysses_attention_fn(_seq_mesh(4))(q, q, q)
    assert all(str(ranks[r]["refusal/4"]) == str(want.value) for r in range(4))
    assert "refusal/2" not in ranks[0]  # 6 heads divide over 2
