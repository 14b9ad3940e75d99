"""The multi-leaf decode (kernel B2: one launch for every leaf of a round).

``fused_block_decode_leaves(ws, leaves)`` decodes each leaf in place in the
layer-coded step's slot layout: [W, S, *shape] leaves with [W, S] weights
(the faithful contract, reduced s-major) or [P, *shape] leaves with [P]
weights. Its plain version is, leaf by leaf, the s-major copy through
``reference_block_decode``: what the step computed before the kernel read
the layout in place, so it must equal that bitwise. Each decoded leaf is
also held to the JAX package's ``fused_block_decode`` on the s-major
flattening, in its XLA form and as its Pallas kernel in interpret mode:
float32 within 1e-6 * sum_m |w_m g_md| + 1e-7 per column (the port sums the
slots in order, XLA's dot in its own order), bfloat16 within one bfloat16
ulp (both round a float32 sum once). The ``cuda``-marked tests hold the
kernel to its plain version bitwise on the card and skip where there is
none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erasurehead_tpu.ops import kernels as j_kernels
from erasurehead_tpu_torch.ops import kernels as t_kernels

# deepmlp's per-slot leaves at F = 128 in sorted-key order (W, W_in, b,
# b_in, b_out, w_out): the deep path's six leaves
DEEP_SHAPES = [(4, 32, 32), (128, 32), (4, 32), (32,), (), (32,)]
SMALL_SHAPES = [(3, 5), (7,), (), (2, 2, 4), (1,)]


def _case(lead, shapes, seed, zero_every=3):
    rng = np.random.default_rng(seed)
    ws = rng.standard_normal(lead).astype(np.float32)
    ws.reshape(-1)[::zero_every] = 0.0
    leaves = [rng.standard_normal(lead + s).astype(np.float32) for s in shapes]
    return ws, leaves


def _s_major(ws, leaf):
    """The faithful contract's reduction order: slot m = s * W + w."""
    M = ws.size
    if ws.ndim == 2:
        return ws.T.reshape(M), np.ascontiguousarray(leaf.swapaxes(0, 1)).reshape(M, -1)
    return ws, leaf.reshape(M, -1)


def _torch(ws, leaves, dtype):
    return torch.from_numpy(ws), [torch.from_numpy(l).to(dtype) for l in leaves]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead", [(6, 3), (18,), (5, 1)])
def test_plain_version_is_the_per_leaf_decode_of_s_major_copies(lead, dtype):
    ws, leaves = _case(lead, SMALL_SHAPES, seed=sum(lead))
    tws, tleaves = _torch(ws, leaves, dtype)
    got = t_kernels.reference_block_decode_leaves(tws, tleaves)
    for out, leaf, shape in zip(got, tleaves, SMALL_SHAPES):
        wf, g = _s_major(ws, leaf.float().numpy())
        want = t_kernels.reference_block_decode(
            torch.from_numpy(wf), torch.from_numpy(g).to(dtype)
        )
        assert out.dtype == dtype and tuple(out.shape) == shape
        assert torch.equal(out.reshape(-1), want)


@pytest.mark.parametrize("lead", [(30, 3), (90,)])
def test_wrapper_on_the_cpu_takes_the_plain_version(lead):
    ws, leaves = _case(lead, DEEP_SHAPES, seed=11)
    tws, tleaves = _torch(ws, leaves, torch.float32)
    before = dict(t_kernels.LAUNCHES)
    got = t_kernels.fused_block_decode_leaves(tws, tleaves)
    assert t_kernels.LAUNCHES == before  # the CPU path launches nothing
    want = t_kernels.reference_block_decode_leaves(tws, tleaves)
    assert [tuple(g.shape) for g in got] == DEEP_SHAPES
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _jax_decodes(wf, g, jdtype):
    jw, jg = jnp.asarray(wf), jnp.asarray(g).astype(jdtype)
    xla = j_kernels.fused_block_decode(jw, jg)
    pallas = j_kernels.fused_block_decode(jw, jg, use_pallas=True, interpret=True)
    return [np.asarray(a.astype(jnp.float32)) for a in (xla, pallas)]


@pytest.mark.parametrize("lead", [(6, 3), (18,)])
def test_each_leaf_matches_jax_f32(lead):
    ws, leaves = _case(lead, SMALL_SHAPES + [(130,)], seed=5)
    got = t_kernels.fused_block_decode_leaves(*_torch(ws, leaves, torch.float32))
    for out, leaf in zip(got, leaves):
        wf, g = _s_major(ws, leaf)
        tol = 1e-6 * np.abs(wf[:, None] * g).sum(0) + 1e-7
        for want in _jax_decodes(wf, g, jnp.float32):
            assert (np.abs(out.numpy().reshape(-1) - want) <= tol).all()


@pytest.mark.parametrize("lead", [(6, 3), (18,)])
def test_each_leaf_matches_jax_bf16(lead):
    ws, leaves = _case(lead, SMALL_SHAPES + [(130,)], seed=6)
    got = t_kernels.fused_block_decode_leaves(*_torch(ws, leaves, torch.bfloat16))
    for out, leaf in zip(got, leaves):
        assert out.dtype == torch.bfloat16
        got32 = out.float().numpy().reshape(-1)
        # one ulp of a bfloat16 value v is 2**(exponent(v) - 7)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(got32), 1e-30))) - 7)
        wf, g = _s_major(ws, leaf)
        for want in _jax_decodes(wf, g, jnp.bfloat16):
            assert (np.abs(got32 - want) <= ulp).all()


@pytest.mark.parametrize(
    "bad",
    [
        dict(ws=torch.zeros(2, 3, dtype=torch.float64)),  # non-f32 weights
        dict(ws=torch.zeros(3, 2)),  # slot count W*S differs from the leaves'
        dict(leaves=[torch.zeros(2, 3, 4), torch.zeros(2, 3, 4, dtype=torch.bfloat16)]),
        dict(leaves=[torch.zeros(2, 3, 4), torch.zeros(2, 3, 4, device="meta")]),
        dict(leaves=[torch.zeros(2, 3, 4), torch.zeros(4, 3, 2).transpose(0, 2)]),
        dict(leaves=[torch.zeros(2, 3, 4, dtype=torch.float16)]),
        dict(leaves=[torch.zeros(6, 4)]),  # the slots flattened: not [W, S, ...]
        dict(leaves=[torch.zeros(2, 3, 0)]),
        dict(leaves=[]),
        dict(ws=torch.zeros(2, 3, 1)),
        dict(ws=torch.zeros(3, 2).t()),  # non-contiguous weights
    ],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    args = dict(ws=torch.zeros(2, 3), leaves=[torch.zeros(2, 3, 4), torch.zeros(2, 3)])
    args.update(bad)
    with pytest.raises(ValueError):
        t_kernels.fused_block_decode_leaves(**args)


# ---------------------------------------------------------------------------
# on the card


def _cuda_case(lead, shapes, dtype, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    ws, leaves = _case(lead, shapes, seed)
    return torch.from_numpy(ws).cuda(), [torch.from_numpy(l).to(dtype).cuda() for l in leaves]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "lead,shapes",
    [
        ((30, 3), DEEP_SHAPES),  # the deep path's round
        ((200, 3), DEEP_SHAPES),  # M = 600: beyond one shared-memory stage
        ((43, 3), [(7,), (4098,), ()]),  # M = 129: one slot past one stage
        ((90,), SMALL_SHAPES),  # the partition-major contract
        ((30, 3), [(d,) for d in range(1, 41)]),  # 40 leaves: past the cap
    ],
)
def test_cuda_leaves_bitwise_equal_plain_version(lead, shapes, dtype):
    ws, leaves = _cuda_case(lead, shapes, dtype, seed=len(shapes) + sum(lead))
    cap = 32  # the kernel's leaves per launch
    before = t_kernels.LAUNCHES["fused_block_decode"]
    got = t_kernels.fused_block_decode_leaves(ws, leaves)
    again = t_kernels.fused_block_decode_leaves(ws, leaves)
    want = t_kernels.reference_block_decode_leaves(ws, leaves)
    torch.cuda.synchronize()
    assert t_kernels.LAUNCHES["fused_block_decode"] == before + 2 * -(-len(shapes) // cap)
    for a, b, c in zip(got, again, want):
        assert a.dtype == dtype and torch.equal(a, c) and torch.equal(a, b)
