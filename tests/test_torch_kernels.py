"""The port's two kernels against the JAX package's Pallas kernels.

On the CPU each wrapper takes its plain PyTorch version (a CUDA kernel has
no interpret mode); the JAX side runs its Pallas kernel in interpret mode
and its XLA oracle. The cases are those of tests/test_kernels.py.

fused_glm_grad: rtol 1e-5, atol 1e-4, the JAX tests' tolerance (float32
sums in a different order). fused_block_decode: float32 within
1e-6 * sum_m |w_m g_md| + 1e-7 per column (the port sums the slots in order,
XLA's dot in its own order); bfloat16 within one bfloat16 ulp of the result
(both round a float32 sum once). The card itself is checked by the
``cuda``-marked tests, which skip where there is no card: there the kernel
must equal its plain version bitwise. The device guard (each launch with
its tensors' card current) is held here with a stand-in library, and on a
host with two cards by a ``cuda`` test.
"""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from erasurehead_tpu.ops import kernels as j_kernels
from erasurehead_tpu_torch.ops import kernels as t_kernels
from erasurehead_tpu_torch.parallel import step as t_step

RTOL, ATOL = 1e-5, 1e-4


def _case(M, R, F, seed=7):
    rng = np.random.default_rng(seed + M * 1000 + R * 10 + F)
    X = rng.standard_normal((M, R, F)).astype(np.float32)
    y = np.sign(rng.standard_normal((M, R))).astype(np.float32)
    b = rng.standard_normal(F).astype(np.float32)
    w = rng.standard_normal(M).astype(np.float32)
    return b, X, y, w


def _both(b, X, y, w, kind, x_dtype=torch.float32):
    tX = torch.from_numpy(X).to(x_dtype)
    got = t_kernels.fused_glm_grad(
        torch.from_numpy(b), tX, torch.from_numpy(y), torch.from_numpy(w), kind
    )
    return got, tX


@pytest.mark.parametrize("kind", t_kernels.GLM_KINDS)
@pytest.mark.parametrize("shape", [(6, 40, 32), (3, 17, 128), (1, 8, 64)])
def test_fused_matches_jax_kernel_and_oracle(kind, shape):
    b, X, y, w = _case(*shape)
    before = dict(t_kernels.LAUNCHES)
    got, _ = _both(b, X, y, w, kind)
    assert t_kernels.LAUNCHES == before  # the CPU path launches nothing
    assert got.dtype == torch.float32 and got.shape == (shape[2],)
    jargs = tuple(map(jnp.asarray, (b, X, y, w)))
    pallas = j_kernels.fused_glm_grad(*jargs, kind, interpret=True, block_rows=16)
    oracle = j_kernels.reference_glm_grad(*jargs, kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", t_kernels.GLM_KINDS)
def test_fused_bf16_stream_matches_f32_oracle(kind):
    """A bfloat16 stack is upcast once and contracted in float32: it matches
    the float32 oracle on the bf16-rounded data to float32 tolerance."""
    b, X, y, w = _case(4, 33, 64)
    got, tX = _both(b, X, y, w, kind, torch.bfloat16)
    Xr = tX.float().numpy()  # the bf16-rounded values, as float32
    want = j_kernels.reference_glm_grad(*map(jnp.asarray, (b, Xr, y, w)), kind)
    jb = jnp.asarray(X).astype(jnp.bfloat16)
    pallas = j_kernels.fused_glm_grad(
        jnp.asarray(b), jb, jnp.asarray(y), jnp.asarray(w), kind,
        interpret=True, block_rows=16,
    )
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=RTOL, atol=ATOL)


def test_zero_weight_slots_drop_out():
    """A slot with weight 0 (an erased message) contributes nothing."""
    b, X, y, w = _case(4, 24, 32)
    w[2] = 0.0
    got, _ = _both(b, X, y, w, "logistic")
    keep = [0, 1, 3]
    want = j_kernels.reference_glm_grad(
        *map(jnp.asarray, (b, X[keep], y[keep], w[keep])), "logistic"
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lead", [(3, 2), (6,)])
def test_fused_grad_fn_flattens_leading_dims(lead):
    """make_fused_grad_fn takes a [W, S, R, F] or [P, R, F] stack with
    [W, S] / [P] weights, as the JAX package's make_fused_grad_fn does."""
    M = int(np.prod(lead))
    b, X, y, w = _case(M, 20, 16)
    fn = t_step.make_fused_grad_fn("logistic")
    got = fn(
        torch.from_numpy(b),
        torch.from_numpy(X.reshape(lead + X.shape[1:])),
        torch.from_numpy(y.reshape(lead + y.shape[1:])),
        torch.from_numpy(w.reshape(lead)),
    )
    want = j_kernels.reference_glm_grad(*map(jnp.asarray, (b, X, y, w)), "logistic")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", t_kernels.GLM_KINDS)
def test_wrapper_takes_wide_stacks(kind):
    """Rows wider than a lane's registers: on the card they take the
    kernel's column path (a CTA's threads split the columns), and wider
    rows its cluster or re-read path, so the wrapper refuses no width."""
    b, X, y, w = _case(2, 9, 2500)
    X /= np.float32(50.0)  # unit-scale margins, as for the narrow cases
    got, _ = _both(b, X, y, w, kind)
    want = j_kernels.reference_glm_grad(*map(jnp.asarray, (b, X, y, w)), kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "bad",
    [
        dict(X=torch.zeros(2, 3, 4, dtype=torch.float64)),
        dict(X=torch.zeros(2, 3)),
        dict(X=torch.zeros(2, 0, 4), y=torch.zeros(2, 0)),
        dict(y=torch.zeros(2, 4)),
        dict(w=torch.zeros(3)),
        dict(beta=torch.zeros(4, dtype=torch.float64)),
        dict(kind="probit"),
    ],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    args = dict(
        beta=torch.zeros(4), X=torch.zeros(2, 3, 4), y=torch.zeros(2, 3),
        w=torch.zeros(2), kind="logistic",
    )
    args.update(bad)
    with pytest.raises(ValueError):
        t_kernels.fused_glm_grad(**args)


@pytest.mark.parametrize("F", [16384, 20000, 131073])
def test_wrapper_takes_rows_wider_than_a_cta(F):
    """The widest column-path rows, rows a cluster of CTAs splits, and rows
    past what a cluster holds (re-read): the wrapper takes every width,
    and on the CPU its plain version agrees with the JAX package's oracle."""
    b, X, y, w = _case(1, 2, F)
    X /= np.float32(np.sqrt(F))  # unit-scale margins
    got, _ = _both(b, X, y, w, "logistic")
    want = j_kernels.reference_glm_grad(*map(jnp.asarray, (b, X, y, w)), "logistic")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape,offset,zero_every",
    [
        ((6, 40, 32), 0, 2), ((3, 17, 128), 0, 2), ((5, 300, 17), 0, 2),
        ((90, 4400, 128), 0, 2),
        ((3, 300, 2048), 0, 2),  # wider than a lane's registers: the column path
        ((2, 70, 5001), 0, 2),  # the column path with F % 4 != 0
        ((1, 3, 128), 0, 0), ((2, 1, 7), 0, 0),  # fewer flat rows than CTAs
        ((2, 40, 15509), 0, 0),  # the covtype width at a small M
        ((3, 5, 17), 1, 0),  # a contiguous X[1:]: odd F, base not 16-byte aligned
        ((7, 1000, 96), 0, 0),  # CTA ranges across slot boundaries, weights all differ
        ((300, 1, 64), 0, 2),  # R = 1: every row its own slot
        ((2, 40, 20000), 0, 0),  # a cluster of two CTAs splits each row
        ((3, 7, 20001), 1, 0),  # the cluster path, odd F, base not 16-byte aligned
        ((3, 7, 131072), 1, 0),  # a cluster of eight CTAs
        ((2, 3, 131073), 1, 0),  # past what a cluster holds: the re-read path
    ],
)
def test_cuda_kernel_matches_plain_version(shape, offset, zero_every, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    M, R, F = shape
    b, X, y, w = _case(M + offset, R, F)
    X, y, w = X, y[offset:], w[offset:]
    if zero_every:
        w[::zero_every] = 0.0
    # the offset slots are made on the card and cut off there: X[offset:]
    # is contiguous and starts offset * R * F elements into its storage
    X_card = torch.from_numpy(X).to(dtype).cuda()[offset:]
    args = (
        torch.from_numpy(b).cuda(), X_card,
        torch.from_numpy(np.ascontiguousarray(y)).cuda(),
        torch.from_numpy(np.ascontiguousarray(w)).cuda(),
    )
    for kind in t_kernels.GLM_KINDS:
        before = t_kernels.LAUNCHES["fused_glm_grad"]
        got = t_kernels.fused_glm_grad(*args, kind)
        again = t_kernels.fused_glm_grad(*args, kind)
        want = t_kernels.reference_glm_grad(*args, kind)
        # float32 sums in another order: within 1e-5 of the sum of |terms|
        Xf = args[1].float()
        s = t_kernels._residual(kind, torch.einsum("mrf,f->mr", Xf, args[0]), args[2])
        scale = torch.einsum("mrf,mr->f", Xf.abs(), (s * args[3][:, None]).abs())
        torch.cuda.synchronize()
        assert t_kernels.LAUNCHES["fused_glm_grad"] == before + 2
        assert torch.equal(got, again)  # no atomics: reruns are bitwise
        assert ((got - want).abs() <= 1e-5 * scale + 1e-6).all()


# ---------------------------------------------------------------------------
# fused_block_decode (kernel B2)

DECODE_SHAPES = [(6, 200), (3, 128), (1, 7), (9, 515), (5, 300)]


def _decode_case(M, D, seed=3, zero_every=0):
    rng = np.random.default_rng(seed + 100 * M + D)
    g = rng.standard_normal((M, D)).astype(np.float32)
    w = rng.standard_normal(M).astype(np.float32)
    if zero_every:
        w[::zero_every] = 0.0
    return w, g


def _jax_decodes(w, g, jdtype):
    jw, jg = jnp.asarray(w), jnp.asarray(g).astype(jdtype)
    xla = j_kernels.fused_block_decode(jw, jg)
    pallas = j_kernels.fused_block_decode(jw, jg, use_pallas=True, interpret=True)
    return [np.asarray(a.astype(jnp.float32)) for a in (xla, pallas)]


@pytest.mark.parametrize("zero_every", [0, 2])
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_block_decode_f32_matches_jax(shape, zero_every):
    w, g = _decode_case(*shape, zero_every=zero_every)
    before = dict(t_kernels.LAUNCHES)
    got = t_kernels.fused_block_decode(torch.from_numpy(w), torch.from_numpy(g))
    assert t_kernels.LAUNCHES == before  # the CPU path launches nothing
    assert got.dtype == torch.float32 and tuple(got.shape) == (shape[1],)
    tol = 1e-6 * np.abs(w[:, None] * g).sum(0) + 1e-7
    for want in _jax_decodes(w, g, jnp.float32):
        assert (np.abs(got.numpy() - want) <= tol).all()


@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_block_decode_bf16_matches_jax(shape):
    """w is rounded to bfloat16 first, the sum is float32, the result is
    rounded to bfloat16 once: within one bfloat16 ulp of JAX's."""
    w, g = _decode_case(*shape, zero_every=3)
    tg = torch.from_numpy(g).to(torch.bfloat16)
    got = t_kernels.fused_block_decode(torch.from_numpy(w), tg)
    assert got.dtype == torch.bfloat16
    got32 = got.float().numpy()
    # one ulp of a bfloat16 value v is 2**(exponent(v) - 7)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(got32), 1e-30))) - 7)
    for want in _jax_decodes(w, g, jnp.bfloat16):
        assert (np.abs(got32 - want) <= ulp).all()


def test_block_decode_plain_version_sums_slots_in_order():
    """The plain version is the kernel's arithmetic: one rounded multiply
    and one rounded add per slot, slots in order."""
    w, g = _decode_case(9, 515)
    got = t_kernels.reference_block_decode(torch.from_numpy(w), torch.from_numpy(g))
    acc = np.zeros(515, np.float32)
    for m in range(9):
        acc = (acc + np.float32(w[m]) * g[m]).astype(np.float32)
    assert got.numpy().tobytes() == acc.tobytes()


@pytest.mark.parametrize(
    "bad",
    [
        dict(w=torch.zeros(3, dtype=torch.float64)),
        dict(g=torch.zeros(3, 4, dtype=torch.float16)),
        dict(w=torch.zeros(2)),
        dict(g=torch.zeros(3, 4, 1)),
        dict(g=torch.zeros(3, 0)),
        dict(g=torch.zeros(4, 3).t()),
    ],
)
def test_block_decode_refuses_what_the_kernel_does_not_take(bad):
    args = dict(w=torch.zeros(3), g=torch.zeros(3, 4))
    args.update(bad)
    with pytest.raises(ValueError):
        t_kernels.fused_block_decode(**args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape",
    DECODE_SHAPES + [(90, 4096), (90, 128), (90, 32), (90, 1), (7, 4098)],
)
def test_cuda_block_decode_bitwise_equals_plain_version(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    w, g = _decode_case(*shape, zero_every=4)
    tw, tg = torch.from_numpy(w).cuda(), torch.from_numpy(g).to(dtype).cuda()
    before = t_kernels.LAUNCHES["fused_block_decode"]
    got = t_kernels.fused_block_decode(tw, tg)
    again = t_kernels.fused_block_decode(tw, tg)
    want = t_kernels.reference_block_decode(tw, tg)
    torch.cuda.synchronize()
    assert t_kernels.LAUNCHES["fused_block_decode"] == before + 2
    assert got.dtype == dtype
    assert torch.equal(got, want) and torch.equal(got, again)


# ---------------------------------------------------------------------------
# the device guard: each launch runs with its tensors' card current


class _CardTensor:
    """A stand-in for a CUDA tensor on a CPU-only host: what the wrappers
    read of their arguments (shape, dtype, device, contiguity, address)."""

    def __init__(self, shape, dtype=torch.float32, device="cuda:1"):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = torch.device(device)

    def dim(self):
        return len(self.shape)

    def numel(self):
        return self.shape.numel()

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 4096


class _GuardedLibrary:
    """The kernel library's C entries, recording the device the guard had
    made current at each call."""

    def __init__(self, current):
        self.current = current
        self.calls = []

    def _seen(self, name, rc=0):
        self.calls.append((name, self.current[-1] if self.current else None))
        return rc

    def eh_fused_glm_grad_scratch_floats(self, *args):
        return self._seen("scratch", 64)

    def eh_fused_glm_grad(self, *args):
        return self._seen("glm_grad")

    def eh_fused_block_decode_max_leaves(self):
        return 32

    def eh_fused_block_decode_leaves(self, *args):
        return self._seen("block_decode")


@pytest.fixture
def guarded_library(monkeypatch):
    current = []

    @contextlib.contextmanager
    def device(d):
        current.append(torch.device(d))
        try:
            yield
        finally:
            current.pop()

    lib = _GuardedLibrary(current)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch, "empty", lambda shape, dtype=None, device=None: _CardTensor(
        tuple(shape) if not isinstance(shape, int) else (shape,), dtype, device))
    monkeypatch.setattr(t_kernels, "_LIB", lib)
    t_kernels._glm_scratch_floats.cache_clear()
    yield lib
    t_kernels._glm_scratch_floats.cache_clear()


def test_kernel_wrappers_launch_under_their_tensors_device(guarded_library):
    """B1's scratch query and launch, and B2's launch (one leaf table and a
    cohort), each run inside ``torch.cuda.device`` of their tensors' card:
    cuda:1 here, whatever the caller's current device is."""
    M, R, F = 3, 5, 8
    X = _CardTensor((M, R, F))
    out = t_kernels.fused_glm_grad(_CardTensor((F,)), X, _CardTensor((M, R)), _CardTensor((M,)))
    assert out.device == X.device
    t_kernels.fused_block_decode_leaves(_CardTensor((M, 2)), [_CardTensor((M, 2, 7))])
    t_kernels.fused_block_decode_cohort(_CardTensor((4, M)), [_CardTensor((4, M, 6))], "p")
    card = torch.device("cuda:1")
    assert guarded_library.calls == [("scratch", card), ("glm_grad", card),
                                     ("block_decode", card), ("block_decode", card)]


def test_kernel_wrappers_refuse_a_mix_of_devices(guarded_library):
    M, R, F = 3, 5, 8
    with pytest.raises(ValueError, match="y is on cuda:0, X on cuda:1"):
        t_kernels.fused_glm_grad(_CardTensor((F,)), _CardTensor((M, R, F)),
                                 _CardTensor((M, R), device="cuda:0"), _CardTensor((M,)))
    with pytest.raises(ValueError, match="leaf 1 is on cuda:0, ws on cuda:1"):
        t_kernels.fused_block_decode_leaves(
            _CardTensor((M,)), [_CardTensor((M, 4)), _CardTensor((M, 4), device="cuda:0")])
    assert guarded_library.calls == []


@pytest.mark.cuda
def test_cuda_kernels_launch_on_their_card_when_another_is_current():
    """Both kernels on cuda:0 while cuda:1 is the current device: each
    equals its plain version (B2 bitwise), and the current device is left
    as the caller set it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: with one, the tensors' card is always the current one")
    b, X, y, w = _case(6, 40, 32)
    args = [torch.from_numpy(a).to("cuda:0") for a in (b, X, y, w)]
    wd, gd = _decode_case(6, 4096, zero_every=4)
    tw, tg = torch.from_numpy(wd).to("cuda:0"), torch.from_numpy(gd).to("cuda:0")
    with torch.cuda.device(1):
        got = t_kernels.fused_glm_grad(*args)
        dec = t_kernels.fused_block_decode(tw, tg)
        torch.cuda.synchronize(0)
        assert torch.cuda.current_device() == 1
    want = t_kernels.reference_glm_grad(*args)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert torch.equal(dec, t_kernels.reference_block_decode(tw, tg))
