"""The port's hand-written CUDA kernels for Hopper, and their plain versions.

B1, the decoded GLM gradient (``csrc/fused_glm_grad.cu``, its bfloat16
half ``csrc/fused_glm_grad_bf16.cu`` and their shared ``.cuh``). The coded-GD step
is bandwidth-bound: the per-slot GLM gradient needs a margin matvec
``p = X @ beta`` and a transpose matvec ``g = X^T @ s(p, y)``, two reads of
the feature stack X when written as two products. The kernel fuses
margin -> residual -> weighted transpose-accumulate into ONE pass over X and
folds the per-slot decode weights in, so the *decoded* gradient

    g = sum_m w_m * sum_r s(p_{m,r}, y_{m,r}) * X[m, r, :]

comes out of a single streaming read, in one launch at every width (a
persistent grid fed by TMA bulk copies, rows wider than a CTA holds split
by columns over a thread-block cluster, the partials summed in a fixed
order by the last CTA to finish; the source's header has the design). s is the residual:
  logistic: s = -y / (exp(p*y) + 1)
  linear:   s = -2 * (y - p)
It is the port of the Pallas TPU kernel erasurehead_tpu/ops/kernels.py::_kernel
(``fused_glm_grad``).

B2, the blockwise decode (``csrc/fused_block_decode.cu``): every leaf's
decoded gradient ``out[D] = sum_m w_m * g[m, D]`` from its per-slot
gradients, the decode of the layer-coded step
(parallel/step.make_layer_block_grad_fn), all leaves of a round in one
launch, each leaf read in place in the step's [W, S, D] slot layout. It is
the port of erasurehead_tpu/ops/kernels.py::_decode_kernel
(``fused_block_decode``). The JAX trainer lowers that decode through XLA and
reaches its Pallas kernel only when asked (``use_pallas=True``); in the port
the decode on a CUDA tensor is always this kernel. A trajectory cohort
(train/trainer.train_cohort) decodes every leaf of all its B trajectories
in the same one launch (:func:`fused_block_decode_cohort`).

Each source file says how its design differs from the TPU kernel.
:func:`fused_glm_grad`, :func:`fused_block_decode_leaves`,
:func:`fused_block_decode_cohort` and the one-leaf
:func:`fused_block_decode` launch their kernels for CUDA tensors and raise
on anything they do not take; for CPU tensors they compute the same
function with their plain PyTorch versions (:func:`reference_glm_grad`,
:func:`reference_block_decode_leaves`, :func:`reference_block_decode_cohort`,
:func:`reference_block_decode`). The
kernels are compiled with ``nvcc`` for ``sm_90a`` at first use, one ``nvcc``
per source started together, and linked into one library in ``build/`` at
the root of the checkout (or the directory :func:`set_build_dir` names: the
serve daemon's ``cache_dir``), keyed by a hash of the sources and flags,
loaded with ctypes, once per process however many threads make their first
call together. A build failure raises; there is no fallback.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

GLM_KINDS = ("logistic", "linear")

#: launches of each kernel since the last :func:`reset_launches` (incremented
#: only where a kernel is really launched, never on the CPU path, and only
#: through :func:`_count_launch` or :func:`add_launches`, under
#: :data:`_LAUNCH_LOCK`: the serve daemon launches from several dispatch
#: threads at once)
LAUNCHES = {"fused_glm_grad": 0, "fused_block_decode": 0}
_LAUNCH_LOCK = threading.Lock()
#: a thread's CUDA-graph warm-up or capture (train/graphs.py) counts its
#: launches into its own tally instead of :data:`LAUNCHES`: a captured
#: kernel launches when its graph replays, and the replay adds the tally
_RECORDING = threading.local()

#: kernel-library builds (nvcc runs) in this process; a warm start from an
#: existing build, or a second caller, adds none
BUILDS = 0

_PKG_DIR = Path(__file__).resolve().parent.parent
_SOURCES = (
    _PKG_DIR / "csrc" / "fused_glm_grad.cu",
    _PKG_DIR / "csrc" / "fused_glm_grad_bf16.cu",
    _PKG_DIR / "csrc" / "fused_block_decode.cu",
)
#: headers the sources include: part of the build's key, not compiled alone
_HEADERS = (_PKG_DIR / "csrc" / "fused_glm_grad.cuh", _PKG_DIR / "csrc" / "glm_grad_plan.h")
_BUILD_DIR = _PKG_DIR.parent / "build" / "erasurehead_tpu_torch"
#: the loaded library; built and loaded once, under :data:`_LIB_LOCK`
_LIB: "ctypes.CDLL | None" = None
_LIB_LOCK = threading.Lock()
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count_launch(name: str) -> None:
    """Count one launch of ``name``: a read-modify-write of a dict shared by
    every thread, so it is taken under a lock. Under :func:`recording` the
    launch goes to the thread's tally instead."""
    tally = getattr(_RECORDING, "tally", None)
    if tally is not None:
        tally[name] = tally.get(name, 0) + 1
        return
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1


@contextlib.contextmanager
def recording(tally: dict):
    """Count this thread's launches into ``tally`` (not :data:`LAUNCHES`)
    for the duration: a CUDA graph's warm-up, which is not counted, or its
    capture, whose tally each replay adds (:func:`add_launches`)."""
    prev = getattr(_RECORDING, "tally", None)
    _RECORDING.tally = tally
    try:
        yield tally
    finally:
        _RECORDING.tally = prev


def add_launches(tally: dict) -> None:
    """Count the launches of one replay of a captured graph whose capture
    recorded ``tally``."""
    with _LAUNCH_LOCK:
        for name, n in tally.items():
            LAUNCHES[name] += n


def set_build_dir(path) -> None:
    """Build into and load from ``path`` instead of ``build/`` in the
    checkout (the serve daemon's ``cache_dir``: a restarted daemon pointed
    at the same directory builds nothing). Only before the library is
    loaded: a loaded library stays where it was built from."""
    global _BUILD_DIR
    with _LIB_LOCK:
        new = Path(path).resolve()
        if _LIB is not None and new != _BUILD_DIR:
            raise RuntimeError(
                f"the kernel library is loaded from {_BUILD_DIR} already; "
                f"set the build directory before the first kernel call"
            )
        _BUILD_DIR = new


def _residual(kind: str, p: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    if kind == "logistic":
        return -y / (torch.exp(p * y) + 1.0)
    if kind == "linear":
        return -2.0 * (y - p)
    raise ValueError(f"unknown GLM kind {kind!r}")


def reference_glm_grad(beta, X, y, w, kind: str = "logistic") -> torch.Tensor:
    """Plain PyTorch version of the kernel (two passes over X, float32)."""
    Xf = X.float()
    p = torch.einsum("mrf,f->mr", Xf, beta)
    s = _residual(kind, p, y) * w[:, None]
    return torch.einsum("mrf,mr->f", Xf, s)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc")]
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built"
    )


def _source_key() -> str:
    h = hashlib.sha256()
    for src in _SOURCES + _HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the built shared library for the current sources lives."""
    return _BUILD_DIR / f"eh_kernels-{_source_key()}.so"


def _build() -> Path:
    """Compile the kernel library if the current sources have no build yet.

    One ``nvcc -c`` per source, all started together, then one link. Writes
    ``<name>.so`` and the compilers' reports (``-Xptxas -v``: registers,
    shared memory, spills) as ``<name>.log`` beside it, each by a temporary
    name and ``os.replace``. Raises on failure. Counts a build in
    :data:`BUILDS` (callers hold :data:`_LIB_LOCK`). Processes that share a
    build directory (a serve fleet's replicas) take an exclusive ``flock``
    on the directory itself around the check and the build, so one of them
    builds, the others find its library, and no lock file is left behind."""
    so = library_path()
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd = os.open(_BUILD_DIR, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        if so.exists():
            return so
        return _compile(so)
    finally:
        os.close(fd)  # closing the descriptor releases the lock


def _compile(so: Path) -> Path:
    """The build itself, under the lock :func:`_build` holds."""
    global BUILDS
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [_BUILD_DIR / f"{tag}.{src.stem}.o" for src in _SOURCES]
    cmds = [
        [nvcc, *_NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(o), str(src)]
        for src, o in zip(_SOURCES, objs)
    ]
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(f"$ {' '.join(c)}\n{o}" for c, o in zip(cmds, outs))
    failed = [c for c, p in zip(cmds, procs) if p.returncode != 0]
    tmp = _BUILD_DIR / f"{tag}.tmp.so"
    if not failed:
        link = [nvcc, *_NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log += f"$ {' '.join(link)}\n{proc.stdout}"
        if proc.returncode != 0:
            failed = [link]
    for o in objs:
        o.unlink(missing_ok=True)
    log_tmp = _BUILD_DIR / f"{tag}.tmp.log"
    log_tmp.write_text(log)
    os.replace(log_tmp, so.with_suffix(".log"))
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed: {' '.join(failed[0])}\n{log[-4000:]}")
    os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
    BUILDS += 1
    return so


def _library() -> ctypes.CDLL:
    """The kernel library, built (if needed) and loaded by the first caller;
    concurrent first callers wait for it under :data:`_LIB_LOCK` (two
    threads building at once would write and unlink the same objects)."""
    global _LIB
    lib = _LIB
    if lib is not None:
        return lib
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = _load(_build())
        return _LIB


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.eh_fused_glm_grad.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p
    ]
    lib.eh_fused_glm_grad.restype = ctypes.c_int
    lib.eh_fused_glm_grad_scratch_floats.argtypes = [ctypes.c_int] * 5
    lib.eh_fused_glm_grad_scratch_floats.restype = ctypes.c_longlong
    lib.eh_fused_block_decode_leaves.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.eh_fused_block_decode_leaves.restype = ctypes.c_int
    lib.eh_fused_block_decode_max_leaves.argtypes = []
    lib.eh_fused_block_decode_max_leaves.restype = ctypes.c_int
    lib.eh_cuda_error_string.argtypes = [ctypes.c_int]
    lib.eh_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> None:
    """Build (if needed) and load the kernel library (both kernels) now,
    outside any timed region."""
    _library()


def library_loaded() -> bool:
    """Has this process loaded the kernel library already?"""
    return _LIB is not None


def unsupported_reason(X: torch.Tensor) -> str | None:
    """Why the kernel cannot take this [M, R, F] stack, or None if it can."""
    if X.dtype not in (torch.float32, torch.bfloat16):
        return f"X must be float32 or bfloat16, got {X.dtype}"
    if X.dim() != 3:
        return f"X must be [M, R, F], got shape {tuple(X.shape)}"
    M, R, F = X.shape
    if min(M, R, F) < 1:
        return f"X must be non-empty, got shape {tuple(X.shape)}"
    return None


def _check(beta, X, y, w, kind) -> None:
    if kind not in GLM_KINDS:
        raise ValueError(f"unknown GLM kind {kind!r}")
    reason = unsupported_reason(X)
    if reason is not None:
        raise ValueError(f"fused_glm_grad: {reason}")
    M, R, F = X.shape
    for name, t, shape in (("beta", beta, (F,)), ("y", y, (M, R)), ("w", w, (M,))):
        if t.dtype != torch.float32:
            raise ValueError(f"fused_glm_grad: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(
                f"fused_glm_grad: {name} must have shape {shape}, got {tuple(t.shape)}"
            )
        if t.device != X.device:
            raise ValueError(
                f"fused_glm_grad: {name} is on {t.device}, X on {X.device}"
            )


@functools.lru_cache(maxsize=256)
def _glm_scratch_floats(M: int, R: int, F: int, dtype: int, dev: int) -> int:
    """Floats of B1's scratch for this shape on card ``dev``: its tickets,
    one partial per CTA of the grid and one per reduction group (the grid
    follows the card's SM count). Kept per shape: a round loop asks once."""
    return _library().eh_fused_glm_grad_scratch_floats(M, R, F, dtype, dev)


def fused_glm_grad(
    beta: torch.Tensor,  # [F] float32
    X: torch.Tensor,  # [M, R, F] float32 or bfloat16, slot-major
    y: torch.Tensor,  # [M, R] float32
    w: torch.Tensor,  # [M] float32 decode weight per slot
    kind: str = "logistic",
) -> torch.Tensor:
    """Decoded GLM gradient in one pass over X. Returns [F] float32.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`reference_glm_grad`."""
    _check(beta, X, y, w, kind)
    if X.device.type == "cpu":
        return reference_glm_grad(beta, X, y, w, kind)
    if X.device.type != "cuda":
        raise ValueError(f"fused_glm_grad: unsupported device {X.device}")
    for name, t in (("beta", beta), ("X", X), ("y", y), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"fused_glm_grad: {name} must be contiguous")
    lib = _library()
    M, R, F = X.shape
    dtype = 0 if X.dtype == torch.float32 else 1
    dev = X.device.index
    n_scratch = _glm_scratch_floats(M, R, F, dtype, dev)
    if n_scratch < 1:
        raise RuntimeError(f"fused_glm_grad: no launch plan for {tuple(X.shape)} on {X.device}")
    out = torch.empty(F, dtype=torch.float32, device=X.device)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    rc = lib.eh_fused_glm_grad(
        X.data_ptr(), y.data_ptr(), beta.data_ptr(), w.data_ptr(),
        out.data_ptr(), scratch.data_ptr(),
        M, R, F, dtype, 1 if kind == "logistic" else 0, dev, stream,
    )
    if rc != 0:
        msg = lib.eh_cuda_error_string(rc).decode()
        raise RuntimeError(f"fused_glm_grad launch failed: CUDA error {rc} ({msg})")
    _count_launch("fused_glm_grad")
    return out


def reference_block_decode(w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the decode kernel, step for step: w in g's
    dtype, widened to float32 with g, then ``acc = acc + w[m] * g[m]`` for
    m in order (one rounded multiply and one rounded add each), rounded to
    g's dtype once at the end. Bitwise equal to the kernel."""
    w32 = w.to(g.dtype).float()
    g32 = g.float()
    acc = torch.zeros(g.shape[1], dtype=torch.float32, device=g.device)
    for m in range(g.shape[0]):
        acc = acc + w32[m] * g32[m]
    return acc.to(g.dtype)


def fused_block_decode(
    w: torch.Tensor,  # [M] float32 decode weight per slot, in reduction order
    g: torch.Tensor,  # [M, D] float32 or bfloat16 per-slot flattened gradients
) -> torch.Tensor:
    """Decoded leaf gradient ``sum_m w[m] * g[m, :]``: [D] in g's dtype.

    ``w`` must already be flattened in the order of the contraction it
    replaces. The one-leaf, partition-major (S = 1) case of
    :func:`fused_block_decode_leaves`, with its checks and dispatch."""
    if w.dim() != 1 or g.dim() != 2:
        raise ValueError(
            "fused_block_decode: need w [M] and g [M, D], got "
            f"{tuple(w.shape)} and {tuple(g.shape)}"
        )
    return fused_block_decode_leaves(w, [g])[0]


def _s_major(ws: torch.Tensor):
    """The slot weights flattened in reduction order, and a function taking
    a leaf [*ws.shape, ...] to its [M, D] rows in that order: s-major for
    the faithful [W, S] contract (a copy), as-is for a [P] vector (a view)."""
    if ws.dim() == 2:
        return ws.t().reshape(-1), lambda leaf: leaf.transpose(0, 1).reshape(ws.numel(), -1)
    return ws, lambda leaf: leaf.reshape(ws.numel(), -1)


def reference_block_decode_leaves(ws: torch.Tensor, leaves) -> list:
    """Plain PyTorch version of the multi-leaf decode: each leaf's s-major
    copy through :func:`reference_block_decode`. Bitwise equal to the
    kernel, which reads the same rows in place."""
    wf, rows = _s_major(ws)
    return [
        reference_block_decode(wf, rows(leaf)).reshape(leaf.shape[ws.dim():])
        for leaf in leaves
    ]


def _check_leaves(ws, leaves, name="fused_block_decode_leaves", ws_dims=(1, 2)) -> None:
    """Refuse what the kernel does not take: ``ws`` float32, contiguous,
    with ``ws.dim()`` in ``ws_dims``; leaves of one dtype (float32 or
    bfloat16), contiguous, non-empty, on ws's device, each leading with
    ``ws.shape``."""
    if ws.dtype != torch.float32:
        raise ValueError(f"{name}: ws must be float32, got {ws.dtype}")
    if ws.dim() not in ws_dims or ws.numel() < 1:
        want = " or ".join(("[P]", "[W, S]", "[B, W, S]")[d - 1] for d in ws_dims)
        raise ValueError(f"{name}: need ws {want}, got {tuple(ws.shape)}")
    if not ws.is_contiguous():
        raise ValueError(f"{name}: ws must be contiguous")
    if not leaves:
        raise ValueError(f"{name}: no leaves")
    for i, leaf in enumerate(leaves):
        if leaf.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{name}: leaf {i} must be float32 or bfloat16, got {leaf.dtype}")
        if leaf.dtype != leaves[0].dtype:
            raise ValueError(
                f"{name}: leaves of mixed dtypes ({leaves[0].dtype}, {leaf.dtype})"
            )
        if tuple(leaf.shape[:ws.dim()]) != tuple(ws.shape):
            raise ValueError(
                f"{name}: leaf {i} of shape {tuple(leaf.shape)} does not lead "
                f"with the slots' {tuple(ws.shape)}"
            )
        if leaf.numel() < 1:
            raise ValueError(f"{name}: leaf {i} is empty")
        if leaf.device != ws.device:
            raise ValueError(f"{name}: leaf {i} is on {leaf.device}, ws on {ws.device}")
        if not leaf.is_contiguous():
            raise ValueError(f"{name}: leaf {i} must be contiguous")


def _launch_decode(ws, leaves, cohort: bool, name: str) -> list:
    """Launch the decode kernel on CUDA tensors already checked. ``ws`` is
    [W, S] or [P] (S = 1), led by the trajectory axis [B] where ``cohort``,
    as is every leaf. One launch per 32 leaves, each counted; outputs
    [B, *shape] (a cohort) or [*shape] in the leaf's dtype."""
    if ws.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {ws.device}")
    lib = _library()
    lead = tuple(ws.shape[:1]) if cohort else ()
    W, S = (tuple(ws.shape[len(lead):]) + (1,))[:2]
    B = lead[0] if cohort else 1
    outs = [
        torch.empty(lead + tuple(leaf.shape[ws.dim():]), dtype=leaf.dtype, device=leaf.device)
        for leaf in leaves
    ]
    dtype = 0 if leaves[0].dtype == torch.float32 else 1
    stream = torch.cuda.current_stream(ws.device).cuda_stream
    cap = lib.eh_fused_block_decode_max_leaves()
    for i in range(0, len(leaves), cap):
        part = range(i, min(i + cap, len(leaves)))
        n = len(part)
        rc = lib.eh_fused_block_decode_leaves(
            ws.data_ptr(),
            (ctypes.c_void_p * n)(*(leaves[k].data_ptr() for k in part)),
            (ctypes.c_void_p * n)(*(outs[k].data_ptr() for k in part)),
            (ctypes.c_longlong * n)(*(outs[k].numel() // B for k in part)),
            n, W, S, B, dtype, stream,
        )
        if rc != 0:
            msg = lib.eh_cuda_error_string(rc).decode()
            raise RuntimeError(f"fused_block_decode launch failed: CUDA error {rc} ({msg})")
        _count_launch("fused_block_decode")
    return outs


def fused_block_decode_leaves(ws: torch.Tensor, leaves) -> list:
    """Every leaf's decoded gradient in one launch: for each leaf
    [*ws.shape, *shape], the sum over the slots of ``ws * leaf`` in the
    contract's reduction order, [*shape] in the leaf's dtype.

    ``ws`` is the faithful contract's [W, S] slot weights (reduced s-major,
    slot m = s * W + w, as the JAX package's einsum) or the partition-major
    [P] weights (as-is). The kernel reads each leaf in place in that layout;
    leaves must share one dtype and be contiguous. A table longer than the
    kernel's cap takes further launches, each counted. CUDA tensors launch
    the kernel (or raise); CPU tensors take
    :func:`reference_block_decode_leaves`."""
    leaves = list(leaves)
    _check_leaves(ws, leaves)
    if ws.device.type == "cpu":
        return reference_block_decode_leaves(ws, leaves)
    return _launch_decode(ws, leaves, False, "fused_block_decode_leaves")


def reference_block_decode_cohort(ws_B: torch.Tensor, leaves_B, contract: str) -> list:
    """Plain PyTorch version of the cohort decode: for each trajectory b,
    :func:`reference_block_decode_leaves` of its weights ``ws_B[b]`` and
    its slots ``leaf[b]``, stacked to [B, *shape] per leaf."""
    leaves_B = list(leaves_B)
    per = [
        reference_block_decode_leaves(ws_B[b], [leaf[b] for leaf in leaves_B])
        for b in range(ws_B.shape[0])
    ]
    return [torch.stack([out[i] for out in per]) for i in range(len(leaves_B))]


def fused_block_decode_cohort(ws_B: torch.Tensor, leaves_B, contract: str) -> list:
    """Every leaf of every trajectory of a cohort decoded in one launch (per
    32 leaves): ``ws_B`` is [B, W, S] (``contract="ws"``, each trajectory
    reduced s-major as :func:`fused_block_decode_leaves` does) or [B, P]
    (``contract="p"``), and each leaf [*ws_B.shape, *shape]; returns
    [B, *shape] per leaf in the leaf's dtype. The contract is explicit: a
    2-D ``ws`` is [W, S] to the one-trajectory entry and would also be a
    valid [B, P] here.

    Bitwise equal to B one-trajectory launches and to
    :func:`reference_block_decode_cohort` (the kernel's trajectory axis
    repeats the one-trajectory arithmetic). CUDA tensors launch the kernel
    (or raise); CPU tensors take the plain version."""
    name = "fused_block_decode_cohort"
    if contract not in ("ws", "p"):
        raise ValueError(f"{name}: contract must be 'ws' or 'p', got {contract!r}")
    leaves_B = list(leaves_B)
    # one slot dim per letter of the contract, after the trajectory axis
    _check_leaves(ws_B, leaves_B, name, (len(contract) + 1,))
    if ws_B.device.type == "cpu":
        return reference_block_decode_cohort(ws_B, leaves_B, contract)
    return _launch_decode(ws_B, leaves_B, True, name)
