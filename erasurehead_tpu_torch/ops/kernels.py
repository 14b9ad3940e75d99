"""The decoded GLM gradient as one hand-written CUDA kernel for Hopper.

The coded-GD step is bandwidth-bound: the per-slot GLM gradient needs a
margin matvec ``p = X @ beta`` and a transpose matvec ``g = X^T @ s(p, y)``,
two reads of the feature stack X when written as two products. The kernel in
``csrc/fused_glm_grad.cu`` fuses margin -> residual -> weighted
transpose-accumulate into ONE pass over X and folds the per-slot decode
weights in, so the *decoded* gradient

    g = sum_m w_m * sum_r s(p_{m,r}, y_{m,r}) * X[m, r, :]

comes out of a single streaming read. s is the residual:
  logistic: s = -y / (exp(p*y) + 1)
  linear:   s = -2 * (y - p)

It is the port of the Pallas TPU kernel erasurehead_tpu/ops/kernels.py::_kernel
(``fused_glm_grad``); the source file says how its design differs.

:func:`fused_glm_grad` launches the kernel for CUDA tensors and raises on
anything it does not take; for CPU tensors it computes the same function with
:func:`reference_glm_grad`, the plain two-pass PyTorch version. The kernel is
compiled with ``nvcc`` for ``sm_90a`` at first use into ``build/`` at the root
of the checkout, keyed by a hash of the sources and flags, and loaded with
ctypes. A build failure raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

GLM_KINDS = ("logistic", "linear")

#: launches of each kernel since the last :func:`reset_launches` (incremented
#: only where a kernel is really launched, never on the CPU path)
LAUNCHES = {"fused_glm_grad": 0}

_PKG_DIR = Path(__file__).resolve().parent.parent
_SOURCES = (_PKG_DIR / "csrc" / "fused_glm_grad.cu",)
_BUILD_DIR = _PKG_DIR.parent / "build" / "erasurehead_tpu_torch"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    for src in _SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the built shared library for the current sources lives."""
    return _BUILD_DIR / f"fused_glm_grad-{_source_key()}.so"


def _build() -> Path:
    """Compile the kernel library if the current sources have no build yet.

    Writes ``<name>.so`` and the compiler's report (``-Xptxas -v``: registers,
    shared memory, spills) as ``<name>.log`` beside it. Raises on failure."""
    so = library_path()
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), *map(str, _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    so.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log[-4000:]}")
    os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
    return so


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build()))
    lib.eh_fused_glm_grad.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p
    ]
    lib.eh_fused_glm_grad.restype = ctypes.c_int
    lib.eh_fused_glm_grad_scratch_floats.argtypes = [ctypes.c_int] * 3
    lib.eh_fused_glm_grad_scratch_floats.restype = ctypes.c_longlong
    lib.eh_cuda_error_string.argtypes = [ctypes.c_int]
    lib.eh_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> None:
    """Build (if needed) and load the kernel library now, outside any timed
    region."""
    _library()


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
    out = torch.empty(F, dtype=torch.float32, device=X.device)
    scratch = torch.empty(
        lib.eh_fused_glm_grad_scratch_floats(M, R, F),
        dtype=torch.float32, device=X.device,
    )
    stream = torch.cuda.current_stream(X.device).cuda_stream
    rc = lib.eh_fused_glm_grad(
        X.data_ptr(), y.data_ptr(), beta.data_ptr(), w.data_ptr(),
        out.data_ptr(), scratch.data_ptr(),
        M, R, F, 0 if X.dtype == torch.float32 else 1,
        1 if kind == "logistic" else 0, stream,
    )
    if rc != 0:
        msg = lib.eh_cuda_error_string(rc).decode()
        raise RuntimeError(f"fused_glm_grad launch failed: CUDA error {rc} ({msg})")
    LAUNCHES["fused_glm_grad"] += 1
    return out
