"""ctypes binding for the native text-matrix parser (loadtxt.cpp).

The port of erasurehead_tpu/data/native/. Build on first use: the shared
object is compiled with ``g++ -O2 -shared -fPIC`` into the port's build
directory (``build/erasurehead_tpu_torch/native/`` at the root of the
checkout, ignored by git), named by a hash of the source, written under a
per-process temporary name and renamed into place, so processes that build
at once never load a half-written file. Any failure (no toolchain, a parse
error, a ragged or non-numeric file) makes :func:`load_dense_text_native`
return None and the caller (data/io.py) falls back to np.loadtxt: the
native path is host code that only makes the cold load faster, never a
correctness dependency.

:data:`COUNTS` counts this process's parses: ``native`` where the parser
returned the matrix, ``fallback`` where it returned None (the caller then
parses with np.loadtxt).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "loadtxt.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "erasurehead_tpu_torch" / "native"
_GXX_FLAGS = ("-O2", "-shared", "-fPIC")

#: parses in this process: ``native`` (the parser's matrix was returned) and
#: ``fallback`` (None was returned, so the caller used np.loadtxt)
COUNTS = {"native": 0, "fallback": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def reset_counts() -> None:
    with _lock:
        for k in COUNTS:
            COUNTS[k] = 0


def library_path() -> Path:
    """Where the built parser for the current source lives."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_GXX_FLAGS).encode())
    return _BUILD_DIR / f"_loadtxt-{h.hexdigest()[:16]}.so"


def _compile() -> Path:
    so = library_path()
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        subprocess.run(
            ["g++", *_GXX_FLAGS, "-o", str(tmp), str(_SRC)],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, so)
    return so


def get_lib() -> Optional[ctypes.CDLL]:
    """The compiled library, or None if the toolchain is unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(_compile()))
        except Exception:  # noqa: BLE001 — no toolchain: np.loadtxt parses
            _build_failed = True
            return None
        lib.eh_parse_alloc.restype = ctypes.POINTER(ctypes.c_double)
        lib.eh_parse_alloc.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.eh_free.restype = None
        lib.eh_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
        _lib = lib
        return _lib


def _count(key: str) -> None:
    with _lock:
        COUNTS[key] += 1


def load_dense_text_native(path: str) -> Optional[np.ndarray]:
    """np.loadtxt-compatible parse of a dense text matrix, or None.

    Matches np.loadtxt's squeeze rules for the shapes the reference writes
    (R x C matrices and label vectors): a 1x1 file comes back 0-d, a
    single-row or single-column file 1-D."""
    m = _parse(path)
    _count("fallback" if m is None else "native")
    return m


def _parse(path: str) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    n_vals = ctypes.c_long()
    n_rows = ctypes.c_long()
    ptr = lib.eh_parse_alloc(
        os.fsencode(path), ctypes.byref(n_vals), ctypes.byref(n_rows)
    )
    if not ptr:
        return None  # io/parse error: let np.loadtxt decide / report
    try:
        n, rows = n_vals.value, n_rows.value
        if n <= 0 or rows <= 0 or n % rows != 0:
            return None  # empty or ragged: np.loadtxt's message is better
        out = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
    finally:
        lib.eh_free(ptr)
    m = out.reshape(rows, n // rows)
    if m.shape == (1, 1):
        return m.reshape(())  # np.loadtxt yields a 0-d array for a 1x1 file
    if m.shape[0] == 1:
        return m[0]
    if m.shape[1] == 1:
        return m[:, 0]
    return m
