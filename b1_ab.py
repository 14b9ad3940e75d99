"""Kernel B1 (fused_glm_grad) on the card against its earlier two-launch
design (per-chunk partials, then a reduce kernel), in one process.

    python3 b1_ab.py [--baseline DIR] [--out PATH] [--profile]

DIR holds the earlier design's ``fused_glm_grad.cu``, for example
unpacked from a parent commit with ``git archive``. Its C interface is
``eh_fused_glm_grad(X, y, beta, w, out, scratch, M, R, F, dtype, logistic,
stream)`` and ``eh_fused_glm_grad_scratch_floats(M, R, F)``. It is built
with ``nvcc`` into ``build/b1_ab/``. Without DIR only this checkout's
kernel is timed.

First this checkout's kernel is checked at ``chip_smoke.B1_CASES``. Then,
at every shape of B1's table in PERF.md, each kernel is held to the plain
two-pass version by ``chip_smoke.check_glm_inputs`` (its tolerance, a
bitwise rerun). The kernels are then timed in turns: baseline, kernel,
kernel, baseline. Each time is ``chip_smoke.time_ms``: CUDA events around
back-to-back wrapper calls, output and scratch allocated per call. The
plain version's time and ``chip_smoke.glm_bound_ms``'s bound are given
beside them. ``--profile`` adds torch.profiler's device time per kernel
symbol, with the baseline's stages apart. The script prints one JSON object
per shape and writes them all to PATH (default build/b1_ab.json). It needs
a card.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import subprocess
import sys
import time
import types

import torch

import chip_smoke as cs

HERE = os.path.dirname(os.path.abspath(__file__))
# (shape, dtype, launches timed): B1's rows in PERF.md's table
SHAPES = (
    (cs.MAIN_SHAPE, torch.float32, 50),
    (cs.MAIN_SHAPE, torch.bfloat16, 50),
    ((180, 1100, 128), torch.float32, 50),
    ((210, 4400, 128), torch.float32, 50),
    ((30, 4400, 128), torch.float32, 50),
    ((18, 4400, 128), torch.float32, 50),
    ((3, 70400, 128), torch.float32, 50),
    ((81, 4888, 128), torch.float32, 50),
    ((45, 4400, 128), torch.float32, 50),
    ((3, 4400, 128), torch.float32, 50),
    ((9, 4400, 128), torch.float32, 50),
    ((15, 4400, 128), torch.float32, 50),
    *((shape, torch.float32, 20) for shape in cs.WIDE_SHAPES),
    ((6, 1700, 20000), torch.bfloat16, 20),
)


def build_baseline(src_dir: str):
    """The earlier design's library built from ``src_dir``, and a wrapper
    that calls it as ops/kernels.fused_glm_grad calls this checkout's."""
    from erasurehead_tpu_torch.ops import kernels

    srcs = sorted(glob.glob(os.path.join(src_dir, "fused_glm_grad*.cu")))
    out_dir = os.path.join(HERE, "build", "b1_ab")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, os.path.basename(os.path.normpath(src_dir)) + ".so")
    t0 = time.perf_counter()
    subprocess.run([kernels._nvcc(), *kernels._NVCC_FLAGS, "-shared", "-o", so, *srcs],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    lib.eh_fused_glm_grad.restype = ctypes.c_int
    lib.eh_fused_glm_grad.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.eh_fused_glm_grad_scratch_floats.restype = ctypes.c_longlong
    lib.eh_fused_glm_grad_scratch_floats.argtypes = [ctypes.c_int] * 3

    def call(b, X, y, w, kind="logistic"):
        M, R, F = X.shape
        out = torch.empty(F, dtype=torch.float32, device=X.device)
        scratch = torch.empty(lib.eh_fused_glm_grad_scratch_floats(M, R, F),
                              dtype=torch.float32, device=X.device)
        rc = lib.eh_fused_glm_grad(
            X.data_ptr(), y.data_ptr(), b.data_ptr(), w.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), M, R, F, 0 if X.dtype == torch.float32 else 1,
            1 if kind == "logistic" else 0, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline launch failed: CUDA error {rc}")
        return out

    return call, time.perf_counter() - t0


def device_times(fn, n=20) -> dict:
    """Device microseconds per call of each device symbol ``fn`` launches."""
    prof, _ = cs.profiled(lambda: [fn() for _ in range(n)])
    return {ev.key[:90]: dict(us_per_call=cs.device_us(ev) / n, events=ev.count)
            for ev in cs.device_events(prof)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline")
    ap.add_argument("--out", default=os.path.join(HERE, "build", "b1_ab.json"))
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b1_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    _, kernels = cs.import_port()
    card = cs.card_line()
    t0 = time.perf_counter()
    kernels.load_library()
    rows = [dict(device=card, build_s=time.perf_counter() - t0)]
    base = None
    if args.baseline:
        base, rows[0]["baseline_build_s"] = build_baseline(args.baseline)
    print(json.dumps(rows[0]), flush=True)
    for i, (shape, dtype, zero_every, offset) in enumerate(cs.B1_CASES):
        for kind in kernels.GLM_KINDS:
            rows.append(cs.check_glm(kernels, shape, dtype, kind, zero_every, 200 + i,
                                     offset=offset))
    as_baseline = types.SimpleNamespace(fused_glm_grad=base,
                                        reference_glm_grad=kernels.reference_glm_grad,
                                        _residual=kernels._residual)
    for i, (shape, dtype, n) in enumerate(SHAPES):
        b, X, y, w = cs.make_inputs(*shape, dtype, seed=300 + i, zero_every=2)
        rec = dict(shape=list(shape), dtype=str(dtype).split(".")[-1],
                   check=cs.check_glm_inputs(kernels, b, X, y, w, "logistic"))
        k = lambda: kernels.fused_glm_grad(b, X, y, w, "logistic")  # noqa: E731
        if base is None:
            rec["kernel_ms"] = [cs.time_ms(k, n), cs.time_ms(k, n)]
        else:
            rec["baseline_check"] = cs.check_glm_inputs(as_baseline, b, X, y, w, "logistic")
            o = lambda: base(b, X, y, w, "logistic")  # noqa: E731
            t = [cs.time_ms(o, n), cs.time_ms(k, n), cs.time_ms(k, n), cs.time_ms(o, n)]
            rec["baseline_ms"], rec["kernel_ms"] = [t[0], t[3]], [t[1], t[2]]
        rec["plain_ms"] = cs.time_ms(lambda: kernels.reference_glm_grad(b, X, y, w, "logistic"),
                                     max(5, n // 5))
        rec["bound_ms"], _ = cs.glm_bound_ms(*shape, X.element_size())
        rec["kernel_bound_share"] = rec["bound_ms"] / min(rec["kernel_ms"])
        if args.profile:
            rec["profile_kernel"] = device_times(k)
            if base is not None:
                rec["profile_baseline"] = device_times(o)
        print(json.dumps(rec), flush=True)
        rows.append(rec)
        del b, X, y, w
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
