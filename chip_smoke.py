"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:

  1. device  - the card's name and power limit (nvidia-smi);
  2. build   - compile every CUDA kernel of the main path from the sources in
               this checkout (nvcc, sm_90a) and time it;
  3. check   - each kernel against its plain PyTorch version on the card, at
               ragged, zero-weight, bfloat16 and main-path shapes;
  4. main    - the paper's experiment through the CLI a user calls: approx
               coding, W=30, s=2, num_collect=15, 132,000 x 128 synthetic GMM
               rows, AGD, 100 rounds, faithful stack, on the card; the kernel
               launch counts are set to 0 just before and read just after;
               then the same run on the CPU, whose replayed training loss the
               card's must match to relative 1e-4 in every round;
  5. time    - each kernel, its plain version and its bound at the main
               path's shapes, then the kernel's wide (re-read) path at two
               widths off the main path;
  6. profile - device time by kernel over one more training run of the main
               path, from torch.profiler, and the device's busy share of the
               round loop.

Then one ``{"kernels": [...]}`` line, the card's name and power limit, and as
the last line ``{"ok": true, "device": {...}}``. Any failed check raises and
exits non-zero; without a CUDA card, or without the erasurehead_tpu_torch
package beside this script, it exits non-zero before printing any result.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# the main path: the README Quickstart's approx run at the flagship width
MAIN_ARGS = [
    "--scheme", "approx", "--workers", "30", "--stragglers", "2",
    "--num-collect", "15", "--rounds", "100", "--rows", "132000",
    "--cols", "128", "--update-rule", "AGD", "--compute-mode", "faithful",
    "--add-delay", "--quiet",
]
ROUNDS = 100
MAIN_SHAPE = (90, 4400, 128)  # [W * (s+1), rows per partition, F]
# rows wider than the kernel's registers: one re-read tile, and the covtype
# preset's width (eight tiles)
WIDE_SHAPES = ((30, 4400, 2048), (6, 2200, 15509))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
ARTIFACTS = ("training_loss", "testing_loss", "auc", "timeset", "worker_timeset")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def import_port():
    """The port package from this checkout, and nowhere else."""
    import erasurehead_tpu_torch

    pkg = os.path.dirname(os.path.abspath(erasurehead_tpu_torch.__file__))
    if os.path.dirname(pkg) != HERE:
        raise RuntimeError(f"erasurehead_tpu_torch imported from {pkg}, not this checkout")
    from erasurehead_tpu_torch import cli
    from erasurehead_tpu_torch.ops import kernels
    from erasurehead_tpu_torch.utils.device import pin_float32_precision

    pin_float32_precision()
    return cli, kernels


def make_inputs(M, R, F, dtype, seed, zero_every=0):
    g = torch.Generator().manual_seed(seed)
    X = (torch.randn(M, R, F, generator=g) * (10 / F**0.5)).to(dtype).cuda()
    y = torch.randn(M, R, generator=g).sign().cuda()
    b = (torch.randn(F, generator=g) * 0.1).cuda()
    w = torch.rand(M, generator=g).cuda()
    if zero_every:
        w[::zero_every] = 0.0
    return b, X, y, w


def check_glm(kernels, shape, dtype, kind, zero_every, seed):
    """Kernel vs plain version: |err| <= 1e-5 * sum_r |w s x| + 1e-6 per
    column, the float32 rounding of sums taken in another order."""
    b, X, y, w = make_inputs(*shape, dtype, seed, zero_every)
    got = kernels.fused_glm_grad(b, X, y, w, kind)
    again = kernels.fused_glm_grad(b, X, y, w, kind)
    want = kernels.reference_glm_grad(b, X, y, w, kind)
    Xf = X.float()
    s = kernels._residual(kind, torch.einsum("mrf,f->mr", Xf, b), y) * w[:, None]
    scale = torch.einsum("mrf,mr->f", Xf.abs(), s.abs())
    torch.cuda.synchronize()
    err = (got - want).abs()
    tol = 1e-5 * scale + 1e-6
    ok = bool((err <= tol).all()) and bool(torch.isfinite(got).all())
    rec = dict(
        kernel="fused_glm_grad", shape=list(shape), dtype=str(dtype).split(".")[-1],
        kind=kind, zero_weight_slots=int((w == 0).sum()),
        max_abs_err=float(err.max()), max_err_over_tol=float((err / tol).max()),
        bitwise_rerun=bool(torch.equal(got, again)), ok=ok,
    )
    emit("check", **rec)
    if not ok or not rec["bitwise_rerun"]:
        raise AssertionError(f"fused_glm_grad disagrees with its plain version: {rec}")
    return rec


def time_ms(fn, n=50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def glm_bound_ms(M, R, F, x_itemsize) -> tuple[float, str]:
    """Least time for the function on these inputs: each input read once and
    the output written once over HBM bandwidth, vs its float32 operations
    (2 FMAs per element of X) over the float32 peak."""
    nbytes = M * R * F * x_itemsize + M * R * 4 + F * 4 + M * 4 + F * 4
    flops = 4 * M * R * F
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def run_main(cli, out_dir, device) -> dict:
    if cli.main(MAIN_ARGS + ["--output-dir", out_dir, "--device", device]) != 0:
        raise AssertionError(f"cli.main failed on {device}")
    prefix = "approx_acc_2"
    paths = {a: os.path.join(out_dir, f"{prefix}_{a}.dat") for a in ARTIFACTS}
    missing = [p for p in paths.values() if not os.path.exists(p)]
    if missing:
        raise AssertionError(f"missing artifacts: {missing}")
    with open(os.path.join(out_dir, f"{prefix}_run_manifest.json")) as f:
        manifest = json.load(f)
    arts = {a: np.loadtxt(p, ndmin=1) for a, p in paths.items()}
    for a in ("training_loss", "testing_loss", "auc", "timeset"):
        if arts[a].shape != (ROUNDS,) or not np.isfinite(arts[a]).all():
            raise AssertionError(f"{a}: shape {arts[a].shape} or non-finite values")
    if arts["worker_timeset"].shape != (ROUNDS, 30):
        raise AssertionError(f"worker_timeset shape {arts['worker_timeset'].shape}")
    return dict(arts=arts, manifest=manifest)


def profile_train(cli) -> dict:
    """Where a round's time goes, over more runs of the main path's training
    (after the launch counts were read): one warm run without the profiler
    (steps/s), then one under torch.profiler, whose device activities in the
    round loop (kernels and device-to-device copies; the stack's upload
    before the loop and the profiler's own buffer events are left out) give
    the device's busy share of the loop."""
    from torch.profiler import ProfilerActivity, profile

    from erasurehead_tpu_torch.train import trainer

    cfg = cli._flags_to_config(cli._flags_parser().parse_args(MAIN_ARGS))
    ds = cli.load_dataset(cfg)
    warm = trainer.train(cfg, ds)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = trainer.train(cfg, ds)
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if dev_us and ev.key and not ev.key.startswith(
            ("cuda", "aten::", "Memcpy HtoD", "Activity Buffer")
        ):
            rows.append((ev.key, dev_us, ev.count))
    rows.sort(key=lambda r: -r[1])
    total_us = sum(r[1] for r in rows)
    return dict(
        rounds=cfg.rounds,
        warm_steps_per_sec=warm.steps_per_sec,
        profiled_loop_wall_ms=res.wall_time * 1e3,
        device_ms_in_loop=total_us / 1e3 if total_us else None,
        device_busy_share=total_us / (res.wall_time * 1e6) if total_us else None,
        top=[dict(name=k[:70], ms=us / 1e3, count=c) for k, us, c in rows[:10]],
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    cli, kernels = import_port()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
         kind=name, count=torch.cuda.device_count())

    t0 = time.perf_counter()
    kernels.load_library()
    emit("build", kernels=["fused_glm_grad"], seconds=time.perf_counter() - t0,
         library=os.path.relpath(str(kernels.library_path()), HERE))

    checks = []
    cases = [
        ((6, 40, 32), torch.float32, 0),  # ragged R (< one 256-row block)
        ((3, 17, 128), torch.float32, 0),
        ((5, 300, 17), torch.float32, 2),  # F % 4 != 0: the scalar path
        ((4, 33, 64), torch.bfloat16, 2),
        ((7, 1000, 1000), torch.bfloat16, 3),  # ragged R and F, 4 chunks
        ((3, 600, 2048), torch.float32, 2),  # the wide (re-read) path, one tile
        ((2, 300, 5001), torch.bfloat16, 0),  # wide, scalar, three tiles
        (MAIN_SHAPE, torch.float32, 2),  # R = 4400 ragged in 256-row blocks
        (MAIN_SHAPE, torch.bfloat16, 2),
    ]
    for i, (shape, dtype, zero_every) in enumerate(cases):
        for kind in kernels.GLM_KINDS:
            checks.append(check_glm(kernels, shape, dtype, kind, zero_every, seed=i))
    main_err = max(
        c["max_abs_err"] for c in checks
        if c["shape"] == list(MAIN_SHAPE) and c["dtype"] == "float32" and c["kind"] == "logistic"
    )

    with tempfile.TemporaryDirectory(prefix="eh-chip-smoke-") as tmp:
        kernels.reset_launches()
        gpu = run_main(cli, os.path.join(tmp, "cuda"), "cuda")
        launches = dict(kernels.LAUNCHES)
        if launches["fused_glm_grad"] != ROUNDS:
            raise AssertionError(f"main path launched {launches} (want {ROUNDS} fused_glm_grad)")
        cpu = run_main(cli, os.path.join(tmp, "cpu"), "cpu")
    g_loss, c_loss = gpu["arts"]["training_loss"], cpu["arts"]["training_loss"]
    rel = np.abs(g_loss - c_loss) / np.abs(c_loss)
    same_clock = (
        gpu["arts"]["timeset"].tobytes() == cpu["arts"]["timeset"].tobytes()
        and gpu["arts"]["worker_timeset"].tobytes() == cpu["arts"]["worker_timeset"].tobytes()
    )
    emit(
        "main", args=MAIN_ARGS, launches=launches,
        steps_per_sec=gpu["manifest"]["steps_per_sec"],
        wall_time_s=gpu["manifest"]["wall_time"],
        cpu_steps_per_sec=cpu["manifest"]["steps_per_sec"],
        train_loss_first_last=[float(g_loss[0]), float(g_loss[-1])],
        final_auc=float(gpu["arts"]["auc"][-1]),
        max_rel_loss_diff_vs_cpu=float(rel.max()), same_clocks_as_cpu=same_clock,
        decode_error_mean=gpu["manifest"].get("decode_error_mean"),
    )
    if not (rel <= 1e-4).all():
        raise AssertionError(f"card vs CPU training loss differs by up to {rel.max():.3g}")
    if not same_clock:
        raise AssertionError("card and CPU runs disagree on the simulated clocks")
    if not g_loss[-1] < g_loss[0]:
        raise AssertionError(f"training loss did not fall: {g_loss[0]} -> {g_loss[-1]}")

    # times at the main path's shapes (compare launches do not count)
    b, X, y, w = make_inputs(*MAIN_SHAPE, torch.float32, seed=100)
    Xb = X.to(torch.bfloat16)
    kernel_ms = time_ms(lambda: kernels.fused_glm_grad(b, X, y, w, "logistic"))
    plain_ms = time_ms(lambda: kernels.reference_glm_grad(b, X, y, w, "logistic"))
    kernel_bf16_ms = time_ms(lambda: kernels.fused_glm_grad(b, Xb, y, w, "logistic"))
    plain_ms_2 = time_ms(lambda: kernels.reference_glm_grad(b, X, y, w, "logistic"))
    kernel_ms_2 = time_ms(lambda: kernels.fused_glm_grad(b, X, y, w, "logistic"))
    bound_ms, bound_by = glm_bound_ms(*MAIN_SHAPE, 4)
    bound_bf16_ms, _ = glm_bound_ms(*MAIN_SHAPE, 2)
    emit("time", kernel="fused_glm_grad", shape=list(MAIN_SHAPE),
         kernel_ms=[kernel_ms, kernel_ms_2], plain_ms=[plain_ms, plain_ms_2],
         kernel_bf16_ms=kernel_bf16_ms, bound_ms=bound_ms, bound_bf16_ms=bound_bf16_ms,
         achieved_tb_per_s=(bound_ms / min(kernel_ms, kernel_ms_2)) * HBM_BYTES_PER_S / 1e12)
    del b, X, y, w, Xb
    for shape in WIDE_SHAPES:  # off the main path: the wide kernel's cost
        b, X, y, w = make_inputs(*shape, torch.float32, seed=101)
        k_ms = time_ms(lambda: kernels.fused_glm_grad(b, X, y, w, "logistic"), n=20)
        p_ms = time_ms(lambda: kernels.reference_glm_grad(b, X, y, w, "logistic"), n=20)
        bound, by = glm_bound_ms(*shape, 4)
        emit("time_wide", kernel="fused_glm_grad", shape=list(shape), kernel_ms=k_ms,
             plain_ms=p_ms, bound_ms=bound, bound_by=by)
        del b, X, y, w

    emit("profile", **profile_train(cli))

    kernel_ms_best = min(kernel_ms, kernel_ms_2)
    line = {"kernels": [{
        "name": "fused_glm_grad",
        "route": "cuda",
        "source": "erasurehead_tpu_torch/csrc/fused_glm_grad.cu",
        "replaces": "erasurehead_tpu/ops/kernels.py:68",
        "tpu_kernel": "erasurehead_tpu/ops/kernels.py:_kernel",
        "launches": launches["fused_glm_grad"],
        "max_abs_err": main_err,
        "ms": kernel_ms_best,
        "plain_ms": min(plain_ms, plain_ms_2),  # the two-pass torch yardstick
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "steps_per_sec": gpu["manifest"]["steps_per_sec"],
    }]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
