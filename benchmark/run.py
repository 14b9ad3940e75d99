"""The benchmark of erasurehead_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
The last line of standard output is the result, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (``--trace 0``: the
cell's end-to-end metrics; ``--trace 1``: its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number that decided ``correct`` beside its limit (also the last lines of
standard error).

Exits with a code other than 0, printing no result, when there is no CUDA
card (or fewer than the cell asks for), when the program is not in the
checkout, or when a module of JAX or of the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
#: every build and kernel cache of the program, at fixed paths in the checkout
CACHE_DIR = ROOT / "build" / "benchmark"


def _environment() -> None:
    """The program's knobs come from the cell, not from the environment."""
    for key in list(os.environ):
        if key.startswith("ERASUREHEAD_"):
            del os.environ[key]
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE_DIR / "nv_compute_cache")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    _environment()
    sys.path.insert(0, str(BENCH_DIR))
    sys.path.insert(1, str(ROOT))
    import manifest

    cell = manifest.load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: cell {cell.name} needs {cell.chips} CUDA card(s), found {have}",
              file=sys.stderr)
        return 2
    try:
        import erasurehead_tpu_torch
    except ImportError as e:
        print(f"benchmark: the program is not in this checkout: {e}", file=sys.stderr)
        return 2
    if Path(erasurehead_tpu_torch.__file__).resolve().parent.parent != ROOT:
        print(f"benchmark: erasurehead_tpu_torch loaded from outside the checkout "
              f"({erasurehead_tpu_torch.__file__})", file=sys.stderr)
        return 2
    from erasurehead_tpu_torch.ops import kernels

    kernels.set_build_dir(CACHE_DIR / "kernels")

    import harness

    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device="cuda",
                           t_start=T_START)
    print(f"run {time.perf_counter() - T_START:.3f} s, correct {out['correct']}",
          file=sys.stderr)
    return emit(out)


def emit(out: dict) -> int:
    """Print the result's checks on standard error and the result as the
    last line of standard output; print no result, and return 3, where a
    module of JAX or of the JAX package is loaded in this process by now
    (the window, the traced stretch, the reference and the metric readers
    have all run)."""
    import harness

    bad = harness.forbidden_loaded()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
