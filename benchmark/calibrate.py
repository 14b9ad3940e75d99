"""The readings the limits of ``correct`` are set from (check.py), and the
faults and the control read against those limits.

    python3 benchmark/calibrate.py --workload <cell> [--seeds 1 2 ...] \
        [--control-seeds 1 2 3] [--faults unchanged half_rows loss clock] \
        [--fault-seeds 1 2 3] [--out FILE]

For each seed, as a run makes them (harness.prepare): the dataset, then one
compare() of the cell's traffic (its full size, one dispatch). Each of its
trajectories is compared with the float64 plain reference (the lower
readings: sound runs of the program). For each control seed, the control
takes the program's place: the same reference computed in the precision the
configuration's ``control`` names, the nearest below the one it states
(TF32 for float32 with TF32 off, bfloat16 for other float32), compared the
same way (the upper readings). For each fault seed and each fault of
faults.py, the program with that fault planted, compared the same way.
One JSON line a seed and kind, with ``correct``, the committed limits'
verdict on it, then a summary: the largest program reading and the
smallest control reading of each number. Needs the card, as run.py.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    run._environment()
    sys.path.insert(0, str(run.BENCH_DIR))
    sys.path.insert(1, str(run.ROOT))
    import torch

    import check
    import faults
    import manifest

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    from erasurehead_tpu_torch.ops import kernels

    kernels.set_build_dir(run.CACHE_DIR / "kernels")
    cell = manifest.load_cell(args.workload, run.ROOT)
    lines = []

    def emit(seed, kind, numbers, t0):
        line = {"cell": cell.name, "seed": seed, "kind": kind, **numbers,
                "correct": check.passes(numbers, cell.limits),
                "seconds": time.perf_counter() - t0}
        lines.append(line)
        print(json.dumps(line), flush=True)

    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t0 = time.perf_counter()
        res = check.readings(cell, seed, "cuda", program=seed in args.seeds,
                             control=seed in args.control_seeds)
        for kind, numbers in res.items():
            emit(seed, kind, numbers, t0)
    for fault in args.faults:
        for seed in args.fault_seeds:
            t0 = time.perf_counter()
            with faults.FAULTS[fault]():
                numbers = check.readings(cell, seed, "cuda")["program"]
            emit(seed, f"fault.{fault}", numbers, t0)
    summary = {"cell": cell.name, "kind": "summary", "limits": cell.limits}
    for k in check.NUMBERS:
        prog = [ln[k] for ln in lines if ln["kind"] == "program"]
        ctrl = [ln[k] for ln in lines if ln["kind"] == "control"]
        summary[k] = {"program_max": max(prog) if prog else None,
                      "control_min": min(ctrl) if ctrl else None}
    summary["correct_by_kind"] = {
        kind: sorted({ln["correct"] for ln in lines if ln["kind"] == kind})
        for kind in sorted({ln["kind"] for ln in lines})}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for ln in lines + [summary]:
                f.write(json.dumps(ln) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
