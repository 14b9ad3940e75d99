"""Operations and bytes of one round, computed from the shapes, and the
card's peaks (peaks.json).

The stack a round's lowering is handed:
  dense     [M, rows, F] float32                  4 F bytes a row
  padded    PaddedRows, [M, rows, K] int32 column indices + float32 values
  fields    FieldOnehot, [M, rows, K] int32 in-field indices (values are 1)
where M = W x S slots (faithful: each worker's slots, the redundant copies
included) or P partitions (deduped), K the nonzeros a row.

One round's decoded gradients, for B trajectories that share the stack,
must move at least: the stack once, the labels (float32, one a stack row),
each trajectory's slot weights (float32, one a stack block) and params in,
and its gradient out (float32, F each).

The model FLOPs of one trajectory-round are the margin and the gradient
over the distinct training rows: 4 n F dense, 4 n K sparse (a multiply and
an add each); the faithful stack's copies are not counted.
"""

from __future__ import annotations

import json
from pathlib import Path

_PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def peaks(device_name: str) -> dict:
    """The data-sheet peaks of the card whose name starts with a known key."""
    for key, vals in _PEAKS["cards"].items():
        if device_name.startswith(key):
            return vals
    raise KeyError(f"no peaks for {device_name!r} in peaks.json")


def stack_blocks(config: dict, traffic: dict, slots_per_worker: int) -> int:
    """M, the stack's leading blocks."""
    if traffic["compute_mode"] == "faithful":
        return int(config["n_workers"]) * slots_per_worker
    return int(config["n_workers"])


def row_bytes(config: dict, traffic: dict) -> int:
    data = config["data"]
    if data["generator"] == "gmm":
        return 4 * int(data["n_cols"])
    K = int(data["n_fields"])
    if traffic["sparse_format"] == "padded":
        return 8 * K
    return 4 * K


def grad_bytes(config: dict, traffic: dict, slots_per_worker: int, trajectories: int) -> int:
    """Least bytes of one loop round of ``trajectories`` decoded gradients."""
    M = stack_blocks(config, traffic, slots_per_worker)
    rows = int(config["data"]["n_rows"]) // int(config["n_workers"])
    F = int(config["data"]["n_cols"])
    stack = M * rows * row_bytes(config, traffic)
    labels = M * rows * 4
    per_traj = 4 * M + 4 * F + 4 * F
    return stack + labels + trajectories * per_traj


def flops_per_trajectory_round(config: dict) -> int:
    data = config["data"]
    n = int(data["n_rows"])
    if data["generator"] == "gmm":
        return 4 * n * int(data["n_cols"])
    return 4 * n * int(data["n_fields"])


def loop_share(ctx):
    """The round loops' share of their bytes roofline in the traced
    stretch, in %: the least time for the bytes the stretch's loops had to
    move (:func:`grad_bytes`, each loop's rounds) at the card's HBM
    bandwidth, over the device time of the operations its CUDA graph
    replays ran. None where the stretch replayed no graph. Which cells
    report it under which name (dense or sparse stack) is BENCHMARK.json's
    ``workloads`` of the metric."""
    p = ctx.prof
    if p is None or p["graph_s"] <= 0:
        return None
    import manifest

    sch = manifest.plugin("reference", "schemes")
    need = 0.0
    for scheme, rounds, size in ctx.profiled_trajectories():
        lay = sch.layout(scheme, int(ctx.config["n_workers"]), int(ctx.config["n_stragglers"]), 0)
        # a cohort's loop moves grad_bytes(size) a round for all its members
        need += rounds * grad_bytes(ctx.config, ctx.traffic, lay.assignment.shape[1], size) / size
    return 100.0 * need / ctx.peaks()["hbm_bytes_per_s"] / p["graph_s"]
