"""Result artifacts: the five per-run files the reference saves, plus a manifest.

The same file names and manifest as erasurehead_tpu/train/artifacts.py, in
``<output_dir>``:

  <prefix>_training_loss.dat   per-iteration train loss
  <prefix>_testing_loss.dat    per-iteration test loss
  <prefix>_auc.dat             per-iteration test AUC
  <prefix>_timeset.dat         per-iteration simulated wall-clock
  <prefix>_worker_timeset.dat  [rounds x W] per-worker arrival latencies
  <prefix>_run_manifest.json   the config and run summary

Values are written at full float precision (the reference's save_vector
truncated to 3 decimals, src/util.py:32-36).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np

from erasurehead_tpu_torch.obs.events import arrival_summary
from erasurehead_tpu_torch.train.evaluate import EvalResult
from erasurehead_tpu_torch.train.trainer import TrainResult
from erasurehead_tpu_torch.utils.config import RunConfig

def run_prefix(cfg: RunConfig) -> str:
    """Reference filename prefix, from the scheme's registry descriptor
    (``artifact_stem``, ``artifact_straggler_suffix``, ``partial``):
    "naive_acc", "coded_acc_<s>", partial schemes "<stem>_<s>_<p>", every
    other scheme "<stem or name_acc>_<s>"."""
    from erasurehead_tpu_torch import schemes

    desc = schemes.get(cfg.scheme)
    stem = desc.artifact_stem or f"{desc.name}_acc"
    if desc.partial:
        return f"{stem}_{cfg.n_stragglers}_{cfg.partitions_per_worker}"
    if not desc.artifact_straggler_suffix:
        return stem
    return f"{stem}_{cfg.n_stragglers}"


def save_vector(v: np.ndarray, path: str) -> None:
    """One value per line, full precision."""
    np.savetxt(path, np.asarray(v).reshape(-1), fmt="%.18g")


def save_matrix(m: np.ndarray, path: str) -> None:
    np.savetxt(path, np.asarray(m), fmt="%.18g")


def write_run_artifacts(
    result: TrainResult,
    ev: Optional[EvalResult],
    output_dir: str,
) -> dict:
    """Write the five reference artifacts + manifest; returns paths."""
    cfg: RunConfig = result.config
    prefix = run_prefix(cfg)
    os.makedirs(output_dir, exist_ok=True)
    paths = {}

    def emit(name, saver, data):
        path = os.path.join(output_dir, f"{prefix}_{name}.dat")
        saver(data, path)
        paths[name] = path

    # A resumed run's history (and so the eval curves) covers rounds
    # [start_round, rounds) while the precomputed clocks cover the whole
    # run; the clocks are sliced to the same window, so row i of every
    # artifact is round start_round + i (recorded in the manifest)
    sr = result.start_round
    if ev is not None:
        emit("training_loss", save_vector, ev.training_loss)
        emit("testing_loss", save_vector, ev.testing_loss)
        emit("auc", save_vector, ev.auc)
    emit("timeset", save_vector, result.timeset[sr:])
    emit("worker_timeset", save_matrix, result.worker_times[sr:])

    def jsonable(v):
        if hasattr(v, "value"):  # enums
            return v.value
        if isinstance(v, np.ndarray):
            return v.tolist()
        return v

    manifest = {
        "config": {
            k: jsonable(v) for k, v in dataclasses.asdict(cfg).items()
        },
        # sim_total_time covers the whole precomputed schedule; a resumed
        # run's artifacts cover [start_round, rounds), whose simulated clock
        # is window_sim_total_time (the sum of the timeset artifact's rows)
        "sim_total_time": result.sim_total_time,
        "window_sim_total_time": float(np.sum(result.timeset[sr:])),
        "start_round": sr,
        "wall_time": result.wall_time,
        "steps_per_sec": result.steps_per_sec,
        "n_train": result.n_train,
        "arrival": arrival_summary(result.worker_times[sr:]),
        "artifacts": paths,
    }
    if result.decode_error is not None:
        err = np.asarray(result.decode_error[sr:], dtype=np.float64)
        manifest["decode_error_mean"] = float(err.mean()) if err.size else 0.0
        manifest["decode_error_max"] = float(err.max()) if err.size else 0.0
    mpath = os.path.join(output_dir, f"{prefix}_run_manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=2, default=str)
    paths["manifest"] = mpath
    return paths


def print_iteration_table(result: TrainResult, ev: EvalResult) -> None:
    """The reference's per-iteration eval printout (src/naive.py:198),
    rows labeled with true round numbers (a resumed run's curves start at
    result.start_round)."""
    sr = result.start_round
    for i in range(len(ev.training_loss)):
        line = (
            f"Iteration {sr + i}: Train Loss = {ev.training_loss[i]:.5f}, "
            f"Test Loss = {ev.testing_loss[i]:.5f}"
        )
        if not np.isnan(ev.auc[i]):
            line += f", AUC = {ev.auc[i]:.5f}"
        line += f", Sim time = {result.timeset[sr + i]:.4f}s"
        wt = np.asarray(result.worker_times[sr + i], dtype=np.float64)
        arrived = wt[wt >= 0.0]
        if arrived.size:
            line += (
                f", Mean arrival = {arrived.mean():.4f}s "
                f"({arrived.size}/{wt.size})"
            )
        else:
            line += ", no arrivals"
        print(line)
    print(
        f"Total simulated time: {float(np.sum(result.timeset[sr:])):.3f}s | "
        f"real wall {result.wall_time:.3f}s | "
        f"{result.steps_per_sec:.1f} steps/s"
    )
