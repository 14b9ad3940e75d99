"""Shared helpers of the benchmark's CPU tests: the harness's modules on the
path, and cells of BENCHMARK.json cut to a size a CPU test can run."""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
for p in (str(BENCH_DIR), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import manifest  # noqa: E402

#: data sizes of the CPU tests by generator: widths and rows cut, W = 6
TINY = {
    "gmm": {"n_rows": 6000, "n_cols": 32},
    "onehot": {"n_rows": 1200, "n_cols": 200, "n_fields": 4},
}
#: a size at which the control's rounding shows above the program's, and a
#: single test pair ordered the other way moves the AUC by under 2e-7
SMALL = {
    "gmm": {"n_rows": 6000, "n_cols": 32},
    "onehot": {"n_rows": 24000, "n_cols": 1550, "n_fields": 12},
}


def cut(name: str, sizes: dict = TINY, rounds: int = 30) -> manifest.Cell:
    """Cell ``name`` with its data cut to ``sizes``, 6 workers (s = 2,
    collecting 3) and ``rounds`` rounds; traffic and limits as committed."""
    cell = manifest.load_cell(name)
    config = dict(cell.config)
    data = dict(config["data"])
    data.update(sizes[data["generator"]])
    config.update(data=data, n_workers=6, num_collect=3, rounds=rounds)
    return dataclasses.replace(cell, config=config)
