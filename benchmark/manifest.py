"""The benchmark's manifest: BENCHMARK.json and the files it names.

Everything that belongs to one configuration, one traffic mix, one cell's
limits or one per-layer metric sits in a file of its own, found by name:

  configs/<config>.json     sizes, coding deployment, schedule (the file
                            BENCHMARK.json's ``configs[].file`` names)
  traffic/<traffic>.json    the sweep: schemes, trajectories a compare,
                            batching, compute mode, sparse format, checks
  limits/<cell>.json        the limit of each number ``correct`` compares
  metrics/<metric>.py       the reader of one per-layer metric

A later cell, configuration or metric is added by adding files and
entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

#: the benchmark's own folder and the checkout's root
BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload: a configuration under a traffic mix."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    #: end-to-end metric entries of BENCHMARK.json this cell reports
    end_to_end: tuple
    #: per-layer metric entries this cell reports
    per_layer: tuple


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return _read_json(root / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its files read."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=_read_json(root / conf["file"]),
        traffic=_read_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        limits=_read_json(BENCH_DIR / "limits" / f"{name}.json"),
        end_to_end=tuple(m for m in bench["end_to_end"] if _applies(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _applies(m, name)),
    )


def metric_reader(name: str):
    """The ``read(ctx)`` function of metrics/<name>.py."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def plugin(kind: str, name: str):
    """Module ``<kind>/<name>.py`` of the benchmark (a data generator or a
    plain reference), loaded from its file."""
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
