"""CPU tests of the benchmark's harness: the manifest, the byte and FLOP
counts, the plain reference against the port, the result line, the refusal
to run without a card, and the imports.

Run from the checkout's root: ``python -m pytest benchmark/tests``. Tests
that need the card carry the ``cuda`` marker and decide inside the test."""

from __future__ import annotations

import ast
import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import types

import pytest

from bench_util import BENCH_DIR, ROOT, cut

import check  # noqa: E402
import devtrace  # noqa: E402
import harness  # noqa: E402
import manifest  # noqa: E402
import roofline  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = ("gmm132k.approx.seq", "covtype.approx.seq", "covtype.sweep7.cohort")


def bench():
    return manifest.load_benchmark()


def test_manifest_names_units_and_files():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert len(json.dumps(b)) <= 64 * 1024
    assert b["command"][1:] == ["benchmark/run.py"] and b["paths"] == ["benchmark"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    entries = b["configs"] + b["workloads"] + b["end_to_end"] + b["per_layer"]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    layers = {}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"] and len(m["layer"]) <= 200
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        layers.setdefault(m["layer"], []).append(m["name"])
    cells = {w["name"]: w for w in b["workloads"]}
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    for w in cells.values():
        for key in ("config", "traffic"):
            assert NAME.match(w[key])
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH_DIR / "limits" / f"{w['name']}.json").is_file()
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in cells.values())
        for key in c["reduced"]:
            assert NAME.match(key) and not key.endswith(("_dim", "_rank"))
    # the check's budget at the full 24 cells
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_cell_loads_and_reports():
    b = bench()
    for name in CELLS:
        cell = manifest.load_cell(name)
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "traj_rounds_per_s"}
        assert cell.per_layer
        assert set(cell.limits) <= set(check.NUMBERS) and cell.limits["clock_gap"] == 0.0
    assert {w["name"] for w in b["workloads"]} == set(CELLS)


def test_grad_bytes_hand_counts():
    gmm = manifest.load_cell("gmm132k.approx.seq")
    seq = manifest.load_cell("covtype.approx.seq")
    coh = manifest.load_cell("covtype.sweep7.cohort")
    # [90, 4400, 128] float32 and its labels: data_cache's stack_bytes 204,336,000
    assert roofline.grad_bytes(gmm.config, gmm.traffic, 3, 1) == (
        90 * 4400 * 128 * 4 + 90 * 4400 * 4 + 90 * 4 + 2 * 128 * 4)
    assert 90 * 4400 * 128 * 4 + 90 * 4400 * 4 == 204_336_000
    # PaddedRows [90, 13204, 12]: int32 columns and float32 values
    assert roofline.grad_bytes(seq.config, seq.traffic, 3, 1) == (
        90 * 13204 * 12 * 8 + 90 * 13204 * 4 + 90 * 4 + 2 * 15509 * 4)
    # FieldOnehot [30, 13204, 12] int32, seven trajectories
    assert roofline.grad_bytes(coh.config, coh.traffic, 1, 7) == (
        30 * 13204 * 12 * 4 + 30 * 13204 * 4 + 7 * (30 * 4 + 2 * 15509 * 4))
    assert roofline.flops_per_trajectory_round(gmm.config) == 4 * 132000 * 128
    assert roofline.flops_per_trajectory_round(seq.config) == 4 * 396120 * 12
    p = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert p == {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12}
    with pytest.raises(KeyError):
        roofline.peaks("cpu")


def test_loop_share_counts_a_cohort_loop_once():
    coh = manifest.load_cell("covtype.sweep7.cohort")
    members = [(s, 1000, 7) for s in coh.traffic["schemes"]]
    ctx = types.SimpleNamespace(
        config=coh.config, traffic=coh.traffic, prof={"graph_s": 2.0},
        peaks=lambda: {"hbm_bytes_per_s": 3.35e12}, profiled_trajectories=lambda: members)
    want = 100.0 * 1000 * roofline.grad_bytes(coh.config, coh.traffic, 1, 7) / 3.35e12 / 2.0
    assert roofline.loop_share(ctx) == pytest.approx(want)
    ctx.prof = {"graph_s": 0.0}
    assert roofline.loop_share(ctx) is None


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_port_on_cpu(name):
    got = check.readings(cut(name), 2**31 + 5, "cpu")["program"]
    limits = manifest.load_cell(name).limits
    assert got["clock_gap"] == 0.0
    assert check.passes(got, limits), got


@pytest.mark.parametrize("name", CELLS)
def test_last_line_keys(name):
    out = harness.run_cell(cut(name), 2**33 + 1, 0.2, False, device="cpu", log=lambda m: None)
    assert list(out)[-1] == "checks"
    assert set(out) == {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"traj_rounds_per_s", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_same_seed_same_inputs():
    cell = cut("covtype.sweep7.cohort")
    a, b = harness.Stream(2**32 + 3), harness.Stream(2**32 + 3)
    da = harness.draw_dispatch(a, cell.config, cell.traffic, "cpu")
    db = harness.draw_dispatch(b, cell.config, cell.traffic, "cpu")
    assert (da["arrivals"] == db["arrivals"]).all()
    assert all((da["init"][k] == db["init"][k]).all() for k in da["init"])
    gen = manifest.plugin("datagen", "onehot")
    x = gen.generate(cell.config["data"], 6, 11, "cpu")
    y = gen.generate(cell.config["data"], 6, 11, "cpu")
    assert all((x[k] == y[k]).all() for k in ("idx_train", "y_train", "idx_test", "y_test"))


def test_no_card_means_no_result(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"), "--workload", CELLS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA card" in r.stderr


@pytest.mark.cuda
def test_bare_checkout_means_no_result(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: without one run.py stops before importing the program")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed",
                        "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_jax_import_anywhere_and_reference_stands_alone():
    for path in BENCH_DIR.rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in harness.FORBIDDEN_MODULES, (path, mod)
    for path in (BENCH_DIR / "reference").glob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] in ("__future__", "dataclasses", "numpy", "torch"), (
                path, mod)


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_loaded(["erasurehead_tpu_torch.train", "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_loaded(["erasurehead_tpu.ops", "jax.numpy", "jaxlib", "os"]) == [
        "erasurehead_tpu.ops", "jax.numpy", "jaxlib"]


def test_harness_run_loads_no_jax():
    harness.run_cell(cut("gmm132k.approx.seq"), 7, 0.1, False, device="cpu", log=lambda m: None)
    code = ("import sys; sys.path[:0] = [%r, %r]; import harness, check, devtrace, roofline;"
            "import erasurehead_tpu_torch.train.experiments;"
            "print(harness.forbidden_loaded())" % (str(BENCH_DIR), str(ROOT)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_trace_reduction():
    dev = [(10, 40, "k_graph", 7), (20, 30, "k_eager", 8), (100, 110, "Memcpy HtoD", 9),
           (150, 160, "k_eager", 10)]
    host = [(0, 5, "cudaGraphLaunch"), (40, 60, "cudaMemcpyAsync")]
    samples = [(120, "train/evaluate.py:_put"), (130, "train/evaluate.py:_put"),
               (135, "train/evaluate.py:replay"), (200, "train/trainer.py:train")]
    red = devtrace.reduce_events(dev, host, {7}, samples)
    assert math.isclose(red["busy_s"], 50e-6) and math.isclose(red["graph_s"], 30e-6)
    assert red["device_ops"][0] == ["k_graph", pytest.approx(30e-6)]
    # the longest gap (40, 100) has no sample: the runtime call before it
    assert red["idle_gaps"][0] == ["host between calls, after cudaMemcpyAsync",
                                   pytest.approx(60e-6)]
    # the next (110, 150): the port's function sampled most often inside it
    assert red["idle_gaps"][1] == ["train/evaluate.py:_put", pytest.approx(40e-6)]
    assert red["sampled_gaps"] == 1
    assert devtrace.reduce_events([], host, set())["n_device_events"] == 0


def test_idle_share_is_taken_over_the_untraced_dispatch():
    read = manifest.metric_reader("device_idle_share")
    prof = {"n_device_events": 9, "busy_s": 1.0, "window_s": 6.0, "untraced_s": 4.0}
    assert read(types.SimpleNamespace(prof=prof)) == pytest.approx(75.0)
    assert read(types.SimpleNamespace(prof=None)) is None
    assert read(types.SimpleNamespace(prof=dict(prof, n_device_events=0))) is None


def test_host_sampler_labels_the_programs_frame():
    from erasurehead_tpu_torch.utils import config as port_config

    with devtrace.HostSampler(interval=0.001) as sampler:
        t_end = time.perf_counter() + 0.3
        while time.perf_counter() < t_end:
            port_config.RunConfig(scheme="naive")
    labels = {label for _, label in sampler.samples}
    assert len(sampler.samples) > 20
    assert any(label.startswith("utils/config.py:") for label in labels), labels
    assert all(t > 0 for t, _ in sampler.samples)


def test_warm_up_covers_each_shape_once():
    seq = manifest.load_cell("covtype.approx.seq").traffic
    coh = manifest.load_cell("covtype.sweep7.cohort").traffic
    assert harness.warm_labels(seq) == ["approx.0"]
    assert harness.warm_labels(coh) == [label for label, _ in harness.labels(coh)]
    two = dict(seq, schemes={"approx": {}, "naive": {}})
    assert harness.warm_labels(two) == ["approx.0", "naive.0"]


def test_jax_loaded_after_the_window_means_no_result(tmp_path, monkeypatch, capsys):
    """A plugin the harness loads after the window (here the plain
    reference) imports a stub ``jax``: run.py's last look finds it and
    prints no result."""
    import run

    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path))
    real = manifest.plugin

    def planted(kind, name):
        mod = real(kind, name)
        if kind == "reference":
            importlib.import_module("jax")
        return mod

    monkeypatch.setattr(manifest, "plugin", planted)
    try:
        out = harness.run_cell(cut("gmm132k.approx.seq"), 2**31 + 7, 0.1, False,
                               device="cpu", log=lambda m: None)
        capsys.readouterr()
        assert "jax" in sys.modules
        assert run.emit(out) == 3
        got = capsys.readouterr()
        assert got.out == "" and "['jax']" in got.err
    finally:
        sys.modules.pop("jax", None)
    assert run.emit(out) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["correct"] is True
