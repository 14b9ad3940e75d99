"""One run of a cell: inputs from the seed, set-up, the timed window, the
traced stretch, the check against the plain reference, the result line.

The window drives ``erasurehead_tpu_torch.train.experiments.compare``, the
sweep users run (the CLI's ``sweep`` and ``compare``): each dispatch is one
``compare()`` over the traffic's trajectories, set-up of each trajectory or
cohort, the round loop, the loss and AUC replay and the summaries included.
Dispatches run back to back; the window closes when the first dispatch
that completes after ``seconds`` completes.

Inputs come from the seed alone: the dataset (datagen/), drawn once a run;
then, per dispatch, the next draws of a stream: the [rounds, W] arrival
matrix (the reference's exponential straggler delays, as under
``--add-delay``) and each trajectory's initial params. The layout seeds of
seed-drawn codes are drawn once a run, so every dispatch runs the same
shapes and codes.

Set-up ends with one warm-up dispatch of one trajectory of each shape
(:func:`warm_labels`), which builds the kernels, captures the graphs and
uploads the stack. With ``--trace 1`` two more dispatches of the same
inputs follow the window: untraced, for the wall time of the card's idle
share, then under the profiler (devtrace.py).
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np

import check
import devtrace
import manifest
import roofline

#: top-level module names that must not be loaded in the measured process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "erasurehead_tpu")


def forbidden_loaded(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN_MODULES)


class Stream:
    """The run's seed stream: whole numbers drawn in a fixed order."""

    def __init__(self, seed: int):
        self._rng = np.random.default_rng([int(seed) & (2**64 - 1), 0xB3])

    def next(self) -> int:
        return int(self._rng.integers(0, 2**62))


def labels(traffic: dict) -> list:
    """(label, scheme) of each trajectory of a compare, scheme-major."""
    k = int(traffic["trajectories_per_scheme"])
    return [(f"{s}.{i}", s) for s in traffic["schemes"] for i in range(k)]


def run_configs(config: dict, traffic: dict, layout_seeds: dict) -> dict:
    """label -> the port's RunConfig."""
    from erasurehead_tpu_torch import schemes
    from erasurehead_tpu_torch.utils.config import RunConfig

    data = config["data"]
    out = {}
    for label, scheme in labels(traffic):
        opts = dict(traffic["schemes"][scheme])
        if schemes.get(scheme).needs_num_collect:
            opts.setdefault("num_collect", int(config["num_collect"]))
        out[label] = RunConfig(
            scheme=scheme, model=config["model"], n_workers=int(config["n_workers"]),
            n_stragglers=int(config["n_stragglers"]), rounds=int(config["rounds"]),
            add_delay=True, delay_mean=float(config["delay_mean"]),
            update_rule=config["update_rule"], lr_schedule=float(config["lr"]),
            n_rows=int(data["n_rows"]), n_cols=int(data["n_cols"]),
            compute_mode=traffic["compute_mode"], sparse_format=traffic["sparse_format"],
            dtype=config["dtype"], seed=layout_seeds[label], **opts,
        )
    return out


def draw_dispatch(stream: Stream, config: dict, traffic: dict, device) -> dict:
    """One compare's inputs: the arrival matrix and each trajectory's init."""
    import torch

    R, W = int(config["rounds"]), int(config["n_workers"])
    arrivals = np.random.default_rng(stream.next()).exponential(
        float(config["delay_mean"]), (R, W))
    F = int(config["data"]["n_cols"])
    inits = {}
    for label, _ in labels(traffic):
        g = torch.Generator(device=device).manual_seed(stream.next())
        inits[label] = torch.randn(F, generator=g, device=device).cpu().numpy()
    return {"arrivals": arrivals, "init": inits}


def _record(rows) -> list:
    """What the check and the metrics keep of compare()'s summaries."""
    out = []
    for r in rows:
        cohort = (r.cache or {}).get("cohort_size") if r.cache else None
        out.append({
            "label": r.label, "status": r.status,
            "train_loss": np.asarray(r.training_loss, np.float64),
            "timeset": np.asarray(r.timeset, np.float64),
            "test_loss": float(r.final_test_loss), "auc": float(r.final_auc),
            "loop_s": r.config.rounds / r.real_steps_per_sec if r.real_steps_per_sec > 0
            else float("inf"),
            "rounds": int(r.config.rounds), "cohort_size": int(cohort or 1),
        })
    return out


def dispatch(experiments, configs, dataset, traffic, inputs, device) -> list:
    rows = experiments.compare(configs, dataset, arrivals=inputs["arrivals"],
                               batch=traffic["batch"], init_params=inputs["init"],
                               device=device)
    return _record(rows)


def _sync(device) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def prepare(cell: manifest.Cell, seed: int, device) -> dict:
    """A run's inputs before its first dispatch, drawn from the seed in a
    fixed order (the run and calibrate.py both start here): the seed
    stream, the layout seed of each trajectory, the dataset on the device
    and the port's RunConfig of each label."""
    config, traffic = cell.config, cell.traffic
    gen = manifest.plugin("datagen", config["data"]["generator"])
    stream = Stream(seed)
    layout_seeds = {label: stream.next() % 2**31 for label, _ in labels(traffic)}
    data = gen.generate(config["data"], int(config["n_workers"]), stream.next(), device)
    return {"stream": stream, "generator": gen, "data": data,
            "configs": run_configs(config, traffic, layout_seeds)}


def warm_labels(traffic: dict) -> list:
    """The trajectories whose dispatch builds every shape of the traffic:
    under ``batch="on"`` the whole cohort; one at a time, the first label
    of each scheme (a scheme's trajectories share their shapes, kernels,
    graphs and data stack)."""
    if traffic["batch"] != "off":
        return [label for label, _ in labels(traffic)]
    seen: dict = {}
    for label, scheme in labels(traffic):
        seen.setdefault(scheme, label)
    return list(seen.values())


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool, *, device="cuda",
             t_start: float | None = None, log=None) -> dict:
    """The whole run of ``cell``; returns the result dict (the last line)."""
    import torch

    from erasurehead_tpu_torch.train import cache as cache_lib
    from erasurehead_tpu_torch.train import experiments

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t_start = time.perf_counter() if t_start is None else t_start
    config, traffic = cell.config, cell.traffic
    t_data = time.perf_counter()
    prep = prepare(cell, seed, device)
    stream, data, configs = prep["stream"], prep["data"], prep["configs"]
    _sync(device)
    t_host = time.perf_counter()
    dataset = prep["generator"].to_host(data)
    t_warm = time.perf_counter()

    # set-up: every shape of the cell's traffic, once (builds, captures,
    # the stack's upload into the data cache)
    inputs = draw_dispatch(stream, config, traffic, device)
    warm = {label: configs[label] for label in warm_labels(traffic)}
    dispatch(experiments, warm, dataset, traffic,
             {"arrivals": inputs["arrivals"],
              "init": {label: inputs["init"][label] for label in warm}}, device)
    _sync(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    log(f"set-up {setup_s:.3f} s: imports {t_data - t_start:.3f}, data on the card "
        f"{t_host - t_data:.3f}, to the host {t_warm - t_host:.3f}, warm-up dispatch of "
        f"{len(warm)} trajectories {t0 - t_warm:.3f}")

    window = []
    while True:
        inputs = draw_dispatch(stream, config, traffic, device)
        d0 = time.perf_counter()
        recs = dispatch(experiments, configs, dataset, traffic, inputs, device)
        d1 = time.perf_counter()
        window.append({"inputs": inputs, "records": recs, "seconds": d1 - d0})
        if d1 - t0 >= seconds:
            break
    window_s = d1 - t0
    log(f"window {window_s:.3f} s, {len(window)} dispatches, "
        f"dispatch seconds {[round(w['seconds'], 4) for w in window]}")

    on_card = str(device).startswith("cuda")
    memory_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    prof = None
    if trace:
        # the same inputs twice: untraced for the wall time the card's idle
        # share is taken over, then under the profiler (which lengthens the
        # stretch by its records of every launch)
        inputs = draw_dispatch(stream, config, traffic, device)
        u0 = time.perf_counter()
        dispatch(experiments, configs, dataset, traffic, inputs, device)
        _sync(device)
        untraced_s = time.perf_counter() - u0
        prof = devtrace.profile_call(
            lambda: dispatch(experiments, configs, dataset, traffic, inputs, device))
        prof["records"] = prof.pop("result")
        prof["untraced_s"] = untraced_s
        log(f"traced stretch {prof['window_s']:.3f} s (the same dispatch untraced "
            f"{untraced_s:.3f} s, the window's median "
            f"{float(np.median([w['seconds'] for w in window])):.3f} s), busy "
            f"{prof['busy_s']:.4f} s, graph {prof['graph_s']:.4f} s, "
            f"{prof['n_device_events']} device events, {prof['graph_launches']} graph "
            f"launches, {prof['host_samples']} host samples, "
            f"{prof['sampled_gaps']} gaps labelled by them")

    # the program's state goes before the reference runs on the card
    cache_lib.clear()
    del dataset
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.check_window(cell, data, window, configs, seed, device)
    log(f"check {time.perf_counter() - t_check:.3f} s, numbers {numbers}")

    log(f"card: {card_limits(device)}")
    correct = check.passes(numbers, cell.limits)
    trajectories = sum(len(w["records"]) for w in window)
    ctx = Context(cell, window, window_s, prof, device)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = manifest.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"traj_rounds_per_s": ctx.traj_rounds / window_s, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    out = {
        "correct": bool(correct),
        "attempted": trajectories,
        "failed": sum(1 for w in window for r in w["records"] if r["status"] != "ok"),
        "metrics": metrics,
        "device": device_info(device, cell.chips, memory_peak, prof),
    }
    if prof is not None:
        out["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    out["checks"] = {k: {"value": numbers[k], "limit": lim} for k, lim in cell.limits.items()}
    return out


def card_limits(device) -> str:
    """The card's name and power limit as nvidia-smi reads them (the peaks
    of peaks.json hold at 700 W; a card set lower runs slower under load)."""
    import subprocess

    if not str(device).startswith("cuda"):
        return "no card"
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"power limit not read ({e})"
    return r.stdout.strip().replace("\n", "; ") or f"power limit not read ({r.stderr.strip()})"


def device_info(device, chips: int, memory_peak: int, prof) -> dict:
    import torch

    on_card = str(device).startswith("cuda")
    info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": chips,
        "memory_peak_bytes": memory_peak,
    }
    if prof is not None:
        info["busy_s"] = prof["busy_s"]
        info["window_s"] = prof["window_s"]
    return info


class Context:
    """What a per-layer metric's reader reads (metrics/<name>.py)."""

    def __init__(self, cell, window, window_s, prof, device):
        self.cell, self.window, self.window_s, self.prof = cell, window, window_s, prof
        recs = [r for w in window for r in w["records"]]
        self.trajectories = len(recs)
        self.traj_rounds = sum(r["rounds"] for r in recs)
        # a cohort member's loop seconds are the cohort's over its size, so
        # the sum counts each loop once
        self.loop_s = sum(r["loop_s"] for r in recs)
        self.config, self.traffic = cell.config, cell.traffic
        self.device_name = None
        if str(device).startswith("cuda"):
            import torch

            self.device_name = torch.cuda.get_device_name(0)

    def peaks(self) -> dict:
        return roofline.peaks(self.device_name)

    def profiled_trajectories(self) -> list:
        """(scheme, rounds, cohort size) of each trajectory the traced
        stretch ran; a sequential trajectory is a cohort of one."""
        return [(r["label"].rsplit(".", 1)[0], r["rounds"], r["cohort_size"])
                for r in self.prof["records"]]
