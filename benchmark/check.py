"""How ``correct`` is decided: the window's own trajectories against the
plain reference (reference/).

A sample drawn from the seed, one trajectory of each label of the traffic
from a dispatch of the window, is worked out again from the inputs the
benchmark handed to the program (the dataset, the arrival matrix, the
initial params) and from the configuration alone: the layout, the
collection and decode weights and the simulated clock (reference/
schemes.py), then the decoded gradient, AGD and the loss and AUC replay
(reference/<model>.py) in float64. Four numbers are compared, each the
worst over the sample:

  clock_gap   largest |program - reference| simulated seconds of a round
  loss_gap    largest relative gap of a round's replayed train loss
  test_gap    relative gap of the last iterate's test loss
  auc_gap     absolute gap of the last iterate's test AUC

A cell compares the numbers its limits/<cell>.json gives a limit, each
set from readings of the program and of a control (calibrate.py); one that
is not finite fails.
"""

from __future__ import annotations

import math

import numpy as np

import manifest

NUMBERS = ("clock_gap", "loss_gap", "test_gap", "auc_gap")


def reference_data(config: dict, data: dict, precision: str, device):
    """(train, y, part, test, y_test) for reference/<model>.py."""
    import torch

    ref = manifest.plugin("reference", config["reference"])
    n = int(config["data"]["n_rows"])
    rows = n // int(config["n_workers"])
    part = torch.arange(n, device=device) // rows
    if "X_train" in data:
        train = ref.Dense(data["X_train"].to(device), precision)
        test = ref.Dense(data["X_test"].to(device), precision)
    else:
        F = int(data["n_cols"])
        train = ref.Onehot(data["idx_train"].to(device), F, precision)
        test = ref.Onehot(data["idx_test"].to(device), F, precision)
    return ref, train, data["y_train"].to(device), part, test, data["y_test"].to(device)


def reference_trajectory(config: dict, cfg, arrivals, beta0, prepared) -> dict:
    """The plain reference's trajectory of one port RunConfig ``cfg``."""
    sch = manifest.plugin("reference", "schemes")
    ref, train, y, part, test, y_test = prepared
    W = int(config["n_workers"])
    lay = sch.layout(cfg.scheme.value, W, int(config["n_stragglers"]), int(cfg.seed))
    weights, clock = sch.schedule(
        cfg.scheme.value, np.asarray(arrivals, np.float64), lay,
        n_stragglers=int(config["n_stragglers"]), num_collect=cfg.num_collect,
        deadline=cfg.deadline)
    pw = sch.partition_weights(lay, weights, W)
    R = int(config["rounds"])
    lr = np.full(R, float(config["lr"]))
    alpha = 1.0 / int(config["data"]["n_rows"])
    out = ref.trajectory(train, y, part, test, y_test, pw, lr, alpha, beta0)
    out["clock"] = clock
    return out


def gaps(prog: dict, ref: dict) -> dict:
    lr = ref["train_loss"]
    return {
        "clock_gap": float(np.max(np.abs(prog["timeset"] - ref["clock"]))),
        "loss_gap": float(np.max(np.abs(prog["train_loss"] - lr) / np.abs(lr))),
        "test_gap": abs(prog["test_loss"] - ref["test_loss"]) / abs(ref["test_loss"]),
        "auc_gap": abs(prog["auc"] - ref["auc"]),
    }


def worst(all_gaps: list) -> dict:
    out = {}
    for k in NUMBERS:
        vals = [g[k] for g in all_gaps]
        out[k] = math.nan if any(not math.isfinite(v) for v in vals) else max(vals)
    return out


def sample(window: list, labels: list, seed: int) -> list:
    """(dispatch index, label) pairs: one dispatch of the window a label,
    drawn from the seed."""
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 0xC4EC])
    return [(int(rng.integers(len(window))), label) for label in labels]


def check_window(cell, data: dict, window: list, configs: dict, seed: int, device) -> dict:
    prepared = reference_data(cell.config, data, "float64", device)
    found = []
    for k, label in sample(window, list(configs), seed):
        w = window[k]
        prog = next(r for r in w["records"] if r["label"] == label)
        ref = reference_trajectory(cell.config, configs[label], w["inputs"]["arrivals"],
                                   w["inputs"]["init"][label], prepared)
        found.append(gaps(prog, ref))
    return worst(found)


def passes(numbers: dict, limits: dict) -> bool:
    return all(math.isfinite(numbers[k]) and numbers[k] <= lim for k, lim in limits.items())


def readings(cell, seed: int, device, *, program: bool = True, control: bool = False) -> dict:
    """One seed's readings at the cell's full size (calibrate.py): the
    program's worst gaps over the trajectories of one compare() of the
    traffic, and the control's (the reference in the configuration's
    ``control`` precision, in the program's place) over the same inputs.
    The inputs are a run's first dispatch's (harness.prepare)."""
    import torch

    import harness

    from erasurehead_tpu_torch.train import cache as cache_lib
    from erasurehead_tpu_torch.train import experiments

    config, traffic = cell.config, cell.traffic
    prep = harness.prepare(cell, seed, device)
    data, configs = prep["data"], prep["configs"]
    inputs = harness.draw_dispatch(prep["stream"], config, traffic, device)
    records = {}
    if program:
        dataset = prep["generator"].to_host(data)
        records = {r["label"]: r for r in
                   harness.dispatch(experiments, configs, dataset, traffic, inputs, device)}
        cache_lib.clear()
        del dataset
        if str(device).startswith("cuda"):
            torch.cuda.empty_cache()
    prepared = reference_data(config, data, "float64", device)
    low = reference_data(config, data, config["control"], device) if control else None
    found: dict = {"program": [], "control": []}
    for label, cfg in configs.items():
        args = (inputs["arrivals"], inputs["init"][label])
        ref = reference_trajectory(config, cfg, *args, prepared)
        if program:
            found["program"].append(gaps(records[label], ref))
        if control:
            ctl = reference_trajectory(config, cfg, *args, low)
            ctl["timeset"] = ctl.pop("clock")
            found["control"].append(gaps(ctl, ref))
    return {kind: worst(v) for kind, v in found.items() if v}
