"""The concrete auto-knob races, each at a run's own shape on its device.

The port of erasurehead_tpu/tune/races.py. The ``block_decode`` and
``layer_coding`` candidates are two fully wired ``trainer.train`` runs
differing ONLY in the knob under test; the ``glm_fused`` candidates are the
two gradient lowerings of a dense GLM stack: B1 (``pallas``,
ops/kernels.fused_glm_grad, csrc/fused_glm_grad.cu) against the two-pass
torch gradient (``xla``, ops/kernels.reference_glm_grad). Each is timed
with the racer's warm-up + min-over-repeats discipline on seeded synthetic
data, and every thunk synchronises the card before it returns.

Fallbacks (the verdict of a tie) are the port's measured defaults, not
JAX's: ``glm_fused`` falls back to ``pallas`` (B1 took 0.086 ms against the
two-pass path's 0.163 ms at the main shape [90, 4400, 128] on an H100),
``block_decode`` to ``fused`` (step.BLOCK_DECODE_FUSED_DEFAULT);
``layer_coding`` to ``treewise``, as in JAX.

``ring_pipeline`` races the ring transport's two schedules and
``stack_mode`` the ring transport against the materialized stack, each as
two wired ``trainer.train`` runs over the run's worker mesh. In one process
the ring has one hop (a per-round local gather of the resident
partition-major stack), so ``stack_mode`` races that gather against the
materialized stack's resident redundancy, and the two ``ring_pipeline``
schedules run the same program.

``python -m erasurehead_tpu_torch.cli tune`` (:func:`main`) drives these
from flags.
"""

from __future__ import annotations

import dataclasses
import math
import numpy as np
import torch

from erasurehead_tpu_torch import tune as tune_lib
from erasurehead_tpu_torch.tune import racer as racer_lib
from erasurehead_tpu_torch.utils.device import resolve_device


def _dataset(cfg):
    from erasurehead_tpu_torch.data.synthetic import generate_gmm

    return generate_gmm(cfg.n_rows, cfg.n_cols, cfg.n_workers, seed=cfg.seed)


def _synced(fn, dev):
    """``fn`` as a race thunk: the card drained before it returns, so the
    racer's host clock brackets the device work."""

    def thunk():
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    return thunk


def _train_thunk(cfg, dataset, dev):
    from erasurehead_tpu_torch.train import trainer

    return _synced(lambda: trainer.train(cfg, dataset, device=dev), dev)


def _signature(cfg, dataset, dev) -> str:
    from erasurehead_tpu_torch.train import trainer

    model, X = trainer.resolved_stack(cfg, dataset, dev)
    return tune_lib.run_shape_signature(model, X)


def race_block_decode(
    cfg, dataset=None, *, reps: int = racer_lib.DEFAULT_REPS,
    timer=None, record: bool = True, device=None,
) -> racer_lib.RaceResult:
    """Treewise pack-then-decode vs fused per-leaf decode, blockwise coding
    forced on (the lowering pair behind step.resolve_block_decode). Both
    launch B2 once a round and give bitwise-identical trajectories: the
    race is purely about time."""
    from erasurehead_tpu_torch.parallel import step as step_lib

    dev = resolve_device(device)
    dataset = dataset if dataset is not None else _dataset(cfg)
    base = dataclasses.replace(cfg, layer_coding="on")
    fallback = "fused" if step_lib.BLOCK_DECODE_FUSED_DEFAULT else "treewise"
    return racer_lib.race(
        "block_decode", _signature(base, dataset, dev),
        {
            name: _train_thunk(dataclasses.replace(base, block_decode=name), dataset, dev)
            for name in ("treewise", "fused")
        },
        fallback=fallback, device_kind=tune_lib.default_device_kind(dev),
        reps=reps, timer=timer, record=record,
    )


def race_layer_coding(
    cfg, dataset=None, *, reps: int = racer_lib.DEFAULT_REPS,
    timer=None, record: bool = True, device=None,
) -> racer_lib.RaceResult:
    """Per-layer blockwise decode vs the monolithic per-slot default (the
    pair behind step.resolve_layer_coding's auto)."""
    from erasurehead_tpu_torch.parallel import step as step_lib

    dev = resolve_device(device)
    dataset = dataset if dataset is not None else _dataset(cfg)
    fallback = "blockwise" if step_lib.LAYER_CODING_DEFAULT else "treewise"
    return racer_lib.race(
        "layer_coding", _signature(dataclasses.replace(cfg, layer_coding="off"), dataset, dev),
        {
            "treewise": _train_thunk(dataclasses.replace(cfg, layer_coding="off"), dataset, dev),
            "blockwise": _train_thunk(dataclasses.replace(cfg, layer_coding="on"), dataset, dev),
        },
        fallback=fallback, device_kind=tune_lib.default_device_kind(dev),
        reps=reps, timer=timer, record=record,
    )


def race_glm_fused(
    cfg, dataset=None, *, reps: int = racer_lib.DEFAULT_REPS,
    timer=None, record: bool = True, device=None,
) -> racer_lib.RaceResult:
    """B1 vs the two-pass torch gradient at the run's stack shape (the pair
    behind the trainer's ``use_pallas="auto"`` gate), on JAX's seeded y,
    beta and w. On the CPU both candidates are plain torch (B1's wrapper
    takes its plain version for a CPU tensor, after its checks); the
    verdict keys under "cpu" and never resolves a card run."""
    from erasurehead_tpu_torch.ops import kernels as kernels_lib
    from erasurehead_tpu_torch.train import trainer

    dev = resolve_device(device)
    dataset = dataset if dataset is not None else _dataset(cfg)
    model, X = trainer.resolved_stack(cfg, dataset, dev)
    kind = getattr(model, "name", "logistic")
    if kind not in kernels_lib.GLM_KINDS or not isinstance(X, torch.Tensor):
        raise ValueError(
            f"glm_fused race needs a dense GLM stack; got model={kind!r}, "
            f"X={type(X).__name__} (set --model logistic/linear)"
        )
    sig = tune_lib.glm_fused_signature(X.shape, X.dtype, kind)
    M = math.prod(int(s) for s in X.shape[:-2])
    Xf = X.reshape((M,) + tuple(X.shape[-2:]))
    rng = np.random.default_rng(cfg.seed)
    y = torch.as_tensor(np.sign(rng.standard_normal(tuple(Xf.shape[:2]))),
                        dtype=torch.float32, device=dev)
    b = torch.as_tensor(rng.standard_normal(Xf.shape[-1]), dtype=torch.float32, device=dev)
    w = torch.as_tensor(rng.standard_normal(M), dtype=torch.float32, device=dev)
    if dev.type == "cuda":
        kernels_lib.load_library()  # nvcc never runs inside a timed thunk
    return racer_lib.race(
        "glm_fused", sig,
        {
            "pallas": _synced(lambda: kernels_lib.fused_glm_grad(b, Xf, y, w, kind), dev),
            "xla": _synced(lambda: kernels_lib.reference_glm_grad(b, Xf, y, w, kind), dev),
        },
        fallback="pallas", device_kind=tune_lib.default_device_kind(dev),
        reps=reps, timer=timer, record=record,
    )


def race_ring_pipeline(
    cfg, dataset=None, *, reps: int = racer_lib.DEFAULT_REPS,
    timer=None, record: bool = True, device=None,
) -> racer_lib.RaceResult:
    """Sequential vs double-buffered ring transport, ``stack_mode="ring"``
    forced (the pair behind step.resolve_ring_pipeline), keyed by the
    partition-major stack the resolver consults. Both move the same blocks
    in the same order: the trajectories are bitwise equal and the race is
    about time (a tie in one process, where there is one hop)."""
    dev = resolve_device(device)
    dataset = dataset if dataset is not None else _dataset(cfg)
    base = dataclasses.replace(cfg, stack_mode="ring")
    return racer_lib.race(
        "ring_pipeline", _signature(base, dataset, dev),
        {
            "sequential": _train_thunk(dataclasses.replace(base, ring_pipeline="off"), dataset, dev),
            "pipelined": _train_thunk(dataclasses.replace(base, ring_pipeline="on"), dataset, dev),
        },
        fallback="sequential", device_kind=tune_lib.default_device_kind(dev),
        reps=reps, timer=timer, record=record,
    )


def race_stack_mode(
    cfg, dataset=None, *, reps: int = racer_lib.DEFAULT_REPS,
    timer=None, record: bool = True, device=None,
) -> racer_lib.RaceResult:
    """Materialized faithful stack vs the ring transport (the pair behind
    sharding.resolve_ring_stack's auto threshold), keyed by the PRE-stack
    signature (tune.stack_mode_signature): the resolver runs before any
    stack exists. Bitwise-equal trajectories; the ring holds 1/(s+1) of the
    stack and gathers the redundant slots every round."""
    from erasurehead_tpu_torch.train import trainer

    dev = resolve_device(device)
    dataset = dataset if dataset is not None else _dataset(cfg)
    layout = trainer.build_layout(cfg)
    sig = tune_lib.stack_mode_signature(
        layout, dataset.n_samples // layout.n_partitions, dataset.X_train.shape[1],
        cfg.resolve_stack_dtype(),
    )
    return racer_lib.race(
        "stack_mode", sig,
        {
            name: _train_thunk(dataclasses.replace(cfg, stack_mode=name), dataset, dev)
            for name in ("materialized", "ring")
        },
        fallback="materialized", device_kind=tune_lib.default_device_kind(dev),
        reps=reps, timer=timer, record=record,
    )


RACE_FNS = {
    "block_decode": race_block_decode,
    "layer_coding": race_layer_coding,
    "glm_fused": race_glm_fused,
    "ring_pipeline": race_ring_pipeline,
    "stack_mode": race_stack_mode,
}


def main(argv=None) -> int:
    """``cli tune``: race auto knobs at a given shape and persist the
    verdicts to the decision cache.

    The races run HERE, once, explicitly, never inside training steps.
    Warm runs then resolve from the cache file this writes (override the
    location with ERASUREHEAD_TUNE_CACHE)."""
    import argparse
    import json

    from erasurehead_tpu_torch.utils.config import RunConfig

    p = argparse.ArgumentParser(
        prog="python -m erasurehead_tpu_torch.cli tune",
        description=(
            "race auto-gated lowerings at a run shape; verdicts persist "
            "to the tune decision cache"
        ),
    )
    p.add_argument(
        "--race", action="append", choices=sorted(RACE_FNS) + ["all"],
        default=None,
        help="race(s) to run (repeatable; default: block_decode)",
    )
    p.add_argument("--scheme", default="approx")
    p.add_argument("--model", default="deepmlp")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--stragglers", type=int, default=1)
    p.add_argument("--num-collect", type=int, default=6)
    p.add_argument("--rounds", type=int, default=8)
    p.add_argument("--rows", type=int, default=256)
    p.add_argument("--cols", type=int, default=32)
    p.add_argument("--deep-layers", type=int, default=0)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=racer_lib.DEFAULT_REPS)
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="where the races run and what their verdicts key "
                        "under (default cuda; raises without a card)")
    p.add_argument(
        "--json", action="store_true",
        help="print ONE JSON result line (with 'platform' and "
             "'device_kind') instead of the human verdict lines",
    )
    ns = p.parse_args(argv)

    names = ns.race or ["block_decode"]
    if "all" in names:
        names = sorted(RACE_FNS)
    dev = resolve_device(ns.device)
    cfg = RunConfig(
        scheme=ns.scheme, model=ns.model, n_workers=ns.workers,
        n_stragglers=ns.stragglers, num_collect=ns.num_collect,
        rounds=ns.rounds, n_rows=ns.rows, n_cols=ns.cols,
        lr_schedule=0.5, update_rule="AGD", add_delay=True,
        seed=ns.seed, deep_layers=ns.deep_layers, dtype=ns.dtype,
    )
    dataset = _dataset(cfg)
    if not ns.json:
        print(f"tune cache: {tune_lib.default_path()}")
    results = {}
    for name in names:
        res = RACE_FNS[name](cfg, dataset, reps=ns.reps, device=dev)
        results[name] = res
        if ns.json:
            continue
        timings = "  ".join(
            f"{k}={v * 1e3:.2f}ms" for k, v in sorted(res.timings.items())
        )
        verdict = "decisive" if res.decisive else "tie -> fallback"
        print(
            f"{name}: choice={res.choice} ({verdict})  [{timings}]  "
            f"shape={res.shape}"
        )
    if ns.json:
        print(json.dumps({
            "metric": "tune_races",
            "platform": dev.type,
            "device_kind": tune_lib.default_device_kind(dev),
            "cache": tune_lib.default_path(),
            "races": {
                name: {
                    "choice": res.choice,
                    "fallback": res.fallback,
                    "decisive": res.decisive,
                    "shape": res.shape,
                    "timings_ms": {
                        k: round(v * 1e3, 3)
                        for k, v in sorted(res.timings.items())
                    },
                }
                for name, res in results.items()
            },
        }))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
