"""The what-if engine: grid spec -> cohort dispatches -> surface.

The port of erasurehead_tpu/whatif/engine.py. One :func:`run_whatif` call
turns a :class:`~erasurehead_tpu_torch.whatif.spec.GridSpec` into a
:class:`~erasurehead_tpu_torch.whatif.surface.Surface`, on the card unless
the caller asks for the CPU (``device=``):

  1. **Enumerate + filter** — spec.enumerate_points builds each grid
     coordinate's RunConfig through the registry's own validation;
     infeasible points (FRC divisibility, missing num_collect/deadline,
     partial partition counts) become surface rows with the validator's
     reason and are NEVER dispatched.
  2. **Sample** — sampler.sample_arrivals draws every point's Monte-Carlo
     arrival block on the device (one batched threefry pass per
     (regime, W)); all
     policies at the same (W, regime, seed) coordinate share the same
     stream, the paired-comparison contract compare() uses.
  3. **Dispatch** — (point, seed) trajectories group by cohort signature
     (experiments.plan_cohorts keys on the layout-stack signature) and
     run through the existing guarded cohort engine
     (experiments._run_configs -> _dispatch_cohort), inheriting its
     degradation ladder: OOM bisection, sequential fallback. Hundreds of
     simulated runs ride a handful of cohort round loops (a dense GLM
     cohort takes the cohort matmul, no B1 launch); with batching off every
     trajectory is a sequential train(), B1 once a round.
  4. **Reduce** — per-trajectory loss curves (evaluate.replay_batch) reduce
     over the seed axis into expected-time-to-target / reach-fraction /
     decode-error rows; the surface saves as deterministic
     ``surface_rows.jsonl`` + ``surface.npz``.

Every phase emits a typed ``whatif`` event (obs/events.py), and an
out_dir whose saved artifact already matches the spec hash REHYDRATES
instead of re-simulating — rerunning an identical spec is bitwise
idempotent.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

import torch

from erasurehead_tpu_torch.obs import events as obs_events
from erasurehead_tpu_torch.ops import blocks
from erasurehead_tpu_torch.whatif import sampler as sampler_lib
from erasurehead_tpu_torch.whatif import spec as spec_lib
from erasurehead_tpu_torch.whatif import surface as surface_lib


def _emit(kind: str, spec_hash: str, **fields) -> None:
    obs_events.emit("whatif", spec_hash=spec_hash, kind=kind, **fields)


def _dataset_for(spec, n_workers: int):
    """The W-column's dataset: partitions must match the worker count, so
    each W gets its own generation at the spec's shape (rows are padded
    up to the nearest multiple of W — the same rule the suite uses)."""
    from erasurehead_tpu_torch.data.synthetic import generate_gmm, generate_linear

    rows = max(n_workers, spec.n_rows)
    rows = n_workers * max(1, -(-rows // n_workers))  # ceil to multiple
    maker = generate_linear if spec.model == "linear" else generate_gmm
    return maker(rows, spec.n_cols, n_workers, seed=spec.data_seed)


def _trajectory_label(point_label: str, seed: int) -> str:
    return f"{point_label}#{seed}"


def run_whatif(
    spec: "spec_lib.GridSpec",
    out_dir: Optional[str] = None,
    rehydrate: bool = True,
    batch: Optional[str] = None,
    device=None,
    init_params=None,
) -> "surface_lib.Surface":
    """Run (or rehydrate) one what-if grid; returns its Surface.

    ``out_dir``: save the surface artifact there (and rehydrate from it
    when its saved spec hash matches — pass ``rehydrate=False`` to force
    re-simulation). ``batch`` is the cohort dispatch mode threaded into
    the sweep engine ('on'/'off'/'auto'; None = the ambient default).
    ``device``: where the draws, the runs and the replays go (``cuda``
    unless ``"cpu"`` is asked for). ``init_params``: the model init every
    trajectory starts from (the grid's model seed is fixed across points
    and seeds); None = the port's own seeded draw at ``spec.model_seed``.
    JAX's engine has no such argument: the port's tests pass JAX's draw.

    Across processes every rank runs every grid point with the same cohort
    dispatch (the plan reads the configs only), each run over train()'s own
    worker mesh, as JAX's engine spreads its runs over every device; rank 0
    alone writes the surface.
    """
    from erasurehead_tpu_torch.parallel import backend
    from erasurehead_tpu_torch.train import evaluate, experiments, trainer
    from erasurehead_tpu_torch.utils.config import resolve_batch_trajectories
    from erasurehead_tpu_torch.utils.device import resolve_device

    spec_hash = spec.spec_hash()
    if out_dir is not None and rehydrate:
        # rank 0's read decides for every rank: all rehydrate or all run
        saved = backend.agree(surface_lib.Surface.saved_hash(out_dir))
        if saved == spec_hash:
            surf = surface_lib.Surface.load(out_dir)
            _emit("rehydrate", spec_hash, n_rows=len(surf.rows))
            return surf

    dev = resolve_device(device)
    t0 = time.perf_counter()
    points = spec_lib.enumerate_points(spec)
    feasible = [p for p in points if p.feasible]
    _emit(
        "grid",
        spec_hash,
        n_points=len(points),
        n_feasible=len(feasible),
        n_infeasible=len(points) - len(feasible),
        n_seeds=spec.n_seeds,
    )

    seeds = list(range(spec.n_seeds))
    datasets = {W: _dataset_for(spec, W) for W in spec.n_workers}

    # per-trajectory config + arrival maps, grouped per W (a cohort never
    # spans worker counts: the data stack is per-W). The arrival block for
    # one (regime, W) is drawn ONCE and shared by every policy at that
    # coordinate — the paired-comparison contract.
    curves: dict = {}
    timesets: dict = {}
    decode_means: dict = {}
    n_trajectories = 0
    for W in spec.n_workers:
        w_points = [p for p in feasible if p.n_workers == W]
        if not w_points:
            continue
        dataset = datasets[W]
        arrival_blocks: dict = {}
        configs: dict = {}
        arrivals: dict = {}
        point_of: dict = {}
        for p in w_points:
            key = (p.regime, W)
            block = arrival_blocks.get(key)
            if block is None:
                layout = trainer.build_layout(p.config)
                block = sampler_lib.sample_arrivals(
                    p.regime, spec.rounds, W, seeds, layout=layout, device=dev
                )
                # layout-DEPENDENT regimes (targeted replica groups,
                # slot-scaled compute) draw per point, not per regime
                if p.regime.kind == "targeted" or p.regime.compute_slots:
                    key = (p.regime, W, p.label)
                arrival_blocks[key] = block
            for i, seed in enumerate(seeds):
                label = _trajectory_label(p.label, seed)
                configs[label] = p.config
                arrivals[label] = block[i]
                point_of[label] = p
        n_trajectories += len(configs)

        raw: dict = {}

        def _finish(label, res):
            raw[label] = res
            timesets[label] = np.asarray(res.timeset, dtype=np.float64)
            decode_means[label] = (
                float(np.mean(res.decode_error))
                if res.decode_error is not None and len(res.decode_error)
                else None
            )

        experiments._run_configs(
            configs,
            dataset,
            arrivals,
            resolve_batch_trajectories(batch),
            device=dev,
            init_params=(
                None if init_params is None
                else {label: init_params for label in configs}
            ),
            on_result=_finish,
        )

        # reduction replay, per point: the seed axis stacked into one
        # [B, R, ...] history (evaluate.replay_batch)
        for p in w_points:
            labels = [_trajectory_label(p.label, s) for s in seeds]
            model = trainer.build_model(p.config)
            n = raw[labels[0]].n_train
            histories = blocks.tree_map(
                lambda *xs: torch.stack(xs),
                *[raw[l].params_history for l in labels],
            )
            ev = evaluate.replay_batch(
                model,
                p.config.model,
                histories,
                dataset.X_train[:n],
                dataset.y_train[:n],
                dataset.X_test,
                dataset.y_test,
            )
            for i, label in enumerate(labels):
                curves[label] = np.asarray(
                    ev.training_loss[i], dtype=np.float64
                )
        raw.clear()

    # one shared loss target across the whole grid (compare()'s rule when
    # the spec does not pin one): 1.05x the worst converged final loss, so
    # every non-diverged point can reach it and times stay comparable
    target = spec.target_loss
    if target is None:
        finals = [
            float(c[-1])
            for c in curves.values()
            if np.isfinite(c[-1])
        ]
        target = 1.05 * max(finals) if finals else None

    rows = []
    for p in points:
        row = {
            "label": p.label,
            "scheme": p.policy.scheme,
            "n_workers": p.n_workers,
            "n_stragglers": p.n_stragglers,
            "num_collect": (
                p.config.num_collect if p.config is not None else None
            ),
            "deadline": p.policy.deadline,
            "decode": spec.decode,
            "regime": p.regime.tag,
            "pipeline_depth": p.pipeline_depth,
            "feasible": p.feasible,
            "reason": p.reason,
            "n_seeds": spec.n_seeds if p.feasible else 0,
        }
        if p.feasible:
            labels = [_trajectory_label(p.label, s) for s in seeds]
            ok = [
                l for l in labels if np.isfinite(curves[l][-1])
            ]
            ttts = [
                experiments.time_to_target_loss(
                    curves[l], timesets[l], target
                )
                for l in ok
            ] if target is not None else []
            reached = [t for t in ttts if t is not None]
            derrs = [
                decode_means[l] for l in ok if decode_means[l] is not None
            ]
            row.update(
                n_diverged=len(labels) - len(ok),
                reach_fraction=(
                    round(len(reached) / len(labels), 6) if labels else 0.0
                ),
                expected_time_to_target=(
                    round(float(np.mean(reached)), 6) if reached else None
                ),
                time_to_target_std=(
                    round(float(np.std(reached)), 6) if reached else None
                ),
                sim_time_per_round=(
                    round(
                        float(
                            np.mean(
                                [timesets[l].sum() for l in ok]
                            )
                        )
                        / spec.rounds,
                        6,
                    )
                    if ok
                    else None
                ),
                decode_error_mean=(
                    round(float(np.mean(derrs)), 8) if derrs else None
                ),
                final_loss_mean=(
                    round(
                        float(np.mean([curves[l][-1] for l in ok])), 6
                    )
                    if ok
                    else None
                ),
            )
        else:
            row.update(
                n_diverged=0,
                reach_fraction=0.0,
                expected_time_to_target=None,
                time_to_target_std=None,
                sim_time_per_round=None,
                decode_error_mean=None,
                final_loss_mean=None,
            )
        _emit(
            "point",
            spec_hash,
            label=p.label,
            feasible=p.feasible,
            reason=p.reason,
            expected_time_to_target=row["expected_time_to_target"],
            reach_fraction=row["reach_fraction"],
        )
        rows.append(row)

    wall = time.perf_counter() - t0
    surf = surface_lib.Surface(
        spec_payload=spec.payload(),
        spec_hash=spec_hash,
        target_loss=target,
        rows=rows,
        stats={
            "n_trajectories": n_trajectories,
            "wall_s": round(wall, 4),
            "runs_per_sec": (
                round(n_trajectories / wall, 3) if wall > 0 else None
            ),
        },
    )
    if out_dir is not None and backend.is_writer():
        paths = surf.save(out_dir)
        _emit(
            "surface",
            spec_hash,
            n_rows=len(rows),
            path=paths["rows"],
        )
    return surf


# ---------------------------------------------------------------------------
# CLI: `python -m erasurehead_tpu_torch.cli whatif`

def main(argv=None) -> int:
    """Grid spec flags -> surface artifact -> rendered crossover table.

    Calls ``parallel.backend.initialize_distributed`` first, as JAX's entry
    does (a no-op in one process); under ``torchrun`` every rank runs the
    grid and rank 0 alone writes the surface, its event log and the
    table."""
    import argparse
    import contextlib
    import os

    p = argparse.ArgumentParser(
        prog="python -m erasurehead_tpu_torch.cli whatif",
        description=(
            "Monte-Carlo policy search over the scheme x regime grid: "
            "simulate every feasible (policy, W, s, regime) point over "
            "n seeds as batched cohort dispatches and reduce to an "
            "expected-time-to-target surface"
        ),
    )
    p.add_argument("--policies", default="naive,cyccoded,approx",
                   help="comma-separated policy specs "
                        "'scheme[:cN][:fFRAC][:dSECS][:pN]' (cN = "
                        "num_collect, fFRAC = collect fraction of W, "
                        "dSECS = deadline, pN = partitions_per_worker)")
    p.add_argument("--workers", default="8",
                   help="comma-separated worker counts (grid axis)")
    p.add_argument("--stragglers", default="1",
                   help="comma-separated straggler counts (grid axis)")
    p.add_argument("--regimes", default="exp:0.5",
                   help="comma-separated regime specs: exp[:MEAN], "
                        "heavytail[:ALPHA[:MEAN]], "
                        "adversary[:SLOWDOWN[:WORKER]], "
                        "targeted[:SLOWDOWN[:GROUP]], trace:PATH; a "
                        "'+cSECS[xslots]' suffix adds per-round compute "
                        "time (xslots scales it by each worker's slot "
                        "count — the faithful redundant-compute price)")
    p.add_argument("--seeds", type=int, default=8,
                   help="Monte-Carlo seeds per grid point")
    p.add_argument("--rounds", type=int, default=30)
    p.add_argument("--rows", type=int, default=256)
    p.add_argument("--cols", type=int, default=16)
    p.add_argument("--model", default="logistic",
                   choices=["logistic", "linear"])
    p.add_argument("--update-rule", default="GD",
                   choices=["GD", "AGD", "ADAM"])
    p.add_argument("--lr", type=float, default=1.0)
    p.add_argument("--decode", default="fixed",
                   choices=["fixed", "optimal"])
    p.add_argument("--target-loss", type=float, default=None,
                   help="time-to-target anchor; default 1.05x the worst "
                        "converged final loss across the grid")
    p.add_argument("--pipeline-depths", default="0",
                   help="comma-separated staleness axis (subset of 0,1): "
                        "1 adds bounded-staleness pipelined points "
                        "(tau=1, --pipeline-depth) per coordinate; "
                        "pipelining-refused combinations surface as "
                        "infeasible rows with the typed reason")
    p.add_argument("--out", default=None, metavar="DIR",
                   help="save surface_rows.jsonl + surface.npz (and the "
                        "events.jsonl run log) here; reruns of an "
                        "identical spec rehydrate from it bitwise")
    p.add_argument("--no-rehydrate", action="store_true",
                   help="re-simulate even when --out already holds this "
                        "spec's surface")
    p.add_argument("--crossover", default=None, metavar="A,B[,AXIS]",
                   help="render the A-vs-B crossover table along AXIS "
                        "(regime | n_stragglers | n_workers; default "
                        "regime), e.g. 'approx,cyccoded,n_stragglers'")
    p.add_argument("--batch-trajectories", default=None,
                   choices=["on", "off", "auto"])
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="where the grid runs (default cuda; raises without "
                        "a card)")
    p.add_argument("--quiet", action="store_true")
    ns = p.parse_args(argv)

    try:
        grid = spec_lib.GridSpec(
            policies=spec_lib.parse_policies(ns.policies),
            n_workers=spec_lib.parse_ints(ns.workers),
            n_stragglers=spec_lib.parse_ints(ns.stragglers),
            regimes=spec_lib.parse_regimes(ns.regimes),
            n_seeds=ns.seeds,
            rounds=ns.rounds,
            n_rows=ns.rows,
            n_cols=ns.cols,
            model=ns.model,
            update_rule=ns.update_rule,
            lr=ns.lr,
            decode=ns.decode,
            target_loss=ns.target_loss,
            pipeline_depths=spec_lib.parse_ints(ns.pipeline_depths),
        )
    except ValueError as e:
        p.error(str(e))

    from erasurehead_tpu_torch.parallel.backend import initialize_distributed, is_writer

    initialize_distributed(device=ns.device)
    writer = is_writer()
    capture = (
        obs_events.capture(os.path.join(ns.out, "events.jsonl"))
        if ns.out and writer
        else contextlib.nullcontext()
    )
    with capture:
        surf = run_whatif(
            grid,
            out_dir=ns.out,
            rehydrate=not ns.no_rehydrate,
            batch=ns.batch_trajectories,
            device=ns.device,
        )
    if not ns.quiet and writer:
        print(f"spec {surf.spec_hash}: {len(surf.rows)} grid points", end="")
        if surf.stats:
            print(
                f", {surf.stats['n_trajectories']} simulated runs in "
                f"{surf.stats['wall_s']}s "
                f"({surf.stats['runs_per_sec']} runs/s)"
            )
        else:
            print(" (rehydrated)")
        print(surf.format_table())
        if ns.crossover:
            fields = [f.strip() for f in ns.crossover.split(",")]
            if len(fields) not in (2, 3):
                p.error("--crossover wants 'schemeA,schemeB[,axis]'")
            axis = fields[2] if len(fields) == 3 else "regime"
            print()
            print(
                surf.format_crossover_table(fields[0], fields[1], axis)
            )
        if ns.out:
            print(f"\nsurface -> {ns.out}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
