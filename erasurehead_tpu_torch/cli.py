"""Command-line entry point of the PyTorch/CUDA port.

Named flags, as the JAX package's CLI takes them::

    python -m erasurehead_tpu_torch.cli --scheme approx --workers 30 \\
        --stragglers 2 --num-collect 15 --rounds 100 --rows 132000 \\
        --cols 128 --add-delay --output-dir results/

The deep families train layer-coded, each round's decode going through the
decode kernel (GD: the reference's AGD starts a tanh network at its all-zero
saddle, where the loss stays at log 2)::

    python -m erasurehead_tpu_torch.cli --scheme approx --workers 30 \\
        --stragglers 2 --num-collect 15 --rows 132000 --cols 128 \\
        --rounds 100 --update-rule GD --lr 0.5 --add-delay \\
        --model deepmlp --layer-coding on --block-decode fused

Run flow: generate the synthetic dataset, train on the device (``cuda``
unless ``--device cpu``), replay the eval, write the five artifacts and the
manifest into ``--output-dir`` (default ``<input_dir>/.../results/``, the
reference's layout).

Not ported yet: the reference's 13-positional-argument form and the on-disk
reference-layout loader; a run whose ``--input-dir`` holds such a layout
raises instead of training on synthetic data.
"""

from __future__ import annotations

import argparse
import os
import sys

from erasurehead_tpu_torch.data.synthetic import Dataset, generate_gmm, generate_linear
from erasurehead_tpu_torch.train import artifacts, evaluate, trainer
from erasurehead_tpu_torch.utils.config import ModelKind, RunConfig, Scheme


def _flags_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="erasurehead_tpu_torch",
        description="Straggler-tolerant coded gradient descent on an NVIDIA GPU",
    )
    p.add_argument("--scheme", default="naive", choices=[s.value for s in Scheme])
    p.add_argument("--model", default=None, choices=[m.value for m in ModelKind])
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--stragglers", type=int, default=1)
    p.add_argument("--num-collect", type=int, default=None)
    p.add_argument("--rounds", type=int, default=100)
    p.add_argument("--dataset", default="artificial")
    p.add_argument("--rows", type=int, default=4096)
    p.add_argument("--cols", type=int, default=100)
    p.add_argument("--input-dir", default=None, help="reference-layout data dir")
    p.add_argument("--output-dir", default=None, help="artifact dir (default <input>/results)")
    p.add_argument("--update-rule", default="AGD", choices=["GD", "AGD", "ADAM"])
    p.add_argument("--lr", type=float, default=None, help="constant lr override")
    p.add_argument("--alpha", type=float, default=None, help="l2 coefficient")
    p.add_argument("--add-delay", action="store_true")
    p.add_argument("--delay-mean", type=float, default=0.5)
    p.add_argument("--compute-mode", default="faithful", choices=["faithful", "deduped"])
    p.add_argument("--use-pallas", default="auto", choices=["auto", "on", "off"],
                   help="fused one-pass GLM gradient kernel "
                        "(ops/kernels.fused_glm_grad): auto/on route dense "
                        "GLM stacks through it (unless --layer-coding on), "
                        "off takes the two-pass PyTorch gradient; on needs "
                        "a GLM")
    p.add_argument("--layer-coding", default="auto", choices=["auto", "on", "off"],
                   help="per-layer (blockwise) gradient coding "
                        "(parallel/step.make_layer_block_grad_fn): per-slot "
                        "gradient trees decode per leaf (DeepMLP layers "
                        "and MoE expert shards are individual coded blocks); "
                        "auto is off")
    p.add_argument("--block-decode", default="auto",
                   choices=["auto", "fused", "treewise"],
                   help="blockwise-decode lowering under --layer-coding: "
                        "'fused' decodes every gradient leaf in place, "
                        "'treewise' the packed per-layer block table, each "
                        "in one launch a round of the decode kernel "
                        "(ops/kernels.fused_block_decode_leaves) and "
                        "bitwise equal; auto is fused")
    p.add_argument("--deep-layers", type=int, default=0,
                   help="hidden-layer count for --model deepmlp (0 = the "
                        "model default)")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="DATA dtype (params/updates stay float32)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the run computes; cuda raises when there is no card")
    p.add_argument("--quiet", action="store_true")
    return p


def _flags_to_config(ns: argparse.Namespace) -> RunConfig:
    model = ns.model
    if model is None:
        model = (
            ModelKind.LINEAR if ns.dataset == "kc_house_data" else ModelKind.LOGISTIC
        )
    return RunConfig(
        scheme=ns.scheme,
        model=model,
        n_workers=ns.workers,
        n_stragglers=ns.stragglers,
        num_collect=ns.num_collect,
        rounds=ns.rounds,
        add_delay=ns.add_delay,
        delay_mean=ns.delay_mean,
        update_rule=ns.update_rule,
        alpha=ns.alpha,
        lr_schedule=ns.lr,
        dataset=ns.dataset,
        n_rows=ns.rows,
        n_cols=ns.cols,
        input_dir=ns.input_dir,
        compute_mode=ns.compute_mode,
        use_pallas=ns.use_pallas,
        layer_coding=ns.layer_coding,
        block_decode=ns.block_decode,
        deep_layers=ns.deep_layers,
        dtype=ns.dtype,
        seed=ns.seed,
    )


def dataset_dir(cfg: RunConfig) -> str | None:
    """The reference's on-disk dataset directory for this config
    (path synthesis: main.py:59-60, generate_data.py:59-62)."""
    if not cfg.input_dir:
        return None
    sub = (
        f"artificial-data/{cfg.n_rows}x{cfg.n_cols}"
        if cfg.dataset == "artificial"
        else cfg.dataset
    )
    return os.path.join(cfg.input_dir, sub, str(cfg.n_workers))


def _has_reference_layout(path: str | None) -> bool:
    """True iff ``path`` holds partition 1 of a reference layout."""
    return path is not None and (
        os.path.exists(os.path.join(path, "1.dat"))
        or os.path.exists(os.path.join(path, "1.npz"))
    )


def load_dataset(cfg: RunConfig) -> Dataset:
    """The in-memory synthetic dataset for this config.

    Raises where the config names on-disk data: the reference-layout loader
    is not ported yet, and training on synthetic data under a real dataset's
    name would be worse than failing."""
    path = dataset_dir(cfg)
    if _has_reference_layout(path):
        raise NotImplementedError(
            f"{path!r} holds a reference-layout dataset, but the on-disk "
            "loader (erasurehead_tpu/data/io.py) is not ported yet; run "
            "without --input-dir to train on generated data"
        )
    if cfg.dataset != "artificial":
        raise NotImplementedError(
            f"dataset {cfg.dataset!r} is real data, which needs the on-disk "
            "loader (not ported yet); only 'artificial' is generated"
        )
    if cfg.model == ModelKind.LINEAR:
        return generate_linear(cfg.n_rows, cfg.n_cols, cfg.n_workers, cfg.seed)
    return generate_gmm(cfg.n_rows, cfg.n_cols, cfg.n_workers, cfg.seed)


def run(cfg: RunConfig, output_dir: str | None = None, quiet: bool = False,
        device=None):
    """Train, replay the eval and write the artifacts. Returns
    (TrainResult, EvalResult, artifact paths)."""
    if output_dir is None:
        output_dir = os.path.join(dataset_dir(cfg) or ".", "results")
    dataset = load_dataset(cfg)
    result = trainer.train(cfg, dataset, device=device)
    n = result.n_train
    ev = evaluate.replay(
        trainer.build_model(cfg),
        cfg.model,
        result.params_history,
        dataset.X_train[:n],
        dataset.y_train[:n],
        dataset.X_test,
        dataset.y_test,
    )
    paths = artifacts.write_run_artifacts(result, ev, output_dir)
    if not quiet:
        artifacts.print_iteration_table(result, ev)
        print(f"artifacts -> {output_dir}")
    return result, ev, paths


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ns = _flags_parser().parse_args(argv)
    run(
        _flags_to_config(ns),
        output_dir=ns.output_dir,
        quiet=ns.quiet,
        device=ns.device,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
