"""Command-line entry point of the PyTorch/CUDA port.

Two invocation forms, as the JAX package's CLI takes them, and six
subcommands: ``python -m erasurehead_tpu_torch.cli sweep [--rounds N]
[--sweep-journal DIR [--resume-sweep]] [--out rows.json] [--events PATH]
[--device cpu]`` runs the BASELINE.json comparison suite
(train/experiments.main); ``... cli report EVENTS.jsonl [...]
[--validate]`` renders event logs into the run summary table
(obs/report.main) and ``... cli top EVENTS.jsonl|http://host:port
[--follow]`` draws the live telemetry frame (obs/exporter.top_main), both
reading files only;
``... cli tune --race NAME [shape flags] [--json] [--device cpu]`` races an
auto knob at a run shape into the tune decision cache
(``ERASUREHEAD_TUNE_CACHE``; tune/races.main); ``... cli whatif --policies
... --regimes ... [--out DIR] [--device cpu]`` simulates a policy grid into
an expected-time-to-target surface (whatif/engine.main); ``... cli serve
[--socket PATH] [--http HOST:PORT] [--journal-dir DIR] [--cache-dir DIR]
[--device cpu] ...`` runs the multi-tenant serve daemon until SIGINT
(serve/server.main): clients submit over the unix socket
(serve/client.ServeClient) or HTTP (HttpServeClient), and ``--cache-dir``
names the directory the CUDA kernel library is built into and loaded from.

1. **Named flags**::

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

   ``--scheme`` takes every name of the scheme registry
   (erasurehead_tpu_torch/schemes/): naive, cyccoded, repcoded, approx,
   avoidstragg, randreg, sparsegraph, expander, deadline (with
   ``--deadline``), partialcyccoded and partialrepcoded (with
   ``--partitions-per-worker``), and any registered extension.
   ``--decode optimal`` refits each round's decode weights by least squares
   to the actual arrival set. ``--model attention`` trains the attention
   family (16 tokens of 8 features a row at the flagship's 128 columns),
   layer-coded with ``--layer-coding on``.

   Arrival models: ``--compute-time`` and ``--worker-speed-spread`` (a
   heterogeneous cluster), ``--arrival-trace PATH`` (replay a recorded
   trace; ``ERASUREHEAD_ARRIVAL_TRACE`` when unset), and
   ``ERASUREHEAD_REGIME=kind:round[:param[:param2]]`` (a mid-run regime
   shift: heavytail, adversary or targeted). Checkpoints:
   ``--checkpoint-dir DIR --checkpoint-every N`` saves every N rounds;
   ``--resume`` restarts from the newest usable one, and the artifacts
   then cover the resumed rounds. ``--pipeline-depth 1`` trains pipelined
   (tau=1 stale gradients, GD and the approximate schemes only);
   ``--sweep-cache off`` turns the device data cache off.
   ``--stack-residency streamed`` trains out of a shard store (the
   dataset spilled to a temporary one), ``--stream-window N`` partitions
   on the device at a time (train/trainer._train_streamed); ``auto``
   streams under an ``ERASUREHEAD_STREAM_WINDOW`` byte budget.
   ``--arrival-mode measured`` times each worker's real gradient compute
   every round and collects on those arrivals (trainer.train_measured).
   ``--kill-workers W:R[,W:R...]`` kills worker W at round R: with
   ``--on-death error`` (the default) a run the reference's master would
   hang in raises, ``failover`` (with ``--death-timeout SECONDS``) rewrites
   the unreachable rounds' decode over the survivors, and ``elastic``
   re-shards onto the survivors at the first death and trains on
   (parallel/failures.py).

   Online drivers: ``--adapt on [--adapt-chunk N] [--adapt-arms SPEC]
   [--adapt-priors DIR]`` re-chooses the collection policy every N rounds
   with a seeded bandit (adapt/; arms ``scheme[:cN][:dSECS]``, priors from a
   saved what-if surface), and ``--elastic on [--elastic-chunk N]
   [--death-rounds K] [--death-timeout S]`` detects dead workers from the
   run's own telemetry and re-lays the code onto the survivors between
   chunks (elastic/); ``--kill-workers`` then scripts the world it sees.

   Telemetry: ``--telemetry on`` writes the run's typed records to
   ``<output-dir>/events.jsonl`` (obs/events.py; ``auto`` = on exactly when
   ``--output-dir`` is given, else ``ERASUREHEAD_TELEMETRY``, else off),
   with the eval's ``eval`` record after the replay; ``--elastic on`` then
   journals its decisions beside it. ``--trace-dir DIR`` captures a
   ``torch.profiler`` trace of the run into ``DIR/*.pt.trace.json``
   (utils/tracing.device_trace; open it in ui.perfetto.dev). Both observe
   only: the run's artifacts are bitwise those of a run without them.

2. **Legacy positional**: the reference's 13-argument calling convention
   (main.py:20-27)::

       python -m erasurehead_tpu_torch.cli n_procs n_rows n_cols input_dir \\
           is_real dataset is_coded n_stragglers partitions coded_ver \\
           num_collect add_delay update_rule [--rounds N] [--device cpu] \\
           [--output-dir DIR] [--quiet]

   Dispatch parity (main.py:62-92): is_coded=0 -> naive; coded_ver 0 ->
   cyclic MDS (partial if partitions>0), 1 -> FRC (partial if partitions>0),
   2 -> avoidstragg, 3 -> AGC; dataset "kc_house_data" selects the linear
   model. The optional trailing flags are the port's: the 13 arguments carry
   no round count, device or output directory.

Across processes: ``torchrun --nproc-per-node N -m erasurehead_tpu_torch.cli
...`` runs the same command on N devices, one process each (NCCL on the
card, gloo with ``--device cpu``; parallel/backend.initialize_distributed
reads torchrun's environment). The W workers split over the largest group
of processes whose size divides W; each rank trains on its slice and the
decoded gradient is all-reduced; rank 0 alone writes the artifacts and the
event log. ``--stack-mode ring [--ring-pipeline on|off|auto]`` keeps only
the partition-major stack and moves the redundant slots between the ranks
every round. ``--tp-shards`` (mlp), ``--pp-shards`` (deepmlp),
``--ep-shards`` (moe) or ``--seq-shards`` (attention, ``--sp-form ring`` or
``ulysses``) above 1 adds a model-internal axis: a 2-D mesh of that many
processes a row (parallel/mesh.worker_plus_axis_mesh).

Run flow: load the reference-layout dataset under ``--input-dir`` if it is
there, else generate the synthetic one (a real dataset, any but
``artificial``, raises without its layout); train on the device (``cuda``
unless ``--device cpu``), replay the eval, write the five artifacts and the
manifest into ``--output-dir`` (default ``<input_dir>/.../results/``, the
reference's layout). A CSR (``.npz``) layout trains as a sparse stack
(``--sparse-format padded|fields|auto``), e.g. a covtype-shaped one-hot
layout written by ``data/io.write_reference_layout`` from
``data/synthetic.generate_onehot(396120, 15509, 30, n_fields=12)``::

    python -m erasurehead_tpu_torch.cli --dataset covtype --input-dir DIR \
        --rows 396120 --cols 15509 --scheme approx --workers 30 \
        --stragglers 2 --num-collect 15 --lr 1.0 --sparse-format fields
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys

import numpy as np

from erasurehead_tpu_torch import schemes as schemes_lib
from erasurehead_tpu_torch.data import io as data_io
from erasurehead_tpu_torch.data.synthetic import Dataset, generate_gmm, generate_linear
from erasurehead_tpu_torch.obs import events as events_lib
from erasurehead_tpu_torch.parallel import failures
from erasurehead_tpu_torch.parallel import backend as backend_lib
from erasurehead_tpu_torch.parallel.backend import is_writer
from erasurehead_tpu_torch.train import artifacts, evaluate, trainer
from erasurehead_tpu_torch.utils.config import ModelKind, RunConfig, resolve_telemetry
from erasurehead_tpu_torch.utils.device import local_devices
from erasurehead_tpu_torch.utils.tracing import device_trace

#: legacy (is_coded=1) dispatch: coded_ver -> scheme, without and with
#: partitions (main.py:62-92)
_LEGACY_CODED = {0: "cyccoded", 1: "repcoded", 2: "avoidstragg", 3: "approx"}
_LEGACY_PARTIAL = {1: "partialrepcoded", 0: "partialcyccoded"}


def _legacy_to_config(argv: list[str]) -> RunConfig:
    """Map the reference's 13 positional args onto a RunConfig."""
    (
        n_procs, n_rows, n_cols, input_dir, is_real, dataset, is_coded,
        n_stragglers, partitions, coded_ver, num_collect, add_delay,
        update_rule,
    ) = argv
    n_procs, n_rows, n_cols = int(n_procs), int(n_rows), int(n_cols)
    is_real, is_coded = int(is_real), int(is_coded)
    n_stragglers, partitions, coded_ver = (
        int(n_stragglers), int(partitions), int(coded_ver),
    )
    num_collect, add_delay = int(num_collect), int(add_delay)

    if not is_coded:
        scheme = "naive"
    elif partitions:
        if coded_ver not in _LEGACY_PARTIAL:
            raise SystemExit(
                f"coded_ver={coded_ver} invalid with partitions>0 "
                f"(0=partial coded, 1=partial replication; main.py:64-68)"
            )
        scheme = _LEGACY_PARTIAL[coded_ver]
    else:
        if coded_ver not in _LEGACY_CODED:
            raise SystemExit(
                f"coded_ver={coded_ver} invalid (0=cyclic MDS, 1=FRC, "
                f"2=avoidstragg, 3=AGC; main.py:70-87)"
            )
        scheme = _LEGACY_CODED[coded_ver]
    model = (
        ModelKind.LINEAR if dataset == "kc_house_data" else ModelKind.LOGISTIC
    )
    return RunConfig(
        scheme=scheme,
        model=model,
        n_workers=n_procs - 1,  # reference: rank 0 is the master
        n_stragglers=n_stragglers,
        num_collect=num_collect if num_collect > 0 else None,
        add_delay=bool(add_delay),
        update_rule=update_rule,
        dataset=dataset if is_real else "artificial",
        n_rows=n_rows,
        n_cols=n_cols,
        input_dir=input_dir,
        is_real_data=bool(is_real),
        partitions_per_worker=partitions,
    )


def _legacy_options_parser() -> argparse.ArgumentParser:
    """The port's optional flags after the 13 legacy positionals."""
    p = argparse.ArgumentParser(prog="erasurehead_tpu_torch (legacy form)")
    p.add_argument("--rounds", type=int, default=None)
    p.add_argument("--output-dir", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--quiet", action="store_true")
    return p


def _is_legacy(argv: list[str]) -> bool:
    """The 13-positional form: 13 leading arguments none of which is a flag,
    then nothing or only flags."""
    return (
        len(argv) >= 13
        and not any(a.startswith("--") for a in argv[:13])
        and (len(argv) == 13 or argv[13].startswith("--"))
    )


def _flags_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="erasurehead_tpu_torch",
        description="Straggler-tolerant coded gradient descent on an NVIDIA GPU",
    )
    # --scheme choices come from the registry, so entry-point-registered
    # schemes appear here without touching this file
    p.add_argument("--scheme", default="naive", choices=schemes_lib.names())
    p.add_argument("--model", default=None, choices=[m.value for m in ModelKind])
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--stragglers", type=int, default=1)
    p.add_argument("--num-collect", type=int, default=None)
    p.add_argument("--deadline", type=float, default=None,
                   help="per-round collection deadline in simulated "
                        "seconds (scheme=deadline)")
    p.add_argument("--decode", default="fixed", choices=["fixed", "optimal"],
                   help="decode-weight policy: 'optimal' refits the "
                        "collection weights per round to the actual "
                        "arrival set (least squares over the layout's "
                        "effective coding matrix, arXiv:2006.09638); "
                        "'fixed' keeps the scheme's own weights")
    p.add_argument("--adapt", default="off", choices=["off", "on"],
                   help="online straggler-adaptive collection (adapt/): "
                        "a seeded bandit re-chooses the (scheme, collect, "
                        "deadline) policy at every --adapt-chunk boundary "
                        "from the run's own decode-error and arrival "
                        "telemetry, switching when the straggler regime "
                        "shifts")
    p.add_argument("--adapt-chunk", type=int, default=10,
                   help="rounds per adaptive decision window")
    p.add_argument("--elastic", default="off", choices=["off", "on"],
                   help="online elastic membership (elastic/): train in "
                        "chunks and, between chunks, detect dead workers "
                        "from the run's own telemetry (the -1 never-"
                        "arrived sentinel persisting --death-rounds "
                        "rounds, or a --death-timeout trip), re-lay the "
                        "code onto the survivors with params and momentum "
                        "carried over, and scale back up when a worker "
                        "rejoins (chaos worker_revive). --kill-workers "
                        "scripts the ground-truth world; the controller "
                        "only ever sees telemetry")
    p.add_argument("--elastic-chunk", type=int, default=10,
                   help="rounds per elastic membership chunk (the "
                        "re-layout granularity)")
    p.add_argument("--death-rounds", type=int, default=3,
                   help="consecutive never-arrived rounds that declare a "
                        "worker dead (elastic mode)")
    p.add_argument("--adapt-arms", default=None, metavar="SPEC",
                   help="comma-separated arms 'scheme[:cN][:dSECS]', e.g. "
                        "'naive,approx:c4,deadline:d1.5'; default: the "
                        "run's own policy plus the uncoded-layout "
                        "alternatives (adapt.default_arms)")
    p.add_argument("--adapt-priors", default=None, metavar="DIR",
                   help="seed the adapt bandit's cold start from a saved "
                        "what-if surface (whatif/surface.py): arm values "
                        "start at the surface's simulated expected reward "
                        "instead of zero, so warm-up only explores arms "
                        "the surface could not rank")
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
    p.add_argument("--compute-time", type=float, default=0.0,
                   help="simulated per-round compute seconds per worker")
    p.add_argument("--worker-speed-spread", type=float, default=0.0,
                   help="uniform per-worker speed spread in [1-s,1+s]")
    p.add_argument("--partitions-per-worker", type=int, default=0)
    p.add_argument("--compute-mode", default="faithful", choices=["faithful", "deduped"])
    p.add_argument("--stack-mode", default="materialized",
                   choices=["materialized", "ring", "auto"],
                   help="faithful-mode stack transport: 'ring' keeps only "
                        "the partition-major stack and rebuilds each rank's "
                        "redundant slots from its ring neighbours every "
                        "round (bitwise-identical trajectories, (s+1)x "
                        "less device data; on one process a local gather); "
                        "'auto' switches to ring past a footprint estimate")
    p.add_argument("--ring-pipeline", default="auto",
                   choices=["auto", "on", "off"],
                   help="ring-transport scheduling under --stack-mode ring: "
                        "'on' posts hop t+1 before hop t's fill and waits on "
                        "it after (same hops, same bytes, bitwise-identical "
                        "trajectories); 'off' sends and fills hop by hop; "
                        "'auto' = a cached ring_pipeline race verdict, else "
                        "off")
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
    p.add_argument("--arrival-trace", default=None, metavar="PATH",
                   help="replay a recorded [rounds, workers] arrival-time "
                        "trace (.npy/.npz/.csv/.txt; tiled over rounds) "
                        "instead of drawing i.i.d. exponential delays; "
                        "ERASUREHEAD_ARRIVAL_TRACE when unset. "
                        "--worker-speed-spread composes as a per-worker "
                        "multiplier on the trace rows")
    p.add_argument("--seq-shards", type=int, default=1,
                   help="sequence-parallel shards for the attention model: "
                        ">1 builds a 2-D (workers, seq) mesh and spans the "
                        "token axis over it")
    p.add_argument("--sp-form", default="ring", choices=["ring", "ulysses"],
                   help="SP form carrying the attention: ppermute ring or "
                        "all-to-all head sharding")
    p.add_argument("--tp-shards", type=int, default=1,
                   help="tensor-parallel shards for the MLP model: >1 "
                        "builds a 2-D (workers, model) mesh and splits the "
                        "hidden dimension over it")
    p.add_argument("--pp-shards", type=int, default=1,
                   help="pipeline stages for the deepmlp model: >1 builds "
                        "a 2-D (workers, pipe) mesh and streams GPipe "
                        "microbatches through the layer stages")
    p.add_argument("--ep-shards", type=int, default=1,
                   help="expert-parallel shards for the moe model: >1 "
                        "builds a 2-D (workers, expert) mesh and splits "
                        "the experts over it")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="DATA dtype (params/updates stay float32)")
    p.add_argument("--arrival-mode", default="simulated",
                   choices=["simulated", "measured"],
                   help="measured: time each worker's real per-round "
                        "gradient compute and collect on those arrivals "
                        "(trainer.train_measured)")
    p.add_argument("--stack-dtype", default="auto",
                   choices=["auto", "float32", "bfloat16", "int8"],
                   help="feature-stack STORAGE dtype: int8 quantizes the "
                        "partition-major stack at upload (per-partition "
                        "scale tables, dequantized at the top of every "
                        "grad body; lossy); auto follows --dtype")
    p.add_argument("--stack-residency", default="resident",
                   choices=["resident", "streamed", "auto"],
                   help="where the partition stack LIVES: 'streamed' "
                        "keeps it in an on-disk shard store (data/"
                        "store.py) and materializes only a window of "
                        "partitions per chunk of rounds, double-buffered by a "
                        "host prefetcher — data larger than device memory trains "
                        "on a fixed byte budget (ERASUREHEAD_STREAM_"
                        "WINDOW); a window covering the whole stack is "
                        "bitwise-identical to resident. 'auto' streams "
                        "exactly when the budget env is set")
    p.add_argument("--stream-window", type=int, default=None,
                   help="streamed residency: partitions per window "
                        "(default: sized so TWO windows fit the "
                        "ERASUREHEAD_STREAM_WINDOW byte budget; rounded "
                        "down to a divisor of the partition count)")
    p.add_argument("--donate", default="auto", choices=["auto", "on", "off"],
                   help="buffer donation for the round loop's carry "
                        "(params + optimizer state) and per-round weight "
                        "tables: their storage is released once copied "
                        "into the CUDA graph's buffers; bitwise-identical "
                        "math, cached data stacks are never donated. "
                        "auto = on")
    p.add_argument("--scan-unroll", type=int, default=1,
                   help="rounds per CUDA-graph replay of the round loop "
                        "(the JAX package's lax.scan unroll factor; "
                        "identical math, a lowering knob; no effect on "
                        "the CPU)")
    p.add_argument("--sparse-format", default="padded",
                   choices=["padded", "fields", "auto"],
                   help="sparse (CSR) stack representation: padded = "
                        "PaddedRows gather/scatter; fields = FieldOnehot "
                        "pair tables (one-hot-per-field data only); auto = "
                        "fields where the data allows")
    p.add_argument("--fields-scatter", default="pairs", choices=["pairs", "onehot"],
                   help="FieldOnehot gradient scatter: pairs = sums into "
                        "the pair tables' cells, then row and column sums; "
                        "onehot = per-field one-hot matmuls")
    p.add_argument("--fields-margin", default="tables", choices=["tables", "onehot"],
                   help="FieldOnehot margin: tables = fused pair-table "
                        "gathers; onehot = per-field one-hot matmuls")
    p.add_argument("--sparse-lanes", type=int, default=None,
                   help="sparse margin lane width (a power of two): on the "
                        "card it shapes the FieldOnehot pairing plan only; "
                        "gathers stay scalar")
    p.add_argument("--dense-margin-cols", type=int, default=None,
                   help="dense margin lowering width [2, 128]: a TPU layout "
                        "device, validated, with no effect on the card")
    p.add_argument("--flat-grad", default="auto", choices=["auto", "on", "off"],
                   help="flat-stack closed-form GLM gradient "
                        "(parallel/step.make_flat_grad_fn): slot axes "
                        "folded into the rows, decode weights into the "
                        "residual; auto is flat for FieldOnehot stacks only")
    p.add_argument("--margin-flat", default="auto", choices=["auto", "on", "off"],
                   help="hybrid dense GLM lowering "
                        "(parallel/step.make_margin_flat_grad_fn): one flat "
                        "margin product, per-slot transpose; auto is off")
    p.add_argument("--pipeline-depth", type=int, default=0,
                   choices=[0, 1],
                   help="pipelined training with bounded staleness tau "
                        "(parallel/pipeline.py): 1 dispatches round t+1's "
                        "worker compute against round t-1's params while "
                        "round t's arrivals drain. Deterministic and "
                        "journal-replayable; refuses (typed "
                        "PipelineRefusal) exact-decode schemes and non-GD "
                        "rules. 0 = synchronous")
    p.add_argument("--sweep-cache", default="on", choices=["on", "off"],
                   help="the sweep engine's device data cache "
                        "(train/cache.py): off rebuilds and re-uploads "
                        "every run's stack. ERASUREHEAD_SWEEP_CACHE=0 in "
                        "the env does the same")
    p.add_argument("--telemetry", default=None, choices=["on", "off", "auto"],
                   help="run-telemetry event log (obs/): writes "
                        "events.jsonl beside the artifacts, typed "
                        "run_start/compile/data_upload/rounds/decode/"
                        "run_end/critical_path records, rendered by the "
                        "report subcommand. Default: ERASUREHEAD_TELEMETRY "
                        "env, else off; auto = on when --output-dir is "
                        "given. Observation only: the run is bitwise the "
                        "same either way")
    p.add_argument("--trace-dir", default=None,
                   help="capture a torch.profiler trace of the run here "
                        "(a Chrome trace, *.pt.trace.json; ui.perfetto.dev)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None,
                   help="save optimizer state here every --checkpoint-every "
                        "rounds (train/checkpoint.py)")
    p.add_argument("--checkpoint-every", type=int, default=None)
    p.add_argument("--resume", action="store_true",
                   help="restart from the latest checkpoint in "
                        "--checkpoint-dir; artifacts cover the resumed "
                        "window [start_round, rounds)")
    p.add_argument("--kill-workers", default=None, metavar="W:R[,W:R...]",
                   help="fault injection: kill worker W permanently at "
                        "round R (e.g. 6:10,7:12)")
    p.add_argument("--on-death", default="error",
                   choices=["error", "failover", "elastic"],
                   help="error: raise where the reference would hang; "
                        "failover: degrade infeasible rounds' decode "
                        "(needs --death-timeout); elastic: re-shard onto "
                        "the survivors and continue (failures.train_elastic)")
    p.add_argument("--death-timeout", type=float, default=None,
                   help="simulated seconds before the master presumes a "
                        "worker dead (failover and elastic modes)")
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
        deadline=ns.deadline,
        decode=ns.decode,
        rounds=ns.rounds,
        add_delay=ns.add_delay,
        delay_mean=ns.delay_mean,
        compute_time=ns.compute_time,
        worker_speed_spread=ns.worker_speed_spread,
        update_rule=ns.update_rule,
        alpha=ns.alpha,
        lr_schedule=ns.lr,
        dataset=ns.dataset,
        n_rows=ns.rows,
        n_cols=ns.cols,
        input_dir=ns.input_dir,
        is_real_data=ns.input_dir is not None and ns.dataset != "artificial",
        partitions_per_worker=ns.partitions_per_worker,
        compute_mode=ns.compute_mode,
        stack_mode=ns.stack_mode,
        ring_pipeline=ns.ring_pipeline,
        use_pallas=ns.use_pallas,
        arrival_mode=ns.arrival_mode,
        layer_coding=ns.layer_coding,
        block_decode=ns.block_decode,
        deep_layers=ns.deep_layers,
        arrival_trace=ns.arrival_trace,
        seq_shards=ns.seq_shards,
        sp_form=ns.sp_form,
        tp_shards=ns.tp_shards,
        pp_shards=ns.pp_shards,
        ep_shards=ns.ep_shards,
        dtype=ns.dtype,
        stack_dtype=ns.stack_dtype,
        stack_residency=ns.stack_residency,
        stream_window=ns.stream_window,
        donate=ns.donate,
        scan_unroll=ns.scan_unroll,
        sparse_format=ns.sparse_format,
        fields_scatter=ns.fields_scatter,
        fields_margin=ns.fields_margin,
        sparse_lanes=ns.sparse_lanes,
        dense_margin_cols=ns.dense_margin_cols,
        flat_grad=ns.flat_grad,
        margin_flat=ns.margin_flat,
        pipeline_depth=ns.pipeline_depth,
        seed=ns.seed,
    )


def n_partitions(cfg: RunConfig) -> int:
    """The dataset's partition count: W, or (p - s) * W for the partial
    schemes (the JAX CLI's count)."""
    if not cfg.partitions_per_worker:
        return cfg.n_workers
    return (cfg.partitions_per_worker - cfg.n_stragglers) * cfg.n_workers


def dataset_dir(cfg: RunConfig) -> str | None:
    """The reference's on-disk dataset directory for this config
    (path synthesis: main.py:59-60, generate_data.py:59-62)."""
    if not cfg.input_dir:
        return None
    sub = (
        cfg.dataset
        if cfg.is_real_data
        else f"artificial-data/{cfg.n_rows}x{cfg.n_cols}"
    )
    leaf = (
        str(cfg.n_workers)
        if not cfg.partitions_per_worker
        else f"partial/{n_partitions(cfg)}"
    )
    return os.path.join(cfg.input_dir, sub, leaf)


def load_dataset(cfg: RunConfig) -> Dataset:
    """The reference-layout directory if present, else the in-memory
    synthetic dataset.

    A config that names a real dataset (any but ``"artificial"``) raises
    when its layout is not on disk, with or without ``--input-dir``:
    training on synthetic data under a real dataset's name would be worse
    than failing. (The JAX CLI generates synthetic data when no
    ``--input-dir`` is given; the port refuses.) A CSR (``.npz``) layout
    loads as scipy sparse matrices and stacks per ``cfg.sparse_format``
    (data/sharding.partition_stack)."""
    P = n_partitions(cfg)
    path = dataset_dir(cfg)
    if data_io.has_reference_layout(path):
        return data_io.read_reference_layout(path, P)
    if cfg.dataset != "artificial":
        raise FileNotFoundError(
            f"real dataset {cfg.dataset!r} not found at {path!r}; pass its "
            "reference layout with --input-dir (write one with "
            "erasurehead_tpu_torch.data.io.write_reference_layout)"
        )
    if cfg.model == ModelKind.LINEAR:
        return generate_linear(cfg.n_rows, cfg.n_cols, P, cfg.seed)
    return generate_gmm(cfg.n_rows, cfg.n_cols, P, cfg.seed)


def _validate_checkpoint_flags(parser, ns) -> None:
    """Interdependent checkpoint, arrival-mode and fault-injection flags:
    fail fast with a proper CLI diagnostic (exit code 2), before the
    dataset loads."""
    if ns.resume and not ns.checkpoint_dir:
        parser.error("--resume requires --checkpoint-dir")
    if ns.checkpoint_every is not None and ns.checkpoint_every < 1:
        parser.error("--checkpoint-every must be >= 1")
    if ns.checkpoint_dir and not ns.resume and ns.checkpoint_every is None:
        parser.error(
            "--checkpoint-dir without --checkpoint-every never saves; "
            "pass --checkpoint-every N"
        )
    if ns.checkpoint_every is not None and not ns.checkpoint_dir:
        parser.error("--checkpoint-every requires --checkpoint-dir")
    if (ns.checkpoint_dir or ns.resume) and ns.arrival_mode == "measured":
        parser.error(
            "checkpoint/resume is implemented for the scan trainer only; "
            "unset --arrival-mode measured"
        )
    # --on-death/--death-timeout only mean anything with --kill-workers;
    # silently ignoring them would let a typo'd run masquerade as a
    # recovery experiment
    if ns.on_death != "error" and not ns.kill_workers:
        parser.error("--on-death requires --kill-workers")
    if ns.death_timeout is not None and ns.on_death != "failover" \
            and ns.elastic != "on":
        parser.error(
            "--death-timeout only applies to --on-death failover or "
            "--elastic on"
        )
    if ns.kill_workers and ns.on_death == "failover" and ns.death_timeout is None:
        parser.error("--on-death failover requires --death-timeout")
    if ns.kill_workers and (ns.checkpoint_dir or ns.resume):
        parser.error("--kill-workers does not compose with checkpointing")
    if ns.kill_workers and ns.arrival_mode == "measured":
        parser.error("--kill-workers needs the simulated-arrival trainer")
    # elastic membership: the driver owns the chunking and the failure
    # handling, so the static death paths don't compose with it
    if ns.elastic == "on":
        if ns.arrival_mode == "measured":
            parser.error("--elastic needs the simulated-arrival trainer")
        if ns.checkpoint_dir or ns.resume:
            parser.error(
                "--elastic manages its own chunk-boundary checkpoints; "
                "drop --checkpoint-dir/--resume (elastic resume is the "
                "driver API's checkpoint_dir/resume)"
            )
        if ns.adapt == "on":
            parser.error(
                "--elastic composes the adapt bandit internally (per-"
                "epoch re-seeded arms); drop --adapt"
            )
        if ns.on_death != "error":
            parser.error(
                "--elastic IS the death handling; drop --on-death"
            )
    if ns.elastic_chunk < 1:
        parser.error("--elastic-chunk must be >= 1")
    if ns.death_rounds < 1:
        parser.error("--death-rounds must be >= 1")
    # adaptive collection: the driver owns the chunking, so the static
    # checkpoint/fault paths don't compose with it
    if ns.adapt == "on":
        if ns.arrival_mode == "measured":
            parser.error("--adapt needs the simulated-arrival trainer")
        if ns.checkpoint_dir or ns.resume:
            parser.error("--adapt does not compose with checkpointing")
        if ns.kill_workers:
            parser.error("--adapt does not compose with --kill-workers")
    if ns.adapt_chunk < 1:
        parser.error("--adapt-chunk must be >= 1")
    if ns.adapt_arms is not None and ns.adapt != "on":
        parser.error("--adapt-arms requires --adapt on")
    if ns.adapt_priors is not None and ns.adapt != "on":
        parser.error("--adapt-priors requires --adapt on")


def _parse_deaths(spec: str) -> dict[int, int]:
    """'6:10,7:12' -> {6: 10, 7: 12} (worker: death round)."""
    out: dict[int, int] = {}
    for part in spec.split(","):
        w, _, r = part.partition(":")
        try:
            wi, ri = int(w), int(r)
        except ValueError:
            raise ValueError(
                f"bad --kill-workers entry {part!r}; want worker:round"
            ) from None
        if wi in out:
            raise ValueError(
                f"--kill-workers lists worker {wi} twice "
                f"({out[wi]} and {ri}) — likely a typo"
            )
        out[wi] = ri
    return out


def _parse_arms(spec: str):
    """'naive,approx:c4,deadline:d1.5' -> [Arm, ...] (cN = num_collect,
    dSECS = deadline; order-free within one arm)."""
    from erasurehead_tpu_torch.adapt import Arm

    arms = []
    for part in spec.split(","):
        fields = part.strip().split(":")
        if not fields or not fields[0]:
            raise ValueError(f"bad --adapt-arms entry {part!r}")
        scheme, num_collect, deadline = fields[0], None, None
        for f in fields[1:]:
            try:
                if f.startswith("c"):
                    num_collect = int(f[1:])
                elif f.startswith("d"):
                    deadline = float(f[1:])
                else:
                    raise ValueError
            except ValueError:
                raise ValueError(
                    f"bad --adapt-arms field {f!r} in {part!r}; want cN "
                    "(collect count) or dSECS (deadline)"
                ) from None
        arms.append(Arm(scheme, num_collect=num_collect, deadline=deadline))
    return arms


def _run_elastic(cfg: RunConfig, dataset, deaths, device, quiet: bool,
                 elastic_chunk: int, death_rounds: int, death_timeout, journal_dir):
    """The ``--elastic on`` branch: train_elastic_online, journaling into
    ``journal_dir`` (the output directory when telemetry is on, else None),
    and its decisions printed."""
    from erasurehead_tpu_torch import elastic as elastic_lib

    ecfg_kw = dict(chunk_rounds=elastic_chunk, death_rounds=death_rounds, seed=cfg.seed)
    if death_timeout is not None:
        ecfg_kw["timeout"] = death_timeout
    eres = elastic_lib.train_elastic_online(
        cfg, dataset, elastic=elastic_lib.ElasticConfig(**ecfg_kw),
        deaths=deaths, journal_dir=journal_dir, device=device,
    )
    if not quiet:
        relayouts = [d for d in eres.decisions if d["action"] == "relayout"]
        print(
            f"elastic membership: {len(eres.rows)} chunk(s), "
            f"{len(relayouts)} re-layout(s) across "
            f"{len(eres.epochs)} epoch(s)"
        )
        for d in eres.decisions:
            print(
                f"  round {d['round']:>4} {d['action']:10s} "
                + str({k: v for k, v in d.items() if k not in ("round", "action")})
            )
    return eres.result


def _run_adapt(cfg: RunConfig, dataset, device, quiet: bool, adapt_chunk: int,
               adapt_arms, adapt_priors):
    """The ``--adapt on`` branch: train_adaptive, the what-if priors loaded
    when asked for, and its decisions printed."""
    from erasurehead_tpu_torch import adapt as adapt_lib

    arms = _parse_arms(adapt_arms) if adapt_arms else None
    priors = None
    if adapt_priors:
        from erasurehead_tpu_torch.whatif import Surface

        surface = Surface.load(adapt_priors)
        priors = surface.adapt_priors(
            arms if arms is not None else adapt_lib.default_arms(cfg),
            n_workers=cfg.n_workers,
            n_stragglers=cfg.n_stragglers,
        )
        if not quiet:
            print(
                f"adapt priors <- {adapt_priors} "
                f"(spec {surface.spec_hash}): "
                f"{len(priors)} arm(s) primed"
            )
    ares = adapt_lib.train_adaptive(
        cfg, dataset, arms=arms,
        controller=adapt_lib.ControllerConfig(chunk_rounds=adapt_chunk, seed=cfg.seed),
        priors=priors, device=device,
    )
    if not quiet:
        switches = sum(
            1 for a, b in zip(ares.decisions, ares.decisions[1:]) if a["arm"] != b["arm"]
        )
        print(
            f"adaptive collection: {len(ares.decisions)} "
            f"decision(s), {switches} arm switch(es), "
            f"{1000 * ares.decision_overhead_s:.2f} ms controller "
            "overhead"
        )
        for d in ares.decisions:
            print(f"  chunk {d['chunk']:>3} -> {d['arm']:24s} [{d['reason']}]")
    return ares.result


def run(cfg: RunConfig, output_dir: str | None = None, quiet: bool = False,
        device=None, checkpoint_dir: str | None = None,
        checkpoint_every: int | None = None, resume: bool = False,
        kill_workers: str | None = None, on_death: str = "error",
        death_timeout: float | None = None, adapt: str = "off",
        adapt_chunk: int = 10, adapt_arms: str | None = None,
        adapt_priors: str | None = None, elastic: str = "off",
        elastic_chunk: int = 10, death_rounds: int = 3,
        telemetry: str | None = None, trace_dir: str | None = None):
    """Train, replay the eval and write the artifacts. Returns
    (TrainResult, EvalResult, artifact paths). A resumed run's artifacts
    cover [start_round, rounds).

    ``telemetry`` ("on"/"off"/"auto", None = ``ERASUREHEAD_TELEMETRY``,
    else off; utils/config.resolve_telemetry) captures the run's records
    into ``<output_dir>/events.jsonl`` (then ``paths["events"]``), the
    ``eval`` record after the replay; ``trace_dir`` wraps training and the
    replay in a ``torch.profiler`` trace (utils/tracing.device_trace).

    ``elastic="on"`` trains through elastic.train_elastic_online (the
    deaths, if any, are the world its controller observes);
    ``adapt="on"`` through adapt.train_adaptive.

    ``cfg.arrival_mode == "measured"`` trains through
    trainer.train_measured. ``kill_workers`` ("W:R[,W:R...]") injects
    permanent deaths: ``on_death="elastic"`` trains through
    failures.train_elastic; otherwise the deaths enter the arrival
    schedule and failures.plan_run builds the collection ("error" raises
    where the reference's master would hang, "failover" degrades those
    rounds, their clock ``death_timeout``)."""
    # argument-only checks: fail before the dataset loads
    if (checkpoint_dir or resume) and cfg.arrival_mode == "measured":
        raise ValueError(
            "checkpoint/resume is implemented for the scan trainer only; "
            "unset --arrival-mode measured"
        )
    deaths = _parse_deaths(kill_workers) if kill_workers else None
    if on_death != "error" and not deaths:
        raise ValueError("on_death requires kill_workers")
    if death_timeout is not None and on_death != "failover" \
            and elastic != "on":
        raise ValueError(
            "death_timeout only applies to on_death='failover' or "
            "elastic='on'"
        )
    if elastic == "on" and cfg.arrival_mode == "measured":
        raise ValueError("elastic needs the simulated-arrival trainer")
    if deaths and cfg.arrival_mode == "measured":
        raise ValueError("--kill-workers needs the simulated-arrival trainer")
    if deaths and (checkpoint_dir or resume):
        raise ValueError("--kill-workers does not compose with checkpointing")
    if deaths and on_death == "failover" and death_timeout is None:
        raise ValueError("--on-death failover requires --death-timeout")
    if deaths and not all(0 <= w < cfg.n_workers for w in deaths):
        raise ValueError(
            f"--kill-workers ids {sorted(deaths)} outside "
            f"[0, {cfg.n_workers})"
        )
    # resolved before the default output dir is filled in, so "auto" keys
    # off the caller's request
    telemetry_on = resolve_telemetry(telemetry, output_dir is not None)
    if output_dir is None:
        output_dir = os.path.join(dataset_dir(cfg) or ".", "results")
    # join torchrun's process group, if any (a no-op in one process), and
    # leave it cleanly on the way out, success or not (parallel/backend.
    # joined); rank 0 alone writes the artifacts and the event log
    with backend_lib.joined(device=device):
        writer = is_writer()
        telemetry_on = telemetry_on and writer
        dataset = load_dataset(cfg)
        events_path = os.path.join(output_dir, "events.jsonl")
        capture = events_lib.capture(events_path) if telemetry_on else contextlib.nullcontext()
        with capture, device_trace(trace_dir, device=device):
            if elastic == "on":
                result = _run_elastic(cfg, dataset, deaths, device, quiet, elastic_chunk,
                                      death_rounds, death_timeout,
                                      output_dir if telemetry_on else None)
            elif adapt == "on":
                result = _run_adapt(cfg, dataset, device, quiet, adapt_chunk, adapt_arms, adapt_priors)
            elif cfg.arrival_mode == "measured":
                # every visible card in one process, as the JAX package's
                # measured mode takes every local device
                result = trainer.train_measured(cfg, dataset, device=local_devices(device))
            elif deaths and on_death == "elastic":
                result, report = failures.train_elastic(cfg, dataset, deaths, device=device)
                if not quiet:
                    print(
                        f"elastic restart at round {report.death_round}: "
                        f"{report.n_workers_before} -> {report.n_workers_after} "
                        f"workers (dead: {list(report.dead_workers)})"
                    )
            elif deaths:
                # error|failover: the deaths enter the arrival schedule, and the
                # run is planned; "error" raises where the reference's master would
                # block in Waitany forever
                arrivals = failures.inject_worker_death(trainer.default_arrivals(cfg), deaths)
                sched, _ = failures.plan_run(
                    cfg.scheme, trainer.build_layout(cfg), arrivals,
                    num_collect=cfg.num_collect, deadline=cfg.deadline,
                    timeout=death_timeout if death_timeout is not None else np.inf,
                    on_infeasible=on_death,
                )
                result = trainer.train(cfg, dataset, device=device, arrivals=arrivals, schedule=sched)
            else:
                result = trainer.train(
                    cfg, dataset, device=device, checkpoint_dir=checkpoint_dir,
                    checkpoint_every=checkpoint_every, resume=resume,
                )
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
            if result.run_id is not None:
                auc = float(ev.auc[-1])
                events_lib.emit(
                    "eval",
                    run_id=result.run_id,
                    final_train_loss=float(ev.training_loss[-1]),
                    final_test_loss=float(ev.testing_loss[-1]),
                    final_auc=auc if np.isfinite(auc) else None,
                )
        if not writer:
            return result, ev, {}
        paths = artifacts.write_run_artifacts(result, ev, output_dir)
        if telemetry_on:
            paths["events"] = events_path
        if not quiet:
            artifacts.print_iteration_table(result, ev)
            print(f"artifacts -> {output_dir}")
            if telemetry_on:
                print(f"events -> {events_path}")
        return result, ev, paths


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "sweep":
        # the comparison-suite sweep runner, with --sweep-journal and
        # --resume-sweep (train/experiments.main)
        from erasurehead_tpu_torch.train import experiments as experiments_lib

        return experiments_lib.main(argv[1:])
    if argv and argv[0] == "report":
        # render event logs into the run summary table (obs/report.py)
        from erasurehead_tpu_torch.obs import report as report_lib

        return report_lib.main(argv[1:])
    if argv and argv[0] == "top":
        # the live telemetry frame over an event log or a /metrics URL
        # (obs/exporter.top_main)
        from erasurehead_tpu_torch.obs import exporter as exporter_lib

        return exporter_lib.top_main(argv[1:])
    if argv and argv[0] == "tune":
        from erasurehead_tpu_torch.tune import races

        return races.main(argv[1:])
    if argv and argv[0] == "whatif":
        from erasurehead_tpu_torch.whatif import engine

        return engine.main(argv[1:])
    if argv and argv[0] == "serve":
        # the multi-tenant serve daemon (serve/server.main)
        from erasurehead_tpu_torch.serve import server as serve_server

        return serve_server.main(argv[1:])
    if argv and argv[0] == "fleet":
        # N serve replicas behind the consistent-hash router
        # (serve/fleet.main): evidential membership over /healthz, WAL
        # adoption on a declared death, rolling deploys
        from erasurehead_tpu_torch.serve import fleet as fleet_lib

        return fleet_lib.main(argv[1:])
    if argv and argv[0] == "lint":
        # the AST lint of the port's contracts (analysis/runner.main);
        # exit 0 = no unsuppressed findings
        from erasurehead_tpu_torch.analysis import runner as lint_lib

        return lint_lib.main(argv[1:])
    if _is_legacy(argv):
        cfg = _legacy_to_config(argv[:13])
        opts = _legacy_options_parser().parse_args(argv[13:])
        if opts.rounds is not None:
            cfg = dataclasses.replace(cfg, rounds=opts.rounds)
        run(cfg, output_dir=opts.output_dir, quiet=opts.quiet, device=opts.device)
        return 0
    parser = _flags_parser()
    ns = parser.parse_args(argv)
    _validate_checkpoint_flags(parser, ns)
    if ns.sweep_cache == "off":
        from erasurehead_tpu_torch.train import cache as cache_lib

        cache_lib.set_enabled(False)
    run(
        _flags_to_config(ns),
        output_dir=ns.output_dir,
        quiet=ns.quiet,
        device=ns.device,
        checkpoint_dir=ns.checkpoint_dir,
        checkpoint_every=ns.checkpoint_every,
        resume=ns.resume,
        kill_workers=ns.kill_workers,
        on_death=ns.on_death,
        death_timeout=ns.death_timeout,
        adapt=ns.adapt,
        adapt_chunk=ns.adapt_chunk,
        adapt_arms=ns.adapt_arms,
        adapt_priors=ns.adapt_priors,
        elastic=ns.elastic,
        elastic_chunk=ns.elastic_chunk,
        death_rounds=ns.death_rounds,
        telemetry=ns.telemetry,
        trace_dir=ns.trace_dir,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
