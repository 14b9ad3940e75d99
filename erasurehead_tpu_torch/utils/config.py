"""Typed run configuration: the JAX package's RunConfig, as far as the port runs it.

Same field names, defaults and validation messages as
erasurehead_tpu/utils/config.py::RunConfig for the fields this port runs:
every scheme of the scheme registry (erasurehead_tpu_torch/schemes/) with
its fixed or least-squares-optimal decode, the two GLM families and the
unsharded mlp, deepmlp and moe families, GD/AGD/ADAM updates, the faithful
and deduped compute modes, float32 or bfloat16 data, the int8 stack, the
sparse stack formats and their lowerings, the faithful stack's transport
(``stack_mode``, ``ring_pipeline``), the flat and margin-flat
gradient lowerings, the fused-kernel switch and the per-layer (blockwise)
gradient coding knobs, the arrival mode (simulated or measured), the
heterogeneous-cluster arrival model and the recorded arrival trace, the
attention family's sequence-parallel knobs (validated; one device runs
them unsharded), and bounded-staleness
pipelining (``pipeline_depth``, refused with :class:`PipelineRefusal` where
it is unsound), and out-of-core streaming (``stack_residency``,
``stream_window``, the :data:`STREAM_WINDOW_ENV` byte budget), and the
compiled round loop's ``donate`` and ``scan_unroll``. Also the
static lowering signature the trajectory-cohort engine groups by, and the
sweep harness's switches: batching (:func:`resolve_batch_trajectories`) and
the sweep journal (:func:`resolve_sweep_journal`,
:func:`resolve_resume_sweep`).
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Optional, Sequence

import numpy as np

from erasurehead_tpu_torch import schemes
from erasurehead_tpu_torch.ops.features import validate_lanes, validate_margin_cols


class Scheme(str, enum.Enum):
    """The seven collection/coding strategies of the reference plus the
    beyond-reference builtins.

    The enum is the BUILTIN subset of the scheme registry
    (erasurehead_tpu_torch/schemes/): behavior (layout builder, collection
    rule, capability flags) lives in each scheme's SchemeDescriptor, and
    third-party schemes registered through the
    ``erasurehead_tpu_torch.schemes`` entry-point group are equally valid
    ``RunConfig.scheme`` values (they resolve to :class:`ExtensionScheme`
    tags instead of enum members).
    """

    NAIVE = "naive"  # wait for all workers               (src/naive.py)
    CYCLIC_MDS = "cyccoded"  # exact coding, cyclic MDS code      (src/coded.py)
    FRC = "repcoded"  # exact coding, fractional repetition (src/replication.py)
    APPROX = "approx"  # approximate gradient coding (AGC)  (src/approximate_coding.py)
    AVOID_STRAGGLERS = "avoidstragg"  # ignore-stragglers baseline (src/avoidstragg.py)
    PARTIAL_CYCLIC = "partialcyccoded"  # two-part coded   (src/partial_coded.py)
    PARTIAL_FRC = "partialrepcoded"  # two-part replicated (src/partial_replication.py)
    # sparse random d-regular code with least-squares-optimal decoding
    # (arXiv 1711.06771 + 2006.09638)
    RANDOM_REGULAR = "randreg"
    # deadline collection: whatever arrived by a fixed per-round deadline,
    # rescaled for unbiasedness
    DEADLINE = "deadline"
    # sparse random bipartite-graph code: each partition on exactly s+1
    # uniformly drawn workers, ragged worker loads
    SPARSE_GRAPH = "sparsegraph"
    # deterministic circulant expander-style code (arXiv 1707.03858)
    EXPANDER = "expander"


class ExtensionScheme(str):
    """A registry-registered scheme name outside the builtin enum.

    Reads like a :class:`Scheme` member wherever the port reads one
    (``.value`` returns the name; string equality and hashing follow the
    name). Constructed only by :func:`as_scheme` after a registry
    membership check."""

    __slots__ = ()

    @property
    def value(self) -> str:
        return str(self)

    def __repr__(self) -> str:
        return f"<ExtensionScheme {str(self)!r}>"


def as_scheme(name) -> "Scheme | ExtensionScheme":
    """Resolve a scheme value: builtin names map to :class:`Scheme`
    members, registry-registered third-party names to
    :class:`ExtensionScheme` tags; anything else raises a ValueError
    naming the registered schemes."""
    if isinstance(name, (Scheme, ExtensionScheme)):
        return name
    try:
        return Scheme(name)
    except ValueError:
        pass
    if schemes.is_registered(str(name)):
        return ExtensionScheme(name)
    raise ValueError(
        f"unknown scheme {name!r}; registered schemes: {schemes.names()}"
    )


class PipelineRefusal(ValueError):
    """Typed refusal for combinations where bounded-staleness pipelining
    (``pipeline_depth=1``) is unsound or unproven. A ``ValueError``, so every
    caller classifies it like any other config refusal, while callers that
    care why read ``reason``."""

    def __init__(self, reason: str, message: str):
        #: machine-readable refusal tag ("exact_decode", "momentum_unproven",
        #: "checkpoint_restart", ...), stable across message rewording
        self.reason = reason
        super().__init__(message)


class UpdateRule(str, enum.Enum):
    GD = "GD"
    AGD = "AGD"  # Nesterov-style accelerated GD (src/naive.py:116-122)
    ADAM = "ADAM"


class ModelKind(str, enum.Enum):
    LOGISTIC = "logistic"
    LINEAR = "linear"
    MLP = "mlp"  # two-layer tanh MLP (models/mlp.py)
    ATTENTION = "attention"  # single-block attention classifier (models/attention.py)
    DEEPMLP = "deepmlp"  # L stacked tanh layers (models/deep_mlp.py)
    MOE = "moe"  # dense softmax-gated experts (models/moe.py)


class ComputeMode(str, enum.Enum):
    """How worker messages are materialized on the device.

    FAITHFUL: every logical worker computes the gradient of each of its
    (possibly redundant) partitions, as the reference cluster did.
    DEDUPED: each partition gradient is computed once and the decode x coding
    coefficients fold into per-partition weights
    (CodingLayout.fold_slot_weights): the same decoded gradient at 1/(s+1)
    the work.
    """

    FAITHFUL = "faithful"
    DEDUPED = "deduped"


# Learning-rate schedules the reference keeps in comments (main.py:36-46).
def constant_schedule(value: float, rounds: int) -> np.ndarray:
    return value * np.ones(rounds)


def inverse_time_schedule(eta0: float, t0: float, rounds: int) -> np.ndarray:
    return np.array([eta0 * t0 / (i + t0) for i in range(1, rounds + 1)])


def exponential_decay_schedule(eta0: float, decay: float, rounds: int) -> np.ndarray:
    return np.array([eta0 * decay**i for i in range(1, rounds + 1)])


#: Per-dataset presets recorded in the reference (main.py:36-46 for the lr
#: schedules; run_approx_coding.sh:26-36 for shapes).
DATASET_PRESETS = {
    "amazon": dict(lr=("constant", 10.0), n_rows=26210, n_cols=241915, model=ModelKind.LOGISTIC),
    "covtype": dict(lr=("constant", 0.1), n_rows=396112, n_cols=15509, model=ModelKind.LOGISTIC),
    "kc_house_data": dict(lr=("exp", 0.1, 0.98), n_rows=17290, n_cols=27654, model=ModelKind.LINEAR),
    "dna": dict(lr=("constant", 0.1), n_rows=400000, n_cols=6890, model=ModelKind.LOGISTIC),
    "artificial": dict(lr=("constant", 10.0), n_rows=4096, n_cols=100, model=ModelKind.LOGISTIC),
}
DATASET_PRESETS["amazon-dataset"] = DATASET_PRESETS["amazon"]
DATASET_PRESETS["dna-dataset"] = DATASET_PRESETS["dna"]


@dataclasses.dataclass
class RunConfig:
    """Everything needed to reproduce one training run."""

    scheme: Scheme = Scheme.NAIVE
    model: ModelKind = ModelKind.LOGISTIC
    n_workers: int = 8  # reference: n_procs - 1 (the master is rank 0)
    n_stragglers: int = 1
    rounds: int = 100  # num_itrs, main.py:32
    num_collect: Optional[int] = None  # AGC stop count; None => n_workers
    add_delay: bool = True  # inject the seeded exponential straggler delays
    delay_mean: float = 0.5  # seconds; src/naive.py:146
    # heterogeneous-cluster arrival model (straggler.ArrivalModel): a base
    # per-round compute time and a seeded uniform per-worker speed spread
    # in [1-s, 1+s] multiplying it. 0/0 = the reference's pure-delay regime.
    compute_time: float = 0.0
    worker_speed_spread: float = 0.0
    update_rule: UpdateRule = UpdateRule.AGD
    alpha: Optional[float] = None  # l2 coeff; None => 1/n_samples (main.py:34)
    lr_schedule: Optional[Sequence[float]] = None  # None => dataset preset
    dataset: str = "artificial"
    n_rows: int = 4096
    n_cols: int = 100
    input_dir: Optional[str] = None  # on-disk data; None => generate in-memory
    is_real_data: bool = False
    partitions_per_worker: int = 0  # >0 selects partial schemes' slot count
    compute_mode: ComputeMode = ComputeMode.FAITHFUL
    # the faithful mode's stack transport (data/sharding.py):
    #   "materialized" keeps the worker-major [W, S, rows, F] stack resident
    #                  (the redundancy is real memory, as in the reference);
    #   "ring"         keeps only the partition-major [P, rows, F] stack and
    #                  rebuilds each rank's worker slots every round over
    #                  ring hops between the ranks (parallel/step.
    #                  make_ring_faithful_grad_fn; at world size 1 a local
    #                  gather): bitwise the materialized run, 1/(s+1) the
    #                  resident stack;
    #   "auto"         ring once the materialized stack's footprint estimate
    #                  crosses sharding.RING_AUTO_MIN_BYTES (or a cached
    #                  stack_mode race verdict says so).
    # Deduped mode has no redundancy to stream and refuses "ring".
    stack_mode: str = "materialized"
    # the ring transport's schedule (parallel/step._ring_fill): "off" sends
    # and fills hop by hop; "on" posts hop t+1 before it fills hop t and
    # waits on it after (same hops, same bytes, same fill order: bitwise);
    # "auto" resolves through a cached ring_pipeline race verdict, else
    # step.RING_PIPELINE_DEFAULT (off). Inert off the ring transport
    ring_pipeline: str = "auto"
    seed: int = 0  # data, generator matrix and the port's own params init
    # DATA dtype: bfloat16 halves the bytes the gradient pass streams; params
    # and optimizer updates always run in float32
    dtype: str = "float32"
    # the fused GLM gradient kernel (ops/kernels.fused_glm_grad): "auto" and
    # "on" (both kept for parity with the JAX package) route a GLM's stack
    # through it unless layer_coding is "on"; "on" needs a GLM; "off" takes
    # the two-pass PyTorch gradient
    use_pallas: str = "auto"
    # "simulated": the precomputed-schedule trainer (train.trainer.train).
    # "measured": time each worker's real gradient compute per round and
    # feed those arrivals to the collection rule (trainer.train_measured:
    # worker_timeset becomes a measurement, like src/naive.py:106)
    arrival_mode: str = "simulated"
    # per-layer (blockwise) gradient coding (parallel/step.
    # make_layer_block_grad_fn): each slot's gradient decodes per leaf
    # (DeepMLP layers and MoE expert shards are individual coded blocks,
    # ops/blocks.py). "on" forces it; "auto" resolves through
    # step.LAYER_CODING_DEFAULT (off, as in the JAX package)
    layer_coding: str = "auto"
    # the blockwise decode's lowering (parallel/step.resolve_block_decode):
    # "fused" decodes every leaf in place, "treewise" the packed
    # [*lead, L, width] block table, each in one launch a round of the
    # decode kernel (ops/kernels.fused_block_decode_leaves); "auto" takes
    # "fused". Inert unless
    # the run decodes blockwise
    block_decode: str = "auto"
    # hidden-layer count for the deepmlp family; 0 = the model's default (4)
    deep_layers: int = 0
    # replay a recorded per-round arrival-time trace instead of drawing
    # i.i.d. exponential delays (parallel/straggler.load_arrival_trace:
    # .npy/.npz/.csv/.txt, shape [R?, W], tiled over rounds). CLI
    # --arrival-trace; ERASUREHEAD_ARRIVAL_TRACE when unset.
    # worker_speed_spread composes as a per-worker multiplier ON the trace
    # rows (heterogeneous replay); refused under arrival_mode="measured"
    arrival_trace: Optional[str] = None
    # sequence-parallel shards for the attention family: >1 builds a 2-D
    # (workers, seq) mesh; each row's token axis splits over seq and
    # attention spans it (parallel/ring.py, models/attention._predict_seq)
    seq_shards: int = 1
    # which canonical SP form carries the attention: "ring" (one hop at a
    # time around the axis) or "ulysses" (two all-to-alls, head-sharded;
    # needs n_heads divisible by seq_shards)
    sp_form: str = "ring"
    # tensor-parallel shards for the MLP family: >1 builds a 2-D
    # (workers, model) mesh; the hidden dimension splits over the model
    # axis (Megatron column/row split, models/mlp._predict_tp)
    tp_shards: int = 1
    # pipeline-parallel stages for the deepmlp family: >1 builds a 2-D
    # (workers, pipe) mesh; layers split contiguously across stages and a
    # GPipe microbatch schedule streams the rows through them
    # (models/deep_mlp._predict_pp)
    pp_shards: int = 1
    # expert-parallel shards for the moe family: >1 builds a 2-D
    # (workers, expert) mesh; experts split contiguously across it
    # (models/moe._predict_ep)
    ep_shards: int = 1
    # per-round collection deadline in simulated seconds (scheme="deadline")
    deadline: Optional[float] = None
    # feature-stack STORAGE dtype (train/trainer._device_stack): "auto"
    # follows ``dtype``; "float32"/"bfloat16" force the stored float dtype
    # (labels ride along); "int8" quantizes the partition-major stack at
    # upload to an int8 payload + per-partition-per-feature float32 scales
    # (ops/features.QuantizedStack), dequantized at the top of every grad
    # body. Dense stacks only
    stack_dtype: str = "auto"
    # where the partition stack lives (train/trainer.train, data/store.py):
    # "resident" copies the whole stack to the device before round 0;
    # "streamed" keeps it in an on-disk shard store (data/store.ShardStore;
    # an in-memory dataset is written to a temporary one) and stages a
    # window of partitions per chunk of rounds, double-buffered by
    # data/prefetch.Prefetcher. A window covering every partition takes the
    # resident path over the store's rows (bitwise the resident run); a
    # smaller one trains block by block (trainer._train_streamed). "auto"
    # streams exactly when a STREAM_WINDOW_ENV byte budget is set
    stack_residency: str = "resident"
    # partitions per streamed window: None resolves from the
    # STREAM_WINDOW_ENV budget (two windows in flight), else to every
    # partition
    stream_window: Optional[int] = None
    # buffer donation for the round loop's carry (params + optimizer state)
    # and per-round weight tables: once a run has copied them into its
    # CUDA graph's static buffers (train/graphs.py), their storage is
    # released instead of held as a duplicate across the loop (the JAX
    # package's donate_argnums). "auto" = on (trainer.DONATE_DEFAULT:
    # bitwise-identical math; the cached device DATA stacks are never
    # donated); "off" for debugging and before/after measurement
    donate: str = "auto"
    # sparse margin lane width (a power of two in [1, 1024], or None): a TPU
    # lane-replication device in the JAX package; on the card its only
    # effect is the FieldOnehot pairing plan (ops/features.fields_margin_plan)
    sparse_lanes: Optional[int] = None
    # dense margin lowering width ([2, 128] or None): a TPU layout device,
    # validated and keyed, with no effect on the card
    dense_margin_cols: Optional[int] = None
    # flat-stack closed-form GLM gradient (parallel/step.make_flat_grad_fn):
    # the slot axes fold into the rows and the decode weights into the
    # residual: one matvec/rmatvec pair a round. "on" forces it (raising off
    # the closed-form path), "off" keeps the per-slot form, "auto" resolves
    # per stack kind (step.resolve_flat_grad: flat for FieldOnehot)
    flat_grad: str = "auto"
    # hybrid dense margin lowering (parallel/step._hybrid_margin_flat_grad):
    # one flat margin product, per-slot weighted transpose. "auto" resolves
    # to step.MARGIN_FLAT_DEFAULT (off); closed-form GLMs on dense stacks
    margin_flat: str = "auto"
    # sparse training-stack representation (ops/features.py): "padded"
    # (PaddedRows gather/scatter), "fields" (FieldOnehot: needs
    # exactly-one-hot-per-field data, raises otherwise), "auto" (fields
    # where the data's structure allows, else padded)
    sparse_format: str = "padded"
    # FieldOnehot gradient scatter: "pairs" (sums into the fused pair
    # tables' cells, then their row and column sums) or "onehot" (per-field
    # one-hot matmuls)
    fields_scatter: str = "pairs"
    # FieldOnehot margin: "tables" (fused pair-table gathers) or "onehot"
    # (per-field one-hot matmuls; sparse_lanes has no effect there)
    fields_margin: str = "tables"
    # decode-weight policy (arXiv:2006.09638): "fixed" keeps the scheme's own
    # collection weights; "optimal" refits them per round by least squares
    # to the actual arrival set over the layout's effective coding matrix
    # (parallel/collect.optimal_decode_schedule). Schemes without an
    # optimal_decode hook (the partial two-part layouts) keep their fixed
    # weights
    decode: str = "fixed"
    # rounds per CUDA-graph replay of the round loop (the JAX package's
    # lax.scan unroll factor): a chunk of n rounds is ceil(n/u) replays of
    # a graph of u = min(scan_unroll, n) rounds (the last covering the
    # n mod u tail). Identical math at any value; a lowering knob, keyed
    # like dtype/flat_grad. No effect on the CPU's eager loop
    scan_unroll: int = 1
    # bounded-staleness pipelined training (parallel/pipeline.py): 0 keeps
    # the synchronous round barrier; 1 dispatches round t+1's worker compute
    # against the params of round t-1 while round t's arrivals drain
    # (staleness tau=1): the trainer carries a second params slot, and the
    # collection schedule becomes the deterministic pipelined recurrence
    # over the same drawn arrival matrix. Refused (PipelineRefusal) on
    # exact-decode schemes and on AGD/ADAM
    pipeline_depth: int = 0

    @classmethod
    def for_dataset(cls, dataset: str, **overrides) -> "RunConfig":
        """Build a config with the dataset preset's shape and model applied."""
        preset = DATASET_PRESETS[dataset]
        base = dict(
            dataset=dataset,
            n_rows=preset["n_rows"],
            n_cols=preset["n_cols"],
            model=preset["model"],
        )
        base.update(overrides)
        return cls(**base)

    def __post_init__(self):
        self.scheme = as_scheme(self.scheme)
        self.model = ModelKind(self.model)
        self.update_rule = UpdateRule(self.update_rule)
        self.compute_mode = ComputeMode(self.compute_mode)
        if self.use_pallas not in ("auto", "on", "off"):
            raise ValueError(
                f"use_pallas must be auto/on/off, got {self.use_pallas!r}"
            )
        if self.flat_grad not in ("auto", "on", "off"):
            raise ValueError(
                f"flat_grad must be auto/on/off, got {self.flat_grad!r}"
            )
        if self.layer_coding not in ("auto", "on", "off"):
            raise ValueError(
                f"layer_coding must be auto/on/off, got {self.layer_coding!r}"
            )
        if self.layer_coding == "on":
            for knob, name in (
                (self.flat_grad, "flat_grad"),
                (self.margin_flat, "margin_flat"),
                (self.use_pallas, "use_pallas"),
            ):
                if knob == "on":
                    raise ValueError(
                        f"layer_coding='on' and {name}='on' both force a "
                        "gradient lowering; force at most one"
                    )
            if self.arrival_mode == "measured":
                raise ValueError(
                    "arrival_mode='measured' decodes each worker's own "
                    "timed message through the per-slot tree contraction; "
                    "the blockwise decode only exists inside the SPMD "
                    "step — use layer_coding='auto' or 'off' with "
                    "measured mode"
                )
        if self.block_decode not in ("auto", "fused", "treewise"):
            raise ValueError(
                f"block_decode must be auto/fused/treewise, got "
                f"{self.block_decode!r}"
            )
        if self.deep_layers < 0:
            raise ValueError(
                f"deep_layers must be >= 0, got {self.deep_layers}"
            )
        if self.arrival_trace is not None and self.arrival_mode != "simulated":
            raise ValueError(
                "arrival_trace replays a recorded schedule through the "
                "simulated-arrival trainer; arrival_mode='measured' times "
                "real arrivals — drop one of the two"
            )
        if self.scan_unroll < 1:
            raise ValueError(
                f"scan_unroll must be >= 1, got {self.scan_unroll}"
            )
        if self.arrival_mode not in ("simulated", "measured"):
            raise ValueError(
                f"arrival_mode must be simulated/measured, got "
                f"{self.arrival_mode!r}"
            )
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"dtype must be float32/bfloat16, got {self.dtype!r}"
            )
        if self.stack_mode not in ("materialized", "ring", "auto"):
            raise ValueError(
                f"stack_mode must be materialized/ring/auto, got "
                f"{self.stack_mode!r}"
            )
        if self.ring_pipeline not in ("auto", "on", "off"):
            raise ValueError(
                f"ring_pipeline must be auto/on/off, got "
                f"{self.ring_pipeline!r}"
            )
        if self.stack_dtype not in ("auto", "float32", "bfloat16", "int8"):
            raise ValueError(
                f"stack_dtype must be auto/float32/bfloat16/int8, got "
                f"{self.stack_dtype!r}"
            )
        if self.donate not in ("auto", "on", "off"):
            raise ValueError(
                f"donate must be auto/on/off, got {self.donate!r}"
            )
        if self.stack_dtype == "int8" and self.arrival_mode == "measured":
            raise ValueError(
                "arrival_mode='measured' dispatches each worker's own "
                "grad_sum on its resident slot stack; the int8 "
                "compressed stack only dequantizes inside the SPMD "
                "step body — use stack_dtype float32/bfloat16 (or "
                "auto) with measured mode"
            )
        if self.stack_dtype == "int8" and self.use_pallas == "on":
            raise ValueError(
                "use_pallas='on' forces the fused kernel, which "
                "streams a plain dense float stack and has no "
                "dequantizing body; force at most one of "
                "stack_dtype='int8' / use_pallas='on'"
            )
        if self.stack_mode == "ring":
            if self.compute_mode != ComputeMode.FAITHFUL:
                raise ValueError(
                    "stack_mode='ring' streams the faithful mode's "
                    "redundant worker stack; deduped mode has no "
                    "redundancy to stream — drop one of the two"
                )
            if self.arrival_mode == "measured":
                raise ValueError(
                    "arrival_mode='measured' times each worker's own "
                    "resident slot stack per dispatch; the ring transport "
                    "only exists inside the SPMD step — use "
                    "stack_mode='materialized' (or 'auto') with measured "
                    "mode"
                )
            if self.use_pallas == "on":
                raise ValueError(
                    "use_pallas='on' forces the fused kernel, which has no "
                    "ring-transport body; force at most one of "
                    "stack_mode='ring' / use_pallas='on'"
                )
        if self.stack_residency not in ("resident", "streamed", "auto"):
            raise ValueError(
                f"stack_residency must be resident/streamed/auto, got "
                f"{self.stack_residency!r}"
            )
        if self.stack_residency == "streamed" and self.arrival_mode == "measured":
            raise ValueError(
                "arrival_mode='measured' dispatches per-worker on "
                "resident slot stacks; the streamed window only "
                "exists in the simulated-arrival scan trainer — use "
                "stack_residency='resident' (or 'auto') with "
                "measured mode"
            )
        if self.stream_window is not None:
            if self.stack_residency == "resident":
                raise ValueError(
                    "stream_window sizes the streamed partition window; "
                    "it has no effect under stack_residency='resident' — "
                    "drop it or set stack_residency='streamed'/'auto'"
                )
            if self.stream_window < 1:
                raise ValueError(
                    f"stream_window must be >= 1, got {self.stream_window}"
                )
        self.sparse_lanes = validate_lanes(self.sparse_lanes)
        self.dense_margin_cols = validate_margin_cols(self.dense_margin_cols)
        if self.sparse_format not in ("padded", "fields", "auto"):
            raise ValueError(
                f"sparse_format must be padded/fields/auto, got "
                f"{self.sparse_format!r}"
            )
        if self.fields_scatter not in ("pairs", "onehot"):
            raise ValueError(
                f"fields_scatter must be pairs/onehot, got "
                f"{self.fields_scatter!r}"
            )
        if self.margin_flat not in ("auto", "on", "off"):
            raise ValueError(
                f"margin_flat must be auto/on/off, got {self.margin_flat!r}"
            )
        if self.margin_flat == "on" and self.flat_grad == "on":
            raise ValueError(
                "margin_flat='on' and flat_grad='on' both force a margin "
                "lowering; force at most one"
            )
        if self.margin_flat == "on" and self.use_pallas == "on":
            raise ValueError(
                "margin_flat='on' and use_pallas='on' both force a grad "
                "lowering; force at most one"
            )
        if self.fields_margin not in ("tables", "onehot"):
            raise ValueError(
                f"fields_margin must be tables/onehot, got "
                f"{self.fields_margin!r}"
            )
        if (
            self.sparse_format == "fields"
            and self.fields_margin == "onehot"
            and self.sparse_lanes is not None
        ):
            raise ValueError(
                "sparse_lanes has no effect under fields_margin='onehot' "
                "(no gathers to lane-replicate); drop one of the two"
            )
        if self.sparse_format == "auto" and self.sparse_lanes is not None:
            # an explicit lane width pins the PaddedRows stack, as in the
            # JAX package: the fields x lanes lowering is asked for by name
            self.sparse_format = "padded"
        self._validate_model_axes()
        if self.decode not in ("fixed", "optimal"):
            raise ValueError(
                f"decode must be fixed/optimal, got {self.decode!r}"
            )
        if self.pipeline_depth not in (0, 1):
            raise ValueError(
                f"pipeline_depth must be 0 (synchronous) or 1 (bounded "
                f"staleness tau=1), got {self.pipeline_depth}"
            )
        if self.pipeline_depth and self.update_rule != UpdateRule.GD:
            raise PipelineRefusal(
                "momentum_unproven",
                f"pipeline_depth=1 refuses update_rule="
                f"{self.update_rule.value!r}: the momentum/adaptive "
                "update's stability under a tau=1 stale gradient is "
                "unproven here — use update_rule='GD' with pipelining",
            )
        if self.pipeline_depth and self.arrival_mode == "measured":
            raise PipelineRefusal(
                "measured_arrivals",
                "pipeline_depth=1 refuses arrival_mode='measured': the "
                "measured trainer times real per-worker dispatches "
                "round by round, and overlapping rounds would make the "
                "measurement racy instead of stale — use the simulated-"
                "arrival trainer with pipelining",
            )
        if self.num_collect is None:
            self.num_collect = self.n_workers
        if self.dataset not in DATASET_PRESETS:
            raise ValueError(
                f"unknown dataset {self.dataset!r}; known: {sorted(DATASET_PRESETS)}"
            )
        # scheme-specific invariants (partial partition counts, positive
        # deadlines, third-party knobs) live on the scheme's registry
        # descriptor
        schemes.get(self.scheme).validate(self)

    def _validate_model_axes(self) -> None:
        """The model-internal axes, with the JAX package's rules and
        messages: each is tied to its family, runs under simulated arrivals
        only, and at most one exceeds 1."""
        if self.seq_shards < 1:
            raise ValueError(f"seq_shards must be >= 1, got {self.seq_shards}")
        axes_over_one = sum(
            v > 1
            for v in (
                self.seq_shards, self.tp_shards, self.pp_shards,
                self.ep_shards,
            )
        )
        if axes_over_one > 1:
            raise ValueError(
                "at most one of seq_shards/tp_shards/pp_shards/ep_shards "
                "may exceed 1 (each belongs to a different model family)"
            )
        if self.sp_form not in ("ring", "ulysses"):
            raise ValueError(
                f"sp_form must be ring/ulysses, got {self.sp_form!r}"
            )
        if self.seq_shards > 1:
            if self.model != ModelKind.ATTENTION:
                raise ValueError(
                    "seq_shards > 1 requires model='attention' (the only "
                    "family with a sequence axis to shard)"
                )
            if self.arrival_mode != "simulated":
                raise ValueError(
                    "seq_shards > 1 runs under the simulated-arrival "
                    "trainer only (measured mode dispatches per-worker on "
                    "single devices)"
                )
        for field, family, what in (
            ("tp_shards", ModelKind.MLP, "with a hidden dimension to split"),
            ("pp_shards", ModelKind.DEEPMLP, "with a layer pipeline"),
            ("ep_shards", ModelKind.MOE, "with experts to shard"),
        ):
            shards = getattr(self, field)
            if shards < 1:
                raise ValueError(f"{field} must be >= 1, got {shards}")
            if shards > 1:
                if self.model != family:
                    raise ValueError(
                        f"{field} > 1 requires model='{family.value}' (the "
                        f"only family {what})"
                    )
                if self.arrival_mode != "simulated":
                    raise ValueError(
                        f"{field} > 1 runs under the simulated-arrival "
                        "trainer only"
                    )

    def static_signature_fields(self) -> dict:
        """Field name -> value of every knob that changes a run's gradient
        lowering or update (not its weights, arrivals or lr values): the
        JAX package's RunConfig.static_signature_fields, in its order,
        restricted to the fields this port has. Trajectories whose
        signatures differ cannot share one cohort round loop
        (train/trainer.train_cohort)."""
        return {
            "model": self.model.value,
            "compute_mode": self.compute_mode.value,
            # the raw transport knobs, as the JAX package keys them: ring
            # and materialized trajectories never share a cohort
            "stack_mode": self.stack_mode,
            "ring_pipeline": self.ring_pipeline,
            "stack_dtype": self.stack_dtype,
            # the raw residency knobs keep streamed and resident
            # trajectories (and two stream windows) in separate cohorts
            "stack_residency": self.stack_residency,
            "stream_window": self.stream_window,
            "donate": self.donate,
            "update_rule": self.update_rule.value,
            "dtype": self.dtype,
            # rounds per graph replay: another captured program
            "scan_unroll": self.scan_unroll,
            # the staleness slot restructures the round's carry, so tau=0
            # and tau=1 trajectories never share a cohort
            "pipeline_depth": self.pipeline_depth,
            "sparse_lanes": self.sparse_lanes,
            "dense_margin_cols": self.dense_margin_cols,
            "layer_coding": self.layer_coding,
            "block_decode": self.block_decode,
            "deep_layers": self.deep_layers,
            "sparse_format": self.sparse_format,
            "fields_scatter": self.fields_scatter,
            "fields_margin": self.fields_margin,
            # model-family internal axes (change for_mesh's model variant)
            "sp_form": self.sp_form,
            "seq_shards": self.seq_shards,
            "tp_shards": self.tp_shards,
            "pp_shards": self.pp_shards,
            "ep_shards": self.ep_shards,
        }

    def static_signature(self) -> tuple:
        """The values of :meth:`static_signature_fields`, as a tuple."""
        return tuple(self.static_signature_fields().values())

    def resolve_stack_dtype(self) -> str:
        """The feature stack's resolved storage dtype: "float32",
        "bfloat16" or "int8". "auto" follows the data dtype; "int8"
        quantizes the feature stack while labels keep the ``dtype`` cast."""
        if self.stack_dtype == "auto":
            return self.dtype
        return self.stack_dtype

    @property
    def effective_alpha(self) -> float:
        return self.alpha if self.alpha is not None else 1.0 / self.n_rows

    def resolve_lr_schedule(self) -> np.ndarray:
        if self.lr_schedule is not None:
            lr = np.asarray(self.lr_schedule, dtype=np.float64)
            if lr.ndim == 0:
                lr = np.full(self.rounds, float(lr))
            if lr.shape != (self.rounds,):
                raise ValueError(
                    f"lr_schedule must be a scalar or have {self.rounds} "
                    f"entries, got shape {lr.shape}"
                )
            return lr
        preset = DATASET_PRESETS[self.dataset]
        kind, *args = preset["lr"]
        if kind == "constant":
            return constant_schedule(args[0], self.rounds)
        if kind == "inv":
            return inverse_time_schedule(args[0], args[1], self.rounds)
        if kind == "exp":
            return exponential_decay_schedule(args[0], args[1], self.rounds)
        raise ValueError(f"unknown lr schedule kind {kind!r}")


#: env var choosing the sweep harness's trajectory-batched dispatch when no
#: explicit setting is given (train/experiments.compare)
BATCH_TRAJECTORIES_ENV = "ERASUREHEAD_BATCH_TRAJECTORIES"

_TRUTHY = ("1", "on", "true", "yes")
_FALSY = ("0", "off", "false", "no")


def resolve_batch_trajectories(
    flag: Optional[str] = None, env: Optional[str] = None
) -> str:
    """The sweep harness's trajectory-batching mode: "on", "off" or "auto".

    "auto" (the default) dispatches every cohort of >= 2 eligible
    trajectories through :func:`train.trainer.train_cohort` (one round loop
    per cohort) and runs singletons sequentially; "on" routes singletons
    through the cohort engine too; "off" runs every trajectory through
    sequential :func:`train.trainer.train`. Precedence: explicit ``flag`` >
    :data:`BATCH_TRAJECTORIES_ENV` > "auto". ``env`` stands in for the real
    environment lookup (tests)."""
    val = flag
    if val is None:
        val = env if env is not None else os.environ.get(BATCH_TRAJECTORIES_ENV)
    if val is None or val == "":
        return "auto"
    val = str(val).strip().lower()
    if val in _TRUTHY:
        return "on"
    if val in _FALSY:
        return "off"
    if val in ("on", "off", "auto"):
        return val
    raise ValueError(
        f"batch-trajectories setting must be on/off/auto (or a "
        f"truthy/falsy {BATCH_TRAJECTORIES_ENV} value), got {val!r}"
    )


#: env var selecting a recorded arrival-trace file
#: (parallel/straggler.load_arrival_trace) when the config/CLI flag is
#: absent: trainer.default_arrivals replays it instead of drawing i.i.d.
#: exponential delays
ARRIVAL_TRACE_ENV = "ERASUREHEAD_ARRIVAL_TRACE"


def resolve_arrival_trace(
    flag: Optional[str] = None, env: Optional[str] = None
) -> Optional[str]:
    """The arrival-trace path, or None (drawn delays). Precedence:
    explicit ``--arrival-trace``/cfg value > :data:`ARRIVAL_TRACE_ENV` >
    off. ``env`` stands in for the real environment lookup (tests)."""
    val = flag
    if val is None:
        val = env if env is not None else os.environ.get(ARRIVAL_TRACE_ENV)
    return val or None


#: env var setting the serve daemon's in-flight device-memory budget when
#: the CLI flag is absent (serve/admission.py); value is bytes with an
#: optional k/m/g/t suffix, e.g. "2g". Unset = unbounded admission.
SERVE_BUDGET_ENV = "ERASUREHEAD_SERVE_BUDGET"

#: env var capping how many trajectories one packed serve dispatch may
#: carry when the CLI flag is absent (serve/packer.py)
SERVE_MAX_COHORT_ENV = "ERASUREHEAD_SERVE_MAX_COHORT"

_BYTE_SUFFIXES = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}


def parse_bytes(val) -> int:
    """"2g" / "512m" / "1048576" -> bytes (suffixes are binary powers)."""
    s = str(val).strip().lower()
    mult = 1
    if s and s[-1] in _BYTE_SUFFIXES:
        mult = _BYTE_SUFFIXES[s[-1]]
        s = s[:-1]
    try:
        n = int(float(s) * mult)
    except ValueError:
        raise ValueError(
            f"byte size must be an integer with an optional k/m/g/t "
            f"suffix, got {val!r}"
        ) from None
    if n <= 0:
        raise ValueError(f"byte size must be positive, got {val!r}")
    return n


def resolve_serve_budget(
    flag: Optional[str] = None, env: Optional[str] = None
) -> Optional[int]:
    """The serve admission budget in bytes, or None (unbounded).
    Precedence: explicit CLI ``--budget`` flag > :data:`SERVE_BUDGET_ENV`
    > unbounded. ``env`` stands in for the real environment lookup
    (tests)."""
    val = flag
    if val is None:
        val = env if env is not None else os.environ.get(SERVE_BUDGET_ENV)
    if val is None or val == "":
        return None
    return parse_bytes(val)


def resolve_serve_max_cohort(
    flag: Optional[int] = None, env: Optional[str] = None, default: int = 64
) -> int:
    """Max trajectories per packed serve dispatch. Explicit flag >
    :data:`SERVE_MAX_COHORT_ENV` > ``default``. ``env`` stands in for the
    real environment lookup (tests)."""
    val = flag
    if val is None:
        raw = env if env is not None else os.environ.get(SERVE_MAX_COHORT_ENV)
        if raw is None or raw == "":
            return default
        try:
            val = int(raw)
        except ValueError:
            raise ValueError(
                f"{SERVE_MAX_COHORT_ENV} must be an integer, got {raw!r}"
            ) from None
    if val < 1:
        raise ValueError(f"serve max-cohort must be >= 1, got {val}")
    return int(val)


#: env var arming an out-of-core host-to-device stream budget in bytes
#: (k/m/g/t suffixes): the ceiling on device bytes the streamed partition
#: windows may occupy. stack_residency="auto" resolves to streamed exactly
#: when it is set; the trainer sizes the window so that two of them (the one
#: computing and the one in flight, data/prefetch's double buffer) fit it
STREAM_WINDOW_ENV = "ERASUREHEAD_STREAM_WINDOW"


def resolve_stream_budget(
    flag: Optional[str] = None, env: Optional[str] = None
) -> Optional[int]:
    """The streamed-window byte budget, or None (unarmed). Precedence:
    explicit ``flag`` > :data:`STREAM_WINDOW_ENV` > off. ``env`` stands in
    for the real environment lookup (tests)."""
    val = flag
    if val is None:
        val = env if env is not None else os.environ.get(STREAM_WINDOW_ENV)
    if val is None or val == "":
        return None
    return parse_bytes(val)


#: env var enabling the sweep journal (train/journal.py) when no journal is
#: passed explicitly: its value is the journal DIRECTORY
SWEEP_JOURNAL_ENV = "ERASUREHEAD_SWEEP_JOURNAL"

#: env var enabling resume-from-journal (skip already-completed
#: trajectories) when the CLI flag is absent
RESUME_SWEEP_ENV = "ERASUREHEAD_RESUME_SWEEP"


def resolve_sweep_journal(
    flag: Optional[str] = None, env: Optional[str] = None
) -> Optional[str]:
    """The sweep-journal directory, or None (journaling off). Precedence:
    explicit ``--sweep-journal DIR`` > :data:`SWEEP_JOURNAL_ENV` > off.
    ``env`` stands in for the real environment lookup (tests)."""
    val = flag
    if val is None:
        val = env if env is not None else os.environ.get(SWEEP_JOURNAL_ENV)
    return val or None


def resolve_resume_sweep(
    flag: Optional[bool] = None, env: Optional[str] = None
) -> bool:
    """Should a journaled sweep skip trajectories its journal already
    completed? Explicit flag > :data:`RESUME_SWEEP_ENV` truthy/falsy value >
    False (record only). ``env`` stands in for the real environment lookup
    (tests)."""
    if flag is not None:
        return bool(flag)
    val = env if env is not None else os.environ.get(RESUME_SWEEP_ENV)
    if val is None or val == "":
        return False
    val = str(val).strip().lower()
    if val in _TRUTHY:
        return True
    if val in _FALSY:
        return False
    raise ValueError(f"{RESUME_SWEEP_ENV} must be truthy/falsy, got {val!r}")


#: env var controlling run telemetry when the CLI flag is absent (the same
#: flag > env > default precedence as the sweep cache's)
TELEMETRY_ENV = "ERASUREHEAD_TELEMETRY"

_TELEMETRY_ON = ("1", "on", "true", "yes")
_TELEMETRY_OFF = ("0", "off", "false", "no")


def resolve_telemetry(
    flag: Optional[str] = None,
    out_dir_set: bool = False,
    env: Optional[str] = None,
) -> bool:
    """Should this invocation write a run-telemetry event log (obs/)?

    The explicit CLI ``--telemetry {on,off,auto}`` flag wins, else the
    :data:`TELEMETRY_ENV` env var, else off. ``auto`` resolves to on exactly
    when the caller passed an explicit output directory (``out_dir_set``,
    the CLI's ``--output-dir``): a run that asked for a place to keep its
    artifacts wants the event log beside them. ``env`` overrides the real
    environment lookup (tests)."""
    val = flag
    if val is None:
        val = env if env is not None else os.environ.get(TELEMETRY_ENV)
    if val is None or val == "":
        val = "off"
    val = str(val).strip().lower()
    if val in _TELEMETRY_ON:
        return True
    if val in _TELEMETRY_OFF:
        return False
    if val == "auto":
        return bool(out_dir_set)
    raise ValueError(
        f"telemetry setting must be on/off/auto (or a truthy/falsy "
        f"{TELEMETRY_ENV} value), got {val!r}"
    )
