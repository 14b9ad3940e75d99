"""Typed run configuration: the JAX package's RunConfig, as far as the port runs it.

Same field names, defaults and validation messages as
erasurehead_tpu/utils/config.py::RunConfig for the fields this port runs:
every scheme of the scheme registry (erasurehead_tpu_torch/schemes/) with
its fixed or least-squares-optimal decode, the two GLM families and the
unsharded mlp, deepmlp and moe families, GD/AGD/ADAM updates, the faithful
and deduped compute modes, float32 or bfloat16 data, the fused-kernel
switch and the per-layer (blockwise) gradient coding knobs. Also the
static lowering signature the trajectory-cohort engine groups by, and the
sweep harness's batching switch (:func:`resolve_batch_trajectories`).
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Optional, Sequence

import numpy as np

from erasurehead_tpu_torch import schemes


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


class UpdateRule(str, enum.Enum):
    GD = "GD"
    AGD = "AGD"  # Nesterov-style accelerated GD (src/naive.py:116-122)
    ADAM = "ADAM"


class ModelKind(str, enum.Enum):
    LOGISTIC = "logistic"
    LINEAR = "linear"
    MLP = "mlp"  # two-layer tanh MLP (models/mlp.py)
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
    seed: int = 0  # data, generator matrix and the port's own params init
    # DATA dtype: bfloat16 halves the bytes the gradient pass streams; params
    # and optimizer updates always run in float32
    dtype: str = "float32"
    # the fused GLM gradient kernel (ops/kernels.fused_glm_grad): "auto" and
    # "on" (both kept for parity with the JAX package) route a GLM's stack
    # through it unless layer_coding is "on"; "on" needs a GLM; "off" takes
    # the two-pass PyTorch gradient
    use_pallas: str = "auto"
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
    # per-round collection deadline in simulated seconds (scheme="deadline")
    deadline: Optional[float] = None
    # decode-weight policy (arXiv:2006.09638): "fixed" keeps the scheme's own
    # collection weights; "optimal" refits them per round by least squares
    # to the actual arrival set over the layout's effective coding matrix
    # (parallel/collect.optimal_decode_schedule). Schemes without an
    # optimal_decode hook (the partial two-part layouts) keep their fixed
    # weights
    decode: str = "fixed"

    def __post_init__(self):
        self.scheme = as_scheme(self.scheme)
        self.model = ModelKind(self.model)
        self.update_rule = UpdateRule(self.update_rule)
        self.compute_mode = ComputeMode(self.compute_mode)
        if self.use_pallas not in ("auto", "on", "off"):
            raise ValueError(
                f"use_pallas must be auto/on/off, got {self.use_pallas!r}"
            )
        if self.layer_coding not in ("auto", "on", "off"):
            raise ValueError(
                f"layer_coding must be auto/on/off, got {self.layer_coding!r}"
            )
        if self.layer_coding == "on" and self.use_pallas == "on":
            raise ValueError(
                "layer_coding='on' and use_pallas='on' both force a "
                "gradient lowering; force at most one"
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
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"dtype must be float32/bfloat16, got {self.dtype!r}"
            )
        if self.decode not in ("fixed", "optimal"):
            raise ValueError(
                f"decode must be fixed/optimal, got {self.decode!r}"
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
            "update_rule": self.update_rule.value,
            "dtype": self.dtype,
            "layer_coding": self.layer_coding,
            "block_decode": self.block_decode,
            "deep_layers": self.deep_layers,
        }

    def static_signature(self) -> tuple:
        """The values of :meth:`static_signature_fields`, as a tuple."""
        return tuple(self.static_signature_fields().values())

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
