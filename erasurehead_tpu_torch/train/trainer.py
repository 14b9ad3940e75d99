"""The synchronous trainer: a Python loop over rounds on one device.

The counterpart of erasurehead_tpu/train/trainer.py::train, of its
trajectory-cohort engine (train_cohort, train_batch; see
:func:`train_cohort`), of its on-device-control-plane trainer
(:func:`train_dynamic`: arrivals, masks and decode weights computed on the
device inside the round) and of its measured-arrival trainer
(:func:`train_measured`: each worker's message timed, the collection rule
fed online). Control plane
(host, float64, precomputed, tiny): straggler arrival schedule, per-round
collection/decode weights, learning-rate schedule. Data plane (the device):
per round, the decoded gradient of the stack (parallel/step.py) and the
GD/AGD/Adam update; the iterate history stays on the device.

Which gradient lowering a round takes (the JAX trainer's dispatch,
erasurehead_tpu/train/trainer.py:934-985, on one device):
  - ``margin_flat`` and then ``flat_grad`` may swap in their lowering
    (step.make_margin_flat_grad_fn, step.make_flat_grad_fn): "on" forces
    it and raises where the model or stack cannot take it, "auto" resolves
    per stack kind (a FieldOnehot stack takes the flat lowering);
  - a GLM on a dense stack with ``use_pallas`` "auto" (the default) or "on"
    routes the stack through the fused kernel (ops/kernels.fused_glm_grad,
    one launch per round on CUDA) and raises where it declines, unless
    ``layer_coding`` is "on" or, under "auto", a forced ``flat_grad`` or
    ``margin_flat`` lowering was asked for (where the JAX package's "auto"
    declines the kernel off the TPU, so the forced lowering is what it
    runs); ``use_pallas="on"`` on any other model or stack raises, as does
    ``use_pallas="on"`` with ``flat_grad="on"``. Under "auto" a cached
    ``glm_fused`` verdict of "xla" at the stack's shape on this device
    (tune/) keeps the two-pass gradient instead. A sparse (PaddedRows,
    FieldOnehot) or int8 (QuantizedStack) stack is not a dense tensor:
    under "auto" it takes its own lowering and no kernel;
  - otherwise ``layer_coding`` "on" (or "auto" under a cached
    ``layer_coding`` verdict of "blockwise") takes the blockwise decode
    (step.make_layer_block_grad_fn): per-slot gradient trees decoded in
    place by the decode kernel (ops/kernels.fused_block_decode_leaves), one
    launch per round for all leaves ("fused") or for the packed block table
    ("treewise"; ``block_decode`` "auto" walks step.resolve_block_decode's
    ladder);
  - otherwise the monolithic PyTorch gradient (step.make_faithful_grad_fn /
    make_deduped_grad_fn).

Params are the GLM's [F] tensor or the deep families' dict of tensors; the
iterate history is then an [R, F] tensor or a dict of [R, ...] tensors.

Checkpoint/resume (:func:`train`'s ``checkpoint_dir``, ``checkpoint_every``
and ``resume``; train/checkpoint.py): the round loop runs in chunks of
``checkpoint_every`` rounds with a save between chunks, and a resumed run
starts at the restored round; its history covers [start_round, rounds).

The device data stack comes through the sweep engine's data cache
(train/cache.get_or_build_data), keyed like the JAX package's upload plus
the device: repeated runs over one dataset object reuse the stack.

Out-of-core streaming (``cfg.stack_residency``, data/store.py,
data/prefetch.py): the stack lives in an on-disk shard store. A window
covering every partition trains the resident loop on the store's rows
(bitwise the resident run); a smaller one trains block by block
(:func:`_train_streamed`, :func:`_train_cohort_streamed`), a window of
partitions staged per chunk of rounds behind the previous chunk's compute,
the round's gradient taking the same lowering ladder over the window.

Pipelined training (``cfg.pipeline_depth=1``, parallel/pipeline.py): the
schedule is the pipelined recurrence over the same arrivals, and the loop
carries a second params slot, so round r's gradient is taken at the params
that entered round r-1 (rounds 0 and 1 both at p0) while the update applies
to the live state.

Run telemetry (obs/): with a capture (obs/events.capture) or an observer
installed, each trainer emits its typed records as the JAX package's do
(run_start, data_upload, compile, the chunked rounds/decode, run_end,
dispatch_ahead for a pipelined run, critical_path; a cohort's one cohort
record and its trajectory-tagged streams; a streamed run's prefetch and io
records), all after the timed round loop, from host arrays the run already
holds: telemetry adds no launch, no host read and no synchronise to a round,
and a run with it on is bitwise the run with it off. The round loop names
its phases (``eh_scan/coded_step``, ``eh_scan/update``; utils/tracing.annotate)
for a ``--trace-dir`` trace. The port's ``compile`` record is its one compile
step: the kernel library's build and load (kernels.load_library), its
seconds in this call and whether it was loaded already. ``train_dynamic``
emits nothing, as in the JAX package.

Timing artifacts keep two clocks apart, as the JAX package does:
  - ``timeset``/``worker_times``: *simulated* cluster seconds from the
    arrival model;
  - ``wall_time``/``steps_per_sec``: real seconds of the round loop, between
    two ``torch.cuda.synchronize()`` calls on the card (the kernel library is
    built and loaded, and ``torch.func`` imported, before the clock starts).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from erasurehead_tpu_torch import schemes, tune
from erasurehead_tpu_torch.data import sharding as sharding_lib
from erasurehead_tpu_torch.data import store as store_lib
from erasurehead_tpu_torch.data.prefetch import Prefetcher
from erasurehead_tpu_torch.data.sharding import (
    partition_stack,
    plan_stream_windows,
    worker_stack,
)
from erasurehead_tpu_torch.data.synthetic import Dataset
from erasurehead_tpu_torch.models.attention import AttentionModel
from erasurehead_tpu_torch.models.deep_mlp import DeepMLPModel
from erasurehead_tpu_torch.models.glm import LinearModel, LogisticModel, params_from_numpy
from erasurehead_tpu_torch.models.mlp import MLPModel
from erasurehead_tpu_torch.models.moe import MoEModel
from erasurehead_tpu_torch.obs import critical_path as obs_cpath
from erasurehead_tpu_torch.obs import decode as obs_decode
from erasurehead_tpu_torch.obs import events as obs_events
from erasurehead_tpu_torch.ops import blocks, codes, kernels
from erasurehead_tpu_torch.ops import features as features_lib
from erasurehead_tpu_torch.parallel import collect, pipeline as pipeline_lib
from erasurehead_tpu_torch.parallel import step as step_lib, straggler
from erasurehead_tpu_torch.train import cache as cache_lib
from erasurehead_tpu_torch.train import checkpoint as ckpt_lib
from erasurehead_tpu_torch.train import optimizer
from erasurehead_tpu_torch.utils import chaos as chaos_lib
from erasurehead_tpu_torch.utils.config import (
    STREAM_WINDOW_ENV,
    ComputeMode,
    ModelKind,
    PipelineRefusal,
    RunConfig,
    resolve_arrival_trace,
    resolve_stream_budget,
)
from erasurehead_tpu_torch.utils.device import resolve_device
from erasurehead_tpu_torch.utils.tracing import annotate


def build_layout(cfg: RunConfig) -> codes.CodingLayout:
    """Scheme -> layout through its registry descriptor
    (erasurehead_tpu_torch/schemes/)."""
    return schemes.get(cfg.scheme).build_layout(cfg)


def build_schedule(
    cfg: RunConfig, t: np.ndarray, layout: codes.CodingLayout
) -> collect.CollectionSchedule:
    """The scheme's collection schedule over the arrival matrix ``t``,
    through its registry descriptor. ``cfg.decode == "optimal"`` refits the
    decode weights per round to the actual arrival set on schemes with an
    ``optimal_decode`` hook; the partial two-part layouts keep their fixed
    weights."""
    return collect.build_schedule(
        cfg.scheme, t, layout, num_collect=cfg.num_collect,
        deadline=cfg.deadline, decode=cfg.decode,
    )


def build_model(cfg: RunConfig):
    if cfg.model == ModelKind.LOGISTIC:
        return LogisticModel()
    if cfg.model == ModelKind.LINEAR:
        return LinearModel()
    if cfg.model == ModelKind.MLP:
        return MLPModel()
    if cfg.model == ModelKind.ATTENTION:
        return AttentionModel(sp_form=cfg.sp_form)
    if cfg.model == ModelKind.DEEPMLP:
        # cfg.deep_layers sweeps the family's depth (0 = model default)
        if cfg.deep_layers:
            return DeepMLPModel(n_layers=cfg.deep_layers)
        return DeepMLPModel()
    if cfg.model == ModelKind.MOE:
        return MoEModel()
    raise ValueError(f"unknown model {cfg.model}")


def default_arrivals(cfg: RunConfig) -> np.ndarray:
    """The run's default straggler arrival schedule, the one home that
    train(), train_cohort() and the harness share.

    ``ERASUREHEAD_REGIME`` (utils/chaos.py) arms a deterministic mid-run
    straggler-regime shift on top of the drawn delays; unset, the schedule
    is the stationary reference stream. ``cfg.arrival_trace`` (or
    ``ERASUREHEAD_ARRIVAL_TRACE``) replays a recorded per-round arrival
    trace instead of the drawn exponential stream
    (straggler.replay_arrival_trace); ``cfg.worker_speed_spread`` then
    composes as the seeded per-worker multiplier ON the trace rows, and
    ``cfg.compute_time`` with the spread as the arrival model's compute
    term (straggler.model_from_config)."""
    trace = resolve_arrival_trace(cfg.arrival_trace)
    model = straggler.model_from_config(cfg)
    # the compute-time model's seeded per-worker speeds, applied
    # multiplicatively to the recorded delays
    trace_speed = model.worker_speed if trace is not None and model is not None else None
    regime = chaos_lib.active_regime()
    regime_workers = None
    if regime is not None and regime.kind == "targeted":
        # the attacked set is a property of this config's layout
        regime_workers = straggler.targeted_workers(build_layout(cfg), regime.group)
    return straggler.arrival_schedule(
        cfg.rounds, cfg.n_workers, cfg.add_delay, cfg.delay_mean,
        arrival_model=model,
        regime=regime,
        trace=trace,
        trace_speed=trace_speed,
        regime_workers=regime_workers,
    )


@dataclasses.dataclass
class TrainResult:
    """Everything the reference's master holds at the end of a run."""

    # [rounds, F] on the run's device (the betaset), or a dict of [rounds, ...]
    params_history: object
    final_params: object  # [F], or a dict of tensors
    timeset: np.ndarray  # [rounds] simulated iteration wall-clock
    worker_times: np.ndarray  # [rounds, W] simulated arrivals, -1 sentinel
    collected: np.ndarray  # [rounds, W]
    sim_total_time: float  # sum of timeset, the reference's elapsed clock
    wall_time: float  # real seconds of the round loop
    steps_per_sec: float
    n_train: int
    # the first round the history covers: 0, or a resumed run's restored
    # round (the control-plane arrays always cover the whole run)
    start_round: int = 0
    config: RunConfig = None
    layout: codes.CodingLayout = None
    final_state: optimizer.OptState = None
    # [rounds] per-round decode-error norm ||pw - 1||/sqrt(P) (obs/decode.py)
    decode_error: Optional[np.ndarray] = None
    # the round's gradient lowering: "fused", "layer_block", "flat",
    # "margin_flat" or "per_slot" (a cohort member: the cohort's lowering;
    # train_measured: "measured", per-worker messages and the decode kernel)
    lowering: str = "per_slot"
    # a cohort member's dispatch (train_cohort): cohort_size,
    # cohort_lowering, cohort_dispatches, stack_mode; None for train()
    cohort: Optional[dict] = None
    # the data cache's telemetry for this run (train/cache.py): enabled,
    # data_hit, bytes_reused, stack_bytes, setup_seconds (host seconds from
    # the call to the round loop's clock), stack_mode, pipeline_depth and
    # pipeline_params_slot_bytes; a cohort member's also holds the cohort
    # fields
    cache_info: Optional[dict] = None
    # the collection schedule the run decoded with: a parallel/pipeline.
    # PipelinedSchedule (dispatch, done, dispatch_ahead, staleness) when
    # pipelined
    schedule: object = None
    # the event-log run id (obs/events.py) when a capture or an observer was
    # installed, else None
    run_id: Optional[str] = None

    @property
    def fused(self) -> bool:
        """Did the round loop go through the fused GLM kernel's wrapper?"""
        return self.lowering == "fused"

    @property
    def layer_coded(self) -> bool:
        """Did it take the blockwise (layer-coded) decode?"""
        return self.lowering in ("layer_block", "layer_block_vmap")


def _torch_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _to_device(a: np.ndarray, device, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


def _build_stack(cfg: RunConfig, dataset: Dataset, layout, faithful: bool, dev):
    """The run's data stack, moved to the device: worker-major
    [W, S, rows, F] (faithful) or partition-major [P, rows, F], its labels,
    and the training row count (the JAX package's shard_run_data on one
    device). A CSR dataset stacks as PaddedRows or FieldOnehot per
    ``cfg.sparse_format``; under ``stack_dtype="int8"`` the partition-major
    stack is quantized before the worker-major gather
    (ops/features.QuantizedStack), so every slot holds its partition's int8
    values and scales; an int8 shard store's dataset brings its write-time
    tables (``_store_prequantized``), which are taken as they are."""
    Xp_h, yp_h = partition_stack(dataset, layout.n_partitions, cfg.sparse_format)
    stack_dtype = cfg.resolve_stack_dtype()
    if stack_dtype == "int8":
        if not isinstance(Xp_h, np.ndarray):
            raise ValueError(
                "stack_dtype='int8' quantizes dense stacks only; this "
                f"dataset builds a {type(Xp_h).__name__} sparse stack — "
                "use stack_dtype float32/bfloat16 (or auto) with sparse "
                "features"
            )
        # an int8 shard store (data/store.py) quantized at write time: its
        # (q, scale) tables are reused as they are (quantizing the
        # dequantized rows again would not be bitwise stable)
        pre = getattr(dataset, "_store_prequantized", None)
        if pre is not None:
            if pre.q.shape[:1] != (layout.n_partitions,):
                raise ValueError(
                    f"shard store holds {pre.q.shape[0]} partitions; this "
                    f"layout needs {layout.n_partitions} — rewrite the "
                    f"store with the run's partition count"
                )
            Xp_h = features_lib.QuantizedStack(np.asarray(pre.q), np.asarray(pre.scale))
        else:
            Xp_h = features_lib.QuantizedStack.quantize(Xp_h)
    Xh, yh = worker_stack(layout, Xp_h, yp_h) if faithful else (Xp_h, yp_h)
    # the data dtype: the stored float dtype, or cfg.dtype under int8
    data_dtype = _torch_dtype(cfg.dtype if stack_dtype == "int8" else stack_dtype)
    X = features_lib.to_device(Xh, dev, data_dtype)
    # labels ride along the data dtype (as in the JAX package), then stay
    # float32 for the residual
    y = _to_device(yh, dev, data_dtype).float()
    return X, y, yp_h.size


def _device_stack(cfg: RunConfig, dataset: Dataset, layout, faithful: bool, dev):
    """:func:`_build_stack` through the data cache: ``(X, y, n_train,
    hit)``. The key is the JAX package's upload key (dataset identity, the
    layout's stacking signature with the storage, the partition count) plus
    the device, so a CPU run never receives a card stack. A FieldOnehot
    stack takes the run's ``fields_margin``/``fields_scatter``/
    ``sparse_lanes`` after the lookup: the lowering is not part of the
    cached stack."""
    key = (
        "stacks",
        cache_lib.dataset_token(dataset),
        _stack_signature(cfg, layout),
        layout.n_partitions,
        str(dev),
    )
    (X, y, n_train), hit = cache_lib.get_or_build_data(
        key, lambda: _build_stack(cfg, dataset, layout, faithful, dev)
    )
    if isinstance(X, features_lib.FieldOnehot):
        X = X.with_lowering(cfg.fields_margin, cfg.fields_scatter, cfg.sparse_lanes)
    return X, y, n_train, hit


def resolved_stack(cfg: RunConfig, dataset: Dataset, device=None):
    """``(model, X)`` exactly as :func:`train` resolves them on ``device``:
    the worker-major stack for faithful runs, the partition-major stack for
    deduped runs, through the data cache (so a race's thunks then hit it).
    The shape the tune plane races and resolves under (tune/races.py): the
    decision cache keys on ``tune.run_shape_signature(model, X)`` of THIS
    pair, so races and warm-run resolutions can never key apart."""
    dev = resolve_device(device)
    faithful = cfg.compute_mode == ComputeMode.FAITHFUL
    X, _, _, _ = _device_stack(cfg, dataset, build_layout(cfg), faithful, dev)
    return build_model(cfg), X


def _cache_info(cfg: RunConfig, hit: bool, stats_before: dict, X, y, faithful: bool,
                setup_seconds: float, final_params, residency: str) -> dict:
    """A run's ``TrainResult.cache_info`` (the JAX trainer's, without the
    executable cache's fields)."""
    return {
        "residency": residency,
        "enabled": cache_lib.enabled(),
        "data_hit": hit,
        "bytes_reused": cache_lib.stats().bytes_reused - stats_before["bytes_reused"],
        "stack_bytes": cache_lib.device_nbytes((X, y)),
        "setup_seconds": setup_seconds,
        "stack_mode": "materialized" if faithful else "deduped",
        "pipeline_depth": cfg.pipeline_depth,
        "pipeline_params_slot_bytes": (
            cache_lib.device_nbytes(final_params) if cfg.pipeline_depth else 0
        ),
    }


def _prepare_sparse(X, grad_fn, params, y, weights) -> None:
    """Build a sparse stack's scatter plans and fused codes before the
    clock starts: one untimed gradient (its result is dropped). They are
    statics of the stack, built at first use (ops/features._Segments), and
    the kernels never see a sparse stack, so no launch is counted."""
    if isinstance(X, (features_lib.PaddedRows, features_lib.FieldOnehot)):
        grad_fn(params, X, y, weights)


def _round_weights(layout, slot_w: np.ndarray, faithful: bool) -> np.ndarray:
    """A run's [R, W, S] slot weights as its stack takes them: as they are
    (faithful) or folded per partition, [R, P] (deduped)."""
    return slot_w if faithful else layout.fold_slot_weights(slot_w)


def _check_layer_coding(cfg: RunConfig, model) -> None:
    if cfg.layer_coding == "on" and not step_lib.supports_layer_coding(model):
        raise ValueError(
            "layer_coding='on' needs a model whose per-slot gradients are "
            "exact (no model-internal mesh axes) - got "
            f"model={getattr(model, 'name', type(model).__name__)!r}"
        )


def _model_name(model) -> str:
    return getattr(model, "name", type(model).__name__)


def _apply_margin_flat(cfg: RunConfig, model, X, grad_fn):
    """Swap in the hybrid dense lowering per ``cfg.margin_flat``: "on"
    forces it (raising off the dense closed-form path), "auto" defers to
    step.resolve_margin_flat. Returns (grad_fn, swapped)."""
    if cfg.margin_flat == "on" and not step_lib.supports_margin_flat(model, X):
        raise ValueError(
            "margin_flat='on' needs a closed-form GLM on a dense stack; "
            f"got model={_model_name(model)!r}, X={type(X).__name__}"
        )
    if step_lib.resolve_margin_flat(cfg.margin_flat, model, X):
        return step_lib.make_margin_flat_grad_fn(model), True
    return grad_fn, False


def _apply_flat_grad(cfg: RunConfig, model, X, grad_fn):
    """Swap in the flat-stack lowering per ``cfg.flat_grad``: "on" forces
    it (raising off the closed-form path), "auto" defers to
    step.resolve_flat_grad. Returns (grad_fn, swapped)."""
    if cfg.flat_grad == "on" and not step_lib.supports_flat_grad(model, X):
        raise ValueError(
            "flat_grad='on' needs a closed-form GLM (logistic/linear) on a "
            "dense, PaddedRows, or FieldOnehot stack; "
            f"got model={_model_name(model)!r}, X={type(X).__name__}"
        )
    if step_lib.resolve_flat_grad(cfg.flat_grad, model, X):
        return step_lib.make_flat_grad_fn(model), True
    return grad_fn, False


def _apply_layer_coding(cfg: RunConfig, model, X, grad_fn, params_template, faithful: bool):
    """Swap in the blockwise decode (step.make_layer_block_grad_fn) per
    ``cfg.layer_coding``; ``cfg.block_decode`` picks its lowering. Both
    resolve "auto" through the tune cache at the stack ``X``'s signature.
    Returns (grad_fn, layer_coded)."""
    _check_layer_coding(cfg, model)
    if not step_lib.resolve_layer_coding(cfg.layer_coding, model, X):
        return grad_fn, False
    spec = blocks.model_block_spec(model, params_template)
    fused = step_lib.resolve_block_decode(cfg.block_decode, model, X)
    return step_lib.make_layer_block_grad_fn(
        model, spec, faithful=faithful, fused=fused
    ), True


def _fused_wins(cfg: RunConfig, model, X) -> bool:
    """Does a dense GLM stack take B1? Always under ``use_pallas="on"``;
    under "auto", unless a cached ``glm_fused`` verdict at this stack's
    shape on this device says the two-pass gradient ("xla") won. The
    fallback is B1 ("pallas"), the port's measured default at the main
    shape."""
    if cfg.use_pallas == "on":
        return True
    sig = tune.glm_fused_signature(X.shape, X.dtype, model.name)
    kind = tune.default_device_kind(X.device)
    choice = tune.lookup("glm_fused", sig, device_kind=kind, fallback="pallas")
    if choice == "xla":
        _warn_pallas_declined(
            f"use_pallas='auto' declines the fused kernel: the cached glm_fused "
            f"verdict at {sig} on {kind} is 'xla' (the two-pass gradient)"
        )
    return choice != "xla"


#: reasons already recorded as use_pallas_declined warnings (one record per
#: distinct reason per process: the auto gate runs on every train() call)
_pallas_declined_seen: set = set()


def _warn_pallas_declined(reason: str) -> None:
    if reason in _pallas_declined_seen:
        return
    _pallas_declined_seen.add(reason)
    obs_events.emit("warning", kind="use_pallas_declined", message=reason)


def _grad_lowering(cfg: RunConfig, model, X, faithful: bool, params0):
    """The round's gradient fn over the stack ``X`` and the name of its
    lowering, by the ladder of the module docstring: margin-flat, then
    flat, then the fused kernel, then the blockwise decode, else the
    per-slot form. A streamed window takes the same ladder over its own
    stack."""
    if faithful:
        grad_fn = step_lib.make_faithful_grad_fn(model)
    else:
        grad_fn = step_lib.make_deduped_grad_fn(model)
    lowering = "per_slot"
    grad_fn, swapped = _apply_margin_flat(cfg, model, X, grad_fn)
    lowering = "margin_flat" if swapped else lowering
    grad_fn, swapped = _apply_flat_grad(cfg, model, X, grad_fn)
    lowering = "flat" if swapped else lowering
    if cfg.use_pallas != "off":
        if cfg.use_pallas == "on" and cfg.flat_grad == "on":
            raise ValueError(
                "use_pallas='on' and flat_grad='on' are mutually exclusive "
                "gradient lowerings; force at most one"
            )
        dense_glm = model.name in kernels.GLM_KINDS and isinstance(X, torch.Tensor)
        # under "auto" a forced flat/margin-flat lowering wins over the
        # kernel, as does a forced blockwise decode
        forced = cfg.use_pallas == "on" or "on" not in (cfg.flat_grad, cfg.margin_flat)
        if dense_glm and cfg.layer_coding != "on" and forced and _fused_wins(cfg, model, X):
            reason = kernels.unsupported_reason(X.reshape((-1,) + tuple(X.shape[-2:])))
            if reason is not None:  # no quiet fallback to the two-pass gradient
                raise ValueError(
                    f"the fused kernel declines this stack ({reason}); "
                    "use_pallas='off' takes the two-pass gradient"
                )
            grad_fn = step_lib.make_fused_grad_fn(model.name)
            lowering = "fused"
        elif cfg.use_pallas == "on":
            raise ValueError(
                "use_pallas='on' needs a dense logistic/linear stack; "
                f"got model={model.name!r}, X={type(X).__name__}"
            )
    if lowering != "fused":
        grad_fn, layer_coded = _apply_layer_coding(cfg, model, X, grad_fn, params0, faithful)
        lowering = "layer_block" if layer_coded else lowering
    return grad_fn, lowering


def _load_kernels(dev, needed: bool) -> tuple:
    """The port's one compile step: build and load the kernel library
    (kernels.load_library) when a run on the card launches a kernel.
    Returns ``(seconds spent here, hit)``, ``hit`` True when nothing was
    built or loaded in this call (the library was loaded already, or the
    run needs none): the ``compile`` record's fields."""
    if dev.type != "cuda" or not needed or kernels.library_loaded():
        return 0.0, True
    t0 = time.perf_counter()
    kernels.load_library()
    return time.perf_counter() - t0, False


def _prepare_lowering(dev, model, lowering: str, grad_fn, X, y, params0, w0) -> tuple:
    """Set-up before the clock starts: build the kernels, import
    torch.func, build a sparse stack's scatter plans. Returns the compile
    step's ``(seconds, hit)`` (:func:`_load_kernels`)."""
    compiled = _load_kernels(dev, lowering in ("fused", "layer_block"))
    if lowering == "layer_block" or getattr(model, "grads_via_loss", False):
        step_lib.warm_autodiff()
    _prepare_sparse(X, grad_fn, params0, y, w0)
    return compiled


# ---------------------------------------------------------------------------
# run telemetry: the records every trainer emits after its timed loop


def _history_update_norms(history) -> np.ndarray:
    """[R-1] L2 norms of successive iterate differences, host float64: the
    gradient-magnitude proxy the ``rounds`` chunks carry. Read from the
    history the run already holds, after the loop; entry j is the step into
    round j+1 of the covered window."""
    leaves = blocks.tree_leaves(history)
    if not leaves or int(leaves[0].shape[0]) < 2:
        return np.zeros(0)
    total = None
    for leaf in leaves:
        a = np.asarray(leaf.detach().cpu(), dtype=np.float64)
        d = a[1:] - a[:-1]
        sq = (d.reshape(d.shape[0], -1) ** 2).sum(axis=1)
        total = sq if total is None else total + sq
    return np.sqrt(total)


def _mesh_signature(dev) -> tuple:
    """The one-device mesh in the shape of the JAX package's
    cache.mesh_signature at world size 1: axes, sizes, device ids."""
    return (("workers",), (1,), (dev.index or 0,))


def _emit_run_start(run_id, cfg: RunConfig, dev, lowering: str, stack_mode: str,
                    data_bytes: int, data_hit: bool, compiled: tuple, chunk_rounds: int,
                    cohort: Optional[dict] = None) -> None:
    """A run's opening records, as the JAX trainer emits them: run_start,
    data_upload, the cohort record of a cohort, then the compile record of
    the port's one compile step."""
    obs_events.emit(
        "run_start",
        run_id=run_id,
        scheme=cfg.scheme.value,
        model=cfg.model.value,
        platform=dev.type,
        config_hash=obs_events.config_hash(cfg),
        mesh=_mesh_signature(dev),
        lowering=lowering,
        static_signature=cfg.static_signature_fields(),
        n_workers=cfg.n_workers,
        n_stragglers=cfg.n_stragglers,
        rounds=cfg.rounds,
        compute_mode=cfg.compute_mode.value,
        stack_mode=stack_mode,
        dtype=cfg.dtype,
        stack_dtype=cfg.resolve_stack_dtype(),
    )
    obs_events.emit(
        "data_upload", run_id=run_id, bytes=int(data_bytes),
        cache_hit=data_hit, ring=False,
    )
    if cohort is not None:
        obs_events.emit("cohort", run_id=run_id, **cohort)
    if compiled is not None:
        seconds, hit = compiled
        obs_events.emit(
            "compile", run_id=run_id, seconds=round(seconds, 4), cache_hit=hit,
            chunk_rounds=chunk_rounds, memory_analysis=None,
        )


def _exec_fields(compiled: tuple) -> dict:
    """run_end's cache fields: the compile step as one hit or one miss."""
    seconds, hit = compiled
    return {
        "exec_hits": int(hit), "exec_misses": int(not hit),
        "compile_seconds": round(seconds, 4),
    }


def _emit_stream_records(run_id, records: list) -> None:
    """A streamed run's staging records (data/prefetch.Prefetcher.records):
    per staged window in window order, what its read emitted (an ``io``)
    and its ``prefetch`` record."""
    for held, staged in records:
        obs_events.replay(held)
        obs_events.emit("prefetch", run_id=run_id, **staged)


def _state_on(state: optimizer.OptState, dev) -> optimizer.OptState:
    """A donor run's optimizer state on this run's device: a mid-schedule
    restart may carry it from another device (or from the host)."""

    def move(tree):
        return blocks.tree_map(lambda leaf: torch.as_tensor(leaf).to(dev), tree)

    mom = state.momentum
    mom = tuple(move(m) for m in mom) if isinstance(mom, tuple) else move(mom)
    return optimizer.OptState(params=move(state.params), momentum=mom)


def train(
    cfg: RunConfig,
    dataset: Dataset,
    *,
    device=None,
    init_params=None,
    arrivals: Optional[np.ndarray] = None,
    schedule: Optional[collect.CollectionSchedule] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: Optional[int] = None,
    resume: bool = False,
    initial_state: Optional[optimizer.OptState] = None,
    initial_round: int = 0,
) -> TrainResult:
    """Run one full training run for ``cfg`` on ``dataset``.

    ``device`` defaults to ``cuda`` and raises when there is no card;
    ``device="cpu"`` runs the same loop on the CPU, where the kernels take
    their plain PyTorch versions. ``init_params`` (an [F] array, or a dict
    of numpy arrays for the deep families) replaces the port's own seeded
    init, e.g. with a JAX run's draw for parity (models/glm.
    params_from_numpy).
    ``arrivals``/``schedule`` replace the default arrival draw and the
    scheme's collection rule.

    With ``checkpoint_dir`` and ``checkpoint_every`` set, the optimizer
    state and the next round are saved to ``checkpoint_dir/round_<N>``
    after every ``checkpoint_every`` rounds, never after the last
    (train/checkpoint.py); ``resume=True`` restarts from the newest usable
    checkpoint there (or from round 0, saying so on stderr, when there is
    none). ``params_history`` then covers only rounds [start_round, rounds);
    the control-plane arrays still cover the whole run, and
    ``steps_per_sec`` leaves the checkpoint I/O out.

    ``initial_state``/``initial_round`` start the run mid-schedule from an
    in-memory optimizer state instead of a checkpoint: the elastic restart
    hook (parallel/failures.train_elastic). Rounds ``initial_round``
    onward run with this config's layout while the state carries over (its
    leaves do not depend on the worker count); the history then covers
    [initial_round, rounds). Neither composes with ``resume``.

    ``cfg.pipeline_depth=1`` refuses ``checkpoint_dir``/``resume``,
    ``initial_state`` and a caller-provided ``schedule``
    (:class:`PipelineRefusal`): the stale params slot is in neither the
    checkpoint nor the donor state, and the pipelined schedule is derived
    here from the arrivals.

    ``cfg.stack_residency`` "streamed" (or "auto" under a
    ``ERASUREHEAD_STREAM_WINDOW`` budget) keeps the stack in a shard store
    (the dataset's own, from data/store.ShardStore.dataset, or one written
    to a temporary directory): a window covering every partition trains
    through this resident loop over the store's rows, bitwise the resident
    run; a smaller window trains block by block (:func:`_train_streamed`),
    which refuses ``pipeline_depth=1`` and a mid-schedule restart."""
    t_call = time.perf_counter()
    # a bare initial_round would otherwise silently run the whole horizon
    # from round 0; resume takes its start round from the checkpoint
    if initial_round != 0 and initial_state is None:
        raise ValueError(
            f"initial_round={initial_round} requires initial_state: a "
            "mid-schedule restart resumes from donor state (resume=True "
            "takes its start round from the checkpoint instead)"
        )
    if checkpoint_every is not None and checkpoint_every < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1, got {checkpoint_every}"
        )
    if cfg.pipeline_depth:
        # a mid-run restore would re-enter the loop with a fabricated stale
        # slot and silently fork the trajectory; journaled sweeps
        # (train/journal.py) are the kill -> resume path of pipelined runs
        if checkpoint_dir is not None or resume:
            raise PipelineRefusal(
                "checkpoint_restart",
                "pipeline_depth=1 refuses checkpoint_dir/resume: the "
                "stale params slot is not in the checkpoint contract, so "
                "a mid-run restore cannot reproduce the pipelined "
                "trajectory (use journaled sweep resume instead)",
            )
        if initial_state is not None:
            raise PipelineRefusal(
                "elastic_restart",
                "pipeline_depth=1 refuses initial_state/initial_round: an "
                "elastic mid-schedule restart carries no stale params "
                "slot, so the resumed pipelined trajectory would fork",
            )
        if schedule is not None:
            raise PipelineRefusal(
                "custom_schedule",
                "pipeline_depth=1 refuses a caller-provided schedule: the "
                "pipelined timing recurrence and the stale-gradient carry "
                "must agree, so the schedule is derived from the arrivals "
                "here (parallel/pipeline.pipelined_schedule), not passed in",
            )
    dev = resolve_device(device)
    # ---- stack residency (out-of-core streaming, data/store.py) -----------
    # a streamed run lives in a shard store; a window covering every
    # partition trains on the store's rows through the resident path below
    # (bitwise the resident run), a smaller one block by block
    # (_train_streamed)
    residency = _resolve_residency(cfg)
    if residency == "streamed":
        store = _ensure_store(cfg, dataset)
        window = _resolve_stream_window(cfg, store.n_partitions, store.partition_bytes())
        if window < store.n_partitions:
            if cfg.pipeline_depth:
                raise PipelineRefusal(
                    "streamed_window",
                    "pipeline_depth=1 refuses windowed streamed residency: "
                    "the block trainer re-enters the scan per window, and "
                    "threading the stale params slot across windows is "
                    "untested (a single-window streamed run — window "
                    "covering every partition — rides the resident "
                    "pipeline and composes)",
                )
            return _train_streamed(
                cfg, dataset, store, window, device=dev, init_params=init_params,
                arrivals=arrivals, schedule=schedule, checkpoint_dir=checkpoint_dir,
                resume=resume, initial_state=initial_state, initial_round=initial_round,
            )
        if getattr(dataset, "_sweep_cache_token", None) != store.cache_token:
            dataset = store.dataset()
    layout = build_layout(cfg)
    model = build_model(cfg)
    faithful = cfg.compute_mode == ComputeMode.FAITHFUL

    # ---- control plane (host, float64) ------------------------------------
    if arrivals is None:
        arrivals = default_arrivals(cfg)
    if schedule is None:
        if cfg.pipeline_depth:
            # the same drawn arrivals, the bounded-staleness dispatch
            # recurrence on top; it duck-types CollectionSchedule
            schedule = pipeline_lib.pipelined_schedule(cfg, arrivals, layout)
        else:
            schedule = build_schedule(cfg, arrivals, layout)
    decode_err = obs_decode.decode_error_series(layout, schedule.message_weights)
    slot_w = step_lib.expand_slot_weights(
        schedule.message_weights, layout.coeffs, np.asarray(layout.slot_is_coded)
    )  # [R, W, S]
    lr = cfg.resolve_lr_schedule()
    alpha = cfg.effective_alpha

    # ---- data plane: the stack moves to the device once --------------------
    stats_before = cache_lib.stats().snapshot()
    X, y, n_train, data_hit = _device_stack(cfg, dataset, layout, faithful, dev)
    weights = _to_device(_round_weights(layout, slot_w, faithful), dev, torch.float32)

    if init_params is None:
        params0 = model.init_params(cfg.seed, dataset.n_features, dev)
    else:
        params0 = params_from_numpy(init_params, dev)

    grad_fn, lowering = _grad_lowering(cfg, model, X, faithful, params0)
    compiled = _prepare_lowering(dev, model, lowering, grad_fn, X, y, params0, weights[0])
    run_id = obs_events.new_run_id() if obs_events.active() else None

    state = optimizer.init_state(params0, cfg.update_rule)
    start_round = 0
    if initial_state is not None:
        if resume:
            raise ValueError("pass either initial_state or resume, not both")
        if not 0 <= initial_round < cfg.rounds:
            raise ValueError(
                f"initial_round={initial_round} outside [0, {cfg.rounds})"
            )
        state = _state_on(initial_state, dev)
        start_round = initial_round
    if resume and checkpoint_dir:
        # restore_latest skips partially written or torn round_N
        # directories with a warning, falling back to the next-older one
        restored = ckpt_lib.restore_latest(checkpoint_dir, state)
        if restored is None:
            # loud, not fatal: a restart loop passes resume=True on its
            # first attempt, before any checkpoint exists
            print(
                f"train: resume requested but no usable checkpoint found "
                f"under {checkpoint_dir!r}; starting from round 0",
                file=sys.stderr,
            )
        else:
            state, start_round, _ = restored
    update_fn = optimizer.make_update_fn(cfg.update_rule)
    lr32 = lr.astype(np.float32)
    history = blocks.tree_map(
        lambda p: torch.empty(
            (max(cfg.rounds - start_round, 0),) + tuple(p.shape),
            dtype=torch.float32, device=dev,
        ),
        params0,
    )

    # the pipelined carry's second slot: the params the next round's
    # gradient is taken at, a copy so that nothing written to the live
    # params can reach it (rounds 0 and 1 both read p0)
    depth = cfg.pipeline_depth
    stale = blocks.tree_map(torch.clone, state.params) if depth else None

    # chunk boundaries [start, start + every, ..., rounds]: a save between
    # chunks, none after the last; the clock covers the rounds only
    step_len = checkpoint_every or max(cfg.rounds - start_round, 1)
    bounds = list(range(start_round, cfg.rounds, step_len)) + [cfg.rounds]
    wall = 0.0
    setup_seconds = None
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if setup_seconds is None:
            setup_seconds = t0 - t_call
        for i in range(lo, hi):
            # the absolute round index: AGD's theta and Adam's bias
            # correction read it, so a resumed run continues the count
            p_grad = step_lib.staleness_slot_params(state.params, stale, depth)
            with annotate("eh_scan/coded_step"):
                g = grad_fn(p_grad, X, y, weights[i])
            if depth:
                stale = state.params  # the params that entered this round
            with annotate("eh_scan/update"):
                state = update_fn(state, g, float(lr32[i]), alpha, n_train, float(i))
                blocks.tree_map(lambda h, p: h[i - start_round].copy_(p), history, state.params)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall += time.perf_counter() - t0
        if checkpoint_dir and checkpoint_every and hi < cfg.rounds:
            ckpt_lib.save(os.path.join(checkpoint_dir, f"round_{hi}"), state, hi)
    steps_per_sec = (cfg.rounds - start_round) / wall if wall > 0 else 0.0
    if run_id is not None:
        # after the timed loop, from host arrays and the history the run
        # already holds: the records never touch the loop
        _emit_run_start(run_id, cfg, dev, lowering,
                        "materialized" if faithful else "deduped",
                        cache_lib.device_nbytes((X, y)), data_hit, compiled,
                        cfg.rounds - start_round)
        obs_events.emit_round_chunks(
            run_id, start_round=start_round, timeset=schedule.sim_time,
            worker_times=schedule.worker_times, decode_error=decode_err,
            update_norm=_history_update_norms(history),
        )
        obs_events.emit(
            "run_end",
            run_id=run_id,
            wall_time_s=round(wall, 6),
            steps_per_sec=round(steps_per_sec, 4),
            sim_total_time_s=float(schedule.sim_time.sum()),
            data_cache_hit=data_hit,
            stack_bytes=cache_lib.device_nbytes((X, y)),
            arrival=obs_events.arrival_summary(schedule.worker_times[start_round:]),
            **_exec_fields(compiled),
            **obs_decode.summarize(decode_err),
        )
        if depth:
            # the overlap the pipeline bought, off the precomputed schedule
            obs_events.emit(
                "dispatch_ahead", run_id=run_id, first_round=start_round,
                n_rounds=int(cfg.rounds - start_round), pipeline_depth=int(depth),
                **pipeline_lib.overlap_summary(schedule),
            )
        obs_cpath.emit_event(run_id, obs_cpath.attribute(
            schedule.sim_time[start_round:], schedule.worker_times[start_round:],
            schedule.collected[start_round:], wall_s=wall,
            # a pipelined run never resumes, so its absolute clocks start
            # at round 0
            dispatch=getattr(schedule, "dispatch", None),
            done=getattr(schedule, "done", None),
        ))

    return TrainResult(
        params_history=history,
        final_params=state.params,
        timeset=schedule.sim_time,
        worker_times=schedule.worker_times,
        collected=schedule.collected,
        sim_total_time=float(schedule.sim_time.sum()),
        wall_time=wall,
        steps_per_sec=steps_per_sec,
        n_train=n_train,
        start_round=start_round,
        config=cfg,
        layout=layout,
        final_state=state,
        decode_error=decode_err,
        lowering=lowering,
        cache_info=_cache_info(cfg, data_hit, stats_before, X, y, faithful,
                               setup_seconds or 0.0, state.params, residency),
        schedule=schedule,
        run_id=run_id,
    )


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_dynamic(
    cfg: RunConfig,
    dataset: Dataset,
    *,
    device=None,
    init_params=None,
    initial_state: Optional[optimizer.OptState] = None,
    initial_round: int = 0,
    _sync_debug_mode: Optional[str] = None,
) -> TrainResult:
    """A run whose control plane lives on the device: each round's arrival
    times, collection mask and decode weights are tensors computed inside
    the round (parallel/dynamic.py), and nothing is read back to the host
    until the loop ends (the JAX package's train_dynamic, whose round is a
    step of one jitted scan).

    :func:`train` is the reference-parity path (the reference's MT19937
    delays, the float64 decode); this one draws JAX's threefry exponentials
    (utils/threefry.py), so its arrivals and collected sets are the JAX
    package's own ``train_dynamic``'s, and decodes with the scheme's
    dynamic rule: an MDS family through its float64-solved decode table
    (float32 on the device), or the float32 solve where the table would be
    too large (randreg, sparsegraph and expander collecting half of W = 30).
    Faithful compute mode only, as in the JAX package.

    Per round: the threefry draw (its key folded in from the seed and the
    round index on the host, as integers), the rule, the [W, S] slot
    weights (step.expand_slot_weights on the device), the gradient through
    :func:`_grad_lowering`'s ladder (a dense float GLM under
    ``use_pallas="auto"`` launches the fused kernel once a round, where
    the JAX package's has no kernel path; ``layer_coding="on"`` decodes
    with the decode kernel once a round), then the update. The round's
    clock, worker stamps and mask go into [R, W] device tensors copied to
    the host once, after the loop. ``lr`` and the round index stay host
    floats, as in :func:`train`.

    ``initial_state``/``initial_round`` are :func:`train`'s mid-schedule
    restart: the loop covers [initial_round, rounds); the telemetry rows
    before it carry zero time, -1 stamps and nothing collected, and the
    history has ``rounds - initial_round`` entries. ``init_params`` as in
    :func:`train`. No decode-error series: the weights never reach the
    host. ``_sync_debug_mode`` ("warn" or "error"), on the card, runs the
    round loop under ``torch.cuda.set_sync_debug_mode``: "error" raises at
    any operation that waits for the device (the check that the loop is
    free of host synchronisation)."""
    from erasurehead_tpu_torch.parallel import dynamic as dynamic_lib
    from erasurehead_tpu_torch.utils import threefry

    t_call = time.perf_counter()
    if initial_round != 0 and initial_state is None:
        raise ValueError(
            f"initial_round={initial_round} requires initial_state: a "
            "mid-schedule restart resumes from donor state"
        )
    if cfg.decode == "optimal":
        raise ValueError(
            "decode='optimal' refits collection weights on the host "
            "control plane (a per-round float64 lstsq); train_dynamic's "
            "weights are traced values inside the scan — use "
            "trainer.train() for optimal decoding"
        )
    if cfg.pipeline_depth:
        raise PipelineRefusal(
            "dynamic_rule",
            "pipeline_depth=1 has no on-device dynamic implementation: "
            "the pipelined dispatch recurrence lives on the host control "
            "plane (parallel/pipeline.py) — use trainer.train()",
        )
    dev = resolve_device(device)
    layout = build_layout(cfg)
    model = build_model(cfg)
    sched_fn = dynamic_lib.make_round_schedule_fn(
        cfg.scheme, layout, cfg.num_collect, cfg.delay_mean, cfg.add_delay,
        deadline=cfg.deadline, device=dev,
    )
    stats_before = cache_lib.stats().snapshot()
    X, y, n_train, data_hit = _device_stack(cfg, dataset, layout, True, dev)
    if init_params is None:
        params0 = model.init_params(cfg.seed, dataset.n_features, dev)
    else:
        params0 = params_from_numpy(init_params, dev)
    coeffs = _to_device(layout.coeffs, dev, torch.float32)
    slot_coded = torch.from_numpy(np.asarray(layout.slot_is_coded, dtype=bool)).to(dev)
    grad_fn, lowering = _grad_lowering(cfg, model, X, True, params0)
    _prepare_lowering(dev, model, lowering, grad_fn, X, y, params0, torch.zeros_like(coeffs))

    state = optimizer.init_state(params0, cfg.update_rule)
    start = 0
    if initial_state is not None:
        if not 0 <= initial_round < cfg.rounds:
            raise ValueError(
                f"initial_round={initial_round} outside [0, {cfg.rounds})"
            )
        state = _state_on(initial_state, dev)
        start = initial_round
    R, W = cfg.rounds, layout.n_workers
    n = R - start
    update_fn = optimizer.make_update_fn(cfg.update_rule)
    lr32 = cfg.resolve_lr_schedule().astype(np.float32)
    alpha = cfg.effective_alpha
    key = threefry.key(cfg.seed + 1)
    history = blocks.tree_map(
        lambda p: torch.empty((n,) + tuple(p.shape), dtype=torch.float32, device=dev), params0
    )
    sim = torch.empty(n, device=dev)
    wtimes = torch.empty((n, W), device=dev)
    collected = torch.empty((n, W), dtype=torch.bool, device=dev)

    guard = _sync_debug_mode is not None and dev.type == "cuda"
    _sync(dev)
    t0 = time.perf_counter()
    if guard:
        torch.cuda.set_sync_debug_mode(_sync_debug_mode)
    try:
        for j, i in enumerate(range(start, R)):
            rs = sched_fn(threefry.fold_in(key, i))
            slot_w = step_lib.expand_slot_weights(rs.message_weights.float(), coeffs, slot_coded)
            g = grad_fn(state.params, X, y, slot_w)
            state = update_fn(state, g, float(lr32[i]), alpha, n_train, float(i))
            blocks.tree_map(lambda h, p: h[j].copy_(p), history, state.params)
            sim[j] = rs.sim_time
            wtimes[j] = rs.worker_times
            collected[j] = rs.collected
    finally:
        if guard:
            torch.cuda.set_sync_debug_mode("default")
    _sync(dev)
    wall = time.perf_counter() - t0

    # telemetry padded to the whole horizon (train()'s restart contract):
    # rows before ``start`` belong to the donor phase
    timeset = np.zeros(R)
    timeset[start:] = sim.cpu().numpy()
    wt = -np.ones((R, W))
    wt[start:] = wtimes.cpu().numpy()
    col = np.zeros((R, W), dtype=bool)
    col[start:] = collected.cpu().numpy()
    return TrainResult(
        params_history=history,
        final_params=state.params,
        timeset=timeset,
        worker_times=wt,
        collected=col,
        sim_total_time=float(timeset.sum()),
        wall_time=wall,
        steps_per_sec=n / wall if wall > 0 else 0.0,
        n_train=n_train,
        start_round=start,
        config=cfg,
        layout=layout,
        final_state=state,
        lowering=lowering,
        cache_info=_cache_info(cfg, data_hit, stats_before, X, y, True, t0 - t_call,
                               state.params, "resident"),
    )


def _make_worker_msg(model):
    """One worker's transmitted message: its per-slot gradient stack over
    its [S, rows, ...] slots (a GLM's closed-form ``grad_sum`` takes the
    slot axis as it is, on every stack kind; the autodiff families go
    through step.per_slot_grads).

    ``n`` (the work multiplier) repeats the computation inside one chain:
    each repetition takes the previous message through a factor that is
    always exactly 1.0 but not provably so (the JAX package's dependence,
    trainer._make_worker_msg), so n-fold work is n-fold device time and
    the message is bitwise the one-fold message."""

    def one(params, Xs, ys):
        if getattr(model, "grads_via_loss", False):
            return step_lib.per_slot_grads(model, params, Xs, ys, 1)
        return model.grad_sum(params, Xs, ys)

    def worker_msg(params, Xs, ys, n=1):
        msg = one(params, Xs, ys)
        for _ in range(n - 1):
            s = blocks.tree_leaves(msg)[0].sum()
            dep = torch.where(torch.isnan(s), 1.0, torch.sign(torch.abs(s) + 1.0))
            msg = one(blocks.tree_map(lambda p: p * dep, params), Xs, ys)
        return msg

    return worker_msg


def train_measured(
    cfg: RunConfig,
    dataset: Dataset,
    *,
    device=None,
    init_params=None,
    work_multiplier=None,
    _clock=time.perf_counter,
) -> TrainResult:
    """Measured-arrival mode: every round, each logical worker's message is
    computed on its own and timed, and those times (plus the injected
    exponential delays when ``add_delay`` is on, as the reference's worker
    latency is compute plus sleep) feed the scheme's collection rule
    online, round by round (the JAX package's train_measured, single
    process). ``worker_times`` is then a measurement again, like the
    reference's Waitany stamps (src/naive.py:106).

    Workers are timed one after another on the run's device (pure compute
    heterogeneity): worker w's message is its per-slot gradient stack
    (:func:`_make_worker_msg`), timed on the host clock between two
    ``torch.cuda.synchronize`` calls, after every worker's computation was
    warmed up once before the clock. The collection is the host float64
    rule (parallel/collect.py via :func:`build_schedule`), and the decode
    of the W stacked messages with the [W, S] slot weights is one launch
    of the decode kernel (ops/kernels.fused_block_decode_leaves, the
    ``"ws"`` contraction the JAX package runs as an einsum); the CPU takes
    its plain version.

    ``work_multiplier``: optional [W] ints; worker w computes its message
    that many times in one chain, inducing real compute imbalance.
    ``_clock``: the per-worker clock (tests pass a deterministic one); the
    round loop's wall time always reads ``time.perf_counter``.

    Refused as in the JAX package: pipelining, the simulated heterogeneity
    knobs, deduped compute, the forced fused kernel and the forced flat
    lowerings, and schemes whose descriptor lacks ``supports_measured``
    (the partial two-part schemes). The JAX package's multi-device and
    multi-process measured paths have no counterpart on one card."""
    if cfg.pipeline_depth:
        raise PipelineRefusal(
            "measured_arrivals",
            "pipeline_depth=1 has no measured-arrival implementation: "
            "online per-round collection cannot overlap rounds whose "
            "arrivals it has not measured yet",
        )
    if cfg.compute_time or cfg.worker_speed_spread:
        raise ValueError(
            "arrival_mode='measured' measures real per-worker compute; "
            "simulated heterogeneity (compute_time/worker_speed_spread) "
            "does not apply — unset it or use the simulated trainer"
        )
    if cfg.compute_mode != ComputeMode.FAITHFUL:
        raise ValueError(
            "arrival_mode='measured' times each worker's own (redundant) "
            "slot compute; only compute_mode='faithful' is meaningful"
        )
    if cfg.use_pallas == "on":
        raise ValueError(
            "arrival_mode='measured' has no fused-kernel path; "
            "use use_pallas='auto' or 'off'"
        )
    if cfg.flat_grad == "on":
        raise ValueError(
            "arrival_mode='measured' times each worker's own message "
            "separately; the flat-stack lowering fuses all slots into one "
            "matmul and cannot be timed per worker — use flat_grad='auto' "
            "or 'off'"
        )
    if cfg.margin_flat == "on":
        raise ValueError(
            "arrival_mode='measured' times each worker's own message "
            "separately; the flat-margin lowering fuses all slots' margins "
            "into one matmul and cannot be timed per worker — use "
            "margin_flat='auto' or 'off'"
        )
    if not schemes.get(cfg.scheme).supports_measured:
        raise ValueError(
            "arrival_mode='measured' has no two-part message timing: the "
            "partial schemes send their uncoded part before the coded part "
            "is computed, and timing one combined dispatch would "
            "misattribute the arrival the mode exists to measure — use the "
            "simulated trainer for partial schemes"
        )
    if isinstance(device, (list, tuple)) or (
        torch.distributed.is_available() and torch.distributed.is_initialized()
        and torch.distributed.get_world_size() > 1
    ):
        raise ValueError(
            "arrival_mode='measured' runs one process on one device here; "
            "the multi-device queue replay and the multi-process cluster "
            "path are not ported (ROADMAP A9)"
        )
    dev = resolve_device(device)
    layout = build_layout(cfg)
    model = build_model(cfg)
    W = layout.n_workers
    mult = (
        np.ones(W, dtype=np.int64)
        if work_multiplier is None
        else np.asarray(work_multiplier, dtype=np.int64)
    )
    if mult.shape != (W,) or (mult < 1).any():
        raise ValueError(f"work_multiplier must be [W] ints >= 1, got {mult}")

    X, y, n_train, data_hit = _device_stack(cfg, dataset, layout, True, dev)
    if init_params is None:
        params0 = model.init_params(cfg.seed, dataset.n_features, dev)
    else:
        params0 = params_from_numpy(init_params, dev)
    run_id = obs_events.new_run_id() if obs_events.active() else None
    state = optimizer.init_state(params0, cfg.update_rule)
    update_fn = optimizer.make_update_fn(cfg.update_rule)
    lr32 = cfg.resolve_lr_schedule().astype(np.float32)
    alpha = cfg.effective_alpha
    coeffs = np.asarray(layout.coeffs)
    slot_coded = np.asarray(layout.slot_is_coded)
    keys = tuple(sorted(params0)) if isinstance(params0, dict) else None  # decode order
    worker_msg = _make_worker_msg(model)
    slices = [(features_lib.take_lead(X, w), y[w]) for w in range(W)]

    # warm every worker's computation before the clock (autodiff imports,
    # a sparse stack's scatter plans, the library's load): measured times
    # are then steady-state compute
    if dev.type == "cuda":
        kernels.load_library()
    step_lib.warm_autodiff()
    for w, (Xs, ys) in enumerate(slices):
        worker_msg(state.params, Xs, ys, n=int(mult[w]))
        _sync(dev)

    # the injected delay on top of the real compute, like the reference's
    # post-compute sleep (src/naive.py:140-149)
    delays = straggler.arrival_schedule(cfg.rounds, W, cfg.add_delay, cfg.delay_mean)
    timeset = np.zeros(cfg.rounds)
    worker_times = np.zeros((cfg.rounds, W))
    collected = np.zeros((cfg.rounds, W), dtype=bool)
    mw_rows = []
    history = blocks.tree_map(
        lambda p: torch.empty((cfg.rounds,) + tuple(p.shape), dtype=torch.float32, device=dev),
        params0,
    )
    _sync(dev)
    wall0 = time.perf_counter()
    for r in range(cfg.rounds):
        # the previous round's update off the device before worker 0's
        # clock opens, or its cost would be charged to worker 0
        _sync(dev)
        t_row = np.zeros(W)
        msgs = []
        for w, (Xs, ys) in enumerate(slices):
            t0 = _clock()
            m = worker_msg(state.params, Xs, ys, n=int(mult[w]))
            _sync(dev)
            t_row[w] = _clock() - t0
            msgs.append(m)
        sched = build_schedule(cfg, (t_row + delays[r])[None, :], layout)
        slot_w = step_lib.expand_slot_weights(sched.message_weights, coeffs, slot_coded)[0]
        leaves = [torch.stack(ls) for ls in zip(*(blocks.tree_leaves(m) for m in msgs))]
        g = blocks.tree_unflatten(
            keys, kernels.fused_block_decode_leaves(_to_device(slot_w, dev, torch.float32), leaves)
        )
        state = update_fn(state, g, float(lr32[r]), alpha, n_train, float(r))
        blocks.tree_map(lambda h, p: h[r].copy_(p), history, state.params)
        timeset[r] = sched.sim_time[0]
        worker_times[r] = sched.worker_times[0]
        collected[r] = sched.collected[0]
        mw_rows.append(sched.message_weights[0])
    _sync(dev)
    wall = time.perf_counter() - wall0
    decode_err = obs_decode.decode_error_series(
        layout, np.stack(mw_rows) if mw_rows else np.zeros((0, W))
    )
    steps_per_sec = cfg.rounds / wall if wall > 0 else 0.0
    if run_id is not None:
        # as the JAX package's measured trainer: no compile record
        _emit_run_start(run_id, cfg, dev, "measured", "materialized",
                        cache_lib.device_nbytes((X, y)), data_hit,
                        None, cfg.rounds)
        obs_events.emit_round_chunks(
            run_id, start_round=0, timeset=timeset, worker_times=worker_times,
            decode_error=decode_err,
        )
        obs_events.emit(
            "run_end",
            run_id=run_id,
            wall_time_s=round(wall, 6),
            steps_per_sec=round(steps_per_sec, 4),
            sim_total_time_s=float(timeset.sum()),
            arrival=obs_events.arrival_summary(worker_times),
            **obs_decode.summarize(decode_err),
        )
    return TrainResult(
        params_history=history,
        final_params=state.params,
        timeset=timeset,
        worker_times=worker_times,
        collected=collected,
        sim_total_time=float(timeset.sum()),
        wall_time=wall,
        steps_per_sec=steps_per_sec,
        n_train=n_train,
        config=cfg,
        layout=layout,
        final_state=state,
        decode_error=decode_err,
        lowering="measured",
        run_id=run_id,
    )


# ---------------------------------------------------------------------------
# out-of-core streaming: the stack in a shard store, a window of partitions
# on the device at a time (the JAX trainer's residency front and
# _train_streamed, one device)


def _resolve_residency(cfg: RunConfig) -> str:
    """The resolved stack residency: ``cfg.stack_residency``, where "auto"
    streams exactly when the host sets a device byte budget
    (:data:`STREAM_WINDOW_ENV`; without one streaming only adds staging)."""
    if cfg.stack_residency != "auto":
        return cfg.stack_residency
    return "streamed" if resolve_stream_budget() is not None else "resident"


def _ensure_store(cfg: RunConfig, dataset: Dataset):
    """The shard store behind a streamed run: the store the dataset was
    rebuilt from (ShardStore.dataset brands ``_shard_store``), else the
    in-memory dataset written once to a temporary store and branded, so
    every later run over the dataset shares it. A store must hold the run's
    partition count (partitions are grouped into shard files at write
    time) and, if quantized, serve an int8 run."""
    layout = build_layout(cfg)
    store = getattr(dataset, "_shard_store", None)
    if store is not None:
        if store.n_partitions != layout.n_partitions:
            raise ValueError(
                f"shard store at {store.directory!r} holds "
                f"{store.n_partitions} partitions; this run's layout needs "
                f"{layout.n_partitions} — rewrite the store "
                f"(data/prepare.py --store) with the run's partition count"
            )
        if store.quantized and cfg.resolve_stack_dtype() != "int8":
            raise ValueError(
                f"shard store at {store.directory!r} is quantized (int8); "
                f"this run resolves stack_dtype="
                f"{cfg.resolve_stack_dtype()!r} — training on the "
                "dequantized reconstruction would silently lose precision; "
                "use stack_dtype='int8' or rewrite the store as float32"
            )
        return store
    store = store_lib.write_store(
        dataset,
        tempfile.mkdtemp(prefix="eh-shard-store-"),
        layout.n_partitions,
        stack_dtype="int8" if cfg.resolve_stack_dtype() == "int8" else "float32",
    )
    dataset._shard_store = store
    return store


def _resolve_stream_window(cfg: RunConfig, n_partitions: int, partition_bytes: int) -> int:
    """Partitions per streamed window: ``cfg.stream_window``, else the
    :data:`STREAM_WINDOW_ENV` budget over two windows' bytes (the one
    computing and the one in flight), else every partition. A window below
    P is rounded down to a divisor of P, so every window has one shape."""
    P = int(n_partitions)
    if cfg.stream_window is not None:
        w = int(cfg.stream_window)
    else:
        budget = resolve_stream_budget()
        if budget is None:
            return P
        w = int(budget // max(1, 2 * int(partition_bytes)))
    if w >= P:
        return P
    w = max(1, w)
    while P % w:
        w -= 1
    return w


def _stream_remedy(cfg: RunConfig) -> str:
    """The remedy clause of a windowed-streaming refusal, naming the knob
    that put the run on the streamed path."""
    if cfg.stream_window is not None:
        return (
            "raise stream_window (--stream-window) to cover every "
            "partition, or run resident (stack_residency='resident')"
        )
    if resolve_stream_budget() is not None:
        return (
            f"raise the {STREAM_WINDOW_ENV} byte budget to cover every "
            "partition, or unset it to run resident"
        )
    return (
        "run this config resident (stack_residency='resident' or "
        "'auto' without a stream budget)"
    )


def _check_streamed_compat(cfg: RunConfig) -> None:
    """Refuse the knobs with no windowed body: the forced whole-stack
    kernel (``use_pallas="on"``) and the forced blockwise decode
    (``layer_coding="on"``), naming the knob that led to the streamed path.
    (The JAX package also refuses model-parallel meshes here; the port has
    no model axes.)"""
    if cfg.use_pallas == "on":
        raise ValueError(
            "use_pallas='on' forces the fused whole-stack kernel, which "
            "has no windowed streamed body; use use_pallas='auto'/'off', "
            f"or {_stream_remedy(cfg)}"
        )
    if cfg.layer_coding == "on":
        raise ValueError(
            "layer_coding='on' forces the blockwise decode, which has no "
            "windowed streamed body; use layer_coding='auto'/'off', "
            f"or {_stream_remedy(cfg)}"
        )


def _make_stream_put(plan, dev, quantize: bool, data_dtype: torch.dtype):
    """The host-to-device transfer of one staged window (it runs on the
    prefetch staging thread; the per-run and cohort streamed trainers share
    it). The staged partition-major span (window and halo, as
    ``read_ranges`` returns it) is copied as it is; a materialized faithful
    window then gathers the slot-group's worker-major ``[gw, S, rows, F]``
    view on the device through the plan's local assignment. (The JAX
    package gathers on the host and sends (s+1)x the bytes; a gather is
    exact, so the bits are the same.) An int8 store's window brings its
    ``(q, scale)``; a float32 window of an int8 run is quantized per
    partition on the host before the gather, as the resident path does.
    Labels take the data dtype and then float32, as in the resident stack.
    Every tensor is a fresh copy: the host buffers are refilled."""
    local = (
        torch.from_numpy(np.asarray(plan.local_assignment))
        if plan.mode == "materialized" else None
    )

    def upload(t, dtype=None):
        return t.to(device=dev, dtype=dtype, non_blocking=True, copy=True)

    def put(Xh, yh):
        idx = None if local is None else local.to(dev)
        if quantize:
            if not isinstance(Xh, features_lib.QuantizedStack):
                qs = features_lib.QuantizedStack.quantize(Xh.numpy())
                Xh = features_lib.QuantizedStack(torch.from_numpy(qs.q), torch.from_numpy(qs.scale))
            q, scale = upload(Xh.q), upload(Xh.scale, torch.float32)
            if idx is not None:
                q, scale = q[idx], scale[idx]
            Xd = features_lib.QuantizedStack(q, scale)
        else:
            Xd = upload(Xh, data_dtype)
            if idx is not None:
                Xd = Xd[idx]
        yd = upload(yh, data_dtype).float()
        return Xd, (yd if idx is None else yd[idx])

    return put


def _stream_group_slot_weights(layout, plan, schedule) -> np.ndarray:
    """Per-slot-group decode weights for sub-full faithful windows (host
    float64, byte-equal to the JAX package's).

    The resident [R, W] message weights cancel across workers (cyccoded's
    telescoping sums, the MDS solves), so one slot-group's rows of them
    reconstruct nothing. Each window instead gets its own decode: for
    slot-group k, the min-norm least squares ``u @ E_k = 1_window`` over the
    group's collected workers, ``E_k`` the group's effective coding matrix
    on the staged span and the target the window's partition indicator
    (halo partitions decode toward 0: they belong to the next window). This
    is the least-squares optimal decode (arXiv:2006.09638) localized to one
    slot-group, so a sub-full faithful window trains its block as
    approximate gradient coding even for an exact scheme.

    Returns ``[R, n_windows, gw, S]`` per-slot weights; separate (uncoded)
    slots keep their always-on coeffs, their fixed contribution folded out
    of the target (expand_slot_weights' rule)."""
    R = schedule.collected.shape[0]
    K, gw = plan.n_windows, plan.group_workers
    S = int(plan.local_assignment.shape[1])
    coeffs = np.asarray(layout.coeffs, dtype=np.float64)
    coded = np.broadcast_to(
        np.asarray(layout.slot_is_coded, dtype=bool), (int(layout.n_workers), S)
    )
    la = np.asarray(plan.local_assignment)  # [gw, S] staged positions
    staged = plan.staged_partitions
    target0 = (np.arange(staged) < plan.window).astype(np.float64)
    out = np.zeros((R, K, gw, S))
    for k in range(K):
        rows = slice(k * gw, (k + 1) * gw)
        ck = coeffs[rows]
        ik = coded[rows]
        E = np.zeros((gw, staged))
        np.add.at(E, (np.arange(gw)[:, None], la), np.where(ik, ck, 0.0))
        fixed = np.zeros(staged)
        np.add.at(fixed, la[~ik], ck[~ik])
        target = target0 - fixed
        masks = schedule.collected[:, rows]
        uniq, inverse = np.unique(masks, axis=0, return_inverse=True)
        u = np.zeros((uniq.shape[0], gw))
        for j in range(uniq.shape[0]):
            live = np.flatnonzero(uniq[j])
            if live.size:
                u[j, live] = np.linalg.lstsq(E[live].T, target, rcond=None)[0]
        mw = u[inverse.reshape(-1)]  # [R, gw]
        out[:, k] = np.where(ik, mw[:, :, None] * ck, ck)
    return out


@dataclasses.dataclass
class _StreamPlan:
    """What the per-run and cohort streamed trainers share: the window plan,
    the chunks of rounds and the window each consumes, the storage."""

    plan: object  # data/sharding.StreamWindowPlan
    chunks: list  # [(lo, hi)] round ranges
    win_of: list  # the window each chunk consumes
    round_win: np.ndarray  # [R] the window each round reads
    stack_dtype: str
    data_dtype: torch.dtype

    @property
    def mode(self) -> str:
        return self.plan.mode

    @property
    def windows(self) -> list:
        """The prefetcher's consume-order window list."""
        return [self.plan.ranges[k] for k in self.win_of]


def _plan_stream(cfg: RunConfig, layout, store, window: int) -> _StreamPlan:
    """The window plan of a streamed run and its chunks of rounds: each
    chunk of ``L = max(1, rounds // n_windows)`` rounds consumes one window,
    chunk i window ``i mod n_windows`` (fewer rounds visit a prefix of the
    windows), as in the JAX package."""
    _check_streamed_compat(cfg)
    faithful = cfg.compute_mode == ComputeMode.FAITHFUL
    try:
        plan = plan_stream_windows(layout, window, mode="materialized" if faithful else "deduped")
    except ValueError as e:
        raise ValueError(f"{e} — or {_stream_remedy(cfg)}") from None
    stack_dtype = cfg.resolve_stack_dtype()
    if store.quantized and stack_dtype != "int8":
        raise ValueError(
            f"int8 shard store requires stack_dtype='int8' (resolved "
            f"{stack_dtype!r}): re-uploading a dequantized window would "
            "silently train on reconstructed values"
        )
    L = max(1, cfg.rounds // plan.n_windows)
    bounds = list(range(0, cfg.rounds, L)) + [cfg.rounds]
    chunks = [(lo, hi) for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo]
    win_of = [i % plan.n_windows for i in range(len(chunks))]
    round_win = np.zeros(cfg.rounds, dtype=np.int64)
    for (lo, hi), k in zip(chunks, win_of):
        round_win[lo:hi] = k
    return _StreamPlan(
        plan=plan, chunks=chunks, win_of=win_of, round_win=round_win,
        stack_dtype=stack_dtype,
        data_dtype=_torch_dtype(cfg.dtype if stack_dtype == "int8" else stack_dtype),
    )


def _stream_round_weights(sp: _StreamPlan, layout, schedule) -> np.ndarray:
    """A streamed run's per-round weights as its window takes them (host
    float64): deduped, round r's window's columns of the folded [R, P]
    weights; a sub-full faithful window, its slot-group's decode
    (:func:`_stream_group_slot_weights`); a full-cover faithful window the
    resident slot weights."""
    plan = sp.plan
    slot_w = step_lib.expand_slot_weights(
        schedule.message_weights, layout.coeffs, np.asarray(layout.slot_is_coded)
    )  # [R, W, S]
    if plan.mode == "deduped":
        cols = sp.round_win[:, None] * plan.window + np.arange(plan.window)
        return np.take_along_axis(layout.fold_slot_weights(slot_w), cols, axis=1)
    if plan.n_windows > 1:
        gsw = _stream_group_slot_weights(layout, plan, schedule)  # [R, K, gw, S]
        return gsw[np.arange(len(sp.round_win)), sp.round_win]
    return slot_w


def _stream_cache_info(sp: _StreamPlan, window_nbytes: int, setup_seconds: float,
                       pf_stats: dict, peak: Optional[int]) -> dict:
    """A streamed run's ``cache_info``: the JAX trainer's keys (without the
    executable cache's), and the device's peak bytes over the round loop
    above its start (cuda; None on the CPU)."""
    plan = sp.plan
    return {
        "enabled": cache_lib.enabled(),
        # windows are transient by design: caching them would defeat the
        # residency bound
        "data_hit": False,
        "bytes_reused": 0,
        # device bytes of one staged window (for a faithful plan the
        # slot-group's worker-major gather)
        "stack_bytes": window_nbytes,
        "setup_seconds": setup_seconds,
        "stack_mode": plan.mode,
        "stack_dtype": sp.stack_dtype,
        "pipeline_depth": 0,
        "pipeline_params_slot_bytes": 0,
        "residency": "streamed",
        "stream_window": plan.window,
        "n_windows": plan.n_windows,
        "stream_halo": plan.halo,
        "stream_group_workers": plan.group_workers,
        "prefetch": pf_stats,
        "device_peak_bytes": peak,
    }


def _stream_loop(dev, store, sp: _StreamPlan, put, setup, grad_fn, update_fn,
                 t_call: float):
    """The streamed round loop shared by the per-run and cohort trainers.

    Stages the plan's windows through a Prefetcher; ``setup(X0, y0)`` runs
    on the first window before the clock starts (it picks the lowering);
    then per chunk, timed from before its window's ``get`` (the wait is
    streaming overhead) to a synchronize after its last round, for each of
    its rounds ``g = grad_fn(r, X, y)`` and ``update_fn(r, g)``. Each
    window's tensors are dropped before the next is fetched, so at most the
    prefetcher's ring and the window in use occupy the device. On the card the peak device bytes
    over the loop are read above the level before the first stage (this
    resets the device's peak-memory statistic).

    Returns ``(wall, setup_seconds, window_nbytes, prefetch stats, peak,
    staging records)``, the last data/prefetch.Prefetcher.records (each
    window's held ``io`` record and its ``prefetch`` payload), which the
    caller emits after the loop."""
    cuda = dev.type == "cuda"
    base = None
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    pf = Prefetcher(store, sp.windows, put, device=dev, plan_fields=sp.plan.event_fields())
    wall = 0.0
    try:
        X, y = pf.get(0)
        window_nbytes = cache_lib.device_nbytes((X, y))
        setup(X, y)
        setup_seconds = None
        for i, (lo, hi) in enumerate(sp.chunks):
            if cuda:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            if setup_seconds is None:
                setup_seconds = t0 - t_call
            if i:
                X = y = None
                X, y = pf.get(i)
            for r in range(lo, hi):
                with annotate("eh_scan/coded_step"):
                    g = grad_fn(r, X, y)
                with annotate("eh_scan/update"):
                    update_fn(r, g)
            if cuda:
                torch.cuda.synchronize(dev)
            wall += time.perf_counter() - t0
        X = y = None
    finally:
        pf.close()
    peak = torch.cuda.max_memory_allocated(dev) - base if cuda else None
    return wall, setup_seconds, window_nbytes, pf.stats(), peak, pf.records


def _train_streamed(
    cfg: RunConfig,
    dataset: Dataset,
    store,
    window: int,
    *,
    device=None,
    init_params=None,
    arrivals: Optional[np.ndarray] = None,
    schedule: Optional[collect.CollectionSchedule] = None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    initial_state: Optional[optimizer.OptState] = None,
    initial_round: int = 0,
) -> TrainResult:
    """Windowed streamed training: the stack never resides on the device
    whole. ``window`` partitions (a divisor of P, from
    _resolve_stream_window) are staged per chunk of rounds while the
    prefetcher (data/prefetch.py) stages the next window behind the
    chunk's compute.

    Block training, as in the JAX package, not a replay of the resident
    run: each round's gradient reads one window (``n_train`` is the
    window's rows), and chunks cycle through the windows in a fixed order;
    deterministic run to run for a (config, store). Deduped windows are
    partition windows with the folded weights' columns; faithful windows
    are the plan's slot-groups, gathered worker-major on the device, each
    decoded by its own least-squares weights
    (:func:`_stream_group_slot_weights`). The round's gradient takes the
    resident ladder over the window's stack (:func:`_grad_lowering`): a
    dense float GLM under ``use_pallas="auto"`` goes through the fused
    kernel, one launch a round (where the JAX package's auto declines its
    kernel here), an int8 window its dequantizing lowering. Refused, with
    JAX's messages: the forced kernel and the forced blockwise decode
    (:func:`_check_streamed_compat`), assignments that are not
    window-uniform (the planner), ``checkpoint_dir``, ``resume`` and a
    mid-schedule restart (``initial_state``/``initial_round``)."""
    t_call = time.perf_counter()
    if checkpoint_dir or resume or initial_state is not None or initial_round:
        raise ValueError(
            "checkpoint/resume/mid-schedule restart are not supported on "
            "the windowed streamed path (kill→resume recovery is the "
            "sweep journal's trajectory rehydration; see "
            "tools/outofcore_smoke.py)"
        )
    dev = resolve_device(device)
    layout = build_layout(cfg)
    model = build_model(cfg)
    sp = _plan_stream(cfg, layout, store, window)
    faithful = sp.mode == "materialized"

    # ---- control plane: the resident trainer's, then the window's slices
    if arrivals is None:
        arrivals = default_arrivals(cfg)
    if schedule is None:
        schedule = build_schedule(cfg, arrivals, layout)
    decode_err = obs_decode.decode_error_series(layout, schedule.message_weights)
    lr32 = cfg.resolve_lr_schedule().astype(np.float32)
    alpha = cfg.effective_alpha
    n_train = window * store.rows_per_partition  # the block a round averages
    weights = _to_device(_stream_round_weights(sp, layout, schedule), dev, torch.float32)

    if init_params is None:
        params0 = model.init_params(cfg.seed, store.n_features, dev)
    else:
        params0 = params_from_numpy(init_params, dev)
    state = optimizer.init_state(params0, cfg.update_rule)
    update_fn = optimizer.make_update_fn(cfg.update_rule)
    history = blocks.tree_map(
        lambda p: torch.empty((cfg.rounds,) + tuple(p.shape), dtype=torch.float32, device=dev),
        params0,
    )
    run = {}

    def setup(X0, y0):
        run["grad_fn"], run["lowering"] = _grad_lowering(cfg, model, X0, faithful, params0)
        run["compiled"] = _prepare_lowering(dev, model, run["lowering"], run["grad_fn"],
                                            X0, y0, params0, weights[0])

    def grad_r(r, X, y):
        return run["grad_fn"](state.params, X, y, weights[r])

    def update_r(r, g):
        nonlocal state
        state = update_fn(state, g, float(lr32[r]), alpha, n_train, float(r))
        blocks.tree_map(lambda h, p: h[r].copy_(p), history, state.params)

    run_id = obs_events.new_run_id() if obs_events.active() else None
    put = _make_stream_put(sp.plan, dev, sp.stack_dtype == "int8", sp.data_dtype)
    wall, setup_seconds, window_nbytes, pf_stats, peak, staged = _stream_loop(
        dev, store, sp, put, setup, grad_r, update_r, t_call
    )
    steps_per_sec = cfg.rounds / wall if wall > 0 else 0.0
    if run_id is not None:
        _emit_run_start(run_id, cfg, dev, run["lowering"], sp.mode, window_nbytes, False,
                        run["compiled"], cfg.rounds)
        _emit_stream_records(run_id, staged)
        obs_events.emit_round_chunks(
            run_id, start_round=0, timeset=schedule.sim_time,
            worker_times=schedule.worker_times, decode_error=decode_err,
            update_norm=_history_update_norms(history),
        )
        obs_events.emit(
            "run_end",
            run_id=run_id,
            wall_time_s=round(wall, 6),
            steps_per_sec=round(steps_per_sec, 4),
            sim_total_time_s=float(schedule.sim_time.sum()),
            data_cache_hit=False,
            stack_bytes=window_nbytes,
            arrival=obs_events.arrival_summary(schedule.worker_times),
            **_exec_fields(run["compiled"]),
            **obs_decode.summarize(decode_err),
        )
        # the timed loop includes the staging waits; the prefetcher's
        # blocked_s is exactly the part the double buffer failed to hide
        obs_cpath.emit_event(run_id, obs_cpath.attribute(
            schedule.sim_time, schedule.worker_times, schedule.collected, wall_s=wall,
            prefetch_stall_s=float(pf_stats.get("blocked_s", 0.0)),
        ))
    return TrainResult(
        params_history=history,
        final_params=state.params,
        timeset=schedule.sim_time,
        worker_times=schedule.worker_times,
        collected=schedule.collected,
        sim_total_time=float(schedule.sim_time.sum()),
        wall_time=wall,
        steps_per_sec=steps_per_sec,
        n_train=n_train,
        config=cfg,
        layout=layout,
        final_state=state,
        decode_error=decode_err,
        lowering=run["lowering"],
        cache_info=_stream_cache_info(sp, window_nbytes, setup_seconds, pf_stats, peak),
        schedule=schedule,
        run_id=run_id,
    )


# ---------------------------------------------------------------------------
# trajectory cohorts: B training trajectories, one shared data stack, one
# round loop (the JAX package's train_cohort, resident stacks)


def estimate_stack_bytes(cfg: RunConfig, dataset: Dataset) -> int:
    """Host-side estimate of the device data-stack footprint a dispatch of
    ``cfg`` pins while in flight: the serve admission controller's charge
    unit (serve/admission.py), the JAX package's estimate on the port's
    stacks.

    Deduped runs keep the partition-major stack; faithful runs pay the
    (s+1)x worker-major stack (the port has no ring transport, so every
    faithful stack is materialized: the JAX package's ``stack_mode``
    "materialized" case). bfloat16 counts 2 bytes an element, int8 1 plus
    its float32 scale rows (data/sharding.estimate_worker_stack_bytes).
    Streamed-residency runs are charged their resident WINDOWS, at most two
    (the one computing and the one in flight), never the whole stack; a
    faithful window is its slot-group's worker gather, ``2/n_windows`` of
    the worker stack. A pipelined run adds its stale params slot. An
    estimate, not an accounting: the daemon refines it per signature with
    the measured peak of a dispatch on the card."""
    layout = build_layout(cfg)
    dtype_name = cfg.resolve_stack_dtype()
    worker_stack_est = sharding_lib.estimate_worker_stack_bytes(dataset, layout, dtype_name)
    per_block = worker_stack_est / max(1, layout.n_workers * layout.n_slots)
    partition_major = cfg.compute_mode != ComputeMode.FAITHFUL
    streamed = _resolve_residency(cfg) == "streamed"
    w = None
    if streamed:
        # the window without a store: ShardStore.partition_bytes() from the
        # dataset's own shapes (payload + labels + an int8 scale row)
        P = layout.n_partitions
        F = int(dataset.X_train.shape[1])
        rows = dataset.n_samples // max(1, P)
        part_bytes = rows * F * sharding_lib.STACK_ITEMSIZE[dtype_name]
        part_bytes += rows * np.asarray(dataset.y_train).dtype.itemsize
        if dtype_name == "int8":
            part_bytes += F * 4
        w = _resolve_stream_window(cfg, P, part_bytes)
    if partition_major:
        blocks_n = layout.n_partitions
        if streamed and w < blocks_n:
            blocks_n = min(blocks_n, 2 * w)  # deduped windows have no halo
        est = per_block * blocks_n
    else:
        est = worker_stack_est
        if streamed and w < layout.n_partitions:
            n_windows = layout.n_partitions // w
            est = worker_stack_est * min(1.0, 2.0 / n_windows)
    if cfg.pipeline_depth:
        # the pipelined loop's stale params slot, at the dense GLM's size
        F = int(dataset.X_train.shape[1])
        est += cfg.pipeline_depth * (F + 1) * 4
    return int(est)


def cohort_eligible(cfg: RunConfig) -> bool:
    """Can this config ride a trajectory-cohort dispatch? Not with the
    forced fused kernel (``use_pallas="on"``: a one-trajectory kernel), not
    pipelined (the cohort loop has no batched stale-params slot, so those
    run as per-run train()), not a streamed run with the forced blockwise
    decode (no windowed body), and only where the scheme's descriptor
    allows it (``cohort_batchable``). Streamed runs batch: trajectories of
    one store and window plan ride one windowed cohort loop
    (:func:`_train_cohort_streamed`), and ``static_signature`` carries the
    residency knobs, so they never group with resident ones. Measured-
    arrival runs time each worker on its own and never batch."""
    if _resolve_residency(cfg) == "streamed" and cfg.layer_coding == "on":
        return False
    return (
        cfg.arrival_mode == "simulated"
        and cfg.use_pallas != "on"
        and cfg.pipeline_depth == 0
        and schemes.get(cfg.scheme).cohort_batchable
    )


def cohort_signature(cfg: RunConfig) -> Optional[tuple]:
    """Grouping key for cohort dispatch (experiments.plan_cohorts): configs
    with the same key share a device data stack and a gradient lowering,
    so they can run as one cohort (:func:`train_cohort`); None = not
    batchable. Deduped trajectories group by partition count alone (the
    partition-major stack is scheme-independent, so a whole 7-scheme
    compare() is one cohort); faithful ones by assignment content (FRC and
    AGC share one, cyclic MDS has its own)."""
    if not cohort_eligible(cfg):
        return None
    return (
        cfg.static_signature(),
        cfg.rounds,
        cfg.n_workers,
        _stack_signature(cfg, build_layout(cfg)),
    )


def _stack_signature(cfg: RunConfig, layout) -> tuple:
    return cache_lib.layout_stack_signature(
        layout, worker_major=cfg.compute_mode == ComputeMode.FAITHFUL,
        stack_dtype=cfg.resolve_stack_dtype(), dtype=cfg.dtype,
        sparse_format=cfg.sparse_format,
    )


def _lane(state: optimizer.OptState, b: int) -> optimizer.OptState:
    """Trajectory b of a cohort's stacked optimizer state."""

    def take(tree):
        return blocks.tree_map(lambda leaf: leaf[b], tree)

    mom = state.momentum
    mom = tuple(take(m) for m in mom) if isinstance(mom, tuple) else take(mom)
    return optimizer.OptState(params=take(state.params), momentum=mom)


def _cohort_schedules(cfgs, layouts, arrivals) -> list:
    """Each trajectory's collection schedule, built as train() builds it.
    ``arrivals``: None (each draws its own), one shared [R, W] matrix, or
    one per trajectory."""
    B = len(cfgs)
    if arrivals is None:
        arr_list = [default_arrivals(c) for c in cfgs]
    elif isinstance(arrivals, (list, tuple)):
        if len(arrivals) != B:
            raise ValueError(f"got {len(arrivals)} arrival matrices for {B} trajectories")
        arr_list = [np.asarray(a) for a in arrivals]
    else:
        arr_list = [np.asarray(arrivals)] * B
    return [build_schedule(c, a, lay) for c, a, lay in zip(cfgs, arr_list, layouts)]


def _cohort_lr_alpha(cfgs, dev):
    """The cohort's [R, B] learning rates and [B] l2 coefficients. They are
    trajectory axes, float32 tensors (as in the JAX cohort): the update's
    scalar coefficients are formed in float32, where train() forms them
    from Python floats."""
    lr_B = _to_device(
        np.stack([c.resolve_lr_schedule() for c in cfgs], axis=1), dev, torch.float32
    )
    alpha_B = _to_device(np.array([c.effective_alpha for c in cfgs]), dev, torch.float32)
    return lr_B, alpha_B


def _cohort_fields(B: int, lowering: str, faithful: bool) -> dict:
    return {
        "cohort_size": B,
        "cohort_lowering": lowering,
        "cohort_dispatches": 1,
        "stack_mode": "materialized" if faithful else "deduped",
    }


def _cohort_results(cfgs, schedules, layouts, state, history, wall: float, n_train: int,
                    lowering: str, cohort: dict, cache_info: dict, run_id=None) -> list:
    """One TrainResult per trajectory of a cohort's round loop: its lane of
    the stacked state and history, its own control plane, the cohort's wall
    clock and aggregate steps/s (R * B / wall)."""
    rounds = cfgs[0].rounds
    agg_rate = rounds * len(cfgs) / wall if wall > 0 else 0.0
    results = []
    for b, (c, sched, lay) in enumerate(zip(cfgs, schedules, layouts)):
        final = _lane(state, b)
        results.append(TrainResult(
            params_history=blocks.tree_map(lambda h: h[:, b].contiguous(), history),
            final_params=final.params,
            timeset=sched.sim_time,
            worker_times=sched.worker_times,
            collected=sched.collected,
            sim_total_time=float(sched.sim_time.sum()),
            wall_time=wall,
            steps_per_sec=agg_rate,
            n_train=n_train,
            config=c,
            layout=lay,
            final_state=final,
            decode_error=obs_decode.decode_error_series(lay, sched.message_weights),
            lowering=lowering,
            cohort=dict(cohort),
            cache_info=dict(cache_info),
            schedule=sched,
            run_id=run_id,
        ))
    return results


def _emit_cohort(run_id, cfgs, results, dev, stack_mode: str, data_hit: bool,
                 compiled: tuple, stack_bytes: int, prefetch_stall_s: float = 0.0,
                 staged=()) -> None:
    """A cohort's records, as the JAX cohort emits them, after its loop: the
    opening records with one ``cohort`` record (its one round loop is its
    one dispatch), each trajectory's chunk stream tagged
    ``<b>:<scheme>:s<seed>`` under the cohort's run_id, one run_end, and one
    critical path over the B schedules concatenated along the round axis
    (the sim ledger decomposes the summed simulated clock, wall_s stays the
    cohort's wall)."""
    cfg = cfgs[0]
    lowering = results[0].lowering
    cohort = dict(
        n_trajectories=len(cfgs), schemes=sorted({c.scheme.value for c in cfgs}),
        seeds=[c.seed for c in cfgs], dispatches=1, lowering=lowering,
    )
    _emit_run_start(run_id, cfg, dev, lowering, stack_mode, stack_bytes, data_hit, compiled,
                    cfg.rounds, cohort=cohort)
    _emit_stream_records(run_id, staged)
    for b, (c, res) in enumerate(zip(cfgs, results)):
        obs_events.emit_round_chunks(
            run_id, start_round=0, timeset=res.timeset, worker_times=res.worker_times,
            decode_error=res.decode_error, trajectory=f"{b}:{c.scheme.value}:s{c.seed}",
        )
    wall = results[0].wall_time
    obs_events.emit(
        "run_end",
        run_id=run_id,
        wall_time_s=round(wall, 6),
        steps_per_sec=round(results[0].steps_per_sec, 4),
        batch_size=len(cfgs),
        cohort_size=len(cfgs),
        data_cache_hit=data_hit,
        stack_bytes=stack_bytes,
        arrival=obs_events.arrival_summary(np.stack([r.worker_times for r in results])),
        **_exec_fields(compiled),
        **obs_decode.summarize(np.concatenate([r.decode_error for r in results])),
    )
    obs_cpath.emit_event(run_id, obs_cpath.attribute(
        np.concatenate([r.timeset for r in results]),
        np.concatenate([r.worker_times for r in results]),
        np.concatenate([r.collected for r in results]),
        wall_s=wall, prefetch_stall_s=prefetch_stall_s,
    ))


def _cohort_layouts(cfgs) -> list:
    """Each trajectory's layout; one shared device stack, so a trajectory
    whose stack differs from the first's is refused rather than trained on
    another code than its train() run would use."""
    layouts = [build_layout(c) for c in cfgs]
    stack0 = _stack_signature(cfgs[0], layouts[0])
    for c, lay in zip(cfgs[1:], layouts[1:]):
        if _stack_signature(c, lay) != stack0:
            raise ValueError(
                f"trajectory {c.scheme.value!r} (seed {c.seed}) builds a "
                "different device data stack than the cohort's first "
                "trajectory; train_cohort shares one stack — group by "
                "cohort_signature (experiments.plan_cohorts) or run "
                "per-trajectory train()"
            )
    return layouts


def _cohort_params(model, cfgs, init_params, n_features: int, dev):
    """The cohort's initial params, stacked on a leading [B] axis: each
    trajectory's seeded init, or ``init_params``' entries."""
    if init_params is None:
        params = [model.init_params(c.seed, n_features, dev) for c in cfgs]
    else:
        params = [params_from_numpy(p, dev) for p in init_params]
    return blocks.tree_map(lambda *leaves: torch.stack(leaves), *params)


def _cohort_lowering(cfg: RunConfig, model, X, y, faithful: bool, params0, w0, dev):
    """The cohort's gradient fn over the stack ``X``, its lowering
    (step.make_cohort_grad_fn) and its compile step (:func:`_load_kernels`),
    with the set-up before the clock starts: build the kernels, import
    torch.func, build a sparse stack's scatter plans."""
    if cfg.flat_grad == "on" and not step_lib.supports_flat_grad(model, X):
        raise ValueError(
            "flat_grad='on' needs a closed-form GLM stack; "
            f"got model={_model_name(model)!r}, X={type(X).__name__}"
        )
    _check_layer_coding(cfg, model)
    grad_fn, lowering = step_lib.make_cohort_grad_fn(
        model, blocks.tree_map(lambda p: p[0], params0), X, faithful=faithful,
        layer_coding=cfg.layer_coding, block_decode=cfg.block_decode,
        flat_grad=cfg.flat_grad,
    )
    compiled = _load_kernels(dev, lowering == "layer_block_vmap")
    step_lib.warm_autodiff()
    _prepare_sparse(X, grad_fn, params0, y, w0)
    return grad_fn, lowering, compiled


def _train_cohort_streamed(cfgs, store, window: int, *, arrivals, device, init_params,
                           t_call: float) -> list:
    """A cohort over a shard store's windows: the streamed counterpart of
    the resident cohort loop. One prefetch stream and one staging a chunk
    serve all B trajectories; each trajectory's rounds are
    :func:`_train_streamed`'s block training exactly (the same window plan,
    chunks, window cycle and per-window weights: deduped the window's
    columns of ``[R, B, P]``, faithful each trajectory's slot-group
    decode), its gradient one cohort body over the window's stack (the
    cohort matmul for a dense GLM; no blockwise form), its update the
    vmapped one. Members match their sequential streamed runs to float
    tolerance."""
    # the same chaos site as the resident cohort dispatch: a raise exercises
    # compare()'s bisection (experiments._dispatch_cohort)
    chaos_lib.maybe_fire("cohort")
    cfg = cfgs[0]
    dev = device
    layouts = _cohort_layouts(cfgs)
    sp = _plan_stream(cfg, layouts[0], store, window)
    faithful = sp.mode == "materialized"
    schedules = _cohort_schedules(cfgs, layouts, arrivals)
    weights = _to_device(
        np.stack([_stream_round_weights(sp, lay, sched)
                  for lay, sched in zip(layouts, schedules)], axis=1),
        dev, torch.float32,
    )  # [R, B, window] (deduped) or [R, B, gw, S] (faithful)
    lr_B, alpha_B = _cohort_lr_alpha(cfgs, dev)
    n_train = window * store.rows_per_partition
    model = build_model(cfg)
    params0 = _cohort_params(model, cfgs, init_params, store.n_features, dev)
    state = optimizer.init_state(params0, cfg.update_rule)
    update_fn = optimizer.make_cohort_update_fn(cfg.update_rule)
    history = blocks.tree_map(
        lambda p: torch.empty((cfg.rounds,) + tuple(p.shape), dtype=torch.float32, device=dev),
        params0,
    )  # leaves [R, B, ...]
    run = {}

    def setup(X0, y0):
        run["grad_fn"], run["lowering"], run["compiled"] = _cohort_lowering(
            cfg, model, X0, y0, faithful, params0, weights[0], dev
        )

    def grad_r(r, X, y):
        return run["grad_fn"](state.params, X, y, weights[r])

    def update_r(r, g):
        nonlocal state
        state = update_fn(state, g, lr_B[r], alpha_B, n_train, float(r))
        blocks.tree_map(lambda h, p: h[r].copy_(p), history, state.params)

    run_id = obs_events.new_run_id() if obs_events.active() else None
    put = _make_stream_put(sp.plan, dev, sp.stack_dtype == "int8", sp.data_dtype)
    wall, setup_seconds, window_nbytes, pf_stats, peak, staged = _stream_loop(
        dev, store, sp, put, setup, grad_r, update_r, t_call
    )
    cohort = _cohort_fields(len(cfgs), run["lowering"], faithful)
    cache_info = _stream_cache_info(sp, window_nbytes, setup_seconds, pf_stats, peak)
    results = _cohort_results(cfgs, schedules, layouts, state, history, wall, n_train,
                              run["lowering"], cohort, {**cache_info, **cohort}, run_id)
    if run_id is not None:
        _emit_cohort(run_id, cfgs, results, dev, sp.mode, False,
                     run["compiled"], window_nbytes,
                     prefetch_stall_s=float(pf_stats.get("blocked_s", 0.0)), staged=staged)
    return results


def train_cohort(
    cfgs: Sequence[RunConfig] | RunConfig,
    dataset: Dataset,
    seeds=None,
    arrivals=None,
    *,
    device=None,
    init_params=None,
) -> list:
    """Run a cohort of training trajectories, (scheme, seed, lr/alpha)
    variants, as ONE round loop over one shared device data stack.

    Each round computes every trajectory's decoded gradient from one pass
    of the stack: a dense GLM cohort's margins are one [N, F] x [F, B]
    product (step.cohort_matmul_grad_fn), a layer-coded cohort decodes in
    one kernel launch a round for all B trajectories
    (ops/kernels.fused_block_decode_cohort), other families run the
    sequential step under ``torch.func.vmap``; then every trajectory's
    update at once (optimizer.make_cohort_update_fn).

    ``cfgs`` is a sequence of trajectory configs (or one config);
    ``seeds`` expands each across a seed sweep (``replace(cfg, seed=s)``).
    ``arrivals`` is None (each trajectory draws its own default schedule,
    as ``train()`` would), one shared [R, W] matrix (the paired comparison
    of experiments.compare), or a list with one matrix per trajectory.
    ``init_params`` is None (each trajectory's own seeded init) or a list
    with one init per trajectory (as ``train(init_params=...)`` takes it).
    ``device`` as in :func:`train`: cuda unless ``"cpu"`` is asked for.

    Contract: each trajectory matches its ``train()`` run to float
    tolerance (the batched products reduce in another order), and its
    control-plane arrays (timeset, worker_times, collected, decode_error)
    are identical, built per trajectory on the host as ``train()`` builds
    them. All trajectories share rounds, workers, the static lowering
    signature (RunConfig.static_signature) and the data stack (deduped:
    partition count; faithful: assignment content): group mixed sets with
    experiments.plan_cohorts. Every result carries the cohort's wall clock
    and its aggregate steps/s, R * B / wall.

    A streamed cohort (``stack_residency``) shares the store: a window
    covering every partition runs this loop on the store's rows, a smaller
    one the windowed cohort loop (:func:`_train_cohort_streamed`)."""
    if isinstance(cfgs, RunConfig):
        cfgs = [cfgs]
    cfgs = list(cfgs)
    if seeds is not None:
        cfgs = [dataclasses.replace(c, seed=int(s)) for c in cfgs for s in seeds]
    if not cfgs:
        raise ValueError("train_cohort needs at least one trajectory config")
    for c in cfgs:
        if c.arrival_mode != "simulated":
            raise ValueError(
                "train_cohort batches the scan trainer; "
                "arrival_mode='measured' has no batched implementation"
            )
        if c.use_pallas == "on":
            raise ValueError(
                "train_cohort has no batched fused-kernel dispatch; "
                "use use_pallas='auto' or 'off'"
            )
        if c.pipeline_depth:
            raise PipelineRefusal(
                "cohort_batch",
                "train_cohort has no batched stale-carry scan; pipelined "
                "trajectories dispatch sequentially as per-run train() "
                "(experiments.plan_cohorts already routes them so)",
            )
    t_call = time.perf_counter()
    cfg = cfgs[0]
    sig = cfg.static_signature()
    for c in cfgs[1:]:
        if c.static_signature() != sig or c.rounds != cfg.rounds or c.n_workers != cfg.n_workers:
            raise ValueError(
                "cohort trajectories must share rounds, workers, and the "
                "full static lowering signature (model, compute_mode, "
                "dtype, update_rule, ...); group mixed config sets with "
                "experiments.plan_cohorts"
            )
    B = len(cfgs)
    if init_params is not None and len(init_params) != B:
        raise ValueError(f"got {len(init_params)} initial params for {B} trajectories")
    dev = resolve_device(device)
    # streamed cohorts: static_signature carries the residency knobs, so
    # the whole cohort resolves its residency and window alike; a window
    # covering every partition trains the resident cohort on the store's
    # rows (bitwise), a smaller one the windowed cohort loop
    residency = _resolve_residency(cfg)
    if residency == "streamed":
        store = _ensure_store(cfg, dataset)
        window = _resolve_stream_window(cfg, store.n_partitions, store.partition_bytes())
        if window < store.n_partitions:
            return _train_cohort_streamed(
                cfgs, store, window, arrivals=arrivals, device=dev,
                init_params=init_params, t_call=t_call,
            )
        if getattr(dataset, "_sweep_cache_token", None) != store.cache_token:
            dataset = store.dataset()
    # chaos site "cohort": a kill here is a preemption mid-cohort (nothing of
    # the cohort persisted); a raise whose message names an out-of-memory
    # marker exercises compare()'s bisection (experiments._dispatch_cohort)
    chaos_lib.maybe_fire("cohort")
    faithful = cfg.compute_mode == ComputeMode.FAITHFUL
    layouts = _cohort_layouts(cfgs)

    # ---- control plane, per trajectory, exactly as train() builds it ------
    schedules = _cohort_schedules(cfgs, layouts, arrivals)
    weights_h = np.stack([
        _round_weights(
            lay,
            step_lib.expand_slot_weights(
                s.message_weights, lay.coeffs, np.asarray(lay.slot_is_coded)
            ),
            faithful,
        )
        for s, lay in zip(schedules, layouts)
    ], axis=1)  # [R, B, W, S] (faithful) or [R, B, P] (deduped)
    lr_B, alpha_B = _cohort_lr_alpha(cfgs, dev)

    # ---- data plane: one stack for the cohort ------------------------------
    stats_before = cache_lib.stats().snapshot()
    X, y, n_train, data_hit = _device_stack(cfg, dataset, layouts[0], faithful, dev)
    weights = _to_device(weights_h, dev, torch.float32)
    model = build_model(cfg)
    params0 = _cohort_params(model, cfgs, init_params, dataset.n_features, dev)
    grad_fn, lowering, compiled = _cohort_lowering(cfg, model, X, y, faithful, params0,
                                                   weights[0], dev)
    run_id = obs_events.new_run_id() if obs_events.active() else None

    state = optimizer.init_state(params0, cfg.update_rule)
    update_fn = optimizer.make_cohort_update_fn(cfg.update_rule)
    history = blocks.tree_map(
        lambda p: torch.empty((cfg.rounds,) + tuple(p.shape), dtype=torch.float32, device=dev),
        params0,
    )  # leaves [R, B, ...]

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    cache_info = _cache_info(cfg, data_hit, stats_before, X, y, faithful, t0 - t_call, None,
                             residency)
    for i in range(cfg.rounds):
        with annotate("eh_scan/coded_step"):
            g = grad_fn(state.params, X, y, weights[i])
        with annotate("eh_scan/update"):
            state = update_fn(state, g, lr_B[i], alpha_B, n_train, float(i))
            blocks.tree_map(lambda h, p: h[i].copy_(p), history, state.params)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    cohort = _cohort_fields(B, lowering, faithful)
    results = _cohort_results(cfgs, schedules, layouts, state, history, wall, n_train,
                              lowering, cohort, {**cache_info, **cohort}, run_id)
    if run_id is not None:
        _emit_cohort(run_id, cfgs, results, dev, cache_info["stack_mode"], data_hit,
                     compiled, cache_info["stack_bytes"])
    return results


def train_batch(cfg: RunConfig, dataset: Dataset, seeds, *, device=None) -> list:
    """Seed sweep of one config as one cohort: ``[train(replace(cfg,
    seed=s)) for s in seeds]`` through :func:`train_cohort`. Keeps the JAX
    package's original contract: a scheme whose layout depends on the seed
    is refused whenever the seeds give different layouts, even in deduped
    mode, where train_cohort itself could batch them."""
    seeds = [int(s) for s in seeds]
    if not seeds:
        raise ValueError("train_batch needs at least one seed")
    if cfg.arrival_mode != "simulated":
        raise ValueError(
            "train_batch batches the scan trainer; arrival_mode='measured' "
            "has no batched implementation"
        )
    if cfg.use_pallas == "on":
        raise ValueError(
            "train_batch has no batched fused-kernel dispatch; "
            "use use_pallas='auto' or 'off'"
        )
    cfgs = [dataclasses.replace(cfg, seed=s) for s in seeds]
    layouts = [build_layout(c) for c in cfgs]
    a0, c0 = np.asarray(layouts[0].assignment), np.asarray(layouts[0].coeffs)
    for lay in layouts[1:]:
        if not (
            np.array_equal(a0, np.asarray(lay.assignment))
            and np.array_equal(c0, np.asarray(lay.coeffs))
        ):
            raise ValueError(
                f"scheme {cfg.scheme.value!r} builds a seed-dependent "
                "layout across these seeds; train_batch shares one data "
                "stack — run per-seed train() for seed-dependent codes"
            )
    return train_cohort(cfgs, dataset, device=device)
