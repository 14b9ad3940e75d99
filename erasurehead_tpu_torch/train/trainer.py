"""The synchronous trainer: a Python loop over rounds on each rank's device.

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
erasurehead_tpu/train/trainer.py:934-985; in the port the ring transport
composes with every lowering, the fused kernel included, where JAX's ring
declines its kernel):
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
the round's gradient taking the same lowering ladder over the window. A
faithful window is materialized worker-major or, under the ring transport
(``stack_mode`` "ring", or "auto" on a redundant layout), staged
partition-major and its slots rebuilt every round; over a worker mesh each
rank stages only its share of every window.

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
for a ``--trace-dir`` trace. ``train_dynamic`` emits nothing, as in the JAX
package.

The round loop's executable (train/graphs.py, train/cache.py): on the card,
``train``, ``train_dynamic`` and ``train_cohort`` run each chunk of rounds
as replays of a captured CUDA graph, one program per chunk length from the
executable cache, keyed as the JAX package keys its executables
(:func:`_exec_signature_fields`) plus the data stack's identity; the per-round
scalars (learning rate, round index, round key) and weights are device
tables the run copies in, so a sweep's runs share the program. Each of the
three has one round body, ``round_fn(carry, row, consts)`` over those
tables: the program captures it, and the uncaptured executor
(graphs.run_eager) calls it once a round with the round's row read by host
index. Each chunk length's ``compile`` record carries the capture's
seconds, the hit and the program's memory (``memory_analysis``: graph pool
and static bytes, replays, unroll); a miss that lands near an earlier
signature warns (obs/detect.py). The CPU runs the round body uncaptured,
counted in the cache as the JAX package's CPU executable is. It also runs
uncaptured, by name and decided before any capture (:func:`_loop_mode`),
under ``graphs.disabled()``, over a process group, under a
``device_trace``, for a rule that synchronises with the host (the float32
decode solve); ``train_measured`` (the host times each worker) and the
streamed windows (a staging thread stages each window into new tensors)
keep eager loops of their own. An eager run's ``compile`` record is the
kernel library's load and names the reason. ``cfg.donate``
(:func:`_resolve_donate`) releases the starting carry and weight table
once they are in the program's buffers (graphs.release), after the loop
on the eager path.

The worker mesh (parallel/mesh.py; ``mesh=None`` is the largest group of
the world's processes whose size divides the sharded axis, as the JAX
package's ``_auto_mesh``): each rank keeps its slice of the stack and of the
round weights, computes the local decoded gradient, and all-reduces it over
the group where the JAX package psums (parallel/step.py). Every rank runs
the same host control plane from the same seeds and applies the same update,
so the ranks' params stay bitwise equal; rank 0 alone writes checkpoints.
``cfg.stack_mode="ring"`` (or "auto" past a footprint) keeps only the
partition-major stack and rebuilds the worker slots every round over ring
hops between the ranks (step.make_ring_faithful_grad_fn), bitwise the
materialized run. Without a process group the mesh is this one process and
nothing changes. A config with a model-internal axis (``tp_shards``,
``pp_shards``, ``ep_shards`` or ``seq_shards`` above 1) runs on the 2-D
(workers, axis) mesh (``_auto_2d_mesh``, or an explicit mesh that must carry
the axis), and the round's step takes the family's model-parallel copy
(``for_mesh``); eval replay stays unsharded.

Timing artifacts keep two clocks apart, as the JAX package does:
  - ``timeset``/``worker_times``: *simulated* cluster seconds from the
    arrival model;
  - ``wall_time``/``steps_per_sec``: real seconds of the round loop, between
    two ``torch.cuda.synchronize()`` calls on the card (the kernel library is
    built and loaded, ``torch.func`` imported and the graphs captured before
    the clock starts; a graph run's clock covers copying its carry and tables
    in, the replays and copying its history out).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from erasurehead_tpu_torch import schemes, tune
from erasurehead_tpu_torch.data import sharding as sharding_lib
from erasurehead_tpu_torch.data import store as store_lib
from erasurehead_tpu_torch.data.prefetch import Prefetcher
from erasurehead_tpu_torch.data.sharding import (
    partition_stack,
    plan_ring_transport,
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
from erasurehead_tpu_torch.obs import detect as obs_detect
from erasurehead_tpu_torch.obs import events as obs_events
from erasurehead_tpu_torch.ops import blocks, codes, kernels
from erasurehead_tpu_torch.ops import features as features_lib
from erasurehead_tpu_torch.parallel import backend as backend_lib
from erasurehead_tpu_torch.parallel import collect, pipeline as pipeline_lib
from erasurehead_tpu_torch.parallel import mesh as mesh_lib
from erasurehead_tpu_torch.parallel import step as step_lib, straggler
from erasurehead_tpu_torch.train import cache as cache_lib
from erasurehead_tpu_torch.train import checkpoint as ckpt_lib
from erasurehead_tpu_torch.train import graphs, optimizer
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
from erasurehead_tpu_torch.utils import tracing
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


def _build_stack(cfg: RunConfig, dataset: Dataset, layout, faithful: bool, dev,
                 mesh=None, ring: bool = False):
    """The run's data stack, moved to the device: worker-major
    [W, S, rows, F] (faithful) or partition-major [P, rows, F] (deduped, or
    the ring transport), its labels, and the training row count (the JAX
    package's shard_run_data). Over a worker ``mesh`` the rank builds and
    uploads only its slice: its workers ``[Wl, S, rows, F]``, or its
    partitions ``[Pl, rows, F]`` (empty outside the worker group); the row
    count stays the whole stack's. A CSR dataset stacks as PaddedRows or FieldOnehot per
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
    mesh = mesh or mesh_lib.worker_mesh(1)
    if faithful:
        mesh_lib.check_divisible(layout.n_workers, mesh, "n_workers")
    if faithful and not ring:
        lo, hi = mesh.slice(layout.n_workers)
        Xh, yh = worker_stack(layout, Xp_h, yp_h, workers=slice(lo, hi))
    else:
        mesh_lib.check_divisible(layout.n_partitions, mesh, "n_partitions")
        lo, hi = mesh.slice(layout.n_partitions)
        Xh, yh = features_lib.take_lead(Xp_h, slice(lo, hi)), yp_h[lo:hi]
    # the data dtype: the stored float dtype, or cfg.dtype under int8
    data_dtype = _torch_dtype(cfg.dtype if stack_dtype == "int8" else stack_dtype)
    X = features_lib.to_device(Xh, dev, data_dtype)
    # labels ride along the data dtype (as in the JAX package), then stay
    # float32 for the residual
    y = _to_device(yh, dev, data_dtype).float()
    return X, y, yp_h.size


def _device_stack(cfg: RunConfig, dataset: Dataset, layout, faithful: bool, dev,
                  mesh=None, ring: bool = False):
    """:func:`_build_stack` through the data cache: ``(X, y, n_train,
    hit)``. The key is the JAX package's upload key (dataset identity, the
    layout's stacking signature with the storage, the partition count, the
    mesh) plus the device, so a CPU run never receives a card stack. A
    FieldOnehot stack takes the run's ``fields_margin``/``fields_scatter``/
    ``sparse_lanes`` after the lookup: the lowering is not part of the
    cached stack."""
    mesh = mesh or mesh_lib.worker_mesh(1)
    key = (
        "stacks",
        cache_lib.dataset_token(dataset),
        _stack_signature(cfg, layout, ring),
        layout.n_partitions,
        str(dev),
        cache_lib.mesh_signature(mesh, dev),
    )
    (X, y, n_train), hit = cache_lib.get_or_build_data(
        key, lambda: _build_stack(cfg, dataset, layout, faithful, dev, mesh, ring)
    )
    if isinstance(X, features_lib.FieldOnehot):
        X = X.with_lowering(cfg.fields_margin, cfg.fields_scatter, cfg.sparse_lanes)
    return X, y, n_train, hit


def resolved_stack(cfg: RunConfig, dataset: Dataset, device=None, mesh=None):
    """``(model, X)`` exactly as :func:`train` resolves them on ``device``:
    the worker-major stack for materialized faithful runs, the
    partition-major stack for deduped and ring-transported runs (the rank's
    slice over a mesh), through the data cache (so a race's thunks then hit
    it). The shape the tune plane races and resolves under (tune/races.py):
    the decision cache keys on ``tune.run_shape_signature(model, X)`` of
    THIS pair, so races and warm-run resolutions can never key apart."""
    dev = resolve_device(device)
    faithful = cfg.compute_mode == ComputeMode.FAITHFUL
    layout = build_layout(cfg)
    mesh, ring = _resolve_transport(cfg, dataset, layout, faithful, dev, mesh)
    X, _, _, _ = _device_stack(cfg, dataset, layout, faithful, dev, mesh, ring)
    return _step_model(cfg, mesh), X


def _model_axis_request(cfg: RunConfig):
    """(axis_name, shards) of the config's model-internal axis: seq for
    attention, model for the mlp's tensor parallelism, pipe for deepmlp,
    expert for moe; or None. Config validation allows at most one above
    1."""
    if cfg.seq_shards > 1:
        from erasurehead_tpu_torch.parallel.ring import SEQ_AXIS

        return SEQ_AXIS, cfg.seq_shards
    if cfg.tp_shards > 1:
        return mesh_lib.MODEL_AXIS, cfg.tp_shards
    if cfg.pp_shards > 1:
        from erasurehead_tpu_torch.models.deep_mlp import PIPE_AXIS

        return PIPE_AXIS, cfg.pp_shards
    if cfg.ep_shards > 1:
        from erasurehead_tpu_torch.models.moe import EXPERT_AXIS

        return EXPERT_AXIS, cfg.ep_shards
    return None


def _auto_2d_mesh(need: int, axis_name: str, shards: int):
    """The 2-D (workers, <axis>) mesh: ``shards`` processes a row, the
    worker axis the largest divisor of ``need`` that fits in the world (the
    JAX trainer's _auto_2d_mesh)."""
    avail = backend_lib.world_size()
    if shards > avail:
        raise ValueError(
            f"{axis_name} shards={shards} exceeds the {avail} available "
            f"devices"
        )
    per = avail // shards
    wd = max(d for d in range(1, per + 1) if need % d == 0)
    return mesh_lib.worker_plus_axis_mesh(axis_name, shards, wd)


def _step_model(cfg: RunConfig, mesh):
    """The model the round's step runs: the model-parallel copy of the
    family when the mesh carries its axis (its ``for_mesh``), else the
    plain model. Eval replay builds its own, unsharded."""
    model = build_model(cfg)
    return model.for_mesh(mesh) if hasattr(model, "for_mesh") else model


def _run_mesh(mesh, need: int, dev, axis_req=None):
    """The run's mesh: ``mesh``, or the largest group of the world's
    processes whose size divides ``need`` (the JAX trainer's _auto_mesh),
    or under a model-internal axis request ``(axis, shards)`` the 2-D mesh
    (:func:`_auto_2d_mesh`), which an explicit mesh must carry. A group
    formed for one device type never runs another's: no silent move from
    the card to the CPU."""
    if mesh is None:
        if axis_req is not None:
            mesh = _auto_2d_mesh(need, *axis_req)
        else:
            mesh = mesh_lib.auto_mesh(need)
    if axis_req is not None:
        # an explicit mesh must actually carry the requested axis: these
        # modes preserve parity, so running without them would look right
        # while testing nothing
        ax, shards = axis_req
        if ax not in mesh.axis_names or mesh.shape[ax] != shards:
            raise ValueError(
                f"requested {shards} '{ax}' shards but the mesh axes are "
                f"{dict(mesh.shape)}; pass mesh=None (auto) or a 2-D mesh "
                f"with a matching '{ax}' axis"
            )
    if mesh.device is not None and mesh.device.type != dev.type:
        raise ValueError(
            f"the process group was formed on {mesh.device.type}, and this "
            f"run asks for {dev.type}: pass the group's device"
        )
    return mesh


def _resolve_transport(cfg: RunConfig, dataset: Dataset, layout, faithful: bool, dev, mesh):
    """``(mesh, ring)``: the run's worker mesh over the axis it shards (the
    workers of a faithful run, the partitions of a deduped one) and whether
    its faithful stack takes the ring transport (sharding.
    resolve_ring_stack; ``use_pallas="on"`` pins "auto" to materialized)."""
    mesh = _run_mesh(mesh, layout.n_workers if faithful else layout.n_partitions, dev,
                     _model_axis_request(cfg))
    ring = faithful and sharding_lib.resolve_ring_stack(
        cfg.stack_mode, layout, dataset, mesh.size, cfg.resolve_stack_dtype(),
        device=dev, supported=cfg.use_pallas != "on",
    )
    return mesh, ring


def _local_weights(mesh, layout, weights: np.ndarray, faithful: bool) -> np.ndarray:
    """The rank's columns of the run's ``[R, W, S]`` (faithful) or
    ``[R, P]`` (deduped) weights, host float64: the slots its stack holds."""
    lo, hi = mesh.slice(layout.n_workers if faithful else layout.n_partitions)
    return weights[:, lo:hi]


def _ring_grad(cfg: RunConfig, model, layout, mesh, X, grad_fn, tuned: bool = True):
    """The ring transport of ``layout`` (a CodingLayout, or a stream
    window's sub-layout) around ``grad_fn`` (step.make_ring_faithful_grad_fn)
    and the resolved schedule: ``(grad_fn, "pipelined" | "sequential")``.
    ``tuned=False`` resolves "auto" without a race verdict, as the JAX
    package's streamed trainers do."""
    pipe = (step_lib.resolve_ring_pipeline(cfg.ring_pipeline, model, X) if tuned
            else step_lib.resolve_ring_pipeline(cfg.ring_pipeline))
    grad_fn = step_lib.make_ring_faithful_grad_fn(
        model, plan_ring_transport(layout, mesh.size), mesh, local_body=grad_fn,
        pipeline=pipe,
    )
    return grad_fn, "pipelined" if pipe else "sequential"


def _stack_mode(faithful: bool, ring_pipe: Optional[str]) -> str:
    """The resolved transport's name, as the JAX trainer records it."""
    if ring_pipe is not None:
        return "ring"
    return "materialized" if faithful else "deduped"


def _cache_info(cfg: RunConfig, hit: bool, stats_before: dict, X, y, faithful: bool,
                setup_seconds: float, final_params, residency: str,
                ring_pipe: Optional[str] = None) -> dict:
    """A run's ``TrainResult.cache_info``, the JAX trainer's keys but the
    executable cache's (:meth:`_LoopExec.cache_fields` adds those):
    ``stack_mode`` the resolved transport and ``ring_pipeline`` its schedule
    (None off the ring)."""
    return {
        "residency": residency,
        "enabled": cache_lib.enabled(),
        "data_hit": hit,
        "bytes_reused": cache_lib.stats().bytes_reused - stats_before["bytes_reused"],
        "stack_bytes": cache_lib.device_nbytes((X, y)),
        "setup_seconds": setup_seconds,
        "stack_mode": _stack_mode(faithful, ring_pipe),
        "ring_pipeline": ring_pipe,
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
    """The JAX package's refusal, with its message: the blockwise decode
    needs per-slot gradients, which a model on a model-internal axis does
    not take (step.supports_layer_coding)."""
    if cfg.layer_coding == "on" and not step_lib.supports_layer_coding(model):
        raise ValueError(
            "layer_coding='on' needs a model whose per-slot gradients are "
            "exact under the worker-axis step (no model-internal mesh "
            "axes; autodiff families need a jax without the implicit "
            "replicated-grad psum) — got "
            f"model={getattr(model, 'name', type(model).__name__)!r}"
        )


def _model_name(model) -> str:
    return getattr(model, "name", type(model).__name__)


def _apply_margin_flat(cfg: RunConfig, model, X, grad_fn, mesh=None):
    """Swap in the hybrid dense lowering per ``cfg.margin_flat``: "on"
    forces it (raising off the dense closed-form path), "auto" defers to
    step.resolve_margin_flat. Returns (grad_fn, swapped)."""
    if cfg.margin_flat == "on" and not step_lib.supports_margin_flat(model, X):
        raise ValueError(
            "margin_flat='on' needs a closed-form GLM on a dense stack; "
            f"got model={_model_name(model)!r}, X={type(X).__name__}"
        )
    if step_lib.resolve_margin_flat(cfg.margin_flat, model, X):
        return step_lib.make_margin_flat_grad_fn(model, mesh), True
    return grad_fn, False


def _apply_flat_grad(cfg: RunConfig, model, X, grad_fn, mesh=None):
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
        return step_lib.make_flat_grad_fn(model, mesh), True
    return grad_fn, False


def _apply_layer_coding(cfg: RunConfig, model, X, grad_fn, params_template, faithful: bool,
                        mesh=None):
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
        model, spec, faithful=faithful, fused=fused, mesh=mesh
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


def _grad_lowering(cfg: RunConfig, model, X, faithful: bool, params0, mesh=None):
    """The round's gradient fn over the stack ``X`` and the name of its
    lowering, by the ladder of the module docstring: margin-flat, then
    flat, then the fused kernel, then the blockwise decode, else the
    per-slot form, each all-reducing over ``mesh``. A streamed window takes
    the same ladder over its own stack, and a ring-transported run over its
    partition-major shard (the fill then feeds the body its worker
    slots)."""
    if faithful:
        grad_fn = step_lib.make_faithful_grad_fn(model, mesh)
    else:
        grad_fn = step_lib.make_deduped_grad_fn(model, mesh)
    lowering = "per_slot"
    grad_fn, swapped = _apply_margin_flat(cfg, model, X, grad_fn, mesh)
    lowering = "margin_flat" if swapped else lowering
    grad_fn, swapped = _apply_flat_grad(cfg, model, X, grad_fn, mesh)
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
            # a rank outside the worker group holds an empty stack and
            # never launches
            reason = None if mesh is not None and not mesh.member else (
                kernels.unsupported_reason(X.reshape((-1,) + tuple(X.shape[-2:]))))
            if reason is not None:  # no quiet fallback to the two-pass gradient
                raise ValueError(
                    f"the fused kernel declines this stack ({reason}); "
                    "use_pallas='off' takes the two-pass gradient"
                )
            grad_fn = step_lib.make_fused_grad_fn(model.name, mesh)
            lowering = "fused"
        elif cfg.use_pallas == "on":
            raise ValueError(
                "use_pallas='on' needs a dense logistic/linear stack; "
                f"got model={model.name!r}, X={type(X).__name__}"
            )
    if lowering != "fused":
        grad_fn, layer_coded = _apply_layer_coding(cfg, model, X, grad_fn, params0,
                                                   faithful, mesh)
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


def _mesh_signature(mesh, dev) -> tuple:
    """The run's mesh in the shape of the JAX package's run_start ``mesh``:
    axes, sizes, device ids (the group's ranks; cache.mesh_signature)."""
    return cache_lib.mesh_signature(mesh or mesh_lib.worker_mesh(1), dev)[:3]


def _emit_run_start(run_id, cfg: RunConfig, dev, lowering: str, stack_mode: str,
                    data_bytes: int, data_hit: bool, loop, chunk_rounds: int,
                    cohort: Optional[dict] = None, mesh=None) -> None:
    """A run's opening records, as the JAX trainer emits them: run_start,
    data_upload, the cohort record of a cohort, then the loop's compile
    records (:meth:`_LoopExec.report`; ``loop`` None emits none)."""
    obs_events.emit(
        "run_start",
        run_id=run_id,
        scheme=cfg.scheme.value,
        model=cfg.model.value,
        platform=dev.type,
        config_hash=obs_events.config_hash(cfg),
        mesh=_mesh_signature(mesh, dev),
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
        cache_hit=data_hit, ring=stack_mode == "ring",
    )
    if cohort is not None:
        obs_events.emit("cohort", run_id=run_id, **cohort)
    if loop is not None:
        loop.report(run_id, chunk_rounds)


# ---------------------------------------------------------------------------
# the round loop's executable: CUDA graphs through the executable cache

# Whether donate="auto" resolves to donating the round loop's starting carry
# (params + optimizer state) and per-round weight table (the JAX package's
# DONATE_DEFAULT): on. Once a graph run has copied them into its program's
# static buffers it releases their storage (graphs.release), so the
# duplicate is gone for the loop; the eager loop (the CPU's) releases them
# after its loop, so a read after donation raises on both. Bitwise-identical
# math, and the data cache's stacks are never donated. The JAX package's
# persistent-compilation-cache branch has no counterpart: the port writes no
# executable to disk.
DONATE_DEFAULT = True


def _resolve_donate(cfg: RunConfig) -> bool:
    if cfg.donate == "on":
        return True
    if cfg.donate == "off":
        return False
    return DONATE_DEFAULT


#: why the measured-arrival trainer keeps the eager loop
_MEASURED_EAGER = "measured arrivals: the host times each worker's message"
#: why a windowed streamed run keeps the eager loop
_STREAMED_EAGER = "streamed windows: a staging thread stages each window into new tensors"
#: why a run over a process group keeps the eager loop
_GROUP_EAGER = ("a process group: gloo cannot be captured, and NCCL capture "
                "(world 1 included) waits for ROADMAP A9b")


def _loop_mode(dev, mesh, eager_reason: Optional[str] = None) -> tuple:
    """``(mode, reason)``: how a run's round body executes, decided before
    any capture. "graph": captured CUDA graphs from the executable cache
    (train/graphs.py); "cpu": uncaptured on the CPU (graphs.run_eager),
    counted in the executable cache as the JAX package's CPU executable is;
    "eager": uncaptured, by name."""
    if graphs.is_disabled():
        return "eager", "graphs.disabled()"
    if eager_reason is not None:
        return "eager", eager_reason
    if mesh is not None and mesh.distributed:
        return "eager", _GROUP_EAGER
    if tracing.active():
        return "eager", tracing.TRACE_EAGER
    if dev.type == "cuda":
        return "graph", None
    return "cpu", None


#: why an autodiff family on a PaddedRows stack keeps the eager loop
_GATHER_EAGER = ("an autodiff family on a PaddedRows stack: its gather's gradient sizes "
                 "its scatter plan on the host each round (torch.unique_consecutive), "
                 "which a CUDA graph cannot capture")


def _host_sync_reason(model, X) -> Optional[str]:
    """Why this lowering's round reads the device from the host (seen on
    the card: its capture is invalidated), or None. Only the autodiff
    families' PaddedRows gather does (ops/features._ScatterRows); the
    closed-form GLMs' sparse plans are statics of the stack."""
    if getattr(model, "grads_via_loss", False) and isinstance(X, features_lib.PaddedRows):
        return _GATHER_EAGER
    return None


def _code_digest(layout) -> str:
    """The layout's code tables (assignment, coefficients, generator
    matrix) as a key: the on-device control plane bakes them into the
    round."""
    h = hashlib.sha256()
    for name in ("assignment", "coeffs", "B", "groups"):
        a = getattr(layout, name, None)
        if a is not None:
            h.update(name.encode() + np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()[:16]


def _release_consumed(start_leaves, final_state, extra=()) -> None:
    """Donation on the eager loop: after the loop, release the starting
    carry's leaves the final state does not hold (GD carries its momentum
    through unchanged) and ``extra`` (graphs.release)."""
    final = {id(t) for t in pytree.tree_leaves(tuple(final_state))}
    graphs.release([t for t in start_leaves if id(t) not in final] + list(extra))


def _ring_signature(layout, ring_pipe: Optional[str]) -> tuple:
    """The ring transport as a key: its plan is a function of the layout's
    assignment and the mesh (keyed apart), baked into the round, and the
    partition-major stack does not carry it."""
    if ring_pipe is None:
        return ("materialized",)
    return ("ring", np.asarray(layout.assignment).tobytes(), ring_pipe)


def _exec_signature_fields(kind: str, dev, cfg: RunConfig, model, X, y, lowering: str,
                           ring: tuple, weights_shape, mesh, state0, alpha, n_train,
                           **extra) -> dict:
    """The labelled executable-cache signature (the JAX trainer's
    ``_exec_signature_fields``): field name -> value, the key being
    ``tuple(fields.values())`` plus the chunk length. The names feed the
    recompile detector (obs/detect.py). Everything that changes the
    captured program is here: the config's static signature, the resolved
    lowering, the transport, the mesh, the state and stack shapes, the
    constants baked into the round (alpha, the row count). The learning
    rates, weights, seeds and round keys are tables the run copies in.
    ``stack`` is the port's deviation: a graph reads the data stack at its
    address, so the stack's identity (cache.stack_token) is keyed and an
    executable hit needs a data hit."""
    with tune.quiet():  # the run resolved these knobs already, with records
        lowering_sig = step_lib.lowering_signature(cfg, model, X)
    fields = {
        "kind": kind,
        "platform": dev.type,
        **cfg.static_signature_fields(),
        "lowering": lowering_sig,
        "fused": lowering == "fused",
        "ring": ring,
        "weights_shape": tuple(weights_shape),
        "mesh": cache_lib.mesh_signature(mesh or mesh_lib.worker_mesh(1), dev),
        "state_tree": cache_lib.tree_signature(state0),
        "data_tree": cache_lib.tree_signature((X, y)),
        "alpha": float(alpha),
        "n_train": int(n_train),
        "stack": cache_lib.stack_token(y),
    }
    fields.update(extra)
    return fields


class _LoopExec:
    """A run's round-loop executor: its mode (:func:`_loop_mode`), the
    program of each chunk length through the executable cache, and what the
    run reports (the compile records, the run_end and cache_info fields, the
    recompile detector's warnings)."""

    def __init__(self, mode: str, reason: Optional[str] = None, fields: Optional[dict] = None,
                 library: tuple = (0.0, True)):
        self.mode, self.reason, self.fields = mode, reason, fields
        self.library = library  # the kernel library's load: (seconds, hit)
        self.chunks: list = []  # (n, seconds, hit, memory_analysis), first use order
        self._programs: dict = {}
        self._misses: list = []

    @property
    def graph(self) -> bool:
        return self.mode == "graph"

    def program(self, n: int, build):
        """The program of chunk length ``n`` (None unless the mode is
        "graph"), looked up once per run. ``build()`` makes a
        graphs.Program on a miss."""
        if n in self._programs:
            return self._programs[n]
        if self.mode == "eager":
            self._programs[n] = None
            return None

        def compile_fn():
            t0 = time.perf_counter()
            entry = build() if self.graph else graphs.EAGER
            return entry, time.perf_counter() - t0

        key = tuple(self.fields.values()) + (n,)
        t0 = time.perf_counter()
        entry, hit = cache_lib.get_or_compile(key, compile_fn)
        seconds = time.perf_counter() - t0
        if not hit:
            self._misses.append(len(self.chunks))
        mem = entry.memory_analysis() if isinstance(entry, graphs.Program) else {}
        self.chunks.append((n, seconds, hit, {"executor": self.mode, **mem}))
        self._programs[n] = entry if self.graph else None
        return self._programs[n]

    @staticmethod
    @graphs.donates(names=("donate",))
    def run(prog, round_fn, carry, tables, consts, out, donate=()):
        """One chunk: replays of ``prog``, or ``round_fn`` uncaptured
        (graphs.run_eager) where :meth:`program` gave None. ``donate``
        goes to the program's run; an eager caller releases after its
        loop. Returns the final carry."""
        if prog is not None:
            return prog.run(carry, tables, consts, out, donate=donate)
        return graphs.run_eager(round_fn, carry, tables, consts, out)

    def report(self, run_id, chunk_rounds: int) -> None:
        """After the loop: each miss's recompile check (obs/detect.py, its
        warning emitted before its compile record) and, with a ``run_id``,
        the compile records, one per chunk length; an eager loop's one
        record is the kernel library's load and names the reason."""
        for k, (n, seconds, hit, mem) in enumerate(self.chunks):
            if k in self._misses:
                obs_detect.observe_and_warn({**self.fields, "chunk_rounds": n}, run_id)
            if run_id is not None:
                obs_events.emit("compile", run_id=run_id, seconds=round(seconds, 4),
                                cache_hit=hit, chunk_rounds=n, memory_analysis=mem)
        if self.mode == "eager" and run_id is not None:
            seconds, hit = self.library
            obs_events.emit("compile", run_id=run_id, seconds=round(seconds, 4),
                            cache_hit=hit, chunk_rounds=chunk_rounds,
                            memory_analysis={"executor": "eager", "reason": self.reason})

    def exec_fields(self) -> dict:
        """run_end's executable fields, the JAX trainer's: this run's hits
        and misses and their seconds (an eager loop: the kernel library's
        load and no lookup)."""
        if self.mode == "eager":
            return {"exec_hits": 0, "exec_misses": 0,
                    "compile_seconds": round(self.library[0], 4)}
        return {"exec_hits": sum(1 for c in self.chunks if c[2]),
                "exec_misses": sum(1 for c in self.chunks if not c[2]),
                "compile_seconds": round(sum(c[1] for c in self.chunks), 4)}

    def cache_fields(self, stats_before: dict, donate: bool) -> dict:
        """cache_info's executable fields: the JAX trainer's, and the
        executor with its reason."""
        fields = self.exec_fields()
        saved = cache_lib.stats().compile_seconds_saved - stats_before["compile_seconds_saved"]
        return {
            "exec_hits": fields["exec_hits"],
            "exec_misses": fields["exec_misses"],
            "compile_seconds": fields["compile_seconds"],
            "compile_seconds_saved": round(saved, 4),
            "donation": donate,
            "executor": self.mode,
            "eager_reason": self.reason,
            "memory_analysis": self.chunks[0][3] if self.chunks else None,
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


@graphs.donates(names=("initial_state",))
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
    mesh=None,
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
    which refuses ``pipeline_depth=1`` and a mid-schedule restart.

    ``mesh`` (parallel/mesh.WorkerMesh; None: the largest group of the
    world's processes whose size divides the sharded axis) splits the
    workers (or a deduped run's partitions) over the processes of a group:
    each rank trains on its slice and all-reduces the decoded gradient, and
    every rank returns the same params; rank 0 alone saves checkpoints,
    every rank restores them."""
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
                mesh=mesh,
            )
        if getattr(dataset, "_sweep_cache_token", None) != store.cache_token:
            dataset = store.dataset()
    layout = build_layout(cfg)
    faithful = cfg.compute_mode == ComputeMode.FAITHFUL
    mesh, ring = _resolve_transport(cfg, dataset, layout, faithful, dev, mesh)
    model = _step_model(cfg, mesh)

    # ---- control plane (host, float64, replicated on every rank) ----------
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

    # ---- data plane: the rank's slice moves to the device once ------------
    stats_before = cache_lib.stats().snapshot()
    X, y, n_train, data_hit = _device_stack(cfg, dataset, layout, faithful, dev, mesh, ring)
    weights = _to_device(
        _local_weights(mesh, layout, _round_weights(layout, slot_w, faithful), faithful),
        dev, torch.float32,
    )

    if init_params is None:
        params0 = model.init_params(cfg.seed, dataset.n_features, dev)
    else:
        params0 = params_from_numpy(init_params, dev)

    grad_fn, lowering = _grad_lowering(cfg, model, X, faithful, params0, mesh)
    ring_pipe = None
    if ring:
        grad_fn, ring_pipe = _ring_grad(cfg, model, layout, mesh, X, grad_fn)
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

    # the round loop's executable (train/graphs.py): one program per chunk
    # length from the executable cache on the card; on the CPU and on the
    # paths named eager the same round body runs uncaptured
    donate = _resolve_donate(cfg)
    loop = _LoopExec(*_loop_mode(dev, mesh, _host_sync_reason(model, X)), library=compiled)
    if loop.mode != "eager":
        loop.fields = _exec_signature_fields(
            "scan", dev, cfg, model, X, y, lowering, _ring_signature(layout, ring_pipe),
            weights.shape, mesh, state, alpha, n_train, donation=donate,
        )
    # the update's round scalars as a table: the absolute round index
    # (AGD's theta, Adam's bias correction), so a resumed run continues
    # the count
    recip = dev.type == "cuda"
    coef = _to_device(optimizer.round_table(cfg.update_rule, lr32, np.arange(cfg.rounds),
                                            alpha, n_train, recip), dev, torch.float32)
    table_update = optimizer.make_table_update_fn(cfg.update_rule, recip)

    def round_fn(carry, row, consts):
        st = carry["state"]
        p_grad = step_lib.staleness_slot_params(st.params, carry.get("stale"), depth)
        with annotate("eh_scan/coded_step"):
            g = grad_fn(p_grad, X, y, row["w"])
        with annotate("eh_scan/update"):
            new = table_update(st, g, row["coef"], alpha, n_train)
        if depth:  # the params that entered this round
            return {"state": new, "stale": st.params}, new.params
        return {"state": new}, new.params

    def as_carry(state, stale):
        return {"state": state, "stale": stale} if depth else {"state": state}

    start_leaves = pytree.tree_leaves(tuple(state))
    # chunk boundaries [start, start + every, ..., rounds]: a save between
    # chunks, none after the last; the clock covers the rounds only
    step_len = checkpoint_every or max(cfg.rounds - start_round, 1)
    bounds = list(range(start_round, cfg.rounds, step_len)) + [cfg.rounds]
    wall = 0.0
    setup_seconds = None
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        tables = {"w": weights[lo:hi], "coef": coef[lo:hi]}
        prog = loop.program(hi - lo, lambda tables=tables, n=hi - lo: graphs.Program(
            round_fn, as_carry(state, stale), tables, {}, n=n, unroll=cfg.scan_unroll,
            holds=(cache_lib.stack_token(y),)))
        graphs.sync(dev)
        t0 = time.perf_counter()
        if setup_seconds is None:
            setup_seconds = t0 - t_call
        carry = loop.run(
            prog, round_fn, as_carry(state, stale), tables, {},
            blocks.tree_map(lambda h: h[lo - start_round:hi - start_round], history),
            donate=(pytree.tree_leaves(tuple(state))
                    + ([weights, coef] if hi == cfg.rounds else []) if donate else ()),
        )
        state, stale = carry["state"], carry.get("stale")
        graphs.sync(dev)
        wall += time.perf_counter() - t0
        if checkpoint_dir and checkpoint_every and hi < cfg.rounds and mesh.rank == 0:
            ckpt_lib.save(os.path.join(checkpoint_dir, f"round_{hi}"), state, hi)
    if donate and not loop.graph:
        _release_consumed(start_leaves, state, [weights, coef])
    steps_per_sec = (cfg.rounds - start_round) / wall if wall > 0 else 0.0
    if run_id is None:
        loop.report(None, cfg.rounds - start_round)
    else:
        # after the timed loop, from host arrays and the history the run
        # already holds: the records never touch the loop
        _emit_run_start(run_id, cfg, dev, lowering, _stack_mode(faithful, ring_pipe),
                        cache_lib.device_nbytes((X, y)), data_hit, loop,
                        cfg.rounds - start_round, mesh=mesh)
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
            **loop.exec_fields(),
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
        cache_info={**_cache_info(cfg, data_hit, stats_before, X, y, faithful,
                                  setup_seconds or 0.0, state.params, residency, ring_pipe),
                    **loop.cache_fields(stats_before, donate)},
        schedule=schedule,
        run_id=run_id,
    )


def _sync(dev) -> None:
    graphs.sync(dev)


@graphs.donates(names=("initial_state",))
def train_dynamic(
    cfg: RunConfig,
    dataset: Dataset,
    *,
    device=None,
    init_params=None,
    initial_state: Optional[optimizer.OptState] = None,
    initial_round: int = 0,
    mesh=None,
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
    round index on the host, as integers, before the loop: a row of a
    device table), the rule, the [W, S] slot
    weights (step.expand_slot_weights on the device), the gradient through
    :func:`_grad_lowering`'s ladder (a dense float GLM under
    ``use_pallas="auto"`` launches the fused kernel once a round, where
    the JAX package's has no kernel path; ``layer_coding="on"`` decodes
    with the decode kernel once a round), then the update. The round's
    clock, worker stamps and mask go into [R, W] device tensors copied to
    the host once, after the loop. ``lr`` and the round index are rows of
    the update's round table, as in :func:`train`.

    ``initial_state``/``initial_round`` are :func:`train`'s mid-schedule
    restart: the loop covers [initial_round, rounds); the telemetry rows
    before it carry zero time, -1 stamps and nothing collected, and the
    history has ``rounds - initial_round`` entries. ``init_params`` as in
    :func:`train`. No decode-error series: the weights never reach the
    host. ``_sync_debug_mode`` ("warn" or "error"), on the card, runs the
    uncaptured round loop, or a graph's warm-up round, under
    ``torch.cuda.set_sync_debug_mode``: "error" raises at any operation
    that waits for the device (the check that the loop is free of host
    synchronisation; a capture refuses one in any case).

    ``mesh`` as in :func:`train`: every rank draws the same arrivals from
    the same key (the draw is replicated), takes its workers' columns of
    the round's [W, S] weights on the device, and all-reduces the decoded
    gradient."""
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
    sched_fn = dynamic_lib.make_round_schedule_fn(
        cfg.scheme, layout, cfg.num_collect, cfg.delay_mean, cfg.add_delay,
        deadline=cfg.deadline, device=dev,
    )
    stats_before = cache_lib.stats().snapshot()
    mesh, ring = _resolve_transport(cfg, dataset, layout, True, dev, mesh)
    model = _step_model(cfg, mesh)
    X, y, n_train, data_hit = _device_stack(cfg, dataset, layout, True, dev, mesh, ring)
    if init_params is None:
        params0 = model.init_params(cfg.seed, dataset.n_features, dev)
    else:
        params0 = params_from_numpy(init_params, dev)
    coeffs = _to_device(layout.coeffs, dev, torch.float32)
    slot_coded = torch.from_numpy(np.asarray(layout.slot_is_coded, dtype=bool)).to(dev)
    lo, hi = mesh.slice(layout.n_workers)  # the rank's workers of the [W, S] weights
    grad_fn, lowering = _grad_lowering(cfg, model, X, True, params0, mesh)
    ring_pipe = None
    if ring:
        grad_fn, ring_pipe = _ring_grad(cfg, model, layout, mesh, X, grad_fn)
    _prepare_lowering(dev, model, lowering, grad_fn, X, y, params0,
                      torch.zeros_like(coeffs)[lo:hi])

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
    lr32 = cfg.resolve_lr_schedule().astype(np.float32)
    alpha = cfg.effective_alpha
    key = threefry.key(cfg.seed + 1)
    history = blocks.tree_map(
        lambda p: torch.empty((n,) + tuple(p.shape), dtype=torch.float32, device=dev), params0
    )
    sim = torch.empty(n, device=dev)
    wtimes = torch.empty((n, W), device=dev)
    collected = torch.empty((n, W), dtype=torch.bool, device=dev)

    donate = _resolve_donate(cfg)
    loop = _LoopExec(*_loop_mode(dev, mesh, getattr(sched_fn, "host_sync", None)
                                 or _host_sync_reason(model, X)))
    if loop.mode != "eager":
        loop.fields = _exec_signature_fields(
            "dynamic_scan", dev, cfg, model, X, y, lowering, _ring_signature(layout, ring_pipe),
            (R,) + tuple(coeffs.shape), mesh, state, alpha, n_train, donation=donate,
            # the rule's tables and constants are baked into the round
            scheme=cfg.scheme.value, num_collect=cfg.num_collect, deadline=cfg.deadline,
            delay_mean=cfg.delay_mean, add_delay=cfg.add_delay,
            code=_code_digest(layout),
        )
    start_leaves = pytree.tree_leaves(tuple(state))
    guard = _sync_debug_mode is not None and dev.type == "cuda"
    # the round's scalars and threefry keys as tables: a round reads its
    # key on the device, as the captured program must
    recip = dev.type == "cuda"
    coef = _to_device(optimizer.round_table(cfg.update_rule, lr32[start:],
                                            np.arange(start, R), alpha, n_train, recip),
                      dev, torch.float32)
    keys = torch.tensor([threefry.fold_in(key, i) for i in range(start, R)],
                        dtype=torch.int64, device=dev).reshape(n, 2)
    tables = {"key": keys, "coef": coef}
    table_update = optimizer.make_table_update_fn(cfg.update_rule, recip)

    def round_fn(carry, row, consts):
        st = carry["state"]
        rs = sched_fn(row["key"])
        slot_w = step_lib.expand_slot_weights(rs.message_weights.float(), coeffs, slot_coded)
        g = grad_fn(st.params, X, y, slot_w[lo:hi])
        new = table_update(st, g, row["coef"], alpha, n_train)
        return {"state": new}, (new.params, rs.sim_time, rs.worker_times, rs.collected)

    prog = None
    if n > 0:
        prog = loop.program(n, lambda: graphs.Program(
            round_fn, {"state": state}, tables, {}, n=n, unroll=cfg.scan_unroll,
            holds=(cache_lib.stack_token(y),), sync_debug=_sync_debug_mode if guard else None))
    _sync(dev)
    t0 = time.perf_counter()
    if guard and prog is None:
        torch.cuda.set_sync_debug_mode(_sync_debug_mode)
    try:
        carry = loop.run(prog, round_fn, {"state": state}, tables, {},
                         (history, sim, wtimes, collected),
                         donate=start_leaves + [keys, coef] if donate else ())
    finally:
        if guard and prog is None:
            torch.cuda.set_sync_debug_mode("default")
    state = carry["state"]
    if donate and prog is None:
        _release_consumed(start_leaves, state, [keys, coef])
    _sync(dev)
    wall = time.perf_counter() - t0
    loop.report(None, n)

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
        cache_info={**_cache_info(cfg, data_hit, stats_before, X, y, True, t0 - t_call,
                                  state.params, "resident", ring_pipe),
                    **loop.cache_fields(stats_before, donate)},
    )


def _gather_sum(mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` gathered and summed in rank order: the same bits
    on every rank."""
    total = None
    for part in mesh.all_gather(t):
        total = part if total is None else total + part
    return total


def _split_like(flat: torch.Tensor, like: list) -> list:
    """``flat`` cut into tensors shaped as ``like``'s, in order."""
    out, at = [], 0
    for t in like:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


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
    mesh=None,
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

    Over a worker ``mesh`` of several processes (the JAX package's
    _train_measured_cluster) every rank is a replica of the master: it
    times only its own workers' messages, the ``[W]`` arrival row (zeros
    for the workers another rank timed) meets by ``all_gather`` and sums,
    every rank builds the same collection on the host, decodes its own
    messages with its rows of the weights (one decode launch a round), and
    the partial decoded gradients meet by ``all_gather`` and sum in rank
    order, so the replicas apply the same update bitwise. Worker ``w`` is
    timed on the rank whose slice holds it.

    Refused as in the JAX package: pipelining, the simulated heterogeneity
    knobs, deduped compute, the forced fused kernel and the forced flat
    lowerings, and schemes whose descriptor lacks ``supports_measured``
    (the partial two-part schemes); and a ``device`` list (the JAX
    package's one-process multi-device queue replay)."""
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
    if isinstance(device, (list, tuple)):
        raise ValueError(
            "arrival_mode='measured' drives one device per process; one "
            "process replaying several devices' queues waits for "
            f"{mesh_lib.A9B} (one process driving several GPUs): run one "
            "process per device instead"
        )
    dev = resolve_device(device)
    layout = build_layout(cfg)
    model = build_model(cfg)
    W = layout.n_workers
    mesh = _run_mesh(mesh, W, dev)
    lo, hi = mesh.slice(W)  # the workers this rank times
    mult = (
        np.ones(W, dtype=np.int64)
        if work_multiplier is None
        else np.asarray(work_multiplier, dtype=np.int64)
    )
    if mult.shape != (W,) or (mult < 1).any():
        raise ValueError(f"work_multiplier must be [W] ints >= 1, got {mult}")

    X, y, n_train, data_hit = _device_stack(cfg, dataset, layout, True, dev, mesh)
    if init_params is None:
        params0 = model.init_params(cfg.seed, dataset.n_features, dev)
    else:
        params0 = params_from_numpy(init_params, dev)
    # as in the JAX package, a replica in a cluster emits no records: N
    # processes appending to one log would interleave
    run_id = obs_events.new_run_id() if obs_events.active() and not mesh.distributed else None
    state = optimizer.init_state(params0, cfg.update_rule)
    update_fn = optimizer.make_update_fn(cfg.update_rule)
    lr32 = cfg.resolve_lr_schedule().astype(np.float32)
    alpha = cfg.effective_alpha
    coeffs = np.asarray(layout.coeffs)
    slot_coded = np.asarray(layout.slot_is_coded)
    keys = tuple(sorted(params0)) if isinstance(params0, dict) else None  # decode order
    worker_msg = _make_worker_msg(model)
    slices = [(features_lib.take_lead(X, j), y[j]) for j in range(hi - lo)]

    # warm every worker's computation before the clock (autodiff imports,
    # a sparse stack's scatter plans, the library's load): measured times
    # are then steady-state compute
    if dev.type == "cuda":
        kernels.load_library()
    step_lib.warm_autodiff()
    for w, (Xs, ys) in enumerate(slices, start=lo):
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
        for w, (Xs, ys) in enumerate(slices, start=lo):
            t0 = _clock()
            m = worker_msg(state.params, Xs, ys, n=int(mult[w]))
            _sync(dev)
            t_row[w] = _clock() - t0
            msgs.append(m)
        if mesh.distributed:
            # one rank timed each worker, the rest hold zeros there
            t_row = _gather_sum(mesh, torch.from_numpy(t_row).to(dev)).cpu().numpy()
        sched = build_schedule(cfg, (t_row + delays[r])[None, :], layout)
        slot_w = step_lib.expand_slot_weights(sched.message_weights, coeffs, slot_coded)[0]
        if msgs:
            leaves = [torch.stack(ls) for ls in zip(*(blocks.tree_leaves(m) for m in msgs))]
            parts = kernels.fused_block_decode_leaves(
                _to_device(slot_w[lo:hi], dev, torch.float32), leaves)
        else:
            parts = [torch.zeros_like(p) for p in blocks.tree_leaves(state.params)]
        if mesh.distributed:
            # the distributed Gather + decode: the ranks' partials, summed
            parts = _split_like(_gather_sum(mesh, torch.cat([p.reshape(-1) for p in parts])),
                                parts)
        g = blocks.tree_unflatten(keys, parts)
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
        cache_info={"executor": "eager", "eager_reason": _MEASURED_EAGER},
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
    kernel (``use_pallas="on"``), the forced blockwise decode
    (``layer_coding="on"``) and the model-internal axes (a 2-D mesh),
    naming the knob that led to the streamed path."""
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
    if _model_axis_request(cfg) is not None:
        raise ValueError(
            "streamed windows have no model-parallel (2-D mesh) body; "
            f"{_stream_remedy(cfg)}"
        )


def _make_stream_put(plan, dev, quantize: bool, data_dtype: torch.dtype, shard=None):
    """The host-to-device transfer of one staged window (it runs on the
    prefetch staging thread; the per-run and cohort streamed trainers share
    it). The staged partition-major span (as ``read_ranges`` returns it) is
    copied as it is: a deduped window and a ring window (whose slots the
    ring transport rebuilds every round) stay partition-major. A
    materialized faithful window then gathers the slot-group's worker-major
    ``[gw, S, rows, F]`` view on the device through the plan's local
    assignment, or through ``shard``'s (data/sharding.WindowShard: a rank's
    workers over the positions it staged). (The JAX package gathers on the
    host and sends (s+1)x the bytes; a gather is exact, so the bits are the
    same.) An int8 store's window brings its ``(q, scale)``; a float32
    window of an int8 run is quantized per partition on the host before the
    gather, as the resident path does. Labels take the data dtype and then
    float32, as in the resident stack. Every tensor is a fresh copy: the
    host buffers are refilled."""
    local = None
    if plan.mode == "materialized":
        local = torch.from_numpy(np.asarray(
            plan.local_assignment if shard is None else shard.local_assignment))

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


def _resolve_stream_ring(cfg: RunConfig, layout) -> bool:
    """The transport of a streamed faithful run (the JAX trainer's rule):
    "ring" forces the ring, "materialized" forbids it, and "auto" takes it
    whenever the assignment duplicates partitions (storage overhead above
    1). A streamed stack never resides whole, so the resident footprint
    gate does not apply: the staged window carries each partition once and
    the (s+1)x redundancy exists only in the round's rebuilt slots."""
    if cfg.stack_mode == "ring":
        return True
    if cfg.stack_mode != "auto":
        return False
    return float(layout.storage_overhead) > 1.0


@dataclasses.dataclass
class _StreamPlan:
    """What the per-run and cohort streamed trainers share: the window plan,
    the worker mesh and this rank's share of each window, the chunks of
    rounds and the window each consumes, the storage."""

    plan: object  # data/sharding.StreamWindowPlan
    mesh: object  # parallel/mesh.WorkerMesh
    shard: object  # data/sharding.WindowShard: what this rank stages
    chunks: list  # [(lo, hi)] round ranges
    win_of: list  # the window each chunk consumes
    round_win: np.ndarray  # [R] the window each round reads
    stack_dtype: str
    data_dtype: torch.dtype

    @property
    def mode(self) -> str:
        return self.plan.mode

    @property
    def faithful(self) -> bool:
        """Does the round's body take worker slots (materialized or
        ring-filled)?"""
        return self.plan.mode != "deduped"

    @property
    def windows(self) -> list:
        """The prefetcher's consume-order list of this rank's ranges."""
        return [self.shard.ranges[k] for k in self.win_of]

    def local_weights(self, weights: np.ndarray) -> np.ndarray:
        """This rank's columns of per-round window weights, ``[R, ...]``
        with the window's partitions (deduped) or the slot-group's workers
        (faithful) on axis ``-2`` of a faithful ``[.., gw, S]`` or the last
        axis of a deduped ``[.., window]`` table."""
        axis = weights.ndim - (2 if self.faithful else 1)
        n = weights.shape[axis]
        lo, hi = self.mesh.slice(n)
        return np.take(weights, np.arange(lo, hi), axis=axis)


def _plan_stream(cfg: RunConfig, layout, store, window: int, dev, mesh=None) -> _StreamPlan:
    """The window plan of a streamed run, its worker mesh, and its chunks of
    rounds: each chunk of ``L = max(1, rounds // n_windows)`` rounds
    consumes one window, chunk i window ``i mod n_windows`` (fewer rounds
    visit a prefix of the windows), as in the JAX package.

    ``mesh=None`` is the JAX trainer's rule with the port's "largest group
    whose size divides the axis": a deduped run splits the window's
    partitions, a materialized faithful run the slot-group's workers, a
    ring run ``gcd(group workers, staged partitions)`` (the sub-ring plan
    shards both). An explicit mesh must fold the same axes (JAX's
    refusals), and a 2-D mesh has no windowed body."""
    _check_streamed_compat(cfg)
    faithful = cfg.compute_mode == ComputeMode.FAITHFUL
    try:
        mode = "deduped"
        if faithful:
            mode = "ring" if _resolve_stream_ring(cfg, layout) else "materialized"
        plan = plan_stream_windows(layout, window, mode=mode)
    except ValueError as e:
        raise ValueError(f"{e} — or {_stream_remedy(cfg)}") from None
    gw = plan.group_workers
    if mesh is not None and mesh.axis_name is not None:
        raise ValueError(
            "streamed windows have no model-parallel (2-D mesh) body; "
            f"{_stream_remedy(cfg)}"
        )
    need = (window if mode == "deduped" else gw if mode == "materialized"
            else math.gcd(gw, plan.staged_partitions))
    mesh = _run_mesh(mesh, need, dev)
    if mode == "deduped":
        mesh_lib.check_divisible(window, mesh, "stream_window")
    else:
        mesh_lib.check_divisible(gw, mesh, "stream slot-group workers")
        if mode == "ring":
            mesh_lib.check_divisible(plan.staged_partitions, mesh, "staged stream window")
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
        plan=plan, mesh=mesh, shard=plan.shard(mesh.index, mesh.size), chunks=chunks,
        win_of=win_of, round_win=round_win, stack_dtype=stack_dtype,
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
                       pf_stats: dict, peak: Optional[int],
                       ring_pipe: Optional[str] = None) -> dict:
    """A streamed run's ``cache_info``: the JAX trainer's keys (without the
    executable cache's: the windows run the eager loop, named), and the
    device's peak bytes over the round loop
    above its start (cuda; None on the CPU). ``stack_bytes`` and
    ``prefetch`` are this rank's: what it staged."""
    plan = sp.plan
    return {
        "enabled": cache_lib.enabled(),
        # windows are transient by design: caching them would defeat the
        # residency bound
        "data_hit": False,
        "bytes_reused": 0,
        # device bytes of one staged window on this rank (for a
        # materialized plan its workers' worker-major gather, for a ring
        # plan its partition-major share of window and halo)
        "stack_bytes": window_nbytes,
        "setup_seconds": setup_seconds,
        "stack_mode": plan.mode,
        "stack_dtype": sp.stack_dtype,
        "ring_pipeline": ring_pipe,
        "pipeline_depth": 0,
        "pipeline_params_slot_bytes": 0,
        "residency": "streamed",
        "stream_window": plan.window,
        "n_windows": plan.n_windows,
        "stream_halo": plan.halo,
        "stream_group_workers": plan.group_workers,
        "stream_staged_partitions": sp.shard.n_partitions,
        "prefetch": pf_stats,
        "device_peak_bytes": peak,
        "executor": "eager",
        "eager_reason": _STREAMED_EAGER,
    }


class _NoWindows:
    """The window source of a rank outside the worker group: it stages
    nothing, and every window is an empty stack of the store's kind (the
    rank's round adds exact zeros to the all-reduce)."""

    records: tuple = ()

    def __init__(self, store, dev, data_dtype: torch.dtype):
        rows, F = store.rows_per_partition, store.n_features
        if store.quantized:
            self._X = features_lib.QuantizedStack(
                torch.zeros((0, rows, F), dtype=torch.int8, device=dev),
                torch.zeros((0, F), dtype=torch.float32, device=dev))
        else:
            self._X = torch.zeros((0, rows, F), dtype=data_dtype, device=dev)
        self._y = torch.zeros((0, rows), dtype=torch.float32, device=dev)

    def get(self, i: int):
        return self._X, self._y

    def stats(self) -> dict:
        return {"windows": 0, "bytes": 0, "fetch_s": 0.0, "blocked_s": 0.0,
                "overlap_efficiency": 1.0}

    def close(self) -> None:
        pass


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

    Each rank stages only its share of every window (``sp.shard``) through
    its own prefetcher against the shared store; a rank outside the worker
    group stages nothing (:class:`_NoWindows`).

    Returns ``(wall, setup_seconds, window_nbytes, prefetch stats, peak,
    staging records)``, the last data/prefetch.Prefetcher.records (each
    window's held ``io`` record and its ``prefetch`` payload), which the
    caller emits after the loop."""
    cuda = dev.type == "cuda"
    base = None
    if cuda:
        _sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    if sp.shard.n_partitions:
        pf = Prefetcher(store, sp.windows, put, device=dev, plan_fields=sp.plan.event_fields())
    else:
        pf = _NoWindows(store, dev, sp.data_dtype)
    wall = 0.0
    try:
        X, y = pf.get(0)
        window_nbytes = cache_lib.device_nbytes((X, y))
        setup(X, y)
        setup_seconds = None
        for i, (lo, hi) in enumerate(sp.chunks):
            _sync(dev)
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
            _sync(dev)
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
    mesh=None,
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
    are the plan's slot-groups, each decoded by its own least-squares
    weights (:func:`_stream_group_slot_weights`). A materialized window is
    gathered worker-major on the device; a ring window
    (:func:`_resolve_stream_ring`) stays partition-major, window plus halo,
    and every round the ring transport rebuilds the slot-group's worker
    slots from it (step.make_ring_faithful_grad_fn over the plan's
    sub-layout; a full-cover ring window is bitwise the resident ring
    run). The round's gradient takes the resident ladder over the window's
    stack (:func:`_grad_lowering`): a dense float GLM under
    ``use_pallas="auto"`` goes through the fused kernel, one launch a round
    (where the JAX package's auto declines its kernel here), an int8
    window its dequantizing lowering.

    ``mesh`` (None: :func:`_plan_stream`'s rule) splits each window over
    the worker mesh: every rank stages only its share (its partitions, the
    partitions its workers' slots read, or its span of the staged
    partitions for the ring), computes its local decoded gradient and
    all-reduces it, as the resident trainer does; every rank returns the
    same params. Refused, with JAX's messages: the forced kernel and the
    forced blockwise decode (:func:`_check_streamed_compat`), a 2-D mesh,
    a mesh that does not fold the window, assignments that are not
    window-uniform (the planner), ``checkpoint_dir``, ``resume`` and a
    mid-schedule restart (``initial_state``/``initial_round``)."""
    t_call = time.perf_counter()
    _check_streamed_compat(cfg)
    if checkpoint_dir or resume or initial_state is not None or initial_round:
        raise ValueError(
            "checkpoint/resume/mid-schedule restart are not supported on "
            "the windowed streamed path (kill→resume recovery is the "
            "sweep journal's trajectory rehydration; see "
            "tools/outofcore_smoke.py)"
        )
    dev = resolve_device(device)
    layout = build_layout(cfg)
    sp = _plan_stream(cfg, layout, store, window, dev, mesh)
    mesh = sp.mesh
    model = _step_model(cfg, mesh)

    # ---- control plane: the resident trainer's, then the window's slices
    if arrivals is None:
        arrivals = default_arrivals(cfg)
    if schedule is None:
        schedule = build_schedule(cfg, arrivals, layout)
    decode_err = obs_decode.decode_error_series(layout, schedule.message_weights)
    lr32 = cfg.resolve_lr_schedule().astype(np.float32)
    alpha = cfg.effective_alpha
    n_train = window * store.rows_per_partition  # the block a round averages
    weights = _to_device(sp.local_weights(_stream_round_weights(sp, layout, schedule)),
                         dev, torch.float32)

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
        grad_fn, run["lowering"] = _grad_lowering(cfg, model, X0, sp.faithful, params0, mesh)
        run["ring_pipe"] = None
        if sp.mode == "ring":
            grad_fn, run["ring_pipe"] = _ring_grad(cfg, model, sp.plan.sub_layout(), mesh, X0,
                                                   grad_fn, tuned=False)
        run["grad_fn"] = grad_fn
        run["loop"] = _LoopExec("eager", _STREAMED_EAGER, library=_prepare_lowering(
            dev, model, run["lowering"], grad_fn, X0, y0, params0, weights[0]))

    def grad_r(r, X, y):
        return run["grad_fn"](state.params, X, y, weights[r])

    def update_r(r, g):
        nonlocal state
        state = update_fn(state, g, float(lr32[r]), alpha, n_train, float(r))
        blocks.tree_map(lambda h, p: h[r].copy_(p), history, state.params)

    run_id = obs_events.new_run_id() if obs_events.active() else None
    put = _make_stream_put(sp.plan, dev, sp.stack_dtype == "int8", sp.data_dtype, sp.shard)
    wall, setup_seconds, window_nbytes, pf_stats, peak, staged = _stream_loop(
        dev, store, sp, put, setup, grad_r, update_r, t_call
    )
    steps_per_sec = cfg.rounds / wall if wall > 0 else 0.0
    if run_id is not None:
        _emit_run_start(run_id, cfg, dev, run["lowering"], sp.mode, window_nbytes, False,
                        run["loop"], cfg.rounds, mesh=mesh)
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
            **run["loop"].exec_fields(),
            **obs_decode.summarize(decode_err),
        )
        # the timed loop includes the staging waits; the prefetcher's
        # blocked_s is exactly the part the double buffer failed to hide
        obs_cpath.emit_event(run_id, obs_cpath.attribute(
            schedule.sim_time, schedule.worker_times, schedule.collected, wall_s=wall,
            prefetch_stall_s=float(pf_stats.get("blocked_s", 0.0)),
            transport="ring" if sp.mode == "ring" else "none",
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
        cache_info=_stream_cache_info(sp, window_nbytes, setup_seconds, pf_stats, peak,
                                      run["ring_pipe"]),
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

    Deduped runs and explicitly ring-streamed faithful runs keep the
    partition-major stack; other faithful runs pay the (s+1)x worker-major
    stack (``stack_mode="auto"`` is charged at the materialized footprint,
    as in the JAX package). bfloat16 counts 2 bytes an element, int8 1 plus
    its float32 scale rows (data/sharding.estimate_worker_stack_bytes).
    Streamed-residency runs are charged their resident WINDOWS, at most two
    (the one computing and the one in flight), never the whole stack, over
    the whole dispatch (every rank's share together): a partition-major
    window is charged staged (window and halo for a ring window), a
    materialized faithful window its slot-group's worker gather,
    ``2/n_windows`` of the worker stack. A pipelined run adds its stale params slot. An
    estimate, not an accounting: the daemon refines it per signature with
    the measured peak of a dispatch on the card."""
    layout = build_layout(cfg)
    dtype_name = cfg.resolve_stack_dtype()
    worker_stack_est = sharding_lib.estimate_worker_stack_bytes(dataset, layout, dtype_name)
    per_block = worker_stack_est / max(1, layout.n_workers * layout.n_slots)
    partition_major = cfg.compute_mode != ComputeMode.FAITHFUL or cfg.stack_mode == "ring"
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
            # a staged window's device bytes are its span: window and halo
            # for the ring fill (deduped windows have no halo)
            staged = w
            if cfg.compute_mode == ComputeMode.FAITHFUL:
                try:
                    staged = plan_stream_windows(layout, w, mode="ring").staged_partitions
                except ValueError:
                    pass  # the run itself will refuse; charge the window
            blocks_n = min(blocks_n, 2 * staged)
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
    decode or a model-internal axis (no windowed body), and only where the scheme's descriptor
    allows it (``cohort_batchable``). Streamed runs batch: trajectories of
    one store and window plan ride one windowed cohort loop
    (:func:`_train_cohort_streamed`), and ``static_signature`` carries the
    residency knobs, so they never group with resident ones. Measured-
    arrival runs time each worker on its own and never batch."""
    if _resolve_residency(cfg) == "streamed" and (
        cfg.layer_coding == "on" or _model_axis_request(cfg) is not None
    ):
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


def _stack_signature(cfg: RunConfig, layout, ring: bool = False) -> tuple:
    return cache_lib.layout_stack_signature(
        layout, worker_major=cfg.compute_mode == ComputeMode.FAITHFUL and not ring,
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
    scalar coefficients are formed in float32, where train()'s round table
    forms them in double."""
    lr_B = _to_device(
        np.stack([c.resolve_lr_schedule() for c in cfgs], axis=1), dev, torch.float32
    )
    alpha_B = _to_device(np.array([c.effective_alpha for c in cfgs]), dev, torch.float32)
    return lr_B, alpha_B


def _cohort_fields(B: int, lowering: str, faithful: bool,
                   ring_pipe: Optional[str] = None) -> dict:
    return {
        "cohort_size": B,
        "cohort_lowering": lowering,
        "cohort_dispatches": 1,
        "stack_mode": _stack_mode(faithful, ring_pipe),
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
                 loop: "_LoopExec", stack_bytes: int, prefetch_stall_s: float = 0.0,
                 staged=(), mesh=None) -> None:
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
    _emit_run_start(run_id, cfg, dev, lowering, stack_mode, stack_bytes, data_hit, loop,
                    cfg.rounds, cohort=cohort, mesh=mesh)
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
        **loop.exec_fields(),
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


def _cohort_lowering(cfg: RunConfig, model, X, y, faithful: bool, params0, w0, dev,
                     mesh=None, layout=None, ring: bool = False):
    """The cohort's gradient fn over the stack ``X``, its lowering
    (step.make_cohort_grad_fn, all-reducing over ``mesh``), its compile step
    (:func:`_load_kernels`) and the ring schedule (None off the ring: a
    ``ring`` cohort fills its worker slots from the partition-major ``X``
    and ``layout``'s plan), with the set-up before the clock starts: build
    the kernels, import torch.func, build a sparse stack's scatter plans."""
    if cfg.flat_grad == "on" and not step_lib.supports_flat_grad(model, X):
        raise ValueError(
            "flat_grad='on' needs a closed-form GLM stack; "
            f"got model={_model_name(model)!r}, X={type(X).__name__}"
        )
    _check_layer_coding(cfg, model)
    grad_fn, lowering = step_lib.make_cohort_grad_fn(
        model, blocks.tree_map(lambda p: p[0], params0), X, faithful=faithful,
        layer_coding=cfg.layer_coding, block_decode=cfg.block_decode,
        flat_grad=cfg.flat_grad, mesh=mesh,
    )
    ring_pipe = None
    if ring:
        grad_fn, ring_pipe = _ring_grad(cfg, model, layout, mesh, X, grad_fn)
    compiled = _load_kernels(dev, lowering == "layer_block_vmap")
    step_lib.warm_autodiff()
    _prepare_sparse(X, grad_fn, params0, y, w0)
    return grad_fn, lowering, compiled, ring_pipe


def _train_cohort_streamed(cfgs, store, window: int, *, arrivals, device, init_params,
                           t_call: float, mesh=None) -> list:
    """A cohort over a shard store's windows: the streamed counterpart of
    the resident cohort loop. One prefetch stream and one staging a chunk
    serve all B trajectories; each trajectory's rounds are
    :func:`_train_streamed`'s block training exactly (the same window plan,
    mesh, chunks, window cycle and per-window weights: deduped the window's
    columns of ``[R, B, P]``, faithful each trajectory's slot-group
    decode), its gradient one cohort body over the window's stack (the
    cohort matmul for a dense GLM; no blockwise form; a ring window's slots
    rebuilt by the ring transport first), its update the vmapped one. Over
    a worker ``mesh`` each rank stages its share of the window and the B
    decoded gradients are all-reduced in one collective a round. Members
    match their sequential streamed runs to float tolerance."""
    _check_streamed_compat(cfgs[0])
    # the same chaos site as the resident cohort dispatch: a raise exercises
    # compare()'s bisection (experiments._dispatch_cohort)
    chaos_lib.maybe_fire("cohort")
    cfg = cfgs[0]
    dev = device
    layouts = _cohort_layouts(cfgs)
    sp = _plan_stream(cfg, layouts[0], store, window, dev, mesh)
    mesh = sp.mesh
    schedules = _cohort_schedules(cfgs, layouts, arrivals)
    weights = _to_device(
        sp.local_weights(np.stack([_stream_round_weights(sp, lay, sched)
                                   for lay, sched in zip(layouts, schedules)], axis=1)),
        dev, torch.float32,
    )  # [R, B, window] (deduped) or [R, B, gw, S] (faithful), this rank's columns
    lr_B, alpha_B = _cohort_lr_alpha(cfgs, dev)
    n_train = window * store.rows_per_partition
    model = _step_model(cfg, mesh)
    params0 = _cohort_params(model, cfgs, init_params, store.n_features, dev)
    state = optimizer.init_state(params0, cfg.update_rule)
    update_fn = optimizer.make_cohort_update_fn(cfg.update_rule)
    history = blocks.tree_map(
        lambda p: torch.empty((cfg.rounds,) + tuple(p.shape), dtype=torch.float32, device=dev),
        params0,
    )  # leaves [R, B, ...]
    run = {}

    def setup(X0, y0):
        grad_fn, run["lowering"], library, _ = _cohort_lowering(
            cfg, model, X0, y0, sp.faithful, params0, weights[0], dev, mesh)
        run["loop"] = _LoopExec("eager", _STREAMED_EAGER, library=library)
        run["ring_pipe"] = None
        if sp.mode == "ring":
            grad_fn, run["ring_pipe"] = _ring_grad(cfg, model, sp.plan.sub_layout(), mesh, X0,
                                                   grad_fn, tuned=False)
        run["grad_fn"] = grad_fn

    def grad_r(r, X, y):
        return run["grad_fn"](state.params, X, y, weights[r])

    def update_r(r, g):
        nonlocal state
        state = update_fn(state, g, lr_B[r], alpha_B, n_train, float(r))
        blocks.tree_map(lambda h, p: h[r].copy_(p), history, state.params)

    run_id = obs_events.new_run_id() if obs_events.active() else None
    put = _make_stream_put(sp.plan, dev, sp.stack_dtype == "int8", sp.data_dtype, sp.shard)
    wall, setup_seconds, window_nbytes, pf_stats, peak, staged = _stream_loop(
        dev, store, sp, put, setup, grad_r, update_r, t_call
    )
    cohort = _cohort_fields(len(cfgs), run["lowering"], sp.faithful, run["ring_pipe"])
    cache_info = _stream_cache_info(sp, window_nbytes, setup_seconds, pf_stats, peak,
                                    run["ring_pipe"])
    results = _cohort_results(cfgs, schedules, layouts, state, history, wall, n_train,
                              run["lowering"], cohort, {**cache_info, **cohort}, run_id)
    if run_id is not None:
        _emit_cohort(run_id, cfgs, results, dev, sp.mode, False,
                     run["loop"], window_nbytes,
                     prefetch_stall_s=float(pf_stats.get("blocked_s", 0.0)), staged=staged,
                     mesh=mesh)
    return results


def train_cohort(
    cfgs: Sequence[RunConfig] | RunConfig,
    dataset: Dataset,
    seeds=None,
    arrivals=None,
    *,
    device=None,
    init_params=None,
    mesh=None,
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
    one the windowed cohort loop (:func:`_train_cohort_streamed`).

    ``mesh`` as in :func:`train`: each rank holds its slice of the shared
    stack and of every trajectory's weights, and the B decoded gradients
    are all-reduced in one collective a round."""
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
                init_params=init_params, t_call=t_call, mesh=mesh,
            )
        if getattr(dataset, "_sweep_cache_token", None) != store.cache_token:
            dataset = store.dataset()
    # chaos site "cohort": a kill here is a preemption mid-cohort (nothing of
    # the cohort persisted); a raise whose message names an out-of-memory
    # marker exercises compare()'s bisection (experiments._dispatch_cohort)
    chaos_lib.maybe_fire("cohort")
    faithful = cfg.compute_mode == ComputeMode.FAITHFUL
    layouts = _cohort_layouts(cfgs)
    mesh, ring = _resolve_transport(cfg, dataset, layouts[0], faithful, dev, mesh)

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
    lo, hi = mesh.slice(layouts[0].n_workers if faithful else layouts[0].n_partitions)
    weights_h = weights_h[:, :, lo:hi]  # the rank's slots
    lr_B, alpha_B = _cohort_lr_alpha(cfgs, dev)

    # ---- data plane: one stack for the cohort ------------------------------
    stats_before = cache_lib.stats().snapshot()
    X, y, n_train, data_hit = _device_stack(cfg, dataset, layouts[0], faithful, dev, mesh, ring)
    weights = _to_device(weights_h, dev, torch.float32)
    model = _step_model(cfg, mesh)
    params0 = _cohort_params(model, cfgs, init_params, dataset.n_features, dev)
    grad_fn, lowering, compiled, ring_pipe = _cohort_lowering(
        cfg, model, X, y, faithful, params0, weights[0], dev, mesh, layouts[0], ring)
    run_id = obs_events.new_run_id() if obs_events.active() else None

    state = optimizer.init_state(params0, cfg.update_rule)
    history = blocks.tree_map(
        lambda p: torch.empty((cfg.rounds,) + tuple(p.shape), dtype=torch.float32, device=dev),
        params0,
    )  # leaves [R, B, ...]

    donate = _resolve_donate(cfg)
    loop = _LoopExec(*_loop_mode(dev, mesh, _host_sync_reason(model, X)), library=compiled)
    if loop.mode != "eager":
        loop.fields = _exec_signature_fields(
            "cohort_scan", dev, cfg, model, X, y, lowering,
            _ring_signature(layouts[0], ring_pipe), weights.shape, mesh, state, 0.0, n_train,
            donation=donate, batch_size=B, chunk_rounds=cfg.rounds, cohort_lowering=lowering,
        )
    # the round-index scalars shared by the cohort as a table
    recip = dev.type == "cuda"
    coef = _to_device(optimizer.cohort_round_table(cfg.update_rule, np.arange(cfg.rounds),
                                                   recip), dev, torch.float32)
    table_update = optimizer.make_cohort_table_update_fn(cfg.update_rule, recip)

    def round_fn(carry, row, consts):
        st = carry["state"]
        with annotate("eh_scan/coded_step"):
            g = grad_fn(st.params, X, y, row["w"])
        with annotate("eh_scan/update"):
            new = table_update(st, g, row["lr"], consts["alpha"], n_train, row["coef"])
        return {"state": new}, new.params

    tables = {"w": weights, "lr": lr_B, "coef": coef}
    prog = loop.program(cfg.rounds, lambda: graphs.Program(
        round_fn, {"state": state}, tables, {"alpha": alpha_B}, n=cfg.rounds,
        unroll=cfg.scan_unroll, holds=(cache_lib.stack_token(y),)))
    start_leaves = pytree.tree_leaves(tuple(state))

    _sync(dev)
    t0 = time.perf_counter()
    cache_info = _cache_info(cfg, data_hit, stats_before, X, y, faithful, t0 - t_call, None,
                             residency, ring_pipe)
    carry = loop.run(prog, round_fn, {"state": state}, tables, {"alpha": alpha_B}, history,
                     donate=start_leaves + [weights, coef] if donate else ())
    state = carry["state"]
    if donate and prog is None:
        _release_consumed(start_leaves, state, [weights, coef])
    _sync(dev)
    wall = time.perf_counter() - t0
    if run_id is None:
        loop.report(None, cfg.rounds)
    cache_info.update(loop.cache_fields(stats_before, donate))

    cohort = _cohort_fields(B, lowering, faithful, ring_pipe)
    results = _cohort_results(cfgs, schedules, layouts, state, history, wall, n_train,
                              lowering, cohort, {**cache_info, **cohort}, run_id)
    if run_id is not None:
        _emit_cohort(run_id, cfgs, results, dev, cache_info["stack_mode"], data_hit,
                     loop, cache_info["stack_bytes"], mesh=mesh)
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
