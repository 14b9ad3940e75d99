"""The synchronous trainer: a Python loop over rounds on one device.

The counterpart of erasurehead_tpu/train/trainer.py::train, and of its
trajectory-cohort engine (train_cohort, train_batch; see
:func:`train_cohort`). Control plane
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
    ``use_pallas="on"`` with ``flat_grad="on"``. A sparse (PaddedRows,
    FieldOnehot) or int8 (QuantizedStack) stack is not a dense tensor:
    under "auto" it takes its own lowering and no kernel;
  - otherwise ``layer_coding`` "on" takes the blockwise decode
    (step.make_layer_block_grad_fn): per-slot gradient trees decoded in
    place by the decode kernel (ops/kernels.fused_block_decode_leaves), one
    launch per round for all leaves ("fused") or for the packed block table
    ("treewise");
  - otherwise the monolithic PyTorch gradient (step.make_faithful_grad_fn /
    make_deduped_grad_fn).

Params are the GLM's [F] tensor or the deep families' dict of tensors; the
iterate history is then an [R, F] tensor or a dict of [R, ...] tensors.

Checkpoint/resume (:func:`train`'s ``checkpoint_dir``, ``checkpoint_every``
and ``resume``; train/checkpoint.py): the round loop runs in chunks of
``checkpoint_every`` rounds with a save between chunks, and a resumed run
starts at the restored round; its history covers [start_round, rounds).

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
import time
from typing import Optional, Sequence

import numpy as np
import torch

from erasurehead_tpu_torch import schemes
from erasurehead_tpu_torch.data.sharding import partition_stack, worker_stack
from erasurehead_tpu_torch.data.synthetic import Dataset
from erasurehead_tpu_torch.models.attention import AttentionModel
from erasurehead_tpu_torch.models.deep_mlp import DeepMLPModel
from erasurehead_tpu_torch.models.glm import LinearModel, LogisticModel, params_from_numpy
from erasurehead_tpu_torch.models.mlp import MLPModel
from erasurehead_tpu_torch.models.moe import MoEModel
from erasurehead_tpu_torch.obs import decode as obs_decode
from erasurehead_tpu_torch.ops import blocks, codes, kernels
from erasurehead_tpu_torch.ops import features as features_lib
from erasurehead_tpu_torch.parallel import collect, step as step_lib, straggler
from erasurehead_tpu_torch.train import checkpoint as ckpt_lib
from erasurehead_tpu_torch.train import optimizer
from erasurehead_tpu_torch.train.cache import layout_stack_signature
from erasurehead_tpu_torch.utils import chaos as chaos_lib
from erasurehead_tpu_torch.utils.config import (
    ComputeMode,
    ModelKind,
    RunConfig,
    resolve_arrival_trace,
)
from erasurehead_tpu_torch.utils.device import resolve_device


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
    desc = schemes.get(cfg.scheme)
    sched = desc.build_schedule(
        t, layout, num_collect=cfg.num_collect, deadline=cfg.deadline
    )
    if cfg.decode == "optimal" and desc.optimal_decode is not None:
        sched = desc.optimal_decode(sched, layout)
    return sched


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
    # "margin_flat" or "per_slot" (a cohort member: the cohort's lowering)
    lowering: str = "per_slot"
    # a cohort member's dispatch (train_cohort): cohort_size,
    # cohort_lowering, cohort_dispatches, stack_mode; None for train()
    cohort: Optional[dict] = None

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


def _device_stack(cfg: RunConfig, dataset: Dataset, layout, faithful: bool, dev):
    """The run's data stack, moved to the device once: worker-major
    [W, S, rows, F] (faithful) or partition-major [P, rows, F], its labels,
    and the training row count (the JAX package's shard_run_data on one
    device). A CSR dataset stacks as PaddedRows or FieldOnehot per
    ``cfg.sparse_format`` (a FieldOnehot stack carries the run's
    ``fields_margin``/``fields_scatter``/``sparse_lanes``); under
    ``stack_dtype="int8"`` the partition-major stack is quantized before
    the worker-major gather (ops/features.QuantizedStack), so every slot
    holds its partition's int8 values and scales."""
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
        Xp_h = features_lib.QuantizedStack.quantize(Xp_h)
    Xh, yh = worker_stack(layout, Xp_h, yp_h) if faithful else (Xp_h, yp_h)
    # the data dtype: the stored float dtype, or cfg.dtype under int8
    data_dtype = _torch_dtype(cfg.dtype if stack_dtype == "int8" else stack_dtype)
    X = features_lib.to_device(Xh, dev, data_dtype)
    if isinstance(X, features_lib.FieldOnehot):
        X = X.with_lowering(cfg.fields_margin, cfg.fields_scatter, cfg.sparse_lanes)
    # labels ride along the data dtype (as in the JAX package), then stay
    # float32 for the residual
    y = _to_device(yh, dev, data_dtype).float()
    return X, y, yp_h.size


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


def _apply_layer_coding(cfg: RunConfig, model, grad_fn, params_template, faithful: bool):
    """Swap in the blockwise decode (step.make_layer_block_grad_fn) per
    ``cfg.layer_coding``; ``cfg.block_decode`` picks its lowering. Returns
    (grad_fn, layer_coded)."""
    _check_layer_coding(cfg, model)
    if not step_lib.resolve_layer_coding(cfg.layer_coding, model):
        return grad_fn, False
    spec = blocks.model_block_spec(model, params_template)
    fused = step_lib.resolve_block_decode(cfg.block_decode)
    return step_lib.make_layer_block_grad_fn(
        model, spec, faithful=faithful, fused=fused
    ), True


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
    ``steps_per_sec`` leaves the checkpoint I/O out."""
    if checkpoint_every is not None and checkpoint_every < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1, got {checkpoint_every}"
        )
    dev = resolve_device(device)
    layout = build_layout(cfg)
    model = build_model(cfg)
    faithful = cfg.compute_mode == ComputeMode.FAITHFUL

    # ---- control plane (host, float64) ------------------------------------
    if arrivals is None:
        arrivals = default_arrivals(cfg)
    if schedule is None:
        schedule = build_schedule(cfg, arrivals, layout)
    decode_err = obs_decode.decode_error_series(layout, schedule.message_weights)
    slot_w = step_lib.expand_slot_weights(
        schedule.message_weights, layout.coeffs, np.asarray(layout.slot_is_coded)
    )  # [R, W, S]
    lr = cfg.resolve_lr_schedule()
    alpha = cfg.effective_alpha

    # ---- data plane: the stack moves to the device once --------------------
    X, y, n_train = _device_stack(cfg, dataset, layout, faithful, dev)
    weights = _to_device(_round_weights(layout, slot_w, faithful), dev, torch.float32)

    if init_params is None:
        params0 = model.init_params(cfg.seed, dataset.n_features, dev)
    else:
        params0 = params_from_numpy(init_params, dev)

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
        if dense_glm and cfg.layer_coding != "on" and forced:
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
        grad_fn, layer_coded = _apply_layer_coding(cfg, model, grad_fn, params0, faithful)
        lowering = "layer_block" if layer_coded else lowering
    # set-up before the clock starts: build the kernels, import torch.func,
    # build a sparse stack's scatter plans
    if dev.type == "cuda" and lowering in ("fused", "layer_block"):
        kernels.load_library()
    if lowering == "layer_block" or getattr(model, "grads_via_loss", False):
        step_lib.warm_autodiff()
    _prepare_sparse(X, grad_fn, params0, y, weights[0])

    state = optimizer.init_state(params0, cfg.update_rule)
    start_round = 0
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

    # chunk boundaries [start, start + every, ..., rounds]: a save between
    # chunks, none after the last; the clock covers the rounds only
    step_len = checkpoint_every or max(cfg.rounds - start_round, 1)
    bounds = list(range(start_round, cfg.rounds, step_len)) + [cfg.rounds]
    wall = 0.0
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for i in range(lo, hi):
            # the absolute round index: AGD's theta and Adam's bias
            # correction read it, so a resumed run continues the count
            g = grad_fn(state.params, X, y, weights[i])
            state = update_fn(state, g, float(lr32[i]), alpha, n_train, float(i))
            blocks.tree_map(lambda h, p: h[i - start_round].copy_(p), history, state.params)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall += time.perf_counter() - t0
        if checkpoint_dir and checkpoint_every and hi < cfg.rounds:
            ckpt_lib.save(os.path.join(checkpoint_dir, f"round_{hi}"), state, hi)
    steps_per_sec = (cfg.rounds - start_round) / wall if wall > 0 else 0.0

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
    )


# ---------------------------------------------------------------------------
# trajectory cohorts: B training trajectories, one shared data stack, one
# round loop (the JAX package's train_cohort, resident stacks)


def cohort_eligible(cfg: RunConfig) -> bool:
    """Can this config ride a trajectory-cohort dispatch? Not with the
    forced fused kernel (``use_pallas="on"``: a one-trajectory kernel), and
    only where the scheme's descriptor allows it (``cohort_batchable``).
    The JAX package also excludes measured-arrival and pipelined runs and
    some streamed ones; the port has none of those modes."""
    return cfg.use_pallas != "on" and schemes.get(cfg.scheme).cohort_batchable


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
    return layout_stack_signature(
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
    and its aggregate steps/s, R * B / wall."""
    if isinstance(cfgs, RunConfig):
        cfgs = [cfgs]
    cfgs = list(cfgs)
    if seeds is not None:
        cfgs = [dataclasses.replace(c, seed=int(s)) for c in cfgs for s in seeds]
    if not cfgs:
        raise ValueError("train_cohort needs at least one trajectory config")
    for c in cfgs:
        if c.use_pallas == "on":
            raise ValueError(
                "train_cohort has no batched fused-kernel dispatch; "
                "use use_pallas='auto' or 'off'"
            )
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
    faithful = cfg.compute_mode == ComputeMode.FAITHFUL

    # one shared device stack: refuse a trajectory whose stack differs
    # rather than train a different code than its train() run would
    layouts = [build_layout(c) for c in cfgs]
    stack0 = _stack_signature(cfg, layouts[0])
    for c, lay in zip(cfgs[1:], layouts[1:]):
        if _stack_signature(c, lay) != stack0:
            raise ValueError(
                f"trajectory {c.scheme.value!r} (seed {c.seed}) builds a "
                "different device data stack than the cohort's first "
                "trajectory; train_cohort shares one stack — group by "
                "cohort_signature (experiments.plan_cohorts) or run "
                "per-trajectory train()"
            )

    # ---- control plane, per trajectory, exactly as train() builds it ------
    if arrivals is None:
        arr_list = [default_arrivals(c) for c in cfgs]
    elif isinstance(arrivals, (list, tuple)):
        if len(arrivals) != B:
            raise ValueError(f"got {len(arrivals)} arrival matrices for {B} trajectories")
        arr_list = [np.asarray(a) for a in arrivals]
    else:
        arr_list = [np.asarray(arrivals)] * B
    schedules = [build_schedule(c, a, lay) for c, a, lay in zip(cfgs, arr_list, layouts)]
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
    # lr and alpha are trajectory axes, float32 tensors (as in the JAX
    # cohort): the update's scalar coefficients are formed in float32, where
    # train() forms them from Python floats
    lr_B = _to_device(
        np.stack([c.resolve_lr_schedule() for c in cfgs], axis=1), dev, torch.float32
    )  # [R, B]
    alpha_B = _to_device(np.array([c.effective_alpha for c in cfgs]), dev, torch.float32)

    # ---- data plane: one stack for the cohort ------------------------------
    X, y, n_train = _device_stack(cfg, dataset, layouts[0], faithful, dev)
    weights = _to_device(weights_h, dev, torch.float32)
    model = build_model(cfg)
    if init_params is None:
        params = [model.init_params(c.seed, dataset.n_features, dev) for c in cfgs]
    else:
        params = [params_from_numpy(p, dev) for p in init_params]
    params0 = blocks.tree_map(lambda *leaves: torch.stack(leaves), *params)

    if cfg.flat_grad == "on" and not step_lib.supports_flat_grad(model, X):
        raise ValueError(
            "flat_grad='on' needs a closed-form GLM stack; "
            f"got model={_model_name(model)!r}, X={type(X).__name__}"
        )
    _check_layer_coding(cfg, model)
    grad_fn, lowering = step_lib.make_cohort_grad_fn(
        model, params[0], X, faithful=faithful,
        layer_coding=cfg.layer_coding, block_decode=cfg.block_decode,
        flat_grad=cfg.flat_grad,
    )
    # set-up before the clock starts: build the kernels, import torch.func,
    # build a sparse stack's scatter plans
    if dev.type == "cuda" and lowering == "layer_block_vmap":
        kernels.load_library()
    step_lib.warm_autodiff()
    _prepare_sparse(X, grad_fn, params0, y, weights[0])

    state = optimizer.init_state(params0, cfg.update_rule)
    update_fn = optimizer.make_cohort_update_fn(cfg.update_rule)
    history = blocks.tree_map(
        lambda p: torch.empty((cfg.rounds,) + tuple(p.shape), dtype=torch.float32, device=dev),
        params0,
    )  # leaves [R, B, ...]

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for i in range(cfg.rounds):
        g = grad_fn(state.params, X, y, weights[i])
        state = update_fn(state, g, lr_B[i], alpha_B, n_train, float(i))
        blocks.tree_map(lambda h, p: h[i].copy_(p), history, state.params)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    agg_rate = cfg.rounds * B / wall if wall > 0 else 0.0

    cohort = {
        "cohort_size": B,
        "cohort_lowering": lowering,
        "cohort_dispatches": 1,
        "stack_mode": "materialized" if faithful else "deduped",
    }
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
        ))
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
