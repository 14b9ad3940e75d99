"""The synchronous trainer: a Python loop over rounds on one device.

The counterpart of erasurehead_tpu/train/trainer.py::train. Control plane
(host, float64, precomputed, tiny): straggler arrival schedule, per-round
collection/decode weights, learning-rate schedule. Data plane (the device):
per round, the decoded gradient of the stack (parallel/step.py) and the
GD/AGD/Adam update; the iterate history stays on the device.

Which gradient lowering a round takes (the JAX trainer's dispatch,
erasurehead_tpu/train/trainer.py:941-985, on one device):
  - a GLM with ``use_pallas`` "auto" (the default) or "on" routes the stack
    through the fused kernel (ops/kernels.fused_glm_grad, one launch per
    round on CUDA) and raises where it declines, unless ``layer_coding`` is
    "on"; ``use_pallas="on"`` on any other model raises;
  - otherwise ``layer_coding`` "on" takes the blockwise decode
    (step.make_layer_block_grad_fn): per-slot gradient trees decoded in
    place by the decode kernel (ops/kernels.fused_block_decode_leaves), one
    launch per round for all leaves ("fused") or for the packed block table
    ("treewise");
  - otherwise the monolithic PyTorch gradient (step.make_faithful_grad_fn /
    make_deduped_grad_fn).

Params are the GLM's [F] tensor or the deep families' dict of tensors; the
iterate history is then an [R, F] tensor or a dict of [R, ...] tensors.

Timing artifacts keep two clocks apart, as the JAX package does:
  - ``timeset``/``worker_times``: *simulated* cluster seconds from the
    arrival model;
  - ``wall_time``/``steps_per_sec``: real seconds of the round loop, between
    two ``torch.cuda.synchronize()`` calls on the card (the kernel library is
    built and loaded, and ``torch.func`` imported, before the clock starts).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from erasurehead_tpu_torch import schemes
from erasurehead_tpu_torch.data.sharding import partition_stack, worker_stack
from erasurehead_tpu_torch.data.synthetic import Dataset
from erasurehead_tpu_torch.models.deep_mlp import DeepMLPModel
from erasurehead_tpu_torch.models.glm import LinearModel, LogisticModel, params_from_numpy
from erasurehead_tpu_torch.models.mlp import MLPModel
from erasurehead_tpu_torch.models.moe import MoEModel
from erasurehead_tpu_torch.obs import decode as obs_decode
from erasurehead_tpu_torch.ops import blocks, codes, kernels
from erasurehead_tpu_torch.parallel import collect, step as step_lib, straggler
from erasurehead_tpu_torch.train import optimizer
from erasurehead_tpu_torch.utils.config import (
    ComputeMode,
    ModelKind,
    RunConfig,
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
    if cfg.model == ModelKind.DEEPMLP:
        # cfg.deep_layers sweeps the family's depth (0 = model default)
        if cfg.deep_layers:
            return DeepMLPModel(n_layers=cfg.deep_layers)
        return DeepMLPModel()
    if cfg.model == ModelKind.MOE:
        return MoEModel()
    raise ValueError(f"unknown model {cfg.model}")


def default_arrivals(cfg: RunConfig) -> np.ndarray:
    """The run's stationary straggler arrival schedule (the reference's
    seeded exponential delays)."""
    return straggler.arrival_schedule(
        cfg.rounds, cfg.n_workers, cfg.add_delay, cfg.delay_mean
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
    config: RunConfig = None
    layout: codes.CodingLayout = None
    final_state: optimizer.OptState = None
    # [rounds] per-round decode-error norm ||pw - 1||/sqrt(P) (obs/decode.py)
    decode_error: Optional[np.ndarray] = None
    # did the round loop go through the fused GLM kernel's wrapper?
    fused: bool = False
    # did it take the blockwise (layer-coded) decode?
    layer_coded: bool = False


def _data_dtype(cfg: RunConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _to_device(a: np.ndarray, device, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


def _apply_layer_coding(cfg: RunConfig, model, grad_fn, params_template, faithful: bool):
    """Swap in the blockwise decode (step.make_layer_block_grad_fn) per
    ``cfg.layer_coding``; ``cfg.block_decode`` picks its lowering. Returns
    (grad_fn, layer_coded)."""
    if cfg.layer_coding == "on" and not step_lib.supports_layer_coding(model):
        raise ValueError(
            "layer_coding='on' needs a model whose per-slot gradients are "
            "exact (no model-internal mesh axes) - got "
            f"model={getattr(model, 'name', type(model).__name__)!r}"
        )
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
) -> TrainResult:
    """Run one full training run for ``cfg`` on ``dataset``.

    ``device`` defaults to ``cuda`` and raises when there is no card;
    ``device="cpu"`` runs the same loop on the CPU, where the kernels take
    their plain PyTorch versions. ``init_params`` (an [F] array, or a dict
    of numpy arrays for the deep families) replaces the port's own seeded
    init, e.g. with a JAX run's draw for parity (models/glm.
    params_from_numpy).
    ``arrivals``/``schedule`` replace the default arrival draw and the
    scheme's collection rule."""
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
    Xp_h, yp_h = partition_stack(dataset, layout.n_partitions)
    n_train = yp_h.size
    if faithful:
        Xh, yh = worker_stack(layout, Xp_h, yp_h)
        weights_h = slot_w
    else:
        Xh, yh = Xp_h, yp_h
        weights_h = layout.fold_slot_weights(slot_w)
    data_dtype = _data_dtype(cfg)
    X = _to_device(Xh, dev, data_dtype)
    # labels ride along the data dtype (as in the JAX package), then stay
    # float32 for the residual
    y = _to_device(yh, dev, data_dtype).float()
    weights = _to_device(weights_h, dev, torch.float32)

    if init_params is None:
        params0 = model.init_params(cfg.seed, dataset.n_features, dev)
    else:
        params0 = params_from_numpy(init_params, dev)

    if faithful:
        grad_fn = step_lib.make_faithful_grad_fn(model)
    else:
        grad_fn = step_lib.make_deduped_grad_fn(model)
    use_fused = False
    if cfg.use_pallas != "off":
        # a forced blockwise decode wins over the fused GLM kernel
        if model.name in kernels.GLM_KINDS and cfg.layer_coding != "on":
            reason = kernels.unsupported_reason(X.reshape((-1,) + tuple(X.shape[-2:])))
            if reason is not None:  # no quiet fallback to the two-pass gradient
                raise ValueError(
                    f"the fused kernel declines this stack ({reason}); "
                    "use_pallas='off' takes the two-pass gradient"
                )
            grad_fn = step_lib.make_fused_grad_fn(model.name)
            use_fused = True
        elif cfg.use_pallas == "on":
            raise ValueError(
                "use_pallas='on' needs a dense logistic/linear stack; "
                f"got model={model.name!r}, X={type(X).__name__}"
            )
    layer_coded = False
    if not use_fused:
        grad_fn, layer_coded = _apply_layer_coding(cfg, model, grad_fn, params0, faithful)
    # set-up before the clock starts: build the kernels, import torch.func
    if dev.type == "cuda" and (use_fused or layer_coded):
        kernels.load_library()
    if layer_coded or getattr(model, "grads_via_loss", False):
        step_lib.warm_autodiff()

    state = optimizer.init_state(params0, cfg.update_rule)
    update_fn = optimizer.make_update_fn(cfg.update_rule)
    lr32 = lr.astype(np.float32)
    history = blocks.tree_map(
        lambda p: torch.empty((cfg.rounds,) + tuple(p.shape), dtype=torch.float32, device=dev),
        params0,
    )

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for i in range(cfg.rounds):
        g = grad_fn(state.params, X, y, weights[i])
        state = update_fn(state, g, float(lr32[i]), alpha, n_train, float(i))
        blocks.tree_map(lambda h, p: h[i].copy_(p), history, state.params)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    steps_per_sec = cfg.rounds / wall if wall > 0 else 0.0

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
        fused=use_fused,
        layer_coded=layer_coded,
    )
