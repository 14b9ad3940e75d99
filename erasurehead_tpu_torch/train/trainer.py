"""The synchronous trainer: a Python loop over rounds on one device.

The counterpart of erasurehead_tpu/train/trainer.py::train. Control plane
(host, float64, precomputed, tiny): straggler arrival schedule, per-round
collection/decode weights, learning-rate schedule. Data plane (the device):
per round, the decoded gradient of the stack (parallel/step.py) and the
GD/AGD/Adam update; the iterate history stays on the device.

``use_pallas`` "auto" (the default) and "on" both route the stack through
the fused kernel (ops/kernels.fused_glm_grad, one launch per round on CUDA)
and raise where it declines; "off" takes the two-pass PyTorch gradient.

Timing artifacts keep two clocks apart, as the JAX package does:
  - ``timeset``/``worker_times``: *simulated* cluster seconds from the
    arrival model;
  - ``wall_time``/``steps_per_sec``: real seconds of the round loop, between
    two ``torch.cuda.synchronize()`` calls on the card (the kernel library is
    built and loaded before the clock starts).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from erasurehead_tpu_torch.data.sharding import partition_stack, worker_stack
from erasurehead_tpu_torch.data.synthetic import Dataset
from erasurehead_tpu_torch.models.glm import LinearModel, LogisticModel
from erasurehead_tpu_torch.obs import decode as obs_decode
from erasurehead_tpu_torch.ops import codes, kernels
from erasurehead_tpu_torch.parallel import collect, step as step_lib, straggler
from erasurehead_tpu_torch.train import optimizer
from erasurehead_tpu_torch.utils.config import (
    ComputeMode,
    ModelKind,
    RunConfig,
    Scheme,
)
from erasurehead_tpu_torch.utils.device import resolve_device

#: scheme -> layout (the JAX package's scheme registry, schemes/builtin.py,
#: for the ported schemes)
_LAYOUTS = {
    Scheme.NAIVE: lambda cfg: codes.uncoded_layout(cfg.n_workers),
    Scheme.CYCLIC_MDS: lambda cfg: codes.cyclic_mds_layout(
        cfg.n_workers, cfg.n_stragglers, seed=cfg.seed
    ),
    Scheme.FRC: lambda cfg: codes.frc_layout(cfg.n_workers, cfg.n_stragglers),
    Scheme.APPROX: lambda cfg: codes.frc_layout(cfg.n_workers, cfg.n_stragglers),
    Scheme.AVOID_STRAGGLERS: lambda cfg: codes.uncoded_layout(
        cfg.n_workers, n_stragglers=cfg.n_stragglers
    ),
}


def build_layout(cfg: RunConfig) -> codes.CodingLayout:
    return _LAYOUTS[cfg.scheme](cfg)


def build_model(cfg: RunConfig):
    if cfg.model == ModelKind.LOGISTIC:
        return LogisticModel()
    if cfg.model == ModelKind.LINEAR:
        return LinearModel()
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

    params_history: torch.Tensor  # [rounds, F] on the run's device (the betaset)
    final_params: torch.Tensor  # [F]
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
    # did the round loop go through the fused kernel's wrapper?
    fused: bool = False


def _data_dtype(cfg: RunConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _to_device(a: np.ndarray, device, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


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
    ``device="cpu"`` runs the same loop on the CPU, where the fused
    gradient takes its plain PyTorch version. ``init_params`` ([F]) replaces
    the port's own seeded init, e.g. with a JAX run's draw for parity.
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
        schedule = collect.build_schedule(
            cfg.scheme, arrivals, layout, num_collect=cfg.num_collect
        )
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

    use_fused = cfg.use_pallas != "off"
    if use_fused:
        reason = kernels.unsupported_reason(X.reshape((-1,) + tuple(X.shape[-2:])))
        if reason is not None:  # no quiet fallback to the two-pass gradient
            raise ValueError(
                f"the fused kernel declines this stack ({reason}); "
                "use_pallas='off' takes the two-pass gradient"
            )
        grad_fn = step_lib.make_fused_grad_fn(model.name)
        if dev.type == "cuda":
            kernels.load_library()  # build before the clock starts
    elif faithful:
        grad_fn = step_lib.make_faithful_grad_fn(model)
    else:
        grad_fn = step_lib.make_deduped_grad_fn(model)

    if init_params is None:
        params0 = model.init_params(cfg.seed, dataset.n_features, dev)
    else:
        params0 = torch.tensor(np.asarray(init_params, np.float32), device=dev)
    state = optimizer.init_state(params0, cfg.update_rule)
    update_fn = optimizer.make_update_fn(cfg.update_rule)
    lr32 = lr.astype(np.float32)
    history = torch.empty((cfg.rounds, dataset.n_features), dtype=torch.float32, device=dev)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for i in range(cfg.rounds):
        g = grad_fn(state.params, X, y, weights[i])
        state = update_fn(state, g, float(lr32[i]), alpha, n_train, float(i))
        history[i] = state.params
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
    )
