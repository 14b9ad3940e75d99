"""AGC decode error: the quantity the source papers bound.

The decoded gradient is ``sum_p pw[p] * g_p`` where ``pw`` is the
per-partition fold of the collection weights (CodingLayout.fold_slot_weights);
the exact gradient is the same sum with ``pw == 1``. The per-round
decode-error norm is the weight-space residual

    err[r] = || pw[r] - 1 ||_2 / || 1 ||_2

computed in host float64 exactly as erasurehead_tpu/obs/decode.py computes
it. Residuals below :data:`EXACT_TOL` (lstsq float noise) snap to 0.0.
:func:`block_decode_error` measures the same error per coded block of a
model's gradient (the decode-error-vs-depth series).

A pipelined run (``cfg.pipeline_depth``) has a second error source the
weight-space norm cannot see: the gradient was taken at a stale iterate.
:func:`staleness_error_series` measures that half in gradient space by a
replay after the run, and :func:`emit_staleness_split` packages both halves
as the ``stale_decode`` record. The replay is a tool's call, never
``train()``'s: telemetry adds no device work to a run.
"""

from __future__ import annotations

import numpy as np

#: residuals below this are decode-exact up to lstsq float noise and snap to
#: exactly 0.0
EXACT_TOL = 1e-9


def _fold_weights(layout, message_weights: np.ndarray) -> np.ndarray:
    """[R, P] per-partition fold of a run's [R, W] collection weights, host
    float64, through the step's own slot expansion."""
    from erasurehead_tpu_torch.parallel import step as step_lib

    mw = np.asarray(message_weights, dtype=np.float64)
    slot_w = np.asarray(
        step_lib.expand_slot_weights(
            mw, np.asarray(layout.coeffs), np.asarray(layout.slot_is_coded)
        )
    )  # [R, W, S]
    return layout.fold_slot_weights(slot_w)


def decode_error_series(layout, message_weights: np.ndarray) -> np.ndarray:
    """[R] per-round decode-error norms for a run's [R, W] collection
    weights."""
    pw = _fold_weights(layout, message_weights)  # [R, P]
    P = layout.n_partitions
    err = np.linalg.norm(pw - 1.0, axis=-1) / np.sqrt(P)
    err[err < EXACT_TOL] = 0.0
    return err


def block_decode_error(
    layout, message_weights: np.ndarray, block_table: np.ndarray
) -> dict:
    """Per-layer (gradient-space) decode error: the decode-error-vs-depth
    series of the approximate-coding-limits analysis (arXiv:1901.08166),
    measured against a model's actual per-partition gradient blocks.

    ``block_table`` is the host [P, L, width] table of per-partition
    gradient blocks at a reference parameter point
    (ops/blocks.partition_block_table). The decoded gradient of block l in
    round r is ``pw[r] @ block_table[:, l]`` and the exact gradient is the
    same contraction with ``pw == 1``, so

        per_block[r, l] = ||(pw[r] - 1) @ G_l|| / max(||1 @ G_l||, eps)

    is the per-layer relative decode error the weight-space norm
    (:func:`decode_error_series`) aggregates away, and

        cumulative[r, l] = || (pw[r] - 1) @ G_{0..l} ||_F

    the unnormalized error over the first l+1 blocks, non-decreasing in
    depth l for every round. Host float64; exact rounds snap to 0.0 like the
    weight-space series."""
    pw = _fold_weights(layout, message_weights)  # [R, P]
    G = np.asarray(block_table, dtype=np.float64)  # [P, L, K]
    resid = np.einsum("rp,plk->rlk", pw - 1.0, G)  # decoded - exact
    exact = G.sum(axis=0)  # [L, K]: the pw == 1 contraction
    exact_norm = np.linalg.norm(exact, axis=-1)  # [L]
    num = np.linalg.norm(resid, axis=-1)  # [R, L]
    per_block = num / np.maximum(exact_norm[None, :], 1e-30)
    per_block[per_block < EXACT_TOL] = 0.0
    cumulative = np.sqrt(np.cumsum(num**2, axis=1))
    cumulative[cumulative < EXACT_TOL] = 0.0
    return {
        "per_block": per_block,
        "cumulative": cumulative,
        "exact_block_norms": exact_norm,
    }


def staleness_error_series(
    model, params_history, staleness, X, y, initial_params
) -> np.ndarray:
    """[R] per-round gradient-space staleness error of a pipelined run:

        s[r] = || g(p_stale[r]) - g(p_fresh[r]) || / max(||g(p_fresh[r])||, eps)

    where ``p_fresh[r]`` is the iterate entering round r (``history[r-1]``,
    or ``initial_params`` for round 0), ``p_stale[r]`` the iterate the
    pipelined run differentiated at (the one entering round
    ``r - staleness[r]``), and g the model's full-batch gradient
    (``model.grad_sum``). Exactly zero where ``staleness[r] == 0`` (the
    warm-up rounds and every round of a tau=0 run).

    The half of the pipelined error that the weight-space coding error
    (:func:`decode_error_series`) cannot see. It replays one full-batch
    gradient a round, so it runs after the run, never inside the trainer.
    ``params_history`` and ``initial_params`` are a tensor or a dict of
    tensors (a TrainResult's ``params_history`` and its initial params);
    ``X``/``y`` the full dense training arrays (numpy or tensors); the
    gradients are taken on the history's device in float32, the norms in
    host float64. ``staleness`` is the [R] tau schedule
    (parallel/pipeline.staleness_schedule or PipelinedSchedule.staleness)."""
    import torch

    from erasurehead_tpu_torch.ops import blocks

    tau = np.asarray(staleness, dtype=np.int64)
    R = int(tau.shape[0])
    leaves = blocks.tree_leaves(params_history)
    dev = leaves[0].device
    def put(a):
        if torch.is_tensor(a):
            return a.to(device=dev, dtype=torch.float32)
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)

    Xt, yt, p0 = put(X), put(y), blocks.tree_map(put, initial_params)
    rows = []
    for r in range(R):
        # the iterate entering round r: p0, then history[r - 1]
        p = p0 if r == 0 else blocks.tree_map(lambda h: h[r - 1], params_history)
        g = model.grad_sum(p, Xt, yt)
        rows.append(np.concatenate([
            np.asarray(leaf.detach().cpu(), dtype=np.float64).reshape(-1)
            for leaf in blocks.tree_leaves(g)
        ]))
    g = np.stack(rows)  # [R, n_params]
    idx = np.arange(R)
    diff = g[idx - tau] - g[idx]
    fresh_norm = np.linalg.norm(g, axis=-1)
    err = np.linalg.norm(diff, axis=-1) / np.maximum(fresh_norm, 1e-30)
    err[tau == 0] = 0.0
    err[err < EXACT_TOL] = 0.0
    return err


def emit_staleness_split(run_id, result, dataset, initial_params=None) -> dict:
    """A finished pipelined run's staleness-vs-coding error decomposition,
    emitted as ONE ``stale_decode`` record (when a capture is installed):
    the mean gradient-space staleness error, the mean coding error (the
    run's weight-space decode-error series) and staleness's share of their
    sum. Returns the payload either way.

    It replays one gradient a round (:func:`staleness_error_series`), on the
    device of the run's history. ``initial_params`` (the run's
    ``init_params`` form) defaults to the config's seeded init."""
    from erasurehead_tpu_torch.models.glm import params_from_numpy
    from erasurehead_tpu_torch.obs import events as events_lib
    from erasurehead_tpu_torch.ops import blocks
    from erasurehead_tpu_torch.parallel.pipeline import staleness_schedule
    from erasurehead_tpu_torch.train import trainer as trainer_lib

    cfg = result.config
    model = trainer_lib.build_model(cfg)
    dev = blocks.tree_leaves(result.params_history)[0].device
    if initial_params is None:
        p0 = model.init_params(cfg.seed, dataset.n_features, dev)
    else:
        p0 = params_from_numpy(initial_params, dev)
    n = result.n_train
    tau = staleness_schedule(cfg.rounds, cfg.pipeline_depth)[result.start_round:]
    s_err = staleness_error_series(
        model, result.params_history, tau, dataset.X_train[:n], dataset.y_train[:n], p0,
    )
    c_err = np.asarray(result.decode_error, dtype=np.float64)[result.start_round:]
    s_mean = float(s_err.mean()) if s_err.size else 0.0
    c_mean = float(c_err.mean()) if c_err.size else 0.0
    total = s_mean + c_mean
    payload = {
        "run_id": run_id,
        "first_round": int(result.start_round),
        "n_rounds": int(s_err.shape[0]),
        "staleness_error_mean": round(s_mean, 10),
        "coding_error_mean": round(c_mean, 10),
        # which noise source dominates: 0 = pure coding error (tau=0 runs
        # land here exactly), 1 = pure staleness
        "staleness_share": round(s_mean / total, 10) if total > 0 else 0.0,
    }
    if events_lib.current():
        events_lib.emit("stale_decode", **payload)
    return payload


def summarize(decode_error) -> dict:
    """Mean/max summary of a [R] error series (the ``run_end`` fields)."""
    if decode_error is None:
        return {"decode_error_mean": None, "decode_error_max": None}
    err = np.asarray(decode_error, dtype=np.float64)
    if err.size == 0:
        return {"decode_error_mean": 0.0, "decode_error_max": 0.0}
    return {
        "decode_error_mean": round(float(err.mean()), 10),
        "decode_error_max": round(float(err.max()), 10),
    }
