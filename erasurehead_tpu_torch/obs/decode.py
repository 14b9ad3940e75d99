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
