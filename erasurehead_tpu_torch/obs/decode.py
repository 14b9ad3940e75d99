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
