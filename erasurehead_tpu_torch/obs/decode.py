"""AGC decode error: the quantity the source papers bound.

The decoded gradient is ``sum_p pw[p] * g_p`` where ``pw`` is the
per-partition fold of the collection weights (CodingLayout.fold_slot_weights);
the exact gradient is the same sum with ``pw == 1``. The per-round
decode-error norm is the weight-space residual

    err[r] = || pw[r] - 1 ||_2 / || 1 ||_2

computed in host float64 exactly as erasurehead_tpu/obs/decode.py computes
it. Residuals below :data:`EXACT_TOL` (lstsq float noise) snap to 0.0.
"""

from __future__ import annotations

import numpy as np

#: residuals below this are decode-exact up to lstsq float noise and snap to
#: exactly 0.0
EXACT_TOL = 1e-9


def decode_error_series(layout, message_weights: np.ndarray) -> np.ndarray:
    """[R] per-round decode-error norms for a run's [R, W] collection
    weights."""
    from erasurehead_tpu_torch.parallel import step as step_lib

    mw = np.asarray(message_weights, dtype=np.float64)
    slot_w = np.asarray(
        step_lib.expand_slot_weights(
            mw, np.asarray(layout.coeffs), np.asarray(layout.slot_is_coded)
        )
    )  # [R, W, S]
    pw = layout.fold_slot_weights(slot_w)  # [R, P]
    P = layout.n_partitions
    err = np.linalg.norm(pw - 1.0, axis=-1) / np.sqrt(P)
    err[err < EXACT_TOL] = 0.0
    return err
