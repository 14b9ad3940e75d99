"""Run-summary helpers shared by the artifact writer.

Only :func:`arrival_summary` of erasurehead_tpu/obs/events.py is ported; the
event log itself is not.
"""

from __future__ import annotations

import numpy as np


def arrival_summary(worker_times) -> dict:
    """Masked latency stats over a [.., W] arrival block.

    ``worker_times`` carries the reference's ``-1`` sentinel for workers the
    master never collected; it is masked out, never averaged in. Quantiles
    are None when no worker arrived at all."""
    wt = np.asarray(worker_times, dtype=np.float64)
    arrived = wt[wt >= 0.0]
    n_never = int(wt.size - arrived.size)
    if arrived.size == 0:
        return {
            "p50": None, "p90": None, "p99": None, "mean": None,
            "n_arrivals": 0, "n_never": n_never,
        }
    q50, q90, q99 = np.quantile(arrived, [0.5, 0.9, 0.99])
    return {
        "p50": round(float(q50), 6),
        "p90": round(float(q90), 6),
        "p99": round(float(q99), 6),
        "mean": round(float(arrived.mean()), 6),
        "n_arrivals": int(arrived.size),
        "n_never": n_never,
    }
