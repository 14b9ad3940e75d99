"""Partitioning a dataset and materializing the (possibly redundant) worker stack.

The reference shards by writing one file per partition and having each MPI
rank load its assigned (rotated/replicated) partitions (src/approximate_coding.py:39-69).
Here, as in erasurehead_tpu/data/sharding.py, the same assignment becomes
array indexing on the host: a partition-major stack [P, rows, F], and for the
faithful compute mode a worker-major stack [W, S, rows, F] gathered through
``CodingLayout.assignment`` (the redundancy is real memory). The trainer moves
the stack it needs to the device once.

Row-count convention (the reference's src/coded.py:23): rows_per_partition =
n_samples // P, trailing remainder rows dropped from training.
"""

from __future__ import annotations

import numpy as np

from erasurehead_tpu_torch.data.synthetic import Dataset
from erasurehead_tpu_torch.ops.codes import CodingLayout


def partition_stack(dataset: Dataset, n_partitions: int):
    """[P, rows, F] + [P, rows] partition-major dense arrays (host)."""
    n = dataset.n_samples
    rows = n // n_partitions
    if rows == 0:
        raise ValueError(f"{n} samples cannot fill {n_partitions} partitions")
    X, y = dataset.X_train, dataset.y_train
    if not isinstance(X, np.ndarray):
        raise ValueError(
            "this port stacks dense features only; sparse stacks are not "
            f"ported yet (got {type(X).__name__})"
        )
    Xp = X[: rows * n_partitions].reshape(n_partitions, rows, -1)
    yp = y[: rows * n_partitions].reshape(n_partitions, rows)
    return Xp, yp


def worker_stack(layout: CodingLayout, Xp, yp):
    """[W, S, rows, F] + [W, S, rows]: the redundant worker-major stacks,
    gathered through the assignment."""
    return Xp[layout.assignment], yp[layout.assignment]
