"""Partitioning a dataset and materializing the (possibly redundant) worker stack.

The reference shards by writing one file per partition and having each MPI
rank load its assigned (rotated/replicated) partitions (src/approximate_coding.py:39-69).
Here, as in erasurehead_tpu/data/sharding.py, the same assignment becomes
array indexing on the host: a partition-major stack [P, rows, F], and for the
faithful compute mode a worker-major stack [W, S, rows, F] gathered through
``CodingLayout.assignment`` (the redundancy is real memory). The trainer moves
the stack it needs to the device once.

A CSR dataset stacks as a container of host numpy leaves
(ops/features.PaddedRows or FieldOnehot, per ``sparse_format``); every leaf
leads with the partition axis, so the worker-major gather is one indexed
take per leaf.

Row-count convention (the reference's src/coded.py:23): rows_per_partition =
n_samples // P, trailing remainder rows dropped from training.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps
from torch.utils import _pytree as pytree

from erasurehead_tpu_torch.data.synthetic import Dataset
from erasurehead_tpu_torch.ops.codes import CodingLayout
from erasurehead_tpu_torch.ops.features import (
    FieldOnehot,
    PaddedRows,
    infer_field_sizes,
    take_lead,
)


def _stack_leaves(containers):
    """One container whose leaves stack the given containers' leaves on a
    new leading (partition) axis."""
    spec = pytree.tree_structure(containers[0])
    leaves = [pytree.tree_leaves(c) for c in containers]
    return pytree.tree_unflatten([np.stack(ls) for ls in zip(*leaves)], spec)


def partition_stack(dataset: Dataset, n_partitions: int, sparse_format: str = "padded"):
    """[P, rows, F] + [P, rows] partition-major arrays (host).

    ``sparse_format`` picks the sparse stack: "padded" (PaddedRows),
    "fields" (FieldOnehot; raises when the data is not
    exactly-one-hot-per-field) or "auto" (fields where the structure
    allows, else padded)."""
    n = dataset.n_samples
    rows = n // n_partitions
    if rows == 0:
        raise ValueError(f"{n} samples cannot fill {n_partitions} partitions")
    X, y = dataset.X_train, dataset.y_train
    if sps.issparse(X):
        X = X[: rows * n_partitions]
        # field structure is a whole-matrix property: infer once so every
        # partition shares the same block offsets (tables must agree)
        sizes = None
        if sparse_format in ("fields", "auto"):
            sizes = infer_field_sizes(X)
            if sizes is None and sparse_format == "fields":
                raise ValueError(
                    "sparse_format='fields' requires exactly-one-hot-per-"
                    "field data (uniform nnz/row, unit values, disjoint "
                    "ordered field blocks); use 'auto' or 'padded'"
                )
        parts = [X[i * rows : (i + 1) * rows] for i in range(n_partitions)]
        if sizes is not None:
            Xp = _stack_leaves([FieldOnehot.from_scipy(p, field_sizes=sizes) for p in parts])
        else:
            nnz = max(int(np.diff(p.indptr).max()) for p in parts)
            # from_scipy builds host numpy leaves (the JAX package's
            # _padded_host): nothing touches the device before the upload
            Xp = _stack_leaves([PaddedRows.from_scipy(p, nnz) for p in parts])
    else:
        if sparse_format == "fields":
            raise ValueError(
                "sparse_format='fields' requires sparse (CSR) features; "
                "this dataset is dense — use 'auto' or 'padded'"
            )
        Xp = X[: rows * n_partitions].reshape(n_partitions, rows, -1)
    yp = y[: rows * n_partitions].reshape(n_partitions, rows)
    return Xp, yp


def worker_stack(layout: CodingLayout, Xp, yp):
    """[W, S, rows, F] + [W, S, rows]: the redundant worker-major stacks,
    gathered through the assignment (leaf by leaf for a container: a
    QuantizedStack's scale table rides the same gather as its payload)."""
    return take_lead(Xp, layout.assignment), yp[layout.assignment]
