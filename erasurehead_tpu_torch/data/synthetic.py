"""Synthetic datasets: the reference's two-component GMM logistic task, its
least-squares counterpart, and a covtype-style one-hot task.

Host-side numpy, drawn exactly as erasurehead_tpu/data/synthetic.py draws
them, so the same seed gives the same bytes:

  - a ground-truth beta* with iid +-1 entries,
  - class means mu = +-(1.5 / n_cols) * beta*,
  - features: per-partition, a Binomial(rows, 1/2) split between the two
    components, each row mu_c + (10/sqrt(n_cols)) * N(0, I), component-1 rows
    stacked before component-2 rows (src/util.py:39-43),
  - labels drawn from the true logistic model: y = 2*Bernoulli(sigmoid(X
    beta*)) - 1 (src/generate_data.py:34-35),
  - a test split of 0.2 * n_rows generated the same way.

Deviation from the reference: its generator is unseeded
(src/generate_data.py:54); this one takes a seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Dataset:
    """In-memory dataset, row-major with partition-contiguous training rows."""

    X_train: np.ndarray | object  # [n, F] dense ndarray or scipy CSR
    y_train: np.ndarray  # [n] in {-1, +1} (or real-valued for regression)
    X_test: np.ndarray | object
    y_test: np.ndarray
    name: str = "artificial"

    @property
    def n_samples(self) -> int:
        return self.X_train.shape[0]

    @property
    def n_features(self) -> int:
        return self.X_train.shape[1]


def _gmm_block(
    rng: np.random.Generator, mu1, mu2, n_rows: int, n_cols: int
) -> np.ndarray:
    n2 = rng.binomial(n_rows, 0.5)
    n1 = n_rows - n2
    scale = 10.0 / np.sqrt(n_cols)
    return np.concatenate(
        [
            mu1 + scale * rng.standard_normal((n1, n_cols)),
            mu2 + scale * rng.standard_normal((n2, n_cols)),
        ]
    )


def generate_gmm(
    n_rows: int,
    n_cols: int,
    n_partitions: int,
    seed: int = 0,
    dtype=np.float32,
) -> Dataset:
    """Generate the reference's synthetic logistic-regression task.

    Rows are generated per partition (partition i occupies the contiguous row
    block i); n_rows must be a multiple of n_partitions
    (src/generate_data.py:11).
    """
    if n_rows % n_partitions:
        raise ValueError("n_rows must be a multiple of n_partitions")
    rng = np.random.default_rng(seed)
    beta_true = rng.integers(0, 2, n_cols) * 2.0 - 1.0
    mu1 = (1.5 / n_cols) * beta_true
    mu2 = -mu1
    rows_per = n_rows // n_partitions

    def labeled_block(n):
        X = _gmm_block(rng, mu1, mu2, n, n_cols)
        p = 1.0 / (1.0 + np.exp(-X @ beta_true))
        y = 2.0 * rng.binomial(1, p) - 1.0
        return X.astype(dtype), y.astype(dtype)

    blocks = [labeled_block(rows_per) for _ in range(n_partitions)]
    X_train = np.concatenate([b[0] for b in blocks])
    y_train = np.concatenate([b[1] for b in blocks])
    X_test, y_test = labeled_block(int(0.2 * n_rows))
    return Dataset(X_train, y_train, X_test, y_test, name="artificial")


def generate_onehot(
    n_rows: int,
    n_cols: int,
    n_partitions: int,
    n_fields: int = 12,
    seed: int = 0,
) -> Dataset:
    """Covtype-style sparse one-hot logistic task (scipy CSR features).

    The reference's real workloads are one-hot sparse CSR matrices
    (src/arrange_real_data.py:145-205 bins covtype's columns into 15509
    one-hot categories; amazon hashes to 241915). This task has the same
    structure: ``n_fields`` categorical fields in contiguous column blocks
    (the last absorbs the remainder), each row activating exactly one
    category per field (value 1.0, so nnz a row == n_fields), labels drawn
    from a true logistic model over the one-hot features. Drawn as the JAX
    package draws it, so a seed gives the same bytes.
    """
    import scipy.sparse as sps

    if n_rows % n_partitions:
        raise ValueError("n_rows must be a multiple of n_partitions")
    if n_fields > n_cols:
        raise ValueError("n_fields cannot exceed n_cols")
    rng = np.random.default_rng(seed)
    bounds = np.linspace(0, n_cols, n_fields + 1).astype(np.int64)
    # unit logit variance: sum of n_fields iid N(0, 1/n_fields) entries
    beta_true = rng.standard_normal(n_cols) / np.sqrt(n_fields)

    def block(n):
        cats = rng.random((n, n_fields))
        lo, hi = bounds[:-1], bounds[1:]
        idx = (lo + (cats * (hi - lo)).astype(np.int64)).astype(np.int32)
        logits = beta_true[idx].sum(axis=1)
        y = (2.0 * rng.binomial(1, 1.0 / (1.0 + np.exp(-logits))) - 1.0)
        X = sps.csr_matrix(
            (
                np.ones(n * n_fields, dtype=np.float32),
                idx.ravel(),
                np.arange(n + 1, dtype=np.int64) * n_fields,
            ),
            shape=(n, n_cols),
        )
        return X, y.astype(np.float32)

    X_train, y_train = block(n_rows)
    X_test, y_test = block(int(0.2 * n_rows))
    return Dataset(X_train, y_train, X_test, y_test, name="artificial-onehot")


def generate_linear(
    n_rows: int,
    n_cols: int,
    n_partitions: int,
    seed: int = 0,
    noise: float = 0.1,
    dtype=np.float32,
) -> Dataset:
    """Synthetic least-squares task (regression counterpart, same geometry)."""
    if n_rows % n_partitions:
        raise ValueError("n_rows must be a multiple of n_partitions")
    rng = np.random.default_rng(seed)
    beta_true = rng.standard_normal(n_cols) / np.sqrt(n_cols)

    def block(n):
        X = rng.standard_normal((n, n_cols)) / np.sqrt(n_cols)
        y = X @ beta_true + noise * rng.standard_normal(n)
        return X.astype(dtype), y.astype(dtype)

    X_train, y_train = block(n_rows)
    X_test, y_test = block(int(0.2 * n_rows))
    return Dataset(X_train, y_train, X_test, y_test, name="artificial-linear")
