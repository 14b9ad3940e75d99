"""A covtype-shaped one-hot logistic task, drawn on the device from a seed.

The arithmetic of ``erasurehead_tpu_torch/data/synthetic.generate_onehot``
(the structure src/arrange_real_data.py:145-205 gives covtype): ``n_fields``
categorical fields in contiguous column blocks (the last takes the
remainder), one active category a field in every row (value 1, so 12
nonzeros a row at covtype's 12 fields), beta* ~ N(0, 1/n_fields) a column,
y = 2 Bernoulli(sigmoid(sum of the row's beta*)) - 1, and a test block of
``test_fraction * n_rows`` rows. Draws by a ``torch.Generator`` on the run's
device. The data is kept as each row's column indices, [n, n_fields].
"""

from __future__ import annotations

import math

import numpy as np
import torch

KIND = "onehot"


def generate(data: dict, n_partitions: int, seed: int, device) -> dict:
    n, F, K = int(data["n_rows"]), int(data["n_cols"]), int(data["n_fields"])
    if n % n_partitions:
        raise ValueError(f"n_rows {n} is not a multiple of {n_partitions} partitions")
    g = torch.Generator(device=device).manual_seed(int(seed))
    bounds = torch.as_tensor(np.linspace(0, F, K + 1).astype(np.int64), device=device)
    lo, size = bounds[:-1], bounds[1:] - bounds[:-1]
    beta = torch.randn(F, generator=g, device=device, dtype=torch.float64) / math.sqrt(K)

    def block(rows: int):
        u = torch.rand((rows, K), generator=g, device=device, dtype=torch.float64)
        idx = lo + torch.minimum((u * size).long(), size - 1)
        p = torch.sigmoid(beta[idx].sum(dim=1))
        y = 2.0 * torch.bernoulli(p, generator=g) - 1.0
        return idx.to(torch.int32), y.float()

    idx, y = block(n)
    idx_t, yt = block(int(float(data["test_fraction"]) * n))
    return {"idx_train": idx, "y_train": y, "idx_test": idx_t, "y_test": yt, "n_cols": F}


def _csr(idx: torch.Tensor, n_cols: int):
    import scipy.sparse as sps

    n, K = idx.shape
    return sps.csr_matrix(
        (np.ones(n * K, np.float32), idx.cpu().numpy().ravel(),
         np.arange(n + 1, dtype=np.int64) * K),
        shape=(n, n_cols),
    )


def to_host(data: dict):
    """The port's input: a ``Dataset`` of scipy CSR features."""
    from erasurehead_tpu_torch.data.synthetic import Dataset

    F = data["n_cols"]
    return Dataset(_csr(data["idx_train"], F), data["y_train"].cpu().numpy(),
                   _csr(data["idx_test"], F), data["y_test"].cpu().numpy(),
                   name="artificial-onehot")
