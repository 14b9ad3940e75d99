"""The reference's synthetic logistic task, drawn on the device from a seed.

The arithmetic of ``erasurehead_tpu_torch/data/synthetic.generate_gmm``
(itself the reference's src/util.py:39-43 and src/generate_data.py:34-35),
with the draws made by a ``torch.Generator`` on the run's device in a few
large calls instead of numpy's generator on the host:

  - beta* with iid +-1 entries, class means mu = +-(1.5 / F) beta*;
  - per partition, each row joins component 1 or 2 with probability 1/2
    and component-1 rows come first (the port's Binomial split);
  - x = mu_c + (10 / sqrt(F)) N(0, I), y = 2 Bernoulli(sigmoid(x beta*)) - 1;
  - a test block of ``test_fraction * n_rows`` rows drawn the same way.
"""

from __future__ import annotations

import math

import torch

KIND = "dense"


def generate(data: dict, n_partitions: int, seed: int, device) -> dict:
    n, F = int(data["n_rows"]), int(data["n_cols"])
    if n % n_partitions:
        raise ValueError(f"n_rows {n} is not a multiple of {n_partitions} partitions")
    g = torch.Generator(device=device).manual_seed(int(seed))
    beta = torch.randint(0, 2, (F,), generator=g, device=device).double() * 2.0 - 1.0
    mu = (1.5 / F) * beta.float()
    scale = 10.0 / math.sqrt(F)

    def block(P: int, rows: int):
        second = torch.rand((P, rows), generator=g, device=device) < 0.5
        second = torch.sort(second.to(torch.uint8), dim=1).values.bool()
        sign = 1.0 - 2.0 * second.float()
        X = sign[..., None] * mu + scale * torch.randn((P, rows, F), generator=g, device=device)
        X = X.reshape(P * rows, F)
        p = torch.sigmoid(X.double() @ beta)
        y = 2.0 * torch.bernoulli(p, generator=g) - 1.0
        return X, y.float()

    X, y = block(n_partitions, n // n_partitions)
    Xt, yt = block(1, int(float(data["test_fraction"]) * n))
    return {"X_train": X, "y_train": y, "X_test": Xt, "y_test": yt}


def to_host(data: dict):
    """The port's input: a ``Dataset`` of numpy arrays."""
    from erasurehead_tpu_torch.data.synthetic import Dataset

    return Dataset(*(data[k].cpu().numpy() for k in ("X_train", "y_train", "X_test", "y_test")),
                   name="artificial")
