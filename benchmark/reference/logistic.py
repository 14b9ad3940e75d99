"""Plain logistic-regression trajectory: the decoded gradient, AGD and the
replayed loss and AUC, in plain PyTorch.

What ErasureHead's master computes for one trajectory (arXiv:1901.09671;
src/naive.py:113-139, src/util.py:136-137), given the per-round partition
weights of the decoded gradient (reference/schemes.py):

  residual   r = y / (exp(y * x.beta) + 1)
  gradient   g = - sum_p pw[p] X_p^T r_p           (the sum convention)
  AGD        theta = 2 / (i + 2), u_0 = 0
             v = (1 - theta) beta + theta u
             beta' = v - (eta / n) g - 2 alpha eta beta
             u' = beta + (beta' - beta) / theta
  replay     train loss of every iterate, mean softplus(-y x.beta) over
             all training rows; test loss and Mann-Whitney AUC of the last.

``precision`` "float64" is the reference. The controls compute in float32
with the inputs of every product (data, params, residuals) rounded to
nearest in a lower precision: "tf32" (a 10-bit mantissa), as a TF32 matrix
product takes them, or "bf16" (a 7-bit mantissa).

Data is dense rows (:class:`Dense`) or one-hot rows given by their column
indices (:class:`Onehot`). Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero), as float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest bfloat16 value (ties to even), as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


_ROUND = {"tf32": tf32_round, "bf16": bf16_round}


class _Precision:
    def __init__(self, precision: str):
        if precision != "float64" and precision not in _ROUND:
            raise ValueError(f"unknown precision {precision!r}")
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        self._round = _ROUND.get(precision)

    def _in(self, v):
        return v if self._round is None else self._round(v.to(self.dtype))


class Dense(_Precision):
    def __init__(self, X: torch.Tensor, precision: str):
        super().__init__(precision)
        self.X = self._in(X.to(self.dtype))
        self.n = X.shape[0]

    def matvec(self, b):
        return self.X @ self._in(b)

    def rmatvec(self, r):
        return self.X.T @ self._in(r)


class Onehot(_Precision):
    def __init__(self, idx: torch.Tensor, n_cols: int, precision: str):
        super().__init__(precision)
        self.idx = idx.long()
        self.flat = self.idx.reshape(-1)
        self.n, self.K = self.idx.shape
        self.n_cols = n_cols

    def matvec(self, b):
        return self._in(b)[self.idx].sum(dim=1)

    def rmatvec(self, r):
        rr = self._in(r)[:, None].expand(self.n, self.K).reshape(-1)
        return torch.zeros(self.n_cols, dtype=self.dtype, device=r.device).index_add_(
            0, self.flat, rr)


def softplus_mean(z: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.softplus(z).mean()


def auc(y: np.ndarray, scores: np.ndarray) -> float:
    """Mann-Whitney AUC with midranks for ties."""
    order = np.argsort(scores, kind="stable")
    s = scores[order]
    ranks = np.empty(len(s))
    i = 0
    while i < len(s):
        j = i
        while j + 1 < len(s) and s[j + 1] == s[i]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    pos = y > 0
    n_pos = int(pos.sum())
    n_neg = len(y) - n_pos
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def trajectory(train, y, part, test, y_test, pw, lr, alpha: float, beta0) -> dict:
    """One trajectory. ``train``/``test``: :class:`Dense` or :class:`Onehot`
    of one precision; ``part`` [n] the partition of each training row;
    ``pw`` [R, P] partition weights (numpy); ``lr`` [R]; ``beta0`` [F].
    Returns the train-loss curve [R], the last iterate's test loss and AUC
    (numpy, float64)."""
    dt, dev = train.dtype, y.device
    y, y_test = y.to(dt), y_test.to(dt)
    pw_rows = torch.as_tensor(pw, dtype=dt, device=dev)  # [R, P]
    part = part.to(dev)
    R = pw.shape[0]
    n = train.n
    b = torch.as_tensor(np.asarray(beta0), dtype=dt, device=dev)
    u = torch.zeros_like(b)
    losses = torch.empty(R, dtype=dt, device=dev)
    for i in range(R):
        m = train.matvec(b)
        if i:
            losses[i - 1] = softplus_mean(-y * m)
        r = y / (torch.exp(m * y) + 1.0) * pw_rows[i][part]
        g = -train.rmatvec(r)
        theta = 2.0 / (i + 2.0)
        eta = float(lr[i])
        v = (1.0 - theta) * b + theta * u
        b_next = v - (eta / n) * g - (2.0 * alpha * eta) * b
        u = b + (b_next - b) / theta
        b = b_next
    losses[R - 1] = softplus_mean(-y * train.matvec(b))
    mt = test.matvec(b)
    return {
        "train_loss": losses.double().cpu().numpy(),
        "test_loss": float(softplus_mean(-y_test * mt)),
        "auc": auc(y_test.double().cpu().numpy(), mt.double().cpu().numpy()),
    }
