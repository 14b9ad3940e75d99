"""Evaluation metrics on tensors: logistic loss, MSE, ROC AUC.

The same three metrics as erasurehead_tpu/models/metrics.py, computed on the
device in the scores' dtype (float32), as the JAX package computes them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F_nn

__all__ = ["log_loss_mean", "mse_mean", "auc"]


def log_loss_mean(y: torch.Tensor, margins: torch.Tensor) -> torch.Tensor:
    """Mean logistic loss, labels in {-1,+1} (src/util.py:136-137), via
    softplus (the literal log(1+exp(.)) overflows float32 beyond ~88)."""
    return F_nn.softplus(-y * margins).mean()


def mse_mean(y: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Mean squared error (src/util.py:139-141)."""
    return ((y - pred) ** 2).mean()


def auc(y: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """ROC AUC via the Mann-Whitney U statistic.

    Equals sklearn's trapezoidal roc_curve/auc (src/naive.py:188-197) on
    tie-free scores; ties take midranks."""
    n = y.shape[0]
    pos = y > 0
    n_pos = pos.sum()
    n_neg = n - n_pos
    order = torch.argsort(scores, stable=True)
    sorted_scores = scores[order]
    ranks_sorted = torch.arange(1, n + 1, dtype=scores.dtype, device=scores.device)
    same_as_prev = torch.cat(
        [
            torch.zeros(1, dtype=torch.bool, device=scores.device),
            sorted_scores[1:] == sorted_scores[:-1],
        ]
    )
    group = torch.cumsum(~same_as_prev, 0) - 1  # run id of equal scores
    group_sum = torch.zeros_like(ranks_sorted).index_add_(0, group, ranks_sorted)
    group_cnt = torch.zeros_like(ranks_sorted).index_add_(
        0, group, torch.ones_like(ranks_sorted)
    )
    midrank_sorted = group_sum[group] / group_cnt[group]
    ranks = torch.empty_like(midrank_sorted).scatter_(0, order, midrank_sorted)
    rank_sum_pos = torch.where(pos, ranks, 0.0).sum()
    u = rank_sum_pos - n_pos * (n_pos + 1) / 2.0
    return u / (n_pos * n_neg)
