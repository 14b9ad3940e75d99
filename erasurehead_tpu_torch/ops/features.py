"""Dense feature-matrix products in full float32.

All model code routes matrix products through :func:`matvec` /
:func:`rmatvec`, as in erasurehead_tpu/ops/features.py. Only dense stacks are
ported; leading batch dimensions ([W, S, n, F] or [P, n, F]) are carried
through, so one call computes every slot's product.

Precision: products run in float32 with TF32 off
(utils/device.pin_float32_precision), the counterpart of the JAX package's
``Precision.HIGHEST``. A bfloat16 stack is upcast to float32 before the
product (the JAX package instead casts the vector operand down and
accumulates in float32); the fused kernel (ops/kernels.py) streams bfloat16
as stored.
"""

from __future__ import annotations

import torch


def _f32(X: torch.Tensor) -> torch.Tensor:
    return X if X.dtype == torch.float32 else X.float()


def matvec(X: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """X @ v for dense X [..., n, F] and v [F] ([..., n]) or a weight
    matrix v [F, H] ([..., n, H])."""
    return torch.matmul(_f32(X), v)


def rmatvec(X: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """X^T @ r for dense X [..., n, F] and r [..., n]: [..., F]."""
    return torch.matmul(r.unsqueeze(-2), _f32(X)).squeeze(-2)
