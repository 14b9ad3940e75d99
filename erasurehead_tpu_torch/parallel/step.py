"""The coded gradient step on one device.

In the JAX package (erasurehead_tpu/parallel/step.py) the step is a
``shard_map`` over a worker mesh axis: each chip computes the slot gradients
of its logical workers, contracts them with the collection weights, and a
``psum`` over the worker axis decodes. On one card the W logical workers fold
onto the one device, so the ``psum`` is the identity and a round's device
work is one op: the decoded gradient of the whole stack.

Three forms of that op, each a function ``(params, X, y, weights) -> [F]``:

  - :func:`make_faithful_grad_fn`: every worker computes each of its
    (possibly redundant) slot gradients of the worker-major [W, S, rows, F]
    stack, then the [W, S] slot weights contract them;
  - :func:`make_deduped_grad_fn`: every partition gradient of the
    partition-major [P, rows, F] stack once, contracted with the folded [P]
    partition weights;
  - :func:`make_fused_grad_fn`: either stack, leading dims flattened into M
    slots, through the one-pass kernel (ops/kernels.fused_glm_grad).

The first two are the two-pass PyTorch form, the counterpart of the JAX
package's own XLA lowering.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

GradFn = Callable[..., torch.Tensor]  # (params, X, y, weights) -> [F]


def _weighted_sum(weights: torch.Tensor, grads: torch.Tensor, contract: str):
    """sum_i weights[i...] * grads[i..., :] over the leading axes."""
    return torch.einsum(f"{contract},{contract}f->f", weights, grads)


def make_faithful_grad_fn(model) -> GradFn:
    """Every logical worker computes all of its (redundant) slot gradients.

    Matches the reference's cost model: an FRC/MDS worker does (s+1)
    partitions' worth of matvec work each round.

    Args of the returned fn:
      params: [F] float32.
      Xw, yw: worker-major stacks [W, S, rows, F] / [W, S, rows].
      slot_weights: [W, S] decode x coding weight per slot message.
    """

    def grad(params, Xw, yw, slot_weights):
        per_slot = model.grad_sum(params, Xw, yw)  # [W, S, F]
        return _weighted_sum(slot_weights, per_slot, "ws")

    return grad


def make_deduped_grad_fn(model) -> GradFn:
    """Each partition gradient once, combined with folded decode weights
    (CodingLayout.fold_slot_weights): the same decoded gradient as the
    faithful mode at 1/(s+1) the work.

    Args of the returned fn:
      params: [F] float32.
      Xp, yp: partition-major stacks [P, rows, F] / [P, rows].
      part_weights: [P] folded per-partition weights.
    """

    def grad(params, Xp, yp, part_weights):
        per_part = model.grad_sum(params, Xp, yp)  # [P, F]
        return _weighted_sum(part_weights, per_part, "p")

    return grad


def make_fused_grad_fn(kind: str) -> GradFn:
    """The one-pass kernel (ops/kernels.py) as a drop-in for either grad fn
    above on dense GLM stacks: the worker-major [W, S, rows, F] or the
    partition-major [P, rows, F] stack, leading dims flattened into kernel
    slots (views, no copy)."""
    from erasurehead_tpu_torch.ops import kernels

    def grad(params, Xs, ys, ws):
        M = int(np.prod(Xs.shape[:-2]))
        return kernels.fused_glm_grad(
            params,
            Xs.reshape((M,) + tuple(Xs.shape[-2:])),
            ys.reshape(M, -1),
            ws.reshape(M),
            kind,
        )

    return grad


def expand_slot_weights(
    message_weights: np.ndarray, coeffs: np.ndarray, slot_is_coded: np.ndarray
) -> np.ndarray:
    """[R?, W] per-message decode weights -> [R?, W, S] per-slot weights
    (host float64, the single home of this rule).

    Coded slots are scaled by the message's decode weight; separate slots
    (partial schemes' uncoded first parts) always contribute with weight 1
    (src/partial_coded.py:187-190)."""
    a = np.asarray(message_weights)[..., :, None]
    return np.where(slot_is_coded, a * coeffs, coeffs)
