"""GD, accelerated GD and Adam updates on a parameter tensor or a dict of them.

Update rules being matched (src/naive.py:113-122, as in
erasurehead_tpu/train/optimizer.py):
  GD:   beta <- (1 - 2*alpha*eta_i) * beta - (eta_i / n) * g
  AGD (Nesterov-style, theta_i = 2/(i+2)):
        y      = (1 - theta) * beta + theta * u
        beta+  = y - (eta_i / n) * g - 2*alpha*eta_i * beta
        u     <- beta + (beta+ - beta) / theta
  ADAM (beyond the reference): Adam on g/n + 2*alpha*beta.
where g is the *sum* gradient over collected samples and n is the total
sample count. Each update returns a new state; nothing is updated in place.
A dict of tensors (the deep families) updates leaf by leaf with the same
arithmetic as a bare tensor. A trajectory cohort updates all its B
trajectories at once (:func:`make_cohort_update_fn`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from erasurehead_tpu_torch.ops.blocks import tree_map
from erasurehead_tpu_torch.utils.config import UpdateRule


class OptState(NamedTuple):
    params: object  # a tensor, or a dict of tensors
    # AGD's u sequence; for ADAM the (mu, nu) moment pair; unused by GD
    momentum: object


def init_state(params, rule: UpdateRule = UpdateRule.AGD) -> OptState:
    zeros = tree_map(torch.zeros_like, params)
    if UpdateRule(rule) == UpdateRule.ADAM:
        return OptState(params=params, momentum=(zeros, tree_map(torch.zeros_like, params)))
    return OptState(params=params, momentum=zeros)


def _field(out, k: int):
    """Field k of every leaf's result tuple, as a tree."""
    return tree_map(lambda t: t[k], out)


def gd_update(state: OptState, g, eta: float, alpha: float, n_samples: int, i) -> OptState:
    mult = eta / n_samples

    def leaf(p, gl):
        return (1.0 - 2.0 * alpha * eta) * p - mult * gl

    return OptState(params=tree_map(leaf, state.params, g), momentum=state.momentum)


def agd_update(state: OptState, g, eta: float, alpha: float, n_samples: int, i) -> OptState:
    mult = eta / n_samples
    theta = 2.0 / (i + 2.0)

    def leaf(b, u, gl):
        y = (1.0 - theta) * b + theta * u
        b_next = y - mult * gl - 2.0 * alpha * eta * b
        return b_next, b + (b_next - b) / theta

    out = tree_map(leaf, state.params, state.momentum, g)
    return OptState(params=_field(out, 0), momentum=_field(out, 1))


def adam_update(state: OptState, g, eta: float, alpha: float, n_samples: int, i) -> OptState:
    """Adam on the objective the GD rule descends (mean loss +
    alpha*||params||^2); bias correction uses t = i+1. The corrections
    1 - b**t are taken in float32, as the JAX package takes them: at small t
    they cancel about three digits, so double precision would not match."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    t = np.float32(i + 1.0)
    mu, nu = state.momentum

    def leaf(p, m, v, gl):
        grad = gl / n_samples + 2.0 * alpha * p
        m_new = b1 * m + (1.0 - b1) * grad
        v_new = b2 * v + (1.0 - b2) * grad * grad
        m_hat = m_new / (np.float32(1.0) - np.float32(b1) ** t)
        v_hat = v_new / (np.float32(1.0) - np.float32(b2) ** t)
        return p - eta * m_hat / (torch.sqrt(v_hat) + eps), m_new, v_new

    out = tree_map(leaf, state.params, mu, nu, g)
    return OptState(params=_field(out, 0), momentum=(_field(out, 1), _field(out, 2)))


def make_update_fn(rule: UpdateRule):
    rule = UpdateRule(rule)
    if rule == UpdateRule.GD:
        return gd_update
    if rule == UpdateRule.ADAM:
        return adam_update
    return agd_update


def make_cohort_update_fn(rule: UpdateRule):
    """The update of a trajectory cohort: :func:`make_update_fn`'s rule under
    ``torch.func.vmap`` over (state, grads, eta, alpha), each leading with
    the trajectory axis [B] (the JAX trainer's ``vmap(update_fn)``); the
    sample count and round index are shared. eta and alpha are float32
    tensors, so the scalar coefficients are formed in float32 where the
    sequential update forms them from Python floats: equal to float
    tolerance, not bit for bit."""
    return torch.func.vmap(make_update_fn(rule), in_dims=(0, 0, 0, 0, None, None))
