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


def _gd(state: OptState, g, decay, mult) -> OptState:
    def leaf(p, gl):
        return decay * p - mult * gl

    return OptState(params=tree_map(leaf, state.params, g), momentum=state.momentum)


def gd_update(state: OptState, g, eta: float, alpha: float, n_samples: int, i) -> OptState:
    return _gd(state, g, 1.0 - 2.0 * alpha * eta, eta / n_samples)


def _agd(state: OptState, g, keep, theta, mult, l2, over_theta) -> OptState:
    """AGD's step given its round scalars: ``keep = 1 - theta``, ``theta``,
    ``mult = eta / n``, ``l2 = 2 * alpha * eta`` and ``over_theta``, the
    division by theta."""

    def leaf(b, u, gl):
        y = keep * b + theta * u
        b_next = y - mult * gl - l2 * b
        return b_next, b + over_theta(b_next - b)

    out = tree_map(leaf, state.params, state.momentum, g)
    return OptState(params=_field(out, 0), momentum=_field(out, 1))


def agd_update(state: OptState, g, eta: float, alpha: float, n_samples: int, i) -> OptState:
    theta = 2.0 / (i + 2.0)
    return _agd(state, g, 1.0 - theta, theta, eta / n_samples, 2.0 * alpha * eta,
                lambda d: d / theta)


_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _adam_corrections(i):
    """Adam's bias corrections ``1 - b**t`` at t = i+1, in float32."""
    t = np.float32(i + 1.0)
    return (np.float32(1.0) - np.float32(_B1) ** t, np.float32(1.0) - np.float32(_B2) ** t)


def _adam(state: OptState, g, eta, alpha, n_samples, over_c1, over_c2) -> OptState:
    mu, nu = state.momentum

    def leaf(p, m, v, gl):
        grad = gl / n_samples + 2.0 * alpha * p
        m_new = _B1 * m + (1.0 - _B1) * grad
        v_new = _B2 * v + (1.0 - _B2) * grad * grad
        m_hat = over_c1(m_new)
        v_hat = over_c2(v_new)
        return p - eta * m_hat / (torch.sqrt(v_hat) + _EPS), m_new, v_new

    out = tree_map(leaf, state.params, mu, nu, g)
    return OptState(params=_field(out, 0), momentum=(_field(out, 1), _field(out, 2)))


def adam_update(state: OptState, g, eta: float, alpha: float, n_samples: int, i) -> OptState:
    """Adam on the objective the GD rule descends (mean loss +
    alpha*||params||^2); bias correction uses t = i+1. The corrections
    1 - b**t are taken in float32, as the JAX package takes them: at small t
    they cancel about three digits, so double precision would not match."""
    c1, c2 = _adam_corrections(i)
    return _adam(state, g, eta, alpha, n_samples, lambda x: x / c1, lambda x: x / c2)


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


# ---------------------------------------------------------------------------
# the round bodies of train, train_dynamic and train_cohort read their
# per-round scalars from device tables, captured or not (train/graphs.py):
# a Python float would be baked into the captured kernels, and a cached
# graph replays runs whose lr and round differ. The scalar forms above
# stay for the loops that are never captured (train_measured, the streamed
# windows); the table forms are bitwise them


def _over(col, recip: bool):
    """Division by the host scalar a column stands for. On CUDA a tensor
    divided by a host scalar is multiplied by the scalar's reciprocal,
    taken in double and rounded to float32 (the column holds it: measured
    on an H100, 100 of 100 rounds' AGD thetas, where the float32 reciprocal
    of the float32 theta differs in 13); on the CPU it is a true division by
    the float32 scalar (the column holds it)."""
    return (lambda d: d * col) if recip else (lambda d: d / col)


def _divisor(x, recip: bool):
    return np.float32(1.0 / float(x)) if recip else np.float32(x)


def round_table(rule: UpdateRule, lr, rounds, alpha: float, n_samples: int,
                recip: bool) -> np.ndarray:
    """[len(rounds), K] float32: the scalars the eager update forms on the
    host each round, one row per round (absolute indices ``rounds``, learning
    rates ``lr``), formed in double and rounded to float32 as the eager
    update's scalars are where they meet a float32 tensor. ``recip`` as in
    :func:`_over` (True on CUDA)."""
    rule = UpdateRule(rule)
    rows = []
    for eta, i in zip((float(e) for e in lr), (float(r) for r in rounds)):
        if rule == UpdateRule.GD:
            rows.append((1.0 - 2.0 * alpha * eta, eta / n_samples))
        elif rule == UpdateRule.ADAM:
            c1, c2 = _adam_corrections(i)
            rows.append((eta, _divisor(c1, recip), _divisor(c2, recip)))
        else:
            theta = 2.0 / (i + 2.0)
            rows.append((1.0 - theta, theta, eta / n_samples, 2.0 * alpha * eta,
                         _divisor(theta, recip)))
    return np.asarray(rows, dtype=np.float32).reshape(len(rows), -1)


def make_table_update_fn(rule: UpdateRule, recip: bool):
    """``(state, g, coef, alpha, n_samples) -> state``: the update of
    :func:`make_update_fn` reading its round scalars from ``coef``, a row of
    :func:`round_table` on the device. Bitwise the scalar update."""
    rule = UpdateRule(rule)
    if rule == UpdateRule.GD:
        return lambda state, g, coef, alpha, n: _gd(state, g, coef[0], coef[1])
    if rule == UpdateRule.ADAM:
        return lambda state, g, coef, alpha, n: _adam(
            state, g, coef[0], alpha, n, _over(coef[1], recip), _over(coef[2], recip))
    return lambda state, g, coef, alpha, n: _agd(
        state, g, coef[0], coef[1], coef[2], coef[3], _over(coef[4], recip))


def cohort_round_table(rule: UpdateRule, rounds, recip: bool) -> np.ndarray:
    """[len(rounds), K] float32: the round-index scalars of a cohort's
    update (its lr and alpha are float32 tensors already): AGD's
    ``1 - theta``, ``theta`` and the division by theta, Adam's two
    corrections; GD has none (K = 1, unused)."""
    rule = UpdateRule(rule)
    rows = []
    for i in (float(r) for r in rounds):
        if rule == UpdateRule.ADAM:
            c1, c2 = _adam_corrections(i)
            rows.append((_divisor(c1, recip), _divisor(c2, recip)))
        elif rule == UpdateRule.AGD:
            theta = 2.0 / (i + 2.0)
            rows.append((1.0 - theta, theta, _divisor(theta, recip)))
        else:
            rows.append((0.0,))
    return np.asarray(rows, dtype=np.float32).reshape(len(rows), -1)


def make_cohort_table_update_fn(rule: UpdateRule, recip: bool):
    """:func:`make_cohort_update_fn` reading its round-index scalars from
    ``coef``, a row of :func:`cohort_round_table` shared by the cohort:
    ``(state_B, g_B, eta_B, alpha_B, n_samples, coef) -> state_B``."""
    rule = UpdateRule(rule)
    if rule == UpdateRule.GD:
        def one(state, g, eta, alpha, n, coef):
            return _gd(state, g, 1.0 - 2.0 * alpha * eta, eta / n)
    elif rule == UpdateRule.ADAM:
        def one(state, g, eta, alpha, n, coef):
            return _adam(state, g, eta, alpha, n, _over(coef[0], recip),
                         _over(coef[1], recip))
    else:
        def one(state, g, eta, alpha, n, coef):
            return _agd(state, g, coef[0], coef[1], eta / n, 2.0 * alpha * eta,
                        _over(coef[2], recip))
    return torch.func.vmap(one, in_dims=(0, 0, 0, 0, None, None))
