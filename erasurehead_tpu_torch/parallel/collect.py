"""Collection rules: who the master hears from, what weights decode the gradient.

In the reference, each scheme's master sits in an ``MPI.Request.Waitany`` loop
with a scheme-specific stop condition. Here that protocol is a pure function
of the simulated arrival times ``t[round, worker]`` (parallel/straggler.py),
computed ahead of training in float64 on the host, exactly as
erasurehead_tpu/parallel/collect.py computes it:

  - ``message_weights`` [R, W]: the decode coefficient of each worker's
    message (0 for uncollected/unused workers);
  - ``sim_time`` [R]: the simulated master wall-clock per round (the
    reference's ``timeset``);
  - ``worker_times`` [R, W]: arrival stamps, -1 for workers never collected;
  - ``collected`` [R, W]: who the master heard from at all.

Stop conditions being reproduced (file:line in the original ErasureHead code):
  naive          wait for all W workers                src/naive.py:103-110
  cyclic MDS     first W-s arrivals, lstsq decode      src/coded.py:137-149
  FRC            first arrival of every group          src/replication.py:143-155
  AGC            num_collect arrivals OR all groups    src/approximate_coding.py:144-158
  avoidstragg    first W-s, unbiasedness rescale       src/avoidstragg.py:106-116

Tie-breaking: arrivals are processed in ascending (t, worker index) order.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from erasurehead_tpu_torch.ops import codes
from erasurehead_tpu_torch.ops.codes import CodingLayout
from erasurehead_tpu_torch.utils.config import Scheme, as_scheme

NEVER = -1.0  # reference sentinel for "not collected" (src/coded.py:171-173)


@dataclasses.dataclass(frozen=True)
class CollectionSchedule:
    """Per-round decode control data (see module docstring)."""

    message_weights: np.ndarray  # [R, W] float64
    sim_time: np.ndarray  # [R] float64
    worker_times: np.ndarray  # [R, W] float64, NEVER sentinel
    collected: np.ndarray  # [R, W] bool


def _order(t: np.ndarray) -> np.ndarray:
    """Arrival processing order per round: ascending time, worker index
    tie-break (a stable argsort)."""
    return np.argsort(t, axis=-1, kind="stable")


def _rank(t: np.ndarray) -> np.ndarray:
    """[R, W] arrival rank of each worker within its round."""
    R, W = t.shape
    ranks = np.empty((R, W), dtype=np.int64)
    np.put_along_axis(
        ranks, _order(t), np.broadcast_to(np.arange(W), (R, W)), axis=1
    )
    return ranks


def _stamp(t: np.ndarray, collected: np.ndarray) -> np.ndarray:
    return np.where(collected, t, NEVER)


def collect_all(t: np.ndarray) -> CollectionSchedule:
    """Uncoded synchronous GD: the master waits for everyone."""
    R, W = t.shape
    return CollectionSchedule(
        message_weights=np.ones((R, W)),
        sim_time=t.max(axis=1),
        worker_times=t.copy(),
        collected=np.ones((R, W), dtype=bool),
    )


def _first_k_lstsq(t: np.ndarray, B: np.ndarray, k: int) -> CollectionSchedule:
    """Stop at the k-th arrival, lstsq-decode over the received rows of B."""
    ranks = _rank(t)
    collected = ranks < k
    weights = codes.mds_decode_weights_host(B, collected)
    kth_time = np.where(ranks == k - 1, t, -np.inf).max(axis=1)
    return CollectionSchedule(
        message_weights=weights,
        sim_time=kth_time,
        worker_times=_stamp(t, collected),
        collected=collected,
    )


def collect_first_k_mds(
    t: np.ndarray, B: np.ndarray, n_stragglers: int
) -> CollectionSchedule:
    """Exact MDS coding: stop at the first W-s arrivals, solve decode weights
    over exactly that set."""
    return _first_k_lstsq(t, B, t.shape[1] - n_stragglers)


def collect_frc(t: np.ndarray, groups: np.ndarray) -> CollectionSchedule:
    """Fractional repetition: wait until every group has reported once; use
    each group's first arrival. This is AGC with an unreachable worker
    quota."""
    return collect_agc(t, groups, num_collect=t.shape[1] + 1)


def collect_agc(
    t: np.ndarray, groups: np.ndarray, num_collect: int
) -> CollectionSchedule:
    """Approximate gradient coding: process arrivals until either
    ``num_collect`` workers have reported or every group is covered; sum the
    first arrival of each covered group; uncovered groups are erased.
    Vectorized over rounds as one batched argsort + prefix scan."""
    R, W = t.shape
    n_groups = int(groups.max()) + 1
    order = _order(t)  # [R, W] event processing order
    onehot = np.eye(n_groups, dtype=np.int64)[np.asarray(groups)]  # [W, G]
    oh_sorted = onehot[order]  # [R, W, G] group membership in arrival order
    cum = np.cumsum(oh_sorted, axis=1)
    # first arrival of its group among events processed so far?
    win_sorted = (oh_sorted * (cum == 1)).sum(axis=2)  # [R, W] 0/1
    covered = (cum >= 1).sum(axis=2)  # [R, W] groups covered after j+1 events
    j = np.arange(1, W + 1)
    done = (j >= num_collect) | (covered >= n_groups)
    stop_idx = done.argmax(axis=1)  # first index where the loop exits
    taken_sorted = np.arange(W) <= stop_idx[:, None]
    weights = np.zeros((R, W))
    np.put_along_axis(weights, order, win_sorted * taken_sorted, axis=1)
    collected = np.zeros((R, W), dtype=bool)
    np.put_along_axis(collected, order, taken_sorted, axis=1)
    stop_worker = np.take_along_axis(order, stop_idx[:, None], axis=1)
    sim = np.take_along_axis(t, stop_worker, axis=1)[:, 0]
    return CollectionSchedule(
        message_weights=weights,
        sim_time=sim,
        worker_times=_stamp(t, collected),
        collected=collected,
    )


def collect_avoidstragg(t: np.ndarray, n_stragglers: int) -> CollectionSchedule:
    """Ignore-stragglers baseline: sum the first W-s uncoded gradients and
    rescale by W/(W-s) for unbiasedness (src/avoidstragg.py:116)."""
    R, W = t.shape
    k = W - n_stragglers
    ranks = _rank(t)
    collected = ranks < k
    kth_time = np.where(ranks == k - 1, t, -np.inf).max(axis=1)
    return CollectionSchedule(
        message_weights=collected * (W / k),
        sim_time=kth_time,
        worker_times=_stamp(t, collected),
        collected=collected,
    )


def _sched_agc(t, layout, num_collect):
    if num_collect is None:
        raise ValueError("AGC needs num_collect")
    return collect_agc(t, layout.groups, num_collect)


#: scheme -> host collection rule (the dispatch of the JAX package's scheme
#: registry, schemes/builtin.py, for the ported schemes)
_RULES = {
    Scheme.NAIVE: lambda t, layout, num_collect: collect_all(t),
    Scheme.CYCLIC_MDS: lambda t, layout, num_collect: collect_first_k_mds(
        t, layout.B, layout.n_stragglers
    ),
    Scheme.FRC: lambda t, layout, num_collect: collect_frc(t, layout.groups),
    Scheme.APPROX: _sched_agc,
    Scheme.AVOID_STRAGGLERS: lambda t, layout, num_collect: collect_avoidstragg(
        t, layout.n_stragglers
    ),
}


def build_schedule(
    scheme,
    t: np.ndarray,
    layout: CodingLayout,
    num_collect: int | None = None,
) -> CollectionSchedule:
    """The scheme's collection schedule over the arrival matrix ``t``."""
    return _RULES[as_scheme(scheme)](t, layout, num_collect)
