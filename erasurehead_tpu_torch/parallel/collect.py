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
  partial MDS    all uncoded parts AND >= W-s coded    src/partial_coded.py:174-194
  partial FRC    all uncoded parts AND 1 coded/group   src/partial_replication.py:166-187

and the beyond-reference rules of the JAX package: first-k with the
least-squares-optimal decode (randreg, sparsegraph, expander), deadline
collection, and the ``decode="optimal"`` refit of any scheme's weights
(arXiv:2006.09638). Which rule a scheme takes is its registry descriptor's
(erasurehead_tpu_torch/schemes/); :func:`build_schedule` applies it.

Tie-breaking: arrivals are processed in ascending (t, worker index) order.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from erasurehead_tpu_torch.ops import codes
from erasurehead_tpu_torch.ops.codes import CodingLayout

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


def _group_winners(t: np.ndarray, groups: np.ndarray) -> np.ndarray:
    """[R, W] bool: is worker the earliest arrival of its group (index tie-break)."""
    R, W = t.shape
    n_groups = int(groups.max()) + 1
    win = np.zeros((R, W), dtype=bool)
    for g in range(n_groups):
        members = np.flatnonzero(groups == g)
        best = members[np.argmin(t[:, members], axis=1)]  # argmin: first index wins
        win[np.arange(R), best] = True
    return win


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


def collect_first_k_mds(
    t: np.ndarray, B: np.ndarray, n_stragglers: int
) -> CollectionSchedule:
    """Exact MDS coding: stop at the first W-s arrivals, solve decode weights
    over exactly that set."""
    return collect_first_k_optimal(t, B, t.shape[1] - n_stragglers)


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


def collect_first_k_optimal(
    t: np.ndarray, B: np.ndarray, num_collect: int
) -> CollectionSchedule:
    """Optimal-decoding AGC (arXiv 2006.09638): stop at the first
    ``num_collect`` arrivals and take the least-squares combination of
    their messages, the weights minimizing ||w^T B - 1||_2 over the
    received rows of the incidence matrix."""
    ranks = _rank(t)
    collected = ranks < num_collect
    weights = codes.mds_decode_weights_host(B, collected)
    kth_time = np.where(ranks == num_collect - 1, t, -np.inf).max(axis=1)
    return CollectionSchedule(
        message_weights=weights,
        sim_time=kth_time,
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


def collect_deadline(t: np.ndarray, deadline: float) -> CollectionSchedule:
    """Deadline-based collection: the master takes every gradient that
    arrived by ``deadline`` simulated seconds into the round and rescales by
    W/collected for unbiasedness. A round where all workers arrive early
    stops at the last arrival; otherwise the master waits out the deadline.
    A round with zero arrivals applies a zero gradient (all weights 0) and
    costs the deadline."""
    R, W = t.shape
    collected = t <= deadline
    cnt = collected.sum(axis=1)
    weights = collected * (W / np.maximum(cnt, 1)[:, None])
    all_in = cnt == W
    sim = np.where(all_in, t.max(axis=1, initial=-np.inf), deadline)
    return CollectionSchedule(
        message_weights=weights,
        sim_time=sim,
        worker_times=_stamp(t, collected),
        collected=collected,
    )


def collect_partial(
    t: np.ndarray,
    layout: CodingLayout,
    variant: str,  # "mds" | "frc"
) -> CollectionSchedule:
    """Two-part schemes: every worker sends its uncoded part when its unique
    partitions are done, its coded part when the rest are; the master needs
    all uncoded parts plus enough coded parts (W-s for the MDS decode,
    src/partial_coded.py:174-194; one per group for FRC,
    src/partial_replication.py:166-187).

    A worker's full compute finishes at t[r, w]; its uncoded part (n_sep of
    n_slots partitions) is sent at the same fraction of that time.
    ``message_weights`` weight only the coded messages: the step weights
    separate slots 1.0 unconditionally (step.expand_slot_weights).
    """
    R, W = t.shape
    s = layout.n_stragglers
    t_first, t_second = layout.uncoded_frac * t, t
    # event replay of the two-message Waitany loop: 2W events per round
    # (each worker's uncoded part at t_first, coded part at t_second) in a
    # stable ascending (time, part, worker) order; the loop exits at the
    # first event satisfying both stop conditions, and the coded parts
    # processed by then join the decode
    times = np.concatenate([t_first, t_second], axis=1)  # [R, 2W]; first W = uncoded
    order = _order(times)
    is_second = order >= W  # [R, 2W]: is the j-th processed event a coded part?
    cnt_first = np.cumsum(~is_second, axis=1)
    cnt_second = np.cumsum(is_second, axis=1)
    if variant == "mds":
        second_ok = cnt_second >= W - s
    else:
        # one coded part per group (partial FRC): per-event group coverage
        onehot = np.eye(layout.n_groups, dtype=np.int64)[
            np.asarray(layout.groups)
        ]  # [W, G]
        oh_events = onehot[order % W] * is_second[..., None]  # [R, 2W, G]
        second_ok = (np.cumsum(oh_events, axis=1) >= 1).all(axis=2)
    done = (cnt_first >= W) & second_ok  # always True at the last event
    stop_idx = done.argmax(axis=1)
    stop_ev = np.take_along_axis(order, stop_idx[:, None], axis=1)
    stop = np.take_along_axis(times, stop_ev, axis=1)[:, 0]
    sec_taken = is_second & (np.arange(2 * W) <= stop_idx[:, None])
    completed = np.zeros((R, W), dtype=bool)
    rr, jj = np.nonzero(sec_taken)
    completed[rr, order[rr, jj] % W] = True
    if variant == "mds":
        # the reference solves over all completed coded parts at loop exit
        # (src/partial_coded.py:192-193), possibly more than W-s rows
        weights = codes.mds_decode_weights_host(layout.B, completed)
    elif variant == "frc":
        # only each group's first coded arrival is summed
        # (src/partial_replication.py:173-180)
        win = _group_winners(t_second, layout.groups)
        weights = (win & completed).astype(np.float64)
    else:
        raise ValueError(f"unknown partial variant {variant!r}")
    # worker_timeset: -1 for workers whose coded part never arrived
    # (src/partial_coded.py:210-212)
    return CollectionSchedule(
        message_weights=weights,
        sim_time=stop,
        worker_times=_stamp(t_second, completed),
        collected=completed,
    )


def optimal_decode_weights_host(E: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """Least-squares collection weights fit to the actual arrival sets, the
    optimal decoder of arXiv:2006.09638.

    ``E`` is the layout's [W, P] effective coding matrix; for each round's
    completion mask the returned row minimizes ``||w^T E - 1||_2`` over
    weights supported on the collected workers (the weight-space decode
    error obs/decode.py reports). Host float64; each distinct mask is solved
    once, in ``np.unique`` order.
    """
    E = np.asarray(E, dtype=np.float64)
    masks = np.asarray(masks, dtype=bool)
    ones = np.ones(E.shape[1])
    uniq, inverse = np.unique(masks, axis=0, return_inverse=True)
    out = np.zeros((uniq.shape[0], E.shape[0]))
    for k in range(uniq.shape[0]):
        live = np.flatnonzero(uniq[k])
        if live.size:
            out[k, live] = np.linalg.lstsq(E[live, :].T, ones, rcond=None)[0]
    return out[inverse.reshape(-1)]


def optimal_decode_schedule(
    schedule: CollectionSchedule, layout: CodingLayout
) -> CollectionSchedule:
    """``decode="optimal"``: keep the schedule's stop condition (who was
    collected, when the master exited) and refit only the decode weights
    to each round's actual arrival set."""
    weights = optimal_decode_weights_host(
        layout.effective_matrix(), schedule.collected
    )
    return dataclasses.replace(schedule, message_weights=weights)


def build_schedule(
    scheme,
    t: np.ndarray,
    layout: CodingLayout,
    num_collect: int | None = None,
    deadline: float | None = None,
    decode: str = "fixed",
) -> CollectionSchedule:
    """The scheme's collection schedule through its registry descriptor
    (the reference's dispatch was main.py:62-92). ``decode="optimal"``
    refits the decode weights per round to the actual arrival set on
    schemes with an ``optimal_decode`` hook; the partial two-part layouts
    keep their fixed weights."""
    from erasurehead_tpu_torch import schemes

    desc = schemes.get(scheme)
    sched = desc.build_schedule(t, layout, num_collect=num_collect, deadline=deadline)
    if decode == "optimal" and desc.optimal_decode is not None:
        sched = desc.optimal_decode(sched, layout)
    elif decode not in ("fixed", "optimal"):
        raise ValueError(f"decode must be fixed/optimal, got {decode!r}")
    return sched
