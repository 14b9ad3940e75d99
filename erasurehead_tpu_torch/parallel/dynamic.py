"""Collection on the device: arrivals, masks and decode weights inside the round.

The default trainer precomputes the whole straggler schedule on the host
(float64, parallel/collect.py), the analogue of the reference's
iteration-seeded delays. This module is the on-device alternative of the
JAX package's erasurehead_tpu/parallel/dynamic.py: each round's arrival
times are drawn on the run's device with JAX's counter RNG
(utils/threefry.py, the same numbers as ``jax.random.exponential``), every
collection rule is a fixed-shape tensor computation there, and the MDS
decode is a gather from a float64-solved table (ops/codes.MdsDecodeTable)
or, past the table's cap, the float32 solve (ops/codes.mds_decode_weights).
Nothing reads a value back to the host between rounds: the stop event is
indexed with index tensors, never ``int(tensor)``, and ties are broken by
stable sorts, as JAX's argsort breaks them (the tie-break is part of the
rule).

Every rule is held against the JAX package's jnp rule and against
parallel/collect.py's event replay on shared arrival matrices
(tests/test_torch_dynamic.py).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from erasurehead_tpu_torch.ops import codes
from erasurehead_tpu_torch.ops.codes import CodingLayout

NEVER = -1.0  # reference sentinel (src/coded.py:171-173; collect.NEVER)


class RoundSchedule(NamedTuple):
    """One round's collection, all tensors on the run's device."""

    message_weights: torch.Tensor  # [W] float32
    sim_time: torch.Tensor  # 0-d
    collected: torch.Tensor  # [W] bool
    worker_times: Optional[torch.Tensor] = None  # [W], NEVER for uncollected


def _argsort(t: torch.Tensor) -> torch.Tensor:
    return torch.argsort(t, stable=True)


def _ranks(t: torch.Tensor) -> torch.Tensor:
    """Arrival rank per worker; ties broken by worker index (collect.py's
    ``_order``: the sort is stable)."""
    order = _argsort(t)
    return torch.empty_like(order).scatter_(0, order, torch.arange(t.shape[0], device=t.device))


def _kth_arrival_time(t: torch.Tensor, ranks: torch.Tensor, k: int) -> torch.Tensor:
    return torch.where(ranks == k - 1, t, -torch.inf).max()


def _group_onehot(groups: np.ndarray) -> np.ndarray:
    G = int(groups.max()) + 1
    return np.eye(G)[groups]  # [W, G]


def _at(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``values[index]`` for a 0-d index tensor, with no host read."""
    return values.gather(0, index.view(1))[0]


def collect_all(t: torch.Tensor) -> RoundSchedule:
    W = t.shape[0]
    return RoundSchedule(
        torch.ones(W, device=t.device), t.max(), torch.ones(W, dtype=torch.bool, device=t.device)
    )


def collect_first_k_mds(
    t: torch.Tensor,
    B: torch.Tensor,
    n_stragglers: int,
    decode_table: Optional[codes.MdsDecodeTable] = None,
) -> RoundSchedule:
    return _first_k_lstsq(t, B, t.shape[0] - n_stragglers, decode_table=decode_table)


def _first_k_lstsq(
    t: torch.Tensor,
    B: torch.Tensor,
    k: int,
    decode_table: Optional[codes.MdsDecodeTable] = None,
) -> RoundSchedule:
    """Stop at the k-th arrival and decode over the received rows of B
    (the exact MDS decode for k = W - s, the least-squares-optimal one for
    k = num_collect): a table gather when a decode table is given, else
    the float32 solve (small W only)."""
    ranks = _ranks(t)
    mask = ranks < k
    if decode_table is not None:
        weights = decode_table.lookup(mask)
    else:
        weights = codes.mds_decode_weights(B, mask)
    return RoundSchedule(weights, _kth_arrival_time(t, ranks, k), mask)


def collect_avoidstragg(t: torch.Tensor, n_stragglers: int) -> RoundSchedule:
    W = t.shape[0]
    k = W - n_stragglers
    ranks = _ranks(t)
    mask = ranks < k
    return RoundSchedule(mask * (W / k), _kth_arrival_time(t, ranks, k), mask)


def collect_deadline(t: torch.Tensor, deadline: float) -> RoundSchedule:
    """Whatever arrived by the cutoff, rescaled W/collected; a round where
    nobody arrives applies a zero gradient and costs the full deadline."""
    W = t.shape[0]
    mask = t <= deadline
    cnt = mask.sum()
    weights = mask * (W / torch.clamp(cnt, min=1))
    sim = torch.where(cnt == W, t.max(), torch.full_like(t[0], deadline))
    return RoundSchedule(weights.float(), sim, mask)


def collect_agc(t: torch.Tensor, onehot: torch.Tensor, num_collect: int) -> RoundSchedule:
    """The AGC stop rule as prefix scans over the arrival order
    (collect.collect_agc's event loop, src/approximate_coding.py:144-158)."""
    W, G = onehot.shape
    dev = t.device
    order = _argsort(t)
    oh_sorted = onehot[order]  # [W, G] rows in arrival order
    cum = torch.cumsum(oh_sorted, dim=0)
    win_sorted = (oh_sorted * (cum == 1)).sum(dim=1)  # first of its group?
    covered = (cum >= 1).sum(dim=1)  # groups covered after j+1 arrivals
    j1 = torch.arange(1, W + 1, device=dev)
    done = (j1 >= num_collect) | (covered >= G)
    stop_idx = torch.argmax(done.to(torch.int32))  # the first True
    taken_sorted = torch.arange(W, device=dev) <= stop_idx
    weights = torch.zeros(W, device=dev).scatter_(0, order, (win_sorted * taken_sorted).float())
    collected = torch.zeros(W, dtype=torch.bool, device=dev).scatter_(0, order, taken_sorted)
    return RoundSchedule(weights, _at(t, _at(order, stop_idx)), collected)


def collect_frc(t: torch.Tensor, onehot: torch.Tensor) -> RoundSchedule:
    """FRC is AGC with an unreachable worker quota (collect.collect_frc)."""
    return collect_agc(t, onehot, num_collect=t.shape[0] + 1)


def collect_partial(
    t: torch.Tensor,
    *,
    variant: str,  # "mds" | "frc"
    frac: float,  # the uncoded part's send time as a fraction of the compute
    n_stragglers: int = 0,
    B: Optional[torch.Tensor] = None,  # [W, W], mds variant
    onehot: Optional[torch.Tensor] = None,  # [W, G], frc variant
    group_ids: Optional[torch.Tensor] = None,  # [W], frc variant
    decode_table: Optional[codes.MdsDecodeTable] = None,  # mds variant
) -> RoundSchedule:
    """The two-part schemes as a fixed-shape sort of 2W events and a prefix
    scan (collect.collect_partial's replay of the two-message Waitany loop,
    src/partial_coded.py:174-194, src/partial_replication.py:166-187).

    Events 0..W-1 are the uncoded parts (at ``frac * t``), W..2W-1 the coded
    parts (at ``t``); the loop exits at the first event where every uncoded
    part is in and the coded condition holds (W - s parts for the MDS
    decode, one part per group for FRC). The coded parts processed by then
    join the decode."""
    W = t.shape[0]
    dev = t.device
    times = torch.cat([frac * t, t])  # [2W]; the stable sort processes ties
    order = _argsort(times)  # in (time, part, worker) order
    is_second = order >= W
    cnt_first = torch.cumsum(~is_second, dim=0)
    cnt_second = torch.cumsum(is_second, dim=0)
    if variant == "mds":
        second_ok = cnt_second >= W - n_stragglers
    elif variant == "frc":
        oh_events = onehot[order % W] * is_second[:, None]  # [2W, G]
        second_ok = (torch.cumsum(oh_events, dim=0) >= 1).all(dim=1)
    else:
        raise ValueError(f"unknown partial variant {variant!r}")
    done = (cnt_first >= W) & second_ok  # always True at the last event
    stop_idx = torch.argmax(done.to(torch.int32))
    sec_taken = is_second & (torch.arange(2 * W, device=dev) <= stop_idx)
    completed = torch.zeros(W, dtype=torch.int32, device=dev).scatter_reduce(
        0, order % W, sec_taken.to(torch.int32), "amax"
    ) > 0
    if variant == "mds":
        if decode_table is not None:
            weights = decode_table.lookup(completed)
        else:
            weights = codes.mds_decode_weights(B, completed)
    else:
        # each group's first coded arrival, if completed (the stable-rank
        # minimum: collect._group_winners' first-index tie-break)
        ranks = _ranks(t)
        min_rank = torch.where(onehot.T.bool(), ranks[None, :], W).amin(dim=1)  # [G]
        win = ranks == min_rank[group_ids]
        weights = (win & completed).to(t.dtype)
    return RoundSchedule(weights, _at(times, _at(order, stop_idx)), completed)


def make_round_schedule_fn(
    scheme,
    layout: CodingLayout,
    num_collect: Optional[int] = None,
    delay_mean: float = 0.5,
    add_delay: bool = True,
    deadline: Optional[float] = None,
    device=None,
) -> Callable[[tuple], RoundSchedule]:
    """(per-round threefry key: host ints, or a [2] int64 tensor on the
    device) -> RoundSchedule on ``device``.

    The arrivals are ``delay_mean * exponential(key, (W,))``
    (straggler.threefry_delay_schedule's draw: JAX's numbers, not the
    reference's numpy stream; the host control plane of trainer.train is
    the one with run-for-run parity with the reference). The rule is the
    scheme descriptor's ``dynamic_rule`` (schemes/builtin.py), built here
    once with its constants (layout tables, the MDS decode table) on the
    device."""
    from erasurehead_tpu_torch import schemes
    from erasurehead_tpu_torch.utils import threefry

    desc = schemes.get(scheme)
    W = layout.n_workers
    if desc.dynamic_rule is None:
        raise ValueError(
            f"scheme {desc.name!r} has no dynamic (on-device) collection "
            "rule; use the host control plane (trainer.train)"
        )
    device = torch.device("cpu" if device is None else device)
    rule = desc.dynamic_rule(layout, num_collect=num_collect, deadline=deadline, device=device)

    def draw(key):
        if not add_delay:
            return torch.zeros(W, device=device)
        return delay_mean * threefry.exponential(key, W, device)

    def schedule(key) -> RoundSchedule:
        t = draw(key)
        rs = rule(t)
        return rs._replace(worker_times=torch.where(rs.collected, t, NEVER))

    # a rule that reads the device from the host (the float32 decode solve)
    # keeps train_dynamic's eager loop: a CUDA graph cannot capture it
    schedule.host_sync = getattr(rule, "host_sync", None)
    return schedule
