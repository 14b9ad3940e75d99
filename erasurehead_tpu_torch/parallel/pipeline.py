"""Bounded-staleness pipelined collection: break the round barrier.

The port of erasurehead_tpu/parallel/pipeline.py. A synchronous trainer
serializes rounds on the master clock: round t+1 cannot dispatch until round
t's collection closes, so one heavy-tail straggler stalls every round even
when the code could absorb the erasure. ``pipeline_depth=1`` overlaps
adjacent rounds instead: round t+1's worker compute is dispatched against
the params of round t-1 while round t's arrivals drain (staleness tau = 1,
which the approximate schemes tolerate; exact-decode schemes are refused
through their descriptor's ``staleness_tolerant`` flag).

This module is the pipelined control plane: a deterministic host-float64
recurrence over the same drawn arrival matrix the synchronous schedule
reads, reusing each scheme's own stop rule (train/trainer.build_schedule)
per round on the workers' effective relative arrivals. The schedule is a
pure function of (cfg, arrivals, layout), so journal replays and kill ->
resume runs stay bitwise.

The timing model (absolute simulated master clock):

  dispatch[r] = max(dispatch[r-1], done[r-2])     params p_{r-1} ready
  start[r,w]  = max(dispatch[r], free[w])         worker finishes r-1 first
  arrive[r,w] = start[r,w] + t[r,w]               t = drawn per-round times
  stop[r]     = dispatch[r] + scheme stop rule over (arrive - dispatch)
  done[r]     = max(done[r-1], stop[r])           decode+update applied
  free[w]     = arrive[r,w] if collected else min(arrive[r,w], done[r])
                                                  (stragglers are cancelled
                                                   when the round closes)

At depth 0 the recurrence collapses to ``dispatch[r] = done[r-1]``; every
worker is free by then, the effective relative arrivals equal the drawn
matrix row, and the schedule is bitwise the synchronous schedule.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from erasurehead_tpu_torch.utils.config import PipelineRefusal  # noqa: F401


@dataclasses.dataclass(frozen=True)
class PipelinedSchedule:
    """Collection schedule of a pipelined run.

    Duck-types :class:`parallel.collect.CollectionSchedule` (the trainer and
    obs/decode read only the four shared fields) and adds the pipeline's
    own timing artifacts:

      - ``dispatch`` [R]: absolute simulated time each round's compute was
        dispatched to the workers;
      - ``done`` [R]: absolute time each round's decode+update applied;
      - ``dispatch_ahead`` [R]: how far ahead of the synchronous barrier the
        dispatch ran, ``done[r-1] - dispatch[r]`` (>= 0; 0 everywhere at
        depth 0);
      - ``staleness`` [R]: the per-round staleness (tau), 0 for the warm-up
        rounds that still compute at fresh params.
    """

    message_weights: np.ndarray  # [R, W] float64
    sim_time: np.ndarray  # [R] float64 (done[r] - done[r-1])
    worker_times: np.ndarray  # [R, W] float64, collect.NEVER sentinel
    collected: np.ndarray  # [R, W] bool
    dispatch: np.ndarray  # [R] float64, absolute
    done: np.ndarray  # [R] float64, absolute
    dispatch_ahead: np.ndarray  # [R] float64, >= 0
    staleness: np.ndarray  # [R] int64


def staleness_schedule(rounds: int, depth: int) -> np.ndarray:
    """[R] per-round staleness tau: round r computes its gradient at the
    params of round ``r - tau[r]``. Depth-1 pipelining is tau = 1 from round
    1 on; rounds 0..depth-1 are the fresh warm-up."""
    return np.minimum(np.arange(rounds, dtype=np.int64), int(depth))


def pipelined_schedule(cfg, t: np.ndarray, layout) -> PipelinedSchedule:
    """The depth-``cfg.pipeline_depth`` pipelined schedule of one run (module
    docstring's timing model).

    ``t`` is the same [R, W] drawn arrival matrix the synchronous trainer
    hands its collection rule. Each round's stop rule runs on the workers'
    effective relative arrivals (skewed by busy workers), so every scheme's
    collection (first-k, group coverage, deadline, the optimal refit)
    composes unchanged. Host float64 throughout; the per-round rules'
    exceptions propagate."""
    from erasurehead_tpu_torch.train.trainer import build_schedule

    t = np.asarray(t, dtype=np.float64)
    R, W = t.shape
    depth = int(cfg.pipeline_depth)

    weights = np.zeros((R, W))
    wtimes = np.zeros((R, W))
    coll = np.zeros((R, W), dtype=bool)
    dispatch = np.zeros(R)
    done = np.zeros(R)
    sim = np.zeros(R)
    ahead = np.zeros(R)

    free = np.zeros(W)  # absolute time each worker is next available
    done_prev = 0.0  # done[r-1]
    done_lag = 0.0  # done[r-1-depth]: the dispatch gate
    recent: list = []  # trailing done values, for the lagged gate
    for r in range(R):
        disp = max(dispatch[r - 1] if r else 0.0, done_lag)
        # effective relative arrivals, built without a round trip through
        # the absolute clock: a worker free by dispatch time adds exactly
        # 0.0, so at depth 0 the rule sees the drawn row t[r] bitwise
        skew = np.maximum(free - disp, 0.0)
        rel = skew + t[r]
        # the scheme's own stop rule on this round's effective arrivals: one
        # [1, W] schedule a round (the optimal refit composes as it does
        # synchronously)
        sched = build_schedule(cfg, rel[None, :], layout)
        stop_rel = float(sched.sim_time[0])
        # delta <= 0 when the dispatch ran ahead of the previous round's
        # close; exactly 0.0 at depth 0, where sim[r] is stop_rel bitwise
        delta = disp - done_prev
        sim[r] = max(0.0, delta + stop_rel)
        d = done_prev + sim[r]
        weights[r] = sched.message_weights[0]
        wtimes[r] = sched.worker_times[0]
        coll[r] = sched.collected[0]
        dispatch[r] = disp
        done[r] = d
        ahead[r] = max(-delta, 0.0)
        # collected workers are freed at their own arrival; stragglers are
        # cancelled when the round closes (the reference master's abort)
        arrive = disp + rel
        free = np.where(coll[r], arrive, np.minimum(arrive, d))
        recent.append(d)
        done_prev = d
        done_lag = recent[-1 - depth] if len(recent) > depth else 0.0
    return PipelinedSchedule(
        message_weights=weights,
        sim_time=sim,
        worker_times=wtimes,
        collected=coll,
        dispatch=dispatch,
        done=done,
        dispatch_ahead=ahead,
        staleness=staleness_schedule(R, depth),
    )


def overlap_summary(schedule: PipelinedSchedule) -> dict:
    """Host summary of the pipeline's dispatch-ahead overlap."""
    ahead = np.asarray(schedule.dispatch_ahead, dtype=np.float64)
    return {
        "ahead_mean_s": round(float(ahead.mean()), 6) if ahead.size else 0.0,
        "ahead_max_s": round(float(ahead.max()), 6) if ahead.size else 0.0,
        "overlap_total_s": round(float(ahead.sum()), 6),
    }
