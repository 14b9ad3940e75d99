"""Per-round wall-clock attribution: where a run's time went.

The port of erasurehead_tpu/obs/critical_path.py. ErasureHead's argument
(arXiv:1901.09671) is a wall-clock decomposition: how much of a round the
master spends waiting on stragglers versus doing work. Two ledgers, because
the system runs two clocks:

  - the simulated master clock (``timeset``, the paper's quantity): each
    round's close decomposes into the fastest-arrival compute floor
    (``compute_s``), the straggler wait (``straggler_wait_s``, the tail
    between the first usable arrival and the stop rule closing, deadline
    idling included) and the pipelined dispatch gap (``dispatch_gap_s``,
    nonzero only when the depth-lagged gate stalls). Pipelined overlap that
    hid arrival time behind the previous round rides along as
    ``overlap_hidden_s``, outside the ledger (it is the win, not a cost);
  - the host wall (``wall_s``, the timed round loop): decode+update
    execution (``decode_update_s``, the rounds' device work and the host
    work that launches it) versus the prefetch stall (``prefetch_stall_s``,
    the staging waits of a streamed run that the double buffer failed to
    hide, data/prefetch.py ``blocked_s``).

Each ledger sums to its measured total by construction, and the validator
(obs/events.py ``critical_path`` checks) re-verifies the reconciliation
within :data:`events.CRITICAL_PATH_TOL` on every line. Everything here is
host float64 over arrays the run already produced, emitted after the timed
loop like every other record, so the ledgers equal the JAX package's
exactly on the same arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from erasurehead_tpu_torch.obs import events

#: sim-ledger bucket names, in render order
SIM_BUCKETS = ("compute_s", "straggler_wait_s", "dispatch_gap_s")

#: host-ledger bucket names, in render order
HOST_BUCKETS = ("decode_update_s", "prefetch_stall_s")


@dataclasses.dataclass(frozen=True)
class CriticalPath:
    """One run's attribution: totals, ledgers, and per-round arrays."""

    wall_s: float  # measured host wall of the timed region
    sim_total_s: float  # measured simulated master clock (timeset sum)
    components: dict  # host ledger, sums to wall_s
    sim_components: dict  # sim ledger, sums to sim_total_s
    overlap_hidden_s: float  # pipelined overlap (a win; outside ledgers)
    transport: str  # "ring" | "none" — where decode_update_s ran
    per_round: dict  # {"compute_s","straggler_wait_s","dispatch_gap_s"}

    def fractions(self) -> dict:
        """Both ledgers normalized by their own measured totals, keyed
        without the ``_s`` suffix (the typed event's ``fractions``
        payload). Values are clamped to [0, 1] against float dust."""
        out = {}
        for comps, total in (
            (self.components, self.wall_s),
            (self.sim_components, self.sim_total_s),
        ):
            for k, v in comps.items():
                frac = v / total if total > 0 else 0.0
                out[k[:-2] if k.endswith("_s") else k] = round(
                    min(max(frac, 0.0), 1.0), 6
                )
        return out

    def payload(self) -> dict:
        """The ``critical_path`` event payload (everything but run_id)."""
        return {
            "wall_s": round(self.wall_s, 6),
            "sim_total_s": round(self.sim_total_s, 6),
            "components": {
                k: round(v, 6) for k, v in self.components.items()
            },
            "sim_components": {
                k: round(v, 6) for k, v in self.sim_components.items()
            },
            "fractions": self.fractions(),
            "overlap_hidden_s": round(self.overlap_hidden_s, 6),
            "transport": self.transport,
        }


def attribute(
    timeset,
    worker_times,
    collected,
    *,
    wall_s: float,
    prefetch_stall_s: float = 0.0,
    dispatch=None,
    done=None,
    transport: str = "none",
) -> CriticalPath:
    """Build both attribution ledgers from a run's schedule arrays.

    ``timeset``/``worker_times``/``collected`` are the usual [R]/[R, W]
    schedule artifacts (worker_times carries the -1 never-arrived
    sentinel; masking happens here, same discipline as
    events.arrival_summary). ``dispatch``/``done`` are the pipelined
    schedule's absolute clocks when available (parallel/pipeline.
    PipelinedSchedule) — without them the dispatch-gap bucket is zero,
    which is exact for every synchronous schedule.
    """
    t = np.asarray(timeset, dtype=np.float64)
    wt = np.asarray(worker_times, dtype=np.float64)
    coll = np.asarray(collected, dtype=bool)
    R = t.shape[0]

    # masked first/last collected arrival per round (relative clock)
    ok = coll & (wt >= 0.0) & np.isfinite(wt)
    has_any = ok.any(axis=1)
    first = np.where(
        has_any, np.where(ok, wt, np.inf).min(axis=1), 0.0
    )
    stop_rel = np.where(
        has_any, np.where(ok, wt, -np.inf).max(axis=1), 0.0
    )

    # pipelined overlap: the part of the round's relative close that the
    # previous round's drain already covered (sim_time < stop_rel).
    # Exactly zero for synchronous schedules, where timeset IS the
    # relative stop (deadline cutoffs have timeset >= stop_rel).
    hidden = np.maximum(stop_rel - t, 0.0)

    # dispatch gap: master idle between the previous close and this
    # round's dispatch gate opening (depth-lagged gate stalls only)
    gap = np.zeros(R)
    if dispatch is not None and done is not None:
        disp = np.asarray(dispatch, dtype=np.float64)
        dn = np.asarray(done, dtype=np.float64)
        prev_done = np.concatenate(([0.0], dn[:-1]))
        gap = np.maximum(disp - prev_done, 0.0)

    # the ledger closes exactly: compute (overlap-adjusted fastest
    # arrival) + gap + wait == timeset per round, each bucket >= 0
    compute = np.clip(np.where(has_any, first, 0.0) - hidden, 0.0, t)
    gap = np.minimum(gap, t - compute)
    wait = t - compute - gap

    wall = max(float(wall_s), 0.0)
    stall = min(max(float(prefetch_stall_s), 0.0), wall)
    return CriticalPath(
        wall_s=wall,
        sim_total_s=float(t.sum()),
        components={
            "decode_update_s": wall - stall,
            "prefetch_stall_s": stall,
        },
        sim_components={
            "compute_s": float(compute.sum()),
            "straggler_wait_s": float(wait.sum()),
            "dispatch_gap_s": float(gap.sum()),
        },
        overlap_hidden_s=float(hidden.sum()),
        transport=transport,
        per_round={
            "compute_s": compute,
            "straggler_wait_s": wait,
            "dispatch_gap_s": gap,
        },
    )


def attribute_result(res, *, prefetch_stall_s: Optional[float] = None):
    """Attribution straight from a TrainResult (synchronous runs; the
    pipelined trainer passes its schedule's dispatch/done clocks to
    :func:`attribute` directly). The prefetch stall defaults to the
    streamed run's own ``cache_info["prefetch"]["blocked_s"]``."""
    if prefetch_stall_s is None:
        pf = (res.cache_info or {}).get("prefetch") or {}
        prefetch_stall_s = float(pf.get("blocked_s", 0.0))
    mode = (res.cache_info or {}).get("stack_mode")
    return attribute(
        res.timeset,
        res.worker_times,
        res.collected,
        wall_s=float(res.wall_time),
        prefetch_stall_s=prefetch_stall_s,
        transport="ring" if mode == "ring" else "none",
    )


def emit_event(run_id: str, cp: CriticalPath) -> bool:
    """Emit the run's typed ``critical_path`` record into the current
    capture (host-side, after the timed region — observation-only)."""
    return events.emit("critical_path", run_id=run_id, **cp.payload())


def from_events(records) -> dict:
    """run_id -> critical_path payload, from parsed event record dicts
    (the report/top side: renders whatever the run attributed)."""
    out = {}
    for rec in records:
        if rec.get("type") == "critical_path":
            out[rec.get("run_id")] = rec
    return out


def render_lines(payload: dict) -> list:
    """Human lines for one run's attribution (report section body)."""
    lines = []
    wall = float(payload.get("wall_s", 0.0))
    sim = float(payload.get("sim_total_s", 0.0))
    fr = payload.get("fractions", {})

    def pct(key):
        return f"{100.0 * float(fr.get(key, 0.0)):5.1f}%"

    sim_c = payload.get("sim_components", {})
    host_c = payload.get("components", {})
    lines.append(
        f"  simulated clock {sim:.3f}s: "
        f"compute {sim_c.get('compute_s', 0.0):.3f}s ({pct('compute')}) | "
        f"straggler-wait {sim_c.get('straggler_wait_s', 0.0):.3f}s "
        f"({pct('straggler_wait')}) | dispatch-gap "
        f"{sim_c.get('dispatch_gap_s', 0.0):.3f}s ({pct('dispatch_gap')})"
    )
    hidden = float(payload.get("overlap_hidden_s", 0.0))
    if hidden > 0:
        lines.append(
            f"  pipelined overlap hid {hidden:.3f}s of arrival time"
        )
    transport = payload.get("transport", "none")
    decode_label = (
        "decode+update (incl. ring transport)"
        if transport == "ring"
        else "decode+update"
    )
    lines.append(
        f"  host wall {wall:.3f}s: {decode_label} "
        f"{host_c.get('decode_update_s', 0.0):.3f}s ({pct('decode_update')})"
        f" | prefetch-stall {host_c.get('prefetch_stall_s', 0.0):.3f}s "
        f"({pct('prefetch_stall')})"
    )
    return lines
