"""Deterministic microbench racer: warm-up + min-over-repeats, tie->fallback.

The port of erasurehead_tpu/tune/racer.py. Every candidate thunk runs once
unmeasured (kernel build, first touch), then ``reps`` measured runs, and the
candidate's time is the MINIMUM, the least-noise estimator for a
deterministic program under scheduler jitter. A candidate only unseats the
hardcoded fallback by beating it by more than ``tie_margin`` (default 10%):
within the margin the verdict is a tie and the fallback stands, so timer
noise cannot flip a decision back and forth. (The other half of the
determinism contract is the cache: tune/cache.py stores choices only,
canonically ordered.)

On the card a thunk ends with ``torch.cuda.synchronize()`` itself (the
counterpart of JAX's ``block_until_ready``), so the host clock brackets the
device work; the racer does not synchronise. ``timer`` is injectable so
tests race with a fake clock and assert exact verdicts; production uses
``time.perf_counter``.

Races fire the ``tune_race`` chaos site before any timing: the kill drill
(``ERASUREHEAD_CHAOS=kill:tune_race:1``) proves a torn race leaves no
partial cache entry (atomic writes) and a rerun reproduces the verdict.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

from erasurehead_tpu_torch.utils import chaos

#: a challenger must beat the fallback by this fraction to win "auto"
TIE_MARGIN = 0.10

#: measured repeats per candidate (min is taken)
DEFAULT_REPS = 3


@dataclasses.dataclass(frozen=True)
class RaceResult:
    """One settled race: the verdict plus the evidence."""

    race: str
    shape: str
    device_kind: str
    choice: str
    fallback: str
    timings: Dict[str, float]
    decisive: bool


def time_thunk(
    thunk: Callable[[], None],
    *,
    reps: int = DEFAULT_REPS,
    timer: Optional[Callable[[], float]] = None,
) -> float:
    """Warm once (build/first-touch outside the clock), then min of
    ``reps`` timed runs."""
    timer = timer or time.perf_counter
    thunk()
    best = None
    for _ in range(max(1, reps)):
        t0 = timer()
        thunk()
        dt = timer() - t0
        best = dt if best is None else min(best, dt)
    return float(best)


def race(
    name: str,
    shape_sig: str,
    candidates: Dict[str, Callable[[], None]],
    *,
    fallback: str,
    device_kind: Optional[str] = None,
    reps: int = DEFAULT_REPS,
    tie_margin: float = TIE_MARGIN,
    timer: Optional[Callable[[], float]] = None,
    record: bool = True,
    cache=None,
) -> RaceResult:
    """Race ``candidates`` (name -> thunk) and settle the verdict.

    The winner is recorded into the decision cache (unless
    ``record=False``) and emitted as a ``tune`` record with
    ``source="race"``. Candidates time in sorted-name order, so the
    measurement schedule itself is deterministic. ``device_kind`` keys the
    verdict (tune.default_device_kind of the run's device; None = the
    default device's)."""
    from erasurehead_tpu_torch import tune as tune_lib

    if fallback not in candidates:
        raise ValueError(
            f"race {name!r}: fallback {fallback!r} not among candidates "
            f"{sorted(candidates)}"
        )
    chaos.maybe_fire("tune_race")
    dk = device_kind or tune_lib.default_device_kind()
    timings = {
        cname: time_thunk(candidates[cname], reps=reps, timer=timer)
        for cname in sorted(candidates)
    }
    best = min(sorted(timings), key=lambda k: timings[k])
    decisive = (
        best != fallback
        and timings[best] < timings[fallback] * (1.0 - tie_margin)
    )
    choice = best if decisive else fallback
    if record:
        (cache or tune_lib.get_cache()).record(dk, name, shape_sig, choice)
    tune_lib.emit_decision(name, dk, shape_sig, choice, "race")
    return RaceResult(
        race=name, shape=shape_sig, device_kind=dk, choice=choice,
        fallback=fallback, timings=timings, decisive=decisive,
    )
