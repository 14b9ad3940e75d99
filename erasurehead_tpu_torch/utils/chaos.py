"""Chaos injection: deterministic faults and straggler regimes armed by env vars.

The port of erasurehead_tpu/utils/chaos.py.

Faults (``ERASUREHEAD_CHAOS=spec[,spec...]``, each spec
``mode:site:count[:message]``): the resilience machinery (the sweep journal
and its resume, the checkpoint fallback) exists to survive failures that are
awkward to produce on demand; a spec makes one reproducible. ``mode`` is
``kill`` (the process dies through ``os._exit`` with :data:`KILL_EXIT`: no
cleanup, nothing flushed beyond what already reached disk), ``raise`` (a
:class:`ChaosInjection` whose message carries ``message``, default
``RESOURCE_EXHAUSTED``) or ``stall`` (the invocation sleeps ``message``
seconds, default 30). ``count`` fires on the Nth invocation of the site
(``2``) or on the Nth and every later one (``2+``). The wired sites
(:data:`WIRED_SITES`) are ``trajectory`` (after a sweep trajectory's row is
finished and journaled, experiments.compare), ``cohort`` (at the head of a
trajectory-batched cohort dispatch, trainer.train_cohort: a ``raise`` whose
message names an out-of-memory marker makes compare() bisect the cohort),
``checkpoint`` (at the head of checkpoint.save, so the save never commits),
``adapt`` / ``elastic`` (the chunk boundaries of the adaptive and elastic
drivers, adapt/driver.py and elastic/driver.py) and ``prefetch`` (on the
staging thread of data/prefetch.Prefetcher, before each window is read: a
raise surfaces at the trainer's next ``get``) and ``tune_race`` (at the head
of a tune race, tune/racer.race, before any timing: a kill leaves the
decision cache as it was), and the serve daemon's ``serve_intake`` (in
SweepServer.submit, after the acceptance is in the intake WAL and before
it is queued), ``serve_dispatch`` (at the head of a cohort dispatch, on a
dispatch thread) and ``serve_reply`` (after a row is journaled, before its
reply is delivered) and ``fleet_replica`` (the fleet's site, at the head
of a replica's cohort dispatch, before ``serve_dispatch``: serve/fleet.py
arms it on one replica, whose WAL a peer then adopts). Every site of the
JAX package is wired (:data:`UNWIRED_SITES` is empty): a spec that parses
is never silently ignored.

Membership sites (:data:`MEMBERSHIP_SITES`, read by the elastic membership
driver, elastic/driver.py) take a worker id in the mode field,
``worker:site:count``: ``3:worker_death:2`` kills live worker 3 at the
driver's 2nd chunk boundary and ``3:worker_revive:5`` offers it back at the
5th, so one env var drives a die-then-rejoin cycle::

    ERASUREHEAD_CHAOS=3:worker_death:2,3:worker_revive:5

They never fire through :func:`maybe_fire`: the driver asks
:func:`membership_fires` by its absolute chunk-boundary number.

Straggler regimes (``ERASUREHEAD_REGIME``, below): a deterministic mid-run
regime change (parallel/straggler.RegimeShift), read by
train/trainer.default_arrivals. Not a fault (nothing crashes), but it makes
non-stationary straggling reproducible.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Optional

#: env var arming the fault
CHAOS_ENV = "ERASUREHEAD_CHAOS"

#: exit code of a chaos kill: distinctive, so a harness can tell an injected
#: preemption from a genuine crash
KILL_EXIT = 43

#: every instrumented site of the JAX package
SITES = (
    "trajectory", "cohort", "checkpoint", "adapt", "elastic",
    "worker_death", "worker_revive",
    "serve_intake", "serve_dispatch", "serve_reply",
    "fleet_replica",
    "prefetch",
    "tune_race",
)

#: the sites the port instruments
WIRED_SITES = (
    "trajectory", "cohort", "checkpoint", "adapt", "elastic",
    "worker_death", "worker_revive",
    "serve_intake", "serve_dispatch", "serve_reply",
    "fleet_replica",
    "prefetch", "tune_race",
)

#: sites whose fault is a MEMBERSHIP change (a worker dying or offering to
#: join) rather than a process fault; their specs carry a worker id in the
#: mode field and fire through :func:`membership_fires`, never
#: :func:`maybe_fire`
MEMBERSHIP_SITES = ("worker_death", "worker_revive")

#: an unwired site -> the ROADMAP queue A item whose module brings it
#: (empty: every site is wired)
UNWIRED_SITES: dict = {}


class ChaosInjection(RuntimeError):
    """An injected fault (mode ``raise``); the message carries the
    configured status marker."""


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    mode: str  # "kill" | "raise" | "stall" | "member" (membership sites)
    site: str
    count: int  # 1-based invocation number that fires
    sticky: bool  # True = fire on count and every later invocation
    message: str
    worker: Optional[int] = None  # membership sites: which worker


def parse_spec(spec: str) -> ChaosSpec:
    """Parse one ``mode:site:count[:message]`` spec (worker-id mode for
    membership sites); loud on malformed specs and on sites the port does
    not instrument (a chaos run silently doing nothing would invalidate
    the drill)."""
    parts = spec.split(":", 3)
    if len(parts) < 3:
        raise ValueError(f"{CHAOS_ENV}={spec!r}: want mode:site:count[:message]")
    mode, site, count = parts[0], parts[1], parts[2]
    message = parts[3] if len(parts) > 3 else "RESOURCE_EXHAUSTED"
    if site not in SITES:
        raise ValueError(f"{CHAOS_ENV}={spec!r}: site must be one of {SITES}")
    if site in UNWIRED_SITES:
        raise ValueError(
            f"{CHAOS_ENV}={spec!r}: site {site!r} is not instrumented in "
            f"erasurehead_tpu_torch yet (ROADMAP queue A, "
            f"{UNWIRED_SITES[site]}); wired sites: {WIRED_SITES}"
        )
    worker = None
    if site in MEMBERSHIP_SITES:
        # membership grammar: the first field is the worker id the event
        # concerns (3:worker_death:2 = worker 3 dies at invocation 2)
        try:
            worker = int(mode)
        except ValueError:
            raise ValueError(
                f"{CHAOS_ENV}={spec!r}: membership sites take a worker id "
                f"first (e.g. 3:{site}:2), got {mode!r}"
            ) from None
        if worker < 0:
            raise ValueError(f"{CHAOS_ENV}={spec!r}: worker id must be >= 0")
        mode = "member"
    elif mode not in ("kill", "raise", "stall"):
        raise ValueError(f"{CHAOS_ENV}={spec!r}: mode must be kill|raise|stall")
    if mode == "stall":
        # the message field carries the stall duration in seconds
        if len(parts) <= 3:
            message = "30"
        try:
            if float(message) < 0:
                raise ValueError
        except ValueError:
            raise ValueError(
                f"{CHAOS_ENV}={spec!r}: stall takes a non-negative "
                f"seconds value in the message field, got {message!r}"
            ) from None
    sticky = count.endswith("+")
    try:
        n = int(count[:-1] if sticky else count)
    except ValueError:
        raise ValueError(f"{CHAOS_ENV}={spec!r}: count must be an int or 'N+'") from None
    if n < 1:
        raise ValueError(f"{CHAOS_ENV}={spec!r}: count must be >= 1")
    return ChaosSpec(mode=mode, site=site, count=n, sticky=sticky, message=message,
                     worker=worker)


def parse_specs(value: str) -> list:
    """Parse the full env value: a comma-separated spec list."""
    return [parse_spec(part) for part in value.split(",") if part]


_counts: dict = {}
#: the serve daemon's dispatch threads count the same site concurrently
_counts_lock = threading.Lock()


def _count(site: str) -> int:
    """Count one invocation of ``site``; returns its 1-based number."""
    with _counts_lock:
        _counts[site] = _counts.get(site, 0) + 1
        return _counts[site]


def reset() -> None:
    """Zero the per-site invocation counters (tests)."""
    with _counts_lock:
        _counts.clear()


def active() -> Optional[ChaosSpec]:
    """The first armed spec, or None when chaos is off."""
    specs = active_specs()
    return specs[0] if specs else None


def active_specs() -> list:
    """All armed specs ([] when chaos is off)."""
    value = os.environ.get(CHAOS_ENV)
    return parse_specs(value) if value else []


def _fires(spec: ChaosSpec, n: int) -> bool:
    return n == spec.count or (spec.sticky and n > spec.count)


def maybe_fire(site: str) -> None:
    """Count one invocation of ``site``; fire the armed fault if its
    trigger condition is met. No-op (beyond one env lookup) when unarmed.
    Membership sites never fire here (:func:`membership_fires`)."""
    if CHAOS_ENV not in os.environ:
        return
    specs = [s for s in active_specs() if s.site == site]
    if not specs or site in MEMBERSHIP_SITES:
        return
    n = _count(site)
    for spec in specs:
        if not _fires(spec, n):
            continue
        if spec.mode == "kill":
            # preemption: no cleanup, no atexit; only what already reached
            # disk (the journal writes a whole line at a time) survives
            os._exit(KILL_EXIT)
        if spec.mode == "stall":
            time.sleep(float(spec.message))
            continue
        raise ChaosInjection(
            f"{spec.message}: chaos injection at site {site!r} "
            f"(invocation {n}, spec {spec.mode}:{spec.site}:"
            f"{spec.count}{'+' if spec.sticky else ''})"
        )


def membership_fires(site: str, invocation: int) -> tuple:
    """PURE query: the worker ids of armed MEMBERSHIP specs firing at the
    1-based ``invocation`` of ``site``. No counter is touched: the elastic
    driver indexes invocations by its own absolute chunk-boundary number,
    so a killed-and-resumed run replays the same membership chaos without
    firing already-applied events again (a process-global counter would
    restart at zero and shift every firing)."""
    if site not in MEMBERSHIP_SITES:
        raise ValueError(
            f"membership_fires: {site!r} is not one of {MEMBERSHIP_SITES}"
        )
    if invocation < 1:
        raise ValueError(f"invocation must be >= 1, got {invocation}")
    if CHAOS_ENV not in os.environ:
        return ()
    return tuple(
        s.worker for s in active_specs() if s.site == site and _fires(s, invocation)
    )


def fire_membership(site: str) -> tuple:
    """Counter-based form of :func:`membership_fires`: count one invocation
    of ``site`` and return the worker ids firing at it. Never kills or
    raises; returns () when unarmed."""
    if site not in MEMBERSHIP_SITES:
        raise ValueError(
            f"fire_membership: {site!r} is not one of {MEMBERSHIP_SITES}"
        )
    if CHAOS_ENV not in os.environ:
        return ()
    if not any(s.site == site for s in active_specs()):
        return ()
    return membership_fires(site, _count(site))


# ---------------------------------------------------------------------------
# straggler-regime injection

#: env var arming a straggler-regime shift
#: (``kind:round[:param[:param2]]``): ``heavytail:50[:alpha]`` switches
#: the delay stream from exponential to Pareto(alpha)-tailed at round 50;
#: ``adversary:50[:worker[:slowdown]]`` turns one worker adversarially
#: slow from round 50 (arXiv:1901.08166's fixed-straggler worst case);
#: ``targeted:50[:group[:slowdown]]`` slows EVERY replica of one coded
#: partition group at once, the fractional-repetition worst case of the
#: same paper (the attacked workers come from the run's layout in
#: trainer.default_arrivals; see straggler.targeted_workers). Unset, arrival
#: schedules are the stationary stream.
REGIME_ENV = "ERASUREHEAD_REGIME"


def parse_regime(spec: str):
    """Parse :data:`REGIME_ENV`; loud on malformed specs (a typo'd regime
    run silently staying stationary would invalidate the experiment)."""
    from erasurehead_tpu_torch.parallel.straggler import RegimeShift

    parts = spec.split(":")
    if len(parts) < 2:
        raise ValueError(
            f"{REGIME_ENV}={spec!r}: want kind:round[:param[:param2]]"
        )
    kind = parts[0]
    try:
        rnd = int(parts[1])
    except ValueError:
        raise ValueError(
            f"{REGIME_ENV}={spec!r}: round must be an int"
        ) from None
    if kind == "heavytail":
        alpha = float(parts[2]) if len(parts) > 2 else 1.2
        return RegimeShift(kind=kind, round=rnd, alpha=alpha)
    if kind == "adversary":
        worker = int(parts[2]) if len(parts) > 2 else 0
        slowdown = float(parts[3]) if len(parts) > 3 else 5.0
        return RegimeShift(
            kind=kind, round=rnd, worker=worker, slowdown=slowdown
        )
    if kind == "targeted":
        group = int(parts[2]) if len(parts) > 2 else 0
        slowdown = float(parts[3]) if len(parts) > 3 else 5.0
        return RegimeShift(
            kind=kind, round=rnd, group=group, slowdown=slowdown
        )
    raise ValueError(
        f"{REGIME_ENV}={spec!r}: kind must be heavytail|adversary|targeted"
    )


def active_regime():
    """The armed RegimeShift, or None when the env var is unset."""
    spec = os.environ.get(REGIME_ENV)
    return parse_regime(spec) if spec else None
