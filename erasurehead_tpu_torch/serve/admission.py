"""Admission controller: bound the serve daemon's in-flight device memory.

The port of erasurehead_tpu/serve/admission.py. A cohort dispatch pins
device memory three ways: the shared data stack it uploads (or reuses from
the sweep data cache), the per-round weight tables that scale with cohort
width, and its working set (the margins, the per-slot gradients, the
iterate history). The controller charges each candidate cohort an ESTIMATE
of that footprint against a byte budget before it may dispatch:

  - the estimate is the host-side stack arithmetic
    (trainer.estimate_stack_bytes) plus the weight-table bytes the cohort's
    width implies and a per-trajectory slack;
  - once a signature has dispatched on the card, its MEASURED footprint
    refines the estimate: later admissions of the same signature charge
    the measured bytes when they are larger. The JAX package measures a
    compiled executable's ``memory_analysis``; the port has no executable,
    so the measurement is the dispatch's peak of allocated device bytes
    above its start (``torch.cuda.max_memory_allocated``). The peak counter
    is one per device and the daemon dispatches from two threads, so the
    server records it only for a dispatch that ran with no other in flight
    from its start to its end (server.SweepServer._run_cohort); a
    concurrent dispatch's reading would be inflated by, or reset under, its
    neighbour's. On the CPU nothing is measured and the estimate stands;
  - the data cache's device pins (cache.data_cache_bytes) count against the
    budget alongside in-flight charges: they are real device memory;
  - an over-footprint cohort QUEUES: it stays pending and is retried after
    in-flight dispatches release their charge. It never joins a running
    cohort's memory;
  - when dropping the data cache's pins would change the verdict, the
    controller EVICTS the cache (cache.drop_data_cache, the same pressure
    valve the out-of-memory bisection uses) and re-runs the FULL decision,
    so eviction can admit in the same call and an idle daemon never
    strands a pending cohort;
  - a cohort too big for the budget even on an idle daemon admits alone
    with a warning (refusing forever would deadlock the tenant).

Every decision is observable: ``admit`` records carry the estimate against
the budget and the verdict, ``evict`` records name what was dropped, and the
``serve.admitted`` / ``serve.deferred`` / ``serve.evictions`` counters
aggregate them.

:class:`EtaQuoter` is the admission-time read side of the what-if engine
(whatif/): a loaded surface quotes each arriving request's simulated
expected time-to-target.
"""

from __future__ import annotations

import threading
from typing import Optional

from erasurehead_tpu_torch.obs import events as events_lib
from erasurehead_tpu_torch.obs.metrics import REGISTRY as _METRICS
from erasurehead_tpu_torch.obs.metrics import warn_once
from erasurehead_tpu_torch.train import cache as cache_lib
from erasurehead_tpu_torch.train import trainer
from erasurehead_tpu_torch.utils.config import ComputeMode

#: per-trajectory fixed overhead charged on top of the weight tables:
#: params history [R, F], optimizer state, host/device staging slack
TRAJECTORY_SLACK_BYTES = 1 << 20


def estimate_cohort_bytes(cohort, width: Optional[int] = None) -> int:
    """Estimated device footprint of one packed cohort: ONE shared data
    stack (the pack key guarantees the cohort shares it) + width-scaled
    per-round weight tables + per-trajectory slack. ``width`` overrides the
    trajectory count (the server's fixed-width padded dispatch really
    allocates ``max_cohort`` table columns). Streamed payloads are charged
    their resident windows (trainer.estimate_stack_bytes)."""
    first = cohort.requests[0]
    cfg = first.config
    stack = trainer.estimate_stack_bytes(cfg, first.dataset)
    layout = trainer.build_layout(cfg)
    B = width if width is not None else len(cohort.requests)
    if cfg.compute_mode == ComputeMode.FAITHFUL:
        table_cols = layout.n_workers * layout.n_slots
    else:
        table_cols = layout.n_partitions
    tables = cfg.rounds * B * table_cols * 4  # float32 weight tables [R, B, ...]
    return int(stack + tables + B * TRAJECTORY_SLACK_BYTES)


class AdmissionController:
    """Byte-budgeted admission over concurrent cohort dispatches.

    ``budget_bytes=None`` = unbounded (every cohort admits; records still
    carry the estimates, so a budget can be sized from a dry run)."""

    def __init__(self, budget_bytes: Optional[int] = None):
        if budget_bytes is not None and budget_bytes <= 0:
            raise ValueError(
                f"budget_bytes must be positive (or None for unbounded), "
                f"got {budget_bytes}"
            )
        self.budget_bytes = budget_bytes
        self._lock = threading.Lock()
        self._in_flight: dict[str, int] = {}  # dispatch id -> charged bytes
        self._measured: dict[str, int] = {}  # key digest -> measured bytes
        self._deferred_total = 0  # lifetime defer verdicts (pressure())

    def pressure(self) -> dict:
        """Admission pressure snapshot (what /healthz exposes): charged
        in-flight bytes against the budget, live dispatch count, and how
        often this controller has deferred."""
        with self._lock:
            in_flight = sum(self._in_flight.values())
            dispatches = len(self._in_flight)
            deferred = self._deferred_total
        return {
            "budget_bytes": self.budget_bytes,
            "in_flight_bytes": in_flight,
            "in_flight_dispatches": dispatches,
            "deferred_total": deferred,
        }

    @property
    def in_flight_bytes(self) -> int:
        with self._lock:
            return sum(self._in_flight.values())

    def measured_bytes(self, key_digest: str) -> Optional[int]:
        """The largest measured footprint of a signature, or None."""
        with self._lock:
            return self._measured.get(key_digest)

    def charge_for(self, cohort, width: Optional[int] = None) -> int:
        """The bytes this cohort would be charged: the estimate, raised to
        the signature's measured footprint when known and larger."""
        est = estimate_cohort_bytes(cohort, width=width)
        measured = self.measured_bytes(cohort.key_digest)
        if measured is not None:
            est = max(est, measured)
        return est

    def _decide_locked(self, est: int) -> str:
        """The verdict for ``est`` charged bytes (caller holds the lock):
        ``"admit"``, ``"evict"`` (dropping the data cache's pins would
        change the verdict: re-decide after) or ``"defer"``."""
        budget = self.budget_bytes
        if budget is None:
            return "admit"
        in_flight = sum(self._in_flight.values())
        cached = cache_lib.data_cache_bytes()
        if in_flight + cached + est <= budget:
            return "admit"
        if cached > 0 and (in_flight + est <= budget or in_flight == 0):
            # the cache's pins are idle: dropping them frees real memory
            # without touching a live dispatch. Evict when that closes the
            # gap, or when the daemon is idle (admit-alone wants every byte)
            return "evict"
        if in_flight == 0:
            # nothing to wait for and nothing to evict: admitting alone is
            # the only move that cannot deadlock
            return "admit"
        return "defer"

    def try_admit(self, cohort, dispatch_id: str, width: Optional[int] = None) -> bool:
        """Admit ``cohort`` (charging its footprint until :meth:`release`),
        or defer it. Emits one ``admit`` record either way; evicts the data
        cache's pins here when they are what stands between the cohort and
        the budget."""
        est = self.charge_for(cohort, width=width)
        with self._lock:
            verdict = self._decide_locked(est)
            if verdict == "admit":
                self._in_flight[dispatch_id] = est
        if verdict == "evict":
            released = cache_lib.drop_data_cache()
            _METRICS.counter("serve.evictions").inc()
            events_lib.emit(
                "evict",
                reason="data_cache_pressure",
                cohort=cohort.key_digest,
                released_bytes=released,
            )
            with self._lock:
                # the full decision again with the pins gone, INCLUDING the
                # idle admit-alone fallback
                verdict = self._decide_locked(est)
                if verdict == "evict":
                    # a concurrent dispatch refilled the cache between the
                    # drop and this lock: defer rather than thrash
                    verdict = "defer"
                if verdict == "admit":
                    self._in_flight[dispatch_id] = est
        admitted = verdict == "admit"
        if admitted and self.budget_bytes is not None and est > self.budget_bytes:
            warn_once(
                f"serve_overbudget_{cohort.key_digest}",
                f"serve: cohort {cohort.key_digest} estimate {est}B exceeds "
                f"the whole budget {self.budget_bytes}B; admitted ALONE "
                f"(refusing forever would deadlock the tenant)",
            )
        if not admitted:
            with self._lock:
                self._deferred_total += 1
        _METRICS.counter("serve.admitted" if admitted else "serve.deferred").inc()
        events_lib.emit(
            "admit",
            est_bytes=est,
            budget_bytes=self.budget_bytes,
            in_flight_bytes=self.in_flight_bytes,
            admitted=admitted,
            cohort=cohort.key_digest,
            n_trajectories=len(cohort.requests),
        )
        return admitted

    def release(self, dispatch_id: str) -> None:
        """Return a finished (or failed) dispatch's charge to the budget."""
        with self._lock:
            self._in_flight.pop(dispatch_id, None)

    def observe(self, cohort, cache_info: Optional[dict]) -> None:
        """Refine the signature's footprint with a dispatch's measured
        ``device_peak_bytes`` (peak allocated device bytes above the
        dispatch's start, recorded by the server for a dispatch that ran
        alone). The charge only RATCHETS UP: a measured undercount must not
        talk admission into optimism."""
        measured = int((cache_info or {}).get("device_peak_bytes") or 0)
        if measured <= 0:
            return
        with self._lock:
            prev = self._measured.get(cohort.key_digest, 0)
            if measured > prev:
                self._measured[cohort.key_digest] = measured


class EtaQuoter:
    """Admission-time ETA quotes from a what-if surface (whatif/surface.py):
    given an arriving request's RunConfig, the nearest feasible row's
    expected simulated seconds-to-target, or None when the surface cannot
    speak for the policy (the daemon serves the request either way). The
    quote rides the ``request`` record and the fronts' accepted reply
    (``eta_s``)."""

    def __init__(self, surface):
        if surface is None:
            raise ValueError(
                "EtaQuoter needs a whatif Surface (cli whatif --out DIR; "
                "Surface.load(DIR))"
            )
        self.surface = surface

    def quote(self, cfg) -> Optional[float]:
        """Expected time-to-target (simulated seconds) for a request's
        policy coordinate, or None."""
        return self.surface.eta(cfg)
