"""Closed-loop load generator for the serve daemon's HTTP front.

The port of erasurehead_tpu/serve/loadgen.py. The measurement harness
behind chip_smoke.py's ``serve`` phase and the backpressure/fairness tests:
many concurrent
:class:`~erasurehead_tpu_torch.serve.client.HttpServeClient` tenants
drive a daemon closed-loop (each client keeps a fixed number of requests
in flight, submitting the next as each row lands — offered load tracks
service rate instead of queueing unboundedly), and every accounting
question the robustness contracts ask is answered from the client's own
ledger:

  - **latency** — per-request time-to-first-row (submit accept -> the
    request's first streamed line) and per-tenant time-to-last-row (burst
    start -> final row), reported as p50/p99;
  - **no loss, no dups** — every accepted request_id must produce exactly
    one result line (``lost``/``duplicates`` counters; both must be 0
    even under 2x-capacity offered load — 429'd submissions retry on the
    deterministic capped-exponential schedule and are NOT accepted until
    the daemon says so);
  - **fairness** — :func:`fairness_run` pits one flooding tenant against
    closed-loop victims and compares each victim's goodput to its solo
    baseline (the acceptance bar: >= 0.5x with weighted-fair packing on);
  - **warm restart** — :func:`restart_run` bounces the daemon under a
    cleared in-process cache (the cold-process proxy; the subprocess
    kill variant is chip_smoke.py's kill drill), resubmits everything, and
    pins bitwise rehydration plus no new file in the kernel library's
    build directory (the daemon's ``cache_dir``).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional, Sequence

from erasurehead_tpu_torch.serve.client import (
    HttpServeClient,
    ServeRejectedError,
)


def percentile(values: Sequence[float], p: float) -> Optional[float]:
    """Nearest-rank percentile (p in [0, 100]); None on empty input."""
    if not values:
        return None
    xs = sorted(values)
    k = max(0, min(len(xs) - 1, int(round((p / 100.0) * (len(xs) - 1)))))
    return float(xs[k])


def run_tenant(
    host: str,
    port: int,
    tenant: str,
    jobs: Sequence[tuple],
    token: Optional[str] = None,
    concurrency: int = 4,
    max_retries: int = 8,
    priority: int = 0,
    timeout: float = 600.0,
) -> dict:
    """Drive one tenant's job list closed-loop; returns its ledger.

    ``jobs`` is a sequence of ``(label, config_dict)``; ``concurrency``
    requests stay in flight (the next submits as each result lands).
    Submissions ride the client's capped-exponential retry schedule; a
    job still rejected after ``max_retries`` is counted in
    ``rejected_final`` (never silently dropped)."""
    client = HttpServeClient(host, port, tenant, token=token)
    submit_t: dict[str, float] = {}
    results: dict[str, dict] = {}
    latencies: list[float] = []
    duplicates = 0
    rejected_final = 0
    it = iter(jobs)
    n_jobs = len(jobs)
    outstanding = 0
    t0 = time.monotonic()
    last_row_t: Optional[float] = None
    first_row_t: Optional[float] = None

    def submit_next() -> bool:
        nonlocal outstanding, rejected_final
        while True:
            try:
                label, cfg = next(it)
            except StopIteration:
                return False
            try:
                rid = client.submit(
                    label, cfg, max_retries=max_retries, priority=priority
                )
            except ServeRejectedError:
                rejected_final += 1
                continue  # try the next job; this one is lost to caller
            submit_t[rid] = time.monotonic()
            outstanding += 1
            return True

    for _ in range(max(1, int(concurrency))):
        if not submit_next():
            break
    deadline = time.monotonic() + timeout
    while outstanding and time.monotonic() < deadline:
        try:
            res = client.result(timeout=5.0)
        except Exception:  # noqa: BLE001 — Empty: keep waiting till deadline
            continue
        now = time.monotonic()
        rid = res["request_id"]
        if rid in results:
            duplicates += 1
            continue
        results[rid] = res
        outstanding -= 1
        if rid in submit_t:
            latencies.append(now - submit_t[rid])
        if first_row_t is None:
            first_row_t = now
        last_row_t = now
        submit_next()
    elapsed = (last_row_t or time.monotonic()) - t0
    lost = len(submit_t) - len(results)
    ledger = {
        "tenant": tenant,
        "jobs": n_jobs,
        "accepted": len(submit_t),
        "rows": len(results),
        "lost": lost,
        "duplicates": duplicates,
        "rejected_429s": client.rejected_total,
        "retries": client.retried_total,
        "rejected_final": rejected_final,
        "stream_overflow_dropped": client.overflow_dropped,
        "errors": sum(
            1 for r in results.values() if r.get("status") == "error"
        ),
        "ttfr_s": (
            round(first_row_t - t0, 6) if first_row_t is not None else None
        ),
        "ttlr_s": round(elapsed, 6),
        "latencies_s": [round(x, 6) for x in latencies],
        "goodput_rows_per_s": (
            round(len(results) / elapsed, 4) if elapsed > 0 else None
        ),
        # full result payloads keyed by label (labels are unique per
        # tenant in this harness): what the restart phase compares
        # bitwise across the bounce
        "rows_by_label": {
            r["label"]: {
                "status": r.get("status"),
                "row": r.get("row"),
                "resumed": bool(r.get("resumed")),
            }
            for r in results.values()
        },
    }
    client.close()
    return ledger


def run_fleet(
    host: str,
    port: int,
    tenant_jobs: dict,
    tokens: Optional[dict] = None,
    concurrency: int = 4,
    max_retries: int = 8,
    priorities: Optional[dict] = None,
    timeout: float = 600.0,
) -> dict:
    """Drive several tenants concurrently (one thread each); returns
    {"tenants": {tenant: ledger}, "latency_p50_s", "latency_p99_s",
    "ttlr_p99_s", "lost", "duplicates"} aggregated across the fleet.
    ``tenant_jobs`` maps tenant -> job list; ``tokens`` maps tenant ->
    bearer token (None = auth off); ``concurrency`` is an int for the
    whole fleet or a dict tenant -> in-flight depth (how a flooding
    tenant floods)."""
    ledgers: dict[str, dict] = {}
    threads = []

    def drive(tenant, jobs):
        depth = (
            concurrency.get(tenant, 4)
            if isinstance(concurrency, dict)
            else concurrency
        )
        try:
            ledgers[tenant] = run_tenant(
                host, port, tenant, jobs,
                token=(tokens or {}).get(tenant),
                concurrency=depth,
                max_retries=max_retries,
                priority=(priorities or {}).get(tenant, 0),
                timeout=timeout,
            )
        except Exception as e:  # noqa: BLE001 — a dead client thread
            # must surface in the ledger, never silently vanish from
            # the fleet aggregates (its jobs would read as "not lost")
            ledgers[tenant] = {
                "tenant": tenant, "jobs": len(jobs), "accepted": 0,
                "rows": 0, "lost": len(jobs), "duplicates": 0,
                "rejected_429s": 0, "retries": 0, "rejected_final": 0,
                "stream_overflow_dropped": 0, "errors": 0,
                "ttfr_s": None, "ttlr_s": None, "latencies_s": [],
                "goodput_rows_per_s": None, "rows_by_label": {},
                "client_error": f"{type(e).__name__}: {e}",
            }

    for tenant, jobs in tenant_jobs.items():
        t = threading.Thread(
            target=drive, args=(tenant, jobs),
            name=f"eh-loadgen-{tenant}", daemon=True,
        )
        threads.append(t)
        t.start()
    for t in threads:
        t.join(timeout=timeout + 30)
    all_lat = [
        x for led in ledgers.values() for x in led["latencies_s"]
    ]
    return {
        "tenants": ledgers,
        "latency_p50_s": percentile(all_lat, 50),
        "latency_p99_s": percentile(all_lat, 99),
        "ttlr_p99_s": percentile(
            [
                led["ttlr_s"] for led in ledgers.values()
                if led["ttlr_s"] is not None
            ],
            99,
        ),
        "lost": sum(led["lost"] for led in ledgers.values()),
        "duplicates": sum(led["duplicates"] for led in ledgers.values()),
        "rejected_429s": sum(
            led["rejected_429s"] for led in ledgers.values()
        ),
        "retries": sum(led["retries"] for led in ledgers.values()),
    }


def fairness_run(
    make_front: Callable[[], tuple],
    victim_jobs: dict,
    flood_jobs: Sequence[tuple],
    flood_tenant: str = "flood",
    concurrency: int = 2,
    flood_concurrency: int = 16,
    timeout: float = 600.0,
) -> dict:
    """Goodput fairness under one flooding tenant.

    ``make_front()`` builds a fresh (server, front) pair and returns
    ``(server, front, host, port, close_fn)`` — a fresh daemon per phase
    so the solo baseline and the contended run see identical cold/warm
    state. Phase 1 runs each victim alone (solo goodput); phase 2 runs
    all victims plus the flooder. The acceptance bar: every victim's
    contended goodput >= 0.5x its solo goodput (vs. starvation under
    FIFO packing)."""
    solo: dict[str, dict] = {}
    for tenant, jobs in victim_jobs.items():
        _srv, _front, host, port, close_fn = make_front()
        try:
            solo[tenant] = run_tenant(
                host, port, tenant, jobs,
                concurrency=concurrency, timeout=timeout,
            )
        finally:
            close_fn()
    _srv, _front, host, port, close_fn = make_front()
    try:
        contended = run_fleet(
            host, port,
            {**victim_jobs, flood_tenant: list(flood_jobs)},
            concurrency={
                **dict.fromkeys(victim_jobs, concurrency),
                flood_tenant: flood_concurrency,
            },
            timeout=timeout,
        )
    finally:
        close_fn()
    ratios = {}
    for tenant, led in contended["tenants"].items():
        if tenant == flood_tenant:
            continue
        s = solo[tenant]["goodput_rows_per_s"]
        c = led["goodput_rows_per_s"]
        ratios[tenant] = (
            round(c / s, 4) if (s and c is not None and s > 0) else None
        )
    valid = [r for r in ratios.values() if r is not None]
    return {
        "solo": solo,
        "contended": contended,
        "goodput_ratio": ratios,
        "min_goodput_ratio": min(valid) if valid else None,
        "flood_rows": contended["tenants"][flood_tenant]["rows"],
    }


def restart_run(
    make_front: Callable[[], tuple],
    tenant_jobs: dict,
    cache_dir: str,
    concurrency: int = 4,
    timeout: float = 600.0,
) -> dict:
    """Warm-restart phase: serve the load, bounce the daemon with its
    in-process caches CLEARED (the cold-process proxy — the subprocess
    kill variant is chip_smoke.py's kill drill), resubmit everything,
    and pin the crash-safety contract:

      - every resubmitted request rehydrates (``resumed=True``) with a
        row byte-identical to the first run's;
      - the kernel library's build directory (``cache_dir``) gained no
        file across the restart (the working set re-served with no new
        build; on the CPU nothing is built at all).

    ``make_front()`` must build its server with ``journal_dir`` and
    ``cache_dir`` pointed at the same directories both times."""
    from erasurehead_tpu_torch.train import cache as cache_lib

    def build_files() -> set:
        return set(os.listdir(cache_dir)) if os.path.isdir(cache_dir) else set()

    _srv, _front, host, port, close_fn = make_front()
    try:
        before = run_fleet(
            host, port, tenant_jobs,
            concurrency=concurrency, timeout=timeout,
        )
    finally:
        close_fn()
    files_before = build_files()
    cache_lib.clear()  # drop in-process exec/data caches: cold process
    t0 = time.monotonic()
    _srv, _front, host, port, close_fn = make_front()
    try:
        after = run_fleet(
            host, port, tenant_jobs,
            concurrency=concurrency, timeout=timeout,
        )
    finally:
        close_fn()
    restart_wall = time.monotonic() - t0
    files_after = build_files()
    import json

    resumed = 0
    bitwise_mismatches = 0
    for tenant, led in after["tenants"].items():
        first_rows = before["tenants"][tenant]["rows_by_label"]
        for label, got in led["rows_by_label"].items():
            if got["resumed"]:
                resumed += 1
            want = first_rows.get(label)
            if want is None or json.dumps(
                got["row"], sort_keys=True
            ) != json.dumps(want["row"], sort_keys=True):
                bitwise_mismatches += 1
    return {
        "first_pass": before,
        "resubmit_pass": after,
        "rows_first": sum(
            led["rows"] for led in before["tenants"].values()
        ),
        "rows_resubmitted": sum(
            led["rows"] for led in after["tenants"].values()
        ),
        "resumed": resumed,
        "bitwise_mismatches": bitwise_mismatches,
        "restart_wall_s": round(restart_wall, 4),
        "new_build_files": len(files_after - files_before),
    }
