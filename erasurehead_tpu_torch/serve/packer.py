"""Cohort packer: bin-pack compatible pending requests into shared dispatches.

The port of erasurehead_tpu/serve/packer.py. The cohort engine
(trainer.train_cohort) does not care WHOSE trajectories share a dispatch,
only that they share a device data stack and a gradient lowering. The
packing key is therefore the cohort grouping key of the sweep planner,
``trainer.cohort_signature`` (static lowering signature + rounds + workers
+ the stack's layout signature), plus the dataset's identity token:
requests from different tenants that agree on all of it ride ONE
dispatch.

What must not pack does not: the static signature carries the memory knobs
(``stack_dtype``, ``stack_residency``, ``stream_window``...), so an int8
request and a float32 request key different data caches and land in
different cohorts. Arrival schedules are not in the key: train_cohort takes
them per trajectory, so tenants keep their own straggler streams inside a
shared dispatch.

Packing changes throughput, never bits: under the daemon's fixed-width
dispatch a request's row is bitwise the same packed or alone
(tests/test_torch_serve.py). So the packer has a fairness/latency tradeoff
only: FIFO-by-signature let one chatty tenant fill every dispatch window;
the weighted-fair order (:func:`fair_windows`) interleaves tenants
round-robin per window (each tenant's own queue FIFO within a priority
class), and an optional per-tenant slot quota hard-caps one tenant's share
of a window.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import deque
from typing import Optional

from erasurehead_tpu_torch.serve.queue import RunRequest
from erasurehead_tpu_torch.train import cache as cache_lib
from erasurehead_tpu_torch.train import trainer


def pack_key(request: RunRequest) -> Optional[tuple]:
    """The bin-packing key for one request: ``(cohort_signature, dataset
    token)``, or None when the config is cohort-ineligible (measured
    arrivals, the forced fused kernel, pipelining: dispatched as its own
    sequential singleton). The request's dataset must already be resolved
    (server._resolve_dataset)."""
    sig = trainer.cohort_signature(request.config)
    if sig is None:
        return None
    return (sig, cache_lib.dataset_token(request.dataset))


def key_digest(key: Optional[tuple]) -> str:
    """Short stable digest of a pack key for records and logs (the raw key
    embeds assignment bytes)."""
    if key is None:
        return "sequential"
    return hashlib.sha256(repr(key).encode()).hexdigest()[:12]


@dataclasses.dataclass
class PackedCohort:
    """One planned dispatch: the requests riding it and their shared key."""

    key: Optional[tuple]
    requests: list  # list[RunRequest], first-submitted first
    batchable: bool  # False = cohort-ineligible singleton

    @property
    def key_digest(self) -> str:
        return key_digest(self.key)

    @property
    def tenants(self) -> list:
        return sorted({r.tenant for r in self.requests})

    @property
    def labels(self) -> list:
        return [r.label for r in self.requests]


def fair_windows(
    reqs: list, max_cohort: int, tenant_quota: Optional[int] = None
) -> list[list]:
    """Split one signature group's requests into dispatch windows of at
    most ``max_cohort``, weighted-fair across tenants:

      - each tenant's requests form their own queue, ordered by priority
        class first (higher ``RunRequest.priority`` sooner; arrival order
        kept within a class: the sort is stable);
      - each window drains the tenant queues round-robin (tenants in
        first-arrival order), so tenants sharing a window get about equal
        shares of it however deep one backlog is; a lone tenant still
        fills whole windows;
      - ``tenant_quota`` additionally hard-caps one tenant's slots per
        window: when every backlogged tenant is at quota the window closes
        short and the overflow waits for the next one.
    """
    queues: "dict[str, deque]" = {}
    tenant_order: list[str] = []
    for r in reqs:
        if r.tenant not in queues:
            queues[r.tenant] = deque()
            tenant_order.append(r.tenant)
    for tenant in tenant_order:
        mine = [r for r in reqs if r.tenant == tenant]
        mine.sort(key=lambda r: -r.priority)  # stable: FIFO within class
        queues[tenant].extend(mine)
    windows: list[list] = []
    while any(queues.values()):
        window: list = []
        taken = dict.fromkeys(tenant_order, 0)
        while len(window) < max_cohort:
            progress = False
            for tenant in tenant_order:
                if len(window) >= max_cohort:
                    break
                if not queues[tenant]:
                    continue
                if tenant_quota is not None and taken[tenant] >= tenant_quota:
                    continue
                window.append(queues[tenant].popleft())
                taken[tenant] += 1
                progress = True
            if not progress:
                break  # every backlogged tenant is at quota (or drained)
        windows.append(window)
    return windows


def plan_packs(
    pending: list,
    max_cohort: int = 64,
    fair: bool = True,
    tenant_quota: Optional[int] = None,
) -> list[PackedCohort]:
    """Group pending requests into dispatch cohorts, first-seen key order.
    Groups larger than ``max_cohort`` split into chunks (the per-round
    weight tables scale with cohort width, so one burst must not balloon a
    dispatch past what admission can reason about). Within a key,
    ``fair=True`` (the daemon default) orders each chunk weighted-fair
    across tenants (:func:`fair_windows`); ``fair=False`` keeps FIFO by
    arrival. Cohort-ineligible requests come back as their own
    ``batchable=False`` singletons."""
    if max_cohort < 1:
        raise ValueError(f"max_cohort must be >= 1, got {max_cohort}")
    if tenant_quota is not None and tenant_quota < 1:
        raise ValueError(
            f"tenant_quota must be >= 1 (or None), got {tenant_quota}"
        )
    groups: dict = {}
    order: list = []
    for req in pending:
        key = pack_key(req)
        gk = ("__sequential__", req.request_id) if key is None else key
        if gk not in groups:
            groups[gk] = (key, [])
            order.append(gk)
        groups[gk][1].append(req)
    out: list[PackedCohort] = []
    for gk in order:
        key, reqs = groups[gk]
        if key is None:
            out.append(PackedCohort(key=None, requests=reqs, batchable=False))
            continue
        if fair:
            chunks = fair_windows(reqs, max_cohort, tenant_quota)
        else:
            chunks = [reqs[lo:lo + max_cohort] for lo in range(0, len(reqs), max_cohort)]
        for chunk in chunks:
            out.append(PackedCohort(key=key, requests=chunk, batchable=True))
    return out
