"""Card-side pin of the serve fleet: two ``cli serve --device cuda``
replicas behind the router, sharing a build directory that already holds
the kernel library, a ``kill:fleet_replica:2`` on the replica the ring
routes the tenant to, the death declared and the WAL adopted by its ring
peer; every row reaches the tenant once, bitwise the same requests' rows
from an in-process daemon on the card, and no replica builds anything.
Marked ``cuda``; skips without a card.

The module imports the port only: ``python -m pytest --noconftest -m cuda
tests/test_torch_fleet_cuda.py``.
"""

import json
import os
import time

import pytest
import torch

from erasurehead_tpu_torch.obs import events as events_lib
from erasurehead_tpu_torch.ops import kernels
from erasurehead_tpu_torch.serve import queue, server
from erasurehead_tpu_torch.serve.client import HttpServeClient
from erasurehead_tpu_torch.serve.fleet import FleetSupervisor
from erasurehead_tpu_torch.serve.router import HashRing, affinity_key
from erasurehead_tpu_torch.train import journal as journal_lib
from erasurehead_tpu_torch.utils import chaos
from erasurehead_tpu_torch.utils.config import RunConfig

W, R, N_ROWS, N_COLS, MAX_COHORT = 8, 12, 8 * 64, 32, 4


def _cfg(**kw):
    base = dict(scheme="approx", n_workers=W, n_stragglers=1, num_collect=6, rounds=R,
                n_rows=N_ROWS, n_cols=N_COLS, update_rule="AGD", lr_schedule=1.0,
                add_delay=True, seed=0)
    base.update(kw)
    return RunConfig(**base)


@pytest.mark.cuda
def test_two_replicas_on_the_card_kill_and_adoption(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    kernels.load_library()
    build_dir = str(kernels.library_path().parent)
    files_before = sorted(os.listdir(build_dir))
    cfgs = {"warm": _cfg(seed=0), "b": _cfg(seed=1), "c": _cfg(seed=2),
            "fused": _cfg(seed=3, use_pallas="on")}
    payloads = {label: queue.config_payload(c) for label, c in cfgs.items()}
    victim = HashRing(["r0", "r1"]).lookup(affinity_key("alice", payloads["warm"]))
    sup_log = str(tmp_path / "supervisor.jsonl")
    assert chaos.CHAOS_ENV not in os.environ
    with events_lib.capture(sup_log):
        sup = FleetSupervisor(n=2, base_dir=str(tmp_path / "fleet"), k=3, probe_interval_s=0.2,
                              cache_dir=build_dir, device="cuda",
                              chaos={victim: "kill:fleet_replica:2"},
                              extra_args=("--max-cohort", str(MAX_COHORT),
                                          "--dispatch-workers", "1"))
        sup.start()
        try:
            client = HttpServeClient(sup.router.host, sup.router.port, "alice")
            rows = {}
            client.submit("warm", payloads["warm"], max_retries=8)
            first = client.result(timeout=300)
            rows[first["label"]] = first
            for label in ("b", "c", "fused"):
                client.submit(label, payloads[label], max_retries=8)
            deadline = time.monotonic() + 300
            while set(cfgs) - set(rows) and time.monotonic() < deadline:
                try:
                    res = client.result(timeout=5)
                except Exception:  # noqa: BLE001 — nothing yet while the peer adopts
                    continue
                assert res["label"] not in rows, res["label"]
                rows[res["label"]] = res
            client.close()
            victim_rc = sup.replicas[victim].proc.poll()
        finally:
            sup.stop()
    assert sorted(rows) == sorted(cfgs) and {r["status"] for r in rows.values()} == {"ok"}
    assert victim_rc == chaos.KILL_EXIT
    deaths = [r for r in map(json.loads, open(sup_log))
              if r["type"] == "fleet" and r["action"] == "declare_dead"]
    assert [r["replica"] for r in deaths] == [victim] and deaths[0]["streak"] >= 3
    peer = "r1" if victim == "r0" else "r0"
    adopts = [r for r in map(json.loads, open(sup.replicas[peer].events_path))
              if r["type"] == "fleet" and r["action"] == "adopt"]
    assert len(adopts) == 1 and adopts[0]["replica"] == victim
    for p in [sup_log] + [rep.events_path for rep in sup.replicas.values()]:
        assert events_lib.validate_file(p) == [], p
    assert sorted(os.listdir(build_dir)) == files_before  # no replica built
    with server.serving(device="cuda", max_cohort=MAX_COHORT, dispatch_workers=1,
                        window_s=0.05) as srv:
        want = {label: srv.submit(tenant="alice", label=label, config=c).result(timeout=300)
                for label, c in cfgs.items()}
    for label, res in rows.items():
        assert json.dumps(journal_lib.science_row(res["row"]), sort_keys=True) == json.dumps(
            journal_lib.science_row(journal_lib.summary_payload(want[label].summary)),
            sort_keys=True), label
