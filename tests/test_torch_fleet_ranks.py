"""The serve fleet whose replicas are rank groups (serve/fleet.py's
``ranks=``, parallel/backend.resolve_card), on the CPU with gloo, against the
JAX package's in-process daemon and the port's one-process daemon.

One fleet of three replicas runs the drills (a module fixture): the replica
the ring routes tenant alice to (the victim, ``kill:fleet_replica:2`` armed
on its rank 0) and the next in its ring order (the adopter) are groups of 2
ranks, the third is one process. Every replica starts each trajectory from
the JAX package's init draw of its seed (``FleetSupervisor.serve_cmd`` is a
``-c`` program that installs it, then runs ``cli serve``).

  - rows: alice's first request is served by the victim group, the next two
    are accepted, the victim dies in its second dispatch and the adopter
    group replays them from the victim's WAL; each row's status and
    simulated clock equal the JAX daemon's, its losses are within JAX_RTOL
    of JAX's and within TOL of the port's one-process daemon's (the
    tolerances of tests/test_torch_serve_ranks.py);
  - the kill drill: rank 0 exits 43 (read from rank 0's own process), the
    death is declared at a streak >= K, the adopter adopts the WAL, every
    row reaches alice exactly once, the follower ends by itself once rank 0
    is gone, and no process of the group is left;
  - the rolling deploy under closed-loop load bounces the adopter group and
    the single replica with no lost or duplicate row; the group re-forms at
    a new rendezvous with new followers;
  - ``stop()`` drains each group (every rank exits 0) and leaves no process
    of any group;
  - defaults: ``ranks=None`` is the card count on ``cuda`` (a stand-in
    count here) and 1 on the CPU; more ranks than cards is refused unless
    ``share_card`` asks for it, and so is a rank past the cards in the
    backend.

Sizes: W = 4, 64 x 8 rows, 2 rounds (tests/test_torch_fleet.py's). Every
wait has a limit of its own.
"""

import concurrent.futures
import json
import os
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from erasurehead_tpu.serve import server as j_server
from erasurehead_tpu.train import trainer as j_trainer
from erasurehead_tpu.utils.config import RunConfig as JRunConfig
from erasurehead_tpu_torch.models import glm as t_glm
from erasurehead_tpu_torch.obs import events as events_lib
from erasurehead_tpu_torch.parallel import backend
from erasurehead_tpu_torch.serve import fleet as fleet_lib
from erasurehead_tpu_torch.serve import loadgen
from erasurehead_tpu_torch.serve import server as serve_server
from erasurehead_tpu_torch.serve.client import HttpServeClient
from erasurehead_tpu_torch.serve.queue import config_from_payload
from erasurehead_tpu_torch.serve.router import HashRing, affinity_key
from erasurehead_tpu_torch.train import cache
from erasurehead_tpu_torch.train import journal as journal_lib
from erasurehead_tpu_torch.utils import chaos

CFG = {
    "scheme": "naive", "n_workers": 4, "n_stragglers": 1, "rounds": 2,
    "n_rows": 64, "n_cols": 8, "lr_schedule": 0.5, "add_delay": True,
    "compute_mode": "deduped",
}
PAYLOADS = {label: {**CFG, "seed": s} for s, label in enumerate(("warm", "b", "c"))}
MAX_COHORT = 4
K = 3
TOL = dict(rtol=2e-5, atol=1e-6)
JAX_RTOL = 1e-4
LOAD_TENANTS, LOAD_JOBS = ("la", "lb"), 3
WAIT_S = 120.0

#: a replica's command: the JAX init draw of every seed it knows, then
#: ``cli serve`` with the supervisor's flags
_HOOK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from erasurehead_tpu_torch.models import glm

    inits = dict(np.load({path!r}))
    own = glm.LogisticModel.init_params

    def init_params(self, seed, F, device="cpu"):
        if str(seed) in inits:
            return torch.from_numpy(inits[str(seed)]).to(device)
        return own(self, seed, F, device)

    glm.LogisticModel.init_params = init_params
    from erasurehead_tpu_torch import cli

    sys.exit(cli.main(["serve", *sys.argv[1:]]))
""")


def _jax_init(payload):
    jcfg = JRunConfig(**payload)
    return np.asarray(j_trainer._init_params_f32(jcfg, j_trainer.build_model(jcfg),
                                                 payload["n_cols"]))


def _await(pred, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError("timed out")
        time.sleep(0.05)


def _alice(sup) -> dict:
    """The kill drill's traffic: rows by label, deliveries counted."""
    client = HttpServeClient(sup.router.host, sup.router.port, "alice")
    try:
        client.submit("warm", PAYLOADS["warm"], max_retries=8)
        first = client.result(timeout=WAIT_S)
        rows, delivered = {first["label"]: first}, 1
        client.submit("b", PAYLOADS["b"], max_retries=8)
        client.submit("c", PAYLOADS["c"], max_retries=8)
        deadline = time.monotonic() + WAIT_S
        while {"b", "c"} - set(rows) and time.monotonic() < deadline:
            try:
                res = client.result(timeout=5)
            except Exception:  # noqa: BLE001 — nothing yet while the peer adopts
                continue
            rows[res["label"]] = res
            delivered += 1
        t_end = time.monotonic() + 1.5  # a duplicate would land here
        while time.monotonic() < t_end:
            try:
                client.result(timeout=0.5)
                delivered += 1
            except Exception:  # noqa: BLE001 — nothing is the success case
                pass
    finally:
        client.close()
    return {"rows": rows, "delivered": delivered}


def _deploy_under_load(sup) -> dict:
    """Closed-loop batches through the router while rolling_deploy() runs,
    until a batch ends after the deploy is done."""
    out: dict = {}
    done = threading.Event()

    def deploy():
        time.sleep(0.5)  # the load is going first
        try:
            out["phases"] = sup.rolling_deploy()
        finally:
            done.set()

    deployer = threading.Thread(target=deploy)
    deployer.start()
    batches = []
    try:
        while True:
            b = len(batches)
            jobs = {t: [(f"{t}{b}_{k}", {**CFG, "seed": 1000 + 64 * b + 8 * i + k})
                        for k in range(LOAD_JOBS)]
                    for i, t in enumerate(LOAD_TENANTS)}
            batches.append(loadgen.run_fleet(sup.router.host, sup.router.port, jobs,
                                             concurrency=2, max_retries=16, timeout=WAIT_S))
            if done.is_set() or b > 200:
                break
    finally:
        deployer.join(timeout=WAIT_S)
    out["batches"], out["deployer_alive"] = batches, deployer.is_alive()
    return out


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """The fleet's drills, and the JAX daemon's and the port's one-process
    daemon's rows of alice's requests (computed while the fleet boots)."""
    tmp = tmp_path_factory.mktemp("fleet_ranks")
    inits = {str(p["seed"]): _jax_init(p) for p in PAYLOADS.values()}
    np.savez(tmp / "inits.npz", **inits)
    names = ["r0", "r1", "r2"]
    victim = HashRing(names).lookup(affinity_key("alice", PAYLOADS["warm"]))
    survivors = [n for n in names if n != victim]
    adopter = HashRing(survivors).lookup(victim)
    single = next(n for n in survivors if n != adopter)
    sup_log = str(tmp / "supervisor.jsonl")
    saved_env = os.environ.pop(chaos.CHAOS_ENV, None)
    sup = fleet_lib.FleetSupervisor(
        n=3, base_dir=str(tmp / "fleet"), device="cpu", k=K, probe_interval_s=0.2,
        window_ms=20, ranks={victim: 2, adopter: 2},
        chaos={victim: "kill:fleet_replica:2"}, extra_args=("--max-cohort", str(MAX_COHORT)))
    sup.serve_cmd = (sys.executable, "-c", _HOOK.format(path=str(tmp / "inits.npz")))
    rec = {"victim": victim, "adopter": adopter, "single": single, "sup": sup,
           "sup_log": sup_log}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_rows = pool.submit(_jax_rows)
        try:
            with events_lib.capture(sup_log):
                t0 = time.monotonic()
                sup.start()
                rec["boot_s"] = {n: r.boot_s for n, r in sup.replicas.items()}
                rec["start_s"] = time.monotonic() - t0
                vrep, arep = sup.replicas[victim], sup.replicas[adopter]
                rec["victim_pgid"] = vrep.proc.pid
                rec["alice"] = _alice(sup)
                _await(lambda: vrep.exit_codes is not None)
                rec["victim_exit_codes"] = list(vrep.exit_codes)
                rec["victim_left"] = fleet_lib.group_pids(rec["victim_pgid"])
                rec["adopter_before"] = (arep.rendezvous, [p.pid for p in arep.followers])
                rec["deploy"] = _deploy_under_load(sup)
                rec["adopter_after"] = (arep.rendezvous, [p.pid for p in arep.followers])
                rec["adopter_log"] = open(arep.rank_log_path(1)).read()
                pgids = {n: r.proc.pid for n, r in sup.replicas.items()}
                sup.stop()
                rec["stopped"] = True
                rec["left_after_stop"] = {n: fleet_lib.group_pids(g) for n, g in pgids.items()}
                rec["exit_codes"] = {n: r.exit_codes for n, r in sup.replicas.items()}
        finally:
            if "stopped" not in rec:
                sup.stop()
            if saved_env is not None:
                os.environ[chaos.CHAOS_ENV] = saved_env
        rec["jax"] = jax_rows.result()
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(t_glm.LogisticModel, "init_params",
                   lambda self, seed, F, device="cpu": torch.tensor(inits[str(seed)],
                                                                   device=device))
        cache.clear()
        with serve_server.serving(device="cpu", window_s=0.02, max_cohort=MAX_COHORT) as srv:
            rec["one"] = {label: srv.submit(tenant="alice", label=label,
                                            config=config_from_payload(p)).result(timeout=WAIT_S)
                          for label, p in PAYLOADS.items()}
    finally:
        mp.undo()
        cache.clear()
    return rec


def _jax_rows() -> dict:
    with j_server.serving(window_s=0.02, max_cohort=MAX_COHORT) as srv:
        handles = {label: srv.submit(tenant="alice", label=label, config=JRunConfig(**p))
                   for label, p in PAYLOADS.items()}
        return {label: h.result(timeout=300).summary for label, h in handles.items()}


def _summary(row, label):
    return journal_lib.rehydrate_summary(row, config_from_payload(PAYLOADS[label]))


def test_group_rows_match_the_jax_daemon_and_the_one_process_daemon(drill):
    """Rows served by the two groups (warm by the victim, b and c by the
    adopter from the victim's WAL): status and simulated clock the JAX
    daemon's, losses within JAX_RTOL of JAX's and TOL of one process's."""
    rows = drill["alice"]["rows"]
    assert sorted(rows) == ["b", "c", "warm"]
    for label, res in rows.items():
        assert res["status"] == "ok", res.get("error")
        got, want, one = _summary(res["row"], label), drill["jax"][label], drill["one"][label]
        assert one.status == "ok"
        assert got.sim_total_time == want.sim_total_time == one.summary.sim_total_time
        np.testing.assert_array_equal(got.timeset, want.timeset)
        np.testing.assert_allclose(got.training_loss, want.training_loss, rtol=JAX_RTOL)
        np.testing.assert_allclose(got.final_auc, want.final_auc, rtol=JAX_RTOL)
        np.testing.assert_allclose(got.training_loss, one.summary.training_loss, **TOL)
        np.testing.assert_allclose(got.final_auc, one.summary.final_auc, **TOL)


def test_kill_drill_on_a_group(drill):
    """Rank 0 of the victim group exits 43, its follower ends by itself (exit
    1, at its next collective), the death is declared once at a streak >= K,
    the adopter group adopts the WAL, each row reaches alice once, and no
    process of the victim's group is left."""
    victim, adopter, sup = drill["victim"], drill["adopter"], drill["sup"]
    assert drill["victim_exit_codes"] == [chaos.KILL_EXIT, 1]
    assert drill["victim_left"] == []
    assert drill["alice"]["delivered"] == 3
    recs = [json.loads(line) for line in open(drill["sup_log"])]
    deaths = [r for r in recs if r["type"] == "fleet" and r["action"] == "declare_dead"]
    assert [r["replica"] for r in deaths] == [victim] and deaths[0]["streak"] >= K
    adopts = [r for r in map(json.loads, open(sup.replicas[adopter].events_path))
              if r["type"] == "fleet" and r["action"] == "adopt"]
    assert len(adopts) == 1 and adopts[0]["replica"] == victim and adopts[0]["records"] >= 1
    assert os.path.exists(sup.replicas[victim].wal_path + ".adopted")
    log = open(sup.replicas[victim].rank_log_path(1)).read()
    assert "serve: rank 1 follows rank 0" in log and "serve: rank 1 ends:" in log
    for path in (drill["sup_log"], sup.replicas[adopter].events_path):
        assert events_lib.validate_file(path) == [], path


def test_rolling_deploy_bounces_a_group_with_no_loss(drill):
    """The deploy bounces both survivors under closed-loop load: no lost or
    duplicate row, every row ok; the adopter group comes back with new
    followers that met at a new rendezvous, and its rank 0 led every
    dispatch its follower followed before the bounce."""
    sup, adopter = drill["sup"], drill["adopter"]
    deploy = drill["deploy"]
    assert not deploy["deployer_alive"]
    assert sorted(deploy["phases"]) == sorted([adopter, drill["single"]])
    batches = deploy["batches"]
    assert sum(b["lost"] for b in batches) == 0 and sum(b["duplicates"] for b in batches) == 0
    ledgers = [led for b in batches for led in b["tenants"].values()]
    assert all(led["rows"] == LOAD_JOBS for led in ledgers)
    assert {r["status"] for led in ledgers for r in led["rows_by_label"].values()} == {"ok"}
    (rdzv0, pids0), (rdzv1, pids1) = drill["adopter_before"], drill["adopter_after"]
    assert rdzv0 != rdzv1 and rdzv1.endswith(f"rendezvous.{sup.replicas[adopter].restarts}")
    assert len(pids0) == len(pids1) == 1 and pids0 != pids1
    log = drill["adopter_log"]
    assert log.count("serve: rank 1 follows rank 0") == 2
    lead = open(sup.replicas[adopter].log_path).read()
    led = [int(line.split(" led ")[1].split()[0]) for line in lead.splitlines()
           if line.startswith("serve: rank 0 led ")]
    followed = [int(line.split(" followed ")[1].split()[0]) for line in log.splitlines()
                if line.startswith("serve: rank 1 followed ")]
    assert led[:1] == followed[:1] and led[0] >= 1


def test_stop_drains_every_group_and_leaves_no_process(drill):
    sup = drill["sup"]
    assert drill["left_after_stop"] == {n: [] for n in sup.replicas}
    codes = drill["exit_codes"]
    assert codes[drill["adopter"]] == [0, 0]  # rank 0 drained, then released rank 1
    assert len(codes[drill["single"]]) == 1
    assert sup.replicas[drill["victim"]].ranks == sup.replicas[drill["adopter"]].ranks == 2


@pytest.mark.parametrize("device,cards,want", [("cuda", 4, 4), ("cuda", 1, 1), ("cuda", 0, 1),
                                               ("cpu", 4, 1)])
def test_ranks_default_to_the_hosts_cards(tmp_path, monkeypatch, device, cards, want):
    """None is the JAX auto mesh's reach: every card on ``cuda`` (a stand-in
    count; at least one rank), one on the CPU; a named replica keeps its
    own count."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    sup = fleet_lib.FleetSupervisor(n=2, base_dir=str(tmp_path), device=device)
    named = fleet_lib.FleetSupervisor(n=2, base_dir=str(tmp_path), device=device,
                                      ranks={"r1": 1}, share_card=True)
    try:
        assert sup.ranks_of("r0") == sup.ranks_of("r1") == want
        assert named.ranks_of("r0") == want and named.ranks_of("r1") == 1
    finally:
        sup.router.close()
        named.router.close()


def test_more_ranks_than_cards_is_refused_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for ranks in (2, {"r0": 2}):
        with pytest.raises(ValueError, match="share_card=True"):
            fleet_lib.FleetSupervisor(n=1, base_dir=str(tmp_path), device="cuda", ranks=ranks)
    sup = fleet_lib.FleetSupervisor(n=1, base_dir=str(tmp_path), device="cuda", ranks=2,
                                    share_card=True)
    sup.router.close()
    assert sup.ranks_of("r0") == 2
    with pytest.raises(ValueError, match="at least one rank"):
        fleet_lib.FleetSupervisor(n=1, base_dir=str(tmp_path), device="cpu", ranks=0)
    # the CPU has no cards to share: any count of ranks is taken
    sup = fleet_lib.FleetSupervisor(n=1, base_dir=str(tmp_path), device="cpu", ranks=3)
    sup.router.close()
    assert sup.ranks_of("r0") == 3


@pytest.mark.parametrize("cards", [1, 2])
def test_a_rank_past_the_cards_is_refused_unless_asked(monkeypatch, cards):
    """Each rank keeps its own card (and the caller's backend); a rank past
    the cards is refused by name; asked to share, ranks bind LOCAL_RANK mod
    cards under gloo, and NCCL is refused."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    for r in range(cards):
        assert backend.resolve_card(r, False, "nccl") == (r, "nccl")
    with pytest.raises(ValueError, match=backend.SHARE_CARD_ENV):
        backend.resolve_card(cards, False, None)
    assert backend.resolve_card(cards + 1, True, None) == ((cards + 1) % cards, "gloo")
    assert backend.resolve_card(0, True, "gloo") == (0, "gloo")
    with pytest.raises(ValueError, match="NCCL refuses"):
        backend.resolve_card(1, True, "nccl")


@pytest.mark.parametrize("native", [True, False])
def test_ranks_join_rank_0s_process_group(monkeypatch, native):
    """A group's ranks share rank 0's process group, through Popen's
    ``process_group`` (Python 3.11 on) or, before it, a setpgid in the
    child; group_pids finds both and one killpg ends them."""
    import signal
    import subprocess

    monkeypatch.setattr(fleet_lib, "_POPEN_PROCESS_GROUP", native)
    cmd = [sys.executable, "-c", "import time; time.sleep(60)"]
    lead = subprocess.Popen(cmd, **fleet_lib._process_group_kw(0))
    try:
        follow = subprocess.Popen(cmd, **fleet_lib._process_group_kw(lead.pid))
        try:
            assert os.getpgid(lead.pid) == lead.pid == os.getpgid(follow.pid)
            assert os.getpgid(0) != lead.pid
            assert sorted(fleet_lib.group_pids(lead.pid)) == sorted([lead.pid, follow.pid])
        finally:
            os.killpg(lead.pid, signal.SIGKILL)
            follow.wait(timeout=10)
    finally:
        lead.wait(timeout=10)
    assert fleet_lib.group_pids(lead.pid) == []
