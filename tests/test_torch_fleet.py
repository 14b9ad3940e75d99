"""The port's serve fleet (serve/router.py, serve/fleet.py, ``cli fleet``)
against the JAX package's, on the CPU.

What is held, and how:
  - the hash ring: ``lookup`` and ``ring_order`` equal the JAX ring's for
    the same members and key strings; adding or removing a member remaps
    about 1/N of the keys, all to or from that member; the failover order
    is deterministic whatever the insertion order;
  - affinity: packable payloads share one key per tenant, the key is the
    same string in two processes (and computing it initialises no card);
    unbatchable and unresolvable payloads fall back to the tenant, as the
    JAX router's do;
  - membership: death only after K evidential misses, step for step the
    JAX detector's; the fleet record validator's errors for an early death
    and an unknown action are the JAX validator's strings;
  - the router: membership and gauges, routing by affinity, the submit
    proxy's failover walk on a refused connection (a 429 passes through
    and is never retried sideways); a bounced replica joins the ring only
    once the open streams have re-dialed it, and a client's stream answers
    only once the router's pumps listen; request ids are unique across
    replica processes;
  - the supervisor: ``_wait_front`` reads only this incarnation's log; a
    draining replica's answered probe leaves it out of the ring (the JAX
    supervisor re-admits it); a replica that cannot reach its device exits
    and the supervisor raises with its log (nothing falls back to the
    CPU);
  - the kernel build lock: two processes that build into one directory
    at once run the (stand-in) compiler once between them;
  - one real ``cli fleet --device cpu`` drill: two replicas, a
    ``kill:fleet_replica:2`` on the one the ring routes the tenant to, a
    declared death and an adoption, every row exactly once through the
    router's stream and bitwise an in-process daemon's rows.

Sizes: W = 4, 64 x 8 synthetic rows, 2 rounds.
"""

import dataclasses
import http.client
import http.server
import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from erasurehead_tpu.elastic.controller import ProbeStreakDetector as JProbeStreakDetector
from erasurehead_tpu.obs import events as j_events
from erasurehead_tpu.serve import router as j_router
from erasurehead_tpu_torch.elastic.controller import ProbeStreakDetector
from erasurehead_tpu_torch.obs import events as events_lib
from erasurehead_tpu_torch.serve import fleet as fleet_lib
from erasurehead_tpu_torch.serve.client import HttpServeClient
from erasurehead_tpu_torch.serve.router import VNODES, FleetRouter, HashRing, affinity_key
from erasurehead_tpu_torch.train import journal as journal_lib
from erasurehead_tpu_torch.utils import chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = {
    "scheme": "naive", "n_workers": 4, "n_stragglers": 1, "rounds": 2,
    "n_rows": 64, "n_cols": 8, "lr_schedule": 0.5, "add_delay": True,
    "compute_mode": "deduped",
}


def _keys(n=1000):
    return [f"tenant{i % 7}:key{i}" for i in range(n)]


# ---- the hash ring ---------------------------------------------------------


@pytest.mark.parametrize("members", [["r0", "r1"], ["r0", "r1", "r2"],
                                     ["r2", "r0", "r3", "r1"]])
def test_ring_lookup_and_order_equal_jax(members):
    """Same members, same key strings: the same primary and the same
    failover order as the JAX ring (sha256, 64 virtual nodes each)."""
    ours, theirs = HashRing(members), j_router.HashRing(members)
    assert VNODES == j_router.VNODES
    for k in _keys():
        assert ours.lookup(k) == theirs.lookup(k)
    for k in _keys(64):
        assert ours.ring_order(k) == theirs.ring_order(k)
    assert ours.members == theirs.members


@pytest.mark.parametrize("change", ["add", "remove"])
def test_ring_remaps_about_one_nth(change):
    """Adding a 4th member moves about 1/4 of the keys, every one of them TO
    the new member; removing one re-homes only its own keys."""
    if change == "add":
        before, after, member = HashRing(["r0", "r1", "r2"]), HashRing(
            ["r0", "r1", "r2", "r3"]), "r3"
    else:
        before, after, member = HashRing(["r0", "r1", "r2"]), HashRing(["r0", "r2"]), "r1"
    keys = _keys()
    moved = [k for k in keys if before.lookup(k) != after.lookup(k)]
    frac = len(moved) / len(keys)
    assert 0.10 <= frac <= 0.45, f"remap fraction {frac}"
    if change == "add":
        assert all(after.lookup(k) == member for k in moved)
    else:
        assert all(before.lookup(k) == member for k in moved)
        assert all(after.lookup(k) in ("r0", "r2") for k in moved)


def test_ring_order_is_a_deterministic_failover():
    """ring_order starts at lookup, holds every member once, and does not
    depend on the order members were added."""
    a, b = HashRing(["r0", "r1", "r2"]), HashRing(["r2", "r0", "r1"])
    for k in _keys(64):
        order = a.ring_order(k)
        assert order[0] == a.lookup(k) and sorted(order) == ["r0", "r1", "r2"]
        assert b.ring_order(k) == order
    assert HashRing().lookup("x") is None and HashRing().ring_order("x") == []


def test_ring_vnodes_spread():
    ring = HashRing(["r0", "r1", "r2"])
    counts = {}
    for k in _keys():
        counts[ring.lookup(k)] = counts.get(ring.lookup(k), 0) + 1
    assert max(counts.values()) / sum(counts.values()) < 0.5, counts


# ---- affinity ------------------------------------------------------------


def test_packable_payloads_share_a_key():
    """Four tenants' same-signature requests (the seed is not in the cohort
    signature): one key per tenant, so one replica per tenant's cohort."""
    ring = HashRing(["r0", "r1"])
    for tenant in ("t0", "t1", "t2", "t3"):
        keys = {affinity_key(tenant, {**CFG, "seed": s}) for s in range(8)}
        assert len(keys) == 1
        assert len({ring.lookup(k) for k in keys}) == 1
        assert json.loads(next(iter(keys)))[0] == tenant
    # the signature takes part: another stack shape is another key
    assert affinity_key("t0", CFG) != affinity_key("t0", {**CFG, "n_workers": 8})


_KEY_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    from erasurehead_tpu_torch.serve.router import affinity_key
    payloads = json.loads(sys.argv[1])
    keys = [affinity_key(t, p) for t, p in payloads]
    print(json.dumps({"keys": keys, "cuda": torch.cuda.is_initialized()}))
""")


def test_affinity_key_is_the_same_in_two_processes():
    """The key's signature repr holds nothing process-specific: a fresh
    interpreter computes the same strings, and initialises no card."""
    payloads = [
        ["alice", {**CFG, "seed": 3}],
        ["bob", {**CFG, "scheme": "approx", "n_workers": 6, "n_stragglers": 2,
                 "num_collect": 3, "compute_mode": "faithful"}],
        ["carol", {**CFG, "scheme": "cyccoded", "n_workers": 6, "n_stragglers": 2,
                   "compute_mode": "faithful", "model": "deepmlp",
                   "layer_coding": "on"}],
    ]
    out = subprocess.run([sys.executable, "-c", _KEY_SCRIPT, json.dumps(payloads)],
                         capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["keys"] == [affinity_key(t, p) for t, p in payloads]
    assert got["cuda"] is False
    assert all(json.loads(k)[1] != "None" for k in got["keys"])


@pytest.mark.parametrize("payload", [
    {**CFG, "use_pallas": "on"},  # the forced kernel never batches
    {**CFG, "scheme": "no-such-scheme"},  # does not resolve
    {"n_workers": "four"},
])
def test_unbatchable_payloads_fall_back_to_the_tenant(payload):
    """A payload that cannot pack (or cannot resolve) routes by tenant
    alone: the JAX router's key for the same payload, ``[tenant, "None"]``."""
    key = affinity_key("alice", payload)
    assert key == json.dumps(["alice", "None"]) == j_router.affinity_key("alice", payload)


# ---- membership and the fleet records ------------------------------------


def test_death_only_after_k_evidential_misses_as_jax():
    """k - 1 misses never kill; a success resets; misses while deliberately
    down are no evidence; the kth evidential miss kills — the JAX
    detector's streaks at every step."""
    seq = ([(False, True)] * 2 + [(True, True)] + [(False, False)] * 10
           + [(False, True)] * 3)
    ours, theirs = ProbeStreakDetector(["r0"], k=3), JProbeStreakDetector(["r0"], k=3)
    dead_at = None
    for i, (ok, evidential) in enumerate(seq):
        a = ours.observe("r0", ok=ok, evidential=evidential)
        b = theirs.observe("r0", ok=ok, evidential=evidential)
        assert a == b and ours.is_dead("r0") == theirs.is_dead("r0")
        if ours.is_dead("r0") and dead_at is None:
            dead_at = i
    assert dead_at == len(seq) - 1 and ours.streak("r0") >= 3


@pytest.mark.parametrize("record", [
    {"action": "declare_dead", "replica": "r1", "streak": 2, "k": 3},
    {"action": "resurrect", "replica": "r1"},
])
def test_fleet_validator_errors_equal_jax(tmp_path, record):
    """An early death and an unknown action are refused with the JAX
    validator's own words, on the same log."""
    p = tmp_path / "ev.jsonl"
    with events_lib.capture(str(p)):
        events_lib.emit("fleet", **record)
    ours = events_lib.validate_lines(open(p))
    theirs = j_events.validate_lines(open(p))
    assert ours and ours == theirs
    good = tmp_path / "good.jsonl"
    with events_lib.capture(str(good)):
        events_lib.emit("fleet", action="suspect", replica="r1", streak=1, k=3)
        events_lib.emit("fleet", action="declare_dead", replica="r1", streak=3, k=3)
        events_lib.emit("fleet", action="adopt", replica="r1", records=4, adopter="r0")
        events_lib.emit("fleet", action="deploy_phase", replica="r0", phase="drain")
    assert events_lib.validate_lines(open(good)) == j_events.validate_lines(open(good)) == []


# ---- the router ------------------------------------------------------------


def test_router_membership_and_fleet_gauges():
    router = FleetRouter(port=0)
    try:
        router.add_replica("r0", "127.0.0.1", 1111)
        router.add_replica("r1", "127.0.0.1", 2222)
        assert router.ring.members == ["r0", "r1"]
        router.set_alive("r1", False)
        assert router.ring.members == ["r0"] and set(router.replicas) == {"r0", "r1"}
        assert router.live_endpoints() == [("127.0.0.1", 1111)]
        router.set_alive("r1", True, pressure=0.5)
        assert router.ring.members == ["r0", "r1"]
        view = router.fleet_view()
        assert view["replicas"]["r1"]["pressure"] == 0.5 and view["vnodes"] == VNODES
        by_name = {k.split("{")[0]: v for k, v in router.fleet_gauges().items()}
        live = next(k for k in by_name if k.endswith("fleet_replicas_live"))
        known = next(k for k in by_name if k.endswith("fleet_replicas_known"))
        assert by_name[live] == 2.0 and by_name[known] == 2.0
        router.remove_replica("r0")
        assert router.ring.members == ["r1"] and router.endpoint_of("r0") is None
        conn = http.client.HTTPConnection(router.host, router.port, timeout=10)
        conn.request("GET", "/healthz")
        body = json.loads(conn.getresponse().read())
        conn.close()
        assert body["role"] == "router" and body["replicas"] == ["r1"]
    finally:
        router.close()


class _FakeFront:
    """Counts /v1/submit POSTs; answers 202, or 429 with Retry-After."""

    def __init__(self, status=202):
        front = self
        self.status, self.seen = status, []

        class H(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                front.seen.append(json.loads(self.rfile.read(n) or b"{}"))
                if front.status == 202:
                    out = {"type": "accepted", "request_id": f"rid-{len(front.seen)}"}
                else:
                    out = {"type": "rejected", "retry_after_s": 7.0}
                body = json.dumps(out).encode()
                self.send_response(front.status)
                if front.status == 429:
                    self.send_header("Retry-After", "7")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self._srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self._srv.server_address[1]
        threading.Thread(target=self._srv.serve_forever, daemon=True).start()

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()


def _refused_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _post(router, body) -> tuple:
    conn = http.client.HTTPConnection(router.host, router.port, timeout=30)
    conn.request("POST", "/v1/submit", body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = (resp.status, json.loads(resp.read()), resp.getheader("Retry-After"))
    conn.close()
    return out


def test_router_routes_by_affinity_and_fails_over():
    """The ring's primary gets the submit; with the primary refusing
    connections the proxy walks to the next replica in ring order (one
    redirect, delivered once); a 429 passes through verbatim and is never
    retried on a peer."""
    live, busy = _FakeFront(), _FakeFront(status=429)
    router = FleetRouter(port=0)
    try:
        msg = {"tenant": "alice", "label": "j", "config": {**CFG, "seed": 0}}
        key = affinity_key("alice", msg["config"])
        router.add_replica("r0", "127.0.0.1", live.port)
        router.add_replica("r1", "127.0.0.1", live.port)
        order = router.ring.ring_order(key)
        # the primary is dead: a refused port
        router.add_replica(order[0], "127.0.0.1", _refused_port())
        status, body, _ = _post(router, msg)
        assert status == 202 and body["type"] == "accepted"
        assert len(live.seen) == 1 and router.redirects_total == 1
        # marked dead, the same key resolves to the survivor directly
        router.set_alive(order[0], False)
        assert router.ring.lookup(key) == order[1]
        status, _, _ = _post(router, msg)
        assert status == 202 and len(live.seen) == 2 and router.redirects_total == 1
        # an overloaded primary is alive: its 429 comes back as it is
        router.set_alive(order[0], True)
        router.add_replica(order[0], "127.0.0.1", busy.port)
        status, body, retry_after = _post(router, msg)
        assert status == 429 and retry_after == "7" and body["type"] == "rejected"
        assert len(busy.seen) == 1 and len(live.seen) == 2
    finally:
        router.close()
        live.close()
        busy.close()


class _StreamFront:
    """A replica's /v1/stream stand-in: answers 200, then heartbeats every
    0.1 s until closed; counts the subscriptions it answered."""

    def __init__(self, delay_s=0.0):
        front = self
        self.subscribed, self.closing = 0, threading.Event()

        class H(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_GET(self):
                time.sleep(delay_s)  # a busy replica answers late
                front.subscribed += 1
                self.send_response(200)
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                beat = b'{"type": "ping"}\n'
                try:
                    while not front.closing.wait(0.1):
                        self.wfile.write(f"{len(beat):x}\r\n".encode() + beat + b"\r\n")
                        self.wfile.flush()
                except OSError:
                    pass
                self.close_connection = True  # as a dead replica's socket

            def log_message(self, *a):
                pass

        self._srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self._srv.server_address[1]
        threading.Thread(target=self._srv.serve_forever, daemon=True).start()

    def close(self):
        self.closing.set()
        self._srv.shutdown()
        self._srv.server_close()


def test_a_bounced_replica_joins_once_open_streams_redial_it():
    """A stream open through the router pumps from every replica. When a
    replica comes back at a new port, add_replica returns (and routes to
    it) only after that stream's pump has subscribed there: a row the
    replica finished before would never reach the reader."""
    before, after = _StreamFront(), _StreamFront()
    router = FleetRouter(port=0)
    reader = None
    try:
        router.add_replica("r0", "127.0.0.1", before.port)
        reader = http.client.HTTPConnection(router.host, router.port, timeout=30)
        reader.request("GET", "/v1/stream?tenant=alice")
        assert reader.getresponse().status == 200
        deadline = time.monotonic() + 10
        while before.subscribed < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert before.subscribed == 1
        before.close()  # the replica dies; the pump re-dials its old port
        router.set_alive("r0", False)
        assert router.ring.members == []
        router.add_replica("r0", "127.0.0.1", after.port)
        assert after.subscribed == 1 and router.ring.members == ["r0"]
    finally:
        if reader is not None:
            reader.close()
        router.close()
        after.close()


@pytest.mark.parametrize("package", ["port", "jax"])
def test_a_client_returns_once_its_stream_listens(package):
    """An HttpServeClient on the router returns from its constructor only
    after the router's pumps have subscribed at the replicas, so its first
    submit's row cannot be published before the stream listens. The JAX
    client and router return at once (the race a closed-loop load shows
    as a row that never arrives)."""
    from erasurehead_tpu.serve.client import HttpServeClient as JHttpServeClient

    front = _StreamFront(delay_s=0.5)
    router = (FleetRouter if package == "port" else j_router.FleetRouter)(port=0)
    client = None
    try:
        router.add_replica("r0", "127.0.0.1", front.port)
        cls = HttpServeClient if package == "port" else JHttpServeClient
        client = cls(router.host, router.port, "alice")
        assert front.subscribed == (1 if package == "port" else 0)
    finally:
        if client is not None:
            client.close()
        router.close()
        front.close()


@pytest.mark.parametrize("package", ["erasurehead_tpu_torch", "erasurehead_tpu"])
def test_request_ids_are_unique_across_replica_processes(package):
    """Two fresh processes (two replicas, or one before and after a bounce)
    make their first ids for one tenant: the port's differ, the JAX
    package's collide — and a client that holds one stream per replica,
    or one through the router, dedups rows by request id."""
    code = (f"from {package}.serve.queue import new_request_id; "
            "print(new_request_id('alice'))")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    ids = [subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=120, env=env).stdout.strip() for _ in range(2)]
    assert all(i.startswith("alice-req-") for i in ids)
    assert (ids[0] != ids[1]) == (package == "erasurehead_tpu_torch")


# ---- the supervisor --------------------------------------------------------


def test_wait_front_parses_only_this_incarnations_log(tmp_path):
    """A bounced replica appends to its log, whose first "http front on"
    line names the dead port: only lines after ``log_offset`` count."""

    class Healthz(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = b'{"status": "ok"}'
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Healthz)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    live_port = httpd.server_address[1]
    try:
        log = tmp_path / "r0.log"
        stale = "serve: http front on 127.0.0.1:1 (auth off)\n"
        log.write_text(stale)
        rep = fleet_lib.Replica(name="r0", journal_dir=str(tmp_path / "r0"),
                                cache_dir=str(tmp_path / "cache"), events_path=None,
                                log_path=str(log))
        rep.log_offset = len(stale)

        class LiveProc:
            def poll(self):
                return None

        rep.proc = LiveProc()
        with open(log, "a") as f:
            f.write(f"serve: http front on 127.0.0.1:{live_port} (auth off)\n")
        fleet_lib.FleetSupervisor._wait_front(None, rep, timeout=10)
        assert rep.port == live_port
    finally:
        httpd.shutdown()
        httpd.server_close()


class _Healthz(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
        body = b'{"status": "ok", "queued": 0, "in_flight": 0}'
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


@pytest.mark.parametrize("package", ["port", "jax"])
def test_a_draining_replica_stays_out_of_the_ring(tmp_path, package):
    """A replica mid-deploy still answers /healthz while it drains. The
    port's probe sweep leaves it out of the ring (spawn re-admits it);
    the JAX supervisor's sweep puts it back, so new work would reach a
    replica about to be stopped and wait out its restart."""
    from erasurehead_tpu.serve import fleet as j_fleet

    lib = fleet_lib if package == "port" else j_fleet
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Healthz)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    sup = lib.FleetSupervisor(n=1, base_dir=str(tmp_path))
    try:
        rep = lib.Replica(name="r0", journal_dir=str(tmp_path / "r0"),
                          cache_dir=str(tmp_path / "c"), events_path=None,
                          log_path=str(tmp_path / "r0.log"))
        rep.host, rep.port = "127.0.0.1", httpd.server_address[1]
        sup.replicas["r0"] = rep
        sup.router.add_replica("r0", rep.host, rep.port)
        sup.detector.add("r0")
        sup.probe_once()
        assert sup.router.ring.members == ["r0"]
        sup._deploying = "r0"
        sup.router.set_alive("r0", False)
        sup.probe_once()
        want = [] if package == "port" else ["r0"]
        assert sup.router.ring.members == want
        assert sup.detector.streak("r0") == 0 and not sup.detector.is_dead("r0")
    finally:
        sup.router.close()
        httpd.shutdown()
        httpd.server_close()


class _HeldFront(http.server.BaseHTTPRequestHandler):
    """A replica whose /healthz reports it idle and whose /v1/submit
    answers only once the test releases it: a submit proxied before the
    replica left the ring, still on its way when the drain begins."""

    entered: threading.Event
    release: threading.Event
    answered: list

    def do_GET(self):
        body = json.dumps({"status": "ok", "queued": 0, "in_flight": 0}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length") or 0))
        self.entered.set()
        self.release.wait(10)
        body = json.dumps({"type": "accepted", "request_id": "rid-0"}).encode()
        self.send_response(202)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        self.answered.append(time.monotonic())

    def log_message(self, *a):
        pass


@pytest.mark.parametrize("package", ["port", "jax"])
def test_a_drain_waits_for_submits_open_against_the_replica(tmp_path, package):
    """A submit the router proxied before the replica left the ring is
    answered before the port's drain ends (the replica has it queued when
    the drain probes), and none opens after it left; the JAX drain probes
    at once and ends with the submit still on its way, so the request
    would wait out the restart in the WAL."""
    from erasurehead_tpu.serve import fleet as j_fleet

    lib = fleet_lib if package == "port" else j_fleet
    handler = type("H", (_HeldFront,), dict(entered=threading.Event(),
                                             release=threading.Event(), answered=[]))
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    sup = lib.FleetSupervisor(n=1, base_dir=str(tmp_path))
    try:
        rep = lib.Replica(name="r0", journal_dir=str(tmp_path / "r0"),
                          cache_dir=str(tmp_path / "c"), events_path=None,
                          log_path=str(tmp_path / "r0.log"))
        rep.host, rep.port = "127.0.0.1", httpd.server_address[1]
        sup.replicas["r0"] = rep
        sup.router.add_replica("r0", rep.host, rep.port)
        raw = json.dumps({"tenant": "a", "label": "x", "config": {}}).encode()
        submit = threading.Thread(
            target=sup.router._proxy_submit, args=(["r0"], raw, None, "a"))
        submit.start()
        assert handler.entered.wait(10)
        sup.router.set_alive("r0", False)
        drained = []
        drain = threading.Thread(
            target=lambda: (sup._drain(rep, 10.0), drained.append(time.monotonic())))
        drain.start()
        drain.join(0.5)
        handler.release.set()
        drain.join(10)
        submit.join(10)
        assert drained and handler.answered
        if package == "port":
            assert handler.answered[0] <= drained[0]
            code, _, _ = sup.router._proxy_submit(["r0"], raw, None, "a")
            assert code == 503 and len(handler.answered) == 1
        else:
            assert drained[0] < handler.answered[0]
    finally:
        handler.release.set()
        sup.router.close()
        httpd.shutdown()
        httpd.server_close()


def test_a_replica_without_its_device_fails_the_fleet(tmp_path):
    """``device="cuda"`` where there is no card: the replica exits non-zero,
    the supervisor raises with the replica's own log, and no replica is
    started on the CPU instead."""
    with pytest.raises(ValueError, match="device"):
        fleet_lib.FleetSupervisor(n=1, base_dir=str(tmp_path / "x"), device="tpu")
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present: the replica would start on it")
    sup = fleet_lib.FleetSupervisor(n=1, base_dir=str(tmp_path), device="cuda")
    try:
        with pytest.raises(RuntimeError, match="exited") as ei:
            sup.start(probe=False)
        assert "CUDA" in str(ei.value) or "cuda" in str(ei.value)
        assert sup.replicas["r0"].proc.returncode != 0
        assert sup.router.ring.members == []
    finally:
        sup.stop()


_BUILD_SCRIPT = textwrap.dedent("""
    import os, sys, time
    from pathlib import Path
    from erasurehead_tpu_torch.ops import kernels
    nvcc, build, go = sys.argv[1], Path(sys.argv[2]), sys.argv[3]
    kernels._nvcc = lambda: nvcc
    kernels._BUILD_DIR = build
    while not os.path.exists(go):
        time.sleep(0.01)
    kernels._build()
    print("BUILDS", kernels.BUILDS)
""")


def test_two_processes_sharing_a_build_directory_build_once(tmp_path):
    """Two processes drive the real ``_build`` into one directory at once
    with a slow stand-in compiler: the directory lock makes one of them
    build (one compile per source plus one link) and the other load its
    library, which it finds when it gets the lock."""
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\necho x >> "' + str(calls) + '"\nsleep 1\n'
                    'while [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then : > "$2"; fi; shift\ndone\n')
    nvcc.chmod(0o755)
    build, go = tmp_path / "build", tmp_path / "go"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_SCRIPT, str(nvcc), str(build),
                               str(go)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    time.sleep(3.0)  # both import torch, then wait on the same go
    go.write_text("")
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    builds = sorted(int(o[0].split("BUILDS")[1]) for o in outs)
    assert builds == [0, 1]
    from erasurehead_tpu_torch.ops import kernels

    n_sources = len(kernels._SOURCES)
    assert len(calls.read_text().split()) == n_sources + 1
    files = sorted(f.name for f in build.iterdir())
    assert len(files) == 2 and files[0].endswith(".log") and files[1].endswith(".so")


# ---- a real fleet ----------------------------------------------------------


def _science(row) -> str:
    return json.dumps(journal_lib.science_row(row), sort_keys=True)


def test_cli_fleet_kill_and_adoption_drill(tmp_path):
    """``cli fleet --device cpu`` with two replicas and
    ``kill:fleet_replica:2`` armed on the replica the ring routes alice to:
    her first request is served, the next two are accepted and the replica
    dies in the dispatch; the supervisor declares it dead at a streak of K,
    its ring peer adopts its WAL, and every row reaches alice exactly once
    through the router, bitwise an in-process daemon's rows. SIGINT stops
    the fleet with exit 0, and every log validates."""
    from erasurehead_tpu_torch.serve import server as serve_server
    from erasurehead_tpu_torch.serve.queue import config_from_payload

    payloads = {label: {**CFG, "seed": s} for s, label in enumerate(("warm", "b", "c"))}
    victim = HashRing(["r0", "r1"]).lookup(affinity_key("alice", payloads["warm"]))
    base, sup_log = tmp_path / "fleet", tmp_path / "supervisor.jsonl"
    env = {k: v for k, v in os.environ.items() if k != chaos.CHAOS_ENV}
    proc = subprocess.Popen(
        [sys.executable, "-m", "erasurehead_tpu_torch.cli", "fleet", "--replicas", "2",
         "--device", "cpu", "--base-dir", str(base), "--events", str(sup_log),
         "--probe-interval", "0.2", "--window-ms", "20",
         "--chaos", f"{victim}=kill:fleet_replica:2"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: list = []
    ready = threading.Event()

    def drain():
        for line in proc.stdout:
            lines.append(line.rstrip())
            if line.startswith("fleet: replica r1 on"):
                ready.set()

    threading.Thread(target=drain, daemon=True).start()
    try:
        assert ready.wait(120), lines
        host, port = next(ln for ln in lines if ln.startswith("fleet: router on")).split()[3] \
            .rsplit(":", 1)
        client = HttpServeClient(host, int(port), "alice")
        rows, delivered = {}, 0
        client.submit("warm", payloads["warm"], max_retries=8)
        first = client.result(timeout=120)
        rows[first["label"]], delivered = first, 1
        client.submit("b", payloads["b"], max_retries=8)
        client.submit("c", payloads["c"], max_retries=8)
        deadline = time.monotonic() + 120
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
        client.close()
        assert sorted(rows) == ["b", "c", "warm"] and delivered == 3, (rows, lines[-20:])
        assert {r["status"] for r in rows.values()} == {"ok"}
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    sup = [json.loads(ln) for ln in open(sup_log)]
    deaths = [r for r in sup if r["type"] == "fleet" and r["action"] == "declare_dead"]
    assert [r["replica"] for r in deaths] == [victim] and deaths[0]["streak"] >= deaths[0]["k"] == 3
    peer = "r1" if victim == "r0" else "r0"
    peer_log = base / f"{peer}.events.jsonl"
    adopts = [r for r in map(json.loads, open(peer_log))
              if r["type"] == "fleet" and r["action"] == "adopt"]
    assert len(adopts) == 1 and adopts[0]["replica"] == victim and adopts[0]["records"] >= 1
    assert os.path.exists(base / victim / "intake_wal.jsonl.adopted")
    for p in (sup_log, peer_log, base / f"{victim}.events.jsonl"):
        assert events_lib.validate_file(str(p)) == [], p
    with serve_server.serving(device="cpu", window_s=0.01) as srv:
        want = {label: srv.submit(tenant="alice", label=label,
                                  config=config_from_payload(p)).result(timeout=120)
                for label, p in payloads.items()}
    for label, res in rows.items():
        got = _science(res["row"])
        assert got == json.dumps(journal_lib.science_row(journal_lib.summary_payload(
            want[label].summary)), sort_keys=True), label


def test_fleet_cli_refuses_a_bad_chaos_spec():
    with pytest.raises(SystemExit) as ei:
        fleet_lib.main(["--chaos", "r0=kill:nowhere:1"])
    assert ei.value.code == 2
    with pytest.raises(SystemExit):
        fleet_lib.main(["--chaos", "kill:fleet_replica:1"])
    assert dataclasses.asdict(chaos.parse_spec("kill:fleet_replica:2"))["site"] == "fleet_replica"
