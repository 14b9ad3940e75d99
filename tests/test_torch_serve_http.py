"""The port's HTTP front, clients and load generator, and wire parity with
the JAX package's daemon, on the CPU.

Held here:
  - per-tenant bearer auth names the tenant (a body tenant cannot
    impersonate; a bad token is a 401 plus a ``reject`` record);
  - ``/healthz``, 404s, 400s, ``/v1/stats``, ``GET /metrics`` as Prometheus
    text holding the ``serve.*`` counters, ``POST /v1/adopt``;
  - backpressure: 429 with ``Retry-After``, then the client's backoff lands
    the request exactly once;
  - the stream hub's bounded outboxes shed to the journal without
    blocking;
  - wire parity: the JAX package's ``ServeClient``/``HttpServeClient`` get
    their rows from the port's fronts, the port's clients from the JAX
    package's, and both daemons' ``accepted``/``rejected``/``result`` lines
    carry the same keys;
  - the load generator's ledger (no loss, no duplicates) and its warm
    restart (bitwise rehydration, no new file in the build directory).

A test that asserts on a stream's records waits for them (the ``close``
record is emitted when the server side of the stream ends), never on a
sleep.
"""

import http.client
import json
import os
import queue as queue_lib
import re
import threading
import time

import pytest

from erasurehead_tpu.serve import client as j_client
from erasurehead_tpu.serve import http_front as j_http
from erasurehead_tpu.serve import server as j_server
from erasurehead_tpu_torch.obs import events as events_lib
from erasurehead_tpu_torch.obs.metrics import REGISTRY
from erasurehead_tpu_torch.ops import kernels as t_kernels
from erasurehead_tpu_torch.serve import loadgen
from erasurehead_tpu_torch.serve import server as serve_server
from erasurehead_tpu_torch.serve import wal as wal_lib
from erasurehead_tpu_torch.serve.client import (
    HttpServeClient,
    ServeClient,
    ServeRejectedError,
    ServeUnavailableError,
)
from erasurehead_tpu_torch.serve.http_front import (
    HttpFront,
    StreamHub,
    healthz_answers,
    parse_hostport,
)
from erasurehead_tpu_torch.serve.queue import ServeResult
from erasurehead_tpu_torch.train import cache
from erasurehead_tpu_torch.utils import chaos

W, R = 4, 10
CFG = {
    "scheme": "naive", "n_workers": W, "n_stragglers": 1, "rounds": R,
    "n_rows": 256, "n_cols": 16, "lr_schedule": 0.5, "add_delay": True,
    "compute_mode": "deduped",
}


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    monkeypatch.delenv(chaos.CHAOS_ENV, raising=False)
    monkeypatch.setattr(t_kernels, "_BUILD_DIR", t_kernels._BUILD_DIR)
    chaos.reset()
    cache.clear()
    yield
    cache.clear()
    chaos.reset()


def _serving(**kw):
    return serve_server.serving(device="cpu", **kw)


def _get(host, port, path, token=None, raw=False):
    conn = http.client.HTTPConnection(host, port, timeout=30)
    headers = {} if token is None else {"Authorization": f"Bearer {token}"}
    conn.request("GET", path, headers=headers)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp, (data.decode() if raw else json.loads(data or b"{}"))


def _post(host, port, path, payload, token=None):
    conn = http.client.HTTPConnection(host, port, timeout=30)
    headers = {"Content-Type": "application/json"}
    if token is not None:
        headers["Authorization"] = f"Bearer {token}"
    conn.request("POST", path, body=json.dumps(payload), headers=headers)
    resp = conn.getresponse()
    body = json.loads(resp.read() or b"{}")
    retry = resp.getheader("Retry-After")
    conn.close()
    return resp, body, retry


def _records(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def _wait_for(pred, timeout=30.0):
    """Poll ``pred`` until it is truthy (the records it reads are written
    by other threads); fail after ``timeout``."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.01)
    raise AssertionError("condition not met within the timeout")


class TestHttpFront:
    def test_auth_token_names_the_tenant(self, tmp_path):
        path = str(tmp_path / "ev.jsonl")
        with events_lib.capture(path):
            with _serving(window_s=0.01) as srv:
                front = HttpFront(srv, tokens={"tok-a": "alice"})
                try:
                    client = HttpServeClient(front.host, front.port, "alice", token="tok-a")
                    rid = client.submit("mine", CFG)
                    res = client.result(timeout=120)
                    assert (res["request_id"], res["tenant"], res["status"]) == (
                        rid, "alice", "ok")
                    # the body's tenant is ignored under auth
                    resp, body, _ = _post(front.host, front.port, "/v1/submit",
                                          {"tenant": "mallory", "label": "steal",
                                           "config": CFG}, token="tok-a")
                    assert resp.status == 202
                    assert client.result(timeout=120)["tenant"] == "alice"
                    resp, _, _ = _post(front.host, front.port, "/v1/submit",
                                       {"label": "x", "config": CFG}, token="nope")
                    assert resp.status == 401
                    resp, _ = _get(front.host, front.port, "/v1/stream")
                    assert resp.status == 401
                    client.close()
                    # the server side of the stream ends: its close record
                    _wait_for(lambda: any(r["type"] == "stream" and r["event"] == "close"
                                          for r in _records(path)))
                finally:
                    front.close()
        recs = _records(path)
        rejects = [r for r in recs if r["type"] == "reject"]
        assert rejects and all(r["reason"] == "unauthorized" for r in rejects)
        assert {s["event"] for s in recs if s["type"] == "stream"} >= {"open", "close"}
        assert events_lib.validate_file(path) == []

    def test_healthz_routes_stats_and_metrics(self, tmp_path):
        with _serving(window_s=0.01, journal_dir=str(tmp_path / "j"),
                      replica_name="r1") as srv:
            front = HttpFront(srv)
            try:
                host, port = front.host, front.port
                resp, body = _get(host, port, "/healthz")
                assert resp.status == 200 and body["status"] == "ok"
                assert body["queued"] == 0 and body["in_flight"] == 0
                assert body["admission"]["in_flight_bytes"] == 0
                assert body["replica"] == "r1" and body["wal_path"].endswith(wal_lib.WAL_NAME)
                assert healthz_answers(f"{host}:{port}")
                assert _get(host, port, "/nope")[0].status == 404
                resp, body, _ = _post(host, port, "/v1/submit",
                                      {"tenant": "t", "label": "bad",
                                       "config": {"warp_drive": 9}})
                assert resp.status == 400 and "unserveable" in body["message"]
                assert _get(host, port, "/v1/stream")[0].status == 400  # wants ?tenant=
                client = HttpServeClient(host, port, "t")
                client.submit("one", CFG)
                assert client.result(timeout=120)["status"] == "ok"
                client.close()
                resp, stats = _get(host, port, "/v1/stats?tenant=t")
                assert resp.status == 200 and stats["tenant"] == "t"
                assert stats["requests"] >= 1 and stats["rows_ok"] >= 1
                resp, text = _get(host, port, "/metrics", raw=True)
                assert resp.status == 200
                assert resp.getheader("Content-Type").startswith("text/plain")
            finally:
                front.close()
        # Prometheus text: every sample line is `name{labels} value`
        sample = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? -?[0-9.eE+-]+|NaN$")
        names = set()
        for line in text.splitlines():
            if not line or line.startswith("#"):
                continue
            assert sample.match(line), line
            names.add(line.split("{")[0].split(" ")[0])
        assert {"erasurehead_serve_requests", "erasurehead_serve_dispatches",
                "erasurehead_serve_results"} <= names
        assert not healthz_answers(f"{host}:{port}", timeout=0.5)

    def test_adopt_route(self, tmp_path):
        dead = wal_lib.IntakeWAL(str(tmp_path / "dead"))
        dead.append(tenant="t", request_id="t-req-dead", label="orphan", digest="d1",
                    config_payload=dict(CFG))
        dead.close()
        path = str(tmp_path / "ev.jsonl")
        with events_lib.capture(path):
            with _serving(window_s=0.01, journal_dir=str(tmp_path / "mine")) as srv:
                front = HttpFront(srv)
                try:
                    h, p = front.host, front.port
                    resp, body, _ = _post(h, p, "/v1/adopt", {"path": dead.path,
                                                              "replica": "dead", "owner": None})
                    assert resp.status == 202 and body["records"] == 1
                    resp, body, _ = _post(h, p, "/v1/adopt", {"path": dead.path})
                    assert resp.status == 409 and "already adopted" in body["message"]
                    assert _post(h, p, "/v1/adopt", {})[0].status == 400
                    restart = _wait_for(lambda: [r for r in _records(path)
                                                 if r["type"] == "restart"])
                finally:
                    front.close()
        assert restart[0]["wal_records"] == 1 and restart[0]["resubmitted"] == 1
        assert [r["action"] for r in _records(path) if r["type"] == "fleet"] == ["adopt"]

    def test_429_retry_after_then_client_backoff_lands(self, monkeypatch):
        """Past the high-water mark: 429 with a Retry-After header >= 1 and
        the exact quote in the body; the client with retries lands the same
        request once the stalled first dispatch ends."""
        monkeypatch.setenv(chaos.CHAOS_ENV, "stall:serve_dispatch:1:0.6")
        chaos.reset()
        with _serving(window_s=0.01, max_pending=1) as srv:
            front = HttpFront(srv)
            try:
                client = HttpServeClient(front.host, front.port, "t")
                rid1 = client.submit("first", CFG)
                resp, body, header_retry = _post(front.host, front.port, "/v1/submit",
                                                 {"tenant": "t", "label": "second",
                                                  "config": {**CFG, "seed": 1}})
                assert resp.status == 429 and body["type"] == "rejected"
                assert body["retry_after_s"] > 0 and int(header_retry) >= 1
                with pytest.raises(ServeRejectedError):
                    client.submit("second", {**CFG, "seed": 1})
                rid2 = client.submit("second", {**CFG, "seed": 1}, max_retries=20,
                                     backoff_base=0.05, backoff_cap=0.5)
                assert client.rejected_total >= 2
                got = {client.result(timeout=120)["request_id"] for _ in range(2)}
                assert got == {rid1, rid2}
                client.close()
            finally:
                front.close()

    def test_dead_front_raises_typed_unavailable(self):
        with _serving(window_s=0.01) as srv:
            front = HttpFront(srv)
            host, port = front.host, front.port
            client = HttpServeClient(host, port, "t")
            front.close()
        with pytest.raises(ServeUnavailableError, match=f"{port}"):
            client.submit("x", CFG)
        with pytest.raises(ServeUnavailableError):
            client.result(timeout=10)
        client.close()

    def test_parse_hostport(self):
        assert parse_hostport("0.0.0.0:8080") == ("0.0.0.0", 8080)
        assert parse_hostport("8080") == ("127.0.0.1", 8080)
        assert parse_hostport(":0") == ("127.0.0.1", 0)
        with pytest.raises(ValueError, match="HOST:PORT"):
            parse_hostport("nope:port")


class TestStreamHub:
    def _result(self, k: int) -> ServeResult:
        return ServeResult(request_id=f"t-req-{k}", tenant="t", label=f"r{k}",
                           status="ok", row={"k": k})

    def test_bounded_outbox_sheds_and_journals(self, tmp_path):
        path = str(tmp_path / "ev.jsonl")
        hub = StreamHub(outbox_limit=2)
        d0 = REGISTRY.counter("serve.stream_dropped").value
        with events_lib.capture(path):
            sid, sub = hub.subscribe("t")
            _, other = hub.subscribe("other")
            for k in range(5):
                hub.publish(self._result(k))
            assert sub.q.qsize() == 2 and sub.dropped == 3 and sub.total_dropped == 3
            assert other.q.qsize() == 0  # tenant-scoped fan-out
            hub.unsubscribe(sid)
        assert REGISTRY.counter("serve.stream_dropped").value == d0 + 3
        recs = [r for r in _records(path) if r["type"] == "stream"]
        assert len([r for r in recs if r["event"] == "overflow"]) == 1  # one a burst
        assert [r["dropped"] for r in recs if r["event"] == "close"] == [3]
        assert events_lib.validate_file(path) == []

    def test_publish_never_blocks(self):
        hub = StreamHub(outbox_limit=1)
        hub.subscribe("t")
        t0 = time.monotonic()
        for k in range(1000):
            hub.publish(self._result(k))
        assert time.monotonic() - t0 < 1.0  # shed, not blocked

    def test_overflow_marker_after_drain(self):
        hub = StreamHub(outbox_limit=1)
        _, sub = hub.subscribe("t")
        hub.publish(self._result(0))
        hub.publish(self._result(1))  # shed
        assert sub.q.get_nowait()["label"] == "r0"
        with sub.lock:
            dropped, sub.dropped = sub.dropped, 0
        assert dropped == 1
        with pytest.raises(queue_lib.Empty):
            sub.q.get_nowait()


# ---------------------------------------------------------------------------
# wire parity with the JAX package's daemon


RESULT_KEYS = {"type", "request_id", "tenant", "label", "status", "row", "error", "resumed"}


def _socket_lines(sock, payloads):
    """Raw submit lines over the unix socket; returns every reply line until
    each accepted request has its result."""
    import socket as socket_lib

    s = socket_lib.socket(socket_lib.AF_UNIX, socket_lib.SOCK_STREAM)
    s.connect(sock)
    s.settimeout(120)
    for p in payloads:
        s.sendall((json.dumps(p) + "\n").encode())
    lines, buf, accepted, results = [], b"", 0, 0
    while not lines or results < accepted or len(lines) < len(payloads):
        buf += s.recv(1 << 16)
        while b"\n" in buf:
            raw, buf = buf.split(b"\n", 1)
            msg = json.loads(raw)
            lines.append(msg)
            accepted += msg["type"] == "accepted"
            results += msg["type"] == "result"
    s.close()
    return lines


@pytest.mark.parametrize("daemon", ["port", "jax"])
def test_socket_reply_lines_have_the_same_keys(tmp_path, daemon):
    """accepted / error / result lines of either daemon carry the same keys."""
    sock = str(tmp_path / "eh.sock")
    mod = serve_server if daemon == "port" else j_server
    kw = {"device": "cpu"} if daemon == "port" else {}
    with mod.serving(window_s=0.01, max_cohort=2, **kw) as srv:
        front = mod.SocketFront(srv, sock)
        try:
            lines = _socket_lines(sock, [
                {"op": "submit", "tenant": "t", "label": "a", "config": CFG},
                {"op": "submit", "tenant": "t", "label": "b", "config": {"warp": 1}},
            ])
        finally:
            front.close()
    by_type = {m["type"]: set(m) for m in lines}
    assert by_type["accepted"] == {"type", "request_id", "eta_s"}
    assert by_type["error"] == {"type", "message"}
    assert by_type["result"] == RESULT_KEYS


@pytest.mark.parametrize("daemon", ["port", "jax"])
def test_rejected_lines_have_the_same_keys(tmp_path, monkeypatch, daemon):
    """A daemon at its high-water mark answers ``rejected`` with the same
    keys in both packages (the first dispatch held by a chaos stall: both
    read the same ERASUREHEAD_CHAOS)."""
    from erasurehead_tpu.utils import chaos as j_chaos

    monkeypatch.setenv(chaos.CHAOS_ENV, "stall:serve_dispatch:1:0.3")
    chaos.reset()
    j_chaos.reset()
    sock = str(tmp_path / "eh.sock")
    mod = serve_server if daemon == "port" else j_server
    kw = {"device": "cpu"} if daemon == "port" else {}
    with mod.serving(window_s=0.01, max_pending=1, **kw) as srv:
        front = mod.SocketFront(srv, sock)
        try:
            lines = _socket_lines(sock, [
                {"op": "submit", "tenant": "t", "label": "a", "config": CFG},
                {"op": "submit", "tenant": "t", "label": "b", "config": {**CFG, "seed": 1}},
            ])
        finally:
            front.close()
    rejected = [m for m in lines if m["type"] == "rejected"]
    assert rejected and set(rejected[0]) == {"type", "retry_after_s", "message"}


def test_jax_clients_get_rows_from_the_port_fronts(tmp_path):
    sock = str(tmp_path / "eh.sock")
    with _serving(window_s=0.01, max_cohort=2) as srv:
        sfront = serve_server.SocketFront(srv, sock)
        hfront = HttpFront(srv, tokens={"tok": "alice"})
        try:
            sc = j_client.ServeClient(sock)
            rid = sc.submit("bob", "jax-socket", CFG)
            res = sc.result(timeout=120)
            assert (res["request_id"], res["status"], res["row"]["label"]) == (
                rid, "ok", "jax-socket")
            sc.close()
            hc = j_client.HttpServeClient(hfront.host, hfront.port, "alice", token="tok")
            rid = hc.submit("jax-http", {**CFG, "seed": 3})
            res = hc.result(timeout=120)
            assert (res["request_id"], res["tenant"], res["status"]) == (rid, "alice", "ok")
            assert set(res) == RESULT_KEYS
            # the JAX client's own close waits for the stream's next line;
            # closing the front ends its stream instead
        finally:
            hfront.close()
            sfront.close()


def test_port_clients_get_rows_from_the_jax_fronts(tmp_path):
    sock = str(tmp_path / "eh.sock")
    with j_server.serving(window_s=0.01, max_cohort=2) as srv:
        sfront = j_server.SocketFront(srv, sock)
        hfront = j_http.HttpFront(srv)
        try:
            sc = ServeClient(sock)
            rid = sc.submit("bob", "port-socket", CFG)
            res = sc.result(timeout=300)
            assert (res["request_id"], res["status"], res["row"]["label"]) == (
                rid, "ok", "port-socket")
            sc.close()
            hc = HttpServeClient(hfront.host, hfront.port, "carol")
            rid = hc.submit("port-http", CFG)
            res = hc.result(timeout=300)
            assert (res["request_id"], res["tenant"], res["status"]) == (rid, "carol", "ok")
            assert set(res) == RESULT_KEYS
            hc.close()
        finally:
            hfront.close()
            sfront.close()


# ---------------------------------------------------------------------------
# the load generator


def test_percentile():
    from erasurehead_tpu.serve.loadgen import percentile as j_percentile

    assert loadgen.percentile([], 50) is None
    assert loadgen.percentile([3.0], 99) == 3.0
    xs = [float(x) for x in range(1, 101)]
    assert loadgen.percentile(xs, 50) == 51.0
    for p in (0, 1, 37.5, 50, 99, 100):
        assert loadgen.percentile(xs, p) == j_percentile(xs, p)


def _jobs(tenant, n):
    return [(f"{tenant}{k}", {**CFG, "seed": k}) for k in range(n)]


def test_run_fleet_ledger_no_loss_no_duplicates():
    """Three closed-loop tenants against a daemon that rejects past 2
    outstanding requests: every accepted request lands exactly once."""
    with _serving(window_s=0.01, max_cohort=4, max_pending=2) as srv:
        front = HttpFront(srv)
        try:
            out = loadgen.run_fleet(front.host, front.port,
                                    {t: _jobs(t, 4) for t in ("a", "b", "c")},
                                    concurrency=2, timeout=120)
        finally:
            front.close()
    assert out["lost"] == 0 and out["duplicates"] == 0
    for led in out["tenants"].values():
        assert led["rows"] == led["accepted"] == 4 and led["errors"] == 0
        assert {r["status"] for r in led["rows_by_label"].values()} == {"ok"}
    assert out["rejected_429s"] > 0 and out["latency_p50_s"] is not None


class _ReplayingClient:
    """A stand-in HttpServeClient whose tenant stream first carries a row
    of an earlier run (what a restarted replica's WAL replay republishes),
    then each submitted request's row."""

    def __init__(self, host, port, tenant, token=None):
        import queue as queue_lib

        self.tenant, self.n = tenant, 0
        self.rejected_total = self.retried_total = self.overflow_dropped = 0
        self.lines = queue_lib.Queue()
        self.lines.put({"request_id": "earlier-run-0", "label": "old0", "status": "ok",
                        "row": {}})

    def submit(self, label, cfg, max_retries=8, priority=0):
        rid = f"{self.tenant}-{self.n}"
        self.n += 1
        self.lines.put({"request_id": rid, "label": label, "status": "ok", "row": {}})
        return rid

    def result(self, timeout=None):
        return self.lines.get(timeout=timeout)

    def close(self):
        pass


def test_run_tenant_skips_rows_it_did_not_submit(monkeypatch):
    """A row of a request id the run never submitted is not the run's: it
    neither counts as a row nor closes the closed loop early, so every
    accepted request still lands (the JAX ledger counts it as one of its
    rows and closes before the last request's row)."""
    import erasurehead_tpu.serve.loadgen as j_loadgen

    jobs = _jobs("a", 3)
    monkeypatch.setattr(loadgen, "HttpServeClient", _ReplayingClient)
    led = loadgen.run_tenant("127.0.0.1", 0, "a", jobs, concurrency=1, timeout=5)
    assert (led["accepted"], led["rows"], led["lost"], led["duplicates"]) == (3, 3, 0, 0)
    assert sorted(led["rows_by_label"]) == [label for label, _ in jobs]
    assert len(led["latencies_s"]) == 3
    monkeypatch.setattr(j_loadgen, "HttpServeClient", _ReplayingClient)
    j_led = j_loadgen.run_tenant("127.0.0.1", 0, "a", jobs, concurrency=1, timeout=5)
    assert (j_led["accepted"], j_led["rows"]) == (3, 3)
    assert sorted(j_led["rows_by_label"]) == ["a0", "a1", "old0"]


def test_restart_run_rehydrates_bitwise_with_no_new_build(tmp_path):
    jdir, cdir = str(tmp_path / "j"), str(tmp_path / "build")

    def make_front():
        srv = serve_server.SweepServer(window_s=0.01, journal_dir=jdir, cache_dir=cdir,
                                       device="cpu").start()
        front = HttpFront(srv)

        def close():
            front.close()
            srv.stop()

        return srv, front, front.host, front.port, close

    out = loadgen.restart_run(make_front, {"a": _jobs("a", 2), "b": _jobs("b", 2)},
                              cdir, concurrency=2, timeout=120)
    assert out["rows_first"] == out["rows_resubmitted"] == 4
    assert out["resumed"] == 4 and out["bitwise_mismatches"] == 0
    assert out["new_build_files"] == 0
