"""HTTP/1.1 JSONL front: the serve daemon goes on the network.

The port of erasurehead_tpu/serve/http_front.py, whole: the same routes,
replies and records, so the JAX package's clients and the port's speak to
either daemon.

Stdlib only (``http.server`` threads — no new deps), riding the same
queue model as the AF_UNIX front (serve/queue.py), so the HTTP surface
can never accept a config the in-process surface would refuse:

  - ``POST /v1/submit`` — one JSON request body (``label``, ``config``,
    optional ``target_loss``/``data_seed``/``priority``/``retry``; the
    tenant comes from the bearer token when auth is on, the body when
    off). Replies: 202 ``{"request_id", "eta_s"}`` on acceptance, 400 on
    a refused payload, 401 on a bad token, and 429 with a ``Retry-After``
    header (plus the exact ``retry_after_s`` in the body) when the
    daemon's intake queue is at its high-water mark — backpressure is a
    first-class reply, never a hang.
  - ``GET /v1/stream`` — chunked transfer encoding, one JSON line per
    finished result for the authenticated tenant, written AS JOURNAL ROWS
    LAND. Each connection owns a BOUNDED outbox: a slow or wedged reader
    sheds rows (``{"type": "overflow", "dropped": n}`` marks the gap and
    a ``stream`` event journals it) instead of backing pressure up into
    the dispatch pool — the rows are journaled per tenant, so the client
    re-fetches by resubmitting (idempotent; rehydrates bitwise).
    ``{"type": "ping"}`` heartbeats flow when idle so half-open
    connections die at the writer, not in the kernel.
  - ``GET /healthz`` — queue depth, in-flight dispatches, uptime; the
    load generator and restart harnesses poll it for readiness.
  - ``GET /metrics`` — Prometheus text exposition (obs/exporter.py) of
    the process metrics registry plus the front's live timeseries
    gauges (obs/timeseries.py, attached in-process to the event
    stream). Unauthenticated like /healthz: it is the scrape surface.
  - ``GET /v1/stats`` — per-tenant JSON stats (requests, completed
    rows, rejects, SLO burn rate) for the authenticated tenant (or
    ``?tenant=`` with auth off).

Auth is per-tenant bearer tokens (a JSON ``{token: tenant}`` map): the
token *names* the tenant, so a client can only submit into — and stream
from — its own journal namespace. With auth off (trusted localhost, the
default), the body/query tenant is used
verbatim, matching the AF_UNIX front's filesystem-permission trust.
"""

from __future__ import annotations

import json
import queue as queue_lib
import select
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from erasurehead_tpu_torch.obs import events as events_lib
from erasurehead_tpu_torch.obs.metrics import REGISTRY as _METRICS
from erasurehead_tpu_torch.serve.queue import (
    ServeOverloadedError,
    ServeResult,
    config_from_payload,
)
from erasurehead_tpu_torch.serve.wal import WalAdoptionError

#: default bound on one stream connection's outbox (result lines queued
#: for a reader that hasn't drained them); beyond it rows are shed —
#: drop-and-journal, never block the dispatch pool
DEFAULT_OUTBOX_LIMIT = 256


def healthz_answers(hostport: str, timeout: float = 1.0) -> bool:
    """One /healthz probe of ``"host:port"``: True iff the daemon
    answered 200 within ``timeout``. The adoption guard (POST /v1/adopt
    with an ``owner``) and the fleet supervisor's membership probes both
    ride this — a refused connection, a timeout, or a non-200 all read
    as "did not answer", never as an exception."""
    import http.client

    host, port = parse_hostport(hostport)
    try:
        conn = http.client.HTTPConnection(host, port, timeout=timeout)
        try:
            conn.request("GET", "/healthz")
            return conn.getresponse().status == 200
        finally:
            conn.close()
    except OSError:
        return False


def parse_hostport(spec: str) -> tuple[str, int]:
    """``"HOST:PORT"`` (or bare ``"PORT"``) -> (host, port); port 0 asks
    the kernel for a free one."""
    host, sep, port = str(spec).rpartition(":")
    if not sep:
        host, port = "127.0.0.1", port or "0"
    try:
        return (host or "127.0.0.1", int(port))
    except ValueError:
        raise ValueError(
            f"--http wants HOST:PORT (or PORT), got {spec!r}"
        ) from None


class _QuietThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that doesn't traceback-spam on the normal
    fate of a streaming connection: the reader hangs up mid-write."""

    daemon_threads = True
    # socketserver's default accept backlog is 5 — a closed-loop load
    # burst (hundreds of concurrent clients) overflows it and the kernel
    # RESETS connections, which reads as daemon death. Size it for the
    # front's actual job.
    request_queue_size = 128

    def handle_error(self, request, client_address):
        import sys

        exc = sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError)):
            return
        super().handle_error(request, client_address)


class _Subscription:
    """One stream connection's bounded outbox + overflow accounting."""

    def __init__(self, tenant: str, limit: int):
        self.tenant = tenant
        self.q: "queue_lib.Queue[dict]" = queue_lib.Queue(maxsize=limit)
        self.dropped = 0  # rows shed since the last overflow marker
        self.total_dropped = 0
        self.lock = threading.Lock()


class StreamHub:
    """Fan-out of delivered results to per-connection bounded outboxes.

    ``publish`` is the server's result listener: it runs on the dispatch
    pool and NEVER blocks — a full outbox sheds the row (counted, marked
    in-stream, journaled as a ``stream`` overflow event) rather than
    slowing anyone else's dispatch."""

    def __init__(self, outbox_limit: int = DEFAULT_OUTBOX_LIMIT):
        self.outbox_limit = int(outbox_limit)
        self._subs: dict[int, _Subscription] = {}
        self._ids = 0
        self._lock = threading.Lock()

    def subscribe(self, tenant: str) -> tuple[int, _Subscription]:
        with self._lock:
            self._ids += 1
            sid = self._ids
            sub = _Subscription(tenant, self.outbox_limit)
            self._subs[sid] = sub
        events_lib.emit("stream", tenant=tenant, event="open")
        return sid, sub

    def unsubscribe(self, sid: int) -> None:
        with self._lock:
            sub = self._subs.pop(sid, None)
        if sub is not None:
            events_lib.emit(
                "stream",
                tenant=sub.tenant,
                event="close",
                dropped=sub.total_dropped,
            )

    def publish(self, result: ServeResult) -> None:
        line = {
            "type": "result",
            "request_id": result.request_id,
            "tenant": result.tenant,
            "label": result.label,
            "status": result.status,
            "row": result.row,
            "error": result.error,
            "resumed": result.resumed,
        }
        with self._lock:
            subs = [
                s for s in self._subs.values() if s.tenant == result.tenant
            ]
        for sub in subs:
            try:
                sub.q.put_nowait(line)
            except queue_lib.Full:
                with sub.lock:
                    first_of_burst = sub.dropped == 0
                    sub.dropped += 1
                    sub.total_dropped += 1
                _METRICS.counter("serve.stream_dropped").inc()
                if first_of_burst:
                    # one event per burst, not per shed row — the marker
                    # line carries the exact count once the reader drains
                    events_lib.emit(
                        "stream",
                        tenant=sub.tenant,
                        event="overflow",
                        dropped=sub.total_dropped,
                    )


class HttpFront:
    """HTTP listener bridging network clients onto a SweepServer."""

    def __init__(
        self,
        server,
        host: str = "127.0.0.1",
        port: int = 0,
        tokens: Optional[dict] = None,
        outbox_limit: int = DEFAULT_OUTBOX_LIMIT,
        slo_ttlr_s: Optional[float] = None,
        slo_budget: float = 0.1,
    ):
        from erasurehead_tpu_torch.obs import exporter as exporter_lib
        from erasurehead_tpu_torch.obs.timeseries import TimeseriesReducer

        self.server = server
        #: token -> tenant; None = auth off (trusted-localhost mode)
        self.tokens = dict(tokens) if tokens else None
        self.hub = StreamHub(outbox_limit)
        server.add_result_listener(self.hub.publish)
        # the live plane: a timeseries reducer rides the in-process event
        # stream (request/pack/admit/reject + any training capture) so
        # GET /metrics answers from windowed state, no file tail needed
        self.reducer = TimeseriesReducer()
        self._reducer_detach = self.reducer.attach()
        self.slo = (
            exporter_lib.SloTracker(
                slo_ttlr_s, budget=slo_budget
            )
            if slo_ttlr_s
            else None
        )
        if self.slo is not None:
            events_lib.add_observer(self.slo.observe)
        self._exporter = exporter_lib
        self._started = time.monotonic()
        front = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            server_version = "erasurehead-serve"

            def log_message(self, fmt, *args):  # noqa: D102 — quiet
                pass

            def _reply(self, code: int, obj: dict, headers=()):
                body = (json.dumps(obj) + "\n").encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _tenant(self) -> Optional[str]:
                """The authenticated tenant, or None after a 401 reply
                (auth on + bad/missing token). With auth off, the caller
                falls back to body/query tenant."""
                if front.tokens is None:
                    return ""
                auth = self.headers.get("Authorization", "")
                token = auth[7:] if auth.startswith("Bearer ") else None
                tenant = front.tokens.get(token) if token else None
                if tenant is None:
                    _METRICS.counter("serve.rejected").inc()
                    events_lib.emit(
                        "reject", tenant="unknown", reason="unauthorized"
                    )
                    self._reply(
                        401,
                        {"type": "error",
                         "message": "missing or unknown bearer token"},
                        headers=[("WWW-Authenticate", "Bearer")],
                    )
                    return None
                return tenant

            def do_POST(self):  # noqa: N802 — http.server API
                if self.path == "/v1/adopt":
                    self._adopt()
                    return
                if self.path != "/v1/submit":
                    self._reply(404, {"type": "error",
                                      "message": f"no route {self.path}"})
                    return
                tenant = self._tenant()
                if tenant is None:
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    msg = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(msg, dict):
                        raise ValueError("request body must be an object")
                    cfg = config_from_payload(msg.get("config") or {})
                    handle = front.server.submit(
                        tenant=tenant or msg.get("tenant"),
                        label=msg.get("label"),
                        config=cfg,
                        target_loss=msg.get("target_loss"),
                        data_seed=int(msg.get("data_seed", 0)),
                        priority=int(msg.get("priority", 0)),
                        retry=int(msg.get("retry", 0)),
                    )
                except ServeOverloadedError as e:
                    # delta-seconds must be >= 1 for the header; the body
                    # carries the exact quote for backoff arithmetic
                    self._reply(
                        429,
                        {"type": "rejected",
                         "retry_after_s": e.retry_after_s,
                         "message": str(e)},
                        headers=[(
                            "Retry-After",
                            str(max(1, int(e.retry_after_s + 0.999))),
                        )],
                    )
                    return
                except Exception as e:  # noqa: BLE001 — per-request
                    self._reply(
                        400,
                        {"type": "error",
                         "message": f"{type(e).__name__}: {e}"},
                    )
                    return
                self._reply(
                    202,
                    {"type": "accepted",
                     "request_id": handle.request_id,
                     "eta_s": handle.eta_s},
                )

            def _adopt(self) -> None:
                """``POST /v1/adopt`` — fleet seam (the serve fleet): the
                supervisor asks THIS replica to adopt a declared-dead
                peer's intake WAL. Body: ``{"path": <wal path>,
                "replica": <dead peer's name>, "owner": <"host:port" or
                null>}``. When ``owner`` is given, the adoption re-probes
                the owner's /healthz first and refuses if it answers —
                the final guard against adopting a live daemon's working
                set. 409 on refusal (already adopted / owner alive)."""
                if self._tenant() is None:
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    msg = json.loads(self.rfile.read(n) or b"{}")
                    path = msg.get("path")
                    if not isinstance(path, str) or not path:
                        raise ValueError("adopt body wants a WAL 'path'")
                    owner = msg.get("owner")
                    owner_alive = (
                        (lambda: healthz_answers(owner))
                        if owner
                        else None
                    )
                    out = front.server.adopt_wal(
                        path,
                        owner_alive=owner_alive,
                        dead_replica=str(
                            msg.get("replica") or "unknown"
                        ),
                    )
                except WalAdoptionError as e:
                    self._reply(
                        409,
                        {"type": "refused", "message": str(e)},
                    )
                    return
                except Exception as e:  # noqa: BLE001 — per-request
                    self._reply(
                        400,
                        {"type": "error",
                         "message": f"{type(e).__name__}: {e}"},
                    )
                    return
                self._reply(202, {"type": "adopted", **out})

            def do_GET(self):  # noqa: N802 — http.server API
                path, _, query = self.path.partition("?")
                if path == "/healthz":
                    with front.server._state_lock:
                        in_flight = front.server._in_flight
                    body = {
                        "status": "ok",
                        "queued": front.server.queued_depth(),
                        "in_flight": in_flight,
                        "admission": (
                            front.server.admission.pressure()
                        ),
                        "uptime_s": round(
                            time.monotonic() - front._started, 3
                        ),
                    }
                    # fleet gossip: who this replica is, where its WAL
                    # lives (the path a peer adopts on death), and how
                    # many peers' WALs it has adopted so far
                    if front.server.replica_name is not None:
                        body["replica"] = front.server.replica_name
                    if front.server.wal is not None:
                        body["wal_path"] = front.server.wal.path
                    body["adoptions"] = front.server.adoptions_total
                    self._reply(200, body)
                    return
                if path == "/metrics":
                    # the scrape surface: SLO windows are re-scored on
                    # scrape (emitting slo events the reducer folds in),
                    # then the registry + live gauges render as one
                    # deterministic text exposition
                    if front.slo is not None:
                        front.slo.evaluate()
                    body = front._exporter.render_prometheus(
                        _METRICS, front.reducer.gauges()
                    ).encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", front._exporter.PROM_CONTENT_TYPE
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if path not in ("/v1/stream", "/v1/stats"):
                    self._reply(404, {"type": "error",
                                      "message": f"no route {path}"})
                    return
                tenant = self._tenant()
                if tenant is None:
                    return
                if not tenant:
                    params = dict(
                        kv.partition("=")[::2]
                        for kv in query.split("&")
                        if kv
                    )
                    tenant = params.get("tenant", "")
                    if not tenant:
                        self._reply(
                            400,
                            {"type": "error",
                             "message": f"{path[4:]} wants ?tenant= "
                                        f"(or auth)"},
                        )
                        return
                if path == "/v1/stats":
                    self._reply(200, front.tenant_stats(tenant))
                    return
                self._stream(tenant)

            def _hung_up(self) -> bool:
                """Has the stream's reader closed its end? (It sends
                nothing after its request, so a readable socket reading
                empty is its close.)"""
                try:
                    ready, _, _ = select.select([self.connection], [], [], 0)
                    return bool(ready) and not self.connection.recv(
                        1, socket.MSG_PEEK
                    )
                except OSError:
                    return True

            def _chunk(self, obj: dict) -> None:
                data = (json.dumps(obj) + "\n").encode()
                self.wfile.write(
                    f"{len(data):x}\r\n".encode() + data + b"\r\n"
                )
                self.wfile.flush()

            def _stream(self, tenant: str) -> None:
                sid, sub = front.hub.subscribe(tenant)
                try:
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "application/jsonlines"
                    )
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    last_beat = time.monotonic()
                    while not front._closing:
                        try:
                            line = sub.q.get(timeout=0.2)
                        except queue_lib.Empty:
                            line = None
                        # the overflow marker rides AFTER the queue
                        # drains: the reader knows exactly where the gap
                        # is and how many rows to re-fetch
                        if line is None:
                            with sub.lock:
                                dropped, sub.dropped = sub.dropped, 0
                            if dropped:
                                self._chunk(
                                    {"type": "overflow",
                                     "dropped": dropped}
                                )
                                continue
                            if time.monotonic() - last_beat > 5.0:
                                self._chunk({"type": "ping"})
                                last_beat = time.monotonic()
                            elif self._hung_up():
                                break  # the reader closed: end now, not at the next ping
                            continue
                        self._chunk(line)
                        last_beat = time.monotonic()
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass  # reader went away; rows are journaled
                finally:
                    front.hub.unsubscribe(sid)

        self._closing = False
        self._httpd = _QuietThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="eh-serve-http",
            daemon=True,
        )
        self._thread.start()

    def tenant_stats(self, tenant: str) -> dict:
        """One tenant's live stats from the windowed reducer state: the
        ``GET /v1/stats`` body. Sums the retained windows (bounded, so
        this is a rolling horizon, not all-time) plus the latest SLO
        window if the tracker is armed."""
        snap = self.reducer.snapshot()
        totals = {"requests": 0, "rows_ok": 0, "done": 0, "rejects": 0}
        goodput = 0.0
        for w in snap["windows"]:
            tv = w["tenants"].get(tenant)
            if tv:
                for k in totals:
                    totals[k] += tv.get(k, 0)
        if snap["windows"]:
            last = snap["windows"][-1]["tenants"].get(tenant)
            if last:
                goodput = last["rows_ok"] / self.reducer.window_s
        out = {
            "tenant": tenant,
            "window_s": self.reducer.window_s,
            "horizon_s": self.reducer.window_s * len(snap["windows"]),
            **totals,
            "goodput_rows_per_sec": round(goodput, 4),
            "queued": self.server.queued_depth(),
        }
        slo_rec = (snap.get("slo") or {}).get(tenant)
        if self.slo is not None:
            rows = [r for r in self.slo.evaluate() if r["tenant"] == tenant]
            slo_rec = rows[0] if rows else slo_rec
        if slo_rec is not None:
            out["slo"] = {
                k: slo_rec[k]
                for k in (
                    "slo_s", "window_requests", "breaches", "burn_rate"
                )
                if k in slo_rec
            }
        return out

    def close(self) -> None:
        self._closing = True
        self._reducer_detach.detach()
        if self.slo is not None:
            events_lib.remove_observer(self.slo.observe)
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
