"""Fleet router: one address in front of N serve replicas.

The port of erasurehead_tpu/serve/router.py. Stdlib only, same discipline
as the HTTP front it proxies (serve/http_front.py). Two pieces:

  - :class:`HashRing` — consistent hashing (sha256, ``VNODES`` virtual
    nodes per member) keyed by **(tenant, cohort_signature)**: requests
    that could PACK into one cohort dispatch hash to the same replica, so
    a replica's device data stacks stay hot for exactly the traffic that
    reuses them. Adding or removing one replica remaps only ~1/N of the
    key space (pinned by test) — a deploy bounce does not flush every
    replica's cache, it flushes one. The ring's hashes and order are the
    JAX package's for the same member names and key strings; the key
    strings themselves are the port's own (its cohort signature is its
    own), so the same request can route to another replica than under the
    JAX router.
  - :class:`FleetRouter` — a thin HTTP proxy: ``POST /v1/submit`` routes
    by affinity key to the primary replica and walks the DETERMINISTIC
    failover ring (the ring order after the primary) when a replica
    refuses the connection; ``GET /v1/stream`` fans IN every replica's
    stream for the tenant (re-dialing upstreams that bounce, so a
    rolling deploy doesn't strand a reader); ``/healthz``, ``/v1/fleet``
    and ``/metrics`` expose the membership table and fleet gauges.

The router holds NO request state: acceptance lives in each replica's
intake WAL, results in the per-tenant journals. Killing the router loses
nothing — clients re-resolve and resubmit (idempotent by digest).
Backpressure is passed through verbatim (429 + Retry-After), never
retried sideways: an overloaded replica is alive, and its quota is the
admission plane's business (serve/admission.py), not the router's. The
router never touches a device: computing a key builds a layout on the
host and nothing else.

Membership changes come from the fleet supervisor (serve/fleet.py):
``add_replica`` / ``remove_replica`` / ``set_alive`` mutate the ring
under a lock; in-flight proxies finish against the endpoints they
resolved, exactly like a DNS flip, and the router counts them per replica
so a drain can wait them out (none opens against a replica out of the
ring). A bounced replica (a known name at a
new endpoint) joins the ring only once every open stream has re-dialed it,
so no row it finishes is published before those streams listen.
"""

from __future__ import annotations

import bisect
import hashlib
import itertools
import json
import queue as queue_lib
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Optional

from erasurehead_tpu_torch.obs import events as events_lib
from erasurehead_tpu_torch.obs.metrics import REGISTRY as _METRICS

#: virtual nodes per ring member: enough that one member's share of the
#: key space is smooth (stddev ~ 1/sqrt(VNODES) of its mean share)
VNODES = 64

#: longest add_replica waits for open streams to re-dial a bounced replica
#: (their pumps re-dial every 0.5 s)
STREAM_REDIAL_WAIT_S = 5.0


def _hash(data: str) -> int:
    return int.from_bytes(
        hashlib.sha256(data.encode()).digest()[:8], "big"
    )


def affinity_key(tenant: str, config_payload: dict) -> str:
    """The routing key: (tenant, cohort_signature). Configs that would
    pack into one cohort (train/trainer.cohort_signature) route to one
    replica; unbatchable configs collapse onto the tenant alone. Falls
    back to the tenant when the payload cannot resolve — a misrouted
    BAD request costs nothing (the replica 400s it the same way). The
    signature's ``repr`` holds only strings, numbers and bytes, so the
    same payload gives the same key in every process."""
    sig = None
    try:
        from erasurehead_tpu_torch.serve.queue import config_from_payload
        from erasurehead_tpu_torch.train import trainer

        sig = trainer.cohort_signature(config_from_payload(config_payload))
    except Exception:  # noqa: BLE001 — routing must never 500 on a key
        sig = None
    return json.dumps([tenant, repr(sig)])


#: a pump's entry leaving the table (its stream ended)
_GONE = object()


class HashRing:
    """Consistent-hash ring over named members (sha256, VNODES virtual
    nodes each). ``lookup`` gives the primary; ``ring_order`` gives the
    full deterministic failover sequence for a key."""

    def __init__(self, members=(), vnodes: int = VNODES):
        self.vnodes = int(vnodes)
        self._members: set[str] = set()
        self._ring: list[tuple[int, str]] = []
        self._lock = threading.Lock()
        for m in members:
            self.add(m)

    @property
    def members(self) -> list[str]:
        with self._lock:
            return sorted(self._members)

    def __len__(self) -> int:
        with self._lock:
            return len(self._members)

    def add(self, member: str) -> None:
        member = str(member)
        with self._lock:
            if member in self._members:
                return
            self._members.add(member)
            for v in range(self.vnodes):
                self._ring.append((_hash(f"{member}#{v}"), member))
            self._ring.sort()

    def remove(self, member: str) -> None:
        member = str(member)
        with self._lock:
            if member not in self._members:
                return
            self._members.discard(member)
            self._ring = [(h, m) for h, m in self._ring if m != member]

    def lookup(self, key: str) -> Optional[str]:
        """The primary member for ``key`` (None on an empty ring)."""
        with self._lock:
            if not self._ring:
                return None
            i = bisect.bisect(self._ring, (_hash(key), ""))
            return self._ring[i % len(self._ring)][1]

    def ring_order(self, key: str) -> list[str]:
        """Every member, in the deterministic failover order for
        ``key``: the primary first, then each DISTINCT member as its
        first vnode appears walking the ring clockwise. Every client
        and the supervisor walk the same sequence, so \"the next live
        replica after the dead one\" is a single well-defined peer."""
        with self._lock:
            if not self._ring:
                return []
            start = bisect.bisect(self._ring, (_hash(key), ""))
            out: list[str] = []
            seen: set[str] = set()
            n = len(self._ring)
            for s in range(n):
                m = self._ring[(start + s) % n][1]
                if m not in seen:
                    seen.add(m)
                    out.append(m)
            return out


class FleetRouter:
    """The fleet's front door: consistent-hash submit proxy + fan-in
    stream proxy + membership/metrics surface."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 vnodes: int = VNODES):
        from erasurehead_tpu_torch.serve.http_front import (
            _QuietThreadingHTTPServer,
        )

        self.ring = HashRing(vnodes=vnodes)
        #: replica name -> {"host", "port", "alive", "pressure"}
        self.replicas: dict[str, dict] = {}
        self._lock = threading.Lock()
        self.redirects_total = 0  # proxies that left the primary
        self.adoptions_total = 0  # adoptions the supervisor commanded
        self._started = time.monotonic()
        self._closing = False
        #: stream pump id -> (replica, the endpoint it is subscribed at,
        #: None while it re-dials); add_replica waits on it
        self._pumps: dict[int, tuple] = {}
        self._pump_ids = itertools.count()
        self._pumps_changed = threading.Condition(self._lock)
        #: replica -> submit proxies open against it; a drain waits for 0
        self._open_proxies: dict[str, int] = {}
        self._proxies_changed = threading.Condition(self._lock)
        router = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            server_version = "erasurehead-fleet-router"

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

            def do_POST(self):  # noqa: N802 — http.server API
                if self.path != "/v1/submit":
                    self._reply(404, {"type": "error",
                                      "message": f"no route {self.path}"})
                    return
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                try:
                    msg = json.loads(raw or b"{}")
                    tenant = str(msg.get("tenant") or "")
                    key = affinity_key(tenant, msg.get("config") or {})
                except Exception as e:  # noqa: BLE001 — per-request
                    self._reply(400, {"type": "error",
                                      "message": f"bad body: {e}"})
                    return
                order = router.ring.ring_order(key)
                if not order:
                    self._reply(
                        503,
                        {"type": "error",
                         "message": "fleet has no live replicas"},
                        headers=[("Retry-After", "1")],
                    )
                    return
                auth = self.headers.get("Authorization")
                code, body, retry_after = router._proxy_submit(
                    order, raw, auth, tenant
                )
                headers = []
                if retry_after is not None:
                    headers.append(("Retry-After", retry_after))
                bs = body if body.endswith(b"\n") else body + b"\n"
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(bs)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(bs)

            def do_GET(self):  # noqa: N802 — http.server API
                path, _, query = self.path.partition("?")
                if path == "/healthz":
                    with router._lock:
                        live = [
                            n for n, r in router.replicas.items()
                            if r["alive"]
                        ]
                    self._reply(
                        200,
                        {
                            "status": "ok",
                            "role": "router",
                            "replicas_live": len(live),
                            "replicas": sorted(live),
                            "uptime_s": round(
                                time.monotonic() - router._started, 3
                            ),
                        },
                    )
                    return
                if path == "/v1/fleet":
                    self._reply(200, router.fleet_view())
                    return
                if path == "/metrics":
                    from erasurehead_tpu_torch.obs import exporter

                    body = exporter.render_prometheus(
                        _METRICS, router.fleet_gauges()
                    ).encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", exporter.PROM_CONTENT_TYPE
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if path == "/v1/stream":
                    params = dict(
                        kv.partition("=")[::2]
                        for kv in query.split("&")
                        if kv
                    )
                    tenant = params.get("tenant", "")
                    auth = self.headers.get("Authorization")
                    if not tenant and not auth:
                        self._reply(
                            400,
                            {"type": "error",
                             "message": "stream wants ?tenant= (or "
                                        "auth)"},
                        )
                        return
                    router._proxy_stream(self, tenant, auth)
                    return
                self._reply(404, {"type": "error",
                                  "message": f"no route {path}"})

        self._httpd = _QuietThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="eh-fleet-router",
            daemon=True,
        )
        self._thread.start()

    # ---- membership (mutated by the fleet supervisor) --------------------

    def add_replica(self, name: str, host: str, port: int) -> None:
        """Admit ``name`` at ``host:port``. A bounced replica (a known name
        at a new endpoint) joins the ring only once every open stream's
        pump has subscribed at its new endpoint (at most
        ``STREAM_REDIAL_WAIT_S``): a row it finished before a pump
        re-dialed would never reach that stream's reader (the JAX router
        admits at once)."""
        ep = (host, int(port))
        with self._pumps_changed:
            bounced = name in self.replicas
            self.replicas[name] = {
                "host": host, "port": int(port), "alive": True,
                "pressure": None,
            }
            if bounced:
                self._pumps_changed.wait_for(
                    lambda: all(
                        e == ep for n, e in self._pumps.values() if n == name
                    ),
                    timeout=STREAM_REDIAL_WAIT_S,
                )
        self.ring.add(name)

    def _set_pump(self, pid: int, name: str, ep) -> None:
        with self._pumps_changed:
            if ep is _GONE:
                self._pumps.pop(pid, None)
            else:
                self._pumps[pid] = (name, ep)
            self._pumps_changed.notify_all()

    def remove_replica(self, name: str) -> None:
        self.ring.remove(name)
        with self._lock:
            self.replicas.pop(name, None)

    def set_alive(self, name: str, alive: bool,
                  pressure=None) -> None:
        """Mark a replica routable or not WITHOUT forgetting it (the
        supervisor still knows its endpoints and WAL). Dead replicas
        leave the hash ring so no new keys resolve to them."""
        with self._lock:
            rec = self.replicas.get(name)
            if rec is None:
                return
            was = rec["alive"]
            rec["alive"] = bool(alive)
            if pressure is not None:
                rec["pressure"] = pressure
        if alive and not was:
            self.ring.add(name)
        elif was and not alive:
            self.ring.remove(name)

    def endpoint_of(self, name: str) -> Optional[tuple[str, int]]:
        with self._lock:
            rec = self.replicas.get(name)
            return (rec["host"], rec["port"]) if rec else None

    def _claim(self, name: str) -> Optional[tuple[str, int]]:
        """The endpoint to proxy a submit to, counted open until
        :meth:`_release`; None once the replica left the ring (a proxy
        that read the ring order before a drain walks on, so none opens
        after the drain began)."""
        with self._lock:
            rec = self.replicas.get(name)
            if rec is None or not rec["alive"]:
                return None
            self._open_proxies[name] = self._open_proxies.get(name, 0) + 1
            return (rec["host"], rec["port"])

    def _release(self, name: str) -> None:
        with self._proxies_changed:
            self._open_proxies[name] -= 1
            self._proxies_changed.notify_all()

    def wait_proxies(self, name: str, timeout: float) -> bool:
        """Wait until no submit proxy is open against ``name`` (bounded);
        True if none is. With the replica out of the ring, every request
        it will accept has then been answered, so it is in the replica's
        queue when the supervisor drains it."""
        with self._proxies_changed:
            return self._proxies_changed.wait_for(
                lambda: not self._open_proxies.get(name), timeout=timeout
            )

    def live_endpoints(self) -> list[tuple[str, int]]:
        """Every routable replica's (host, port) — the stream fan-in
        set, and what /v1/fleet hands a client that wants to hold its
        own per-replica connections."""
        with self._lock:
            return [
                (r["host"], r["port"])
                for _, r in sorted(self.replicas.items())
                if r["alive"]
            ]

    def fleet_view(self) -> dict:
        with self._lock:
            table = {
                name: {
                    "host": r["host"], "port": r["port"],
                    "alive": r["alive"], "pressure": r["pressure"],
                }
                for name, r in sorted(self.replicas.items())
            }
        return {
            "replicas": table,
            "ring": self.ring.members,
            "vnodes": self.ring.vnodes,
            "redirects_total": self.redirects_total,
            "adoptions_total": self.adoptions_total,
        }

    def fleet_gauges(self) -> dict:
        """The fleet's live gauge plane for /metrics (rendered through
        obs/exporter.render_prometheus alongside the counter
        registry)."""
        from erasurehead_tpu_torch.obs.exporter import fleet_gauges

        return fleet_gauges(self.fleet_view())

    # ---- proxying --------------------------------------------------------

    def _proxy_submit(self, order, raw: bytes, auth, tenant: str):
        """POST the raw submit body to the primary, walking the failover
        ring on CONNECTION failure (a dead replica), never on
        backpressure (an overloaded replica is alive — its 429 +
        Retry-After passes through verbatim). Returns (status, body,
        retry_after_header)."""
        import http.client

        headers = {"Content-Type": "application/json"}
        if auth:
            headers["Authorization"] = auth
        last_err = "no live replicas"
        for hop, name in enumerate(order):
            ep = self._claim(name)
            if ep is None:
                continue
            if hop > 0:
                self.redirects_total += 1
                _METRICS.counter("fleet.router_redirects").inc()
                events_lib.emit(
                    "fleet", action="route", replica=name,
                    tenant=tenant, hop=hop,
                )
            conn = http.client.HTTPConnection(
                ep[0], ep[1], timeout=30.0
            )
            try:
                conn.request("POST", "/v1/submit", body=raw,
                             headers=headers)
                resp = conn.getresponse()
                body = resp.read()
                return (
                    resp.status, body, resp.getheader("Retry-After")
                )
            except (OSError, http.client.HTTPException) as e:
                last_err = f"{name}: {type(e).__name__}: {e}"
                continue
            finally:
                conn.close()
                self._release(name)
        return (
            503,
            json.dumps(
                {"type": "error",
                 "message": f"no replica accepted the proxy: "
                            f"{last_err}"}
            ).encode(),
            "1",
        )

    def _proxy_stream(self, handler, tenant: str, auth) -> None:
        """Fan IN every replica's /v1/stream for the tenant into one
        chunked response. Upstream readers RE-DIAL on death (a bounced
        replica's replayed rows still reach the reader); the client
        dedups by request_id, so an adoption replay is exactly-once at
        the caller. The response starts once every routable replica's
        pump has subscribed (at most ``STREAM_REDIAL_WAIT_S``): a reader
        that submits as soon as its stream answers must not have a row
        published before the pump listens (the JAX router answers at
        once)."""
        import http.client

        q: "queue_lib.Queue[bytes]" = queue_lib.Queue(maxsize=1024)
        stop = threading.Event()

        def pump(name: str, pid: int) -> None:
            try:
                redial(pid, name)
            finally:
                self._set_pump(pid, name, _GONE)

        def redial(pid: int, name: str) -> None:
            while not stop.is_set() and not self._closing:
                ep = self.endpoint_of(name)
                if ep is None:
                    return  # removed from the fleet for good
                try:
                    conn = http.client.HTTPConnection(
                        ep[0], ep[1], timeout=10.0
                    )
                    path = "/v1/stream"
                    h = {}
                    if auth:
                        h["Authorization"] = auth
                    else:
                        path += f"?tenant={tenant}"
                    conn.request("GET", path, headers=h)
                    resp = conn.getresponse()
                    if resp.status != 200:
                        conn.close()
                        time.sleep(0.5)
                        continue
                    # the replica subscribes before it answers 200
                    self._set_pump(pid, name, ep)
                    while not stop.is_set():
                        raw = resp.readline()
                        if not raw:
                            break
                        try:
                            q.put(raw, timeout=1.0)
                        except queue_lib.Full:
                            pass  # slow reader: rows are journaled
                    conn.close()
                except OSError:
                    pass
                self._set_pump(pid, name, None)
                time.sleep(0.5)  # re-dial a bounced replica

        with self._lock:
            names = sorted(self.replicas)
        pids = {}
        for n in names:
            pids[n] = next(self._pump_ids)
            self._set_pump(pids[n], n, None)
        for n in names:
            threading.Thread(
                target=pump, args=(n, pids[n]), name=f"eh-router-pump-{n}",
                daemon=True,
            ).start()
        with self._pumps_changed:
            self._pumps_changed.wait_for(
                lambda: all(
                    self._pumps.get(pid, (n, None))[1] is not None
                    for n, pid in pids.items()
                    if self.replicas.get(n, {}).get("alive")
                ),
                timeout=STREAM_REDIAL_WAIT_S,
            )
        try:
            handler.send_response(200)
            handler.send_header("Content-Type", "application/jsonlines")
            handler.send_header("Transfer-Encoding", "chunked")
            handler.end_headers()
            last_beat = time.monotonic()
            while not self._closing:
                try:
                    raw = q.get(timeout=0.2)
                except queue_lib.Empty:
                    if time.monotonic() - last_beat > 5.0:
                        beat = b'{"type": "ping"}\n'
                        handler.wfile.write(
                            f"{len(beat):x}\r\n".encode() + beat
                            + b"\r\n"
                        )
                        handler.wfile.flush()
                        last_beat = time.monotonic()
                    continue
                handler.wfile.write(
                    f"{len(raw):x}\r\n".encode() + raw + b"\r\n"
                )
                handler.wfile.flush()
                last_beat = time.monotonic()
            handler.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass  # reader went away; rows are journaled
        finally:
            stop.set()

    def close(self) -> None:
        self._closing = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
