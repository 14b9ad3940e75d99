"""Clients for the serve daemon's network fronts.

The port of erasurehead_tpu/serve/client.py, whole: the wire protocol is
the JAX package's, so either package's clients talk to either daemon.

Two transports, one contract:

  - :class:`ServeClient` — newline-delimited JSON over the AF_UNIX
    socket (see server.SocketFront): one ``submit`` line per request,
    streamed ``result`` lines back as the daemon's packed dispatches
    land. A reader thread demultiplexes the responses, so any number of
    submissions may be in flight on one connection; results arrive in
    COMPLETION order — match them up by ``request_id`` (or ``label``).
  - :class:`HttpServeClient` — the HTTP/1.1 JSONL front
    (serve/http_front.py): ``POST /v1/submit`` per request plus one
    long-lived chunked ``GET /v1/stream`` connection the reader thread
    drains. Auth is a per-tenant bearer token.

Failure taxonomy (the part the reference's mpirun-and-pray lifecycle
never had):

  - **daemon death** raises :class:`ServeUnavailableError` naming the
    endpoint and the last event seen on the wire — never a raw
    ``queue.Empty`` or socket errno;
  - **backpressure** (socket ``rejected`` line / HTTP 429) raises
    :class:`ServeRejectedError` carrying the daemon's ``retry_after_s``
    quote — or, with ``max_retries > 0``, is retried in-client on a
    DETERMINISTIC capped-exponential schedule that honors the quote
    (``wait = max(retry_after_s, min(cap, base * 2**attempt))``, no
    jitter: a rejected request's resubmission is idempotent by digest,
    so synchronized retries cost duplicate 429s, not duplicate rows);
  - **a client-side wait timeout** stays ``queue.Empty`` (the daemon is
    alive, the result genuinely isn't ready); the server-side
    ``request_timeout_s`` knob turns a stalled dispatch into a typed
    error *result* instead.
"""

from __future__ import annotations

import json
import queue as queue_lib
import socket
import threading
import time
from typing import Optional


class ServeUnavailableError(RuntimeError):
    """The daemon went away (connect refused, connection dropped, or the
    reader hit EOF) — distinguishable from a result that merely isn't
    ready yet. ``endpoint`` names the socket path or URL; ``last_event``
    is the last wire message type seen before the drop (None = the
    connection never spoke)."""

    def __init__(self, endpoint: str, last_event: Optional[str],
                 detail: str = ""):
        self.endpoint = endpoint
        self.last_event = last_event
        msg = (
            f"serve daemon unavailable at {endpoint} "
            f"(last event seen: {last_event or 'none'})"
        )
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


class ServeRejectedError(RuntimeError):
    """Backpressure: the daemon answered 429/"rejected" instead of
    accepting. ``retry_after_s`` is the schedule quote to honor."""

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


def backoff_s(
    attempt: int,
    retry_after_s: Optional[float],
    base: float = 0.1,
    cap: float = 10.0,
) -> float:
    """The deterministic capped-exponential wait before retry number
    ``attempt`` (0-based): the daemon's retry-after quote wins when it is
    the longer, the exponential floor keeps a client whose quotes are
    stale from hammering, and the cap bounds the tail."""
    exp = min(cap, base * (2.0 ** attempt))
    return max(float(retry_after_s or 0.0), exp)


class ServeClient:
    """One connection to a serve daemon's unix socket — or a FLEET of
    them. ``path`` may be a single socket path or a list of paths: the
    client connects to the first reachable one in list order and, when
    the daemon behind it dies (:class:`ServeUnavailableError`), fails
    over to the NEXT endpoint in list order, wrapping — deterministic,
    so every client walks the same ring. An endpoint that quoted
    backpressure is embargoed for its own ``retry_after_s`` and
    deprioritized while the embargo holds (Retry-After is per endpoint:
    one overloaded replica never stalls submission to its peers). A
    submission is only re-sent when its ``accepted`` reply never
    arrived; acceptance is idempotent by request digest server-side, so
    failover cannot double-dispatch."""

    def __init__(self, path, timeout: Optional[float] = None):
        if isinstance(path, (str, bytes)):
            self.paths = [str(path)]
        else:
            self.paths = [str(p) for p in path]
        if not self.paths:
            raise ValueError("ServeClient wants at least one socket path")
        self._idx = 0
        self._timeout = timeout
        self.last_event: Optional[str] = None
        self._wlock = threading.Lock()
        self._accepted: "queue_lib.Queue[dict]" = queue_lib.Queue()
        self._results: "queue_lib.Queue[dict]" = queue_lib.Queue()
        self.rejected_total = 0  # 429/"rejected" replies seen
        self.retried_total = 0  # submissions re-sent after a rejection
        self.failovers_total = 0  # endpoint rotations after a drop
        #: endpoint -> monotonic instant before which its own 429 quote
        #: says not to bother it again
        self._not_before: dict[str, float] = {}
        self._sock: Optional[socket.socket] = None
        self._closed = threading.Event()
        self._closed.set()
        self._connect()

    @property
    def path(self) -> str:
        """The endpoint currently connected (or next to be tried)."""
        return self.paths[self._idx]

    def _connect(self) -> None:
        """Connect to an endpoint, walking the list in order from the
        current index (wrapping) — embargoed endpoints are tried LAST.
        Deterministic: the same list and the same failures produce the
        same walk. Raises when no endpoint is reachable."""
        order = [
            (self._idx + s) % len(self.paths)
            for s in range(len(self.paths))
        ]
        now = time.monotonic()
        ready = [
            i for i in order
            if self._not_before.get(self.paths[i], 0.0) <= now
        ]
        embargoed = [i for i in order if i not in ready]
        last_err: Optional[Exception] = None
        for idx in ready + embargoed:
            p = self.paths[idx]
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.settimeout(self._timeout)
            try:
                sock.connect(p)
            except OSError as e:
                sock.close()
                last_err = e
                continue
            closed = threading.Event()
            self._sock, self._closed, self._idx = sock, closed, idx
            threading.Thread(
                target=self._read_loop, args=(sock, closed),
                name="eh-serve-client", daemon=True,
            ).start()
            return
        raise ServeUnavailableError(
            ", ".join(self.paths),
            self.last_event,
            str(last_err) if last_err else "no reachable endpoint",
        )

    def _read_loop(self, sock: socket.socket,
                   closed: threading.Event) -> None:
        buf = b""
        try:
            while True:
                try:
                    chunk = sock.recv(1 << 16)
                except OSError:
                    return
                if not chunk:
                    return
                buf += chunk
                while b"\n" in buf:
                    raw, buf = buf.split(b"\n", 1)
                    if not raw.strip():
                        continue
                    try:
                        msg = json.loads(raw)
                    except json.JSONDecodeError:
                        continue
                    self.last_event = msg.get("type")
                    if msg.get("type") == "result":
                        self._results.put(msg)
                    else:  # accepted / rejected / error — submit replies
                        self._accepted.put(msg)
        finally:
            closed.set()

    def _unavailable(self, detail: str = "") -> ServeUnavailableError:
        return ServeUnavailableError(self.path, self.last_event, detail)

    def _send_await(self, line: str, timeout: Optional[float]) -> dict:
        """Send one submit line and await its accepted/rejected reply.
        The lock spans the send AND the reply: replies correlate purely
        by submit order, so two concurrent submitters must not each read
        the other's request_id."""
        with self._wlock:
            if self._closed.is_set():
                raise self._unavailable("connection closed")
            try:
                self._sock.sendall(line.encode())
            except OSError as e:
                raise self._unavailable(str(e)) from e
            deadline = (
                None if timeout is None else time.monotonic() + timeout
            )
            while True:
                try:
                    return self._accepted.get(timeout=0.2)
                except queue_lib.Empty:
                    if self._closed.is_set():
                        raise self._unavailable(
                            "connection closed while awaiting the "
                            "accepted reply"
                        ) from None
                    if deadline is not None and (
                        time.monotonic() >= deadline
                    ):
                        raise

    def submit(
        self,
        tenant: str,
        label: str,
        config: dict,
        target_loss: Optional[float] = None,
        data_seed: int = 0,
        timeout: Optional[float] = 30.0,
        priority: int = 0,
        max_retries: int = 0,
        backoff_base: float = 0.1,
        backoff_cap: float = 10.0,
    ) -> str:
        """Submit one trajectory request; returns its request_id.

        Raises RuntimeError when the daemon refuses the payload,
        :class:`ServeRejectedError` on backpressure once ``max_retries``
        deterministic capped-exponential attempts (honoring the daemon's
        retry-after quotes) are exhausted, and
        :class:`ServeUnavailableError` when the daemon is gone. Thread-
        safe: the accepted reply is correlated purely by submit order, so
        the lock spans the send AND the reply — two concurrent
        submitters must not each read the other's request_id."""
        for attempt in range(max_retries + 1):
            line = json.dumps(
                {
                    "op": "submit",
                    "tenant": tenant,
                    "label": label,
                    "config": config,
                    "target_loss": target_loss,
                    "data_seed": data_seed,
                    "priority": priority,
                    "retry": attempt,
                }
            ) + "\n"
            # failover ring: an unacknowledged submission re-sends to the
            # next endpoint in list order; one that WAS accepted returns
            # before ever reaching this loop again — no duplicate submit
            for hop in range(len(self.paths)):
                try:
                    reply = self._send_await(line, timeout)
                    break
                except ServeUnavailableError:
                    if hop == len(self.paths) - 1:
                        raise
                    self._idx = (self._idx + 1) % len(self.paths)
                    self.failovers_total += 1
                    self._connect()
            rtype = reply.get("type")
            if rtype == "accepted":
                # what-if ETA quote (daemon --eta-surface; None without
                # one): exposed on the client rather than the return
                # value so existing submit() callers keep their
                # request_id contract
                self.last_eta_s = reply.get("eta_s")
                return reply["request_id"]
            if rtype == "rejected":
                retry_after = float(reply.get("retry_after_s") or 0.0)
                # the quote embargoes THIS endpoint; a later failover
                # walk tries un-embargoed peers first
                self._not_before[self.path] = (
                    time.monotonic() + retry_after
                )
                self.rejected_total += 1
                if attempt < max_retries:
                    self.retried_total += 1
                    time.sleep(
                        backoff_s(
                            attempt, retry_after,
                            base=backoff_base, cap=backoff_cap,
                        )
                    )
                    continue
                raise ServeRejectedError(
                    reply.get("message", "serve daemon rejected the "
                              "request (overloaded)"),
                    retry_after_s=retry_after,
                )
            raise RuntimeError(
                f"serve daemon refused the request: "
                f"{reply.get('message', reply)}"
            )
        raise AssertionError("unreachable")  # loop always returns/raises

    def result(self, timeout: Optional[float] = None) -> dict:
        """The next finished trajectory (completion order, any of this
        connection's requests): {"request_id", "tenant", "label",
        "status", "row", "error", "resumed"}. Raises ``queue.Empty`` on
        a live-daemon timeout and :class:`ServeUnavailableError` when
        the daemon died with results still owed."""
        deadline = (
            None if timeout is None else time.monotonic() + timeout
        )
        while True:
            try:
                return self._results.get(timeout=0.2)
            except queue_lib.Empty:
                if self._closed.is_set() and self._results.empty():
                    raise self._unavailable(
                        "connection closed with results still owed "
                        "(rows are journaled; resubmit to re-fetch)"
                    ) from None
                if deadline is not None and time.monotonic() >= deadline:
                    raise

    def close(self) -> None:
        if self._sock is None:
            return
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


def _normalize_endpoints(host, port, endpoints) -> list:
    """``(host, port)`` or a LIST of endpoints -> ``[(host, port), ...]``.
    List elements may be ``(host, port)`` tuples or ``"host:port"``
    strings; a bare ``host`` that is itself a list is treated as the
    endpoint list (so ``HttpServeClient([...], tenant=...)`` reads
    naturally)."""
    if endpoints is None and not isinstance(host, (str, bytes)) and (
        host is not None
    ):
        endpoints, host = host, None
    if endpoints is not None:
        out = []
        for ep in endpoints:
            if isinstance(ep, (tuple, list)):
                h, p = ep
            else:
                h, _, p = str(ep).rpartition(":")
            out.append((str(h), int(p)))
        if not out:
            raise ValueError("HttpServeClient wants at least one endpoint")
        return out
    if host is None or port is None:
        raise ValueError(
            "HttpServeClient wants (host, port) or endpoints=[...]"
        )
    return [(str(host), int(port))]


class HttpServeClient:
    """One tenant's connection to the HTTP JSONL front — or a FLEET of
    fronts.

    ``submit`` POSTs per request (a fresh connection each time — the
    submit path is stateless, so daemon restarts are invisible to it
    beyond a retriable :class:`ServeUnavailableError`); ``result`` drains
    the long-lived chunked ``/v1/stream`` connections the reader threads
    own. Timing hooks for the load generator: ``on_line(msg)`` fires on
    every stream line as it is read.

    With ``endpoints=[...]`` (or the router's fleet view) the client
    holds ONE stream per endpoint — results land on whichever replica
    dispatched them — and ``submit`` fails over deterministically in
    list order on :class:`ServeUnavailableError`, honoring each
    endpoint's own Retry-After embargo. ``result`` deduplicates by
    request_id, so a row replayed by a WAL adoption is delivered exactly
    once."""

    def __init__(
        self,
        host=None,
        port=None,
        tenant: str = "",
        token: Optional[str] = None,
        timeout: float = 30.0,
        on_line=None,
        endpoints=None,
    ):
        self.endpoints = _normalize_endpoints(host, port, endpoints)
        self._ep_idx = 0
        self.host, self.port = self.endpoints[0]
        self.tenant = tenant
        self.token = token
        self.timeout = float(timeout)
        self.last_event: Optional[str] = None
        self.overflow_dropped = 0  # rows the daemon shed on our stream
        self._on_line = on_line
        self.rejected_total = 0  # 429 replies seen
        self.retried_total = 0  # submissions re-sent after a 429
        self.failovers_total = 0  # endpoint rotations after a drop
        #: endpoint index -> monotonic instant before which its own 429
        #: quote says not to bother it again
        self._not_before: dict[int, float] = {}
        self._results: "queue_lib.Queue[dict]" = queue_lib.Queue()
        self._delivered: set = set()  # request_ids handed to the caller
        self._closed = threading.Event()
        self._stop = False
        self._live_readers = len(self.endpoints)
        self._reader_lock = threading.Lock()
        self._stream_resps: list = [None] * len(self.endpoints)
        #: set once an endpoint's stream has answered (or failed): the
        #: constructor waits for them, so no row of a request submitted
        #: after it returns can be published before its stream listens
        #: (the JAX client returns at once)
        self._answered = [threading.Event() for _ in self.endpoints]
        self._readers = []
        for i, (h, p) in enumerate(self.endpoints):
            t = threading.Thread(
                target=self._stream_loop, args=(i, h, p),
                name=f"eh-serve-http-client-{i}", daemon=True,
            )
            t.start()
            self._readers.append(t)
        deadline = time.monotonic() + min(self.timeout, 10.0)
        for ev in self._answered:
            ev.wait(max(0.0, deadline - time.monotonic()))

    @property
    def endpoint(self) -> str:
        """The URL of the endpoint currently preferred for submission."""
        h, p = self.endpoints[self._ep_idx]
        return f"http://{h}:{p}"

    # ---- submit ----------------------------------------------------------

    def _headers(self) -> dict:
        h = {"Content-Type": "application/json"}
        if self.token is not None:
            h["Authorization"] = f"Bearer {self.token}"
        return h

    def submit(
        self,
        label: str,
        config: dict,
        target_loss: Optional[float] = None,
        data_seed: int = 0,
        priority: int = 0,
        max_retries: int = 0,
        backoff_base: float = 0.1,
        backoff_cap: float = 10.0,
    ) -> str:
        """POST one request; returns its request_id. 429s retry on the
        deterministic capped-exponential schedule honoring Retry-After
        (see :func:`backoff_s`); exhausted retries raise
        :class:`ServeRejectedError`; a dead daemon raises
        :class:`ServeUnavailableError` — unless a peer endpoint is
        configured, in which case the submission fails over to the next
        endpoint in list order (a request is only ever re-sent when no
        endpoint acknowledged it, and acceptance is idempotent by digest
        server-side, so failover cannot double-submit). Each endpoint's
        429 quote embargoes THAT endpoint; embargoed peers are skipped
        while the embargo holds."""
        import http.client

        for attempt in range(max_retries + 1):
            body = json.dumps(
                {
                    "tenant": self.tenant,
                    "label": label,
                    "config": config,
                    "target_loss": target_loss,
                    "data_seed": data_seed,
                    "priority": priority,
                    "retry": attempt,
                }
            )
            # one deterministic pass over the endpoint ring, starting at
            # the currently preferred endpoint
            last_exc = None
            pass_retry_after: Optional[float] = None
            saw_rejection = False
            for _hop in range(len(self.endpoints)):
                idx = self._ep_idx
                host, port = self.endpoints[idx]
                embargo = self._not_before.get(idx, 0.0) - time.monotonic()
                if embargo > 0 and len(self.endpoints) > 1:
                    # its own quote says not yet — try the next peer
                    pass_retry_after = (
                        embargo
                        if pass_retry_after is None
                        else min(pass_retry_after, embargo)
                    )
                    self._ep_idx = (idx + 1) % len(self.endpoints)
                    continue
                conn = http.client.HTTPConnection(
                    host, port, timeout=self.timeout
                )
                try:
                    conn.request(
                        "POST", "/v1/submit", body=body,
                        headers=self._headers(),
                    )
                    resp = conn.getresponse()
                    payload = json.loads(resp.read() or b"{}")
                except (OSError, http.client.HTTPException) as e:
                    # a reset/refused under burst load is transient
                    # (accept backlog, front mid-restart): rotate to the
                    # next endpoint — submission is idempotent by
                    # digest, so a resent acceptance can't
                    # double-dispatch
                    last_exc = e
                    if len(self.endpoints) > 1:
                        self._ep_idx = (idx + 1) % len(self.endpoints)
                        self.failovers_total += 1
                        continue
                    if attempt < max_retries and isinstance(
                        e, (ConnectionError, TimeoutError)
                    ):
                        break  # next attempt after the backoff below
                    raise ServeUnavailableError(
                        self.endpoint, self.last_event, str(e)
                    ) from e
                finally:
                    conn.close()
                if resp.status == 202:
                    self.last_eta_s = payload.get("eta_s")
                    return payload["request_id"]
                if resp.status == 429:
                    retry_after = float(
                        payload.get("retry_after_s")
                        or resp.getheader("Retry-After")
                        or 0.0
                    )
                    # the quote embargoes THIS endpoint only
                    self._not_before[idx] = (
                        time.monotonic() + retry_after
                    )
                    pass_retry_after = (
                        retry_after
                        if pass_retry_after is None
                        else min(pass_retry_after, retry_after)
                    )
                    self.rejected_total += 1
                    saw_rejection = True
                    if len(self.endpoints) > 1:
                        self._ep_idx = (idx + 1) % len(self.endpoints)
                        continue
                    break  # single endpoint: back off below
                raise RuntimeError(
                    f"serve daemon refused the request "
                    f"(HTTP {resp.status}): "
                    f"{payload.get('message', payload)}"
                )
            # the whole ring failed this pass: back off and re-walk, or
            # surface the typed error once attempts are exhausted
            if attempt < max_retries:
                if saw_rejection:
                    self.retried_total += 1
                time.sleep(
                    backoff_s(
                        attempt, pass_retry_after,
                        base=backoff_base, cap=backoff_cap,
                    )
                )
                continue
            if saw_rejection or (
                last_exc is None and pass_retry_after is not None
            ):
                raise ServeRejectedError(
                    "serve daemon rejected the request (overloaded)",
                    retry_after_s=pass_retry_after or 0.0,
                )
            raise ServeUnavailableError(
                self.endpoint,
                self.last_event,
                str(last_exc) if last_exc else "no reachable endpoint",
            ) from last_exc
        raise AssertionError("unreachable")

    # ---- result stream ---------------------------------------------------

    def _stream_loop(self, idx: int, host: str, port: int) -> None:
        """One endpoint's stream reader: all readers feed the one result
        queue (``result`` dedups by request_id). ``_closed`` is only set
        once EVERY endpoint's stream is dead — one dying replica doesn't
        strand a fleet client that still owes results from its peers."""
        import http.client

        try:
            path = "/v1/stream"
            if self.token is None:
                path += f"?tenant={self.tenant}"
            conn = http.client.HTTPConnection(
                host, port, timeout=max(self.timeout, 10.0)
            )
            conn.request("GET", path, headers=self._headers())
            resp = conn.getresponse()
            self._stream_resps[idx] = conn
            self._answered[idx].set()
            if resp.status != 200:
                return
            while not self._stop:
                raw = resp.readline()  # chunked decoding is transparent
                if not raw:
                    return
                try:
                    msg = json.loads(raw)
                except json.JSONDecodeError:
                    continue
                self.last_event = msg.get("type")
                if self._on_line is not None:
                    self._on_line(msg)
                if msg.get("type") == "result":
                    self._results.put(msg)
                elif msg.get("type") == "overflow":
                    # the daemon shed rows our reader was too slow for;
                    # they are journaled — re-fetch by resubmitting
                    self.overflow_dropped += int(msg.get("dropped", 0))
        except Exception:  # noqa: BLE001 — reader thread must not crash
            return
        finally:
            self._answered[idx].set()
            with self._reader_lock:
                self._live_readers -= 1
                if self._live_readers <= 0:
                    self._closed.set()

    def result(self, timeout: Optional[float] = None) -> dict:
        """The next finished trajectory off the stream(s); ``queue.Empty``
        on a live timeout, :class:`ServeUnavailableError` once every
        stream is dead and drained. Exactly-once per request_id: a row
        that reaches the client twice (WAL adoption replayed it on a
        peer whose stream we also hold) is delivered once."""
        deadline = (
            None if timeout is None else time.monotonic() + timeout
        )
        while True:
            try:
                msg = self._results.get(timeout=0.2)
            except queue_lib.Empty:
                if self._closed.is_set() and self._results.empty():
                    raise ServeUnavailableError(
                        self.endpoint, self.last_event,
                        "stream closed with results still owed (rows "
                        "are journaled; resubmit to re-fetch)",
                    ) from None
                if deadline is not None and time.monotonic() >= deadline:
                    raise
                continue
            rid = msg.get("request_id")
            if rid is not None:
                if rid in self._delivered:
                    continue  # duplicate via a second stream — drop
                self._delivered.add(rid)
            return msg

    def close(self) -> None:
        self._stop = True
        for conn in self._stream_resps:
            if conn is not None:
                # shut the socket down first: a reader thread blocked in
                # readline() then returns at once (closing alone waits for
                # the stream's next line, up to a heartbeat)
                sock = getattr(conn, "sock", None)
                if sock is not None:
                    try:
                        sock.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                try:
                    conn.close()
                except OSError:
                    pass
