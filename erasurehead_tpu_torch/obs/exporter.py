"""Prometheus text exposition, SLO burn-rate tracking, and the live
``top`` renderer — the scrape-facing edge of the telemetry plane.

The port of erasurehead_tpu/obs/exporter.py: the same text for the same
registry state and records.

Three surfaces over the same data:

  - :func:`render_prometheus` — text-format (version 0.0.4) exposition
    of a :class:`~erasurehead_tpu_torch.obs.metrics.MetricsRegistry` plus any
    flat gauge map (obs/timeseries.TimeseriesReducer.gauges), served by
    ``GET /metrics`` on the serve HTTP front. Hand-rolled: the
    no-new-deps discipline (serve/http_front.py) applies to exporters
    too. Metric names sanitize to ``[a-zA-Z_:][a-zA-Z0-9_:]*`` under an
    ``erasurehead_`` prefix; label values escape ``\\``, ``"`` and
    newlines per the exposition spec; families and lines render in
    sorted order so two scrapes of the same state are byte-identical.
  - :class:`SloTracker` — per-tenant time-to-last-row SLO scoring over
    the ``request`` intake/done record pairs, emitting typed ``slo``
    events with the window's burn rate (breach fraction over error
    budget; > 1 = the budget is burning faster than allowed).
  - :func:`top_main` — ``erasurehead-tpu top <events.jsonl|url>``: a
    live follow renderer over the timeseries reducer (or a remote
    daemon's /metrics text), refreshing a one-screen summary.

Everything is host-side and read-only over already-emitted records: the
observation-only contract is untouched.
"""

from __future__ import annotations

import json
import re
import sys
import threading
import time
from collections import OrderedDict, deque
from typing import Optional

from erasurehead_tpu_torch.obs import events as events_lib
from erasurehead_tpu_torch.obs import metrics as metrics_lib

#: the exposition content type GET /metrics answers with
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: prefix every exported metric family carries
PROM_PREFIX = "erasurehead_"

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_name(name: str) -> str:
    """Dotted registry names -> valid Prometheus metric names."""
    out = _NAME_OK.sub("_", str(name))
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def escape_label_value(v) -> str:
    """Escape a label value per the text exposition format."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def prom_key(name: str, **labels) -> str:
    """Build a ``name{k="v",...}`` series key with escaped values and
    sorted labels (the convention timeseries gauges use)."""
    base = sanitize_name(name)
    if not labels:
        return base
    inner = ",".join(
        f'{sanitize_name(k)}="{escape_label_value(v)}"'
        for k, v in sorted(labels.items())
    )
    return f"{base}{{{inner}}}"


def _family_of(series_key: str) -> str:
    """The metric family a (possibly labeled) series key belongs to."""
    return series_key.split("{", 1)[0]


def _fmt_value(v) -> str:
    f = float(v)
    if f != f:  # NaN
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(
    registry: Optional[metrics_lib.MetricsRegistry] = None,
    gauges: Optional[dict] = None,
    prefix: str = PROM_PREFIX,
) -> str:
    """Render the registry + extra gauges as Prometheus text exposition.

    ``gauges`` maps series keys (plain names or ``prom_key`` outputs) to
    float values. Histograms export as summaries (quantile series +
    ``_sum``/``_count``). Output order is deterministic: families sorted
    by name, series sorted within each family.
    """
    families: dict = {}  # prefixed family -> (type, [(series_key, value)])

    def add(family: str, kind: str, series_key: str, value) -> None:
        fam = families.setdefault(family, (kind, []))
        fam[1].append((series_key, value))

    if registry is not None:
        for name, kind, exported in registry.export_typed():
            fam = prefix + sanitize_name(name)
            if kind == "histogram":
                if exported.get("count", 0):
                    for q in ("p50", "p90", "p99"):
                        v = exported.get(q)
                        if v is not None:
                            add(
                                fam, "summary",
                                f'{fam}{{quantile="0.{q[1:]}"}}', v,
                            )
                add(fam + "_sum", "counter", fam + "_sum",
                    exported.get("sum", 0.0))
                add(fam + "_count", "counter", fam + "_count",
                    exported.get("count", 0))
            else:
                add(fam, kind, fam, exported)
    for key, value in (gauges or {}).items():
        base = _family_of(key)
        fam = prefix + sanitize_name(base)
        series = fam + key[len(base):]  # re-attach any label block
        add(fam, "gauge", series, value)

    lines = []
    for fam in sorted(families):
        kind, series = families[fam]
        lines.append(f"# TYPE {fam} {kind}")
        for key, value in sorted(series):
            lines.append(f"{key} {_fmt_value(value)}")
    return "\n".join(lines) + "\n"


def fleet_gauges(view: dict) -> dict:
    """The serve fleet's gauge plane from a router membership view
    (serve/router.FleetRouter.fleet_view): how many replicas are
    routable vs merely known, how many proxies had to leave their
    primary, how many dead peers' WALs were adopted, and each live
    replica's admission pressure — series keys ready for
    :func:`render_prometheus`."""
    replicas = view.get("replicas") or {}
    out = {
        prom_key("fleet_replicas_live"): sum(
            1 for r in replicas.values() if r.get("alive")
        ),
        prom_key("fleet_replicas_known"): len(replicas),
        prom_key("fleet_router_redirects_total"): int(
            view.get("redirects_total") or 0
        ),
        prom_key("fleet_adoptions_total"): int(
            view.get("adoptions_total") or 0
        ),
    }
    for name, r in sorted(replicas.items()):
        if r.get("pressure") is not None:
            out[prom_key("fleet_replica_pressure", replica=name)] = (
                float(r["pressure"])
            )
    return out


# ---------------------------------------------------------------------------
# SLO tracking: per-tenant time-to-last-row burn rate


class SloTracker:
    """Score per-tenant time-to-last-row against an SLO and emit typed
    ``slo`` burn-rate events.

    Feed it the event stream (:meth:`observe` accepts every record and
    reads only ``request`` intake/done pairs); call :meth:`evaluate`
    periodically. The burn rate is the classic SRE quantity: the
    window's breach fraction divided by the error budget — 1.0 means
    the tenant is burning budget exactly at the allowed rate, above
    that the ``slo`` event doubles as the warning (consumers alert on
    ``burn_rate > 1``). Bounded memory: at most ``max_open`` open
    requests and one window of completions are retained.
    """

    def __init__(
        self,
        slo_ttlr_s: float,
        *,
        budget: float = 0.1,
        window_s: float = 60.0,
        max_open: int = 4096,
    ):
        if slo_ttlr_s <= 0:
            raise ValueError(f"slo_ttlr_s must be > 0, got {slo_ttlr_s}")
        if not 0 < budget <= 1:
            raise ValueError(f"budget must be in (0, 1], got {budget}")
        self.slo_ttlr_s = float(slo_ttlr_s)
        self.budget = float(budget)
        self.window_s = float(window_s)
        self.max_open = int(max_open)
        self._lock = threading.Lock()
        self._open: OrderedDict = OrderedDict()  # request_id -> (tenant, t)
        self._done: deque = deque()  # (t_done, tenant, ttlr_s)

    def observe(self, rec: dict) -> None:
        if rec.get("type") != "request":
            return
        rid = rec.get("request_id")
        tenant = rec.get("tenant")
        t = rec.get("t")
        if not isinstance(rid, str) or not isinstance(t, (int, float)):
            return
        with self._lock:
            if rec.get("phase") == "done":
                start = self._open.pop(rid, None)
                if start is not None:
                    self._done.append((t, start[0], t - start[1]))
            else:
                self._open[rid] = (tenant or "?", float(t))
                while len(self._open) > self.max_open:
                    self._open.popitem(last=False)

    def observe_submit(self, request_id: str, tenant: str, t=None):
        """Programmatic intake (serve daemons without a capture)."""
        self.observe({
            "type": "request", "request_id": request_id,
            "tenant": tenant, "label": "",
            "t": time.time() if t is None else t,
        })

    def observe_done(self, request_id: str, t=None) -> None:
        with self._lock:
            start = self._open.pop(request_id, None)
            if start is not None:
                now = time.time() if t is None else t
                self._done.append((now, start[0], now - start[1]))

    def evaluate(self, now: Optional[float] = None) -> list:
        """Per-tenant window scores; emits one ``slo`` event per tenant
        that completed requests in the window. Returns the payloads."""
        now = time.time() if now is None else now
        with self._lock:
            while self._done and self._done[0][0] < now - self.window_s:
                self._done.popleft()
            per_tenant: dict = {}
            for _, tenant, ttlr in self._done:
                reqs, breaches, worst = per_tenant.get(
                    tenant, (0, 0, 0.0)
                )
                per_tenant[tenant] = (
                    reqs + 1,
                    breaches + (1 if ttlr > self.slo_ttlr_s else 0),
                    max(worst, ttlr),
                )
        out = []
        for tenant in sorted(per_tenant):
            reqs, breaches, worst = per_tenant[tenant]
            burn = (breaches / reqs) / self.budget if reqs else 0.0
            payload = {
                "tenant": tenant,
                "slo_s": round(self.slo_ttlr_s, 6),
                "window_requests": reqs,
                "breaches": breaches,
                "burn_rate": round(burn, 4),
                "worst_ttlr_s": round(worst, 6),
                "budget": self.budget,
            }
            events_lib.emit("slo", **payload)
            out.append(payload)
        return out


# ---------------------------------------------------------------------------
# the `erasurehead-tpu top` live follow renderer


def _render_frame(snap: dict, source: str, slo_rows: list) -> str:
    """One screenful from a reducer snapshot."""
    lines = [
        f"erasurehead-tpu top — {source}   "
        f"events {snap['consumed']} ({snap['malformed']} malformed)"
    ]
    windows = snap.get("windows") or []
    if windows:
        w = windows[-1]

        def fmt(v, spec="{:.4g}"):
            return spec.format(v) if v is not None else "-"

        arr = w["arrival"]
        lines.append(
            f"rounds/s wall {fmt(w['rounds_per_wall_sec'])} | "
            f"sim {fmt(w['rounds_per_sim_sec'])} | arrival p50/p90/p99 "
            f"{fmt(arr['p50'])}/{fmt(arr['p90'])}/{fmt(arr['p99'])}s"
        )
        lines.append(
            f"decode err {fmt(w['decode_error_mean'], '{:.3e}')} "
            f"(exact {fmt(w['decode_exact_share'])}) | staleness share "
            f"{fmt(w['staleness_share'])} | cache hits exec "
            f"{fmt(w['compile_cache_hit_rate'])} data "
            f"{fmt(w['data_cache_hit_rate'])} | prefetch "
            f"{fmt(w['prefetch_bytes_per_sec'], '{:.3g}')} B/s"
        )
        if w["tenants"]:
            lines.append("tenant            requests  rows_ok  rejects")
            for tenant, tv in w["tenants"].items():
                lines.append(
                    f"  {tenant[:16]:16s} {tv['requests']:>7d} "
                    f"{tv['rows_ok']:>8d} {tv['rejects']:>8d}"
                )
    cp = snap.get("critical_path")
    if cp:
        from erasurehead_tpu_torch.obs import critical_path as cp_lib

        lines.append("critical path:")
        lines.extend(cp_lib.render_lines(cp))
    reg = snap.get("regime")
    if reg:
        shift = (
            f" (shift @ round {reg['shift_round']})"
            if reg.get("shift_round") is not None
            else ""
        )
        lines.append(
            f"regime: {reg.get('kind')} rate={reg.get('rate')}/s "
            f"tail_index={reg.get('tail_index')}{shift}"
        )
    for row in slo_rows:
        state = "BURNING" if row["burn_rate"] > 1.0 else "ok"
        lines.append(
            f"slo[{row['tenant']}]: ttlr<={row['slo_s']}s "
            f"{row['breaches']}/{row['window_requests']} breached, "
            f"burn {row['burn_rate']:.2f} ({state})"
        )
    return "\n".join(lines)


def _top_url(url: str, interval_s: float, follow: bool) -> int:
    """Remote mode: poll a daemon's /metrics and echo the exposition."""
    from urllib.request import urlopen

    target = url.rstrip("/")
    if not target.endswith("/metrics"):
        target += "/metrics"
    while True:
        try:
            with urlopen(target, timeout=10.0) as resp:
                body = resp.read().decode()
        except OSError as e:
            print(f"top: {target}: {e}", file=sys.stderr)
            return 1
        if follow:
            sys.stdout.write("\x1b[2J\x1b[H")
        ts = time.strftime("%H:%M:%S")
        sys.stdout.write(f"# scrape {target} @ {ts}\n{body}")
        sys.stdout.flush()
        if not follow:
            return 0
        time.sleep(interval_s)


def top_main(argv: Optional[list] = None) -> int:
    """``erasurehead-tpu top <events.jsonl|url>``: live telemetry view.

    File mode tails the log through the timeseries reducer (``--follow``
    keeps watching a growing file); URL mode polls a serve daemon's
    ``/metrics``. ``--slo-ttlr SECONDS`` arms the SLO tracker, which
    emits ``slo`` burn-rate events into the current capture (if any)
    and renders per-tenant burn lines."""
    import argparse

    p = argparse.ArgumentParser(
        prog="erasurehead-tpu-torch top",
        description="live telemetry over an events.jsonl or daemon URL",
    )
    p.add_argument("source", help="events.jsonl path or http://host:port")
    p.add_argument(
        "--follow", action="store_true",
        help="keep tailing/polling (default: one frame and exit)",
    )
    p.add_argument("--interval", type=float, default=2.0)
    p.add_argument(
        "--window", type=float, default=5.0,
        help="reducer window seconds",
    )
    p.add_argument(
        "--slo-ttlr", type=float, default=None, metavar="SECONDS",
        help="time-to-last-row SLO; emits per-tenant slo burn events",
    )
    p.add_argument(
        "--slo-budget", type=float, default=0.1,
        help="allowed breach fraction behind the burn rate",
    )
    args = p.parse_args(argv)

    if args.source.startswith(("http://", "https://")):
        return _top_url(args.source, args.interval, args.follow)

    from erasurehead_tpu_torch.obs.timeseries import TimeseriesReducer

    red = TimeseriesReducer(window_s=args.window)
    slo = (
        SloTracker(args.slo_ttlr, budget=args.slo_budget)
        if args.slo_ttlr
        else None
    )
    next_frame = 0.0

    def frame():
        rows = slo.evaluate() if slo else []
        out = _render_frame(red.snapshot(), args.source, rows)
        if args.follow:
            sys.stdout.write("\x1b[2J\x1b[H")
        sys.stdout.write(out + "\n")
        sys.stdout.flush()

    try:
        for rec in red.tail(
            args.source, follow=args.follow, poll_s=min(0.2, args.interval)
        ):
            if slo:
                slo.observe(rec)
            if args.follow and time.monotonic() >= next_frame:
                frame()
                next_frame = time.monotonic() + args.interval
    except FileNotFoundError:
        print(f"top: no such file: {args.source}", file=sys.stderr)
        return 1
    except KeyboardInterrupt:
        pass
    frame()
    return 0


def load_metrics_json(path: str) -> dict:
    """Read the final ``metrics`` snapshot record out of an events.jsonl
    (the capture's closing registry dump) — a convenience for tools."""
    snap: dict = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("type") == "metrics":
                snap = rec.get("snapshot") or snap
    return snap
