"""Bounded-memory streaming aggregation of the typed event stream.

The port of erasurehead_tpu/obs/timeseries.py.

Everything the system emits is a typed JSONL record (obs/events.SCHEMA);
until now all of it was post-hoc — readable only after the run, by
loading the whole file. This module turns the same stream into *live*
windowed series with O(max_windows) memory, consumed either by tailing
a growing events.jsonl (:meth:`TimeseriesReducer.tail`) or attached
in-process to whatever ``events.capture()`` is emitting
(:meth:`TimeseriesReducer.attach`, via events.add_observer — the serve
daemon's ``/metrics`` loop).

Series maintained per wall-clock window (default 5 s, last 120
windows):

  - training throughput: rounds landed, simulated seconds, rounds/sec
    on both clocks;
  - arrival quantiles (p50/p90/p99/mean) merged from the chunked
    ``rounds`` records' masked summaries;
  - decode health: error mean/max, exact-decode share, and the
    staleness-vs-coding split from ``stale_decode``;
  - prefetch: staged bytes, fetch seconds, effective bytes/s;
  - cache hit rates: executable (``compile``) and device-data
    (``data_upload``);
  - per-tenant serve goodput: intake requests, completed rows
    (``request`` phase="done" markers), rejects.

The reducer also keeps the latest ``critical_path`` ledger, ``regime``
estimate and per-tenant ``slo`` burn rates — the gauges
obs/exporter.py renders at ``GET /metrics``.

Strictly a consumer: it never emits, never blocks a producer (observer
exceptions are swallowed upstream), and drops malformed lines with a
counter instead of raising — a telemetry reader must never take down
the thing it watches.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Iterator, Optional

#: tenants tracked per window before the long tail aggregates as "..."
MAX_TENANTS = 64


def _window_blank() -> dict:
    return {
        "events": {},
        "rounds": 0,
        "sim_time_s": 0.0,
        "arrival": {"p50": [], "p90": [], "p99": [], "mean": []},
        "decode_err_sum": 0.0,
        "decode_err_max": 0.0,
        "decode_n": 0,
        "decode_exact_n": 0,
        "stale_share_sum": 0.0,
        "stale_n": 0,
        "prefetch_bytes": 0,
        "prefetch_fetch_s": 0.0,
        "compile_hits": 0,
        "compile_n": 0,
        "data_hits": 0,
        "data_n": 0,
        "tenants": {},
    }


def _tenant_blank() -> dict:
    return {"requests": 0, "done": 0, "rows_ok": 0, "rejects": 0}


class TimeseriesReducer:
    """Windowed streaming reducer over typed event records."""

    def __init__(self, window_s: float = 5.0, max_windows: int = 120):
        if window_s <= 0 or max_windows < 1:
            raise ValueError(
                f"window_s must be > 0 and max_windows >= 1, got "
                f"{window_s}/{max_windows}"
            )
        self.window_s = float(window_s)
        self.max_windows = int(max_windows)
        self._lock = threading.Lock()
        self._windows: collections.OrderedDict = collections.OrderedDict()
        self._malformed = 0
        self._consumed = 0
        self._last_critical_path: Optional[dict] = None
        self._last_regime: Optional[dict] = None
        self._last_run_end: Optional[dict] = None
        self._slo_by_tenant: dict = {}

    # ---- ingestion -------------------------------------------------------

    def consume_line(self, line: str) -> bool:
        """Parse one JSONL line and consume it; malformed lines are
        counted and dropped (a live tail can race a partial write)."""
        line = line.strip()
        if not line:
            return False
        try:
            rec = json.loads(line)
            if not isinstance(rec, dict):
                raise ValueError("not an object")
        except ValueError:
            with self._lock:
                self._malformed += 1
            return False
        self.consume(rec)
        return True

    def consume(self, rec: dict) -> None:
        """Fold one typed record into the windowed series (the
        events.add_observer entry point — must stay cheap and
        non-raising for well-formed records)."""
        rtype = rec.get("type")
        t = rec.get("t")
        if not isinstance(t, (int, float)):
            t = time.time()
        with self._lock:
            self._consumed += 1
            w = self._window_for(t)
            w["events"][rtype] = w["events"].get(rtype, 0) + 1
            if rtype == "rounds":
                w["rounds"] += int(rec.get("n_rounds", 0) or 0)
                w["sim_time_s"] += float(rec.get("sim_time_s", 0.0) or 0.0)
                arr = rec.get("arrival") or {}
                for q in ("p50", "p90", "p99", "mean"):
                    v = arr.get(q)
                    if isinstance(v, (int, float)):
                        w["arrival"][q].append(
                            (float(v), int(arr.get("n_arrivals", 1) or 1))
                        )
            elif rtype == "decode":
                n = int(rec.get("n_rounds", 0) or 0)
                w["decode_n"] += n
                w["decode_err_sum"] += n * float(
                    rec.get("error_mean", 0.0) or 0.0
                )
                w["decode_err_max"] = max(
                    w["decode_err_max"],
                    float(rec.get("error_max", 0.0) or 0.0),
                )
                if rec.get("exact"):
                    w["decode_exact_n"] += n
            elif rtype == "stale_decode":
                w["stale_n"] += 1
                w["stale_share_sum"] += float(
                    rec.get("staleness_share", 0.0) or 0.0
                )
            elif rtype == "prefetch":
                w["prefetch_bytes"] += int(rec.get("bytes", 0) or 0)
                w["prefetch_fetch_s"] += float(
                    rec.get("fetch_s", 0.0) or 0.0
                )
            elif rtype == "compile":
                w["compile_n"] += 1
                if rec.get("cache_hit"):
                    w["compile_hits"] += 1
            elif rtype == "data_upload":
                w["data_n"] += 1
                if rec.get("cache_hit"):
                    w["data_hits"] += 1
            elif rtype == "request":
                ten = self._tenant_slot(w, rec.get("tenant"))
                if rec.get("phase") == "done":
                    ten["done"] += 1
                    if rec.get("status") == "ok":
                        ten["rows_ok"] += 1
                else:
                    ten["requests"] += 1
            elif rtype == "reject":
                self._tenant_slot(w, rec.get("tenant"))["rejects"] += 1
            elif rtype == "critical_path":
                self._last_critical_path = rec
            elif rtype == "regime":
                self._last_regime = rec
            elif rtype == "run_end":
                self._last_run_end = rec
            elif rtype == "slo":
                tenant = rec.get("tenant")
                if isinstance(tenant, str):
                    self._slo_by_tenant[tenant] = rec
                    while len(self._slo_by_tenant) > MAX_TENANTS:
                        self._slo_by_tenant.pop(
                            next(iter(self._slo_by_tenant))
                        )

    def _window_for(self, t: float) -> dict:
        key = int(t // self.window_s)
        w = self._windows.get(key)
        if w is None:
            w = _window_blank()
            self._windows[key] = w
            while len(self._windows) > self.max_windows:
                self._windows.popitem(last=False)
        return w

    @staticmethod
    def _tenant_slot(w: dict, tenant) -> dict:
        name = tenant if isinstance(tenant, str) and tenant else "?"
        tenants = w["tenants"]
        if name not in tenants and len(tenants) >= MAX_TENANTS:
            name = "..."  # bounded memory: the long tail aggregates
        return tenants.setdefault(name, _tenant_blank())

    # ---- attachment ------------------------------------------------------

    def attach(self):
        """Attach in-process to the current event stream
        (events.add_observer); returns a detach callable, and works as a
        context manager via :class:`_Attached`."""
        from erasurehead_tpu_torch.obs import events

        events.add_observer(self.consume)
        return _Attached(self)

    def tail(
        self,
        path: str,
        *,
        follow: bool = False,
        poll_s: float = 0.2,
        stop=None,
    ) -> Iterator[dict]:
        """Tail an events.jsonl through the reducer, yielding each
        consumed record. ``follow=False`` reads to EOF once (a finished
        run); ``follow=True`` keeps polling a growing file until
        ``stop()`` returns True. Partial trailing lines (a writer
        mid-record) are held back until complete."""
        buf = ""
        with open(path, "r") as f:
            while True:
                chunk = f.read(65536)
                if chunk:
                    buf += chunk
                    *lines, buf = buf.split("\n")
                    for line in lines:
                        if not line.strip():
                            continue
                        if self.consume_line(line):
                            yield json.loads(line)
                    continue
                if not follow or (stop is not None and stop()):
                    break
                time.sleep(poll_s)
        if buf.strip() and self.consume_line(buf):
            yield json.loads(buf)

    # ---- querying --------------------------------------------------------

    def snapshot(self) -> dict:
        """Windowed series + latest-record state, JSON-ready."""
        with self._lock:
            windows = [
                {"t0": key * self.window_s, **self._render_window(w)}
                for key, w in self._windows.items()
            ]
            return {
                "window_s": self.window_s,
                "consumed": self._consumed,
                "malformed": self._malformed,
                "windows": windows,
                "critical_path": self._last_critical_path,
                "regime": self._last_regime,
                "run_end": self._last_run_end,
                "slo": dict(self._slo_by_tenant),
            }

    def _render_window(self, w: dict) -> dict:
        def wavg(pairs):
            tot = sum(n for _, n in pairs)
            return (
                sum(v * n for v, n in pairs) / tot if tot > 0 else None
            )

        return {
            "events": dict(w["events"]),
            "rounds": w["rounds"],
            "sim_time_s": round(w["sim_time_s"], 6),
            "rounds_per_wall_sec": round(w["rounds"] / self.window_s, 4),
            "rounds_per_sim_sec": (
                round(w["rounds"] / w["sim_time_s"], 4)
                if w["sim_time_s"] > 0
                else None
            ),
            "arrival": {
                q: (round(v, 6) if v is not None else None)
                for q, v in (
                    (q, wavg(w["arrival"][q]))
                    for q in ("p50", "p90", "p99", "mean")
                )
            },
            "decode_error_mean": (
                round(w["decode_err_sum"] / w["decode_n"], 10)
                if w["decode_n"] > 0
                else None
            ),
            "decode_error_max": round(w["decode_err_max"], 10),
            "decode_exact_share": (
                round(w["decode_exact_n"] / w["decode_n"], 4)
                if w["decode_n"] > 0
                else None
            ),
            "staleness_share": (
                round(w["stale_share_sum"] / w["stale_n"], 4)
                if w["stale_n"] > 0
                else None
            ),
            "prefetch_bytes": w["prefetch_bytes"],
            "prefetch_bytes_per_sec": (
                round(w["prefetch_bytes"] / w["prefetch_fetch_s"], 1)
                if w["prefetch_fetch_s"] > 0
                else None
            ),
            "compile_cache_hit_rate": (
                round(w["compile_hits"] / w["compile_n"], 4)
                if w["compile_n"] > 0
                else None
            ),
            "data_cache_hit_rate": (
                round(w["data_hits"] / w["data_n"], 4)
                if w["data_n"] > 0
                else None
            ),
            "tenants": {
                t: dict(v) for t, v in sorted(w["tenants"].items())
            },
        }

    def gauges(self) -> dict:
        """Flat metric-name -> value map for the Prometheus exporter:
        the most recent window's series plus the latest critical-path
        fractions, regime estimate and per-tenant SLO burn rates.
        Label-carrying names use the exporter's ``name{label="v"}``
        convention."""
        from erasurehead_tpu_torch.obs.exporter import prom_key

        snap = self.snapshot()
        out = {
            "timeseries_consumed_total": float(snap["consumed"]),
            "timeseries_malformed_total": float(snap["malformed"]),
        }
        if snap["windows"]:
            w = snap["windows"][-1]
            out["rounds_per_wall_sec"] = float(w["rounds_per_wall_sec"])
            for key in (
                "rounds_per_sim_sec", "decode_error_mean",
                "decode_exact_share", "staleness_share",
                "compile_cache_hit_rate", "data_cache_hit_rate",
                "prefetch_bytes_per_sec",
            ):
                if w.get(key) is not None:
                    out[key] = float(w[key])
            for q, v in w["arrival"].items():
                if v is not None:
                    out[prom_key("arrival_seconds", quantile=q)] = float(v)
            for tenant, tv in w["tenants"].items():
                for field in ("requests", "rows_ok", "rejects"):
                    out[
                        prom_key(f"tenant_{field}", tenant=tenant)
                    ] = float(tv[field])
        cp = snap.get("critical_path")
        if cp:
            for k, v in (cp.get("fractions") or {}).items():
                if isinstance(v, (int, float)):
                    out[
                        prom_key("critical_path_fraction", bucket=k)
                    ] = float(v)
        reg = snap.get("regime")
        if reg:
            if isinstance(reg.get("rate"), (int, float)):
                out["regime_arrival_rate"] = float(reg["rate"])
            if isinstance(reg.get("tail_index"), (int, float)):
                out["regime_tail_index"] = float(reg["tail_index"])
            out["regime_heavytail"] = (
                1.0 if reg.get("kind") == "heavytail" else 0.0
            )
        for tenant, rec in (snap.get("slo") or {}).items():
            if isinstance(rec.get("burn_rate"), (int, float)):
                out[
                    prom_key("slo_burn_rate", tenant=tenant)
                ] = float(rec["burn_rate"])
        return out


class _Attached:
    """Detach handle/context manager returned by
    :meth:`TimeseriesReducer.attach`."""

    def __init__(self, reducer: TimeseriesReducer):
        self._reducer = reducer

    def __call__(self) -> None:
        self.detach()

    def detach(self) -> None:
        from erasurehead_tpu_torch.obs import events

        events.remove_observer(self._reducer.consume)

    def __enter__(self) -> TimeseriesReducer:
        return self._reducer

    def __exit__(self, *exc) -> bool:
        self.detach()
        return False


def tail_path(
    path: str, *, follow: bool = False, **kw
) -> TimeseriesReducer:
    """Convenience: reduce a whole events.jsonl in one call."""
    red = TimeseriesReducer(**kw)
    if os.path.exists(path):
        for _ in red.tail(path, follow=follow):
            pass
    return red
