"""Named metrics: counters, gauges, histograms and their snapshot export.

The port of erasurehead_tpu/obs/metrics.py. One registry any module writes
to under a dotted name ("sweep_cache.data_hits", "sweep_journal.records",
"cohort.split", ...). Everything is plain host-side Python: recording a
metric never touches the device, so it can never perturb a run.

The process-default registry is :data:`REGISTRY`; ``snapshot()`` exports
every metric as JSON-ready values (a capture closes with one ``metrics``
record of it, obs/events.py), ``export_typed()`` feeds the Prometheus text
(obs/exporter.py). Also the one-time stderr warnings (:func:`warn_once`).
"""

from __future__ import annotations

import math
import sys
import threading
from typing import Optional


class Counter:
    """Monotonically increasing value (int or float increments), lock-guarded
    so threads sharing a journal or a cache count exactly."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def reset(self) -> None:
        self._value = 0

    def export(self):
        return self._value


class Gauge:
    """Last-written value (e.g. steps/sec of the most recent run)."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, v) -> None:
        self._value = v

    @property
    def value(self):
        return self._value

    def reset(self) -> None:
        self._value = 0.0

    def export(self):
        return self._value


class Histogram:
    """Streaming distribution summary: count/sum/min/max plus a bounded
    sample reservoir for quantiles (the cap guards long-lived processes)."""

    __slots__ = ("name", "count", "sum", "min", "max", "_sample")

    MAX_SAMPLE = 4096

    def __init__(self, name: str):
        self.name = name
        self.reset()

    def reset(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._sample: list = []

    def observe(self, v) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if len(self._sample) < self.MAX_SAMPLE:
            self._sample.append(v)
        else:
            # deterministic decimation (no RNG: runs must replay exactly):
            # overwrite round-robin so the sample keeps covering the stream
            self._sample[self.count % self.MAX_SAMPLE] = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> Optional[float]:
        if not self._sample:
            return None
        s = sorted(self._sample)
        idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
        return s[idx]

    def export(self) -> dict:
        if not self.count:
            return {"count": 0, "sum": 0.0}
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            "p50": self.quantile(0.5),
            "p90": self.quantile(0.9),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Name -> metric, get-or-create per kind; a name registered as one kind
    cannot be requested as another (loud, not silently aliased)."""

    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> dict:
        """Every metric exported as JSON-ready values, sorted by name."""
        with self._lock:
            items = sorted(self._metrics.items())
        return {name: m.export() for name, m in items}

    def export_typed(self) -> list:
        """``[(name, kind, exported_value)]`` sorted by name, the metric set
        read in one pass under the registry lock (the Prometheus text,
        obs/exporter.py, renders from it)."""
        with self._lock:
            items = sorted(self._metrics.items())
        kinds = {Counter: "counter", Gauge: "gauge", Histogram: "histogram"}
        return [(n, kinds[type(m)], m.export()) for n, m in items]

    def reset(self) -> None:
        """Zero every metric (tests; the names stay registered)."""
        for m in self._metrics.values():
            m.reset()


#: process-default registry (the caches, the journal and the harness count here)
REGISTRY = MetricsRegistry()


_warned: set = set()


def warn_once(key: str, message: str) -> bool:
    """Print ``message`` to stderr the first time ``key`` is seen in this
    process; later calls are no-ops. Returns whether it printed. Callers
    pair it with a counter, so the repeats stay countable."""
    if key in _warned:
        return False
    _warned.add(key)
    print(message, file=sys.stderr)
    return True


def reset_warnings() -> None:
    """Forget which one-time warnings fired (tests)."""
    _warned.clear()
