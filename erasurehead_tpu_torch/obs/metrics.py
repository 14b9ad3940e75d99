"""Named counters: the counter half of erasurehead_tpu/obs/metrics.py.

One registry any module writes to under a dotted name
("sweep_cache.data_hits", "sweep_journal.records", "cohort.split", ...).
Everything is plain host-side Python: recording a metric never touches the
device. Also the JAX module's one-time stderr warnings (:func:`warn_once`).
Gauges, histograms and the snapshot export are not ported (they wait for
the obs plane).
"""

from __future__ import annotations

import sys
import threading


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


class MetricsRegistry:
    """Name -> counter, created on first request."""

    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Counter(name)
            return m

    def reset(self) -> None:
        """Zero every counter (tests; the names stay registered)."""
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
