"""One stretch of a run under ``torch.profiler``, reduced to what the
per-layer metrics read.

The profiler records the card's activity alone (``ProfilerActivity.CUDA``:
kernels, copies, memsets and the CUDA runtime calls that launched them),
not the host's ATen operators. Its record of every launch still lengthens
the stretch (a dispatch launches some 0.3 to 0.6 M kernels): so the card's
idle share is taken over the wall time of the same dispatch run untraced
(harness.py, metrics/device_idle_share.py), and the gaps below are as long
as they were under the profiler. What the host was doing comes from a
sampler thread, which reads the main thread's Python stack every few
milliseconds.

The events are read in memory (no trace file is written):

  - device intervals: every kernel, copy and memset on the card;
  - ``busy_s``: the length of their union within the stretch;
  - ``graph_s``: the device time of the operations that CUDA-graph
    launches (``cudaGraphLaunch``) started, joined by their correlation
    id: the port's round loop, which replays captured graphs;
  - ``device_ops``: device seconds by operation name;
  - ``idle_gaps``: the longest stretches with nothing on the card, each
    labelled by the port's function the host sampler found most often
    inside it (else by the CUDA runtime call before it).

The port's own tracing (utils/tracing) is never started: it would switch
the round loop to its eager form.
"""

from __future__ import annotations

import bisect
import collections
import sys
import threading
import time
from collections import defaultdict

#: the program's package: a host sample is labelled by its innermost frame there
PROGRAM = "erasurehead_tpu_torch"
SAMPLE_S = 0.002


class HostSampler:
    """A daemon thread recording ``(time_ns, label)`` of the main thread's
    innermost frame in the program's package, every ``SAMPLE_S``; the
    profiler's timestamps are the same wall clock (``time.time_ns``)."""

    def __init__(self, interval: float = SAMPLE_S):
        self.interval, self.samples = interval, []
        self._main = threading.main_thread().ident
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            frame = sys._current_frames().get(self._main)
            label = None
            while frame is not None:
                path = frame.f_code.co_filename
                k = path.rfind(f"/{PROGRAM}/")
                if k >= 0:
                    label = f"{path[k + len(PROGRAM) + 2:]}:{frame.f_code.co_name}"
                    break
                frame = frame.f_back
            self.samples.append((time.time_ns(), label or "outside the program"))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def profile_call(fn) -> dict:
    """Run ``fn()`` under the profiler; return the reduction (see module
    docstring) with ``window_s``, the host seconds of the stretch, and
    ``result``, what ``fn`` returned."""
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, HostSampler() as sampler:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev, host, graph_corr = [], [], set()
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns() * 1e-3
        e = s + ev.duration_ns() * 1e-3
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            dev.append((s, e, name, ev.correlation_id()))
        else:
            host.append((s, e, name))
            if name.startswith("cudaGraphLaunch"):
                graph_corr.add(ev.correlation_id())
    samples = [(t * 1e-3, label) for t, label in sampler.samples]
    red = reduce_events(dev, host, graph_corr, samples)
    red["window_s"] = window_s
    red["host_samples"] = len(samples)
    red["result"] = out
    return red


def _union(intervals: list) -> list:
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_events(dev: list, host: list, graph_corr: set, samples: list = (),
                  n_ops: int = 10, n_gaps: int = 10) -> dict:
    """The reduction of device events ``(start, end, name, correlation)``,
    host runtime calls ``(start, end, name)``, the correlation ids of graph
    launches and host samples ``(time, label)``; times in microseconds."""
    if not dev:
        return {"busy_s": 0.0, "graph_s": 0.0, "device_ops": [], "idle_gaps": [],
                "n_device_events": 0, "graph_launches": 0, "sampled_gaps": 0}
    by_name: dict = defaultdict(float)
    graph_us = 0.0
    for s, e, name, corr in dev:
        by_name[name] += e - s
        if corr is not None and corr in graph_corr:
            graph_us += e - s
    busy = _union([(s, e) for s, e, _, _ in dev])
    busy_us = sum(e - s for s, e in busy)
    gaps = [(busy[k + 1][0] - busy[k][1], busy[k][1], busy[k + 1][0])
            for k in range(len(busy) - 1)]
    gaps.sort(reverse=True)
    host.sort()
    starts = [h[0] for h in host]
    samples = sorted(samples)
    times = [t for t, _ in samples]
    labelled, sampled = [], 0
    for length, s, e in gaps[:n_gaps]:
        inside = [lab for _, lab in samples[bisect.bisect_left(times, s):
                                            bisect.bisect_right(times, e)]]
        if inside:
            sampled += 1
            label = collections.Counter(inside).most_common(1)[0][0]
        else:
            label = _host_label(host, starts, (s + e) / 2.0)
        labelled.append([label, length * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_ops]
    return {
        "busy_s": busy_us * 1e-6,
        "graph_s": graph_us * 1e-6,
        "device_ops": [[name, us * 1e-6] for name, us in ops],
        "idle_gaps": labelled,
        "n_device_events": len(dev),
        "graph_launches": len(graph_corr),
        "sampled_gaps": sampled,
    }


def _host_label(host: list, starts: list, t: float) -> str:
    """The runtime call covering ``t``, else the last that ended before it."""
    k = bisect.bisect_right(starts, t)
    best, last = None, None
    for j in range(k - 1, max(k - 4000, -1), -1):
        s, e, name = host[j]
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
        if e < t and (last is None or e > last[1]):
            last = (s, e, name)
    if best is not None:
        return best[2]
    return f"host between calls, after {last[2]}" if last is not None else "host, no call"
