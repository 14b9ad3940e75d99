"""Tracing and profiling: a ``torch.profiler`` trace around a run, named
regions inside it.

The port of erasurehead_tpu/utils/tracing.py. The reference's observability
is two hand-rolled artifacts, per-iteration ``timeset`` and the per-worker
arrival matrix ``worker_timeset``, which the trainers keep as the simulated
clock. On top, :func:`device_trace` captures a real trace of the host and
the card (the CLI's ``--trace-dir``): a Chrome trace, ``*.pt.trace.json``,
that opens in ui.perfetto.dev, with the kernels by their device symbols
(``glm_grad_onepass``: B1, one launch a call; ``block_decode_leaves``) and
the trainers' named regions (:func:`annotate`: ``eh_scan/coded_step``,
``eh_scan/update``, ``eh_step/partial_grads``, ``eh_step/decode``) as host
spans.

Deviation from the JAX package, whose ``annotate`` is always on: there a
``named_scope`` inside ``jit`` costs nothing at run time, while here a
``record_function`` or an NVTX range is a host call in a round loop the host
already bounds. So :func:`annotate` takes no profiler or NVTX call unless a
:func:`device_trace` is in progress, and an untraced run pays one flag test
per region.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Iterator, Optional

#: the device of the device_trace in progress (None: no trace); annotate
#: reads it
_tracing: Optional[str] = None

#: why a run under a device_trace keeps the eager loop (train/trainer.
#: _loop_mode): the trace records each round's host spans, where a captured
#: graph's would be recorded once, at capture. So a trace times the eager
#: loop, not the graph replays an untraced run on the card times; the trace
#: file says so in its metadata (``executor``, ``eager_reason``)
TRACE_EAGER = "a device_trace records each round's host spans"

_NO_REGION = contextlib.nullcontext()


@dataclasses.dataclass
class Trace:
    """A :func:`device_trace` in progress; ``path`` is the Chrome trace file
    once the block has exited."""

    path: Optional[str] = None


@contextlib.contextmanager
def device_trace(log_dir: Optional[str], device=None) -> Iterator[Optional[Trace]]:
    """Capture a ``torch.profiler`` trace of the block into ``log_dir`` (a
    no-op yielding None when ``log_dir`` is empty).

    The CPU activity always, plus the CUDA activity when ``device`` is a
    cuda device (None: when a card is present). On exit the trace is
    written as ``log_dir/eh_<pid>_<ns>.pt.trace.json``, its metadata naming
    the round loop's executor (:data:`TRACE_EAGER`); a failed export
    raises. Traces do not nest."""
    global _tracing
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    if _tracing is not None:
        raise RuntimeError("device_trace does not nest: a trace is already in progress")
    if device is None:
        cuda = torch.cuda.is_available()
    else:
        cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    trace = Trace()
    with profile(activities=activities) as prof:
        # what the traced rounds ran: a reader of the trace must not take
        # its per-layer times for the graph path's
        prof.add_metadata("executor", "eager")
        prof.add_metadata("eager_reason", TRACE_EAGER)
        _tracing = "cuda" if cuda else "cpu"
        try:
            yield trace
        finally:
            _tracing = None
    path = os.path.join(log_dir, f"eh_{os.getpid()}_{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    trace.path = path


class _Region:
    """A named region of an active trace: a ``record_function`` host span,
    and on the card an NVTX range around it."""

    __slots__ = ("name", "_span", "_nvtx")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        import torch

        self._span = torch.profiler.record_function(self.name)
        self._span.__enter__()
        self._nvtx = _tracing == "cuda"
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if self._nvtx:
            import torch

            torch.cuda.nvtx.range_pop()
        self._span.__exit__(*exc)
        return False


def active() -> bool:
    """Is a :func:`device_trace` in progress? (The trainers then run their
    round bodies uncaptured, :data:`TRACE_EAGER`.)"""
    return _tracing is not None


def annotate(name: str):
    """A named region in the trace of the :func:`device_trace` in progress;
    without one, a shared null context (no profiler call, no NVTX call)."""
    if _tracing is None:
        return _NO_REGION
    return _Region(name)


class StepTimer:
    """Host-side wall-clock accumulator for loops outside the trainers (eval
    sweeps, data preparation)."""

    def __init__(self):
        self.laps: list = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.laps.append(time.perf_counter() - self._t0)
        self._t0 = None
        return False

    @property
    def total(self) -> float:
        return sum(self.laps)

    @property
    def mean(self) -> float:
        return self.total / len(self.laps) if self.laps else 0.0
