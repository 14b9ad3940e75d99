"""trace-purity: no host effects reachable from traced function bodies.

The port of erasurehead_tpu/analysis/purity.py. The observation-only
contract: telemetry emission (events, metrics counters) stays on the host
loop, once per round or per trajectory, and a body the port runs under
``torch.func.vmap`` / ``torch.func.grad`` (or as the ``forward`` /
``backward`` of a ``torch.autograd.Function``) is pure. Such a body runs
ONCE for the whole batch: an event or a counter inside it is emitted once
where the reader counts one per trajectory, a clock read times the batch
instead of the slot, and a host RNG draw (or a reseed) is shared by every
trajectory and moves the global generator under the caller's feet — which
breaks the bitwise-reproducibility pins the cohort and serve paths key on.

Flags, inside the traced call graph (core.SourceModule.traced_functions):

  - event emission: any ``*.emit(...)`` call, and bare ``emit(...)`` when
    the module imports it from obs.events;
  - metrics mutation: ``*.inc(...)`` / ``*.observe(...)`` (the
    obs/metrics counter-and-histogram surface);
  - host clocks: ``time.time/perf_counter/monotonic/process_time/sleep``;
  - host randomness: ``np.random.*`` / ``numpy.random.*`` (and stdlib
    ``random.*`` when the module imports ``random``), ``torch.manual_seed``
    / ``torch.seed`` / ``torch.cuda.manual_seed[_all]`` /
    ``torch.random.manual_seed``, and a ``torch.Generator(...)`` created
    inside the body;
  - console/file I/O: ``print``, ``open``, ``input``, ``breakpoint``,
    ``sys.stdout/stderr.write``, ``os.remove/rename/makedirs/unlink``.
"""

from __future__ import annotations

import ast

from erasurehead_tpu_torch.analysis.core import Finding, SourceModule, dotted, walk_own

CHECKER = "trace-purity"

_BARE_CALLS = frozenset({"print", "open", "input", "breakpoint"})
_EXACT_DOTTED = frozenset(
    {
        "time.time",
        "time.perf_counter",
        "time.monotonic",
        "time.process_time",
        "time.sleep",
        "sys.stdout.write",
        "sys.stderr.write",
        "os.remove",
        "os.rename",
        "os.makedirs",
        "os.unlink",
        "os.open",
    }
)
_NUMPY_RANDOM_PREFIXES = ("np.random.", "numpy.random.")
_TORCH_RNG = frozenset(
    {
        "torch.manual_seed",
        "torch.seed",
        "torch.random.manual_seed",
        "torch.random.seed",
        "torch.cuda.manual_seed",
        "torch.cuda.manual_seed_all",
        "torch.Generator",
    }
)
_EFFECT_SUFFIXES = (".emit", ".inc", ".observe")


def _effect(name: str, mod: SourceModule) -> str | None:
    """A short label when ``name`` is a host effect, else None."""
    if name in _BARE_CALLS:
        return f"host I/O call {name}()"
    if name in _EXACT_DOTTED:
        return f"host call {name}()"
    if name.startswith(_NUMPY_RANDOM_PREFIXES) or name in _TORCH_RNG:
        return (
            f"host RNG {name}() (draw outside the batched body and pass "
            "the values in)"
        )
    if name.startswith("random.") and "random" in mod.imported_modules:
        return f"host RNG {name}()"
    if name == "emit" and mod.emit_is_events:
        return "event emission emit()"
    for suffix in _EFFECT_SUFFIXES:
        if name.endswith(suffix):
            kind = (
                "event emission"
                if suffix == ".emit"
                else "metrics mutation"
            )
            return f"{kind} {name}()"
    return None


def check(mod: SourceModule, context) -> list:
    findings = []
    for fn, why in mod.traced_functions().values():
        scope = mod.scope_of(fn)
        for node in walk_own(fn):
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func)
            if name is None:
                continue
            if name == "emit" and scope.resolve_function("emit") is not None:
                continue  # a local helper def named emit, not the event sink
            label = _effect(name, mod)
            if label is not None:
                findings.append(
                    Finding(
                        CHECKER,
                        mod.path,
                        node.lineno,
                        node.col_offset,
                        f"{label} inside traced code (traced via {why}); "
                        "host effects must stay outside vmap/grad bodies",
                    )
                )
    return findings
