"""Measured autotuning plane: race, cache, resolve.

The port of erasurehead_tpu/tune/. An ``auto`` knob resolves through the
ladder

    explicit knob > env override > cached measured decision > constant

The measured decisions come from deterministic races (tune/racer.py:
seeded inputs, warm-up, min-over-repeats, tie->fallback) run at the run's
own shape on the run's own device, by ``python -m erasurehead_tpu_torch.cli
tune`` (tune/races.main), and persist in a JSON decision cache keyed by
``(device_kind, race, shape signature)`` (tune/cache.py). Resolution is one
memoized dict lookup; races never run inside a training step or a
resolver: resolvers only read.

Resolutions are observable as ``tune`` records (obs/events.py; source
"race"/"cache"/"default"), deduplicated per process; emission never feeds
back into the resolved choice.

Races and their choice vocabularies (JAX's, unchanged, so the records
validate in both packages):

    block_decode   fused | treewise      B2's per-leaf decode vs the packed
                                         table (both launch B2 on the card)
    layer_coding   blockwise | treewise  per-layer coding on/off
    glm_fused      pallas | xla          B1 (csrc/fused_glm_grad.cu) vs the
                                         two-pass torch gradient
    ring_pipeline  pipelined | sequential  the ring transport's schedules
    stack_mode     ring | materialized      the faithful stack's transports
                                            (at world size 1 the ring is a
                                            per-round local gather)

The cache's device dimension is the run's device: the CUDA device name on
the card, ``"cpu"`` for a CPU run (a ``--device cpu`` run on a machine with
a card keys as ``"cpu"``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from erasurehead_tpu_torch.tune.cache import (  # noqa: F401 (public API)
    DecisionCache,
    ENV_PATH,
    canonical_bytes,
    decision_key,
    default_path,
    get_cache,
    reset,
)

#: every race the plane knows, with its candidate vocabulary (the events
#: validator checks membership: obs/events.TUNE_RACES mirrors the keys)
TUNE_CHOICES = {
    "block_decode": ("fused", "treewise"),
    "layer_coding": ("blockwise", "treewise"),
    "glm_fused": ("pallas", "xla"),
    "ring_pipeline": ("pipelined", "sequential"),
    "stack_mode": ("ring", "materialized"),
}

RACES = tuple(sorted(TUNE_CHOICES))


def default_device_kind(device=None) -> str:
    """The cache's device dimension for a run on ``device`` (None = the
    port's default, ``cuda``, which raises without a card as every entry
    point does): ``torch.cuda.get_device_name`` for a CUDA device,
    ``"cpu"`` for the CPU."""
    from erasurehead_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def stack_device(X) -> torch.device:
    """The device a stack lives on: a dense tensor's own, or the first
    tensor field of a sparse/compressed stack (ops/features.py)."""
    if isinstance(X, torch.Tensor):
        return X.device
    for v in vars(X).values():
        if isinstance(v, torch.Tensor):
            return v.device
    raise TypeError(f"no tensor in stack {type(X).__name__}")


def dtype_name(dtype) -> str:
    """A dtype in JAX's spelling (``float32``, never ``torch.float32``)."""
    return str(dtype).replace("torch.", "")


def run_shape_signature(model, X) -> str:
    """The shape key a run resolves (and races) under: model family +
    depth + the stack's type/shape/dtype, in JAX's field order. The port's
    dense stack is a ``Tensor`` (JAX's an ``ArrayImpl``), so the two
    packages' keys never coincide for a dense run. Computable both at
    resolution time (the trainer has model + stack) and at race time
    (trainer.resolved_stack builds the same pair)."""
    shape = tuple(int(s) for s in getattr(X, "shape", ()))
    dtype = dtype_name(getattr(X, "dtype", "?"))
    nl = getattr(model, "n_layers", None)
    return (
        f"model={type(model).__name__}"
        f"|nl={nl}|X={type(X).__name__}{shape}|{dtype}"
    )


def stack_mode_signature(layout, rows: int, n_features: int, dtype) -> str:
    """Shape key of the stack-transport race (data/sharding.
    resolve_ring_stack): the pre-stack quantities its footprint gate reads,
    as JAX keys them (no stack exists yet when it resolves)."""
    return (
        f"W={layout.n_workers}|P={layout.n_partitions}"
        f"|S={layout.n_slots}|rows={int(rows)}|F={int(n_features)}"
        f"|{dtype_name(dtype)}"
    )


def glm_fused_signature(shape, dtype, kind: str) -> str:
    """Shape key of the fused-GLM race: the whole stack's shape
    ([W, S, rows, F] faithful, [P, rows, F] deduped), as JAX keys it."""
    return f"glm={kind}|X={tuple(int(s) for s in shape)}|{dtype_name(dtype)}"


# -- tune records, deduplicated per process ----------------------------------

_emitted: set = set()
#: a thread inside :func:`quiet` consults without emitting
_quiet = threading.local()


@contextlib.contextmanager
def quiet():
    """Consult the cache without emitting ``tune`` records: the executable
    cache's key resolves the knobs again (parallel/step.lowering_signature)
    after the run has resolved them, and its records are the run's."""
    prev = getattr(_quiet, "on", False)
    _quiet.on = True
    try:
        yield
    finally:
        _quiet.on = prev


def emit_decision(
    race: str, device_kind: str, shape: str, choice: str, source: str
) -> None:
    """Emit one ``tune`` record per distinct decision per process (into the
    current obs/events capture, if any). Observation only: emission happens
    after the choice is made and never feeds back."""
    key = (race, device_kind, shape, choice, source)
    if key in _emitted or getattr(_quiet, "on", False):
        return
    _emitted.add(key)
    from erasurehead_tpu_torch.obs import events as events_lib

    events_lib.emit(
        "tune", race=race, device_kind=device_kind, shape=shape,
        choice=choice, source=source,
    )


def reset_emitted() -> None:
    """Tests: forget the per-process record dedup."""
    _emitted.clear()


def lookup(
    race: str,
    shape_sig: str,
    device_kind: Optional[str] = None,
    fallback: Optional[str] = None,
) -> Optional[str]:
    """Resolve one auto knob: cached decision or None (caller's constant).

    The single consult point every resolver goes through
    (step.resolve_layer_coding / resolve_block_decode, the trainer's
    ``use_pallas="auto"`` gate). Warm path: one stat(2) + dict lookup.
    Emits the decision as a ``tune`` record: ``source="cache"`` when a
    verdict applies, ``source="default"`` (with ``fallback`` as the
    choice, when given) when the hardcoded constant stands. In a process
    group every rank takes rank 0's verdict (parallel/backend.agree): every
    rank must consult at the same points."""
    dk = device_kind or default_device_kind()
    # across ranks, rank 0's read decides: the cache is a file that a
    # racing process may rewrite between two ranks' reads, and ranks that
    # took different lowerings would part
    from erasurehead_tpu_torch.parallel import backend

    choice = backend.agree(get_cache().lookup(dk, race, shape_sig))
    if choice is not None:
        emit_decision(race, dk, shape_sig, choice, "cache")
        return choice
    if fallback is not None:
        emit_decision(race, dk, shape_sig, fallback, "default")
    return None
