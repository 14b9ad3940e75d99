"""Recompile detector: catch sweeps that silently stop sharing executables.

The port of erasurehead_tpu/obs/detect.py. The executable cache
(train/cache.py) is worth its keep because the Nth run of a signature skips
capturing its round loop's CUDA graphs again (train/graphs.py). The failure
mode is quiet: a config knob, a mesh or a resolved-lowering default drifts
between "the same" runs, every run captures anew, and nothing says why.

This module watches executable-cache misses. The trainer reports each
capture as a labelled signature (field name -> value, the content of the
cache key); when a miss lands in a signature family that was already
captured in this process, :func:`observe` returns the most similar earlier
signature's diff, the names of the key fields that differ, and the trainer
emits a ``warning`` record of kind ``recompile`` naming them. Fields
expected to vary (the chunk length under checkpointing) are left out, so
the captures of one chunked run do not warn; an empty diff means the
identical signature was captured again (cache disabled or entry evicted).
"""

from __future__ import annotations

from collections import deque
from typing import Optional

#: signature fields expected to differ between captures of one logical run
#: (checkpointing captures one program per distinct chunk length)
EXPECTED_VARYING = frozenset({"chunk_rounds"})

#: earlier signatures kept per family: sweeps cycle over a handful
_MAX_SEEN = 64

_seen: dict = {}  # family (fields["kind"]) -> deque[dict]


def reset() -> None:
    _seen.clear()


def _truncate(v, width: int = 120) -> str:
    s = repr(v)
    return s if len(s) <= width else s[: width - 3] + "..."


def observe(fields: dict) -> Optional[dict]:
    """Record one executable-cache miss; return the diff when this family
    (``fields['kind']``) was already captured in this process.

    None for the family's first capture, or for a miss that differs from
    every earlier signature only in :data:`EXPECTED_VARYING` fields.
    Otherwise ``{"changed": [...], "detail": {name: "old -> new"},
    "n_prior": int}`` against the closest earlier signature (fewest
    differing fields); ``changed`` empty means an identical signature was
    captured again."""
    family = fields.get("kind", "?")
    prior = _seen.setdefault(family, deque(maxlen=_MAX_SEEN))
    best = None
    best_changed = None
    for p in prior:
        keys = set(p) | set(fields)
        changed = sorted(k for k in keys if p.get(k) != fields.get(k))
        if best_changed is None or len(changed) < len(best_changed):
            best, best_changed = p, changed
    prior.append(dict(fields))
    if best is None:
        return None
    essential = [k for k in best_changed if k not in EXPECTED_VARYING]
    if best_changed and not essential:
        return None  # only expected-to-vary fields differed
    return {
        "changed": essential,
        "detail": {
            k: f"{_truncate(best.get(k))} -> {_truncate(fields.get(k))}"
            for k in essential
        },
        "n_prior": len(prior) - 1,
    }


def observe_and_warn(fields: dict, run_id: Optional[str] = None) -> None:
    """The trainer's hook: observe a miss and emit a ``warning`` record into
    the current capture when it looks like an unintended recompile."""
    diff = observe(fields)
    if diff is None:
        return
    from erasurehead_tpu_torch.obs import events

    if diff["changed"]:
        msg = (
            f"executable recompiled: {len(diff['changed'])} signature "
            f"field(s) differ from a prior in-process compile: "
            f"{', '.join(diff['changed'])}"
        )
    else:
        msg = (
            "executable recompiled with an identical signature "
            "(sweep cache disabled or entry evicted)"
        )
    events.emit(
        "warning",
        kind="recompile",
        message=msg,
        run_id=run_id,
        changed=diff["changed"],
        detail=diff["detail"],
    )
