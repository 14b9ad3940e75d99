"""Checkpoint/resume of the optimizer state and the round cursor.

The counterpart of erasurehead_tpu/train/checkpoint.py, whose orbax save
becomes one ``torch.save`` of ``{"params", "momentum", "next_round"}``
with every tensor moved to the CPU. A ``round_N`` directory holds that file
(:data:`STATE_NAME`) and a commit marker (:data:`COMMIT_MARKER`).

Preemptions also strike mid-save, so a save never shows a half-written
``round_N``: it writes into a temporary sibling directory (a name
:func:`_candidates` never lists), writes the commit marker last, then
``os.replace`` renames the directory to ``round_N``. :func:`latest` skips
a candidate without its marker, and :func:`restore_latest` goes further:
it attempts the restore newest-first and falls back to the next-older
checkpoint when the data itself is torn (a truncated state file passes the
marker check). Every skipped checkpoint is counted (``checkpoint.invalid``),
recorded as a ``checkpoint_invalid`` warning (obs/events.py) and reported
once on stderr.

``momentum`` round-trips whatever it is: None, a tensor or a dict of them
(GD, AGD), or a pair of those (ADAM); dtypes are kept, and a restore puts
every tensor on the device of the template state's params.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Optional, Tuple

import torch

from erasurehead_tpu_torch.ops.blocks import tree_leaves
from erasurehead_tpu_torch.train.optimizer import OptState
from erasurehead_tpu_torch.utils import chaos as chaos_lib

#: the commit marker, written last: a round_N directory without it is a
#: save that never completed (killed mid-write)
COMMIT_MARKER = "_COMMITTED"
#: the state file inside a round_N directory
STATE_NAME = "state.pt"
#: controller-state sidecar inside a round_N directory (the JAX package's
#: elastic membership controller): written after the state commits, so a kill
#: between the two leaves a committed checkpoint without its aux, which the
#: aux-aware resume skips
AUX_NAME = "elastic_aux.json"


def _map(fn, tree):
    """``fn`` over every tensor of a state tree (None, a tensor, a dict or
    a tuple of these), keeping its structure."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map(fn, v) for v in tree)
    raise TypeError(f"checkpoint: cannot store a {type(tree).__name__} in the state")


def _structure(tree):
    """Structure, shapes and dtypes of a state tree, for the template check."""
    return _map(lambda t: (tuple(t.shape), t.dtype), tree)


def _pack(state: OptState, next_round: int) -> dict:
    cpu = lambda t: t.detach().to("cpu", copy=True)  # noqa: E731
    return {
        "params": _map(cpu, state.params),
        "momentum": _map(cpu, state.momentum),
        "next_round": int(next_round),
    }


def save(path: str, state: OptState, next_round: int) -> None:
    """Write checkpoint directory ``path`` (overwrites): the state into a
    temporary sibling, the commit marker last, then a rename to ``path``."""
    # chaos site "checkpoint" (utils/chaos.py): an injected kill here is a
    # preemption mid-checkpoint; the save never commits, and a resume falls
    # back to the previous round_N (restore_latest)
    chaos_lib.maybe_fire("checkpoint")
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=f".{os.path.basename(path)}.")
    try:
        with open(os.path.join(tmp, STATE_NAME), "wb") as f:
            torch.save(_pack(state, next_round), f)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, COMMIT_MARKER), "w") as f:
            f.write(f"{int(next_round)}\n")
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def restore(path: str, template_state: OptState) -> Tuple[OptState, int]:
    """Load (state, next_round). ``template_state`` supplies the structure,
    shapes and dtypes the checkpoint must have, and the device it lands on
    (that of its params)."""
    path = os.path.abspath(path)
    back = torch.load(
        os.path.join(path, STATE_NAME), map_location="cpu", weights_only=True
    )
    state = OptState(params=back["params"], momentum=back["momentum"])
    if _structure(tuple(state)) != _structure(tuple(template_state)):
        raise ValueError(
            f"checkpoint {path!r} does not hold this run's optimizer state "
            "(structure, shapes or dtypes differ)"
        )
    device = tree_leaves(template_state.params)[0].device
    state = OptState(*(_map(lambda t: t.to(device), part) for part in state))
    return state, int(back["next_round"])


def is_valid(path: str) -> bool:
    """Structural validity of one ``round_N`` directory: it exists and its
    commit marker is present (a kill mid-save leaves no marker). Torn data
    inside a committed directory is caught by :func:`restore_latest`'s
    restore attempt instead."""
    return os.path.isdir(path) and os.path.exists(os.path.join(path, COMMIT_MARKER))


def _candidates(checkpoint_dir: str) -> list:
    """``round_N`` subdirectories, newest round first."""
    if not os.path.isdir(checkpoint_dir):
        return []
    rounds = []
    for name in os.listdir(checkpoint_dir):
        if name.startswith("round_"):
            try:
                rounds.append((int(name.split("_", 1)[1]), name))
            except ValueError:
                continue
    return [
        os.path.join(checkpoint_dir, name)
        for _, name in sorted(rounds, reverse=True)
    ]


def _warn_invalid(path: str, why: str) -> None:
    """A skipped checkpoint: counted, a ``checkpoint_invalid`` warning
    record, and one stderr line per path."""
    from erasurehead_tpu_torch.obs import events as obs_events
    from erasurehead_tpu_torch.obs.metrics import REGISTRY, warn_once

    REGISTRY.counter("checkpoint.invalid").inc()
    msg = (
        f"checkpoint: skipping {path!r} ({why}); falling back to the "
        f"next-older checkpoint"
    )
    obs_events.emit("warning", kind="checkpoint_invalid", message=msg)
    warn_once(f"checkpoint_invalid:{path}", msg)


def latest(checkpoint_dir: str) -> Optional[str]:
    """Most recent valid ``round_N`` checkpoint under ``checkpoint_dir``;
    candidates without their commit marker are skipped with a warning."""
    for path in _candidates(checkpoint_dir):
        if is_valid(path):
            return path
        _warn_invalid(path, "partially written: commit marker missing")
    return None


def save_aux(path: str, aux: dict) -> None:
    """Atomically attach a JSON sidecar to checkpoint directory ``path``
    (write to a temporary file, then rename: a kill mid-write never leaves
    a torn aux)."""
    target = os.path.join(os.path.abspath(path), AUX_NAME)
    tmp = target + ".tmp"
    with open(tmp, "w") as f:
        json.dump(aux, f)
    os.replace(tmp, target)


def load_aux(path: str) -> Optional[dict]:
    """The checkpoint's aux sidecar, or None (absent or torn)."""
    target = os.path.join(os.path.abspath(path), AUX_NAME)
    try:
        with open(target) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def save_with_aux(path: str, state: OptState, next_round: int, aux: dict) -> None:
    """Checkpoint plus controller-state sidecar: the aux is written only
    after the state commits, so every recoverable checkpoint carries a
    consistent (state, aux) pair."""
    save(path, state, next_round)
    save_aux(path, aux)


def _try_restore(path: str, template_state: OptState):
    try:
        return restore(path, template_state)
    except Exception as e:  # noqa: BLE001 - any torn checkpoint falls back
        _warn_invalid(
            path, f"restore failed: {type(e).__name__}: "
            f"{(str(e).splitlines() or [''])[0][:160]}"
        )
        return None


def restore_latest_with_aux(
    checkpoint_dir: str, template_state: OptState
) -> Optional[Tuple[OptState, int, str, dict]]:
    """Like :func:`restore_latest`, but only candidates carrying a readable
    aux sidecar qualify; one without it is skipped with a warning like a
    torn one. Returns (state, next_round, path, aux)."""
    for path in _candidates(checkpoint_dir):
        if not is_valid(path):
            _warn_invalid(path, "partially written: commit marker missing")
            continue
        aux = load_aux(path)
        if aux is None:
            _warn_invalid(
                path, "aux sidecar missing/torn (killed between the state "
                "commit and the aux write)"
            )
            continue
        restored = _try_restore(path, template_state)
        if restored is not None:
            return restored[0], restored[1], path, aux
    return None


def restore_latest(
    checkpoint_dir: str, template_state: OptState
) -> Optional[Tuple[OptState, int, str]]:
    """Restore the newest checkpoint that actually loads.

    Candidates are tried newest-first; ones without their commit marker and
    ones whose restore raises (a truncated or corrupt state file, or a
    state of another run's shape) are skipped with a warning on stderr.
    Returns ``(state, next_round, path)``, or None when no candidate
    survives (callers start from round 0, as with no checkpoint at all)."""
    for path in _candidates(checkpoint_dir):
        if not is_valid(path):
            _warn_invalid(path, "partially written: commit marker missing")
            continue
        restored = _try_restore(path, template_state)
        if restored is not None:
            return restored[0], restored[1], path
    return None
