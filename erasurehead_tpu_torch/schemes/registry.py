"""The scheme registry: name -> SchemeDescriptor, entry-point discoverable.

The port's copy of erasurehead_tpu/schemes/registry.py. Lookup (:func:`get`)
is the single dispatch point: ``trainer.build_layout``,
``trainer.build_schedule`` and ``artifacts.run_prefix`` resolve their scheme
through here (tests/test_torch_schemes.py pins that no scheme dispatch
survives outside ``schemes/``).

Third-party codes register without touching the package, two ways:

  - **direct**: ``erasurehead_tpu_torch.schemes.register(descriptor)``;
  - **entry point**: expose the descriptor (or a zero-arg factory returning
    one) under the ``erasurehead_tpu_torch.schemes`` group::

        [project.entry-points."erasurehead_tpu_torch.schemes"]
        mycode = "mypkg.schemes:MYCODE_DESCRIPTOR"

    Entry points load on the first registry read; a broken one warns once
    on stderr and is ignored.
"""

from __future__ import annotations

import sys
import threading
from typing import Iterable

from erasurehead_tpu_torch.schemes.base import SchemeDescriptor

#: the entry-point group third-party schemes publish under
ENTRY_POINT_GROUP = "erasurehead_tpu_torch.schemes"

_REGISTRY: dict[str, SchemeDescriptor] = {}
_lock = threading.RLock()
_entry_points_loaded = False
_warned: set[str] = set()


def register(desc: SchemeDescriptor) -> SchemeDescriptor:
    """Register a descriptor under its name. Refuses shadowing: a name that
    is already registered (builtin or not) raises; an extension is
    unregistered first."""
    if not isinstance(desc, SchemeDescriptor):
        raise TypeError(
            f"register() takes a SchemeDescriptor, got {type(desc).__name__}"
        )
    with _lock:
        prev = _REGISTRY.get(desc.name)
        if prev is not None:
            raise ValueError(
                f"scheme {desc.name!r} is already registered "
                f"({'builtin' if prev.builtin else 'extension'}); a "
                "registered name is not shadowed"
            )
        _REGISTRY[desc.name] = desc
    return desc


def unregister(name: str) -> None:
    """Remove a non-builtin descriptor (tests, plugin unload)."""
    with _lock:
        desc = _REGISTRY.get(name)
        if desc is None:
            return
        if desc.builtin:
            raise ValueError(f"cannot unregister builtin scheme {name!r}")
        del _REGISTRY[name]


def _ensure_loaded() -> None:
    if not _entry_points_loaded:
        load_entry_points()


def load_entry_points(force: bool = False) -> list[str]:
    """Discover and register ``erasurehead_tpu_torch.schemes`` entry points.

    Each entry point's ``load()`` must yield a :class:`SchemeDescriptor` or a
    zero-arg callable returning one. Returns the names newly registered.
    Broken entry points warn once (stderr) instead of breaking the
    registry. ``force=True`` re-scans."""
    global _entry_points_loaded
    with _lock:
        if _entry_points_loaded and not force:
            return []
        _entry_points_loaded = True
        import importlib.metadata as _md

        try:
            eps = _md.entry_points()
            group: Iterable = (
                eps.select(group=ENTRY_POINT_GROUP)
                if hasattr(eps, "select")
                else eps.get(ENTRY_POINT_GROUP, ())
            )
        except Exception as e:  # noqa: BLE001 - discovery must not raise
            _warn_entry_point("<entry-point scan>", e)
            return []
        added: list[str] = []
        for ep in group:
            try:
                obj = ep.load()
                if callable(obj) and not isinstance(obj, SchemeDescriptor):
                    obj = obj()
                if not isinstance(obj, SchemeDescriptor):
                    raise TypeError(
                        f"entry point yielded {type(obj).__name__}, not a "
                        "SchemeDescriptor"
                    )
                if obj.name not in _REGISTRY:
                    register(obj)
                    added.append(obj.name)
            except Exception as e:  # noqa: BLE001 - isolate bad plugins
                _warn_entry_point(getattr(ep, "name", "?"), e)
        return added


def _warn_entry_point(name: str, err: Exception) -> None:
    """One stderr line per broken entry point per process."""
    key = f"scheme_entry_point:{name}"
    if key in _warned:
        return
    _warned.add(key)
    print(
        f"schemes: entry point {name!r} in group {ENTRY_POINT_GROUP!r} "
        f"failed to load ({type(err).__name__}: {err}); ignoring it",
        file=sys.stderr,
    )


def scheme_name(scheme) -> str:
    """The registry key for a Scheme member, ExtensionScheme or string."""
    return getattr(scheme, "value", None) or str(scheme)


def get(scheme) -> SchemeDescriptor:
    """The descriptor for a scheme (enum member, extension tag, or name);
    ValueError naming the registered schemes otherwise."""
    _ensure_loaded()
    name = scheme_name(scheme)
    desc = _REGISTRY.get(name)
    if desc is None:
        raise ValueError(
            f"unknown scheme {name!r}; registered schemes: {names()}"
        )
    return desc


def is_registered(scheme) -> bool:
    _ensure_loaded()
    return scheme_name(scheme) in _REGISTRY


def names() -> list[str]:
    """All registered scheme names, builtins first (in registration order),
    extensions after, sorted: the CLI ``--scheme`` choices."""
    _ensure_loaded()
    with _lock:
        builtin = [n for n, d in _REGISTRY.items() if d.builtin]
        ext = sorted(n for n, d in _REGISTRY.items() if not d.builtin)
    return builtin + ext


def descriptors() -> list[SchemeDescriptor]:
    _ensure_loaded()
    with _lock:
        return [_REGISTRY[n] for n in names()]
