"""JSON decision cache for measured autotuning verdicts.

The port's copy of erasurehead_tpu/tune/cache.py: the same file format, so
equal decisions serialize to the same bytes in both packages. The default
location is the port's own (``~/.cache/erasurehead_tpu_torch/tune.json``):
a verdict raced on one package's lowerings never resolves the other's.

One file, one dict: ``{"version": 1, "decisions": {"<device_kind>|<race>|
<shape signature>": {"choice": "<candidate>"}}}``. The cache stores ONLY
the verdicts — never timings, timestamps, or host names — so two races at
the same shapes with the same seeds serialize to byte-identical files
(the determinism acceptance bar) and a cache file is portable review
material: the diff of a default flip is one line of JSON.

Writes are atomic (tmp file + ``os.replace`` in the cache's directory), so
a run killed mid-race (chaos site ``tune_race``) leaves either the old
complete file or the new complete file, never a torn one — the
kill->rerun invariance test pins this. Reads tolerate a missing or
corrupt file as an empty cache (the resolver falls back to the hardcoded
default, exactly as if the race never ran).

Lookups are warm-path cheap: the parsed decisions are memoized per
process and re-read only when the file's (mtime_ns, size) stamp moves —
one ``stat(2)`` per resolution, no JSON parse.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Optional

#: env override for the cache file location (tests, smokes, CI isolation)
ENV_PATH = "ERASUREHEAD_TUNE_CACHE"

VERSION = 1


def default_path() -> str:
    env = os.environ.get(ENV_PATH)
    if env:
        return env
    return os.path.join(
        os.path.expanduser("~"), ".cache", "erasurehead_tpu_torch", "tune.json"
    )


def decision_key(device_kind: str, race: str, shape_sig: str) -> str:
    return f"{device_kind}|{race}|{shape_sig}"


def canonical_bytes(decisions: dict) -> bytes:
    """The one serialization of a decision dict: sorted keys, fixed
    separators, trailing newline — byte-identical for equal decisions."""
    doc = {
        "version": VERSION,
        "decisions": {
            k: {"choice": decisions[k]} for k in sorted(decisions)
        },
    }
    return (json.dumps(doc, indent=2, sort_keys=True) + "\n").encode()


class DecisionCache:
    """The decisions behind every resolved ``auto`` knob, as a file."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._decisions: dict = {}
        self._stamp: Optional[tuple] = None

    def _refresh_locked(self) -> None:
        try:
            st = os.stat(self.path)
            stamp = (st.st_mtime_ns, st.st_size)
        except OSError:
            self._decisions, self._stamp = {}, None
            return
        if stamp == self._stamp:
            return
        try:
            with open(self.path) as f:
                doc = json.load(f)
            decisions = {
                str(k): str(v["choice"])
                for k, v in doc.get("decisions", {}).items()
                if isinstance(v, dict) and "choice" in v
            }
        except (OSError, ValueError, KeyError, TypeError):
            # corrupt/unreadable file == empty cache: the resolver falls
            # back to the hardcoded default rather than failing the run
            decisions = {}
        self._decisions, self._stamp = decisions, stamp

    def lookup(
        self, device_kind: str, race: str, shape_sig: str
    ) -> Optional[str]:
        with self._lock:
            self._refresh_locked()
            return self._decisions.get(
                decision_key(device_kind, race, shape_sig)
            )

    def decisions(self) -> dict:
        with self._lock:
            self._refresh_locked()
            return dict(self._decisions)

    def record(
        self, device_kind: str, race: str, shape_sig: str, choice: str
    ) -> None:
        with self._lock:
            self._refresh_locked()
            self._decisions[
                decision_key(device_kind, race, shape_sig)
            ] = str(choice)
            self._write_locked()

    def _write_locked(self) -> None:
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        data = canonical_bytes(self._decisions)
        fd, tmp = tempfile.mkstemp(prefix=".tune-", dir=d)
        closed = False
        try:
            os.write(fd, data)
            os.fsync(fd)
            os.close(fd)
            closed = True
            os.replace(tmp, self.path)
        except BaseException:
            if not closed:
                os.close(fd)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        try:
            st = os.stat(self.path)
            self._stamp = (st.st_mtime_ns, st.st_size)
        except OSError:
            self._stamp = None

    def to_bytes(self) -> bytes:
        with self._lock:
            self._refresh_locked()
            return canonical_bytes(self._decisions)


_caches: dict = {}
_caches_lock = threading.Lock()


def get_cache(path: Optional[str] = None) -> DecisionCache:
    """Process-global memoized cache per path."""
    p = path or default_path()
    with _caches_lock:
        c = _caches.get(p)
        if c is None:
            c = _caches[p] = DecisionCache(p)
        return c


def reset() -> None:
    """Drop memoized caches (tests switching ERASUREHEAD_TUNE_CACHE)."""
    with _caches_lock:
        _caches.clear()
