"""Online membership detection: who is still in the cluster, from the
run's own telemetry.

The port's copy of erasurehead_tpu/elastic/controller.py: host float64
numpy over the port's parallel/failures.py, so on equal telemetry its
decisions and snapshots equal the JAX package's.

The framework's failure handling so far needed the deaths HANDED to it:
``parallel/failures.train_elastic`` re-shards only when the caller scripts
``{worker: round}`` in advance, and the adapt/ bandit switches collection
policy but never the worker count. This module closes the loop the
reference's README concedes is open (README.md:120-122 — any death hangs
its master forever): membership decisions are derived from what the run
itself observed, never from ground truth the master could not have.

Detection rules (ElasticConfig knobs, deterministic by construction):

  - **death (streak rule)** — a worker whose telemetry column carries the
    ``-1`` never-collected sentinel (or a ``detect_dead`` timeout trip,
    parallel/failures.py) for ``death_rounds`` CONSECUTIVE *evidential*
    rounds is declared dead. A round is evidential for worker w only when
    the master actually listened out its patience window (the round's
    sim clock reached ``min(timeout, deadline)``): under early-stopping
    policies (AGC's first-``num_collect`` rule, avoidstragg) the sentinel
    routinely marks workers the master simply STOPPED LISTENING for, and
    counting those as death evidence evicts healthy workers — measured at
    the canonical W=30 collect=15 config, an ungated K=3 streak rule
    declared 5 false deaths in 32 rounds. The streak must be consecutive:
    an in-patience arrival resets it to zero (the satellite test pins the
    all--1 vs transiently-slow distinction); a non-evidential round
    leaves it unchanged (absence of evidence is not evidence of life).
  - **death (absence rule)** — evidential rounds only exist while the
    death COSTS clock (failover/deadline rounds); a scheme with slack
    (AGC with ``alive >= num_collect``) keeps ending rounds early, so a
    dead worker there never produces one. The long-window backstop: a
    worker uncollected for ``absence_rounds`` consecutive rounds
    (default ``5 * death_rounds``) is declared dead regardless of
    evidence — a healthy worker under rotating early-stop policies is
    uncollected with probability well under 1 per round, so a long
    all-absent run is overwhelmingly a departure (or a worker so
    persistently slow that evicting it and re-sharding its partition is
    the right call anyway).
  - **collapse probe** — a chunk whose masked arrival mean jumps past
    ``shift_factor`` vs the previous chunk (the adapt/ shift detector's
    rule) triggers a membership re-evaluation: suspicion streaks of at
    least ``ceil(death_rounds / 2)`` are treated as corroborated and
    promoted to deaths — a collapsed arrival regime plus a persistent
    silent worker is evidence of the same event (a machine going away),
    and waiting the full K rounds just burns timeout-priced rounds.
  - **join** — an external offer (a chaos ``worker_revive``, a scripted
    revive, a widened mesh) queues a worker id; it enters the layout at
    the next commit. Joins are offers, not telemetry: a worker outside
    the layout produces none.

All decisions are recorded (``decisions``) and the full state snapshots to
JSON (:meth:`snapshot` / :meth:`restore`) so a killed-and-resumed elastic
run replays the identical decision sequence — the same determinism
contract the adapt/ controller carries.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Knobs of the online membership controller (+ its chunked driver)."""

    #: rounds per chunk — the restart/decision granularity (the
    #: initial_state/initial_round seam runs this many rounds at a time)
    chunk_rounds: int = 10
    #: K: consecutive never-arrived (or timed-out) rounds that declare a
    #: worker dead (the CLI's --death-rounds)
    death_rounds: int = 3
    #: per-round master patience in simulated seconds: arrivals beyond it
    #: are presumed dead for the round (failures.detect_dead) and failover
    #: stamps the round's clock at this value — must be finite, it is what
    #: keeps the master from inheriting the reference's hang-forever
    timeout: float = 5.0
    #: never shrink the layout below this many workers
    min_workers: int = 1
    #: arrival-mean jump factor (vs the previous chunk) that flags a
    #: collapsed regime and triggers the corroborated re-evaluation
    shift_factor: float = 2.5
    #: the long-window absence backstop (module docstring): a worker
    #: uncollected this many CONSECUTIVE rounds is dead even if no round
    #: was evidential. None = 5 * death_rounds.
    absence_rounds: Optional[int] = None
    #: seed for the composed adapt bandit (arms re-seed per epoch as
    #: seed + epoch); detection itself is threshold-based and seed-free
    seed: int = 0

    @property
    def effective_absence_rounds(self) -> int:
        return (
            self.absence_rounds
            if self.absence_rounds is not None
            else 5 * self.death_rounds
        )

    def __post_init__(self):
        if self.chunk_rounds < 1:
            raise ValueError(
                f"chunk_rounds must be >= 1, got {self.chunk_rounds}"
            )
        if self.death_rounds < 1:
            raise ValueError(
                f"death_rounds must be >= 1, got {self.death_rounds}"
            )
        if not np.isfinite(self.timeout) or self.timeout <= 0:
            raise ValueError(
                f"timeout must be finite and > 0, got {self.timeout!r} — "
                "an infinite master patience is the reference's "
                "hang-forever semantics, which this controller exists to "
                "remove"
            )
        if self.min_workers < 1:
            raise ValueError(
                f"min_workers must be >= 1, got {self.min_workers}"
            )
        if self.shift_factor <= 1.0:
            raise ValueError(
                f"shift_factor must be > 1, got {self.shift_factor}"
            )
        if self.absence_rounds is not None and (
            self.absence_rounds < self.death_rounds
        ):
            raise ValueError(
                f"absence_rounds ({self.absence_rounds}) must be >= "
                f"death_rounds ({self.death_rounds}) — the no-evidence "
                "backstop cannot be stricter than the evidential rule"
            )


@dataclasses.dataclass(frozen=True)
class ChunkObservation:
    """What one chunk's telemetry told the detector."""

    first_round: int
    #: workers newly suspected dead this chunk (streak >= threshold);
    #: they become deaths at the next commit
    deaths: tuple
    #: the collapsed-arrival probe fired (shift_factor jump)
    collapse: bool
    #: masked mean arrival of the chunk (None = nobody arrived)
    arrival_mean: Optional[float]


@dataclasses.dataclass(frozen=True)
class MembershipChange:
    """One committed re-layout: who left, who joined, W -> W'."""

    round: int
    dead: tuple
    joined: tuple
    n_workers_before: int
    n_workers_after: int


class MembershipController:
    """Tracks the believed-alive worker set from per-chunk telemetry
    (class docstring). Worker ids are ORIGINAL ids — the layout over W'
    survivors maps its columns back through :attr:`active`."""

    def __init__(self, n_workers: int, cfg: ElasticConfig = None):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self.cfg = cfg or ElasticConfig()
        self.n_workers = int(n_workers)
        self.active: tuple = tuple(range(n_workers))
        self.dead: tuple = ()
        self.epoch = 0
        self._streaks = {w: 0 for w in range(n_workers)}
        self._absence = {w: 0 for w in range(n_workers)}
        self._last_mean: Optional[float] = None
        self._pending_deaths: list = []
        self._pending_joins: list = []
        self.decisions: list[dict] = []

    # ---- telemetry feedback ----------------------------------------------

    def observe_chunk(
        self,
        first_round: int,
        worker_times: np.ndarray,
        sim_time: Optional[np.ndarray] = None,
        window: Optional[float] = None,
    ) -> ChunkObservation:
        """Feed one chunk's [n, W'] telemetry clock block (columns in
        :attr:`active` order, carrying the -1 never-collected sentinel).
        Updates suspicion streaks and the collapse detector; newly
        suspected workers become pending deaths, applied at the next
        :meth:`commit`.

        ``sim_time`` is the chunk's [n] per-round simulated clock and
        ``window`` the master's per-round listening window (the driver
        passes ``min(timeout, deadline)``): a round is EVIDENTIAL only
        when its clock ran the window out — a sentinel in a round the
        master ended early means "stopped listening", not "dead" (module
        docstring). Without ``sim_time`` every round counts as
        evidential (the raw detect_dead view of a clock block)."""
        from erasurehead_tpu_torch.obs import events as obs_events
        from erasurehead_tpu_torch.parallel import failures

        wt = np.asarray(worker_times, dtype=np.float64)
        if wt.ndim != 2 or wt.shape[1] != len(self.active):
            raise ValueError(
                f"worker_times shape {wt.shape} does not match the "
                f"{len(self.active)} active workers"
            )
        # detect_dead reads the sentinel AND the timeout trip in one rule:
        # negative (never collected) or beyond the master's patience
        suspect = failures.detect_dead(wt, self.cfg.timeout)
        if sim_time is None:
            evidential = np.ones(wt.shape[0], dtype=bool)
        else:
            win = self.cfg.timeout if window is None else float(window)
            evidential = (
                np.asarray(sim_time, dtype=np.float64)
                >= win * (1.0 - 1e-9)
            )
        for j, w in enumerate(self.active):
            col = suspect[:, j]
            streak = self._streaks.get(w, 0)
            absent = self._absence.get(w, 0)
            for r, s in enumerate(col):  # rounds in order
                if not s:
                    # an in-patience arrival resets both rules
                    streak = 0
                    absent = 0
                else:
                    absent += 1
                    if evidential[r]:
                        streak += 1
                    # non-evidential absence leaves the streak unchanged:
                    # absence of evidence is not evidence of life
            self._streaks[w] = int(streak)
            self._absence[w] = int(absent)
        K = self.cfg.death_rounds
        threshold = {w: K for w in self.active}

        # collapse probe: the adapt/ shift rule on the chunk's own masked
        # arrival stats — policy-independent enough here because a genuine
        # collapse moves the mean regardless of which workers arrive
        mean = obs_events.arrival_summary(wt)["mean"]
        prev_mean = self._last_mean
        collapse = False
        if mean is not None and prev_mean is not None:
            lo, hi = sorted((max(mean, 1e-12), max(prev_mean, 1e-12)))
            collapse = hi / lo >= self.cfg.shift_factor
        if mean is not None:
            self._last_mean = mean
        if collapse:
            # corroborated threshold: the collapse and a persistent silent
            # worker are evidence of one event — promote half-streaks
            half = max(1, math.ceil(K / 2))
            threshold = {w: half for w in self.active}

        pending = set(self._pending_deaths)
        absence_limit = self.cfg.effective_absence_rounds
        deaths = []
        for w in self.active:
            if w in pending:
                continue
            by_streak = self._streaks[w] >= threshold[w]
            by_absence = self._absence[w] >= absence_limit
            if by_streak or by_absence:
                deaths.append(w)
                self.decisions.append({
                    "action": "death", "round": int(first_round),
                    "worker": int(w), "streak": int(self._streaks[w]),
                    "absent": int(self._absence[w]),
                    "rule": "streak" if by_streak else "absence",
                    "threshold": int(threshold[w]),
                    "corroborated": bool(collapse),
                })
        self._pending_deaths.extend(deaths)
        if collapse:
            self.decisions.append({
                "action": "probe", "round": int(first_round),
                "arrival_mean": mean, "prev_mean": prev_mean,
            })
        return ChunkObservation(
            first_round=int(first_round),
            deaths=tuple(deaths),
            collapse=collapse,
            arrival_mean=mean,
        )

    # ---- join offers ------------------------------------------------------

    def request_join(self, worker: int, round: int = 0) -> bool:
        """Queue a join offer for ``worker`` (an original id). Returns
        False (ignored) when the worker is already active or queued."""
        w = int(worker)
        if not 0 <= w < self.n_workers:
            raise ValueError(
                f"join offer for worker {w} outside [0, {self.n_workers})"
            )
        if w in self.active or w in self._pending_joins:
            return False
        self._pending_joins.append(w)
        self.decisions.append({
            "action": "join", "round": int(round), "worker": w,
        })
        return True

    # ---- commit -----------------------------------------------------------

    def commit(self, round: int) -> Optional[MembershipChange]:
        """Apply pending deaths and joins at a chunk boundary; returns the
        change (triggering a re-layout) or None when membership is
        unchanged. Deaths are dropped lowest-id-first if applying all of
        them would shrink below ``min_workers`` (deterministic; the kept
        suspects stay pending and re-commit once joins restore headroom)."""
        before = self.active
        deaths = sorted(set(self._pending_deaths) & set(before))
        joins = sorted(
            w for w in self._pending_joins if w not in before
        )
        new = [w for w in before if w not in deaths] + joins
        if len(new) < self.cfg.min_workers:
            keep = self.cfg.min_workers - len(new)
            kept, deaths = deaths[:keep], deaths[keep:]
            new = sorted(new + kept)
        if not new:
            raise RuntimeError("membership commit left zero workers")
        new = tuple(sorted(new))
        applied = set(deaths)
        # suspects kept alive by the min_workers floor stay pending — they
        # re-commit as soon as a join restores headroom
        self._pending_deaths = [
            w for w in self._pending_deaths
            if w not in applied and w in new
        ]
        self._pending_joins = []
        if new == before:
            return None
        self.active = new
        self.dead = tuple(sorted(set(range(self.n_workers)) - set(new)))
        for w in joins:
            self._streaks[w] = 0  # a joiner starts with a clean slate
            self._absence[w] = 0
        self.epoch += 1
        change = MembershipChange(
            round=int(round),
            dead=tuple(deaths),
            joined=tuple(joins),
            n_workers_before=len(before),
            n_workers_after=len(new),
        )
        self.decisions.append({
            "action": "relayout", "round": int(round),
            "dead": list(change.dead), "joined": list(change.joined),
            "n_workers": len(new), "epoch": self.epoch,
        })
        return change

    # ---- persistence ------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-serializable full state (checkpoint aux sidecar): restoring
        it and replaying the same telemetry reproduces the same decisions."""
        return {
            "n_workers": self.n_workers,
            "active": list(self.active),
            "dead": list(self.dead),
            "epoch": self.epoch,
            "streaks": {str(w): s for w, s in self._streaks.items()},
            "absence": {str(w): s for w, s in self._absence.items()},
            "last_mean": self._last_mean,
            "pending_deaths": list(self._pending_deaths),
            "pending_joins": list(self._pending_joins),
            "decisions": list(self.decisions),
        }

    @classmethod
    def restore(
        cls, snap: dict, cfg: ElasticConfig = None
    ) -> "MembershipController":
        ctl = cls(int(snap["n_workers"]), cfg)
        ctl.active = tuple(int(w) for w in snap["active"])
        ctl.dead = tuple(int(w) for w in snap["dead"])
        ctl.epoch = int(snap["epoch"])
        ctl._streaks = {int(w): int(s) for w, s in snap["streaks"].items()}
        ctl._absence = {
            int(w): int(s)
            for w, s in snap.get("absence", {}).items()
        }
        ctl._last_mean = snap.get("last_mean")
        ctl._pending_deaths = [int(w) for w in snap["pending_deaths"]]
        ctl._pending_joins = [int(w) for w in snap["pending_joins"]]
        ctl.decisions = list(snap.get("decisions", []))
        return ctl


class ProbeStreakDetector:
    """The evidential-streak death rule, generalized to probe-based
    membership over NAMED members (string ids, not worker columns).

    This is the same discipline :class:`MembershipController` applies to
    telemetry columns, lifted out for callers that watch liveness through
    explicit probes — the JAX package's serve fleet (serve/fleet.py)
    probing each replica's ``/healthz``: a member is declared dead only after ``k``
    CONSECUTIVE *evidential* misses. A probe is evidential only when it
    was actually ATTEMPTED and ran its window out (connect refused, read
    timeout, bad status); a probe the caller never made — the prober was
    paused, the member was deliberately drained for a rolling deploy —
    is not evidence, and leaves the streak unchanged (absence of
    evidence is not evidence of life, and equally not of death). One
    success resets the streak to zero. Never one timeout: ``k >= 2`` is
    enforced, because a single miss declaring death is exactly the
    reference's raw-timeout semantics this module exists to remove.
    """

    def __init__(self, members: Sequence[str] = (), k: int = 3):
        if k < 2:
            raise ValueError(
                f"k must be >= 2, got {k} — a single evidential miss "
                "declaring death is a raw timeout, not a streak rule"
            )
        self.k = int(k)
        self._streaks: dict[str, int] = {str(m): 0 for m in members}
        self._dead: set[str] = set()

    @property
    def members(self) -> tuple:
        return tuple(sorted(self._streaks))

    def add(self, member: str) -> None:
        """(Re)admit a member with a clean slate — a joiner (or a
        bounced replica re-entering the ring) starts at streak zero."""
        m = str(member)
        self._streaks[m] = 0
        self._dead.discard(m)

    def remove(self, member: str) -> None:
        m = str(member)
        self._streaks.pop(m, None)
        self._dead.discard(m)

    def observe(
        self, member: str, ok: bool, evidential: bool = True
    ) -> int:
        """Feed one probe outcome; returns the member's updated streak.
        ``ok`` resets the streak; a miss advances it only when the probe
        was evidential (actually attempted to completion)."""
        m = str(member)
        if m not in self._streaks:
            raise KeyError(f"unknown member {m!r}")
        if ok:
            self._streaks[m] = 0
            self._dead.discard(m)
        elif evidential:
            self._streaks[m] += 1
            if self._streaks[m] >= self.k:
                self._dead.add(m)
        return self._streaks[m]

    def streak(self, member: str) -> int:
        return self._streaks[str(member)]

    def is_dead(self, member: str) -> bool:
        return str(member) in self._dead

    def snapshot(self) -> dict:
        return {
            "k": self.k,
            "streaks": dict(self._streaks),
            "dead": sorted(self._dead),
        }

    @classmethod
    def restore(cls, snap: dict) -> "ProbeStreakDetector":
        det = cls(k=int(snap["k"]))
        det._streaks = {
            str(m): int(s) for m, s in snap["streaks"].items()
        }
        det._dead = {str(m) for m in snap.get("dead", [])}
        return det


def auto_survivor_config(
    cfg, n_active: int, survivor_overrides: Optional[dict] = None,
    lr_schedule=None,
):
    """A validated config for ``n_active`` workers, auto-shrinking
    ``n_stragglers`` when the scheme's structural constraint (FRC's
    ``(s+1) | W'``) rejects the current value.

    An explicit ``n_stragglers`` in ``survivor_overrides`` is honored
    as-is (its failure propagates — the caller asked for exactly that);
    otherwise the controller tries s, s-1, ..., 0 and takes the largest
    valid value, so an online re-layout never dies on a divisibility
    accident the operator is not around to fix. Returns the config (the
    chosen s is readable off it)."""
    from erasurehead_tpu_torch.parallel import failures

    explicit = (survivor_overrides or {}).get("n_stragglers") is not None
    if explicit:
        return failures.survivor_config(
            cfg, n_active, survivor_overrides, lr_schedule=lr_schedule
        )
    last_err = None
    for s in range(cfg.n_stragglers, -1, -1):
        ov = dict(survivor_overrides or {})
        ov["n_stragglers"] = s
        try:
            return failures.survivor_config(
                cfg, n_active, ov, lr_schedule=lr_schedule
            )
        except ValueError as e:
            last_err = e
    raise last_err


def default_join_offers(
    revives, active: Sequence[int], boundary_round: int
) -> list[int]:
    """Scripted revives (``{worker: round}``) whose round has passed and
    whose worker is not in the active layout — the scripted counterpart
    of a chaos ``worker_revive`` offer."""
    if not revives:
        return []
    act = set(active)
    return sorted(
        int(w)
        for w, r in revives.items()
        if int(r) <= boundary_round and int(w) not in act
    )
