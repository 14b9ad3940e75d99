"""The online straggler-adaptive collection controller.

The port's copy of erasurehead_tpu/adapt/controller.py: host float64 numpy
and a seeded ``numpy`` Generator, so on equal telemetry the port's
decisions, values and state dicts equal the JAX package's bit for bit.

The telemetry subsystem (obs/) was built to be consumed, not just
rendered: every run already measures its per-round decode-error norm
(obs/decode.py — the central quantity of arXiv:2006.09638) and masked
arrival statistics (obs/events.arrival_summary), yet collection policy is
fixed for the whole run. This module closes the loop: a discounted-reward
bandit over registry-compatible *arms* — (scheme, collect count, deadline)
triples sharing the run's device data stack — reads each chunk's own
telemetry and switches policy when the straggler regime shifts, exactly
the non-stationary setting where "Fundamental Limits of Approximate
Gradient Coding" (arXiv:1901.08166) shows a fixed policy costs the most.

Design constraints, in order:

  1. **Determinism.** Decisions are a pure function of (seed, observed
     telemetry); telemetry under the simulated-arrival trainer is itself
     deterministic, so a killed-and-rerun adaptive run replays the same
     decision sequence bitwise (the kill→resume invariance the chaos
     harness pins, composing with the sweep journal's resume). Exploration
     uses a seeded ``numpy`` Generator, never wall-clock or OS entropy.
  2. **Observability.** Every decision is journaled as a typed ``adapt``
     event (obs/events.py) carrying the chosen arm, the reason
     (warmup/exploit/explore/regime_shift), and the per-arm value
     snapshot — a run's policy trajectory is reconstructible from its
     event log alone.
  3. **Cheap switches.** Arms must be registry-compatible — same
     layout-stack signature, so an arm switch is a new per-round weight
     table, never a re-upload: every chunk's train() finds the stack the
     first chunk uploaded in the device data cache (train/cache.py).

Reward: the controller maximizes *useful progress per simulated second*.
The default ``reward_mode="progress"`` scores a chunk as the training-
loss decrease it achieved divided by the simulated seconds it cost
(the driver measures the loss at each chunk boundary from a one-snapshot
eval replay) — exactly the quantity time-to-target integrates, so the
bandit's optimum is the time-to-target optimum in each regime. It also
self-corrects the speed/error tradeoff: an aggressive low-collect arm
earns big rewards while far from convergence and near zero once its decode
error floors its progress, at which point the controller escalates to a
lower-error arm. ``reward_mode="time_error"`` is the telemetry-only
fallback (no loss evals): ``-(sim_seconds/round) * (1 + error_penalty *
decode_error_mean^2)`` — the clock inflated by how wrong the decoded
gradient was.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Arm:
    """One collection policy the controller may run a chunk under."""

    scheme: str
    num_collect: Optional[int] = None
    deadline: Optional[float] = None

    @property
    def label(self) -> str:
        parts = [self.scheme]
        if self.num_collect is not None:
            parts.append(f"c{self.num_collect}")
        if self.deadline is not None:
            parts.append(f"d{self.deadline:g}")
        return ":".join(parts)

    def overrides(self) -> dict:
        """dataclasses.replace() kwargs turning a base config into this
        arm's config (None fields keep the base value — a deadline-less
        arm must not clear the base deadline another arm needs)."""
        out: dict = {"scheme": self.scheme}
        if self.num_collect is not None:
            out["num_collect"] = self.num_collect
        if self.deadline is not None:
            out["deadline"] = self.deadline
        return out


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Knobs of the chunk-boundary bandit."""

    #: rounds per decision window (the scan runs chunk_rounds at a time)
    chunk_rounds: int = 10
    #: discount on older observations per new one (0 = only the latest
    #: chunk counts, 1 = plain running mean). Small = fast re-adaptation.
    discount: float = 0.5
    #: seeded epsilon-greedy exploration rate after the warm-up pass
    epsilon: float = 0.1
    #: "progress" (default): reward = chunk loss decrease / sim seconds
    #: (the driver measures chunk-boundary losses); "time_error": the
    #: telemetry-only fallback reward (module docstring)
    reward_mode: str = "progress"
    #: decode-error penalty weight in the time_error reward
    error_penalty: float = 25.0
    #: arrival-mean jump factor (vs the previous chunk) that flags a
    #: regime shift and resets the per-arm values so the bandit
    #: re-explores instead of trusting stale pre-shift rewards
    shift_factor: float = 2.5
    #: where the shift verdict comes from: "chunk_mean" (default — the
    #: controller's own arrival-mean jump rule above) or "regime" — the
    #: caller passes the live estimator's verdict into ``observe``
    #: (obs/regime.ArrivalRegimeEstimator.poll_shift, which sees every
    #: ROUND's arrivals instead of one mean per chunk and also carries
    #: the tail-index change-point machinery)
    shift_source: str = "chunk_mean"
    #: exploration seed (decision replay: same seed + same telemetry ->
    #: same decisions, bitwise)
    seed: int = 0
    #: observation weight a simulated prior counts as (controller
    #: ``priors``): 1.0 = one real chunk's worth of evidence — strong
    #: enough to skip the warm-up visit, weak enough that one real
    #: observation halves its influence under the default discount
    prior_weight: float = 1.0

    def __post_init__(self):
        if self.chunk_rounds < 1:
            raise ValueError(
                f"chunk_rounds must be >= 1, got {self.chunk_rounds}"
            )
        if not 0.0 <= self.discount <= 1.0:
            raise ValueError(f"discount must be in [0, 1], got {self.discount}")
        if not 0.0 <= self.epsilon < 1.0:
            raise ValueError(f"epsilon must be in [0, 1), got {self.epsilon}")
        if self.reward_mode not in ("progress", "time_error"):
            raise ValueError(
                f"reward_mode must be progress/time_error, got "
                f"{self.reward_mode!r}"
            )
        if self.shift_factor <= 1.0:
            raise ValueError(
                f"shift_factor must be > 1, got {self.shift_factor}"
            )
        if self.shift_source not in ("chunk_mean", "regime"):
            raise ValueError(
                f"shift_source must be chunk_mean/regime, got "
                f"{self.shift_source!r}"
            )
        if self.prior_weight <= 0.0:
            raise ValueError(
                f"prior_weight must be > 0, got {self.prior_weight}"
            )


@dataclasses.dataclass(frozen=True)
class ChunkStats:
    """What the controller reads back after one chunk: the run's OWN
    telemetry quantities (obs/decode.py error norms, obs/events
    arrival_summary fields), never anything the trainers don't already
    produce."""

    n_rounds: int
    sim_time: float  # summed simulated seconds of the chunk
    decode_error_mean: float  # mean ||pw - 1||/sqrt(P) over the chunk
    arrival_mean: Optional[float]  # masked mean arrival (None = none arrived)
    arrival_p90: Optional[float]
    #: training-loss decrease over the chunk (loss at the previous chunk
    #: boundary minus loss at this one); None = the driver did not
    #: measure boundary losses (reward_mode="time_error")
    loss_delta: Optional[float] = None

    @property
    def sim_per_round(self) -> float:
        return self.sim_time / max(self.n_rounds, 1)


class AdaptiveController:
    """Discounted-reward epsilon-greedy bandit over arms (module docstring).

    ``choose()`` -> (arm_index, reason); ``observe(arm_index, stats)``
    feeds the chunk's telemetry back. The decision log (``decisions``)
    is the journal payload: one dict per choice, stable field order.

    ``priors`` seeds the cold start from a what-if surface
    (whatif/surface.Surface.adapt_priors): {arm label: prior value} in
    the controller's own reward units. A primed arm starts with its
    simulated expected reward at ``cfg.prior_weight`` observations of
    evidence instead of zero at zero — so the warm-up pass (which
    otherwise burns one chunk per arm exploring policies the registry's
    simulation could already rank) only visits arms the surface could
    NOT speak for, and the first free choice exploits the simulated
    ranking. Real telemetry then overwrites the prior at the discount's
    usual pace; a detected regime shift still wipes primed values — the
    priors were conditioned on the regime that just ended.
    """

    def __init__(
        self,
        arms: Sequence[Arm],
        cfg: ControllerConfig = None,
        priors: Optional[dict] = None,
    ):
        self.arms = list(arms)
        if not self.arms:
            raise ValueError("AdaptiveController needs at least one arm")
        labels = [a.label for a in self.arms]
        if len(set(labels)) != len(labels):
            raise ValueError(f"duplicate arms: {labels}")
        self.cfg = cfg or ControllerConfig()
        self._rng = np.random.default_rng(self.cfg.seed)
        n = len(self.arms)
        # discounted value estimate + discounted observation weight per arm
        self._value = np.zeros(n)
        self._weight = np.zeros(n)
        self.priors = dict(priors) if priors else {}
        if self.priors:
            unknown = sorted(set(self.priors) - set(labels))
            if unknown:
                raise ValueError(
                    f"priors name unknown arms {unknown}; controller arms "
                    f"are {labels}"
                )
            for i, label in enumerate(labels):
                if label in self.priors:
                    self._value[i] = float(self.priors[label])
                    self._weight[i] = self.cfg.prior_weight
        self._last_arrival_mean: Optional[float] = None
        self._chunk_index = 0
        self._pending_shift = False
        self.decisions: list[dict] = []

    # ---- policy ----------------------------------------------------------

    def choose(self) -> tuple[int, str]:
        """Pick the next chunk's arm. Warm-up visits every arm once (in
        order — deterministic), then epsilon-greedy on discounted value;
        a detected regime shift forces a fresh warm-up pass (the stale
        values were reset by ``observe``)."""
        unvisited = np.flatnonzero(self._weight == 0.0)
        if unvisited.size:
            idx = int(unvisited[0])
            reason = "regime_shift" if self._pending_shift else "warmup"
        elif self._rng.random() < self.cfg.epsilon:
            idx = int(self._rng.integers(len(self.arms)))
            reason = "explore"
        else:
            idx = int(np.argmax(self._value))
            reason = "exploit"
        self.decisions.append(
            {
                "chunk": self._chunk_index,
                "arm": self.arms[idx].label,
                "arm_index": idx,
                "reason": reason,
                "values": [round(float(v), 8) for v in self._value],
            }
        )
        self._chunk_index += 1
        return idx, reason

    # ---- feedback --------------------------------------------------------

    def reward(self, stats: ChunkStats) -> float:
        if self.cfg.reward_mode == "progress" and stats.loss_delta is not None:
            # loss decrease per simulated second — the quantity
            # time-to-target integrates (negative when the arm regressed)
            return float(stats.loss_delta) / max(stats.sim_time, 1e-9)
        err = float(stats.decode_error_mean)
        return -stats.sim_per_round * (
            1.0 + self.cfg.error_penalty * err * err
        )

    def observe(
        self,
        arm_index: int,
        stats: ChunkStats,
        regime_shift: Optional[bool] = None,
    ) -> Optional[str]:
        """Feed one chunk's telemetry back; returns "regime_shift" when
        the arrival statistics jumped past ``shift_factor`` (per-arm
        values are then reset so the next choices re-explore — the
        discounted estimates from the old regime are evidence about a
        world that no longer exists).

        Under ``shift_source="regime"`` the jump rule is replaced by the
        caller's verdict: ``regime_shift`` is the live estimator's
        ``poll_shift()`` for this chunk (obs/regime.py), and a chunk
        observed without a verdict falls back to the jump rule so a
        driver that stopped feeding the estimator degrades to the old
        behavior instead of going shift-blind."""
        r = self.reward(stats)
        g = self.cfg.discount
        self._weight *= g
        self._value[arm_index] = (
            (self._value[arm_index] * self._weight[arm_index] + r)
            / (self._weight[arm_index] + 1.0)
        )
        self._weight[arm_index] += 1.0
        shift = None
        mean = stats.arrival_mean
        use_verdict = (
            self.cfg.shift_source == "regime" and regime_shift is not None
        )
        if use_verdict:
            shifted = bool(regime_shift)
        else:
            shifted = False
            if mean is not None and self._last_arrival_mean is not None:
                lo, hi = sorted(
                    (max(mean, 1e-12), max(self._last_arrival_mean, 1e-12))
                )
                shifted = hi / lo >= self.cfg.shift_factor
        if shifted:
            shift = "regime_shift"
            # keep only THIS chunk's reward (it is from the new
            # regime); every other arm restarts from scratch
            self._value[:] = 0.0
            self._weight[:] = 0.0
            self._value[arm_index] = r
            self._weight[arm_index] = 1.0
            self._pending_shift = True
        if shift is None:
            self._pending_shift = False
        self._last_arrival_mean = mean
        return shift

    # ---- introspection ---------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "arms": [a.label for a in self.arms],
            "values": [round(float(v), 8) for v in self._value],
            "weights": [round(float(w), 6) for w in self._weight],
            "chunks": self._chunk_index,
        }

    # ---- persistence (elastic/driver.py checkpoints the bandit in its
    # aux sidecar so a killed->resumed elastic-with-adapt run replays the
    # identical arm sequence: values, weights AND the exploration rng
    # state all round-trip through JSON exactly)

    def state_dict(self) -> dict:
        """JSON-serializable full state; :meth:`load_state_dict` restores
        it bitwise (floats survive JSON via repr round-trip, the seeded
        Generator via its bit_generator state dict)."""
        import json

        return {
            "value": [float(v) for v in self._value],
            "weight": [float(w) for w in self._weight],
            "last_arrival_mean": self._last_arrival_mean,
            "chunk_index": self._chunk_index,
            "pending_shift": self._pending_shift,
            "decisions": list(self.decisions),
            # the bit-generator state is plain ints/lists after one JSON
            # round-trip, matching what a restored aux sidecar holds
            "rng_state": json.loads(
                json.dumps(self._rng.bit_generator.state)
            ),
        }

    def load_state_dict(self, state: dict) -> None:
        n = len(self.arms)
        value = np.asarray(state["value"], dtype=np.float64)
        weight = np.asarray(state["weight"], dtype=np.float64)
        if value.shape != (n,) or weight.shape != (n,):
            raise ValueError(
                f"state_dict covers {value.shape[0]} arms, controller has "
                f"{n} — arm sets must match to restore"
            )
        self._value = value
        self._weight = weight
        self._last_arrival_mean = state.get("last_arrival_mean")
        self._chunk_index = int(state["chunk_index"])
        self._pending_shift = bool(state.get("pending_shift", False))
        self.decisions = list(state.get("decisions", []))
        rng_state = state.get("rng_state")
        if rng_state is not None:
            self._rng.bit_generator.state = rng_state
