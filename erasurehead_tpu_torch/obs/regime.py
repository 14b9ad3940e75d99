"""Online arrival-regime estimation: what kind of stragglers are these?

The port's copy of erasurehead_tpu/obs/regime.py (host float64 numpy, the
same estimates on the same rows).

Every adaptive organ in the system keys on the arrival regime — the
bandit's priors (adapt/), the what-if surfaces (whatif/), and ROADMAP
item 4's SLO autoscaler is explicitly blocked on "a live arrival-regime
estimate from obs/ telemetry". This module is that estimate: a
bounded-memory online estimator over the -1-sentinel-masked arrival
stream that answers, at any round,

  - **rate**: the rolling exponential rate 1/mean (arrivals per
    simulated second) over the last ``window_rounds`` rounds;
  - **kind**: light vs heavy tail, by a rolling Hill index over the top
    order statistics of the window — exponential-like streams estimate
    well above :attr:`heavy_tail_below`, Pareto-like streams converge to
    their true tail index below it;
  - **shifted**: change-point detection — the short-window mean jumping
    past ``shift_factor`` in either direction against the
    regime-so-far baseline (the same jump rule the adapt controller's
    private detector used, now policy-independent and shared).

Masking discipline: arrivals are masked exactly like
events.arrival_summary — the -1 never-arrived sentinel and non-finite
entries never enter any statistic. Feed the estimator RAW schedule rows
(adapt/driver.py's shift-detection lesson: collected-masked times are
policy-dependent, and a policy-dependent detector reads every arm
switch as a regime change).

The estimator is a passive consumer: it allocates O(window_rounds * W)
floats, runs host-side, and emits a typed ``regime`` event only when a
change-point fires (plus every ``emit_every`` rounds when asked) — the
observation-only contract is untouched.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Optional

import numpy as np

from erasurehead_tpu_torch.obs import events


@dataclasses.dataclass(frozen=True)
class RegimeEstimate:
    """The queryable answer at one round (immutable snapshot)."""

    round: int  # last round observed
    n: int  # masked arrivals in the rolling window
    mean: Optional[float]  # masked mean arrival (None below min samples)
    rate: Optional[float]  # 1/mean, the rolling exponential rate
    tail_index: Optional[float]  # rolling Hill estimate (None = too few)
    kind: str  # one of events.REGIME_KINDS
    shifted: bool  # change-point fired AT this round
    shift_round: Optional[int]  # most recent change-point round

    def payload(self) -> dict:
        """The ``regime`` event payload (rate 0.0 when unknown: the
        typed field is required, the optional mean carries the None)."""
        out = {
            "round": int(self.round),
            "kind": self.kind,
            "rate": round(self.rate, 6) if self.rate else 0.0,
            "n": int(self.n),
            "shifted": bool(self.shifted),
        }
        if self.mean is not None:
            out["mean"] = round(self.mean, 6)
        if self.tail_index is not None:
            out["tail_index"] = round(self.tail_index, 4)
        if self.shift_round is not None:
            out["shift_round"] = int(self.shift_round)
        return out


def hill_index(samples, top_frac: float = 0.1) -> Optional[float]:
    """Rolling Hill tail-index estimate over the top order statistics.

    alpha_hat = k / sum(log(x_(i) / x_(k+1))) over the k largest
    samples; small alpha = heavy (Pareto-like) tail, exponential streams
    drift well above 2 at this top fraction. None when the window is too
    small (< 4 positive samples above the threshold) to say anything.
    """
    x = np.asarray(samples, dtype=np.float64)
    x = x[np.isfinite(x) & (x > 0.0)]
    if x.size < 5:
        return None
    x = np.sort(x)[::-1]
    k = max(3, int(top_frac * x.size))
    if k + 1 > x.size:
        k = x.size - 1
    threshold = x[k]
    if threshold <= 0.0:
        return None
    logs = np.log(x[:k] / threshold)
    s = float(logs.sum())
    if s <= 0.0:
        return None
    return k / s


class ArrivalRegimeEstimator:
    """Bounded-memory online estimator over masked arrival rounds.

    Feed it per-round raw arrival rows via :meth:`update` (or whole
    chunks via :meth:`update_rounds`); query :meth:`estimate` anytime;
    :meth:`poll_shift` returns True exactly once per detected
    change-point (the adapt controller's flagged shift source).
    """

    def __init__(
        self,
        *,
        window_rounds: int = 32,
        detect_rounds: int = 4,
        min_samples: int = 8,
        shift_factor: float = 2.5,
        heavy_tail_below: float = 2.0,
        top_frac: float = 0.1,
        emit_every: int = 0,
        run_id: Optional[str] = None,
    ):
        if window_rounds < 1 or detect_rounds < 1:
            raise ValueError(
                f"window_rounds/detect_rounds must be >= 1, got "
                f"{window_rounds}/{detect_rounds}"
            )
        if shift_factor <= 1.0:
            raise ValueError(
                f"shift_factor must be > 1, got {shift_factor}"
            )
        self.window_rounds = int(window_rounds)
        self.detect_rounds = int(detect_rounds)
        self.min_samples = int(min_samples)
        self.shift_factor = float(shift_factor)
        self.heavy_tail_below = float(heavy_tail_below)
        self.top_frac = float(top_frac)
        self.emit_every = int(emit_every)
        self.run_id = run_id
        # rolling window of masked per-round sample arrays (rate + tail)
        self._window: collections.deque = collections.deque(
            maxlen=self.window_rounds
        )
        # change-point state: short recent window vs regime-so-far
        # baseline; rounds evicted from the short deque accumulate into
        # the baseline until a shift adopts the new level
        self._short: collections.deque = collections.deque()
        self._base_sum = 0.0
        self._base_n = 0
        self._round = -1
        self._shift_round: Optional[int] = None
        self._pending_shift = False

    # ---- feeding ---------------------------------------------------------

    def update(self, round: int, worker_times_row) -> RegimeEstimate:
        """Observe one round's raw arrival row ([W]; -1 sentinel and
        non-finite entries masked). Returns the post-update estimate."""
        row = np.asarray(worker_times_row, dtype=np.float64).ravel()
        row = row[np.isfinite(row) & (row >= 0.0)]
        self._round = int(round)
        self._window.append(row)
        shifted = self._observe_changepoint(row)
        est = self._estimate(shifted)
        if shifted:
            self._shift_round = self._round
            self._pending_shift = True
            est = self._estimate(shifted)  # shift_round now set
            events.emit("regime", **self._event_fields(est))
        elif self.emit_every > 0 and self._round % self.emit_every == 0:
            events.emit("regime", **self._event_fields(est))
        return est

    def update_rounds(self, start_round: int, rows) -> RegimeEstimate:
        """Observe a [n, W] chunk of raw rounds (adapt/driver chunks)."""
        rows = np.asarray(rows, dtype=np.float64)
        if rows.ndim == 1:
            rows = rows[None, :]
        est = self.estimate()
        for i in range(rows.shape[0]):
            est = self.update(start_round + i, rows[i])
        return est

    # ---- change-point ----------------------------------------------------

    def _observe_changepoint(self, row: np.ndarray) -> bool:
        self._short.append((float(row.sum()), int(row.size)))
        while len(self._short) > self.detect_rounds:
            s, n = self._short.popleft()
            self._base_sum += s
            self._base_n += n
        short_sum = sum(s for s, _ in self._short)
        short_n = sum(n for _, n in self._short)
        if (
            len(self._short) < self.detect_rounds
            or short_n < 1
            or self._base_n < self.min_samples
        ):
            return False
        short_mean = short_sum / short_n
        base_mean = self._base_sum / self._base_n
        lo, hi = sorted((max(short_mean, 1e-12), max(base_mean, 1e-12)))
        if hi / lo < self.shift_factor:
            return False
        # adopt the new level: the short window becomes the baseline of
        # the new regime, so one shift fires once, not every round after
        self._base_sum = short_sum
        self._base_n = short_n
        self._short.clear()
        return True

    def poll_shift(self) -> bool:
        """True exactly once per detected change-point since the last
        poll (the adapt controller's shift_source="regime" signal)."""
        fired = self._pending_shift
        self._pending_shift = False
        return fired

    # ---- querying --------------------------------------------------------

    def estimate(self) -> RegimeEstimate:
        return self._estimate(False)

    def _estimate(self, shifted: bool) -> RegimeEstimate:
        samples = (
            np.concatenate(list(self._window))
            if self._window
            else np.empty(0)
        )
        n = int(samples.size)
        if n < self.min_samples:
            return RegimeEstimate(
                round=self._round, n=n, mean=None, rate=None,
                tail_index=None, kind="unknown", shifted=shifted,
                shift_round=self._shift_round,
            )
        mean = float(samples.mean())
        rate = 1.0 / mean if mean > 0 else math.inf
        tail = hill_index(samples, self.top_frac)
        kind = (
            "heavytail"
            if tail is not None and tail <= self.heavy_tail_below
            else "exp"
        )
        return RegimeEstimate(
            round=self._round, n=n, mean=mean,
            rate=rate if math.isfinite(rate) else None,
            tail_index=tail, kind=kind, shifted=shifted,
            shift_round=self._shift_round,
        )

    def _event_fields(self, est: RegimeEstimate) -> dict:
        fields = est.payload()
        if self.run_id is not None:
            fields["run_id"] = self.run_id
        return fields
