"""Short-horizon arrival-rate forecasting: Holt smoothing over admissions.

Port of the JAX package's ``tuning/forecast.py``; same decisions on the same inputs.

The just-in-time batch closer (tuning/controller.py) needs one number the
fixed-deadline assembler never had: "when is the NEXT transaction expected?"
This module estimates the instantaneous offered rate from the admission
timestamps the microbatch assembler already sees, with Holt
double-exponential smoothing (level + trend) over fixed time buckets — the short-horizon
forecast the just-in-time dynamic-batching paper (arXiv:1904.07421) closes
batches against, and the same windowed-counting discipline as
``obs.tracing.SloTracker`` (exact on a virtual clock, O(1) memory).

Clock discipline: every ``observe``/``rate`` call carries an explicit
``now`` from ONE clock base (the assembler's monotonic clock in
production, the virtual clock in drills). Counts land in ``bucket_s``-wide
buckets; a bucket folds into the Holt state only once it is COMPLETE
(``now`` has moved past it), so the estimate never oscillates with partial
buckets and a replayed timeline folds identically — decisions are
reproducible bit-for-bit.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

__all__ = ["ArrivalForecaster"]


class ArrivalForecaster:
    """Holt (level+trend) arrival-rate estimator over time buckets."""

    # a silent gap longer than this many buckets re-anchors the state
    # instead of folding thousands of zero buckets one by one (bounds the
    # fold work after an idle period; the result — rate ~0 — is identical)
    MAX_GAP_BUCKETS = 64

    # fast EWMA over observed inter-arrival gaps: the close decision's
    # primary gap estimate. Rate-over-buckets (Holt) answers "what is the
    # trend"; the gap EWMA answers "when is the NEXT txn due" and reacts
    # to a regime change within a handful of arrivals instead of a full
    # counting bucket — the difference between catching a burst's first
    # millisecond and its twentieth
    GAP_ALPHA = 0.25

    def __init__(self, bucket_s: float = 0.02, alpha: float = 0.5,
                 beta: float = 0.2):
        if bucket_s <= 0 or not 0.0 < alpha <= 1.0 or not 0.0 <= beta <= 1.0:
            raise ValueError(
                f"forecaster requires bucket_s > 0, 0 < alpha <= 1, "
                f"0 <= beta <= 1; got bucket_s={bucket_s} alpha={alpha} "
                f"beta={beta}")
        self.bucket_s = float(bucket_s)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.gap_ewma: Optional[float] = None
        self._cur_idx: Optional[int] = None   # bucket currently filling
        self._cur_count = 0
        self.level: Optional[float] = None    # smoothed rate (txn/s)
        self.trend = 0.0                      # txn/s per bucket
        self.last_arrival: Optional[float] = None
        self.observed_total = 0
        self.folds = 0

    # ------------------------------------------------------------- folding
    def _fold_value(self, x: float) -> None:
        """One complete bucket's rate into the Holt recursion."""
        if self.level is None:
            self.level = x
            self.trend = 0.0
        else:
            prev = self.level
            self.level = (self.alpha * x
                          + (1.0 - self.alpha) * (self.level + self.trend))
            self.trend = (self.beta * (self.level - prev)
                          + (1.0 - self.beta) * self.trend)
        self.folds += 1

    def _advance_to(self, idx: int) -> None:
        """Fold every bucket strictly older than ``idx`` (zero-filled
        gaps included, clamped to MAX_GAP_BUCKETS so an idle hour costs
        O(64), not O(hour))."""
        if self._cur_idx is None:
            self._cur_idx = idx
            return
        if idx <= self._cur_idx:
            return
        gap = idx - self._cur_idx
        self._fold_value(self._cur_count / self.bucket_s)
        if gap - 1 > self.MAX_GAP_BUCKETS:
            # long silence: the rate IS ~0 — re-anchor instead of looping
            self.level = 0.0
            self.trend = 0.0
        else:
            for _ in range(gap - 1):
                self._fold_value(0.0)
        self._cur_idx = idx
        self._cur_count = 0

    # ------------------------------------------------------------- observe
    def observe(self, now: float, n: int = 1) -> None:
        """Record ``n`` admissions at time ``now`` (the caller's clock)."""
        if n <= 0:
            return
        self._advance_to(int(now // self.bucket_s))
        self._cur_count += int(n)
        self.observed_total += int(n)
        if self.last_arrival is not None and now >= self.last_arrival:
            # n records since the last observation: each effectively
            # arrived (now - last)/n apart; fold all n EWMA steps at once
            per = (now - self.last_arrival) / n
            if self.gap_ewma is None:
                self.gap_ewma = per
            else:
                w = 1.0 - (1.0 - self.GAP_ALPHA) ** n
                self.gap_ewma = (1.0 - w) * self.gap_ewma + w * per
        if self.last_arrival is None or now > self.last_arrival:
            self.last_arrival = now

    # -------------------------------------------------------------- query
    def rate(self, now: float) -> float:
        """Forecast offered rate (txn/s) for the immediate horizon.

        Folds any buckets ``now`` has completed first, then blends the
        Holt one-step-ahead forecast with the current (partial) bucket's
        observed rate — so a burst is visible within one bucket width,
        not one full bucket behind.
        """
        self._advance_to(int(now // self.bucket_s))
        holt = max(0.0, (self.level or 0.0) + self.trend)
        if self._cur_idx is None:
            return holt
        elapsed = now - self._cur_idx * self.bucket_s
        if elapsed <= 0:
            return holt
        partial = self._cur_count / max(elapsed, self.bucket_s * 0.25)
        # the partial bucket dominates once it has real evidence
        w = min(1.0, elapsed / self.bucket_s)
        return max(0.0, (1.0 - w * self.alpha) * holt
                   + w * self.alpha * partial)

    def expected_gap_s(self, now: float) -> float:
        """Expected inter-arrival time; inf when the forecast rate is ~0.

        The primary estimate is the fast gap EWMA (reacts within a few
        arrivals); the Holt rate is the fallback before any gap has been
        observed. Both are floored by the OBSERVED silence: when
        ``now - last_arrival`` already exceeds the predicted gap, the
        prediction is wrong by direct evidence (a burst just ended, or a
        ramp is falling faster than the smoothing tracks) — believing the
        stale estimate would hold batches open for arrivals that never
        come.
        """
        if self.gap_ewma is not None:
            gap = self.gap_ewma
        else:
            r = self.rate(now)
            gap = 1.0 / r if r > 1e-9 else float("inf")
        if self.last_arrival is not None:
            gap = max(gap, now - self.last_arrival)
        return gap

    def snapshot(self) -> Dict[str, Any]:
        return {
            "level_tps": round(self.level or 0.0, 3),
            "trend_tps": round(self.trend, 3),
            "observed_total": self.observed_total,
            "folds": self.folds,
            "bucket_s": self.bucket_s,
        }
