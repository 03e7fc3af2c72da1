"""Just-in-time batch closing: wait for one more txn only when it pays.

Port of the JAX package's ``tuning/controller.py``; same decisions on the same inputs.

A fixed assembly deadline is wrong at both ends of the load curve: at
trough a lone transaction idles out the whole window on top of its service
time, and at peak the deadline truncates batches below the bucket sizes
the padded transfer actually prices (core/batching.BATCH_BUCKETS — a
101-row batch pays the 128-row program). The JIT closer replaces the fixed
deadline with a marginal decision per poll iteration (arXiv:1904.07421):

    is waiting for ONE more transaction expected to lower admitted p99?

evaluated from three live inputs —

- the arrival forecast (tuning/forecast.py): when is the next txn due;
- the bucket pad-waste curve: a txn landing on a pad row is service-FREE
  (the padded program runs regardless), a txn that bumps the batch into
  the next bucket re-prices service for every waiter;
- the measured service-time curve T(bucket): per-bucket EWMAs fed from
  completed batches (or the tracing plane's stage costs when attached).

Decision rule (deterministic — no randomness, no wall-clock reads of its
own, so a virtual-clock replay reproduces every decision bit-for-bit):

- sustainability first: while the batch's per-transaction service cost
  ``T(bucket(n)) / n`` exceeds ``RHO_TARGET × expected_gap``, closing
  would run the device past the utilization target and grow the queue —
  keep filling as long as the next arrival is forecast inside the
  headroom (at trough the expected gap is huge, so a lone transaction is
  "sustainable" immediately and closes with zero added wait);
- once sustainable, the marginal test: waiting for one more txn costs
  every current waiter the expected gap (plus any bucket-step service
  re-price) and buys the newcomer the batch's amortized fixed cost —
  wait only while ``n × gap + ΔT < patience_factor × T(first_bucket)``;
- never past the tuned max-wait bound, and never past the QoS budget's
  close-by instant (the budget check runs FIRST in the assembler —
  the controller only ever closes earlier than the budget would).

The tuner (tuning/tuner.py) owns ``max_wait_ms`` and ``buckets``; this
object just reads them on every decision.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from realtime_fraud_detection_tpu_torch.core.batching import (
    BATCH_BUCKETS,
    bucket_for,
)
from realtime_fraud_detection_tpu_torch.tuning.forecast import ArrivalForecaster

__all__ = ["CloseDecision", "JitBatchController"]


@dataclasses.dataclass(frozen=True)
class CloseDecision:
    close: bool
    reason: str          # jit | deadline | wait
    recheck_s: float     # advisory re-decision delay while waiting


class _ServiceModel:
    """Per-bucket service-time EWMAs with a linear (fixed + per-row) prior.

    ``observe(bucket, service_s)`` feeds completed batches; ``ms(bucket)``
    answers for any bucket — seen buckets from their EWMA, unseen ones
    from a line through the two most extreme seen buckets (or the prior
    until anything is seen)."""

    def __init__(self, prior_fixed_ms: float = 0.5,
                 prior_row_us: float = 5.0, alpha: float = 0.3):
        self.prior_fixed_ms = float(prior_fixed_ms)
        self.prior_row_us = float(prior_row_us)
        self.alpha = float(alpha)
        self._ewma: Dict[int, float] = {}     # bucket -> service ms

    def observe(self, bucket: int, service_s: float) -> None:
        if bucket < 1 or service_s < 0:
            return
        ms = service_s * 1e3
        prev = self._ewma.get(bucket)
        self._ewma[bucket] = (ms if prev is None
                              else self.alpha * ms
                              + (1.0 - self.alpha) * prev)

    def ms(self, bucket: int) -> float:
        hit = self._ewma.get(bucket)
        if hit is not None:
            return hit
        if len(self._ewma) >= 2:
            b_lo, b_hi = min(self._ewma), max(self._ewma)
            t_lo, t_hi = self._ewma[b_lo], self._ewma[b_hi]
            if b_hi > b_lo:
                slope = (t_hi - t_lo) / (b_hi - b_lo)
                return max(0.0, t_lo + slope * (bucket - b_lo))
        if len(self._ewma) == 1:
            (b0, t0), = self._ewma.items()
            # one point: keep its fixed cost, scale the row part by the
            # prior's per-row slope
            return max(0.0, t0 + (bucket - b0) * self.prior_row_us / 1e3)
        return self.prior_fixed_ms + bucket * self.prior_row_us / 1e3

    def snapshot(self) -> Dict[str, float]:
        return {str(b): round(v, 4) for b, v in sorted(self._ewma.items())}


class JitBatchController:
    """The decision object the assembler consults per poll iteration."""

    # device-utilization target the sustainability phase fills toward:
    # closing a batch whose per-txn service cost exceeds this fraction of
    # the inter-arrival gap runs the device too close to saturation and
    # the queue (not the assembly wait) becomes the tail; the 0.15 slack
    # is what drains a transient hole while a burst is still on
    RHO_TARGET = 0.85

    def __init__(self, forecaster: Optional[ArrivalForecaster] = None,
                 buckets: Tuple[int, ...] = BATCH_BUCKETS,
                 max_wait_ms: float = 10.0,
                 patience_factor: float = 1.0,
                 prior_fixed_ms: float = 0.5,
                 prior_row_us: float = 5.0):
        self.forecaster = forecaster or ArrivalForecaster()
        self.buckets: Tuple[int, ...] = tuple(buckets)
        self.max_wait_ms = float(max_wait_ms)
        self.patience_factor = float(patience_factor)
        self.service = _ServiceModel(prior_fixed_ms, prior_row_us)
        self.decisions: Dict[str, int] = {"jit": 0, "deadline": 0,
                                          "wait": 0}

    # ------------------------------------------------------------- inputs
    def observe(self, now: float, n: int = 1) -> None:
        """Admissions into the forecaster (the assembler calls this on every
        poll, with ITS clock — one time base per instance)."""
        self.forecaster.observe(now, n)

    def observe_batch(self, n_rows: int, service_s: float) -> None:
        """A completed batch's dispatch→complete duration, keyed by the
        bucket it padded onto — the live T(bucket) curve."""
        self.service.observe(self.bucket_for(n_rows), service_s)

    # ------------------------------------------------------------ buckets
    def bucket_for(self, n: int) -> int:
        """The padded shape ``n`` rows land on — core/batching's rule
        over THIS controller's (tuner-selected) close-boundary set."""
        return bucket_for(n, self.buckets)

    def _next_bucket(self, b: int) -> Optional[int]:
        for cand in self.buckets:
            if cand > b:
                return cand
        return None

    # ----------------------------------------------------------- decision
    def should_close(self, n: int, first_ts: float, now: float,
                     close_by: Optional[float] = None) -> CloseDecision:
        """The JIT decision for a batch of ``n`` waiters whose first
        record arrived at ``first_ts``. ``close_by`` is the QoS budget's
        latest hand-off instant for the oldest waiter (already enforced
        upstream; passed so the headroom math can't plan past it)."""
        waited_ms = max(0.0, (now - first_ts) * 1e3)
        headroom_ms = self.max_wait_ms - waited_ms
        if close_by is not None:
            headroom_ms = min(headroom_ms, (close_by - now) * 1e3)
        if headroom_ms <= 0.0:
            self.decisions["deadline"] += 1
            return CloseDecision(True, "deadline", 0.0)
        gap_ms = self.forecaster.expected_gap_s(now) * 1e3
        bucket = self.bucket_for(n)
        t_bucket = self.service.ms(bucket)
        # phase 1 — sustainability: closing an undersized batch runs the
        # device past the utilization target (queue growth costs the tail
        # far more than assembly wait does); keep filling while the next
        # arrival is forecast inside the headroom. At trough gap_ms is
        # huge, so n=1 is sustainable immediately — zero idle wait.
        if t_bucket / max(n, 1) > self.RHO_TARGET * gap_ms:
            if gap_ms <= headroom_ms:
                self.decisions["wait"] += 1
                return CloseDecision(
                    False, "wait", self._recheck_s(gap_ms, headroom_ms))
            self.decisions["jit"] += 1
            return CloseDecision(True, "jit", 0.0)
        # phase 2 — marginal free-rider test: one more txn costs every
        # current waiter the gap (plus the bucket-step re-price when n
        # sits on a boundary) and buys the newcomer a skipped service
        # cycle of the batch being built (under load, a txn left out of
        # this batch waits a full T(bucket) for the next one). Valuing
        # the gain at the TARGET bucket makes the closer ride pad rows to
        # the boundary when arrivals are due, and snap shut at the
        # boundary when the next bucket's re-price outweighs it — the
        # pad-waste curve driving the decision directly.
        target = self.bucket_for(n + 1)
        delta_ms = max(0.0, self.service.ms(target) - t_bucket)
        gain_ms = self.patience_factor * self.service.ms(target)
        if n * gap_ms + delta_ms < gain_ms and gap_ms <= headroom_ms:
            self.decisions["wait"] += 1
            return CloseDecision(
                False, "wait", self._recheck_s(gap_ms, headroom_ms))
        self.decisions["jit"] += 1
        return CloseDecision(True, "jit", 0.0)

    @staticmethod
    def _recheck_s(gap_ms: float, headroom_ms: float) -> float:
        """Advisory wait before re-deciding (the asyncio batcher's
        timeout; a new arrival re-decides immediately regardless)."""
        bound_ms = min(max(gap_ms, 0.05), headroom_ms)
        return max(0.0001, min(bound_ms / 1e3, 0.005))

    def snapshot(self) -> Dict[str, Any]:
        return {
            "max_wait_ms": round(self.max_wait_ms, 4),
            "buckets": list(self.buckets),
            "patience_factor": self.patience_factor,
            "decisions": dict(self.decisions),
            "forecast": self.forecaster.snapshot(),
            "service_ms": self.service.snapshot(),
        }
