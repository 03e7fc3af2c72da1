"""Token-bucket admission control with priority classes.

Port of the JAX package's ``qos/admission.py``. One bucket models the
sustainable scoring rate. Classes draw from it with different privileges:

- ``high``   — never shed. A high-value transaction is admitted even when
  the bucket is in debt (tokens go negative, bounded at -burst); its cost
  still counts, so lower classes absorb the squeeze.
- ``normal`` — admitted while a whole token is available.
- ``low``    — admitted only while the bucket ALSO retains a reserve
  (``low_reserve_frac`` of burst), so under pressure the low class sheds
  first and the normal class keeps its headroom.

Every refusal is an :class:`AdmissionDecision` with an explicit reason —
the stream job turns it into a score-with-reason (``QosPlane.shed_result``),
never a silent drop.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

__all__ = ["PRIORITIES", "TokenBucket", "AdmissionDecision",
           "AdmissionController"]

PRIORITIES = ("high", "normal", "low")


@dataclasses.dataclass
class AdmissionDecision:
    admitted: bool
    priority: str
    reason: str          # "unlimited" | "capacity" | "high_priority" |
    #                      "shed:rate_limit" | "shed:low_reserve"
    tokens: float = 0.0  # bucket level after the decision (observability)


class TokenBucket:
    """Classic token bucket on an injected clock value: callers pass ``now``
    (wall time in the stream job, a virtual clock in the drill), so there is
    no hidden time source."""

    def __init__(self, rate: float, burst: Optional[float] = None):
        self.rate = float(rate)
        self.burst = float(burst) if burst else max(self.rate, 1.0)
        self.tokens = self.burst
        self._last: Optional[float] = None

    def refill(self, now: float) -> None:
        if self._last is None:
            self._last = now
        elapsed = max(0.0, now - self._last)
        self._last = now
        self.tokens = min(self.burst, self.tokens + elapsed * self.rate)

    def take(self, n: float = 1.0) -> None:
        """Unconditional draw; may push the bucket into bounded debt."""
        self.tokens = max(-self.burst, self.tokens - n)


class AdmissionController:
    """Priority-aware admission over one shared token bucket.

    ``rate`` is the sustainable txn/s; 0 disables limiting (every decision
    is ``admitted`` with reason ``unlimited``). Thread-safe.
    """

    def __init__(self, rate: float, burst: Optional[float] = None,
                 low_reserve_frac: float = 0.25):
        self.bucket = TokenBucket(rate, burst)
        self.low_reserve_frac = float(low_reserve_frac)
        self._lock = threading.Lock()

    def configure(self, rate: Optional[float] = None,
                  burst: Optional[float] = None,
                  low_reserve_frac: Optional[float] = None) -> None:
        """Run-time knob update. ``burst=None`` with a new rate re-derives
        the bucket size from that rate (one second of tokens): a plane built
        unlimited (rate 0 -> burst 1) must not keep its 1-token bucket once
        enabled at a real rate."""
        with self._lock:
            if rate is not None:
                self.bucket.rate = float(rate)
                if burst is None:
                    self.bucket.burst = max(float(rate), 1.0)
            if burst is not None:
                self.bucket.burst = float(burst)
            self.bucket.tokens = min(self.bucket.tokens, self.bucket.burst)
            if low_reserve_frac is not None:
                self.low_reserve_frac = float(low_reserve_frac)

    def decide(self, priority: str, now: float) -> AdmissionDecision:
        if priority not in PRIORITIES:
            priority = "normal"
        with self._lock:
            b = self.bucket
            if b.rate <= 0:
                return AdmissionDecision(True, priority, "unlimited")
            b.refill(now)
            if priority == "high":
                # never shed, but the draw still counts, so the squeeze
                # lands on the lower classes
                b.take()
                return AdmissionDecision(True, priority, "high_priority",
                                         b.tokens)
            if priority == "low":
                reserve = self.low_reserve_frac * b.burst
                if b.tokens - 1.0 < reserve:
                    return AdmissionDecision(False, priority,
                                             "shed:low_reserve", b.tokens)
                b.take()
                return AdmissionDecision(True, priority, "capacity", b.tokens)
            if b.tokens < 1.0:
                return AdmissionDecision(False, priority, "shed:rate_limit",
                                         b.tokens)
            b.take()
            return AdmissionDecision(True, priority, "capacity", b.tokens)
