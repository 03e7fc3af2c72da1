"""Per-transaction latency budgets: ingest timestamp -> remaining deadline.

Port of the JAX package's ``qos/budget.py``. The p99 < 20 ms contract is per
transaction, end to end: time a record spends queued upstream is budget
already spent. The microbatcher (``stream/microbatch.py``) consults this
tracker, so a batch closes early when its oldest waiter's remaining budget
drops under the assembly margin: better a small batch on time than a full
batch late (deadline-aware batch assembly, arXiv:1904.07421).
"""

from __future__ import annotations

import dataclasses

__all__ = ["LatencyBudget"]


@dataclasses.dataclass
class LatencyBudget:
    """``budget_ms`` is the whole per-transaction deadline; ``margin_ms``
    reserves the tail for transfer+compute+return, so assembly must hand
    the batch off ``margin_ms`` before the deadline."""

    budget_ms: float = 20.0
    margin_ms: float = 2.0

    def deadline(self, ingest_ts: float) -> float:
        return ingest_ts + self.budget_ms / 1e3

    def remaining_ms(self, ingest_ts: float, now: float) -> float:
        """May be negative: the deadline is already blown."""
        return (self.deadline(ingest_ts) - now) * 1e3

    def close_by(self, ingest_ts: float) -> float:
        """Latest instant assembly may still hold a batch containing a
        record ingested at ``ingest_ts``."""
        return self.deadline(ingest_ts) - self.margin_ms / 1e3

    def should_close(self, oldest_ingest_ts: float, now: float) -> bool:
        return now >= self.close_by(oldest_ingest_ts)
