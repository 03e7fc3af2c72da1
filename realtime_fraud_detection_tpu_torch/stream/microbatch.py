"""Deadline-bounded microbatch assembly: the stream -> device seam.

Port of ``MicrobatchAssembler`` from the JAX package's
``stream/microbatch.py``: it drains a consumer into microbatches closed by
whichever comes first:

- size: ``max_batch`` records (aligned with the bucket set of
  ``core/batching.py``);
- budget (with a ``qos.LatencyBudget``): the oldest pending record's
  remaining latency budget, from its ingest timestamp, has dropped under
  the assembly margin; checked before the deadline;
- deadline: ``max_delay_ms`` since the batch's first record arrived; with a
  ``controller`` (the tuning plane's just-in-time closer) its
  ``should_close`` decision replaces the fixed deadline, after the budget
  trigger, and every polled record is fed to its arrival forecast.

Without a budget and a controller it closes exactly the batches it closed
before either trigger existed.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

from realtime_fraud_detection_tpu_torch.stream.transport import Consumer, Record

# blocking mode's pause between polls of an empty consumer
_IDLE_SLEEP_S = 0.0005


class MicrobatchAssembler:
    """Pull-based assembler over a transport consumer."""

    def __init__(
        self,
        consumer: Consumer,
        max_batch: int = 256,
        max_delay_ms: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
        budget=None,
        budget_clock: Callable[[], float] = time.time,
        controller=None,
    ):
        self.consumer = consumer
        self.max_batch = max_batch
        self.max_delay_ms = max_delay_ms
        self.clock = clock
        # optional qos.LatencyBudget; ``budget_clock`` shares the record
        # timestamps' time base (wall clock in the job, the virtual clock
        # in the overload drill)
        self.budget = budget
        self.budget_clock = budget_clock
        # optional tuning.TuningPlane (or a bare JitBatchController): polled
        # records feed its forecaster on this assembler's clock, and its
        # close decision replaces the fixed deadline; the budget trigger
        # still runs first, so it never outwaits a QoS latency budget
        self.controller = controller
        self._pending: List[Record] = []
        self._first_ts: Optional[float] = None
        self._oldest_event_ts: Optional[float] = None
        self.batches_emitted = 0
        self.records_emitted = 0
        # why the last batch closed (size | budget | deadline | jit |
        # timeout | flush) and the histogram of every close
        self.last_close_reason: Optional[str] = None
        self.close_reasons: dict = {}

    def _deadline_passed(self) -> bool:
        return (
            self._first_ts is not None
            and (self.clock() - self._first_ts) * 1000.0 >= self.max_delay_ms
        )

    def _budget_low(self) -> bool:
        return (
            self.budget is not None
            and self._oldest_event_ts is not None
            and self.budget.should_close(self._oldest_event_ts,
                                         self.budget_clock())
        )

    def _oldest(self, records: List[Record]) -> float:
        # an explicit None check: t = 0.0 is a real ingest timestamp (the
        # drill's virtual clock starts there)
        return min((r.timestamp if r.timestamp is not None
                    else self.budget_clock()) for r in records)

    def next_batch(self, block: bool = True,
                   timeout_s: Optional[float] = None) -> List[Record]:
        """Assemble the next microbatch.

        Non-blocking mode returns [] when no close condition holds yet. Blocking mode waits (bounded by ``timeout_s``)
        until a batch closes or the wait times out with whatever is pending.
        """
        wait_start = self.clock()
        while True:
            if len(self._pending) < self.max_batch:
                got = self.consumer.poll(self.max_batch - len(self._pending))
                if got and self._first_ts is None:
                    self._first_ts = self.clock()
                if got and self.budget is not None:
                    ts = self._oldest(got)
                    self._oldest_event_ts = (
                        ts if self._oldest_event_ts is None
                        else min(self._oldest_event_ts, ts))
                if got and self.controller is not None:
                    self.controller.observe(self.clock(), len(got))
                self._pending.extend(got)

            if len(self._pending) >= self.max_batch:
                return self._emit("size")
            if self._pending and self._budget_low():
                return self._emit("budget")
            if self.controller is not None:
                if self._pending:
                    d = self.controller.should_close(
                        len(self._pending), self._first_ts, self.clock())
                    if d.close:
                        return self._emit(d.reason)
            elif self._pending and self._deadline_passed():
                return self._emit("deadline")

            if not block:
                return []
            if timeout_s is not None and self.clock() - wait_start >= timeout_s:
                return self._emit("timeout") if self._pending else []
            time.sleep(_IDLE_SLEEP_S)

    def _emit(self, reason: str = "size") -> List[Record]:
        self.last_close_reason = reason
        self.close_reasons[reason] = self.close_reasons.get(reason, 0) + 1
        batch, self._pending = self._pending[: self.max_batch], self._pending[self.max_batch:]
        self._first_ts = self.clock() if self._pending else None
        self._oldest_event_ts = (self._oldest(self._pending)
                                 if self.budget is not None and self._pending
                                 else None)
        self.batches_emitted += 1
        self.records_emitted += len(batch)
        return batch

    def flush(self) -> List[Record]:
        """Close and return whatever is pending (drain-on-shutdown)."""
        return self._emit("flush") if self._pending else []
