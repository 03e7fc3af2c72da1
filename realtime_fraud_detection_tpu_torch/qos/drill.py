"""Deterministic overload drill: the QoS plane on a virtual clock.

Port of the JAX package's ``qos/drill.py``. It drives offered load at N x
the sustainable scoring rate through the port's stream path
(``MicrobatchAssembler`` -> ``StreamJob.dispatch_batch`` / ``complete_batch``
-> ``QosPlane`` admission, ladder and budget -> fan-out -> offset commit)
with two substitutions that make the run exactly reproducible on any CPU:

- time is a virtual clock (records carry virtual ingest timestamps; the
  assembler, the admission bucket and the budget all read it), and
- the device is a :class:`DrillScorer`: the dispatch / finalize seam of
  ``TorchFraudScorer`` with a deterministic per-batch service cost that
  shrinks as the ladder degrades. It touches no device.

``python -m realtime_fraud_detection_tpu_torch qos-drill`` runs it; its
summary equals the JAX package's drill on the same arguments.
"""

from __future__ import annotations

import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from realtime_fraud_detection_tpu_torch.qos.plane import QosPlane
from realtime_fraud_detection_tpu_torch.utils.config import QosSettings

__all__ = ["DrillScorer", "run_overload_drill"]


class _NoCache:
    """The drill generates unique transaction ids; dedupe never hits."""

    def get_transaction(self, txn_id, now=None):
        return None


class _DrillPending:
    def __init__(self, records, cost_s, level, rules_only):
        self.records = list(records)
        self.n = len(self.records)
        self.features = None
        self.cost_s = cost_s
        self.level = level
        self.rules_only = rules_only


class DrillScorer:
    """Deterministic scorer stand-in for overload drills.

    Service cost per dispatched batch is ``(base_ms + n*per_txn_ms) /
    speedup[level]`` of VIRTUAL time — the ladder's rungs genuinely buy
    capacity, so the control loop being exercised (backlog → degrade →
    drain → recover) has the same feedback shape as the real ensemble,
    just with exact arithmetic instead of wall-clock noise.
    """

    SPEEDUP = (1.0, 2.0, 4.0, 8.0)   # one entry per ladder level

    def __init__(self, base_ms: float = 1.0, per_txn_ms: float = 0.05):
        self.base_ms = float(base_ms)
        self.per_txn_ms = float(per_txn_ms)
        self.model_valid = np.ones(5, bool)
        self.txn_cache = _NoCache()
        self.qos_level = 0
        self._qos_rules_only = False
        self.last_cost_s = 0.0

    # the QoS seam TorchFraudScorer exposes (qos/plane.py apply_degradation)
    def set_degradation(self, mask, rules_only: bool = False,
                        level: int = 0) -> None:
        self.qos_level = int(level)
        self._qos_rules_only = bool(rules_only)

    def cost_s(self, n: int) -> float:
        return ((self.base_ms + n * self.per_txn_ms) / 1e3) \
            / self.SPEEDUP[self.qos_level]

    def sustainable_tps(self, batch: int) -> float:
        """Level-0 (full ensemble) capacity at a given batch size."""
        return batch / self.cost_s(batch) if batch else 0.0

    def dispatch(self, records, now: Optional[float] = None) -> _DrillPending:
        self.last_cost_s = self.cost_s(len(records))
        return _DrillPending(records, self.last_cost_s, self.qos_level,
                             self._qos_rules_only)

    def finalize(self, pending: _DrillPending, now: Optional[float] = None,
                 lock=None) -> List[Dict[str, Any]]:
        results = []
        for r in pending.records:
            tid = str(r.get("transaction_id", ""))
            # deterministic pseudo-score in [0, 0.65): id-hashed, stable
            # across runs, below the alert threshold by construction
            score = (zlib.crc32(tid.encode()) % 650) / 1000.0
            results.append({
                "transaction_id": tid,
                "fraud_probability": score,
                "fraud_score": score,
                "risk_level": "LOW" if score < 0.3 else "MEDIUM",
                "decision": "APPROVE" if score < 0.6 else
                            "APPROVE_WITH_MONITORING",
                "model_predictions": {},
                "confidence": 0.9,
                "processing_time_ms": pending.cost_s * 1e3 / max(pending.n, 1),
                "explanation": {"drill": True,
                                "ladder_level": pending.level,
                                "rules_only": pending.rules_only},
            })
        return results


def _make_txn(i: int, ts: float, amount: float) -> Dict[str, Any]:
    return {
        "transaction_id": f"drill-{i}",
        "user_id": f"u{i % 97}",
        "merchant_id": f"m{i % 31}",
        "amount": amount,
        "timestamp": str(ts),
    }


def run_overload_drill(
    offered_multiplier: float = 2.0,
    overload_s: float = 1.5,
    recovery_s: float = 1.5,
    max_batch: int = 64,
    max_delay_ms: float = 5.0,
    budget_ms: float = 20.0,
    assemble_margin_ms: float = 2.0,
    high_frac: float = 0.2,
    low_frac: float = 0.5,
    seed: int = 7,
    return_state: bool = False,
) -> Any:
    """Run the overload drill; returns a JSON-able summary (and, with
    ``return_state``, the live job + plane for assertions on metrics and
    topics).

    Timeline: ``overload_s`` of offered load at ``offered_multiplier`` ×
    the level-0 sustainable rate, then ``recovery_s`` at 0.3× so the
    backlog drains and the ladder steps back up, then a full drain.
    """
    from realtime_fraud_detection_tpu_torch.stream import topics as T
    from realtime_fraud_detection_tpu_torch.stream.job import JobConfig, StreamJob
    from realtime_fraud_detection_tpu_torch.stream.microbatch import (
        MicrobatchAssembler,
    )
    from realtime_fraud_detection_tpu_torch.stream.transport import InMemoryBroker

    rng = np.random.default_rng(seed)
    scorer = DrillScorer()
    capacity = scorer.sustainable_tps(max_batch)
    offered = offered_multiplier * capacity

    settings = QosSettings(
        enabled=True,
        budget_ms=budget_ms,
        assemble_margin_ms=assemble_margin_ms,
        admission_rate=capacity,
        admission_burst=capacity * 0.05,        # 50 ms of tokens
        high_value_amount=500.0,
        low_value_amount=25.0,
        # watermarks in records: ~4 ms / ~1 ms of backlog at capacity —
        # the ladder must engage well before queueing alone eats the
        # budget; slow recovery (up_patience) keeps it from flapping
        ladder_high_backlog=capacity * 0.004,
        ladder_low_backlog=capacity * 0.001,
        ladder_patience=2,
        ladder_up_patience=12,
    )
    plane = QosPlane(settings)
    broker = InMemoryBroker()
    job = StreamJob(broker, scorer, JobConfig(
        max_batch=max_batch, max_delay_ms=max_delay_ms,
        emit_features=False, emit_enriched=False, qos=plane))

    # virtual clock: the assembler's delay/budget triggers, the admission
    # bucket, and every latency measurement read the same timeline
    clock = [0.0]
    vclock = lambda: clock[0]                                  # noqa: E731
    job.assembler = MicrobatchAssembler(
        job.consumer, max_batch=max_batch, max_delay_ms=max_delay_ms,
        clock=vclock, budget=plane.budget, budget_clock=vclock)

    # precomputed arrival schedule (uniform spacing per phase — exact)
    arrivals: List[Tuple[float, Dict[str, Any]]] = []
    t = 0.0
    while t < overload_s:
        arrivals.append((t, None))
        t += 1.0 / offered
    recovery_rate = 0.3 * capacity
    while t < overload_s + recovery_s:
        arrivals.append((t, None))
        t += 1.0 / recovery_rate
    # priority mix: high never sheds, low sheds first
    amounts = rng.choice(
        [1000.0, 60.0, 5.0],
        p=[high_frac, 1.0 - high_frac - low_frac, low_frac],
        size=len(arrivals))
    arrivals = [(ts, _make_txn(j, ts, float(amounts[j])))
                for j, (ts, _) in enumerate(arrivals)]

    latencies_ms: List[float] = []
    level_trace: List[int] = []
    max_level = 0
    next_i = 0
    idle_step = 0.001
    while True:
        # deliver every arrival due at the current virtual instant
        due = []
        while next_i < len(arrivals) and arrivals[next_i][0] <= clock[0]:
            ts, txn = arrivals[next_i]
            due.append((txn, ts))
            next_i += 1
        for txn, ts in due:
            broker.produce(T.TRANSACTIONS, txn, key=txn["user_id"],
                           timestamp=ts)

        batch = job.assembler.next_batch(block=False)
        if not batch and next_i >= len(arrivals):
            batch = job.assembler.flush()
        if batch:
            ctx = job.dispatch_batch(batch, now=clock[0])
            clock[0] += (scorer.last_cost_s if ctx is not None
                         and ctx.pending is not None else idle_step)
            if ctx is not None:
                job.complete_batch(ctx, now=clock[0])
                for r in ctx.fresh:
                    latencies_ms.append(
                        (clock[0] - float(r.timestamp)) * 1e3)
            level_trace.append(plane.ladder.level)
            max_level = max(max_level, plane.ladder.level)
            continue
        if next_i >= len(arrivals) and job.consumer.lag() == 0:
            break
        # nothing assembled yet: advance to the next arrival (or tick)
        clock[0] = (max(clock[0] + idle_step, arrivals[next_i][0])
                    if next_i < len(arrivals) else clock[0] + idle_step)

    # a drained system observes a zero backlog until the ladder fully
    # recovers (the run loops would keep polling; the drill is explicit)
    recovery_observations = 0
    while plane.ladder.level > 0 and recovery_observations < 32:
        plane.observe_backlog(0)
        # rtfd-lint: allow[lock-order] drill drives the plane from one thread on the virtual clock
        plane.apply_degradation(scorer)
        recovery_observations += 1

    lat = np.asarray(latencies_ms) if latencies_ms else np.zeros(1)
    shed_by = {}
    for labels, count in plane.metrics.qos_shed.by_label():
        shed_by[f"{labels.get('priority')}:{labels.get('reason')}"] = \
            int(count)
    summary = {
        "capacity_tps_level0": round(capacity, 1),
        "offered_multiplier": offered_multiplier,
        "offered_tps": round(offered, 1),
        "produced": len(arrivals),
        "scored": job.counters["scored"],
        "shed": job.counters["shed"],
        "shed_by_priority_reason": shed_by,
        "budget_ms": budget_ms,
        "admitted_latency_ms": {
            "p50": round(float(np.percentile(lat, 50)), 3),
            "p99": round(float(np.percentile(lat, 99)), 3),
            "max": round(float(lat.max()), 3),
        },
        "p99_within_budget": bool(np.percentile(lat, 99) <= budget_ms),
        "ladder": plane.ladder.snapshot(),
        "max_ladder_level": max_level,
        "virtual_duration_s": round(clock[0], 3),
        "counters": dict(job.counters),
    }
    if return_state:
        return summary, job, plane
    return summary
