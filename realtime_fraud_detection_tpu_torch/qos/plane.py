"""QosPlane: admission + budget + ladder bundled behind one object.

Port of the JAX package's ``qos/plane.py``: what the stream job holds
(``JobConfig.qos``). It owns (or shares) a
:class:`~realtime_fraud_detection_tpu_torch.obs.metrics.MetricsCollector`, so
every admit, shed, ladder step and budget observation lands on its
Prometheus exposition. ``observe_slo_burn`` is the tracing plane's gate into
the served rung: with ``JobConfig.tracing`` on, the job feeds it the SLO burn
rate after every completed batch.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Mapping, Optional

from realtime_fraud_detection_tpu_torch.obs.metrics import MetricsCollector
from realtime_fraud_detection_tpu_torch.qos.admission import (
    AdmissionController,
    AdmissionDecision,
    PRIORITIES,
)
from realtime_fraud_detection_tpu_torch.qos.budget import LatencyBudget
from realtime_fraud_detection_tpu_torch.qos.ladder import (
    DegradationLadder,
    LADDER_LEVELS,
    LadderConfig,
)
from realtime_fraud_detection_tpu_torch.utils.config import QosSettings

__all__ = ["QosPlane"]


class QosPlane:
    """One QoS plane per stream job."""

    def __init__(self, settings: Optional[QosSettings] = None,
                 metrics: Optional[MetricsCollector] = None):
        self.settings = settings or QosSettings()
        self.metrics = metrics if metrics is not None else MetricsCollector()
        s = self.settings
        self.admission = AdmissionController(
            s.admission_rate, s.admission_burst or None, s.low_reserve_frac)
        self.budget = LatencyBudget(s.budget_ms, s.assemble_margin_ms)
        self.ladder = DegradationLadder(LadderConfig(
            high_backlog=s.ladder_high_backlog,
            low_backlog=s.ladder_low_backlog,
            patience=s.ladder_patience,
            up_patience=s.ladder_up_patience or None))
        self.counters: Dict[str, int] = {"admitted": 0, "shed": 0}
        self._lock = threading.Lock()
        # SLO-burn degradation signal (the tracing plane's burn rate feeds
        # it): an engaged gate floors the served rung at level 1 on top of
        # the backlog ladder. The ladder's asymmetric hysteresis: engaging
        # takes `patience` consecutive burn observations over the
        # threshold, recovery `up_patience` under it.
        self.slo_engaged = False
        self._slo_over = 0
        self._slo_under = 0

    @property
    def enabled(self) -> bool:
        return bool(self.settings.enabled)

    # -------------------------------------------------------- configuration
    def configure(self, updates: Mapping[str, Any]) -> Dict[str, Any]:
        """Apply a partial settings update. Only known QosSettings fields
        are accepted, and the result must satisfy the invariants
        ``Config.validate`` enforces at load time (an update must never put
        the plane into a state the config loader would refuse; a refused
        update rolls back). Returns the applied subset. All of it is
        run-time state: no rebuild, no restart."""
        applied: Dict[str, Any] = {}
        s = self.settings
        previous = {key: getattr(s, key) for key in updates
                    if hasattr(s, key)}
        try:
            for key, value in updates.items():
                if not hasattr(s, key):
                    raise ValueError(f"unknown qos setting {key!r}")
                current = getattr(s, key)
                if isinstance(current, bool):
                    # bool("false") is True: reject strings outright
                    if not isinstance(value, bool):
                        raise ValueError(
                            f"qos setting {key!r} must be a JSON boolean, "
                            f"got {value!r}")
                    setattr(s, key, value)
                elif isinstance(value, (bool, str)):
                    raise ValueError(
                        f"qos setting {key!r} must be a number, "
                        f"got {value!r}")
                else:
                    setattr(s, key, type(current)(value))
                applied[key] = getattr(s, key)
            s.validate()
        except (TypeError, ValueError):
            for key, value in previous.items():
                setattr(s, key, value)
            raise
        # push the knobs into the live components
        self.admission.configure(
            rate=s.admission_rate,
            burst=(s.admission_burst or None),
            low_reserve_frac=s.low_reserve_frac)
        self.budget.budget_ms = s.budget_ms
        self.budget.margin_ms = s.assemble_margin_ms
        lc = self.ladder.config
        lc.high_backlog = s.ladder_high_backlog
        lc.low_backlog = s.ladder_low_backlog
        lc.patience = s.ladder_patience
        lc.up_patience = s.ladder_up_patience or None
        return applied

    # ----------------------------------------------------------- admission
    def classify(self, txn: Mapping[str, Any]) -> str:
        """Priority class: an explicit ``priority`` field wins; otherwise
        by amount (high-value never sheds)."""
        p = txn.get("priority")
        if isinstance(p, str) and p in PRIORITIES:
            return p
        try:
            amount = float(txn.get("amount", 0.0))
        except (TypeError, ValueError):
            amount = 0.0
        if amount >= self.settings.high_value_amount:
            return "high"
        if amount < self.settings.low_value_amount:
            return "low"
        return "normal"

    def admit(self, txn: Mapping[str, Any], now: float) -> AdmissionDecision:
        decision = self.admission.decide(self.classify(txn), now)
        if decision.admitted:
            self.metrics.qos_admitted.inc(priority=decision.priority)
            with self._lock:
                self.counters["admitted"] += 1
        else:
            self.metrics.qos_shed.inc(priority=decision.priority,
                                      reason=decision.reason)
            with self._lock:
                self.counters["shed"] += 1
        return decision

    def shed_result(self, txn: Mapping[str, Any],
                    decision: AdmissionDecision) -> Dict[str, Any]:
        """A score-with-reason for a shed transaction, never a silent drop:
        downstream sees a REVIEW with the shed reason in the explanation,
        on the same schema as every scored record."""
        return {
            "transaction_id": str(txn.get("transaction_id", "")),
            "fraud_probability": 0.5,
            "fraud_score": 0.5,
            "risk_level": "SHED",
            "decision": "REVIEW",
            "model_predictions": {},
            "confidence": 0.0,
            "processing_time_ms": 0.0,
            "explanation": {
                "shed": True,
                "shed_reason": decision.reason,
                "priority": decision.priority,
            },
        }

    # -------------------------------------------------------------- ladder
    def observe_backlog(self, backlog: float) -> int:
        """Feed one backlog observation to the ladder; publishes the level
        gauge and any transition."""
        if not self.settings.ladder_enabled:
            return self.ladder.level
        prev = self.ladder.level
        level = self.ladder.observe(backlog)
        self.metrics.qos_ladder_level.set(level)
        if level != prev:
            self.metrics.qos_ladder_transitions.inc(
                direction="down" if level > prev else "up")
        return level

    def observe_slo_burn(self, burn_rate: float,
                         threshold: float = 2.0,
                         patience: int = 3,
                         up_patience: int = 12) -> bool:
        """Feed one SLO burn-rate observation (the tracing plane's fast
        window) to the hysteresis gate; returns whether the gate is
        engaged. An engaged gate makes ``apply_degradation`` serve at least
        rung 1 (drop BERT / GNN) even while the backlog reads calm: latency
        can burn the error budget without a queue ever forming."""
        prev_level = self.effective_level()
        if burn_rate > threshold:
            self._slo_over += 1
            self._slo_under = 0
            if self._slo_over >= max(1, int(patience)) \
                    and not self.slo_engaged:
                self.slo_engaged = True
                self._slo_over = 0
        else:
            self._slo_under += 1
            self._slo_over = 0
            if self._slo_under >= max(1, int(up_patience)) \
                    and self.slo_engaged:
                self.slo_engaged = False
                self._slo_under = 0
        # count a transition only when the served rung moved: a gate flip
        # while the backlog ladder sits at level >= 1 changes nothing
        level = self.effective_level()
        if level != prev_level:
            self.metrics.qos_ladder_transitions.inc(
                direction="down" if level > prev_level else "up")
        return self.slo_engaged

    def effective_level(self) -> int:
        """The rung actually served: the backlog ladder's level, floored
        at 1 while the SLO-burn gate is engaged."""
        level = self.ladder.level
        if self.slo_engaged:
            level = max(level, 1)
        return min(level, len(LADDER_LEVELS) - 1)

    def apply_degradation(self, scorer) -> int:
        """Push the effective rung (``effective_level``) into a scorer as a
        branch-validity mask, plus the rules-only flag for the last rung.
        The scorer ands it with its deployment validity: a rung only
        narrows it. Returns the level."""
        from realtime_fraud_detection_tpu_torch.scoring.pipeline import MODEL_NAMES

        level = self.effective_level()
        rung = LADDER_LEVELS[level]
        if level == 0:
            scorer.set_degradation(None, rules_only=False, level=0)
        else:
            scorer.set_degradation(
                self.ladder.level_mask(MODEL_NAMES, level=level),
                rules_only=rung.rules_only, level=level)
        if level > 0:
            self.metrics.qos_degraded_scored.inc(
                0, level=rung.name)  # materialize the series
        return level

    def record_scored(self, n: int) -> None:
        """Count transactions scored at the current (degraded) rung."""
        level = self.effective_level()
        if n and level > 0:
            self.metrics.qos_degraded_scored.inc(
                n, level=LADDER_LEVELS[level].name)

    # -------------------------------------------------------------- budget
    def record_completion(self, ingest_ts: float, now: float) -> float:
        """Observe a transaction's budget headroom at completion (negative
        = the deadline was blown). Returns the remaining seconds."""
        remaining_s = self.budget.remaining_ms(ingest_ts, now) / 1e3
        self.metrics.qos_budget_remaining.observe(remaining_s)
        return remaining_s

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> Dict[str, Any]:
        """Settings, bucket, ladder, SLO gate and counters as one dict."""
        with self._lock:
            counters = dict(self.counters)
        s = self.settings
        return {
            "enabled": s.enabled,
            "budget_ms": s.budget_ms,
            "assemble_margin_ms": s.assemble_margin_ms,
            "admission": {
                "rate": s.admission_rate,
                "burst": self.admission.bucket.burst,
                "tokens": round(self.admission.bucket.tokens, 3),
                "low_reserve_frac": s.low_reserve_frac,
                "high_value_amount": s.high_value_amount,
                "low_value_amount": s.low_value_amount,
            },
            "ladder": self.ladder.snapshot(),
            "ladder_levels": [lvl.name for lvl in LADDER_LEVELS],
            "effective_level": self.effective_level(),
            "slo_gate": {
                "engaged": self.slo_engaged,
                "over_streak": self._slo_over,
                "under_streak": self._slo_under,
            },
            "counters": counters,
        }
