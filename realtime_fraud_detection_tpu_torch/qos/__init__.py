"""Deadline-aware quality-of-service plane of the port.

Port of the JAX package's ``qos/``: a latency target is a property of the
system only if it holds when the offered load exceeds what the card can
take, so this plane shapes load before the card:

- ``admission``: token-bucket admission with priority classes (high-value
  transactions are never shed; a shed is an explicit REVIEW with a reason);
- ``budget``: per-transaction latency budgets; the microbatcher closes a
  batch early when its oldest record's budget runs low;
- ``ladder``: the degradation ladder with hysteresis (full ensemble ->
  drop BERT / GNN -> trees + isolation forest -> rules only, and back);
- ``plane``: ``QosPlane``, the bundle ``JobConfig.qos`` wires into the
  stream job, publishing through ``obs/metrics.py``;
- ``drill``: the deterministic virtual-clock overload drill
  (``qos-drill``).
"""

from realtime_fraud_detection_tpu_torch.qos.admission import (  # noqa: F401
    AdmissionController,
    AdmissionDecision,
    PRIORITIES,
    TokenBucket,
)
from realtime_fraud_detection_tpu_torch.qos.budget import LatencyBudget  # noqa: F401
from realtime_fraud_detection_tpu_torch.qos.ladder import (  # noqa: F401
    DegradationLadder,
    LADDER_LEVELS,
    LadderConfig,
    LadderLevel,
)
from realtime_fraud_detection_tpu_torch.qos.plane import QosPlane  # noqa: F401
from realtime_fraud_detection_tpu_torch.qos.drill import (  # noqa: F401
    DrillScorer,
    run_overload_drill,
)

__all__ = [
    "DrillScorer",
    "run_overload_drill",
    "AdmissionController",
    "AdmissionDecision",
    "DegradationLadder",
    "LADDER_LEVELS",
    "LadderConfig",
    "LadderLevel",
    "LatencyBudget",
    "PRIORITIES",
    "QosPlane",
    "TokenBucket",
]
