"""Topic contract: names, partition counts, retention/compaction classes.

Copy of the JAX package's ``stream/topics.py``: the reference's Kafka topic
contract (create-topics.sh:60-151), 29 reference topics (27 regular + 2
compacted profile topics) plus ``transaction-labels``, the delayed
ground-truth stream. The in-memory broker honours the same names and
partition counts, so key -> partition routing matches a Kafka deployment.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TopicSpec:
    name: str
    partitions: int
    compacted: bool = False


# names + partition counts exactly as create-topics.sh materializes them
TOPIC_SPECS: tuple[TopicSpec, ...] = (
    # core transaction flow (create-topics.sh:92-96)
    TopicSpec("payment-transactions", 12),
    TopicSpec("transaction-enriched", 12),
    TopicSpec("transaction-features", 12),
    TopicSpec("fraud-predictions", 12),
    TopicSpec("fraud-decisions", 6),
    # compacted profile topics (:103, :114)
    TopicSpec("user-profiles", 6, compacted=True),
    TopicSpec("merchant-profiles", 4, compacted=True),
    # user & behavioral (:101-110)
    TopicSpec("user-behavior", 8),
    TopicSpec("device-fingerprints", 4),
    TopicSpec("user-sessions", 6),
    TopicSpec("login-events", 4),
    # merchant & risk (:112-120)
    TopicSpec("merchant-transactions", 8),
    TopicSpec("risk-signals", 6),
    TopicSpec("blacklist-updates", 2),
    # alerts & audit (:122-128)
    TopicSpec("fraud-alerts", 6),
    TopicSpec("system-alerts", 2),
    TopicSpec("audit-logs", 4),
    TopicSpec("model-metrics", 2),
    # stream processing (:130-136)
    TopicSpec("velocity-checks", 8),
    TopicSpec("geographic-analysis", 4),
    TopicSpec("pattern-detection", 6),
    TopicSpec("network-analysis", 4),
    # analytics & reporting (:138-144)
    TopicSpec("transaction-metrics", 4),
    TopicSpec("fraud-metrics", 2),
    TopicSpec("dashboard-updates", 2),
    TopicSpec("reporting-data", 4),
    # test topics (:146-151)
    TopicSpec("test-transactions", 4),
    TopicSpec("model-experiments", 2),
    TopicSpec("feature-experiments", 2),
    # framework extension (no reference analog): delayed ground-truth
    # labels — chargeback outcomes keyed by user like the transactions
    # they label, consumed by the continuous-learning plane (feedback/)
    TopicSpec("transaction-labels", 12),
)

TOPIC_BY_NAME = {t.name: t for t in TOPIC_SPECS}

TRANSACTIONS = "payment-transactions"
ENRICHED = "transaction-enriched"
FEATURES = "transaction-features"
PREDICTIONS = "fraud-predictions"
DECISIONS = "fraud-decisions"
ALERTS = "fraud-alerts"
LABELS = "transaction-labels"
