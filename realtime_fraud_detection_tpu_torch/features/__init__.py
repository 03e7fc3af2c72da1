"""The 64-wide feature contract of the port (the names the JAX package's
``features/__init__.py`` exports)."""

from realtime_fraud_detection_tpu_torch.features.schema import (  # noqa: F401
    TransactionBatch,
    encode_transactions,
    PAYMENT_METHODS,
    TRANSACTION_TYPES,
    CARD_TYPES,
    MERCHANT_CATEGORIES,
    KYC_STATUSES,
    RISK_LEVELS,
)
from realtime_fraud_detection_tpu_torch.features.extract import (  # noqa: F401
    FEATURE_NAMES,
    NUM_FEATURES,
    extract_features,
    feature_index,
)
from realtime_fraud_detection_tpu_torch.features.rules import (  # noqa: F401
    DECISIONS,
    RISK_LEVEL_NAMES,
    rule_score,
    make_decision,
    risk_level_code,
)
from realtime_fraud_detection_tpu_torch.features.serving import ServingFeatureProcessor  # noqa: F401
