"""Ensemble combination of the port (the names the JAX package's
``ensemble/__init__.py`` exports)."""

from realtime_fraud_detection_tpu_torch.ensemble.combine import (  # noqa: F401
    STRATEGIES,
    WEIGHTED_AVERAGE,
    VOTING,
    STACKING,
    EnsembleParams,
    combine_predictions,
    model_confidence,
    ensemble_decision,
)
