"""Experiments of the PyTorch port (``ab.py``: A/B routing and evaluation)."""

from realtime_fraud_detection_tpu_torch.testing.ab import (
    ABTestManager,
    Experiment,
    Variant,
    VariantStats,
    apply_weight_overrides,
)

__all__ = ["ABTestManager", "Experiment", "Variant", "VariantStats",
           "apply_weight_overrides"]
