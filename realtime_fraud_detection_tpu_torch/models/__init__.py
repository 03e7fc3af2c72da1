"""Model branches of the port (the names the JAX package's
``models/__init__.py`` exports; the other branches are imported from their
modules, as in the JAX package)."""

from realtime_fraud_detection_tpu_torch.models.trees import (  # noqa: F401
    TreeEnsemble,
    tree_ensemble_predict,
    tree_ensemble_logits,
)
