"""Configuration of the port (the names the JAX package's
``utils/__init__.py`` exports)."""

from realtime_fraud_detection_tpu_torch.utils.config import (  # noqa: F401
    Config,
    ModelConfig,
    EnsembleConfig,
    ServingConfig,
    StreamConfig,
    SimConfig,
    MonitoringConfig,
    MeshSettings,
)
