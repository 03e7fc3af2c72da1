"""Observability plane of the port: metrics, structured logs, span timing,
drift detection and tracing.

The exports are the JAX package's ``obs`` exports; ``device_trace`` and
``annotate`` run over ``torch.profiler`` (``obs/profiling.py``). The fleet
plane (``obs.fleetmetrics``) and the drills (``obs.trace_drill``,
``obs.obs_drill``) are imported from their modules, as in the JAX package.
"""

from realtime_fraud_detection_tpu_torch.obs.drift import (
    DriftConfig,
    DriftReport,
    FeatureDriftMonitor,
)
from realtime_fraud_detection_tpu_torch.obs.logs import (
    JsonFormatter,
    log_batch_scored,
    log_model_event,
    log_prediction_result,
    setup_logging,
)
from realtime_fraud_detection_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsCollector,
    Registry,
)
from realtime_fraud_detection_tpu_torch.obs.profiling import (
    SpanTimer,
    annotate,
    device_trace,
)
from realtime_fraud_detection_tpu_torch.obs.tracing import (
    SloTracker,
    TraceBatch,
    TraceContext,
    Tracer,
)

__all__ = [
    "Counter",
    "DriftConfig",
    "DriftReport",
    "FeatureDriftMonitor",
    "Gauge",
    "Histogram",
    "JsonFormatter",
    "MetricsCollector",
    "Registry",
    "SloTracker",
    "SpanTimer",
    "TraceBatch",
    "TraceContext",
    "Tracer",
    "annotate",
    "device_trace",
    "log_batch_scored",
    "log_model_event",
    "log_prediction_result",
    "setup_logging",
]
