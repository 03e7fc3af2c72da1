"""Self-tuning host pipeline: arrival-aware just-in-time batching.

Port of the JAX package's ``tuning/`` (plain Python, no device state):

- ``forecast.ArrivalForecaster`` — short-horizon Holt (level+trend)
  arrival-rate estimate over admission timestamps, virtual-clock exact;
- ``controller.JitBatchController`` — the just-in-time batch closer the
  microbatch assembler consults instead of a fixed deadline
  (arXiv:1904.07421);
- ``tuner.ConfigTuner`` — gradient-free online hill climbing over the
  max-wait bound, bucket set, and in-flight depth, with hysteresis and
  hard QoS-budget floors (arXiv:2101.12127, tf.data autotuning);
- ``plane.TuningPlane`` — the bundle the stream job holds;
- ``drill`` — the deterministic virtual-clock acceptance drill
  (the ``autotune-drill`` command).
"""

from realtime_fraud_detection_tpu_torch.tuning.controller import (
    CloseDecision,
    JitBatchController,
)
from realtime_fraud_detection_tpu_torch.tuning.forecast import ArrivalForecaster
from realtime_fraud_detection_tpu_torch.tuning.plane import TuningPlane
from realtime_fraud_detection_tpu_torch.tuning.tuner import ConfigTuner

__all__ = [
    "ArrivalForecaster",
    "CloseDecision",
    "ConfigTuner",
    "JitBatchController",
    "TuningPlane",
]
