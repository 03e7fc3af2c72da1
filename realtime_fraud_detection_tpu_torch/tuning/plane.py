"""TuningPlane: forecaster + JIT closer + online tuner behind one object.

Port of the JAX package's ``tuning/plane.py``: what the stream job holds
(``JobConfig.autotune``, the ``QosPlane`` / ``Tracer`` pattern). The
microbatch assembler calls ``observe`` / ``should_close`` on the hot path,
the job's completion calls ``on_batch_complete``, and the Prometheus mirror
reads ``snapshot()`` at exposition time
(``obs.metrics.MetricsCollector.sync_autotune``, honest counter deltas).

Duck-typing contract: the plane IS the ``controller`` object the assembler
takes (``MicrobatchAssembler(controller=...)``); it only ever calls
``observe(now, n)`` and ``should_close(n, first_ts, now, close_by)``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from realtime_fraud_detection_tpu_torch.tuning.controller import (
    CloseDecision,
    JitBatchController,
)
from realtime_fraud_detection_tpu_torch.tuning.forecast import ArrivalForecaster
from realtime_fraud_detection_tpu_torch.tuning.tuner import ConfigTuner

__all__ = ["TuningPlane"]


class TuningPlane:
    """One self-tuning plane per stream job."""

    def __init__(self, settings: Optional[Any] = None):
        from realtime_fraud_detection_tpu_torch.utils.config import TuningSettings

        self.settings = (settings if settings is not None
                         else TuningSettings(enabled=True))
        s = self.settings
        self.controller = JitBatchController(
            forecaster=ArrivalForecaster(
                bucket_s=s.forecast_bucket_s,
                alpha=s.forecast_alpha,
                beta=s.forecast_beta),
            buckets=tuple(s.bucket_sets[0]),
            max_wait_ms=s.deadline_max_ms,
            patience_factor=s.patience_factor)
        self.tuner = ConfigTuner(s, self.controller)
        # completion may run on another thread than the assembler's polls:
        # one small lock for the shared state
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return bool(getattr(self.settings, "enabled", True))

    # --------------------------------------------------- hot path (batcher)
    def observe(self, now: float, n: int = 1) -> None:
        self.controller.observe(now, n)

    def should_close(self, n: int, first_ts: float, now: float,
                     close_by: Optional[float] = None) -> CloseDecision:
        return self.controller.should_close(n, first_ts, now,
                                            close_by=close_by)

    # ------------------------------------------------------ completion path
    def on_batch_complete(self, n_rows: int, service_s: float, now: float,
                          latencies_ms=None, burn_rate: float = 0.0,
                          ladder_level: int = 0) -> None:
        """One completed microbatch: feed the service model, the tuner's
        objective, and the epoch machine. ``latencies_ms`` are the
        admitted per-txn end-to-end latencies the batch just served;
        ``burn_rate`` / ``ladder_level`` come from the tracing and QoS
        planes when the job has them (calm, 0, otherwise)."""
        with self._lock:
            if n_rows > 0:
                self.controller.observe_batch(n_rows, service_s)
            for ms in (latencies_ms or ()):
                self.tuner.observe_result(ms)
            self.tuner.on_batch(now, burn_rate=burn_rate,
                                ladder_level=ladder_level)

    def recommended_inflight_depth(self) -> int:
        """The tuner's current overlap/in-flight depth pick — the run
        loops re-read this each iteration, so a tuner move takes effect
        one batch later with no restart."""
        return int(self.tuner.inflight_depth)

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> Dict[str, Any]:
        """Cumulative plane state for the Prometheus mirror
        (sync_autotune) and the drill verdicts. Counters only ever grow
        (honest-counter discipline)."""
        with self._lock:
            c = self.controller.snapshot()
            t = self.tuner.snapshot()
        return {
            "enabled": self.enabled,
            "controller": c,
            "tuner": t,
            "forecast_tps": round(
                (c["forecast"].get("level_tps") or 0.0)
                + (c["forecast"].get("trend_tps") or 0.0), 3),
        }
