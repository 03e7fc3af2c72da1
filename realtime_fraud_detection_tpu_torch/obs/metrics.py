"""Metrics plane: counters, gauges, histograms and the Prometheus text format.

Port of the JAX package's ``obs/metrics.py``: a small registry of its own
(instances are isolated, the render order is deterministic), and a
``MetricsCollector`` with the families of the planes the port has:

- predictions, batches and errors (``record_prediction``, ``record_batch``,
  ``record_error``; the JSON ``summary`` of the recent window);
- the serving queue's depth (``serving_queue_depth``, set by the app);
- the QoS plane's six ``qos_*`` families, written by ``qos/plane.py``;
- ``microbatch_close_reason_total`` (``sync_microbatch``), the host-assembly
  caches and stage times (``sync_host_stats``), the tracing plane's
  ``trace_*`` (``sync_tracing``), the tuning plane's ``autotune_*``
  (``sync_autotune``), the quantized plane's ``quant_*`` (``sync_quant``),
  the kernel plane (``sync_kernels``), the entity graph (``sync_graph``),
  the feedback plane's ``prequential_*`` / ``feedback_*``
  (``sync_feedback``), the device pool's ``device_pool_*``
  (``sync_device_pool``), the partition-parallel plane's ``cluster_*``
  (``sync_cluster``), the chaos plane's ``chaos_*`` (``sync_chaos``), the
  elastic fleet's ``autoscale_*`` and ``handoff_server_*``
  (``sync_autoscale``) and the network fault plane's ``netfault_*`` and the
  broker fence's ``fenced_*`` (``sync_netfaults``) and the mesh executor's
  ``mesh_*`` (``sync_mesh``), each mirrored from a snapshot at exposition
  time as counter deltas against the values last seen.

``kernel_interpret_active`` is not ported: the port has no kernel
interpreter (a CPU tensor runs the plain version).
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsCollector",
    "Registry",
    "DEFAULT_LATENCY_BUCKETS",
]

# Reference latency buckets: 1 ms .. 5 s (metrics.py:74-78).
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
)
SCORE_BUCKETS: Tuple[float, ...] = tuple(i / 10 for i in range(1, 10))


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _labels_key(labels: Mapping[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _render_labels(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in key)
    return "{" + body + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_text: str,
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def render(self) -> List[str]:
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help_text, labelnames=()):
        super().__init__(name, help_text, labelnames)
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = _labels_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        return self._values.get(_labels_key(labels), 0.0)

    def by_label(self) -> List[Tuple[Dict[str, str], float]]:
        """Sorted snapshot of (labels, value) pairs."""
        with self._lock:
            return [(dict(k), v) for k, v in sorted(self._values.items())]

    def total(self) -> float:
        with self._lock:
            return sum(self._values.values())

    def render(self) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        if not items:
            items = [((), 0.0)]
        for key, v in items:
            lines.append(f"{self.name}{_render_labels(key)} {_fmt(v)}")
        return lines


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help_text, labelnames=()):
        super().__init__(name, help_text, labelnames)
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[_labels_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = _labels_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: str) -> float:
        return self._values.get(_labels_key(labels), 0.0)

    def render(self) -> List[str]:
        with self._lock:
            items = sorted(self._values.items()) or [((), 0.0)]
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        for key, v in items:
            lines.append(f"{self.name}{_render_labels(key)} {_fmt(v)}")
        return lines


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_text, labelnames=(),
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help_text, labelnames)
        self.buckets = tuple(sorted(buckets)) + (math.inf,)
        self._counts: Dict[Tuple[Tuple[str, str], ...], List[int]] = {}
        self._sums: Dict[Tuple[Tuple[str, str], ...], float] = {}
        self._maxes: Dict[Tuple[Tuple[str, str], ...], float] = {}
        # one exemplar per series: (bucket index, labels, value), rendered
        # as a comment line beside its bucket
        self._exemplars: Dict[Tuple[Tuple[str, str], ...],
                              Tuple[int, Dict[str, str], float]] = {}

    def observe(self, value: float, **labels: str) -> None:
        if not math.isfinite(value):
            # NaN / inf would poison _sum forever; dropped, so the count
            # stays consistent with the bucket lines
            return
        key = _labels_key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    counts[i] += 1
                    break
            self._sums[key] = self._sums.get(key, 0.0) + float(value)
            self._maxes[key] = max(self._maxes.get(key, value), value)

    def add_bucket_deltas(self, deltas: Sequence[float], sum_delta: float,
                          max_value: Optional[float] = None,
                          exemplar: Optional[Mapping[str, Any]] = None,
                          **labels: str) -> None:
        """Merge pre-bucketed observation deltas (aligned with
        ``self.buckets``, +Inf last, all >= 0) into this histogram.
        ``exemplar`` is ``{"value": v, **labels}`` and replaces the series'
        stored one."""
        if len(deltas) != len(self.buckets):
            raise ValueError(
                f"{self.name}: expected {len(self.buckets)} bucket deltas "
                f"(incl. +Inf), got {len(deltas)}")
        if any(d < 0 for d in deltas) or sum_delta < 0:
            raise ValueError(f"{self.name}: bucket deltas must be >= 0")
        key = _labels_key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, d in enumerate(deltas):
                counts[i] += int(d)
            self._sums[key] = self._sums.get(key, 0.0) + float(sum_delta)
            if max_value is not None:
                self._maxes[key] = max(self._maxes.get(key, max_value),
                                       float(max_value))
            if exemplar:
                ex = dict(exemplar)
                v = float(ex.pop("value"))
                idx = next((i for i, ub in enumerate(self.buckets)
                            if v <= ub), len(self.buckets) - 1)
                self._exemplars[key] = (
                    idx, {str(k): str(val) for k, val in ex.items()}, v)

    def count(self, **labels: str) -> int:
        return sum(self._counts.get(_labels_key(labels), ()))

    def sum(self, **labels: str) -> float:
        return self._sums.get(_labels_key(labels), 0.0)

    def quantile(self, q: float, **labels: str) -> float:
        """Upper bound of the hit bucket; in the +Inf bucket, the largest
        observation (never understates the tail)."""
        key = _labels_key(labels)
        counts = self._counts.get(key)
        if not counts:
            return 0.0
        total = sum(counts)
        target = q * total
        acc = 0
        for i, c in enumerate(counts):
            acc += c
            if acc >= target and c:
                return self.buckets[i] if self.buckets[i] != math.inf \
                    else self._maxes.get(key, self.buckets[-2])
        return self._maxes.get(key, self.buckets[-2])

    def render(self) -> List[str]:
        with self._lock:
            keys = sorted(self._counts) or [()]
            lines = [f"# HELP {self.name} {self.help}",
                     f"# TYPE {self.name} {self.kind}"]
            for key in keys:
                counts = self._counts.get(key, [0] * len(self.buckets))
                ex = self._exemplars.get(key)
                cum = 0
                for i, (ub, c) in enumerate(zip(self.buckets, counts)):
                    cum += c
                    lk = key + (("le", _fmt(ub)),)
                    lines.append(
                        f"{self.name}_bucket{_render_labels(lk)} {cum}")
                    if ex is not None and ex[0] == i:
                        # a comment line: the classic text format has no
                        # exemplar syntax, and every parser skips '#'
                        ex_labels = ",".join(
                            f'{k}="{_escape(v)}"' for k, v in ex[1].items())
                        lines.append(
                            f"# exemplar {self.name}_bucket"
                            f"{_render_labels(lk)} {{{ex_labels}}} "
                            f"{_fmt(ex[2])}")
                lines.append(
                    f"{self.name}_sum{_render_labels(key)} "
                    f"{_fmt(self._sums.get(key, 0.0))}"
                )
                lines.append(f"{self.name}_count{_render_labels(key)} {cum}")
        return lines


class Registry:
    """Named metric collection with Prometheus text rendering."""

    def __init__(self) -> None:
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            if metric.name in self._metrics:
                raise ValueError(f"duplicate metric {metric.name!r}")
            self._metrics[metric.name] = metric
        return metric

    def counter(self, name, help_text, labelnames=()) -> Counter:
        return self.register(Counter(name, help_text, labelnames))  # type: ignore[return-value]

    def gauge(self, name, help_text, labelnames=()) -> Gauge:
        return self.register(Gauge(name, help_text, labelnames))  # type: ignore[return-value]

    def histogram(self, name, help_text, labelnames=(),
                  buckets=DEFAULT_LATENCY_BUCKETS) -> Histogram:
        return self.register(Histogram(name, help_text, labelnames, buckets))  # type: ignore[return-value]

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


def _mirror(counter: Counter, seen: Dict[Any, float], key: Any, total: Any,
            **labels: str) -> None:
    """Increment ``counter`` by ``total``'s growth since the last mirror of
    ``key`` (a source that restarts from zero adds nothing until it catches
    up: never a negative increment)."""
    total = float(total)
    delta = total - seen.get(key, 0.0)
    if delta > 0:
        counter.inc(delta, **labels)
    seen[key] = total


class MetricsCollector:
    """Domain metrics of the scoring plane (reference metrics.py:36-432),
    with a bounded window of recent predictions behind ``summary()``."""

    def __init__(self, window: int = 10_000, clock=time.monotonic) -> None:
        self.registry = Registry()
        self._clock = clock
        self._start = clock()
        self._lock = threading.Lock()
        self._recent: deque = deque(maxlen=window)  # (t, duration_s, score, decision)
        self._total = 0
        # per-second event counts for throughput, independent of the
        # window's cap
        self._sec_counts: deque = deque(maxlen=120)  # (int_second, count)

        r = self.registry
        self.predictions_total = r.counter(
            "ml_predictions_total", "Total predictions served",
            ("model", "decision"))
        self.prediction_errors = r.counter(
            "ml_prediction_errors_total", "Prediction failures", ("stage",))
        self.prediction_duration = r.histogram(
            "ml_prediction_duration_seconds", "End-to-end scoring latency")
        self.fraud_score = r.histogram(
            "ml_fraud_score", "Fraud score distribution", buckets=SCORE_BUCKETS)
        self.batch_size = r.histogram(
            "scoring_microbatch_size", "Scored microbatch sizes",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512))
        self.batch_duration = r.histogram(
            "scoring_microbatch_duration_seconds", "Per-microbatch latency")
        self.active_models = r.gauge(
            "ml_active_models", "Number of live ensemble branches")
        self.uptime = r.gauge("ml_uptime_seconds", "Process uptime")
        self.throughput = r.gauge(
            "ml_throughput_tps", "Scored txns/sec over the last 60 s")
        self.queue_depth = r.gauge(
            "serving_queue_depth", "Requests waiting in the microbatcher")
        # QoS plane (qos/): admission, shedding, the degradation ladder and
        # per-transaction budget headroom
        self.qos_admitted = r.counter(
            "qos_admitted_total", "Transactions admitted by the QoS plane",
            ("priority",))
        self.qos_shed = r.counter(
            "qos_shed_total",
            "Transactions shed by admission control (explicit decisions, "
            "never silent drops)", ("priority", "reason"))
        self.qos_ladder_level = r.gauge(
            "qos_ladder_level",
            "Current degradation-ladder level (0=full ensemble, "
            "3=rules only)")
        self.qos_ladder_transitions = r.counter(
            "qos_ladder_transitions_total",
            "Degradation-ladder steps", ("direction",))
        self.qos_degraded_scored = r.counter(
            "qos_degraded_scored_total",
            "Transactions scored at a degraded ladder level", ("level",))
        self.qos_budget_remaining = r.histogram(
            "qos_budget_remaining_seconds",
            "Per-transaction latency budget remaining at completion "
            "(negative = deadline blown)",
            buckets=(-0.1, -0.02, -0.005, 0.0, 0.001, 0.0025, 0.005,
                     0.01, 0.015, 0.02, 0.05, 0.1))
        # host assembly: cache hit / miss totals and per-stage times,
        # mirrored from TorchFraudScorer.host_stats() by sync_host_stats
        self.host_cache_hits = r.counter(
            "host_assembly_cache_hits_total",
            "Cumulative host-assembly cache hits (token LRU, entity join "
            "rows)", ("cache",))
        self.host_cache_misses = r.counter(
            "host_assembly_cache_misses_total",
            "Cumulative host-assembly cache misses", ("cache",))
        self.host_stage_ms = r.gauge(
            "host_assembly_stage_ms",
            "Host-side per-stage timing (assemble/pack/dispatch/"
            "device_wait)", ("stage", "stat"))
        # the stage table's cumulative totals: rate(seconds) / rate(count)
        # is the mean a stage took over any interval
        self.host_stage_seconds = r.counter(
            "host_stage_seconds_total",
            "Cumulative seconds in each host stage and in the interpreter's "
            "collections (gc.gen0/1/2)", ("stage",))
        self.host_stage_count = r.counter(
            "host_stage_count_total",
            "Cumulative samples of each host stage and collections of each "
            "generation", ("stage",))
        self._host_cache_seen: Dict[Tuple[str, str], float] = {}
        self._host_stage_seen: Dict[Tuple[str, str], float] = {}
        # the device pool (scoring/device_pool.py): per-replica dispatch,
        # completion and retry counters, live depth and cumulative queue
        # wait, mirrored from DevicePool.stats() by sync_device_pool
        self.pool_dispatched = r.counter(
            "device_pool_dispatched_total",
            "Microbatches dispatched to each pool replica", ("device",))
        self.pool_completed = r.counter(
            "device_pool_completed_total",
            "Microbatches completed by each pool replica", ("device",))
        self.pool_retries = r.counter(
            "device_pool_retries_total",
            "Batches rescued ONTO this replica after another replica "
            "failed mid-flight", ("device",))
        self.pool_inflight = r.gauge(
            "device_pool_inflight",
            "Batches currently in flight on each pool replica", ("device",))
        self.pool_healthy = r.gauge(
            "device_pool_healthy_replicas",
            "Replicas currently in the dispatch rotation")
        self.pool_queue_wait = r.counter(
            "device_pool_queue_wait_ms_total",
            "Cumulative milliseconds dispatch spent blocked on a replica "
            "at full in-flight depth", ("device",))
        self._pool_seen: Dict[Tuple[str, str], float] = {}
        # the feedback plane (feedback/): prequential quality under live
        # labels, label-join health, the retrain / gate / promotion audit
        # counters, mirrored from FeedbackPlane.snapshot() by sync_feedback
        # (registered where the JAX collector registers them: the
        # exposition's order is JAX's)
        self.preq_auc = r.gauge(
            "prequential_auc",
            "Streaming test-then-train AUC over matched labels",
            ("window",))
        self.preq_precision = r.gauge(
            "prequential_precision",
            "Prequential precision at the pinned operating threshold",
            ("window",))
        self.preq_recall = r.gauge(
            "prequential_recall",
            "Prequential recall at the pinned operating threshold",
            ("window",))
        self.preq_calibration = r.gauge(
            "prequential_calibration_error",
            "Expected calibration error over the sliding label window")
        self.feedback_labels = r.counter(
            "feedback_labels_total",
            "Label-join outcomes (matched / expired_unlabeled / "
            "orphan_labels / duplicate_labels)", ("outcome",))
        self.feedback_label_lag = r.gauge(
            "feedback_label_lag_seconds",
            "Mean prediction-to-label delay over matched labels")
        self.feedback_buffer = r.gauge(
            "feedback_buffer_examples",
            "Labeled-example buffer occupancy", ("klass",))
        self.feedback_triggers = r.counter(
            "feedback_retrain_triggers_total",
            "Retrain triggers fired by the policy", ("reason",))
        self.feedback_gate = r.counter(
            "feedback_gate_verdicts_total",
            "Promotion-gate verdicts on retrained candidates", ("verdict",))
        self.feedback_promotions = r.counter(
            "feedback_promotions_total",
            "Candidates promoted into the serving blend")
        self._feedback_seen: Dict[Tuple[str, str], float] = {}
        # tracing plane (obs/tracing.py): per-stage latency histograms
        # with exemplar trace_ids, trace terminal counters, and the SLO
        # burn-rate gauges — mirrored from Tracer.snapshot() by
        # sync_tracing at exposition time
        from realtime_fraud_detection_tpu_torch.obs.tracing import (
            TRACE_STAGE_BUCKETS_MS,
        )

        self.trace_stage_ms = r.histogram(
            "trace_stage_ms",
            "Per-transaction stage latency from the tracing plane "
            "(exemplars carry trace_ids)", ("stage",),
            buckets=TRACE_STAGE_BUCKETS_MS)
        self.trace_completed = r.counter(
            "trace_completed_total",
            "Traces closed by the flight recorder", ("terminal",))
        self.trace_slo_violations = r.counter(
            "trace_slo_violations_total",
            "Transactions that blew the SLO latency objective")
        # trace carriers: adopted = producer-stamped contexts re-hydrated at
        # consume time; lost = expected but missing or garbled, degraded to
        # fresh local roots (counted, never a gap)
        self.trace_carrier_adopted = r.counter(
            "trace_carrier_adopted_total",
            "Producer-stamped trace carriers adopted at consume time")
        self.trace_carrier_lost = r.counter(
            "trace_carrier_lost_total",
            "Expected trace carriers missing/unparseable — degraded to "
            "fresh local roots")
        self.trace_slo_burn = r.gauge(
            "trace_slo_burn_rate",
            "SLO error-budget burn rate (1.0 = budget consumed exactly at "
            "the sustainable rate)", ("window",))
        self._trace_seen: Dict[Tuple[str, ...], Any] = {}
        # why each microbatch closed, mirrored from the assembler's
        # close_reasons by sync_microbatch
        self.microbatch_close_reason = r.counter(
            "microbatch_close_reason_total",
            "Microbatch close decisions by trigger "
            "(size/deadline/budget/timeout/flush/jit)", ("reason",))
        self._close_reason_seen: Dict[str, float] = {}
        # self-tuning plane (tuning/): arrival forecast, JIT close
        # decision mix, live knob values, tuner trial/freeze audit —
        # mirrored from TuningPlane.snapshot() by sync_autotune
        self.autotune_decisions = r.counter(
            "autotune_close_decisions_total",
            "JIT controller decisions (jit/deadline close, wait)",
            ("decision",))
        self.autotune_tuner_events = r.counter(
            "autotune_tuner_events_total",
            "Online-tuner epoch outcomes "
            "(trials/accepted/reverted/frozen_epochs)", ("event",))
        self.autotune_forecast_tps = r.gauge(
            "autotune_forecast_tps",
            "Short-horizon forecast arrival rate (txn/s)")
        self.autotune_max_wait_ms = r.gauge(
            "autotune_max_wait_ms",
            "Current tuned batch max-wait bound (ms)")
        self.autotune_bucket_set = r.gauge(
            "autotune_bucket_set",
            "Index of the bucket set the tuner currently serves")
        self.autotune_inflight_depth = r.gauge(
            "autotune_inflight_depth",
            "Overlap/in-flight depth the tuner currently recommends")
        self.autotune_frozen = r.gauge(
            "autotune_frozen",
            "1 while the tuner is frozen by the QoS ladder / SLO burn")
        self._autotune_seen: Dict[Tuple[str, str], float] = {}
        # chaos plane (chaos/): scheduled fault windows and recovery
        # accounting — mirrored from ChaosPlan.snapshot() by sync_chaos at
        # exposition time (honest counter deltas, same discipline as every
        # sync_* mirror above)
        self.chaos_fault_windows = r.counter(
            "chaos_fault_windows_total",
            "Fault windows opened by the chaos plane", ("fault",))
        self.chaos_fault_active = r.gauge(
            "chaos_fault_active",
            "1 while the named fault window is open", ("fault",))
        self.chaos_recovery_seconds = r.gauge(
            "chaos_recovery_seconds",
            "Virtual seconds from a fault window's end to observed plane "
            "recovery", ("fault",))
        self._chaos_seen: Dict[str, float] = {}
        # quantized plane (the JAX package's help texts): the mode each
        # quantizable branch serves (read from the live parameters), its
        # parameter bytes and the divergence gate's verdicts, mirrored from
        # TorchFraudScorer.quant_snapshot() by sync_quant
        self.quant_branch_mode = r.gauge(
            "quant_branch_mode",
            "1 for the weight/kernel mode each branch currently serves "
            "(f32/int8 for bert_text, gather/gemm for the tree branches)",
            ("branch", "mode"))
        self.quant_param_bytes = r.gauge(
            "quant_param_bytes",
            "Serialized parameter bytes of the quantizable branch as "
            "served (the per-replica replication / hot-swap payload)",
            ("branch",))
        self.quant_gate_verdicts = r.counter(
            "quant_gate_verdicts_total",
            "Divergence-oracle verdicts recorded against this scorer "
            "(rtfd quant-drill and any caller running the quantized-vs-"
            "f32 comparison)", ("verdict",))
        self._quant_seen: Dict[str, float] = {}
        # kernel plane (ops/ + KernelSettings): per-site modes as exhaustive
        # 0/1 gauges and the dispatch / fallback counters of
        # TorchFraudScorer.kernel_snapshot(), mirrored by sync_kernels
        self.kernel_site_mode = r.gauge(
            "kernel_site_mode",
            "1 for the kernel mode each fusion site currently serves "
            "(off/cuda for dequant_matmul, epilogue and megakernel, "
            "reference/flash for attention)",
            ("site", "mode"))
        self.kernel_dispatches = r.counter(
            "kernel_dispatch_total",
            "Batches dispatched with this site's kernel engaged",
            ("site",))
        self.kernel_fallbacks = r.counter(
            "kernel_fallback_total",
            "Batches where this site's kernel was requested but the "
            "shape/param-form guard fell back to the plain path",
            ("site",))
        self._kernel_seen: Dict[str, Dict[str, float]] = {
            "dispatch": {}, "fallback": {}}
        self.kernel_mega_dispatch = r.counter(
            "kernel_mega_dispatch_total",
            "Batches dispatched with the persistent megakernel engaged "
            "(one program serving every branch plus the epilogue)")
        self.kernel_mega_fallback = r.counter(
            "kernel_mega_fallback_total",
            "Batches where the megakernel was requested but its shape "
            "plan declined and the per-site kernel chain served instead")
        self.kernel_launches_per_batch = r.gauge(
            "kernel_launches_per_batch",
            "Device programs launched for the most recent scoring "
            "microbatch (1 when the megakernel served it; the per-site "
            "chain length otherwise)")
        self._mega_seen: Dict[str, float] = {}
        # the partition-parallel plane (cluster/): fleet membership,
        # partition ownership, the handoff ledger and the serving router's
        # key movement, mirrored from WorkerFleet.snapshot() or the serving
        # app's router snapshot by sync_cluster
        self.cluster_workers_alive = r.gauge(
            "cluster_workers_alive",
            "Fleet workers currently alive (in the hash ring)")
        self.cluster_partitions_owned = r.gauge(
            "cluster_partitions_owned",
            "Transaction-topic partitions each worker currently owns "
            "(state ownership == consumption ownership)", ("worker",))
        self.cluster_handoff = r.counter(
            "cluster_handoff_total",
            "Partitions handed off to a surviving worker after a worker "
            "loss (restore + committed-gap state replay)")
        self.cluster_handoff_replay_depth = r.gauge(
            "cluster_handoff_replay_depth",
            "Records state-replayed during the most recent handoff "
            "(committed offset minus snapshot offset, summed over the "
            "moved partitions)")
        self.cluster_router_moved_keys = r.counter(
            "cluster_router_moved_keys_total",
            "Keys (partition moves x key density) the consistent-hash "
            "serving router re-routed across membership changes")
        self._cluster_seen: Dict[str, float] = {}
        # elastic process fleet (cluster/autoscale.py + handoff.py):
        # forecast-driven target worker count, scale events, and the
        # network handoff server's checkpoint/restore/torn-blob ledger —
        # mirrored from AutoscaleController.snapshot() (+ the fleet's
        # HandoffClient.stats()) by sync_autoscale at exposition time
        # (honest counter deltas, same discipline as every sync_* mirror)
        self.autoscale_target_workers = r.gauge(
            "autoscale_target_workers",
            "Worker-count target the autoscale controller currently "
            "wants (forecast lead x headroom / per-worker capacity)")
        self.autoscale_forecast_rate = r.gauge(
            "autoscale_forecast_rate",
            "Arrival-rate estimate (txn/s) behind the current target")
        self.autoscale_events = r.counter(
            "autoscale_events_total",
            "Autoscale target changes by direction (up = spawn + restore "
            "+ replay, down = graceful drain)", ("direction",))
        self.handoff_server_checkpoints = r.counter(
            "handoff_server_checkpoints_total",
            "Partition snapshots committed to the network handoff store "
            "(temp->fsync->rename, sha256-stamped)")
        self.handoff_server_restores = r.counter(
            "handoff_server_restores_total",
            "Verified snapshot restores served to partition inheritors")
        self.handoff_server_torn_blobs = r.counter(
            "handoff_server_torn_blobs_total",
            "Checkpoint blobs that failed sha256 verification on restore "
            "(the previous checkpoint was served instead)")
        self._autoscale_seen: Dict[str, float] = {}
        # the mesh executor (scoring/mesh_executor.py): geometry, per-branch
        # placement as exhaustive 0/1 gauges, per-position against
        # replicated parameter bytes, per-replica dispatch counters,
        # mirrored from MeshExecutor.mesh_snapshot() by sync_mesh
        self.mesh_data_axis = r.gauge(
            "mesh_data_axis_size",
            "Data-parallel axis size of each serving mesh replica")
        self.mesh_model_axis = r.gauge(
            "mesh_model_axis_size",
            "Model-parallel axis size of each serving mesh replica")
        self.mesh_replica_count = r.gauge(
            "mesh_replica_count",
            "Mesh replicas in the executor's round-robin rotation "
            "(pool x mesh: replicate the mesh, not the chip)")
        self.mesh_branch_sharded = r.gauge(
            "mesh_branch_sharded",
            "1 when the branch's params store sharded over the model "
            "axis, 0 when replicated (exhaustive over the registry)",
            ("branch",))
        self.mesh_param_bytes = r.gauge(
            "mesh_param_bytes_per_chip",
            "Max per-chip resident param bytes for each branch as "
            "committed on mesh replica 0 (the HBM the placement actually "
            "buys)", ("branch",))
        self.mesh_param_bytes_replicated = r.gauge(
            "mesh_param_bytes_replicated",
            "Replicated-equivalent param bytes per branch (what a pure "
            "DevicePool replica would hold) — the denominator of the "
            "sharding win", ("branch",))
        self.mesh_dispatched = r.counter(
            "mesh_dispatched_total",
            "Microbatches dispatched to each mesh replica", ("replica",))
        self.mesh_completed = r.counter(
            "mesh_completed_total",
            "Microbatches completed by each mesh replica", ("replica",))
        self._mesh_seen: Dict[Tuple[str, str], float] = {}
        # network fault plane (chaos/netfaults.py) + broker producer-
        # generation fencing (stream/netbroker.py): per-link injected
        # fault effects and the broker's refused-write counters —
        # mirrored from LinkFaultPlane.snapshot() (optionally carrying a
        # broker fencing block) by sync_netfaults at exposition time
        # (honest counter deltas, same discipline as every sync_* mirror
        # above)
        self.netfault_link_active = r.gauge(
            "netfault_link_active",
            "1 while any fault (partition/degrade) is armed on the named "
            "link", ("link",))
        self.netfault_windows = r.counter(
            "netfault_windows_total",
            "Fault windows begun on the named link", ("link",))
        self.netfault_delayed_sends = r.counter(
            "netfault_delayed_sends_total",
            "Frames delayed by injected latency on the named link",
            ("link",))
        self.netfault_dropped_sends = r.counter(
            "netfault_dropped_sends_total",
            "Frames dropped (bounded drop-then-reconnect) on the named "
            "link", ("link",))
        self.netfault_partitioned_sends = r.counter(
            "netfault_partitioned_sends_total",
            "Frames refused at send by a full partition on the named "
            "link", ("link",))
        self.netfault_lost_responses = r.counter(
            "netfault_lost_responses_total",
            "Responses lost to a one-way partition on the named link "
            "(the op was APPLIED peer-side; retries may duplicate)",
            ("link",))
        self.netfault_throttled_bytes = r.counter(
            "netfault_throttled_bytes_total",
            "Bytes paced by slow-link throttling on the named link",
            ("link",))
        self.fenced_produce = r.counter(
            "fenced_produce_total",
            "Stamped produces the broker refused because the target "
            "partition was fenced at a newer assignment generation "
            "(StaleGenerationError — the zombie-writer fence)")
        self.fenced_commit = r.counter(
            "fenced_commit_total",
            "Stamped offset commits the broker refused at the "
            "generation fence (a zombie's commit must not advance the "
            "group past refused predictions)")
        self._netfault_seen: Dict[Tuple[str, str], float] = {}
        # entity graph (graph/): typed-store occupancy and the sampler's
        # cache, mirrored from TorchFraudScorer.graph_snapshot() by
        # sync_graph
        self.graph_typed_mode = r.gauge(
            "graph_typed_mode",
            "1 while the scorer assembles typed entity-graph "
            "neighborhoods (graph/ plane), 0 on the bipartite "
            "user<->merchant store")
        self.graph_nodes = r.gauge(
            "graph_nodes",
            "Typed-graph nodes resident by node type (partitioned "
            "stores report the sum of owned-partition shards)",
            ("type",))
        self.graph_edges = r.gauge(
            "graph_edges",
            "Typed-graph ring entries resident by directed edge type",
            ("edge",))
        self.graph_edges_added = r.counter(
            "graph_edges_added_total",
            "Entity links ingested into the typed graph at finalize "
            "time (both directions of one link count once)")
        self.graph_sampler_cache_hits = r.counter(
            "graph_sampler_cache_hits_total",
            "Neighborhood-sampler cache hits (center sample reused)")
        self.graph_sampler_cache_misses = r.counter(
            "graph_sampler_cache_misses_total",
            "Neighborhood-sampler cache misses (center sample rebuilt)")
        self.graph_sampler_cache_evictions = r.counter(
            "graph_sampler_cache_evictions_total",
            "Sampler cache entries evicted (adjacency-dependency dirt, "
            "age-out, ownership-epoch clear, or the capacity cap)")
        self.graph_sampler_entries = r.gauge(
            "graph_sampler_entries",
            "Center samples currently resident in the sampler cache")
        # cross-partition resolution (graph/fetch.py GraphFetchClient)
        self.graph_remote_fetch = r.counter(
            "graph_remote_fetch_total",
            "Cross-partition neighbor-fetch requests sent to peer "
            "workers")
        self.graph_remote_nodes = r.counter(
            "graph_remote_nodes_total",
            "Node adjacency entries received from peer workers")
        self.graph_fetch_deadline = r.counter(
            "graph_fetch_deadline_total",
            "Microbatches whose remote resolution hit the per-batch "
            "deadline (degraded to the local subgraph)")
        self.graph_fetch_errors = r.counter(
            "graph_fetch_errors_total",
            "Failed/refused peer fetch calls (connection errors, "
            "netfault windows, backoff-gated skips)")
        self.graph_fetch_budget_exhausted = r.counter(
            "graph_fetch_budget_exhausted_total",
            "Microbatches whose remote resolution hit the per-batch "
            "node budget (partial remote view, counted as degraded)")
        self.graph_fetch_stale_generation = r.counter(
            "graph_fetch_stale_generation_total",
            "Peer fetches refused at the server's assignment-generation "
            "fence (stale requester — degraded, refreshed on rebalance "
            "adoption)")
        self.graph_degraded_batches = r.counter(
            "graph_degraded_batches_total",
            "Microbatches scored with a degraded (partial or local-only) "
            "neighbor view for ANY reason — deadline, budget, netfault, "
            "fenced generation")
        self._graph_seen: Dict[str, float] = {}

    # ------------------------------------------------------------- mirrors
    def sync_host_stats(self, host_stats: Mapping[str, Any]) -> None:
        """Mirror ``TorchFraudScorer.host_stats()``: cache totals and each
        stage's cumulative count and seconds as counter deltas, the stage
        mean / p50 / p99 a stage has as gauges (the collector's ``gc.gen*``
        entries keep no percentiles)."""
        for name, st in (host_stats.get("caches") or {}).items():
            for kind, counter in (("hits", self.host_cache_hits),
                                  ("misses", self.host_cache_misses)):
                _mirror(counter, self._host_cache_seen, (name, kind),
                        st.get(kind, 0), cache=name)
        for stage, st in (host_stats.get("stages") or {}).items():
            for stat in ("mean_ms", "p50_ms", "p99_ms"):
                if stat in st:
                    self.host_stage_ms.set(float(st[stat]), stage=stage,
                                           stat=stat.replace("_ms", ""))
            for key, counter in (("total_s", self.host_stage_seconds),
                                 ("count", self.host_stage_count)):
                if key in st:
                    _mirror(counter, self._host_stage_seen, (stage, key),
                            st[key], stage=stage)

    def sync_microbatch(self, close_reasons: Mapping[str, int]) -> None:
        """Mirror an assembler's cumulative close-reason histogram
        (``MicrobatchAssembler.close_reasons``)."""
        for reason, total in (close_reasons or {}).items():
            _mirror(self.microbatch_close_reason, self._close_reason_seen,
                    reason, total, reason=str(reason))

    def sync_tracing(self, snapshot: Mapping[str, Any]) -> None:
        """Mirror ``Tracer.snapshot()``. The tracer buckets stage durations
        with ``TRACE_STAGE_BUCKETS_MS``, the buckets of ``trace_stage_ms``,
        so the histogram mirror is a bucket-count delta (plus the slowest
        sample as exemplar); terminal, carrier and violation totals mirror
        as counter deltas, the burn rates as gauges."""
        for stage, st in (snapshot.get("stages") or {}).items():
            counts = list(st.get("bucket_counts") or ())
            if len(counts) != len(self.trace_stage_ms.buckets):
                continue
            prev = self._trace_seen.get(("stage", stage)) or {}
            deltas = [max(0, c - p) for c, p in zip(
                counts, prev.get("bucket_counts", [0] * len(counts)))]
            sum_ms = float(st.get("sum_ms", 0.0))
            sum_delta = max(0.0, sum_ms - float(prev.get("sum_ms", 0.0)))
            if any(deltas) or sum_delta > 0:
                ex = st.get("exemplar") or None
                self.trace_stage_ms.add_bucket_deltas(
                    deltas, sum_delta, max_value=st.get("max_ms"),
                    exemplar=({"value": ex["ms"], "trace_id": ex["trace_id"]}
                              if ex else None),
                    stage=stage)
            self._trace_seen[("stage", stage)] = {"bucket_counts": counts,
                                                  "sum_ms": sum_ms}
        counters = snapshot.get("counters") or {}
        for key, terminal in (("completed", "scored"), ("shed", "shed"),
                              ("errors", "error"), ("cached", "cached")):
            _mirror(self.trace_completed, self._trace_seen, ("terminal", terminal),
                    counters.get(key, 0), terminal=terminal)
        for key, counter in (("carrier_adopted", self.trace_carrier_adopted),
                             ("carrier_lost", self.trace_carrier_lost)):
            _mirror(counter, self._trace_seen, ("carrier", key), counters.get(key, 0))
        slo = snapshot.get("slo") or {}
        _mirror(self.trace_slo_violations, self._trace_seen, ("slo", "violations"),
                slo.get("violations_total", 0))
        for window, w in (slo.get("windows") or {}).items():
            burn = w.get("burn_rate")
            if burn is not None and math.isfinite(float(burn)):
                self.trace_slo_burn.set(float(burn), window=window)

    def sync_kernels(self, snapshot: Mapping[str, Any]) -> None:
        """Mirror ``TorchFraudScorer.kernel_snapshot()``: the mode gauges
        are exhaustive over each site's valid modes (a swap reads as a
        transition, not a new series), the dispatch / fallback counts
        mirror as deltas, the megakernel's also on its own series."""
        from realtime_fraud_detection_tpu_torch.utils.config import (
            VALID_ATTENTION_KERNELS,
            VALID_KERNEL_MODES,
            VALID_KERNEL_SITES,
        )

        modes = snapshot.get("modes") or {}
        for site in VALID_KERNEL_SITES:
            served = modes.get(site)
            valid = (VALID_ATTENTION_KERNELS if site == "attention"
                     else VALID_KERNEL_MODES)
            for mode in valid:
                self.kernel_site_mode.set(
                    1.0 if mode == served else 0.0,
                    site=str(site), mode=str(mode))
        for kind, counter in (("dispatch", self.kernel_dispatches),
                              ("fallback", self.kernel_fallbacks)):
            for site, total in (snapshot.get(kind) or {}).items():
                _mirror(counter, self._kernel_seen[kind], site, total,
                        site=str(site))
        for kind, counter in (("dispatch", self.kernel_mega_dispatch),
                              ("fallback", self.kernel_mega_fallback)):
            _mirror(counter, self._mega_seen, kind,
                    (snapshot.get(kind) or {}).get("megakernel", 0.0))
        self.kernel_launches_per_batch.set(
            float(snapshot.get("launches_per_batch", 0)))

    def sync_quant(self, snapshot: Mapping[str, Any]) -> None:
        """Mirror ``TorchFraudScorer.quant_snapshot()``: the branch-mode
        gauges are exhaustive over each branch's valid modes (a flip reads
        as a transition), the gate's verdicts mirror as counter deltas."""
        from realtime_fraud_detection_tpu_torch.utils.config import (
            VALID_BERT_WEIGHTS,
            VALID_TREE_KERNELS,
        )

        valid_by_branch = {"bert_text": VALID_BERT_WEIGHTS,
                           "xgboost_primary": VALID_TREE_KERNELS,
                           "isolation_forest": VALID_TREE_KERNELS}
        for branch, served in (snapshot.get("modes") or {}).items():
            for mode in valid_by_branch.get(branch, (served,)):
                self.quant_branch_mode.set(
                    1.0 if mode == served else 0.0,
                    branch=str(branch), mode=str(mode))
        for branch, nbytes in (snapshot.get("param_bytes") or {}).items():
            self.quant_param_bytes.set(float(nbytes), branch=str(branch))
        for verdict, total in (snapshot.get("gate") or {}).items():
            _mirror(self.quant_gate_verdicts, self._quant_seen, verdict, total,
                    verdict=str(verdict))

    def sync_autotune(self, snapshot: Mapping[str, Any]) -> None:
        """Mirror ``TuningPlane.snapshot()``: the controller's decisions and
        the tuner's epoch outcomes as counter deltas, the live knobs and
        the forecast as gauges."""
        ctrl = snapshot.get("controller") or {}
        for decision, total in (ctrl.get("decisions") or {}).items():
            _mirror(self.autotune_decisions, self._autotune_seen,
                    ("decision", str(decision)), total, decision=str(decision))
        tuner = snapshot.get("tuner") or {}
        for event in ("trials", "accepted", "reverted", "frozen_epochs"):
            _mirror(self.autotune_tuner_events, self._autotune_seen, ("tuner", event),
                    (tuner.get("counters") or {}).get(event, 0), event=event)
        self.autotune_forecast_tps.set(float(snapshot.get("forecast_tps", 0.0)))
        self.autotune_max_wait_ms.set(float(ctrl.get("max_wait_ms", 0.0)))
        self.autotune_bucket_set.set(float(tuner.get("bucket_set_idx", 0)))
        self.autotune_inflight_depth.set(float(tuner.get("inflight_depth", 0)))
        self.autotune_frozen.set(1.0 if tuner.get("frozen") else 0.0)

    def sync_graph(self, snapshot: Mapping[str, Any]) -> None:
        """Mirror ``TorchFraudScorer.graph_snapshot()``. A bipartite
        snapshot carries only ``mode``; the typed series keep their last
        mirrored values."""
        self.graph_typed_mode.set(
            1.0 if snapshot.get("mode") == "typed" else 0.0)
        store = snapshot.get("store") or {}
        for ntype, count in (store.get("nodes") or {}).items():
            self.graph_nodes.set(float(count), type=str(ntype))
        for edge, count in (store.get("edges") or {}).items():
            self.graph_edges.set(float(count), edge=str(edge))
        if "edges_added" in store:
            _mirror(self.graph_edges_added, self._graph_seen, "edges_added",
                    store["edges_added"])
        sampler = snapshot.get("sampler") or {}
        if sampler:
            for key, counter in (("hits", self.graph_sampler_cache_hits),
                                 ("misses", self.graph_sampler_cache_misses),
                                 ("evictions",
                                  self.graph_sampler_cache_evictions)):
                _mirror(counter, self._graph_seen, key, sampler.get(key, 0))
            self.graph_sampler_entries.set(
                float(sampler.get("entries", 0)))
        fetch = snapshot.get("fetch") or {}
        if fetch:
            for key, total, counter in (
                    ("remote_fetch", "remote_fetch_total",
                     self.graph_remote_fetch),
                    ("remote_nodes", "fetched_nodes_total",
                     self.graph_remote_nodes),
                    ("deadline", "fetch_deadline_total",
                     self.graph_fetch_deadline),
                    ("errors", "fetch_error_total", self.graph_fetch_errors),
                    ("budget", "budget_exhausted_total",
                     self.graph_fetch_budget_exhausted),
                    ("stale", "stale_generation_total",
                     self.graph_fetch_stale_generation),
                    ("degraded", "degraded_batches_total",
                     self.graph_degraded_batches)):
                _mirror(counter, self._graph_seen, key, fetch.get(total, 0))

    def sync_device_pool(self, stats: Mapping[str, Any]) -> None:
        """Mirror ``DevicePool.stats()``: per-replica totals as counter
        deltas, depth and the healthy count as gauges."""
        for dev in stats.get("devices") or ():
            name = str(dev.get("device", dev.get("index", "?")))
            for kind, counter in (("dispatched", self.pool_dispatched),
                                  ("completed", self.pool_completed),
                                  ("retries", self.pool_retries),
                                  ("queue_wait_ms", self.pool_queue_wait)):
                _mirror(counter, self._pool_seen, (name, kind), dev.get(kind, 0),
                        device=name)
            self.pool_inflight.set(float(dev.get("inflight", 0)), device=name)
        self.pool_healthy.set(float(stats.get("healthy", 0)))

    def sync_cluster(self, snapshot: Mapping[str, Any]) -> None:
        """Mirror ``WorkerFleet.snapshot()`` (stream side) or the serving
        app's router snapshot: gauges set, cumulative totals as counter
        deltas. A router-only snapshot lacks the handoff ledger, whose
        series keep their last mirrored values."""
        self.cluster_workers_alive.set(float(snapshot.get("workers_alive", 0)))
        for wid, w in (snapshot.get("workers") or {}).items():
            self.cluster_partitions_owned.set(
                float(w.get("partitions_owned", 0)), worker=str(wid))
        if "handoffs_total" in snapshot:
            _mirror(self.cluster_handoff, self._cluster_seen, "handoffs",
                    snapshot.get("handoffs_total", 0))
            self.cluster_handoff_replay_depth.set(
                float(snapshot.get("last_replay_depth", 0)))
        router = snapshot.get("router") or {}
        if "moved_keys_total" in router:
            _mirror(self.cluster_router_moved_keys, self._cluster_seen,
                    "router_moved", router.get("moved_keys_total", 0))

    def sync_chaos(self, snapshot: Mapping[str, Any]) -> None:
        """Mirror a ``chaos.ChaosPlan.snapshot()`` into the chaos_*
        series. Called at exposition time (the plan's poll path never
        touches the metrics lock); window-open counts mirror as deltas
        against last-seen values — the same honest-counter scheme as
        every other sync_* mirror."""
        for w in snapshot.get("windows") or ():
            fault = str(w.get("fault", "?"))
            opened = 1.0 if w.get("begun") else 0.0
            delta = opened - self._chaos_seen.get(fault, 0.0)
            if delta > 0:
                self.chaos_fault_windows.inc(delta, fault=fault)
            self._chaos_seen[fault] = opened
            self.chaos_fault_active.set(
                1.0 if w.get("active") else 0.0, fault=fault)
        for fault, rec_s in (snapshot.get("recovery_s") or {}).items():
            self.chaos_recovery_seconds.set(float(rec_s), fault=str(fault))

    def sync_autoscale(self, snapshot: Mapping[str, Any]) -> None:
        """Mirror an ``cluster.autoscale.AutoscaleController.snapshot()``
        — optionally carrying a ``handoff_server`` stats block
        (``HandoffServer.stats()`` / ``HandoffClient.stats()``) — into
        the autoscale_* / handoff_server_* series. Called at exposition
        time; cumulative quantities mirror as counter DELTAS against
        last-seen values (never a negative increment), so a stream-side
        coordinator and a serving app syncing the same snapshot render
        IDENTICAL series."""
        self.autoscale_target_workers.set(
            float(snapshot.get("target_workers", 0)))
        self.autoscale_forecast_rate.set(
            float(snapshot.get("forecast_rate", 0.0)))
        for direction in ("up", "down"):
            total = float((snapshot.get("events") or {}).get(direction, 0))
            key = f"events:{direction}"
            delta = total - self._autoscale_seen.get(key, 0.0)
            if delta > 0:
                self.autoscale_events.inc(delta, direction=direction)
            self._autoscale_seen[key] = total
        hs = snapshot.get("handoff_server") or {}
        for field, counter in (
                ("checkpoints_total", self.handoff_server_checkpoints),
                ("restores_total", self.handoff_server_restores),
                ("torn_blobs_total", self.handoff_server_torn_blobs)):
            if field not in hs:
                continue
            total = float(hs.get(field, 0))
            delta = total - self._autoscale_seen.get(field, 0.0)
            if delta > 0:
                counter.inc(delta)
            self._autoscale_seen[field] = total

    def sync_mesh(self, snapshot: Mapping[str, Any]) -> None:
        """Mirror ``MeshExecutor.mesh_snapshot()``: geometry and bytes as
        gauges, the per-replica dispatch and completion totals as counter
        deltas against the values last seen."""
        self.mesh_data_axis.set(float(snapshot.get("data_axis", 0)))
        self.mesh_model_axis.set(float(snapshot.get("model_axis", 0)))
        self.mesh_replica_count.set(float(snapshot.get("replicas", 0)))
        for branch, placement in (snapshot.get("placement") or {}).items():
            self.mesh_branch_sharded.set(
                1.0 if placement == "sharded" else 0.0, branch=str(branch))
        for branch, pb in (snapshot.get("param_bytes") or {}).items():
            self.mesh_param_bytes.set(float(pb.get("per_chip", 0)), branch=str(branch))
            self.mesh_param_bytes_replicated.set(float(pb.get("replicated", 0)),
                                                 branch=str(branch))
        for kind, counter in (("dispatched", self.mesh_dispatched),
                              ("completed", self.mesh_completed)):
            for replica, total in (snapshot.get(kind) or {}).items():
                _mirror(counter, self._mesh_seen, (kind, str(replica)), total,
                        replica=str(replica))

    def sync_netfaults(self, snapshot: Mapping[str, Any]) -> None:
        """Mirror a ``chaos.netfaults.LinkFaultPlane.snapshot()`` —
        optionally carrying a broker ``fencing`` block (the
        ``fenced_*_total`` counters from ``NetBrokerClient.status()`` /
        ``InMemoryBroker.producer_fence_stats()``) — into the
        netfault_* / fenced_* series. Called at exposition time; the
        links' cumulative effect counts mirror as counter DELTAS against
        last-seen values (never a negative increment), so a stream-job
        and a serving app syncing the same snapshot render IDENTICAL
        series."""
        for link, entry in (snapshot.get("links") or {}).items():
            link = str(link)
            self.netfault_link_active.set(
                1.0 if entry.get("active") else 0.0, link=link)
            for field, counter in (
                    ("windows_begun", self.netfault_windows),
                    ("delayed_sends_total", self.netfault_delayed_sends),
                    ("dropped_sends_total", self.netfault_dropped_sends),
                    ("partitioned_sends_total",
                     self.netfault_partitioned_sends),
                    ("lost_responses_total",
                     self.netfault_lost_responses),
                    ("throttled_bytes_total",
                     self.netfault_throttled_bytes)):
                total = float(entry.get(field, 0))
                key = (link, field)
                delta = total - self._netfault_seen.get(key, 0.0)
                if delta > 0:
                    counter.inc(delta, link=link)
                self._netfault_seen[key] = total
        fencing = snapshot.get("fencing") or {}
        for field, counter in (
                ("fenced_produces_total", self.fenced_produce),
                ("fenced_commits_total", self.fenced_commit)):
            if field not in fencing:
                continue
            total = float(fencing.get(field, 0))
            key = ("fencing", field)
            delta = total - self._netfault_seen.get(key, 0.0)
            if delta > 0:
                counter.inc(delta)
            self._netfault_seen[key] = total

    # -------------------------------------------------------------- events
    def sync_feedback(self, snapshot: Mapping[str, Any]) -> None:
        """Mirror ``FeedbackPlane.snapshot()``: prequential gauges per
        window, the buffer's occupancy by class, and the join's outcomes
        and the policy's counters as counter deltas."""
        preq = snapshot.get("prequential") or {}
        for window in ("sliding", "fading"):
            w = preq.get(window) or {}
            for key, gauge in (("auc", self.preq_auc),
                               ("precision", self.preq_precision),
                               ("recall", self.preq_recall)):
                v = w.get(key)
                if v is not None and math.isfinite(float(v)):
                    gauge.set(float(v), window=window)
        ce = (preq.get("sliding") or {}).get("calibration_error")
        if ce is not None and math.isfinite(float(ce)):
            self.preq_calibration.set(float(ce))
        self.feedback_label_lag.set(float(preq.get("mean_label_lag_s", 0.0)))
        buf = snapshot.get("buffer") or {}
        self.feedback_buffer.set(float(buf.get("positives", 0)), klass="positive")
        self.feedback_buffer.set(float(buf.get("negatives", 0)), klass="negative")
        seen = self._feedback_seen
        join = snapshot.get("label_join") or {}
        for outcome in ("matched", "expired_unlabeled", "orphan_labels",
                        "duplicate_labels"):
            _mirror(self.feedback_labels, seen, ("join", outcome),
                    join.get(outcome, 0), outcome=outcome)
        policy = snapshot.get("policy") or {}
        _mirror(self.feedback_gate, seen, ("gate", "pass"),
                policy.get("gate_pass", 0), verdict="pass")
        _mirror(self.feedback_gate, seen, ("gate", "fail"),
                policy.get("gate_fail", 0), verdict="fail")
        _mirror(self.feedback_promotions, seen, ("promotions", "total"),
                policy.get("promotions", 0))
        _mirror(self.feedback_triggers, seen, ("triggers", "total"),
                policy.get("triggers", 0), reason="any")

    def record_prediction(self, decision: str, fraud_score: float,
                          duration_s: float,
                          model_predictions: Optional[Mapping[str, float]] = None,
                          ) -> None:
        self.predictions_total.inc(model="ensemble", decision=decision)
        for name in (model_predictions or {}):
            self.predictions_total.inc(model=name, decision=decision)
        self.prediction_duration.observe(duration_s)
        self.fraud_score.observe(fraud_score)
        now = self._clock()
        with self._lock:
            self._recent.append((now, duration_s, fraud_score, decision))
            self._total += 1
            sec = int(now)
            if self._sec_counts and self._sec_counts[-1][0] == sec:
                self._sec_counts[-1][1] += 1
            else:
                self._sec_counts.append([sec, 1])

    def record_batch(self, size: int, duration_s: float) -> None:
        self.batch_size.observe(size)
        self.batch_duration.observe(duration_s)

    def record_error(self, stage: str = "predict") -> None:
        self.prediction_errors.inc(stage=stage)

    # ------------------------------------------------------------- summaries
    def summary(self) -> Dict[str, Any]:
        """The JSON metrics payload (reference ``GET /metrics``,
        main.py:268-288)."""
        now = self._clock()
        self.uptime.set(now - self._start)
        with self._lock:
            recent = list(self._recent)
            in_window = sum(c for s, c in self._sec_counts if now - s <= 60.0)
        tps = in_window / 60.0
        self.throughput.set(tps)
        durations = sorted(r[1] for r in recent)
        decisions: Dict[str, int] = {}
        for _, _, _, d in recent:
            decisions[d] = decisions.get(d, 0) + 1

        def pct(q: float) -> float:
            if not durations:
                return 0.0
            return durations[min(int(q * len(durations)), len(durations) - 1)]

        return {
            "uptime_seconds": now - self._start,
            "total_predictions": self._total,
            "recent_predictions": len(recent),
            "throughput_tps_60s": tps,
            "latency_ms": {
                "p50": pct(0.50) * 1e3,
                "p95": pct(0.95) * 1e3,
                "p99": pct(0.99) * 1e3,
            },
            "avg_fraud_score": (
                sum(r[2] for r in recent) / len(recent) if recent else 0.0),
            "decision_counts": decisions,
            "errors": int(self.prediction_errors.total()),
        }

    def render_prometheus(self) -> str:
        self.uptime.set(self._clock() - self._start)
        return self.registry.render()

    def reset(self) -> None:
        """Drop the windowed state (reference reset_metrics,
        metrics.py:403-417)."""
        with self._lock:
            self._recent.clear()
            self._sec_counts.clear()
