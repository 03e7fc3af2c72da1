"""Scoring configuration of the port: one typed tree with layering

    defaults -> JSON file (``Config.from_file``) -> environment variables

as in the JAX package's ``utils/config.py``. The blocks the port has: the
five-model registry (``ModelConfig``, enable / disable, weights), the
ensemble defaults ``EnsembleParams.from_config`` reads, the quant and kernel
planes, the state tier (``StateConfig``: the backend, in process or the
shared RESP server, its address, the stores' TTLs and list lengths), the
alert threshold (``StreamConfig``), the scoring service
(``ServingConfig``, with the prediction cache's TTL and size on
``EnsembleConfig``) and its monitoring switches (``MonitoringConfig``), and
the QoS, tracing, tuning and feedback planes' knobs (``QosSettings``,
``TracingSettings``, ``TuningSettings``, with the QoS floor on the tuner's
deadline, and ``FeedbackSettings``), the load generator's settings
(``SimConfig``), the partition-parallel plane's knobs (``ClusterSettings``:
the serving router, the handoff cadence, the elastic fleet's autoscale
bounds), the chaos plane's knobs (``ChaosSettings``), the mesh geometry and
the mesh executor's knobs (``MeshSettings``) and the models' base path; plus
the
quality-artifact loaders that deploy a measured blend
(``Config.apply_quality_artifact``).
The environment part: the ensemble's (``RTFD_ENSEMBLE_STRATEGY`` or
``ENSEMBLE_STRATEGY``, ``CONFIDENCE_THRESHOLD``, ``FRAUD_THRESHOLD``), the
service's address (``ML_SERVICE_HOST``, ``ML_SERVICE_PORT``), logging
(``LOG_LEVEL``, ``LOG_FILE``), ``MODELS_PATH`` and the state tier's
(``RTFD_STATE_BACKEND``, ``REDIS_HOST``, ``REDIS_PORT``), each also under
its ``RTFD_`` name, which wins (the backend's is looked up as JAX looks it
up: ``RTFD_RTFD_STATE_BACKEND``, then ``RTFD_STATE_BACKEND``). ``StreamConfig`` reads no environment variable,
as in the JAX package. Values are copies of the JAX package's; the port keeps
its own so it imports nothing of it.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

VALID_STRATEGIES = ("weighted_average", "voting", "stacking")


def _env(name: str, default: str) -> str:
    """``RTFD_<name>``, then ``name``, else ``default``."""
    for key in (f"RTFD_{name}", name):
        val = os.getenv(key)
        if val is not None:
            return val
    return default

# Decision-ladder rung defaults (ensemble_predictor.py:344-356).
DECLINE_THRESHOLD_DEFAULT = 0.95
REVIEW_THRESHOLD_DEFAULT = 0.8
MONITOR_THRESHOLD_DEFAULT = 0.6


@dataclass
class ModelConfig:
    """Per-model configuration (reference config.py:9-18). ``model_path``
    is kept for the schema's sake: all five branches live in one model set,
    swapped through ``TorchFraudScorer.set_models``."""

    name: str
    model_type: str  # 'gbdt' | 'lstm' | 'bert' | 'gnn' | 'isolation_forest'
    weight: float = 1.0
    enabled: bool = True
    model_path: str = ""
    hyperparameters: Dict[str, Any] = field(default_factory=dict)


def _default_models() -> Dict[str, ModelConfig]:
    """The five-model registry (reference config.py:126-199), in registry
    order."""
    return {
        "xgboost_primary": ModelConfig(
            name="xgboost_primary",
            model_type="gbdt",
            weight=0.40,
            hyperparameters={
                "n_estimators": 100,
                "max_depth": 6,
                "learning_rate": 0.1,
                "subsample": 0.8,
                "colsample_bytree": 0.8,
            },
        ),
        "lstm_sequential": ModelConfig(
            name="lstm_sequential",
            model_type="lstm",
            weight=0.25,
            hyperparameters={
                "sequence_length": 10,
                "hidden_units": 128,
                "dropout": 0.2,
            },
        ),
        "bert_text": ModelConfig(
            name="bert_text",
            model_type="bert",
            weight=0.15,
            hyperparameters={
                "max_length": 128,  # reference uses 512 but its texts are <64 tokens
                "vocab_size": 30522,
                "hidden_size": 768,
                "num_layers": 6,
                "num_heads": 12,
                "intermediate_size": 3072,
            },
        ),
        "graph_neural": ModelConfig(
            name="graph_neural",
            model_type="gnn",
            weight=0.15,
            hyperparameters={
                "hidden_channels": 64,
                "num_layers": 3,
                "dropout": 0.1,
                "num_neighbors": 16,
            },
        ),
        "isolation_forest": ModelConfig(
            name="isolation_forest",
            model_type="isolation_forest",
            weight=0.05,
            hyperparameters={
                "contamination": 0.1,
                "n_estimators": 100,
                "random_state": 42,
            },
        ),
    }

# Confidence multipliers per model (ensemble_predictor.py:331-337).
MODEL_CONFIDENCE_MULTIPLIER: Dict[str, float] = {
    "xgboost_primary": 1.0,
    "lstm_sequential": 0.8,
    "bert_text": 0.7,
    "graph_neural": 0.6,
    "isolation_forest": 0.5,
}
DEFAULT_CONFIDENCE_MULTIPLIER = 0.5


@dataclass
class EnsembleConfig:
    """Ensemble strategy + decision thresholds (config.py:21-27)."""

    strategy: str = "weighted_average"
    confidence_threshold: float = 0.7
    fraud_threshold: float = 0.5
    enable_explanation: bool = True
    decline_threshold: float = DECLINE_THRESHOLD_DEFAULT
    review_threshold: float = REVIEW_THRESHOLD_DEFAULT
    monitor_threshold: float = MONITOR_THRESHOLD_DEFAULT
    # the serving prediction cache (ensemble_predictor.py:57-58, 460-471)
    cache_ttl_seconds: float = 300.0
    cache_max_entries: int = 1000


@dataclass
class ServingConfig:
    """The scoring service's settings (reference config.py:72-88 and the
    TF-Serving batching block, ml-models-deployment.yaml:270-290)."""

    host: str = "0.0.0.0"
    port: int = 8080
    max_concurrent_predictions: int = 100
    prediction_timeout_seconds: float = 5.0
    batch_size_limit: int = 1000
    # the request microbatcher: close after deadline_ms or at max_size
    microbatch_deadline_ms: float = 5.0
    microbatch_max_size: int = 256
    # idempotent retries of a transaction_id are served from the prediction
    # cache (TTL and size on EnsembleConfig)
    enable_prediction_cache: bool = True
    # two-phase microbatcher: dispatch batch N+1 while batch N waits on the
    # card. A retry arriving while its first copy is between dispatch and
    # finalize misses the cache and is scored (and written back) again
    overlap_assembly: bool = False
    # the device pool (scoring/device_pool.py): whole microbatches round-
    # robin over replicas of the models, each with its own CUDA stream;
    # implies the two-phase microbatcher with its depth raised to the
    # pool's capacity (replicas x inflight_depth), so the retry window
    # above widens to the pool's in-flight window
    device_pool: bool = False
    inflight_depth: int = 2
    # the tuning plane's just-in-time closer drives the microbatcher's
    # close decisions (knobs on Config.tuning)
    autotune: bool = False

    def validate(self) -> None:
        if not 0 <= self.port <= 65535:
            raise ValueError(f"serving.port must be in [0, 65535], got {self.port}")
        if self.max_concurrent_predictions < 1 or self.batch_size_limit < 1 \
                or self.microbatch_max_size < 1:
            raise ValueError(
                "serving requires max_concurrent_predictions, batch_size_limit "
                "and microbatch_max_size >= 1")
        if self.prediction_timeout_seconds <= 0 or self.microbatch_deadline_ms < 0:
            raise ValueError(
                "serving requires prediction_timeout_seconds > 0 and "
                "microbatch_deadline_ms >= 0")


@dataclass
class MonitoringConfig:
    """The service's monitoring switches: the dedicated Prometheus listener
    (0 = none; ``GET /metrics/prometheus`` on the main port either way),
    the log level and rotating JSON log file, per-prediction metrics and
    feature drift."""

    enable_prometheus: bool = True
    prometheus_port: int = 8081
    log_level: str = "INFO"
    log_file: str = ""
    enable_performance_tracking: bool = True
    enable_drift_detection: bool = True

    def validate(self) -> None:
        if not 0 <= self.prometheus_port <= 65535:
            raise ValueError(f"monitoring.prometheus_port must be in [0, 65535], "
                             f"got {self.prometheus_port}")
        if logging.getLevelName(str(self.log_level).upper()) not in range(0, 51):
            raise ValueError(f"monitoring.log_level {self.log_level!r} is not a "
                             f"logging level")


VALID_BERT_WEIGHTS = ("f32", "int8")
VALID_TREE_KERNELS = ("gather", "gemm")


@dataclass
class QuantSettings:
    """Quantized scoring plane: weight-only int8 BERT and the GEMM-form
    tree traversals, selectable per branch. Off by default."""

    enabled: bool = False
    bert_weights: str = "f32"       # f32 | int8
    tree_kernel: str = "gather"     # gather | gemm
    iforest_kernel: str = "gather"  # gather | gemm

    def validate(self) -> None:
        if self.bert_weights not in VALID_BERT_WEIGHTS:
            raise ValueError(
                f"quant.bert_weights must be one of {VALID_BERT_WEIGHTS}, "
                f"got {self.bert_weights!r}")
        for name, kernel in (("tree_kernel", self.tree_kernel),
                             ("iforest_kernel", self.iforest_kernel)):
            if kernel not in VALID_TREE_KERNELS:
                raise ValueError(
                    f"quant.{name} must be one of {VALID_TREE_KERNELS}, "
                    f"got {kernel!r}")

    @classmethod
    def full(cls) -> "QuantSettings":
        """int8 BERT + GEMM-form kernels for both tree branches."""
        return cls(enabled=True, bert_weights="int8",
                   tree_kernel="gemm", iforest_kernel="gemm")

    def bert_mode(self) -> str:
        return self.bert_weights if self.enabled else "f32"

    def static(self) -> Dict[str, str]:
        """The tree-kernel selection the fused scorer takes."""
        if not self.enabled:
            return {"tree_kernel": "gather", "iforest_kernel": "gather"}
        return {"tree_kernel": self.tree_kernel,
                "iforest_kernel": self.iforest_kernel}


VALID_KERNEL_SITES = ("dequant_matmul", "epilogue", "attention",
                      "megakernel")
VALID_KERNEL_MODES = ("off", "cuda")
VALID_ATTENTION_KERNELS = ("reference", "flash")


@dataclass
class KernelSettings:
    """Hand-written kernel plane (ops/): per-site kernel selection.

    ``dequant_matmul``, ``epilogue`` and ``megakernel`` are "off" or
    "cuda"; ``attention`` is "reference" or "flash". When the megakernel
    engages it subsumes the three per-site kernels: one launch scores the
    batch, and the per-site selections only matter on shapes its plan
    declines (``ops/megakernel.py mega_plan``), which fall back to the
    per-site chain. Off by default.
    """

    enabled: bool = False
    dequant_matmul: str = "off"
    epilogue: str = "off"
    attention: str = "reference"
    megakernel: str = "off"

    def validate(self) -> None:
        for name, mode in (("dequant_matmul", self.dequant_matmul),
                           ("epilogue", self.epilogue),
                           ("megakernel", self.megakernel)):
            if mode not in VALID_KERNEL_MODES:
                raise ValueError(
                    f"kernels.{name} must be one of {VALID_KERNEL_MODES}, "
                    f"got {mode!r}")
        if self.attention not in VALID_ATTENTION_KERNELS:
            raise ValueError(
                f"kernels.attention must be one of "
                f"{VALID_ATTENTION_KERNELS}, got {self.attention!r}")

    @classmethod
    def full(cls) -> "KernelSettings":
        """Fused dequant-matmul + fused epilogue + flash attention."""
        return cls(enabled=True, dequant_matmul="cuda", epilogue="cuda",
                   attention="flash")

    @classmethod
    def mega(cls) -> "KernelSettings":
        """``full()`` plus the persistent megakernel; the per-site plane
        stays the fallback for shapes the megakernel's plan declines."""
        return cls(enabled=True, dequant_matmul="cuda", epilogue="cuda",
                   attention="flash", megakernel="cuda")

    def site_modes(self) -> Dict[str, str]:
        if not self.enabled:
            return {"dequant_matmul": "off", "epilogue": "off",
                    "attention": "reference", "megakernel": "off"}
        return {"dequant_matmul": self.dequant_matmul,
                "epilogue": self.epilogue, "attention": self.attention,
                "megakernel": self.megakernel}

    def static(self) -> Dict[str, object]:
        """The kernel selection the fused scorer takes."""
        modes = self.site_modes()
        return {"dequant_kernel": modes["dequant_matmul"],
                "epilogue_kernel": modes["epilogue"],
                "use_flash": modes["attention"] == "flash",
                "megakernel": modes["megakernel"]}


@dataclass
class StateConfig:
    """State store settings (RedisService.java key TTLs). ``backend``
    "memory" keeps the stores in process; "redis" makes a scorer built
    without a ``state_client`` connect to the shared RESP server at
    ``redis_host:redis_port`` (the reference's REDIS_HOST / REDIS_PORT).
    Velocity windows expire on their own periods, so there is no velocity
    TTL."""

    backend: str = "memory"  # memory | redis
    redis_host: str = "localhost"
    redis_port: int = 6379
    transaction_ttl_s: int = 24 * 3600
    features_ttl_s: int = 2 * 3600
    user_history_len: int = 100  # RedisService.java:296-306 last-100 list
    merchant_history_len: int = 500


@dataclass
class QosSettings:
    """The deadline-aware QoS plane's knobs (qos/): admission, budgets,
    ladder. Off by default; ``run-job --qos`` or a config file turns it on.
    Every knob is run-time state of the plane (``QosPlane.configure``)."""

    enabled: bool = False
    # the per-transaction latency budget (the p99 contract) and the slice
    # of it reserved for transfer + compute + return: assembly closes a
    # batch margin_ms before the oldest waiter's deadline
    budget_ms: float = 20.0
    assemble_margin_ms: float = 2.0
    # token-bucket admission: sustainable txn/s (0 = unlimited), bucket size
    # (0 = one second of tokens), and the reserve fraction under which the
    # low class sheds first
    admission_rate: float = 0.0
    admission_burst: float = 0.0
    low_reserve_frac: float = 0.25
    # priority by amount when a record carries no "priority" field:
    # >= high_value_amount -> high (never shed), < low_value_amount -> low
    # (sheds first), else normal
    high_value_amount: float = 500.0
    low_value_amount: float = 25.0
    # the degradation ladder (qos/ladder.py): backlog watermarks in records
    # and consecutive observations per step (the hysteresis)
    ladder_enabled: bool = True
    ladder_high_backlog: float = 2048.0
    ladder_low_backlog: float = 256.0
    ladder_patience: int = 2
    # recovery (step-up) patience; 0 = ladder_patience. Slower recovery
    # keeps a sustained overload from flapping the ensemble
    ladder_up_patience: int = 8

    def validate(self) -> None:
        """The QoS invariants, checked at load (``Config.validate``) and on
        every run-time update (``QosPlane.configure``)."""
        if self.budget_ms <= 0 or self.assemble_margin_ms < 0 \
                or self.assemble_margin_ms >= self.budget_ms:
            raise ValueError(
                f"qos budget must satisfy 0 <= assemble_margin_ms < "
                f"budget_ms, got margin={self.assemble_margin_ms} "
                f"budget={self.budget_ms}")
        if self.ladder_low_backlog > self.ladder_high_backlog:
            # inverted watermarks would step down and up on the same backlog
            raise ValueError(
                f"qos ladder watermarks must satisfy low_backlog <= "
                f"high_backlog, got low={self.ladder_low_backlog} "
                f"high={self.ladder_high_backlog}")


@dataclass
class TracingSettings:
    """End-to-end transaction tracing plane knobs (obs/tracing.py):
    flight recorder, critical-path analyzer, SLO burn-rate tracking.

    Disabled by default — the plane is opt-in (``run-job --trace``, or a
    config file) with a no-op fast path when off (one ``is None`` branch
    per batch on the scoring path; ``trace-drill`` pins the enabled path's
    overhead bound too). All knobs are host state.
    """

    enabled: bool = False
    # process identity stamped into minted trace ids and wire carriers
    # ("" = single-process id format): what keeps two workers' fresh
    # roots globally distinct when the coordinator stitches their rings
    origin: str = ""
    # flight recorder: ring of the most recent completed traces, plus the
    # slowest-N kept verbatim (the tail exemplars Chrome-trace export and
    # /latency/breakdown surface regardless of ring churn)
    ring_size: int = 4096
    slowest_n: int = 32
    # SLO objective: objective_frac of scored transactions complete under
    # objective_ms, evaluated over a fast and a slow window (the standard
    # multi-window burn-rate pair); bucket_s is the counting granularity
    slo_objective_ms: float = 20.0
    slo_objective_frac: float = 0.99
    slo_fast_window_s: float = 3600.0
    slo_slow_window_s: float = 21600.0
    slo_bucket_s: float = 60.0
    # QoS consultation: a fast-window burn rate above slo_burn_threshold
    # for slo_gate_patience consecutive observations engages an extra
    # degradation floor (>= ladder rung 1); recovery needs
    # slo_gate_up_patience consecutive under-threshold observations —
    # the same asymmetric hysteresis discipline as the backlog ladder
    slo_burn_threshold: float = 2.0
    slo_gate_patience: int = 3
    slo_gate_up_patience: int = 12

    def validate(self) -> None:
        if not 0.0 < self.slo_objective_frac < 1.0:
            raise ValueError(
                f"tracing.slo_objective_frac must be in (0, 1), got "
                f"{self.slo_objective_frac}")
        if self.slo_objective_ms <= 0 or self.ring_size < 16 \
                or self.slowest_n < 1:
            raise ValueError(
                "tracing requires slo_objective_ms > 0, ring_size >= 16 "
                "and slowest_n >= 1")
        if not (0 < self.slo_bucket_s <= self.slo_fast_window_s
                <= self.slo_slow_window_s):
            # a fast window longer than the slow one would invert the
            # burn-alerting pair; a bucket wider than the fast window
            # would make its burn rate a single stale cell
            raise ValueError(
                f"tracing SLO windows must satisfy 0 < bucket_s <= "
                f"fast_window_s <= slow_window_s, got "
                f"bucket={self.slo_bucket_s} fast={self.slo_fast_window_s} "
                f"slow={self.slo_slow_window_s}")
        if self.slo_burn_threshold <= 0 or self.slo_gate_patience < 1 \
                or self.slo_gate_up_patience < 1:
            raise ValueError(
                "tracing SLO gate requires burn_threshold > 0 and "
                "patience/up_patience >= 1")


@dataclass
class TuningSettings:
    """Self-tuning host pipeline knobs (tuning/): arrival-rate forecast,
    just-in-time batch closing, and the gradient-free online config tuner.

    Disabled by default — the plane is opt-in (``run-job --autotune``, or a
    config file). With it off, batch-close decisions are BIT-IDENTICAL to
    the fixed-deadline path (the assembler takes the controller branch
    only when one is attached). All knobs are host state.
    """

    enabled: bool = False
    # arrival forecaster (tuning/forecast.py): Holt double-exponential
    # smoothing over time-bucketed admission counts. bucket_s is the
    # counting granularity (and the forecast reaction time); alpha/beta
    # the level/trend smoothing factors
    forecast_bucket_s: float = 0.02
    forecast_alpha: float = 0.5
    forecast_beta: float = 0.2
    # just-in-time closer (tuning/controller.py): the tuned max-wait
    # deadline moves within [deadline_min_ms, deadline_max_ms]; with a
    # QoS plane configured, deadline_max_ms must leave the budget's
    # assembly slice intact (validated — the tuner can NEVER starve a
    # latency budget the QoS plane promised)
    deadline_min_ms: float = 0.25
    deadline_max_ms: float = 10.0
    # free-rider patience: waiting for one more (service-free, pad-riding)
    # txn is worth `patience_factor x T(bucket) / fill` of the current
    # waiters' time — the marginal-gain-vs-cost knob (arXiv:1904.07421)
    patience_factor: float = 1.0
    # candidate bucket sets the tuner may select among (index 0 is the
    # starting set). Each must be a non-empty ascending list of positive
    # sizes; the defaults are subsets of core/batching.BATCH_BUCKETS so a
    # tuned close boundary always lands on a compile-cached padded shape
    # (closing at an off-bucket size pads up and wastes the difference).
    bucket_sets: List[List[int]] = field(default_factory=lambda: [
        [1, 8, 32, 128, 256],
        [1, 32, 256],
        [1, 8, 32, 256],
    ])
    # online tuner (tuning/tuner.py): epoch length in completed batches,
    # the relative admitted-p99 improvement required to KEEP a move (the
    # hysteresis), and the post-move cooldown in epochs
    tune_interval_batches: int = 50
    hysteresis_frac: float = 0.05
    tuner_cooldown_epochs: int = 2
    # overlap / in-flight depth search range
    inflight_min: int = 1
    inflight_max: int = 4

    def clamp_to_qos(self, qos: "QosSettings | None") -> None:
        """Clamp the deadline search space to the QoS budget's assembly
        slice, then re-validate — the clamp-then-check recipe
        ``run-job --autotune`` applies."""
        if qos is not None and getattr(qos, "enabled", False):
            limit = qos.budget_ms - qos.assemble_margin_ms
            self.deadline_max_ms = min(self.deadline_max_ms, limit)
            self.deadline_min_ms = min(self.deadline_min_ms,
                                       self.deadline_max_ms)
        self.validate(qos=qos)

    def validate(self, qos: "QosSettings | None" = None) -> None:
        if not (0.0 < self.deadline_min_ms <= self.deadline_max_ms):
            raise ValueError(
                f"tuning deadline bounds must satisfy 0 < deadline_min_ms "
                f"<= deadline_max_ms, got min={self.deadline_min_ms} "
                f"max={self.deadline_max_ms}")
        if not self.bucket_sets:
            raise ValueError("tuning.bucket_sets must not be empty")
        for bs in self.bucket_sets:
            if not bs or list(bs) != sorted(bs) or min(bs) < 1 \
                    or len(set(bs)) != len(bs):
                raise ValueError(
                    f"every tuning bucket set must be a non-empty strictly "
                    f"ascending list of positive sizes, got {bs!r}")
        if not (0.0 < self.forecast_alpha <= 1.0
                and 0.0 <= self.forecast_beta <= 1.0
                and self.forecast_bucket_s > 0):
            raise ValueError(
                "tuning forecast requires 0 < alpha <= 1, 0 <= beta <= 1 "
                "and bucket_s > 0")
        if self.tune_interval_batches < 1 or self.hysteresis_frac < 0 \
                or self.tuner_cooldown_epochs < 0:
            raise ValueError(
                "tuning requires tune_interval_batches >= 1, "
                "hysteresis_frac >= 0 and tuner_cooldown_epochs >= 0")
        if not (1 <= self.inflight_min <= self.inflight_max):
            raise ValueError(
                f"tuning requires 1 <= inflight_min <= inflight_max, got "
                f"min={self.inflight_min} max={self.inflight_max}")
        if self.patience_factor <= 0:
            raise ValueError("tuning.patience_factor must be > 0")
        if self.enabled and qos is not None \
                and getattr(qos, "enabled", False):
            # the hard QoS floor: the tuner's deadline search space may
            # never reach past the budget's assembly slice — a tuned
            # max-wait that outlives close_by would hold batches past the
            # deadline the QoS plane promised every admitted transaction.
            # Checked only when the plane is ON: a disabled tuner imposes
            # no constraint on an otherwise-valid QoS config.
            limit = qos.budget_ms - qos.assemble_margin_ms
            if self.deadline_max_ms > limit:
                raise ValueError(
                    f"tuning.deadline_max_ms={self.deadline_max_ms} "
                    f"violates the QoS budget: must be <= budget_ms - "
                    f"assemble_margin_ms = {limit}")


@dataclass
class FeedbackSettings:
    """Continuous-learning plane knobs (``feedback/``): label join,
    prequential evaluation, retrain policy, promotion gate. Disabled by
    default: the plane is opt-in per deployment (``serve`` /
    ``run-job --feedback``, a JSON overlay). All knobs are host state."""

    enabled: bool = False
    # label-join windowing: how long an unlabeled prediction waits for its
    # chargeback before expiring, and the per-stream out-of-orderness
    label_horizon_s: float = 90 * 86_400.0
    label_ooo_s: float = 60.0
    pred_ooo_s: float = 5.0
    # hard cap on predictions waiting for a label (the watermark horizon
    # cannot evict while the labels topic is silent)
    join_max_pending: int = 100_000
    # synthetic label emission (sim): compresses the chargeback delay
    # distribution (1.0 = realistic days; drills use tiny values)
    label_delay_scale: float = 1.0
    # labeled-example buffer (state/labeled.py)
    buffer_size: int = 50_000
    buffer_store_history: bool = False
    # prequential evaluation
    sliding_window: int = 2_000
    fading_gamma: float = 0.999
    operating_threshold: float = 0.5
    # retrain policy
    auc_drop: float = 0.08
    auc_floor: float = 0.0
    min_labels: int = 300
    cooldown_s: float = 600.0
    use_drift_trigger: bool = True
    # candidate training
    retrain_trees: int = 48
    retrain_depth: int = 5
    retrain_iforest_trees: int = 60
    retrain_neural: bool = False
    # promotion gate
    gate_holdout_frac: float = 0.2
    gate_select_frac: float = 0.2
    gate_min_positives: int = 12
    gate_auc_margin: float = 0.0
    gate_recall_tolerance: float = 0.02

    def validate(self) -> None:
        if not 0.0 < self.fading_gamma < 1.0:
            raise ValueError(
                f"feedback.fading_gamma must be in (0, 1), got "
                f"{self.fading_gamma}")
        if self.sliding_window < 10 or self.buffer_size < 10:
            raise ValueError(
                "feedback.sliding_window and buffer_size must be >= 10")
        if not (0.0 < self.gate_holdout_frac < 1.0
                and 0.0 < self.gate_select_frac < 1.0
                and self.gate_holdout_frac + self.gate_select_frac < 0.9):
            # the gate must always keep a real training majority
            raise ValueError(
                f"feedback gate fractions must satisfy 0 < holdout, select "
                f"and holdout + select < 0.9, got "
                f"holdout={self.gate_holdout_frac} "
                f"select={self.gate_select_frac}")
        if self.label_horizon_s <= 0 or self.label_delay_scale <= 0:
            raise ValueError(
                "feedback.label_horizon_s and label_delay_scale must be > 0")


@dataclass
class StreamConfig:
    """Transport settings (reference JobConfig.java:20-38 semantics). Of the
    JAX block's fields only the alert threshold is read by any code (the
    serving app's experiments flag a prediction above it); its transport
    fields (backend, bootstrap servers, topic names, partitions, checkpoint
    interval) are read by nothing in either package, so the port leaves
    them out and a config file that sets them gets the unknown-key
    warning."""

    alert_score_threshold: float = 0.7  # FraudDetectionJob.java:66


@dataclass
class ChaosSettings:
    """The chaos plane's knobs (``chaos/``): deterministic fault injection
    and the adversarial fraud ring, composed by ``chaos-drill``. Off by
    default: injectors are explicit objects a harness builds, and no hot
    path has a chaos branch. The knobs reach the drill through
    ``chaos-drill --config file.json`` (``chaos/drill.py
    apply_chaos_settings`` overlays them onto the drill's config); all are
    virtual-clock quantities, so a change reshapes the replayed timeline
    deterministically. ``enabled`` gates nothing yet, as in the JAX
    package."""

    enabled: bool = False
    seed: int = 11
    # fault windows (virtual seconds, relative to their phase starts)
    broker_outage_s: float = 1.5       # replica down -> NotEnoughReplicas
    label_stall_s: float = 4.0         # label stream held back
    flash_crowd_mult: float = 2.5      # peak offered load / capacity
    flash_burst_mult: float = 1.6      # short bursts on top of the peak
    # adversarial fraud ring (sim/fraud_patterns.FraudRingConfig)
    ring_rate: float = 0.10
    ring_members: int = 24
    ring_merchants: int = 6
    ring_devices: int = 4
    ring_ips: int = 3
    # device-pool faults: how many in-flight fetches the dead replica
    # fails before revival, and the slow-device injected delay
    replica_faults: int = 1
    slow_device_ms: float = 40.0

    def validate(self) -> None:
        if self.broker_outage_s <= 0 or self.label_stall_s < 0:
            raise ValueError(
                "chaos.broker_outage_s must be > 0 and label_stall_s >= 0")
        if self.flash_crowd_mult < 1.0 or self.flash_burst_mult < 1.0:
            raise ValueError(
                f"chaos flash-crowd multipliers must be >= 1, got "
                f"crowd={self.flash_crowd_mult} "
                f"burst={self.flash_burst_mult}")
        if not 0.0 < self.ring_rate <= 1.0:
            raise ValueError(
                f"chaos.ring_rate must be in (0, 1], got {self.ring_rate}")
        if min(self.ring_members, self.ring_merchants, self.ring_devices,
               self.ring_ips) < 1:
            raise ValueError("chaos ring needs >= 1 of each entity kind")
        if self.replica_faults < 1 or self.slow_device_ms < 0:
            raise ValueError(
                "chaos.replica_faults must be >= 1 and slow_device_ms >= 0")


@dataclass
class ClusterSettings:
    """The partition-parallel plane's knobs (``cluster/``), the fields this
    port's code reads. ``enabled`` turns on the serving router: this process
    serves ``/predict`` only for users whose partition the ring assigns to
    ``worker_id``; other keys get a 421 naming the owner's address
    (``workers``). Placement is a pure function of (workers, n_partitions,
    virtual_nodes), the same in every process. The stream-side fleets
    (``cluster/fleet.py WorkerFleet``, ``cluster/procfleet.py``) read
    ``checkpoint_every``; the elastic fleet's autoscaler reads the
    worker bounds and the capacity model."""

    enabled: bool = False
    # must match the transactions topic's partition count (the key ->
    # partition hash is the transport's; stream/topics.py: 12)
    n_partitions: int = 12
    virtual_nodes: int = 256
    # completed batches between per-partition handoff snapshots
    checkpoint_every: int = 8
    # this process's id in the ring ("" = not a fleet member)
    worker_id: str = ""
    # worker_id -> base URL: the router's redirect targets; the ring is
    # built over these ids
    workers: Dict[str, str] = field(default_factory=dict)
    # the elastic process fleet (cluster/procfleet.py, cluster/autoscale.py):
    # the worker-count bounds the autoscaler moves between, the capacity it
    # divides the forecast by, and the forecast lead that grows the fleet
    # before a peak (spawn latency is paid inside the lead)
    min_workers: int = 1
    max_workers: int = 8
    per_worker_tps: float = 200.0
    autoscale_headroom: float = 1.25
    autoscale_lead_s: float = 2.0
    autoscale_interval_s: float = 0.5
    autoscale_down_patience: int = 3

    def validate(self) -> None:
        if self.n_partitions < 1:
            raise ValueError(
                f"cluster.n_partitions must be >= 1, got {self.n_partitions}")
        if self.virtual_nodes < 1 or self.checkpoint_every < 1:
            raise ValueError(
                "cluster.virtual_nodes and cluster.checkpoint_every must be >= 1")
        if not 1 <= self.min_workers <= self.max_workers:
            raise ValueError(
                f"cluster autoscale needs 1 <= min_workers <= "
                f"max_workers, got {self.min_workers}..{self.max_workers}")
        if (self.per_worker_tps <= 0 or self.autoscale_headroom < 1.0
                or self.autoscale_lead_s < 0
                or self.autoscale_interval_s <= 0
                or self.autoscale_down_patience < 1):
            raise ValueError(
                "cluster autoscale requires per_worker_tps > 0, "
                "headroom >= 1, lead_s >= 0, interval_s > 0 and "
                "down_patience >= 1")
        if self.enabled:
            if not self.workers:
                raise ValueError(
                    "cluster.enabled requires a non-empty cluster.workers "
                    "map (worker_id -> base URL)")
            if self.worker_id and self.worker_id not in self.workers:
                raise ValueError(
                    f"cluster.worker_id {self.worker_id!r} missing from "
                    f"cluster.workers {sorted(self.workers)}")


@dataclass
class SimConfig:
    """Load-generator settings (reference simulator.py:480-489)."""

    tps: int = 100
    num_users: int = 10_000
    num_merchants: int = 5_000
    seed: int = 42


# Branches whose params may take the sharded placement on the serving mesh
# (scoring/mesh_executor.py; parallel/layouts.SHARDABLE_BRANCHES maps these
# onto ScoringModels fields, a test pins the two in sync). Trees / iforest /
# rules are replicated by design.
MESH_SHARDABLE_BRANCHES = ("bert_text", "lstm_sequential", "graph_neural")


@dataclass
class MeshSettings:
    """Mesh geometry: the (data, model, seq) axes of ``core/mesh.py`` and
    the serving executor's knobs (``scoring/mesh_executor.py``).

    ``enabled`` opts a serving deployment into mesh-sharded scoring:
    ``replicas`` ``data x model`` meshes in round-robin rotation, each
    storing the ``shard_branches`` params split over ``model`` while the
    microbatch splits over ``data``. ``data=None`` takes every visible card
    (as JAX takes every device); a ``data`` size places ``replicas x data x
    model`` positions over the cards, cycled, several on one card each with
    its own stream (on the CPU, all there). Off by default: the replicated
    ``DevicePool`` stays the baseline plane; ``mesh-drill`` gates the
    sharded path's bit-equality contract."""

    data: int | None = None
    model: int = 1
    seq: int = 1
    enabled: bool = False
    replicas: int = 1
    inflight_depth: int = 2
    shard_branches: List[str] = field(default_factory=lambda: ["bert_text"])

    def validate(self) -> None:
        if self.model < 1 or self.seq < 1:
            raise ValueError(
                f"mesh axes must be >= 1, got model={self.model} "
                f"seq={self.seq}")
        if self.replicas < 1 or self.inflight_depth < 1:
            raise ValueError(
                "mesh.replicas and mesh.inflight_depth must be >= 1")
        bad = [b for b in self.shard_branches
               if b not in MESH_SHARDABLE_BRANCHES]
        if bad:
            raise ValueError(
                f"mesh.shard_branches {bad} not shardable; valid: "
                f"{list(MESH_SHARDABLE_BRANCHES)} (trees/iforest/rules "
                f"are replicated by design)")


@dataclass
class Config:
    """The slice of the JAX package's root ``Config`` the port reads. A
    disabled model is left out of the blend and of the scorer's validity
    mask. ``service_name`` stamps the process's JSON log lines."""

    service_name: str = "rtfd-tpu"
    environment: str = "development"
    models_base_path: str = "artifacts/models"
    sim: SimConfig = field(default_factory=SimConfig)
    models: Dict[str, ModelConfig] = field(default_factory=_default_models)
    ensemble: EnsembleConfig = field(default_factory=EnsembleConfig)
    quant: QuantSettings = field(default_factory=QuantSettings)
    kernels: KernelSettings = field(default_factory=KernelSettings)
    state: StateConfig = field(default_factory=StateConfig)
    stream: StreamConfig = field(default_factory=StreamConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    monitoring: MonitoringConfig = field(default_factory=MonitoringConfig)
    qos: QosSettings = field(default_factory=QosSettings)
    feedback: FeedbackSettings = field(default_factory=FeedbackSettings)
    tracing: TracingSettings = field(default_factory=TracingSettings)
    tuning: TuningSettings = field(default_factory=TuningSettings)
    cluster: ClusterSettings = field(default_factory=ClusterSettings)
    chaos: ChaosSettings = field(default_factory=ChaosSettings)
    mesh: MeshSettings = field(default_factory=MeshSettings)

    def __post_init__(self) -> None:
        self._apply_env()
        self.validate()

    def _apply_env(self) -> None:
        """The JAX ``Config._apply_env`` for the blocks the port has:
        the models' base path, the service's address, the ensemble's
        strategy and thresholds, the log level and file and the state
        tier's backend and Redis address, from ``RTFD_``-prefixed or plain
        environment variables."""
        self.models_base_path = _env("MODELS_PATH", self.models_base_path)
        self.serving.port = int(_env("ML_SERVICE_PORT", str(self.serving.port)))
        self.serving.host = _env("ML_SERVICE_HOST", self.serving.host)
        self.monitoring.log_level = _env("LOG_LEVEL", self.monitoring.log_level)
        self.monitoring.log_file = _env("LOG_FILE", self.monitoring.log_file)
        e = self.ensemble
        e.strategy = _env("ENSEMBLE_STRATEGY", e.strategy)
        e.confidence_threshold = float(
            _env("CONFIDENCE_THRESHOLD", str(e.confidence_threshold)))
        e.fraud_threshold = float(_env("FRAUD_THRESHOLD", str(e.fraud_threshold)))
        # the reference's Redis contract (REDIS_HOST / REDIS_PORT): with
        # state.backend "redis" they select the shared state tier
        self.state.backend = _env("RTFD_STATE_BACKEND", self.state.backend)
        self.state.redis_host = _env("REDIS_HOST", self.state.redis_host)
        self.state.redis_port = int(_env("REDIS_PORT", str(self.state.redis_port)))

    # -- registry helpers (reference config.py:201-224) --------------------
    def get_model_config(self, model_name: str) -> ModelConfig:
        if model_name not in self.models:
            raise ValueError(f"Model '{model_name}' not found in configuration")
        return self.models[model_name]

    def get_enabled_models(self) -> Dict[str, ModelConfig]:
        return {n: c for n, c in self.models.items() if c.enabled}

    def normalized_weights(self) -> Dict[str, float]:
        """Blend weights over the enabled models."""
        enabled = self.get_enabled_models()
        total = sum(c.weight for c in enabled.values())
        if total <= 0:
            return {n: 0.0 for n in enabled}
        return {n: c.weight / total for n, c in enabled.items()}

    def update_model_weight(self, model_name: str, weight: float) -> None:
        if model_name in self.models:
            self.models[model_name].weight = weight

    def disable_model(self, model_name: str) -> None:
        if model_name in self.models:
            self.models[model_name].enabled = False

    def enable_model(self, model_name: str) -> None:
        if model_name in self.models:
            self.models[model_name].enabled = True

    # -- quality artifacts (``QUALITY_r*.json``) ---------------------------
    @staticmethod
    def _artifact_section(artifact_path: str, key: str) -> Optional[dict]:
        with open(artifact_path) as f:
            artifact = json.load(f)
        section = artifact.get(key) if isinstance(artifact, dict) else None
        return section if isinstance(section, dict) else None

    @staticmethod
    def load_selected_blend_weights(artifact_path: str) -> Dict[str, float]:
        """A quality-eval artifact's ``selected_blend.weights``. Malformed
        shapes raise ValueError."""
        blend = Config._artifact_section(artifact_path, "selected_blend")
        weights = blend.get("weights") if blend is not None else None
        if not isinstance(weights, dict) or not weights:
            raise ValueError(
                f"{artifact_path} has no selected_blend.weights — not a "
                f"quality-eval artifact?")
        return {str(n): float(w) for n, w in weights.items()}

    @staticmethod
    def load_selected_blend_strategy(artifact_path: str) -> Optional[str]:
        """The artifact's measured combine strategy, or None for artifacts
        from before strategies were recorded (all measured under
        weighted_average). An unknown name raises."""
        blend = Config._artifact_section(artifact_path, "selected_blend")
        strategy = blend.get("strategy") if blend is not None else None
        if strategy is None:
            return None
        if strategy not in VALID_STRATEGIES:
            raise ValueError(
                f"{artifact_path} selected_blend.strategy {strategy!r} not "
                f"one of {VALID_STRATEGIES}")
        return str(strategy)

    @staticmethod
    def load_artifact_text_model(artifact_path: str) -> Optional[Dict[str, Any]]:
        """The artifact's recorded text-encoder architecture
        (``protocol.text_model``: layers / width / vocab), or None."""
        proto = Config._artifact_section(artifact_path, "protocol")
        tm = proto.get("text_model") if proto is not None else None
        return dict(tm) if isinstance(tm, dict) else None

    def apply_quality_artifact(self, artifact_path: str) -> Dict[str, float]:
        """Deploy a measured blend: the artifact's ``selected_blend`` (the
        branches that survived its validation gate, at their weights)
        becomes this config's model table; branches outside it stay
        configured but disabled, and a recorded combine strategy deploys
        too. Returns the applied weights."""
        weights = self.load_selected_blend_weights(artifact_path)
        strategy = self.load_selected_blend_strategy(artifact_path)
        unknown = [n for n in weights if n not in self.models]
        if unknown:
            raise ValueError(
                f"artifact names unknown model(s) {unknown}; "
                f"configured: {sorted(self.models)}")
        for name, mc in self.models.items():
            if name in weights:
                mc.enabled = True
                mc.weight = float(weights[name])
            else:
                mc.enabled = False
        if strategy is not None:
            self.ensemble.strategy = strategy
        return {n: float(w) for n, w in weights.items()}

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_file(cls, config_path: str) -> "Config":
        with open(config_path) as f:
            data = json.load(f)
        return cls.from_dict(data)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Config":
        cfg = cls()
        _merge_dataclass(cfg, data)
        # the environment applies after the file: defaults -> file -> env
        cfg._apply_env()
        cfg.validate()
        return cfg

    def validate(self) -> None:
        if self.ensemble.strategy not in VALID_STRATEGIES:
            raise ValueError(
                f"ensemble.strategy (env RTFD_ENSEMBLE_STRATEGY) must be one of "
                f"{VALID_STRATEGIES}, got {self.ensemble.strategy!r}")
        e = self.ensemble
        if not (0.0 <= e.monitor_threshold <= e.review_threshold
                <= e.decline_threshold <= 1.0):
            raise ValueError(
                "decision ladder must satisfy 0 <= monitor_threshold <= "
                "review_threshold <= decline_threshold <= 1, got "
                f"monitor={e.monitor_threshold} review={e.review_threshold} "
                f"decline={e.decline_threshold}")
        if e.cache_ttl_seconds < 0 or e.cache_max_entries < 1:
            raise ValueError(
                "ensemble prediction cache requires cache_ttl_seconds >= 0 and "
                "cache_max_entries >= 1")
        self.serving.validate()
        self.monitoring.validate()
        self.qos.validate()
        self.feedback.validate()
        self.tracing.validate()
        self.tuning.validate(qos=self.qos)
        self.quant.validate()
        self.kernels.validate()
        self.cluster.validate()
        self.chaos.validate()
        self.mesh.validate()


def _merge_dataclass(obj: Any, data: Dict[str, Any]) -> None:
    """Overlay a dict onto a dataclass tree, recursively. An unknown key
    warns instead of vanishing: a typo'd knob must not quietly leave the
    default in force."""
    for key, value in data.items():
        if not hasattr(obj, key):
            logging.getLogger(__name__).warning(
                "config: unknown key %r on %s — ignored (typo or renamed "
                "knob?)", key, type(obj).__name__)
            continue
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            _merge_dataclass(current, value)
        elif key == "models" and isinstance(value, dict):
            for model_name, model_data in value.items():
                if model_name in current and isinstance(model_data, dict):
                    for attr, v in model_data.items():
                        if hasattr(current[model_name], attr):
                            setattr(current[model_name], attr, v)
                elif isinstance(model_data, dict) and "model_type" in model_data:
                    current[model_name] = ModelConfig(
                        name=model_name,
                        **{k: v for k, v in model_data.items() if k != "name"})
        else:
            setattr(obj, key, value)
