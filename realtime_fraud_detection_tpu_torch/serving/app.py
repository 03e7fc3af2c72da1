"""The scoring HTTP service over the microbatched port scorer.

Port of the JAX package's ``serving/app.py`` (``ServingApp``), on one
device (the CUDA card unless the caller passes ``device="cpu"``):

    POST /predict             one transaction -> its prediction
    POST /batch-predict       a list -> {results, count, processing_time_ms}
    GET  /health              liveness, model inventory, prediction cache
    GET  /metrics             JSON summary, the scorer's host stages
    GET  /model-info          branches, blend weights, strategy
    POST /reload-models       hot swap: from a checkpoint, from a seed, or a
                              quality artifact's blend
    GET  /metrics/prometheus  text exposition (also alone on
                              ``monitoring.prometheus_port``)
    GET  /metrics/fleet       fleet exposition of this process's counters
    GET  /drift               feature drift (PSI) report
    POST /experiments         create an A/B experiment
    GET  /experiments?name=   arm metrics and significance
    GET  /qos, POST /qos      the QoS plane's state and run-time knobs
    GET  /latency/breakdown   the tracing plane's critical path
    GET  /slo                 SLO burn rates and the QoS gate
    GET  /autotune            the tuning plane's state
    POST /labels              delayed label events into the feedback plane
    GET  /quality/live        prequential quality, the join, the buffer and
                              the retrain / gate / promotion audit
    GET  /cluster             the shard router: this worker's id, the
                              membership, the partition assignment

Every concurrent ``/predict`` goes through ``RequestMicrobatcher`` into one
scorer dispatch a batch; ``/batch-predict`` scores its list as one batch.
The score lock is held for host-state mutation only (the cache lookup and
the dispatch; the write-back inside finalize), never across the device
wait. With ``serving.overlap_assembly`` the microbatcher dispatches batch
N+1 while batch N's finalize waits on the card, two batches in flight.
Dispatch and finalize run on different executor threads: the scorer
records its completion event on the thread's current stream, and every
thread here launches on the default stream. A ``/reload-models`` may swap
the models while batches are queued on the card; each pending batch holds
what it was launched with until its event completes
(``scoring/scorer.py PendingScore.launched_with``).

The feedback plane (``feedback/``) is always built, so ``/labels`` and
``/quality/live`` answer (``/labels`` with 409 while
``config.feedback.enabled`` is off). Enabled, every fresh batch's served
results and host feature rows go into its label join and drift monitor
(which then is not fed a second time), its cheap trigger check runs after
the batch, and a fired trigger's retrain runs on a ``feedback-retrain``
worker thread from a buffer snapshot taken under the score lock; a
candidate that passes the gate is promoted by ``promote_candidate`` under
the score lock, the ``/reload-models`` recipe, while later batches queue.

With ``serving.device_pool`` the scorer's batches run on a
``scoring/device_pool.py DevicePool`` (replicas with their own CUDA
streams), which implies the two-phase microbatcher with its depth raised to
the pool's capacity; the ``device_pool_*`` series and ``/metrics``'s
``device_pool`` block mirror its counters. With ``cluster.enabled`` the
consistent-hash ``ShardRouter`` (``cluster/hashring.py``) answers
``/predict`` for a user whose partition another worker owns with 421, the
owner, its address (``location``) and the partition, ahead of admission;
``/cluster`` shows the router and the ``cluster_*`` series mirror it; the
client side of the 421 is ``serving/ingress_client.py ShardIngressClient``.
With
``state.backend == "redis"`` the scorer keeps its state on the shared RESP
tier (``scoring/scorer.py``). With ``mesh.enabled`` (and no pool) the batches
run on a ``scoring/mesh_executor.py MeshExecutor`` (``mesh.replicas`` data x
``mesh.model`` meshes over every visible card, or with ``mesh.data`` set over
``replicas x data x model`` positions cycled over the cards, storing
``mesh.shard_branches`` split over ``model``), behind the same
seam and the same two-phase microbatcher; the ``mesh_*`` series and
``/metrics``'s ``mesh`` block mirror it, and ``/model-info`` reports its
geometry. A mesh on the card needs cuBLAS's split-K off from the process's
start (``core/precision.py batch_invariant_blas``, which ``serve`` calls
first): building the app raises where the card was used without it.
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from realtime_fraud_detection_tpu_torch import __version__
from realtime_fraud_detection_tpu_torch.checkpoint import CheckpointManager
from realtime_fraud_detection_tpu_torch.cluster.hashring import ShardRouter
from realtime_fraud_detection_tpu_torch.feedback.plane import (
    FeedbackPlane,
    promote_candidate,
)
from realtime_fraud_detection_tpu_torch.obs.drift import DriftConfig, FeatureDriftMonitor
from realtime_fraud_detection_tpu_torch.obs.fleetmetrics import FleetMetrics
from realtime_fraud_detection_tpu_torch.obs.metrics import MetricsCollector
from realtime_fraud_detection_tpu_torch.obs.tracing import (
    Tracer,
    make_carrier,
    parse_carrier,
)
from realtime_fraud_detection_tpu_torch.qos.plane import QosPlane
from realtime_fraud_detection_tpu_torch.scoring.device_pool import DevicePool
from realtime_fraud_detection_tpu_torch.scoring.mesh_executor import (
    MeshExecutor,
    mesh_positions,
)
from realtime_fraud_detection_tpu_torch.scoring.pipeline import (
    MODEL_NAMES,
    init_scoring_models,
)
from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
from realtime_fraud_detection_tpu_torch.serving.batcher import RequestMicrobatcher
from realtime_fraud_detection_tpu_torch.serving.cache import PredictionCache
from realtime_fraud_detection_tpu_torch.serving.httpd import HttpError, HttpServer
from realtime_fraud_detection_tpu_torch.serving.validation import (
    validate_batch,
    validate_transaction,
)
from realtime_fraud_detection_tpu_torch.testing import (
    ABTestManager,
    Variant,
    apply_weight_overrides,
)
from realtime_fraud_detection_tpu_torch.tuning.plane import TuningPlane
from realtime_fraud_detection_tpu_torch.utils.config import Config, TuningSettings

__all__ = ["ServingApp"]

class ServingApp:
    """Scorer, microbatcher, observability and experiments behind HTTP."""

    def __init__(self, config: Optional[Config] = None,
                 scorer: Optional[TorchFraudScorer] = None,
                 host: Optional[str] = None, port: Optional[int] = None,
                 device: str = "cuda"):
        self.config = config or Config()
        sc = self.config.serving
        self.scorer = (scorer if scorer is not None
                       else TorchFraudScorer(self.config, device=device))
        self.metrics = MetricsCollector()
        self.drift = FeatureDriftMonitor(DriftConfig(
            num_features=self.scorer.sc.feature_dim))
        self.ab = ABTestManager()
        # always built, so POST /qos can turn it on at run time; admission
        # and the ladder act only while it is enabled. It writes its series
        # on this app's collector.
        self.qos = QosPlane(self.config.qos, metrics=self.metrics)
        # built only when enabled: off, the scoring path pays one `is None`
        # branch a batch
        self.tracer = Tracer(self.config.tracing) if self.config.tracing.enabled else None
        # GET /metrics/fleet: this process's tracer counters fold in under
        # its worker id at render time
        self.fleet_metrics = FleetMetrics()
        # the device pool: replicas of the models, each on its own stream;
        # it needs several batches in flight, so it implies the two-phase
        # microbatcher at the pool's capacity. A pool the caller attached
        # to the scorer is kept.
        self.pool = getattr(self.scorer, "pool", None)
        if sc.device_pool and self.pool is None:
            self.pool = DevicePool(self.scorer, inflight_depth=sc.inflight_depth)
        elif self.config.mesh.enabled and self.pool is None:
            # mesh-sharded scoring behind the pool's seam: each rotation slot
            # is a data x model mesh storing the configured branches split.
            # ``mesh.data`` None: every visible card; set, replicas x data x
            # model positions over the cards, cycled (on the CPU, all there)
            mcfg = self.config.mesh
            devices = (None if mcfg.data is None else mesh_positions(
                mcfg.replicas * mcfg.data * mcfg.model, self.scorer.device))
            self.pool = MeshExecutor(self.scorer, devices=devices, model_axis=mcfg.model,
                                     replicas=mcfg.replicas,
                                     inflight_depth=mcfg.inflight_depth,
                                     shard_branches=tuple(mcfg.shard_branches))
        two_phase = sc.overlap_assembly or self.pool is not None
        # the tuning plane: the microbatcher's close decisions move from the
        # fixed deadline to the just-in-time controller; the tuner reads the
        # SLO burn and the QoS level through signals_fn and freezes while
        # either says the service is in trouble
        self.tuning = None
        if sc.autotune or self.config.tuning.enabled:
            fields = {**dataclasses.asdict(self.config.tuning), "enabled": True}
            if not two_phase or self.pool is not None:
                # single-phase serving has no pipeline depth, and with a pool
                # the depth is the pool's capacity: pin the tuner's in-flight
                # dimension, or it would trial a change that does nothing and
                # keep measurement noise as a gain
                depth = self.pool.total_slots() if self.pool is not None else 1
                fields["inflight_min"] = fields["inflight_max"] = depth
            tset = TuningSettings(**fields)
            tset.validate(qos=self.config.qos)
            self.tuning = TuningPlane(tset)
            self.tuning.signals_fn = lambda: (
                (self.tracer.slo.burn_rate(self.config.tracing.slo_fast_window_s)
                 if self.tracer is not None else 0.0),
                (self.qos.effective_level() if self.qos.enabled else 0))
        # an optional network-fault snapshot source (anything with
        # .snapshot(), e.g. chaos/netfaults.py LinkFaultPlane) that a
        # harness degrading this app's links attaches; the exposition
        # mirrors it through sync_netfaults as a stream job would
        self.netfaults = None
        # the consistent-hash shard router: with cluster.enabled, /predict
        # serves only users whose partition the ring gives this worker_id;
        # placement is a pure function of (workers, n_partitions,
        # virtual_nodes), the same in every worker and ingress
        self.cluster_router = None
        cl = self.config.cluster
        if cl.enabled:
            self.cluster_router = ShardRouter(
                cl.n_partitions, sorted(cl.workers),
                virtual_nodes=cl.virtual_nodes, addresses=dict(cl.workers))
        self.batcher = RequestMicrobatcher(
            self._score_batch_sync,
            max_batch=sc.microbatch_max_size,
            deadline_ms=sc.microbatch_deadline_ms,
            budget=self.qos.budget if self.config.qos.enabled else None,
            tracer=self.tracer,
            controller=self.tuning,
            # priority classes appear in the queue-wait split only while the
            # QoS plane is enabled; otherwise traffic is "unclassified"
            classify_fn=lambda t: (self.qos.classify(t) if self.qos.enabled else ""),
            dispatch_fn=(self._dispatch_batch_sync if two_phase else None),
            finalize_fn=(self._finalize_batch_sync if two_phase else None),
            pipeline_depth=(self.pool.total_slots() if self.pool is not None else 2),
        )
        self.http = HttpServer(host if host is not None else sc.host,
                               port if port is not None else sc.port)
        # the dedicated Prometheus listener (metrics on their own port, the
        # reference's monitoring contract); 0 = none, and the main port
        # serves /metrics/prometheus either way
        self.metrics_http: Optional[HttpServer] = None
        mon = self.config.monitoring
        if mon.enable_prometheus and mon.prometheus_port:
            self.metrics_http = HttpServer(
                host if host is not None else sc.host, mon.prometheus_port)
            self.metrics_http.route("GET", "/metrics", self._metrics_prometheus)
        self._reload_lock = asyncio.Lock()
        # idempotent retries of a transaction_id are served the stored
        # response (reference ensemble_predictor.py:437-471)
        self.prediction_cache = (
            PredictionCache(self.config.ensemble.cache_ttl_seconds,
                            self.config.ensemble.cache_max_entries)
            if sc.enable_prediction_cache else None)
        # the scorer, the cache and the drift monitor are single-writer;
        # /predict's and /batch-predict's executor threads both score
        self._score_lock = threading.Lock()
        # set by _predict on the event loop when the QoS served rung moved,
        # applied by _dispatch_batch_sync under the score lock (the event
        # loop never takes that lock: a dispatch holds it across assembly)
        self._qos_rung_dirty = False
        # rtfd-lint: allow[wall-clock] HTTP serving plane is real-time (no virtual-clock mode)
        self._started = time.monotonic()
        # transactions admitted and not yet answered: beyond
        # max_concurrent_predictions a request gets an immediate 503
        # (one event loop: a plain counter)
        self._inflight_txns = 0
        # the feedback plane: it shares this app's drift monitor and
        # collector, and promotes through this app's score lock
        self.feedback = FeedbackPlane(
            self.config.feedback, scorer=self.scorer, config=self.config,
            metrics=self.metrics, drift_monitor=self.drift,
            promote_fn=lambda cand: promote_candidate(
                self.scorer, self.config, cand, lock=self._score_lock))
        self._feedback_reacting = False
        self._register_routes()

    # --------------------------------------------------------------- scoring
    def _score_batch_sync(self, txns, trace=None) -> List[Dict[str, Any]]:
        """Dispatch and finalize one batch in the calling executor thread."""
        return self._finalize_batch_sync(self._dispatch_batch_sync(txns, trace))

    def _dispatch_batch_sync(self, txns, trace=None) -> tuple:
        """Stage 1 (executor thread): the prediction cache, then assembly
        and launch without waiting for the card."""
        # rtfd-lint: allow[wall-clock] HTTP serving plane is real-time (no virtual-clock mode)
        t0 = time.perf_counter()
        cache = self.prediction_cache
        cached: Dict[int, Dict[str, Any]] = {}
        to_score = txns
        if cache is not None:
            with self._score_lock:
                for i, txn in enumerate(txns):
                    hit = cache.get(str(txn.get("transaction_id", "")))
                    if hit is not None:
                        cached[i] = hit
            if cached:
                to_score = [t for i, t in enumerate(txns) if i not in cached]
        if trace is not None and cached:
            # cache hits never reach the card: close their traces as
            # `cached` and keep the scored contexts (in queue order)
            kept = []
            for i, c in enumerate(trace.contexts):
                if i in cached:
                    self.tracer.finish_terminal(c, "cached")
                else:
                    kept.append(c)
            trace.contexts = kept
        try:
            pending = None
            if to_score:
                with self._score_lock:
                    if self._qos_rung_dirty and self.qos.enabled:
                        self._qos_rung_dirty = False
                        self.qos.apply_degradation(self.scorer)
                    pending = self.scorer.dispatch(to_score, trace=trace)
        except Exception:
            self.metrics.record_error("score")
            self._close_trace_error(trace)
            raise
        return (t0, txns, to_score, cached, pending, trace)

    def _close_trace_error(self, trace) -> None:
        """Close every open context of a failed batch as `error`: the
        waiters got the exception, the flight recorder still sees them."""
        if trace is None or self.tracer is None:
            return
        for c in trace.contexts:
            self.tracer.finish_terminal(c, "error")
        trace.contexts = []

    def _finalize_batch_sync(self, ctx: tuple) -> List[Dict[str, Any]]:
        """Stage 2 (executor thread): wait for the card, then metrics,
        drift, experiments, the cache and the SLO gate; results in request
        order."""
        t0, txns, to_score, cached, pending, trace = ctx
        cache = self.prediction_cache
        try:
            fresh = (self.scorer.finalize(pending, lock=self._score_lock)
                     if pending is not None else [])
        except Exception:
            self.metrics.record_error("score")
            self._close_trace_error(trace)
            raise
        # rtfd-lint: allow[wall-clock] HTTP serving plane is real-time (no virtual-clock mode)
        dt = time.perf_counter() - t0
        # batch and per-prediction metrics count fresh results only (a cache
        # hit costs ~0 and is a retry of a transaction already counted)
        if fresh:
            self.metrics.record_batch(len(fresh), dt)
        if (self.config.monitoring.enable_drift_detection and pending is not None
                and not self.config.feedback.enabled):
            # with the feedback plane on, on_predictions feeds this monitor
            with self._score_lock:
                self.drift.update(pending.features)
        self._apply_experiments(to_score, fresh)
        if self.config.monitoring.enable_performance_tracking:
            per_txn = dt / max(len(fresh), 1)
            for r in fresh:
                self.metrics.record_prediction(
                    r["decision"], r["fraud_score"], per_txn, r["model_predictions"])
        if cache is not None:
            # after the experiments: the stored response is what this
            # request served, so a retry gets exactly it
            with self._score_lock:
                for r in fresh:
                    cache.put(r["transaction_id"], r)
        if self.config.feedback.enabled and fresh:
            # what this batch serves (after the experiments) with its host
            # feature rows; the retrain runs on a worker thread
            with self._score_lock:
                self.feedback.on_predictions(
                    to_score, fresh,
                    features=pending.features if pending is not None else None)
                self.feedback.check_trigger()
            self._maybe_react()
        if trace is not None and self.tracer is not None:
            # closing the batch feeds the SLO window; the burn gate is a
            # hysteresis-guarded degradation signal on top of the ladder
            self.tracer.finish_batch(trace)
            if self.qos.enabled:
                ts = self.config.tracing
                self.qos.observe_slo_burn(
                    self.tracer.slo.burn_rate(ts.slo_fast_window_s),
                    threshold=ts.slo_burn_threshold,
                    patience=ts.slo_gate_patience,
                    up_patience=ts.slo_gate_up_patience)
        if cached:
            results, it_fresh = [], iter(fresh)
            for i in range(len(txns)):
                results.append(cached[i] if i in cached else next(it_fresh))
            return results
        return fresh

    def _apply_experiments(self, txns, results) -> None:
        """Route each transaction through the active experiments: a weight
        override re-weights the blend on the host over the returned branch
        predictions (and recomputes decision and risk level), and every arm
        records the prediction, with the producer's ``is_fraud`` label when
        there is one."""
        alert_t = self.config.stream.alert_score_threshold
        base = self.config.normalized_weights()
        for txn, res in zip(txns, results):
            uid = str(txn.get("user_id", ""))
            for name in self.ab.active_experiments():
                variant = self.ab.assign(name, uid)
                if variant.overrides.get("weights"):
                    ens = self.config.ensemble
                    reweighted = apply_weight_overrides(
                        res["model_predictions"], base, variant.overrides["weights"],
                        ens.confidence_threshold,
                        decline_threshold=ens.decline_threshold,
                        review_threshold=ens.review_threshold,
                        monitor_threshold=ens.monitor_threshold)
                    if reweighted is not None:
                        res.update(reweighted)
                        res["fraud_score"] = reweighted["fraud_probability"]
                        res.setdefault("explanation", {})["experiment"] = {
                            "name": name, "variant": variant.name}
                actual = txn.get("is_fraud")
                self.ab.record_prediction(
                    name, variant.name, res["fraud_score"],
                    res["fraud_score"] > alert_t,
                    bool(actual) if actual is not None else None)

    def _maybe_react(self) -> None:
        """Start the plane's retrain -> gate -> promotion on a worker thread
        when a trigger is pending, one at a time. The rows are snapshotted
        under the score lock; sorting, stacking and training run without it,
        and the promotion takes it inside ``promote_fn``."""
        if self.feedback.pending_trigger is None or self._feedback_reacting:
            return
        self._feedback_reacting = True

        def _run() -> None:
            try:
                with self._score_lock:
                    rows = self.feedback.buffer.snapshot_rows()
                arrays = self.feedback.buffer.arrays_from(
                    rows, self.feedback.buffer.store_history)
                self.feedback.react(arrays=arrays)
            finally:
                self._feedback_reacting = False

        threading.Thread(target=_run, name="feedback-retrain", daemon=True).start()

    # ---------------------------------------------------------------- routes
    def _register_routes(self) -> None:
        r = self.http.route
        r("POST", "/predict", self._predict)
        r("POST", "/batch-predict", self._batch_predict)
        r("GET", "/health", self._health)
        r("GET", "/metrics", self._metrics)
        r("GET", "/model-info", self._model_info)
        r("POST", "/reload-models", self._reload_models)
        r("GET", "/metrics/prometheus", self._metrics_prometheus)
        r("GET", "/metrics/fleet", self._metrics_fleet)
        r("GET", "/drift", self._drift)
        r("POST", "/experiments", self._create_experiment)
        r("GET", "/experiments", self._experiment_results)
        r("GET", "/qos", self._qos_status)
        r("POST", "/qos", self._qos_configure)
        r("POST", "/labels", self._ingest_labels)
        r("GET", "/quality/live", self._quality_live)
        r("GET", "/latency/breakdown", self._latency_breakdown)
        r("GET", "/slo", self._slo_status)
        r("GET", "/autotune", self._autotune_status)
        r("GET", "/cluster", self._cluster_status)

    def _admit(self, n: int) -> None:
        limit = self.config.serving.max_concurrent_predictions
        if self._inflight_txns + n > limit:
            self.metrics.record_error("at_capacity")
            raise HttpError(503, f"at capacity ({self._inflight_txns} in flight, "
                                 f"limit {limit})")
        self._inflight_txns += n

    def _release_on_done(self, fut: "asyncio.Future", n: int) -> None:
        """Free n admission slots when the batcher resolves ``fut``, not when
        the waiter gives up: a timed-out request's transaction is still
        queued and will be scored."""
        def _done(f: "asyncio.Future") -> None:
            self._inflight_txns -= n
            if not f.cancelled():
                f.exception()        # retrieved: no "never retrieved" warning
        fut.add_done_callback(_done)

    async def _predict(self, body, query) -> Tuple[int, Any]:
        txn, errors = validate_transaction(body)
        if errors:
            raise HttpError(422, errors)
        if self.cluster_router is not None and self.config.cluster.worker_id:
            misdirected = self._misdirected(txn)
            if misdirected is not None:
                return 421, misdirected
        if self.qos.enabled:
            # admission ahead of the concurrency gate: a shed is an explicit
            # score-with-reason (200, REVIEW, risk level SHED); the ladder
            # reads the microbatcher's queue as its backlog
            # rtfd-lint: allow[wall-clock] HTTP serving plane is real-time (no virtual-clock mode)
            decision = self.qos.admit(txn, time.monotonic())
            if not decision.admitted:
                return 200, self.qos.shed_result(txn, decision)
            self.qos.observe_backlog(self.batcher.queue_depth)
            # a rung change is only flagged here (see _qos_rung_dirty)
            if self.qos.effective_level() != self.scorer.qos_level:
                self._qos_rung_dirty = True
        timeout = self.config.serving.prediction_timeout_seconds
        self._admit(1)
        try:
            fut = self.batcher.submit_nowait(txn)
        except (asyncio.QueueFull, RuntimeError):
            self._inflight_txns -= 1
            self.metrics.record_error("at_capacity")
            raise HttpError(503, "scoring queue full")
        self._release_on_done(fut, 1)
        # rtfd-lint: allow[wall-clock] HTTP serving plane is real-time (no virtual-clock mode)
        t_enq = time.monotonic()
        try:
            # shield: the waiter's timeout must not cancel the scoring
            result = await asyncio.wait_for(asyncio.shield(fut), timeout=timeout)
        except asyncio.TimeoutError:
            self.metrics.record_error("timeout")
            raise HttpError(408, "prediction timed out")
        if self.qos.enabled:
            # rtfd-lint: allow[wall-clock] HTTP serving plane is real-time (no virtual-clock mode)
            self.qos.record_completion(t_enq, time.monotonic())
        self.metrics.queue_depth.set(self.batcher.queue_depth)
        return 200, result

    def _misdirected(self, txn) -> Optional[Dict[str, Any]]:
        """The 421 body for a user another worker owns (None when this
        worker owns it): ahead of admission, so a wrong-shard request burns
        none of this worker's QoS tokens or slots. It names the owner, its
        address and the partition, so the caller re-issues once; a trace
        carrier comes back with its redirect hop counted."""
        uid = str(txn.get("user_id", ""))
        owner = self.cluster_router.route(uid)
        if owner == self.config.cluster.worker_id:
            return None
        resp = {
            "error": "wrong_shard",
            "owner": owner,
            "location": self.cluster_router.address_of(owner),
            "partition": self.cluster_router.partition_of(uid),
        }
        carrier = txn.get("trace_carrier")
        c = parse_carrier(carrier) if carrier is not None else None
        if c is not None:
            resp["trace_carrier"] = make_carrier(
                c["tid"], origin=c["org"], produced_ts=c.get("ts"),
                priority=c["pr"], fault=c["flt"], parent=c["sp"],
                hops=int(c.get("rh", 0)) + 1,
                redirect_s=float(c.get("rs", 0.0)))
        return resp

    async def _batch_predict(self, body, query) -> Tuple[int, Any]:
        txns, errors = validate_batch(body, self.config.serving.batch_size_limit)
        if errors:
            raise HttpError(422, errors)
        limit = self.config.serving.max_concurrent_predictions
        if len(txns) > limit:
            # oversize, not overload: no retry can ever fit it
            raise HttpError(
                413, f"batch of {len(txns)} exceeds the concurrency "
                     f"capacity {limit}; split into smaller batches")
        # rtfd-lint: allow[wall-clock] HTTP serving plane is real-time (no virtual-clock mode)
        t0 = time.perf_counter()
        self._admit(len(txns))
        try:
            loop = asyncio.get_running_loop()
            results = await loop.run_in_executor(None, self._score_batch_sync, txns)
        finally:
            self._inflight_txns -= len(txns)
        return 200, {"results": results, "count": len(results),
                     # rtfd-lint: allow[wall-clock] HTTP serving plane is real-time (no virtual-clock mode)
                     "processing_time_ms": (time.perf_counter() - t0) * 1e3}

    async def _health(self, body, query) -> Tuple[int, Any]:
        info = self.scorer.model_info()
        payload = {
            "status": "healthy",
            "models_loaded": sum(1 for m in info["models"].values() if m["enabled"]),
            "num_models": info["num_models"],
            # rtfd-lint: allow[wall-clock] HTTP serving plane is real-time (no virtual-clock mode)
            "uptime_seconds": time.monotonic() - self._started,
            "queue_depth": self.batcher.queue_depth,
        }
        if self.prediction_cache is not None:
            # lock-free by contract (serving/cache.py stats)
            payload["prediction_cache"] = self.prediction_cache.stats()
        return 200, payload

    async def _metrics(self, body, query) -> Tuple[int, Any]:
        payload = self.metrics.summary()
        payload["host_assembly"] = self.scorer.host_stats()
        if self.pool is not None:
            key = "mesh" if isinstance(self.pool, MeshExecutor) else "device_pool"
            payload[key] = self.pool.stats()
        return 200, payload

    async def _metrics_prometheus(self, body, query) -> Tuple[int, Any]:
        self.metrics.sync_host_stats(self.scorer.host_stats())
        self.metrics.sync_quant(self.scorer.quant_snapshot())
        self.metrics.sync_kernels(self.scorer.kernel_snapshot())
        self.metrics.sync_graph(self.scorer.graph_snapshot())
        self.metrics.sync_microbatch(self.batcher.close_reasons)
        if isinstance(self.pool, MeshExecutor):
            # the mesh's own series (geometry, placement, per-position bytes);
            # the device_pool_* family stays the replicated pool's
            self.metrics.sync_mesh(self.pool.mesh_snapshot())
        elif self.pool is not None:
            self.metrics.sync_device_pool(self.pool.stats())
        if self.tracer is not None:
            self.metrics.sync_tracing(self.tracer.snapshot())
        if self.tuning is not None:
            self.metrics.sync_autotune(self.tuning.snapshot())
        if self.config.feedback.enabled:
            with self._score_lock:
                snap = self.feedback.snapshot()
            self.metrics.sync_feedback(snap)
        if self.cluster_router is not None:
            self.metrics.sync_cluster(self._cluster_snapshot())
        if self.netfaults is not None:
            self.metrics.sync_netfaults(self.netfaults.snapshot())
        return 200, self.metrics.render_prometheus()

    async def _metrics_fleet(self, body, query) -> Tuple[int, Any]:
        """The fleet exposition: this process is a one-worker fleet whose
        tracing counters fold in at render time."""
        local_id = self.config.cluster.worker_id or "serving"
        if self.tracer is not None:
            self.fleet_metrics.ingest_cumulative(
                local_id, {f"trace_{k}": v for k, v in self.tracer.counters.items()})
            self.fleet_metrics.set_worker_info(local_id, pid=os.getpid(),
                                               version=__version__)
        return 200, self.fleet_metrics.render(version=__version__)

    def _cluster_snapshot(self) -> Dict[str, Any]:
        """The router's view in the shape ``sync_cluster`` reads (no handoff
        ledger: that is the stream fleet's)."""
        snap = self.cluster_router.snapshot()
        return {
            "workers_alive": len(snap["members"]),
            "workers": {m: {"partitions_owned": len(snap["assignment"].get(m, ()))}
                        for m in snap["members"]},
            "router": snap,
        }

    async def _cluster_status(self, body, query) -> Tuple[int, Any]:
        """This worker's id, the membership, the partition assignment and
        the router's movement ledger."""
        if self.cluster_router is None:
            return 200, {"enabled": False}
        return 200, {"enabled": True, "worker_id": self.config.cluster.worker_id,
                     **self.cluster_router.snapshot()}

    async def _model_info(self, body, query) -> Tuple[int, Any]:
        return 200, self.scorer.model_info()

    async def _reload_models(self, body, query) -> Tuple[int, Any]:
        """Hot swap under the reload lock (reference main.py:291-305).
        Body: {"checkpoint_dir": ..., "step": optional} restores params (and
        host state when saved); {"quality_artifact": path} deploys an
        artifact's blend (weights and validity are run-time tensors of the
        scorer), alone or with a checkpoint; {"seed": n} or {} re-initialises
        the models from a seed. The swap lands between dispatches; batches
        already on the card finish with the models they were launched with."""
        body = body or {}
        async with self._reload_lock:
            loop = asyncio.get_running_loop()
            source: Dict[str, Any] = {}
            blend_requested = "quality_artifact" in body
            if blend_requested:
                # validated up front, applied only after a restore succeeded:
                # a failed restore leaves the live blend untouched
                try:
                    weights = Config.load_selected_blend_weights(
                        str(body["quality_artifact"]))
                except FileNotFoundError as e:
                    raise HttpError(404, str(e))
                except (ValueError, OSError) as e:
                    raise HttpError(422, str(e))
                unknown = [n for n in weights if n not in self.config.models]
                if unknown:
                    raise HttpError(
                        422, f"artifact names unknown model(s) {unknown}; "
                             f"configured: {sorted(self.config.models)}")
            if "checkpoint_dir" in body:
                step = body.get("step")
                if step is not None:
                    try:
                        step = int(step)
                    except (TypeError, ValueError):
                        raise HttpError(422, f"step must be an integer, got {step!r}")
                if blend_requested:
                    # an artifact and a checkpoint recording different text
                    # encoders are refused before the restore;
                    # {"allow_arch_mismatch": true} overrides
                    art_tm = Config.load_artifact_text_model(
                        str(body["quality_artifact"]))
                    try:
                        ck_meta = (CheckpointManager(body["checkpoint_dir"])
                                   .manifest(step).get("metadata") or {})
                    except FileNotFoundError as e:
                        raise HttpError(404, str(e))
                    ck_tm = ck_meta.get("text_model")
                    if (art_tm is not None and ck_tm is not None
                            and dict(art_tm) != dict(ck_tm)
                            and not body.get("allow_arch_mismatch")):
                        raise HttpError(
                            409, f"text-encoder architecture mismatch: "
                                 f"artifact records {art_tm}, checkpoint "
                                 f"records {ck_tm}; pass "
                                 f"allow_arch_mismatch to combine anyway")

                def _restore():
                    return CheckpointManager(body["checkpoint_dir"]).restore_into_scorer(
                        self.scorer, step=step, lock=self._score_lock,
                        allow_arch_mismatch=bool(body.get("allow_arch_mismatch")))
                try:
                    ck = await loop.run_in_executor(None, _restore)
                except FileNotFoundError as e:
                    raise HttpError(404, str(e))
                except ValueError as e:
                    raise HttpError(409, str(e))   # mode or shape mismatch
                source.update(checkpoint=body["checkpoint_dir"], step=ck.step)
            elif not blend_requested:
                seed = int(body.get("seed", 0))

                def _reinit():
                    sc = self.scorer.sc
                    fresh = init_scoring_models(
                        seed, bert_config=self.scorer.bert_config,
                        feature_dim=sc.feature_dim, node_dim=sc.node_dim,
                        gnn_typed=sc.graph_mode == "typed")
                    with self._score_lock:
                        self.scorer.set_models(fresh)
                await loop.run_in_executor(None, _reinit)
                source["reinit_seed"] = seed
            if blend_requested:
                # the params are in place; deploy the validated blend, and
                # roll the model table back if that still fails, so the
                # served blend is wholly the old one or wholly the new one
                snapshot = {n: (mc.enabled, mc.weight)
                            for n, mc in self.config.models.items()}
                try:
                    applied = self.config.apply_quality_artifact(
                        str(body["quality_artifact"]))
                    with self._score_lock:
                        self.scorer.refresh_blend_from_config()
                except Exception:
                    for name, (was_enabled, was_weight) in snapshot.items():
                        self.config.models[name].enabled = was_enabled
                        self.config.models[name].weight = was_weight
                    with self._score_lock:
                        self.scorer.refresh_blend_from_config()
                    raise
                source["quality_artifact"] = {
                    "path": str(body["quality_artifact"]), "weights": applied}
            if self.prediction_cache is not None:
                # cached responses describe the replaced models (the hit /
                # miss counters stay: they are monotonic on /health)
                with self._score_lock:
                    self.prediction_cache.clear()
        return 200, {"status": "reloaded", "source": source}

    async def _qos_status(self, body, query) -> Tuple[int, Any]:
        snap = self.qos.snapshot()
        snap["queue_depth"] = self.batcher.queue_depth
        return 200, snap

    async def _qos_configure(self, body, query) -> Tuple[int, Any]:
        """Update QoS knobs at run time: any subset of ``QosSettings``."""
        try:
            applied = self.qos.configure(body or {})
        except (TypeError, ValueError) as e:
            raise HttpError(422, str(e))
        # the budget binds the batcher only while the plane is enabled
        self.batcher.budget = self.qos.budget if self.config.qos.enabled else None
        if not self.config.qos.enabled:
            # a disabled plane also lifts any degradation
            with self._score_lock:
                self.scorer.set_degradation(None)
        return 200, {"status": "configured", "applied": applied,
                     "qos": self.qos.snapshot()}

    async def _ingest_labels(self, body, query) -> Tuple[int, Any]:
        """Delayed ground-truth label events (the labels topic over HTTP):
        one event dict or a list, each with ``transaction_id``, ``is_fraud``
        and optionally ``label_ts`` (default now). They join the emitted
        predictions, feed the prequential metrics and the buffer, and may
        trigger a retrain."""
        if not self.config.feedback.enabled:
            raise HttpError(409, "feedback plane disabled "
                                 "(config.feedback.enabled)")
        events = body if isinstance(body, list) else [body]
        cleaned = []
        for ev in events:
            if not isinstance(ev, dict) or not ev.get("transaction_id") \
                    or "is_fraud" not in ev:
                raise HttpError(422, "each label event needs transaction_id + is_fraud")
            ev = dict(ev)
            # rtfd-lint: allow[wall-clock] HTTP serving plane is real-time (no virtual-clock mode)
            ev.setdefault("label_ts", time.time())
            cleaned.append(ev)
        with self._score_lock:
            matched = self.feedback.on_labels(cleaned)
            self.feedback.check_trigger()
        self._maybe_react()
        return 200, {"ingested": len(cleaned), "matched": matched,
                     "join": self.feedback.join.stats()}

    async def _quality_live(self, body, query) -> Tuple[int, Any]:
        """Live quality under delayed ground truth: the prequential sliding
        and fading windows, calibration, drop-one attribution, the join, the
        buffer and the audit tail, snapshotted under the score lock."""
        with self._score_lock:
            return 200, self.feedback.snapshot()

    async def _latency_breakdown(self, body, query) -> Tuple[int, Any]:
        if self.tracer is None:
            return 200, {"enabled": False, "n": 0,
                         "hint": "start with --trace or config.tracing.enabled"}
        return 200, self.tracer.breakdown()

    async def _slo_status(self, body, query) -> Tuple[int, Any]:
        if self.tracer is None:
            return 200, {"enabled": False}
        payload = self.tracer.slo.snapshot()
        payload["enabled"] = True
        payload["qos_gate"] = {"engaged": self.qos.slo_engaged,
                               "threshold": self.config.tracing.slo_burn_threshold}
        return 200, payload

    async def _autotune_status(self, body, query) -> Tuple[int, Any]:
        if self.tuning is None:
            return 200, {"enabled": False,
                         "hint": "start with --autotune or config.tuning.enabled"}
        return 200, self.tuning.snapshot()

    async def _drift(self, body, query) -> Tuple[int, Any]:
        rep = self.drift.report()
        return 200, {
            "drifted": rep.drifted,
            "max_psi": rep.max_psi,
            "top_features": rep.top_features[:10],
            "psi": [float(x) for x in rep.psi],
            "rows_seen": rep.rows_seen,
            "baseline_frozen": rep.baseline_frozen,
        }

    async def _create_experiment(self, body, query) -> Tuple[int, Any]:
        body = body or {}
        try:
            name = body["name"]
            if "from_quality_artifact" in body:
                # canary a measured blend; every branch it weights must be
                # enabled here (the host re-weighting only has the
                # predictions the card returned)
                art = str(body["from_quality_artifact"])
                weights = Config.load_selected_blend_weights(art)
                disabled = [n for n in weights if n in MODEL_NAMES
                            and not self.scorer.model_valid[MODEL_NAMES.index(n)]]
                if disabled:
                    raise HttpError(
                        409, f"artifact blend uses branch(es) {disabled} that "
                             f"are disabled in the current deployment; enable "
                             f"them first (POST /reload-models with the artifact)")
                self.ab.experiment_from_artifact(
                    name, art, traffic=float(body.get("traffic", 0.5)),
                    salt=body.get("salt", ""))
            else:
                variants = [Variant(v["name"], float(v["traffic"]),
                                    v.get("overrides", {}))
                            for v in body["variants"]]
                self.ab.create_experiment(name, variants, salt=body.get("salt", ""))
        except FileNotFoundError as e:
            raise HttpError(404, str(e))
        except (KeyError, TypeError) as e:
            raise HttpError(422, f"bad experiment spec: {e}")
        except ValueError as e:
            raise HttpError(422, str(e))
        return 200, {"status": "created", "experiment": name}

    async def _experiment_results(self, body, query) -> Tuple[int, Any]:
        name = query.get("name")
        if not name:
            raise HttpError(422, "query param 'name' required")
        try:
            return 200, self.ab.results(name)
        except KeyError:
            raise HttpError(404, f"no experiment {name!r}")

    # -------------------------------------------------------------- lifecycle
    def _build_kernels(self) -> None:
        """Build and load the CUDA kernels when the scorer runs any, so the
        first request does not pay the ``nvcc`` build (tens of seconds,
        well over the prediction timeout)."""
        if self.scorer.device.type == "cuda" and self.scorer.kernels.enabled:
            from realtime_fraud_detection_tpu_torch.ops.build import kernel_library

            kernel_library()

    async def start(self) -> None:
        await asyncio.get_running_loop().run_in_executor(None, self._build_kernels)
        await self.batcher.start()
        await self.http.start()
        if self.metrics_http is not None:
            await self.metrics_http.start()

    async def stop(self) -> None:
        if self.metrics_http is not None:
            await self.metrics_http.stop()
        await self.http.stop()
        await self.batcher.stop()

    @property
    def port(self) -> int:
        return self.http.port

    def run_forever(self) -> None:
        """Serve until SIGTERM / SIGINT, then stop: the HTTP server closes
        first (no new admissions), then the microbatcher drains, so every
        admitted transaction is answered before the process exits."""
        import signal

        async def _main():
            await self.start()
            stopping = asyncio.Event()
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    loop.add_signal_handler(sig, stopping.set)
                except (NotImplementedError, RuntimeError, ValueError):
                    pass          # no signal support on this platform / thread
            try:
                await stopping.wait()
            finally:
                await self.stop()

        asyncio.run(_main())
