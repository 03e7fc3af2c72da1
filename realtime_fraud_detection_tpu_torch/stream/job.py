"""The streaming scoring job: consume -> score -> fan out -> commit.

Port of the JAX package's ``stream/job.py`` (the reference's Flink job
graph, FraudDetectionJob.java:33-106, with the ML seam wired):

    payment-transactions --> microbatch assembler --> TorchFraudScorer
        |--> fraud-predictions    (every scored transaction)
        |--> fraud-alerts         (fraud_score > the alert threshold, 0.7)
        |--> transaction-enriched (the transaction + score and decision)
        `--> transaction-features (the 64-wide feature vector)

Offsets are committed only after write-back and every produce, so a crash
replays the uncommitted tail, and replayed transaction ids are
deduplicated against the in-flight ids and the scorer's transaction cache
(at-least-once delivery, effectively-once scoring). With
``JobConfig.overlap_assembly`` the scorer's assemble + dispatch run on an
``AssemblerStage`` thread while this thread waits on the card; admission,
dedupe, completion order and commits stay on this thread.

With ``JobConfig.qos`` (``QosSettings`` with ``enabled=True``, or a
``QosPlane``) the deadline-aware QoS plane is wired in: the assembler closes
a batch early when its oldest record's latency budget runs low; admission
runs after dedupe and before dispatch, and a shed record gets an explicit
REVIEW with its reason on the predictions topic, covered by its batch's
commit; the degradation ladder observes the backlog once per dispatched
batch and pushes its rung into the scorer (under the stage lock with
overlap on); completion records the scored count and each record's budget
headroom.

With ``JobConfig.tracing`` (``TracingSettings`` with ``enabled=True``, or a
``Tracer``) every admitted transaction opens a trace at admission, its batch
carries an ``obs.tracing.TraceBatch`` through the scorer's stage marks, and
completion closes the batch's traces and reads the SLO burn rate, which
feeds the QoS plane's SLO-burn gate (``QosPlane.observe_slo_burn``); a shed,
an invalid record and a duplicate each close a terminal trace. With
``JobConfig.autotune`` (``TuningSettings`` with ``enabled=True``, or a
``TuningPlane``) the assembler's just-in-time closer replaces the fixed
deadline, each completed batch feeds the plane its dispatch-to-completion
time, its admitted latencies, the burn rate and the served rung, and the run
loops re-read the tuner's in-flight depth every iteration. With
``JobConfig.feedback`` (a live ``feedback.FeedbackPlane``) the job reads
the labels topic under a consumer group of its own; after every scored
batch the plane gets exactly the emitted results with the batch's host
feature rows (``PendingScore.features``, the retrain corpus), the due labels
are drained into it and its cheap trigger check runs at the completion
time. The retrain itself (``react``) runs between batches in both run
loops: batches already in flight complete with the models they were
launched with.

With ``JobConfig.enable_enrichment`` every scored batch's ensemble scores
are blended 60/40 with the six-category feature score
(``features/rules.py blend_enrichment``, on the scorer's device) and the
enriched topic carries the blended score, its enrichment decision and risk
level, and the ensemble's score as ``ensemble_score``. With
``JobConfig.enable_analytics`` every enriched record also passes, at its
event time, through the seven window operators of ``stream/windows.py
WindowedAnalytics``, whose fired windows go to the stream-processing topics.

``request_stop`` (signal-handler safe) makes both run loops stop polling,
dispatch the assembler's polled-but-unbatched tail, complete every batch in
flight (with overlapped assembly: through the ``AssemblerStage``) and
commit, so a stopped job leaves nothing to replay.

With ``JobConfig.device_pool`` the scorer's batches run on a
``scoring/device_pool.py DevicePool`` (every visible card, or the
scorer's device alone; a pool the caller attached first is kept), each
whole microbatch on one replica with its own CUDA stream, and the run loops'
in-flight window is the pool's capacity (replicas x ``inflight_depth``), so
every replica gets work; scores stay bit-identical to unpooled ones and
completion stays FIFO.

``complete_batch`` times its fan-out (the produces to the output topics
and the commit) as the stage ``fan_out`` of the scorer's host stage table
(``TorchFraudScorer.spans``, which its ``host_stats`` reports), inside the
region ``rtfd.fan_out`` while a profiler records; a stand-in scorer with no
table records nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional

from realtime_fraud_detection_tpu_torch.obs.profiling import SpanTimer
from realtime_fraud_detection_tpu_torch.obs.tracing import CARRIER_KEY
from realtime_fraud_detection_tpu_torch.serving.validation import sanitize_for_stream
from realtime_fraud_detection_tpu_torch.state.stores import _event_time_ms
from realtime_fraud_detection_tpu_torch.stream import topics as T
from realtime_fraud_detection_tpu_torch.stream.microbatch import MicrobatchAssembler
from realtime_fraud_detection_tpu_torch.stream.windows import WindowedAnalytics
from realtime_fraud_detection_tpu_torch.stream.transport import (
    FaultInjector,
    InMemoryBroker,
    Record,
)
from realtime_fraud_detection_tpu_torch.utils.config import (
    QosSettings,
    TracingSettings,
    TuningSettings,
)


@dataclasses.dataclass
class JobConfig:
    """Streaming-job parameters (reference JobConfig.java:14-200 analog)."""

    group_id: str = "fraud-detection-job"
    max_batch: int = 256
    max_delay_ms: float = 5.0
    alert_threshold: float = 0.7      # FraudDetectionJob.java:66
    emit_features: bool = True
    emit_enriched: bool = True
    # the windowed-analytics stage (stream/windows.py) over the enriched
    # records, fired windows onto the stream-processing topics
    enable_analytics: bool = False
    # blend the six-category feature score 60/40 into the enriched output
    # (FeatureEnrichmentProcessor.java:84-150)
    enable_enrichment: bool = False
    # microbatches in flight before the oldest is completed: 2 overlaps the
    # host work of batch N+1 with the device time of batch N. Completion
    # stays in dispatch order. State write-back happens at completion, so
    # at depth D a user's transactions in D consecutive batches see velocity
    # counts missing up to D-1 batches' updates.
    pipeline_depth: int = 2
    # overlapped host assembly (scoring/host_pipeline.AssemblerStage): a
    # background thread assembles and launches batch N+1 while this thread
    # waits out batch N on the card. Completion order and commits are
    # unchanged, but which write-backs land before an assembly depends on
    # timing, so decisions are not bit-reproducible: off where replays must
    # match, on for throughput
    overlap_assembly: bool = False
    # the device pool (scoring/device_pool.py): whole microbatches round-
    # robin over replicas of the models, each with its own CUDA stream and
    # in-flight queue; the run loops' window rises to the pool's capacity
    # (replicas x inflight_depth), and the velocity-staleness tradeoff of
    # pipeline_depth scales with it
    device_pool: bool = False
    # per-replica batches in flight (2 keeps a replica's work back to back)
    inflight_depth: int = 2
    # the deadline-aware QoS plane (qos/): a QosSettings (the plane is built
    # when enabled) or a live QosPlane; None or enabled=False = off, and the
    # job behaves as without it
    qos: Optional[Any] = None
    # the tracing plane (obs/tracing.py): a TracingSettings (the Tracer is
    # built when enabled) or a live Tracer (the drills pass one on a
    # virtual clock); None or disabled = off, one ``is None`` branch a batch
    tracing: Optional[Any] = None
    # distributed tracing: True means every consumed record is expected to
    # carry a producer-stamped carrier (obs.tracing.CARRIER_KEY in the raw
    # value), and a record without a parseable one opens a fresh root trace
    # counted in the tracer's carrier_lost (a frame a link fault dropped);
    # False adopts a carrier when present and never counts one as lost
    expect_carrier: bool = False
    # the tuning plane (tuning/): a TuningSettings (the plane is built when
    # enabled) or a live TuningPlane; None or disabled = off, and batch
    # closes are bit-identical to the fixed-deadline path
    autotune: Optional[Any] = None
    # the continuous-learning plane (feedback/): a live FeedbackPlane fed
    # after every scored batch, its labels topic drained in the run loops;
    # None = off
    feedback: Optional[Any] = None
    labels_topic: str = T.LABELS
    transactions_topic: str = T.TRANSACTIONS
    predictions_topic: str = T.PREDICTIONS
    alerts_topic: str = T.ALERTS
    enriched_topic: str = T.ENRICHED
    features_topic: str = T.FEATURES

    def __post_init__(self) -> None:
        from realtime_fraud_detection_tpu_torch.feedback.plane import FeedbackPlane
        from realtime_fraud_detection_tpu_torch.obs.tracing import Tracer
        from realtime_fraud_detection_tpu_torch.qos.plane import QosPlane
        from realtime_fraud_detection_tpu_torch.tuning.plane import TuningPlane

        for name, kinds in (("qos", (QosSettings, QosPlane)),
                            ("tracing", (TracingSettings, Tracer)),
                            ("autotune", (TuningSettings, TuningPlane)),
                            ("feedback", (FeedbackPlane,))):
            value = getattr(self, name)
            if value is not None and not isinstance(value, kinds):
                raise TypeError(
                    f"JobConfig.{name} must be "
                    f"{' or '.join(k.__name__ for k in kinds)}, "
                    f"got {type(value).__name__}")


@dataclasses.dataclass
class _BatchCtx:
    """A microbatch between dispatch and completion (device in flight)."""

    fresh: List[Record]
    ids: set
    pending: Any                      # PendingScore | AssembledHandle | None
    positions: Dict[tuple, int]       # offsets to commit at completion
    now: Optional[float]
    # records rejected by per-record sanitization: each gets its own error
    # result at completion and never poisons the rest of the batch
    invalid: List[tuple] = dataclasses.field(default_factory=list)
    # transaction-cache duplicates: (record, cached result) pairs, re-emitted
    # from the cache at completion (a crash between write-back and fan-out
    # may have lost the first prediction)
    cached_dups: List[tuple] = dataclasses.field(default_factory=list)
    # QoS admission sheds: (record, AdmissionDecision) pairs, each produced
    # as an explicit REVIEW at completion
    shed: List[tuple] = dataclasses.field(default_factory=list)
    # the batch's obs.tracing.TraceBatch (None = tracing off)
    trace: Optional[Any] = None
    # dispatch instant on the record timestamps' clock (wall time, or the
    # drills' virtual clock): the tuning plane's service time is completion
    # minus this
    t_dispatch: float = 0.0


def _error_result(transaction_id: str, explanation: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "transaction_id": transaction_id,
        "fraud_probability": 0.5,
        "fraud_score": 0.5,
        "risk_level": "ERROR",
        "decision": "REVIEW",
        "model_predictions": {},
        "confidence": 0.0,
        "processing_time_ms": 0.0,
        "explanation": explanation,
    }


class StreamJob:
    """Consume -> score -> fan out -> commit. One instance per process.

    The run loops keep up to ``JobConfig.pipeline_depth`` microbatches in
    flight and complete them (fan-out + offset commit) strictly in dispatch
    order. The job runs on the caller's thread, but for the scorer's
    assemble + dispatch under ``overlap_assembly``; ``close`` stops that
    stage's thread.
    """

    def __init__(self, broker: InMemoryBroker, scorer: Any,
                 config: Optional[JobConfig] = None,
                 faults: Optional[FaultInjector] = None):
        self.broker = broker
        self.scorer = scorer
        self.config = config or JobConfig()
        self.consumer = broker.consumer(
            [self.config.transactions_topic], self.config.group_id, faults)
        self.qos = None
        qs = self.config.qos
        if qs is not None and qs.enabled:
            from realtime_fraud_detection_tpu_torch.qos.plane import QosPlane

            self.qos = qs if isinstance(qs, QosPlane) else QosPlane(qs)
        # the tuning plane: the assembler consults its just-in-time closer
        # instead of the fixed deadline
        self.tuning = None
        ts = self.config.autotune
        if ts is not None and ts.enabled:
            from realtime_fraud_detection_tpu_torch.tuning.plane import TuningPlane

            self.tuning = ts if isinstance(ts, TuningPlane) else TuningPlane(ts)
        self.assembler = MicrobatchAssembler(
            self.consumer, max_batch=self.config.max_batch,
            max_delay_ms=self.config.max_delay_ms,
            budget=self.qos.budget if self.qos is not None else None,
            controller=self.tuning)
        # the tracing plane: a live Tracer is adopted as given
        self.tracer = None
        tr = self.config.tracing
        if tr is not None and tr.enabled:
            from realtime_fraud_detection_tpu_torch.obs.tracing import Tracer

            self.tracer = tr if isinstance(tr, Tracer) else Tracer(tr)
        self.analytics = (WindowedAnalytics(broker)
                          if self.config.enable_analytics else None)
        # the feedback plane: labels are a stream of their own, with their
        # own offsets under a consumer group of their own
        self.feedback = self.config.feedback
        self._labels_consumer = None
        if self.feedback is not None:
            self._labels_consumer = broker.consumer(
                [self.config.labels_topic], f"{self.config.group_id}-labels")
        self.counters: Dict[str, int] = {
            "scored": 0, "alerts": 0, "batches": 0, "duplicates_skipped": 0,
            "errors": 0, "shed": 0,
        }
        # transaction ids dispatched but not yet written back: batch N+1 is
        # deduplicated against them before batch N lands in the txn cache
        self._inflight_ids: set = set()
        # the device pool: an already-attached one (the caller's) is kept;
        # getattr: the drills drive this job with stand-in scorers
        self.pool = getattr(scorer, "pool", None)
        if self.config.device_pool and self.pool is None:
            from realtime_fraud_detection_tpu_torch.scoring.device_pool import DevicePool

            self.pool = DevicePool(scorer, inflight_depth=self.config.inflight_depth)
        self._stage = None
        if self.config.overlap_assembly:
            from realtime_fraud_detection_tpu_torch.scoring.host_pipeline import (
                AssemblerStage,
            )

            self._stage = AssemblerStage(
                scorer, depth=max(1, self.config.pipeline_depth))
        # the graceful-stop seam (run-job's SIGTERM / SIGINT handlers set it)
        self.stop_requested = False
        # the process's host stage table, the one the scorer reports
        spans = getattr(scorer, "spans", None)
        self._spans = spans if isinstance(spans, SpanTimer) else None

    def request_stop(self) -> None:
        """Ask the run loops to drain: stop polling, complete every batch in
        flight and commit, then return (one attribute write, so safe in a
        signal handler)."""
        self.stop_requested = True

    def close(self) -> None:
        """Stop the background assembler stage (no-op without overlap)."""
        if self._stage is not None:
            self._stage.close()

    def _inflight_depth(self) -> int:
        """The run loops' in-flight window: the configured pipeline depth,
        or with the tuning plane its online-tuned depth (re-read every loop
        iteration, so a tuner move takes effect one batch later). An
        attached pool's capacity overrides both: a smaller window starves
        replicas, a larger one deadlocks this loop (a dispatch would wait
        for a slot only this loop's own completion frees)."""
        if self.pool is not None:
            return self.pool.total_slots()
        if self.tuning is not None:
            return max(1, self.tuning.recommended_inflight_depth())
        return max(1, self.config.pipeline_depth)

    # ----------------------------------------------------------------- steps
    def process_batch(self, records: List[Record],
                      now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Score one microbatch and fan its results out (dispatch, then
        complete)."""
        ctx = self.dispatch_batch(records, now=now)
        return self.complete_batch(ctx) if ctx is not None else []

    def dispatch_batch(self, records: List[Record],
                       now: Optional[float] = None) -> Optional[_BatchCtx]:
        """Stage 1: sanitize, dedupe and launch on the device without
        waiting. Offsets are snapshotted here, so a later poll cannot advance
        what this batch's commit covers."""
        if not records:
            return None
        fresh: List[Record] = []
        invalid: List[tuple] = []
        cached_dups: List[tuple] = []
        shed: List[tuple] = []
        trace_ctxs: List[Any] = []
        tracer = self.tracer
        batch_ids: set = set()
        # rtfd-lint: allow[wall-clock] production default time base; drills pass now
        t_adm = now if now is not None else time.time()

        def ingest_lag(rec: Record) -> float:
            # upstream of admission: the record's ingest stamp when it has
            # one, else the broker's produce timestamp (wall minus wall, or
            # virtual minus virtual in the drills)
            src = rec.value.get("ingest_ts") if isinstance(rec.value, dict) else None
            if src is None:
                src = rec.timestamp
            try:
                return max(0.0, t_adm - float(src)) if src is not None else 0.0
            except (TypeError, ValueError):
                return 0.0

        def begin(rec: Record, txn_id: str, priority: str = ""):
            # a producer-stamped carrier is adopted when the record has one,
            # read from the raw value (sanitizing strips it)
            carrier = (rec.value.get(CARRIER_KEY)
                       if isinstance(rec.value, dict) else None)
            return tracer.begin(txn_id, ingest_lag_s=ingest_lag(rec),
                                priority=priority, carrier=carrier,
                                now_wall=t_adm,
                                expect_carrier=self.config.expect_carrier)

        for r in records:
            txn, errors = sanitize_for_stream(r.value)
            if errors:
                invalid.append((r, errors))
                if tracer is not None:
                    value = r.value if isinstance(r.value, dict) else {}
                    tracer.finish_terminal(
                        begin(r, str(value.get("transaction_id", ""))), "error",
                        reason="invalid")
                continue
            txn_id = txn["transaction_id"]  # the sanitizer guarantees it
            if txn_id in batch_ids or txn_id in self._inflight_ids:
                # the first instance emits the prediction itself
                self.counters["duplicates_skipped"] += 1
                if tracer is not None:
                    tracer.finish_terminal(begin(r, txn_id), "cached",
                                           reason="duplicate")
                continue
            cached = self.scorer.txn_cache.get_transaction(txn_id, now=now)
            if cached is not None:
                # scored and written back before: re-emit from the cache at
                # completion, no re-scoring, no double-counted velocity
                self.counters["duplicates_skipped"] += 1
                batch_ids.add(txn_id)
                cached_dups.append((r, cached))
                if tracer is not None:
                    tracer.finish_terminal(begin(r, txn_id), "cached",
                                           reason="duplicate")
                continue
            priority = ""
            if self.qos is not None:
                # after dedupe (a replayed duplicate must not burn tokens)
                # and before dispatch: a shed is produced at completion
                decision = self.qos.admit(txn, t_adm)
                priority = decision.priority
                if not decision.admitted:
                    self.counters["shed"] += 1
                    shed.append((dataclasses.replace(r, value=txn), decision))
                    if tracer is not None:
                        # a shed is a recorded terminal trace, not a gap
                        tracer.finish_terminal(
                            begin(r, txn_id, decision.priority), "shed",
                            reason=decision.reason, priority=decision.priority)
                    continue
            batch_ids.add(txn_id)
            fresh.append(dataclasses.replace(r, value=txn))
            if tracer is not None:
                trace_ctxs.append(begin(r, txn_id, priority))
        positions = self.consumer.snapshot_positions()
        if self.qos is not None:
            # one ladder observation per dispatched batch: consumer lag is
            # everything not yet committed (the unread topic plus every
            # batch in flight), minus this batch
            self.qos.observe_backlog(max(0, self.consumer.lag() - len(records)))
            if self._stage is not None:
                # the stage thread reads the scorer's mask and rules_only
                # flag at dispatch: one batch must never see a torn pair
                with self._stage.lock:
                    self.qos.apply_degradation(self.scorer)
            else:
                # rtfd-lint: allow[lock-order] stream job is single-writer: consume, score, QoS share one thread
                self.qos.apply_degradation(self.scorer)
        if not fresh:
            return _BatchCtx([], set(), None, positions, now, invalid,
                             cached_dups, shed)
        trace = None
        if tracer is not None:
            trace = tracer.batch(trace_ctxs, batch_size=len(fresh),
                                 close_reason=self.assembler.last_close_reason)
        # the trace is passed only when tracing is live: the drills' stand-in
        # scorers need not know the argument
        kw = {"trace": trace} if trace is not None else {}
        pending = None
        try:
            if self._stage is not None:
                # resolves to the PendingScore at completion, where an
                # assembly or dispatch error takes the degradation path;
                # the trace rides the stage's queue item
                pending = self._stage.submit([r.value for r in fresh], now=now,
                                             **kw)
            else:
                pending = self.scorer.dispatch([r.value for r in fresh], now=now,
                                               **kw)
        except Exception:
            # whole-batch degradation: REVIEW at 0.5 keeps the stream alive;
            # counted as errors at completion
            pass
        self._inflight_ids |= batch_ids
        return _BatchCtx(fresh, batch_ids, pending, positions, now, invalid,
                         cached_dups, shed, trace, t_adm)

    def complete_batch(self, ctx: _BatchCtx,
                       now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Stage 2: wait for the device result, fan out, commit offsets.
        ``now`` is the completion time of the QoS budget accounting (the
        drill's virtual clock; default the dispatch clock, else wall time);
        ``ctx.now`` stays the event clock of the state TTLs."""
        fresh = ctx.fresh
        t_done = now if now is not None else (
            # rtfd-lint: allow[wall-clock] production default time base; drills pass now
            ctx.now if ctx.now is not None else time.time())
        now = ctx.now
        if not fresh:
            invalid_results = self._emit_invalid(ctx)
            self._emit_shed(ctx)
            self._emit_cached_dups(ctx)
            self.consumer.commit(ctx.positions)
            return invalid_results

        scored_ok, results, feats = False, None, None
        if ctx.pending is not None:
            try:
                pending = ctx.pending
                if self._stage is not None:
                    pending = pending.result()
                results = self.scorer.finalize(
                    pending, now=now,
                    lock=self._stage.lock if self._stage is not None else None)
                feats = pending.features
                scored_ok = True
            except Exception:
                results = None
        if results is None:
            self.counters["errors"] += len(fresh)
            results = [_error_result(str(r.value.get("transaction_id", "")),
                                     {"error": True}) for r in fresh]
        if self.qos is not None:
            self.qos.record_scored(len(fresh))
            for r in fresh:
                # budget headroom at completion, from the ingest timestamp
                self.qos.record_completion(
                    r.timestamp if r.timestamp is not None else t_done, t_done)
        try:
            invalid_results = self._emit_invalid(ctx)
            self._emit_shed(ctx)
            self._emit_cached_dups(ctx)
            with (self._spans.span("fan_out") if self._spans is not None
                  else contextlib.nullcontext()):
                fanned = self._fan_out(ctx, fresh, results, feats, scored_ok, now)
            out = invalid_results + fanned
            self._observe_planes(ctx, fresh, scored_ok, t_done)
            if self.feedback is not None and scored_ok:
                # exactly what was emitted, with the batch's feature rows
                # (the retrain corpus); then the due labels and the cheap
                # trigger check, on the completion clock. The retrain stays
                # with the run loops (react)
                self.feedback.on_predictions(
                    [r.value for r in fresh], results,
                    features=feats[:len(fresh)] if feats is not None else None,
                    now=t_done)
                self.drain_labels()
                self.feedback.check_trigger(now=t_done)
            return out
        finally:
            # always release, even when fan-out raises: a leaked id would
            # make the replayed record look like an in-flight duplicate and
            # the next commit would advance past it
            self._inflight_ids -= ctx.ids

    def _observe_planes(self, ctx: _BatchCtx, fresh: List[Record],
                        scored_ok: bool, t_done: float) -> None:
        """After fan-out: close the batch's traces and feed the SLO burn
        rate to the QoS plane's gate, then give the tuning plane the batch's
        dispatch-to-completion time, its admitted latencies, the burn rate
        and the served rung (it freezes while the ladder is degraded)."""
        burn = 0.0
        if ctx.trace is not None and self.tracer is not None:
            self.tracer.finish_batch(ctx.trace,
                                     terminal="scored" if scored_ok else "error")
            # the burn rate reads the tracer's clock, the clock the traces
            # closed on: one time base end to end
            ts = self.tracer.settings
            burn = self.tracer.slo.burn_rate(ts.slo_fast_window_s)
            if self.qos is not None:
                self.qos.observe_slo_burn(
                    burn, threshold=ts.slo_burn_threshold,
                    patience=ts.slo_gate_patience,
                    up_patience=ts.slo_gate_up_patience)
        if self.tuning is not None:
            lat = [max(0.0, t_done - r.timestamp) * 1e3
                   for r in fresh if r.timestamp is not None]
            self.tuning.on_batch_complete(
                len(fresh), max(0.0, t_done - ctx.t_dispatch), t_done,
                latencies_ms=lat, burn_rate=burn,
                ladder_level=(self.qos.effective_level()
                              if self.qos is not None else 0))

    def _emit_invalid(self, ctx: _BatchCtx) -> List[Dict[str, Any]]:
        """Per-record error results for sanitization rejects, produced to
        the predictions topic: a REVIEW decision, never a silent gap."""
        results = []
        items = []
        for rec, errors in ctx.invalid:
            value = rec.value if isinstance(rec.value, dict) else {}
            res = _error_result(str(value.get("transaction_id", "")),
                                {"error": True, "validation_errors": errors})
            self.counters["errors"] += 1
            items.append((str(value.get("user_id", "")), res))
            results.append(res)
        if items:
            self.broker.produce_batch_keyed(self.config.predictions_topic,
                                            items)
        return results

    def _emit_shed(self, ctx: _BatchCtx) -> None:
        """A score-with-reason for every shed record
        (``QosPlane.shed_result``): downstream sees a REVIEW with the shed
        reason and priority class, covered by this batch's commit."""
        if not ctx.shed or self.qos is None:
            return
        items = []
        for rec, decision in ctx.shed:
            value = rec.value if isinstance(rec.value, dict) else {}
            items.append((str(value.get("user_id", "")),
                          self.qos.shed_result(value, decision)))
        self.broker.produce_batch_keyed(self.config.predictions_topic, items)

    def _emit_cached_dups(self, ctx: _BatchCtx) -> None:
        """Re-emit predictions for transaction-cache duplicates from their
        cached results; consumers deduplicate by transaction id."""
        items = []
        for rec, cached in ctx.cached_dups:
            value = rec.value if isinstance(rec.value, dict) else {}
            items.append((
                str(value.get("user_id", "")),
                {
                    "transaction_id": str(cached.get("transaction_id") or
                                          value.get("transaction_id", "")),
                    "fraud_probability": float(cached.get("fraud_score", 0.5)),
                    "fraud_score": float(cached.get("fraud_score", 0.5)),
                    "risk_level": str(cached.get("risk_level", "UNKNOWN")),
                    "decision": str(cached.get("decision", "REVIEW")),
                    "model_predictions": {},
                    "confidence": float(cached.get("confidence", 0.0)),
                    "processing_time_ms": 0.0,
                    "explanation": {"replayed_from_cache": True},
                },
            ))
        if items:
            self.broker.produce_batch_keyed(self.config.predictions_topic,
                                            items)

    def _enrich(self, results: List[Dict[str, Any]], feats):
        """The batch's blended scores, enrichment decisions and risk levels
        (``blend_enrichment`` on the scorer's device; no padding, so no pad
        row can reach the output)."""
        import torch

        from realtime_fraud_detection_tpu_torch.features.rules import (
            DECISIONS,
            RISK_LEVEL_NAMES,
            blend_enrichment,
        )

        n = len(results)
        device = getattr(self.scorer, "device", "cpu")
        prior = torch.tensor([r["fraud_score"] for r in results],
                             dtype=torch.float32).to(device)
        blended, dec, risk = blend_enrichment(
            prior, torch.as_tensor(feats[:n]).to(device))
        return (blended.cpu().tolist(),
                [DECISIONS[i] for i in dec.cpu().tolist()],
                [RISK_LEVEL_NAMES[i] for i in risk.cpu().tolist()])

    def _fan_out(self, ctx: _BatchCtx, fresh: List[Record],
                 results: List[Dict[str, Any]], feats,
                 scored_ok: bool, now: Optional[float]) -> List[Dict[str, Any]]:
        """Enrich, produce to the output topics (one batched produce per
        topic), feed the analytics stage, then commit."""
        cfg = self.config
        wants_enriched = cfg.emit_enriched or self.analytics is not None
        enriched_scores = None
        if cfg.enable_enrichment and scored_ok and wants_enriched:
            enriched_scores = self._enrich(results, feats)
        out_preds: List[tuple] = []
        out_alerts: List[tuple] = []
        out_enriched: List[tuple] = []
        out_features: List[tuple] = []
        for i, (rec, res) in enumerate(zip(fresh, results)):
            uid = str(rec.value.get("user_id", ""))
            out_preds.append((uid, res))
            if res["fraud_score"] > cfg.alert_threshold:
                out_alerts.append((uid, self._to_alert(rec.value, res)))
                self.counters["alerts"] += 1
            if wants_enriched:
                enriched = dict(rec.value)
                enriched.update(fraud_score=res["fraud_score"],
                                risk_level=res["risk_level"],
                                decision=res["decision"])
                if enriched_scores is not None:
                    blended, decisions, risks = enriched_scores
                    enriched.update(fraud_score=blended[i], risk_level=risks[i],
                                    decision=decisions[i],
                                    ensemble_score=res["fraud_score"])
                if cfg.emit_enriched:
                    out_enriched.append((uid, enriched))
                if self.analytics is not None:
                    self.analytics.process(
                        enriched, _event_time_ms(enriched, now) / 1000.0)
            # feature rows exist only when scoring succeeded
            if cfg.emit_features and scored_ok:
                out_features.append((uid, {
                    "transaction_id": res["transaction_id"],
                    "features": feats[i].tolist()}))
        self.broker.produce_batch_keyed(cfg.predictions_topic, out_preds)
        if out_alerts:
            self.broker.produce_batch_keyed(cfg.alerts_topic, out_alerts)
        if out_enriched:
            self.broker.produce_batch_keyed(cfg.enriched_topic, out_enriched)
        if out_features:
            self.broker.produce_batch_keyed(cfg.features_topic, out_features)
        self.counters["scored"] += len(fresh)
        self.counters["batches"] += 1
        # commit after fan-out and the scorer's write-back: at-least-once
        self.consumer.commit(ctx.positions)
        return results

    @staticmethod
    def _to_alert(txn: Dict[str, Any], res: Dict[str, Any]) -> Dict[str, Any]:
        """Alert payload (Transaction.toFraudAlert analog)."""
        return {
            "alert_type": "FRAUD_DETECTED",
            "transaction_id": res["transaction_id"],
            "user_id": txn.get("user_id"),
            "merchant_id": txn.get("merchant_id"),
            "amount": txn.get("amount"),
            "fraud_score": res["fraud_score"],
            "risk_level": res["risk_level"],
            "decision": res["decision"],
            "timestamp": txn.get("timestamp"),
        }

    def drain_labels(self, max_records: int = 10_000) -> int:
        """Poll the labels topic into the feedback plane (no-op without
        one); returns the newly matched pairs. Label offsets commit right
        after ingestion: the join deduplicates a replayed label."""
        if self._labels_consumer is None:
            return 0
        recs = self._labels_consumer.poll(max_records)
        if not recs:
            return 0
        matched = self.feedback.on_labels(
            [r.value for r in recs if isinstance(r.value, dict)])
        self._labels_consumer.commit()
        return matched

    def _react(self, now: Optional[float] = None) -> None:
        """Run a pending retrain -> gate -> promotion between batches. With
        overlapped assembly the stage lock is held, so the promotion never
        swaps the models under a batch the stage thread is dispatching."""
        if self.feedback is None or self.feedback.pending_trigger is None:
            return
        with (self._stage.lock if self._stage is not None
              else contextlib.nullcontext()):
            self.feedback.react(now=now)

    # ------------------------------------------------------------------ run
    def _dispatch_tail(self, in_flight: deque,
                       now: Optional[float] = None) -> None:
        """The drain after ``request_stop``: dispatch the assembler's
        polled-but-unbatched records too (their offsets are past the last
        commit snapshot, so leaving them would replay them on a restart)."""
        tail = self.assembler.flush()
        while tail:
            in_flight.append(self.dispatch_batch(tail, now=now))
            tail = self.assembler.flush()

    def run_until_drained(self, max_batches: int = 10_000,
                          now: Optional[float] = None) -> int:
        """Process until the input topic is fully consumed, or until
        ``request_stop`` (then drain). Returns #scored."""
        start_scored = self.counters["scored"]
        in_flight: deque = deque()
        for _ in range(max_batches):
            if self.stop_requested:
                self._dispatch_tail(in_flight, now)
                break
            batch = self.assembler.next_batch(block=False)
            if not batch:
                batch = self.assembler.flush()
            if not batch:
                if in_flight:
                    self.complete_batch(in_flight.popleft())
                    continue
                if self.consumer.lag() == 0:
                    break
                continue
            in_flight.append(self.dispatch_batch(batch, now=now))
            while len(in_flight) >= self._inflight_depth():
                self.complete_batch(in_flight.popleft())
            self._react(now)
        while in_flight:
            self.complete_batch(in_flight.popleft())
        self.drain_labels()
        return self.counters["scored"] - start_scored

    def run_for(self, duration_s: float) -> int:
        """Process the stream for a wall-clock window, or until
        ``request_stop`` (then drain). Returns #scored."""
        # rtfd-lint: allow[wall-clock] consume-only slice duration is wall-bound by definition
        t_end = time.monotonic() + duration_s
        start = self.counters["scored"]
        in_flight: deque = deque()
        # rtfd-lint: allow[wall-clock] consume-only slice duration is wall-bound by definition
        while time.monotonic() < t_end and not self.stop_requested:
            batch = self.assembler.next_batch(block=True, timeout_s=0.05)
            if batch:
                in_flight.append(self.dispatch_batch(batch))
            if in_flight and (len(in_flight) >= self._inflight_depth() or not batch):
                self.complete_batch(in_flight.popleft())
            self._react()
        if self.stop_requested:
            self._dispatch_tail(in_flight)
        while in_flight:
            self.complete_batch(in_flight.popleft())
        self.drain_labels()
        return self.counters["scored"] - start
