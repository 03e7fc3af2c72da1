"""FeedbackPlane: the closed loop, assembled.

Port of the JAX package's ``feedback/plane.py``. The plane is host state;
the only device work it starts is the retrainer's branch scoring (and, with
``retrain_neural``, the LSTM's training) on the scorer's device, and the
promotion's ``set_models``, which moves the candidate onto the card.

Wires the label join (labels.py), the prequential evaluator
(prequential.py), the bounded labeled buffer (state/labeled.py), the drift
monitor (obs/drift.py), and the retrain/gate policy (policy.py) around a
live scorer:

    predictions ──▶ LabelJoin ◀── delayed labels
                        │ matched
                        ▼
        PrequentialEvaluator + LabeledExampleBuffer + FeatureDriftMonitor
                        │ degradation / drift
                        ▼
        RetrainPolicy ─▶ Retrainer ─▶ PromotionGate ─▶ promote
                                           │ fail
                                           ▼
                              nothing changes, verdict recorded

Promotion runs the /reload-models recipe — ``set_models`` + config blend
update + ``refresh_blend_from_config`` under the host's score lock — so a
promoted candidate deploys exactly the way an operator-driven reload does.
Batches already launched finish with the models they were launched with
(``scoring/scorer.py PendingScore.launched_with``): the swap lands between
dispatches, and the megakernel's parameter arguments are rebuilt for the
next batch that it serves. Every trigger, gate verdict, and promotion is appended to a bounded audit
trail (``events``) and mirrored to Prometheus by
``MetricsCollector.sync_feedback``.

Thread model: single-writer, like the stores it owns. The serving app and
the stream job both call ``on_predictions``/``on_labels`` from the one
thread that already owns the scorer's host state (under the score lock
where one exists); ``react`` — the expensive retrain — is safe to run from
a worker thread only because it touches the scorer exclusively through
``promote_fn``, which the host points at its own locked reload recipe.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import numpy as np

from realtime_fraud_detection_tpu_torch.feedback.labels import LabelJoin
from realtime_fraud_detection_tpu_torch.feedback.policy import (
    PromotionGate,
    Retrainer,
    RetrainPolicy,
)
from realtime_fraud_detection_tpu_torch.feedback.prequential import (
    PrequentialEvaluator,
)
from realtime_fraud_detection_tpu_torch.state.labeled import LabeledExampleBuffer
from realtime_fraud_detection_tpu_torch.state.stores import _event_time_ms
from realtime_fraud_detection_tpu_torch.utils.config import FeedbackSettings

__all__ = ["FeedbackPlane", "promote_candidate"]


def promote_candidate(scorer, config, candidate: Mapping[str, Any],
                      lock: Optional[threading.Lock] = None) -> Dict[str, Any]:
    """The /reload-models recipe, applied to a gate-passed candidate:
    swap the retrained branches into the model set, write the candidate's
    weights/strategy into the config's model table, and refresh the
    scorer's blend — all under the host's score lock, between batches.
    This is the ONE way the plane (or the serving endpoint) deploys a
    candidate; there is no side door that skips the gate."""
    import contextlib
    import dataclasses

    models = dataclasses.replace(
        scorer.models, trees=candidate["trees"], iforest=candidate["iforest"],
        **({"lstm": candidate["lstm"]}
           if candidate.get("lstm") is not None else {}))
    weights = candidate["weights"]
    with (lock if lock is not None else contextlib.nullcontext()):
        scorer.set_models(models)
        for name, mc in config.models.items():
            if name in weights:
                mc.enabled = True
                mc.weight = float(weights[name])
            else:
                mc.enabled = False
        config.ensemble.strategy = candidate.get("strategy",
                                                 "weighted_average")
        scorer.refresh_blend_from_config()
    return {"branches": sorted(weights),
            "strategy": config.ensemble.strategy}


class FeedbackPlane:
    """Continuous-learning plane around one scorer; its retrainer runs on
    the scorer's device (``cuda`` without a scorer)."""

    def __init__(self, settings: Optional[FeedbackSettings] = None,
                 scorer=None, config=None, metrics=None,
                 promote_fn: Optional[Callable[[Mapping[str, Any]],
                                               Dict[str, Any]]] = None,
                 drift_monitor=None,
                 clock: Callable[[], float] = time.time):
        self.settings = settings or FeedbackSettings()
        s = self.settings
        self.scorer = scorer
        self.config = config
        self.metrics = metrics
        self.clock = clock
        self.join = LabelJoin(horizon_s=s.label_horizon_s,
                              pred_ooo_s=s.pred_ooo_s,
                              label_ooo_s=s.label_ooo_s,
                              max_pending=s.join_max_pending)
        self.evaluator = PrequentialEvaluator(
            window=s.sliding_window, threshold=s.operating_threshold,
            fading_gamma=s.fading_gamma)
        self.buffer = LabeledExampleBuffer(
            capacity=s.buffer_size, store_history=s.buffer_store_history)
        self.drift = drift_monitor
        self.policy = RetrainPolicy(
            auc_drop=s.auc_drop, auc_floor=s.auc_floor,
            min_labels=s.min_labels, cooldown_s=s.cooldown_s,
            use_drift=s.use_drift_trigger)
        self.retrainer = Retrainer(
            n_trees=s.retrain_trees, depth=s.retrain_depth,
            iforest_trees=s.retrain_iforest_trees,
            select_frac=s.gate_select_frac,
            holdout_frac=s.gate_holdout_frac,
            train_neural=s.retrain_neural,
            # the retrain scores its candidate where the scorer runs
            device=str(getattr(scorer, "device", "cuda")))
        self.gate = PromotionGate(
            auc_margin=s.gate_auc_margin,
            recall_tolerance=s.gate_recall_tolerance,
            min_positives=s.gate_min_positives,
            operating_threshold=s.operating_threshold)
        self._promote_fn = promote_fn
        self.events: deque = deque(maxlen=256)   # bounded audit trail
        self.counters: Dict[str, int] = {
            "triggers": 0, "gate_pass": 0, "gate_fail": 0, "promotions": 0,
        }
        self.pending_trigger: Optional[Dict[str, Any]] = None
        self._react_lock = threading.Lock()
        # evaluation stride: the full snapshot + PSI report only re-run
        # after this many NEW labels (the metrics can't move without new
        # labels, so denser evaluation is pure hot-path cost)
        self.eval_stride = max(1, s.sliding_window // 32)
        self._last_eval_labels = -self.eval_stride

    # ------------------------------------------------------------- audit
    def _record(self, event: Dict[str, Any]) -> Dict[str, Any]:
        self.events.append(event)
        return event

    # ------------------------------------------------------------- inputs
    def on_predictions(self, records: Sequence[Mapping[str, Any]],
                       results: Sequence[Mapping[str, Any]],
                       features: Optional[np.ndarray] = None,
                       now: Optional[float] = None) -> int:
        """Register a scored batch with the join (and the drift monitor).
        ``records``/``results`` are the job/serving pairs; ``features`` the
        assembled (B, F) rows — the retrain corpus. Returns newly matched
        labels processed (labels can beat predictions through the broker)."""
        matched = []
        for i, (rec, res) in enumerate(zip(records, results)):
            ts = (now if now is not None
                  else _event_time_ms(rec, None) / 1000.0)
            payload = {
                "score": float(res.get("fraud_score", 0.5)),
                "branch_preds": dict(res.get("model_predictions") or {}),
            }
            if features is not None and i < len(features):
                payload["features"] = np.asarray(features[i], np.float32)
            matched.extend(self.join.process_prediction(
                str(res.get("transaction_id", "")), float(ts), payload))
        if self.drift is not None and features is not None \
                and len(features):
            self.drift.update(np.asarray(features))
        for m in matched:
            self._ingest_match(m)
        return len(matched)

    def on_labels(self, events: Sequence[Mapping[str, Any]]) -> int:
        """Feed label events (the labels topic's payloads); returns newly
        matched pairs."""
        n = 0
        for ev in events:
            for m in self.join.process_label(ev):
                self._ingest_match(m)
                n += 1
        return n

    def _ingest_match(self, m: Mapping[str, Any]) -> None:
        self.evaluator.update(m["score"], m["is_fraud"],
                              branch_preds=m.get("branch_preds"),
                              label_lag_s=m.get("label_lag_s", 0.0))
        feats = m.get("features")
        if feats is not None:
            self.buffer.append(feats, m["is_fraud"], m["score"],
                               m.get("label_ts", m.get("pred_ts", 0.0)),
                               branch_preds=m.get("branch_preds"))

    # ------------------------------------------------------------- control
    def check_trigger(self, now: Optional[float] = None) -> Optional[Dict]:
        """Policy evaluation only (cheap; callable per batch). A fired
        trigger is recorded, counted, and parked in ``pending_trigger``
        for ``react`` to consume — callers decide where the expensive
        retrain runs (inline on the drill's virtual clock; a worker thread
        in serving)."""
        if self.pending_trigger is not None:
            return self.pending_trigger
        now = self.clock() if now is None else now
        if not self.policy.ready(self.evaluator.labeled_total, now):
            # O(1) exit on the scoring hot path: the full prequential
            # snapshot + PSI report only run once the policy is eligible
            return None
        if (self.evaluator.labeled_total - self._last_eval_labels
                < self.eval_stride):
            return None
        self._last_eval_labels = self.evaluator.labeled_total
        drift_report = self.drift.report() if self.drift is not None else None
        trigger = self.policy.observe(self.evaluator.snapshot(),
                                      drift_report, now)
        if trigger is not None:
            self.counters["triggers"] += 1
            self.pending_trigger = self._record(trigger)
        return trigger

    def react(self, now: Optional[float] = None,
              arrays: Optional[Mapping[str, np.ndarray]] = None
              ) -> Optional[Dict[str, Any]]:
        """Consume the pending trigger: retrain -> gate -> (maybe) promote.
        Returns the gate verdict event, or None when nothing was pending.
        Serialized — concurrent calls (serving worker threads) collapse to
        one retrain. ``arrays``: a buffer snapshot taken under the host's
        ingest lock — a caller whose ingest runs on another thread (the
        serving app) must pass one; reading the live buffer mid-append is
        only safe single-threaded (the job/drill default)."""
        with self._react_lock:
            trigger = self.pending_trigger
            if trigger is None:
                return None
            self.pending_trigger = None
            now = self.clock() if now is None else now
            try:
                candidate = self.retrainer.retrain(
                    arrays if arrays is not None else self.buffer.arrays(),
                    weights=(self.config.normalized_weights()
                             if self.config is not None else None))
            except ValueError as e:
                return self._record({"type": "retrain_skipped", "ts": now,
                                     "reason": str(e), "trigger": trigger})
            return self.submit_candidate(candidate, now=now,
                                         trigger=trigger)

    def submit_candidate(self, candidate: Mapping[str, Any],
                         now: Optional[float] = None,
                         trigger: Optional[Mapping[str, Any]] = None
                         ) -> Dict[str, Any]:
        """Gate a candidate; promote if and only if the gate passes. The
        drill also drives this directly (its negative control)."""
        now = self.clock() if now is None else now
        verdict = self.gate.evaluate(candidate)
        verdict.update(ts=now, trained_on=candidate.get("trained_on"),
                       select_auc=candidate.get("select_auc"),
                       trigger_reason=(trigger or {}).get("reason"))
        self._record(dict(verdict))
        if not verdict["passed"]:
            self.counters["gate_fail"] += 1
            return verdict
        self.counters["gate_pass"] += 1
        promoted = self._promote(candidate)
        self._record({"type": "promotion", "ts": now, **promoted})
        self.counters["promotions"] += 1
        verdict["promoted"] = promoted
        return verdict

    def _promote(self, candidate: Mapping[str, Any]) -> Dict[str, Any]:
        if self._promote_fn is not None:
            return self._promote_fn(candidate)
        if self.scorer is None or self.config is None:
            raise RuntimeError(
                "FeedbackPlane has no scorer/config and no promote_fn — "
                "nothing to promote into")
        # the single-writer path (job, drill); serving injects a promote_fn
        # bound to its score lock
        return promote_candidate(self.scorer, self.config, candidate)

    # ------------------------------------------------------------- snapshot
    @staticmethod
    def _json_safe(obj: Any) -> Any:
        """NaN/inf -> None, recursively: a cold window's AUC is NaN, and
        bare NaN in a JSON body breaks strict parsers downstream."""
        if isinstance(obj, float):
            return obj if math.isfinite(obj) else None
        if isinstance(obj, dict):
            return {k: FeedbackPlane._json_safe(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [FeedbackPlane._json_safe(v) for v in obj]
        return obj

    def snapshot(self) -> Dict[str, Any]:
        """The GET /quality/live payload (strict-JSON safe)."""
        weights = (self.config.normalized_weights()
                   if self.config is not None else None)
        return self._json_safe({
            "enabled": bool(self.settings.enabled),
            "prequential": self.evaluator.snapshot(weights=weights),
            "label_join": self.join.stats(),
            "buffer": self.buffer.stats(),
            "policy": {
                "pending_trigger": self.pending_trigger,
                "last_trigger_ts": (None if self.policy.last_trigger_ts
                                    == float("-inf")
                                    else self.policy.last_trigger_ts),
                **self.counters,
            },
            "events_tail": list(self.events)[-10:],
        })
