"""Deterministic closed-loop drill: prove the continuous-learning plane.

Port of the JAX package's ``feedback/drill.py``, with the same sizes,
phases and verdict. It runs the whole loop on a virtual clock with the real
components, on one device (``cuda`` unless the configuration says
otherwise) — simulator → broker → StreamJob → TorchFraudScorer (the fused
scorer, real GBDT / isolation-forest training on the host) → label join →
prequential evaluation → retrain policy → promotion gate → the
/reload-models promotion recipe:

1. **Train** an incumbent (gbdt + isolation forest) on a historical
   labeled segment through the production assemble path; deploy it.
2. **Healthy stream**: delayed labels match back; prequential AUC settles
   at the incumbent's baseline.
3. **Drift**: ``TransactionGenerator.inject_drift`` adds a novel fraud MO
   the incumbent never saw — prequential sliding AUC dips, the policy
   fires a retrain trigger.
4. **Gate negative control**: a candidate retrained on permuted labels is
   submitted first; the gate MUST reject it, and the serving blend must
   be bit-identical afterwards (models, weights, validity, strategy).
5. **Genuine retrain** on the labeled buffer (which now holds drifted
   positives) → gate pass → promotion through the /reload-models recipe.
6. **Recovery**: the drifted pattern keeps flowing; prequential AUC
   recovers to the baseline band.

``feedback-drill`` prints the full summary, then a compact (<2 KB)
parseable verdict as the last stdout line.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["FeedbackDrillConfig", "run_feedback_drill",
           "compact_drill_summary"]


@dataclasses.dataclass
class FeedbackDrillConfig:
    """Drill sizes. Defaults = the full drill; ``fast()`` = the CPU test
    sizes. ``device`` is where the scorer and the retrainer run."""

    seed: int = 5
    num_users: int = 600
    num_merchants: int = 200
    tps: float = 64.0                 # virtual txns/sec
    batch: int = 128
    n_train: int = 2_048              # historical labeled segment
    # drift phase is deliberately the long one: the retrainer's gate split
    # reserves the NEWEST labels, so the training segment must still hold
    # enough drifted positives to learn the new pattern from
    n_healthy: int = 1_024
    n_drift: int = 2_560
    n_recovery: int = 3_072
    drift_rate: float = 0.08
    n_trees: int = 32
    tree_depth: int = 4
    sliding_window: int = 512
    fading_gamma: float = 0.998
    auc_drop: float = 0.10
    auc_floor: float = 0.82
    min_labels: int = 256
    # virtual seconds; generous enough that exactly one trigger fires per
    # degradation episode
    cooldown_s: float = 30.0
    # compresses the chargeback delay distribution onto the virtual clock:
    # ~9 virtual seconds for a fraud label, ~2 for a legit confirmation
    label_delay_scale: float = 1e-5
    device: str = "cuda"

    @classmethod
    def fast(cls) -> "FeedbackDrillConfig":
        return cls(n_train=1_536, n_healthy=896, n_drift=1_792,
                   n_recovery=2_048, n_trees=24, sliding_window=448,
                   min_labels=224)


def _train_incumbent(cfg, gen, scorer) -> Dict[str, Any]:
    """Historical segment through the production assemble path -> deployed
    trees + iforest (the blend_eval recipe, drill-sized)."""
    from realtime_fraud_detection_tpu_torch.models.isolation_forest import (
        IsolationForestTrainer,
    )
    from realtime_fraud_detection_tpu_torch.training.gbdt import GBDTTrainer

    xs, ys = [], []
    done = 0
    ts = 0.0
    while done < cfg.n_train:
        n = min(cfg.batch, cfg.n_train - done)
        recs = gen.generate_batch(n)
        batch = scorer.assemble(recs, now=ts)
        xs.append(np.asarray(batch.features))
        ys.append(np.asarray([bool(r.get("is_fraud")) for r in recs],
                             np.float32))
        for r in recs:   # serving's write-back: later segments see state
            scorer.velocity.update(str(r.get("user_id", "")),
                                   float(r.get("amount", 0.0)), ts)
        done += n
        ts += n / cfg.tps
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    trees = GBDTTrainer(n_estimators=cfg.n_trees, max_depth=cfg.tree_depth,
                        seed=cfg.seed).fit(x, y)
    iforest = IsolationForestTrainer(n_estimators=48,
                                     seed=cfg.seed + 1).fit(
        x[y < 0.5][:4000])
    # single-threaded here: no batch is in flight during the swap
    # rtfd-lint: allow[lock-order] drill is single-threaded here (no batch in flight during the swap)
    scorer.set_models(dataclasses.replace(scorer.models, trees=trees,
                                          iforest=iforest))
    return {"rows": int(len(y)), "fraud_rate": round(float(y.mean()), 4),
            "virtual_end_s": ts}


def _blend_fingerprint(scorer, config) -> Dict[str, Any]:
    """Everything a promotion could change, copied to the host."""
    trees, forest = scorer.models.trees, scorer.models.iforest
    leaves = [t.detach().cpu().numpy().copy() for t in (
        trees.feature, trees.threshold, trees.leaf, trees.base_score,
        forest.feature, forest.threshold, forest.path_length, forest.c_psi)]
    return {
        "leaves": leaves,
        "weights": scorer.ensemble_params.weights.detach().cpu().numpy().copy(),
        "model_valid": np.asarray(scorer.model_valid).copy(),
        "strategy": config.ensemble.strategy,
    }


def _fingerprints_equal(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
    return (len(a["leaves"]) == len(b["leaves"])
            and all(np.array_equal(x, y)
                    for x, y in zip(a["leaves"], b["leaves"]))
            and np.array_equal(a["weights"], b["weights"])
            and np.array_equal(a["model_valid"], b["model_valid"])
            and a["strategy"] == b["strategy"])


def run_feedback_drill(config: Optional[FeedbackDrillConfig] = None,
                       fast: bool = False,
                       return_state: bool = False) -> Any:
    """Run the closed-loop drill; returns a JSON-able summary (and, with
    ``return_state``, the live plane + job + scorer for assertions)."""
    from realtime_fraud_detection_tpu_torch.feedback.plane import FeedbackPlane
    from realtime_fraud_detection_tpu_torch.obs.drift import (
        DriftConfig,
        FeatureDriftMonitor,
    )
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import ScorerConfig
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.sim.simulator import (
        TransactionGenerator,
    )
    from realtime_fraud_detection_tpu_torch.stream import topics as T
    from realtime_fraud_detection_tpu_torch.stream.job import JobConfig, StreamJob
    from realtime_fraud_detection_tpu_torch.stream.transport import InMemoryBroker
    from realtime_fraud_detection_tpu_torch.utils.config import (
        Config,
        FeedbackSettings,
    )

    cfg = config or (FeedbackDrillConfig.fast() if fast
                     else FeedbackDrillConfig())

    # serving pair (the round-4 production baseline): trees + iforest
    app_config = Config()
    for name, mc in app_config.models.items():
        mc.enabled = name in ("xgboost_primary", "isolation_forest")
    app_config.models["xgboost_primary"].weight = 0.8
    app_config.models["isolation_forest"].weight = 0.2

    gen = TransactionGenerator(num_users=cfg.num_users,
                               num_merchants=cfg.num_merchants,
                               seed=cfg.seed, tps=cfg.tps)
    scorer = TorchFraudScorer(app_config,
                              scorer_config=ScorerConfig(text_len=16,
                                                         tokenizer="word"),
                              device=cfg.device)
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    incumbent = _train_incumbent(cfg, gen, scorer)

    clock = [incumbent["virtual_end_s"]]
    settings = FeedbackSettings(
        enabled=True,
        label_horizon_s=120.0, label_ooo_s=0.5, pred_ooo_s=0.5,
        label_delay_scale=cfg.label_delay_scale,
        buffer_size=max(cfg.n_healthy + cfg.n_drift + cfg.n_recovery, 4096),
        sliding_window=cfg.sliding_window, fading_gamma=cfg.fading_gamma,
        operating_threshold=0.5,
        auc_drop=cfg.auc_drop, auc_floor=cfg.auc_floor,
        min_labels=cfg.min_labels, cooldown_s=cfg.cooldown_s,
        retrain_trees=cfg.n_trees, retrain_depth=cfg.tree_depth + 1,
        gate_min_positives=12,
        # keep the gate honest but small: the drifted positives the
        # candidate must LEARN from live in the recent half of the buffer
        gate_select_frac=0.1, gate_holdout_frac=0.15,
    )
    drift_monitor = FeatureDriftMonitor(DriftConfig(
        num_features=scorer.sc.feature_dim,
        warmup_rows=min(768, cfg.n_healthy // 2), window_rows=512,
        min_report_rows=256))
    plane = FeedbackPlane(settings, scorer=scorer, config=app_config,
                          drift_monitor=drift_monitor,
                          clock=lambda: clock[0])
    broker = InMemoryBroker()
    job = StreamJob(broker, scorer, JobConfig(
        max_batch=cfg.batch, emit_enriched=False, feedback=plane))

    label_heap: List = []     # (label_ts, seq, event)
    seq = [0]

    def push_labels(txns, ts_list) -> None:
        for ev in gen.label_events(txns, event_ts=ts_list,
                                   delay_scale=cfg.label_delay_scale):
            heapq.heappush(label_heap, (ev["label_ts"], seq[0], ev))
            seq[0] += 1

    def release_labels() -> None:
        due = []
        while label_heap and label_heap[0][0] <= clock[0]:
            due.append(heapq.heappop(label_heap)[2])
        for ev in due:
            broker.produce(T.LABELS, ev, key=ev["transaction_id"],
                           timestamp=ev["label_ts"])

    def process_available() -> None:
        while True:
            batch = (job.assembler.next_batch(block=False)
                     or job.assembler.flush())
            if not batch:
                break
            ctx = job.dispatch_batch(batch, now=clock[0])
            if ctx is not None:
                job.complete_batch(ctx, now=clock[0])

    def stream(n: int, auc_trace: List[float]) -> None:
        done = 0
        while done < n:
            k = min(cfg.batch, n - done)
            txns = gen.generate_batch(k)
            ts_list = []
            for txn in txns:
                clock[0] += 1.0 / cfg.tps
                txn["timestamp_ms"] = clock[0] * 1000.0
                ts_list.append(clock[0])
            broker.produce_batch(T.TRANSACTIONS, txns,
                                 key_fn=lambda r: str(r["user_id"]))
            push_labels(txns, ts_list)
            release_labels()
            process_available()
            done += k
            a = plane.evaluator.auc()
            if not math.isnan(a) and len(plane.evaluator) >= cfg.min_labels:
                auc_trace.append(round(a, 4))

    def settle_labels(horizon_s: float = 30.0) -> None:
        """Advance virtual time so the delayed-label tail lands."""
        t_end = clock[0] + horizon_s
        while label_heap and clock[0] < t_end:
            clock[0] = min(max(label_heap[0][0], clock[0] + 0.25), t_end)
            release_labels()
            job.drain_labels()
            plane.check_trigger(now=clock[0])

    # ---- phase 2: healthy stream ------------------------------------------
    healthy_trace: List[float] = []
    stream(cfg.n_healthy, healthy_trace)
    settle_labels()
    baseline_auc = plane.evaluator.auc()

    # ---- phase 3: drift ----------------------------------------------------
    gen.inject_drift(cfg.drift_rate)
    drift_trace: List[float] = []
    stream(cfg.n_drift, drift_trace)
    settle_labels()
    dip_auc = min(drift_trace) if drift_trace else float("nan")
    trigger = plane.pending_trigger or plane.check_trigger(now=clock[0])
    auc_dipped = (not math.isnan(dip_auc)
                  and baseline_auc - dip_auc >= cfg.auc_drop / 2)

    # ---- phase 4: gate negative control -----------------------------------
    # a candidate trained on permuted labels MUST be rejected, and the
    # serving blend must be bit-identical afterwards
    before = _blend_fingerprint(scorer, app_config)
    control_verdict: Dict[str, Any] = {"passed": None,
                                       "reason": "not_run"}
    blend_unchanged = True
    try:
        bad = plane.retrainer.retrain(
            plane.buffer.arrays(),
            weights=app_config.normalized_weights(),
            label_noise_seed=cfg.seed)
        control_verdict = plane.submit_candidate(bad, now=clock[0])
    except ValueError as e:
        control_verdict = {"passed": False, "reason": f"skipped: {e}"}
    blend_unchanged = _fingerprints_equal(before,
                                          _blend_fingerprint(scorer,
                                                             app_config))

    # ---- phase 5: genuine retrain + gated promotion ------------------------
    verdict = plane.react(now=clock[0]) if plane.pending_trigger else None
    promoted = bool(verdict and verdict.get("passed")
                    and "promoted" in verdict)

    # ---- phase 6: recovery (drifted pattern keeps flowing) -----------------
    recovery_trace: List[float] = []
    stream(cfg.n_recovery, recovery_trace)
    settle_labels()
    recovered_auc = plane.evaluator.auc()
    auc_recovered = (promoted and not math.isnan(recovered_auc)
                     and recovered_auc >= baseline_auc - 0.05)

    snap = plane.snapshot()
    passed = bool(
        auc_dipped and trigger is not None
        and control_verdict.get("passed") is False and blend_unchanged
        and promoted and auc_recovered)
    summary: Dict[str, Any] = {
        "metric": "feedback_drill",
        "passed": passed,
        "baseline_auc": round(baseline_auc, 4),
        "dip_auc": (None if math.isnan(dip_auc) else round(dip_auc, 4)),
        "recovered_auc": (None if math.isnan(recovered_auc)
                          else round(recovered_auc, 4)),
        "auc_dipped": bool(auc_dipped),
        "retrain_triggered": trigger is not None,
        "trigger_reason": (trigger or {}).get("reason"),
        "gate_control_rejected": control_verdict.get("passed") is False,
        "gate_control_reason": control_verdict.get("reason"),
        "blend_unchanged_on_reject": bool(blend_unchanged),
        "promoted": promoted,
        "gate": ({k: v for k, v in (verdict or {}).items()
                  if k not in ("promoted",)} if verdict else None),
        "promoted_blend": (verdict or {}).get("promoted"),
        "incumbent": incumbent,
        "drift_rate": cfg.drift_rate,
        "label_join": snap["label_join"],
        "buffer": snap["buffer"],
        "policy": {k: snap["policy"][k] for k in
                   ("triggers", "gate_pass", "gate_fail", "promotions")},
        "labeled_total": snap["prequential"]["labeled_total"],
        "drop_one_auc": snap["prequential"].get("drop_one_auc"),
        "virtual_duration_s": round(clock[0], 2),
        "events": len(plane.events),
    }
    if return_state:
        return summary, plane, job, scorer
    return summary


def compact_drill_summary(summary: Dict[str, Any]) -> Dict[str, Any]:
    """The <2 KB last-stdout-line digest (the full result on the line
    before it, the compact parseable verdict last)."""
    import json

    compact = {
        "metric": "feedback_drill",
        "passed": summary.get("passed"),
        "baseline_auc": summary.get("baseline_auc"),
        "dip_auc": summary.get("dip_auc"),
        "recovered_auc": summary.get("recovered_auc"),
        "auc_dipped": summary.get("auc_dipped"),
        "retrain_triggered": summary.get("retrain_triggered"),
        "trigger_reason": summary.get("trigger_reason"),
        "gate_control_rejected": summary.get("gate_control_rejected"),
        "blend_unchanged_on_reject":
            summary.get("blend_unchanged_on_reject"),
        "promoted": summary.get("promoted"),
        "promoted_blend": summary.get("promoted_blend"),
        "labels_matched": (summary.get("label_join") or {}).get("matched"),
        "labeled_total": summary.get("labeled_total"),
        "virtual_duration_s": summary.get("virtual_duration_s"),
        "summary_of": "full result JSON on the preceding stdout line",
    }
    line = json.dumps(compact, separators=(",", ":"))
    while len(line.encode()) >= 2048:     # hard contract: < 2 KB, one line
        for victim in ("promoted_blend", "trigger_reason", "summary_of"):
            if compact.pop(victim, None) is not None:
                break
        else:
            compact = {"metric": "feedback_drill",
                       "passed": summary.get("passed")}
        line = json.dumps(compact, separators=(",", ":"))
    return compact
