"""A/B experiments over scorer variants: sticky routing and evaluation.

Port of the JAX package's ``testing/ab.py`` (the reference's
ABTestManager, ab_testing.py:49-427): hash-sticky variant assignment per
user, traffic-split validation, per-arm online metrics (precision, recall,
F1 against labels when the producer supplies them) and a pooled
two-proportion z-test on the arms' detection rates. A variant that changes
only the ensemble weights is evaluated on the host over the per-branch
predictions the card already returned (``apply_weight_overrides``): the
same weighted average, confidence, decision ladder and risk level the
device combine computes, so an experiment costs no extra device work.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import threading
import time
from typing import Any, Dict, List, Mapping, Optional

from realtime_fraud_detection_tpu_torch.utils.config import (
    DECLINE_THRESHOLD_DEFAULT,
    MONITOR_THRESHOLD_DEFAULT,
    REVIEW_THRESHOLD_DEFAULT,
)

__all__ = ["Variant", "VariantStats", "Experiment", "ABTestManager",
           "apply_weight_overrides"]


def apply_weight_overrides(
        model_predictions: Mapping[str, float],
        base_weights: Mapping[str, float],
        overrides: Mapping[str, float],
        confidence_threshold: float = 0.7,
        decline_threshold: float = DECLINE_THRESHOLD_DEFAULT,
        review_threshold: float = REVIEW_THRESHOLD_DEFAULT,
        monitor_threshold: float = MONITOR_THRESHOLD_DEFAULT) -> Optional[Dict[str, Any]]:
    """Re-combine per-model predictions under variant weight overrides.

    The fused scorer returns every branch's prediction, so a variant that
    only changes ensemble weights can be evaluated host-side as the same
    weighted average the device combine computes (ensemble_predictor.py:
    263-284 semantics) — zero extra device work per arm. The full downstream
    outcome is recomputed so the served record stays internally consistent:
    confidence (:325-342), decision ladder (:344-356), risk level (:358-369).
    Returns None when no overridden model actually produced a prediction."""
    from realtime_fraud_detection_tpu_torch.features.rules import (
        ensemble_decision_name,
        model_confidence_value,
        risk_level_name,
    )
    from realtime_fraud_detection_tpu_torch.utils.config import (
        DEFAULT_CONFIDENCE_MULTIPLIER,
        MODEL_CONFIDENCE_MULTIPLIER,
    )

    weights = {k: float(v) for k, v in base_weights.items()}
    weights.update({k: float(v) for k, v in overrides.items()})
    num = den = conf_num = 0.0
    for name, pred in model_predictions.items():
        w = weights.get(name, 0.0)
        p = float(pred)
        mult = MODEL_CONFIDENCE_MULTIPLIER.get(name, DEFAULT_CONFIDENCE_MULTIPLIER)
        num += w * p
        conf_num += w * model_confidence_value(p, mult)
        den += w
    if den <= 0.0:
        return None
    prob = num / den
    confidence = conf_num / den
    return {"fraud_probability": prob, "confidence": confidence,
            "decision": ensemble_decision_name(
                prob, confidence, confidence_threshold,
                decline=decline_threshold, review=review_threshold,
                monitor=monitor_threshold),
            "risk_level": risk_level_name(prob)}


@dataclasses.dataclass
class Variant:
    """One arm of an experiment. ``overrides`` patches the scorer config
    (model weights / strategy / enabled set)."""

    name: str
    traffic: float                       # fraction in [0, 1]
    overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)


class VariantStats:
    """Online confusion-matrix accumulator for one arm."""

    def __init__(self) -> None:
        self.assigned = 0
        self.predictions = 0
        self.score_sum = 0.0
        self.tp = self.fp = self.tn = self.fn = 0

    def record(self, fraud_score: float, flagged: bool,
               actual_fraud: Optional[bool]) -> None:
        self.predictions += 1
        self.score_sum += fraud_score
        if actual_fraud is None:
            return
        if flagged and actual_fraud:
            self.tp += 1
        elif flagged and not actual_fraud:
            self.fp += 1
        elif not flagged and actual_fraud:
            self.fn += 1
        else:
            self.tn += 1

    @property
    def labeled(self) -> int:
        return self.tp + self.fp + self.tn + self.fn

    def metrics(self) -> Dict[str, float]:
        """Precision/recall/F1 (ab_testing.py per-variant metrics analog)."""
        p = self.tp / (self.tp + self.fp) if self.tp + self.fp else 0.0
        r = self.tp / (self.tp + self.fn) if self.tp + self.fn else 0.0
        f1 = 2 * p * r / (p + r) if p + r else 0.0
        return {
            "assigned": self.assigned,
            "predictions": self.predictions,
            "labeled": self.labeled,
            "avg_fraud_score": (self.score_sum / self.predictions
                                if self.predictions else 0.0),
            "precision": p,
            "recall": r,
            "f1": f1,
            "flag_rate": ((self.tp + self.fp) / self.labeled
                          if self.labeled else 0.0),
        }


@dataclasses.dataclass
class Experiment:
    name: str
    variants: List[Variant]
    salt: str = ""
    started_at: float = dataclasses.field(default_factory=time.time)
    active: bool = True

    def __post_init__(self) -> None:
        for v in self.variants:
            if not 0.0 <= v.traffic <= 1.0:
                raise ValueError(
                    f"variant {v.name!r} traffic {v.traffic} not in [0, 1]")
        total = sum(v.traffic for v in self.variants)
        if not math.isclose(total, 1.0, abs_tol=1e-6):
            raise ValueError(
                f"variant traffic must sum to 1.0, got {total:.6f}")
        if len({v.name for v in self.variants}) != len(self.variants):
            raise ValueError("duplicate variant names")


class ABTestManager:
    """Create experiments, stickily route users, evaluate arms."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._experiments: Dict[str, Experiment] = {}
        self._stats: Dict[str, Dict[str, VariantStats]] = {}

    # ------------------------------------------------------------ lifecycle
    def create_experiment(self, name: str, variants: List[Variant],
                          salt: str = "") -> Experiment:
        exp = Experiment(name=name, variants=variants, salt=salt)
        with self._lock:
            if name in self._experiments:
                raise ValueError(f"experiment {name!r} already exists")
            self._experiments[name] = exp
            self._stats[name] = {v.name: VariantStats() for v in variants}
        return exp

    def experiment_from_artifact(self, name: str, artifact_path: str,
                                 traffic: float = 0.5,
                                 salt: str = "") -> Experiment:
        """Canary a measured blend: control = current production weights
        (no overrides), treatment = a quality-eval artifact's
        selected_blend at ``traffic`` share. The treatment rides variant
        weight overrides, so serving re-weights host-side over the
        already-returned per-branch predictions (apply_weight_overrides) —
        zero extra device work per arm. Branches outside the artifact's
        blend are overridden to weight 0, matching the artifact's
        semantics exactly. NOTE: serving can only re-weight branches that
        actually computed a prediction — canarying a blend that
        re-includes a branch disabled in the current deployment requires
        enabling it first (/reload-models with the artifact); the serving
        endpoint enforces this."""
        from realtime_fraud_detection_tpu_torch.scoring.pipeline import MODEL_NAMES
        from realtime_fraud_detection_tpu_torch.utils.config import Config

        weights = Config.load_selected_blend_weights(artifact_path)
        strategy = Config.load_selected_blend_strategy(artifact_path)
        if strategy not in (None, "weighted_average"):
            # host-side variant evaluation recombines the returned branch
            # predictions as a weighted average; a stacking/voting artifact
            # measured a DIFFERENT combine, so the canary arm would not be
            # serving what the artifact promises — deploy such artifacts
            # via /reload-models (the device combine honors the strategy)
            raise ValueError(
                f"artifact blend uses strategy {strategy!r}, which host-"
                f"side re-weighting cannot emulate; canary it via "
                f"/reload-models instead")
        unknown = [n for n in weights if n not in MODEL_NAMES]
        if unknown:
            raise ValueError(
                f"artifact names unknown model(s) {unknown}; "
                f"known: {list(MODEL_NAMES)}")
        overrides = {"weights": {n: weights.get(n, 0.0)
                                 for n in MODEL_NAMES}}
        return self.create_experiment(name, [
            Variant("control", 1.0 - traffic),
            Variant("artifact", traffic, overrides=overrides),
        ], salt=salt)

    def stop_experiment(self, name: str) -> None:
        with self._lock:
            self._experiments[name].active = False

    def active_experiments(self) -> List[str]:
        with self._lock:
            return [n for n, e in self._experiments.items() if e.active]

    # -------------------------------------------------------------- routing
    def assign(self, experiment: str, user_id: str) -> Variant:
        """Sticky hash assignment (ab_testing.py:49-105 semantics): the same
        user always lands in the same arm for a given experiment+salt."""
        exp = self._experiments[experiment]
        digest = hashlib.sha256(
            f"{experiment}:{exp.salt}:{user_id}".encode()).digest()
        u = int.from_bytes(digest[:8], "big") / 2 ** 64
        acc = 0.0
        chosen = exp.variants[-1]
        for v in exp.variants:
            acc += v.traffic
            if u < acc:
                chosen = v
                break
        with self._lock:
            self._stats[experiment][chosen.name].assigned += 1
        return chosen

    # ------------------------------------------------------------ recording
    def record_prediction(self, experiment: str, variant: str,
                          fraud_score: float, flagged: bool,
                          actual_fraud: Optional[bool] = None) -> None:
        with self._lock:
            self._stats[experiment][variant].record(
                fraud_score, flagged, actual_fraud)

    # ------------------------------------------------------------ analysis
    def results(self, experiment: str) -> Dict[str, Any]:
        exp = self._experiments[experiment]
        with self._lock:
            # snapshot everything under one lock: metrics() and the
            # significance test must see a consistent confusion matrix
            per_variant = {
                name: s.metrics()
                for name, s in self._stats[experiment].items()
            }
            sig = None
            if len(exp.variants) == 2:
                a, b = (exp.variants[0].name, exp.variants[1].name)
                sig = self._two_proportion_test(
                    self._stats[experiment][a], self._stats[experiment][b])
        out: Dict[str, Any] = {
            "experiment": experiment,
            "active": exp.active,
            "running_seconds": time.time() - exp.started_at,
            "variants": per_variant,
        }
        if sig is not None:
            out["significance"] = sig
            out["control"] = exp.variants[0].name
            out["treatment"] = exp.variants[1].name
        return out

    @staticmethod
    def _two_proportion_test(a: VariantStats, b: VariantStats,
                             alpha: float = 0.05) -> Dict[str, Any]:
        """Pooled two-proportion z-test on per-arm detection rate (recall).

        Pooled-variance z statistic; two-sided p via the normal CDF. This is
        the statistically sound version of ab_testing.py:314-372.
        """
        na, nb = a.tp + a.fn, b.tp + b.fn          # labeled positives per arm
        if na < 5 or nb < 5:
            return {"computed": False, "reason": "insufficient labeled fraud"}
        pa, pb = a.tp / na, b.tp / nb
        pooled = (a.tp + b.tp) / (na + nb)
        se = math.sqrt(pooled * (1 - pooled) * (1 / na + 1 / nb))
        if se == 0:
            return {"computed": False, "reason": "zero variance"}
        z = (pb - pa) / se
        p_value = 2 * (1 - 0.5 * (1 + math.erf(abs(z) / math.sqrt(2))))
        return {
            "computed": True,
            "recall_control": pa,
            "recall_treatment": pb,
            "effect": pb - pa,
            "z": z,
            "p_value": p_value,
            "significant": p_value < alpha,
        }

    # -------------------------------------------------------------- serving
    def route_config_overrides(self, experiment: str,
                               user_id: str) -> Mapping[str, Any]:
        """Overrides dict the serving layer applies to the scorer for this
        user's request (weights / strategy / enabled models)."""
        exp = self._experiments.get(experiment)
        if exp is None or not exp.active:
            return {}
        return self.assign(experiment, user_id).overrides
