"""Retrain triggers, candidate training, and the promotion gate.

Port of the JAX package's ``feedback/policy.py``, the control loop's
decision layer:

- :class:`RetrainPolicy` watches the prequential snapshot and the drift
  monitor; it fires an auditable trigger on prequential degradation
  (sliding AUC falling under the fading-window baseline, or under an
  absolute floor) or on feature drift, with a cooldown and a minimum-labels
  floor so one noisy window cannot thrash the trainer.
- :class:`Retrainer` fits a candidate (GBDT + isolation forest on the host,
  and optionally the LSTM branch on ``torch.optim`` when the buffer stores
  history) on the labeled buffer's past, selects the combine strategy
  (weighted average or the stacked combiner) on a selection split, and
  leaves the most recent slice untouched for the gate. Its branch scores
  run the port's tree, forest and LSTM functions on ``device`` with TF32
  off (the GEMM-form trees and their gather form need exact f32 products).
- :class:`PromotionGate` is the non-regression gate in front of the serving
  blend: candidate scores against the scores that actually served (the
  buffer's as-served record) on the held-out most recent labels. A failed
  gate changes nothing anywhere.

The trees and the forest are bit-equal to the JAX trainers' on the same
buffer (``training/gbdt.py``, ``models/isolation_forest.py``). The LSTM's
initial weights come from ``Retrainer.lstm_init`` when given (the JAX
package draws them from ``PRNGKey(seed)``, which the port cannot
reproduce), else from the port's seeded NumPy initialiser.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from realtime_fraud_detection_tpu_torch.feedback.prequential import sliding_auc

__all__ = ["RetrainPolicy", "Retrainer", "PromotionGate", "blend_scores"]


@dataclasses.dataclass
class RetrainPolicy:
    """Degradation / drift watcher -> retrain triggers."""

    auc_drop: float = 0.08          # sliding below fading by this much
    auc_floor: float = 0.0          # absolute sliding-AUC alarm (0 = off)
    min_labels: int = 300           # labeled examples before any trigger
    cooldown_s: float = 600.0       # stream time between triggers
    use_drift: bool = True

    last_trigger_ts: float = -math.inf

    def ready(self, labeled_total: int, now: float) -> bool:
        """The cheap pre-check (a counter and the cooldown): callers on the
        scoring path gate the snapshot and drift report on it."""
        return (labeled_total >= self.min_labels
                and now - self.last_trigger_ts >= self.cooldown_s)

    def observe(self, snapshot: Mapping[str, Any], drift_report: Any,
                now: float) -> Optional[Dict[str, Any]]:
        """One policy evaluation; returns a trigger event dict or None."""
        if not self.ready(int(snapshot.get("labeled_total", 0)), now):
            return None
        s_auc = float(snapshot.get("sliding", {}).get("auc", float("nan")))
        f_auc = float(snapshot.get("fading", {}).get("auc", float("nan")))
        reason = None
        details: Dict[str, Any] = {"sliding_auc": s_auc, "fading_auc": f_auc}
        if not math.isnan(s_auc):
            if (not math.isnan(f_auc)
                    and f_auc - s_auc >= self.auc_drop):
                reason = "prequential_auc_drop"
                details["drop"] = round(f_auc - s_auc, 4)
            elif self.auc_floor > 0.0 and s_auc < self.auc_floor:
                reason = "prequential_auc_floor"
        if reason is None and self.use_drift and drift_report is not None \
                and getattr(drift_report, "drifted", False):
            reason = "feature_drift"
            details["max_psi"] = float(drift_report.max_psi)
            details["top_features"] = list(drift_report.top_features[:5])
        if reason is None:
            return None
        self.last_trigger_ts = now
        return {"type": "retrain_trigger", "reason": reason, "ts": now,
                **details}


@torch.no_grad()
def _branch_scores(candidate: Mapping[str, Any],
                   arrays: Mapping[str, np.ndarray], sl: slice,
                   device: torch.device) -> Dict[str, np.ndarray]:
    """Per-branch candidate probabilities on a buffer slice, computed on
    ``device`` and returned as host arrays."""
    from realtime_fraud_detection_tpu_torch.models.isolation_forest import (
        iforest_predict,
    )
    from realtime_fraud_detection_tpu_torch.models.trees import (
        tree_ensemble_predict,
    )
    from realtime_fraud_detection_tpu_torch.training.neural import exact_f32

    x = torch.as_tensor(np.ascontiguousarray(arrays["x"][sl])).to(device)
    with exact_f32():
        out = {
            "xgboost_primary": tree_ensemble_predict(
                candidate["trees"].to(device), x).cpu().numpy(),
            "isolation_forest": iforest_predict(
                candidate["iforest"].to(device), x).cpu().numpy(),
        }
        if candidate.get("lstm") is not None and "history" in arrays:
            from realtime_fraud_detection_tpu_torch.models.lstm import lstm_logits

            lstm = {k: v.to(device) for k, v in candidate["lstm"].items()}
            seq = torch.as_tensor(np.clip(arrays["history"][sl], -10, 10)).to(device)
            lens = torch.as_tensor(arrays["history_len"][sl]).to(device)
            z = lstm_logits(lstm, seq, lens).cpu().numpy()
            out["lstm_sequential"] = 1.0 / (1.0 + np.exp(-z))
    return out


def blend_scores(branch_scores: Mapping[str, np.ndarray],
                 weights: Mapping[str, float],
                 strategy: str = "weighted_average") -> np.ndarray:
    """Serving-parity combine of candidate branch scores: the shared
    ``ensemble/combine.py blend_branch_scores`` recipe at any strategy,
    the stacked combiner included."""
    from realtime_fraud_detection_tpu_torch.ensemble.combine import (
        blend_branch_scores,
    )

    return blend_branch_scores(dict(branch_scores), dict(weights), strategy)


@dataclasses.dataclass
class Retrainer:
    """Candidate trainer over the labeled buffer.

    Splits the time-ordered buffer into train (the oldest ``1 - select_frac
    - holdout_frac``), strategy selection, and the gate's holdout (the most
    recent); the holdout is never seen by training or selection.
    """

    n_trees: int = 48
    depth: int = 5
    iforest_trees: int = 60
    seed: int = 11
    select_frac: float = 0.2
    holdout_frac: float = 0.2
    train_neural: bool = False
    neural_hidden: int = 64
    neural_epochs: int = 2
    try_stacking: bool = True
    # where the branch scores and the LSTM's training run
    device: str = "cuda"
    # the LSTM's initial parameters (None: the port's seeded initialiser)
    lstm_init: Optional[Dict[str, Any]] = None

    def retrain(self, arrays: Mapping[str, np.ndarray],
                weights: Optional[Mapping[str, float]] = None,
                label_noise_seed: Optional[int] = None) -> Dict[str, Any]:
        """Fit a candidate; returns the candidate dict (models + blend +
        per-split evidence + the holdout slice for the gate).

        ``label_noise_seed`` permutes the training labels: the drill's
        negative control, a candidate the gate must catch.
        """
        from realtime_fraud_detection_tpu_torch.models.isolation_forest import (
            IsolationForestTrainer,
        )
        from realtime_fraud_detection_tpu_torch.training.gbdt import GBDTTrainer
        from realtime_fraud_detection_tpu_torch.training.neural import (
            training_device,
        )

        device = training_device(self.device)
        n = len(arrays["y"])
        n_hold = max(int(n * self.holdout_frac), 1)
        n_sel = max(int(n * self.select_frac), 1)
        n_train = n - n_hold - n_sel
        if n_train < 50:
            raise ValueError(
                f"labeled buffer too small to retrain: {n} examples "
                f"({n_train} would remain for training)")
        tr, sel, hold = (slice(0, n_train), slice(n_train, n_train + n_sel),
                         slice(n_train + n_sel, n))
        y_tr = arrays["y"][tr]
        if label_noise_seed is not None:
            y_tr = np.random.default_rng(label_noise_seed).permutation(y_tr)
        trees = GBDTTrainer(n_estimators=self.n_trees, max_depth=self.depth,
                            seed=self.seed).fit(arrays["x"][tr], y_tr)
        normals = arrays["x"][tr][y_tr < 0.5][:6000]
        iforest = IsolationForestTrainer(
            n_estimators=self.iforest_trees, seed=self.seed + 1).fit(normals)
        candidate: Dict[str, Any] = {"trees": trees, "iforest": iforest,
                                     "lstm": None}
        if self.train_neural and "history" in arrays:
            candidate["lstm"] = self._train_lstm(arrays, tr, y_tr, device)

        if weights is None:
            from realtime_fraud_detection_tpu_torch.utils.config import Config

            weights = Config().normalized_weights()
        cand_names = ["xgboost_primary", "isolation_forest"] + (
            ["lstm_sequential"] if candidate["lstm"] is not None else [])
        blend_w = {nm: float(weights.get(nm, 0.0)) or 0.05
                   for nm in cand_names}

        # strategy selection on the selection split: weighted average vs the
        # stacked combiner, the candidate's one free structural choice
        sel_scores = _branch_scores(candidate, arrays, sel, device)
        y_sel = arrays["y"][sel]
        select_auc = {"weighted_average": sliding_auc(
            y_sel, blend_scores(sel_scores, blend_w, "weighted_average"))}
        strategy = "weighted_average"
        if self.try_stacking:
            select_auc["stacking"] = sliding_auc(
                y_sel, blend_scores(sel_scores, blend_w, "stacking"))
            if not math.isnan(select_auc["stacking"]) and (
                    math.isnan(select_auc["weighted_average"])
                    or select_auc["stacking"]
                    > select_auc["weighted_average"]):
                strategy = "stacking"

        hold_scores = _branch_scores(candidate, arrays, hold, device)
        candidate.update({
            "weights": blend_w,
            "strategy": strategy,
            "select_auc": {k: (None if math.isnan(v) else round(v, 4))
                           for k, v in select_auc.items()},
            "trained_on": n_train,
            "label_noise": label_noise_seed is not None,
            "holdout": {
                "y": arrays["y"][hold],
                "as_served": arrays["score"][hold],
                "candidate": blend_scores(hold_scores, blend_w, strategy),
                "n": n - (n_train + n_sel),
            },
        })
        return candidate

    def _train_lstm(self, arrays, tr: slice, y_tr: np.ndarray,
                    device: torch.device) -> Dict[str, torch.Tensor]:
        from realtime_fraud_detection_tpu_torch.models.lstm import (
            init_lstm_params,
            lstm_logits,
        )
        from realtime_fraud_detection_tpu_torch.training.neural import (
            NeuralTrainer,
            weighted_bce_loss,
        )

        pos_w = float((1.0 - y_tr.mean()) / max(float(y_tr.mean()), 1e-6))
        params = self.lstm_init
        if params is None:
            params = init_lstm_params(np.random.default_rng(self.seed),
                                      arrays["x"].shape[-1], self.neural_hidden)

        def loss(p, inputs, y):
            seq, length = inputs
            return weighted_bce_loss(lstm_logits(p, seq, length), y, pos_w)

        return NeuralTrainer(epochs=self.neural_epochs, seed=self.seed,
                             device=str(device)).train(
            params, loss,
            (np.clip(arrays["history"][tr], -10, 10),
             arrays["history_len"][tr]), y_tr)


@dataclasses.dataclass
class PromotionGate:
    """Non-regression gate on the held-out most recent labels."""

    auc_margin: float = 0.0        # candidate must beat served AUC by this
    recall_tolerance: float = 0.02  # allowed recall give-back at threshold
    min_positives: int = 12
    operating_threshold: float = 0.5

    def evaluate(self, candidate: Mapping[str, Any]) -> Dict[str, Any]:
        hold = candidate["holdout"]
        y = np.asarray(hold["y"], np.float64)
        served = np.asarray(hold["as_served"], np.float64)
        cand = np.asarray(hold["candidate"], np.float64)
        pos = y > 0.5
        n_pos = int(pos.sum())
        verdict: Dict[str, Any] = {
            "type": "gate_verdict",
            "holdout_n": int(len(y)),
            "holdout_positives": n_pos,
            "strategy": candidate.get("strategy"),
        }
        if n_pos < self.min_positives:
            verdict.update(passed=False,
                           reason=f"insufficient labeled fraud in holdout "
                                  f"({n_pos} < {self.min_positives})")
            return verdict
        auc_served = sliding_auc(y, served)
        auc_cand = sliding_auc(y, cand)

        def recall(s):
            flag = s >= self.operating_threshold
            return float((flag & pos).sum()) / n_pos

        rec_served, rec_cand = recall(served), recall(cand)
        verdict.update(
            auc_as_served=round(auc_served, 4),
            auc_candidate=round(auc_cand, 4),
            recall_as_served=round(rec_served, 4),
            recall_candidate=round(rec_cand, 4),
        )
        if math.isnan(auc_cand) or auc_cand < auc_served + self.auc_margin:
            verdict.update(passed=False, reason="auc_regression")
            return verdict
        if rec_cand < rec_served - self.recall_tolerance:
            verdict.update(passed=False, reason="recall_regression")
            return verdict
        verdict.update(passed=True, reason="non_regression")
        return verdict
