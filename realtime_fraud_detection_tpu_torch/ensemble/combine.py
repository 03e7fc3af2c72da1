"""Ensemble combination: strategies, confidence, decisions, on tensors.

Port of the JAX package's ``ensemble/combine.py`` (``EnsemblePredictor``'s
math, ensemble_predictor.py:252-369): a (B, M) prediction matrix with a
validity mask for failed or shed branches.

- weighted_average: sum(w*p)/sum(w)
- voting: fraction of valid models with p > fraud_threshold
- stacking: confidence-weighted average, weighted average at zero confidence

Per-model confidence: min(1, 2*|p-0.5| * multiplier). Decision ladder: low
confidence -> REVIEW; p>=decline DECLINE; >=review REVIEW; >=monitor
APPROVE_WITH_MONITORING; else APPROVE.

``EnsembleParams`` carries its weights and multipliers twice: as tensors on
the scoring device and as host floats (``host_vectors``), which the fused
epilogue's by-value arguments and the explanations read, so no launch pulls
them from the card. The host copy is made where the values are known (from
the config, or from tensors on the CPU) and carried across ``to``; it
records the tensors it belongs to and their in-place version counters. On
the CPU a stale copy is read again; on the card ``host_vectors`` raises
rather than pull the tensors or hand back stale weights.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from realtime_fraud_detection_tpu_torch.features.rules import (
    APPROVE,
    APPROVE_WITH_MONITORING,
    DECLINE,
    REVIEW,
    risk_level_code,
)
from realtime_fraud_detection_tpu_torch.utils.config import (
    DECLINE_THRESHOLD_DEFAULT,
    DEFAULT_CONFIDENCE_MULTIPLIER,
    MODEL_CONFIDENCE_MULTIPLIER,
    MONITOR_THRESHOLD_DEFAULT,
    REVIEW_THRESHOLD_DEFAULT,
    VALID_STRATEGIES,
    Config,
)

STRATEGIES: tuple[str, ...] = VALID_STRATEGIES
WEIGHTED_AVERAGE, VOTING, STACKING = range(3)


def _host_record(weights: torch.Tensor, multipliers: torch.Tensor,
                 values: Tuple[List[float], List[float]]) -> tuple:
    """A host copy of (weights, multipliers) bound to the tensors it
    describes and their version counters at this moment."""
    return (weights, weights._version, multipliers, multipliers._version,
            values[0], values[1])


@dataclass
class EnsembleParams:
    """Ensemble parameters: tensors over the model axis plus the strategy
    and ladder thresholds, with the host copy of the tensors (``host``,
    see ``host_vectors``)."""

    weights: torch.Tensor                 # f32[M], normalised over enabled
    confidence_multipliers: torch.Tensor  # f32[M]
    strategy: int = WEIGHTED_AVERAGE
    fraud_threshold: float = 0.5
    confidence_threshold: float = 0.7
    decline_threshold: float = DECLINE_THRESHOLD_DEFAULT
    review_threshold: float = REVIEW_THRESHOLD_DEFAULT
    monitor_threshold: float = MONITOR_THRESHOLD_DEFAULT
    host: Optional[tuple] = field(default=None, repr=False, compare=False)

    def _host_current(self) -> bool:
        h, w, cm = self.host, self.weights, self.confidence_multipliers
        return (h is not None and h[0] is w and h[1] == w._version
                and h[2] is cm and h[3] == cm._version)

    def host_vectors(self) -> Tuple[List[float], List[float]]:
        """The weights and multipliers as host floats, never read from the
        card. The host copy is read afresh from tensors on the CPU when it
        is missing or stale; for tensors elsewhere a missing copy (tensors
        built there) or a stale one (the tensors replaced or written in
        place since it was made) raises rather than pull them or hand back
        old weights: a path that changes the blend builds new parameters
        (``from_config``, then ``to``)."""
        if not self._host_current():
            w, cm = self.weights, self.confidence_multipliers
            if w.device.type != "cpu" or cm.device.type != "cpu":
                raise ValueError(
                    "no current host copy of the blend weights and confidence "
                    f"multipliers on {w.device}: they were built there, replaced or "
                    "written in place; build new EnsembleParams (from_config, then "
                    ".to(device)) instead")
            self.host = _host_record(w, cm, (w.reshape(-1).tolist(),
                                             cm.reshape(-1).tolist()))
        return self.host[4], self.host[5]

    @classmethod
    def from_config(cls, config: Config,
                    model_names: Sequence[str]) -> "EnsembleParams":
        norm = config.normalized_weights()
        e = config.ensemble
        # the f32 values the tensors hold, known here without a device
        weights = np.float32([norm.get(n, 0.0) for n in model_names]).tolist()
        multipliers = np.float32([
            MODEL_CONFIDENCE_MULTIPLIER.get(n, DEFAULT_CONFIDENCE_MULTIPLIER)
            for n in model_names]).tolist()
        w = torch.tensor(weights, dtype=torch.float32)
        cm = torch.tensor(multipliers, dtype=torch.float32)
        return cls(
            weights=w, confidence_multipliers=cm,
            strategy=STRATEGIES.index(e.strategy),
            fraud_threshold=e.fraud_threshold,
            confidence_threshold=e.confidence_threshold,
            decline_threshold=e.decline_threshold,
            review_threshold=e.review_threshold,
            monitor_threshold=e.monitor_threshold,
            host=_host_record(w, cm, (weights, multipliers)),
        )

    def to(self, device) -> "EnsembleParams":
        on_cpu = (self.weights.device.type == "cpu"
                  and self.confidence_multipliers.device.type == "cpu")
        values = self.host_vectors() if on_cpu or self._host_current() else None
        w = self.weights.to(device)
        cm = self.confidence_multipliers.to(device)
        host = _host_record(w, cm, values) if values is not None else None
        return EnsembleParams(
            w, cm, self.strategy, self.fraud_threshold,
            self.confidence_threshold, self.decline_threshold,
            self.review_threshold, self.monitor_threshold, host=host)


def model_confidence(preds: torch.Tensor, multipliers: torch.Tensor) -> torch.Tensor:
    """Per-model confidence (ensemble_predictor.py:325-342). (B,M)->(B,M)."""
    return torch.clamp(torch.abs(preds - 0.5) * 2.0 * multipliers[None, :],
                       max=1.0)


def ensemble_decision(prob: torch.Tensor, confidence: torch.Tensor,
                      confidence_threshold: float = 0.7,
                      decline: float = DECLINE_THRESHOLD_DEFAULT,
                      review: float = REVIEW_THRESHOLD_DEFAULT,
                      monitor: float = MONITOR_THRESHOLD_DEFAULT) -> torch.Tensor:
    """Decision ladder (ensemble_predictor.py:344-356) -> i32 codes."""
    out = torch.full(prob.shape, APPROVE, dtype=torch.int32, device=prob.device)
    out = torch.where(prob >= monitor, APPROVE_WITH_MONITORING, out)
    out = torch.where(prob >= review, REVIEW, out)
    out = torch.where(prob >= decline, DECLINE, out)
    return torch.where(confidence < confidence_threshold, REVIEW, out).to(torch.int32)


def combine_predictions(preds: torch.Tensor, valid: torch.Tensor,
                        params: EnsembleParams,
                        with_confidences: bool = True) -> Dict[str, torch.Tensor]:
    """Combine (B, M) predictions under a bool[B, M] or bool[M] mask."""
    if valid.ndim == 1:
        valid = valid[None, :].expand(preds.shape)
    vf = valid.to(torch.float32)
    weights = params.weights.to(preds.device)
    conf = model_confidence(
        preds, params.confidence_multipliers.to(preds.device)) * vf
    w = weights[None, :] * vf

    def where(c, a, other):
        return torch.where(c, a, torch.as_tensor(other, dtype=a.dtype,
                                                 device=a.device))

    w_total = w.sum(dim=1)
    wa_prob = where(w_total > 0, (preds * w).sum(dim=1)
                    / torch.clamp(w_total, min=1e-12), 0.5)
    wa_conf = where(w_total > 0, (conf * w).sum(dim=1)
                    / torch.clamp(w_total, min=1e-12), 0.0)

    n_valid = vf.sum(dim=1)
    votes = ((preds > params.fraud_threshold) & valid).sum(dim=1).to(torch.float32)
    vote_prob = where(n_valid > 0, votes / torch.clamp(n_valid, min=1.0), 0.0)
    vote_conf = where(n_valid > 0, conf.sum(dim=1)
                      / torch.clamp(n_valid, min=1.0), 0.0)

    conf_total = conf.sum(dim=1)
    stack_prob = torch.where(conf_total > 0, (preds * conf).sum(dim=1)
                             / torch.clamp(conf_total, min=1e-12), wa_prob)
    stack_conf = torch.where(conf_total > 0,
                             conf_total / torch.clamp(n_valid, min=1.0), wa_conf)

    if params.strategy == WEIGHTED_AVERAGE:
        prob, confidence = wa_prob, wa_conf
    elif params.strategy == VOTING:
        prob, confidence = vote_prob, vote_conf
    else:
        prob, confidence = stack_prob, stack_conf

    out = {
        "fraud_probability": prob,
        "confidence": confidence,
        "decision": ensemble_decision(
            prob, confidence, params.confidence_threshold,
            decline=params.decline_threshold, review=params.review_threshold,
            monitor=params.monitor_threshold),
        "risk_level": risk_level_code(prob),
    }
    if with_confidences:
        out["model_confidences"] = conf
    return out


def blend_branch_scores(scores_by_branch: Dict[str, "object"],
                        weights_by_name: Dict[str, float],
                        strategy: str = "weighted_average"):
    """Host-side serving-parity blend over named branch score arrays (the
    JAX package's ``blend_branch_scores``, the recipe of the blend-selection
    protocol): branch scores laid out in ``MODEL_NAMES`` order, the weights
    mapped onto ``EnsembleParams``, validity = (weight > 0 and the branch
    produced scores), and the serving ``combine_predictions`` doing the
    math at any strategy. Returns the fraud probabilities as numpy."""
    import numpy as np

    from realtime_fraud_detection_tpu_torch.scoring.pipeline import MODEL_NAMES

    if strategy not in STRATEGIES:
        raise ValueError(
            f"strategy must be one of {STRATEGIES}, got {strategy!r}")
    params = EnsembleParams.from_config(Config(), list(MODEL_NAMES))
    params.weights = torch.tensor([float(weights_by_name.get(n, 0.0))
                                   for n in MODEL_NAMES], dtype=torch.float32)
    params.strategy = STRATEGIES.index(strategy)
    valid = np.asarray([weights_by_name.get(n, 0.0) > 0.0
                        and n in scores_by_branch for n in MODEL_NAMES])
    n_rows = len(next(iter(scores_by_branch.values())))
    preds = np.stack(
        [np.asarray(scores_by_branch.get(name, np.zeros(n_rows)), np.float32)
         for name in MODEL_NAMES], axis=1)
    out = combine_predictions(torch.from_numpy(preds), torch.from_numpy(valid),
                              params, with_confidences=False)
    return out["fraud_probability"].numpy()
