"""Rule-based fraud score and the decision / risk ladders, on tensors.

Port of the JAX package's ``features/rules.py`` (``rule_score``,
``risk_level_code``, the constants and the host-side scalar twins the
serving A/B path recombines with), itself a vectorised
``TransactionProcessor.applyFraudDetectionRules``
(TransactionProcessor.java:327-439).
"""

from __future__ import annotations

import numpy as np
import torch

from realtime_fraud_detection_tpu_torch.features.schema import TransactionBatch
from realtime_fraud_detection_tpu_torch.utils.config import (
    DECLINE_THRESHOLD_DEFAULT,
    MONITOR_THRESHOLD_DEFAULT,
    REVIEW_THRESHOLD_DEFAULT,
)

DECISIONS: tuple[str, ...] = (
    "APPROVE", "APPROVE_WITH_MONITORING", "REVIEW", "DECLINE",
)
APPROVE, APPROVE_WITH_MONITORING, REVIEW, DECLINE = range(4)

RISK_LEVEL_NAMES: tuple[str, ...] = (
    "VERY_LOW", "LOW", "MEDIUM", "HIGH", "CRITICAL",
)

# ensemble risk-band rungs (ensemble_predictor.py:358-369)
RISK_LEVEL_THRESHOLDS: tuple[float, ...] = (0.3, 0.6, 0.8, 0.95)


def rule_score(b: TransactionBatch) -> torch.Tensor:
    """Rule-based fraud score in [0, 1] (TransactionProcessor.java:327-439).
    Columns are tensors on one device; returns f32[B] there."""
    def f32(x):
        return x.to(torch.float32)

    score = 0.5 * b.prior_fraud_score

    # user component; unknown user -> minimal profile: 0.5*0.2 + 0.1 + 0.15
    user_known = (
        b.user_risk_score * 0.2
        + 0.1 * f32(b.account_age_days < 30)
        + 0.15 * f32(~b.user_verified)
    )
    score = score + torch.where(b.has_user, user_known,
                                torch.full_like(user_known, 0.35))

    # merchant component; unknown merchant -> minimal profile: 0.1
    rate = b.merchant_fraud_rate
    merch_known = (
        0.2 * f32(b.merchant_risk_code == 2)
        + 0.1 * f32(b.merchant_risk_code == 1)
        + 0.4 * f32(b.merchant_blacklisted)
        + torch.where(rate > 0.05, rate * 2.0, torch.zeros_like(rate))
        + 0.15 * f32(b.merchant_high_risk_category)
    )
    score = score + torch.where(b.has_merchant, merch_known,
                                torch.full_like(merch_known, 0.1))

    # feature flags (:415-439)
    large_amount = b.has_user & (b.user_avg_amount > 0) & (
        b.amount / torch.clamp(b.user_avg_amount, min=1e-9) > 5.0)
    new_device = (b.has_txn_fingerprint & b.has_user & b.has_device_list
                  & ~b.known_device)
    hour = b.hour_of_day
    unusual_hour = (hour <= 5) | (hour >= 23)
    outside_hours = b.has_merchant & b.has_op_hours & ~(
        (hour >= b.merchant_op_start) & (hour <= b.merchant_op_end))
    score = (score
             + 0.15 * f32(large_amount)
             + 0.1 * f32(new_device)
             + 0.05 * f32(unusual_hour)
             + 0.1 * f32(outside_hours))
    return torch.clamp(score, 0.0, 1.0)


def risk_level_code(prob: torch.Tensor) -> torch.Tensor:
    """Five-level ensemble risk ladder -> i32 codes."""
    code = torch.zeros(prob.shape, dtype=torch.int32, device=prob.device)
    for t in RISK_LEVEL_THRESHOLDS:
        code += (prob >= t).to(torch.int32)
    return code


def risk_level_codes_np(probs) -> np.ndarray:
    """Host twin of ``risk_level_code`` over a numpy array."""
    probs = np.asarray(probs)
    code = np.zeros(probs.shape, np.int32)
    for t in RISK_LEVEL_THRESHOLDS:
        code += (probs >= t).astype(np.int32)
    return code


def ensemble_decision_name(prob: float, confidence: float,
                           confidence_threshold: float = 0.7,
                           decline: float = DECLINE_THRESHOLD_DEFAULT,
                           review: float = REVIEW_THRESHOLD_DEFAULT,
                           monitor: float = MONITOR_THRESHOLD_DEFAULT) -> str:
    """Host-side scalar twin of the device decision ladder
    (ensemble_predictor.py:344-356); callers serving configured rungs pass
    the same values the device ladder reads."""
    if confidence < confidence_threshold:
        return DECISIONS[REVIEW]
    if prob >= decline:
        return DECISIONS[DECLINE]
    if prob >= review:
        return DECISIONS[REVIEW]
    if prob >= monitor:
        return DECISIONS[APPROVE_WITH_MONITORING]
    return DECISIONS[APPROVE]


def risk_level_name(prob: float) -> str:
    """Host-side scalar twin of ``risk_level_code``."""
    return RISK_LEVEL_NAMES[int(sum(prob >= t for t in RISK_LEVEL_THRESHOLDS))]


def model_confidence_value(prob: float, multiplier: float) -> float:
    """Host-side scalar twin of one branch's confidence
    (ensemble_predictor.py:325-342)."""
    return min(1.0, abs(prob - 0.5) * 2.0 * multiplier)
