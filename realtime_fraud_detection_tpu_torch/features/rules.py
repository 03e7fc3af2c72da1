"""Rule-based fraud score and the decision / risk ladders, on tensors.

Port of the JAX package's ``features/rules.py`` (``rule_score``, the
Flink job's ``make_decision`` ladder, ``risk_level_code``, the constants
and the host-side scalar twins the serving A/B path recombines with),
itself a vectorised
``TransactionProcessor.applyFraudDetectionRules``
(TransactionProcessor.java:327-439), and of its enrichment pair
``enrichment_score`` / ``blend_enrichment`` (FeatureEnrichmentProcessor,
the stream job's ``JobConfig.enable_enrichment``). Every function runs on
the device of the tensors it is given.
"""

from __future__ import annotations

import numpy as np
import torch

from realtime_fraud_detection_tpu_torch.features.extract import FEATURE_NAMES
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
VERY_LOW, LOW, MEDIUM, HIGH, CRITICAL = range(5)

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


def make_decision(score: torch.Tensor, blacklisted: torch.Tensor,
                  fraud_threshold: float = 0.7
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decision + risk-level codes (TransactionProcessor.java:444-473).

    Ladder: >=0.9 DECLINE/CRITICAL, >=threshold REVIEW/HIGH, >=0.5
    APPROVE/MEDIUM, else APPROVE/LOW; blacklisted merchants override to
    DECLINE/CRITICAL. Returns (decision i32[B], risk_level i32[B]) on the
    device of ``score``.
    """
    def code(c):
        return torch.full_like(score, c, dtype=torch.int32)

    decision = torch.where(score >= 0.9, code(DECLINE), torch.where(
        score >= fraud_threshold, code(REVIEW), code(APPROVE)))
    risk = torch.where(score >= 0.9, code(CRITICAL), torch.where(
        score >= fraud_threshold, code(HIGH),
        torch.where(score >= 0.5, code(MEDIUM), code(LOW))))
    blacklisted = blacklisted.to(torch.bool)
    return (torch.where(blacklisted, code(DECLINE), decision),
            torch.where(blacklisted, code(CRITICAL), risk))


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


# ---------------------------------------------------------------- enrichment
def _fma(x: torch.Tensor, weight: float, acc: torch.Tensor) -> torch.Tensor:
    """f32 ``x * weight + acc`` rounded once, as a fused multiply-add: the
    product of two f32 values is exact in f64, so the f64 sum rounded to f32
    is the fused result. The reference's compiled weighted sums fuse each
    product into the running sum this way; rounding the product first would
    move a score by an ulp, enough to flip a ladder rung at a cut."""
    w = float(torch.tensor(weight, dtype=torch.float32))
    return (x.to(torch.float64) * w + acc.to(torch.float64)).to(torch.float32)


def enrichment_score(features: torch.Tensor) -> torch.Tensor:
    """Category-weighted feature score over the 64-wide feature matrix
    (FeatureEnrichmentProcessor.calculateFeatureBasedFraudScore,
    FeatureEnrichmentProcessor.java:122-344): six category sub-scores
    weighted .2/.1/.25/.2/.15/.1; only the weighted sum is clipped to
    [0, 1]. The terms are added in the JAX function's order, in f32, the
    weighted category sum with fused multiply-adds (``_fma``)."""
    f = features.to(torch.float32)

    def col(name: str) -> torch.Tensor:
        return f[:, FEATURE_NAMES.index(name)]

    def on(cond: torch.Tensor) -> torch.Tensor:
        return cond.to(torch.float32)

    def pick(cond: torch.Tensor, a: float, b) -> torch.Tensor:
        return torch.where(cond, torch.full_like(cond, a, dtype=torch.float32), b)

    # amount (x0.2, :157-179): very large / micro amount categories
    amount_cat = col("amount_category")
    zero = torch.zeros_like(amount_cat)
    amount = (0.3 * on(col("is_large_for_user") > 0)
              + 0.1 * on(col("is_round_100") > 0)
              + pick(amount_cat >= 4, 0.2, pick(amount_cat < 1, 0.1, zero)))
    # temporal (x0.1, :184-206)
    temporal = (0.2 * on(col("is_night_time") > 0)
                + 0.15 * on(col("in_user_preferred_time") <= 0)
                + 0.1 * on((col("is_weekend") > 0)
                           & (col("weekend_activity_factor") < 0.3)))
    # user behaviour (x0.25, :211-238)
    user = (pick(col("is_very_new_account") > 0, 0.4,
                 pick(col("is_new_account") > 0, 0.2, zero))
            + 0.3 * on(col("is_kyc_verified") <= 0)
            + col("user_risk_score") * 0.5)
    # merchant risk (x0.2, :243-277)
    merchant = (0.8 * on(col("is_blacklisted_merchant") > 0)
                + 0.3 * on(col("is_high_risk_category") > 0)
                + col("merchant_fraud_rate") * 2.0
                + 0.2 * on(col("suspicious_merchant_name") > 0)
                + 0.15 * on(col("within_merchant_hours") <= 0))
    # velocity (x0.15, :282-307)
    velocity = (0.6 * on(col("high_velocity_5min") > 0)
                + 0.4 * on(col("high_velocity_1hour") > 0)
                + 0.2 * on(col("velocity_5min_count") > 3)
                + 0.15 * on(col("velocity_1hour_count") > 10))
    # device / network (x0.1, :312-334)
    device = (0.3 * on(col("is_new_device") > 0)
              + col("ip_risk_score")
              + 0.2 * on(col("suspicious_user_agent") > 0))
    score = _fma(temporal, 0.1, amount * 0.2)
    for term, weight in ((user, 0.25), (merchant, 0.2), (velocity, 0.15),
                         (device, 0.1)):
        score = _fma(term, weight, score)
    return torch.clamp(score, 0.0, 1.0)


def blend_enrichment(prior_score: torch.Tensor, features: torch.Tensor):
    """60/40 blend of the prior score with ``enrichment_score``, then the
    enrichment ladder (FeatureEnrichmentProcessor.java:84-90, 341-367):
    >=0.95 DECLINE/CRITICAL, >=0.8 REVIEW/HIGH, >=0.6 REVIEW/MEDIUM, >=0.3
    APPROVE/LOW, else APPROVE/VERY_LOW. Returns (blended f32[B], decision
    i32[B], risk_level i32[B]) on the inputs' device."""
    blended = torch.clamp(
        _fma(prior_score.to(torch.float32), 0.6, enrichment_score(features) * 0.4),
        0.0, 1.0)
    decision = torch.where(
        blended >= 0.95, DECLINE,
        torch.where(blended >= 0.6, REVIEW, APPROVE)).to(torch.int32)
    return blended, decision, risk_level_code(blended)
