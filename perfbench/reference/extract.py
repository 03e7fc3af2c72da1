"""Frozen copy for the benchmark's plain reference: ``realtime_fraud_detection_tpu_torch/features/extract.py`` as of
the commit that added ``perfbench/``. It imports nothing of the program;
the program may change, the yardstick does not.

The 64-feature contract on tensors.

Port of the JAX package's ``features/extract.py extract_features``
(``FeatureExtractor.extractAllFeatures``, FeatureExtractor.java:50-87):
``TransactionBatch -> f32[B, 64]`` in the same canonical column order. It
runs on whichever device the batch's columns lie on; ``extract_features_host``
runs it on the CPU over a numpy batch, as host assembly does.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from perfbench.reference.schema import TransactionBatch

FEATURE_NAMES: tuple[str, ...] = (
    # amount (12)
    "amount", "amount_log", "amount_sqrt", "is_round_amount", "is_round_10",
    "is_round_100", "amount_to_user_avg_ratio", "amount_deviation_zscore",
    "is_large_for_user", "amount_to_merchant_avg_ratio", "is_large_for_merchant",
    "amount_category",
    # temporal (8)
    "hour_of_day", "day_of_week", "day_of_month", "is_weekend", "time_period",
    "is_business_hours", "is_night_time", "in_user_preferred_time",
    # geographic (8)
    "has_geolocation", "has_merchant_location", "latitude", "longitude",
    "is_high_risk_country", "distance_to_merchant_km", "user_intl_preference",
    "unexpected_intl_transaction",
    # user behavior (10)
    "account_age_days", "is_new_account", "is_very_new_account",
    "user_risk_score", "is_kyc_verified", "kyc_status",
    "weekend_activity_factor", "online_preference", "user_avg_amount",
    "user_transaction_frequency",
    # merchant risk (8)
    "merchant_risk_level", "merchant_fraud_rate", "is_blacklisted_merchant",
    "merchant_category", "is_high_risk_category", "within_merchant_hours",
    "merchant_risk_multiplier", "suspicious_merchant_name",
    # device / network (5)
    "is_known_device", "is_new_device", "is_private_ip", "ip_risk_score",
    "suspicious_user_agent",
    # velocity (8)
    "velocity_5min_count", "velocity_5min_amount", "velocity_1hour_count",
    "velocity_1hour_amount", "velocity_24hour_count", "velocity_24hour_amount",
    "high_velocity_5min", "high_velocity_1hour",
    # contextual (5)
    "payment_method", "is_high_risk_payment", "transaction_type", "is_refund",
    "card_type",
)
NUM_FEATURES = len(FEATURE_NAMES)

_INDEX = {name: i for i, name in enumerate(FEATURE_NAMES)}


def feature_index(name: str) -> int:
    return _INDEX[name]


def top_feature_importances(importances, k: int = 10):
    """Top-k {feature name: score} from a per-feature importance vector
    (the reference's explanation field, ensemble_predictor.py:371-435). Its
    length must match the 64-name contract: a trainer fit on another
    feature matrix must not get its indices mislabelled with these names."""
    arr = np.asarray(importances, np.float32)
    if arr.shape != (len(FEATURE_NAMES),):
        raise ValueError(
            f"importances shape {arr.shape} != ({len(FEATURE_NAMES)},) — "
            "not the canonical feature contract")
    order = np.argsort(arr)[::-1][:k]
    return {FEATURE_NAMES[i]: round(float(arr[i]), 6)
            for i in order if arr[i] > 0}


def _haversine_km(lat1, lon1, lat2, lon2):
    """Haversine distance (FeatureExtractor.java:407-417)."""
    rad = math.pi / 180.0
    dlat = (lat2 - lat1) * rad
    dlon = (lon2 - lon1) * rad
    a = (torch.sin(dlat / 2) ** 2
         + torch.cos(lat1 * rad) * torch.cos(lat2 * rad)
         * torch.sin(dlon / 2) ** 2)
    return 6371.0 * 2.0 * torch.atan2(torch.sqrt(a), torch.sqrt(1.0 - a))


def extract_features(b: TransactionBatch) -> torch.Tensor:
    """Vectorised 64-feature extraction. Returns f32[B, 64]."""
    def f32(x):
        return x.to(torch.float32)

    def where(cond, a, other):
        return torch.where(cond, a, torch.as_tensor(other, dtype=a.dtype,
                                                    device=a.device))

    amount = f32(b.amount)
    hour = b.hour_of_day

    # amount (12)
    cents = torch.round(amount * 100.0).to(torch.int32)
    has_user_avg = b.has_user & (b.user_avg_amount > 0)
    user_avg = torch.clamp(b.user_avg_amount, min=1e-9)
    user_ratio = where(has_user_avg, amount / user_avg, 0.0)
    user_z = where(has_user_avg, (amount - b.user_avg_amount) / user_avg, 0.0)
    has_merch_avg = b.has_merchant & (b.merchant_avg_amount > 0)
    merch_ratio = where(
        has_merch_avg, amount / torch.clamp(b.merchant_avg_amount, min=1e-9),
        0.0)
    amount_category = ((amount >= 10).to(torch.int32) + (amount >= 100)
                       + (amount >= 1000) + (amount >= 10000))

    # temporal (8); time_period: morning 0 / afternoon 1 / evening 2 / night 3
    time_period = torch.full_like(hour, 3)
    time_period = torch.where((hour >= 18) & (hour < 22), 2, time_period)
    time_period = torch.where((hour >= 12) & (hour < 18), 1, time_period)
    time_period = torch.where((hour >= 6) & (hour < 12), 0, time_period)
    in_preferred = (b.has_user & b.has_preferred_hours
                    & (hour >= b.preferred_start) & (hour <= b.preferred_end))

    # geographic (8)
    high_risk_loc = b.has_geo & (
        (torch.abs(b.lat) > 60)
        | ((torch.abs(b.lat) < 10) & (torch.abs(b.lon) < 10)))
    both_geo = b.has_geo & b.has_merchant_geo
    dist = where(both_geo, _haversine_km(b.lat, b.lon, b.merchant_lat,
                                         b.merchant_lon), 0.0)
    intl_pref = where(b.has_user & b.has_intl_ratio, b.intl_ratio, 0.0)
    unexpected_intl = b.has_user & b.has_intl_ratio & (b.intl_ratio < 0.1)

    # user (10); unknown users count as new accounts
    is_new_account = torch.where(b.has_user, b.account_age_days < 30, True)
    is_very_new = torch.where(b.has_user, b.account_age_days < 7, True)

    # merchant (8)
    within_hours = torch.where(
        b.has_merchant & b.has_op_hours,
        (hour >= b.merchant_op_start) & (hour <= b.merchant_op_end), True)
    risk_mult = torch.full_like(amount, 2.0)
    risk_mult = torch.where(b.has_merchant & (b.merchant_risk_code == 1),
                            1.5, risk_mult)
    risk_mult = torch.where(b.has_merchant & (b.merchant_risk_code == 0),
                            1.0, risk_mult)

    cols = [
        # amount
        amount,
        torch.log1p(torch.clamp(amount, min=0.0)),
        torch.sqrt(torch.clamp(amount, min=0.0)),
        f32(torch.remainder(cents, 100) == 0),
        f32(torch.remainder(cents, 1000) == 0),
        f32(torch.remainder(cents, 10000) == 0),
        user_ratio,
        user_z,
        f32(has_user_avg & (user_ratio > 3.0)),
        merch_ratio,
        f32(has_merch_avg & (amount > b.merchant_avg_amount * 2.0)),
        f32(amount_category),
        # temporal
        f32(hour),
        f32(b.day_of_week),
        f32(b.day_of_month),
        f32(b.is_weekend),
        f32(time_period),
        f32((hour >= 9) & (hour <= 17)),
        f32((hour <= 6) | (hour >= 22)),
        f32(in_preferred),
        # geographic
        f32(b.has_geo),
        f32(b.has_merchant_geo),
        where(b.has_geo, b.lat, 0.0),
        where(b.has_geo, b.lon, 0.0),
        f32(high_risk_loc),
        dist,
        intl_pref,
        f32(unexpected_intl),
        # user
        f32(b.account_age_days),
        f32(is_new_account),
        f32(is_very_new),
        f32(b.user_risk_score),
        f32(b.has_user & b.user_verified),
        f32(b.kyc_code),
        f32(b.weekend_activity),
        f32(b.online_preference),
        f32(b.user_avg_amount),
        f32(b.user_txn_frequency),
        # merchant
        f32(b.merchant_risk_code),
        f32(b.merchant_fraud_rate),
        f32(b.merchant_blacklisted),
        f32(b.merchant_category_code),
        f32(b.merchant_high_risk_category),
        f32(within_hours),
        risk_mult,
        f32(b.suspicious_merchant_name),
        # device / network
        f32(b.known_device),
        f32(~b.known_device),
        f32(b.private_ip),
        f32(b.ip_risk),
        f32(b.suspicious_user_agent),
        # velocity
        f32(b.velocity_5min_count),
        f32(b.velocity_5min_amount),
        f32(b.velocity_1hour_count),
        f32(b.velocity_1hour_amount),
        f32(b.velocity_24hour_count),
        f32(b.velocity_24hour_amount),
        f32(b.velocity_5min_count > 5),
        f32(b.velocity_1hour_count > 20),
        # contextual
        f32(b.payment_method_code),
        f32(b.high_risk_payment),
        f32(b.transaction_type_code),
        f32(b.transaction_type_code == 1),  # refund (TRANSACTION_TYPES[1])
        f32(b.card_type_code),
    ]
    return torch.stack(cols, dim=-1)


# rows per padded block of ``extract_features_host``: a multiple of every
# CPU vector loop's step (two vectors of 16 f32 lanes at most)
_HOST_ROW_BLOCK = 64


def extract_features_host(b: TransactionBatch) -> np.ndarray:
    """``extract_features`` on the CPU over a batch of numpy columns; returns
    f32[B, 64] as a numpy array (the rows host assembly keeps for the
    history store and the features topic).

    The columns are padded (row 0 repeated) to a multiple of
    ``_HOST_ROW_BLOCK`` rows: PyTorch's CPU loops run whole vectors and
    finish a remainder with scalar code, whose sin / cos / atan2 round
    differently, so without the padding a row's haversine distance would
    depend on its position and the batch size, and the columnar assembly
    would not equal the record-at-a-time one."""
    n = len(np.asarray(b.amount))
    pad = -n % _HOST_ROW_BLOCK
    cols = {}
    for f in dataclasses.fields(b):
        col = np.asarray(getattr(b, f.name))
        if pad and n:
            col = np.concatenate([col, np.repeat(col[:1], pad, axis=0)])
        cols[f.name] = torch.from_numpy(col)
    return extract_features(TransactionBatch(**cols)).numpy()[:n]
