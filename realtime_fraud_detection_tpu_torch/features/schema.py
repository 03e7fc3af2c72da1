"""Transaction batch container: one flat column per field.

The same struct-of-arrays layout as the JAX package's
``features/schema.py TransactionBatch``, with the fields in the same order
(the packed transfer layout of ``core/packing.py`` follows field order).
Columns are numpy arrays on the host and torch tensors on the device;
``has_*`` flags stand in for the reference's null checks. The records ->
batch encode is not part of this package yet.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any

import numpy as np

# categorical vocabularies (closed sets from the simulator); a code is the
# index into its tuple, -1 for an absent or unknown value
PAYMENT_METHODS = ("credit_card", "debit_card", "digital_wallet", "bank_transfer",
                   "crypto", "gift_card", "prepaid_card", "wire_transfer")
TRANSACTION_TYPES = ("purchase", "refund", "authorization")
CARD_TYPES = ("visa", "mastercard", "amex", "discover")
MERCHANT_CATEGORIES = ("retail", "grocery", "gas_station", "restaurant",
                       "online_retail", "gambling", "adult_entertainment",
                       "pharmacy", "jewelry", "electronics")
KYC_STATUSES = ("verified", "pending", "rejected")
RISK_LEVELS = ("low", "medium", "high")


@dataclass
class TransactionBatch:
    """Dense batch of transactions + joined profile state; every column has
    leading dim B. Dtypes: see ``column_dtype``."""

    # transaction core
    amount: Any
    hour_of_day: Any
    day_of_week: Any                 # ISO 1=Mon..7=Sun
    day_of_month: Any
    is_weekend: Any
    lat: Any
    lon: Any
    has_geo: Any
    merchant_lat: Any
    merchant_lon: Any
    has_merchant_geo: Any
    payment_method_code: Any
    transaction_type_code: Any
    card_type_code: Any
    high_risk_payment: Any
    suspicious_user_agent: Any
    private_ip: Any
    ip_risk: Any
    prior_fraud_score: Any

    # user profile join
    has_user: Any
    user_risk_score: Any
    account_age_days: Any
    user_verified: Any
    kyc_code: Any
    user_avg_amount: Any
    user_txn_frequency: Any
    preferred_start: Any
    preferred_end: Any
    has_preferred_hours: Any
    weekend_activity: Any
    intl_ratio: Any
    has_intl_ratio: Any
    online_preference: Any
    known_device: Any
    has_device_list: Any
    has_txn_fingerprint: Any

    # merchant profile join
    has_merchant: Any
    merchant_risk_code: Any
    merchant_fraud_rate: Any
    merchant_blacklisted: Any
    merchant_category_code: Any
    merchant_high_risk_category: Any
    merchant_op_start: Any
    merchant_op_end: Any
    has_op_hours: Any
    merchant_avg_amount: Any
    suspicious_merchant_name: Any

    # velocity state join (5min / 1hour / 24hour windows)
    velocity_5min_count: Any
    velocity_5min_amount: Any
    velocity_1hour_count: Any
    velocity_1hour_amount: Any
    velocity_24hour_count: Any
    velocity_24hour_amount: Any


BOOL_FIELDS = frozenset({
    "is_weekend", "has_geo", "has_merchant_geo", "high_risk_payment",
    "suspicious_user_agent", "private_ip", "has_txn_fingerprint", "has_user",
    "user_verified", "has_preferred_hours", "has_intl_ratio", "known_device",
    "has_device_list", "has_merchant", "merchant_blacklisted",
    "merchant_high_risk_category", "has_op_hours", "suspicious_merchant_name",
})
INT_FIELDS = frozenset({
    "hour_of_day", "day_of_week", "day_of_month", "payment_method_code",
    "transaction_type_code", "card_type_code", "kyc_code", "preferred_start",
    "preferred_end", "merchant_risk_code", "merchant_category_code",
    "merchant_op_start", "merchant_op_end",
})
FIELD_NAMES: tuple[str, ...] = tuple(f.name for f in fields(TransactionBatch))


def column_dtype(name: str) -> np.dtype:
    """numpy dtype of one TransactionBatch column."""
    if name in BOOL_FIELDS:
        return np.dtype(np.bool_)
    if name in INT_FIELDS:
        return np.dtype(np.int32)
    return np.dtype(np.float32)
