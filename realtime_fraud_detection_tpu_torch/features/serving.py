"""Serving-side feature validation / derivation.

Port of the JAX package's ``features/serving.py`` (host NumPy).

Mirror of the reference ``FeatureProcessor`` (feature_processor.py:30-402):
typed feature definitions with bounds/defaults, validation and NaN handling,
and derived features. Unlike the reference (one dict at a time, per-request
Python), this processes a whole microbatch vectorized in NumPy on the host;
its output feeds ``encode_request_features`` -> the (B, 64) model vector.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np

NUMERICAL = "numerical"
BINARY = "binary"


@dataclass(frozen=True)
class FeatureDef:
    """Feature definition (feature_processor.py:30-41)."""

    name: str
    kind: str = NUMERICAL
    required: bool = False
    min_value: float | None = None
    max_value: float | None = None
    default: float = 0.0


def _defs() -> Dict[str, FeatureDef]:
    """Serving feature definitions (feature_processor.py:66-147)."""
    table: List[FeatureDef] = [
        # amount
        FeatureDef("amount", required=True, min_value=0.0),
        FeatureDef("amount_log"),
        FeatureDef("amount_percentile", min_value=0.0, max_value=100.0),
        FeatureDef("amount_zscore"),
        FeatureDef("rounded_amount_frequency", min_value=0.0),
        # temporal
        FeatureDef("hour_of_day", min_value=0, max_value=23, default=12),
        FeatureDef("day_of_week", min_value=0, max_value=6, default=1),
        FeatureDef("is_weekend", kind=BINARY),
        FeatureDef("is_holiday", kind=BINARY),
        FeatureDef("time_since_last_transaction", min_value=0.0),
        # geographic
        FeatureDef("distance_from_home", min_value=0.0),
        FeatureDef("location_risk_score", min_value=0.0, max_value=1.0),
        FeatureDef("country_risk_score", min_value=0.0, max_value=1.0, default=0.5),
        FeatureDef("timezone_mismatch", kind=BINARY),
        # user behavior
        FeatureDef("user_transaction_count_1h", min_value=0),
        FeatureDef("user_transaction_count_24h", min_value=0),
        FeatureDef("user_total_amount_24h", min_value=0.0),
        FeatureDef("user_avg_amount", min_value=0.0),
        FeatureDef("user_unique_merchants_24h", min_value=0),
        FeatureDef("user_account_age_days", min_value=0),
        # merchant
        FeatureDef("merchant_transaction_count_1h", min_value=0),
        FeatureDef("merchant_fraud_rate", min_value=0.0, max_value=1.0),
        FeatureDef("merchant_avg_amount", min_value=0.0),
        FeatureDef("merchant_risk_score", min_value=0.0, max_value=1.0, default=0.5),
        FeatureDef("merchant_category_risk", min_value=0.0, max_value=1.0, default=0.5),
        # device / network
        FeatureDef("device_risk_score", min_value=0.0, max_value=1.0, default=0.5),
        FeatureDef("is_new_device", kind=BINARY),
        FeatureDef("ip_risk_score", min_value=0.0, max_value=1.0, default=0.5),
        FeatureDef("is_tor_ip", kind=BINARY),
        FeatureDef("is_vpn_ip", kind=BINARY),
        # velocity
        FeatureDef("velocity_score", min_value=0.0, max_value=1.0),
        FeatureDef("amount_velocity_1h", min_value=0.0),
        FeatureDef("transaction_velocity_5m", min_value=0.0),
        # contextual
        FeatureDef("payment_method_risk", min_value=0.0, max_value=1.0, default=0.5),
        FeatureDef("card_type_risk", min_value=0.0, max_value=1.0, default=0.5),
        FeatureDef("is_crypto_merchant", kind=BINARY),
        FeatureDef("is_gift_card_merchant", kind=BINARY),
        FeatureDef("cross_border_transaction", kind=BINARY),
        # encoded categoricals
        FeatureDef("payment_method_encoded", min_value=0, max_value=10),
        FeatureDef("merchant_category_encoded", min_value=0, max_value=20),
        FeatureDef("card_type_encoded", min_value=0, max_value=5),
    ]
    return {d.name: d for d in table}


_METADATA_KEYS = ("transaction_id", "user_id", "merchant_id", "timestamp",
                  "currency", "payment_method")


class ServingFeatureProcessor:
    """Validates raw request features and derives the serving feature set."""

    def __init__(self) -> None:
        self.feature_definitions = _defs()

    # -- single request (API-compatible with the reference) ----------------
    def process_features(self, raw: Mapping[str, Any]) -> Dict[str, Any]:
        """Validate + derive for one request (feature_processor.py:161-194)."""
        return self.process_batch([raw])[0]

    # -- vectorized batch path ---------------------------------------------
    def process_batch(self, raws: Sequence[Mapping[str, Any]]) -> List[Dict[str, Any]]:
        results = []
        for raw in raws:
            flink = raw.get("features", {}) if isinstance(raw.get("features"), dict) else {}
            out: Dict[str, Any] = {}
            for name, d in self.feature_definitions.items():
                if name in raw:
                    value = raw[name]
                elif name in flink:
                    value = flink[name]
                elif d.required:
                    raise ValueError(f"Required feature '{name}' not found")
                else:
                    value = d.default
                out[name] = self._validate(value, d)
            out.update(self._derive(out))
            for key in _METADATA_KEYS:
                out[key] = raw.get(key, "USD" if key == "currency" else
                                   ("unknown" if key == "payment_method" else ""))
            # final finite sweep (feature_processor.py:375-402)
            for k, v in out.items():
                if isinstance(v, float) and not math.isfinite(v):
                    d = self.feature_definitions.get(k)
                    out[k] = d.default if d else 0.0
            results.append(out)
        return results

    def _validate(self, value: Any, d: FeatureDef) -> float:
        """Bounds/NaN/bool handling (feature_processor.py:224-275)."""
        try:
            if d.kind == BINARY:
                if isinstance(value, bool):
                    return 1.0 if value else 0.0
                if isinstance(value, str):
                    return 1.0 if value.lower() in ("true", "1", "yes") else 0.0
                return 1.0 if float(value) > 0.5 else 0.0
            v = float(value) if value is not None else 0.0
            if math.isnan(v) or math.isinf(v):
                return d.default
            if d.min_value is not None:
                v = max(v, d.min_value)
            if d.max_value is not None:
                v = min(v, d.max_value)
            return v
        except (ValueError, TypeError):
            return d.default

    def _derive(self, f: Dict[str, float]) -> Dict[str, float]:
        """Derived features (feature_processor.py:330-373).

        Unlike the reference, every derived key is ALWAYS emitted (0.0 when
        the inputs are absent/non-positive) so each row of a batch has an
        identical key set — otherwise ``to_model_matrix`` columns would mean
        different features for different rows.
        """
        out: Dict[str, float] = {}
        amount = f.get("amount", 0.0)
        out["amount_log"] = math.log1p(amount) if amount > 0 else 0.0
        out["amount_sqrt"] = math.sqrt(amount) if amount > 0 else 0.0
        user_avg = f.get("user_avg_amount", 1.0)
        out["amount_to_user_avg_ratio"] = amount / user_avg if user_avg > 0 else 0.0
        merchant_avg = f.get("merchant_avg_amount", 1.0)
        out["amount_to_merchant_avg_ratio"] = (
            amount / merchant_avg if merchant_avg > 0 else 0.0
        )
        c1, c24 = f.get("user_transaction_count_1h", 0), f.get("user_transaction_count_24h", 0)
        out["hourly_velocity_ratio"] = c1 / (c24 / 24) if c24 > 0 else 0.0
        out["combined_device_ip_risk"] = (
            f.get("device_risk_score", 0.5) + f.get("ip_risk_score", 0.5)
        ) / 2
        hour = f.get("hour_of_day", 12)
        out["is_business_hours"] = 1.0 if 9 <= hour <= 17 else 0.0
        out["is_late_night"] = 1.0 if hour < 6 or hour > 22 else 0.0
        return out

    # -- model input --------------------------------------------------------
    def to_model_matrix(self, processed: Sequence[Mapping[str, Any]], width: int = 64) -> np.ndarray:
        """Flatten processed dicts into the clipped (B, >=64) model input.

        Numeric fields (metadata excluded) in definition order + derived,
        zero-padded to ``width`` and clipped to +-10
        (ensemble_predictor.py:221-250).
        """
        rows = []
        for p in processed:
            vals = [float(v) for k, v in p.items()
                    if k not in _METADATA_KEYS and isinstance(v, (int, float))]
            vals = (vals + [0.0] * width)[: max(width, len(vals))]
            rows.append(vals)
        n = max(len(r) for r in rows)
        mat = np.zeros((len(rows), n), np.float32)
        for i, r in enumerate(rows):
            mat[i, : len(r)] = r
        return np.clip(mat, -10.0, 10.0)

    def get_feature_names(self) -> List[str]:
        return list(self.feature_definitions)

    def validate_feature_schema(self, features: Mapping[str, Any]) -> Tuple[bool, List[str]]:
        """Schema check (feature_processor.py:415-442)."""
        errors = []
        missing = [n for n, d in self.feature_definitions.items()
                   if d.required and n not in features]
        if missing:
            errors.append(f"Missing required features: {missing}")
        for name, value in features.items():
            d = self.feature_definitions.get(name)
            if d is None or d.kind != NUMERICAL:
                continue
            try:
                v = float(value)
                if d.min_value is not None and v < d.min_value:
                    errors.append(f"Feature {name} below minimum: {v} < {d.min_value}")
                if d.max_value is not None and v > d.max_value:
                    errors.append(f"Feature {name} above maximum: {v} > {d.max_value}")
            except (ValueError, TypeError):
                errors.append(f"Feature {name} has invalid type: {type(value)}")
        return len(errors) == 0, errors
