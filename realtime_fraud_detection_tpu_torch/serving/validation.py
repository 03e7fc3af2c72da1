"""Validation of stream records and of the scoring service's requests.

Port of the JAX package's ``serving/validation.py`` (the reference's
request models, main.py:67-106): ``validate_transaction`` is strict on
identity and amount; ``sanitize_for_stream`` is lenient on everything else
(a field is coerced, or dropped so the encoder's default applies);
``validate_batch`` takes a ``/batch-predict`` body, ``{"transactions":
[...]}`` or a bare list, up to a size limit.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Tuple

__all__ = ["validate_transaction", "validate_batch", "sanitize_for_stream"]

_REQUIRED = ("transaction_id", "user_id", "merchant_id", "amount")
_STRING_FIELDS = ("transaction_id", "user_id", "merchant_id", "currency",
                  "payment_method", "timestamp")

# stream-ingest coercion tables; calendar fields carry their valid ranges
# (an out-of-range value would overflow the int32 batch column), and a value
# outside them is dropped so the encoder's neutral default applies
_STREAM_INT_FIELDS = (("hour_of_day", 0, 23), ("day_of_week", 1, 7),
                      ("day_of_month", 1, 31))
_STREAM_FLOAT_FIELDS = ("fraud_score",)
_STREAM_GEO_FIELDS = ("geolocation", "merchant_location")
_STREAM_STR_FIELDS = ("payment_method", "transaction_type", "card_type",
                      "user_agent", "ip_address", "device_fingerprint",
                      "description")


def sanitize_for_stream(body: Any) -> Tuple[Dict[str, Any], List[str]]:
    """Per-record ingest sanitizer for the stream path: a poisoned field in
    one record must not push its batch-mates onto the error path
    (TransactionProcessor.java:83-91). Returns (sanitized_record, errors);
    non-empty errors divert this record to its own error result."""
    txn, errors = validate_transaction(body)
    if errors:
        return txn, errors
    for f, lo, hi in _STREAM_INT_FIELDS:
        if f in txn:
            try:
                v = int(txn[f])
            except (TypeError, ValueError, OverflowError):
                # OverflowError: int(float('inf'))
                del txn[f]
                continue
            if lo <= v <= hi:
                txn[f] = v
            else:
                del txn[f]
    for f in _STREAM_FLOAT_FIELDS:
        if f in txn:
            try:
                v = float(txn[f])
                txn[f] = v if math.isfinite(v) else 0.0
            except (TypeError, ValueError):
                del txn[f]
    for f in _STREAM_GEO_FIELDS:
        geo = txn.get(f)
        if geo is not None:
            try:
                txn[f] = {"lat": float(geo["lat"]), "lon": float(geo["lon"])}
            except (TypeError, ValueError, KeyError):
                del txn[f]
    for f in _STREAM_STR_FIELDS:
        if f in txn and txn[f] is not None and not isinstance(txn[f], str):
            txn[f] = str(txn[f])
    return txn, []


def validate_transaction(body: Any) -> Tuple[Dict[str, Any], List[str]]:
    """Returns (normalized_txn, errors). Empty errors == valid."""
    errors: List[str] = []
    if not isinstance(body, Mapping):
        return {}, ["body must be a JSON object"]
    txn: Dict[str, Any] = dict(body)
    for f in _REQUIRED:
        if f not in txn or txn[f] in (None, ""):
            errors.append(f"missing required field: {f}")
    if "amount" in txn and txn.get("amount") not in (None, ""):
        try:
            amount = float(txn["amount"])
            if not math.isfinite(amount) or amount < 0:
                errors.append("amount must be a finite non-negative number")
            else:
                txn["amount"] = amount
        except (TypeError, ValueError):
            errors.append("amount must be a number")
    for f in _STRING_FIELDS:
        if f in txn and txn[f] is not None and not isinstance(txn[f], str):
            txn[f] = str(txn[f])
    feats = txn.get("features")
    if feats is not None and not isinstance(feats, Mapping):
        errors.append("features must be an object of name -> value")
    return txn, errors


def validate_batch(body: Any, limit: int) -> Tuple[List[Dict[str, Any]], List[str]]:
    """Validate a /batch-predict payload: {"transactions": [...]} or a bare
    list (the reference accepts a list of TransactionFeatures,
    main.py:218-233)."""
    if isinstance(body, Mapping) and "transactions" in body:
        body = body["transactions"]
    if not isinstance(body, list):
        return [], ["body must be a list of transactions or "
                    "{'transactions': [...]}"]
    if len(body) == 0:
        return [], ["empty batch"]
    if len(body) > limit:
        return [], [f"batch size {len(body)} exceeds limit {limit}"]
    txns: List[Dict[str, Any]] = []
    errors: List[str] = []
    for i, item in enumerate(body):
        txn, errs = validate_transaction(item)
        if errs:
            errors.extend(f"[{i}] {e}" for e in errs)
        txns.append(txn)
    return txns, errors
