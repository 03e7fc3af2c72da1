"""Shared online-state stores over the RESP client: the multi-replica tier.

Port of the JAX package's ``state/shared.py``: the in-process stores' APIs
(``state/stores.py``) over a Redis-protocol server, with the reference's key
schema (RedisService.java:36-49):

    user:{id} / merchant:{id}              profile hashes (JSON field values)
    transaction:{id}                       JSON, TTL 24 h
    user_transactions:{id}                 list, last 100 (LPUSH + LTRIM)
    merchant_transactions:{id}             list, last 500
    velocity:{user}:{5min|1hour|24hour}    hash {count, amount, timestamp}
    features:{txnId}                       JSON, TTL 2 h
    agg:{key}                              hash counters, TTL 30 min

Scorer replicas pointed at one server share profiles, velocity and the
transaction cache; a JAX scorer and a port scorer can share one server.
Differences from the in-process stores, by design:

- **Atomicity**: velocity and aggregation updates are HINCRBY /
  HINCRBYFLOAT, atomic on the server, so concurrent replicas cannot lose
  updates (the reference's GET-then-SET races,
  RedisTransactionSink.java:116-135).
- **Velocity TTL**: each window key gets its own TTL equal to its period
  (PEXPIRE at window creation), not the reference's uniform one hour
  (RedisService.java:178-207). Expiry runs on the server's wall clock, so
  the ``now`` arguments kept for the in-process API are recorded but not
  used for expiry.
- **No pickling**: every store holds the client's socket, so a shared
  store cannot go into a host-state snapshot (``checkpoint.py``).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Mapping, Optional

from realtime_fraud_detection_tpu_torch.state.resp import RespClient
from realtime_fraud_detection_tpu_torch.state.stores import (
    VELOCITY_WINDOWS,
    _event_time_ms,
)

__all__ = [
    "SharedProfileStore",
    "SharedVelocityStore",
    "SharedTransactionCache",
    "SharedAggregationStore",
]


def _dumps(v: Any) -> str:
    return json.dumps(v, separators=(",", ":"))


def _loads(b: Optional[bytes]) -> Any:
    return None if b is None else json.loads(b)


class SharedProfileStore:
    """``user:{id}`` / ``merchant:{id}`` hashes, one JSON value per field."""

    def __init__(self, client: RespClient):
        self.c = client

    def seed(self, users: Optional[Mapping[str, Mapping[str, Any]]] = None,
             merchants: Optional[Mapping[str, Mapping[str, Any]]] = None) -> None:
        for uid, p in (users or {}).items():
            self.put_user(uid, p)
        for mid, p in (merchants or {}).items():
            self.put_merchant(mid, p)

    def _put(self, key: str, profile: Mapping[str, Any]) -> None:
        pairs: List[Any] = []
        for field, value in profile.items():
            pairs.extend((field, _dumps(value)))
        if pairs:
            self.c.hset(key, *pairs)

    def _get(self, key: str) -> Optional[Dict[str, Any]]:
        h = self.c.hgetall(key)
        if not h:
            return None
        return {field: json.loads(v) for field, v in h.items()}

    def put_user(self, user_id: str, profile: Mapping[str, Any]) -> None:
        self._put(f"user:{user_id}", profile)

    def put_merchant(self, merchant_id: str, profile: Mapping[str, Any]) -> None:
        self._put(f"merchant:{merchant_id}", profile)

    def get_user(self, user_id: str) -> Optional[Mapping[str, Any]]:
        return self._get(f"user:{user_id}")

    def get_merchant(self, merchant_id: str) -> Optional[Mapping[str, Any]]:
        return self._get(f"merchant:{merchant_id}")


class SharedVelocityStore:
    """``velocity:{user}:{window}`` hashes with atomic increments."""

    def __init__(self, client: RespClient):
        self.c = client

    def update(self, user_id: str, amount: float, now: float) -> None:
        for window, period in VELOCITY_WINDOWS.items():
            key = f"velocity:{user_id}:{window}"
            created = self.c.hsetnx(key, "timestamp", repr(now))
            self.c.hincrby(key, "count", 1)
            self.c.hincrbyfloat(key, "amount", float(amount))
            if created:
                # the window's TTL is its own period, set once at creation
                self.c.expire(key, period)

    def update_batch(self, user_ids, amounts, now: float) -> None:
        for uid, amt in zip(user_ids, amounts):
            self.update(uid, float(amt), now)

    def get(self, user_id: str, window: str,
            now: Optional[float] = None) -> Dict[str, float]:
        h = self.c.hgetall(f"velocity:{user_id}:{window}")
        if not h:
            return {}
        return {
            "count": int(h.get("count", b"0")),
            "amount": float(h.get("amount", b"0")),
            "timestamp": float(h.get("timestamp", b"0")),
        }

    def get_all(self, user_id: str,
                now: Optional[float] = None) -> Dict[str, Dict[str, float]]:
        return {w: self.get(user_id, w, now) for w in VELOCITY_WINDOWS}


class SharedTransactionCache:
    """``transaction:{id}`` / ``features:{id}`` JSON + per-entity id lists."""

    def __init__(self, client: RespClient, txn_ttl_s: float = 24 * 3600,
                 features_ttl_s: float = 2 * 3600,
                 user_list_len: int = 100, merchant_list_len: int = 500):
        self.c = client
        self.txn_ttl_s = txn_ttl_s
        self.features_ttl_s = features_ttl_s
        self.user_list_len = user_list_len
        self.merchant_list_len = merchant_list_len

    def cache_transaction(self, txn: Mapping[str, Any],
                          now: Optional[float] = None) -> None:
        tid = str(txn.get("transaction_id"))
        self.c.set(f"transaction:{tid}", _dumps(dict(txn)), ex=self.txn_ttl_s)
        uid, mid = str(txn.get("user_id")), str(txn.get("merchant_id"))
        ukey, mkey = f"user_transactions:{uid}", f"merchant_transactions:{mid}"
        self.c.lpush(ukey, tid)
        self.c.ltrim(ukey, 0, self.user_list_len - 1)
        self.c.lpush(mkey, tid)
        self.c.ltrim(mkey, 0, self.merchant_list_len - 1)

    def get_transaction(self, txn_id: str,
                        now: Optional[float] = None) -> Any:
        return _loads(self.c.get(f"transaction:{txn_id}"))

    def store_features(self, txn_id: str, features: Any,
                       now: Optional[float] = None) -> None:
        self.c.set(f"features:{txn_id}", _dumps(features),
                   ex=self.features_ttl_s)

    def get_features(self, txn_id: str, now: Optional[float] = None) -> Any:
        return _loads(self.c.get(f"features:{txn_id}"))

    def get_user_transactions(self, user_id: str,
                              limit: int = 100) -> List[str]:
        return [b.decode() for b in
                self.c.lrange(f"user_transactions:{user_id}", 0, limit - 1)]

    def get_merchant_transactions(self, merchant_id: str,
                                  limit: int = 500) -> List[str]:
        return [b.decode() for b in
                self.c.lrange(f"merchant_transactions:{merchant_id}", 0,
                              limit - 1)]


class SharedAggregationStore:
    """``agg:{key}`` hash counters — concurrent-replica-safe by atomicity."""

    def __init__(self, client: RespClient, ttl_s: float = 1800.0):
        self.c = client
        self.ttl_s = ttl_s

    def record(self, txn: Mapping[str, Any],
               now: Optional[float] = None) -> None:
        ts_ms = _event_time_ms(txn, now)
        hour_key = int(ts_ms // 3_600_000)
        day_key = int(ts_ms // 86_400_000)
        amount = float(txn.get("amount", 0.0))
        is_fraud = bool(txn.get("is_fraud", False))
        high_risk = float(txn.get("fraud_score", 0.0)) > 0.7
        for key in (f"hourly:{hour_key}", f"daily:{day_key}",
                    f"merchant:{txn.get('merchant_id')}:{hour_key}"):
            full = f"agg:{key}"
            count = self.c.hincrby(full, "total_count", 1)
            self.c.hincrbyfloat(full, "total_amount", amount)
            if is_fraud:
                self.c.hincrby(full, "fraud_count", 1)
            if high_risk:
                self.c.hincrby(full, "high_risk_count", 1)
            if count == 1:
                self.c.expire(full, self.ttl_s)

    def get(self, key: str, now: Optional[float] = None) -> Dict[str, Any]:
        h = self.c.hgetall(f"agg:{key}")
        if not h:
            return {}
        count = int(h.get("total_count", b"0"))
        total = float(h.get("total_amount", b"0"))
        fraud = int(h.get("fraud_count", b"0"))
        return {
            "total_count": count,
            "total_amount": total,
            "fraud_count": fraud,
            "high_risk_count": int(h.get("high_risk_count", b"0")),
            "fraud_rate": fraud / count if count else 0.0,
            "avg_amount": total / count if count else 0.0,
        }
