"""Windowed state stores, in process: the Redis data plane of the reference.

Port of the JAX package's ``state/stores.py``: the reference's Redis key
schema (RedisService.java:36-49) as plain dicts, with the sink's update
logic (RedisTransactionSink.java:87-262: velocity, the transaction cache,
the rolling aggregations). Every mutation happens on the one thread that
assembles and writes back (single writer per key), and each velocity window
resets on its own period (the reference gave all three a one-hour key TTL).
Callers on a virtual clock pass ``now``. The shared RESP tier
(``state/shared.py``) keeps the same store APIs over a Redis-protocol
server. (The JAX module's ``StateBackend`` protocol is not ported: nothing is
typed against it, and its own in-process backend does not match it.)
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

VELOCITY_WINDOWS: dict[str, float] = {"5min": 300.0, "1hour": 3600.0, "24hour": 86400.0}


def _event_time_ms(txn: Mapping[str, Any], now: float | None) -> float:
    """Event time in ms: explicit timestamp_ms, else the simulator's ISO
    'timestamp' string, else ``now`` / the wall clock."""
    if "timestamp_ms" in txn:
        return float(txn["timestamp_ms"])
    ts = txn.get("timestamp")
    if isinstance(ts, str) and ts:
        from datetime import datetime

        try:
            return datetime.fromisoformat(ts).timestamp() * 1000.0
        except ValueError:
            pass
    return (now if now is not None else time.time()) * 1000.0


class _MemoryBackend:
    """Dict backend with lazy TTL expiry (single-writer discipline)."""

    def __init__(self) -> None:
        self._data: Dict[str, Tuple[Any, float | None]] = {}

    def get(self, key: str, now: float | None = None) -> Any:
        item = self._data.get(key)
        if item is None:
            return None
        value, expires = item
        if expires is not None and (now if now is not None else time.time()) >= expires:
            del self._data[key]
            return None
        return value

    def put(self, key: str, value: Any, ttl_s: float | None = None,
            now: float | None = None) -> None:
        expires = None
        if ttl_s is not None:
            expires = (now if now is not None else time.time()) + ttl_s
        self._data[key] = (value, expires)

    def delete(self, key: str) -> None:
        self._data.pop(key, None)

    def __len__(self) -> int:
        return len(self._data)


class VelocityStore:
    """Per-user transaction velocity over 5min/1hour/24hour windows.

    Update semantics follow RedisTransactionSink.updateVelocityWindow
    (:116-135): read current (count, amount), add, store; each window resets
    when its own period has elapsed since the window started.
    """

    def __init__(self) -> None:
        # (user_id, window) -> [count, amount, window_start]
        self._state: Dict[Tuple[str, str], List[float]] = {}
        # stream time: the latest `now` any update has seen; reads that omit
        # `now` expire against this clock
        self._clock: float = 0.0

    def update(self, user_id: str, amount: float, now: float) -> None:
        self._clock = max(self._clock, now)
        for window, period in VELOCITY_WINDOWS.items():
            key = (user_id, window)
            cur = self._state.get(key)
            if cur is None or now - cur[2] >= period:
                self._state[key] = [1, amount, now]
            else:
                cur[0] += 1
                cur[1] += amount

    def update_batch(self, user_ids: Iterable[str], amounts: Iterable[float],
                     now: float) -> None:
        for uid, amt in zip(user_ids, amounts):
            self.update(uid, float(amt), now)

    def get(self, user_id: str, window: str, now: float | None = None) -> Dict[str, float]:
        """Velocity metrics dict (RedisService.getVelocityMetrics shape),
        expired against ``now`` when given, else the stream clock."""
        cur = self._state.get((user_id, window))
        if cur is None:
            return {}
        if (now if now is not None else self._clock) - cur[2] >= VELOCITY_WINDOWS[window]:
            return {}
        return {"count": cur[0], "amount": cur[1], "timestamp": cur[2]}

    def get_all(self, user_id: str, now: float | None = None) -> Dict[str, Dict[str, float]]:
        return {w: self.get(user_id, w, now) for w in VELOCITY_WINDOWS}

    def entries(self) -> List[Tuple[str, str, float, float, float]]:
        """Sorted raw window rows ``(user_id, window, count, amount,
        window_start)``."""
        return sorted((uid, w, float(v[0]), float(v[1]), float(v[2]))
                      for (uid, w), v in self._state.items())

    def __len__(self) -> int:
        return len(self._state)


class ProfileStore:
    """User + merchant profile store (``user:{id}`` / ``merchant:{id}``).

    ``generation`` stamps every write: the encoder's join-row cache
    (``features/schema.py EntityRowCache``) compares its stamp against it and
    drops rows of a profile that has since been rewritten.
    """

    def __init__(self) -> None:
        self.users: Dict[str, Mapping[str, Any]] = {}
        self.merchants: Dict[str, Mapping[str, Any]] = {}
        self.generation: int = 0

    def seed(self, users: Mapping[str, Mapping[str, Any]] | None = None,
             merchants: Mapping[str, Mapping[str, Any]] | None = None) -> None:
        """Bulk-load profiles (the simulator's Redis seeding path,
        simulator.py:243-294)."""
        if users:
            self.users.update(users)
        if merchants:
            self.merchants.update(merchants)
        if users or merchants:
            self.generation += 1

    def get_user(self, user_id: str) -> Optional[Mapping[str, Any]]:
        return self.users.get(user_id)

    def get_merchant(self, merchant_id: str) -> Optional[Mapping[str, Any]]:
        return self.merchants.get(merchant_id)

    def put_user(self, user_id: str, profile: Mapping[str, Any]) -> None:
        self.users[user_id] = profile
        self.generation += 1

    def put_merchant(self, merchant_id: str, profile: Mapping[str, Any]) -> None:
        self.merchants[merchant_id] = profile
        self.generation += 1


class TransactionCache:
    """Recent transactions + per-entity id lists (RedisService.java:127-171,
    296-321): ``transaction:{id}`` TTL 24h, ``user_transactions`` last-100,
    ``merchant_transactions`` last-500, ``features:{id}`` TTL 2h.
    """

    def __init__(self, txn_ttl_s: float = 24 * 3600, features_ttl_s: float = 2 * 3600,
                 user_list_len: int = 100, merchant_list_len: int = 500) -> None:
        self._backend = _MemoryBackend()
        self.txn_ttl_s = txn_ttl_s
        self.features_ttl_s = features_ttl_s
        self.user_list_len = user_list_len
        self.merchant_list_len = merchant_list_len
        self._user_lists: Dict[str, List[str]] = {}
        self._merchant_lists: Dict[str, List[str]] = {}

    def cache_transaction(self, txn: Mapping[str, Any], now: float | None = None) -> None:
        tid = str(txn.get("transaction_id"))
        self._backend.put(f"transaction:{tid}", dict(txn), self.txn_ttl_s, now)
        uid, mid = str(txn.get("user_id")), str(txn.get("merchant_id"))
        ul = self._user_lists.setdefault(uid, [])
        ul.insert(0, tid)
        del ul[self.user_list_len:]
        ml = self._merchant_lists.setdefault(mid, [])
        ml.insert(0, tid)
        del ml[self.merchant_list_len:]

    def get_transaction(self, txn_id: str, now: float | None = None) -> Any:
        return self._backend.get(f"transaction:{txn_id}", now)

    def store_features(self, txn_id: str, features: Any, now: float | None = None) -> None:
        self._backend.put(f"features:{txn_id}", features, self.features_ttl_s, now)

    def get_features(self, txn_id: str, now: float | None = None) -> Any:
        return self._backend.get(f"features:{txn_id}", now)

    def entries(self, now: float | None = None) -> List[Tuple[str, Any]]:
        """Sorted live ``(transaction_id, cached_txn)`` pairs (expired
        entries excluded against ``now`` when given)."""
        out = []
        for key in sorted(self._backend._data):
            if not key.startswith("transaction:"):
                continue
            value = self._backend.get(key, now)
            if value is not None:
                out.append((key[len("transaction:"):], value))
        return out

    def get_user_transactions(self, user_id: str, limit: int = 100) -> List[str]:
        return self._user_lists.get(user_id, [])[:limit]

    def get_merchant_transactions(self, merchant_id: str, limit: int = 500) -> List[str]:
        return self._merchant_lists.get(merchant_id, [])[:limit]


class AggregationStore:
    """Hourly / daily / per-merchant rolling aggregations
    (RedisTransactionSink.java:140-262): total_count, total_amount,
    fraud_count, high_risk_count, fraud_rate, avg_amount per bucket.
    """

    def __init__(self, ttl_s: float = 1800.0) -> None:
        self._backend = _MemoryBackend()
        self.ttl_s = ttl_s

    def record(self, txn: Mapping[str, Any], now: float | None = None) -> None:
        ts_ms = _event_time_ms(txn, now)
        hour_key = int(ts_ms // 3_600_000)
        day_key = int(ts_ms // 86_400_000)
        amount = float(txn.get("amount", 0.0))
        is_fraud = bool(txn.get("is_fraud", False))
        high_risk = float(txn.get("fraud_score", 0.0)) > 0.7
        for key in (f"hourly:{hour_key}", f"daily:{day_key}",
                    f"merchant:{txn.get('merchant_id')}:{hour_key}"):
            self._update(key, amount, is_fraud, high_risk, now)

    def _update(self, key: str, amount: float, is_fraud: bool, high_risk: bool,
                now: float | None) -> None:
        agg = self._backend.get(f"agg:{key}", now) or {
            "total_count": 0, "total_amount": 0.0, "fraud_count": 0,
            "high_risk_count": 0,
        }
        agg["total_count"] += 1
        agg["total_amount"] += amount
        agg["fraud_count"] += int(is_fraud)
        agg["high_risk_count"] += int(high_risk)
        agg["fraud_rate"] = agg["fraud_count"] / agg["total_count"]
        agg["avg_amount"] = agg["total_amount"] / agg["total_count"]
        self._backend.put(f"agg:{key}", agg, self.ttl_s, now)

    def get(self, key: str, now: float | None = None) -> Dict[str, Any]:
        return self._backend.get(f"agg:{key}", now) or {}
