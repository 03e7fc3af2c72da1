"""Windowed stream joins: the reference's StreamJoiner.

Port of the JAX package's ``stream/joins.py`` (host-only), the
reference's Flink join layer (StreamJoiner.java:29-127):

    1. txn x user-behavior        keyBy user,      tumbling 5m
    2. txn x merchant-update      keyBy merchant,  tumbling 10m
    3. txn x historical-pattern   keyBy (payment, category, amount//100),
                                                   tumbling 1h, similarity-
                                                   scored risk factors
    4. multi-stream correlation   connected per-user streams (txn + behavior
                                  + device + network) -> complex events

The reference wires the join graphs but every event class they join against
(UserBehaviorEvent, MerchantProfileUpdate, HistoricalFraudPattern,
ComplexEvent, EnrichedTransaction — StreamJoiner.java:29-127) is missing
from its tree (SURVEY.md §0.2); the schemas here are reconstructed from the
getter calls in the join functions. Join outputs are enriched-transaction
dicts: the original txn fields plus a ``risk_factors`` map and the joined
context, matching the addRiskFactor/addContext usage.

Engine: inner join over per-(key, window) buffers of both sides, emitted as
a cross product when the combined watermark (min of both streams'
max_event_time - out_of_orderness) passes the window end — the semantics of
Flink's tumbling-window join with bounded out-of-orderness watermarks.
Single-writer discipline, same as stream/windows.py.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from realtime_fraud_detection_tpu_torch.stream.windows import TumblingWindow

__all__ = [
    "WindowJoin", "MultiStreamCorrelator",
    "txn_user_behavior_join", "txn_merchant_update_join",
    "txn_historical_pattern_join",
    "pattern_similarity", "historical_pattern_key",
]

Event = Mapping[str, Any]
JoinFn = Callable[[Event, Event], Dict[str, Any]]

TXN_OOO_S = 5.0                 # StreamJoiner.java:36 (5s txn watermark)
PATTERN_OOO_S = 60.0            # :94 (1m for the historical-pattern side)


class WindowJoin:
    """Inner join of two keyed streams over tumbling event-time windows.

    ``process_left`` / ``process_right`` buffer events; pairs for a window
    are emitted (via ``join_fn``) once the combined watermark passes the
    window end. Returns newly fired joined records.
    """

    def __init__(
        self,
        name: str,
        window: TumblingWindow,
        left_key: Callable[[Event], str],
        right_key: Callable[[Event], str],
        join_fn: JoinFn,
        left_ooo_s: float = TXN_OOO_S,
        right_ooo_s: float = TXN_OOO_S,
    ):
        self.name = name
        self.window = window
        self.left_key = left_key
        self.right_key = right_key
        self.join_fn = join_fn
        self.left_ooo_s = left_ooo_s
        self.right_ooo_s = right_ooo_s
        # (key, window) -> ([left events], [right events])
        self._buffers: Dict[Tuple[str, Tuple[float, float]],
                            Tuple[List[Event], List[Event]]] = {}
        self._left_max_ts = -math.inf
        self._right_max_ts = -math.inf
        self._fired_wm = -math.inf    # watermark at the last eviction scan
        self._min_open_end = math.inf  # earliest buffered window end
        self.joined = 0
        self.late_dropped = 0

    @property
    def watermark(self) -> float:
        """Joint watermark: min of both inputs' watermarks (Flink aligns
        watermarks across a two-input operator)."""
        return min(self._left_max_ts - self.left_ooo_s,
                   self._right_max_ts - self.right_ooo_s)

    def _add(self, side: int, key: str, event: Event,
             ts: float) -> List[Dict[str, Any]]:
        (start, end), = self.window.assign(ts)
        if end <= self.watermark:
            self.late_dropped += 1
        else:
            slot = self._buffers.get((key, (start, end)))
            if slot is None:
                slot = self._buffers[(key, (start, end))] = ([], [])
                self._min_open_end = min(self._min_open_end, end)
            slot[side].append(event)
        return self.advance_watermark()

    def process_left(self, event: Event, ts: float) -> List[Dict[str, Any]]:
        self._left_max_ts = max(self._left_max_ts, ts)
        return self._add(0, self.left_key(event), event, ts)

    def process_right(self, event: Event, ts: float) -> List[Dict[str, Any]]:
        self._right_max_ts = max(self._right_max_ts, ts)
        return self._add(1, self.right_key(event), event, ts)

    def advance_watermark(self) -> List[Dict[str, Any]]:
        wm = self.watermark
        # fast exit when the joint watermark hasn't advanced or hasn't yet
        # crossed the earliest buffered window's end (hot path)
        if wm <= self._fired_wm or wm < self._min_open_end:
            if wm > self._fired_wm:
                self._fired_wm = wm
            return []
        self._fired_wm = wm
        out: List[Dict[str, Any]] = []
        ready = sorted([kw for kw in self._buffers if kw[1][1] <= wm],
                       key=lambda kw: kw[1][1])
        for kw in ready:
            lefts, rights = self._buffers.pop(kw)
            for le in lefts:
                for re in rights:
                    out.append(self.join_fn(le, re))
                    self.joined += 1
        self._min_open_end = min(
            (kw[1][1] for kw in self._buffers), default=math.inf)
        return out

    def flush(self) -> List[Dict[str, Any]]:
        """End-of-stream: join every buffered window."""
        out: List[Dict[str, Any]] = []
        for kw in sorted(self._buffers, key=lambda kw: kw[1][1]):
            lefts, rights = self._buffers.pop(kw)
            for le in lefts:
                for re in rights:
                    out.append(self.join_fn(le, re))
                    self.joined += 1
        self._min_open_end = math.inf
        return out

    def __len__(self) -> int:
        return len(self._buffers)


# ------------------------------------------------------------ join function 1
def _enrich(txn: Event, risk_factors: Dict[str, float],
            context_key: str, context: Event) -> Dict[str, Any]:
    enriched = dict(txn)
    rf = dict(enriched.get("risk_factors") or {})
    rf.update({k: v for k, v in risk_factors.items() if v})
    enriched["risk_factors"] = rf
    enriched[context_key] = dict(context)
    return enriched


def _join_user_behavior(txn: Event, behavior: Event) -> Dict[str, Any]:
    """TransactionUserBehaviorJoinFunction (StreamJoiner.java:193-216):
    anomalous login 0.3, short session 0.2, anomalous navigation 0.25."""
    return _enrich(txn, {
        "recent_login_anomaly": 0.3 if behavior.get("anomalous_login") else 0.0,
        "session_duration_anomaly": 0.2 if behavior.get("short_session") else 0.0,
        "navigation_pattern_anomaly":
            0.25 if behavior.get("anomalous_navigation") else 0.0,
    }, "user_behavior_context", behavior)


def txn_user_behavior_join() -> WindowJoin:
    """txn x user-behavior, keyBy user, tumbling 5m (:29-49)."""
    return WindowJoin(
        "txn_user_behavior", TumblingWindow(300.0),
        lambda t: str(t.get("user_id")), lambda b: str(b.get("user_id")),
        _join_user_behavior)


# ------------------------------------------------------------ join function 2
def _join_merchant_update(txn: Event, update: Event) -> Dict[str, Any]:
    """TransactionMerchantUpdateJoinFunction (:218-244): risk-level increase
    0.4, fraud-rate increase 0.3, newly blacklisted 0.8."""
    return _enrich(txn, {
        "merchant_risk_increase":
            0.4 if update.get("risk_level_increased") else 0.0,
        "merchant_fraud_rate_increase":
            0.3 if update.get("fraud_rate_increased") else 0.0,
        "merchant_newly_blacklisted":
            0.8 if update.get("newly_blacklisted") else 0.0,
    }, "merchant_update_context", update)


def txn_merchant_update_join() -> WindowJoin:
    """txn x merchant-profile-update, keyBy merchant, tumbling 10m (:52-76)."""
    return WindowJoin(
        "txn_merchant_update", TumblingWindow(600.0),
        lambda t: str(t.get("merchant_id")),
        lambda u: str(u.get("merchant_id")),
        _join_merchant_update)


# ------------------------------------------------------------ join function 3
def historical_pattern_key(payment_method: Any, category: Any,
                           amount: float) -> str:
    """Composite pattern key (TransactionPatternKeySelector, :160-170):
    payment method, merchant category, amount rounded down to 100s."""
    return (f"{payment_method or 'unknown'}:{category or 'unknown'}:"
            f"{math.floor(float(amount or 0.0) / 100) * 100:.0f}")


def pattern_similarity(txn: Event, pattern: Event) -> float:
    """calculatePatternSimilarity (:278-301): payment-method 0.3 + amount
    closeness 0.4 + hour-of-day closeness 0.3, capped at 1."""
    sim = 0.0
    if txn.get("payment_method") and (
            txn.get("payment_method") == pattern.get("payment_method")):
        sim += 0.3
    t_amount = float(txn.get("amount") or 0.0)
    p_amount = float(pattern.get("amount_range") or 0.0)
    denom = max(t_amount, p_amount)
    if denom > 0:
        sim += max(0.0, 1.0 - abs(t_amount - p_amount) / denom) * 0.4
    t_hour, p_hour = txn.get("hour_of_day"), pattern.get("hour_of_day")
    if t_hour is not None and p_hour is not None:
        sim += max(0.0, 1.0 - abs(int(t_hour) - int(p_hour)) / 12.0) * 0.3
    return min(1.0, sim)


def _join_historical_pattern(txn: Event, pattern: Event) -> Dict[str, Any]:
    """TransactionHistoricalPatternJoinFunction (:246-276)."""
    fraud_rate = float(pattern.get("fraud_rate") or 0.0)
    factors = {
        "historical_pattern_similarity":
            pattern_similarity(txn, pattern) * fraud_rate,
    }
    if pattern.get("recent_pattern") and fraud_rate > 0.5:
        factors["recent_high_fraud_pattern"] = 0.4
    if int(pattern.get("occurrence_count") or 0) > 100 and fraud_rate > 0.3:
        factors["frequent_fraud_pattern"] = 0.3
    return _enrich(txn, factors, "historical_pattern_context", pattern)


def txn_historical_pattern_join() -> WindowJoin:
    """txn x historical-fraud-pattern, keyed by the composite pattern key,
    tumbling 1h, pattern side with a 1m watermark (:79-103)."""
    def txn_key(t: Event) -> str:
        return historical_pattern_key(
            t.get("payment_method"), t.get("merchant_category"),
            float(t.get("amount") or 0.0))

    def pattern_key(p: Event) -> str:
        return historical_pattern_key(
            p.get("payment_method"), p.get("merchant_category"),
            float(p.get("amount_range") or 0.0))

    return WindowJoin(
        "txn_historical_pattern", TumblingWindow(3600.0),
        txn_key, pattern_key, _join_historical_pattern,
        right_ooo_s=PATTERN_OOO_S)


# -------------------------------------------------------------- correlation
class MultiStreamCorrelator:
    """Per-user complex-event correlation across four streams
    (connectMultipleStreams, :106-127 — the reference's
    MultiStreamCorrelationFunction does not exist; semantics designed here).

    Keeps a rolling horizon of behavior / device / network events per user;
    each transaction is correlated against them and emits a ComplexEvent
    when at least ``min_signals`` anomalous signals coincide:
    anomalous behavior, a new/changed device, and a risky network origin.
    """

    def __init__(self, horizon_s: float = 300.0, min_signals: int = 2,
                 max_events_per_user: int = 50,
                 sweep_interval_events: int = 10_000):
        self.horizon_s = horizon_s
        self.min_signals = min_signals
        self.max_events = max_events_per_user
        self.sweep_interval = sweep_interval_events
        self._behavior: Dict[str, deque] = {}
        self._device: Dict[str, deque] = {}
        self._network: Dict[str, deque] = {}
        self._max_ts = -math.inf
        self._ops_since_sweep = 0
        self.emitted = 0

    def _push(self, table: Dict[str, deque], user: str, event: Event,
              ts: float) -> None:
        q = table.setdefault(user, deque(maxlen=self.max_events))
        q.append((ts, dict(event)))
        self._max_ts = max(self._max_ts, ts)
        self._ops_since_sweep += 1
        if self._ops_since_sweep >= self.sweep_interval:
            self.sweep()

    def sweep(self) -> int:
        """Evict users whose newest event fell behind the horizon — bounds
        memory at (active users in horizon) x max_events instead of growing
        with all-time user cardinality."""
        cutoff = self._max_ts - self.horizon_s
        evicted = 0
        for table in (self._behavior, self._device, self._network):
            stale = [u for u, q in table.items() if not q or q[-1][0] < cutoff]
            for u in stale:
                del table[u]
                evicted += 1
        self._ops_since_sweep = 0
        return evicted

    def on_behavior(self, event: Event, ts: float) -> None:
        self._push(self._behavior, str(event.get("user_id")), event, ts)

    def on_device(self, event: Event, ts: float) -> None:
        self._push(self._device, str(event.get("user_id")), event, ts)

    def on_network(self, event: Event, ts: float) -> None:
        self._push(self._network, str(event.get("user_id")), event, ts)

    def _recent(self, table: Dict[str, deque], user: str,
                ts: float) -> List[Event]:
        return [e for (t, e) in table.get(user, ())
                if ts - self.horizon_s <= t <= ts]

    def on_transaction(self, txn: Event,
                       ts: float) -> Optional[Dict[str, Any]]:
        user = str(txn.get("user_id"))
        behavior = self._recent(self._behavior, user, ts)
        device = self._recent(self._device, user, ts)
        network = self._recent(self._network, user, ts)

        signals: Dict[str, Any] = {}
        if any(b.get("anomalous_login") or b.get("anomalous_navigation")
               for b in behavior):
            signals["anomalous_behavior"] = True
        if any(d.get("is_new_device") or d.get("fingerprint_changed")
               for d in device):
            signals["device_change"] = True
        if any(n.get("is_proxy") or n.get("is_vpn")
               or n.get("country_mismatch") for n in network):
            signals["risky_network"] = True
        if float(txn.get("amount") or 0.0) > 5000:
            signals["large_amount"] = True

        if len(signals) < self.min_signals:
            return None
        self.emitted += 1
        return {
            "event_type": "COMPLEX_CORRELATION",
            "transaction_id": txn.get("transaction_id"),
            "user_id": user,
            "signals": signals,
            "signal_count": len(signals),
            "correlated_events": {
                "behavior": len(behavior),
                "device": len(device),
                "network": len(network),
            },
            "timestamp": ts,
        }
