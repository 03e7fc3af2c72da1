"""Event-time windowed analytics: the reference's WindowProcessor.

Port of the JAX package's ``stream/windows.py`` (host-only), the
reference's Flink windowing layer (WindowProcessor.java:36-166): seven
keyed window computations over the transaction stream:

    1. user velocity        keyBy user,            sliding 5m / 1m
    2. merchant patterns    keyBy merchant,        tumbling 1h
    3. user sessions        keyBy user,            session gap 30m
    4. geo clustering       keyBy 1-degree grid,   tumbling 15m
    5. fraud patterns       keyBy (payment, category, amount-bucket),
                                                   sliding 10m / 2m
    6. high frequency       keyBy user,            tumbling 5m + count-10
                                                   early trigger
    7. amount clustering    keyBy log10 bucket,    tumbling 30m

The reference defines all seven stream graphs but implements only the first
two aggregate functions (WindowProcessor.java:486-487, SURVEY.md §0.2); here
all seven are real, on one event-time engine with bounded-out-of-orderness
watermarks (10 s, the reference's WatermarkStrategy; 5 s for the
high-frequency path).

Single writer: windows live in plain dicts keyed by (key, window_start);
a watermark advance fires and evicts closed windows. The merchant amount
spread uses Welford's online (count, mean, M2) instead of the reference's
keep-every-amount list: the same population std-dev in O(1) state a window.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Tuple

__all__ = [
    "SlidingWindow", "TumblingWindow", "SessionWindow", "WindowOperator",
    "WindowedAnalytics",
    "user_velocity_windows", "merchant_pattern_windows",
    "user_session_windows", "geo_cluster_windows", "fraud_pattern_windows",
    "high_frequency_windows", "amount_cluster_windows",
    "geo_grid_key", "fraud_pattern_key", "amount_cluster_key",
    "amount_bucket",
]

DEFAULT_OUT_OF_ORDERNESS_S = 10.0     # WindowProcessor.java:41

Txn = Mapping[str, Any]


# --------------------------------------------------------------- assigners
@dataclasses.dataclass(frozen=True)
class SlidingWindow:
    """SlidingEventTimeWindows.of(size, slide) — one event lands in
    size/slide overlapping windows."""

    size_s: float
    slide_s: float

    def assign(self, ts: float) -> List[Tuple[float, float]]:
        last_start = ts - (ts % self.slide_s)
        out = []
        start = last_start
        while start > ts - self.size_s:
            out.append((start, start + self.size_s))
            start -= self.slide_s
        return out


@dataclasses.dataclass(frozen=True)
class TumblingWindow:
    size_s: float

    def assign(self, ts: float) -> List[Tuple[float, float]]:
        start = ts - (ts % self.size_s)
        return [(start, start + self.size_s)]


@dataclasses.dataclass(frozen=True)
class SessionWindow:
    """SessionWindows.withGap — per-event window [ts, ts+gap) that merges
    with any overlapping session of the same key."""

    gap_s: float

    def assign(self, ts: float) -> List[Tuple[float, float]]:
        return [(ts, ts + self.gap_s)]


# ------------------------------------------------------------- aggregates
class Aggregate:
    """AggregateFunction contract: fresh accumulator, add, merge, result."""

    def create(self) -> Any:
        raise NotImplementedError

    def add(self, acc: Any, txn: Txn, ts: float) -> None:
        raise NotImplementedError

    def merge(self, a: Any, b: Any) -> Any:
        raise NotImplementedError

    def result(self, acc: Any, key: str,
               window: Tuple[float, float]) -> Dict[str, Any]:
        raise NotImplementedError


def _base_result(key_field: str, key: str, window: Tuple[float, float],
                 acc: "_BaseAcc") -> Dict[str, Any]:
    n = acc.count
    return {
        key_field: key,
        "window_start": window[0],
        "window_end": window[1],
        "event_time_start": acc.first_ts,
        "event_time_end": acc.last_ts,
        "transaction_count": n,
        "total_amount": acc.total,
        "avg_amount": acc.total / n if n else 0.0,
        "fraud_count": acc.fraud,
        "fraud_rate": acc.fraud / n if n else 0.0,
        "high_risk_count": acc.high_risk,
    }


@dataclasses.dataclass
class _BaseAcc:
    count: int = 0
    total: float = 0.0
    fraud: int = 0
    high_risk: int = 0
    first_ts: float = math.inf
    last_ts: float = -math.inf

    def take(self, txn: Txn, ts: float) -> None:
        self.count += 1
        self.total += float(txn.get("amount") or 0.0)
        if txn.get("is_fraud"):
            self.fraud += 1
        if float(txn.get("fraud_score") or 0.0) > 0.7:
            self.high_risk += 1
        self.first_ts = min(self.first_ts, ts)
        self.last_ts = max(self.last_ts, ts)

    def fold(self, other: "_BaseAcc") -> None:
        self.count += other.count
        self.total += other.total
        self.fraud += other.fraud
        self.high_risk += other.high_risk
        self.first_ts = min(self.first_ts, other.first_ts)
        self.last_ts = max(self.last_ts, other.last_ts)


@dataclasses.dataclass
class _VelocityAcc(_BaseAcc):
    merchants: set = dataclasses.field(default_factory=set)
    payment_methods: set = dataclasses.field(default_factory=set)


class UserVelocityAggregate(Aggregate):
    """UserVelocityAggregateFunction (WindowProcessor.java:248-352)."""

    def create(self) -> _VelocityAcc:
        return _VelocityAcc()

    def add(self, acc: _VelocityAcc, txn: Txn, ts: float) -> None:
        acc.take(txn, ts)
        acc.merchants.add(str(txn.get("merchant_id")))
        pm = txn.get("payment_method")
        if pm:
            acc.payment_methods.add(str(pm))

    def merge(self, a: _VelocityAcc, b: _VelocityAcc) -> _VelocityAcc:
        a.fold(b)
        a.merchants |= b.merchants
        a.payment_methods |= b.payment_methods
        return a

    def result(self, acc, key, window):
        out = _base_result("user_id", key, window, acc)
        out["unique_merchant_count"] = len(acc.merchants)
        out["unique_payment_method_count"] = len(acc.payment_methods)
        out["velocity_score"] = self._velocity_score(acc)
        return out

    @staticmethod
    def _velocity_score(acc: _VelocityAcc) -> float:
        """(WindowProcessor.java:328-351) count, amount, fraud-rate, and
        low-merchant-diversity factors, capped at 1."""
        score = 0.0
        if acc.count > 20:
            score += 0.4
        elif acc.count > 10:
            score += 0.2
        elif acc.count > 5:
            score += 0.1
        if acc.total > 10_000:
            score += 0.3
        elif acc.total > 5_000:
            score += 0.2
        elif acc.total > 1_000:
            score += 0.1
        if acc.count:
            score += (acc.fraud / acc.count) * 0.4
            if len(acc.merchants) / acc.count < 0.2:
                score += 0.2
        return min(1.0, score)


@dataclasses.dataclass
class _MerchantAcc(_BaseAcc):
    fraud_amount: float = 0.0
    users: set = dataclasses.field(default_factory=set)
    payment_methods: set = dataclasses.field(default_factory=set)
    # Welford state for amount std-dev
    mean: float = 0.0
    m2: float = 0.0


class MerchantPatternAggregate(Aggregate):
    """MerchantAggregateFunction (WindowProcessor.java:358-489) with Welford
    replacing the stored-amounts list."""

    def create(self) -> _MerchantAcc:
        return _MerchantAcc()

    def add(self, acc: _MerchantAcc, txn: Txn, ts: float) -> None:
        acc.take(txn, ts)
        amount = float(txn.get("amount") or 0.0)
        if txn.get("is_fraud"):
            acc.fraud_amount += amount
        acc.users.add(str(txn.get("user_id")))
        pm = txn.get("payment_method")
        if pm:
            acc.payment_methods.add(str(pm))
        delta = amount - acc.mean
        acc.mean += delta / acc.count
        acc.m2 += delta * (amount - acc.mean)

    def merge(self, a: _MerchantAcc, b: _MerchantAcc) -> _MerchantAcc:
        # Chan's parallel Welford merge
        n = a.count + b.count
        if b.count:
            delta = b.mean - a.mean
            if n:
                a.m2 = a.m2 + b.m2 + delta * delta * a.count * b.count / n
                a.mean = (a.mean * a.count + b.mean * b.count) / n
        a.fold(b)
        a.fraud_amount += b.fraud_amount
        a.users |= b.users
        a.payment_methods |= b.payment_methods
        return a

    def result(self, acc, key, window):
        out = _base_result("merchant_id", key, window, acc)
        std = math.sqrt(acc.m2 / acc.count) if acc.count >= 2 else 0.0
        out["fraud_amount"] = acc.fraud_amount
        out["unique_user_count"] = len(acc.users)
        out["unique_payment_method_count"] = len(acc.payment_methods)
        out["amount_std_dev"] = std
        out["risk_score"] = self._risk_score(acc, std)
        return out

    @staticmethod
    def _risk_score(acc: _MerchantAcc, std: float) -> float:
        """(WindowProcessor.java:460-484) fraud rate, volume, amount
        dispersion, and low-user-diversity factors, capped at 1."""
        score = 0.0
        if acc.count:
            score += (acc.fraud / acc.count) * 0.5
        if acc.count > 1000:
            score += 0.2
        elif acc.count > 500:
            score += 0.1
        avg = acc.total / acc.count if acc.count else 0.0
        if avg > 0 and std / avg > 2.0:
            score += 0.2
        if acc.count and len(acc.users) / acc.count < 0.1:
            score += 0.3
        return min(1.0, score)


@dataclasses.dataclass
class _SessionAcc(_BaseAcc):
    merchants: set = dataclasses.field(default_factory=set)
    max_amount: float = 0.0


class UserSessionAggregate(Aggregate):
    """Session analytics (the reference's UserSessionAggregateFunction is
    referenced but never written — designed here): duration, tempo, burst
    intensity of one user session."""

    def create(self) -> _SessionAcc:
        return _SessionAcc()

    def add(self, acc: _SessionAcc, txn: Txn, ts: float) -> None:
        acc.take(txn, ts)
        acc.merchants.add(str(txn.get("merchant_id")))
        acc.max_amount = max(acc.max_amount, float(txn.get("amount") or 0.0))

    def merge(self, a: _SessionAcc, b: _SessionAcc) -> _SessionAcc:
        a.fold(b)
        a.merchants |= b.merchants
        a.max_amount = max(a.max_amount, b.max_amount)
        return a

    def result(self, acc, key, window):
        out = _base_result("user_id", key, window, acc)
        duration = max(0.0, acc.last_ts - acc.first_ts)
        out["session_duration_s"] = duration
        out["unique_merchant_count"] = len(acc.merchants)
        out["max_amount"] = acc.max_amount
        # txns per minute of active session (>=1-minute floor so one-txn
        # sessions don't divide by ~0)
        out["transactions_per_minute"] = acc.count / max(duration / 60.0, 1.0)
        return out


@dataclasses.dataclass
class _GeoAcc(_BaseAcc):
    users: set = dataclasses.field(default_factory=set)
    merchants: set = dataclasses.field(default_factory=set)


class GeoClusterAggregate(Aggregate):
    """Per-1-degree-grid activity (GeographicAggregateFunction analog)."""

    def create(self) -> _GeoAcc:
        return _GeoAcc()

    def add(self, acc: _GeoAcc, txn: Txn, ts: float) -> None:
        acc.take(txn, ts)
        acc.users.add(str(txn.get("user_id")))
        acc.merchants.add(str(txn.get("merchant_id")))

    def merge(self, a: _GeoAcc, b: _GeoAcc) -> _GeoAcc:
        a.fold(b)
        a.users |= b.users
        a.merchants |= b.merchants
        return a

    def result(self, acc, key, window):
        out = _base_result("geo_key", key, window, acc)
        out["unique_user_count"] = len(acc.users)
        out["unique_merchant_count"] = len(acc.merchants)
        return out


class FraudPatternAggregate(Aggregate):
    """Per (payment-method, merchant-category, amount-bucket) pattern cell
    (FraudPatternAggregateFunction analog)."""

    def create(self) -> _BaseAcc:
        return _BaseAcc()

    def add(self, acc: _BaseAcc, txn: Txn, ts: float) -> None:
        acc.take(txn, ts)

    def merge(self, a: _BaseAcc, b: _BaseAcc) -> _BaseAcc:
        a.fold(b)
        return a

    def result(self, acc, key, window):
        return _base_result("pattern_key", key, window, acc)


class HighFrequencyAggregate(Aggregate):
    """Early-firing burst detector (HighFrequencyAggregateFunction analog):
    fires every `trigger_count` events inside the 5m window."""

    def create(self) -> _BaseAcc:
        return _BaseAcc()

    def add(self, acc: _BaseAcc, txn: Txn, ts: float) -> None:
        acc.take(txn, ts)

    def merge(self, a: _BaseAcc, b: _BaseAcc) -> _BaseAcc:
        a.fold(b)
        return a

    def result(self, acc, key, window):
        out = _base_result("user_id", key, window, acc)
        span = max(1.0, acc.last_ts - acc.first_ts)
        out["alert_type"] = "HIGH_FREQUENCY"
        out["transactions_per_second"] = acc.count / span
        return out


class AmountClusterAggregate(Aggregate):
    """Per log-bucket amount concentration (AmountClusterAggregateFunction
    analog). High same-bucket counts reveal structuring (many just-below-
    threshold amounts land in the same 9xxx bucket)."""

    def create(self) -> _BaseAcc:
        return _BaseAcc()

    def add(self, acc: _BaseAcc, txn: Txn, ts: float) -> None:
        acc.take(txn, ts)

    def merge(self, a: _BaseAcc, b: _BaseAcc) -> _BaseAcc:
        a.fold(b)
        return a

    def result(self, acc, key, window):
        return _base_result("amount_bucket", key, window, acc)


# ------------------------------------------------------------- key selectors
def geo_grid_key(txn: Txn) -> str:
    """1-degree grid key (GeographicKeySelector, WindowProcessor.java:173-193)."""
    geo = txn.get("geolocation") or {}
    lat, lon = geo.get("lat"), geo.get("lon")
    if lat is None or lon is None:
        return "unknown"
    return f"geo_{math.floor(float(lat))}_{math.floor(float(lon))}"


def amount_bucket(amount: float) -> str:
    """Range buckets (FraudPatternKeySelector.getAmountBucket, :213-221)."""
    if amount < 10:
        return "micro"
    if amount < 100:
        return "small"
    if amount < 500:
        return "medium"
    if amount < 2000:
        return "large"
    if amount < 10000:
        return "very_large"
    return "extreme"


def fraud_pattern_key(txn: Txn) -> str:
    """(payment, merchant-category, amount-bucket) cell key
    (FraudPatternKeySelector, :198-222)."""
    pm = txn.get("payment_method") or "unknown"
    cat = txn.get("merchant_category") or "unknown"
    amount = float(txn.get("amount") or 0.0)
    return f"pattern_{pm}_{cat}_{amount_bucket(amount)}"


def amount_cluster_key(txn: Txn) -> str:
    """Logarithmic bucket key (AmountClusterKeySelector, :227-242):
    amount_{floor(log10)}_{leading digit band}."""
    amount = float(txn.get("amount") or 0.0)
    if amount <= 0:
        return "zero"
    bucket = math.floor(math.log10(amount))
    sub = math.floor(amount / (10.0 ** bucket))
    return f"amount_{bucket}_{sub}"


# ---------------------------------------------------------------- operator
class WindowOperator:
    """One keyed event-time window computation.

    ``process(txn, ts)`` adds the event and returns any results fired by a
    count trigger; ``advance_watermark(ts)`` (called automatically as event
    time progresses) closes windows whose end precedes
    watermark = max_event_time - out_of_orderness and returns their results.
    Late events (behind the watermark) are counted and dropped, mirroring
    Flink's default lateness handling.
    """

    def __init__(
        self,
        name: str,
        key_fn: Callable[[Txn], str],
        assigner: SlidingWindow | TumblingWindow | SessionWindow,
        aggregate: Aggregate,
        out_of_orderness_s: float = DEFAULT_OUT_OF_ORDERNESS_S,
        trigger_count: Optional[int] = None,
    ):
        self.name = name
        self.key_fn = key_fn
        self.assigner = assigner
        self.agg = aggregate
        self.ooo_s = out_of_orderness_s
        self.trigger_count = trigger_count
        self._is_session = isinstance(assigner, SessionWindow)
        # (key, (start, end)) -> (accumulator, events_since_fire)
        self._windows: Dict[Tuple[str, Tuple[float, float]], List[Any]] = {}
        self.max_event_ts = -math.inf
        self._fired_wm = -math.inf    # watermark at the last eviction scan
        # earliest end among open windows (may be stale-low after session
        # merges — that only costs an occasional no-op scan, never misses)
        self._min_open_end = math.inf
        self.late_dropped = 0
        self.fired = 0

    @property
    def watermark(self) -> float:
        return self.max_event_ts - self.ooo_s

    def process(self, txn: Txn, ts: float) -> List[Dict[str, Any]]:
        self.max_event_ts = max(self.max_event_ts, ts)
        wm = self.watermark
        key = self.key_fn(txn)
        fired: List[Dict[str, Any]] = []
        if self._is_session:
            if ts + self.assigner.gap_s > wm:
                self._add_session(key, txn, ts)
            else:
                self.late_dropped += 1
        else:
            # an element is late only when ALL its windows are already
            # closed (Flink semantics) — a slightly-late event still lands
            # in its open windows
            open_windows = [w for w in self.assigner.assign(ts) if w[1] > wm]
            if not open_windows:
                self.late_dropped += 1
            for window in open_windows:
                slot = self._windows.get((key, window))
                if slot is None:
                    slot = self._windows[(key, window)] = [self.agg.create(), 0]
                    self._min_open_end = min(self._min_open_end, window[1])
                self.agg.add(slot[0], txn, ts)
                slot[1] += 1
                if self.trigger_count and slot[1] >= self.trigger_count:
                    # early fire: emit current aggregate, keep accumulating
                    # (Flink CountTrigger FIREs without purging)
                    fired.append(self.agg.result(slot[0], key, window))
                    self.fired += 1
                    slot[1] = 0
        fired.extend(self.advance_watermark(self.max_event_ts))
        return fired

    def _add_session(self, key: str, txn: Txn, ts: float) -> None:
        """Merge the event's [ts, ts+gap) window with overlapping sessions."""
        (start, end), = self.assigner.assign(ts)
        acc = self.agg.create()
        self.agg.add(acc, txn, ts)
        merged_keys = [
            (k, w) for (k, w) in self._windows
            if k == key and w[0] <= end and start <= w[1]
        ]
        for k_w in merged_keys:
            other_acc, _ = self._windows.pop(k_w)
            acc = self.agg.merge(acc, other_acc)
            start = min(start, k_w[1][0])
            end = max(end, k_w[1][1])
        self._windows[(key, (start, end))] = [acc, 0]
        self._min_open_end = min(self._min_open_end, end)

    def advance_watermark(self, event_ts: Optional[float] = None
                          ) -> List[Dict[str, Any]]:
        if event_ts is not None:
            self.max_event_ts = max(self.max_event_ts, event_ts)
        wm = self.watermark
        # hot-path fast exits: nothing to do unless the watermark moved AND
        # crossed the earliest open window's end (in-order streams advance
        # the watermark every event; without the second check each event
        # would pay a full open-window scan)
        if wm <= self._fired_wm or wm < self._min_open_end:
            if wm > self._fired_wm:
                self._fired_wm = wm
            return []
        self._fired_wm = wm
        fired = []
        for (key, window) in sorted(
                [kw for kw in self._windows if kw[1][1] <= wm],
                key=lambda kw: kw[1][1]):
            acc, _ = self._windows.pop((key, window))
            fired.append(self.agg.result(acc, key, window))
            self.fired += 1
        self._min_open_end = min(
            (kw[1][1] for kw in self._windows), default=math.inf)
        return fired

    def flush(self) -> List[Dict[str, Any]]:
        """Close every open window (end-of-stream)."""
        fired = []
        for (key, window) in sorted(self._windows, key=lambda kw: kw[1][1]):
            acc, _ = self._windows.pop((key, window))
            fired.append(self.agg.result(acc, key, window))
            self.fired += 1
        self._min_open_end = math.inf
        return fired

    def __len__(self) -> int:
        return len(self._windows)


# ------------------------------------------------------------ constructors
def user_velocity_windows() -> WindowOperator:
    """Sliding 5m/1m per-user velocity (WindowProcessor.java:36-52)."""
    return WindowOperator(
        "user_velocity", lambda t: str(t.get("user_id")),
        SlidingWindow(300.0, 60.0), UserVelocityAggregate())


def merchant_pattern_windows() -> WindowOperator:
    """Tumbling 1h per-merchant patterns (:55-71)."""
    return WindowOperator(
        "merchant_patterns", lambda t: str(t.get("merchant_id")),
        TumblingWindow(3600.0), MerchantPatternAggregate())


def user_session_windows() -> WindowOperator:
    """30m-gap user sessions (:74-90)."""
    return WindowOperator(
        "user_sessions", lambda t: str(t.get("user_id")),
        SessionWindow(1800.0), UserSessionAggregate())


def geo_cluster_windows() -> WindowOperator:
    """Tumbling 15m per geo grid cell (:93-109)."""
    return WindowOperator(
        "geo_clusters", geo_grid_key, TumblingWindow(900.0),
        GeoClusterAggregate())


def fraud_pattern_windows() -> WindowOperator:
    """Sliding 10m/2m per pattern cell (:112-126)."""
    return WindowOperator(
        "fraud_patterns", fraud_pattern_key, SlidingWindow(600.0, 120.0),
        FraudPatternAggregate())


def high_frequency_windows(trigger_count: int = 10) -> WindowOperator:
    """Tumbling 5m per user with count-10 early trigger, 5s watermark
    (:129-150)."""
    return WindowOperator(
        "high_frequency", lambda t: str(t.get("user_id")),
        TumblingWindow(300.0), HighFrequencyAggregate(),
        out_of_orderness_s=5.0, trigger_count=trigger_count)


def amount_cluster_windows() -> WindowOperator:
    """Tumbling 30m per log-amount bucket (:153-169)."""
    return WindowOperator(
        "amount_clusters", amount_cluster_key, TumblingWindow(1800.0),
        AmountClusterAggregate())


# --------------------------------------------------------------- composite
# result topic per operator (create-topics.sh stream-processing group)
ANALYTICS_TOPIC = {
    "user_velocity": "velocity-checks",
    "merchant_patterns": "merchant-transactions",
    "user_sessions": "user-sessions",
    "geo_clusters": "geographic-analysis",
    "fraud_patterns": "pattern-detection",
    "high_frequency": "velocity-checks",
    "amount_clusters": "transaction-metrics",
}


class WindowedAnalytics:
    """All seven window computations over one stream, fanning results out to
    the stream-processing topics (the analytics side of the reference's job
    graph, which it never attached; SURVEY.md §0.3)."""

    def __init__(self, broker=None,
                 operators: Optional[Iterable[WindowOperator]] = None):
        self.broker = broker
        self.operators = list(operators) if operators is not None else [
            user_velocity_windows(), merchant_pattern_windows(),
            user_session_windows(), geo_cluster_windows(),
            fraud_pattern_windows(), high_frequency_windows(),
            amount_cluster_windows(),
        ]

    def process(self, txn: Txn, ts: float) -> Dict[str, List[Dict[str, Any]]]:
        out: Dict[str, List[Dict[str, Any]]] = {}
        for op in self.operators:
            fired = op.process(txn, ts)
            if fired:
                out[op.name] = fired
                self._emit(op.name, fired)
        return out

    def flush(self) -> Dict[str, List[Dict[str, Any]]]:
        out = {}
        for op in self.operators:
            fired = op.flush()
            if fired:
                out[op.name] = fired
                self._emit(op.name, fired)
        return out

    def _emit(self, name: str, results: List[Dict[str, Any]]) -> None:
        if self.broker is None:
            return
        topic = ANALYTICS_TOPIC[name]
        for r in results:
            self.broker.produce(topic, r)

    def stats(self) -> Dict[str, Dict[str, float]]:
        return {
            op.name: {"open_windows": len(op), "fired": op.fired,
                      "late_dropped": op.late_dropped,
                      "watermark": op.watermark}
            for op in self.operators
        }
