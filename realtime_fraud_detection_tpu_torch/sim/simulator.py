"""Vectorized transaction load generator.

Port of the JAX package's ``sim/simulator.py`` (the reference data
simulator, simulator.py:159-476): 10k users with beta(2,8) risk and
lognormal(4,1) spend, 5k merchants from 10 category tuples with 2%
blacklisted, transactions with user x merchant amount factors and a ~5.5%
basic fraud mix. The same seed gives the same records, dict for dict, and
the same profiles as the JAX package's generator.

- ``generate_batch(n)``: transaction dicts in the reference JSON schema
  (simulator.py:78-101), with the stateful fraud appliers;
- ``generate_encoded(n)``: columns straight into a ``TransactionBatch`` +
  labels, vectorized in numpy.

- ``inject_fraud_ring(config)``: a coordinated ring (``FraudRing``) takes a
  ``config.rate`` share of the stream; the per-record draw happens only
  while a ring is set, so a stream without one is unchanged.
- ``inject_drift(rate)``: a ``rate`` share of the stream becomes the
  drifted fraud pattern (``fraud_type 'drifted_pattern'``) through the
  ``electronics`` merchants; its per-record draw happens only while the
  rate is above 0 and comes before the ring's, as in the JAX generator.
- ``label_events(txns, ...)``: delayed ground-truth label events for
  generated transactions (``feedback/labels.py make_label_events``), drawn
  from the generator's own ``rng``: calling it between ``generate_batch``
  calls moves every later record, in both packages alike.
"""

from __future__ import annotations

from datetime import datetime, timedelta, timezone
from typing import Any, Dict, List, Sequence

import numpy as np

from realtime_fraud_detection_tpu_torch.features.schema import (
    CARD_TYPES,
    KYC_STATUSES,
    MERCHANT_CATEGORIES,
    PAYMENT_METHODS,
    TRANSACTION_TYPES,
    TransactionBatch,
    encode_transactions,
)
from realtime_fraud_detection_tpu_torch.sim.fraud_patterns import (
    AdvancedFraudPatterns,
    BASIC_FRAUD_MIX,
    FraudRing,
    FraudRingConfig,
)

# (category, mcc, risk_level, avg_amount, fraud_rate) — simulator.py:255-266
MERCHANT_CATEGORY_TUPLES = (
    ("retail", "5399", "low", 50.0, 0.01),
    ("grocery", "5411", "low", 25.0, 0.005),
    ("gas_station", "5542", "medium", 40.0, 0.02),
    ("restaurant", "5812", "low", 35.0, 0.008),
    ("online_retail", "5399", "medium", 75.0, 0.025),
    ("gambling", "7995", "high", 200.0, 0.15),
    ("adult_entertainment", "5967", "high", 100.0, 0.12),
    ("pharmacy", "5912", "medium", 30.0, 0.01),
    ("jewelry", "5944", "high", 500.0, 0.08),
    ("electronics", "5732", "medium", 300.0, 0.03),
)

_SUSPICIOUS_TOKENS = ("Crypto Exchange", "Gift Card Outlet", "Wire Transfer Co",
                      "Casino Royale", "Bitcoin Mart")
_PLAIN_TOKENS = ("Market", "Store", "Shop", "House", "Depot", "Corner", "Bros")
_USER_AGENTS = (
    "Mozilla/5.0 (X11; Linux x86_64) AppleWebKit/537.36 Chrome/120.0",
    "Mozilla/5.0 (iPhone; CPU iPhone OS 17_0 like Mac OS X) Safari/604.1",
    "Mozilla/5.0 (Windows NT 10.0; Win64; x64) Gecko/20100101 Firefox/121.0",
    "Mozilla/5.0 (Macintosh; Intel Mac OS X 14_2) Version/17.2 Safari/605.1",
)


class UserPool:
    """Vectorized user profile pool (simulator.py:206-249 distributions)."""

    def __init__(self, n: int, rng: np.random.Generator):
        self.n = n
        self.ids = np.array([f"user_{i:08x}" for i in range(n)])
        self.risk_score = rng.beta(2, 8, n).astype(np.float32)
        self.avg_amount = rng.lognormal(4, 1, n).astype(np.float32)
        self.txn_frequency = (rng.gamma(2, 2, n).astype(np.int32) + 1)
        self.kyc_code = rng.choice(3, n, p=[0.85, 0.12, 0.03]).astype(np.int32)
        self.account_age_days = rng.uniform(0, 730, n).astype(np.float32)
        self.pref_start = rng.integers(6, 11, n).astype(np.int32)
        self.pref_end = rng.integers(18, 24, n).astype(np.int32)
        self.weekend_activity = rng.uniform(0.3, 1.0, n).astype(np.float32)
        self.intl_ratio = rng.uniform(0.0, 0.1, n).astype(np.float32)
        self.online_preference = rng.uniform(0.5, 0.95, n).astype(np.float32)
        self.home_lat = rng.uniform(-60, 60, n).astype(np.float32)
        self.home_lon = rng.uniform(-180, 180, n).astype(np.float32)
        n_dev = rng.integers(1, 4, n)
        self.device_fingerprints = [
            [f"dev_{i:08x}_{d}" for d in range(n_dev[i])] for i in range(n)
        ]

    def profile_dict(self, i: int) -> Dict[str, Any]:
        return {
            "user_id": str(self.ids[i]),
            "risk_score": float(self.risk_score[i]),
            "account_age_days": float(self.account_age_days[i]),
            "kyc_status": KYC_STATUSES[self.kyc_code[i]],
            "avg_transaction_amount": float(self.avg_amount[i]),
            "transaction_frequency": int(self.txn_frequency[i]),
            "device_fingerprints": list(self.device_fingerprints[i]),
            "behavioral_patterns": {
                "preferred_time_start": int(self.pref_start[i]),
                "preferred_time_end": int(self.pref_end[i]),
                "weekend_activity": float(self.weekend_activity[i]),
                "international_transactions": float(self.intl_ratio[i]),
                "online_preference": float(self.online_preference[i]),
            },
        }

    def profiles(self) -> Dict[str, Dict[str, Any]]:
        return {str(self.ids[i]): self.profile_dict(i) for i in range(self.n)}


class MerchantPool:
    """Vectorized merchant pool (simulator.py:251-296 distributions)."""

    def __init__(self, n: int, rng: np.random.Generator):
        self.n = n
        self.ids = np.array([f"merchant_{i:08x}" for i in range(n)])
        cat_idx = rng.integers(0, len(MERCHANT_CATEGORY_TUPLES), n)
        cats = [MERCHANT_CATEGORY_TUPLES[c] for c in cat_idx]
        self.category = np.array([c[0] for c in cats])
        self.category_code = np.array(
            [MERCHANT_CATEGORIES.index(c[0]) for c in cats], np.int32
        )
        self.mcc = np.array([c[1] for c in cats])
        self.risk_level = np.array([c[2] for c in cats])
        self.risk_code = np.array(
            [{"low": 0, "medium": 1, "high": 2}[c[2]] for c in cats], np.int32
        )
        self.avg_amount = np.array(
            [c[3] for c in cats], np.float32
        ) * rng.uniform(0.5, 2.0, n).astype(np.float32)
        self.fraud_rate = np.array([c[4] for c in cats], np.float32)
        self.is_blacklisted = rng.random(n) < 0.02
        self.op_start = rng.integers(6, 11, n).astype(np.int32)
        self.op_end = rng.integers(20, 25, n).astype(np.int32)
        self.lat = rng.uniform(-60, 60, n).astype(np.float32)
        self.lon = rng.uniform(-180, 180, n).astype(np.float32)
        suspicious = rng.random(n) < 0.05
        self.names = np.array([
            f"{'Biz'} {i} {(_SUSPICIOUS_TOKENS if suspicious[i] else _PLAIN_TOKENS)[int(rng.integers(0, 5))]}"
            for i in range(n)
        ])
        self.suspicious_name = suspicious
        # suspicious-named merchants really do attract more fraud
        self.fraud_rate = np.where(
            suspicious, np.minimum(self.fraud_rate * 3.0, 0.3), self.fraud_rate
        ).astype(np.float32)
        # per-merchant fraud multiplier, normalized so E[mult] == 1 over a
        # uniform merchant draw: total stream fraud stays at the documented
        # ~5.5% BASIC_FRAUD_MIX prevalence even after clipping
        raw_mult = np.clip(self.fraud_rate / max(self.fraud_rate.mean(), 1e-6), 0.2, 4.0)
        self.fraud_mult = (raw_mult / raw_mult.mean()).astype(np.float32)

    def profile_dict(self, i: int) -> Dict[str, Any]:
        return {
            "merchant_id": str(self.ids[i]),
            "name": str(self.names[i]),
            "category": str(self.category[i]),
            "mcc": str(self.mcc[i]),
            "risk_level": str(self.risk_level[i]),
            "avg_transaction_amount": float(self.avg_amount[i]),
            "fraud_rate": float(self.fraud_rate[i]),
            "is_blacklisted": bool(self.is_blacklisted[i]),
            "operating_hours": {
                "start_hour": str(int(self.op_start[i])),
                "end_hour": str(int(self.op_end[i])),
            },
        }

    def profiles(self) -> Dict[str, Dict[str, Any]]:
        return {str(self.ids[i]): self.profile_dict(i) for i in range(self.n)}

FRAUD_TYPES = ("none",) + tuple(BASIC_FRAUD_MIX)


class TransactionGenerator:
    """Generates transactions against a user/merchant pool."""

    def __init__(
        self,
        num_users: int = 10_000,
        num_merchants: int = 5_000,
        seed: int = 42,
        start_time: datetime | None = None,
        tps: float = 1000.0,
    ):
        self.rng = np.random.default_rng(seed)
        self.users = UserPool(num_users, self.rng)
        self.merchants = MerchantPool(num_merchants, self.rng)
        self.patterns = AdvancedFraudPatterns(self.rng)
        self.clock = start_time or datetime(2026, 1, 5, 8, 0, tzinfo=timezone.utc)
        self.tps = tps
        self._txn_counter = 0
        # drifted fraud pattern (inject_drift): a novel modus operandi the
        # incumbent models never trained on; 0.0 = off
        self._drift_rate = 0.0
        self._drift_merchants: np.ndarray | None = None
        # coordinated fraud ring (inject_fraud_ring); None = off
        self._ring: FraudRing | None = None

    # ------------------------------------------------------------------ dicts
    def generate_batch(self, n: int) -> List[Dict[str, Any]]:
        """n transaction dicts in the reference schema (simulator.py:298-374)."""
        out = []
        for _ in range(n):
            out.append(self._generate_one())
        return out

    def _generate_one(self) -> Dict[str, Any]:
        rng = self.rng
        u = int(rng.integers(0, self.users.n))
        m = int(rng.integers(0, self.merchants.n))
        self.clock += timedelta(seconds=1.0 / self.tps)
        self._txn_counter += 1
        amount = max(
            1.0,
            round(
                float(self.users.avg_amount[u])
                * float(rng.normal(1.0, 0.3))
                * float(rng.normal(1.0, 0.2)),
                2,
            ),
        )
        intl = rng.random() < self.users.intl_ratio[u]
        if intl:
            geo = {"lat": float(rng.uniform(-90, 90)), "lon": float(rng.uniform(-180, 180))}
        else:
            geo = {
                "lat": float(self.users.home_lat[u] + rng.normal(0, 0.5)),
                "lon": float(self.users.home_lon[u] + rng.normal(0, 0.5)),
            }
        devices = self.users.device_fingerprints[u]
        device = devices[int(rng.integers(0, len(devices)))]
        txn: Dict[str, Any] = {
            "transaction_id": f"txn_{self._txn_counter:012d}",
            "user_id": str(self.users.ids[u]),
            "merchant_id": str(self.merchants.ids[m]),
            "amount": amount,
            "currency": "USD",
            "transaction_type": TRANSACTION_TYPES[int(rng.integers(0, 3))],
            "payment_method": PAYMENT_METHODS[int(rng.integers(0, 4))],
            "card_type": CARD_TYPES[int(rng.integers(0, 4))],
            "card_last_four": str(int(rng.integers(1000, 10000))),
            "timestamp": self.clock.isoformat(),
            "ip_address": self._random_ip(),
            "device_id": device,
            "device_fingerprint": device,
            "user_agent": _USER_AGENTS[int(rng.integers(0, len(_USER_AGENTS)))],
            "geolocation": geo,
            "merchant_location": {
                "lat": float(self.merchants.lat[m]),
                "lon": float(self.merchants.lon[m]),
            },
            "is_weekend": self.clock.weekday() >= 5,
            "hour_of_day": self.clock.hour,
            "day_of_week": self.clock.isoweekday(),
            "day_of_month": self.clock.day,
            "is_fraud": False,
            "fraud_type": None,
            "fraud_score": 0.0,
        }
        # basic fraud mix (simulator.py:106-127,349-371), modulated by the
        # merchant's fraud rate (same rule as the fast path)
        total_mix = sum(BASIC_FRAUD_MIX.values())
        mult = float(self.merchants.fraud_mult[m])
        fraud_type = None
        if rng.random() < total_mix * mult:
            pattern_roll = rng.random() * total_mix
            cum = 0.0
            for name, p in BASIC_FRAUD_MIX.items():
                cum += p
                if pattern_roll < cum:
                    fraud_type = name
                    break
        if fraud_type is not None:
            txn["is_fraud"] = True
            txn["fraud_type"] = fraud_type
            txn = self.patterns.apply_fraud_pattern(fraud_type, txn)
        else:
            txn["fraud_score"] = float(rng.uniform(0.0, 0.3))
            self.patterns.record_location(txn["user_id"], geo)
        if self._drift_rate > 0.0 and rng.random() < self._drift_rate:
            txn = self._apply_drifted_pattern(txn)
        if self._ring is not None and rng.random() < self._ring.config.rate:
            txn = self._ring.apply(txn)
        return txn

    # ------------------------------------------------------------ drift
    def inject_drift(self, rate: float = 0.05) -> None:
        """Turn on the drifted fraud pattern: a ``rate`` share of the
        stream becomes a modus operandi an incumbent model has never seen
        (benign-looking prior score, the user's ordinary amount, the
        digital-wallet rail at one merchant category), so a pre-drift model
        ranks it like legit traffic until a retrain on its labels."""
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"drift rate must be in [0, 1], got {rate}")
        self._drift_rate = float(rate)
        if self._drift_merchants is None:
            # the complicit ring is one merchant category (electronics): a
            # single categorical feature a retrained tree can split on
            ring = self.merchants.ids[self.merchants.category == "electronics"]
            if len(ring) == 0:
                ring = self.merchants.ids[:max(1, self.merchants.n // 10)]
            self._drift_merchants = ring

    def clear_drift(self) -> None:
        self._drift_rate = 0.0

    def _apply_drifted_pattern(self, txn: Dict[str, Any]) -> Dict[str, Any]:
        rng = self.rng
        txn["is_fraud"] = True
        txn["fraud_type"] = "drifted_pattern"
        # in distribution feature by feature: the signal lives only in the
        # conjunction (electronics merchant x digital-wallet rail)
        txn["merchant_id"] = str(self._drift_merchants[int(rng.integers(
            0, len(self._drift_merchants)))])
        txn["payment_method"] = "digital_wallet"
        txn["fraud_score"] = float(rng.uniform(0.0, 0.3))
        txn["fraud_reason"] = "drifted pattern (novel MO, unseen in training)"
        return txn

    # ------------------------------------------------------------ labels
    def label_events(self, txns: Sequence[Dict[str, Any]],
                     event_ts: Sequence[float] | None = None,
                     delay_scale: float = 1.0) -> List[Dict[str, Any]]:
        """Delayed ground-truth label events for generated transactions
        (the labels topic's producer role), chargeback-style delays drawn
        from this generator's ``rng``, sorted by ``label_ts``."""
        from realtime_fraud_detection_tpu_torch.feedback.labels import (
            make_label_events,
        )

        return make_label_events(list(txns), self.rng,
                                 event_ts=(list(event_ts)
                                           if event_ts is not None else None),
                                 delay_scale=delay_scale)

    # ------------------------------------------------------------ fraud ring
    def inject_fraud_ring(self, config: FraudRingConfig | None = None) -> FraudRing:
        """Activate a coordinated fraud ring: a deterministic user cohort
        funnels a ``config.rate`` share of the stream through a small shared
        merchant / device / IP set. Returns the live ring."""
        self._ring = FraudRing(config or FraudRingConfig(), self.users,
                               self.merchants.ids, self.merchants.category,
                               self.rng)
        return self._ring

    def clear_fraud_ring(self) -> None:
        self._ring = None

    def _random_ip(self) -> str:
        rng = self.rng
        if rng.random() < 0.05:
            return f"192.168.{int(rng.integers(0, 256))}.{int(rng.integers(1, 255))}"
        return f"{int(rng.integers(11, 223))}.{int(rng.integers(0, 256))}.{int(rng.integers(0, 256))}.{int(rng.integers(1, 255))}"

    # ------------------------------------------------------------ fast arrays
    def generate_encoded(self, n: int) -> tuple[TransactionBatch, Dict[str, np.ndarray]]:
        """Vectorized batch straight into TransactionBatch columns + labels.

        Semantically equivalent to generate_batch + encode_transactions with
        joined pools, minus string materialization. Velocity fields are
        synthesized (Poisson background; elevated for velocity fraud) since
        no state store is in the loop here.
        """
        rng = self.rng
        up, mp = self.users, self.merchants
        u = rng.integers(0, up.n, n)
        m = rng.integers(0, mp.n, n)
        amount = np.maximum(
            1.0,
            np.round(up.avg_amount[u] * rng.normal(1, 0.3, n) * rng.normal(1, 0.2, n), 2),
        ).astype(np.float32)

        # virtual clock: advance n/tps seconds across the batch
        offsets = np.arange(n) / self.tps
        base = self.clock
        secs = (base - datetime(2026, 1, 5, tzinfo=timezone.utc)).total_seconds() + offsets
        hour = ((secs // 3600) % 24).astype(np.int32)
        day_index = (secs // 86400).astype(np.int64)
        day_of_week = ((day_index % 7) + 1).astype(np.int32)  # base is a Monday
        # base date is the 5th; wrap within a 28-day month (dict path uses
        # real calendar days — equal on day 0, may drift at month ends)
        day_of_month = ((day_index + 4) % 28 + 1).astype(np.int32)
        self.clock = base + timedelta(seconds=float(n / self.tps))

        intl = rng.random(n) < up.intl_ratio[u]
        lat = np.where(intl, rng.uniform(-90, 90, n), up.home_lat[u] + rng.normal(0, 0.5, n))
        lon = np.where(intl, rng.uniform(-180, 180, n), up.home_lon[u] + rng.normal(0, 0.5, n))

        # fraud mix, modulated by the merchant's own fraud rate so merchant
        # identity (category, suspicious name) carries real signal — the
        # reference stores per-merchant fraud_rate (simulator.py:255-266)
        # but never lets it influence label generation
        probs = np.array(list(BASIC_FRAUD_MIX.values()))
        total_mix = probs.sum()
        mult = mp.fraud_mult[m]
        roll = rng.random(n)
        is_fraud = roll < total_mix * mult
        # pattern choice within fraud rows keeps the mix proportions
        pattern_roll = rng.random(n) * total_mix
        cum = np.concatenate([[0.0], np.cumsum(probs)])
        fraud_code = np.zeros(n, np.int32)  # 0 = none
        for k in range(len(probs)):
            sel = is_fraud & (pattern_roll >= cum[k]) & (pattern_roll < cum[k + 1])
            fraud_code[sel] = k + 1

        ct = fraud_code == 1 + list(BASIC_FRAUD_MIX).index("card_testing")
        ato = fraud_code == 1 + list(BASIC_FRAUD_MIX).index("account_takeover")
        syn = fraud_code == 1 + list(BASIC_FRAUD_MIX).index("synthetic_fraud")
        vel = fraud_code == 1 + list(BASIC_FRAUD_MIX).index("velocity_fraud")
        other = is_fraud & ~(ct | ato | syn | vel)

        amount = np.where(ct, np.round(rng.uniform(1.0, 5.0, n), 2), amount)
        amount = np.where(syn, np.round(rng.uniform(1000.0, 5000.0, n), 2), amount)
        lat = np.where(ato, rng.uniform(-90, 90, n), lat)
        lon = np.where(ato, rng.uniform(-180, 180, n), lon)

        fraud_score = rng.uniform(0.0, 0.3, n)
        fraud_score = np.where(ct, rng.uniform(0.8, 0.95, n), fraud_score)
        fraud_score = np.where(ato, rng.uniform(0.7, 0.9, n), fraud_score)
        fraud_score = np.where(syn, rng.uniform(0.75, 0.95, n), fraud_score)
        fraud_score = np.where(vel, rng.uniform(0.6, 0.85, n), fraud_score)
        fraud_score = np.where(other, rng.uniform(0.5, 0.8, n), fraud_score)

        known_device = ~ato  # takeover uses a brand-new fingerprint
        private_ip = rng.random(n) < 0.05

        v5 = rng.poisson(0.2, n).astype(np.float32)
        v5 = np.where(vel, rng.integers(6, 13, n), v5).astype(np.float32)
        v1h = v5 + rng.poisson(1.0, n).astype(np.float32)
        v1h = np.where(vel, v1h + rng.integers(10, 20, n), v1h).astype(np.float32)
        v24 = v1h + rng.poisson(4.0, n).astype(np.float32)
        avg_amt = up.avg_amount[u]

        payment_code = rng.integers(0, 4, n).astype(np.int32)
        txn_type = rng.integers(0, 3, n).astype(np.int32)

        batch = TransactionBatch(
            amount=amount.astype(np.float32),
            hour_of_day=hour,
            day_of_week=day_of_week,
            day_of_month=day_of_month,
            is_weekend=day_of_week >= 6,
            lat=lat.astype(np.float32),
            lon=lon.astype(np.float32),
            has_geo=np.ones(n, bool),
            merchant_lat=mp.lat[m],
            merchant_lon=mp.lon[m],
            has_merchant_geo=np.ones(n, bool),
            payment_method_code=payment_code,
            transaction_type_code=txn_type,
            card_type_code=rng.integers(0, 4, n).astype(np.int32),
            high_risk_payment=np.zeros(n, bool),  # basic methods are low-risk
            suspicious_user_agent=rng.random(n) < 0.01,
            private_ip=private_ip,
            has_txn_fingerprint=np.ones(n, bool),
            ip_risk=np.where(private_ip, 0.1, 0.3).astype(np.float32),
            prior_fraud_score=fraud_score.astype(np.float32),
            has_user=np.ones(n, bool),
            user_risk_score=up.risk_score[u],
            account_age_days=up.account_age_days[u],
            user_verified=up.kyc_code[u] == 0,
            kyc_code=up.kyc_code[u],
            user_avg_amount=avg_amt,
            user_txn_frequency=up.txn_frequency[u].astype(np.float32),
            preferred_start=up.pref_start[u],
            preferred_end=up.pref_end[u],
            has_preferred_hours=np.ones(n, bool),
            weekend_activity=up.weekend_activity[u],
            intl_ratio=up.intl_ratio[u],
            has_intl_ratio=np.ones(n, bool),
            online_preference=up.online_preference[u],
            known_device=known_device,
            has_device_list=np.ones(n, bool),
            has_merchant=np.ones(n, bool),
            merchant_risk_code=mp.risk_code[m],
            merchant_fraud_rate=mp.fraud_rate[m],
            merchant_blacklisted=mp.is_blacklisted[m],
            merchant_category_code=mp.category_code[m],
            merchant_high_risk_category=mp.risk_code[m] == 2,
            merchant_op_start=mp.op_start[m],
            merchant_op_end=mp.op_end[m],
            has_op_hours=np.ones(n, bool),
            merchant_avg_amount=mp.avg_amount[m],
            suspicious_merchant_name=mp.suspicious_name[m],
            velocity_5min_count=v5,
            velocity_5min_amount=v5 * avg_amt,
            velocity_1hour_count=v1h,
            velocity_1hour_amount=v1h * avg_amt,
            velocity_24hour_count=v24,
            velocity_24hour_amount=v24 * avg_amt,
        )
        labels = {
            "is_fraud": is_fraud,
            "fraud_type": fraud_code,
            "fraud_score": fraud_score.astype(np.float32),
            "user_index": u,
            "merchant_index": m,
        }
        return batch, labels

    # ---------------------------------------------------------------- joins
    def encode_dicts(self, records: Sequence[Dict[str, Any]]) -> TransactionBatch:
        """Encode dict transactions with this generator's profile pools."""
        return encode_transactions(
            records, self.users.profiles(), self.merchants.profiles()
        )
