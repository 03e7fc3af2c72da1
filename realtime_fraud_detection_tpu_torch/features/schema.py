"""Transaction batch container: one flat column per field.

The same struct-of-arrays layout as the JAX package's
``features/schema.py TransactionBatch``, with the fields in the same order
(the packed transfer layout of ``core/packing.py`` follows field order).
Columns are numpy arrays on the host and torch tensors on the device;
``has_*`` flags stand in for the reference's null checks.

The records -> batch encode is ported too: ``encode_transactions`` (record
at a time) and ``encode_transactions_columnar`` (the assembly hot path,
bit-identical), with the cross-batch ``EntityRowCache`` of profile join
rows. Every string is resolved here on the host (merchant-name regex,
IP and user-agent analysis, device-fingerprint membership), so the feature
extractor is pure arithmetic.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, fields
from typing import Any, Dict, Mapping, Sequence

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
# categories the reference treats as high-risk (simulator risk_level='high')
HIGH_RISK_CATEGORIES = frozenset({"gambling", "adult_entertainment", "jewelry"})

UNKNOWN = -1  # encoding for absent/unknown categorical values


def _code(vocab: Sequence[str], value: Any) -> int:
    if value is None:
        return UNKNOWN
    try:
        return vocab.index(str(value))
    except ValueError:
        return UNKNOWN


# dict-form vocab lookups for the encode hot loop
_PM_CODE = {v: i for i, v in enumerate(PAYMENT_METHODS)}
_TT_CODE = {v: i for i, v in enumerate(TRANSACTION_TYPES)}
_CT_CODE = {v: i for i, v in enumerate(CARD_TYPES)}
_MC_CODE = {v: i for i, v in enumerate(MERCHANT_CATEGORIES)}
_KYC_CODE = {v: i for i, v in enumerate(KYC_STATUSES)}
_RL_CODE = {v: i for i, v in enumerate(RISK_LEVELS)}


def _dcode(codes: Dict[str, int], value: Any) -> int:
    if value is None:
        return UNKNOWN
    return codes.get(value if type(value) is str else str(value), UNKNOWN)


# host-side string analysis (FeatureExtractor.java:30-41,427-451)
_SUSPICIOUS_NAME_RE = re.compile(
    r"(?i)(bitcoin|crypto|coinbase|binance|blockchain|wallet|mining|exchange"
    r"|gift\s*card|prepaid|reload|vanilla|amazon\s*gift|itunes"
    r"|western\s*union|moneygram|remit|transfer|wire|paypal|venmo"
    r"|casino|gambling|betting|lottery|forex|trading|investment|loan)"
)


def is_suspicious_merchant_name(name: str | None) -> bool:
    return bool(name) and _SUSPICIOUS_NAME_RE.search(name) is not None


def is_private_ip(ip: str | None) -> bool:
    # FeatureExtractor.java:434-438 (the reference only checks 172.16.)
    return bool(ip) and (
        ip.startswith("192.168.") or ip.startswith("10.") or ip.startswith("172.16.")
    )


def ip_risk_score(ip: str | None) -> float:
    # FeatureExtractor.java:440-445
    if not ip:
        return 0.3
    return 0.1 if is_private_ip(ip) else 0.3


def is_suspicious_user_agent(ua: str | None) -> bool:
    # FeatureExtractor.java:447-451
    if ua is None:
        return False
    return "bot" in ua or "crawler" in ua or len(ua) < 20


def is_high_risk_payment(method: str | None) -> bool:
    # FeatureExtractor.java:486-493
    if not method:
        return False
    lower = method.lower()
    return any(tok in lower for tok in ("prepaid", "gift", "crypto", "wire"))


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

    @property
    def batch_size(self) -> int:
        return self.amount.shape[0]


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


def encode_transactions(
    records: Sequence[Mapping[str, Any]],
    user_profiles: Mapping[str, Mapping[str, Any]] | None = None,
    merchant_profiles: Mapping[str, Mapping[str, Any]] | None = None,
    velocities: Mapping[str, Mapping[str, Mapping[str, float]]] | None = None,
) -> TransactionBatch:
    """Encode transaction JSON records + profile joins into a dense batch.

    ``records`` follow the simulator schema (simulator.py:78-101).
    ``user_profiles``/``merchant_profiles`` map ids to profile dicts
    (simulator.py:40-75 schema). ``velocities`` maps user_id ->
    {"5min"|"1hour"|"24hour" -> {"count": n, "amount": a}}.
    """
    user_profiles = user_profiles or {}
    merchant_profiles = merchant_profiles or {}
    velocities = velocities or {}

    # per-field Python lists converted once, with per-batch memoization of
    # the profile-derived field groups (joins repeat inside a microbatch)
    field_names = [f.name for f in fields(TransactionBatch)]
    rows: Dict[str, list] = {name: [] for name in field_names}

    # unknown-user defaults (FeatureExtractor.java:244-251):
    # (present, risk, age, verified, kyc, avg, freq, has_pref, ps, pe,
    #  weekend, has_intl, intl, online, has_devlist, fingerprints)
    _NO_USER = (False, 0.8, 0.0, False, UNKNOWN, 0.0, 0.0, False, 0, 23,
                0.5, False, 0.0, 0.7, False, ())
    # unknown-merchant defaults (FeatureExtractor.java:288-295)
    _NO_MERCH = (False, UNKNOWN, 0.1, False, UNKNOWN, False, False, 0, 24,
                 0.0, False)
    user_memo: Dict[str, tuple] = {}
    merch_memo: Dict[str, tuple] = {}

    def _user_row(uid: str) -> tuple:
        row = user_memo.get(uid)
        if row is None:
            user = user_profiles.get(uid)
            if user is None:
                row = _NO_USER
            else:
                patterns = user.get("behavioral_patterns") or {}
                ps = patterns.get("preferred_time_start")
                pe = patterns.get("preferred_time_end")
                intl = patterns.get("international_transactions")
                kyc = user.get("kyc_status")
                row = (
                    True,
                    float(user.get("risk_score", 0.5)),
                    float(user.get("account_age_days", 0.0)),
                    str(kyc or "") == "verified",
                    _dcode(_KYC_CODE, kyc),
                    float(user.get("avg_transaction_amount", 0.0)),
                    float(user.get("transaction_frequency", 0.0)),
                    ps is not None and pe is not None,
                    int(ps if ps is not None else 0),
                    int(pe if pe is not None else 23),
                    float(patterns.get("weekend_activity", 0.5)),
                    intl is not None,
                    float(intl if intl is not None else 0.0),
                    float(patterns.get("online_preference", 0.7)),
                    bool(user.get("device_fingerprints")),
                    user.get("device_fingerprints") or (),
                )
            user_memo[uid] = row
        return row

    def _merch_row(mid: str) -> tuple:
        row = merch_memo.get(mid)
        if row is None:
            merch = merchant_profiles.get(mid)
            if merch is None:
                row = _NO_MERCH
            else:
                cat, risk = merch.get("category"), merch.get("risk_level")
                hours = merch.get("operating_hours") or {}
                row = (
                    True,
                    _dcode(_RL_CODE, risk),
                    float(merch.get("fraud_rate", 0.05)),
                    bool(merch.get("is_blacklisted", False)),
                    _dcode(_MC_CODE, cat),
                    (str(cat) in HIGH_RISK_CATEGORIES or str(risk) == "high"),
                    "start_hour" in hours and "end_hour" in hours,
                    int(hours.get("start_hour", 0)),
                    int(hours.get("end_hour", 24)),
                    float(merch.get("avg_transaction_amount", 0.0)),
                    is_suspicious_merchant_name(merch.get("name")),
                )
            merch_memo[mid] = row
        return row

    pm_memo: Dict[str, tuple] = {}
    _EMPTY_VEL: Dict[str, Mapping[str, float]] = {}
    _EMPTY_W: Dict[str, float] = {}
    a = rows  # short alias for the loop body

    for rec in records:
        get = rec.get
        geo = get("geolocation") or {}
        mgeo = get("merchant_location") or {}
        a["amount"].append(float(get("amount", 0.0)))
        a["hour_of_day"].append(int(get("hour_of_day", 12)))
        a["day_of_week"].append(int(get("day_of_week", 1)))
        a["day_of_month"].append(int(get("day_of_month", 1)))
        a["is_weekend"].append(bool(get("is_weekend", False)))
        a["has_geo"].append(bool(geo) and geo.get("lat") is not None)
        a["lat"].append(float(geo.get("lat", 0.0) or 0.0))
        a["lon"].append(float(geo.get("lon", 0.0) or 0.0))
        a["has_merchant_geo"].append(bool(mgeo) and mgeo.get("lat") is not None)
        a["merchant_lat"].append(float(mgeo.get("lat", 0.0) or 0.0))
        a["merchant_lon"].append(float(mgeo.get("lon", 0.0) or 0.0))
        pm = get("payment_method")
        pm_row = pm_memo.get(pm)
        if pm_row is None:
            pm_memo[pm] = pm_row = (
                _dcode(_PM_CODE, pm), is_high_risk_payment(pm))
        a["payment_method_code"].append(pm_row[0])
        a["high_risk_payment"].append(pm_row[1])
        a["transaction_type_code"].append(
            _dcode(_TT_CODE, get("transaction_type")))
        a["card_type_code"].append(_dcode(_CT_CODE, get("card_type")))
        a["suspicious_user_agent"].append(
            is_suspicious_user_agent(get("user_agent")))
        ip = get("ip_address")
        private = is_private_ip(ip)
        a["private_ip"].append(private)
        # inlined ip_risk_score(): private 0.1, everything else 0.3
        a["ip_risk"].append(0.1 if private else 0.3)
        a["prior_fraud_score"].append(float(get("fraud_score", 0.0)))
        fp = get("device_fingerprint")
        a["has_txn_fingerprint"].append(fp is not None)

        uid = str(get("user_id", ""))
        (has_user, risk, age, verified, kyc, avg, freq, has_pref, ps, pe,
         weekend, has_intl, intl, online, has_devlist,
         fingerprints) = _user_row(uid)
        a["has_user"].append(has_user)
        a["user_risk_score"].append(risk)
        a["account_age_days"].append(age)
        a["user_verified"].append(verified)
        a["kyc_code"].append(kyc)
        a["user_avg_amount"].append(avg)
        a["user_txn_frequency"].append(freq)
        a["has_preferred_hours"].append(has_pref)
        a["preferred_start"].append(ps)
        a["preferred_end"].append(pe)
        a["weekend_activity"].append(weekend)
        a["has_intl_ratio"].append(has_intl)
        a["intl_ratio"].append(intl)
        a["online_preference"].append(online)
        a["has_device_list"].append(has_devlist)
        a["known_device"].append(fp is not None and fp in fingerprints)

        mid = str(get("merchant_id", ""))
        (has_merch, mrisk, frate, blist, mcat, mhigh, has_hours, op_s, op_e,
         mavg, sus_name) = _merch_row(mid)
        a["has_merchant"].append(has_merch)
        a["merchant_risk_code"].append(mrisk)
        a["merchant_fraud_rate"].append(frate)
        a["merchant_blacklisted"].append(blist)
        a["merchant_category_code"].append(mcat)
        a["merchant_high_risk_category"].append(mhigh)
        a["has_op_hours"].append(has_hours)
        a["merchant_op_start"].append(op_s)
        a["merchant_op_end"].append(op_e)
        a["merchant_avg_amount"].append(mavg)
        a["suspicious_merchant_name"].append(sus_name)

        vel = velocities.get(uid) or _EMPTY_VEL
        w = vel.get("5min") or _EMPTY_W
        a["velocity_5min_count"].append(float(w.get("count", 0.0)))
        a["velocity_5min_amount"].append(float(w.get("amount", 0.0)))
        w = vel.get("1hour") or _EMPTY_W
        a["velocity_1hour_count"].append(float(w.get("count", 0.0)))
        a["velocity_1hour_amount"].append(float(w.get("amount", 0.0)))
        w = vel.get("24hour") or _EMPTY_W
        a["velocity_24hour_count"].append(float(w.get("count", 0.0)))
        a["velocity_24hour_amount"].append(float(w.get("amount", 0.0)))

    return TransactionBatch(**{
        name: np.array(rows[name], dtype=column_dtype(name))
        for name in field_names
    })


# --- columnar encode: the host-assembly hot path ---------------------------
# Unknown-entity default rows for the columnar path, split by dtype group in
# the exact field order the gathers below consume. Values mirror _NO_USER /
# _NO_MERCH (FeatureExtractor.java:244-251, :288-295).
_NO_USER_F32 = (0.8, 0.0, 0.0, 0.0, 0.5, 0.0, 0.7)
_NO_USER_I32 = (UNKNOWN, 0, 23)
_NO_USER_BOOL = (False, False, False, False, False)
_NO_MERCH_F32 = (0.1, 0.0)
_NO_MERCH_I32 = (UNKNOWN, UNKNOWN, 0, 24)
_NO_MERCH_BOOL = (False, False, False, False, False)


class EntityRowCache:
    """Cross-batch cache of encode-time join rows, generation-stamped.

    The per-entity profile joins are pure functions of the profile dict, so
    their encoded rows (dtype-grouped scalar tuples) are cached across
    microbatches and invalidated wholesale when the backing ProfileStore's
    ``generation`` moves (any profile write). A store without a
    ``generation`` attribute (the shared RESP tier — remote writers are
    invisible) gets per-batch memoization only: ``sync`` clears on every
    call. ``max_entries`` bounds each side (steady-state write-back never
    touches profiles, so without a cap a long-running service would grow
    one row per distinct id forever); at the cap the side is cleared
    wholesale — misses are cheap rebuilds and the hot ids repopulate
    within a batch.
    """

    def __init__(self, max_entries: int = 131_072) -> None:
        self.generation: Any = object()     # never equal to a store's int
        self.max_entries = max(1, int(max_entries))
        self.users: Dict[str, tuple] = {}
        self.merchants: Dict[str, tuple] = {}
        self.hits = 0
        self.misses = 0

    def sync(self, profile_store: Any) -> None:
        gen = getattr(profile_store, "generation", None)
        if gen is None or gen != self.generation:
            self.users.clear()
            self.merchants.clear()
        else:
            if len(self.users) > self.max_entries:
                self.users.clear()
            if len(self.merchants) > self.max_entries:
                self.merchants.clear()
        self.generation = gen if gen is not None else object()

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self.users) + len(self.merchants)}


def _user_row_cols(user: Mapping[str, Any] | None) -> tuple:
    """(f32 row, i32 row, bool row, fingerprints) for one user profile —
    scalar-for-scalar the values _user_row produces for the serial path."""
    if user is None:
        return (_NO_USER_F32, _NO_USER_I32, _NO_USER_BOOL, ())
    patterns = user.get("behavioral_patterns") or {}
    ps = patterns.get("preferred_time_start")
    pe = patterns.get("preferred_time_end")
    intl = patterns.get("international_transactions")
    kyc = user.get("kyc_status")
    return (
        (float(user.get("risk_score", 0.5)),
         float(user.get("account_age_days", 0.0)),
         float(user.get("avg_transaction_amount", 0.0)),
         float(user.get("transaction_frequency", 0.0)),
         float(patterns.get("weekend_activity", 0.5)),
         float(intl if intl is not None else 0.0),
         float(patterns.get("online_preference", 0.7))),
        (_dcode(_KYC_CODE, kyc),
         int(ps if ps is not None else 0),
         int(pe if pe is not None else 23)),
        (True,
         str(kyc or "") == "verified",
         ps is not None and pe is not None,
         intl is not None,
         bool(user.get("device_fingerprints"))),
        user.get("device_fingerprints") or (),
    )


def _merch_row_cols(merch: Mapping[str, Any] | None) -> tuple:
    """(f32 row, i32 row, bool row) for one merchant profile — the columnar
    twin of _merch_row."""
    if merch is None:
        return (_NO_MERCH_F32, _NO_MERCH_I32, _NO_MERCH_BOOL)
    cat, risk = merch.get("category"), merch.get("risk_level")
    hours = merch.get("operating_hours") or {}
    return (
        (float(merch.get("fraud_rate", 0.05)),
         float(merch.get("avg_transaction_amount", 0.0))),
        (_dcode(_RL_CODE, risk),
         _dcode(_MC_CODE, cat),
         int(hours.get("start_hour", 0)),
         int(hours.get("end_hour", 24))),
        (True,
         bool(merch.get("is_blacklisted", False)),
         (str(cat) in HIGH_RISK_CATEGORIES or str(risk) == "high"),
         "start_hour" in hours and "end_hour" in hours,
         is_suspicious_merchant_name(merch.get("name"))),
    )


def encode_transactions_columnar(
    records: Sequence[Mapping[str, Any]],
    user_profiles: Mapping[str, Mapping[str, Any]] | None = None,
    merchant_profiles: Mapping[str, Mapping[str, Any]] | None = None,
    velocities: Mapping[str, Mapping[str, Mapping[str, float]]] | None = None,
    cache: EntityRowCache | None = None,
) -> TransactionBatch:
    """Columnar twin of ``encode_transactions``: bit-identical output.

    The per-record Python loop shrinks to the ~20 transaction-core fields;
    every profile/velocity join becomes one dense gather — unique entities
    are resolved to dtype-grouped row tables (cached across batches via
    ``cache``; see EntityRowCache) and fancy-indexed back out to records.
    """
    if not records:
        return encode_transactions(records, user_profiles,
                                   merchant_profiles, velocities)
    user_profiles = user_profiles or {}
    merchant_profiles = merchant_profiles or {}
    velocities = velocities or {}
    if cache is None:
        cache = EntityRowCache()
    n = len(records)

    cols: Dict[str, Any] = {}
    # ---- transaction-core fields: the one remaining per-record loop
    amount: list = []
    hour_of_day: list = []
    day_of_week: list = []
    day_of_month: list = []
    is_weekend: list = []
    has_geo: list = []
    lat: list = []
    lon: list = []
    has_mgeo: list = []
    mlat: list = []
    mlon: list = []
    pm_code: list = []
    high_risk_pm: list = []
    tt_code: list = []
    ct_code: list = []
    sus_ua: list = []
    private_ip: list = []
    ip_risk: list = []
    prior_score: list = []
    has_fp: list = []
    fps: list = []                       # device fingerprint (or None)
    uid_of: list = []
    mid_of: list = []
    pm_memo: Dict[Any, tuple] = {}
    for rec in records:
        get = rec.get
        geo = get("geolocation") or {}
        mgeo = get("merchant_location") or {}
        amount.append(float(get("amount", 0.0)))
        hour_of_day.append(int(get("hour_of_day", 12)))
        day_of_week.append(int(get("day_of_week", 1)))
        day_of_month.append(int(get("day_of_month", 1)))
        is_weekend.append(bool(get("is_weekend", False)))
        has_geo.append(bool(geo) and geo.get("lat") is not None)
        lat.append(float(geo.get("lat", 0.0) or 0.0))
        lon.append(float(geo.get("lon", 0.0) or 0.0))
        has_mgeo.append(bool(mgeo) and mgeo.get("lat") is not None)
        mlat.append(float(mgeo.get("lat", 0.0) or 0.0))
        mlon.append(float(mgeo.get("lon", 0.0) or 0.0))
        pm = get("payment_method")
        pm_row = pm_memo.get(pm)
        if pm_row is None:
            pm_memo[pm] = pm_row = (
                _dcode(_PM_CODE, pm), is_high_risk_payment(pm))
        pm_code.append(pm_row[0])
        high_risk_pm.append(pm_row[1])
        tt_code.append(_dcode(_TT_CODE, get("transaction_type")))
        ct_code.append(_dcode(_CT_CODE, get("card_type")))
        sus_ua.append(is_suspicious_user_agent(get("user_agent")))
        private = is_private_ip(get("ip_address"))
        private_ip.append(private)
        ip_risk.append(0.1 if private else 0.3)
        prior_score.append(float(get("fraud_score", 0.0)))
        fp = get("device_fingerprint")
        has_fp.append(fp is not None)
        fps.append(fp)
        uid_of.append(str(get("user_id", "")))
        mid_of.append(str(get("merchant_id", "")))

    cols["amount"] = np.array(amount, np.float32)
    cols["hour_of_day"] = np.array(hour_of_day, np.int32)
    cols["day_of_week"] = np.array(day_of_week, np.int32)
    cols["day_of_month"] = np.array(day_of_month, np.int32)
    cols["is_weekend"] = np.array(is_weekend, np.bool_)
    cols["has_geo"] = np.array(has_geo, np.bool_)
    cols["lat"] = np.array(lat, np.float32)
    cols["lon"] = np.array(lon, np.float32)
    cols["has_merchant_geo"] = np.array(has_mgeo, np.bool_)
    cols["merchant_lat"] = np.array(mlat, np.float32)
    cols["merchant_lon"] = np.array(mlon, np.float32)
    cols["payment_method_code"] = np.array(pm_code, np.int32)
    cols["high_risk_payment"] = np.array(high_risk_pm, np.bool_)
    cols["transaction_type_code"] = np.array(tt_code, np.int32)
    cols["card_type_code"] = np.array(ct_code, np.int32)
    cols["suspicious_user_agent"] = np.array(sus_ua, np.bool_)
    cols["private_ip"] = np.array(private_ip, np.bool_)
    cols["ip_risk"] = np.array(ip_risk, np.float32)
    cols["prior_fraud_score"] = np.array(prior_score, np.float32)
    cols["has_txn_fingerprint"] = np.array(has_fp, np.bool_)

    # ---- user join: unique -> cached rows -> stacked tables -> gather
    u_index: Dict[str, int] = {}
    u_rows: list = []
    u_inv = np.empty((n,), np.int64)
    for i, uid in enumerate(uid_of):
        j = u_index.get(uid)
        if j is None:
            j = len(u_rows)
            u_index[uid] = j
            row = cache.users.get(uid)
            if row is None:
                cache.misses += 1
                row = _user_row_cols(user_profiles.get(uid))
                cache.users[uid] = row
            else:
                cache.hits += 1
            u_rows.append(row)
        u_inv[i] = j
    uf = np.array([r[0] for r in u_rows], np.float32)[u_inv]
    ui = np.array([r[1] for r in u_rows], np.int32)[u_inv]
    ub = np.array([r[2] for r in u_rows], np.bool_)[u_inv]
    cols["user_risk_score"] = uf[:, 0]
    cols["account_age_days"] = uf[:, 1]
    cols["user_avg_amount"] = uf[:, 2]
    cols["user_txn_frequency"] = uf[:, 3]
    cols["weekend_activity"] = uf[:, 4]
    cols["intl_ratio"] = uf[:, 5]
    cols["online_preference"] = uf[:, 6]
    cols["kyc_code"] = ui[:, 0]
    cols["preferred_start"] = ui[:, 1]
    cols["preferred_end"] = ui[:, 2]
    cols["has_user"] = ub[:, 0]
    cols["user_verified"] = ub[:, 1]
    cols["has_preferred_hours"] = ub[:, 2]
    cols["has_intl_ratio"] = ub[:, 3]
    cols["has_device_list"] = ub[:, 4]
    cols["known_device"] = np.array(
        [fp is not None and fp in u_rows[u_inv[i]][3]
         for i, fp in enumerate(fps)], np.bool_)

    # ---- merchant join
    m_index: Dict[str, int] = {}
    m_rows: list = []
    m_inv = np.empty((n,), np.int64)
    for i, mid in enumerate(mid_of):
        j = m_index.get(mid)
        if j is None:
            j = len(m_rows)
            m_index[mid] = j
            row = cache.merchants.get(mid)
            if row is None:
                cache.misses += 1
                row = _merch_row_cols(merchant_profiles.get(mid))
                cache.merchants[mid] = row
            else:
                cache.hits += 1
            m_rows.append(row)
        m_inv[i] = j
    mf = np.array([r[0] for r in m_rows], np.float32)[m_inv]
    mi = np.array([r[1] for r in m_rows], np.int32)[m_inv]
    mb = np.array([r[2] for r in m_rows], np.bool_)[m_inv]
    cols["merchant_fraud_rate"] = mf[:, 0]
    cols["merchant_avg_amount"] = mf[:, 1]
    cols["merchant_risk_code"] = mi[:, 0]
    cols["merchant_category_code"] = mi[:, 1]
    cols["merchant_op_start"] = mi[:, 2]
    cols["merchant_op_end"] = mi[:, 3]
    cols["has_merchant"] = mb[:, 0]
    cols["merchant_blacklisted"] = mb[:, 1]
    cols["merchant_high_risk_category"] = mb[:, 2]
    cols["has_op_hours"] = mb[:, 3]
    cols["suspicious_merchant_name"] = mb[:, 4]

    # ---- velocity join: one row per unique user this batch (windows move
    # every write-back, so these rows are per-batch, never cross-batch)
    v_rows = np.empty((len(u_rows), 6), np.float32)
    _EMPTY_VEL: Dict[str, Mapping[str, float]] = {}
    _EMPTY_W: Dict[str, float] = {}
    for uid, j in u_index.items():
        vel = velocities.get(uid) or _EMPTY_VEL
        w5 = vel.get("5min") or _EMPTY_W
        w1 = vel.get("1hour") or _EMPTY_W
        w24 = vel.get("24hour") or _EMPTY_W
        v_rows[j] = (float(w5.get("count", 0.0)), float(w5.get("amount", 0.0)),
                     float(w1.get("count", 0.0)), float(w1.get("amount", 0.0)),
                     float(w24.get("count", 0.0)),
                     float(w24.get("amount", 0.0)))
    vg = v_rows[u_inv]
    cols["velocity_5min_count"] = vg[:, 0]
    cols["velocity_5min_amount"] = vg[:, 1]
    cols["velocity_1hour_count"] = vg[:, 2]
    cols["velocity_1hour_amount"] = vg[:, 3]
    cols["velocity_24hour_count"] = vg[:, 4]
    cols["velocity_24hour_amount"] = vg[:, 5]

    return TransactionBatch(**cols)
