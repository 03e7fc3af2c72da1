"""Fraud pattern library: 10 parameterized scenarios + stateful appliers.

Port of the JAX package's ``sim/fraud_patterns.py`` (the reference's
``AdvancedFraudPatterns``, fraud_patterns.py:17-417): the scenario registry,
velocity tracking over 10-minute windows, geographic history for account
takeover and impossible travel, structuring amounts for laundering, and the
simulator's basic 7-pattern mix (simulator.py:106-127) as
``BASIC_FRAUD_MIX``. Every draw comes from an injected
``numpy.random.Generator``, so a seed replays the same records as the JAX
package's simulator. ``FraudRing`` is the coordinated ring (a user cohort
funnelling traffic through a small shared set of merchants, device
fingerprints and egress IPs), the traffic the typed entity graph exists for.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass
from datetime import datetime, timedelta
from typing import Any, Dict, Tuple

import numpy as np

# Basic mix wired into the reference simulator (simulator.py:107-115), ~5.5%.
BASIC_FRAUD_MIX: Dict[str, float] = {
    "card_testing": 0.02,
    "account_takeover": 0.01,
    "synthetic_fraud": 0.005,
    "money_laundering": 0.003,
    "merchant_fraud": 0.002,
    "velocity_fraud": 0.01,
    "geographic_fraud": 0.005,
}


@dataclass(frozen=True)
class FraudScenario:
    """Scenario parameters (reference fraud_patterns.py:17-27)."""

    name: str
    description: str
    probability: float
    severity: str            # low | medium | high | critical
    detection_difficulty: str  # easy | medium | hard | very_hard
    typical_amount_range: Tuple[float, float]
    typical_frequency: str   # single | burst | sustained
    geographic_pattern: str  # local | remote | international | random


def _scenarios() -> Dict[str, FraudScenario]:
    """The 10 scenarios (reference fraud_patterns.py:38-141)."""
    S = FraudScenario
    return {
        "card_testing": S("Card Testing",
                          "Probing stolen card credentials via tiny purchases",
                          0.025, "medium", "easy", (0.99, 9.99), "burst", "random"),
        "account_takeover": S("Account Takeover",
                              "Genuine account hijacked by an attacker",
                              0.015, "high", "medium", (100.0, 2000.0), "sustained", "remote"),
        "synthetic_identity": S("Synthetic Identity Fraud",
                                "Fabricated identity blending genuine and invented data",
                                0.008, "high", "hard", (500.0, 5000.0), "sustained", "local"),
        "first_party_fraud": S("First Party Fraud",
                               "Account owner abusing their own account",
                               0.012, "medium", "very_hard", (200.0, 1500.0), "single", "local"),
        "money_laundering": S("Money Laundering",
                              "Deposits split just under reporting limits to obscure origin",
                              0.005, "critical", "hard", (9000.0, 9900.0), "sustained", "random"),
        "merchant_fraud": S("Merchant Fraud",
                            "Complicit merchant running fabricated charges",
                            0.003, "high", "medium", (50.0, 500.0), "sustained", "local"),
        "velocity_fraud": S("Velocity Fraud",
                            "Burst of charges far above the account's usual cadence",
                            0.018, "medium", "easy", (25.0, 300.0), "burst", "local"),
        "geographic_fraud": S("Geographic Impossibility",
                              "Charges from locations no traveler could reach in time",
                              0.010, "medium", "medium", (100.0, 800.0), "single", "international"),
        "bust_out_fraud": S("Bust-Out Fraud",
                            "Patiently grown credit line drained in one spree",
                            0.004, "high", "hard", (1000.0, 8000.0), "burst", "local"),
        "friendly_fraud": S("Friendly Fraud",
                            "Cardholder charging back purchases they actually made",
                            0.020, "low", "very_hard", (50.0, 1000.0), "single", "local"),
    }


class AdvancedFraudPatterns:
    """Stateful fraud-pattern applier over transaction dicts."""

    def __init__(self, rng: np.random.Generator | None = None):
        self.rng = rng or np.random.default_rng(0)
        self.scenarios = _scenarios()
        self.velocity_windows: Dict[str, list] = {}
        self.geographic_history: Dict[str, list] = {}

    # -- selection ----------------------------------------------------------
    def generate_fraud_scenario(
            self) -> Tuple[bool, str | None, FraudScenario | None]:
        """Weighted scenario draw (reference fraud_patterns.py:143-159)."""
        total = sum(s.probability for s in self.scenarios.values())
        if self.rng.random() > total:
            return False, None, None
        draw = self.rng.random() * total
        cum = 0.0
        for name, scenario in self.scenarios.items():
            cum += scenario.probability
            if draw <= cum:
                return True, name, scenario
        return False, None, None

    # -- appliers -----------------------------------------------------------
    def apply_fraud_pattern(self, fraud_type: str, txn: Dict[str, Any]) -> Dict[str, Any]:
        applier = getattr(self, f"_apply_{fraud_type}", None)
        if applier is None:
            txn["fraud_score"] = float(self.rng.uniform(0.50, 0.80))
            txn["fraud_reason"] = f"Unrecognized scenario key: {fraud_type}"
            return txn
        return applier(txn)

    def _amount(self, name: str) -> float:
        lo, hi = self.scenarios[name].typical_amount_range
        return round(float(self.rng.uniform(lo, hi)), 2)

    def _apply_card_testing(self, txn):
        txn["amount"] = self._amount("card_testing")
        txn["card_last_four"] = str(self.rng.choice(["1234", "5678", "9999", "0000"]))
        txn["fraud_score"] = float(self.rng.uniform(0.75, 0.95))
        txn["fraud_reason"] = "Card-testing probe: repeated tiny charges"
        txn["ip_address"] = _random_public_ip(self.rng)
        return txn

    def _apply_account_takeover(self, txn):
        user_id = txn["user_id"]
        history = self.geographic_history.setdefault(user_id, [])
        if history:
            last = history[-1]
            txn["geolocation"] = {
                "lat": float(np.clip(last["lat"] + self.rng.uniform(-50, 50), -90, 90)),
                "lon": float(np.clip(last["lon"] + self.rng.uniform(-50, 50), -180, 180)),
            }
        history.append(dict(txn.get("geolocation") or {"lat": 0.0, "lon": 0.0}))
        txn["device_fingerprint"] = str(uuid.UUID(int=int(self.rng.integers(0, 2**63)), version=4))
        txn["device_id"] = txn["device_fingerprint"]
        txn["amount"] = self._amount("account_takeover")
        txn["fraud_score"] = float(self.rng.uniform(0.70, 0.90))
        txn["fraud_reason"] = "Login from unfamiliar device and distant location"
        return txn

    def _apply_velocity_fraud(self, txn):
        user_id = txn["user_id"]
        now = datetime.fromisoformat(txn["timestamp"])
        window = self.velocity_windows.setdefault(user_id, [])
        window.append(now)
        cutoff = now - timedelta(minutes=10)
        self.velocity_windows[user_id] = window = [t for t in window if t > cutoff]
        count = len(window)
        if count > 5:
            txn["fraud_score"] = min(0.95, 0.5 + count * 0.1)
            txn["fraud_reason"] = f"Burst rate: {count} charges inside a 10-minute window"
        else:
            txn["fraud_score"] = float(self.rng.uniform(0.60, 0.80))
            txn["fraud_reason"] = "Charge cadence far above account baseline"
        txn["amount"] = self._amount("velocity_fraud")
        return txn

    def _apply_synthetic_identity(self, txn):
        txn["amount"] = self._amount("synthetic_identity")
        txn["fraud_score"] = float(self.rng.uniform(0.65, 0.85))
        txn["fraud_reason"] = "Profile signals consistent with a fabricated identity"
        txn["transaction_type"] = "purchase"
        return txn

    # the simulator's basic mix calls this "synthetic_fraud" (simulator.py:110)
    _apply_synthetic_fraud = _apply_synthetic_identity

    def _apply_money_laundering(self, txn):
        txn["amount"] = self._amount("money_laundering")  # structuring 9000-9900
        txn["fraud_score"] = float(self.rng.uniform(0.70, 0.90))
        txn["fraud_reason"] = "Amounts structured under the reporting threshold"
        return txn

    def _apply_geographic_fraud(self, txn):
        user_id = txn["user_id"]
        if self.geographic_history.get(user_id):
            txn["geolocation"] = {
                "lat": float(self.rng.uniform(-90, 90)),
                "lon": float(self.rng.uniform(-180, 180)),
            }
        txn["amount"] = self._amount("geographic_fraud")
        txn["fraud_score"] = float(self.rng.uniform(0.75, 0.90))
        txn["fraud_reason"] = "Location sequence physically impossible to travel"
        return txn

    def _apply_merchant_fraud(self, txn):
        txn["amount"] = float(self.rng.choice([49.99, 99.99, 199.99, 299.99]))
        txn["fraud_score"] = float(self.rng.uniform(0.60, 0.85))
        txn["fraud_reason"] = "Merchant-side fabricated charge signature"
        return txn

    def _apply_bust_out_fraud(self, txn):
        txn["amount"] = self._amount("bust_out_fraud")
        txn["fraud_score"] = float(self.rng.uniform(0.70, 0.90))
        txn["fraud_reason"] = "Credit line drained in a bust-out spree"
        return txn

    def _apply_friendly_fraud(self, txn):
        txn["amount"] = self._amount("friendly_fraud")
        txn["fraud_score"] = float(self.rng.uniform(0.05, 0.25))
        txn["fraud_reason"] = "Chargeback risk on a likely-genuine purchase"
        return txn

    def _apply_first_party_fraud(self, txn):
        txn["amount"] = self._amount("first_party_fraud")
        txn["fraud_score"] = float(self.rng.uniform(0.10, 0.40))
        txn["fraud_reason"] = "Owner-abuse signals on the account itself"
        return txn

    def record_location(self, user_id: str, geo: Dict[str, float]) -> None:
        """Track legit locations so takeover/impossible-travel have history."""
        self.geographic_history.setdefault(user_id, []).append(dict(geo))

    def get_fraud_statistics(self) -> Dict[str, Any]:
        return {
            "total_scenarios": len(self.scenarios),
            "total_fraud_probability": sum(
                s.probability for s in self.scenarios.values()),
            "velocity_tracking_users": len(self.velocity_windows),
            "geographic_tracking_users": len(self.geographic_history),
        }


def _random_public_ip(rng: np.random.Generator) -> str:
    octets = rng.integers(1, 255, size=4)
    if octets[0] in (10, 192, 172, 127):
        octets[0] = 52
    return ".".join(str(int(o)) for o in octets)


# ---------------------------------------------------------------------------
# coordinated fraud ring
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FraudRingConfig:
    """Shape of a coordinated fraud ring: one attacker operating many
    compromised accounts through a SHARED, small entity set."""

    n_members: int = 24       # compromised user cohort
    n_merchants: int = 6      # complicit merchant set (one benign category)
    n_devices: int = 4        # shared device fingerprints (the attacker's)
    n_ips: int = 3            # shared egress IPs
    rate: float = 0.08        # fraction of the stream that is ring traffic
    merchant_category: str = "grocery"   # camouflage category

    def validate(self) -> None:
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"ring rate must be in [0, 1], got {self.rate}")
        if min(self.n_members, self.n_merchants, self.n_devices,
               self.n_ips) < 1:
            raise ValueError("ring needs >= 1 member/merchant/device/ip")


class FraudRing:
    """Stateful coordinated-ring applier over transaction dicts.

    A user cohort funnels transactions through a handful of shared
    merchants, device fingerprints and egress IPs. Each transaction stays in
    distribution per feature (the member's own amount, geo near home, a
    benign prior score); the signal is the shared-entity structure the
    typed graph's two-hop frontier sees. Membership and every per-record
    draw come from the injected rng, so a seed replays the same ring.
    """

    def __init__(self, config: FraudRingConfig, users,
                 merchant_ids: np.ndarray,
                 merchant_categories: np.ndarray,
                 rng: np.random.Generator):
        config.validate()
        self.config = config
        self.users = users              # sim.simulator.UserPool
        member_idx = rng.choice(users.n,
                                size=min(config.n_members, users.n),
                                replace=False)
        self.member_idx = np.sort(member_idx)
        self.member_ids = users.ids[self.member_idx]
        in_cat = merchant_ids[merchant_categories
                              == config.merchant_category]
        if len(in_cat) == 0:
            in_cat = merchant_ids
        self.merchant_ids = in_cat[:config.n_merchants]
        self.device_ids = [f"ringdev_{int(rng.integers(0, 2**32)):08x}"
                           for _ in range(config.n_devices)]
        self.ips = [_random_public_ip(rng) for _ in range(config.n_ips)]
        self.rng = rng
        self.applied = 0

    def apply(self, txn: Dict[str, Any]) -> Dict[str, Any]:
        """Rewrite one transaction as ring traffic: a member's own spend
        and home geo, one of the ring's merchants, devices and IPs."""
        rng = self.rng
        u = int(self.member_idx[int(rng.integers(0,
                                                 len(self.member_idx)))])
        txn["user_id"] = str(self.users.ids[u])
        txn["amount"] = max(1.0, round(
            float(self.users.avg_amount[u])
            * float(rng.normal(1.0, 0.3)) * float(rng.normal(1.0, 0.2)), 2))
        txn["geolocation"] = {
            "lat": float(self.users.home_lat[u] + rng.normal(0, 0.5)),
            "lon": float(self.users.home_lon[u] + rng.normal(0, 0.5)),
        }
        txn["merchant_id"] = str(
            self.merchant_ids[int(rng.integers(0, len(self.merchant_ids)))])
        device = self.device_ids[int(rng.integers(0, len(self.device_ids)))]
        txn["device_id"] = device
        txn["device_fingerprint"] = device
        txn["ip_address"] = self.ips[int(rng.integers(0, len(self.ips)))]
        txn["is_fraud"] = True
        txn["fraud_type"] = "fraud_ring"
        txn["fraud_score"] = float(rng.uniform(0.0, 0.3))
        txn["fraud_reason"] = (
            "coordinated ring (shared devices/merchants/IPs across cohort)")
        self.applied += 1
        return txn

    def stats(self) -> Dict[str, Any]:
        return {
            "members": len(self.member_ids),
            "merchants": len(self.merchant_ids),
            "devices": len(self.device_ids),
            "ips": len(self.ips),
            "category": self.config.merchant_category,
            "rate": self.config.rate,
            "applied": self.applied,
        }
