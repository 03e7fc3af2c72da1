"""Feature registry and online feature statistics: the FeatureStore.

Port of the JAX package's ``state/feature_store.py``, a capability mirror of
the reference's FeatureStore (FeatureStore.java:21-398): feature
registration with typed metadata, per-entity feature values with a TTL
(2 h), single / batch / selected retrieval, and online per-feature
statistics for data-quality monitoring, with two reference defects fixed:

1. **storeFeatureValues never stores**: the reference builds the enriched
   JSON, then calls ``redisService.incrementCounter(key, ttl)`` instead of
   storing it (FeatureStore.java:122-146). Here the values are stored and
   can be read back.
2. **std-dev is never computed**: the reference's Welford update drops the
   M2 term (FeatureStore.java:268). Here the full Welford update (count,
   mean, M2) runs, so ``std`` is real.

Registration metadata mirrors FeatureMetadata (name / type / description /
version / created / updated / properties, :46-61); statistics mirror
FeatureStats (count / mean / std / min / max, categorical counts, null
rate, :63-75). Backed by the in-process ``_MemoryBackend`` of the other
stores (single writer); ``state/metadata.py MetadataStore`` is the durable
(SQLite) tier.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Set

from realtime_fraud_detection_tpu_torch.features.extract import FEATURE_NAMES
from realtime_fraud_detection_tpu_torch.state.stores import _MemoryBackend

__all__ = ["FeatureStore", "FeatureStats"]

FEATURE_TYPES = ("NUMERICAL", "CATEGORICAL", "BOOLEAN", "TEXT", "TIMESTAMP")

METADATA_TTL_S = 86_400.0     # FeatureStore.java:36
VALUES_TTL_S = 7_200.0        # :37
STATS_TTL_S = 3_600.0         # :38 (stats here don't expire; TTL kept for
                              # parity in health reporting)


class FeatureStats:
    """Online statistics for one feature (FeatureStats, :63-75) with a real
    Welford accumulator."""

    __slots__ = ("name", "count", "numeric_count", "mean", "m2", "min",
                 "max", "categorical_counts", "null_count", "last_updated")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.numeric_count = 0
        self.mean = 0.0
        self.m2 = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.categorical_counts: Dict[str, int] = {}
        self.null_count = 0
        self.last_updated = 0.0

    def update(self, value: Any, now: float) -> None:
        self.count += 1
        self.last_updated = now
        if value is None:
            self.null_count += 1
        elif isinstance(value, bool):
            key = str(value).lower()
            self.categorical_counts[key] = self.categorical_counts.get(key, 0) + 1
        elif isinstance(value, (int, float)):
            v = float(value)
            self.numeric_count += 1
            delta = v - self.mean
            self.mean += delta / self.numeric_count
            self.m2 += delta * (v - self.mean)
            self.min = min(self.min, v)
            self.max = max(self.max, v)
        else:
            key = str(value)
            self.categorical_counts[key] = self.categorical_counts.get(key, 0) + 1

    @property
    def std(self) -> float:
        n = self.numeric_count
        return math.sqrt(self.m2 / n) if n >= 2 else 0.0

    @property
    def null_rate(self) -> float:
        return self.null_count / self.count if self.count else 0.0

    def to_dict(self) -> Dict[str, Any]:
        # min/max must stay JSON-safe (no Infinity tokens) when no numeric
        # sample has been seen — e.g. purely categorical features
        has_numeric = self.numeric_count > 0
        return {
            "feature_name": self.name,
            "count": self.count,
            "mean": self.mean,
            "std": self.std,
            "min": self.min if has_numeric else 0.0,
            "max": self.max if has_numeric else 0.0,
            "null_rate": self.null_rate,
            "categorical_counts": dict(self.categorical_counts),
            "last_updated": self.last_updated,
        }


class FeatureStore:
    """Registry + values + statistics, in one single-writer object."""

    def __init__(self):
        self._metadata: Dict[str, Dict[str, Any]] = {}
        self._values = _MemoryBackend()
        self._stats: Dict[str, FeatureStats] = {}
        self.counters = {"stored": 0, "retrieved": 0, "registered": 0}

    # ------------------------------------------------------------- registry
    def register_feature(self, name: str, feature_type: str = "NUMERICAL",
                         description: str = "",
                         properties: Optional[Mapping[str, Any]] = None,
                         now: Optional[float] = None) -> Dict[str, Any]:
        """registerFeature (:83-117). Re-registering bumps version and
        ``updated_at``."""
        if feature_type not in FEATURE_TYPES:
            raise ValueError(
                f"unknown feature type {feature_type!r}; one of {FEATURE_TYPES}")
        ts = now if now is not None else time.time()
        existing = self._metadata.get(name)
        if existing is None:
            meta = {
                "name": name, "type": feature_type,
                "description": description, "version": 1,
                "created_at": ts, "updated_at": ts,
                "properties": dict(properties or {}),
            }
        else:
            meta = dict(existing)
            meta.update(type=feature_type, description=description,
                        version=existing["version"] + 1, updated_at=ts)
            if properties:
                meta["properties"] = {**existing["properties"], **properties}
        self._metadata[name] = meta
        self.counters["registered"] += 1
        return meta

    def get_metadata(self, name: str) -> Optional[Dict[str, Any]]:
        return self._metadata.get(name)

    def registered_features(self) -> Set[str]:
        """getRegisteredFeatures (:325-365): explicit registrations plus the
        canonical 64-feature contract (features/extract.py FEATURE_NAMES)."""
        return set(self._metadata) | set(FEATURE_NAMES)

    # --------------------------------------------------------------- values
    @staticmethod
    def _key(entity_type: str, entity_id: str) -> str:
        return f"feature_values:{entity_type}:{entity_id}"

    def store_feature_values(self, entity_id: str, entity_type: str,
                             features: Mapping[str, Any],
                             now: Optional[float] = None) -> None:
        """storeFeatureValues (:122-146) — actually storing the values."""
        ts = now if now is not None else time.time()
        enriched = dict(features)
        enriched["_entity_id"] = entity_id
        enriched["_entity_type"] = entity_type
        enriched["_timestamp"] = ts * 1000.0
        enriched["_version"] = "1.0"
        self._values.put(self._key(entity_type, entity_id), enriched,
                         VALUES_TTL_S, now=ts)
        for name, value in features.items():
            stats = self._stats.get(name)
            if stats is None:
                stats = self._stats[name] = FeatureStats(name)
            stats.update(value, ts)
        self.counters["stored"] += 1

    def get_feature_values(self, entity_id: str, entity_type: str,
                           now: Optional[float] = None) -> Dict[str, Any]:
        """getFeatureValues (:152-174): internal ``_*`` fields stripped."""
        raw = self._values.get(self._key(entity_type, entity_id), now=now)
        self.counters["retrieved"] += 1
        if not raw:
            return {}
        return {k: v for k, v in raw.items() if not k.startswith("_")}

    def get_batch_feature_values(self, entity_ids: Iterable[str],
                                 entity_type: str,
                                 now: Optional[float] = None
                                 ) -> Dict[str, Dict[str, Any]]:
        """getBatchFeatureValues (:179-189)."""
        return {eid: self.get_feature_values(eid, entity_type, now=now)
                for eid in entity_ids}

    def get_selected_features(self, entity_id: str, entity_type: str,
                              feature_names: Iterable[str],
                              now: Optional[float] = None) -> Dict[str, Any]:
        """getSelectedFeatures (:194-201)."""
        wanted = set(feature_names)
        return {k: v
                for k, v in self.get_feature_values(
                    entity_id, entity_type, now=now).items()
                if k in wanted}

    # ----------------------------------------------------------- statistics
    def get_feature_statistics(self, name: str) -> Dict[str, Any]:
        """getFeatureStatistics (:305-322)."""
        stats = self._stats.get(name)
        return stats.to_dict() if stats else FeatureStats(name).to_dict()

    def all_statistics(self) -> List[Dict[str, Any]]:
        return [s.to_dict() for s in self._stats.values()]

    # --------------------------------------------------------------- health
    def health(self) -> Dict[str, Any]:
        """isHealthy/getStoreStatistics analog (:370-396)."""
        return {
            "healthy": True,
            "registered_features": len(self._metadata),
            "tracked_statistics": len(self._stats),
            "stored_value_sets": len(self._values),
            "counters": dict(self.counters),
        }
