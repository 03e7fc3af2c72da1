"""Serving-side prediction cache: TTL and bounded size, evict-oldest.

Port of the JAX package's ``serving/cache.py`` (the reference's ensemble
prediction cache, ensemble_predictor.py:437-471: 300 s TTL, 1,000 entries),
keyed by transaction_id: a retried ``/predict`` or ``/batch-predict`` of the
same transaction is served the stored response without another trip to the
card. Scoring is stateful (velocity and history move on), so the cache is
for idempotent retries; the TTL bounds how stale a served-again response can
be. Entries are deep-copied in and out, so a caller that edits a response
cannot change the stored one.

``get`` / ``put`` / ``clear`` run under the serving app's score lock;
``stats`` reads only counters and ``len``, so ``/health`` calls it from the
event loop without the lock.
"""

from __future__ import annotations

import copy
import time
from collections import OrderedDict
from typing import Any, Dict, Optional


class PredictionCache:
    def __init__(self, ttl_seconds: float = 300.0, max_entries: int = 1000):
        self.ttl = ttl_seconds
        self.max_entries = max_entries
        self._data: "OrderedDict[str, tuple[float, Dict[str, Any]]]" = (
            OrderedDict())
        self.hits = 0
        self.misses = 0

    def get(self, key: str, now: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """Deep copy out: a caller mutating the served response (experiment
        annotation, downstream enrichment) must not corrupt the entry."""
        # rtfd-lint: allow[wall-clock] default time base; callers pass now explicitly
        now = now if now is not None else time.monotonic()
        entry = self._data.get(key)
        if entry is None or now - entry[0] > self.ttl:
            if entry is not None:
                del self._data[key]    # expired
            self.misses += 1
            return None
        self.hits += 1
        return copy.deepcopy(entry[1])

    def put(self, key: str, result: Dict[str, Any],
            now: Optional[float] = None) -> None:
        """Deep copy in: the stored response is frozen at serve time."""
        if not key:
            return
        # rtfd-lint: allow[wall-clock] default time base; callers pass now explicitly
        now = now if now is not None else time.monotonic()
        self._data[key] = (now, copy.deepcopy(result))
        self._data.move_to_end(key)
        while len(self._data) > self.max_entries:
            self._data.popitem(last=False)         # evict oldest insertion

    def clear(self) -> None:
        """Drop entries, keep hit/miss counters (they are monotonic counters
        on /health — a model reload must not reset a scraped series)."""
        self._data.clear()

    def stats(self) -> Dict[str, Any]:
        return {"entries": len(self._data), "hits": self.hits,
                "misses": self.misses, "ttl_seconds": self.ttl,
                "max_entries": self.max_entries}
