"""Bounded labeled-example buffer: the training-side state of the
continuous-learning plane (``feedback/``).

Port of the JAX package's ``state/labeled.py`` (pure NumPy, kept as a copy
of its own: the same rows give the same ``arrays()``, order and dtypes
included).

Holds (feature_row, label, served_score, per-branch predictions, optional
LSTM history) tuples produced by the label join (feedback/labels.py) so a
background retrain (feedback/policy.Retrainer) always has a recent,
bounded, class-aware corpus:

- **Bounded**: hard capacity; memory never grows with stream length.
- **Class-aware retention**: fraud labels are ~5% of the stream and the
  whole point of retraining, so positives and negatives evict on separate
  FIFO rings (positives get ``capacity // 5`` slots — at a 5% fraud rate
  that retains positives ~5x longer than a single shared ring would).
- **Chronological reads**: ``arrays()`` returns time-ordered views so the
  retrain/gate split ("train on the past, gate on the most recent") is a
  simple index cut.

Single-writer discipline, same as the other stores in this package.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

__all__ = ["LabeledExampleBuffer"]


class LabeledExampleBuffer:
    """FIFO labeled-example store with per-class eviction rings."""

    def __init__(self, capacity: int = 50_000,
                 store_history: bool = False) -> None:
        if capacity < 10:
            raise ValueError(f"capacity must be >= 10, got {capacity}")
        self.capacity = int(capacity)
        self.store_history = bool(store_history)
        pos_cap = max(self.capacity // 5, 5)
        self._pos: deque = deque(maxlen=pos_cap)
        self._neg: deque = deque(maxlen=self.capacity - pos_cap)
        self.appended = 0
        self.evicted = 0

    def append(self, features: np.ndarray, label: bool, score: float,
               ts: float,
               branch_preds: Optional[Mapping[str, float]] = None,
               history: Optional[np.ndarray] = None,
               history_len: Optional[int] = None) -> None:
        ring = self._pos if label else self._neg
        if len(ring) == ring.maxlen:
            self.evicted += 1
        item = {
            "features": np.asarray(features, np.float32),
            "label": bool(label),
            "score": float(score),
            "ts": float(ts),
            "branch_preds": dict(branch_preds or {}),
        }
        if self.store_history and history is not None:
            item["history"] = np.asarray(history, np.float32)
            item["history_len"] = int(history_len or 0)
        ring.append(item)
        self.appended += 1

    # ------------------------------------------------------------------ reads
    def __len__(self) -> int:
        return len(self._pos) + len(self._neg)

    @property
    def positives(self) -> int:
        return len(self._pos)

    @property
    def negatives(self) -> int:
        return len(self._neg)

    def snapshot_rows(self) -> List[Dict[str, Any]]:
        """Shallow O(n) copy of the live rows — the ONLY part a concurrent
        writer's lock needs to cover. Hand the result to ``arrays_from``
        outside the lock for the expensive sort + stack (the serving app's
        retrain thread does exactly this so a 50k-row snapshot never
        stalls scoring)."""
        return list(self._pos) + list(self._neg)

    def _items_by_time(self) -> List[Dict[str, Any]]:
        return sorted(self.snapshot_rows(), key=lambda it: it["ts"])

    def arrays(self) -> Dict[str, np.ndarray]:
        """Time-ordered columns: ``x`` f32[N, F], ``y`` f32[N], ``score``
        f32[N], ``ts`` f64[N] (+ ``history``/``history_len`` when stored).
        Empty buffer returns zero-length arrays. Single-writer callers
        only — for cross-thread use take ``snapshot_rows`` under the
        writer's lock and build with ``arrays_from``."""
        return self.arrays_from(self.snapshot_rows(), self.store_history)

    @staticmethod
    def arrays_from(rows: List[Dict[str, Any]],
                    store_history: bool = False) -> Dict[str, np.ndarray]:
        items = sorted(rows, key=lambda it: it["ts"])
        if not items:
            out = {"x": np.zeros((0, 0), np.float32),
                   "y": np.zeros((0,), np.float32),
                   "score": np.zeros((0,), np.float32),
                   "ts": np.zeros((0,), np.float64)}
            if store_history:
                out["history"] = np.zeros((0, 0, 0), np.float32)
                out["history_len"] = np.zeros((0,), np.int32)
            return out
        out = {
            "x": np.stack([it["features"] for it in items]),
            "y": np.asarray([it["label"] for it in items], np.float32),
            "score": np.asarray([it["score"] for it in items], np.float32),
            "ts": np.asarray([it["ts"] for it in items], np.float64),
        }
        if store_history and "history" in items[0]:
            out["history"] = np.stack([it["history"] for it in items])
            out["history_len"] = np.asarray(
                [it["history_len"] for it in items], np.int32)
        return out

    def branch_preds(self) -> List[Dict[str, float]]:
        """Per-example branch predictions, time-ordered (same order as
        ``arrays()``)."""
        return [it["branch_preds"] for it in self._items_by_time()]

    def stats(self) -> Dict[str, Any]:
        return {
            "size": len(self),
            "positives": self.positives,
            "negatives": self.negatives,
            "capacity": self.capacity,
            "appended": self.appended,
            "evicted": self.evicted,
        }
