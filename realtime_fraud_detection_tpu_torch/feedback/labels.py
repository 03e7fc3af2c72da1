"""Delayed-label stream + the prediction x label join.

Port of the JAX package's ``feedback/labels.py`` (host Python, a copy of
its own; event times parse through the port's ``state/stores.py``).

Ground truth in payments arrives late: a chargeback lands days after the
transaction, a confirmed-legit settles sooner. ``make_label_events``
synthesizes that delay distribution for simulator transactions (the
label-producer role); :class:`LabelJoin` matches label events back to the
predictions the pipeline actually emitted.

The join follows the JAX package's ``stream/joins.py`` watermark discipline
but is a *keyed interval join*, not a tumbling-window cross product:
predictions and labels pair 1:1 on ``transaction_id``, a match fires the
moment both sides are present, and a buffered prediction expires (counted,
never silently dropped) once the joint watermark passes its timestamp plus
the label horizon — the bound that keeps the pending table finite under
label loss. Single-writer discipline.
"""

from __future__ import annotations

import heapq
import math
from collections import deque
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

__all__ = ["LabelJoin", "make_label_events",
           "FRAUD_LABEL_DELAY_S", "LEGIT_LABEL_DELAY_S"]

# Chargeback-style delay parameters (seconds). Fraud labels ride the
# chargeback pipeline — lognormal around ~9 days with a heavy tail toward
# the 60-90 day network limits; legit confirmations settle in ~2 days.
# ``delay_scale`` compresses both (the drill runs the same shape on a
# virtual clock measured in seconds).
FRAUD_LABEL_DELAY_S = (math.log(9 * 86_400.0), 0.8)    # lognormal (mu, sigma)
LEGIT_LABEL_DELAY_S = (math.log(2 * 86_400.0), 0.5)


def make_label_events(txns: List[Mapping[str, Any]],
                      rng: np.random.Generator,
                      event_ts: Optional[List[float]] = None,
                      delay_scale: float = 1.0) -> List[Dict[str, Any]]:
    """Label events for a list of transactions, delayed chargeback-style.

    ``event_ts`` overrides each transaction's event time (virtual-clock
    runs); default parses ``timestamp_ms`` / ISO ``timestamp``. Returns
    events sorted by ``label_ts`` — the order a label topic would carry
    them in label time.
    """
    from realtime_fraud_detection_tpu_torch.state.stores import _event_time_ms

    events = []
    for i, txn in enumerate(txns):
        is_fraud = bool(txn.get("is_fraud"))
        mu, sigma = FRAUD_LABEL_DELAY_S if is_fraud else LEGIT_LABEL_DELAY_S
        delay = float(rng.lognormal(mu, sigma)) * float(delay_scale)
        ts = (float(event_ts[i]) if event_ts is not None
              else _event_time_ms(txn, None) / 1000.0)
        events.append({
            "transaction_id": str(txn.get("transaction_id", "")),
            "is_fraud": is_fraud,
            "fraud_type": txn.get("fraud_type"),
            "event_ts": ts,
            "label_ts": ts + delay,
        })
    events.sort(key=lambda e: e["label_ts"])
    return events


class LabelJoin:
    """Keyed interval join of emitted predictions x delayed labels.

    ``process_prediction`` buffers a scored transaction (with whatever
    payload the caller wants back — served score, branch predictions,
    feature row); ``process_label`` matches by transaction_id. Both return
    the list of newly matched ``{prediction payload..., label fields...}``
    dicts. Out-of-order labels (label seen before its prediction — e.g. a
    replayed predictions partition) buffer on the label side and match when
    the prediction arrives.

    Watermark semantics: the joint watermark
    is ``min(pred_max - pred_ooo, label_max - label_ooo)``; a prediction
    whose ``ts + horizon_s`` falls behind it will never get a label — it
    expires, counted in ``expired``. Early labels expire against the same
    horizon (``orphan_labels``: a label for a prediction this process never
    emitted, e.g. another consumer group's shard).
    """

    def __init__(self, horizon_s: float = 90 * 86_400.0,
                 pred_ooo_s: float = 5.0,
                 label_ooo_s: float = 60.0,
                 max_pending: int = 100_000,
                 matched_memory: int = 65_536):
        self.horizon_s = float(horizon_s)
        self.pred_ooo_s = float(pred_ooo_s)
        self.label_ooo_s = float(label_ooo_s)
        # hard memory bound: the watermark horizon only evicts while BOTH
        # streams advance (a silent labels topic freezes the joint
        # watermark at -inf), so a missing/wedged label producer must not
        # grow the pending table to OOM — beyond max_pending the oldest
        # prediction is expired outright (counted, like any expiry)
        self.max_pending = int(max_pending)
        self._pending: Dict[str, Dict[str, Any]] = {}   # txn_id -> payload
        self._early_labels: Dict[str, Dict[str, Any]] = {}
        self._pred_heap: List = []      # (ts, txn_id) lazy-deleted
        self._label_heap: List = []
        self._pred_max_ts = -math.inf
        self._label_max_ts = -math.inf
        # recently matched txn_ids: dedupes label/prediction REPLAYS that
        # arrive after their match already fired (both topics are
        # at-least-once) — bounded FIFO memory
        self._matched_ids: set = set()
        self._matched_fifo: deque = deque(maxlen=int(matched_memory))
        self.matched = 0
        self.expired = 0
        self.orphan_labels = 0
        self.duplicate_labels = 0

    @property
    def watermark(self) -> float:
        return min(self._pred_max_ts - self.pred_ooo_s,
                   self._label_max_ts - self.label_ooo_s)

    def __len__(self) -> int:
        return len(self._pending)

    # ---------------------------------------------------------------- inputs
    def _mark_matched(self, txn_id: str) -> None:
        self.matched += 1
        if self._matched_fifo.maxlen and \
                len(self._matched_fifo) == self._matched_fifo.maxlen:
            self._matched_ids.discard(self._matched_fifo[0])
        self._matched_fifo.append(txn_id)
        self._matched_ids.add(txn_id)

    def process_prediction(self, txn_id: str, ts: float,
                           payload: Mapping[str, Any]) -> List[Dict[str, Any]]:
        self._pred_max_ts = max(self._pred_max_ts, ts)
        txn_id = str(txn_id)
        if txn_id in self._matched_ids:
            # replayed prediction whose match already fired — buffering it
            # again would re-match a replayed label and double-count
            self._expire()
            return []
        early = self._early_labels.pop(txn_id, None)
        if early is not None:
            self._mark_matched(txn_id)
            self._expire()
            return [self._merge(payload, ts, early)]
        if txn_id in self._pending:
            # replayed prediction (at-least-once topic): first copy wins
            self._expire()
            return []
        self._pending[txn_id] = {"ts": float(ts), "payload": dict(payload)}
        heapq.heappush(self._pred_heap, (float(ts), txn_id))
        self._expire()
        return []

    def process_label(self, event: Mapping[str, Any]) -> List[Dict[str, Any]]:
        ts = float(event.get("label_ts", 0.0))
        self._label_max_ts = max(self._label_max_ts, ts)
        txn_id = str(event.get("transaction_id", ""))
        if txn_id in self._matched_ids:
            # replayed label whose match already fired
            self.duplicate_labels += 1
            self._expire()
            return []
        pend = self._pending.pop(txn_id, None)
        if pend is not None:
            self._mark_matched(txn_id)
            self._expire()
            return [self._merge(pend["payload"], pend["ts"], event)]
        if txn_id in self._early_labels:
            self.duplicate_labels += 1
            self._expire()
            return []
        self._early_labels[txn_id] = dict(event)
        heapq.heappush(self._label_heap, (ts, txn_id))
        self._expire()
        return []

    @staticmethod
    def _merge(payload: Mapping[str, Any], pred_ts: float,
               label: Mapping[str, Any]) -> Dict[str, Any]:
        out = dict(payload)
        out["pred_ts"] = float(pred_ts)
        out["is_fraud"] = bool(label.get("is_fraud"))
        out["fraud_type"] = label.get("fraud_type")
        out["label_ts"] = float(label.get("label_ts", pred_ts))
        out["label_lag_s"] = max(0.0, out["label_ts"] - float(pred_ts))
        return out

    # ---------------------------------------------------------------- expiry
    def _expire(self) -> None:
        wm = self.watermark
        cutoff = wm - self.horizon_s
        while self._pred_heap and self._pred_heap[0][0] <= cutoff:
            ts, txn_id = heapq.heappop(self._pred_heap)
            pend = self._pending.get(txn_id)
            if pend is not None and pend["ts"] == ts:
                del self._pending[txn_id]
                self.expired += 1
        # hard cap regardless of watermark progress: with a silent label
        # stream the joint watermark never advances, but memory must not
        # grow with stream length — expire the OLDEST pending predictions
        while len(self._pending) > self.max_pending and self._pred_heap:
            ts, txn_id = heapq.heappop(self._pred_heap)
            pend = self._pending.get(txn_id)
            if pend is not None and pend["ts"] == ts:
                del self._pending[txn_id]
                self.expired += 1
        while self._label_heap and self._label_heap[0][0] <= cutoff:
            ts, txn_id = heapq.heappop(self._label_heap)
            ev = self._early_labels.get(txn_id)
            if ev is not None and float(ev.get("label_ts", 0.0)) == ts:
                del self._early_labels[txn_id]
                self.orphan_labels += 1

    def stats(self) -> Dict[str, Any]:
        return {
            "pending_predictions": len(self._pending),
            "early_labels": len(self._early_labels),
            "matched": self.matched,
            "expired_unlabeled": self.expired,
            "orphan_labels": self.orphan_labels,
            "duplicate_labels": self.duplicate_labels,
        }
