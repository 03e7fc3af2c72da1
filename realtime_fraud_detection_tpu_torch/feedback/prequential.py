"""Prequential (test-then-train) quality metrics over the labeled stream.

Port of the JAX package's ``feedback/prequential.py`` (NumPy float64, a
copy of its own: the same events give the same numbers, bit for bit).

Every prediction is scored BEFORE its label is known, so each matched
(prediction, label) pair is an unbiased test observation — the streaming
evaluation discipline of Gama et al. (prequential error) applied to the
fraud blend. Two memories run side by side:

- **Sliding window**: exact metrics over the last N labeled examples —
  AUC (tie-averaged Mann-Whitney, identical to sklearn.roc_auc_score),
  precision/recall at the pinned operating threshold, expected calibration
  error, and per-branch drop-one AUC attribution recomputed host-side from
  the stored per-branch predictions.
- **Exponentially-fading window**: the same statistics under geometric
  per-event decay (weight gamma^age). The fading AUC is EXACT for the
  retained horizon: events are kept until their weight falls below a
  floor, then dropped — at gamma=0.999 and floor 1e-9, ~20.7k events, so
  truncation error on the weighted AUC is below 1e-8.

The fading window reacts like a long EWMA — it IS the degradation
baseline the retrain policy compares the sliding window against (a fresh
drift dents the short window first).
"""

from __future__ import annotations

import math
from collections import deque
from typing import Any, Dict, Mapping, Optional

import numpy as np

__all__ = ["sliding_auc", "weighted_auc", "FadingAUC",
           "PrequentialEvaluator"]


def sliding_auc(y: np.ndarray, s: np.ndarray) -> float:
    """Mann-Whitney AUC with tie-averaged ranks (== sklearn.roc_auc_score).

    NaN when the window holds only one class.
    """
    y = np.asarray(y, np.float64)
    s = np.asarray(s, np.float64)
    _, inv, counts = np.unique(s, return_inverse=True, return_counts=True)
    ends = np.cumsum(counts)
    rank = (ends - (counts - 1) / 2.0)[inv]
    pos = y > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((rank[pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def weighted_auc(y: np.ndarray, s: np.ndarray, w: np.ndarray) -> float:
    """Weighted Mann-Whitney AUC with ties counted at half credit:

        AUC = sum_{i in pos, j in neg} w_i w_j ([s_i > s_j] + 0.5[s_i = s_j])
              / (W_pos * W_neg)

    Computed exactly in O(n log n) via per-unique-score mass cumsums (the
    test suite pins it against the O(n^2) double sum).
    """
    y = np.asarray(y, np.float64)
    s = np.asarray(s, np.float64)
    w = np.asarray(w, np.float64)
    pos = y > 0.5
    w_pos = float(w[pos].sum())
    w_neg = float(w[~pos].sum())
    if w_pos <= 0.0 or w_neg <= 0.0:
        return float("nan")
    uniq, inv = np.unique(s, return_inverse=True)
    pos_mass = np.zeros(len(uniq))
    neg_mass = np.zeros(len(uniq))
    np.add.at(pos_mass, inv[pos], w[pos])
    np.add.at(neg_mass, inv[~pos], w[~pos])
    neg_below = np.concatenate([[0.0], np.cumsum(neg_mass)[:-1]])
    num = float((pos_mass * (neg_below + 0.5 * neg_mass)).sum())
    return num / (w_pos * w_neg)


class FadingAUC:
    """Exponentially-fading AUC + operating-point metrics.

    Each update multiplies every prior observation's weight by ``gamma``
    (equivalently: the k-th most recent event weighs gamma^k). Events are
    dropped once gamma^age < ``weight_floor`` — the retained horizon is
    ceil(log(floor)/log(gamma)) events, beyond which the discarded mass is
    numerically invisible in the weighted AUC.
    """

    def __init__(self, gamma: float = 0.999, weight_floor: float = 1e-9,
                 threshold: float = 0.5):
        if not 0.0 < gamma < 1.0:
            raise ValueError(f"gamma must be in (0, 1), got {gamma}")
        self.gamma = float(gamma)
        self.threshold = float(threshold)
        horizon = int(math.ceil(math.log(weight_floor) / math.log(gamma)))
        self._events: deque = deque(maxlen=max(horizon, 8))  # (score, label)

    def update(self, score: float, label: bool) -> None:
        self._events.append((float(score), bool(label)))

    def __len__(self) -> int:
        return len(self._events)

    def _columns(self):
        n = len(self._events)
        s = np.fromiter((e[0] for e in self._events), np.float64, n)
        y = np.fromiter((e[1] for e in self._events), np.float64, n)
        # newest last in the deque; age = n-1-k for index k
        w = self.gamma ** np.arange(n - 1, -1, -1, dtype=np.float64)
        return y, s, w

    def auc(self) -> float:
        if not self._events:
            return float("nan")
        return weighted_auc(*self._columns())

    def precision_recall(self) -> Dict[str, float]:
        if not self._events:
            return {"precision": float("nan"), "recall": float("nan")}
        y, s, w = self._columns()
        flag = s >= self.threshold
        pos = y > 0.5
        tp = float(w[flag & pos].sum())
        fp = float(w[flag & ~pos].sum())
        fn = float(w[~flag & pos].sum())
        return {
            "precision": tp / (tp + fp) if tp + fp > 0 else float("nan"),
            "recall": tp / (tp + fn) if tp + fn > 0 else float("nan"),
        }


class PrequentialEvaluator:
    """The plane's quality ledger: feed every matched (prediction, label).

    ``update`` order is label-arrival order — the prequential contract:
    the score was produced before the label existed, so the metrics are an
    unbiased running estimate of live model quality.
    """

    def __init__(self, window: int = 2_000, threshold: float = 0.5,
                 fading_gamma: float = 0.999, calibration_bins: int = 10):
        self.window = int(window)
        self.threshold = float(threshold)
        self.calibration_bins = int(calibration_bins)
        # (score, label, branch_preds, label_lag_s)
        self._recent: deque = deque(maxlen=self.window)
        self.fading = FadingAUC(gamma=fading_gamma, threshold=threshold)
        self.labeled_total = 0
        self.fraud_total = 0
        self._lag_sum = 0.0

    # ---------------------------------------------------------------- update
    def update(self, score: float, label: bool,
               branch_preds: Optional[Mapping[str, float]] = None,
               label_lag_s: float = 0.0) -> None:
        self._recent.append((float(score), bool(label),
                             dict(branch_preds or {}), float(label_lag_s)))
        self.fading.update(score, label)
        self.labeled_total += 1
        self.fraud_total += int(bool(label))
        self._lag_sum += float(label_lag_s)

    def __len__(self) -> int:
        return len(self._recent)

    # --------------------------------------------------------------- metrics
    def _columns(self):
        n = len(self._recent)
        s = np.fromiter((e[0] for e in self._recent), np.float64, n)
        y = np.fromiter((e[1] for e in self._recent), np.float64, n)
        return y, s

    def auc(self) -> float:
        if not self._recent:
            return float("nan")
        return sliding_auc(*self._columns())

    def precision_recall(self) -> Dict[str, float]:
        if not self._recent:
            return {"precision": float("nan"), "recall": float("nan"),
                    "flag_rate": float("nan")}
        y, s = self._columns()
        flag = s >= self.threshold
        pos = y > 0.5
        tp = float((flag & pos).sum())
        return {
            "precision": (tp / float(flag.sum()) if flag.any()
                          else float("nan")),
            "recall": (tp / float(pos.sum()) if pos.any() else float("nan")),
            "flag_rate": float(flag.mean()),
        }

    def calibration_error(self) -> float:
        """Expected calibration error over equal-width score bins: the
        |mean score - fraud rate| gap, bin-mass weighted."""
        if not self._recent:
            return float("nan")
        y, s = self._columns()
        bins = np.clip((s * self.calibration_bins).astype(int), 0,
                       self.calibration_bins - 1)
        ece = 0.0
        n = len(s)
        for b in range(self.calibration_bins):
            m = bins == b
            if not m.any():
                continue
            ece += (m.sum() / n) * abs(float(s[m].mean())
                                       - float(y[m].mean()))
        return float(ece)

    def drop_one_attribution(
            self, weights: Mapping[str, float]) -> Dict[str, float]:
        """Per-branch contribution over the sliding window: served-blend
        AUC minus the AUC of the renormalized weighted average with that
        branch removed (recomputed host-side from the stored per-branch
        predictions — the same zero-device-work re-weighting the A/B plane
        uses). Positive = the branch is earning its slot on live traffic."""
        if not self._recent:
            return {}
        y, served = self._columns()
        base_auc = sliding_auc(y, served)
        if math.isnan(base_auc):
            return {}
        names = [n for n, w in weights.items() if w > 0.0]
        out: Dict[str, float] = {}
        n = len(self._recent)
        cols = {name: np.fromiter(
            (e[2].get(name, math.nan) for e in self._recent),
            np.float64, n) for name in names}
        for drop in names:
            rest = [nm for nm in names if nm != drop]
            if not rest:
                continue
            num = np.zeros(n)
            den = np.zeros(n)
            for nm in rest:
                col = cols[nm]
                ok = ~np.isnan(col)
                w = float(weights[nm])
                num[ok] += w * col[ok]
                den[ok] += w
            ok = den > 0
            if ok.sum() < 2:
                continue
            blend = num[ok] / den[ok]
            a = sliding_auc(y[ok], blend)
            if not math.isnan(a):
                out[drop] = round(base_auc - a, 6)
        return out

    # -------------------------------------------------------------- snapshot
    def snapshot(self, weights: Optional[Mapping[str, float]] = None
                 ) -> Dict[str, Any]:
        pr = self.precision_recall()
        fading_pr = self.fading.precision_recall()
        snap: Dict[str, Any] = {
            "labeled_total": self.labeled_total,
            "fraud_total": self.fraud_total,
            "window_size": len(self._recent),
            "operating_threshold": self.threshold,
            "mean_label_lag_s": (self._lag_sum / self.labeled_total
                                 if self.labeled_total else 0.0),
            "sliding": {
                "auc": self.auc(),
                "precision": pr["precision"],
                "recall": pr["recall"],
                "flag_rate": pr["flag_rate"],
                "calibration_error": self.calibration_error(),
            },
            "fading": {
                "auc": self.fading.auc(),
                "precision": fading_pr["precision"],
                "recall": fading_pr["recall"],
            },
        }
        if weights:
            snap["drop_one_auc"] = self.drop_one_attribution(weights)
        return snap
