"""Histogram-based gradient boosting trainer.

Port of the JAX package's ``training/gbdt.py``: second-order (grad / hess)
logistic boosting with quantile-binned histogram splits, growing complete
depth-D trees straight into the ``models/trees.py TreeEnsemble`` layout
(100 trees, depth 6, lr 0.1, subsample 0.8, colsample 0.8 by default). The
trainer is NumPy and runs on the host, as in the reference; only the
returned ensemble is made of torch tensors (on the CPU: the caller moves
it). The same data and seed give bit-identical arrays in both packages.

Unsplit nodes keep threshold=+inf (route left) with both leaves carrying the
parent value, the padding convention the tensorised forward pass expects.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from realtime_fraud_detection_tpu_torch.models.trees import TreeEnsemble


@dataclasses.dataclass
class GBDTTrainer:
    n_estimators: int = 100
    max_depth: int = 6
    learning_rate: float = 0.1
    subsample: float = 0.8
    colsample_bytree: float = 0.8
    n_bins: int = 64
    reg_lambda: float = 1.0
    min_child_weight: float = 1.0
    min_gain: float = 1e-6
    seed: int = 42

    def fit(self, x: np.ndarray, y: np.ndarray) -> TreeEnsemble:
        """Fit on (N, F) features and {0,1} labels; returns the trees.

        Also sets ``self.feature_importances_``: per-feature total split
        gain, normalised to sum 1 (the "gain" importance that prediction
        explanations surface as ``top_feature_importances``).
        """
        rng = np.random.default_rng(self.seed)
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.float32)
        n, f = x.shape
        depth = self.max_depth
        n_internal = 2**depth - 1
        n_leaf = 2**depth

        # quantile bin edges per feature (shared across trees)
        qs = np.linspace(0, 1, self.n_bins + 1)[1:-1]
        edges = np.quantile(x, qs, axis=0).astype(np.float32)  # [n_bins-1, F]
        binned = np.empty((n, f), np.int32)
        for j in range(f):
            binned[:, j] = np.searchsorted(edges[:, j], x[:, j], side="right")

        p0 = float(np.clip(y.mean(), 1e-6, 1 - 1e-6))
        base = float(np.log(p0 / (1 - p0)))
        logits = np.full(n, base, np.float64)

        feat_arr = np.zeros((self.n_estimators, n_internal), np.int32)
        thr_arr = np.full((self.n_estimators, n_internal), np.inf, np.float32)
        leaf_arr = np.zeros((self.n_estimators, n_leaf), np.float32)
        gain_by_feature = np.zeros(f, np.float64)

        for t in range(self.n_estimators):
            p = 1.0 / (1.0 + np.exp(-logits))
            grad = p - y
            hess = np.maximum(p * (1 - p), 1e-12)

            rows = rng.random(n) < self.subsample
            cols = rng.permutation(f)[: max(1, int(round(f * self.colsample_bytree)))]

            node_of = np.zeros(n, np.int32)  # complete-tree node id per sample
            node_of[~rows] = -1              # excluded from split finding
            for node in range(n_internal):
                mask = node_of == node
                if not mask.any():
                    continue
                g, h = grad[mask], hess[mask]
                split = self._best_split(binned[mask][:, cols], g, h)
                if split is None:
                    # leaf early: park samples in the leftmost descendant leaf
                    node_of[mask] = _leftmost_leaf(node, depth)
                    continue
                ci, bin_id, gain = split
                j = cols[ci]
                gain_by_feature[j] += gain
                feat_arr[t, node] = j
                thr_arr[t, node] = (
                    edges[bin_id, j] if bin_id < edges.shape[0] else np.float32(np.inf)
                )
                right = mask & (binned[:, j] > bin_id)
                node_of[np.where(mask & ~right)[0]] = 2 * node + 1
                node_of[np.where(right)[0]] = 2 * node + 2

            # leaf values from full-tree positions (parked samples sit in the
            # leftmost-descendant leaf)
            leaf_vals = np.zeros(n_leaf, np.float64)
            for leaf in range(n_leaf):
                mask = node_of == n_internal + leaf
                if mask.any():
                    gsum, hsum = grad[mask].sum(), hess[mask].sum()
                    leaf_vals[leaf] = -self.learning_rate * gsum / (hsum + self.reg_lambda)
            _fill_pruned_leaves(thr_arr[t], leaf_vals, depth)
            leaf_arr[t] = leaf_vals.astype(np.float32)

            # update the logits of ALL rows through the tensor layout
            logits += _numpy_tree_forward(feat_arr[t], thr_arr[t], leaf_arr[t], x)

        total_gain = gain_by_feature.sum()
        self.feature_importances_ = (
            (gain_by_feature / total_gain).astype(np.float32)
            if total_gain > 0 else np.zeros(f, np.float32)
        )
        return TreeEnsemble(
            feature=torch.from_numpy(feat_arr),
            threshold=torch.from_numpy(thr_arr),
            leaf=torch.from_numpy(leaf_arr),
            base_score=torch.tensor(base, dtype=torch.float32),
        )

    def _best_split(
        self, binned: np.ndarray, grad: np.ndarray, hess: np.ndarray
    ) -> Tuple[int, int, float] | None:
        """Best (col_index, bin, gain) by second-order gain over histograms."""
        gtot, htot = grad.sum(), hess.sum()
        if htot < 2 * self.min_child_weight:
            return None
        parent = gtot * gtot / (htot + self.reg_lambda)
        best = None
        best_gain = self.min_gain
        for ci in range(binned.shape[1]):
            b = binned[:, ci]
            gh = np.zeros((self.n_bins, 2))
            np.add.at(gh, b, np.stack([grad, hess], axis=1))
            gl = np.cumsum(gh[:, 0])[:-1]
            hl = np.cumsum(gh[:, 1])[:-1]
            gr, hr = gtot - gl, htot - hl
            valid = (hl >= self.min_child_weight) & (hr >= self.min_child_weight)
            with np.errstate(divide="ignore", invalid="ignore"):
                gain = (
                    gl * gl / (hl + self.reg_lambda)
                    + gr * gr / (hr + self.reg_lambda)
                    - parent
                ) / 2.0
            gain = np.where(valid, gain, -np.inf)
            k = int(np.argmax(gain))
            if gain[k] > best_gain:
                best_gain = float(gain[k])
                best = (ci, k, best_gain)
        return best


def _leftmost_leaf(node: int, depth: int) -> int:
    """Leaf id (in complete-tree numbering) reached by always going left."""
    level = int(np.log2(node + 1))
    for _ in range(depth - level):
        node = 2 * node + 1
    return node


def _fill_pruned_leaves(thresholds: np.ndarray, leaf_vals: np.ndarray, depth: int) -> None:
    """Copy each unsplit subtree's left-leaf value across its whole leaf span.

    With threshold=+inf everything routes left at inference, so only the
    leftmost leaf of a pruned subtree is ever reached; keeping the span
    consistent makes the arrays robust to any traversal convention.
    """
    n_internal = 2**depth - 1
    for node in range(n_internal):
        if np.isinf(thresholds[node]):
            level = int(np.log2(node + 1))
            span = 2 ** (depth - level)
            first = _leftmost_leaf(node, depth) - n_internal
            leaf_vals[first : first + span] = leaf_vals[first]


def _numpy_tree_forward(
    feature: np.ndarray, threshold: np.ndarray, leaf: np.ndarray, x: np.ndarray
) -> np.ndarray:
    """Single-tree forward in NumPy (training-side logit updates)."""
    n_internal = feature.shape[0]
    depth = int(np.log2(n_internal + 1))
    node = np.zeros(x.shape[0], np.int32)
    for _ in range(depth):
        f = feature[node]
        t = threshold[node]
        node = 2 * node + 1 + (x[np.arange(x.shape[0]), f] >= t).astype(np.int32)
    return leaf[node - n_internal]
