"""Tensorised isolation forest.

Port of the JAX package's ``models/isolation_forest.py``: each isolation
tree uses the complete-tree layout of ``models/trees.py`` with leaves holding
the path-length estimate h; the anomaly score is s = 2^(-E[h]/c(psi)) and the
probability 1/(1+exp(0.5 - s)) (model_manager.py:338-346).
``IsolationForestTrainer`` fits the trees with NumPy on the host (random
splits on subsamples), bit-identical to the JAX trainer for the same data
and seed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from realtime_fraud_detection_tpu_torch.models.trees import (
    descend_complete_trees,
    gather_leaf_values,
    gemm_leaf_contract,
)


def _c(n: float) -> float:
    """Average unsuccessful BST search length c(n) (Liu et al. 2008)."""
    if n <= 1:
        return 0.0
    h = math.log(n - 1) + 0.5772156649015329
    return 2.0 * h - 2.0 * (n - 1) / n


@dataclass
class IsolationForest:
    """Complete-binary-tree isolation forest parameters."""

    feature: torch.Tensor      # i32[T, I]
    threshold: torch.Tensor    # f32[T, I]
    path_length: torch.Tensor  # f32[T, L]
    c_psi: torch.Tensor        # f32[] normaliser c(psi)

    def to(self, device) -> "IsolationForest":
        return IsolationForest(*(t.to(device) for t in (
            self.feature, self.threshold, self.path_length, self.c_psi)))


def random_isolation_forest(rng: np.random.Generator, n_trees: int,
                            depth: int = 8, n_features: int = 64,
                            psi: int = 256) -> IsolationForest:
    """Seeded random forest: every node split, leaf path lengths in
    [depth, depth + c(psi)]."""
    n_internal = 2 ** depth - 1
    return IsolationForest(
        feature=torch.from_numpy(rng.integers(
            0, n_features, (n_trees, n_internal)).astype(np.int32)),
        threshold=torch.from_numpy(rng.normal(
            0.5, 1.0, (n_trees, n_internal)).astype(np.float32)),
        path_length=torch.from_numpy((depth + _c(psi) * rng.random(
            (n_trees, 2 ** depth))).astype(np.float32)),
        c_psi=torch.tensor(_c(psi), dtype=torch.float32),
    )


def iforest_scores(forest: IsolationForest, x: torch.Tensor,
                   kernel: str = "gather") -> torch.Tensor:
    """Anomaly score s in (0, 1]; higher = more anomalous. f32[B]."""
    if kernel == "gemm":
        h = gemm_leaf_contract(forest.feature, forest.threshold,
                               forest.path_length, x)
    elif kernel == "gather":
        leaf_idx = descend_complete_trees(forest.feature, forest.threshold, x)
        h = gather_leaf_values(forest.path_length, leaf_idx)
    else:
        raise ValueError(
            f"iforest kernel must be 'gather' or 'gemm', got {kernel!r}")
    return torch.exp2(-h.mean(dim=1) / forest.c_psi)


def iforest_predict(forest: IsolationForest, x: torch.Tensor,
                    kernel: str = "gather") -> torch.Tensor:
    """Fraud probability f32[B]: 1/(1+exp(0.5 - s))."""
    decision = 0.5 - iforest_scores(forest, x, kernel=kernel)
    return 1.0 / (1.0 + torch.exp(decision))


@dataclass
class IsolationForestTrainer:
    """Fits isolation trees on subsamples with random splits."""

    n_estimators: int = 100
    max_samples: int = 256
    seed: int = 42

    def fit(self, x: np.ndarray) -> IsolationForest:
        rng = np.random.default_rng(self.seed)
        x = np.asarray(x, np.float32)
        n, f = x.shape
        psi = min(self.max_samples, n)
        depth = max(1, int(np.ceil(np.log2(psi))))
        n_internal = 2**depth - 1
        n_leaf = 2**depth

        feat = np.zeros((self.n_estimators, n_internal), np.int32)
        thr = np.full((self.n_estimators, n_internal), np.inf, np.float32)
        plen = np.zeros((self.n_estimators, n_leaf), np.float32)

        for t in range(self.n_estimators):
            idx = rng.choice(n, size=psi, replace=False)
            # node -> sample index list, grown breadth-first over the tree
            members: dict[int, np.ndarray] = {0: idx}
            for node in range(n_internal):
                rows = members.pop(node, None)
                if rows is None:
                    continue
                level = int(np.log2(node + 1))
                if len(rows) <= 1:
                    self._seal(node, level, depth, len(rows), thr[t], plen[t])
                    continue
                sub = x[rows]
                lo, hi = sub.min(axis=0), sub.max(axis=0)
                splittable = np.where(hi > lo)[0]
                if splittable.size == 0:
                    self._seal(node, level, depth, len(rows), thr[t], plen[t])
                    continue
                j = int(rng.choice(splittable))
                s = float(rng.uniform(lo[j], hi[j]))
                feat[t, node] = j
                thr[t, node] = s
                right = sub[:, j] >= s
                members[2 * node + 1] = rows[~right]
                members[2 * node + 2] = rows[right]
            # max-depth leaves
            for node, rows in members.items():
                leaf = node - n_internal
                plen[t, leaf] = depth + _c(len(rows))

        return IsolationForest(
            feature=torch.from_numpy(feat),
            threshold=torch.from_numpy(thr),
            path_length=torch.from_numpy(plen),
            c_psi=torch.tensor(_c(psi), dtype=torch.float32),
        )

    @staticmethod
    def _seal(node: int, level: int, depth: int, n_rows: int,
              thr: np.ndarray, plen: np.ndarray) -> None:
        """Terminate a node early: inf thresholds route left to one leaf."""
        h = level + _c(n_rows)
        n_internal = thr.shape[0]
        # walk the leftmost chain to the leaf, marking inf thresholds
        cur = node
        for _ in range(depth - level):
            thr[cur] = np.inf
            cur = 2 * cur + 1
        first_leaf = cur - n_internal
        span = 2 ** (depth - level)
        plen[first_leaf : first_leaf + span] = h
