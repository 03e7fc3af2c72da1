"""Tensorised isolation forest.

Port of the JAX package's ``models/isolation_forest.py`` scoring half: each
isolation tree uses the complete-tree layout of ``models/trees.py`` with
leaves holding the path-length estimate h; the anomaly score is
s = 2^(-E[h]/c(psi)) and the probability 1/(1+exp(0.5 - s))
(model_manager.py:338-346).
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
