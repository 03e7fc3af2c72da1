"""Tensorised gradient-boosted tree inference.

Port of the JAX package's ``models/trees.py``. Every tree is a *complete*
binary tree of fixed depth D:

- ``feature``   i32[T, 2^D - 1]  split feature per internal node
- ``threshold`` f32[T, 2^D - 1]  split threshold; **x >= threshold goes
  right**, and ``threshold = +inf`` marks an unsplit node
- ``leaf``      f32[T, 2^D]      leaf values (log-odds contributions)

Two traversals with identical leaves: the D-step gather oracle
(``descend_complete_trees`` + ``gather_leaf_values``) and the GEMM form of
Hummingbird (arXiv:2010.04804: ``gemm_leaf_onehot`` and friends), whose
count arithmetic is exact in f32. The GEMM form needs full f32 matmuls: with
TF32 on, the feature-selection contraction would round the features.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch


@dataclass
class TreeEnsemble:
    """Complete-binary-tree GBDT parameters."""

    feature: torch.Tensor     # i32[T, I] with I = 2^depth - 1
    threshold: torch.Tensor   # f32[T, I]
    leaf: torch.Tensor        # f32[T, L] with L = 2^depth
    base_score: torch.Tensor  # f32[] prior logit

    def to(self, device) -> "TreeEnsemble":
        return TreeEnsemble(*(t.to(device) for t in (
            self.feature, self.threshold, self.leaf, self.base_score)))


def random_tree_ensemble(rng: np.random.Generator, n_trees: int, depth: int,
                         n_features: int = 64) -> TreeEnsemble:
    """Seeded random complete trees: every node split, leaves ~N(0, 0.1)."""
    n_internal = 2 ** depth - 1
    return TreeEnsemble(
        feature=torch.from_numpy(rng.integers(
            0, n_features, (n_trees, n_internal)).astype(np.int32)),
        threshold=torch.from_numpy(rng.normal(
            0.5, 1.0, (n_trees, n_internal)).astype(np.float32)),
        leaf=torch.from_numpy(rng.normal(
            0.0, 0.1, (n_trees, 2 ** depth)).astype(np.float32)),
        base_score=torch.tensor(0.0, dtype=torch.float32),
    )


def descend_complete_trees(feature: torch.Tensor, threshold: torch.Tensor,
                           x: torch.Tensor) -> torch.Tensor:
    """Leaf index per (row, tree): i32[B, T] in [0, 2^D)."""
    b = x.shape[0]
    t, n_internal = feature.shape
    depth = int(np.log2(n_internal + 1))
    feat_flat = feature.reshape(-1).long()
    thr_flat = threshold.reshape(-1)
    tree_offset = torch.arange(t, device=x.device) * n_internal      # [T]
    node = torch.zeros((b, t), dtype=torch.long, device=x.device)
    for _ in range(depth):
        flat = node + tree_offset[None, :]
        xv = torch.gather(x, 1, feat_flat[flat])                     # [B, T]
        node = 2 * node + 1 + (xv >= thr_flat[flat]).long()
    return (node - n_internal).to(torch.int32)


def gather_leaf_values(leaf: torch.Tensor, leaf_idx: torch.Tensor) -> torch.Tensor:
    """leaf: [T, L], leaf_idx: i32[B, T] -> f32[B, T] values."""
    t, n_leaf = leaf.shape
    offset = torch.arange(t, device=leaf.device) * n_leaf
    return leaf.reshape(-1)[leaf_idx.long() + offset[None, :]]


@lru_cache(maxsize=None)
def _complete_tree_paths(depth: int) -> tuple:
    """``C`` i8[I, L]: +1 where leaf l is in the LEFT subtree of internal
    node i, -1 for the right subtree, 0 when i is not an ancestor; ``d``
    i32[L]: the number of left edges on the path to l."""
    n_internal = 2 ** depth - 1
    n_leaf = 2 ** depth
    c = np.zeros((n_internal, n_leaf), np.int8)
    d = np.zeros((n_leaf,), np.int32)
    for leaf in range(n_leaf):
        node = leaf + n_internal
        while node:
            parent = (node - 1) // 2
            is_left = node == 2 * parent + 1
            c[parent, leaf] = 1 if is_left else -1
            if is_left:
                d[leaf] += 1
            node = parent
    return c, d


def gemm_leaf_onehot(feature: torch.Tensor, threshold: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """One-hot leaf selection as matmuls. f32[B, T, L].

    (1) a one-hot feature-selection tensor routes ``x`` to every internal
    node, (2) the left indicators contract with the ancestor constants ``C``,
    (3) the leaf whose count of satisfied left conditions equals its
    left-edge count ``d`` lights up. ``left = NOT (x >= t)``, as in the
    gather path.
    """
    t, n_internal = feature.shape
    depth = int(np.log2(n_internal + 1))
    f_dim = x.shape[1]
    c, d = _complete_tree_paths(depth)
    sel = (feature[:, :, None].long()
           == torch.arange(f_dim, device=x.device)[None, None, :])
    xv = torch.einsum("bf,tif->bti", x, sel.to(x.dtype))           # [B, T, I]
    left = 1.0 - (xv >= threshold[None, :, :]).to(x.dtype)
    reach = torch.einsum("bti,il->btl", left,
                         torch.from_numpy(c).to(device=x.device, dtype=x.dtype))
    d_t = torch.from_numpy(d).to(device=x.device, dtype=x.dtype)
    return (reach == d_t[None, None, :]).to(x.dtype)


def gemm_leaf_index(feature: torch.Tensor, threshold: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """GEMM-path leaf indices i32[B, T]."""
    return torch.argmax(gemm_leaf_onehot(feature, threshold, x),
                        dim=2).to(torch.int32)


def gemm_leaf_contract(feature: torch.Tensor, threshold: torch.Tensor,
                       values: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One-hot leaf selection contracted with per-leaf ``values`` [T, L]
    -> f32[B, T]."""
    onehot = gemm_leaf_onehot(feature, threshold, x)
    # contiguous [B, T], as the gather path's: the einsum may return the
    # transposed layout, whose reduction over trees sums in an order that
    # depends on B on the card
    return torch.einsum("btl,tl->bt", onehot, values).contiguous()


def tree_ensemble_logits(ensemble: TreeEnsemble, x: torch.Tensor,
                         kernel: str = "gather") -> torch.Tensor:
    """Raw log-odds f32[B]; ``kernel`` is "gather" or "gemm"."""
    if kernel == "gemm":
        values = gemm_leaf_contract(ensemble.feature, ensemble.threshold,
                                    ensemble.leaf, x)
    elif kernel == "gather":
        leaf_idx = descend_complete_trees(ensemble.feature,
                                          ensemble.threshold, x)
        values = gather_leaf_values(ensemble.leaf, leaf_idx)
    else:
        raise ValueError(
            f"tree kernel must be 'gather' or 'gemm', got {kernel!r}")
    return ensemble.base_score + values.sum(dim=1)


def tree_ensemble_predict(ensemble: TreeEnsemble, x: torch.Tensor,
                          kernel: str = "gather") -> torch.Tensor:
    """Fraud probability f32[B]."""
    return torch.sigmoid(tree_ensemble_logits(ensemble, x, kernel=kernel))
