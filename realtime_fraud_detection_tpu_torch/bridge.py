"""Parameter bridge from the JAX package's ``ScoringModels``.

``models_from_numpy`` turns the JAX scorer's model set, already mapped to
numpy arrays by the caller (e.g. ``jax.tree.map(np.asarray, models)``), into
the port's ``ScoringModels`` of CPU tensors. Fields are read by attribute or
by key, so a dict of the same shape works too. ``params_from_numpy`` maps one
branch's parameter tree (the JAX trainers' initial weights, say) the same
way, for the port's trainers' ``init``. The BERT dict is carried in
whichever layout it has: f32 ``{"w", "b"}`` or the int8 ``{"qw", "scale",
"b"}`` / ``{"qe", "scale"}`` of ``models/quant.py``. This module imports
nothing of JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from realtime_fraud_detection_tpu_torch.models.isolation_forest import IsolationForest
from realtime_fraud_detection_tpu_torch.models.trees import TreeEnsemble
from realtime_fraud_detection_tpu_torch.scoring.pipeline import ScoringModels


def _field(obj: Any, name: str) -> Any:
    if isinstance(obj, dict):
        return obj[name]
    return getattr(obj, name)


def _tensor(x: Any) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.kind == "f":
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr, copy=True))


def _tree(obj: Any) -> Any:
    """Nested dicts/lists of arrays -> the same structure of tensors."""
    if isinstance(obj, dict):
        return {k: _tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_tree(v) for v in obj]
    return _tensor(obj)


def params_from_numpy(tree: Any) -> Any:
    """Nested dicts / lists of numpy leaves -> the same structure of CPU
    tensors (f32 for floating leaves)."""
    return _tree(tree)


def models_from_numpy(obj: Any) -> ScoringModels:
    """The JAX ``ScoringModels`` (numpy leaves) -> the port's models."""
    trees = _field(obj, "trees")
    forest = _field(obj, "iforest")
    return ScoringModels(
        trees=TreeEnsemble(
            feature=_tensor(_field(trees, "feature")).to(torch.int32),
            threshold=_tensor(_field(trees, "threshold")),
            leaf=_tensor(_field(trees, "leaf")),
            base_score=_tensor(_field(trees, "base_score"))),
        iforest=IsolationForest(
            feature=_tensor(_field(forest, "feature")).to(torch.int32),
            threshold=_tensor(_field(forest, "threshold")),
            path_length=_tensor(_field(forest, "path_length")),
            c_psi=_tensor(_field(forest, "c_psi"))),
        lstm=_tree(_field(obj, "lstm")),
        gnn=_tree(_field(obj, "gnn")),
        bert=_tree(_field(obj, "bert")),
    )
