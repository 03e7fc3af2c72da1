"""Sharding layouts: how every parameter and batch tensor maps onto the mesh.

Port of the JAX package's ``parallel/layouts.py``, over the port's own
parameter containers (``scoring/pipeline.py ScoringModels``, the BERT dict of
``models/bert.py`` in f32 or the int8 layout of ``models/quant.py``). The
specs name the same dims and axes as JAX's for every leaf.

Layout policy, as in JAX:
- batch tensors: leading dim over ``data`` (pure DP);
- the DistilBERT encoder in training gets Megatron-style tensor parallelism
  over ``model``: q/k/v and ffn1 split on the output feature dim, o and
  ffn2 on the input dim (``bert_param_specs``; ``parallel/train.py`` runs
  that split);
- every other branch is small: replicated params, sharded batch.

Serving-plane STORAGE specs (``scoring/mesh_executor.py``): scores must be
bit-identical to one position's, so a sharded branch stores its bytes split
over ``model`` and re-gathers them exactly before use
(``mesh_executor._regather_models``). The specs keep the Megatron column /
row positions, and every split dim is guarded for divisibility by the
model-axis size: an indivisible leaf is replicated.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np

from realtime_fraud_detection_tpu_torch.core.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    NamedSharding,
    P,
    PartitionSpec,
    tree_map,
)

__all__ = [
    "SHARDABLE_BRANCHES", "batch_shardings", "batch_spec", "bert_layer_specs",
    "bert_param_specs", "bert_serving_param_specs", "branch_serving_specs",
    "leaf_storage_spec", "replicated", "scoring_model_specs",
    "tree_specs_to_shardings",
]


def _named(mesh: Mesh, spec: PartitionSpec) -> NamedSharding:
    return NamedSharding(mesh, spec)


def replicated(mesh: Mesh) -> NamedSharding:
    return _named(mesh, P())


def batch_spec() -> PartitionSpec:
    return P(DATA_AXIS)


def _rep(tree: Any) -> Any:
    return tree_map(lambda _: P(), tree)


def bert_layer_specs() -> Dict[str, Any]:
    """Megatron TP specs for one encoder layer (column/row parallel pairs)."""
    col = {"w": P(None, MODEL_AXIS), "b": P(MODEL_AXIS)}       # split heads/ffn
    row = {"w": P(MODEL_AXIS, None), "b": P()}                 # partial-sum in
    ln = {"scale": P(), "bias": P()}
    return {
        "q": col, "k": col, "v": col, "o": row,
        "attn_ln": ln,
        "ffn1": col, "ffn2": row,
        "ffn_ln": ln,
    }


def bert_param_specs(params: Dict[str, Any]) -> Dict[str, Any]:
    """Spec tree matching ``models.bert.init_bert_params``' structure."""
    dense_rep = {"w": P(), "b": P()}
    ln = {"scale": P(), "bias": P()}
    return {
        "word_emb": P(None, None),   # gathered by token ids; keep replicated
        "pos_emb": P(None, None),
        "emb_ln": ln,
        "layers": [bert_layer_specs() for _ in params["layers"]],
        "pre_classifier": dense_rep,
        "classifier": dense_rep,
    }


def scoring_model_specs(models) -> Any:
    """Spec tree for a full ``ScoringModels`` set: trees / iforest / LSTM /
    GNN replicated, the BERT branch TP over ``model``."""
    return type(models)(
        trees=_rep(models.trees),
        iforest=_rep(models.iforest),
        lstm=_rep(models.lstm),
        gnn=_rep(models.gnn),
        bert=bert_param_specs(models.bert),
    )


def tree_specs_to_shardings(mesh: Mesh, specs: Any) -> Any:
    return tree_map(lambda s: _named(mesh, s), specs)


# ScoringModels fields that can take the sharded placement, keyed by the
# registry branch names (scoring/pipeline.MODEL_NAMES). Trees / iforest stay
# replicated always.
SHARDABLE_BRANCHES: Dict[str, str] = {
    "bert_text": "bert",
    "lstm_sequential": "lstm",
    "graph_neural": "gnn",
}


def _dim_spec(shape: Sequence[int], dim: int, axis_size: int) -> PartitionSpec:
    """P sharding ``dim`` over ``model`` when divisible, else replicated."""
    if axis_size <= 1 or not shape or shape[dim] % axis_size:
        return P()
    spec = [None] * len(shape)
    spec[dim] = MODEL_AXIS
    return P(*spec)


def leaf_storage_spec(leaf: Any, axis_size: int) -> PartitionSpec:
    """Storage spec for one serving param leaf: shard the largest dim
    divisible by the model-axis size, else replicate (the LSTM / GNN rule,
    the typed GNN's per-type projections included)."""
    shape = tuple(np.shape(leaf))
    if axis_size <= 1 or not shape:
        return P()
    for dim in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[dim] % axis_size == 0 and shape[dim] >= axis_size:
            return _dim_spec(shape, dim, axis_size)
    return P()


def _dense_storage_specs(p: Dict[str, Any], axis_size: int,
                         column: bool) -> Dict[str, PartitionSpec]:
    """Storage specs for one dense layer dict, f32 ``{"w", "b"}`` or int8
    ``{"qw", "scale", "b"}``. ``column``: split the output feature dim (the
    bias and the per-output-channel scale split with it); row layers split
    the input dim and keep bias / scale whole."""
    wkey = "qw" if "qw" in p else "w"
    wdim = 1 if column else 0
    specs: Dict[str, PartitionSpec] = {
        wkey: _dim_spec(np.shape(p[wkey]), wdim, axis_size),
    }
    out_split = column and specs[wkey] != P()
    if "scale" in p:
        specs["scale"] = (_dim_spec(np.shape(p["scale"]), 0, axis_size)
                          if out_split else P())
    specs["b"] = (_dim_spec(np.shape(p["b"]), 0, axis_size)
                  if out_split else P())
    return specs


def _embedding_storage_spec(table: Any, axis_size: int) -> Any:
    """Embedding storage specs: rows over ``model``, for the f32 table and
    the int8 ``{"qe", "scale"}`` form (per-row scales shard with rows);
    indivisible rows split the hidden dim instead."""
    if isinstance(table, dict) and "qe" in table:
        rows_spec = _dim_spec(np.shape(table["qe"]), 0, axis_size)
        if rows_spec != P():
            return {"qe": rows_spec,
                    "scale": _dim_spec(np.shape(table["scale"]), 0, axis_size)}
        return {"qe": _dim_spec(np.shape(table["qe"]), 1, axis_size),
                "scale": P()}
    spec = _dim_spec(np.shape(table), 0, axis_size)
    if spec == P():
        spec = _dim_spec(np.shape(table), 1, axis_size)
    return spec


def bert_serving_param_specs(params: Dict[str, Any],
                             axis_size: int) -> Dict[str, Any]:
    """Storage-spec tree for the BERT branch, f32 or int8: Megatron
    positions, layer norms and the 2-logit head replicated."""
    ln = {"scale": P(), "bias": P()}

    def rep_dense(p):
        return {k: P() for k in p}

    return {
        "word_emb": _embedding_storage_spec(params["word_emb"], axis_size),
        "pos_emb": _embedding_storage_spec(params["pos_emb"], axis_size),
        "emb_ln": ln,
        "layers": [{
            "q": _dense_storage_specs(layer["q"], axis_size, column=True),
            "k": _dense_storage_specs(layer["k"], axis_size, column=True),
            "v": _dense_storage_specs(layer["v"], axis_size, column=True),
            "o": _dense_storage_specs(layer["o"], axis_size, column=False),
            "attn_ln": ln,
            "ffn1": _dense_storage_specs(layer["ffn1"], axis_size, column=True),
            "ffn2": _dense_storage_specs(layer["ffn2"], axis_size, column=False),
            "ffn_ln": ln,
        } for layer in params["layers"]],
        "pre_classifier": rep_dense(params["pre_classifier"]),
        "classifier": rep_dense(params["classifier"]),
    }


def branch_serving_specs(models: Any, axis_size: int,
                         shard_branches: Sequence[str]) -> Any:
    """Storage-spec tree for a ``ScoringModels`` set under a per-branch
    placement: branches named in ``shard_branches`` (``SHARDABLE_BRANCHES``
    members) store sharded over ``model``; the rest replicate."""
    for name in shard_branches:
        if name not in SHARDABLE_BRANCHES:
            raise ValueError(
                f"branch {name!r} is not shardable; expected one of "
                f"{sorted(SHARDABLE_BRANCHES)} (trees/iforest/rules are "
                f"replicated by design)")
    sharded = set(shard_branches) if axis_size > 1 else set()
    return type(models)(
        trees=_rep(models.trees),
        iforest=_rep(models.iforest),
        lstm=(tree_map(lambda lf: leaf_storage_spec(lf, axis_size), models.lstm)
              if "lstm_sequential" in sharded else _rep(models.lstm)),
        gnn=(tree_map(lambda lf: leaf_storage_spec(lf, axis_size), models.gnn)
             if "graph_neural" in sharded else _rep(models.gnn)),
        bert=(bert_serving_param_specs(models.bert, axis_size)
              if "bert_text" in sharded else _rep(models.bert)),
    )


def batch_shardings(mesh: Mesh, tree: Any) -> Any:
    """Shardings splitting every leaf's leading dim over ``data``."""
    def spec(x):
        nd = getattr(x, "ndim", np.ndim(x))
        if nd == 0:
            return _named(mesh, P())
        return _named(mesh, P(DATA_AXIS, *([None] * (nd - 1))))

    return tree_map(spec, tree)
