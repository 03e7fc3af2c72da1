"""Fused end-to-end scorer over one packed microbatch.

Port of the JAX package's ``scoring/pipeline.py``: the microbatch arrives as
the packed blobs of ``core/packing.py`` and leaves as ONE f32 matrix, laid
out as ``OUT_COLUMNS`` + the M model predictions and, with the fused
epilogue on, the ``EXT_COLUMNS`` extension: ``[B, 8+M]`` or ``[B, 8+2M+2]``.
Between them run the five branches (GBDT, LSTM, BERT text, GNN on the
bipartite or the typed entity graph, isolation forest), the rule score and
the ensemble combine. Leaves that crossed the wire in bf16 are widened back
to f32 before the branches. Model order in
the (B, M) prediction matrix is the reference registry order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from realtime_fraud_detection_tpu_torch.core.packing import PackSpec, unpack_tree, widen_bf16
from realtime_fraud_detection_tpu_torch.ensemble.combine import (
    EnsembleParams,
    combine_predictions,
)
from realtime_fraud_detection_tpu_torch.features.extract import extract_features_host
from realtime_fraud_detection_tpu_torch.features.rules import rule_score
from realtime_fraud_detection_tpu_torch.features.schema import (
    TransactionBatch,
    encode_transactions,
)
from realtime_fraud_detection_tpu_torch.models.bert import (
    TINY_CONFIG,
    BertConfig,
    bert_predict,
    init_bert_params,
)
from realtime_fraud_detection_tpu_torch.models.gnn import gnn_logits, init_gnn_params
from realtime_fraud_detection_tpu_torch.models.isolation_forest import (
    IsolationForest,
    iforest_predict,
    random_isolation_forest,
)
from realtime_fraud_detection_tpu_torch.models.lstm import init_lstm_params, lstm_logits
from realtime_fraud_detection_tpu_torch.models.trees import (
    TreeEnsemble,
    random_tree_ensemble,
    tree_ensemble_predict,
)
from realtime_fraud_detection_tpu_torch.ops.epilogue import epilogue_packed
from realtime_fraud_detection_tpu_torch.ops.megakernel import (
    MegaParamArgs,
    fused_megakernel_packed,
)

MODEL_NAMES: tuple[str, ...] = (
    "xgboost_primary",
    "lstm_sequential",
    "bert_text",
    "graph_neural",
    "isolation_forest",
)
NUM_MODELS = len(MODEL_NAMES)

# packed result columns: ints and bools ride as exact small floats
OUT_COLUMNS: tuple[str, ...] = (
    "fraud_probability", "confidence", "decision", "risk_level",
    "rule_score", "high_amount", "unusual_hour", "high_risk_payment",
)
# fused-epilogue extension: per-model contributions (w x p) and the
# rules-only decision / risk ladder over the rule score
EXT_COLUMNS: tuple[str, ...] = ("model_contributions", "rule_decision",
                                "rule_risk")


def packed_width(num_models: int, epilogue: bool) -> int:
    """Width of the packed result matrix for a given layout."""
    base = len(OUT_COLUMNS) + num_models
    return base + num_models + 2 if epilogue else base


@dataclasses.dataclass
class ScoringModels:
    """All five model branches."""

    trees: TreeEnsemble
    iforest: IsolationForest
    lstm: Dict[str, torch.Tensor]
    gnn: Dict[str, torch.Tensor]
    bert: Dict[str, Any]

    def to(self, device) -> "ScoringModels":
        return ScoringModels(trees=self.trees.to(device),
                             iforest=self.iforest.to(device),
                             lstm=_nested_to(self.lstm, device),
                             gnn=_nested_to(self.gnn, device),
                             bert=_nested_to(self.bert, device))


def _nested_to(obj, device):
    """Move a nested dict/list of tensors or numpy arrays to ``device``."""
    if isinstance(obj, dict):
        return {k: _nested_to(v, device) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_nested_to(v, device) for v in obj]
    if isinstance(obj, np.ndarray):
        obj = torch.from_numpy(np.ascontiguousarray(obj))
    return obj.to(device).contiguous()


@dataclasses.dataclass
class ScoreBatch:
    """Dense inputs for one scoring microbatch (numpy on the host, tensors
    on the device). ``valid`` masks bucket padding rows. The four two-hop
    fields are set by the typed graph's sampler and None in bipartite mode,
    where they contribute no leaves: the bipartite packed layout is the one
    the megakernel reads."""

    txn: TransactionBatch
    features: Any            # f32[B, 64]
    history: Any             # f32[B, T, F] front-padded
    history_len: Any         # i32[B]
    user_feat: Any           # f32[B, D]
    merchant_feat: Any       # f32[B, D]
    user_neigh_feat: Any     # f32[B, K, D]
    user_neigh_mask: Any     # bool[B, K]
    merch_neigh_feat: Any    # f32[B, K, D]
    merch_neigh_mask: Any    # bool[B, K]
    token_ids: Any           # i32[B, S]
    token_mask: Any          # bool[B, S]
    valid: Any               # bool[B]
    user_neigh2_feat: Any = None    # f32[B, K, K2, D] users around the user's entities
    user_neigh2_mask: Any = None    # bool[B, K, K2]
    merch_neigh2_feat: Any = None   # f32[B, K, K2, D] merchants around the merchant's users
    merch_neigh2_mask: Any = None   # bool[B, K, K2]

    @property
    def batch_size(self) -> int:
        return int(self.history.shape[0])


@dataclasses.dataclass
class ScorerConfig:
    """Static shapes for the fused scorer."""

    seq_len: int = 10          # LSTM history length
    feature_dim: int = 64      # the feature contract width
    node_dim: int = 16         # GNN node feature width
    fanout: int = 16           # GNN neighbour fan-out
    # "bipartite" = the user <-> merchant EntityGraphStore neighbourhoods;
    # "typed" = the typed entity graph (user <-> device <-> merchant <-> IP,
    # two-hop sampling by graph/sampler.py, edges ingested at write-back)
    graph_mode: str = "bipartite"
    graph_fanout2: int = 8     # typed mode's two-hop width K2
    text_len: int = 64         # token length for the text branch
    # "word" = the hash-OOV word tokenizer (models/tokenizer.py);
    # "wordpiece" = the trained subword vocabulary with BERT's greedy
    # longest-match encoding (models/wordpiece.py)
    tokenizer: str = "word"
    # the whole-text token LRU's size (models/tokenizer.TokenLruCache):
    # merchant texts repeat heavily, so the default keeps every live
    # merchant string resident
    token_cache_entries: int = 65_536
    # ship the history, the node and neighbour features (and the two-hop
    # context) as bf16 on the wire, widened back to f32 on the card; it
    # perturbs scores at bf16 resolution, so it is off by default
    transfer_bf16: bool = False


def init_scoring_models(seed: int, bert_config: BertConfig = TINY_CONFIG,
                        feature_dim: int = 64, node_dim: int = 16,
                        n_trees: int = 100, tree_depth: int = 6,
                        iforest_depth: int = 8,
                        gnn_typed: bool = False) -> ScoringModels:
    """Randomly initialised model set from a numpy seed. Unlike the JAX
    package's all-zero trees, the GBDT and isolation forest get random
    splits, so every branch does real work. ``gnn_typed`` selects the typed
    entity graph's GNN layout."""
    rng = np.random.default_rng(seed)
    return ScoringModels(
        trees=random_tree_ensemble(rng, n_trees, tree_depth, feature_dim),
        iforest=random_isolation_forest(rng, n_trees, iforest_depth,
                                        feature_dim),
        lstm=init_lstm_params(rng, feature_dim=feature_dim),
        gnn=init_gnn_params(rng, node_dim=node_dim, txn_dim=feature_dim,
                            typed=gnn_typed),
        bert=init_bert_params(rng, bert_config),
    )


def _key_factors(txn: TransactionBatch) -> Dict[str, torch.Tensor]:
    """Key-factor flags (ensemble_predictor.py:389-412)."""
    return {
        "high_amount": txn.amount > 10_000.0,
        "unusual_hour": (txn.hour_of_day < 6) | (txn.hour_of_day >= 23),
        "high_risk_payment": txn.high_risk_payment,
    }


def score_fused(models: ScoringModels, batch: ScoreBatch,
                params: EnsembleParams, model_valid: torch.Tensor,
                bert_config: BertConfig = TINY_CONFIG,
                use_flash: bool = False,
                tree_kernel: str = "gather", iforest_kernel: str = "gather",
                dequant_kernel: str = "off", epilogue_kernel: str = "off",
                compute_dtype: torch.dtype = torch.bfloat16
                ) -> Dict[str, torch.Tensor]:
    """Score one device-resident microbatch through the 5-model ensemble.

    ``compute_dtype`` is the dense-product precision of the LSTM and BERT
    branches (bf16 served; f32 for tests).

    ``model_valid`` is the rung's M branch flags, best on the host (a CPU
    tensor, numpy or a tuple): the epilogue kernel takes them by value.

    Returns the combine outputs plus ``model_predictions`` (B, M), the
    rule score and the key-factor flags; with ``epilogue_kernel="cuda"``
    the combine outputs are the whole ``packed`` result instead, which the
    epilogue kernel writes but for the key-factor columns written here.
    """
    features = batch.features
    preds = torch.stack([
        tree_ensemble_predict(models.trees, features, kernel=tree_kernel),
        torch.sigmoid(lstm_logits(models.lstm, batch.history,
                                  batch.history_len,
                                  compute_dtype=compute_dtype)),
        bert_predict(models.bert, batch.token_ids, batch.token_mask,
                     bert_config, use_flash=use_flash,
                     compute_dtype=compute_dtype,
                     dequant_kernel=dequant_kernel),
        torch.sigmoid(gnn_logits(
            models.gnn, features, batch.user_feat, batch.merchant_feat,
            batch.user_neigh_feat, batch.user_neigh_mask,
            batch.merch_neigh_feat, batch.merch_neigh_mask,
            user_neigh2_feat=batch.user_neigh2_feat,
            user_neigh2_mask=batch.user_neigh2_mask,
            merch_neigh2_feat=batch.merch_neigh2_feat,
            merch_neigh2_mask=batch.merch_neigh2_mask)),
        iforest_predict(models.iforest, features, kernel=iforest_kernel),
    ], dim=1)                                                   # f32[B, M]

    rule = rule_score(batch.txn)
    factors = _key_factors(batch.txn)
    if epilogue_kernel == "cuda":
        packed = epilogue_packed(preds, rule, params, model_valid=model_valid,
                                 row_valid=batch.valid)
        packed[:, 5:8] = torch.stack([factors[name] for name in OUT_COLUMNS[5:]],
                                     dim=1)
        out = {"packed": packed}
    else:
        valid = (torch.as_tensor(model_valid).to(preds.device)[None, :]
                 & batch.valid[:, None])
        out = dict(combine_predictions(preds, valid, params))
    out["rule_score"] = rule
    out.update(factors)
    out["model_predictions"] = preds
    return out


def score_fused_packed(models: ScoringModels, blobs: Dict[str, torch.Tensor],
                       spec: PackSpec, params: EnsembleParams,
                       model_valid: torch.Tensor,
                       bert_config: BertConfig = TINY_CONFIG,
                       use_flash: bool = False,
                       tree_kernel: str = "gather",
                       iforest_kernel: str = "gather",
                       dequant_kernel: str = "off",
                       epilogue_kernel: str = "off",
                       megakernel: str = "off",
                       mega_valid: Optional[Tuple[bool, ...]] = None,
                       compute_dtype: torch.dtype = torch.bfloat16,
                       param_args: Optional[MegaParamArgs] = None
                       ) -> torch.Tensor:
    """Packed blobs in, one f32 result matrix out (see ``OUT_COLUMNS``).

    With ``megakernel="cuda"`` and a ``mega_valid`` rung the batch is
    scored in one megakernel launch that returns the extended matrix
    itself; the caller passes the rung only for a batch the megakernel's
    plan admits (``TorchFraudScorer.kernel_static``), and with it the
    kernel's parameter arguments built from ``models`` (``param_args``;
    without them the launch builds its own). Without a rung the per-site
    chain below runs, unchanged.
    """
    if megakernel == "cuda" and mega_valid is not None:
        return fused_megakernel_packed(models, blobs, spec, params,
                                       mega_valid=mega_valid,
                                       bert_config=bert_config,
                                       compute_dtype=compute_dtype,
                                       param_args=param_args)
    batch = widen_bf16(unpack_tree(blobs, spec))
    out = score_fused(models, batch, params, model_valid,
                      bert_config=bert_config, use_flash=use_flash,
                      tree_kernel=tree_kernel, iforest_kernel=iforest_kernel,
                      dequant_kernel=dequant_kernel,
                      epilogue_kernel=epilogue_kernel,
                      compute_dtype=compute_dtype)
    if "packed" in out:
        return out["packed"]
    cols = [out[name].to(torch.float32) for name in OUT_COLUMNS]
    return torch.cat([torch.stack(cols, dim=1), out["model_predictions"]],
                     dim=1)


def make_example_batch(batch_size: int, config: ScorerConfig = ScorerConfig(),
                       rng: Optional[np.random.Generator] = None,
                       vocab_size: int = 30522) -> ScoreBatch:
    """Synthetic host-side ScoreBatch, as the JAX package's
    ``make_example_batch`` builds it: transaction columns encoded from
    simulator records joined with their pools' profiles (the simulator
    seeded from ``rng``), features from ``extract_features_host``, and
    history, graph and token tensors drawn from ``rng``."""
    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator

    rng = rng or np.random.default_rng(0)
    b, c = batch_size, config
    gen = TransactionGenerator(num_users=max(64, b), num_merchants=64,
                               seed=int(rng.integers(2 ** 31)))
    txn = encode_transactions(gen.generate_batch(b), gen.users.profiles(),
                              gen.merchants.profiles())
    return ScoreBatch(
        txn=txn,
        features=extract_features_host(txn),
        history=rng.standard_normal((b, c.seq_len, c.feature_dim)).astype(np.float32),
        history_len=rng.integers(1, c.seq_len + 1, b).astype(np.int32),
        user_feat=rng.standard_normal((b, c.node_dim)).astype(np.float32),
        merchant_feat=rng.standard_normal((b, c.node_dim)).astype(np.float32),
        user_neigh_feat=rng.standard_normal((b, c.fanout, c.node_dim)).astype(np.float32),
        user_neigh_mask=rng.random((b, c.fanout)) < 0.8,
        merch_neigh_feat=rng.standard_normal((b, c.fanout, c.node_dim)).astype(np.float32),
        merch_neigh_mask=rng.random((b, c.fanout)) < 0.8,
        token_ids=rng.integers(0, vocab_size, (b, c.text_len)).astype(np.int32),
        token_mask=np.arange(c.text_len)[None, :]
        < rng.integers(4, c.text_len + 1, b)[:, None],
        valid=np.ones((b,), bool),
    )
