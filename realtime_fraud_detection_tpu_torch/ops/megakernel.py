"""Persistent ensemble megakernel: one launch scores a packed microbatch.

``fused_megakernel`` replaces the JAX package's Pallas kernel
``ops/megakernel.py fused_megakernel`` (``_mega_call``): the five branches
(GEMM-form GBDT and isolation forest, LSTM, TINY BERT, and the GNN, bipartite
or typed: typed parameters run their per-node-type projections ahead of the
aggregation on a one-hop batch), the rule score and the ensemble combine in ONE launch that writes the extended
packed ``f32[B, 2M+10]`` matrix ``TorchFraudScorer._build_responses``
reads; no branch intermediate reaches device memory. On the card it runs
the CUDA kernel of ``csrc/megakernel.cu`` (design and bound noted there);
for tensors on the CPU it runs ``megakernel_reference``, the same branch
functions composed as a plain chain. ``fused_megakernel.launches`` counts
kernel launches. The scorer's packed path enters through
``fused_megakernel_packed``, which points the kernel straight into the
packed blobs. The parameter half of the kernel's arguments
(``MegaParamArgs``) is built by the caller that owns the models:
``TorchFraudScorer`` builds it once per ``set_models`` and passes it with
every batch, so a call fills only the batch half; a call without one builds
its own.

``mega_valid`` is the QoS rung as a tuple of branch-validity booleans: a
pruned branch does no work, its prediction lane is exactly 0.0 and its
weight is masked in the blend (``vf = valid x mega_valid``).

The shape plan (``mega_plan``) decides which dispatches the megakernel
takes: the scorer reads it once per bucket, sends an admitted batch here
and counts a declined one as a megakernel fallback that runs the per-site
chain. It is the JAX package's plan with the budget moved from the TPU
core's VMEM to the H100's L2 (``_MEGA_L2_BUDGET``) and with the limits of
the CUDA kernel's own shared-memory layout (``mega_kernel_shapes_ok``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch

from realtime_fraud_detection_tpu_torch.core.packing import (
    PackSpec,
    tree_unflatten,
    unpack_tree,
    widen_bf16,
)
from realtime_fraud_detection_tpu_torch.ops.build import (
    check_launch,
    count_launch,
    kernel_library,
)
from realtime_fraud_detection_tpu_torch.ops.epilogue import _statics, combine_matrix

# NOTE: the branch modules (models/*, scoring/pipeline) are imported inside
# functions: models.bert imports ops.attention, so a module-level import
# here would cycle through ops/__init__ while models.bert initialises.

# The budget of the JAX plan was 14 MiB of a TPU core's VMEM for the
# parameters plus a block of rows' activations. On the H100 the counterpart
# is the 50 MB L2: every CTA re-reads the parameters for each group of rows
# it scores, so they must stay resident there, while a row's activations live
# in its CTA's shared memory (``mega_smem_bytes``) and are not charged.
# 40 MiB of the 50 MB leaves room for the inputs and outputs streaming
# through. TINY int8 (5.3 MB of parameters) and TINY f32 (17.9 MB, which
# the TPU plan declines) are admitted; DistilBERT-base (70 MB int8, 269 MB
# f32) is declined as there.
_MEGA_L2_BUDGET = 40 * (1 << 20)

# Below this the launch chain is already cheap and padding waste dominates
# -- bucket 1 stays on the per-site kernel path (an honest fallback).
MEGA_MIN_BATCH = 8

# What csrc/megakernel.cu's layouts take (its MEGA_* constants): up to
# MEGA_MAX_ROWS rows per CTA iteration with bf16 compute (one with f32),
# dense weights streamed in MEGA_KC x MEGA_NP chunks (MEGA_KC_F32-deep
# tiles with f32 compute), text in at most two 32-key lanes, dense outputs
# in up to 8 column groups of 32 per lane (LN), attention heads of up to 64
# lanes' worth, the LSTM's gates in one 16-row tensor-core tile per step,
# attention in groups of MEGA_ATT_Q queries a warp, and the shared memory a
# CTA may use on the card.
MEGA_NUM_MODELS = 5
MEGA_MAX_ROWS = 2
MEGA_MAX_LAYERS = 8
MEGA_MAX_TEXT = 64
MEGA_MAX_WIDTH = 256     # the hidden width
MEGA_MAX_FFN = 1024      # the FFN width
MEGA_MAX_HEAD_DIM = 64
MEGA_MAX_LSTM = 128
MEGA_ATT_Q = 8
# one warp's attention scratch in floats: queries, probabilities, k/v biases
MEGA_ATT_SCRATCH = (MEGA_MAX_HEAD_DIM + MEGA_MAX_TEXT) * MEGA_ATT_Q + 2 * MEGA_MAX_HEAD_DIM
MEGA_KC = 64
MEGA_NP = 128
MEGA_KC_F32 = 32
MEGA_WARPS = 8
MEGA_SMEM_LIMIT = 232448

DENSE_SITES = ("q", "k", "v", "o", "ffn1", "ffn2")
LN_SITES = ("attn_ln", "ffn_ln")

# Batch leaves the kernel reads, in the order of csrc/megakernel.cu's
# ``MegaInput`` enum: (field, kind) with kind f (f32), i (i32) or b (one
# byte: bool, or its u8 wire form).
MEGA_INPUTS: Tuple[Tuple[str, str], ...] = (
    # rule score and key factors (TransactionBatch columns)
    ("prior_fraud_score", "f"), ("has_user", "b"), ("user_risk_score", "f"),
    ("account_age_days", "f"), ("user_verified", "b"),
    ("merchant_fraud_rate", "f"), ("merchant_risk_code", "i"),
    ("merchant_blacklisted", "b"), ("merchant_high_risk_category", "b"),
    ("has_merchant", "b"), ("user_avg_amount", "f"), ("amount", "f"),
    ("has_txn_fingerprint", "b"), ("has_device_list", "b"),
    ("known_device", "b"), ("hour_of_day", "i"), ("has_op_hours", "b"),
    ("merchant_op_start", "i"), ("merchant_op_end", "i"),
    ("high_risk_payment", "b"),
    # branch inputs (ScoreBatch fields)
    ("features", "f"), ("history", "f"), ("history_len", "i"),
    ("user_feat", "f"), ("merchant_feat", "f"), ("user_neigh_feat", "f"),
    ("user_neigh_mask", "b"), ("merch_neigh_feat", "f"),
    ("merch_neigh_mask", "b"), ("token_ids", "i"), ("token_mask", "b"),
    ("valid", "b"),
)
_KIND_DTYPES = {"f": (torch.float32,), "i": (torch.int32,),
                "b": (torch.bool, torch.uint8)}


# ------------------------------------------------------------- shape plan
def _leaves(obj) -> Iterator[Any]:
    """Every tensor (or array) of a ScoringModels-shaped tree: dataclasses,
    dicts and lists of leaves."""
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name))
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _leaves(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _leaves(v)
    elif obj is not None:
        yield obj


def mega_param_bytes(models) -> int:
    """Parameter bytes of the whole 5-branch model set, from shapes and
    dtypes only (works on meta tensors)."""
    total = 0
    for leaf in _leaves(models):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            total += math.prod(leaf.shape) * leaf.dtype.itemsize
    return int(total)


def mega_act_row_bytes(bert_config, *, text_len: int, seq_len: int,
                       feature_dim: int, tree_onehot: int) -> int:
    """Per-batch-row activation working set (bytes, f32), the JAX
    package's count: BERT hidden + residual + FFN activations
    ``S*(2H+F)`` plus the attention probabilities ``heads*S^2``; the
    GEMM-form one-hot leaf tensors of both tree ensembles; the LSTM's
    ``T*F`` history slab; one feature row. The H100 plan does not charge
    it (the CUDA kernel keeps a row's activations in shared memory); it
    pins the two packages' numbers against each other."""
    h = bert_config.hidden_size
    f = bert_config.intermediate_size
    bert = text_len * (2 * h + f) * 4 + bert_config.num_heads * text_len * text_len * 4
    trees = tree_onehot * 4
    lstm = seq_len * feature_dim * 4
    return int(bert + trees + lstm + feature_dim * 4)


def mega_supported(b: int, param_bytes: int, has_two_hop: bool = False) -> bool:
    """True when the H100 plan admits a ``b``-row microbatch: a bucket of
    at least ``MEGA_MIN_BATCH`` rows and parameters that fit the L2
    budget. Two-hop typed-graph frontiers stay on the per-site path."""
    return (b >= MEGA_MIN_BATCH and not has_two_hop
            and param_bytes <= _MEGA_L2_BUDGET)


def _dims(models, bert_config, text_len: int, feat_dim: int,
          seq_len: int) -> Dict[str, int]:
    """The widths csrc/megakernel.cu sizes its layout from."""
    lstm, gnn = models.lstm, models.gnn
    return dict(
        text_len=text_len, hidden=bert_config.hidden_size,
        ffn=bert_config.intermediate_size, heads=bert_config.num_heads,
        layers=bert_config.num_layers, num_labels=bert_config.num_labels,
        feat_dim=feat_dim, seq_len=seq_len,
        lstm_hidden=int(lstm["w_head1"].shape[0]),
        lstm_head=int(lstm["w_head1"].shape[1]),
        gnn_hidden=int(gnn["w_sage1"].shape[1]),
        gnn_head=int(gnn["w_head1"].shape[1]),
        node_dim=int(gnn["w_sage2"].shape[0] - gnn["w_sage1"].shape[1]),
        n_trees=int(models.trees.leaf.shape[0]),
        n_iforest=int(models.iforest.path_length.shape[0]),
    )


def _al16(n: int) -> int:
    return (n + 15) & ~15


def mega_smem_bytes_tc(dims: Dict[str, int], fanout: int, rows: int) -> int:
    """Dynamic shared memory of one CTA of csrc/megakernel.cu's bf16-compute
    kernel scoring ``rows`` rows per iteration, in bytes (``mega_layout_tc``
    there, every region 16-byte aligned): x f32 ``[R*S, H+8]``; the bf16
    activations, q|k|v ``[3, R*S, H+2]`` or the FFN hidden ``[R*S, F+8]``
    beside the FFN output; the widened ``[2, KC, NP+8]`` bf16 and raw
    ``[2, KC, NP]`` i8 weight rings (attention's per-warp scratch,
    MEGA_ATT_SCRATCH floats, lives in the widened ring between dense
    layers); the staged LSTM (w_gates in bf16, the history and the
    per-row state), GNN (weights in f32 and per-row scratch, the typed
    projections' node rows included) and tree
    leaves reuse that region when larger; then per row the features, token
    mask and 16 slots, and the [CLS] head."""
    s, h, ffn, rs = dims["text_len"], dims["hidden"], dims["ffn"], rows * dims["text_len"]
    fd, lh = dims["feat_dim"], dims["lstm_hidden"]
    d, g, gh = dims["node_dim"], dims["gnn_hidden"], dims["gnn_head"]
    x = _al16(rs * (h + 8) * 4)
    act = max(3 * _al16(rs * (h + 2) * 2),
              _al16(rs * (ffn + 8) * 2) + _al16(rs * (h + 2) * 2))
    wide = max(2 * _al16(MEGA_KC * (MEGA_NP + 8) * 2), MEGA_WARPS * MEGA_ATT_SCRATCH * 4)
    bert = x + act + wide + 2 * MEGA_KC * MEGA_NP
    lstm = (_al16((fd + lh) * (4 * lh + 8) * 2) + _al16(rows * (fd + lh) * 4)
            + _al16(rows * dims["seq_len"] * fd * 4) + _al16(rows * 4 * lh * 4) + _al16(rows * 2 * lh * 4)
            + _al16(rows * dims["lstm_head"] * 4))
    gnn = (_al16(d * g * 4) + _al16((d + g) * g * 4) + _al16((2 * g + fd) * gh * 4)
           + _al16(rows * 2 * fanout * g * 4) + 2 * _al16(rows * 2 * g * 4)
           + _al16(rows * gh * 4) + _al16(rows * 2 * (fanout + 1) * d * 4))
    trees = _al16(rows * max(dims["n_trees"], dims["n_iforest"]) * 4)
    tail = (_al16(rows * fd * 4) + _al16(rows * s * 4) + _al16(rows * 16 * 4)
            + _al16(rows * h * 4))
    return max(bert, lstm, gnn, trees) + tail


def mega_smem_bytes_f32(dims: Dict[str, int], fanout: int) -> int:
    """Dynamic shared memory of one CTA of the f32-compute kernel, in bytes
    (``mega_layout_f32``): x and q ``[S, H]``, the k|v region ``[S,
    max(2H+1, FFN)]`` (k padded to H+1 columns against bank conflicts; the
    FFN activations reuse it), a scratch region sized for the largest of the
    weight tile, the LSTM, GNN (with the typed projections' node rows) and
    tree stages and the attention rows, the
    feature row, 16 small slots and the token mask."""
    s, h, ffn = dims["text_len"], dims["hidden"], dims["ffn"]
    lh, g, d = dims["lstm_hidden"], dims["gnn_hidden"], dims["node_dim"]
    scratch = max(MEGA_KC_F32 * max(h, ffn), 6 * lh + dims["lstm_head"],
                  2 * fanout * g + 4 * g + dims["gnn_head"] + 2 * (fanout + 1) * d,
                  dims["n_trees"], dims["n_iforest"], h,
                  MEGA_WARPS * s)
    floats = (2 * s * h + s * max(2 * h + 1, ffn) + scratch
              + dims["feat_dim"] + 16 + s)
    return 4 * floats


def mega_smem_bytes(dims: Dict[str, int], fanout: int) -> int:
    """The shared memory the plan charges (``mega_plan_smem_bytes``): the
    larger of the one-row bf16-compute layout and the f32-compute layout,
    so that both kernels fit whenever the plan admits."""
    return max(mega_smem_bytes_tc(dims, fanout, 1), mega_smem_bytes_f32(dims, fanout))


def mega_kernel_shapes_ok(dims: Dict[str, int], smem_bytes: int) -> bool:
    """The widths the CUDA kernel's layouts take (its MEGA_* limits)."""
    s, h, ffn = dims["text_len"], dims["hidden"], dims["ffn"]
    heads, lh = dims["heads"], dims["lstm_hidden"]
    return (0 < s <= MEGA_MAX_TEXT and 0 < dims["layers"] <= MEGA_MAX_LAYERS
            and h % 32 == 0 and 0 < h <= MEGA_MAX_WIDTH
            and ffn % 32 == 0 and 0 < ffn <= MEGA_MAX_FFN
            and heads > 0 and h % heads == 0
            and h // heads <= MEGA_MAX_HEAD_DIM
            and 0 < lh <= MEGA_MAX_LSTM and lh % 4 == 0
            and (dims["feat_dim"] + lh) % 16 == 0
            and dims["num_labels"] == 2
            and smem_bytes <= MEGA_SMEM_LIMIT)


def mega_plan(models, bert_config, *, b: int, text_len: int, seq_len: int,
              feature_dim: int, has_two_hop: bool,
              fanout: int = 16) -> Dict[str, Any]:
    """The shape plan for a ``b``-row dispatch: ``supported`` when the L2
    budget admits it and the kernel's layout takes its widths. Typed GNN
    parameters are admitted on a one-hop batch, as in the JAX plan; a typed
    scorer's batches carry two-hop frontiers and are declined."""
    from realtime_fraud_detection_tpu_torch.models.gnn import is_typed_gnn

    pb = mega_param_bytes(models)
    dims = _dims(models, bert_config, text_len, feature_dim, seq_len)
    smem = mega_smem_bytes(dims, fanout)
    shapes_ok = mega_kernel_shapes_ok(dims, smem)
    typed = is_typed_gnn(models.gnn)
    return {
        "param_bytes": pb,
        "has_two_hop": bool(has_two_hop),
        "typed_gnn": typed,
        "smem_bytes": smem,
        "kernel_shapes": shapes_ok,
        "supported": shapes_ok and mega_supported(b, pb, has_two_hop),
    }


def mega_launch_accounting(b: int, m: int,
                           mega_valid: Optional[Sequence[bool]] = None
                           ) -> Dict[str, int]:
    """Launch-count / device-memory accounting, the JAX package's: the
    chain dispatches one program per enabled branch plus the rule program
    and the blend; the megakernel dispatches ONE.
    ``intermediate_bytes_eliminated`` counts the branch-boundary tensors
    that round-trip through device memory between those programs."""
    valid = tuple(mega_valid) if mega_valid is not None else (True,) * m
    branches = sum(1 for v in valid if v)
    programs_chain = branches + 2
    eliminated = (branches * b * 4    # per-branch f32[B] predictions
                  + b * m * 4         # stacked preds f32[B, M]
                  + b * m * 4         # validity mask f32[B, M]
                  + b * 4)            # rule score f32[B]
    return {
        "programs_chain": int(programs_chain),
        "programs_mega": 1,
        "launches_per_batch_chain": int(programs_chain),
        "launches_per_batch_mega": 1,
        "intermediate_bytes_eliminated": int(eliminated),
    }


# -------------------------------------------------------- plain version
def _branch_columns(models, batch, mega_valid: Tuple[bool, ...],
                    bert_config, compute_dtype) -> list:
    """The five branch probabilities in registry order: GEMM-form trees,
    the LSTM, BERT with reference attention and the plain int8 dense, the
    GNN and the isolation forest. Pruned branches give a zero lane."""
    from realtime_fraud_detection_tpu_torch.models.bert import bert_predict
    from realtime_fraud_detection_tpu_torch.models.gnn import gnn_logits
    from realtime_fraud_detection_tpu_torch.models.isolation_forest import (
        iforest_predict,
    )
    from realtime_fraud_detection_tpu_torch.models.lstm import lstm_logits
    from realtime_fraud_detection_tpu_torch.models.trees import (
        tree_ensemble_predict,
    )

    features = batch.features
    zeros = torch.zeros((features.shape[0],), dtype=torch.float32,
                        device=features.device)
    return [
        tree_ensemble_predict(models.trees, features, kernel="gemm")
        if mega_valid[0] else zeros,
        torch.sigmoid(lstm_logits(models.lstm, batch.history,
                                  batch.history_len,
                                  compute_dtype=compute_dtype))
        if mega_valid[1] else zeros,
        bert_predict(models.bert, batch.token_ids, batch.token_mask,
                     bert_config, use_flash=False,
                     compute_dtype=compute_dtype, dequant_kernel="off")
        if mega_valid[2] else zeros,
        torch.sigmoid(gnn_logits(
            models.gnn, features, batch.user_feat, batch.merchant_feat,
            batch.user_neigh_feat, batch.user_neigh_mask,
            batch.merch_neigh_feat, batch.merch_neigh_mask))
        if mega_valid[3] else zeros,
        iforest_predict(models.iforest, features, kernel="gemm")
        if mega_valid[4] else zeros,
    ]


def _packed_tail(preds, ep, rule, txn, m: int) -> torch.Tensor:
    """The extended packed matrix from the blend output: OUT_COLUMNS,
    predictions, contributions, rule_decision / rule_risk."""
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import _key_factors

    kf = _key_factors(txn)
    head = torch.cat([
        ep[:, 0:4],
        rule[:, None],
        kf["high_amount"].to(torch.float32)[:, None],
        kf["unusual_hour"].to(torch.float32)[:, None],
        kf["high_risk_payment"].to(torch.float32)[:, None],
    ], dim=1)
    return torch.cat([head, preds.to(torch.float32), ep[:, 4:4 + m],
                      ep[:, 4 + m:6 + m]], dim=1)


def megakernel_reference(models, batch, params, *,
                         mega_valid: Tuple[bool, ...], bert_config=None,
                         compute_dtype: torch.dtype = torch.bfloat16
                         ) -> torch.Tensor:
    """Plain version of ``fused_megakernel``: the branch functions, the
    rule score and ``combine_matrix`` composed as a chain -> the same
    extended packed f32[B, 2M+10] matrix. Bool leaves must be bool."""
    from realtime_fraud_detection_tpu_torch.features.rules import rule_score
    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG

    bert_config = bert_config or TINY_CONFIG
    mega_valid = tuple(bool(v) for v in mega_valid)
    m = len(mega_valid)
    preds = torch.stack(_branch_columns(models, batch, mega_valid,
                                        bert_config, compute_dtype), dim=1)
    rule = rule_score(batch.txn).to(torch.float32)
    dev = preds.device
    mvf = torch.tensor(mega_valid, dtype=torch.float32, device=dev)
    vf = batch.valid.to(torch.float32)[:, None] * mvf[None, :]
    ep = combine_matrix(
        preds, vf, rule[:, None],
        params.weights.to(device=dev, dtype=torch.float32)[None, :],
        params.confidence_multipliers.to(device=dev,
                                         dtype=torch.float32)[None, :],
        **_statics(params))
    return _packed_tail(preds, ep, rule, batch.txn, m)


# ------------------------------------------------------------- the kernel
_P = ctypes.c_void_p
_L = ctypes.c_longlong
_LAYER_DENSE = (_P * len(DENSE_SITES)) * MEGA_MAX_LAYERS
_LAYER_LN = (_P * len(LN_SITES)) * MEGA_MAX_LAYERS
_INT_FIELDS = (
    "batch", "n_trees", "tree_depth", "n_iforest", "iforest_depth",
    "feat_dim", "seq_len", "lstm_hidden", "lstm_head", "node_dim", "fanout",
    "gnn_hidden", "gnn_head", "text_len", "hidden", "ffn", "heads", "layers",
    "vocab", "max_pos", "mega_valid", "strategy", "int8", "bf16", "gnn_typed")
_FLOAT_FIELDS = ("fraud_threshold", "confidence_threshold", "decline",
                 "review", "monitor", "ln_eps", "sqrt_head_dim")
_PTR_FIELDS = (
    "tree_feature", "tree_threshold", "tree_leaf", "tree_base",
    "if_feature", "if_threshold", "if_path", "if_cpsi",
    "lstm_w_gates", "lstm_b_gates", "lstm_w_head1", "lstm_b_head1",
    "lstm_w_head2", "lstm_b_head2",
    "gnn_w_sage1", "gnn_b_sage1", "gnn_w_sage2", "gnn_b_sage2",
    "gnn_w_head1", "gnn_b_head1", "gnn_w_head2", "gnn_b_head2",
    "word_emb", "word_scale", "pos_emb", "pos_scale",
    "emb_ln_scale", "emb_ln_bias")
# the typed GNN's per-node-type projections, csrc/megakernel.cu's order
_GNN_NODE_TYPES = ("user", "merchant", "device", "ip")
_TAIL_PTR_FIELDS = ("pre_w", "pre_b", "cls_w", "cls_b", "weights",
                    "conf_mult", "out")


class MegaArgs(ctypes.Structure):
    """csrc/megakernel.cu ``MegaArgs``, field for field: the C entry copies
    it into the kernel's by-value parameter."""

    _fields_ = (
        [("inp", _P * len(MEGA_INPUTS)), ("inp_stride", _L * len(MEGA_INPUTS))]
        + [(name, _P) for name in _PTR_FIELDS]
        + [("gnn_w_node", _P * len(_GNN_NODE_TYPES)),
           ("dense_w", _LAYER_DENSE), ("dense_scale", _LAYER_DENSE),
           ("dense_b", _LAYER_DENSE), ("ln_scale", _LAYER_LN),
           ("ln_bias", _LAYER_LN)]
        + [(name, _P) for name in _TAIL_PTR_FIELDS]
        + [(name, ctypes.c_int) for name in _INT_FIELDS]
        + [(name, ctypes.c_float) for name in _FLOAT_FIELDS]
    )


def _check_ptr(t, dtypes, name: str, device: torch.device) -> int:
    """A parameter tensor's address, after checking it for the kernel."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"fused_megakernel: {name} is not a tensor")
    if t.device != device or t.dtype not in dtypes:
        raise ValueError(
            f"fused_megakernel: {name} must be {dtypes} on {device}, "
            f"got {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"fused_megakernel: {name} must be contiguous")
    return t.data_ptr()


def _batch_field(batch, name):
    return getattr(batch.txn, name) if hasattr(batch.txn, name) else getattr(batch, name)


def _row_ptr(t, kind: str, name: str, b: int, device: torch.device) -> Tuple[int, int]:
    """Pointer and row stride of a [B, ...] batch leaf whose rows are
    contiguous (a column view of a packed blob qualifies)."""
    if not isinstance(t, torch.Tensor) or t.dtype not in _KIND_DTYPES[kind]:
        raise ValueError(f"fused_megakernel: batch.{name} must be one of "
                         f"{_KIND_DTYPES[kind]}")
    if t.device != device or t.shape[0] != b:
        raise ValueError(f"fused_megakernel: batch.{name} must be "
                         f"[{b}, ...] on {device}")
    expect = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size > 1 and stride != expect:
            raise ValueError(f"fused_megakernel: batch.{name} rows must be contiguous")
        expect *= size
    return t.data_ptr(), t.stride(0)


def _checked_dims(models, bert_config, widths: Tuple[int, int, int, int]) -> Dict[str, int]:
    """The kernel's widths for ``models`` at the batch ``widths``
    (text_len, feat_dim, seq_len, fanout); raises where its layout does not
    take them."""
    text_len, feat_dim, seq_len, fanout = widths
    dims = _dims(models, bert_config, text_len, feat_dim, seq_len)
    if not mega_kernel_shapes_ok(dims, mega_smem_bytes(dims, fanout)):
        raise ValueError(f"the megakernel does not take these shapes: {dims}")
    return dims


class MegaParamArgs:
    """The parameter half of the kernel's arguments for one models object:
    every weight pointer and width, checked and written into a ``MegaArgs``
    once. Each launch copies the struct and fills only the batch half. The
    pointers are those of the models' tensors when it was built, so its
    owner rebuilds it whenever they change: ``TorchFraudScorer`` builds one
    per ``set_models``, the only way its models change."""

    def __init__(self, models, bert_config, compute_dtype: torch.dtype,
                 widths: Tuple[int, int, int, int], device: torch.device):
        from realtime_fraud_detection_tpu_torch.models.gnn import is_typed_gnn
        from realtime_fraud_detection_tpu_torch.models.quant import is_quantized_bert

        text_len, feat_dim, seq_len, fanout = widths
        if device.type == "cuda" and device.index is None:   # as tensors report it
            device = torch.device("cuda", torch.cuda.current_device())
        self.models = models
        self.key = (bert_config, compute_dtype, widths, device)
        self.dims = _checked_dims(models, bert_config, widths)
        self.keep = []                    # the tensors the pointers point into
        a = self.args = MegaArgs()

        def ptr(t, dtypes, name):
            self.keep.append(t)
            return _check_ptr(t, dtypes, name, device)

        f32, i32, i8 = (torch.float32,), (torch.int32,), (torch.int8,)
        tr, fo, lstm, gnn, bert = (models.trees, models.iforest, models.lstm,
                                   models.gnn, models.bert)
        a.tree_feature = ptr(tr.feature, i32, "trees.feature")
        a.tree_threshold = ptr(tr.threshold, f32, "trees.threshold")
        a.tree_leaf = ptr(tr.leaf, f32, "trees.leaf")
        a.tree_base = ptr(tr.base_score, f32, "trees.base_score")
        a.if_feature = ptr(fo.feature, i32, "iforest.feature")
        a.if_threshold = ptr(fo.threshold, f32, "iforest.threshold")
        a.if_path = ptr(fo.path_length, f32, "iforest.path_length")
        a.if_cpsi = ptr(fo.c_psi, f32, "iforest.c_psi")
        for key in ("w_gates", "b_gates", "w_head1", "b_head1", "w_head2", "b_head2"):
            setattr(a, "lstm_" + key, ptr(lstm[key], f32, "lstm." + key))
        for key in ("w_sage1", "b_sage1", "w_sage2", "b_sage2", "w_head1",
                    "b_head1", "w_head2", "b_head2"):
            setattr(a, "gnn_" + key, ptr(gnn[key], f32, "gnn." + key))
        typed = is_typed_gnn(gnn)
        if typed:
            for i, name in enumerate(_GNN_NODE_TYPES):
                a.gnn_w_node[i] = ptr(gnn["w_node_" + name], f32, "gnn.w_node_" + name)
        int8 = is_quantized_bert(bert)
        wdt = i8 if int8 else f32
        for name in ("word_emb", "pos_emb"):
            table = bert[name]
            if int8:
                setattr(a, name, ptr(table["qe"], i8, name + ".qe"))
                setattr(a, name.split("_")[0] + "_scale",
                        ptr(table["scale"], f32, name + ".scale"))
            else:
                setattr(a, name, ptr(table, f32, name))
        a.emb_ln_scale = ptr(bert["emb_ln"]["scale"], f32, "emb_ln.scale")
        a.emb_ln_bias = ptr(bert["emb_ln"]["bias"], f32, "emb_ln.bias")
        for li, layer in enumerate(bert["layers"]):
            for si, site in enumerate(DENSE_SITES):
                p = layer[site]
                a.dense_w[li][si] = ptr(p["qw" if int8 else "w"], wdt, site)
                if int8:
                    a.dense_scale[li][si] = ptr(p["scale"], f32, site + ".scale")
                a.dense_b[li][si] = ptr(p["b"], f32, site + ".b")
            for si, site in enumerate(LN_SITES):
                a.ln_scale[li][si] = ptr(layer[site]["scale"], f32, site)
                a.ln_bias[li][si] = ptr(layer[site]["bias"], f32, site)
        a.pre_w = ptr(bert["pre_classifier"]["w"], f32, "pre_classifier.w")
        a.pre_b = ptr(bert["pre_classifier"]["b"], f32, "pre_classifier.b")
        a.cls_w = ptr(bert["classifier"]["w"], f32, "classifier.w")
        a.cls_b = ptr(bert["classifier"]["b"], f32, "classifier.b")
        word = bert["word_emb"]["qe"] if int8 else bert["word_emb"]
        pos = bert["pos_emb"]["qe"] if int8 else bert["pos_emb"]
        d = self.dims
        ints = dict(
            n_trees=d["n_trees"], tree_depth=int(math.log2(tr.leaf.shape[1])),
            n_iforest=d["n_iforest"],
            iforest_depth=int(math.log2(fo.path_length.shape[1])),
            feat_dim=feat_dim, seq_len=seq_len,
            lstm_hidden=d["lstm_hidden"], lstm_head=d["lstm_head"],
            node_dim=d["node_dim"], fanout=fanout,
            gnn_hidden=d["gnn_hidden"], gnn_head=d["gnn_head"],
            text_len=text_len, hidden=d["hidden"], ffn=d["ffn"],
            heads=d["heads"], layers=len(bert["layers"]),
            vocab=int(word.shape[0]), max_pos=int(pos.shape[0]),
            int8=int(int8), bf16=int(compute_dtype == torch.bfloat16),
            gnn_typed=int(typed))
        for name, value in ints.items():
            setattr(a, name, value)
        a.ln_eps = bert_config.layer_norm_eps
        a.sqrt_head_dim = math.sqrt(bert_config.head_dim)


def _batch_widths(batch) -> Tuple[int, int, int, int]:
    """(text_len, feat_dim, seq_len, fanout) of a [B, ...] batch."""
    return (int(batch.token_ids.shape[1]), int(batch.features.shape[1]),
            int(batch.history.shape[1]), int(batch.user_neigh_feat.shape[1]))


def _param_args(given: Optional[MegaParamArgs], models,
                widths: Tuple[int, int, int, int], device: torch.device,
                bert_config, compute_dtype: torch.dtype) -> MegaParamArgs:
    """``given`` once checked to be built from these models for this call,
    else a new parameter half."""
    if given is None:
        return MegaParamArgs(models, bert_config, compute_dtype, widths, device)
    if given.models is not models or given.key != (bert_config, compute_dtype,
                                                   widths, device):
        raise ValueError("fused_megakernel: param_args were built for other "
                         "models, widths or settings than this call's")
    return given


def _launch(entry: MegaParamArgs, inputs, b: int, dev: torch.device, params,
            mega_valid: Tuple[bool, ...]) -> torch.Tensor:
    """Copy the parameter half, fill the batch half (``inputs``: a
    (pointer, row stride) per MEGA_INPUTS leaf) and launch."""
    a = MegaArgs.from_buffer_copy(entry.args)
    for j, (ptr, stride) in enumerate(inputs):
        a.inp[j], a.inp_stride[j] = ptr, stride
    f32 = (torch.float32,)
    weights = params.weights.to(device=dev, dtype=torch.float32).contiguous()
    conf = params.confidence_multipliers.to(device=dev, dtype=torch.float32).contiguous()
    a.weights = _check_ptr(weights, f32, "weights", dev)
    a.conf_mult = _check_ptr(conf, f32, "conf_mult", dev)
    out = torch.empty((b, 2 * len(mega_valid) + 10), dtype=torch.float32, device=dev)
    a.out = out.data_ptr()
    a.batch = b
    a.mega_valid = sum(1 << j for j, v in enumerate(mega_valid) if v)
    for name, value in _statics(params).items():
        setattr(a, name, value)
    code = kernel_library().rtfd_megakernel(
        ctypes.addressof(a), _sm_count(dev), torch.cuda.current_stream(dev).cuda_stream)
    check_launch("fused_megakernel", code)
    count_launch(fused_megakernel)
    return out


_BLOB_OF_KIND = {"f": "f32", "i": "i32", "b": "u8"}
_BLOB_DTYPES = {"f32": torch.float32, "i32": torch.int32, "u8": torch.uint8}


@functools.lru_cache(maxsize=64)
def _packed_layout(spec: PackSpec):
    """Where each MEGA_INPUTS leaf sits in the packed blobs: (blob, first
    column) per leaf, and the batch widths. Raises on a two-hop batch."""
    index = tree_unflatten(spec.treedef, list(range(len(spec.entries))))
    if index.user_neigh2_feat is not None:
        raise ValueError("the megakernel does not take two-hop batches")
    cols = []
    for name, kind in MEGA_INPUTS:
        blob, offset, _, _ = spec.entries[_batch_field(index, name)]
        if blob != _BLOB_OF_KIND[kind]:
            raise ValueError(f"fused_megakernel: batch.{name} is packed in {blob}")
        cols.append((blob, offset))
    tails = {name: spec.entries[_batch_field(index, name)][2]
             for name in ("token_ids", "features", "history", "user_neigh_feat")}
    widths = (int(tails["token_ids"][0]), int(tails["features"][0]),
              int(tails["history"][0]), int(tails["user_neigh_feat"][0]))
    return tuple(cols), widths


def _check_call(mega_valid, compute_dtype) -> Tuple[bool, ...]:
    mega_valid = tuple(bool(v) for v in mega_valid)
    if len(mega_valid) != MEGA_NUM_MODELS:
        raise ValueError(f"mega_valid needs {MEGA_NUM_MODELS} entries")
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"compute_dtype must be bf16 or f32, got {compute_dtype}")
    return mega_valid


def fused_megakernel_packed(models, blobs: Dict[str, torch.Tensor], spec: PackSpec,
                            params, *, mega_valid: Tuple[bool, ...], bert_config=None,
                            compute_dtype: torch.dtype = torch.bfloat16,
                            param_args: Optional[MegaParamArgs] = None) -> torch.Tensor:
    """``fused_megakernel`` for a packed batch (``core/packing.py``): on the
    card the batch half of the arguments points straight into the blobs,
    with no unpacking and no per-leaf checks (the leaf layout is cached per
    ``spec``; the three blobs are checked); for blobs on the CPU they are
    unpacked and the plain version runs. A batch with bf16 wire leaves is
    unpacked and widened, then launched through ``fused_megakernel``."""
    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG

    if blobs["f32"].device.type == "cpu" or "bf16" in blobs:
        return fused_megakernel(models, widen_bf16(unpack_tree(blobs, spec)), params,
                                mega_valid=mega_valid, bert_config=bert_config,
                                compute_dtype=compute_dtype, param_args=param_args)
    bert_config = bert_config or TINY_CONFIG
    mega_valid = _check_call(mega_valid, compute_dtype)
    cols, widths = _packed_layout(spec)
    dev = blobs["f32"].device
    b = int(blobs["f32"].shape[0])
    entry = _param_args(param_args, models, widths, dev, bert_config, compute_dtype)
    base = {}
    for name, dtype in _BLOB_DTYPES.items():
        t = blobs[name]
        if (t.dtype != dtype or t.device != dev or t.dim() != 2 or t.shape[0] != b
                or not t.is_contiguous()):
            raise ValueError(f"fused_megakernel: blob {name} must be a contiguous "
                             f"{dtype} [{b}, W] on {dev}")
        base[name] = (t.data_ptr(), t.element_size(), t.stride(0))
    inputs = [(base[blob][0] + offset * base[blob][1], base[blob][2])
              for blob, offset in cols]
    return _launch(entry, inputs, b, dev, params, mega_valid)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fused_megakernel(models, batch, params, *,
                     mega_valid: Tuple[bool, ...], bert_config=None,
                     compute_dtype: torch.dtype = torch.bfloat16,
                     param_args: Optional[MegaParamArgs] = None
                     ) -> torch.Tensor:
    """Score a whole microbatch in one launch -> the extended packed
    f32[B, 2M+10] matrix (OUT_COLUMNS, model predictions, contributions,
    rule_decision / rule_risk). ``mega_valid`` is the QoS rung. Raises on
    widths the kernel's layout does not take and on two-hop batches;
    whether a batch should take the megakernel at all (bucket size, L2
    budget) is the caller's decision from ``mega_plan``. ``param_args``,
    the parameter half built once by the models' owner, must come from
    these very ``models`` (else this raises); without it the call builds
    its own."""
    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG

    bert_config = bert_config or TINY_CONFIG
    mega_valid = _check_call(mega_valid, compute_dtype)
    if batch.user_neigh2_feat is not None:
        raise ValueError("the megakernel does not take two-hop batches")
    dev = batch.features.device
    widths = _batch_widths(batch)
    if dev.type == "cpu":           # the same checks, then the plain version
        if param_args is None:
            _checked_dims(models, bert_config, widths)
        else:
            _param_args(param_args, models, widths, dev, bert_config, compute_dtype)
        return megakernel_reference(models, batch, params,
                                    mega_valid=mega_valid,
                                    bert_config=bert_config,
                                    compute_dtype=compute_dtype)
    entry = _param_args(param_args, models, widths, dev, bert_config, compute_dtype)
    b = int(batch.features.shape[0])
    inputs = [_row_ptr(_batch_field(batch, name), kind, name, b, dev)
              for name, kind in MEGA_INPUTS]
    return _launch(entry, inputs, b, dev, params, mega_valid)


fused_megakernel.launches = 0
