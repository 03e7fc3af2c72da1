"""Fused score-and-blend epilogue.

``epilogue_packed`` replaces the JAX package's Pallas kernel
``ops/epilogue.py fused_epilogue`` (``_epilogue_kernel``): the ensemble
combine, per-model confidence, decision and risk ladders, the explanation
contributions ``w * p`` and the rules-only ladder over the rule score, in one
launch that writes the columns of the packed ``[B, 8 + 2M + 2]`` result of
``scoring/pipeline.py`` (``packed_columns`` below; the three key-factor
columns are left 0 for the caller), new or into the first columns of a
caller's wider matrix at its row stride. On the card it runs the kernel of
``csrc/epilogue.cu`` (design and bound noted there), which takes the
weights, confidence multipliers, strategy and thresholds by value
(``EpilogueArgs``) and builds the validity mask from the model-valid bits
and ``batch.valid``; for tensors on the CPU it runs
``epilogue_packed_reference``, ``combine_matrix`` written into the same
columns. ``epilogue_packed.launches`` counts kernel launches.

``epilogue_matrix`` / ``fused_epilogue`` keep the JAX package's own API
(a bool ``[B, M]`` or ``[M]`` mask, the ``[B, M+6]`` epilogue matrix or its
result dict) over the same kernel, for the kernel drill's oracle and the
tests.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import torch

from realtime_fraud_detection_tpu_torch.ensemble.combine import VOTING, WEIGHTED_AVERAGE
from realtime_fraud_detection_tpu_torch.features.rules import (
    APPROVE,
    APPROVE_WITH_MONITORING,
    DECLINE,
    REVIEW,
    RISK_LEVEL_THRESHOLDS,
)
from realtime_fraud_detection_tpu_torch.ops.build import check_launch, kernel_library

MAX_EPILOGUE_ROWS = 1 << 16
# models the kernel's argument struct carries (csrc/epilogue.cu EPI_MAX_M)
MAX_EPILOGUE_MODELS = 8


def packed_columns(m: int) -> Dict[str, slice]:
    """Column ranges of the packed result for ``m`` models (the layout of
    ``scoring/pipeline.py OUT_COLUMNS + model predictions + EXT_COLUMNS``)."""
    return {"head": slice(0, 4), "rule_score": slice(4, 5),
            "key_factors": slice(5, 8), "model_predictions": slice(8, 8 + m),
            "model_contributions": slice(8 + m, 8 + 2 * m),
            "rule_ladder": slice(8 + 2 * m, 10 + 2 * m)}


def _packed_width(m: int) -> int:
    return 10 + 2 * m


def epilogue_supported(b: int, m: int) -> bool:
    return 0 < b <= MAX_EPILOGUE_ROWS and 1 <= m <= MAX_EPILOGUE_MODELS


def _rule_ladder(prob, decline, review, monitor):
    """Probability rungs only (no confidence clause), as exact floats."""
    out = torch.full_like(prob, float(APPROVE))
    out = torch.where(prob >= monitor, float(APPROVE_WITH_MONITORING), out)
    out = torch.where(prob >= review, float(REVIEW), out)
    return torch.where(prob >= decline, float(DECLINE), out)


def _risk_code_f32(prob):
    code = torch.zeros_like(prob)
    for t in RISK_LEVEL_THRESHOLDS:
        code = code + (prob >= t).to(torch.float32)
    return code


def combine_matrix(preds, vf, rule, wvec, cm, *, strategy, fraud_threshold,
                   confidence_threshold, decline, review, monitor):
    """Ensemble combine -> the [B, M+6] epilogue matrix.

    preds/vf f32[B, M], rule f32[B, 1], wvec/cm f32[1, M]. Columns: prob,
    confidence, decision, risk, contributions x M, rule_decision, rule_risk.
    """
    conf = torch.clamp(torch.abs(preds - 0.5) * 2.0 * cm, max=1.0) * vf
    w = wvec * vf

    def where(c, a, other):
        return torch.where(c, a, torch.as_tensor(other, dtype=a.dtype,
                                                 device=a.device))

    w_total = w.sum(dim=1, keepdim=True)
    wa_prob = where(w_total > 0, (preds * w).sum(dim=1, keepdim=True)
                    / torch.clamp(w_total, min=1e-12), 0.5)
    wa_conf = where(w_total > 0, (conf * w).sum(dim=1, keepdim=True)
                    / torch.clamp(w_total, min=1e-12), 0.0)

    n_valid = vf.sum(dim=1, keepdim=True)
    votes = ((preds > fraud_threshold).to(torch.float32) * vf).sum(
        dim=1, keepdim=True)
    vote_prob = where(n_valid > 0, votes / torch.clamp(n_valid, min=1.0), 0.0)
    vote_conf = where(n_valid > 0, conf.sum(dim=1, keepdim=True)
                      / torch.clamp(n_valid, min=1.0), 0.0)

    conf_total = conf.sum(dim=1, keepdim=True)
    stack_prob = torch.where(conf_total > 0, (preds * conf).sum(
        dim=1, keepdim=True) / torch.clamp(conf_total, min=1e-12), wa_prob)
    stack_conf = torch.where(conf_total > 0, conf_total
                             / torch.clamp(n_valid, min=1.0), wa_conf)

    if strategy == WEIGHTED_AVERAGE:
        prob, confidence = wa_prob, wa_conf
    elif strategy == VOTING:
        prob, confidence = vote_prob, vote_conf
    else:
        prob, confidence = stack_prob, stack_conf

    by_prob = _rule_ladder(prob, decline, review, monitor)
    decision = torch.where(confidence < confidence_threshold, float(REVIEW),
                           by_prob)
    return torch.cat(
        [prob, confidence, decision, _risk_code_f32(prob), wvec * preds,
         _rule_ladder(rule, decline, review, monitor), _risk_code_f32(rule)],
        dim=1)


def _statics(params) -> Dict[str, float]:
    return dict(strategy=int(params.strategy),
                fraud_threshold=float(params.fraud_threshold),
                confidence_threshold=float(params.confidence_threshold),
                decline=float(params.decline_threshold),
                review=float(params.review_threshold),
                monitor=float(params.monitor_threshold))


class EpilogueArgs(ctypes.Structure):
    """ctypes mirror of ``csrc/epilogue.cu EpilogueArgs`` (same order)."""

    _fields_ = [
        ("preds", ctypes.c_void_p), ("rule", ctypes.c_void_p),
        ("row_valid", ctypes.c_void_p), ("valid", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("B", ctypes.c_int), ("M", ctypes.c_int), ("out_stride", ctypes.c_int),
        ("model_bits", ctypes.c_int), ("strategy", ctypes.c_int),
        ("fraud_threshold", ctypes.c_float),
        ("confidence_threshold", ctypes.c_float),
        ("decline", ctypes.c_float), ("review", ctypes.c_float),
        ("monitor", ctypes.c_float),
        ("w", ctypes.c_float * MAX_EPILOGUE_MODELS),
        ("cm", ctypes.c_float * MAX_EPILOGUE_MODELS),
    ]


def _host_vectors(params):
    """The blend weights and confidence multipliers as host floats, read
    from the device once per tensor (cached on ``params`` with the tensors
    themselves and their in-place version counters, so neither a new tensor
    nor an in-place write can meet a stale copy)."""
    w, cm = params.weights, params.confidence_multipliers
    cached = getattr(params, "_epilogue_host", None)
    if (cached is None or cached[0] is not w or cached[1] != w._version
            or cached[2] is not cm or cached[3] != cm._version):
        cached = (w, w._version, cm, cm._version,
                  [float(x) for x in w.reshape(-1).tolist()],
                  [float(x) for x in cm.reshape(-1).tolist()])
        params._epilogue_host = cached
    return cached[4], cached[5]


def epilogue_args(params, m: int) -> EpilogueArgs:
    """The by-value half of the kernel's arguments: strategy, thresholds,
    and the weights and multipliers zero-padded to ``MAX_EPILOGUE_MODELS``.
    Raises for more models than the struct carries."""
    if not 1 <= m <= MAX_EPILOGUE_MODELS:
        raise ValueError(f"the epilogue kernel takes 1..{MAX_EPILOGUE_MODELS} "
                         f"models, got {m}")
    w, cm = _host_vectors(params)
    if len(w) != m or len(cm) != m:
        raise ValueError(f"{len(w)} weights / {len(cm)} multipliers for {m} models")
    st = _statics(params)
    a = EpilogueArgs()
    a.M = m
    a.strategy = st["strategy"]
    a.fraud_threshold = st["fraud_threshold"]
    a.confidence_threshold = st["confidence_threshold"]
    a.decline, a.review, a.monitor = st["decline"], st["review"], st["monitor"]
    for j in range(m):
        a.w[j], a.cm[j] = w[j], cm[j]
    return a


def _model_bits(model_valid, m: int) -> int:
    flags = (model_valid.tolist() if isinstance(model_valid, torch.Tensor)
             else list(model_valid))
    if len(flags) != m:
        raise ValueError(f"model_valid has {len(flags)} flags for {m} models")
    return sum(1 << j for j, on in enumerate(flags) if on)


def _validity(preds, model_valid, row_valid, valid) -> torch.Tensor:
    """The f32 [B, M] mask the plain version blends under."""
    b, m = preds.shape
    if valid is not None:
        return valid.to(device=preds.device, dtype=torch.float32)
    bits = _model_bits(model_valid, m) if model_valid is not None else (1 << m) - 1
    mv = torch.tensor([bool(bits >> j & 1) for j in range(m)], device=preds.device)
    rv = (torch.ones(b, dtype=torch.bool, device=preds.device) if row_valid is None
          else row_valid.to(device=preds.device, dtype=torch.bool))
    return (rv[:, None] & mv[None, :]).to(torch.float32)


def _out_matrix(out: Optional[torch.Tensor], b: int, m: int, device) -> torch.Tensor:
    """A new packed result, or the caller's ``out``: f32 rows of at least the
    packed width, unit column stride, on ``device``; the packed columns are
    its first ``_packed_width(m)``."""
    if out is None:
        return torch.empty((b, _packed_width(m)), dtype=torch.float32, device=device)
    if (out.dtype != torch.float32 or out.ndim != 2 or out.shape[0] != b
            or out.shape[1] < _packed_width(m) or out.stride(1) != 1
            or out.device != device):
        raise ValueError(f"epilogue out must be f32 [{b}, >= {_packed_width(m)}] "
                         f"with unit column stride on {device}")
    return out


def epilogue_packed_reference(preds: torch.Tensor, rule: torch.Tensor, params,
                              model_valid: Optional[Sequence[bool]] = None,
                              row_valid: Optional[torch.Tensor] = None,
                              valid: Optional[torch.Tensor] = None,
                              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of ``epilogue_packed``: ``combine_matrix`` written into
    the packed columns (key-factor columns 0)."""
    b, m = preds.shape
    p = preds.to(torch.float32)
    r = rule.to(torch.float32).reshape(-1)
    mat = combine_matrix(
        p, _validity(preds, model_valid, row_valid, valid), r[:, None],
        params.weights.to(device=preds.device, dtype=torch.float32).reshape(1, -1),
        params.confidence_multipliers.to(device=preds.device, dtype=torch.float32)
        .reshape(1, -1), **_statics(params))
    cols = packed_columns(m)
    out = _out_matrix(out, b, m, preds.device)
    out[:, cols["key_factors"]] = 0.0
    out[:, cols["head"]] = mat[:, :4]
    out[:, cols["rule_score"]] = r[:, None]
    out[:, cols["model_predictions"]] = p
    out[:, cols["model_contributions"]] = mat[:, 4:4 + m]
    out[:, cols["rule_ladder"]] = mat[:, 4 + m:6 + m]
    return out


def _u8_pointer(t: Optional[torch.Tensor], shape, device, name: str) -> int:
    if t is None:
        return 0
    if (tuple(t.shape) != tuple(shape) or t.dtype not in (torch.bool, torch.uint8)
            or not t.is_contiguous() or t.device != device):
        raise ValueError(f"epilogue {name} must be a contiguous bool or u8 "
                         f"{tuple(shape)} tensor on {device}")
    return t.data_ptr()


def epilogue_packed(preds: torch.Tensor, rule: torch.Tensor, params,
                    model_valid: Optional[Sequence[bool]] = None,
                    row_valid: Optional[torch.Tensor] = None,
                    valid: Optional[torch.Tensor] = None,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused combine -> the packed ``f32[B, 8 + 2M + 2]`` result, new or
    written into the first columns of the caller's ``out`` at its row stride.

    ``preds`` f32 [B, M], ``rule`` f32 [B]; ``params`` an ``EnsembleParams``.
    Validity is ``row_valid`` (bool [B], ``batch.valid``; None: every row)
    AND ``model_valid`` (M host flags, the rung; None: every model), or, when
    given, the per-row mask ``valid`` (bool [B, M]) instead of both. The
    key-factor columns are 0 for the caller to write."""
    b, m = preds.shape
    if not epilogue_supported(b, m):
        raise ValueError(f"unsupported epilogue shape [{b},{m}] (at most "
                         f"{MAX_EPILOGUE_MODELS} models)")
    if preds.device.type == "cpu":
        return epilogue_packed_reference(preds, rule, params, model_valid,
                                         row_valid, valid, out)
    if (preds.dtype != torch.float32 or not preds.is_contiguous()
            or rule.dtype != torch.float32 or rule.numel() != b
            or not rule.is_contiguous() or rule.device != preds.device):
        raise ValueError("epilogue takes contiguous f32 preds [B, M] and rule [B] "
                         "on one device")
    a = epilogue_args(params, m)
    out = _out_matrix(out, b, m, preds.device)
    a.preds, a.rule, a.out = preds.data_ptr(), rule.data_ptr(), out.data_ptr()
    a.row_valid = _u8_pointer(row_valid, (b,), preds.device, "row_valid")
    a.valid = _u8_pointer(valid, (b, m), preds.device, "valid")
    a.B, a.out_stride = b, out.stride(0)
    a.model_bits = _model_bits(model_valid, m) if model_valid is not None else (1 << m) - 1
    code = kernel_library().rtfd_epilogue_packed(
        ctypes.addressof(a), torch.cuda.current_stream(preds.device).cuda_stream)
    check_launch("epilogue_packed", code)
    epilogue_packed.launches += 1
    return out


epilogue_packed.launches = 0


def _matrix_call(fn, preds, valid, rule, params) -> torch.Tensor:
    """``fn`` (the packed entry or its plain version) under the JAX API's
    mask, cut down to the [B, M+6] epilogue matrix."""
    m = preds.shape[1]
    if valid.ndim == 1:
        packed = fn(preds.to(torch.float32).contiguous(),
                    rule.to(torch.float32).reshape(-1).contiguous(), params,
                    model_valid=valid.to(torch.bool).cpu())
    else:
        packed = fn(preds.to(torch.float32).contiguous(),
                    rule.to(torch.float32).reshape(-1).contiguous(), params,
                    valid=valid.to(torch.bool).contiguous())
    cols = packed_columns(m)
    return torch.cat([packed[:, cols["head"]], packed[:, cols["model_contributions"]],
                      packed[:, cols["rule_ladder"]]], dim=1)


def _as_dict(out: torch.Tensor, m: int) -> Dict[str, torch.Tensor]:
    return {
        "fraud_probability": out[:, 0],
        "confidence": out[:, 1],
        "decision": out[:, 2].to(torch.int32),
        "risk_level": out[:, 3].to(torch.int32),
        "model_contributions": out[:, 4:4 + m],
        "rule_decision": out[:, 4 + m].to(torch.int32),
        "rule_risk": out[:, 5 + m].to(torch.int32),
    }


def epilogue_matrix_reference(preds, valid, rule, params) -> torch.Tensor:
    """Plain version of ``epilogue_matrix``."""
    return _matrix_call(epilogue_packed_reference, preds, valid, rule, params)


def epilogue_matrix(preds: torch.Tensor, valid: torch.Tensor,
                    rule: torch.Tensor, params) -> torch.Tensor:
    """The [B, M+6] epilogue matrix (prob, confidence, decision, risk,
    contributions x M, rule decision, rule risk) through ``epilogue_packed``.
    ``valid`` is bool or f32 [B, M], or [M]."""
    b, m = preds.shape
    if not epilogue_supported(b, m):
        raise ValueError(f"unsupported epilogue shape [{b},{m}]")
    return _matrix_call(epilogue_packed, preds, valid, rule, params)


def epilogue_reference(preds, valid, rule, params) -> Dict[str, torch.Tensor]:
    """Plain version of ``fused_epilogue``."""
    return _as_dict(epilogue_matrix_reference(preds, valid, rule, params),
                    preds.shape[1])


def fused_epilogue(preds, valid, rule, params) -> Dict[str, torch.Tensor]:
    """``epilogue_matrix`` split into the JAX package's result dict."""
    return _as_dict(epilogue_matrix(preds, valid, rule, params),
                    preds.shape[1])
