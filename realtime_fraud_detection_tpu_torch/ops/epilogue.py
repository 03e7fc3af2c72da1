"""Fused score-and-blend epilogue.

``fused_epilogue`` replaces the JAX package's Pallas kernel
``ops/epilogue.py fused_epilogue`` (``_epilogue_kernel``): the ensemble
combine, per-model confidence, decision and risk ladders, the explanation
contributions ``w * p`` and the rules-only ladder over the rule score, in one
launch that writes the [B, M+6] epilogue matrix (``epilogue_matrix``;
``fused_epilogue`` splits it into the JAX package's result dict).
``combine_matrix`` is that matrix's math in plain PyTorch;
``epilogue_matrix_reference`` runs it for a tensor on the CPU and is what the
kernel of ``csrc/epilogue.cu`` is held against on the card.
``epilogue_matrix.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Dict

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


def epilogue_supported(b: int, m: int) -> bool:
    return 0 < b <= MAX_EPILOGUE_ROWS and m >= 1


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


def _operands(preds, valid, rule, params):
    if valid.ndim == 1:
        valid = valid[None, :].expand(preds.shape)
    return (preds.to(torch.float32).contiguous(),
            valid.to(torch.float32).contiguous(),
            rule.to(torch.float32).reshape(-1, 1).contiguous(),
            params.weights.to(device=preds.device, dtype=torch.float32)
            .reshape(1, -1).contiguous(),
            params.confidence_multipliers.to(device=preds.device,
                                             dtype=torch.float32)
            .reshape(1, -1).contiguous())


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
    """Plain version of ``epilogue_matrix``: ``combine_matrix`` on the same
    operands."""
    return combine_matrix(*_operands(preds, valid, rule, params),
                          **_statics(params))


def epilogue_matrix(preds: torch.Tensor, valid: torch.Tensor,
                    rule: torch.Tensor, params) -> torch.Tensor:
    """Fused combine -> the [B, M+6] epilogue matrix. ``params`` is an
    ``EnsembleParams``; ``valid`` is bool or f32 [B, M], or [M]."""
    b, m = preds.shape
    if not epilogue_supported(b, m):
        raise ValueError(f"unsupported epilogue shape [{b},{m}]")
    if preds.device.type == "cpu":
        return epilogue_matrix_reference(preds, valid, rule, params)
    p, vf, r, w, cm = _operands(preds, valid, rule, params)
    if len({t.device for t in (p, vf, r, w, cm)}) != 1:
        raise ValueError("epilogue operands on different devices")
    st = _statics(params)
    out = torch.empty((b, m + 6), dtype=torch.float32, device=preds.device)
    code = kernel_library().rtfd_epilogue(
        p.data_ptr(), vf.data_ptr(), r.data_ptr(), w.data_ptr(), cm.data_ptr(),
        out.data_ptr(), b, m, st["strategy"], st["fraud_threshold"],
        st["confidence_threshold"], st["decline"], st["review"], st["monitor"],
        torch.cuda.current_stream(preds.device).cuda_stream)
    check_launch("epilogue_matrix", code)
    epilogue_matrix.launches += 1
    return out


epilogue_matrix.launches = 0


def epilogue_reference(preds, valid, rule, params) -> Dict[str, torch.Tensor]:
    """Plain version of ``fused_epilogue``."""
    return _as_dict(epilogue_matrix_reference(preds, valid, rule, params),
                    preds.shape[1])


def fused_epilogue(preds, valid, rule, params) -> Dict[str, torch.Tensor]:
    """``epilogue_matrix`` split into the JAX package's result dict."""
    return _as_dict(epilogue_matrix(preds, valid, rule, params),
                    preds.shape[1])
