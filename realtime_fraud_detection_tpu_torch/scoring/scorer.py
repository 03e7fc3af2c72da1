"""The device half of the streaming scorer.

Port of the device half of the JAX package's ``scoring/scorer.py
FraudScorer``: ``dispatch_assembled`` pads an assembled microbatch to its
bucket, packs it into the three transfer blobs, copies them to the card
from pinned host memory, launches the fused scorer and starts the copy of
the result matrix back into pinned host memory behind a CUDA event;
``finalize`` waits on that event and builds the response dicts. Host
assembly (stores, tokenizer, ``assemble``), state write-back, pools, the
mesh and tracing are not part of this port yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from realtime_fraud_detection_tpu_torch.core.batching import pad_to_bucket
from realtime_fraud_detection_tpu_torch.core.packing import pack_tree
from realtime_fraud_detection_tpu_torch.ensemble.combine import EnsembleParams
from realtime_fraud_detection_tpu_torch.features.rules import (
    APPROVE,
    APPROVE_WITH_MONITORING,
    DECISIONS,
    DECLINE,
    REVIEW,
    RISK_LEVEL_NAMES,
    risk_level_codes_np,
)
from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG, BertConfig
from realtime_fraud_detection_tpu_torch.models.quant import quantize_bert_params
from realtime_fraud_detection_tpu_torch.scoring.pipeline import (
    MODEL_NAMES,
    NUM_MODELS,
    OUT_COLUMNS,
    ScoreBatch,
    ScorerConfig,
    ScoringModels,
    init_scoring_models,
    score_fused_packed,
)
from realtime_fraud_detection_tpu_torch.utils.config import Config


@dataclasses.dataclass
class PendingScore:
    """A dispatched-but-not-finalized microbatch. ``out`` is the host
    result matrix, filled once ``event`` (None on the CPU) has completed."""

    records: List[Mapping[str, Any]]
    n: int
    out: torch.Tensor
    event: Optional[torch.cuda.Event]
    dispatch_ms: float
    model_valid: np.ndarray
    rules_only: bool = False


class TorchFraudScorer:
    """Scores assembled microbatches on one device (``cuda`` by default)."""

    def __init__(self, config: Optional[Config] = None,
                 models: Optional[ScoringModels] = None,
                 scorer_config: Optional[ScorerConfig] = None,
                 bert_config: BertConfig = TINY_CONFIG, seed: int = 0,
                 device: str = "cuda",
                 compute_dtype: torch.dtype = torch.bfloat16):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TorchFraudScorer: no CUDA device available")
        self.config = config or Config()
        self.sc = scorer_config or ScorerConfig()
        self.bert_config = bert_config
        self.compute_dtype = compute_dtype
        self.quant = self.config.quant
        self.kernels = self.config.kernels
        self.ensemble_params = EnsembleParams.from_config(
            self.config, MODEL_NAMES).to(self.device)
        self.model_valid = np.asarray(
            [n in self.config.model_weights for n in MODEL_NAMES], bool)
        self._qos_mask: Optional[np.ndarray] = None
        self._qos_rules_only = False
        self.set_models(models if models is not None else init_scoring_models(
            seed, bert_config, feature_dim=self.sc.feature_dim,
            node_dim=self.sc.node_dim))

    # ----------------------------------------------------------------- models
    def set_models(self, models: ScoringModels) -> None:
        """Swap the model set; with int8 BERT configured the weights are
        quantized on the host first (idempotent), then moved to the device."""
        if self.quant.bert_mode() == "int8":
            models = dataclasses.replace(
                models, bert=quantize_bert_params(models.bert))
        self.models = models.to(self.device)

    def set_degradation(self, mask: Optional[np.ndarray],
                        rules_only: bool = False) -> None:
        """QoS rung: ``mask`` narrows the enabled branches for later
        dispatches; ``rules_only`` serves the rule score instead."""
        self._qos_mask = None if mask is None else np.asarray(mask, bool)
        self._qos_rules_only = bool(rules_only)

    def effective_model_valid(self) -> np.ndarray:
        """Deployment validity AND the current QoS rung's mask."""
        if self._qos_mask is None:
            return self.model_valid.copy()
        return self.model_valid & self._qos_mask

    # ---------------------------------------------------------------- scoring
    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(arr)
        if self.device.type != "cuda":
            return host.to(self.device)
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        pinned.copy_(host)
        return pinned.to(self.device, non_blocking=True)

    def dispatch_assembled(self, batch: ScoreBatch,
                           records: Sequence[Mapping[str, Any]],
                           t0: Optional[float] = None) -> PendingScore:
        """Pad + pack + launch an assembled host batch without waiting for
        the device."""
        t0 = time.perf_counter() if t0 is None else t0
        n = len(records)
        padded, mask, _ = pad_to_bucket(batch, n)
        padded = dataclasses.replace(padded, valid=mask)
        blobs, spec = pack_tree(padded)
        dev_blobs = {name: self._to_device(arr) for name, arr in blobs.items()}
        mv = self.effective_model_valid()
        out = score_fused_packed(
            self.models, dev_blobs, spec, self.ensemble_params,
            self._to_device(mv), bert_config=self.bert_config,
            compute_dtype=self.compute_dtype,
            **self.quant.static(), **self.kernels.static())
        event = None
        if self.device.type == "cuda":
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = out
        return PendingScore(
            records=list(records), n=n, out=host, event=event,
            dispatch_ms=(time.perf_counter() - t0) * 1000.0,
            model_valid=mv, rules_only=self._qos_rules_only)

    def finalize(self, pending: PendingScore) -> List[Dict[str, Any]]:
        """Wait for a dispatched batch and build its responses."""
        t_fin = time.perf_counter()
        if pending.event is not None:
            pending.event.synchronize()
        elapsed_ms = pending.dispatch_ms + (time.perf_counter() - t_fin) * 1000.0
        return self._build_responses(
            pending.records, pending.out.numpy(), pending.n, elapsed_ms,
            model_valid=pending.model_valid, rules_only=pending.rules_only)

    def _build_responses(self, records, out, n, elapsed_ms, model_valid=None,
                         rules_only=False) -> List[Dict[str, Any]]:
        """Response dicts from the packed matrix ``out`` ([B, 8+M] or, with
        the epilogue extension, [B, 8+2M+2])."""
        if model_valid is None:
            model_valid = self.model_valid
        mat = np.asarray(out)[:n]
        col = {name: mat[:, j] for j, name in enumerate(OUT_COLUMNS)}
        probs = col["fraud_probability"]
        conf = col["confidence"]
        decisions = col["decision"].astype(np.int32)
        risk = col["risk_level"].astype(np.int32)
        base_w = len(OUT_COLUMNS) + NUM_MODELS
        extended = mat.shape[1] >= base_w + NUM_MODELS + 2
        preds = mat[:, len(OUT_COLUMNS):base_w]
        contrib_cols = mat[:, base_w:base_w + NUM_MODELS] if extended else None
        rule = col["rule_score"]
        if rules_only and extended:
            probs = rule
            conf = np.ones_like(probs)
            decisions = mat[:, base_w + NUM_MODELS].astype(np.int32)
            risk = mat[:, base_w + NUM_MODELS + 1].astype(np.int32)
        elif rules_only:
            p = self.ensemble_params
            probs = rule
            conf = np.ones_like(probs)
            decisions = np.where(
                probs >= p.decline_threshold, DECLINE,
                np.where(probs >= p.review_threshold, REVIEW,
                         np.where(probs >= p.monitor_threshold,
                                  APPROVE_WITH_MONITORING,
                                  APPROVE))).astype(np.int32)
            risk = risk_level_codes_np(probs)
        high_amount = col["high_amount"] > 0.5
        unusual_hour = col["unusual_hour"] > 0.5
        high_risk_payment = col["high_risk_payment"] > 0.5
        per_txn_ms = elapsed_ms / max(n, 1)

        results = []
        weights = self.ensemble_params.weights.cpu().numpy()
        with_explanation = self.config.ensemble.enable_explanation
        for i, rec in enumerate(records):
            model_predictions = {
                name: float(preds[i, j])
                for j, name in enumerate(MODEL_NAMES) if model_valid[j]
            }
            if with_explanation:
                factors = []
                if high_amount[i]:
                    factors.append("high_transaction_amount")
                if unusual_hour[i]:
                    factors.append("unusual_transaction_hour")
                if high_risk_payment[i]:
                    factors.append("high_risk_payment_method")
                if contrib_cols is not None:
                    contributions = {
                        name: float(contrib_cols[i, j])
                        for j, name in enumerate(MODEL_NAMES) if model_valid[j]
                    }
                else:
                    contributions = {
                        name: float(weights[j] * preds[i, j])
                        for j, name in enumerate(MODEL_NAMES) if model_valid[j]
                    }
                explanation = {
                    "model_contributions": contributions,
                    "key_factors": factors,
                    "rule_score": float(rule[i]),
                }
                if rules_only:
                    explanation["degraded"] = "rules_only"
            else:
                explanation = {}
            results.append({
                "transaction_id": str(rec.get("transaction_id", "")),
                "fraud_probability": float(probs[i]),
                "fraud_score": float(probs[i]),
                "risk_level": RISK_LEVEL_NAMES[int(risk[i])],
                "decision": DECISIONS[int(decisions[i])],
                "model_predictions": model_predictions,
                "confidence": float(conf[i]),
                "processing_time_ms": per_txn_ms,
                "explanation": explanation,
            })
        return results
