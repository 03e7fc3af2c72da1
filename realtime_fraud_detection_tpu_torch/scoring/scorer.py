"""The device half of the streaming scorer.

Port of the device half of the JAX package's ``scoring/scorer.py
FraudScorer``: ``dispatch_assembled`` pads an assembled microbatch to its
bucket, packs it into the three transfer blobs, copies them to the card
from pinned host memory, launches the fused scorer and starts the copy of
the result matrix back into pinned host memory behind a CUDA event;
``finalize`` waits on that event and builds the response dicts. The kernel
plane's host-side accounting (``kernel_snapshot``) records per batch which
kernel sites the fused scorer dispatched, which fell back (the megakernel's
plan declining a batch, or f32 BERT weights leaving the int8 site no work),
and how many hand-written kernels the batch launched. Host assembly
(stores, tokenizer, ``assemble``), state write-back, pools, the mesh and
tracing are not part of this port yet.
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
from realtime_fraud_detection_tpu_torch.models.quant import (
    is_quantized_bert,
    quantize_bert_params,
)
from realtime_fraud_detection_tpu_torch.ops import (
    launch_counts,
    mega_launch_accounting,
    mega_plan,
)
from realtime_fraud_detection_tpu_torch.ops.attention import attention_supported
from realtime_fraud_detection_tpu_torch.ops.dequant_matmul import (
    matmul_supported,
    rows_supported,
)
from realtime_fraud_detection_tpu_torch.ops.megakernel import MegaParamArgs
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
from realtime_fraud_detection_tpu_torch.utils.config import VALID_KERNEL_SITES, Config


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
        self._kernel_counts: Dict[str, Dict[str, int]] = {
            "dispatch": {site: 0 for site in VALID_KERNEL_SITES},
            "fallback": {site: 0 for site in VALID_KERNEL_SITES},
        }
        # the most recent batch: the JAX package's program count (1 when
        # the megakernel served it) and the port's hand-written launches
        self._last_launches_per_batch = 0
        self._last_kernel_launches = 0
        self.set_models(models if models is not None else init_scoring_models(
            seed, bert_config, feature_dim=self.sc.feature_dim,
            node_dim=self.sc.node_dim))

    # ----------------------------------------------------------------- models
    def set_models(self, models: ScoringModels) -> None:
        """Swap the model set; with int8 BERT configured the weights are
        quantized on the host first (idempotent), then moved to the device.
        Raises when a per-site kernel the settings ask for does not take the
        configured widths (its wrapper would raise on every batch). This is
        the only way the scorer's models change: the megakernel's parameter
        arguments point into them and are rebuilt here."""
        if self.quant.bert_mode() == "int8":
            models = dataclasses.replace(
                models, bert=quantize_bert_params(models.bert))
        self._check_kernel_widths(models)
        self.models = models.to(self.device)
        self._mega_plans: Dict[int, Dict[str, Any]] = {}
        self._mega_args: Optional[MegaParamArgs] = None

    def _check_kernel_widths(self, models: ScoringModels) -> None:
        modes = self.kernels.site_modes()
        h = self.bert_config.hidden_size
        ffn = self.bert_config.intermediate_size
        if (modes["dequant_matmul"] == "cuda" and is_quantized_bert(models.bert)
                and not (matmul_supported(1, h, h) and matmul_supported(1, h, ffn)
                         and matmul_supported(1, ffn, h) and rows_supported(h))):
            raise ValueError(f"the dequant_matmul kernel does not take hidden {h}"
                             f" / FFN {ffn}")
        if (modes["attention"] == "flash"
                and not attention_supported(self.sc.text_len,
                                            self.bert_config.head_dim)):
            raise ValueError(
                f"the flash attention kernel does not take text length "
                f"{self.sc.text_len} / head width {self.bert_config.head_dim}")

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

    # ----------------------------------------------------------- kernel plane
    def kernel_static(self, size: int, model_valid=None) -> Dict[str, Any]:
        """The kernel selection the fused scorer takes for a ``size``-row
        batch. ``mega_valid`` is the QoS rung as a tuple of branch-validity
        booleans (``model_valid`` when given, the dispatch-time snapshot;
        else the current effective mask) when the megakernel is on and its
        plan admits the batch; None otherwise, which runs the per-site
        chain."""
        static = dict(self.kernels.static())
        mega_valid = None
        if static["megakernel"] == "cuda" and self._mega_plan(size)["supported"]:
            mv = (self.effective_model_valid() if model_valid is None
                  else np.asarray(model_valid))
            mega_valid = tuple(bool(v) for v in mv)
        static["mega_valid"] = mega_valid
        return static

    def _mega_plan(self, size: int) -> Dict[str, Any]:
        """The megakernel's shape plan for a ``size``-row batch (the typed
        graph, the only source of two-hop batches, is not ported). Kept per
        size until the models change."""
        plan = self._mega_plans.get(size)
        if plan is None:
            plan = self._mega_plans[size] = mega_plan(
                self.models, self.bert_config, b=size,
                text_len=self.sc.text_len, seq_len=self.sc.seq_len,
                feature_dim=self.sc.feature_dim, has_two_hop=False,
                fanout=self.sc.fanout)
        return plan

    def _mega_param_args(self) -> MegaParamArgs:
        """The megakernel's parameter arguments for the current models,
        built at the first batch the megakernel serves after ``set_models``
        and passed with every later one."""
        if self._mega_args is None:
            widths = (self.sc.text_len, self.sc.feature_dim, self.sc.seq_len,
                      self.sc.fanout)
            self._mega_args = MegaParamArgs(self.models, self.bert_config,
                                            self.compute_dtype, widths, self.device)
        return self._mega_args

    def _record_kernel_dispatch(self, size: int, model_valid,
                                mega_served: bool) -> None:
        """Host-side account of the kernel sites one ``size``-row batch
        under the rung ``model_valid`` dispatches. A batch the megakernel
        served runs one launch and touches no per-site counter; a declined
        one counts a megakernel fallback and the per-site chain. A per-site
        site counts as dispatched when its mode asks for the kernel (the
        widths were checked by ``set_models``); the int8 site also counts
        a fallback with f32 BERT weights, where the plain matmul runs."""
        if not self.kernels.enabled:
            return
        modes = self.kernels.site_modes()
        disp = self._kernel_counts["dispatch"]
        fall = self._kernel_counts["fallback"]
        if modes["megakernel"] == "cuda":
            disp["megakernel"] += 1
            if mega_served:
                self._last_launches_per_batch = 1
                return
            fall["megakernel"] += 1
        self._last_launches_per_batch = mega_launch_accounting(
            size, NUM_MODELS, mega_valid=tuple(bool(v) for v in model_valid),
        )["launches_per_batch_chain"]
        if modes["dequant_matmul"] == "cuda":
            disp["dequant_matmul"] += 1
            if not is_quantized_bert(self.models.bert):
                fall["dequant_matmul"] += 1
        if modes["epilogue"] == "cuda":
            disp["epilogue"] += 1
        if modes["attention"] == "flash":
            disp["attention"] += 1

    def kernel_snapshot(self) -> Dict[str, Any]:
        """Effective per-site modes, cumulative dispatch / fallback counts
        per site, and two launch counts of the most recent batch:
        ``launches_per_batch`` is the JAX package's program count (1 when
        the megakernel served, else the enabled branches + 2), kept equal
        to its gauge; ``kernel_launches`` is the port's own count of
        hand-written kernel launches (0 on the CPU, where the plain
        versions run)."""
        return {
            "modes": self.kernels.site_modes(),
            "dispatch": dict(self._kernel_counts["dispatch"]),
            "fallback": dict(self._kernel_counts["fallback"]),
            "launches_per_batch": self._last_launches_per_batch,
            "kernel_launches": self._last_kernel_launches,
        }

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
        padded, mask, size = pad_to_bucket(batch, n)
        padded = dataclasses.replace(padded, valid=mask)
        blobs, spec = pack_tree(padded)
        dev_blobs = {name: self._to_device(arr) for name, arr in blobs.items()}
        mv = self.effective_model_valid()
        static = self.kernel_static(size, mv)
        self._record_kernel_dispatch(size, mv,
                                     mega_served=static["mega_valid"] is not None)
        before = sum(launch_counts().values())
        mega_args = self._mega_param_args() if static["mega_valid"] is not None else None
        out = score_fused_packed(
            self.models, dev_blobs, spec, self.ensemble_params,
            self._to_device(mv), bert_config=self.bert_config,
            compute_dtype=self.compute_dtype, param_args=mega_args,
            **self.quant.static(), **static)
        self._last_kernel_launches = sum(launch_counts().values()) - before
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
