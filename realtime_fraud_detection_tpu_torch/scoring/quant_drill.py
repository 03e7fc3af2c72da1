"""Deterministic quantization drill: the score-delta oracle that gates the
quantized scoring plane.

Port of the JAX package's ``scoring/quant_drill.py``, with the same
configuration, phases and verdict, run on one device (``cuda`` unless the
configuration says otherwise):

1. **Score-delta oracle.** One seeded transaction stream through two
   ``TorchFraudScorer``s, the f32 plane (``QuantSettings()``) and the fully
   quantized one (``QuantSettings.full()``: weight-only int8 BERT and the
   GEMM-form trees and isolation forest), driven identically (the same
   generator seed, virtual clock and write-back interleaving). The largest
   fraud-score divergence must sit below the calibration-noise bound: how
   far the served bf16 compute already moves the ensemble score against f32
   compute on this stream's own tokens, with the f32 weights
   (``scoring/kernel_drill.py _noise_floor``, floored at
   ``noise_floor_abs``).
2. **Zero decision flips** between the two planes.
3. **Quality-protocol AUC.** Trees and isolation forest trained on a stream
   segment through the production assemble path, a held-out labeled
   segment scored by both planes: the AUCs within ``max_auc_delta``.
4. **GEMM-vs-gather oracle.** On the trained ensembles and a randomized
   one, on the drill's device, the GEMM form selects exactly the leaves of
   the pointer-chase descent, logits within summation-order slack.
5. **Bytes.** The int8 BERT branch serializes at least ``min_bytes_ratio``
   times smaller than f32 (the same arrays the JAX drill counts).
6. **Replay.** A second full run gives the same digest (sha256 over every
   number the gates read). Two devices round differently, so a digest is
   compared only with another run on the same device.

``models`` (a ``ScoringModels``, e.g. the JAX package's initial set through
``bridge.models_from_numpy``) replaces the seeded initial model set of both
sides; the trained trees and forest replace its trees and forest either way.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["QuantDrillConfig", "run_quant_drill", "compact_quant_summary"]


@dataclasses.dataclass
class QuantDrillConfig:
    seed: int = 11
    num_users: int = 800
    num_merchants: int = 160
    batch: int = 128
    n_train: int = 4_096        # trees / iforest training segment (protocol)
    n_batches: int = 16         # divergence / decision-flip stream
    eval_batches: int = 20      # held-out labeled AUC segment
    n_trees: int = 48
    tree_depth: int = 6
    tps: float = 200.0          # virtual arrival rate (clock advance)
    # gates
    noise_scale: float = 1.0    # quant divergence <= scale * bf16 noise floor
    noise_floor_abs: float = 1e-4   # resolution floor for the noise bound
    max_auc_delta: float = 2e-3
    min_bytes_ratio: float = 3.5
    leaf_logit_tol: float = 1e-4    # GEMM summation-order slack
    replay: bool = True
    device: str = "cuda"

    @classmethod
    def fast(cls) -> "QuantDrillConfig":
        """The CPU test sizes: every phase runs, batches stay small."""
        return cls(num_users=400, num_merchants=80, batch=64,
                   n_train=1_536, n_batches=8, eval_batches=10, n_trees=24)


def _make_side(cfg: QuantDrillConfig, quantized: bool, models=None):
    """One drill side: seeded generator + scorer (f32 or fully quantized),
    trees and isolation forest trained on its own identical stream segment
    through the production assemble path (deterministic, so both sides
    deploy the same f32 trees; only the BERT weight form and the tree
    kernels differ)."""
    from realtime_fraud_detection_tpu_torch.models.isolation_forest import (
        IsolationForestTrainer,
    )
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import ScorerConfig
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
    from realtime_fraud_detection_tpu_torch.training.gbdt import GBDTTrainer
    from realtime_fraud_detection_tpu_torch.utils.config import Config, QuantSettings

    quant = QuantSettings.full() if quantized else QuantSettings()
    gen = TransactionGenerator(num_users=cfg.num_users,
                               num_merchants=cfg.num_merchants, seed=cfg.seed)
    scorer = TorchFraudScorer(Config(quant=quant), models=models,
                              scorer_config=ScorerConfig(), seed=cfg.seed,
                              device=cfg.device)
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())

    xs, ys = [], []
    done, ts = 0, 0.0
    while done < cfg.n_train:
        n = min(cfg.batch, cfg.n_train - done)
        recs = gen.generate_batch(n)
        batch = scorer.assemble(recs, now=ts)
        xs.append(np.asarray(batch.features))
        ys.append(np.asarray([bool(r.get("is_fraud")) for r in recs], np.float32))
        for r in recs:   # serving's write-back: later segments see state
            scorer.velocity.update(str(r.get("user_id", "")),
                                   float(r.get("amount", 0.0)), ts)
        done += n
        ts += n / cfg.tps
    x, y = np.concatenate(xs), np.concatenate(ys)
    trees = GBDTTrainer(n_estimators=cfg.n_trees, max_depth=cfg.tree_depth,
                        seed=cfg.seed).fit(x, y)
    iforest = IsolationForestTrainer(n_estimators=cfg.n_trees,
                                     seed=cfg.seed + 1).fit(x[y < 0.5][:4000])
    # single-threaded: no batch is in flight during the swap
    scorer.set_models(dataclasses.replace(scorer.models, trees=trees,
                                          iforest=iforest))
    return gen, scorer, ts


def _score_stream(cfg: QuantDrillConfig, gen, scorer, ts: float,
                  n_batches: int, keep_tokens: int = 0,
                  ) -> Tuple[Dict[str, Any], float]:
    """Drive ``n_batches`` through the scorer on the virtual clock; returns
    host-side probabilities, decisions and labels (and the first
    ``keep_tokens`` token batches for the noise bound)."""
    probs: List[float] = []
    decisions: List[str] = []
    labels: List[float] = []
    tokens: List[Tuple[np.ndarray, np.ndarray]] = []
    for i in range(n_batches):
        recs = gen.generate_batch(cfg.batch)
        batch = scorer.assemble(recs, now=ts)
        if i < keep_tokens:
            tokens.append((np.asarray(batch.token_ids), np.asarray(batch.token_mask)))
        results = scorer.finalize(scorer.dispatch_assembled(batch, recs), now=ts)
        probs.extend(r["fraud_probability"] for r in results)
        decisions.extend(r["decision"] for r in results)
        labels.extend(float(bool(r.get("is_fraud"))) for r in recs)
        ts += cfg.batch / cfg.tps
    return {
        "probs": np.asarray(probs, np.float64),
        "decisions": decisions,
        "labels": np.asarray(labels, np.float32),
        "tokens": tokens,
    }, ts


@torch.no_grad()
def _tree_oracle(cfg: QuantDrillConfig, scorer) -> Dict[str, Any]:
    """GEMM-vs-gather equivalence on the trained ensembles plus a
    randomized one, on the scorer's device: exact leaf equality, logits
    inside tolerance."""
    from realtime_fraud_detection_tpu_torch.models.trees import (
        TreeEnsemble,
        descend_complete_trees,
        gemm_leaf_index,
        tree_ensemble_logits,
    )
    from realtime_fraud_detection_tpu_torch.training.neural import exact_f32

    dev = scorer.device
    rng = np.random.default_rng(cfg.seed + 7)
    feat_dim = int(scorer.sc.feature_dim)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    x = f32(rng.standard_normal((cfg.batch, feat_dim)))
    out: Dict[str, Any] = {}
    trained = scorer.models.trees
    cases = {"trained_gbdt": (trained.feature, trained.threshold),
             "trained_iforest": (scorer.models.iforest.feature,
                                 scorer.models.iforest.threshold)}
    n_int = int(trained.feature.shape[1])
    depth = int(np.log2(n_int + 1))
    rf = torch.as_tensor(rng.integers(0, feat_dim, (8, n_int)).astype(np.int32),
                         device=dev)
    inf_mask = rng.random((8, n_int)) < 0.3
    rt = f32(np.where(inf_mask, np.inf,
                      rng.standard_normal((8, n_int)).astype(np.float32)))
    cases["randomized"] = (rf, rt)

    leaves_equal = True
    with exact_f32():
        for name, (feature, threshold) in cases.items():
            gather = descend_complete_trees(feature, threshold, x)
            gemm = gemm_leaf_index(feature, threshold, x)
            eq = bool(torch.equal(gather, gemm))
            out[name] = {"leaves_equal": eq}
            leaves_equal = leaves_equal and eq

        rand_ens = TreeEnsemble(feature=rf, threshold=rt,
                                leaf=f32(rng.standard_normal((8, 2 ** depth))),
                                base_score=f32(0.1))
        logit_delta = 0.0
        for ens in (trained, rand_ens):
            lg = tree_ensemble_logits(ens, x, kernel="gather")
            lm = tree_ensemble_logits(ens, x, kernel="gemm")
            logit_delta = max(logit_delta, float((lg - lm).abs().max()))
    out["max_logit_delta"] = logit_delta
    out["leaves_equal"] = leaves_equal
    return out


def _run_once(cfg: QuantDrillConfig, models=None) -> Dict[str, Any]:
    from realtime_fraud_detection_tpu_torch.models.quant import (
        bert_param_bytes,
        is_quantized_bert,
        quant_error_bound,
    )
    from realtime_fraud_detection_tpu_torch.scoring.kernel_drill import _noise_floor
    from realtime_fraud_detection_tpu_torch.training.blend_eval import _auc

    summary: Dict[str, Any] = {
        "drill": "quantization",
        "seed": cfg.seed,
        "batch": cfg.batch,
        "n_batches": cfg.n_batches,
        "device": cfg.device,
        "checks": {},
    }
    checks = summary["checks"]

    gen_f, scorer_f, ts_f = _make_side(cfg, quantized=False, models=models)
    gen_q, scorer_q, ts_q = _make_side(cfg, quantized=True, models=models)
    assert ts_f == ts_q

    # param bytes: the payload each replica carries
    bytes_f32 = bert_param_bytes(scorer_f.models.bert)
    bytes_q = bert_param_bytes(scorer_q.models.bert)
    ratio = bytes_f32 / max(bytes_q, 1)
    summary["param_bytes"] = {
        "bert_f32": bytes_f32, "bert_int8": bytes_q,
        "ratio": round(ratio, 3),
        "weight_reconstruction_bound": round(
            quant_error_bound(scorer_q.models.bert), 6),
    }
    checks["bert_is_quantized"] = is_quantized_bert(scorer_q.models.bert)
    checks["bytes_ratio_ge_min"] = ratio >= cfg.min_bytes_ratio

    # ---------------------------------- phase 1: divergence + decision flips
    keep = min(4, cfg.n_batches)
    side_f, ts_f = _score_stream(cfg, gen_f, scorer_f, ts_f, cfg.n_batches,
                                 keep_tokens=keep)
    side_q, ts_q = _score_stream(cfg, gen_q, scorer_q, ts_q, cfg.n_batches)
    div = np.abs(side_f["probs"] - side_q["probs"])
    flips = sum(a != b for a, b in zip(side_f["decisions"], side_q["decisions"]))
    noise = _noise_floor(scorer_f.models, scorer_f.bert_config, side_f["tokens"],
                         scorer_f.ensemble_params.weights,
                         scorer_f.effective_model_valid(), cfg.noise_floor_abs)
    summary["divergence"] = {
        "max": float(div.max()),
        "mean": float(div.mean()),
        "p99": float(np.percentile(div, 99)),
        "n_txn": int(div.size),
        "noise_floor": noise,
        "noise_scale": cfg.noise_scale,
        "decision_flips": int(flips),
    }
    checks["divergence_below_noise"] = float(div.max()) <= cfg.noise_scale * noise["bound"]
    checks["zero_decision_flips"] = flips == 0
    scorer_q.record_quant_gate(bool(checks["divergence_below_noise"]
                                    and checks["zero_decision_flips"]))

    # --------------------------------------- phase 2: quality-protocol AUC
    eval_f, _ = _score_stream(cfg, gen_f, scorer_f, ts_f, cfg.eval_batches)
    eval_q, _ = _score_stream(cfg, gen_q, scorer_q, ts_q, cfg.eval_batches)
    auc_f = _auc(eval_f["labels"], eval_f["probs"])
    auc_q = _auc(eval_q["labels"], eval_q["probs"])
    summary["quality"] = {
        "auc_f32": round(auc_f, 6),
        "auc_quant": round(auc_q, 6),
        "auc_delta": round(abs(auc_f - auc_q), 6),
        "eval_txn": int(eval_f["labels"].size),
        "fraud_rate": round(float(eval_f["labels"].mean()), 4),
        "max_auc_delta": cfg.max_auc_delta,
    }
    checks["auc_unchanged"] = abs(auc_f - auc_q) <= cfg.max_auc_delta
    scorer_q.record_quant_gate(bool(checks["auc_unchanged"]))

    # ------------------------------------------ phase 3: GEMM-vs-gather
    oracle = _tree_oracle(cfg, scorer_f)
    summary["tree_oracle"] = oracle
    checks["gemm_leaves_identical"] = oracle["leaves_equal"]
    checks["gemm_logits_within_tol"] = oracle["max_logit_delta"] <= cfg.leaf_logit_tol

    # served-mode truth (quant_snapshot reads the live parameters)
    summary["modes"] = {"f32": scorer_f.quant_snapshot()["modes"],
                        "quant": scorer_q.quant_snapshot()["modes"]}

    summary["passed"] = all(bool(v) for v in checks.values())
    return summary


def _digest(summary: Dict[str, Any]) -> str:
    """Replay fingerprint over every number the gates read."""
    payload = json.dumps(
        {k: summary.get(k) for k in ("divergence", "quality", "tree_oracle",
                                     "param_bytes", "checks")},
        sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()


def run_quant_drill(cfg: Optional[QuantDrillConfig] = None,
                    models=None) -> Dict[str, Any]:
    cfg = cfg or QuantDrillConfig()
    summary = _run_once(cfg, models)
    summary["digest"] = _digest(summary)
    if cfg.replay:
        second_digest = _digest(_run_once(cfg, models))
        summary["replay"] = {"digest": second_digest,
                             "bit_identical": second_digest == summary["digest"]}
        summary["checks"]["replay_bit_identical"] = second_digest == summary["digest"]
        summary["passed"] = all(bool(v) for v in summary["checks"].values())
    return summary


def compact_quant_summary(summary: Dict[str, Any]) -> Dict[str, Any]:
    """Single-line verdict (under 2 KB)."""
    div = summary.get("divergence") or {}
    q = summary.get("quality") or {}
    pb = summary.get("param_bytes") or {}
    return {
        "drill": "quantization",
        "passed": summary.get("passed", False),
        "device": summary.get("device"),
        "checks": {k: bool(v) for k, v in (summary.get("checks") or {}).items()},
        "max_divergence": div.get("max"),
        "noise_bound": (div.get("noise_floor") or {}).get("bound"),
        "decision_flips": div.get("decision_flips"),
        "auc_f32": q.get("auc_f32"),
        "auc_quant": q.get("auc_quant"),
        "auc_delta": q.get("auc_delta"),
        "bytes_ratio": pb.get("ratio"),
        "digest": (summary.get("digest") or "")[:16],
    }
