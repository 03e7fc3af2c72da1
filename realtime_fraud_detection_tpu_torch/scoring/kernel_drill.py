"""Deterministic kernel drill: the port's parity oracle for its hand-written
kernel plane (``ops/`` + ``KernelSettings``).

The port of the JAX package's ``scoring/kernel_drill.py``, with the same
configuration, phases and verdict, run on one device (``cuda`` unless the
configuration says otherwise; on the CPU both sides run the kernels' plain
versions, so the drill checks its own arithmetic and plumbing there):

1. **Score-delta oracle.** One seeded transaction stream through TWO
   ``TorchFraudScorer``s, both serving the quantized plane
   (``QuantSettings.full()``): one with the kernels off (plain PyTorch),
   one with every per-site kernel on (``KernelSettings.full()``: the fused
   dequant-matmul and embedding rows, the fused epilogue, flash attention)
   or, with ``mega``, the persistent megakernel (``KernelSettings.mega()``).
   The largest fraud-score divergence must sit below the calibration-noise
   bound: how far the served bf16 compute already moves the ensemble score
   against f32 compute, measured on this stream's own tokens
   (``_noise_floor``), floored at ``noise_floor_abs``.
2. **Zero decision flips** between the two sides.
3. **Masked-rung equality.** At every QoS ladder rung
   (``qos/ladder.py``) both sides serve the same decisions and risk levels,
   probabilities within the bound, and the ``rules_only`` rung bit-exactly.
4. **Per-kernel oracle.** Each kernel's wrapper against its plain version
   on the served parameters: dequant-matmul (bf16 within rounding scale,
   f32 near-exact), embedding rows exact, the epilogue across all three
   strategies (ladders exact; through the JAX API's per-row mask and as
   the main path calls it, at each drilled rung), flash attention within
   f32 softmax slack.
   With ``mega``, the megakernel against its plain version on a real
   assembled batch and the GEMM-form tree leaves exactly equal to the
   pointer-chase descent.
5. **Dispatch.** Every per-site kernel dispatched with zero fallbacks; with
   ``mega`` the per-site counters at zero and one launch per batch.
6. **Replay.** A second full run must give the same digest (sha256 over
   every number the gates read).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["KernelDrillConfig", "run_kernel_drill", "compact_kernel_summary"]


@dataclasses.dataclass
class KernelDrillConfig:
    seed: int = 13
    num_users: int = 600
    num_merchants: int = 120
    batch: int = 96
    n_batches: int = 10         # divergence / decision-flip stream
    tps: float = 200.0          # virtual arrival rate (clock advance)
    # gates
    noise_scale: float = 1.0    # kernel divergence <= scale * bf16 noise bound
    noise_floor_abs: float = 1e-4   # resolution floor for the noise bound
    matmul_rel_tol: float = 0.05    # bf16 dequant-matmul: rounding scale,
    #                                 relative to the reference magnitude
    matmul_f32_tol: float = 1e-5    # f32 compute: summation-order slack only
    rows_tol: float = 0.0           # per-row dequant: one widen + mul, exact
    epilogue_prob_tol: float = 1e-6
    attention_tol: float = 5e-5     # online-vs-full softmax f32 slack
    replay: bool = True
    # the kernel side serves the persistent megakernel (KernelSettings.mega())
    # instead of the per-site chain, and the oracle gains its pins
    mega: bool = False
    # megakernel vs its plain version where both run the same operations (the
    # CPU); the CUDA kernel's bf16 tensor-core products round in another
    # order than its plain version, so on the card it is held to the noise
    # bound instead (see _mega_oracle)
    mega_ref_tol: float = 1e-6
    # QoS rung subset for phase 3 (None = every LADDER_LEVELS rung)
    rung_levels: Optional[Tuple[int, ...]] = None
    device: str = "cuda"

    @classmethod
    def fast(cls) -> "KernelDrillConfig":
        """Tier-1 smoke sizes: every phase runs, batches stay small."""
        return cls(num_users=300, num_merchants=60, batch=32, n_batches=2,
                   rung_levels=(0, 3))


def _make_side(cfg: KernelDrillConfig, kernels_on: bool):
    """One drill side: seeded generator + scorer. Both sides serve the
    quantized plane (int8 BERT + GEMM-form trees), so the only difference
    is the kernel plane, the thing under test."""
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import ScorerConfig
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
    from realtime_fraud_detection_tpu_torch.utils.config import (
        Config,
        KernelSettings,
        QuantSettings,
    )

    kernels = KernelSettings()
    if kernels_on:
        kernels = KernelSettings.mega() if cfg.mega else KernelSettings.full()
    gen = TransactionGenerator(num_users=cfg.num_users,
                               num_merchants=cfg.num_merchants, seed=cfg.seed)
    scorer = TorchFraudScorer(Config(quant=QuantSettings.full(), kernels=kernels),
                              scorer_config=ScorerConfig(), seed=cfg.seed,
                              device=cfg.device)
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    return gen, scorer


def _score_stream(cfg: KernelDrillConfig, gen, scorer, ts: float,
                  n_batches: int, keep_tokens: int = 0,
                  ) -> Tuple[Dict[str, Any], float]:
    """Drive ``n_batches`` through the scorer on the virtual clock."""
    probs: List[float] = []
    decisions: List[str] = []
    risks: List[str] = []
    tokens: List[Tuple[np.ndarray, np.ndarray]] = []
    for i in range(n_batches):
        recs = gen.generate_batch(cfg.batch)
        batch = scorer.assemble(recs, now=ts)
        if i < keep_tokens:
            tokens.append((np.asarray(batch.token_ids), np.asarray(batch.token_mask)))
        results = scorer.finalize(scorer.dispatch_assembled(batch, recs), now=ts)
        probs.extend(r["fraud_probability"] for r in results)
        decisions.extend(r["decision"] for r in results)
        risks.extend(r["risk_level"] for r in results)
        ts += cfg.batch / cfg.tps
    return {"probs": np.asarray(probs, np.float64), "decisions": decisions,
            "risks": risks, "tokens": tokens}, ts


def _noise_floor(models, bert_config, tokens: Sequence[Tuple[Any, Any]],
                 weights, valid, noise_floor_abs: float = 1e-4) -> Dict[str, float]:
    """The calibration-noise bound: how far the served bf16 compute moves
    the ensemble score against f32 compute. The BERT branch's largest gap
    between ``bert_predict`` at bf16 and at f32 on ``tokens`` (pairs of ids
    and mask), on the models' own device and weights, times the branch's
    share of the blend (``MODEL_NAMES`` index 2 of ``weights`` under
    ``valid``), floored at ``noise_floor_abs``."""
    from realtime_fraud_detection_tpu_torch.models.bert import bert_predict

    device = models.trees.threshold.device
    branch_delta = 0.0
    for ids, mask in tokens:
        ids_t = torch.as_tensor(np.asarray(ids), device=device)
        mask_t = torch.as_tensor(np.asarray(mask), device=device)
        a = bert_predict(models.bert, ids_t, mask_t, bert_config,
                         compute_dtype=torch.bfloat16)
        b = bert_predict(models.bert, ids_t, mask_t, bert_config,
                         compute_dtype=torch.float32)
        branch_delta = max(branch_delta, float((a - b).abs().max()))
    w = np.asarray(torch.as_tensor(weights).cpu(), np.float64) * np.asarray(valid, bool)
    w_bert = float(w[2] / max(w.sum(), 1e-9))      # MODEL_NAMES order
    bound = max(branch_delta * w_bert, noise_floor_abs)
    return {"bert_branch_bf16_delta": branch_delta,
            "bert_blend_weight": round(w_bert, 4),
            "bound": bound}


def _rung_phase(cfg: KernelDrillConfig, gen_a, scorer_a, gen_b, scorer_b,
                ts: float, bound: float) -> Tuple[Dict[str, Any], float]:
    """Masked-blend equality at every QoS ladder rung: one batch per rung
    on both sides, decisions and risk exactly equal, probabilities within
    the noise bound, and the rules_only rung bit-exact."""
    from realtime_fraud_detection_tpu_torch.qos.ladder import LADDER_LEVELS
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import MODEL_NAMES

    rungs: Dict[str, Any] = {}
    for level, rung in enumerate(LADDER_LEVELS):
        if cfg.rung_levels is not None and level not in cfg.rung_levels:
            continue
        mask = np.asarray([n not in rung.dropped_branches for n in MODEL_NAMES], bool)
        for scorer in (scorer_a, scorer_b):
            scorer.set_degradation(None if level == 0 else mask,
                                   rules_only=rung.rules_only, level=level)
        side_a, _ = _score_stream(cfg, gen_a, scorer_a, ts, 1)
        side_b, ts = _score_stream(cfg, gen_b, scorer_b, ts, 1)
        div = float(np.abs(side_a["probs"] - side_b["probs"]).max())
        flips = sum(x != y for x, y in zip(side_a["decisions"], side_b["decisions"]))
        risk_flips = sum(x != y for x, y in zip(side_a["risks"], side_b["risks"]))
        ok = flips == 0 and risk_flips == 0 and (
            div == 0.0 if rung.rules_only else div <= bound)
        rungs[rung.name] = {"max_divergence": div, "decision_flips": int(flips),
                            "risk_flips": int(risk_flips), "exact": div == 0.0,
                            "ok": bool(ok)}
    for scorer in (scorer_a, scorer_b):
        scorer.set_degradation(None, rules_only=False, level=0)
    return rungs, ts


def _kernel_oracle(cfg: KernelDrillConfig, scorer) -> Dict[str, Any]:
    """Each kernel's wrapper against its plain version on the served
    parameters (plus randomized operands), on the scorer's device."""
    from realtime_fraud_detection_tpu_torch.ops import (
        attention_reference,
        dequant_matmul,
        dequant_matmul_reference,
        dequant_rows,
        dequant_rows_reference,
        epilogue_reference,
        flash_attention,
        fused_epilogue,
    )
    from realtime_fraud_detection_tpu_torch.ops.epilogue import (
        epilogue_packed,
        epilogue_packed_reference,
        packed_columns,
    )
    from realtime_fraud_detection_tpu_torch.qos.ladder import LADDER_LEVELS
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import MODEL_NAMES

    dev = scorer.device
    rng = np.random.default_rng(cfg.seed + 23)
    out: Dict[str, Any] = {}
    layer = scorer.models.bert["layers"][0]
    h = int(scorer.bert_config.hidden_size)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    # --- fused dequant-matmul on the served int8 q / ffn1 weights
    x = f32(rng.standard_normal((cfg.batch, h)))
    mm: Dict[str, Any] = {}
    for name in ("q", "ffn1"):
        p = layer[name]
        for cd, key in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            ref = dequant_matmul_reference(x, p["qw"], p["scale"], p["b"], cd).float()
            got = dequant_matmul(x, p["qw"], p["scale"], p["b"], compute_dtype=cd)
            delta = float((got - ref).abs().max())
            scale = max(1.0, float(ref.abs().max()))
            k = f"{key}_rel_delta"
            mm[k] = max(mm.get(k, 0.0), delta / scale)
    mm["ok"] = (mm["bf16_rel_delta"] <= cfg.matmul_rel_tol
                and mm["f32_rel_delta"] <= cfg.matmul_f32_tol)
    out["dequant_matmul"] = mm

    # --- per-row embedding dequant on served word_emb rows
    emb = scorer.models.bert["word_emb"]
    idx = torch.as_tensor(rng.integers(0, emb["qe"].shape[0], (64,)).astype(np.int32),
                          device=dev)
    rows_delta = float((dequant_rows(emb["qe"], emb["scale"], idx=idx)
                        - dequant_rows_reference(emb["qe"], emb["scale"], idx=idx))
                       .abs().max())
    out["dequant_rows"] = {"max_delta": rows_delta, "ok": rows_delta <= cfg.rows_tol}

    # --- fused epilogue across all three strategies: through the JAX API's
    # per-row mask, and as the main path calls it (the rung's flags by value,
    # one validity byte a row) at every drilled rung with a learned branch
    base = scorer.ensemble_params
    preds = f32(rng.uniform(0, 1, (cfg.batch, 5)))
    valid = torch.as_tensor(rng.uniform(0, 1, (cfg.batch, 5)) > 0.25, device=dev)
    rule = f32(rng.uniform(0, 1, (cfg.batch,)))
    row_valid = torch.as_tensor(rng.uniform(0, 1, (cfg.batch,)) > 0.1, device=dev)
    levels = cfg.rung_levels if cfg.rung_levels is not None else range(len(LADDER_LEVELS))
    rungs = [tuple(n not in LADDER_LEVELS[i].dropped_branches for n in MODEL_NAMES)
             for i in levels if not LADDER_LEVELS[i].rules_only]
    cols = packed_columns(5)
    ladders = [2, 3, cols["rule_ladder"].start, cols["rule_ladder"].start + 1]
    values = [c for c in range(cols["rule_ladder"].start) if c not in ladders]
    ep_delta, ep_exact, pk_delta, pk_exact = 0.0, True, 0.0, True
    for strat in range(3):
        params = dataclasses.replace(base, strategy=strat)
        ref = epilogue_reference(preds, valid, rule, params)
        got = fused_epilogue(preds, valid, rule, params)
        ep_delta = max(ep_delta, float((got["fraud_probability"]
                                        - ref["fraud_probability"]).abs().max()))
        ep_exact = ep_exact and all(
            torch.equal(got[k], ref[k])
            for k in ("decision", "risk_level", "rule_decision", "rule_risk"))
        for rung in rungs:
            got = epilogue_packed(preds, rule, params, model_valid=rung,
                                  row_valid=row_valid)
            ref = epilogue_packed_reference(preds, rule, params, model_valid=rung,
                                            row_valid=row_valid)
            pk_delta = max(pk_delta, float((got[:, values] - ref[:, values])
                                           .abs().max()))
            pk_exact = pk_exact and torch.equal(got[:, ladders], ref[:, ladders])
    out["epilogue"] = {"max_prob_delta": ep_delta, "ladders_exact": bool(ep_exact),
                       "packed_max_delta": pk_delta, "packed_ladders_exact": bool(pk_exact),
                       "ok": bool(ep_exact and ep_delta <= cfg.epilogue_prob_tol
                                  and pk_exact and pk_delta <= cfg.epilogue_prob_tol)}

    # --- flash attention vs reference (f32 operands, the drill's text shape)
    b, heads = 4, int(scorer.bert_config.num_heads)
    seq, d = int(scorer.sc.text_len), int(scorer.bert_config.head_dim)
    qkv = [f32(rng.standard_normal((b, heads, seq, d))) for _ in range(3)]
    mask = torch.as_tensor(rng.uniform(0, 1, (b, seq)) > 0.1, device=dev)
    att_delta = float((flash_attention(*qkv, mask) - attention_reference(*qkv, mask))
                      .abs().max())
    out["attention"] = {"max_delta": att_delta, "ok": att_delta <= cfg.attention_tol}
    return out


def _device_batch(batch, n: int, device):
    """A host batch padded to its bucket and packed, on ``device``: the
    kernel's byte-view batch and the plain version's bool batch."""
    from realtime_fraud_detection_tpu_torch.core.batching import pad_to_bucket
    from realtime_fraud_detection_tpu_torch.core.packing import pack_tree, unpack_tree

    padded, mask, _ = pad_to_bucket(batch, n)
    blobs, spec = pack_tree(dataclasses.replace(padded, valid=mask))
    dev = {k: torch.from_numpy(v).to(device) for k, v in blobs.items()}
    return unpack_tree(dev, spec, keep_u8=True), unpack_tree(dev, spec)


def _mega_oracle(cfg: KernelDrillConfig, gen, scorer, ts: float,
                 bound: float) -> Dict[str, Any]:
    """The megakernel against its plain version on a real assembled batch
    of the served parameters (decision and risk ladders exactly equal,
    probabilities within ``mega_ref_tol`` where both run the same
    operations, within the noise ``bound`` where the kernel's tensor cores
    round bf16 products in another order), and the GEMM-form tree leaf
    indices exactly equal to the pointer-chase descent."""
    from realtime_fraud_detection_tpu_torch.models.trees import (
        descend_complete_trees,
        gemm_leaf_index,
    )
    from realtime_fraud_detection_tpu_torch.ops import (
        fused_megakernel,
        megakernel_reference,
    )
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import OUT_COLUMNS

    out: Dict[str, Any] = {}
    recs = gen.generate_batch(cfg.batch)
    raw, plain = _device_batch(scorer.assemble(recs, now=ts), len(recs), scorer.device)
    mv = tuple(bool(v) for v in scorer.effective_model_valid())
    kw = dict(mega_valid=mv, bert_config=scorer.bert_config,
              compute_dtype=scorer.compute_dtype)
    n = len(recs)
    ref = megakernel_reference(scorer.models, plain, scorer.ensemble_params, **kw)[:n]
    got = fused_megakernel(scorer.models, raw, scorer.ensemble_params, **kw)[:n]
    prob_delta = float((got[:, 0].double() - ref[:, 0].double()).abs().max())
    cols = [OUT_COLUMNS.index("decision"), OUT_COLUMNS.index("risk_level")]
    ladders_exact = bool(torch.equal(got[:, cols], ref[:, cols]))
    tol = cfg.mega_ref_tol if scorer.device.type == "cpu" else max(cfg.mega_ref_tol, bound)
    out["reference"] = {"max_prob_delta": prob_delta, "tolerance": tol,
                        "ladders_exact": ladders_exact,
                        "ok": bool(ladders_exact and prob_delta <= tol)}

    rng = np.random.default_rng(cfg.seed + 31)
    x = torch.as_tensor(rng.standard_normal((cfg.batch, int(scorer.sc.feature_dim)))
                        .astype(np.float32), device=scorer.device)
    leaves: Dict[str, bool] = {}
    for name, ens in (("trees", scorer.models.trees),
                      ("iforest", scorer.models.iforest)):
        leaves[name] = bool(torch.equal(
            gemm_leaf_index(ens.feature, ens.threshold, x),
            descend_complete_trees(ens.feature, ens.threshold, x)))
    out["gemm_tree_leaves"] = {**{f"{k}_exact": v for k, v in leaves.items()},
                               "ok": all(leaves.values())}
    return out


def _run_once(cfg: KernelDrillConfig) -> Dict[str, Any]:
    summary: Dict[str, Any] = {"drill": "kernels", "seed": cfg.seed,
                               "batch": cfg.batch, "n_batches": cfg.n_batches,
                               "mega": cfg.mega, "device": cfg.device, "checks": {}}
    checks = summary["checks"]

    gen_a, scorer_a = _make_side(cfg, kernels_on=False)
    gen_b, scorer_b = _make_side(cfg, kernels_on=True)
    ts = 0.0

    # ---------------------------------- phase 1: divergence + decision flips
    keep = min(4, cfg.n_batches)
    side_a, _ = _score_stream(cfg, gen_a, scorer_a, ts, cfg.n_batches, keep_tokens=keep)
    side_b, ts = _score_stream(cfg, gen_b, scorer_b, ts, cfg.n_batches)
    div = np.abs(side_a["probs"] - side_b["probs"])
    flips = sum(a != b for a, b in zip(side_a["decisions"], side_b["decisions"]))
    noise = _noise_floor(scorer_a.models, scorer_a.bert_config, side_a["tokens"],
                         scorer_a.ensemble_params.weights,
                         scorer_a.effective_model_valid(), cfg.noise_floor_abs)
    bound = cfg.noise_scale * noise["bound"]
    summary["divergence"] = {
        "max": float(div.max()), "mean": float(div.mean()),
        "p99": float(np.percentile(div, 99)), "n_txn": int(div.size),
        "noise_floor": noise, "noise_scale": cfg.noise_scale,
        "decision_flips": int(flips),
    }
    checks["divergence_below_noise"] = float(div.max()) <= bound
    checks["zero_decision_flips"] = flips == 0

    # --------------------------------- phase 2: masked-rung (QoS) equality
    rungs, ts = _rung_phase(cfg, gen_a, scorer_a, gen_b, scorer_b, ts, bound)
    summary["rungs"] = rungs
    checks["masked_rungs_equal"] = all(r["ok"] for r in rungs.values())
    checks["rules_only_exact"] = bool(rungs["rules_only"]["exact"])

    # ------------------------------------- phase 3: per-kernel oracle
    oracle = _kernel_oracle(cfg, scorer_b)
    summary["kernel_oracle"] = oracle
    checks["dequant_matmul_parity"] = bool(oracle["dequant_matmul"]["ok"])
    checks["dequant_rows_parity"] = bool(oracle["dequant_rows"]["ok"])
    checks["epilogue_parity"] = bool(oracle["epilogue"]["ok"])
    checks["attention_parity"] = bool(oracle["attention"]["ok"])

    # --------------------------- phase 3b (mega): megakernel oracle
    if cfg.mega:
        mega = _mega_oracle(cfg, gen_b, scorer_b, ts, bound)
        summary["mega_oracle"] = mega
        checks["mega_reference_parity"] = bool(mega["reference"]["ok"])
        checks["gemm_tree_leaves_exact"] = bool(mega["gemm_tree_leaves"]["ok"])

    # dispatch accounting: with the chain every site engaged with zero
    # fallbacks; with the megakernel its site carries every dispatch, the
    # per-site counters stay at zero and a batch is one launch
    snap = scorer_b.kernel_snapshot()
    summary["kernel_snapshot"] = snap
    summary["modes"] = {"off": scorer_a.kernel_snapshot()["modes"], "on": snap["modes"]}
    if cfg.mega:
        checks["mega_dispatched"] = snap["dispatch"].get("megakernel", 0) > 0
        checks["per_site_subsumed"] = all(
            v == 0 for s, v in snap["dispatch"].items() if s != "megakernel")
        checks["launches_collapsed_to_one"] = snap.get("launches_per_batch") == 1
    else:
        checks["all_sites_dispatched"] = all(
            v > 0 for s, v in snap["dispatch"].items() if s != "megakernel")
    checks["zero_fallbacks"] = all(v == 0 for v in snap["fallback"].values())

    summary["passed"] = all(bool(v) for v in checks.values())
    return summary


def _digest(summary: Dict[str, Any]) -> str:
    """Replay fingerprint over every number the gates read."""
    payload = json.dumps(
        {k: summary.get(k) for k in ("divergence", "rungs", "kernel_oracle",
                                     "mega_oracle", "kernel_snapshot", "checks")},
        sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()


def run_kernel_drill(cfg: Optional[KernelDrillConfig] = None) -> Dict[str, Any]:
    cfg = cfg or KernelDrillConfig()
    summary = _run_once(cfg)
    summary["digest"] = _digest(summary)
    if cfg.replay:
        second_digest = _digest(_run_once(cfg))
        summary["replay"] = {"digest": second_digest,
                             "bit_identical": second_digest == summary["digest"]}
        summary["checks"]["replay_bit_identical"] = second_digest == summary["digest"]
        summary["passed"] = all(bool(v) for v in summary["checks"].values())
    return summary


def compact_kernel_summary(summary: Dict[str, Any]) -> Dict[str, Any]:
    """Single-line verdict (under 2 KB)."""
    div = summary.get("divergence") or {}
    oracle = summary.get("kernel_oracle") or {}
    snap = summary.get("kernel_snapshot") or {}
    out = {
        "drill": "kernels",
        "passed": summary.get("passed", False),
        "device": summary.get("device"),
        "checks": {k: bool(v) for k, v in (summary.get("checks") or {}).items()},
        "max_divergence": div.get("max"),
        "noise_bound": (div.get("noise_floor") or {}).get("bound"),
        "decision_flips": div.get("decision_flips"),
        "matmul_bf16_rel": (oracle.get("dequant_matmul") or {}).get("bf16_rel_delta"),
        "attention_delta": (oracle.get("attention") or {}).get("max_delta"),
        "fallbacks": snap.get("fallback"),
        "digest": (summary.get("digest") or "")[:16],
    }
    if summary.get("mega"):
        mega = summary.get("mega_oracle") or {}
        out["mega"] = {
            "ref_delta": (mega.get("reference") or {}).get("max_prob_delta"),
            "leaves_exact": (mega.get("gemm_tree_leaves") or {}).get("ok"),
            "launches_per_batch": snap.get("launches_per_batch"),
        }
    return out
