"""Production blend selection: train every branch, admit by measurement.

Port of the JAX package's ``training/blend_eval.py``, the protocol behind
``quality-eval``:

1. **Stream-matched data.** Train / validation / test segments are
   consecutive windows of one simulated stream pushed through the serving
   assemble path (``TorchFraudScorer.assemble``: live velocity, history,
   graph and token state), so every branch trains and evaluates on the
   tensors serving builds.
2. **Per-branch training.** Trees (``GBDTTrainer``, host), isolation forest
   (host), class-weighted LSTM / text / GNN (``NeuralTrainer`` on the card
   unless ``device="cpu"``), each neural branch then Platt-calibrated on
   validation with (a, b) folded into its head (``training/calibrate.py``).
3. **Serving-parity blending.** Candidate blends run through the serving
   ``combine_predictions`` (``ensemble/combine.py blend_branch_scores``), so
   an accepted blend is a deployable ``model_valid`` + weights setting.
4. **A/B-gated admission.** From the production pair (trees + isolation
   forest), each remaining branch is admitted only if the validation blend
   AUC does not regress, its weight chosen on validation from the
   ``weight_scales`` of its configured weight; the stacked combiner then
   competes with the weighted average. The held-out test segment is scored
   once, with a paired bootstrap CI on the AUC delta against the pair.
5. **Operating point.** The alert threshold maximises recall on validation
   under a precision floor (default 0.94), then is reported on test.

``run_blend_eval`` returns the evidence dict, with the JAX protocol's keys
(the artifact ``serve --quality-artifact`` reads); with ``checkpoint_dir`` it
saves the trained, calibrated branches as a port checkpoint with the JAX
protocol's metadata keys. Trees and isolation forest are scored on the host,
so their scores do not depend on the device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Tuple

import numpy as np

if TYPE_CHECKING:  # the models load lazily at run time
    from realtime_fraud_detection_tpu_torch.models.bert import BertConfig

# branch order must match scoring.pipeline.MODEL_NAMES
_BASELINE = ("xgboost_primary", "isolation_forest")


def _default_bert() -> "BertConfig":
    """The artifact's text-branch architecture."""
    from realtime_fraud_detection_tpu_torch.models.bert import BertConfig

    return BertConfig(hidden_size=128, num_layers=2, num_heads=4,
                      intermediate_size=512)


@dataclasses.dataclass
class BlendEvalConfig:
    """Protocol parameters: the JAX protocol's defaults."""

    num_users: int = 2000
    num_merchants: int = 500
    seed: int = 3
    batch_size: int = 256
    train_batches: int = 96
    # validation sizes the admission decisions and the Platt fits
    val_batches: int = 24
    test_batches: int = 48
    # branch training
    n_trees: int = 40
    tree_depth: int = 5
    iforest_trees: int = 100
    lstm_epochs: int = 6
    lstm_hidden: int = 128
    text_epochs: int = 2
    gnn_epochs: int = 3
    text_len: int = 32
    tokenizer: str = "wordpiece"
    bert: "BertConfig" = dataclasses.field(default_factory=_default_bert)
    # admission + operating point
    weight_scales: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.125)
    precision_target: float = 0.94
    bootstrap: int = 1000
    # after weight admission the stacked combiner competes with the
    # weighted average on validation; the winner is the selected strategy
    try_stacking: bool = True
    # saving into a checkpoint_dir whose latest step records a different
    # text-encoder architecture is refused unless allowed
    allow_arch_mismatch: bool = False


def _auc(y: np.ndarray, s: np.ndarray) -> float:
    """Mann-Whitney AUC with tie-averaged ranks (a constant scorer gets
    0.5, not whatever the argsort order gives)."""
    _, inv, counts = np.unique(s, return_inverse=True, return_counts=True)
    ends = np.cumsum(counts)
    rank = (ends - (counts - 1) / 2.0)[inv]
    pos = y > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((rank[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def _prf(y: np.ndarray, flag: np.ndarray) -> Dict[str, float]:
    pos = y > 0.5
    tp = float((flag & pos).sum())
    return {
        "accuracy": round(float((flag == pos).mean()), 4),
        "precision": round(tp / max(float(flag.sum()), 1.0), 4),
        "recall": round(tp / max(float(pos.sum()), 1.0), 4),
    }


def _collect(scorer, gen, n_batches: int, batch_size: int) -> Dict[str, np.ndarray]:
    """One stream segment through the serving assemble path."""
    cols: Dict[str, list] = {k: [] for k in (
        "features", "history", "hlen", "ids", "mask", "uf", "mf",
        "unf", "unm", "mnf", "mnm", "y")}
    for _ in range(n_batches):
        recs = gen.generate_batch(batch_size)
        b = scorer.assemble(recs)
        for key, val in (
            ("features", b.features), ("history", b.history),
            ("hlen", b.history_len), ("ids", b.token_ids),
            ("mask", b.token_mask), ("uf", b.user_feat),
            ("mf", b.merchant_feat), ("unf", b.user_neigh_feat),
            ("unm", b.user_neigh_mask), ("mnf", b.merch_neigh_feat),
            ("mnm", b.merch_neigh_mask),
        ):
            cols[key].append(np.asarray(val))
        cols["y"].append(np.asarray(
            [bool(r.get("is_fraud")) for r in recs], np.float32))
        # serving's post-score write-back, applied here so later segments
        # see the velocity state this segment created
        ts = time.time()
        for r in recs:
            scorer.velocity.update(str(r.get("user_id", "")),
                                   float(r.get("amount", 0.0)), ts)
    return {k: np.concatenate(v) for k, v in cols.items()}


def _train_branches(
    cfg: BlendEvalConfig, tr: Dict[str, np.ndarray],
    segments: Dict[str, Dict[str, np.ndarray]],
    log: Callable[[str], None], *, init: Optional[Dict[str, Any]] = None,
    device: str = "cuda", stage_seconds: Optional[Dict[str, float]] = None,
) -> Tuple[Dict[str, Dict[str, np.ndarray]], Dict[str, Dict[str, float]],
           Dict[str, object]]:
    """Fit all five branches; return (scores[segment][branch], the Platt
    constants per neural branch, the trained and calibrated params).
    ``init`` maps "lstm" / "bert" / "gnn" to starting parameters (else the
    port's seeded init); ``stage_seconds`` receives each stage's seconds."""
    import torch

    from realtime_fraud_detection_tpu_torch.models.bert import bert_logits, init_bert_params
    from realtime_fraud_detection_tpu_torch.models.gnn import gnn_logits, init_gnn_params
    from realtime_fraud_detection_tpu_torch.models.isolation_forest import (
        IsolationForestTrainer,
        iforest_predict,
    )
    from realtime_fraud_detection_tpu_torch.models.lstm import init_lstm_params, lstm_logits
    from realtime_fraud_detection_tpu_torch.models.trees import tree_ensemble_predict
    from realtime_fraud_detection_tpu_torch.training.calibrate import (
        calibrate_bert_head,
        calibrate_gnn_head,
        calibrate_lstm_head,
        platt_apply,
        platt_fit,
    )
    from realtime_fraud_detection_tpu_torch.training.gbdt import GBDTTrainer
    from realtime_fraud_detection_tpu_torch.training.neural import (
        NeuralTrainer,
        eval_logits,
        adamw,
        training_device,
        weighted_bce_loss,
    )

    dev = training_device(device)
    init = init or {}
    stage_seconds = {} if stage_seconds is None else stage_seconds
    pos_w = float((1.0 - tr["y"].mean()) / max(tr["y"].mean(), 1e-6))
    scores: Dict[str, Dict[str, np.ndarray]] = {k: {} for k in segments}
    t0 = time.perf_counter()

    def lap(stage: str) -> None:
        nonlocal t0
        now = time.perf_counter()
        stage_seconds[stage] = now - t0
        t0 = now

    log("training trees + isolation forest")
    gtr = GBDTTrainer(n_estimators=cfg.n_trees, max_depth=cfg.tree_depth, seed=2)
    trees = gtr.fit(tr["features"], tr["y"])
    ifo = IsolationForestTrainer(n_estimators=cfg.iforest_trees, seed=4).fit(
        tr["features"][tr["y"] < 0.5][:6000])
    for k, d in segments.items():
        x = torch.from_numpy(d["features"])
        scores[k]["xgboost_primary"] = tree_ensemble_predict(trees, x).numpy()
        scores[k]["isolation_forest"] = iforest_predict(ifo, x).numpy()
    lap("trees_iforest")

    def neural(name, params, loss, inputs, trainer):
        out = trainer.train(params, loss, inputs, tr["y"])
        lap(name)
        stage_seconds[name + "_ms_per_step"] = trainer.last_run["ms_per_step"]
        return out

    log("training LSTM (class-weighted)")
    lp = init.get("lstm") or init_lstm_params(
        np.random.default_rng(0), tr["features"].shape[-1], cfg.lstm_hidden)

    def lstm_loss(p, inputs, y):
        s, l = inputs
        return weighted_bce_loss(lstm_logits(p, s, l), y, pos_w)

    lp = neural("lstm", lp, lstm_loss, (np.clip(tr["history"], -10, 10), tr["hlen"]),
                NeuralTrainer(epochs=cfg.lstm_epochs, seed=0, device=str(dev)))
    lstm_z = {k: eval_logits(lstm_logits, lp, (np.clip(d["history"], -10, 10),
                                                d["hlen"]), dev)
              for k, d in segments.items()}

    log("training text branch (class-weighted)")
    bp = init.get("bert") or init_bert_params(np.random.default_rng(1), cfg.bert)

    def text_loss(p, inputs, y):
        ids, mask = inputs
        lg = bert_logits(p, ids, mask, cfg.bert)
        return weighted_bce_loss(lg[:, 1] - lg[:, 0], y, pos_w)

    bp = neural("text", bp, text_loss, (tr["ids"], tr["mask"]),
                NeuralTrainer(epochs=cfg.text_epochs, seed=1, batch_size=128,
                              optimizer=adamw(5e-4), device=str(dev)))
    text_z = {}
    for k, d in segments.items():
        lg = eval_logits(lambda p, i, m: bert_logits(p, i, m, cfg.bert), bp,
                          (d["ids"], d["mask"]), dev)
        text_z[k] = lg[:, 1] - lg[:, 0]

    log("training GNN (class-weighted)")
    gp = init.get("gnn") or init_gnn_params(
        np.random.default_rng(2), tr["uf"].shape[-1], tr["features"].shape[-1], 64)

    def gnn_loss(p, inputs, y):
        return weighted_bce_loss(gnn_logits(p, *inputs), y, pos_w)

    def gnn_inputs(d):
        return (np.clip(d["features"], -10, 10), d["uf"], d["mf"], d["unf"],
                d["unm"], d["mnf"], d["mnm"])

    gp = neural("gnn", gp, gnn_loss, gnn_inputs(tr),
                NeuralTrainer(epochs=cfg.gnn_epochs, seed=2, device=str(dev)))
    gnn_z = {k: eval_logits(gnn_logits, gp, gnn_inputs(d), dev)
             for k, d in segments.items()}

    # Platt-calibrate the class-weighted branches on validation and fold
    # (a, b) into the heads: these probabilities are what the calibrated
    # models serve, and the returned params are the deployable branches
    y_val = segments["val"]["y"]
    calibration = {}
    folds = {"lstm_sequential": (lstm_z, lambda a, b: calibrate_lstm_head(lp, a, b)),
             "bert_text": (text_z, lambda a, b: calibrate_bert_head(bp, a, b)),
             "graph_neural": (gnn_z, lambda a, b: calibrate_gnn_head(gp, a, b))}
    calibrated_params = {}
    for name, (z, fold) in folds.items():
        a, b = platt_fit(z["val"], y_val)
        calibration[name] = {"a": round(a, 4), "b": round(b, 4)}
        calibrated_params[name] = fold(a, b)
        for k in segments:
            scores[k][name] = platt_apply(z[k], a, b).astype(np.float32)
    log(f"platt calibration (fit on val): {calibration}")
    trained = {
        "trees": trees,
        "iforest": ifo,
        "lstm": calibrated_params["lstm_sequential"],
        "bert": calibrated_params["bert_text"],
        "gnn": calibrated_params["graph_neural"],
    }
    return scores, calibration, trained


def _blend_fn(weights_by_name: Dict[str, float],
              strategy: str = "weighted_average"):
    """Serving-parity blend: ``blend_branch_scores`` curried over this
    protocol's weights and strategy (scores_by_branch -> probabilities)."""
    from realtime_fraud_detection_tpu_torch.ensemble.combine import blend_branch_scores

    def blend(scores_by_branch: Dict[str, np.ndarray]) -> np.ndarray:
        return blend_branch_scores(scores_by_branch, weights_by_name, strategy)

    return blend


def run_blend_eval(cfg: Optional[BlendEvalConfig] = None,
                   log: Callable[[str], None] = lambda m: None,
                   checkpoint_dir: Optional[str] = None, *,
                   init: Optional[Dict[str, Any]] = None,
                   device: str = "cuda",
                   stage_seconds: Optional[Dict[str, float]] = None) -> Dict:
    """Execute the full protocol; returns the evidence dict (JSON-able).

    ``checkpoint_dir``: also save the trained, calibrated branches as a
    serving checkpoint (step 0, or the next step) with the text architecture
    in its metadata; the artifact and the checkpoint together are a
    deployment (``serve --checkpoint-dir D --quality-artifact Q.json``).
    ``init`` and ``stage_seconds`` are ``_train_branches``'; the collection
    and the blend selection add their own stages to ``stage_seconds``."""
    from realtime_fraud_detection_tpu_torch.checkpoint import CheckpointManager
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import (
        ScorerConfig,
        ScoringModels,
    )
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
    from realtime_fraud_detection_tpu_torch.training.neural import training_device
    from realtime_fraud_detection_tpu_torch.utils.config import Config

    cfg = cfg or BlendEvalConfig()
    dev = training_device(device)
    stage_seconds = {} if stage_seconds is None else stage_seconds
    config_weights = Config().normalized_weights()

    mgr = CheckpointManager(checkpoint_dir) if checkpoint_dir else None
    latest = mgr.latest_step() if mgr is not None else None
    if latest is not None and not cfg.allow_arch_mismatch:
        # refused before any training: a dir mixing text architectures
        # across steps makes "restore latest" + "apply artifact" incoherent
        prev_tm = (mgr.manifest(latest).get("metadata") or {}).get("text_model")
        this_tm = dataclasses.asdict(cfg.bert)
        if prev_tm is not None and dict(prev_tm) != this_tm:
            raise ValueError(
                f"checkpoint dir {checkpoint_dir} step {latest} records "
                f"text_model {prev_tm}, but this protocol runs "
                f"{this_tm}; use a fresh directory or set "
                f"allow_arch_mismatch")

    t0 = time.perf_counter()
    gen = TransactionGenerator(num_users=cfg.num_users,
                               num_merchants=cfg.num_merchants, seed=cfg.seed)
    scorer = TorchFraudScorer(
        scorer_config=ScorerConfig(text_len=cfg.text_len, tokenizer=cfg.tokenizer),
        bert_config=cfg.bert, device=str(dev))
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())

    log("collecting train/val/test stream segments (serving assemble)")
    tr = _collect(scorer, gen, cfg.train_batches, cfg.batch_size)
    va = _collect(scorer, gen, cfg.val_batches, cfg.batch_size)
    te = _collect(scorer, gen, cfg.test_batches, cfg.batch_size)
    segments = {"val": va, "test": te}
    stage_seconds["collect"] = time.perf_counter() - t0

    scores, calibration, trained = _train_branches(
        cfg, tr, segments, log, init=init, device=str(dev),
        stage_seconds=stage_seconds)
    t0 = time.perf_counter()
    y_va, y_te = va["y"], te["y"]

    branch_auc = {
        name: {"val": round(_auc(y_va, scores["val"][name]), 4),
               "test": round(_auc(y_te, scores["test"][name]), 4)}
        for name in scores["val"]
    }
    log(f"per-branch AUC: {branch_auc}")

    # ---------------- A/B-gated admission (decided on validation only)
    weights: Dict[str, float] = {n: config_weights[n] for n in _BASELINE}
    admission: List[Dict] = []
    cur_val_auc = _auc(y_va, _blend_fn(weights)(scores["val"]))
    candidates = sorted(
        (n for n in scores["val"] if n not in _BASELINE),
        key=lambda n: -branch_auc[n]["val"])
    for name in candidates:
        best = None
        for scale in cfg.weight_scales:
            trial = dict(weights)
            trial[name] = config_weights[name] * scale
            a = _auc(y_va, _blend_fn(trial)(scores["val"]))
            if best is None or a > best[0]:
                best = (a, scale, trial)
        a, scale, trial = best
        accepted = a >= cur_val_auc     # non-regression gate
        admission.append({
            "branch": name, "weight_scale": scale,
            "val_auc_before": round(cur_val_auc, 4),
            "val_auc_with": round(a, 4),
            "accepted": bool(accepted),
        })
        log(f"  {'ACCEPT' if accepted else 'reject'} {name} "
            f"(scale {scale}): {cur_val_auc:.4f} -> {a:.4f}")
        if accepted:
            weights, cur_val_auc = trial, a

    # ------------- combine-strategy selection (decided on validation)
    strategy = "weighted_average"
    strategy_selection = {"weighted_average": round(cur_val_auc, 4)}
    if cfg.try_stacking:
        stack_val = _auc(y_va, _blend_fn(weights, "stacking")(scores["val"]))
        strategy_selection["stacking"] = round(stack_val, 4)
        if not np.isnan(stack_val) and stack_val > cur_val_auc:
            strategy, cur_val_auc = "stacking", stack_val
    strategy_selection["selected"] = strategy
    log(f"combine strategy (val): {strategy_selection}")

    blend = _blend_fn(weights, strategy)
    blend_te = blend(scores["test"])
    blend_va = blend(scores["val"])
    baseline_te = _blend_fn(
        {n: config_weights[n] for n in _BASELINE})(scores["test"])
    test_auc = _auc(y_te, blend_te)
    base_auc = _auc(y_te, baseline_te)

    # paired bootstrap CI on the AUC delta against the baseline pair
    rng = np.random.default_rng(7)
    deltas = np.empty(cfg.bootstrap)
    n_te = len(y_te)
    for i in range(cfg.bootstrap):
        idx = rng.integers(0, n_te, n_te)
        deltas[i] = _auc(y_te[idx], blend_te[idx]) - _auc(
            y_te[idx], baseline_te[idx])
    ci = (float(np.percentile(deltas, 2.5)),
          float(np.percentile(deltas, 97.5)))

    # drop-one ablation of the selected blend (test segment)
    ablation = {}
    for name in list(weights):
        if len(weights) <= 1:
            break
        rest = {k: v for k, v in weights.items() if k != name}
        ablation[name] = round(
            test_auc - _auc(y_te, _blend_fn(rest, strategy)(scores["test"])), 4)

    # ---------------- operating points (threshold chosen on validation)
    pos_va = y_va > 0.5
    best_t, best_rec = 0.5, -1.0
    for t in np.linspace(0.05, 0.95, 181):
        flag = blend_va >= t
        tp = float((flag & pos_va).sum())
        prec = tp / max(float(flag.sum()), 1.0)
        rec = tp / max(float(pos_va.sum()), 1.0)
        if prec >= cfg.precision_target and rec > best_rec:
            best_t, best_rec = float(t), rec
    operating = {
        "at_0.5": _prf(y_te, blend_te >= 0.5),
        f"at_precision>={cfg.precision_target}": {
            "threshold": round(best_t, 3),
            **_prf(y_te, blend_te >= best_t),
        },
    }
    stage_seconds["selection"] = time.perf_counter() - t0

    checkpoint_info = None
    if mgr is not None:
        models = ScoringModels(
            trees=trained["trees"], iforest=trained["iforest"],
            lstm=trained["lstm"], gnn=trained["gnn"], bert=trained["bert"])
        step = 0 if latest is None else latest + 1
        mgr.save(
            step, params=models,
            metadata={
                "source": "blend_eval",
                "text_model": dataclasses.asdict(cfg.bert),
                "text_len": cfg.text_len,
                "tokenizer": cfg.tokenizer,
                "selected_blend": sorted(weights),
                "selected_strategy": strategy,
            })
        checkpoint_info = {"dir": str(checkpoint_dir), "step": step}
        log(f"saved trained+calibrated branches to {checkpoint_dir}")

    return {
        "protocol": {
            "stream": {"users": cfg.num_users,
                       "merchants": cfg.num_merchants, "seed": cfg.seed},
            "segments_txns": {"train": len(tr["y"]), "val": len(y_va),
                              "test": len(y_te)},
            "fraud_rate": {"train": round(float(tr["y"].mean()), 4),
                           "test": round(float(y_te.mean()), 4)},
            "assemble_path": "TorchFraudScorer.assemble (live state)",
            "blend_math": "ensemble.combine.combine_predictions "
                          "(serving parity)",
            "tokenizer": cfg.tokenizer,
            "text_model": dataclasses.asdict(cfg.bert),
            "text_len": cfg.text_len,
            "platt_calibration": calibration,
        },
        "checkpoint": checkpoint_info,
        "branch_auc": branch_auc,
        "admission": admission,
        "strategy_selection": strategy_selection,
        "selected_blend": {
            "branches": sorted(weights),
            "weights": {k: round(v, 4) for k, v in sorted(weights.items())},
            "n_branches": len(weights),
            "strategy": strategy,
        },
        "test": {
            "blend_auc": round(test_auc, 4),
            "baseline_pair_auc": round(base_auc, 4),
            "delta_auc": round(test_auc - base_auc, 4),
            "delta_auc_bootstrap_95ci": [round(ci[0], 4), round(ci[1], 4)],
        },
        "ablation_drop_one_delta_auc": ablation,
        "operating_points": operating,
        "reference_claim": "96.8% accuracy, unmeasured "
                           "(reference README.md:203)",
    }
