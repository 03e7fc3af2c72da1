"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, the plain
reference (``perfbench/reference/``) replays the run's batches in the order
the program assembled and wrote them back, and judges the transactions of
the batches drawn for the check (``check.stride`` apart from a phase drawn
from the seed, ``check.batches`` of them, in the window):

- what the program's ``assemble`` produced for them, kept by the harness at
  the time: the 64 features, the history sequences and their lengths, the
  node and neighbour rows of the graph join with their masks, the token ids
  and masks;
- what the job put on the predictions topic for them: each branch's score,
  the blended ``fraud_score`` (the fused epilogue), the decision and the
  risk level.

The reference makes its own inputs from the same records and profiles and
its own weights from the same seed and input scales (``perfbench/weights.py``,
drawn again on the run's device), quantizes the encoder itself, and computes every
branch in float32 with TF32 off. Each number has a limit of its own, set
from readings (``PERF.md``) and kept in the cell's workload file under
``check.limits``. With ``control`` the reference at the next precision
below each one the configuration states (``reference/models.py CONTROL``)
stands in the program's place and is judged the same way.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from perfbench.reference import models as ref
from perfbench.reference.replay import Replay
from perfbench.reference.rules import RISK_LEVEL_NAMES
from perfbench.weights import make_weights

BRANCHES = ("xgboost_primary", "lstm_sequential", "bert_text", "graph_neural",
            "isolation_forest")
DECISIONS = ("APPROVE", "APPROVE_WITH_MONITORING", "REVIEW", "DECLINE")
BLOCK = 256


def _rel_gap(got: np.ndarray, want: np.ndarray) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    if not got.size:
        return 0.0
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))


def _branch_preds(w: Dict[str, Any], prec: ref.Precision, cfg, rows, device):
    """[N, 5] branch probabilities for the reference's inputs ``rows`` at
    ``prec``."""
    enc = cfg["text_encoder"]
    enc_w = ref.encoder_weights(w["bert"], prec.encoder_bits)
    out = []
    n = rows["features"].shape[0]
    for lo in range(0, n, BLOCK):
        t = {k: torch.from_numpy(np.ascontiguousarray(v[lo:lo + BLOCK])).to(device)
             for k, v in rows.items()}
        x = t["features"]
        preds = [
            ref.gbdt_prob(w["gbdt"], x, prec),
            ref.lstm_prob(w["lstm"], t["history"], t["history_len"], prec),
            ref.encoder_prob(enc_w, t["token_ids"], t["token_mask"], enc, prec),
            ref.gnn_prob(w["gnn"], x, t["user_feat"], t["merchant_feat"],
                         t["user_neigh_feat"], t["user_neigh_mask"],
                         t["merch_neigh_feat"], t["merch_neigh_mask"], prec),
            ref.iforest_prob(w["iforest"], x, prec),
        ]
        out.append(torch.stack(preds, dim=1).cpu())
    return torch.cat(out, dim=0)


def _judge(cfg, limits, got: List[Dict[str, Any]], want) -> Dict[str, float]:
    """The answer numbers for rows whose answers ``got`` (result dicts, None
    where none came) are held against the reference's ``want``: the widest
    gap of each branch's score and of the blend (``fraud_score``), and the
    decisions and risk levels of the rows whose reference score and
    confidence lie clear of every cut."""
    ens = cfg["ensemble"]
    missing = sum(1 for g in got if g is None)
    ok = [i for i, g in enumerate(got) if g is not None]
    nums: Dict[str, float] = {"missing": float(missing)}
    preds, b = want["preds"].numpy().astype(np.float64), want["blend"]
    gaps = np.full((len(ok), len(BRANCHES)), np.inf)
    for row, i in enumerate(ok):
        mp = got[i]["model_predictions"]
        for j, name in enumerate(BRANCHES):
            if name in mp:
                gaps[row, j] = abs(float(mp[name]) - preds[i, j])
    prob, conf = b["prob"].numpy().astype(np.float64), b["confidence"].numpy()
    blend_gap = np.asarray([abs(float(got[i]["fraud_score"]) - prob[i]) for i in ok])
    widest = gaps.max(axis=0) if ok else np.zeros(len(BRANCHES))
    for j, name in enumerate(BRANCHES):
        nums[name] = float(widest[j])
    nums["fraud_score"] = float(blend_gap.max()) if ok else 0.0
    margin = float(limits["decision_margin"])
    cuts = [ens["monitor_threshold"], ens["review_threshold"],
            ens["decline_threshold"]] + list(ens["risk_level_thresholds"])
    flips = 0
    for i in ok:
        if (min(abs(prob[i] - c) for c in cuts) <= margin
                or abs(conf[i] - ens["confidence_threshold"]) <= margin):
            continue
        if (got[i]["decision"] != DECISIONS[int(b["decision"][i])]
                or got[i]["risk_level"] != RISK_LEVEL_NAMES[int(b["risk"][i])]):
            flips += 1
    nums["decisions"] = float(flips)
    # read beside the compared numbers, compared with nothing
    mean = gaps.mean(axis=0) if ok else np.zeros(len(BRANCHES))
    info = {f"mean.{n}": float(mean[j]) for j, n in enumerate(BRANCHES)}
    info["mean.fraud_score"] = float(blend_gap.mean()) if ok else 0.0
    return nums, info


def _assembled(kept, ref_in) -> Dict[str, float]:
    """The assemble numbers: the program's kept host batches against the
    reference's inputs for the same records."""
    feats, hist, graph = 0.0, 0.0, 0.0
    hlen, tokens = 0, 0
    for k, p in kept.items():
        r = ref_in[k]
        n = len(r["ids"])
        feats = max(feats, _rel_gap(p.features[:n], r["features"]))
        hist = max(hist, _rel_gap(p.history[:n], r["history"]))
        hlen += int(np.sum(np.asarray(p.history_len[:n]) != r["history_len"]))
        graph = max(graph, _rel_gap(p.user_feat[:n], r["user_feat"]),
                    _rel_gap(p.merchant_feat[:n], r["merchant_feat"]))
        for f, m in (("user_neigh_feat", "user_neigh_mask"),
                     ("merch_neigh_feat", "merch_neigh_mask")):
            pm = np.asarray(getattr(p, m)[:n], bool)
            if pm.shape != r[m].shape or np.any(pm != r[m]):
                graph = float("inf")
                continue
            graph = max(graph, _rel_gap(np.asarray(getattr(p, f)[:n]) * pm[..., None],
                                        r[f] * r[m][..., None]))
        pid, pmask = np.asarray(p.token_ids[:n]), np.asarray(p.token_mask[:n], bool)
        if pid.shape != r["token_ids"].shape:
            tokens += n
        else:
            tokens += int(np.sum(np.any((pid != r["token_ids"])
                                        | (pmask != r["token_mask"]), axis=1)))
    return {"features": feats, "history": hist + (float("inf") if hlen else 0.0),
            "graph": graph, "tokens": float(tokens)}


def check_run(cfg: Dict[str, Any], cell: Dict[str, Any], seed: int, device: str,
              traffic, scales, events, kept, results, unanswered: int,
              control: bool = False) -> Dict[str, Any]:
    """The numbers, each beside its limit, and the verdict. ``unanswered``
    counts the run's transactions that were batched or due and never got a
    decision; they join the drawn rows' missing answers."""
    limits = cell["check"]["limits"]
    if not kept:
        # the window reached no batch drawn for the check: nothing judged
        return {"numbers": {"missing": (float(unanswered), limits["missing"])},
                "rows": 0, "info": {}, "correct": False,
                **({"control": {}} if control else {})}
    replay = Replay(traffic.users, traffic.merchants, cfg["ensemble"],
                    cfg["text_encoder"]["vocab_size"])
    ref_in = replay.run(events, keep=set(kept))
    rows = {key: np.concatenate([ref_in[k][key] for k in sorted(kept)])
            for key in ("features", "history", "history_len", "user_feat",
                        "merchant_feat", "user_neigh_feat", "user_neigh_mask",
                        "merch_neigh_feat", "merch_neigh_mask", "token_ids",
                        "token_mask")}
    ids = [t for k in sorted(kept) for t in ref_in[k]["ids"]]
    w = make_weights(seed, cfg, device, scales)
    with torch.no_grad():
        preds = _branch_preds(w, ref.REFERENCE, cfg, rows, device)
        want = {"preds": preds, "blend": ref.blend(preds, cfg["ensemble"], BRANCHES)}
        ctl = None
        if control:
            cpreds = _branch_preds(w, ref.CONTROL, cfg, rows, device)
            cb = ref.blend(cpreds, cfg["ensemble"], BRANCHES)
            ctl = [{"model_predictions": dict(zip(BRANCHES, map(float, cpreds[i]))),
                    "fraud_score": float(cb["prob"][i]),
                    "decision": DECISIONS[int(cb["decision"][i])],
                    "risk_level": RISK_LEVEL_NAMES[int(cb["risk"][i])]}
                   for i in range(len(ids))]
    numbers = _assembled(kept, ref_in)
    judged, info = _judge(cfg, limits, [results.get(t) for t in ids], want)
    numbers.update(judged)
    numbers["missing"] += unanswered
    # a number is compared where the cell's file gives it a limit; the
    # others are read beside them (PERF.md says why each has none)
    info.update({k: float(v) for k, v in numbers.items() if k not in limits})
    verdict = {"numbers": {k: (float(v), limits[k]) for k, v in numbers.items()
                           if k in limits},
               "rows": len(ids), "info": info}
    verdict["correct"] = bool(ids) and all(
        v <= lim for v, lim in verdict["numbers"].values())
    if ctl is not None:
        cn = {k: 0.0 for k in ("features", "history", "graph", "tokens")}
        judged, info = _judge(cfg, limits, ctl, want)
        cn.update(judged)
        cn.update(info)
        verdict["control"] = cn
    return verdict
