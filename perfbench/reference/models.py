"""The plain reference of the five branches and the blend.

Plain PyTorch in float32 with TF32 off, no kernel and no batching trick,
written from the models' equations for this benchmark:

- GBDT and isolation forest: the complete trees walked level by level (a
  node sends ``x >= threshold`` right), leaves summed / path lengths
  averaged;
- LSTM: the gates ``[x_t, h] @ W + b`` split i, f, g, o over the
  front-padded history, steps before the user's first row skipped, then a
  ReLU head;
- GNN: two GraphSAGE layers on the one-hop neighbourhoods (each neighbour
  through layer 1 with an empty frontier, the node through layer 2 with the
  masked mean of its neighbours), then a ReLU head over both nodes and the
  64 features;
- the text encoder: word and position rows, embedding layer norm, post-LN
  blocks with masked softmax attention and the tanh-GELU FFN, the
  pre_classifier (ReLU) -> classifier head on [CLS], softmax's fraud
  column. Its weights are the benchmark's float weights quantized here the
  way the configuration states (``quantize``), then used in float32;
- the blend: the configuration's weights and confidence multipliers, the
  weighted average, the decision ladder and the five risk levels.

``Precision`` says how each product is computed. The reference is
``REFERENCE`` (float32 throughout, the encoder's weights int8 as the
configuration states). ``CONTROL`` takes each precision the configuration
states one step down: int4 encoder weights, fp8 (e4m3, per-tensor scaled)
operands where the configuration states bf16 products (the encoder and the
LSTM), TF32 operands where it states float32 (the attention, the GNN, the heads and
the trees' feature comparisons).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F


def round_operand(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` rounded as a product's operand of ``kind``: "f32" unchanged,
    "tf32" to 10 mantissa bits (nearest, ties away), "fp8" to e4m3 after
    scaling the tensor's largest magnitude to 448."""
    if kind == "f32":
        return x
    if kind == "tf32":
        bits = x.contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32)
    if kind == "fp8":
        s = torch.clamp(x.abs().amax(), min=1e-30) / 448.0
        return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    raise ValueError(kind)


@dataclasses.dataclass(frozen=True)
class Precision:
    encoder_bits: int = 8        # the encoder's weights
    low: str = "f32"             # operands where bf16 products are stated
    full: str = "f32"            # operands where f32 products are stated

    def mm(self, a: torch.Tensor, b: torch.Tensor, kind: str) -> torch.Tensor:
        return round_operand(a, kind) @ round_operand(b, kind)


REFERENCE = Precision()
CONTROL = Precision(encoder_bits=4, low="fp8", full="tf32")


def quantize(w: torch.Tensor, bits: int, axis: int) -> torch.Tensor:
    """Symmetric per-channel quantization, returned dequantized in f32:
    ``scale = max|w| / qmax`` over ``axis`` (1 where a channel is zero),
    ``q = round-half-even(w / scale)`` clipped to +-qmax."""
    qmax = float(2 ** (bits - 1) - 1)
    amax = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale), -qmax, qmax)
    return q * scale


def encoder_weights(bert: Dict[str, Any], bits: int) -> Dict[str, Any]:
    """The encoder's dense kernels quantized per output channel and its
    embedding tables per row, at ``bits``; norms, biases and the head stay
    float."""
    out = {"word_emb": quantize(bert["word_emb"], bits, 1),
           "pos_emb": quantize(bert["pos_emb"], bits, 1),
           "emb_ln": bert["emb_ln"], "pre_classifier": bert["pre_classifier"],
           "classifier": bert["classifier"], "layers": []}
    for layer in bert["layers"]:
        q = {name: {"w": quantize(layer[name]["w"], bits, 0), "b": layer[name]["b"]}
             for name in ("q", "k", "v", "o", "ffn1", "ffn2")}
        q["attn_ln"], q["ffn_ln"] = layer["attn_ln"], layer["ffn_ln"]
        out["layers"].append(q)
    return out


def _ln(x, p, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p["scale"] + p["bias"]


def encoder_prob(w: Dict[str, Any], ids: torch.Tensor, mask: torch.Tensor,
                 enc: Dict[str, Any], prec: Precision = REFERENCE) -> torch.Tensor:
    b, s = ids.shape
    h, heads = enc["hidden_size"], enc["num_heads"]
    d = h // heads
    eps = enc["layer_norm_eps"]
    x = _ln(w["word_emb"][ids.long()] + w["pos_emb"][:s][None], w["emb_ln"], eps)
    key_ok = mask.bool()[:, None, None, :]
    for layer in w["layers"]:
        def proj(name, t):
            return prec.mm(t, layer[name]["w"], prec.low) + layer[name]["b"]

        def heads_of(t):
            return t.reshape(b, s, heads, d).transpose(1, 2)

        q, k, v = (heads_of(proj(n, x)) for n in ("q", "k", "v"))
        scores = prec.mm(q, k.transpose(-1, -2), prec.full) / math.sqrt(d)
        scores = scores.masked_fill(~key_ok, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        ctx = prec.mm(probs, v, prec.full).transpose(1, 2).reshape(b, s, h)
        x = _ln(x + proj("o", ctx), layer["attn_ln"], eps)
        ff = proj("ffn2", F.gelu(proj("ffn1", x), approximate="tanh"))
        x = _ln(x + ff, layer["ffn_ln"], eps)
    head = w["pre_classifier"]
    z = torch.relu(prec.mm(x[:, 0], head["w"], prec.full) + head["b"])
    logits = prec.mm(z, w["classifier"]["w"], prec.full) + w["classifier"]["b"]
    return torch.softmax(logits, dim=-1)[:, 1]


def _walk(feature, threshold, x, prec: Precision = REFERENCE):
    """Leaf index [B, T] of complete trees of depth log2(I + 1)."""
    t, n_int = feature.shape
    depth = int(round(math.log2(n_int + 1)))
    base = torch.arange(t, device=x.device)[None, :] * n_int
    node = torch.zeros((x.shape[0], t), dtype=torch.long, device=x.device)
    f_flat, t_flat = feature.reshape(-1).long(), threshold.reshape(-1)
    x = round_operand(x, prec.full)
    for _ in range(depth):
        at = node + base
        go_right = torch.gather(x, 1, f_flat[at]) >= t_flat[at]
        node = 2 * node + 1 + go_right.long()
    return node - n_int


def gbdt_prob(p: Dict[str, torch.Tensor], x: torch.Tensor,
              prec: Precision = REFERENCE) -> torch.Tensor:
    leaf = _walk(p["feature"], p["threshold"], x, prec)
    n_leaf = p["leaf"].shape[1]
    off = torch.arange(leaf.shape[1], device=x.device)[None, :] * n_leaf
    vals = p["leaf"].reshape(-1)[leaf + off]
    return torch.sigmoid(p["base_score"] + vals.sum(dim=1))


def iforest_prob(p: Dict[str, torch.Tensor], x: torch.Tensor,
                 prec: Precision = REFERENCE) -> torch.Tensor:
    leaf = _walk(p["feature"], p["threshold"], x, prec)
    n_leaf = p["path_length"].shape[1]
    off = torch.arange(leaf.shape[1], device=x.device)[None, :] * n_leaf
    h = p["path_length"].reshape(-1)[leaf + off].mean(dim=1)
    s = torch.pow(2.0, -h / p["c_psi"])
    return 1.0 / (1.0 + torch.exp(0.5 - s))


def lstm_prob(p: Dict[str, torch.Tensor], seq: torch.Tensor,
              lengths: torch.Tensor, prec: Precision = REFERENCE) -> torch.Tensor:
    b, t, _ = seq.shape
    hid = p["w_head1"].shape[0]
    h = torch.zeros((b, hid), dtype=torch.float32, device=seq.device)
    c = torch.zeros_like(h)
    for i in range(t):
        z = prec.mm(torch.cat([seq[:, i], h], dim=-1), p["w_gates"], prec.low) \
            + p["b_gates"]
        ig, fg, g, o = z.split(hid, dim=-1)
        c_new = torch.sigmoid(fg) * c + torch.sigmoid(ig) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        live = (i >= t - lengths)[:, None]
        h, c = torch.where(live, h_new, h), torch.where(live, c_new, c)
    z = torch.relu(prec.mm(h, p["w_head1"], prec.full) + p["b_head1"])
    return torch.sigmoid((prec.mm(z, p["w_head2"], prec.full) + p["b_head2"])[:, 0])


def gnn_prob(p: Dict[str, torch.Tensor], feats, user_feat, merchant_feat,
             un_feat, un_mask, mn_feat, mn_mask,
             prec: Precision = REFERENCE) -> torch.Tensor:
    def sage(w, bias, self_feat, agg):
        return torch.relu(prec.mm(torch.cat([self_feat, agg], dim=-1), w, prec.full)
                          + bias)

    def side(node, neigh, mask):
        # layer 1 on each neighbour with nothing beyond it (a zero mean)
        front = sage(p["w_sage1"], p["b_sage1"], neigh, torch.zeros_like(neigh))
        m = mask.to(front.dtype)[..., None]
        mean = (front * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
        return sage(p["w_sage2"], p["b_sage2"], node, mean)

    z = torch.cat([side(user_feat, un_feat, un_mask),
                   side(merchant_feat, mn_feat, mn_mask), feats], dim=-1)
    z = torch.relu(prec.mm(z, p["w_head1"], prec.full) + p["b_head1"])
    return torch.sigmoid((prec.mm(z, p["w_head2"], prec.full) + p["b_head2"])[:, 0])


def blend(preds: torch.Tensor, ens: Dict[str, Any], names) -> Dict[str, torch.Tensor]:
    """Weighted average over the five branches (all enabled), the averaged
    confidence, the decision ladder and the risk level."""
    w = torch.tensor([ens["weights"][n] for n in names], dtype=torch.float32,
                     device=preds.device)
    w = w / w.sum()
    mult = torch.tensor([ens["confidence_multipliers"][n] for n in names],
                        dtype=torch.float32, device=preds.device)
    prob = (preds * w).sum(dim=1) / w.sum()
    conf = torch.clamp((preds - 0.5).abs() * 2.0 * mult, max=1.0)
    conf = (conf * w).sum(dim=1) / w.sum()
    decision = torch.zeros(prob.shape, dtype=torch.int64, device=prob.device)
    decision = torch.where(prob >= ens["monitor_threshold"], 1, decision)
    decision = torch.where(prob >= ens["review_threshold"], 2, decision)
    decision = torch.where(prob >= ens["decline_threshold"], 3, decision)
    decision = torch.where(conf < ens["confidence_threshold"], 2, decision)
    risk = sum((prob >= t).long() for t in ens["risk_level_thresholds"])
    return {"prob": prob, "confidence": conf, "decision": decision, "risk": risk}
