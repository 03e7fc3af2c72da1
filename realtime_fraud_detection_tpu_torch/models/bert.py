"""DistilBERT-style text encoder.

Port of the JAX package's ``models/bert.py``: 6 post-LN layers, 12 heads,
hidden 768, tanh-GELU FFN 3072, learned positions, LayerNorm'd embeddings,
and the pre_classifier(ReLU) -> classifier head on [CLS]. Heads keep the
``[B, H, S, D]`` layout. Two parameter layouts: f32 dense ``{"w", "b"}`` and
the weight-only int8 ``{"qw", "scale", "b"}`` / ``{"qe", "scale"}`` of
``models/quant.py``.

``compute_dtype`` is the dense-product precision: bf16 served (operands and
product rounded to bf16, f32 accumulation, bias added in f32), f32 for
tests. Kernel selection: ``dequant_kernel="cuda"`` routes the int8 dense
layers and embedding rows through ``ops/dequant_matmul.py``, and
``use_flash`` the attention through ``ops/attention.py``;
``attention_fn(q, k, v, key_mask) -> ctx`` replaces the attention outright
(``parallel/context.py`` passes ring attention over a mesh).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from realtime_fraud_detection_tpu_torch.core.precision import matmul_cd
from realtime_fraud_detection_tpu_torch.ops.attention import (
    attention_reference,
    flash_attention,
)
from realtime_fraud_detection_tpu_torch.ops.dequant_matmul import (
    dequant_matmul,
    dequant_matmul_reference,
    dequant_rows,
    dequant_rows_reference,
)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    layer_norm_eps: float = 1e-12
    num_labels: int = 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


TINY_CONFIG = BertConfig(hidden_size=128, num_layers=2, num_heads=2,
                         intermediate_size=256, vocab_size=30522)
DISTILBERT_BASE = BertConfig()


def _truncated_normal(rng: np.random.Generator, shape, std=0.02) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], times ``std``, as f32."""
    x = rng.standard_normal(shape, dtype=np.float32)
    bad = np.abs(x) > 2.0
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
        bad = np.abs(x) > 2.0
    return torch.from_numpy(x * np.float32(std))


def init_bert_params(rng: np.random.Generator, config: BertConfig) -> Dict:
    """Truncated-normal(0.02) weights, zero biases, unit layer norms."""
    h, ffn = config.hidden_size, config.intermediate_size

    def dense(shape):
        return {"w": _truncated_normal(rng, shape),
                "b": torch.zeros(shape[-1], dtype=torch.float32)}

    def ln():
        return {"scale": torch.ones(h, dtype=torch.float32),
                "bias": torch.zeros(h, dtype=torch.float32)}

    params: Dict = {
        "word_emb": _truncated_normal(rng, (config.vocab_size, h)),
        "pos_emb": _truncated_normal(rng, (config.max_position_embeddings, h)),
        "emb_ln": ln(),
        "layers": [],
        "pre_classifier": dense((h, h)),
    }
    for _ in range(config.num_layers):
        params["layers"].append({
            "q": dense((h, h)), "k": dense((h, h)), "v": dense((h, h)),
            "o": dense((h, h)), "attn_ln": ln(),
            "ffn1": dense((h, ffn)), "ffn2": dense((ffn, h)), "ffn_ln": ln(),
        })
    params["classifier"] = dense((h, config.num_labels))
    return params


def _layer_norm(x, p, eps):
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _dense(x, p, compute_dtype, dequant_kernel="off"):
    if "qw" in p:
        lead = x.shape[:-1]
        k, n = p["qw"].shape
        x2 = x.reshape(-1, k)
        if dequant_kernel == "cuda":
            y = dequant_matmul(x2.contiguous(), p["qw"], p["scale"], p["b"],
                               compute_dtype=compute_dtype)
        else:
            y = dequant_matmul_reference(x2, p["qw"], p["scale"], p["b"],
                                         compute_dtype)
        return y.reshape(*lead, n)
    return matmul_cd(x, p["w"], compute_dtype) + p["b"]


def _embedding_rows(table, idx=None, length=None, dequant_kernel="off"):
    """Embedding lookup for both layouts: gather rows ``idx`` or take the
    first ``length``; f32 rows either way."""
    if isinstance(table, dict) and "qe" in table:
        fn = dequant_rows if dequant_kernel == "cuda" else dequant_rows_reference
        if idx is not None:
            rows = fn(table["qe"], table["scale"], idx=idx.contiguous())
            return rows.reshape(*idx.shape, -1)
        return fn(table["qe"], table["scale"], length=length)
    return table[idx.long()] if idx is not None else table[:length]


def bert_embed(params: Dict, input_ids: torch.Tensor, config: BertConfig,
               dequant_kernel: str = "off") -> torch.Tensor:
    """Token + position embeddings with the embedding layer norm."""
    s = input_ids.shape[1]
    x = (_embedding_rows(params["word_emb"], idx=input_ids,
                         dequant_kernel=dequant_kernel)
         + _embedding_rows(params["pos_emb"], length=s,
                           dequant_kernel=dequant_kernel)[None, :, :])
    return _layer_norm(x, params["emb_ln"], config.layer_norm_eps)


def bert_layer(layer: Dict, x: torch.Tensor, attention_mask: torch.Tensor,
               config: BertConfig, use_flash: bool = False,
               compute_dtype: torch.dtype = torch.bfloat16,
               dequant_kernel: str = "off", attention_fn=None) -> torch.Tensor:
    """One post-LN transformer block. x f32[B, S, H]."""
    b, s = x.shape[:2]
    q = _dense(x, layer["q"], compute_dtype, dequant_kernel)
    k = _dense(x, layer["k"], compute_dtype, dequant_kernel)
    v = _dense(x, layer["v"], compute_dtype, dequant_kernel)

    def split(t):
        return t.reshape(b, s, config.num_heads, config.head_dim).permute(0, 2, 1, 3)

    attend = attention_fn or (flash_attention if use_flash else attention_reference)
    ctx = attend(split(q), split(k), split(v), attention_mask)
    ctx = ctx.permute(0, 2, 1, 3).reshape(b, s, config.hidden_size)
    attn_out = _dense(ctx, layer["o"], compute_dtype, dequant_kernel)
    x = _layer_norm(x + attn_out, layer["attn_ln"], config.layer_norm_eps)
    hidden = F.gelu(_dense(x, layer["ffn1"], compute_dtype, dequant_kernel),
                    approximate="tanh")
    ffn = _dense(hidden, layer["ffn2"], compute_dtype, dequant_kernel)
    return _layer_norm(x + ffn, layer["ffn_ln"], config.layer_norm_eps)


def bert_encode(params: Dict, input_ids: torch.Tensor,
                attention_mask: torch.Tensor, config: BertConfig,
                use_flash: bool = False,
                compute_dtype: torch.dtype = torch.bfloat16,
                dequant_kernel: str = "off", attention_fn=None) -> torch.Tensor:
    """Hidden states f32[B, S, H]: the embeddings through every layer."""
    x = bert_embed(params, input_ids, config, dequant_kernel=dequant_kernel)
    for layer in params["layers"]:
        x = bert_layer(layer, x, attention_mask, config, use_flash=use_flash,
                       compute_dtype=compute_dtype,
                       dequant_kernel=dequant_kernel, attention_fn=attention_fn)
    return x


def bert_logits(params: Dict, input_ids: torch.Tensor,
                attention_mask: torch.Tensor, config: BertConfig,
                use_flash: bool = False,
                compute_dtype: torch.dtype = torch.bfloat16,
                dequant_kernel: str = "off", attention_fn=None) -> torch.Tensor:
    """Sequence-classification logits f32[B, num_labels] from [CLS]."""
    x = bert_encode(params, input_ids, attention_mask, config, use_flash=use_flash,
                    compute_dtype=compute_dtype, dequant_kernel=dequant_kernel,
                    attention_fn=attention_fn)
    cls = x[:, 0, :]
    z = torch.relu(cls @ params["pre_classifier"]["w"]
                   + params["pre_classifier"]["b"])
    return z @ params["classifier"]["w"] + params["classifier"]["b"]


def bert_predict(params: Dict, input_ids: torch.Tensor,
                 attention_mask: torch.Tensor, config: BertConfig,
                 use_flash: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 dequant_kernel: str = "off", attention_fn=None) -> torch.Tensor:
    """Fraud probability f32[B] = softmax(logits)[:, 1]."""
    logits = bert_logits(params, input_ids, attention_mask, config,
                         use_flash=use_flash, compute_dtype=compute_dtype,
                         dequant_kernel=dequant_kernel, attention_fn=attention_fn)
    return torch.softmax(logits, dim=-1)[:, 1]
