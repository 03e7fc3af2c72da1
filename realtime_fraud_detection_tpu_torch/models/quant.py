"""Weight-only int8 quantization for the BERT branch (host-side numpy).

A copy of the JAX package's ``models/quant.py`` calibration, bit for bit:
per-output-channel symmetric scales for every dense kernel
(``scale[j] = max|w[:, j]| / 127``, ``q = rint(w / scale)`` clipped to
[-127, 127]), per-row scales for the embedding tables, and f32 layer norms,
biases and classification head. It runs at model-swap time, never on the
dispatch path; the scorer moves the quantized tensors to the device after.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

_QMAX = 127.0


def _channel_scales(w: np.ndarray, axis: int) -> np.ndarray:
    """Symmetric per-channel scales over ``axis``; a zero channel gets
    scale 1 so dequant stays exactly zero."""
    amax = np.max(np.abs(w), axis=axis)
    return np.where(amax > 0.0, amax / _QMAX, 1.0).astype(np.float32)


def _host(x: Any) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def quantize_dense(p: Dict[str, Any]) -> Dict[str, Any]:
    """``{"w": f32[in, out], "b"}`` -> ``{"qw": i8[in, out], "scale":
    f32[out], "b"}``."""
    w = _host(p["w"])
    scale = _channel_scales(w, axis=0)
    q = np.clip(np.rint(w / scale[None, :]), -_QMAX, _QMAX).astype(np.int8)
    return {"qw": q, "scale": scale, "b": p["b"]}


def quantize_embedding(w: Any) -> Dict[str, Any]:
    """f32[rows, h] -> ``{"qe": i8[rows, h], "scale": f32[rows]}``."""
    w = _host(w)
    scale = _channel_scales(w, axis=1)
    q = np.clip(np.rint(w / scale[:, None]), -_QMAX, _QMAX).astype(np.int8)
    return {"qe": q, "scale": scale}


def quantize_bert_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize an ``init_bert_params``-shaped dict; idempotent."""
    if is_quantized_bert(params):
        return params
    out: Dict[str, Any] = {
        "word_emb": quantize_embedding(params["word_emb"]),
        "pos_emb": quantize_embedding(params["pos_emb"]),
        "emb_ln": params["emb_ln"],
        "pre_classifier": params["pre_classifier"],
        "classifier": params["classifier"],
        "layers": [],
    }
    for layer in params["layers"]:
        out["layers"].append({
            "q": quantize_dense(layer["q"]),
            "k": quantize_dense(layer["k"]),
            "v": quantize_dense(layer["v"]),
            "o": quantize_dense(layer["o"]),
            "attn_ln": layer["attn_ln"],
            "ffn1": quantize_dense(layer["ffn1"]),
            "ffn2": quantize_dense(layer["ffn2"]),
            "ffn_ln": layer["ffn_ln"],
        })
    return out


def is_quantized_bert(params: Any) -> bool:
    """The word embedding is a ``{"qe", "scale"}`` dict in the int8 layout."""
    try:
        return isinstance(params["word_emb"], dict) \
            and "qe" in params["word_emb"]
    except (TypeError, KeyError, IndexError):
        return False


def bert_param_bytes(params: Any) -> int:
    """Total parameter bytes of a (plain or int8) BERT parameter tree, from
    each leaf's element count and size: the ``quant_param_bytes`` series."""
    if isinstance(params, dict):
        return sum(bert_param_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(bert_param_bytes(v) for v in params)
    nbytes = getattr(params, "nbytes", None)      # a tensor or an array
    return int(nbytes if nbytes is not None else np.asarray(params).nbytes)


def quant_error_bound(params: Dict[str, Any]) -> float:
    """The largest absolute weight reconstruction error over the quantized
    leaves: half a step of the widest per-channel scale (0.0 for f32
    weights). A reported sanity number, not a gate."""
    if not is_quantized_bert(params):
        return 0.0
    scales = [params["word_emb"]["scale"], params["pos_emb"]["scale"]]
    for layer in params["layers"]:
        scales.extend(layer[key]["scale"]
                      for key in ("q", "k", "v", "o", "ffn1", "ffn2"))
    return 0.5 * max(float(np.max(_host(s))) for s in scales)
