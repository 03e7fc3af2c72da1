"""Operations, bytes and peaks: the yardstick's arithmetic.

``bound`` and the peaks are copied from ``chip_smoke.py`` (``bound``,
``PEAK_BYTES_PER_S``, ``PEAK_FLOPS``): NVIDIA's H100 SXM data sheet, dense
rates, at the full 700 W. The functions below count what each call site of
the program's kernels needs at the shapes the configuration gives it, the
same work whatever implements the kernel: each input byte read once, each
output byte written once.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# the card's published peaks (H100 SXM data sheet, dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "tf32": 495e12,
              # f32-accurate products from the TF32 tensor cores take three
              # TF32 products each (the 3xTF32 split the attention kernel uses)
              "3xtf32": 495e12 / 3.0}
MFU_PEAK = PEAK_FLOPS["bf16"]


def bound(bytes_moved: float, flops: float, dtype: str) -> Tuple[float, str]:
    """Least time in ms and what bounds it: bytes over the memory peak or
    operations over the ``dtype`` peak, whichever is larger."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dequant_matmul_sites(enc: Dict[str, int]) -> List[Tuple[int, int]]:
    """(K, N) of the int8 dense layers of one encoder layer, in launch
    order: q, k, v, o, ffn1, ffn2."""
    h, ffn = enc["hidden_size"], enc["intermediate_size"]
    return [(h, h)] * 4 + [(h, ffn), (ffn, h)]


def dequant_matmul_work(m: int, k: int, n: int) -> Tuple[float, float]:
    """(bytes, flops) of y[M, N] = x[M, K] @ dequant(q[K, N], scale[N]) +
    bias[N]: f32 x and y, int8 q, f32 scale and bias (``chip_smoke.py
    check_dequant_matmul``'s count)."""
    return float(m * k * 4 + k * n + 2 * n * 4 + m * n * 4), float(2 * m * k * n)


def attention_work(b: int, h: int, s: int, d: int) -> Tuple[float, float]:
    """(bytes, flops) of masked attention over f32 q, k, v [B, H, S, D]:
    q, k, v read and the output written once, the byte mask read once;
    QK^T and PV at 2 S^2 D each per head (``chip_smoke.py
    check_attention``'s count)."""
    return float(4 * b * h * s * d * 4 + b * s), float(4 * b * h * s * s * d)


def dequant_matmul_bound_ms(enc: Dict[str, int], rows: int) -> float:
    """Mean least time of one dequant-matmul launch over one layer's six
    sites at ``rows`` token rows (batch x text length), bf16 products."""
    sites = dequant_matmul_sites(enc)
    return sum(bound(*dequant_matmul_work(rows, k, n), "bf16")[0]
               for k, n in sites) / len(sites)


def attention_bound_ms(enc: Dict[str, int], batch: int, text_len: int) -> float:
    """Least time of one attention launch (one layer, all heads) over a
    ``batch``-row bucket."""
    h = enc["num_heads"]
    d = enc["hidden_size"] // h
    return bound(*attention_work(batch, h, text_len, d), "3xtf32")[0]


def model_flops_per_txn(cfg: Dict) -> float:
    """Model operations for one scored transaction at the configuration's
    shapes: the text encoder at the text length every row carries, its
    head, and the four other branches. Multiply-adds count 2."""
    enc, ens = cfg["text_encoder"], cfg["ensemble"]
    h, ffn, layers = enc["hidden_size"], enc["intermediate_size"], enc["num_layers"]
    s = ens["text_len"]
    per_token_layer = 2 * (4 * h * h + 2 * h * ffn) + 2 * 2 * s * h
    encoder = layers * s * per_token_layer + 2 * (h * h + h * enc["num_labels"])
    f, t = ens["feature_dim"], ens["seq_len"]
    lh, lhh = ens["lstm"]["hidden"], ens["lstm"]["head_hidden"]
    lstm = t * 2 * (f + lh) * 4 * lh + 2 * (lh * lhh + lhh)
    nd, k = ens["node_dim"], ens["fanout"]
    gh, ghh = ens["gnn"]["hidden"], ens["gnn"]["head_hidden"]
    # two SAGE layers on each side (the frontier per neighbour, then the
    # node), then the head
    gnn = 2 * (k * 2 * 2 * nd * gh + 2 * (nd + gh) * gh) + 2 * ((2 * gh + f) * ghh + ghh)
    # a tree is one comparison a level and one add: what the model needs,
    # not what the GEMM form that implements it spends
    trees = sum(2 * ens[key]["n_trees"] * ens[key]["depth"]
                for key in ("gbdt", "isolation_forest"))
    return float(encoder + lstm + gnn + trees)
