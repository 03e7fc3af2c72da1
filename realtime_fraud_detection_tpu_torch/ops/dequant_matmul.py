"""Weight-only int8 kernels of the quantized BERT branch.

``dequant_matmul`` replaces the JAX package's Pallas kernel
``ops/dequant_matmul.py dequant_matmul`` (``_dequant_matmul_kernel``):
``y = x @ dequant(qw, scale) + b`` with the i8 -> compute-dtype widen done in
registers, so the widened weight never exists in device memory.
``dequant_rows`` replaces ``dequant_rows`` (``_dequant_rows_kernel``) and
also fuses the embedding gather: only the gathered i8 rows are read.

On the card both run the hand-written CUDA kernels of
``csrc/dequant_matmul.cu`` (design and bounds are noted there); for a tensor
on the CPU they run their plain versions, ``dequant_matmul_reference`` and
``dequant_rows_reference``, which are also what the CPU tests compare with
the JAX package. Each wrapper counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import torch

from realtime_fraud_detection_tpu_torch.core.precision import matmul_cd, round_bf16
from realtime_fraud_detection_tpu_torch.ops.build import (
    check_launch,
    count_launch,
    kernel_library,
)


def matmul_supported(m: int, k: int, n: int) -> bool:
    """Shapes the fused dequant-matmul kernel takes: whole 32-deep K steps
    and 64-wide N tiles (any M)."""
    return m > 0 and k > 0 and n > 0 and k % 32 == 0 and n % 64 == 0


def rows_supported(h: int) -> bool:
    """Row widths the row-dequant kernel takes (16-byte i8 loads)."""
    return h > 0 and h % 16 == 0


def dequantize_weight(qw: torch.Tensor, scale: torch.Tensor,
                      compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``qw.astype(cd) * scale.astype(cd)`` as f32 values."""
    if compute_dtype == torch.bfloat16:
        return round_bf16(qw.to(torch.float32) * round_bf16(scale))
    return qw.to(torch.float32) * scale.to(torch.float32)


def dequant_matmul_reference(x, qw, scale, b, compute_dtype=torch.bfloat16):
    """Plain version: the int8 branch of ``models/bert.py _dense``."""
    return matmul_cd(x, dequantize_weight(qw, scale, compute_dtype),
                     compute_dtype) + b


def _check_cuda(name, vectorised, others):
    """The kernels read ``vectorised`` tensors with 16-byte loads."""
    dev = vectorised[0].device
    for t in (*vectorised, *others):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in vectorised):
        raise ValueError(f"{name}: tensors must be 16-byte aligned")


def dequant_matmul(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
                   b: torch.Tensor,
                   compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Fused ``x @ dequant(qw, scale) + b`` -> f32[M, N].

    x f32[M, K], qw i8[K, N], scale and b f32[N]. Raises on shapes the
    kernel does not take (``matmul_supported``).
    """
    m, k = x.shape
    k2, n = qw.shape
    if k2 != k or not matmul_supported(m, k, n):
        raise ValueError(
            f"unsupported dequant_matmul shape [{m},{k}]x[{k2},{n}]")
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"compute_dtype must be bf16 or f32, got {compute_dtype}")
    if x.device.type == "cpu":
        return dequant_matmul_reference(x, qw, scale, b, compute_dtype)
    if (x.dtype, qw.dtype, scale.dtype, b.dtype) != (
            torch.float32, torch.int8, torch.float32, torch.float32):
        raise ValueError("dequant_matmul takes f32 x, i8 qw, f32 scale and b")
    _check_cuda("dequant_matmul", (x, qw), (scale, b))
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    code = kernel_library().rtfd_dequant_matmul(
        x.data_ptr(), qw.data_ptr(), scale.data_ptr(), b.data_ptr(),
        y.data_ptr(), m, n, k, int(compute_dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    check_launch("dequant_matmul", code)
    count_launch(dequant_matmul)
    return y


dequant_matmul.launches = 0


def dequant_rows_reference(table: torch.Tensor, scale: torch.Tensor,
                           idx: torch.Tensor | None = None,
                           length: int | None = None) -> torch.Tensor:
    """Plain version: gather (``idx``, flattened) or prefix (``length``)
    rows, then f32 rows = ``q * scale[:, None]``."""
    if idx is not None:
        idx = idx.reshape(-1).long()
        q, s = table[idx], scale[idx]
    else:
        q, s = table[:length], scale[:length]
    return q.to(torch.float32) * s.to(torch.float32)[:, None]


def dequant_rows(table: torch.Tensor, scale: torch.Tensor,
                 idx: torch.Tensor | None = None,
                 length: int | None = None) -> torch.Tensor:
    """Fused gather + per-row widen -> f32[rows, H], bit-exact with
    ``dequant_rows_reference``.

    table i8[R, H], scale f32[R]; ``idx`` i32[rows] gathers, or with
    ``idx=None`` the first ``length`` rows are taken. Out-of-range indices
    are clamped on the card (as an XLA gather does).
    """
    table_rows, h = table.shape
    if not rows_supported(h):
        raise ValueError(f"unsupported dequant_rows width {h}")
    if idx is not None:
        idx = idx.reshape(-1)
    rows = idx.numel() if idx is not None else length
    if rows is None or rows <= 0 or (idx is None and rows > table_rows):
        raise ValueError("dequant_rows needs indices or 0 < length <= table rows")
    if table.device.type == "cpu":
        return dequant_rows_reference(table, scale, idx, length)
    if table.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError("dequant_rows takes an i8 table and f32 scales")
    others = [scale]
    if idx is not None:
        if idx.dtype != torch.int32:
            raise ValueError("dequant_rows takes i32 indices")
        others.append(idx)
    _check_cuda("dequant_rows", (table,), others)
    out = torch.empty((rows, h), dtype=torch.float32, device=table.device)
    code = kernel_library().rtfd_dequant_rows(
        table.data_ptr(), scale.data_ptr(),
        idx.data_ptr() if idx is not None else None, out.data_ptr(),
        rows, table_rows, h, torch.cuda.current_stream(table.device).cuda_stream)
    check_launch("dequant_rows", code)
    count_launch(dequant_rows)
    return out


dequant_rows.launches = 0
