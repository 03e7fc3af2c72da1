"""Matmul precision seam shared by the model branches.

The JAX package computes its dense products as ``x.astype(cd) @
w.astype(cd)`` with ``cd`` bf16 on the served path: bf16 operands, f32
accumulation, the product rounded once to bf16. ``matmul_cd`` states that
rounding explicitly (bf16-valued operands multiply exactly in f32, so an f32
product of the rounded operands, rounded once at the end, is the same
arithmetic) so the port rounds at the same places on every device.
"""

from __future__ import annotations

import torch


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest bf16 value, kept in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def matmul_cd(a: torch.Tensor, b: torch.Tensor,
              compute_dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` at the compute dtype's precision, returned as f32."""
    if compute_dtype == torch.bfloat16:
        return round_bf16(round_bf16(a) @ round_bf16(b))
    if compute_dtype != torch.float32:
        raise ValueError(f"compute_dtype must be bf16 or f32, got {compute_dtype}")
    return a.to(torch.float32) @ b.to(torch.float32)
