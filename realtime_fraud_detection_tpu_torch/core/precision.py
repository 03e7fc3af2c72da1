"""Matmul precision seam shared by the model branches.

The JAX package computes its dense products as ``x.astype(cd) @
w.astype(cd)`` with ``cd`` bf16 on the served path: bf16 operands, f32
accumulation, the product rounded once to bf16. ``matmul_cd`` states that
rounding explicitly (bf16-valued operands multiply exactly in f32, so an f32
product of the rounded operands, rounded once at the end, is the same
arithmetic) so the port rounds at the same places on every device.

``batch_invariant_blas`` turns cuBLAS's split-K off for the process, so a
product's rows do not depend on how many rows it has (from 64 rows up; the
mesh executor's data shards, ``scoring/mesh_executor.py ROW_BLOCK``).
"""

from __future__ import annotations

import os

import torch


# cuBLAS and cuBLASLt with no workspace: no split-K
BATCH_INVARIANT_BLAS = {"CUBLAS_WORKSPACE_CONFIG": ":0:0", "CUBLASLT_WORKSPACE_SIZE": "0"}


def batch_invariant_blas() -> None:
    """Turn cuBLAS's split-K off for this process, or raise if that is too
    late. A split-K product sums its K range in parallel chunks, and cuBLAS
    picks it by the number of rows, so a row of a small batch would round
    otherwise than the same row in a large one. No workspace turns it off.
    PyTorch reads the workspace sizes when it first creates its cuBLAS
    handle, so this sets them only while CUDA is not yet initialised in the
    process, and raises if CUDA is initialised and they are not already in
    the environment. ``MeshExecutor`` calls it for a mesh on the card, so
    ``mesh-drill``, ``serve`` with ``mesh.enabled`` and any script driving
    the mesh call it (or set ``BATCH_INVARIANT_BLAS`` in the environment)
    before their first work on the card. It costs cuBLAS speed elsewhere
    (``chip_smoke.py`` phase 24 times a bf16 product both ways), so nothing
    else turns it on."""
    if all(os.environ.get(k) == v for k, v in BATCH_INVARIANT_BLAS.items()):
        return
    if torch.cuda.is_initialized():
        raise RuntimeError(
            "cuBLAS's split-K may already be on in this process: CUDA was "
            "initialised before batch_invariant_blas(), so a mesh's data shards "
            "could round otherwise than the whole batch; call it (or set "
            + " ".join(f"{k}={v}" for k, v in BATCH_INVARIANT_BLAS.items())
            + ") before the process first uses the card")
    os.environ.update(BATCH_INVARIANT_BLAS)


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
