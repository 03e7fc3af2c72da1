"""Matmul precision seam shared by the model branches.

The JAX package computes its dense products as ``x.astype(cd) @
w.astype(cd)`` with ``cd`` bf16 on the served path: bf16 operands, f32
accumulation, the product rounded once to bf16. ``matmul_cd`` states that
rounding explicitly (bf16-valued operands multiply exactly in f32, so an f32
product of the rounded operands, rounded once at the end, is the same
arithmetic) so the port rounds at the same places on every device.

``Policy`` is the JAX package's precision policy with torch dtypes: f32
parameters, bf16 compute, f32 outputs (``FULL_PRECISION`` computes in f32).
Its casts map over a tree of tensors and leave non-float leaves alone;
``matmul_precision`` names the f32 product precision the policy needs and
sets nothing: no global setting of torch changes here (``chip_smoke.py``
pins TF32 off and the mesh needs ``batch_invariant_blas``).

``batch_invariant_blas`` turns cuBLAS's split-K off for the process, so a
product's rows do not depend on how many rows it has (from 64 rows up; the
mesh executor's data shards, ``scoring/mesh_executor.py ROW_BLOCK``).
"""

from __future__ import annotations

import dataclasses
import os

import torch

from realtime_fraud_detection_tpu_torch.core.mesh import tree_map


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32

    @staticmethod
    def _cast(tree, dtype: torch.dtype):
        return tree_map(
            lambda x: x.to(dtype)
            if isinstance(x, torch.Tensor) and x.is_floating_point() else x,
            tree)

    def cast_to_compute(self, tree):
        return self._cast(tree, self.compute_dtype)

    def cast_to_output(self, tree):
        return self._cast(tree, self.output_dtype)

    def matmul_precision(self) -> str:
        """The ``torch.set_float32_matmul_precision`` name of the f32 products
        this policy's arithmetic needs: ``"highest"`` (no TF32), since
        ``matmul_cd`` rounds bf16 operands itself and wants exact f32
        products of them. Returned only; the caller decides."""
        return "highest"


DEFAULT_POLICY = Policy()
FULL_PRECISION = Policy(compute_dtype=torch.float32)


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
