"""Masked blockwise (flash) attention for the text encoder.

``flash_attention`` replaces the JAX package's Pallas kernel
``ops/attention.py flash_attention`` (``_flash_kernel``): online-softmax
attention over ``[B, H, S, D]`` with a key mask, f32 running max,
denominator and accumulator, masked scores at -1e30 and the denominator
floored at 1e-30. On the card it runs the CUDA kernel of
``csrc/attention.cu`` (design and bound noted there); for a tensor on the
CPU it runs ``attention_reference``, the plain full-softmax version.
``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import math

import torch

from realtime_fraud_detection_tpu_torch.ops.build import (
    check_launch,
    count_launch,
    kernel_library,
)

NEG_INF = -1e30
HEAD_DIM = 64           # the kernel's head width
MAX_SEQ = 440           # the guard's longest text (the encoder serves 64);
                        # K and V stream in 64-key blocks, so shared
                        # memory does not bound it


def attention_supported(s: int, d: int) -> bool:
    """Shapes the flash kernel takes. The wrapper raises on any other, and
    ``TorchFraudScorer.set_models`` refuses kernel settings for a BERT whose
    widths the kernel does not take, so the encoder never meets one."""
    return d == HEAD_DIM and 0 < s <= MAX_SEQ


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain attention over [B, H, S, D]; key_mask bool[B, S]."""
    d = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32) / math.sqrt(d)
    if key_mask is not None:
        scores = torch.where(key_mask[:, None, None, :], scores,
                             torch.full_like(scores, NEG_INF))
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", weights.to(v.dtype), v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Blockwise attention. q/k/v f32[B, H, S, D] (any strides with the last
    dim contiguous) -> f32[B, H, S, D], returned as the permuted view of a
    contiguous [B, S, H, D] buffer, so that merging the heads back into
    [B, S, H*D] is a view. ``key_mask`` bool or u8 [B, S]."""
    b, h, s, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if not attention_supported(s, d):
        raise ValueError(
            f"flash_attention takes D={HEAD_DIM} and 0 < S <= {MAX_SEQ}, "
            f"got D={d} S={s}")
    out = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
    if q.device.type == "cpu":
        out.permute(0, 2, 1, 3).copy_(attention_reference(q, k, v, key_mask))
        return out.permute(0, 2, 1, 3)
    for t in (q, k, v):
        if t.dtype != torch.float32 or t.stride(-1) != 1 or t.device != q.device:
            raise ValueError("flash_attention takes f32 q/k/v on one device "
                             "with a contiguous last dim")
        if t.data_ptr() % 16 or any(st % 4 for st in t.stride()[:3]):
            raise ValueError("flash_attention stages 16-byte rows: q/k/v need "
                             "16-byte aligned rows")
    if key_mask is None:
        key_mask = torch.ones((b, s), dtype=torch.bool, device=q.device)
    if (key_mask.shape != (b, s) or key_mask.device != q.device
            or key_mask.dtype not in (torch.bool, torch.uint8)):
        raise ValueError(f"key_mask must be bool or u8 [B, S] = [{b}, {s}] on {q.device}")
    mask = key_mask.contiguous()
    code = kernel_library().rtfd_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), b, h, s, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("flash_attention", code)
    count_launch(flash_attention)
    return out.permute(0, 2, 1, 3)


flash_attention.launches = 0
