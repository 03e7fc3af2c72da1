"""Ring attention: sequence / context parallelism over the ``seq`` mesh axis.

Port of the JAX package's ``parallel/context.py``. The online-softmax
accumulation the flash kernel runs over key blocks runs here over mesh
positions: each position owns one sequence shard of K / V and passes it one
hop around the ``seq`` ring (``ppermute_seq``) while its Q shard stays put.
After ``seq_size()`` hops each Q block has seen every K / V block. Softmax
in f32, one normalisation at the end: the numerics of dense attention.

Layout as ``ops/attention.py``: q / k / v are [B, H, S, D] with a bool
``key_mask`` [B, S]; the batch splits over ``data`` and the sequence over
``seq``.
"""

from __future__ import annotations

import math

import torch

from realtime_fraud_detection_tpu_torch.core.mesh import DATA_AXIS, SEQ_AXIS, Mesh, P
from realtime_fraud_detection_tpu_torch.parallel.collectives import (
    ppermute_seq,
    seq_size,
    shard_map_over,
)

__all__ = ["bert_context_parallel_predict", "ring_attention"]

NEG_INF = -1e30


def _ring_attention_local(q, k, v, mask):
    """Per-position body. q [B, H, Sq, D] (stationary); k, v [B, H, Sk, D]
    and mask [B, Sk] travel the ring."""
    d = q.shape[-1]
    qf = q.to(torch.float32) * (1.0 / float(math.sqrt(d)))
    b, h, sq, _ = q.shape
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    m_prev = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l_prev = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    k_cur, v_cur, mask_cur = k, v, mask
    for _ in range(seq_size()):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k_cur.to(torch.float32))
        s = torch.where(mask_cur[:, None, None, :], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m_prev, s.amax(dim=-1))
        alpha = torch.exp(m_prev - m_new)
        p = torch.exp(s - m_new[..., None])
        l_prev = l_prev * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p, v_cur.to(torch.float32))
        m_prev = m_new
        # the last rotation returns the shards home, as in JAX's loop
        k_cur, v_cur, mask_cur = ppermute_seq((k_cur, v_cur, mask_cur))
    return (acc / torch.clamp(l_prev, min=1e-30)[..., None]).to(q.dtype)


def ring_attention(mesh: Mesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Context-parallel attention over global [B, H, S, D] tensors: B split
    over ``data``, S over ``seq``; S must divide by the seq-axis size. With
    seq=1 it is one local pass."""
    b, _, s, _ = q.shape
    n_seq = mesh.shape[SEQ_AXIS]
    if s % n_seq:
        raise ValueError(f"seq len {s} not divisible by seq axis {n_seq}")
    if key_mask is None:
        key_mask = torch.ones((b, s), dtype=torch.bool, device=q.device)
    qkv_spec = P(DATA_AXIS, None, SEQ_AXIS, None)
    mask_spec = P(DATA_AXIS, SEQ_AXIS)
    fn = shard_map_over(mesh, _ring_attention_local,
                        in_specs=(qkv_spec, qkv_spec, qkv_spec, mask_spec),
                        out_specs=qkv_spec)
    return fn(q, k, v, key_mask.to(torch.bool)).to(q.device)


def bert_context_parallel_predict(mesh: Mesh, params, input_ids: torch.Tensor,
                                  attention_mask: torch.Tensor, config,
                                  compute_dtype: torch.dtype = torch.bfloat16
                                  ) -> torch.Tensor:
    """The text branch's forward with its attention as ring attention over
    the mesh's ``seq`` axis. Every other op of the encoder is per token and
    runs on the caller's device; the numerics match the single-position
    encoder."""
    from realtime_fraud_detection_tpu_torch.models.bert import bert_predict

    return bert_predict(params, input_ids, attention_mask.to(torch.bool), config,
                        compute_dtype=compute_dtype,
                        attention_fn=lambda q, k, v, m: ring_attention(mesh, q, k, v, m))
