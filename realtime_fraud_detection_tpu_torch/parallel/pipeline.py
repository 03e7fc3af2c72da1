"""Pipeline parallelism: a GPipe-style microbatch schedule over a mesh axis.

Port of the JAX package's ``parallel/pipeline.py``:

- stage parameters are stacked on a leading ``[n_stages, ...]`` dim; each
  position takes its own stage's rows by its axis index;
- the schedule is a tick loop inside ``shard_map_over``: every tick each
  position runs its stage on the activation it holds, then the activations
  move one hop down the ring (``ppermute``);
- the last stage banks its outputs; a ``psum`` over the axis (the other
  stages contribute zeros) hands every position the full [M, ...] result;
- gradients flow back through the schedule (autograd through the
  collectives), with no hand-written backward pass.

The contract is numerical equivalence with the sequential layer stack.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from realtime_fraud_detection_tpu_torch.core.mesh import (
    MODEL_AXIS,
    Mesh,
    P,
    tree_leaves,
    tree_map,
)
from realtime_fraud_detection_tpu_torch.parallel.collectives import (
    axis_index,
    ppermute,
    psum,
    shard_map_over,
)

__all__ = ["PIPELINE_AXIS", "bert_pipeline_encode", "pipeline_forward",
           "stack_stage_params"]

# the pipeline axis reuses ``model``: tensor and pipeline parallelism
# partition the same weight budget
PIPELINE_AXIS = MODEL_AXIS


def stack_stage_params(per_stage_params: list) -> Any:
    """[p_0, ..., p_{S-1}] trees -> one tree with leading stage dim S."""
    return tree_map(lambda *xs: torch.stack([torch.as_tensor(x) for x in xs], dim=0),
                    per_stage_params[0], *per_stage_params[1:])


def pipeline_forward(mesh: Mesh, stage_fn: Callable[[Any, Any], Any],
                     stage_params: Any, microbatches: Any,
                     axis: str = PIPELINE_AXIS) -> Any:
    """``stage_fn`` S times over each of M microbatches, pipelined.

    stage_fn: (params of one stage, h) -> h', h an array [mb, ...] or a
    tree of them (e.g. (hidden, mask)); shapes stage-invariant.
    stage_params: tree with leading dim S (``stack_stage_params``).
    microbatches: tree of [M, mb, ...] tensors.
    Returns the same tree of [M, mb, ...] outputs. Ticks: M + S - 1.
    """
    n_stages = mesh.shape[axis]
    n_micro = tree_leaves(microbatches)[0].shape[0]
    ring = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    def device_body(params, mb):
        stage = axis_index(axis)
        mine = tree_map(lambda x: x[stage], params)
        is_first, is_last = stage == 0, stage == n_stages - 1
        incoming = tree_map(lambda m: torch.zeros_like(m[0]), mb)
        banked = [None] * n_micro
        h_out = None
        for t in range(n_micro + n_stages - 1):
            # stage 0 injects microbatch t while t < M; later stages use the
            # activation that arrived over the ring last tick
            inj = tree_map(lambda m: m[min(t, n_micro - 1)], mb)
            h_out = stage_fn(mine, inj if is_first else incoming)
            slot = t - (n_stages - 1)
            if is_last and 0 <= slot < n_micro:
                banked[slot] = h_out
            incoming = ppermute(h_out, axis, ring)
        if is_last:
            out = tree_map(lambda *xs: torch.stack(xs, dim=0), banked[0], *banked[1:])
        else:
            out = tree_map(lambda h: torch.zeros((n_micro,) + tuple(h.shape),
                                                 dtype=h.dtype, device=h.device), h_out)
        # replicate the last stage's outputs to every stage position
        return psum(out, axis)

    return shard_map_over(mesh, device_body, in_specs=(P(), P()),
                          out_specs=P())(stage_params, microbatches)


def bert_pipeline_encode(mesh: Mesh, params: Any, input_ids: torch.Tensor,
                         attention_mask: torch.Tensor, config: Any,
                         n_micro: int = 4, axis: str = PIPELINE_AXIS,
                         use_flash: bool = False,
                         compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The DistilBERT encoder with its layers pipelined over ``axis``: each
    position runs ``num_layers / S`` blocks (``use_flash``: through the
    flash-attention kernel on the card); hidden states and their mask ride
    the schedule in ``n_micro`` microbatches. The embeddings run once on the
    caller's device. Numerics equal the sequential ``models.bert.
    bert_encode``."""
    from realtime_fraud_detection_tpu_torch.models.bert import bert_embed, bert_layer

    n_stages = mesh.shape[axis]
    if config.num_layers % n_stages:
        raise ValueError(
            f"num_layers={config.num_layers} not divisible by the "
            f"{axis}-axis size {n_stages}")
    span = config.num_layers // n_stages
    b, s = input_ids.shape
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro={n_micro}")

    x = bert_embed(params, input_ids, config)
    stage_params = stack_stage_params([
        {"layers": params["layers"][i * span:(i + 1) * span]}
        for i in range(n_stages)])
    mb = b // n_micro
    micro_x = x.reshape(n_micro, mb, s, config.hidden_size)
    micro_mask = attention_mask.to(torch.bool).reshape(n_micro, mb, s)

    def stage_fn(p, h):
        hid, mask = h
        for layer in p["layers"]:
            hid = bert_layer(layer, hid, mask, config, use_flash=use_flash,
                             compute_dtype=compute_dtype)
        return (hid, mask)

    out_x, _ = pipeline_forward(mesh, stage_fn, stage_params, (micro_x, micro_mask),
                                axis=axis)
    return out_x.reshape(b, s, config.hidden_size).to(input_ids.device)
