"""Expert parallelism: a mixture-of-experts FFN with all_to_all dispatch.

Port of the JAX package's ``parallel/experts.py``:

- E experts' weights are stacked [E, ...] and split over the ``model`` axis:
  each position holds E/S experts.
- Tokens split over ``data`` and, within each data row, over the expert
  axis: each position routes n/(data*S) tokens into per-expert buckets of a
  fixed capacity, one ``all_to_all`` moves the buckets to the positions
  that own the experts, E/S batched matmuls run there, a second
  ``all_to_all`` brings the outputs home and an ``all_gather`` restores the
  data row.
- Tokens over capacity are DROPPED: their output is exactly zero.

With generous capacity the result equals the dense reference: every token
through its top-1 expert's FFN, scaled by its router probability.
Gradients flow through the dispatch (autograd through the collectives).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from realtime_fraud_detection_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, Mesh, P
from realtime_fraud_detection_tpu_torch.parallel.collectives import (
    all_gather,
    all_to_all,
    axis_index,
    shard_map_over,
)

__all__ = ["MoEConfig", "init_moe_params", "moe_ffn", "moe_ffn_reference"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    d_model: int
    d_hidden: int
    capacity_factor: float = 1.25


def init_moe_params(seed: int | np.random.Generator, cfg: MoEConfig
                    ) -> Dict[str, torch.Tensor]:
    """Normal(0, 1/sqrt(fan-in)) router and expert weights, zero biases, from
    a numpy seed."""
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
    scale_in = 1.0 / np.sqrt(cfg.d_model)
    scale_hid = 1.0 / np.sqrt(cfg.d_hidden)

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32))

    return {
        "router": t(rng.standard_normal((cfg.d_model, cfg.n_experts)) * scale_in),
        "w1": t(rng.standard_normal((cfg.n_experts, cfg.d_model, cfg.d_hidden)) * scale_in),
        "b1": t(np.zeros((cfg.n_experts, cfg.d_hidden))),
        "w2": t(rng.standard_normal((cfg.n_experts, cfg.d_hidden, cfg.d_model)) * scale_hid),
        "b2": t(np.zeros((cfg.n_experts, cfg.d_model))),
    }


def moe_ffn_reference(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Dense reference: every token through its top-1 expert, no capacity
    drops. [N, d] -> [N, d]."""
    logits = x @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(logits, dim=-1)                        # [N]
    gate = torch.gather(probs, 1, expert[:, None])[:, 0]
    h = torch.relu(torch.einsum("nd,edh->enh", x, params["w1"])
                   + params["b1"][:, None, :])
    all_out = torch.einsum("enh,ehd->end", h, params["w2"]) + params["b2"][:, None, :]
    picked = all_out[expert, torch.arange(x.shape[0], device=x.device)]   # [N, d]
    return picked * gate[:, None]


def moe_ffn(mesh: Mesh, params: Dict[str, torch.Tensor], x: torch.Tensor,
            cfg: MoEConfig, axis: str = MODEL_AXIS) -> torch.Tensor:
    """Expert-parallel MoE FFN. x: [N, d] split over ``data``; expert
    weights split over ``axis``. Returns [N, d]."""
    n_shards = mesh.shape[axis]
    if cfg.n_experts % n_shards != 0:
        raise ValueError(
            f"n_experts={cfg.n_experts} not divisible by the "
            f"{axis}-axis size {n_shards}")
    e_local = cfg.n_experts // n_shards
    n_per_row = x.shape[0] // mesh.shape[DATA_AXIS]
    if n_per_row % n_shards != 0:
        raise ValueError(
            f"tokens per data row ({n_per_row}) not divisible by the "
            f"{axis}-axis size {n_shards}")

    def device_body(p, xs):
        n_local, d = xs.shape
        n_sub = n_local // n_shards
        me = axis_index(axis)
        xs = xs[me * n_sub:(me + 1) * n_sub]
        cap = max(1, int(cfg.capacity_factor * n_sub / cfg.n_experts))

        logits = xs @ p["router"]                               # [n_sub, E]
        probs = torch.softmax(logits, dim=-1)
        expert = torch.argmax(logits, dim=-1)                   # [n_sub]
        gate = torch.gather(probs, 1, expert[:, None])[:, 0]

        # slot of each token within its expert's bucket (stable order);
        # tokens past the capacity are dropped
        onehot = torch.nn.functional.one_hot(expert, cfg.n_experts)
        slot = torch.cumsum(onehot, dim=0) - 1                  # [n_sub, E]
        my_slot = torch.gather(slot, 1, expert[:, None])[:, 0]
        keep = my_slot < cap
        flat_idx = expert * cap + my_slot
        # kept tokens have unique slots, so the scatter is deterministic
        disp = xs.new_zeros((cfg.n_experts * cap, d)).index_copy(
            0, flat_idx[keep], xs[keep])

        # by destination shard: [S, e_local*cap, d]; recv[j] is source j's
        # buckets for this position's experts
        recv = all_to_all(disp.reshape(n_shards, e_local * cap, d), axis, 0, 0)
        by_exp = (recv.reshape(n_shards, e_local, cap, d).permute(1, 0, 2, 3)
                  .reshape(e_local, n_shards * cap, d))         # [E/S, K, d]
        h = torch.relu(torch.einsum("ekd,edh->ekh", by_exp, p["w1"]) + p["b1"][:, None, :])
        out = torch.einsum("ekh,ehd->ekd", h, p["w2"]) + p["b2"][:, None, :]

        out = out.reshape(e_local, n_shards, cap, d).permute(1, 0, 2, 3)
        back = all_to_all(out.reshape(n_shards, e_local * cap, d), axis, 0, 0)
        back = back.reshape(cfg.n_experts * cap, d)
        token_out = back[torch.where(keep, flat_idx, torch.zeros_like(flat_idx))]
        mine = torch.where(keep[:, None], token_out * gate[:, None],
                           torch.zeros_like(token_out))
        return all_gather(mine, axis, dim=0).reshape(n_local, d)

    param_specs = {"router": P(), "w1": P(axis), "b1": P(axis), "w2": P(axis),
                   "b2": P(axis)}
    return shard_map_over(mesh, device_body, in_specs=(param_specs, P(DATA_AXIS)),
                          out_specs=P(DATA_AXIS))(params, x)
