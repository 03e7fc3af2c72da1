"""GraphSAGE user-merchant network scorer, bipartite mode.

Port of the JAX package's ``models/gnn.py gnn_logits`` for the bipartite
parameter layout: two SAGE layers with a mask-aware mean over a fixed
fan-out, and an MLP head over both center embeddings and the 64 transaction
features. The typed entity-graph layout (per-node-type projections,
``w_node_*`` params) is not ported yet and raises.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def init_gnn_params(rng: np.random.Generator, node_dim: int = 16,
                    txn_dim: int = 64, hidden: int = 64,
                    head_hidden: int = 64) -> Dict[str, torch.Tensor]:
    """GraphSAGE (2 layers) + head parameters, Glorot-normal."""
    def glorot(shape):
        return rng.standard_normal(shape) * np.sqrt(2.0 / (shape[0] + shape[1]))

    params = {
        "w_sage1": glorot((2 * node_dim, hidden)),
        "b_sage1": np.zeros((hidden,)),
        "w_sage2": glorot((node_dim + hidden, hidden)),
        "b_sage2": np.zeros((hidden,)),
        "w_head1": glorot((2 * hidden + txn_dim, head_hidden)),
        "b_head1": np.zeros((head_hidden,)),
        "w_head2": glorot((head_hidden, 1)),
        "b_head2": np.zeros((1,)),
    }
    return {k: torch.from_numpy(np.asarray(v, np.float32))
            for k, v in params.items()}


def is_typed_gnn(params: Dict[str, torch.Tensor]) -> bool:
    return "w_node_user" in params


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over axis -2 where mask, else zeros. x: [..., K, D], mask [..., K]."""
    m = mask[..., None].to(x.dtype)
    return (x * m).sum(dim=-2) / torch.clamp(m.sum(dim=-2), min=1.0)


def _sage(w, b, self_feat, neigh_feat, neigh_mask):
    agg = _masked_mean(neigh_feat, neigh_mask)
    return torch.relu(torch.cat([self_feat, agg], dim=-1) @ w + b)


def _empty_frontier(x: torch.Tensor):
    """[B, K, 1, D] zeros with an all-False mask: the masked mean is 0."""
    return (x[..., None, :] * 0.0,
            torch.zeros(x.shape[:-1] + (1,), dtype=torch.bool, device=x.device))


def gnn_logits(params: Dict[str, torch.Tensor],
               txn_features: torch.Tensor,      # f32[B, 64]
               user_feat: torch.Tensor,         # f32[B, D]
               merchant_feat: torch.Tensor,     # f32[B, D]
               user_neigh_feat: torch.Tensor,   # f32[B, K, D]
               user_neigh_mask: torch.Tensor,   # bool[B, K]
               merch_neigh_feat: torch.Tensor,  # f32[B, K, D]
               merch_neigh_mask: torch.Tensor,  # bool[B, K]
               ) -> torch.Tensor:
    """Fraud logit per scored (user, merchant, txn) edge. f32[B]."""
    if is_typed_gnn(params):
        raise NotImplementedError(
            "the typed entity-graph GNN is not ported yet")
    u2_feat, u2_mask = _empty_frontier(user_neigh_feat)
    m2_feat, m2_mask = _empty_frontier(merch_neigh_feat)
    u_frontier = _sage(params["w_sage1"], params["b_sage1"],
                       user_neigh_feat, u2_feat, u2_mask)
    m_frontier = _sage(params["w_sage1"], params["b_sage1"],
                       merch_neigh_feat, m2_feat, m2_mask)
    h_user = _sage(params["w_sage2"], params["b_sage2"],
                   user_feat, u_frontier, user_neigh_mask)
    h_merch = _sage(params["w_sage2"], params["b_sage2"],
                    merchant_feat, m_frontier, merch_neigh_mask)
    z = torch.cat([h_user, h_merch, txn_features], dim=-1)
    z = torch.relu(z @ params["w_head1"] + params["b_head1"])
    return (z @ params["w_head2"] + params["b_head2"])[:, 0]
