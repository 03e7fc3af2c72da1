"""GraphSAGE user-merchant network scorer, bipartite and typed.

Port of the JAX package's ``models/gnn.py``: two SAGE layers with a
mask-aware mean over a fixed fan-out, and an MLP head over both centre
embeddings and the 64 transaction features. Two-hop context, when given as
``[B, K, K2, D]`` tensors, feeds the first layer's embedding of the 1-hop
frontier; without it the frontier aggregates nothing.

The typed layout (``init_gnn_params(typed=True)``, the ``w_node_*``
params, detected structurally by ``is_typed_gnn``) serves the typed entity
graph: every node tensor goes through its type's projection
(``typed_node_projection``, the type read from the row's own tag slots)
before any aggregation, and the transaction features are clipped to
[-10, 10] inside the model.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

# Node-type tag slots in the node_dim feature row: users carry no tag,
# merchants slot 8, devices 9, IPs 10
MERCHANT_TAG_SLOT = 8
DEVICE_TAG_SLOT = 9
IP_TAG_SLOT = 10
TYPED_MIN_NODE_DIM = 12     # 8 user stats + 3 type tags + 1 degree slot
TYPED_NODE_TYPES = ("user", "merchant", "device", "ip")


def init_gnn_params(rng: np.random.Generator, node_dim: int = 16,
                    txn_dim: int = 64, hidden: int = 64,
                    head_hidden: int = 64,
                    typed: bool = False) -> Dict[str, torch.Tensor]:
    """GraphSAGE (2 layers) + head parameters, Glorot-normal. ``typed``
    adds one near-identity ``(D, D)`` projection per node type, drawn after
    the shared weights (so those are the same draws in both layouts)."""
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
    if typed:
        if node_dim < TYPED_MIN_NODE_DIM:
            raise ValueError(
                f"typed GNN params need node_dim >= {TYPED_MIN_NODE_DIM} "
                f"(type tags at slots {MERCHANT_TAG_SLOT}/{DEVICE_TAG_SLOT}/"
                f"{IP_TAG_SLOT}), got {node_dim}")
        for name in TYPED_NODE_TYPES:
            params[f"w_node_{name}"] = (np.eye(node_dim)
                                        + 0.1 * glorot((node_dim, node_dim)))
    return {k: torch.from_numpy(np.asarray(v, np.float32))
            for k, v in params.items()}


def is_typed_gnn(params: Dict[str, torch.Tensor]) -> bool:
    return "w_node_user" in params


def typed_node_projection(params: Dict[str, torch.Tensor],
                          feat: torch.Tensor) -> torch.Tensor:
    """Per-node-type linear projection before aggregation: the four type
    matrices blended by the row's tag slots (one-hot by construction, users
    untagged), which selects exactly one matrix per row."""
    tm = feat[..., MERCHANT_TAG_SLOT:MERCHANT_TAG_SLOT + 1]
    td = feat[..., DEVICE_TAG_SLOT:DEVICE_TAG_SLOT + 1]
    ti = feat[..., IP_TAG_SLOT:IP_TAG_SLOT + 1]
    tu = torch.clamp(1.0 - tm - td - ti, 0.0, 1.0)
    return (tu * (feat @ params["w_node_user"])
            + tm * (feat @ params["w_node_merchant"])
            + td * (feat @ params["w_node_device"])
            + ti * (feat @ params["w_node_ip"]))


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
               user_neigh2_feat: Optional[torch.Tensor] = None,   # f32[B, K, K2, D]
               user_neigh2_mask: Optional[torch.Tensor] = None,   # bool[B, K, K2]
               merch_neigh2_feat: Optional[torch.Tensor] = None,  # f32[B, K, K2, D]
               merch_neigh2_mask: Optional[torch.Tensor] = None,  # bool[B, K, K2]
               ) -> torch.Tensor:
    """Fraud logit per scored (user, merchant, txn) edge. f32[B]."""
    if is_typed_gnn(params):
        txn_features = torch.clamp(txn_features, -10.0, 10.0)

        def proj(x):
            return typed_node_projection(params, x)

        user_feat, merchant_feat = proj(user_feat), proj(merchant_feat)
        user_neigh_feat = proj(user_neigh_feat)
        merch_neigh_feat = proj(merch_neigh_feat)
        if user_neigh2_feat is not None:
            user_neigh2_feat = proj(user_neigh2_feat)
        if merch_neigh2_feat is not None:
            merch_neigh2_feat = proj(merch_neigh2_feat)
    if user_neigh2_feat is None:
        user_neigh2_feat, user_neigh2_mask = _empty_frontier(user_neigh_feat)
    if merch_neigh2_feat is None:
        merch_neigh2_feat, merch_neigh2_mask = _empty_frontier(merch_neigh_feat)
    u_frontier = _sage(params["w_sage1"], params["b_sage1"],
                       user_neigh_feat, user_neigh2_feat, user_neigh2_mask)
    m_frontier = _sage(params["w_sage1"], params["b_sage1"],
                       merch_neigh_feat, merch_neigh2_feat, merch_neigh2_mask)
    h_user = _sage(params["w_sage2"], params["b_sage2"],
                   user_feat, u_frontier, user_neigh_mask)
    h_merch = _sage(params["w_sage2"], params["b_sage2"],
                    merchant_feat, m_frontier, merch_neigh_mask)
    z = torch.cat([h_user, h_merch, txn_features], dim=-1)
    z = torch.relu(z @ params["w_head1"] + params["b_head1"])
    return (z @ params["w_head2"] + params["b_head2"])[:, 0]



def gnn_predict(params, txn_features, user_feat, merchant_feat,
                user_neigh_feat, user_neigh_mask,
                merch_neigh_feat, merch_neigh_mask) -> torch.Tensor:
    """1-hop fraud probability (the serving path; 2-hop is a training option)."""
    return torch.sigmoid(gnn_logits(
        params, txn_features, user_feat, merchant_feat,
        user_neigh_feat, user_neigh_mask, merch_neigh_feat, merch_neigh_mask,
    ))

def build_node_features(user_pool, merchant_pool,
                        node_dim: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """Static node feature tables from the simulator's profile pools.

    User rows: [risk, log avg amount, frequency, age/365, verified, weekend,
    intl, online], zero-padded to ``node_dim``; merchant rows: [risk code/2,
    fraud rate, log avg amount, blacklisted, category/10, opening hour/24,
    closing hour/24], with the merchant tag at slot 8 (so ``node_dim`` >= 9).
    """
    if node_dim < 9:
        raise ValueError(f"node_dim must be >= 9 (8 stat slots + type tag), got {node_dim}")
    u = np.zeros((user_pool.n, node_dim), np.float32)
    u[:, 0] = user_pool.risk_score
    u[:, 1] = np.log1p(user_pool.avg_amount)
    u[:, 2] = user_pool.txn_frequency
    u[:, 3] = user_pool.account_age_days / 365.0
    u[:, 4] = (user_pool.kyc_code == 0)
    u[:, 5] = user_pool.weekend_activity
    u[:, 6] = user_pool.intl_ratio
    u[:, 7] = user_pool.online_preference

    m = np.zeros((merchant_pool.n, node_dim), np.float32)
    m[:, 0] = merchant_pool.risk_code / 2.0
    m[:, 1] = merchant_pool.fraud_rate
    m[:, 2] = np.log1p(merchant_pool.avg_amount)
    m[:, 3] = merchant_pool.is_blacklisted
    m[:, 4] = merchant_pool.category_code / 10.0
    m[:, 5] = merchant_pool.op_start / 24.0
    m[:, 6] = merchant_pool.op_end / 24.0
    m[:, MERCHANT_TAG_SLOT] = 1.0
    return u, m


def gather_neighbor_features(node_table: np.ndarray, idx: np.ndarray,
                             mask: np.ndarray) -> np.ndarray:
    """Safe gather: padded (-1) indices read row 0 but are masked out."""
    return node_table[np.where(mask, idx, 0)]


def typed_entity_features(kind: str, degrees: np.ndarray, node_dim: int,
                          fanout: int) -> np.ndarray:
    """Node feature rows for the profile-less entity types (device, IP, cold
    merchant) of the typed graph: slot 0 the ring occupancy over the
    fan-out, slot 1 log1p(degree), and the type's tag slot 1.0."""
    tag = {"merchant": MERCHANT_TAG_SLOT, "device": DEVICE_TAG_SLOT,
           "ip": IP_TAG_SLOT}.get(kind)
    if tag is None:
        raise ValueError(f"typed_entity_features kind must be "
                         f"merchant|device|ip, got {kind!r}")
    if node_dim < TYPED_MIN_NODE_DIM:
        raise ValueError(
            f"typed entity features need node_dim >= {TYPED_MIN_NODE_DIM}, "
            f"got {node_dim}")
    deg = np.asarray(degrees, np.float32)
    rows = np.zeros((len(deg), node_dim), np.float32)
    rows[:, 0] = np.minimum(deg, float(fanout)) / max(float(fanout), 1.0)
    rows[:, 1] = np.log1p(deg)
    rows[:, tag] = 1.0
    return rows
