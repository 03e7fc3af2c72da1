"""Neural branch training: LSTM and GraphSAGE on simulated streams.

Port of the JAX package's ``training/neural.py``. One minibatch BCE loop
(``NeuralTrainer``: ``torch.optim`` in place of optax, autograd in place of
``jax.value_and_grad``) plus dataset builders that replay the simulator's
stream through the state stores, so the LSTM trains on per-user histories
exactly as serving gathers them (``state.history.UserHistoryStore``) and the
GNN on a user-merchant graph that grows edge by edge
(``state.history.EntityGraphStore``) or on the typed entity graph through the
serving sampler (``graph.sampler.NeighborSampler``).

Where the JAX package draws initial weights from ``jax.random.PRNGKey(seed)``,
which the port cannot reproduce, the port draws them from its own seeded
numpy initialisers (the ones ``init_scoring_models`` uses: the draws happen
on the host, so the card and the CPU start from the same weights). Each
trainer takes a keyword-only ``init`` to start from given parameters
instead (a seam for holding the port against the JAX trainer from the same
weights). The batch order is numpy's ``default_rng(seed)`` permutation, as
in JAX, and the last partial batch is dropped.

Training runs the plain model functions, never the CUDA kernels (they have
no backward): f32 products with TF32 off, the bf16 rounding of the served
LSTM and BERT products emulated in f32 (``core/precision.py``), plain
attention, dense int8-free BERT weights. It runs on the card unless
``device="cpu"``, and refuses a CUDA device when there is no card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from realtime_fraud_detection_tpu_torch.features.extract import extract_features_host
from realtime_fraud_detection_tpu_torch.models.gnn import (
    build_node_features,
    gather_neighbor_features,
    gnn_logits,
    init_gnn_params,
)
from realtime_fraud_detection_tpu_torch.models.lstm import init_lstm_params, lstm_logits
from realtime_fraud_detection_tpu_torch.state.history import EntityGraphStore, UserHistoryStore
from realtime_fraud_detection_tpu_torch.training.calibrate import (
    calibrate_gnn_head,
    calibrate_lstm_head,
    platt_fit,
)

logger = logging.getLogger(__name__)


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(logits, labels)


def weighted_bce_loss(logits: torch.Tensor, labels: torch.Tensor,
                      pos_weight: float) -> torch.Tensor:
    """BCE with the positive class up-weighted: at the stream's ~5% fraud
    rate unweighted BCE under-fits the positives. Weighting inflates the
    predicted probabilities; fold a Platt fit into the head before blending
    (``training/calibrate.py``)."""
    per = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
    return (per * torch.where(labels > 0.5, pos_weight, 1.0)).mean()


def auto_pos_weight(labels: np.ndarray) -> float:
    """neg/pos ratio, the standard balanced weighting."""
    p = float(np.asarray(labels).mean())
    return (1.0 - p) / max(p, 1e-6)


# --------------------------------------------------------------------------
# parameter trees
# --------------------------------------------------------------------------

def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` over every tensor leaf of nested dicts / lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def training_device(device: str | torch.device) -> torch.device:
    """The device a trainer runs on; a CUDA device without a card raises
    (no trainer carries on on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training: no CUDA device available (pass "
                           "device='cpu' to train on the CPU)")
    return device


@contextlib.contextmanager
def exact_f32():
    """TF32 off for the duration: the trainers' f32 products (and the
    GEMM-form trees scored beside them) need full f32 matmuls."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def adam(learning_rate: float) -> Callable[[List[torch.Tensor]], torch.optim.Optimizer]:
    """``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8 (torch's defaults)."""
    return lambda leaves: torch.optim.Adam(leaves, lr=learning_rate)


def adamw(learning_rate: float, weight_decay: float = 1e-4
          ) -> Callable[[List[torch.Tensor]], torch.optim.Optimizer]:
    """``optax.adamw(lr)``: its weight decay defaults to 1e-4, where
    ``torch.optim.AdamW``'s defaults to 1e-2, so it is passed."""
    return lambda leaves: torch.optim.AdamW(leaves, lr=learning_rate,
                                            weight_decay=weight_decay)


@dataclasses.dataclass
class NeuralTrainer:
    """Minibatch training loop shared by the LSTM, GNN and BERT branches.

    ``optimizer`` builds the optimizer over the parameter leaves (``adam``
    of ``learning_rate`` when None). ``train`` returns the trained
    parameters (detached, on ``device``) and leaves ``last_run``: the
    optimizer steps taken and the loop's seconds (the card synchronised at
    both ends)."""

    learning_rate: float = 1e-3
    batch_size: int = 256
    epochs: int = 3
    seed: int = 0
    optimizer: Optional[Callable[[List[torch.Tensor]], torch.optim.Optimizer]] = None
    device: str = "cuda"

    def train(
        self,
        params: Dict[str, Any],
        loss_fn: Callable[[Dict[str, Any], Tuple, torch.Tensor], torch.Tensor],
        inputs: Tuple[np.ndarray, ...],
        labels: np.ndarray,
    ) -> Dict[str, Any]:
        device = training_device(self.device)
        params = tree_map(lambda t: torch.as_tensor(t).detach().to(
            device=device, dtype=torch.float32).clone().requires_grad_(True), params)
        opt = (self.optimizer or adam(self.learning_rate))(list(tree_leaves(params)))
        dev_inputs = tuple(torch.as_tensor(np.ascontiguousarray(a)).to(device)
                           for a in inputs)
        dev_labels = torch.as_tensor(np.asarray(labels, np.float32)).to(device)

        n = len(labels)
        rng = np.random.default_rng(self.seed)
        bs = min(self.batch_size, n)
        steps = 0
        with exact_f32():
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(self.epochs):
                order = torch.from_numpy(rng.permutation(n)).to(device)
                for start in range(0, n - bs + 1, bs):
                    idx = order[start:start + bs]
                    loss = loss_fn(params, tuple(a[idx] for a in dev_inputs),
                                   dev_labels[idx])
                    opt.zero_grad(set_to_none=True)
                    loss.backward()
                    opt.step()
                    steps += 1
            _sync(device)
            seconds = time.perf_counter() - t0
        self.last_run = {"steps": steps, "seconds": seconds,
                         "ms_per_step": 1e3 * seconds / max(steps, 1),
                         "device": str(device)}
        logger.info("NeuralTrainer: %d steps in %.3f s on %s", steps, seconds, device)
        return tree_map(lambda t: t.detach(), params)


def _record(stats: Optional[Dict[str, Any]], trainer: NeuralTrainer) -> None:
    if stats is not None:
        stats.update(trainer.last_run)


@torch.no_grad()
def eval_logits(fn: Callable[..., torch.Tensor], params, arrays: Sequence[np.ndarray],
                device: torch.device, chunk: int = 4096) -> np.ndarray:
    """``fn(params, *arrays)`` on ``device`` in row chunks -> numpy."""
    n = len(arrays[0])
    out = []
    with exact_f32():
        for s in range(0, n, chunk):
            out.append(fn(params, *(torch.as_tensor(np.ascontiguousarray(a[s:s + chunk]))
                                    .to(device) for a in arrays)).float().cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0,), np.float32)


# --------------------------------------------------------------------------
# dataset builders
# --------------------------------------------------------------------------

def build_sequence_dataset(
    generator,
    n_transactions: int,
    seq_len: int = 10,
    feature_dim: int = 64,
    chunk: int = 4096,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Replay a stream through UserHistoryStore -> (sequences, lengths,
    labels). The label of a sequence is the fraud label of its most recent
    step (reference sequence_length 10, config.py:151-157)."""
    store = UserHistoryStore(seq_len=seq_len, feature_dim=feature_dim)
    seqs, lens, labels = [], [], []
    remaining = n_transactions
    while remaining > 0:
        b = min(chunk, remaining)
        remaining -= b
        batch, lab = generator.generate_encoded(b)
        # the serving-side clip keeps neural inputs in a trainable range
        feats = np.clip(extract_features_host(batch), -10, 10)
        user_ids = [str(generator.users.ids[i]) for i in lab["user_index"]]
        s, l = store.append_and_gather(user_ids, feats)
        seqs.append(s)
        lens.append(l)
        labels.append(lab["is_fraud"])
    return (
        np.concatenate(seqs, axis=0),
        np.concatenate(lens, axis=0),
        np.concatenate(labels, axis=0).astype(np.float32),
    )


def build_graph_dataset(
    generator,
    n_transactions: int,
    fanout: int = 16,
    node_dim: int = 16,
    chunk: int = 512,
):
    """Replay a stream through EntityGraphStore -> GNN training tensors.
    Edges commit per chunk, so a chunk's samples see only earlier chunks'
    edges (no label leakage through the current batch)."""
    graph = EntityGraphStore(fanout=fanout)
    user_table, merchant_table = build_node_features(
        generator.users, generator.merchants, node_dim)
    txn_f, uf, mf, unf, unm, mnf, mnm, labels = [], [], [], [], [], [], [], []
    remaining = n_transactions
    while remaining > 0:
        b = min(chunk, remaining)
        remaining -= b
        batch, lab = generator.generate_encoded(b)
        feats = np.clip(extract_features_host(batch), -10, 10)
        u_idx, m_idx = lab["user_index"], lab["merchant_index"]
        un, un_mask = graph.user_neighbors(u_idx)
        mn, mn_mask = graph.merchant_neighbors(m_idx)
        txn_f.append(feats)
        uf.append(user_table[u_idx])
        mf.append(merchant_table[m_idx])
        unf.append(gather_neighbor_features(merchant_table, un, un_mask))
        unm.append(un_mask)
        mnf.append(gather_neighbor_features(user_table, mn, mn_mask))
        mnm.append(mn_mask)
        labels.append(lab["is_fraud"])
        graph.add_edges(u_idx, m_idx)  # edges visible to FUTURE batches only
    cat = lambda xs: np.concatenate(xs, axis=0)  # noqa: E731
    return (
        (cat(txn_f), cat(uf), cat(mf), cat(unf), cat(unm), cat(mnf), cat(mnm)),
        cat(labels).astype(np.float32),
        (user_table, merchant_table, graph),
    )


def build_typed_graph_dataset(
    generator,
    n_transactions: int,
    fanout: int = 8,
    fanout2: int = 8,
    node_dim: int = 16,
    chunk: int = 256,
):
    """Replay a stream through the typed entity graph -> GNN tensors.

    Edges (user-device, user-merchant, user-IP) commit per chunk after the
    chunk's samples are drawn (sample, then insert: the serving order), and
    the sampling runs through the serving ``NeighborSampler``, so the GNN
    trains on the tensors it is served. A user's profile row is visible to
    two-hop cohorts only once that user has been scored (the serving entity
    index's visibility). Returns ``(inputs, labels, graph)`` with inputs in
    ``gnn_logits``' positional order (txn, user, merchant, u-neigh x2,
    m-neigh x2, u-2hop x2, m-2hop x2).
    """
    from realtime_fraud_detection_tpu_torch.features.schema import encode_transactions
    from realtime_fraud_detection_tpu_torch.graph.sampler import NeighborSampler
    from realtime_fraud_detection_tpu_torch.graph.store import TypedEntityGraph

    user_table, merchant_table = build_node_features(
        generator.users, generator.merchants, node_dim)
    uid_to_row = {str(u): i for i, u in enumerate(generator.users.ids)}
    mid_to_row = {str(m): i for i, m in enumerate(generator.merchants.ids)}
    seen_users: set = set()

    def user_rows(ids):
        out = np.zeros((len(ids), node_dim), np.float32)
        for k, i in enumerate(ids):
            i = str(i)
            r = uid_to_row.get(i)
            if r is not None and i in seen_users:
                out[k] = user_table[r]
        return out

    def merchant_rows(ids):
        out = np.zeros((len(ids), node_dim), np.float32)
        for k, i in enumerate(ids):
            r = mid_to_row.get(str(i))
            if r is not None:
                out[k] = merchant_table[r]
        return out

    graph = TypedEntityGraph(fanout=fanout)
    sampler = NeighborSampler(graph, node_dim, fanout, fanout2,
                              user_rows=user_rows, merchant_rows=merchant_rows)
    uprofs = generator.users.profiles()
    mprofs = generator.merchants.profiles()
    keys = ("txn", "uf", "mf", "unf", "unm", "mnf", "mnm",
            "un2f", "un2m", "mn2f", "mn2m")
    cols: Dict[str, list] = {k: [] for k in keys + ("y",)}
    remaining = n_transactions
    while remaining > 0:
        b = min(chunk, remaining)
        remaining -= b
        records = generator.generate_batch(b)
        user_ids = [str(r["user_id"]) for r in records]
        merchant_ids = [str(r["merchant_id"]) for r in records]
        seen_users.update(user_ids)     # centres are known within the batch
        txn = encode_transactions(records, uprofs, mprofs, {})
        # raw features: the typed GNN clips inside the model, as served
        feats = extract_features_host(txn)
        s = sampler.sample(user_ids, merchant_ids)
        cols["txn"].append(feats)
        cols["uf"].append(user_rows(user_ids))
        cols["mf"].append(merchant_rows(merchant_ids))
        cols["unf"].append(s["user_neigh_feat"])
        cols["unm"].append(s["user_neigh_mask"])
        cols["mnf"].append(s["merch_neigh_feat"])
        cols["mnm"].append(s["merch_neigh_mask"])
        cols["un2f"].append(s["user_neigh2_feat"])
        cols["un2m"].append(s["user_neigh2_mask"])
        cols["mn2f"].append(s["merch_neigh2_feat"])
        cols["mn2m"].append(s["merch_neigh2_mask"])
        cols["y"].append(np.asarray(
            [bool(r.get("is_fraud")) for r in records], np.float32))
        # edges visible to FUTURE chunks only; the sync drops the sampler
        # cache entries the new edges invalidate
        graph.add_batch(user_ids, merchant_ids,
                        [str(r.get("device_id") or "") for r in records],
                        [str(r.get("ip_address") or "") for r in records])
        sampler.sync()
    cat = lambda xs: np.concatenate(xs, axis=0)  # noqa: E731
    inputs = tuple(cat(cols[k]) for k in keys)
    return inputs, cat(cols["y"]).astype(np.float32), graph


# --------------------------------------------------------------------------
# end-to-end trainers
# --------------------------------------------------------------------------

def _calibration_split(n: int, frac: float = 0.1, min_rows: int = 200) -> int:
    """Rows reserved at the stream tail for the Platt fit (a temporal split:
    calibrate on data later than anything trained on). Returns 0
    (calibration disabled, with a warning) when the slice would take half
    or more of the dataset: training data comes first."""
    n_cal = max(min_rows, int(n * frac))
    if n_cal * 2 > n:
        logger.warning(
            "calibration disabled: the tail slice (%d rows, min %d) would "
            "consume >= half of the %d-row dataset; train on everything "
            "and skip the Platt fit", n_cal, min_rows, n)
        return 0
    return n_cal


def train_lstm(
    generator, n_transactions: int = 50_000, seq_len: int = 10,
    hidden: int = 128, epochs: int = 3, seed: int = 0,
    pos_weight: float | None = None, calibrate: bool = True, *,
    init: Any = None, device: str = "cuda",
    stats: Optional[Dict[str, Any]] = None,
) -> Dict[str, torch.Tensor]:
    """``pos_weight=None`` is auto (the neg/pos ratio); 1.0 gives unweighted
    BCE. ``calibrate`` holds out the stream tail, fits Platt scaling there
    and folds it into the head. ``stats``, when given, receives the loop's
    ``NeuralTrainer.last_run``."""
    dev = training_device(device)
    seqs, lens, labels = build_sequence_dataset(generator, n_transactions, seq_len)
    n_cal = _calibration_split(len(labels)) if calibrate else 0
    tr_sl = slice(0, len(labels) - n_cal)
    if init is None:
        init = init_lstm_params(np.random.default_rng(seed), seqs.shape[-1], hidden)
    pw = (auto_pos_weight(labels[tr_sl]) if pos_weight is None
          else float(pos_weight))

    def loss_fn(p, inputs, y):
        s, l = inputs
        return weighted_bce_loss(lstm_logits(p, s, l), y, pw)

    trainer = NeuralTrainer(epochs=epochs, seed=seed, device=str(dev))
    params = trainer.train(init, loss_fn, (seqs[tr_sl], lens[tr_sl]), labels[tr_sl])
    _record(stats, trainer)
    if n_cal and 0 < labels[-n_cal:].sum() < n_cal:
        z = eval_logits(lstm_logits, params, (seqs[-n_cal:], lens[-n_cal:]), dev)
        a, b = platt_fit(z, labels[-n_cal:])
        params = calibrate_lstm_head(params, a, b)
    return params


def _train_gnn_on(inputs, labels, params, epochs: int, seed: int,
                  pos_weight: float | None, calibrate: bool, dev: torch.device,
                  stats: Optional[Dict[str, Any]]):
    """The GNN recipe shared by the bipartite and the typed trainer: auto
    class weighting, tail-split Platt calibration folded into the head."""
    n_cal = _calibration_split(len(labels)) if calibrate else 0
    tr_sl = slice(0, len(labels) - n_cal)
    pw = (auto_pos_weight(labels[tr_sl]) if pos_weight is None
          else float(pos_weight))

    def loss_fn(p, batch_inputs, y):
        return weighted_bce_loss(gnn_logits(p, *batch_inputs), y, pw)

    trainer = NeuralTrainer(epochs=epochs, seed=seed, device=str(dev))
    params = trainer.train(params, loss_fn, tuple(a[tr_sl] for a in inputs),
                           labels[tr_sl])
    _record(stats, trainer)
    if n_cal and 0 < labels[-n_cal:].sum() < n_cal:
        z = eval_logits(gnn_logits, params, [a[-n_cal:] for a in inputs], dev)
        a, b = platt_fit(z, labels[-n_cal:])
        params = calibrate_gnn_head(params, a, b)
    return params


def train_typed_gnn(
    generator, n_transactions: int = 20_000, fanout: int = 8,
    fanout2: int = 8, node_dim: int = 16, hidden: int = 64,
    epochs: int = 3, seed: int = 0, pos_weight: float | None = None,
    calibrate: bool = True, *, init: Any = None, device: str = "cuda",
    stats: Optional[Dict[str, Any]] = None,
):
    """Train the typed entity-graph GNN branch (the recipe of
    :func:`train_gnn` over the typed two-hop tensors). Returns the typed
    parameter dict (``is_typed_gnn`` true)."""
    dev = training_device(device)
    inputs, labels, _graph = build_typed_graph_dataset(
        generator, n_transactions, fanout, fanout2, node_dim)
    if init is None:
        init = init_gnn_params(np.random.default_rng(seed), node_dim,
                               inputs[0].shape[-1], hidden, typed=True)
    return _train_gnn_on(inputs, labels, init, epochs, seed, pos_weight,
                         calibrate, dev, stats)


def train_gnn(
    generator, n_transactions: int = 50_000, fanout: int = 16,
    node_dim: int = 16, hidden: int = 64, epochs: int = 3, seed: int = 0,
    pos_weight: float | None = None, calibrate: bool = True, *,
    init: Any = None, device: str = "cuda",
    stats: Optional[Dict[str, Any]] = None,
):
    """``pos_weight=None`` is auto; ``calibrate`` folds a tail-fitted Platt
    transform into the head (see :func:`train_lstm`). Returns (params,
    user table, merchant table, graph)."""
    dev = training_device(device)
    inputs, labels, (user_table, merchant_table, graph) = build_graph_dataset(
        generator, n_transactions, fanout, node_dim)
    if init is None:
        init = init_gnn_params(np.random.default_rng(seed), node_dim,
                               inputs[0].shape[-1], hidden)
    params = _train_gnn_on(inputs, labels, init, epochs, seed, pos_weight,
                           calibrate, dev, stats)
    return params, user_table, merchant_table, graph
