"""Distributed joint training step for the neural branches.

Port of the JAX package's ``parallel/train.py``: one step computes the joint
BCE loss of the LSTM, the GNN and the DistilBERT branch and updates them with
a ``torch.optim`` optimizer, with

- **DP** over the ``data`` mesh axis: each data row of the mesh scores its
  rows of the batch, its gradient is taken alone, and the rows' gradients
  are averaged in row order (the data-parallel all-reduce, fixed order);
- **TP** for the DistilBERT branch over ``model`` (``parallel/layouts.py
  bert_param_specs``): each model position multiplies with its column block
  of q / k / v / ffn1 (its heads) and its row block of o / ffn2, and the
  row-parallel partial products meet in ``psum_model`` before the bias.

The step runs as ``shard_map_over`` (one thread a position, each on its own
stream on a card); the parameters live once, as full tensors on the mesh's
first device, and each position reads its block of them, so the optimizer
is one ``torch.optim`` optimizer over the full tensors (Adam and SGD are
elementwise: the same update as over the blocks).

Across processes (``run_two_process_step``): each process runs the step on
its own positions and rows, and the gradients and losses of the processes
meet over ``torch.distributed`` (``gloo``), added in rank order.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from realtime_fraud_detection_tpu_torch.core.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    MeshConfig,
    P,
    build_mesh,
    tree_leaves,
    tree_map,
)
from realtime_fraud_detection_tpu_torch.core.precision import matmul_cd
from realtime_fraud_detection_tpu_torch.models.bert import (
    BertConfig,
    _layer_norm,
    bert_embed,
    bert_logits,
)
from realtime_fraud_detection_tpu_torch.models.gnn import gnn_logits
from realtime_fraud_detection_tpu_torch.models.lstm import lstm_logits
from realtime_fraud_detection_tpu_torch.ops.attention import (
    attention_reference,
    flash_attention,
)
from realtime_fraud_detection_tpu_torch.parallel.collectives import (
    axis_size,
    psum_model,
    shard_map_over,
)
from realtime_fraud_detection_tpu_torch.parallel.layouts import (
    batch_shardings,
    bert_param_specs,
    tree_specs_to_shardings,
)

__all__ = ["TrainBatch", "TrainState", "init_train_state", "joint_loss",
           "make_train_step", "neural_param_shardings", "run_two_process_step",
           "shard_train_batch", "tiny_train_setup"]


@dataclasses.dataclass
class TrainBatch:
    """Dense supervised batch for the three neural branches."""

    features: Any          # f32[B, 64]
    history: Any           # f32[B, T, F]
    history_len: Any       # i32[B]
    user_feat: Any         # f32[B, D]
    merchant_feat: Any     # f32[B, D]
    user_neigh_feat: Any   # f32[B, K, D]
    user_neigh_mask: Any   # bool[B, K]
    merch_neigh_feat: Any  # f32[B, K, D]
    merch_neigh_mask: Any  # bool[B, K]
    token_ids: Any         # i32[B, S]
    token_mask: Any        # bool[B, S]
    labels: Any            # f32[B]


@dataclasses.dataclass
class TrainState:
    params: Dict[str, Any]         # {"lstm", "gnn", "bert"}: full tensors
    opt_state: torch.optim.Optimizer
    step: int
    mesh: Mesh


def _specs(params: Dict[str, Any]) -> Dict[str, Any]:
    rep = tree_map(lambda _: P(), {"lstm": params["lstm"], "gnn": params["gnn"]})
    return {"lstm": rep["lstm"], "gnn": rep["gnn"], "bert": bert_param_specs(params["bert"])}


def neural_param_shardings(mesh: Mesh, params: Dict[str, Any]) -> Dict[str, Any]:
    """Layout table for the joint neural param dict (BERT TP, rest
    replicated)."""
    return tree_specs_to_shardings(mesh, _specs(params))


def init_train_state(mesh: Mesh, params: Dict[str, Any],
                     optimizer: Callable[[List[torch.Tensor]], torch.optim.Optimizer]
                     ) -> TrainState:
    """The parameters as f32 leaves on the mesh's first device, and the
    optimizer (``optimizer(leaves)``, e.g. ``lambda ps: torch.optim.AdamW(
    ps, lr=1e-3, weight_decay=1e-4)``) over them."""
    home = mesh.device(mesh.local_positions()[0])
    leaves = tree_map(lambda t: torch.as_tensor(np.asarray(t) if not isinstance(
        t, torch.Tensor) else t).to(home, torch.float32).detach().clone()
        .requires_grad_(True), params)
    return TrainState(params=leaves, opt_state=optimizer(tree_leaves(leaves)),
                      step=0, mesh=mesh)


def _to_tensors(batch: TrainBatch) -> TrainBatch:
    return tree_map(lambda x: x if isinstance(x, torch.Tensor)
                    else torch.from_numpy(np.ascontiguousarray(x)), batch)


def _branch_losses(params, batch: TrainBatch, bert_fn) -> Tuple[torch.Tensor, ...]:
    labels = batch.labels.to(torch.float32)
    lstm_l = F.binary_cross_entropy_with_logits(
        lstm_logits(params["lstm"], batch.history, batch.history_len), labels)
    gnn_l = F.binary_cross_entropy_with_logits(gnn_logits(
        params["gnn"], batch.features, batch.user_feat, batch.merchant_feat,
        batch.user_neigh_feat, batch.user_neigh_mask.to(torch.bool),
        batch.merch_neigh_feat, batch.merch_neigh_mask.to(torch.bool)), labels)
    logits2 = bert_fn(params["bert"], batch.token_ids, batch.token_mask.to(torch.bool))
    bert_l = F.binary_cross_entropy_with_logits(logits2[:, 1] - logits2[:, 0], labels)
    return lstm_l + gnn_l + bert_l, lstm_l, gnn_l, bert_l


def joint_loss(params: Dict[str, Any], batch: TrainBatch, bert_config: BertConfig,
               use_flash: bool = False,
               compute_dtype: torch.dtype = torch.bfloat16
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sum of the per-branch BCE losses, and the per-branch dict (one
    position, no sharding)."""
    total, lstm_l, gnn_l, bert_l = _branch_losses(
        params, _to_tensors(batch),
        lambda p, ids, mask: bert_logits(p, ids, mask, bert_config, use_flash=use_flash,
                                         compute_dtype=compute_dtype))
    return total, {"lstm": lstm_l, "gnn": gnn_l, "bert": bert_l}


def _tp_bert_logits(bert: Dict[str, Any], ids: torch.Tensor, mask: torch.Tensor,
                    config: BertConfig, use_flash: bool,
                    compute_dtype: torch.dtype) -> torch.Tensor:
    """The BERT logits with each layer's dense products split over
    ``model``: this position's heads (column blocks of q / k / v, of ffn1)
    and the row blocks of o / ffn2, whose partial products are summed over
    the axis before the bias."""
    n_model = axis_size(MODEL_AXIS)
    if config.num_heads % n_model:
        raise ValueError(f"num_heads={config.num_heads} not divisible by the "
                         f"model-axis size {n_model}")
    heads = config.num_heads // n_model
    eps = config.layer_norm_eps
    x = bert_embed(bert, ids, config)
    b, s = ids.shape
    attend = flash_attention if use_flash else attention_reference

    def col(p, h):
        return matmul_cd(h, p["w"], compute_dtype) + p["b"]

    def split(t):
        return t.reshape(b, s, heads, config.head_dim).permute(0, 2, 1, 3)

    for layer in bert["layers"]:
        q, k, v = (col(layer[n], x) for n in ("q", "k", "v"))
        ctx = attend(split(q), split(k), split(v), mask)
        ctx = ctx.permute(0, 2, 1, 3).reshape(b, s, heads * config.head_dim)
        attn_out = psum_model(matmul_cd(ctx, layer["o"]["w"], compute_dtype)) + layer["o"]["b"]
        x = _layer_norm(x + attn_out, layer["attn_ln"], eps)
        hidden = F.gelu(col(layer["ffn1"], x), approximate="tanh")
        ffn = psum_model(matmul_cd(hidden, layer["ffn2"]["w"], compute_dtype)) \
            + layer["ffn2"]["b"]
        x = _layer_norm(x + ffn, layer["ffn_ln"], eps)
    cls = x[:, 0, :]
    z = torch.relu(cls @ bert["pre_classifier"]["w"] + bert["pre_classifier"]["b"])
    return z @ bert["classifier"]["w"] + bert["classifier"]["b"]


def _row_losses(state: TrainState, batch: TrainBatch, bert_config: BertConfig,
                use_flash: bool, compute_dtype: torch.dtype) -> torch.Tensor:
    """f32[D, 4]: each data row's (total, lstm, gnn, bert) loss on its rows,
    read at its model position 0, each with its own graph back to the
    parameters."""
    def body(params, local):
        losses = _branch_losses(params, local, lambda p, ids, m: _tp_bert_logits(
            p, ids, m, bert_config, use_flash, compute_dtype))
        return torch.stack(losses)[None, :]

    batch_spec = tree_map(lambda _: P(DATA_AXIS), batch)
    return shard_map_over(state.mesh, body, in_specs=(_specs(state.params), batch_spec),
                          out_specs=P(DATA_AXIS))(state.params, _to_tensors(batch))


def _all_processes_sum(vec: torch.Tensor) -> torch.Tensor:
    """Sum over the processes of ``torch.distributed`` in rank order (one
    process: ``vec``). The vectors travel through host memory (gloo)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return vec
    host = vec.detach().to("cpu")
    parts = [torch.empty_like(host) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, host)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total.to(vec.device)


def make_train_step(bert_config: BertConfig, use_flash: bool = False,
                    compute_dtype: torch.dtype = torch.bfloat16
                    ) -> Callable[[TrainState, TrainBatch],
                                  Tuple[TrainState, Dict[str, float]]]:
    """The DP + TP joint train step (the optimizer rides the state,
    ``init_train_state``). Each data row's gradient is taken alone and the
    rows' gradients are averaged in row order (then across processes in
    rank order); the optimizer steps once."""

    def step(state: TrainState, batch: TrainBatch):
        leaves = tree_leaves(state.params)
        rows = _row_losses(state, batch, bert_config, use_flash, compute_dtype)
        n_rows = rows.shape[0]
        grad_sum = None
        for d in range(n_rows):
            grads = torch.autograd.grad(rows[d, 0], leaves, retain_graph=d < n_rows - 1)
            flat = torch.cat([g.reshape(-1) for g in grads])
            grad_sum = flat if grad_sum is None else grad_sum + flat
        loss_sum = _ordered_sum(rows.detach())
        world = _world_size()
        total = _all_processes_sum(torch.cat([grad_sum, loss_sum]))
        denom = float(n_rows * world)
        g = total[:grad_sum.numel()] / denom
        losses = total[grad_sum.numel():] / denom
        offset = 0
        for leaf in leaves:
            n = leaf.numel()
            leaf.grad = g[offset:offset + n].view_as(leaf).clone()
            offset += n
        state.opt_state.step()
        state.opt_state.zero_grad(set_to_none=True)
        state.step += 1
        vals = [float(v) for v in losses.tolist()]
        return state, {"loss": vals[0], "lstm": vals[1], "gnn": vals[2], "bert": vals[3]}

    return step


def _ordered_sum(rows: torch.Tensor) -> torch.Tensor:
    total = rows[0]
    for r in rows[1:]:
        total = total + r
    return total


def _world_size() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def shard_train_batch(mesh: Mesh, batch: TrainBatch) -> Any:
    """The batch with every leaf split over ``data`` (``ShardedTensor``s);
    the step itself takes the host batch and splits it the same way."""
    from realtime_fraud_detection_tpu_torch.core.mesh import device_put

    return tree_map(lambda x, s: device_put(x, s), batch, batch_shardings(mesh, batch))


# ------------------------------------------------------------ two processes
def tiny_train_setup(b: int, seed: int = 0, param_seed: int = 0):
    """(params, host TrainBatch) for the joint step at small shapes (TINY
    BERT, LSTM hidden 32, GNN hidden 16), from numpy seeds."""
    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG, init_bert_params
    from realtime_fraud_detection_tpu_torch.models.gnn import init_gnn_params
    from realtime_fraud_detection_tpu_torch.models.lstm import init_lstm_params

    prng = np.random.default_rng(param_seed)
    params = {
        "lstm": init_lstm_params(prng, feature_dim=64, hidden=32, head_hidden=16),
        "gnn": init_gnn_params(prng, node_dim=16, txn_dim=64, hidden=16, head_hidden=16),
        "bert": init_bert_params(prng, TINY_CONFIG),
    }
    t, f, d, k, s = 4, 64, 16, 4, 16
    rng = np.random.default_rng(seed)
    batch = TrainBatch(
        features=rng.standard_normal((b, f)).astype(np.float32),
        history=rng.standard_normal((b, t, f)).astype(np.float32),
        history_len=np.full((b,), t, np.int32),
        user_feat=rng.standard_normal((b, d)).astype(np.float32),
        merchant_feat=rng.standard_normal((b, d)).astype(np.float32),
        user_neigh_feat=rng.standard_normal((b, k, d)).astype(np.float32),
        user_neigh_mask=np.ones((b, k), bool),
        merch_neigh_feat=rng.standard_normal((b, k, d)).astype(np.float32),
        merch_neigh_mask=np.ones((b, k), bool),
        token_ids=rng.integers(0, 30522, (b, s)).astype(np.int32),
        token_mask=np.ones((b, s), bool),
        labels=rng.integers(0, 2, (b,)).astype(np.float32),
    )
    return params, batch


def _two_process_child(coordinator: str, n_processes: int, process_id: int,
                       positions: int, device: str) -> None:
    """One process of ``run_two_process_step``: joins the group, runs the
    joint step on its rows and the packed fused scorer on its rows, and
    prints one JSON line with both against a one-process run of the whole
    batch."""
    import torch.distributed as dist

    from realtime_fraud_detection_tpu_torch.core.mesh import (
        build_multihost_mesh,
        init_distributed,
        make_global_batch,
    )
    from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(coordinator, n_processes, process_id)
    model_axis = 2 if positions % 2 == 0 else 1
    devices = [device] * positions
    mesh = build_multihost_mesh(MeshConfig(model=model_axis), devices=devices)
    # every model tile inside one process
    tiles_local = all(len({int(r) for r in row}) == 1
                      for row in mesh.ranks.reshape(-1, model_axis))
    local_mesh = build_mesh(MeshConfig(model=model_axis), devices)
    b = 2 * mesh.shape[DATA_AXIS]
    params, full = tiny_train_setup(b, seed=42)
    rows = b // n_processes
    local = tree_map(lambda x: x[process_id * rows:(process_id + 1) * rows], full)
    # the global batch from this process's rows: its positions hold exactly
    # their blocks of the whole batch
    glob = make_global_batch(mesh, local, batch_shardings(mesh, full))
    global_ok = all(
        g.shape == np.shape(x) and all(np.array_equal(t.cpu().numpy(), np.asarray(x)[sl])
                                       for sl, t in g.addressable_shards)
        for g, x in zip(tree_leaves(glob), tree_leaves(full)))
    state = init_train_state(local_mesh, params, lambda ps: torch.optim.AdamW(
        ps, lr=1e-3, weight_decay=1e-4))
    _, metrics = make_train_step(bert_config=TINY_CONFIG)(state, local)
    ref_params = tree_map(lambda t: t.to(device), params)
    with torch.no_grad():
        ref_loss = float(joint_loss(ref_params, tree_map(
            lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device), full),
            TINY_CONFIG)[0])

    # the packed fused scorer on this process's rows against the whole batch
    from realtime_fraud_detection_tpu_torch.core.packing import pack_tree
    from realtime_fraud_detection_tpu_torch.ensemble.combine import EnsembleParams
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import (
        MODEL_NAMES,
        ScorerConfig,
        init_scoring_models,
        make_example_batch,
        score_fused_packed,
    )
    from realtime_fraud_detection_tpu_torch.utils.config import Config

    sc = ScorerConfig(text_len=16)
    models = init_scoring_models(3, TINY_CONFIG, feature_dim=sc.feature_dim,
                                 node_dim=sc.node_dim).to(device)
    ens = EnsembleParams.from_config(Config(), MODEL_NAMES).to(device)
    mv = torch.ones(len(MODEL_NAMES), dtype=torch.bool)
    bsz = 2 * mesh.size
    blobs, spec = pack_tree(make_example_batch(bsz, sc, rng=np.random.default_rng(11)))
    part = bsz // n_processes
    sl = slice(process_id * part, (process_id + 1) * part)

    def score(bl):
        dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               for k, v in bl.items() if v is not None}
        return score_fused_packed(models, dev, spec, ens, mv,
                                  bert_config=TINY_CONFIG).cpu().numpy()

    mine = score({k: (v[sl] if v is not None else None) for k, v in blobs.items()})
    ref = score(blobs)[sl]
    print(json.dumps({
        "process": process_id, "loss": metrics["loss"], "ref_loss": ref_loss,
        "tiles_local": tiles_local, "global_batch": global_ok, "mesh": mesh.shape,
        "rows": rows,
        "score_rows": int(mine.shape[0]),
        "score_max_abs": float(np.max(np.abs(mine - ref))),
        "scores_close": bool(np.allclose(mine, ref, rtol=2e-5, atol=2e-6)),
        "finite": bool(np.isfinite(mine).all() and np.isfinite(metrics["loss"])),
    }), flush=True)
    dist.barrier()
    dist.destroy_process_group()


def run_two_process_step(n_processes: int = 2, positions: int = 2, device: str = "cuda",
                         timeout_s: float = 300.0, env: Optional[Dict[str, str]] = None
                         ) -> Dict[str, Any]:
    """The joint DP + TP step and the packed fused scorer across
    ``n_processes`` OS processes (``gloo`` over ``tcp://127.0.0.1:<free
    port>``), each with ``positions`` mesh positions on ``device``. Returns
    each process's line and ``passed``: every loss within 1e-4 of the
    one-process loss of the same global batch, every process's scores
    within 2e-5 / 2e-6 of the one-process scores, every tile local, and
    ``make_global_batch`` placing each process's rows as its blocks of the
    whole batch."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    t0 = time.perf_counter()
    procs = []
    for pid in range(n_processes):
        code = ("from realtime_fraud_detection_tpu_torch.parallel.train import "
                f"_two_process_child as c; c({coord!r}, {n_processes}, {pid}, "
                f"{positions}, {device!r})")
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=root,
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    lines, errors = [], []
    for p in procs:
        try:
            out, err = p.communicate(timeout=max(5.0, timeout_s - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = p.communicate()
        if p.returncode != 0:
            errors.append(f"rc {p.returncode}: {err[-2000:]}")
            continue
        lines.append(json.loads(out.strip().splitlines()[-1]))
    passed = (not errors and len(lines) == n_processes
              and all(abs(r["loss"] - r["ref_loss"]) < 1e-4 and r["scores_close"]
                      and r["tiles_local"] and r["global_batch"] and r["finite"]
                      for r in lines))
    return {"processes": lines, "errors": errors, "passed": bool(passed),
            "seconds": round(time.perf_counter() - t0, 2)}
