"""Model weights for one run, drawn from ``--seed`` on the device.

The benchmark makes the weights itself and hands the same values to the
program and to the plain reference. Every tensor comes from one
``torch.Generator`` on the run's device, in a few large calls: the text
encoder's dense kernels and embedding tables are one flat buffer drawn at
once and cut into views. The distributions are those of the program's own
seeded initialisers (truncated normal 0.02 for the encoder, Glorot for the
LSTM and the GNN, random complete trees with N(0.5, 1) thresholds), so
every branch does real work; the draws themselves are the benchmark's.

The LSTM and the GNN read the 64 features and the node rows raw (amounts,
counts, hours), so their Glorot draws would sit on inputs hundreds wide
and saturate every sigmoid. ``input_scales`` takes each input's root mean
square over the seed's own traffic (the warm-up rows' features, the
velocity state the whole traffic can build, every user's and merchant's
node row), and ``make_weights`` divides the rows of
the matrices that read those inputs by it: each input then enters at about
unit size, and both branches' scores stay inside (0, 1).

The result is a plain nested dict of tensors in float32 (int32 for tree
features), the encoder in its float layout; quantizing it is the
program's set-up on one side and the reference's own work on the other.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Any, Dict, Optional

import numpy as np
import torch


def _c(n: float) -> float:
    """Average unsuccessful BST search length c(n) (Liu et al. 2008)."""
    if n <= 1:
        return 0.0
    return 2.0 * (math.log(n - 1) + 0.5772156649015329) - 2.0 * (n - 1) / n


def encoder_shapes(enc: Dict[str, int]) -> Dict[str, tuple]:
    """Name -> shape of every truncated-normal leaf of the encoder, in draw
    order (the flat buffer's layout)."""
    h, ffn = enc["hidden_size"], enc["intermediate_size"]
    shapes = {"word_emb": (enc["vocab_size"], h),
              "pos_emb": (enc["max_position_embeddings"], h)}
    for i in range(enc["num_layers"]):
        for name, shape in (("q", (h, h)), ("k", (h, h)), ("v", (h, h)),
                            ("o", (h, h)), ("ffn1", (h, ffn)),
                            ("ffn2", (ffn, h))):
            shapes[f"layers.{i}.{name}"] = shape
    shapes["pre_classifier"] = (h, h)
    shapes["classifier"] = (h, enc["num_labels"])
    return shapes


def _rms(rows: np.ndarray) -> np.ndarray:
    r = np.sqrt(np.mean(np.square(rows.astype(np.float64)), axis=0))
    return np.where(r > 1e-6, r, 1.0).astype(np.float32)


def input_scales(traffic, cfg: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Root mean square of each of the LSTM's and the GNN's raw inputs over
    the run's traffic (1 where an input is always 0): ``features`` over the
    warm-up rows as the reference extracts them from a fresh state, the
    velocity counts and amounts over every record with its user's totals of
    the whole traffic (the most the state can reach), ``nodes`` over every
    user's and merchant's node row."""
    from perfbench.reference.extract import FEATURE_NAMES
    from perfbench.reference.replay import WINDOWS, Replay, node_row

    ens = cfg["ensemble"]
    rep = Replay(traffic.users, traffic.merchants, ens,
                 cfg["text_encoder"]["vocab_size"])
    feats = rep.run([("D", 0, traffic.warmup)], keep={0})[0]["features"]
    rms = _rms(feats)
    count: Dict[str, float] = defaultdict(float)
    amount: Dict[str, float] = defaultdict(float)
    stream = list(traffic.warmup) + list(traffic.records)
    for r in stream:
        u = str(r.get("user_id", ""))
        count[u] += 1.0
        amount[u] += float(r.get("amount", 0.0))
    users = [str(r.get("user_id", "")) for r in stream]
    for kind, totals in (("count", count), ("amount", amount)):
        r = _rms(np.asarray([[totals[u]] for u in users]))[0]
        for w in WINDOWS:
            rms[FEATURE_NAMES.index(f"velocity_{w}_{kind}")] = r
    d = ens["node_dim"]
    nodes = np.stack([node_row(p, False, d) for p in traffic.users.values()]
                     + [node_row(p, True, d) for p in traffic.merchants.values()])
    return {"features": rms, "nodes": _rms(nodes)}


def make_weights(seed: int, cfg: Dict[str, Any], device: str,
                 scales: Optional[Dict[str, np.ndarray]] = None) -> Dict[str, Any]:
    """All five branches' weights for configuration ``cfg`` from ``seed``;
    with ``scales`` (``input_scales``) the rows that read a raw input are
    divided by its size."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    f32 = dict(dtype=torch.float32, device=device)
    ens = cfg["ensemble"]
    enc = cfg["text_encoder"]
    fdim, ndim = ens["feature_dim"], ens["node_dim"]

    def normal(shape, mean=0.0, std=1.0):
        return torch.randn(shape, generator=g, **f32) * std + mean

    def glorot(shape):
        return normal(shape, std=math.sqrt(2.0 / (shape[0] + shape[1])))

    def trees(n_trees, depth):
        n_int = 2 ** depth - 1
        return (torch.randint(0, fdim, (n_trees, n_int), generator=g,
                              device=device, dtype=torch.int32),
                normal((n_trees, n_int), mean=0.5, std=1.0))

    gb = ens["gbdt"]
    feat, thr = trees(gb["n_trees"], gb["depth"])
    gbdt = {"feature": feat, "threshold": thr,
            "leaf": normal((gb["n_trees"], 2 ** gb["depth"]), std=0.1),
            "base_score": torch.zeros((), **f32)}
    ifo = ens["isolation_forest"]
    feat, thr = trees(ifo["n_trees"], ifo["depth"])
    c_psi = _c(ifo["max_samples"])
    iforest = {"feature": feat, "threshold": thr,
               "path_length": ifo["depth"] + c_psi * torch.rand(
                   (ifo["n_trees"], 2 ** ifo["depth"]), generator=g, **f32),
               "c_psi": torch.tensor(c_psi, **f32)}

    lh, hh = ens["lstm"]["hidden"], ens["lstm"]["head_hidden"]
    b_gates = torch.zeros((4 * lh,), **f32)
    b_gates[lh:2 * lh] = 1.0
    lstm = {"w_gates": normal((fdim + lh, 4 * lh),
                              std=math.sqrt(2.0 / (fdim + lh + 4 * lh))),
            "b_gates": b_gates,
            "w_head1": normal((lh, hh), std=math.sqrt(2.0 / lh)),
            "b_head1": torch.zeros((hh,), **f32),
            "w_head2": normal((hh, 1), std=math.sqrt(2.0 / hh)),
            "b_head2": torch.zeros((1,), **f32)}

    gh, gth = ens["gnn"]["hidden"], ens["gnn"]["head_hidden"]
    gnn = {"w_sage1": glorot((2 * ndim, gh)), "b_sage1": torch.zeros((gh,), **f32),
           "w_sage2": glorot((ndim + gh, gh)), "b_sage2": torch.zeros((gh,), **f32),
           "w_head1": glorot((2 * gh + fdim, gth)),
           "b_head1": torch.zeros((gth,), **f32),
           "w_head2": glorot((gth, 1)), "b_head2": torch.zeros((1,), **f32)}

    if scales is not None:
        inv_f = 1.0 / torch.as_tensor(scales["features"], **f32)[:, None]
        inv_n = 1.0 / torch.as_tensor(scales["nodes"], **f32)[:, None]
        lstm["w_gates"][:fdim] *= inv_f
        gnn["w_head1"][2 * gh:] *= inv_f
        gnn["w_sage1"][:ndim] *= inv_n
        gnn["w_sage2"][:ndim] *= inv_n

    # the encoder: one truncated-normal draw for every kernel and table
    shapes = encoder_shapes(enc)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.empty((total,), **f32)
    torch.nn.init.trunc_normal_(flat, mean=0.0, std=0.02, a=-0.04, b=0.04,
                                generator=g)
    leaves, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        # a leaf of its own: a view would keep the whole buffer alive in
        # whatever holds one leaf
        leaves[name] = flat[off:off + n].view(shape).clone()
        off += n
    del flat
    h = enc["hidden_size"]

    def ln():
        return {"scale": torch.ones((h,), **f32), "bias": torch.zeros((h,), **f32)}

    def dense(name):
        w = leaves[name]
        return {"w": w, "b": torch.zeros((w.shape[1],), **f32)}

    bert = {"word_emb": leaves["word_emb"], "pos_emb": leaves["pos_emb"],
            "emb_ln": ln(), "layers": [],
            "pre_classifier": dense("pre_classifier"),
            "classifier": dense("classifier")}
    for i in range(enc["num_layers"]):
        layer = {name: dense(f"layers.{i}.{name}")
                 for name in ("q", "k", "v", "o", "ffn1", "ffn2")}
        layer["attn_ln"], layer["ffn_ln"] = ln(), ln()
        bert["layers"].append(layer)
    return {"gbdt": gbdt, "iforest": iforest, "lstm": lstm, "gnn": gnn,
            "bert": bert}
