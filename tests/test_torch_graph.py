"""The port's typed entity graph against the JAX package, on the CPU: the
simulator's fraud ring, ``TypedEntityGraph``, ``NeighborSampler``, the
typed GNN with two-hop inputs, ``score_fused_packed`` on a two-hop batch
(also over the bf16 wire), a typed-mode ``TorchFraudScorer`` against the
JAX ``FraudScorer`` on a seeded ring stream, and the port's own oracle:
``assemble`` equal to ``assemble_serial`` with graph sampling on.

Tolerances: the ring's records, the graph's adjacency, stats and digest,
the sampler's tensors and cache counters, every assembled leaf (but the
three transcendental feature columns, within 1e-5 as in
``test_torch_host.py``) and the packed blobs exact; the typed GNN and the
two-hop fused scorer <= 1e-5 at f32 compute; the typed scorer's scores
within the JAX kernel drill's measured bf16 noise bound
(``torch_bounds.py``), decisions equal at every QoS rung on the rows
farther than it from a rung (the one row skipped is asserted),
``rules_only`` bit-exact.
"""

import torch_threads  # noqa: F401  (first: torch held to one CPU thread)
import dataclasses
import pickle
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_fraud_detection_tpu.core.packing import pack_tree as jax_pack_tree
from realtime_fraud_detection_tpu.ensemble.combine import (
    EnsembleParams as JaxEnsembleParams,
)
from realtime_fraud_detection_tpu.graph import sampler as jsampler
from realtime_fraud_detection_tpu.graph import store as jstore
from realtime_fraud_detection_tpu.models import bert as jbert
from realtime_fraud_detection_tpu.models import gnn as jgnn
from realtime_fraud_detection_tpu.models import lstm as jlstm
from realtime_fraud_detection_tpu.models.isolation_forest import (
    IsolationForest as JaxIsolationForest,
)
from realtime_fraud_detection_tpu.models.quant import (
    quantize_bert_params as jax_quantize_bert_params,
)
from realtime_fraud_detection_tpu.models.trees import (
    TreeEnsemble as JaxTreeEnsemble,
)
from realtime_fraud_detection_tpu.scoring import pipeline as jax_pipeline
from realtime_fraud_detection_tpu.scoring import scorer as jax_scorer_module
from realtime_fraud_detection_tpu.scoring.scorer import FraudScorer
from realtime_fraud_detection_tpu.sim.fraud_patterns import (
    FraudRingConfig as JaxFraudRingConfig,
)
from realtime_fraud_detection_tpu.sim.simulator import (
    TransactionGenerator as JaxTransactionGenerator,
)
from realtime_fraud_detection_tpu.utils.config import (
    VALID_KERNEL_SITES,
    Config as JaxConfig,
    KernelSettings as JaxKernelSettings,
)
from realtime_fraud_detection_tpu_torch.bridge import models_from_numpy
from realtime_fraud_detection_tpu_torch.core.packing import (
    pack_tree,
    tree_flatten,
    unpack_tree,
    widen_bf16,
)
from realtime_fraud_detection_tpu_torch.ensemble.combine import EnsembleParams
from realtime_fraud_detection_tpu_torch.features.extract import FEATURE_NAMES
from realtime_fraud_detection_tpu_torch.graph.sampler import NeighborSampler
from realtime_fraud_detection_tpu_torch.graph.store import (
    EDGE_TYPES,
    TypedEntityGraph,
    merge_neighbor_lists,
)
from realtime_fraud_detection_tpu_torch.models import gnn
from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
from realtime_fraud_detection_tpu_torch.qos.ladder import LADDER_LEVELS
from realtime_fraud_detection_tpu_torch.scoring.pipeline import (
    MODEL_NAMES,
    ScorerConfig,
    init_scoring_models,
    make_example_batch,
    score_fused_packed,
)
from realtime_fraud_detection_tpu_torch.scoring.scorer import (
    TorchFraudScorer,
    _stage_bf16,
)
from realtime_fraud_detection_tpu_torch.sim.fraud_patterns import FraudRingConfig
from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
from realtime_fraud_detection_tpu_torch.utils.config import (
    Config,
    KernelSettings,
    QuantSettings,
)

from torch_bounds import near_rung, noise_bound

TRANSCENDENTAL = [FEATURE_NAMES.index(n) for n in (
    "amount_log", "amount_sqrt", "distance_to_merchant_km")]
EXACT = [i for i in range(len(FEATURE_NAMES)) if i not in TRANSCENDENTAL]
FANOUT, FANOUT2, TEXT_LEN, ROWS = 8, 4, 16, 24
TYPED_SC = dict(graph_mode="typed", fanout=FANOUT, graph_fanout2=FANOUT2,
                text_len=TEXT_LEN)
TWO_HOP = ("user_neigh2_feat", "user_neigh2_mask", "merch_neigh2_feat",
           "merch_neigh2_mask")


# ------------------------------------------------------------- fraud ring
@pytest.mark.parametrize("ring", [
    None, {}, {"rate": 1.0, "n_members": 6, "n_devices": 2, "n_ips": 2},
    {"rate": 0.3, "merchant_category": "no_such_category"},
], ids=["off", "default", "dense", "fallback-merchants"])
def test_fraud_ring_records_match_jax(ring):
    port = TransactionGenerator(num_users=80, num_merchants=30, seed=7)
    ref = JaxTransactionGenerator(num_users=80, num_merchants=30, seed=7)
    assert port.generate_batch(20) == ref.generate_batch(20)
    if ring is not None:
        got = port.inject_fraud_ring(FraudRingConfig(**ring))
        want = ref.inject_fraud_ring(JaxFraudRingConfig(**ring))
        assert list(got.member_ids) == list(want.member_ids)
        assert list(got.merchant_ids) == list(want.merchant_ids)
        assert (got.device_ids, got.ips) == (want.device_ids, want.ips)
    assert port.generate_batch(120) == ref.generate_batch(120)
    if ring is not None:
        assert got.stats() == want.stats() and got.applied > 0
        port.clear_fraud_ring()
        ref.clear_fraud_ring()
    # with the ring cleared the per-record draw stops, in step with JAX
    assert port.generate_batch(40) == ref.generate_batch(40)


def test_fraud_ring_refuses_a_bad_config():
    with pytest.raises(ValueError, match="rate"):
        FraudRingConfig(rate=1.5).validate()
    with pytest.raises(ValueError, match=">= 1"):
        FraudRingConfig(n_devices=0).validate()


# ------------------------------------------------------------ typed store
def _ingest_sequence(seed, n_batches=6, rows=20):
    """Batches of (users, merchants, devices, ips) from small pools, with
    empty and missing counterparties."""
    rng = np.random.default_rng(seed)
    pools = {"u": 12, "m": 6, "d": 5, "i": 7}
    out = []
    for _ in range(n_batches):
        cols = []
        for key, size in pools.items():
            col = [f"{key}{int(x)}" for x in rng.integers(0, size, rows)]
            if key != "u":
                for j in np.flatnonzero(rng.random(rows) < 0.1):
                    col[j] = "" if j % 2 else None
            cols.append(col)
        cols[0][0] = ""                         # a record without a user
        out.append(cols)
    return out


@pytest.mark.parametrize("fanout", [1, 3, 8])
def test_typed_graph_matches_jax(fanout):
    port, ref = TypedEntityGraph(fanout), jstore.TypedEntityGraph(fanout)
    ids = ([f"u{i}" for i in range(13)] + [f"m{i}" for i in range(7)]
           + [f"d{i}" for i in range(6)] + [f"i{i}" for i in range(8)] + [""])
    for step, cols in enumerate(_ingest_sequence(fanout)):
        port.add_batch(*cols)
        ref.add_batch(*cols)
        for et in EDGE_TYPES:
            for k in (None, 1, 2, 16):
                assert port.neighbors(et, ids, k) == ref.neighbors(et, ids, k)
            assert port.degree(et, ids) == ref.degree(et, ids)
            assert port.neighbor_map(et, ids) == ref.neighbor_map(et, ids)
        assert port.stats() == ref.stats()
        assert port.digest() == ref.digest()
        assert len(port) == len(ref)
        if step % 2:
            assert port.drain_dirty() == ref.drain_dirty()
    port.add_transaction("u1", "m1", "d1", "i1")
    ref.add_transaction("u1", "m1", "d1", "i1")
    restored = pickle.loads(pickle.dumps(port))
    assert restored.digest() == port.digest() == ref.digest()
    restored.add_batch(["u2"], ["m2"], ["d2"], ["i2"])      # lock rebuilt
    with pytest.raises(ValueError, match="unknown edge type"):
        port.neighbors("user->user", ["u1"])
    with pytest.raises(ValueError, match="fanout"):
        TypedEntityGraph(0)


def test_merge_neighbor_lists_matches_jax():
    local = {"d1": ["u1", "u2"], "d2": ["u3"]}
    remotes = [{"d1": ["u2", "u4", "u5"]}, {"d2": ["u6"], "d3": ["u7"]}]
    for fanout in (1, 2, 4, 0):
        ids = ["d1", "d2", "d3", "d9"]
        assert merge_neighbor_lists(local, remotes, ids, fanout) == \
            jstore.merge_neighbor_lists(local, remotes, ids, fanout)


# ---------------------------------------------------------------- sampler
def _row_fn(node_dim, seed):
    """Deterministic feature rows for the ids the sequences use (users and
    merchants seeded, the rest zero rows, as ``peek_rows`` gives)."""
    rng = np.random.default_rng(seed)
    table = {f"{k}{i}": rng.standard_normal(node_dim).astype(np.float32)
             for k in ("u", "m") for i in range(12)}

    def rows(ids):
        return np.stack([table.get(i, np.zeros(node_dim, np.float32)) for i in ids])
    return rows


@pytest.mark.parametrize("kw", [{}, {"max_entries": 3}, {"max_entry_age": 2},
                                {"epoch": True}],
                         ids=["default", "capacity", "age", "epoch"])
def test_sampler_tensors_and_cache_counts_match_jax(kw):
    kw = dict(kw)
    epoch = kw.pop("epoch", False)
    graphs = (TypedEntityGraph(FANOUT), jstore.TypedEntityGraph(FANOUT))
    rows = _row_fn(16, 3)
    port = NeighborSampler(graphs[0], 16, FANOUT, FANOUT2, rows, rows, **kw)
    ref = jsampler.NeighborSampler(graphs[1], 16, FANOUT, FANOUT2, rows, rows, **kw)
    rng = np.random.default_rng(9)
    for step, cols in enumerate(_ingest_sequence(4, n_batches=8)):
        users = [f"u{int(x)}" for x in rng.integers(0, 14, 10)]
        merchants = [f"m{int(x)}" for x in rng.integers(0, 8, 10)]
        got, want = port.sample(users, merchants), ref.sample(users, merchants)
        assert got.keys() == want.keys()
        for name in want:
            assert got[name].dtype == want[name].dtype
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        assert port.stats() == ref.stats()
        for g in graphs:
            g.add_batch(*cols)
            if epoch and step == 4:
                g.ownership_epoch = 1
        port.sync()
        ref.sync()
        assert port.stats() == ref.stats()
    stats = port.stats()
    assert stats["hits"] > 0 and stats["misses"] > 0 and stats["evictions"] > 0
    assert port.sample([], []) ["user_neigh2_feat"].shape == (0, FANOUT, FANOUT2, 16)


# -------------------------------------------------------------- typed GNN
@pytest.fixture(scope="module")
def typed_gnn_params():
    return jax.tree_util.tree_map(np.asarray, jgnn.init_gnn_params(
        jax.random.PRNGKey(3), typed=True))


def _typed_rows(rng, shape, d=16):
    """Node rows with one-hot type tags (users untagged) and a degree slot."""
    x = rng.standard_normal(shape + (d,)).astype(np.float32)
    x[..., gnn.MERCHANT_TAG_SLOT:gnn.IP_TAG_SLOT + 1] = 0.0
    kind = rng.integers(0, 4, shape)
    for j, slot in enumerate((gnn.MERCHANT_TAG_SLOT, gnn.DEVICE_TAG_SLOT,
                              gnn.IP_TAG_SLOT)):
        x[..., slot] = kind == j + 1
    return x


def _gnn_inputs(seed, b=12, two_hop=True):
    rng = np.random.default_rng(seed)
    args = [rng.normal(0, 20, (b, 64)).astype(np.float32),     # clip reaches
            _typed_rows(rng, (b,)), _typed_rows(rng, (b,)),
            _typed_rows(rng, (b, FANOUT)), rng.random((b, FANOUT)) < 0.7,
            _typed_rows(rng, (b, FANOUT)), rng.random((b, FANOUT)) < 0.7]
    args[4][0] = False
    kw = {}
    if two_hop:
        kw = dict(user_neigh2_feat=_typed_rows(rng, (b, FANOUT, FANOUT2)),
                  user_neigh2_mask=rng.random((b, FANOUT, FANOUT2)) < 0.5,
                  merch_neigh2_feat=_typed_rows(rng, (b, FANOUT, FANOUT2)),
                  merch_neigh2_mask=rng.random((b, FANOUT, FANOUT2)) < 0.5)
    return args, kw


@pytest.mark.parametrize("two_hop", [True, False], ids=["two-hop", "one-hop"])
def test_typed_gnn_logits_match_jax(typed_gnn_params, two_hop):
    args, kw = _gnn_inputs(5, two_hop=two_hop)
    params = {k: torch.from_numpy(np.array(v, np.float32))
              for k, v in typed_gnn_params.items()}
    assert gnn.is_typed_gnn(params) and jgnn.is_typed_gnn(typed_gnn_params)
    want = np.asarray(jgnn.gnn_logits(
        typed_gnn_params, *[jnp.asarray(a) for a in args],
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = gnn.gnn_logits(params, *[torch.from_numpy(a) for a in args],
                         **{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    feat = _typed_rows(np.random.default_rng(1), (10,))
    np.testing.assert_allclose(
        gnn.typed_node_projection(params, torch.from_numpy(feat)).numpy(),
        np.asarray(jgnn.typed_node_projection(typed_gnn_params, jnp.asarray(feat))),
        rtol=0, atol=1e-6)


def test_typed_entity_features_and_init_match_jax():
    deg = np.array([0, 1, 3, 7, 40], np.float32)
    for kind in ("merchant", "device", "ip"):
        np.testing.assert_array_equal(gnn.typed_entity_features(kind, deg, 16, 8),
                                      jgnn.typed_entity_features(kind, deg, 16, 8))
    with pytest.raises(ValueError, match="kind"):
        gnn.typed_entity_features("user", deg, 16, 8)
    with pytest.raises(ValueError, match="node_dim"):
        gnn.init_gnn_params(np.random.default_rng(0), node_dim=9, typed=True)
    flat = gnn.init_gnn_params(np.random.default_rng(0))
    typed = gnn.init_gnn_params(np.random.default_rng(0), typed=True)
    jtyped = jgnn.init_gnn_params(jax.random.PRNGKey(0), typed=True)
    assert {k: tuple(v.shape) for k, v in typed.items()} == \
        {k: tuple(v.shape) for k, v in jtyped.items()}
    for k, v in flat.items():                  # the shared weights are unchanged
        assert torch.equal(typed[k], v)
    # near identity, as the JAX init
    assert float((typed["w_node_device"] - torch.eye(16)).abs().max()) < 0.5


# ------------------------------------------------- two-hop fused scorer
@pytest.fixture(scope="module")
def typed_jax_models():
    """JAX typed model set with random trees and forest, f32 BERT, numpy."""
    rng = np.random.default_rng(41)
    models = jax_pipeline.init_scoring_models(jax.random.PRNGKey(41),
                                              jbert.TINY_CONFIG, gnn_typed=True)
    depth, n_trees = 4, 16
    trees = JaxTreeEnsemble(
        feature=rng.integers(0, 64, (n_trees, 2 ** depth - 1)).astype(np.int32),
        threshold=rng.normal(0.5, 1.0, (n_trees, 2 ** depth - 1)).astype(np.float32),
        leaf=rng.normal(0.0, 0.4, (n_trees, 2 ** depth)).astype(np.float32),
        base_score=np.float32(0.1))
    forest = JaxIsolationForest(
        feature=rng.integers(0, 64, (n_trees, 2 ** depth - 1)).astype(np.int32),
        threshold=rng.normal(0.5, 1.0, (n_trees, 2 ** depth - 1)).astype(np.float32),
        path_length=(4 + 4 * rng.random((n_trees, 2 ** depth))).astype(np.float32),
        c_psi=np.float32(6.0))
    return jax.tree_util.tree_map(np.asarray,
                                  models.replace(trees=trees, iforest=forest))


def _two_hop_batch(seed, b=12):
    rng = np.random.default_rng(seed)
    sc = ScorerConfig(fanout=FANOUT, text_len=TEXT_LEN)
    batch = make_example_batch(b, sc, rng=rng)
    args, kw = _gnn_inputs(seed + 1, b=b)
    return dataclasses.replace(
        batch, user_feat=args[1], merchant_feat=args[2], user_neigh_feat=args[3],
        user_neigh_mask=args[4], merch_neigh_feat=args[5],
        merch_neigh_mask=args[6], **kw)


def _to_jax_batch(batch):
    from realtime_fraud_detection_tpu.features.schema import (
        TransactionBatch as JaxTransactionBatch,
    )

    fields = {f.name: getattr(batch, f.name)
              for f in dataclasses.fields(batch) if f.name != "txn"}
    return jax_pipeline.ScoreBatch(txn=JaxTransactionBatch(**vars(batch.txn)),
                                   **fields)


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_two_hop_fused_scorer_matches_jax(typed_jax_models, monkeypatch, wire):
    batch = _two_hop_batch(11)
    jbatch = _to_jax_batch(batch)
    if wire == "bf16":
        batch, jbatch = _stage_bf16(batch), jax_scorer_module._stage_bf16(jbatch)
    blobs, spec = pack_tree(batch)
    jblobs, jspec = jax_pack_tree(jbatch)
    # the same bytes on the wire, the bf16 blob as its bit patterns
    assert [e[1:] for e in spec.entries] == [e[1:] for e in jspec.entries]
    assert [e[0] for e in spec.entries] == [e[0] for e in jspec.entries]
    for name, blob in blobs.items():
        want = jblobs[name].view(np.int16) if name == "bf16" else jblobs[name]
        assert blob.tobytes() == want.tobytes(), name
    assert ("bf16" in blobs) == (wire == "bf16")
    monkeypatch.setattr(jax_pipeline, "bert_predict",
                        partial(jbert.bert_predict, compute_dtype=jnp.float32))
    monkeypatch.setattr(jax_pipeline, "lstm_logits",
                        partial(jlstm.lstm_logits, compute_dtype=jnp.float32))
    want = np.asarray(jax_pipeline._score_fused_packed_impl(
        typed_jax_models, jblobs["f32"], jblobs["i32"], jblobs["u8"], spec=jspec,
        params=JaxEnsembleParams.from_config(JaxConfig(), jax_pipeline.MODEL_NAMES),
        model_valid=np.ones(5, bool),
        blob_bf16=jblobs["bf16"] if wire == "bf16" else None,
        bert_config=jbert.TINY_CONFIG))
    got = score_fused_packed(
        models_from_numpy(typed_jax_models),
        {k: torch.from_numpy(v) for k, v in blobs.items()}, spec,
        EnsembleParams.from_config(Config(), MODEL_NAMES),
        torch.ones(5, dtype=torch.bool), bert_config=TINY_CONFIG,
        compute_dtype=torch.float32).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_bipartite_packspec_is_unchanged_and_two_hop_appends():
    batch = make_example_batch(4, ScorerConfig(), rng=np.random.default_rng(0))
    assert batch.user_neigh2_feat is None
    blobs, spec = pack_tree(batch)
    _, jspec = jax_pack_tree(_to_jax_batch(batch))
    # 65 leaves in the parent's order: the megakernel reads these offsets
    assert len(spec.entries) == len(jspec.entries) == 65
    assert spec.entries == jspec.entries
    assert set(blobs) == {"f32", "i32", "u8"} and spec.widths == jspec.widths[:3]
    two_hop = _two_hop_batch(2, b=4)
    _, tspec = pack_tree(two_hop)
    _, one_hop_spec = pack_tree(dataclasses.replace(
        two_hop, **{name: None for name in TWO_HOP}))
    # the typed batch's four two-hop leaves come after the bipartite 65
    assert len(tspec.entries) == 69
    assert tspec.entries[:65] == one_hop_spec.entries
    tails = [e[2] for e in tspec.entries[-4:]]
    assert tails == [(FANOUT, FANOUT2, 16), (FANOUT, FANOUT2),
                     (FANOUT, FANOUT2, 16), (FANOUT, FANOUT2)]
    blobs, bspec = pack_tree(_stage_bf16(two_hop))
    restored = widen_bf16(unpack_tree(
        {k: torch.from_numpy(v) for k, v in blobs.items()}, bspec))
    assert restored.user_neigh2_feat.dtype == torch.float32
    np.testing.assert_array_equal(
        restored.user_neigh2_feat.numpy(),
        torch.from_numpy(two_hop.user_neigh2_feat).to(torch.bfloat16).float().numpy())


# ------------------------------------------------- typed scorer vs JAX
def _ring_gens(seed=17):
    port = TransactionGenerator(num_users=60, num_merchants=20, seed=seed)
    ref = JaxTransactionGenerator(num_users=60, num_merchants=20, seed=seed)
    port.inject_fraud_ring(FraudRingConfig(rate=0.3))
    ref.inject_fraud_ring(JaxFraudRingConfig(rate=0.3))
    return port, ref


def _rung_mask(level):
    rung = LADDER_LEVELS[level]
    return np.asarray([n not in rung.dropped_branches for n in MODEL_NAMES])


def _assert_batches_equal(got, want):
    for name, g in vars(got.txn).items():
        np.testing.assert_array_equal(np.asarray(g), np.asarray(getattr(want.txn, name)))
    for f in dataclasses.fields(got):
        if f.name == "txn":
            continue
        g, w = getattr(got, f.name), getattr(want, f.name)
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, f.name
        if f.name in ("features", "history"):
            np.testing.assert_array_equal(g[..., EXACT], w[..., EXACT])
            np.testing.assert_allclose(g[..., TRANSCENDENTAL], w[..., TRANSCENDENTAL],
                                       rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f.name)


@pytest.fixture(scope="module")
def typed_runs(typed_jax_models):
    """The same ring stream through a typed JAX scorer and a typed port
    scorer on the CPU: three batches at the full rung, then one batch at
    each lower rung."""
    jax_s = FraudScorer(models=typed_jax_models,
                        scorer_config=jax_pipeline.ScorerConfig(**TYPED_SC))
    port_s = TorchFraudScorer(models=models_from_numpy(typed_jax_models),
                              scorer_config=ScorerConfig(**TYPED_SC),
                              bert_config=TINY_CONFIG, device="cpu")
    gen, jgen = _ring_gens()
    for s, g in ((port_s, gen), (jax_s, jgen)):
        s.seed_profiles(g.users.profiles(), g.merchants.profiles())
    out = {"batches": [], "results": [], "tokens": [], "levels": []}
    for step, level in enumerate((0, 0, 0, 1, 2, 3)):
        mask = _rung_mask(level)
        for s in (port_s, jax_s):
            s.set_degradation(mask, rules_only=LADDER_LEVELS[level].rules_only,
                              level=level)
        records, jrecords = gen.generate_batch(ROWS), jgen.generate_batch(ROWS)
        assert records == jrecords
        now = 100.0 + step
        got, want = port_s.assemble(records, now), jax_s.assemble(jrecords, now)
        res = port_s.finalize(port_s.dispatch_assembled(got, records), now)
        jres = jax_s.finalize(jax_s.dispatch_assembled(want, jrecords), now)
        out["batches"].append((got, want))
        out["results"].append((res, jres))
        out["tokens"].append((np.asarray(want.token_ids), np.asarray(want.token_mask)))
        out["levels"].append(level)
    out["scorers"] = (port_s, jax_s)
    return out


def test_typed_scorer_batches_match_jax_leaf_for_leaf(typed_runs):
    for got, want in typed_runs["batches"]:
        assert all(getattr(got, name) is not None for name in TWO_HOP)
        _assert_batches_equal(got, want)
    # the ring's shared entities reach the two-hop context
    got = typed_runs["batches"][2][0]
    assert got.user_neigh2_mask.any() and got.merch_neigh2_mask.any()
    port_s, jax_s = typed_runs["scorers"]
    assert port_s.typed_graph.digest() == jax_s.typed_graph.digest()
    assert port_s.graph_snapshot() == {k: v for k, v in jax_s.graph_snapshot().items()}


def test_typed_scorer_decisions_match_jax_at_every_rung(typed_runs, typed_jax_models):
    weights = JaxEnsembleParams.from_config(JaxConfig(), MODEL_NAMES).weights
    skipped = 0
    for (res, jres), tokens, level in zip(typed_runs["results"], typed_runs["tokens"],
                                          typed_runs["levels"]):
        assert [r["transaction_id"] for r in res] == [r["transaction_id"] for r in jres]
        if LADDER_LEVELS[level].rules_only:
            for key in ("fraud_score", "confidence", "decision", "risk_level"):
                assert [r[key] for r in res] == [r[key] for r in jres], key
            continue
        bound = noise_bound(typed_jax_models.bert, [tokens], weights,
                            _rung_mask(level))
        assert 1e-4 <= bound <= 1e-3
        prob = np.array([r["fraud_probability"] for r in jres])
        conf = np.array([r["confidence"] for r in jres])
        near = near_rung(prob, bound) | near_rung(conf, bound)
        skipped += int(near.sum())
        for r, q, skip in zip(res, jres, near):
            if not skip:
                assert (r["decision"], r["risk_level"]) == (q["decision"], q["risk_level"])
            assert set(r["model_predictions"]) == set(q["model_predictions"])
        np.testing.assert_allclose([r["fraud_score"] for r in res],
                                   [r["fraud_score"] for r in jres], rtol=0, atol=bound)
        gnn_pred = [(r["model_predictions"].get("graph_neural"),
                     q["model_predictions"].get("graph_neural")) for r, q in zip(res, jres)]
        if gnn_pred[0][0] is not None:      # the typed GNN is f32 on both sides
            np.testing.assert_allclose(*zip(*gnn_pred), rtol=0, atol=1e-5)
    # one row of this stream lies within the bound of a rung: its JAX
    # confidence is 0.59992, 8.2e-5 from the 0.6 rung
    assert skipped == 1


def test_typed_scorer_under_mega_serves_and_counts_like_jax(typed_jax_models):
    """Typed parameters under ``mega()`` construct and serve; every two-hop
    batch is a counted megakernel fallback, as the JAX scorer counts it."""
    jq = typed_jax_models.replace(bert=jax.tree_util.tree_map(
        np.asarray, jax_quantize_bert_params(typed_jax_models.bert)))
    # the default text length: at 16 the JAX dequant-rows guard declines
    # the position site, which the port's kernel takes
    sc = dict(TYPED_SC, text_len=64)
    scorer = TorchFraudScorer(
        Config(quant=QuantSettings.full(), kernels=KernelSettings.mega()),
        models=models_from_numpy(jq), scorer_config=ScorerConfig(**sc),
        bert_config=TINY_CONFIG, device="cpu")
    stub = SimpleNamespace(
        kernels=JaxKernelSettings.mega(), models=jq, bert_config=jbert.TINY_CONFIG,
        sc=jax_pipeline.ScorerConfig(**sc), _sampler=object(),
        _last_launches_per_batch=0,
        _kernel_counts={"dispatch": {s: 0 for s in VALID_KERNEL_SITES},
                        "fallback": {s: 0 for s in VALID_KERNEL_SITES}})
    stub._mega_plan = lambda size: FraudScorer._mega_plan(stub, size)
    stub.effective_model_valid = lambda: np.ones(5, bool)
    gen, _ = _ring_gens(seed=23)
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    for step, n in enumerate((20, 8)):
        records = gen.generate_batch(n)
        res = scorer.score_batch(records, now=10.0 + step)
        assert len(res) == n and all(0.0 <= r["fraud_score"] <= 1.0 for r in res)
        FraudScorer._record_kernel_dispatch(stub, 32 if n > 8 else 8)
        snap = scorer.kernel_snapshot()
        assert snap["dispatch"] == stub._kernel_counts["dispatch"]
        assert snap["fallback"] == stub._kernel_counts["fallback"]
        assert snap["launches_per_batch"] == stub._last_launches_per_batch == 7
    assert snap["fallback"]["megakernel"] == snap["dispatch"]["megakernel"] == 2
    assert scorer._mega_args is None          # never built in typed mode
    assert not scorer._mega_plan(32, has_two_hop=True)["supported"]
    # typed parameters on a one-hop batch: the port's kernel runs the typed
    # GNN, and its plan admits them where the JAX plan does
    from realtime_fraud_detection_tpu.ops.megakernel import mega_plan as jax_mega_plan

    want = jax_mega_plan(jq, jbert.TINY_CONFIG, b=32, text_len=64, seq_len=10,
                         feature_dim=64, has_two_hop=False)["supported"]
    assert scorer._mega_plan(32, has_two_hop=False)["supported"] == want


def test_scorer_refuses_an_unknown_graph_mode():
    with pytest.raises(ValueError, match="graph_mode"):
        TorchFraudScorer(scorer_config=ScorerConfig(graph_mode="hetero"), device="cpu")


# ------------------------------------------- assemble == assemble_serial
def test_assemble_equals_assemble_serial_with_graph_sampling():
    """The port's copy of the JAX oracle: with graph sampling on, the
    columnar ``assemble`` equals the record-at-a-time ``assemble_serial``
    on every leaf, and so does every served score."""
    models = init_scoring_models(5, TINY_CONFIG, node_dim=16, n_trees=8,
                                 tree_depth=3, gnn_typed=True)
    scorers = [TorchFraudScorer(models=models, scorer_config=ScorerConfig(**TYPED_SC),
                                bert_config=TINY_CONFIG, device="cpu")
               for _ in range(2)]
    gen = TransactionGenerator(num_users=50, num_merchants=16, seed=31)
    gen.inject_fraud_ring(FraudRingConfig(rate=0.3))
    for s in scorers:
        s.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    col, ser = scorers
    for i in range(3):
        records = gen.generate_batch(16)
        a, b = col.assemble(records, now=float(i)), ser.assemble_serial(records, now=float(i))
        la, ta = tree_flatten(a)
        lb, tb = tree_flatten(b)
        assert ta == tb and len(la) == 69
        for x, y in zip(la, lb):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        ra = col.finalize(col.dispatch_assembled(a, records), now=float(i))
        rb = ser.finalize(ser.dispatch_assembled(b, records), now=float(i))
        assert [r["fraud_score"] for r in ra] == [r["fraud_score"] for r in rb]
    assert col.typed_graph.digest() == ser.typed_graph.digest()
    assert np.asarray(a.user_neigh2_mask).any()


def test_megakernel_packed_entry_takes_the_bf16_wire():
    """A bipartite batch staged for the bf16 wire reaches the megakernel's
    packed entry widened: the same result as the widened batch through the
    batch entry (the plain versions on the CPU)."""
    from realtime_fraud_detection_tpu_torch.ops import megakernel as mk

    models = init_scoring_models(3, TINY_CONFIG, n_trees=8, tree_depth=3)
    batch = make_example_batch(8, ScorerConfig(), rng=np.random.default_rng(4))
    blobs, spec = pack_tree(_stage_bf16(batch))
    assert "bf16" in blobs
    tblobs = {k: torch.from_numpy(v) for k, v in blobs.items()}
    params = EnsembleParams.from_config(Config(), MODEL_NAMES)
    full = (True,) * 5
    got = mk.fused_megakernel_packed(models, tblobs, spec, params, mega_valid=full,
                                     bert_config=TINY_CONFIG)
    want = mk.fused_megakernel(models, widen_bf16(unpack_tree(tblobs, spec)), params,
                               mega_valid=full, bert_config=TINY_CONFIG)
    assert torch.equal(got, want) and torch.isfinite(got).all()
