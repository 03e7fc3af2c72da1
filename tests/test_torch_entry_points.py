"""The rest of the JAX package's entry points in the port, against JAX on the
CPU, with the tolerance each case states.

- Models: ``lstm_predict`` within the LSTM's bf16-vs-f32 gap (floored at
  ``torch_bounds.FLOOR``), ``gnn_predict`` within 1e-5 (f32), the tree and
  forest properties, ``TreeEnsemble.zeros`` and ``TokenLruCache.clear``
  exactly.
- Features, core, state, sim, config: ``make_decision``, ``feature_index``,
  ``ip_risk_score``, ``TransactionBatch.batch_size``, ``Policy``, ``unpad``
  (``tests/test_core.py``'s cases), the two-hop samples,
  ``generate_fraud_scenario`` / ``get_fraud_statistics`` / ``encode_dicts`` /
  ``FRAUD_TYPES`` from the same seed, ``produce_batch_stamped``,
  ``QuantSettings.stamp`` and ``capacity_tps``: exact.
- ``mesh_score_packed`` (``mesh_entry()``), the function the mesh executor
  dispatches through, on a data 1 x model 2 CPU mesh with BERT stored split:
  bit-equal to the executor, and against JAX's ``mesh_score_packed`` on the
  same bridged models and batch within the JAX kernel drill's noise bound,
  decisions exact; ``mesh_entry(donate=True)`` raises.
- ``DoubleBufferedScorer`` over the CPU scorer: the pairs it hands back equal
  a serial run bit for bit, one designated wait (with None) a batch.
- ``device_trace`` / ``annotate`` on the CPU write a Chrome trace holding the
  annotation; ``device_trace`` on "cuda" raises without a card;
  ``SpanTimer.span`` records.
- The blend's host copy (ROADMAP C.1): with ``Tensor.tolist`` patched to
  raise, ``epilogue_args`` after ``from_config(...).to(...)`` and after a
  blend refresh reads the new weights; off the CPU (the meta device) a
  weights tensor replaced or written in place makes it raise, on the CPU it
  is read again.
"""

import torch_threads  # first: torch held to one CPU thread
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_fraud_detection_tpu.cluster.drill import ShardDrillConfig as JShardDrillConfig
from realtime_fraud_detection_tpu.core import batching as jbatching
from realtime_fraud_detection_tpu.core import precision as jprecision
from realtime_fraud_detection_tpu.core.packing import pack_tree as jax_pack_tree
from realtime_fraud_detection_tpu.ensemble.combine import EnsembleParams as JEnsembleParams
from realtime_fraud_detection_tpu.features import extract as jextract
from realtime_fraud_detection_tpu.features import rules as jrules
from realtime_fraud_detection_tpu.features import schema as jschema
from realtime_fraud_detection_tpu.models import bert as jbert
from realtime_fraud_detection_tpu.models import gnn as jgnn
from realtime_fraud_detection_tpu.models import lstm as jlstm
from realtime_fraud_detection_tpu.models import trees as jtrees
from realtime_fraud_detection_tpu.models.tokenizer import TokenLruCache as JTokenLruCache
from realtime_fraud_detection_tpu.scoring import pipeline as jpipeline
from realtime_fraud_detection_tpu.scoring.mesh_executor import (
    mesh_score_packed as jax_mesh_score_packed,
)
from realtime_fraud_detection_tpu.sim import fraud_patterns as jpatterns
from realtime_fraud_detection_tpu.sim import simulator as jsim
from realtime_fraud_detection_tpu.state.history import EntityGraphStore as JEntityGraphStore
from realtime_fraud_detection_tpu.stream.transport import InMemoryBroker as JInMemoryBroker
from realtime_fraud_detection_tpu.utils.config import Config as JConfig
from realtime_fraud_detection_tpu.utils.config import QuantSettings as JQuantSettings
from realtime_fraud_detection_tpu_torch.bridge import models_from_numpy
from realtime_fraud_detection_tpu_torch.cluster.drill import ShardDrillConfig
from realtime_fraud_detection_tpu_torch.core import batching, precision, sync
from realtime_fraud_detection_tpu_torch.core.packing import pack_tree
from realtime_fraud_detection_tpu_torch.ensemble.combine import EnsembleParams
from realtime_fraud_detection_tpu_torch.features import extract, rules, schema
from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
from realtime_fraud_detection_tpu_torch.models.gnn import gnn_logits, gnn_predict
from realtime_fraud_detection_tpu_torch.models.lstm import lstm_logits, lstm_predict
from realtime_fraud_detection_tpu_torch.models.tokenizer import TokenLruCache
from realtime_fraud_detection_tpu_torch.models.trees import TreeEnsemble
from realtime_fraud_detection_tpu_torch.obs.profiling import SpanTimer, annotate, device_trace
from realtime_fraud_detection_tpu_torch.ops.epilogue import epilogue_args
from realtime_fraud_detection_tpu_torch.scoring.mesh_executor import (
    ROW_BLOCK,
    MeshExecutor,
    mesh_entry,
    mesh_score_packed,
)
from realtime_fraud_detection_tpu_torch.scoring.pipeline import (
    MODEL_NAMES,
    OUT_COLUMNS,
    ScorerConfig,
    make_example_batch,
    score_fused_packed,
)
from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
from realtime_fraud_detection_tpu_torch.sim import fraud_patterns, simulator
from realtime_fraud_detection_tpu_torch.state.history import EntityGraphStore
from realtime_fraud_detection_tpu_torch.stream.microbatch import DoubleBufferedScorer
from realtime_fraud_detection_tpu_torch.stream.transport import InMemoryBroker
from realtime_fraud_detection_tpu_torch.utils.config import Config, QuantSettings
from torch_bounds import FLOOR, near_rung, noise_bound

SC = ScorerConfig(text_len=16)
MV = np.ones(len(MODEL_NAMES), bool)
DEC, RISK = OUT_COLUMNS.index("decision"), OUT_COLUMNS.index("risk_level")


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def jax_models():
    return jax.tree_util.tree_map(np.asarray, jpipeline.init_scoring_models(
        jax.random.PRNGKey(3), bert_config=jbert.TINY_CONFIG,
        feature_dim=SC.feature_dim, node_dim=SC.node_dim))


@pytest.fixture(scope="module")
def port_models(jax_models):
    return models_from_numpy(jax_models)


# ---------------------------------------------------------------- models
def test_lstm_predict_matches_jax(jax_models, port_models):
    rng = np.random.default_rng(21)
    seq = rng.standard_normal((16, 10, 64)).astype(np.float32)
    lengths = rng.integers(0, 11, 16).astype(np.int32)
    want = np.asarray(jlstm.lstm_predict(jax_models.lstm, jnp.asarray(seq),
                                         jnp.asarray(lengths)))
    gap = np.abs(want - np.asarray(jax.nn.sigmoid(jlstm.lstm_logits(
        jax_models.lstm, jnp.asarray(seq), jnp.asarray(lengths),
        compute_dtype=jnp.float32)))).max()
    got = lstm_predict(port_models.lstm, _t(seq), _t(lengths))
    assert torch.equal(got, torch.sigmoid(lstm_logits(port_models.lstm, _t(seq), _t(lengths))))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=max(float(gap), FLOOR))
    assert lstm_predict(port_models.lstm, _t(seq)).shape == (16,)


def test_gnn_predict_matches_jax(jax_models, port_models):
    rng = np.random.default_rng(22)
    b, k, d = 16, 16, 16
    args = [rng.standard_normal((b, 64)), rng.standard_normal((b, d)),
            rng.standard_normal((b, d)), rng.standard_normal((b, k, d)),
            rng.random((b, k)) < 0.7, rng.standard_normal((b, k, d)),
            rng.random((b, k)) < 0.7]
    args = [a.astype(np.float32) if a.dtype.kind == "f" else a for a in args]
    want = np.asarray(jgnn.gnn_predict(jax_models.gnn, *[jnp.asarray(a) for a in args]))
    got = gnn_predict(port_models.gnn, *[_t(a) for a in args])
    assert torch.equal(got, torch.sigmoid(gnn_logits(port_models.gnn, *[_t(a) for a in args])))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_tree_properties_and_zeros_equal_jax(jax_models, port_models):
    assert port_models.trees.n_trees == jtrees.TreeEnsemble(**{
        f.name: getattr(jax_models.trees, f.name)
        for f in dataclasses.fields(jtrees.TreeEnsemble)}).n_trees
    assert port_models.trees.depth == int(np.log2(jax_models.trees.leaf.shape[1]))
    assert port_models.iforest.n_trees == jax_models.iforest.feature.shape[0]
    got, want = TreeEnsemble.zeros(7, 3, prior=-1.5), jtrees.TreeEnsemble.zeros(7, 3, prior=-1.5)
    assert (got.n_trees, got.depth) == (want.n_trees, want.depth) == (7, 3)
    for f in ("feature", "threshold", "leaf", "base_score"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)


def test_token_cache_clear_equals_jax():
    caches = [TokenLruCache(4), JTokenLruCache(4)]
    for c in caches:
        for i in range(6):
            c.put(f"t{i}", [i])
        c.get("t5")
        c.get("t0")
        c.clear()
    assert len(caches[0]) == len(caches[1]) == 0
    assert caches[0].stats() == caches[1].stats()
    assert caches[0].get("t5") is None


# -------------------------------------------------------------- features
@pytest.mark.parametrize("threshold", [0.7, 0.8])
def test_make_decision_equals_jax(threshold):
    rng = np.random.default_rng(5)
    score = np.concatenate([rng.random(64), [0.0, 0.5, 0.7, 0.8, 0.9, 1.0]]).astype(np.float32)
    black = rng.random(score.shape) < 0.2
    d, r = rules.make_decision(_t(score), _t(black), threshold)
    jd, jr = jrules.make_decision(jnp.asarray(score), jnp.asarray(black), threshold)
    assert d.dtype == r.dtype == torch.int32
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    assert (rules.VERY_LOW, rules.LOW, rules.MEDIUM, rules.HIGH, rules.CRITICAL) == \
        (jrules.VERY_LOW, jrules.LOW, jrules.MEDIUM, jrules.HIGH, jrules.CRITICAL)


def test_feature_index_ip_risk_and_batch_size_equal_jax():
    assert [extract.feature_index(n) for n in extract.FEATURE_NAMES] == \
        [jextract.feature_index(n) for n in jextract.FEATURE_NAMES]
    for ip in (None, "", "10.1.2.3", "192.168.0.4", "172.16.9.9", "172.17.0.1", "52.1.1.1"):
        assert schema.ip_risk_score(ip) == jschema.ip_risk_score(ip)
    batch = make_example_batch(40, SC, rng=np.random.default_rng(1))
    assert batch.txn.batch_size == jschema.TransactionBatch(**vars(batch.txn)).batch_size == 40


# ------------------------------------------------------------------- core
def test_policy_casts_like_jax_and_sets_nothing():
    tree = {"w": np.ones((2, 3), np.float32), "ids": np.arange(4, dtype=np.int32),
            "nested": [np.zeros(2, np.float64)]}
    port_tree = {"w": _t(tree["w"]), "ids": _t(tree["ids"]), "nested": [_t(tree["nested"][0])]}
    before = torch.get_float32_matmul_precision()
    for jp, tp in ((jprecision.DEFAULT_POLICY, precision.DEFAULT_POLICY),
                   (jprecision.FULL_PRECISION, precision.FULL_PRECISION)):
        for cast in ("cast_to_compute", "cast_to_output"):
            want = getattr(jp, cast)(jax.tree_util.tree_map(jnp.asarray, tree))
            got = getattr(tp, cast)(port_tree)
            names = [str(x.dtype) for x in jax.tree_util.tree_leaves(want)]
            assert [str(x.dtype).removeprefix("torch.") for x in
                    (got["ids"], got["nested"][0], got["w"])] == names
        assert isinstance(tp.matmul_precision(), str)
    assert precision.Policy() == precision.DEFAULT_POLICY
    assert torch.get_float32_matmul_precision() == before


def test_unpad_equals_jax_on_the_core_cases():
    tree = {"x": np.arange(12, dtype=np.float32).reshape(6, 2)}
    padded, mask, size = batching.pad_to_bucket(tree, 6)
    jpadded, jmask, jsize = jbatching.pad_to_bucket(tree, 6)
    assert size == jsize == 8 and np.array_equal(mask, jmask)
    np.testing.assert_array_equal(padded["x"], np.asarray(jpadded["x"]))
    np.testing.assert_array_equal(batching.unpad(padded, 6)["x"], tree["x"])
    tree = {"x": np.ones((6, 2)), "emb": np.arange(10)}
    padded, _, size = batching.pad_to_bucket(tree, 6)
    got = batching.unpad(padded, 6, padded_size=size)
    want = jbatching.unpad(jbatching.pad_to_bucket(tree, 6)[0], 6, padded_size=size)
    assert {k: v.shape for k, v in got.items()} == {k: np.shape(v) for k, v in want.items()} \
        == {"x": (6, 2), "emb": (10,)}


# -------------------------------------------------------------- state, sim
def test_two_hop_samples_equal_jax():
    rng = np.random.default_rng(9)
    users, merchants = rng.integers(0, 30, 400), rng.integers(0, 12, 400)
    port, jax_store = EntityGraphStore(fanout=5), JEntityGraphStore(fanout=5)
    port.add_edges(users, merchants)
    jax_store.add_edges(users, merchants)
    ids = [0, 3, 29, 31]                            # 31: no edges
    for name in ("user_two_hop", "merchant_two_hop"):
        got, want = getattr(port, name)(ids), getattr(jax_store, name)(ids)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_fraud_scenarios_and_statistics_equal_jax():
    port = fraud_patterns.AdvancedFraudPatterns(np.random.default_rng(17))
    jax_p = jpatterns.AdvancedFraudPatterns(np.random.default_rng(17))
    for _ in range(300):
        hit, name, sc = port.generate_fraud_scenario()
        jhit, jname, jsc = jax_p.generate_fraud_scenario()
        assert (hit, name) == (jhit, jname)
        assert (sc is None) == (jsc is None)
        if sc is not None:
            assert dataclasses.asdict(sc) == dataclasses.asdict(jsc)
    for p in (port, jax_p):
        p.record_location("u1", {"lat": 1.0, "lon": 2.0})
    assert port.get_fraud_statistics() == jax_p.get_fraud_statistics()


def test_encode_dicts_and_fraud_types_equal_jax():
    assert simulator.FRAUD_TYPES == jsim.FRAUD_TYPES
    port = simulator.TransactionGenerator(num_users=300, num_merchants=40, seed=11)
    jax_g = jsim.TransactionGenerator(num_users=300, num_merchants=40, seed=11)
    records = port.generate_batch(64)
    assert records == jax_g.generate_batch(64)
    got, want = port.encode_dicts(records), jax_g.encode_dicts(records)
    for f in dataclasses.fields(want):
        g, w = np.asarray(getattr(got, f.name)), np.asarray(getattr(want, f.name))
        assert g.dtype == w.dtype and np.array_equal(g, w), f.name


def test_produce_batch_stamped_equals_jax():
    items = [(f"user_{i % 7}", {"n": i}, 1000.0 + 0.25 * i) for i in range(40)]
    out = []
    for broker in (InMemoryBroker(), JInMemoryBroker()):
        assert broker.produce_batch_stamped("transactions", items) == 40
        consumer = broker.consumer(["transactions"], "g")
        out.append(sorted((r.partition, r.offset, r.key, r.value["n"], r.timestamp)
                          for r in consumer.poll(100)))
    assert out[0] == out[1] and len(out[0]) == 40


def test_quant_stamp_and_capacity_equal_jax():
    for make in ("__call__", "full"):
        port = QuantSettings() if make == "__call__" else QuantSettings.full()
        jq = JQuantSettings() if make == "__call__" else JQuantSettings.full()
        assert port.stamp() == jq.stamp()
    assert QuantSettings.full().stamp() == {"bert_weights": "int8"}
    for cfg, jcfg in ((ShardDrillConfig(), JShardDrillConfig()),
                      (ShardDrillConfig.fast(), JShardDrillConfig.fast())):
        assert cfg.capacity_tps() == jcfg.capacity_tps()


# ---------------------------------------------------------------- scoring
def _scorer(models):
    return TorchFraudScorer(models=models, scorer_config=SC, bert_config=TINY_CONFIG,
                            device="cpu")


def test_mesh_score_packed_equals_the_executor_and_jax(jax_models, port_models):
    n = ROW_BLOCK
    batch = make_example_batch(n, SC, rng=np.random.default_rng(13))
    blobs, spec = pack_tree(batch)
    scorer = _scorer(port_models)
    ex = MeshExecutor(scorer, devices=["cpu"] * 2, model_axis=2, inflight_depth=1,
                      shard_branches=("bert_text",))
    rep = ex.replicas[0]
    assert mesh_entry() is mesh_score_packed
    with pytest.raises(ValueError, match="donation"):
        mesh_entry(donate=True)
    out, event, launches, gathered, mega = mesh_score_packed(
        rep.stored, blobs, spec, scorer.ensemble_params, MV, scorer=scorer,
        static=scorer.kernel_static(n, MV), device=torch.device("cpu"), specs=rep.specs,
        gather_fields=ex._gather_fields, data_row=0, n_model=2)
    assert event is None and launches == 0 and mega is None
    assert torch.equal(gathered.bert["word_emb"], port_models.bert["word_emb"])
    got = out.numpy()
    assert got.tobytes() == ex.wait(ex.dispatch_packed(
        blobs, spec, scorer.ensemble_params, MV)).numpy().tobytes()

    fields = {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)
              if f.name != "txn"}
    jbatch = jpipeline.ScoreBatch(txn=jschema.TransactionBatch(**vars(batch.txn)), **fields)
    jblobs, jspec = jax_pack_tree(jbatch)
    ens = JEnsembleParams.from_config(JConfig(), list(MODEL_NAMES))
    want = np.asarray(jax_mesh_score_packed(
        jax_models, jblobs["f32"], jblobs["i32"], jblobs["u8"], spec=jspec, params=ens,
        model_valid=MV, blob_bf16=jblobs.get("bf16"), bert_config=jbert.TINY_CONFIG))
    bound = noise_bound(jax_models.bert, [(batch.token_ids, batch.token_mask)],
                        np.asarray(ens.weights), MV)
    assert got.shape == want.shape
    assert not (near_rung(want[:, 0], bound) | near_rung(want[:, 1], bound)).any()
    np.testing.assert_array_equal(got[:, [DEC, RISK]], want[:, [DEC, RISK]])
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=0, atol=bound)


def _score_fn(scorer):
    """Assemble (which moves the scorer's history and graph state), pad,
    pack and score one batch; the result stays where it was computed."""
    def score(records):
        padded, mask, size = batching.pad_to_bucket(scorer.assemble(records), len(records))
        blobs, spec = pack_tree(dataclasses.replace(padded, valid=mask))
        mv = scorer.effective_model_valid()
        return score_fused_packed(
            scorer.models, {k: torch.from_numpy(v) for k, v in blobs.items()}, spec,
            scorer.ensemble_params, torch.from_numpy(mv), bert_config=TINY_CONFIG,
            **scorer.quant_static(), **scorer.kernel_static(size, mv))
    return score


def test_double_buffered_scorer_equals_serial(port_models, monkeypatch):
    gen = simulator.TransactionGenerator(num_users=200, num_merchants=50, seed=4)
    batches = [gen.generate_batch(n) for n in (32, 20, 32, 7)]
    # two fresh scorers: the serial and the double-buffered run see the same
    # assembly state batch by batch
    serial_scorer, scorer = _scorer(port_models), _scorer(port_models)
    for s in (serial_scorer, scorer):
        s.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    serial = [_score_fn(serial_scorer)(b) for b in batches]
    waits = []
    real = sync.device_wait
    monkeypatch.setattr(sync, "device_wait", lambda e: (waits.append(e), real(e))[1])
    dbs, done = DoubleBufferedScorer(_score_fn(scorer)), []
    assert dbs.submit(batches[0]) is None
    for b in batches[1:]:
        done.append(dbs.submit(b))
    done.append(dbs.drain())
    assert dbs.drain() is None
    assert [b for b, _ in done] == batches
    assert all(torch.equal(r, s) for (_, r), s in zip(done, serial))
    assert waits == [None] * len(batches)


# ------------------------------------------------------------------ obs
def test_device_trace_and_span(tmp_path, monkeypatch):
    with device_trace(str(tmp_path), device="cpu") as prof:
        with annotate("text_analyzer"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    path = pathlib.Path(prof.trace_path)
    assert path.parent == tmp_path and path.suffix == ".json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "text_analyzer" for e in events)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            with device_trace(str(tmp_path)):
                pass
    timer = SpanTimer()
    with timer.span("assemble"):
        pass
    with pytest.raises(KeyError):
        with timer.span("dispatch"):
            raise KeyError("still recorded")
    stats = timer.stats()
    assert stats["assemble"]["count"] == stats["dispatch"]["count"] == 1


# ---------------------------------------------------------- the blend (C.1)
def test_epilogue_args_read_the_host_copy_never_the_tensor(port_models, monkeypatch):
    cfg = Config()
    want = np.asarray(JEnsembleParams.from_config(JConfig(), list(MODEL_NAMES)).weights)
    scorer = _scorer(port_models)

    def pulled(self, *a, **k):
        raise AssertionError("a blend tensor was read with tolist()")

    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "tolist", pulled)
        params = EnsembleParams.from_config(cfg, MODEL_NAMES).to("cpu")
        args = epilogue_args(params, len(MODEL_NAMES))
        np.testing.assert_array_equal(np.float32(list(args.w)[:5]), want)
        scorer.config.models["bert_text"].weight = 0.6
        scorer.refresh_blend_from_config()
        fresh = list(epilogue_args(scorer.ensemble_params, len(MODEL_NAMES)).w)[:5]
    norm = scorer.config.normalized_weights()
    np.testing.assert_array_equal(np.float32(fresh),
                                  np.float32([norm[n] for n in MODEL_NAMES]))
    assert fresh != list(args.w)[:5]
    assert list(epilogue_args(dataclasses.replace(params, strategy=1), 5).w) == list(args.w)
    # off the CPU (the meta device stands in for the card here) the copy is
    # carried by to(), and a replaced or in-place-written tensor raises
    # instead of being read
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "tolist", pulled)
        away = EnsembleParams.from_config(cfg, MODEL_NAMES).to("meta")
        assert list(epilogue_args(away, len(MODEL_NAMES)).w) == list(args.w)
        away.weights.mul_(2.0)
        with pytest.raises(ValueError, match="no current host copy"):
            epilogue_args(away, len(MODEL_NAMES))
        away = EnsembleParams.from_config(cfg, MODEL_NAMES).to("meta")
        away.weights = away.weights * 2
        with pytest.raises(ValueError, match="no current host copy"):
            epilogue_args(away, len(MODEL_NAMES))
    # built by hand on the CPU, then moved: the copy is read there and carried
    hand = EnsembleParams(weights=torch.tensor([0.5, 0.25, 0.25]),
                          confidence_multipliers=torch.ones(3)).to("meta")
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "tolist", pulled)
        assert list(epilogue_args(hand, 3).w)[:3] == [0.5, 0.25, 0.25]
    params.weights.mul_(2.0)                # on the CPU: read again
    np.testing.assert_array_equal(np.float32(list(epilogue_args(params, 5).w)[:5]),
                                  want * 2)
