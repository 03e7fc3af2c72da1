"""The PyTorch port's host half against the JAX package, module by module,
on the CPU: the tokenizer, the text join, the two encoders and the entity
row cache, the state stores, the history ring and the bipartite graph, the
scorer's entity index, the in-memory broker, the microbatch assembler, the
stream sanitizer, the simulator and profiling spans, and
``TorchFraudScorer.assemble`` against ``FraudScorer.assemble`` over three
consecutive batches.

Tolerances: every column exact, apart from the three transcendental
feature columns (log, sqrt, haversine), which the two frameworks compute to
within 1e-5 (``tests/test_torch_models.py test_features_match_jax``).
"""

import torch_threads  # noqa: F401  (first: torch held to one CPU thread)
import copy
import dataclasses

import jax
import numpy as np
import pytest

from realtime_fraud_detection_tpu.features import schema as jschema
from realtime_fraud_detection_tpu.models.text import combined_text as jax_combined_text
from realtime_fraud_detection_tpu.models.tokenizer import (
    FraudTokenizer as JaxFraudTokenizer,
)
from realtime_fraud_detection_tpu.obs.profiling import (
    SpanTimer as JaxSpanTimer,
)
from realtime_fraud_detection_tpu.scoring.pipeline import (
    ScorerConfig as JaxScorerConfig,
)
from realtime_fraud_detection_tpu.scoring.scorer import FraudScorer
from realtime_fraud_detection_tpu.scoring.scorer import (
    _EntityIndex as JaxEntityIndex,
)
from realtime_fraud_detection_tpu.serving.validation import (
    sanitize_for_stream as jax_sanitize,
)
from realtime_fraud_detection_tpu.sim.simulator import (
    TransactionGenerator as JaxTransactionGenerator,
)
from realtime_fraud_detection_tpu.state import history as jhistory
from realtime_fraud_detection_tpu.state import stores as jstores
from realtime_fraud_detection_tpu.stream import topics as JT
from realtime_fraud_detection_tpu.stream.microbatch import (
    MicrobatchAssembler as JaxMicrobatchAssembler,
)
from realtime_fraud_detection_tpu.stream.transport import (
    FaultInjector as JaxFaultInjector,
    InMemoryBroker as JaxInMemoryBroker,
)
from realtime_fraud_detection_tpu_torch.bridge import models_from_numpy
from realtime_fraud_detection_tpu_torch.features import schema
from realtime_fraud_detection_tpu_torch.features.extract import FEATURE_NAMES
from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
from realtime_fraud_detection_tpu_torch.models.text import combined_text
from realtime_fraud_detection_tpu_torch.models.tokenizer import FraudTokenizer
from realtime_fraud_detection_tpu_torch.obs.profiling import (
    SpanTimer,
    interpolated_percentile,
)
from realtime_fraud_detection_tpu_torch.scoring.pipeline import ScorerConfig
from realtime_fraud_detection_tpu_torch.scoring.scorer import (
    TorchFraudScorer,
    _EntityIndex,
)
from realtime_fraud_detection_tpu_torch.serving.validation import sanitize_for_stream
from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
from realtime_fraud_detection_tpu_torch.state import history, stores
from realtime_fraud_detection_tpu_torch.stream import topics as T
from realtime_fraud_detection_tpu_torch.stream.microbatch import MicrobatchAssembler
from realtime_fraud_detection_tpu_torch.stream.transport import (
    FaultInjector,
    InMemoryBroker,
)

TRANSCENDENTAL = [FEATURE_NAMES.index(n) for n in (
    "amount_log", "amount_sqrt", "distance_to_merchant_km")]
EXACT = [i for i in range(len(FEATURE_NAMES)) if i not in TRANSCENDENTAL]


def assert_features_close(got, want):
    """Exact apart from the three transcendental columns (last axis)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got[..., EXACT], want[..., EXACT])
    np.testing.assert_allclose(got[..., TRANSCENDENTAL], want[..., TRANSCENDENTAL],
                               rtol=1e-5, atol=1e-5)


def _mutate(records, rng):
    """Holes and odd values, so the encoders' default paths run too."""
    for r in records:
        u = rng.random(6)
        if u[0] < 0.2:
            r.pop("geolocation", None)
        if u[1] < 0.15:
            r["payment_method"] = None
        if u[2] < 0.1:
            r.pop("device_fingerprint", None)
        if u[3] < 0.1:
            r["user_id"] = f"ghost_{int(rng.integers(4))}"
        if u[4] < 0.1:
            r["merchant_id"] = f"ghostm_{int(rng.integers(4))}"
        if u[5] < 0.1:
            r["user_agent"] = "curl-bot"
    return records


@pytest.fixture(scope="module")
def gens():
    """The same seed in both simulators."""
    return (TransactionGenerator(num_users=80, num_merchants=30, seed=5),
            JaxTransactionGenerator(num_users=80, num_merchants=30, seed=5))


# ------------------------------------------------------------------ simulator
@pytest.mark.parametrize("seed,users,merchants", [(11, 60, 25), (42, 200, 70)])
def test_simulator_records_and_profiles_match_jax(seed, users, merchants):
    port = TransactionGenerator(num_users=users, num_merchants=merchants, seed=seed)
    ref = JaxTransactionGenerator(num_users=users, num_merchants=merchants, seed=seed)
    assert port.users.profiles() == ref.users.profiles()
    assert port.merchants.profiles() == ref.merchants.profiles()
    for n in (50, 7, 120):                 # the generators stay in step
        assert port.generate_batch(n) == ref.generate_batch(n)
    assert port.patterns.velocity_windows == ref.patterns.velocity_windows
    assert port.patterns.geographic_history == ref.patterns.geographic_history


def test_simulator_generate_encoded_matches_jax():
    port = TransactionGenerator(num_users=50, num_merchants=20, seed=3)
    ref = JaxTransactionGenerator(num_users=50, num_merchants=20, seed=3)
    batch, labels = port.generate_encoded(64)
    jbatch, jlabels = ref.generate_encoded(64)
    for name in schema.FIELD_NAMES:
        np.testing.assert_array_equal(np.asarray(getattr(batch, name)),
                                      np.asarray(getattr(jbatch, name)), err_msg=name)
    for k in jlabels:
        np.testing.assert_array_equal(labels[k], jlabels[k])


# ------------------------------------------------------------ text, tokenizer
def test_combined_text_matches_jax():
    cases = [{}, {"merchant_name": "Biz 4 Crypto Exchange"},
             {"merchant_name": "Shop", "description": "gift card reload",
              "category": "retail", "location": "NYC"},
             {"description": "", "category": "gambling", "location": None}]
    for case in cases:
        assert combined_text(case) == jax_combined_text(case)


def test_tokenizer_ids_masks_and_lru_stats_match_jax(gens):
    texts = [combined_text({"merchant_name": p["name"], "category": p["category"],
                            "description": "URGENT: buy bitcoin, act now!!"})
             for p in gens[0].merchants.profiles().values()]
    texts += ["", "   ", "Ünïcödé wörds and 12345 numbers", texts[0], texts[3]]
    port = FraudTokenizer(vocab_size=TINY_CONFIG.vocab_size, max_length=16,
                          cache_entries=8)
    ref = JaxFraudTokenizer(vocab_size=TINY_CONFIG.vocab_size, max_length=16,
                            cache_entries=8)
    for chunk in (texts[:10], texts[10:], texts[:4] + texts[-3:]):
        ids, mask = port.encode_batch(chunk)
        want_ids, want_mask = ref.encode_batch(chunk)
        assert ids.dtype == want_ids.dtype and mask.dtype == want_mask.dtype
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(mask, want_mask)
        assert port.cache_stats() == ref.cache_stats()
    assert port.vocab == ref.vocab
    assert int(ids.max()) < TINY_CONFIG.vocab_size


# ------------------------------------------------------------------- encoders
def _records(gen, n, seed):
    return _mutate(gen.generate_batch(n), np.random.default_rng(seed))


@pytest.mark.parametrize("columnar", [False, True])
def test_encoders_match_jax_column_for_column(gens, columnar):
    gen = gens[0]
    records = _records(gen, 96, seed=1 + columnar)
    users, merchants = gen.users.profiles(), gen.merchants.profiles()
    # some profiles absent, so the unknown-entity defaults are encoded too
    users = {k: v for i, (k, v) in enumerate(users.items()) if i % 5}
    vel = stores.VelocityStore()
    for r in records[:40]:
        vel.update(str(r["user_id"]), float(r["amount"]), 1000.0)
    velocities = {str(r["user_id"]): vel.get_all(str(r["user_id"]), 1010.0)
                  for r in records}
    if columnar:
        got = schema.encode_transactions_columnar(records, users, merchants,
                                                  velocities)
        want = jschema.encode_transactions_columnar(records, users, merchants,
                                                    velocities)
    else:
        got = schema.encode_transactions(records, users, merchants, velocities)
        want = jschema.encode_transactions(records, users, merchants, velocities)
    for name in schema.FIELD_NAMES:
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype == schema.column_dtype(name), name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_entity_row_cache_invalidates_on_profile_change(gens):
    gen = gens[0]
    records = _records(gen, 64, seed=9)
    port_store, ref_store = stores.ProfileStore(), jstores.ProfileStore()
    port_cache, ref_cache = schema.EntityRowCache(), jschema.EntityRowCache()
    for store in (port_store, ref_store):
        store.seed(gen.users.profiles(), gen.merchants.profiles())
    uid = str(records[0]["user_id"])
    mid = str(records[0]["merchant_id"])

    def encode(store, cache, mod):
        cache.sync(store)
        ups = {str(r["user_id"]): store.get_user(str(r["user_id"])) for r in records}
        mps = {str(r["merchant_id"]): store.get_merchant(str(r["merchant_id"]))
               for r in records}
        return mod.encode_transactions_columnar(
            records, {k: v for k, v in ups.items() if v is not None},
            {k: v for k, v in mps.items() if v is not None}, cache=cache)

    for step in range(3):
        got = encode(port_store, port_cache, schema)
        want = encode(ref_store, ref_cache, jschema)
        for name in schema.FIELD_NAMES:
            np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                          np.asarray(getattr(want, name)))
        assert port_cache.stats() == ref_cache.stats()
        if step == 0:      # a profile rewrite moves the generation
            for store in (port_store, ref_store):
                store.put_user(uid, dict(store.get_user(uid), risk_score=0.99,
                                         kyc_status="rejected"))
                store.put_merchant(mid, dict(store.get_merchant(mid),
                                             category="gambling"))
    row = next(i for i, r in enumerate(records) if str(r["user_id"]) == uid)
    assert float(np.asarray(got.user_risk_score)[row]) == pytest.approx(0.99)
    assert port_cache.misses > 0 and port_cache.hits > 0


# ---------------------------------------------------------------------- state
def test_velocity_profile_and_txn_cache_sequences_match_jax(gens):
    gen = gens[0]
    records = _records(gen, 120, seed=4)
    port_v, ref_v = stores.VelocityStore(), jstores.VelocityStore()
    port_c, ref_c = (stores.TransactionCache(user_list_len=3, merchant_list_len=5),
                     jstores.TransactionCache(user_list_len=3, merchant_list_len=5))
    t = 1000.0
    for i, r in enumerate(records):
        t += [1.0, 250.0, 3000.0, 40_000.0][i % 4]   # crosses every window
        uid = str(r["user_id"])
        port_v.update(uid, float(r["amount"]), t)
        ref_v.update(uid, float(r["amount"]), t)
        port_c.cache_transaction(r, now=t)
        ref_c.cache_transaction(r, now=t)
        for now in (t, t + 400.0, None):
            assert port_v.get_all(uid, now) == ref_v.get_all(uid, now)
        assert port_c.get_user_transactions(uid) == ref_c.get_user_transactions(uid)
    assert port_v.entries() == ref_v.entries()
    for now in (t, t + 50_000.0, t + 100_000.0):     # txn TTL is 24 h
        assert port_c.entries(now) == ref_c.entries(now)
        tid = str(records[-1]["transaction_id"])
        assert port_c.get_transaction(tid, now) == ref_c.get_transaction(tid, now)
    port_c.store_features("x", [1.0], now=t)
    ref_c.store_features("x", [1.0], now=t)
    for now in (t + 7000.0, t + 7300.0):             # features TTL is 2 h
        assert port_c.get_features("x", now) == ref_c.get_features("x", now)
    mid = str(records[0]["merchant_id"])
    assert port_c.get_merchant_transactions(mid) == ref_c.get_merchant_transactions(mid)

    port_p, ref_p = stores.ProfileStore(), jstores.ProfileStore()
    for store in (port_p, ref_p):
        store.seed(gen.users.profiles(), {})
        store.seed({}, gen.merchants.profiles())
        store.seed({}, {})
        store.put_user("new", {"risk_score": 0.1})
    assert (port_p.generation, port_p.users, port_p.merchants) == \
        (ref_p.generation, ref_p.users, ref_p.merchants)
    ts = {"timestamp": records[0]["timestamp"]}
    assert stores._event_time_ms(ts, None) == jstores._event_time_ms(ts, None)
    assert stores._event_time_ms({}, 12.5) == jstores._event_time_ms({}, 12.5)


def test_history_ring_and_graph_over_three_batches_match_jax(gens):
    gen = gens[0]
    rng = np.random.default_rng(8)
    port_h, ref_h = history.UserHistoryStore(4, 6), jhistory.UserHistoryStore(4, 6)
    port_g, ref_g = history.EntityGraphStore(3), jhistory.EntityGraphStore(3)
    for b in range(3):
        # repeated users inside a batch take the occurrence rounds
        users = [f"u{int(i)}" for i in rng.integers(0, 7, 24)]
        feats = rng.standard_normal((24, 6)).astype(np.float32)
        got, got_len = port_h.append_and_gather(users, feats)
        want, want_len = ref_h.append_and_gather(users, feats)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_len, want_len)
        u_idx = rng.integers(0, 9, 24)
        m_idx = rng.integers(0, 5, 24)
        for side in ("user_neighbors", "merchant_neighbors"):
            ids = u_idx if side == "user_neighbors" else m_idx
            for a, c in zip(getattr(port_g, side)(ids), getattr(ref_g, side)(ids)):
                np.testing.assert_array_equal(a, c)
        port_g.add_edges(u_idx, m_idx)
        ref_g.add_edges(u_idx, m_idx)
    assert len(port_h) == len(ref_h) == 7


def test_entity_index_matches_jax(gens):
    gen = gens[0]
    users, merchants = gen.users.profiles(), gen.merchants.profiles()
    port_u, ref_u = _EntityIndex(16), JaxEntityIndex(16)
    port_m, ref_m = _EntityIndex(16), JaxEntityIndex(16)
    rng = np.random.default_rng(6)
    uids = list(users) + ["ghost"]
    mids = list(merchants)
    for step in range(3):
        # users seen first without a profile get it later (row refreshed)
        known = users if step else {}
        batch_u = [uids[int(i)] for i in rng.integers(0, len(uids), 300)]
        batch_u += [f"fresh{step}_{i}" for i in range(120)]
        batch_m = [mids[int(i)] for i in rng.integers(0, len(mids), 300)]
        np.testing.assert_array_equal(port_u.lookup_batch(batch_u, known, False),
                                      ref_u.lookup_batch(batch_u, known, False))
        np.testing.assert_array_equal(port_m.lookup_batch(batch_m, merchants, True),
                                      ref_m.lookup_batch(batch_m, merchants, True))
        np.testing.assert_array_equal(port_u.table(), ref_u.table())
        np.testing.assert_array_equal(port_m.table(), ref_m.table())
    assert port_u.table().shape[0] > 256      # grew past the first capacity


# --------------------------------------------------------------------- stream
def test_broker_partitions_commit_replay_and_lag_match_jax(gens):
    records = gens[0].generate_batch(60)
    port, ref = InMemoryBroker(), JaxInMemoryBroker()
    assert [(t.name, t.partitions) for t in T.TOPIC_SPECS] == \
        [(t.name, t.partitions) for t in JT.TOPIC_SPECS]
    for broker in (port, ref):
        broker.produce_batch(T.TRANSACTIONS, records,
                             key_fn=lambda r: str(r["user_id"]))
        for i in range(9):
            broker.produce("unkeyed-topic", {"n": i})
    for key in ("user_1", "m-997", "", "unicode-é"):
        assert port.select_partition(T.TRANSACTIONS, key) == \
            ref.select_partition(T.TRANSACTIONS, key)
    assert port.end_offsets(T.TRANSACTIONS) == ref.end_offsets(T.TRANSACTIONS)
    assert port.end_offsets("unkeyed-topic") == ref.end_offsets("unkeyed-topic")

    def drive(broker):
        seen = []
        c = broker.consumer([T.TRANSACTIONS], "g")
        seen.append([r.value["transaction_id"] for r in c.poll(25)])
        c.commit()
        lag1 = broker.lag("g", T.TRANSACTIONS)
        seen.append([r.value["transaction_id"] for r in c.poll(10)])
        # crash without commit: the group replays from the committed offset
        c2 = broker.consumer([T.TRANSACTIONS], "g")
        seen.append([r.value["transaction_id"] for r in c2.poll(1000)])
        lag2 = broker.lag("g", T.TRANSACTIONS)
        c2.commit()
        scoped = broker.consumer([T.TRANSACTIONS], "h",
                                 partitions={T.TRANSACTIONS: [0, 3]})
        # a stamped produce or commit below a partition's fence is refused
        part = broker.select_partition(T.TRANSACTIONS, "user_1")
        broker.fence_producers(T.TRANSACTIONS, [part, 1], generation=3)
        refused = []
        for gen_, op in ((2, "produce"), (3, "produce"), (2, "commit")):
            try:
                if op == "produce":
                    broker.produce(T.TRANSACTIONS, {"n": 0}, key="user_1",
                                   generation=gen_)
                else:
                    broker.commit("g", {(T.TRANSACTIONS, part): 1}, generation=gen_)
                refused.append(False)
            except RuntimeError as exc:
                refused.append(type(exc).__name__)
        return (seen, lag1, lag2, broker.lag("g", T.TRANSACTIONS), c2.lag(),
                scoped.lag(), c.snapshot_positions(), refused,
                broker.producer_fence_stats(),
                broker.producer_fence(T.TRANSACTIONS, 1))

    assert drive(port) == drive(ref)


def test_fault_injection_matches_jax():
    def drive(broker, faults):
        for i in range(200):
            broker.produce(T.TRANSACTIONS, {"n": i}, key="k")
        c = broker.consumer([T.TRANSACTIONS], "g", faults=faults)
        return [[r.value["n"] for r in c.poll(64)] for _ in range(40)]

    got = drive(InMemoryBroker(), FaultInjector(0.1, 0.1, seed=42))
    assert got == drive(JaxInMemoryBroker(), JaxFaultInjector(0.1, 0.1, seed=42))
    flat = [n for poll in got for n in poll]
    assert set(flat) == set(range(200)) and len(flat) > 200


def test_microbatch_size_and_deadline_triggers_match_jax():
    def drive(broker_cls, assembler_cls):
        b = broker_cls()
        for i in range(300):
            b.produce(T.TRANSACTIONS, {"n": i}, key=str(i))
        clock = [0.0]
        a = assembler_cls(b.consumer([T.TRANSACTIONS], "g"), max_batch=128,
                          max_delay_ms=5.0, clock=lambda: clock[0])
        out = [[r.value["n"] for r in a.next_batch(block=False)]
               for _ in range(3)]                 # size, size, 44 pending
        clock[0] += 0.006                         # 6 ms later: deadline
        out.append([r.value["n"] for r in a.next_batch(block=False)])
        for i in range(3):
            b.produce(T.TRANSACTIONS, {"n": 1000 + i}, key="k")
        out.append([r.value["n"] for r in a.next_batch(block=False)])
        out.append([r.value["n"] for r in a.flush()])
        return out, a.close_reasons, a.batches_emitted, a.records_emitted

    got = drive(InMemoryBroker, MicrobatchAssembler)
    assert got == drive(JaxInMemoryBroker, JaxMicrobatchAssembler)
    assert [len(x) for x in got[0]] == [128, 128, 0, 44, 0, 3]
    assert got[1] == {"size": 2, "deadline": 1, "flush": 1}


@pytest.mark.parametrize("body", [
    {"transaction_id": "t1", "user_id": "u", "merchant_id": "m", "amount": "12.5",
     "hour_of_day": "7", "day_of_week": 9, "day_of_month": float("inf"),
     "fraud_score": float("nan"), "geolocation": {"lat": "1.5", "lon": 2},
     "merchant_location": {"lat": 1}, "payment_method": 3, "ip_address": 10},
    {"transaction_id": "t2", "user_id": "u", "merchant_id": "m", "amount": -1},
    {"transaction_id": "", "user_id": "u", "amount": "x"},
    {"transaction_id": 7, "user_id": 8, "merchant_id": 9, "amount": 1,
     "features": [1, 2]},
    ["not", "a", "record"],
])
def test_sanitize_for_stream_matches_jax(body):
    got = sanitize_for_stream(copy.deepcopy(body))
    assert got == jax_sanitize(copy.deepcopy(body))


# ------------------------------------------------------------------ profiling
def test_span_timer_and_percentile_match_jax():
    xs = [0.003, 0.001, 0.002, 0.010, 0.004, 0.0005]
    port, ref = SpanTimer(max_samples=4), JaxSpanTimer(max_samples=4)
    for i, x in enumerate(xs):
        for timer in (port, ref):
            timer.record("pack" if i % 2 else "assemble", x)
    assert port.stats() == ref.stats()
    assert port.stats("pack") == ref.stats("pack")
    for q in (0.0, 0.5, 0.99, 1.0):       # numpy's linear convention
        assert interpolated_percentile(sorted(xs), q) == pytest.approx(
            float(np.percentile(xs, q * 100)), rel=1e-12)
    port.reset()
    assert port.stats() == {}


# ------------------------------------------------------------------- assemble
@pytest.fixture(scope="module")
def assemble_pair():
    jax_scorer = FraudScorer(scorer_config=JaxScorerConfig(text_len=32), seed=3)
    port_scorer = TorchFraudScorer(
        models=models_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                        jax_scorer.models)),
        scorer_config=ScorerConfig(text_len=32), bert_config=TINY_CONFIG,
        device="cpu")
    gen = JaxTransactionGenerator(num_users=40, num_merchants=15, seed=21)
    for s in (jax_scorer, port_scorer):
        s.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    return gen, jax_scorer, port_scorer


def test_assemble_matches_jax_over_three_batches(assemble_pair):
    gen, jax_scorer, port_scorer = assemble_pair
    rng = np.random.default_rng(12)
    for step in range(3):
        records = _mutate(gen.generate_batch(48), rng)
        now = 1000.0 + 100.0 * step
        got = port_scorer.assemble(records, now)
        want = jax_scorer.assemble(records, now)
        for name in schema.FIELD_NAMES:
            g, w = np.asarray(getattr(got.txn, name)), np.asarray(getattr(want.txn, name))
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        assert_features_close(got.features, want.features)
        assert_features_close(got.history, want.history)
        for f in dataclasses.fields(got):
            if f.name in ("txn", "features", "history"):
                continue
            g, w = getattr(got, f.name), getattr(want, f.name)
            if w is None:
                assert g is None, f.name
                continue
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        # write back the same velocity and cache state before the next batch
        results = [{"transaction_id": r["transaction_id"], "fraud_score": 0.1,
                    "decision": "APPROVE", "risk_level": "LOW", "confidence": 0.9}
                   for r in records]
        port_scorer._write_back(records, results, now)
        jax_scorer._write_back(records, results, now)
    assert port_scorer.velocity.entries() == jax_scorer.velocity.entries()
    stages = port_scorer.host_stats()
    assert set(stages["stages"]) >= {"assemble", "graph"}
    assert stages["caches"] == jax_scorer.host_stats()["caches"]


def test_scorer_refuses_an_unported_tokenizer_or_a_wider_vocab():
    # "word" and "wordpiece" are ported; any other name is refused
    with pytest.raises(ValueError, match="tokenizer"):
        TorchFraudScorer(scorer_config=ScorerConfig(tokenizer="sentencepiece"),
                         device="cpu")
    # a vocabulary wider than the BERT embedding table is refused: on the
    # card an out-of-range id would reach a gather with no bounds check
    narrow = dataclasses.replace(TINY_CONFIG, vocab_size=2000)
    with pytest.raises(ValueError, match="vocab_size"):
        TorchFraudScorer(scorer_config=ScorerConfig(tokenizer="wordpiece"),
                         bert_config=narrow, device="cpu")
    # the word tokenizer's vocab is the BERT vocab: an id is always in range
    s = TorchFraudScorer(scorer_config=ScorerConfig(text_len=16), device="cpu")
    assert s.tokenizer.vocab_size == s.bert_config.vocab_size


def test_score_batch_writes_back_and_dispatch_of_nothing(assemble_pair):
    gen = TransactionGenerator(num_users=40, num_merchants=15, seed=21)
    scorer = TorchFraudScorer(scorer_config=ScorerConfig(text_len=16),
                              device="cpu", seed=2)
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    records = gen.generate_batch(5)
    results = scorer.score_batch(records, now=50.0)
    assert [r["transaction_id"] for r in results] == \
        [r["transaction_id"] for r in records]
    cached = scorer.txn_cache.get_transaction(records[0]["transaction_id"], now=50.0)
    assert cached["decision"] == results[0]["decision"]
    assert scorer.stats["scored"] == 5 and scorer.stats["batches"] == 1
    # the stage table, and the collector's generations that have collected
    stages = set(scorer.host_stats()["stages"])
    assert {s for s in stages if not s.startswith("gc.")} == {
        "assemble", "encode", "features", "history", "graph", "tokens",
        "pack", "dispatch", "h2d", "launch", "device_wait", "responses",
        "write_back"}
    assert {s for s in stages if s.startswith("gc.")} <= {
        "gc.gen0", "gc.gen1", "gc.gen2"}
    empty = scorer.dispatch([], now=51.0)
    assert empty.n == 0 and scorer.finalize(empty, now=51.0) == []


# ------------------------------------------------------ assemble_serial
def _serial_pair(seed=5):
    """Two identically seeded port scorers (each assembly path mutates the
    history and graph state, so each gets its own) and a JAX scorer."""
    gen = TransactionGenerator(num_users=120, num_merchants=40, seed=seed)
    jax_scorer = FraudScorer(scorer_config=JaxScorerConfig(text_len=32), seed=3)
    models = models_from_numpy(jax.tree_util.tree_map(np.asarray, jax_scorer.models))
    port = [TorchFraudScorer(models=models, scorer_config=ScorerConfig(text_len=32),
                             bert_config=TINY_CONFIG, device="cpu") for _ in range(2)]
    for s in (*port, jax_scorer):
        s.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    return gen, port, jax_scorer


def _assert_leaves_equal(got, want, exact=True):
    from realtime_fraud_detection_tpu_torch.core.packing import tree_flatten

    la, ta = tree_flatten(got)
    lb = jax.tree_util.tree_leaves(want) if not exact else tree_flatten(want)[0]
    assert len(la) == len(lb)
    if exact:
        assert ta == tree_flatten(want)[1]
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.ndim and x.shape[-1] == len(FEATURE_NAMES) and not exact:
            assert_features_close(x, y)
        else:
            np.testing.assert_array_equal(x, y)


def test_assemble_serial_matches_assemble_and_jax_on_randomized_records():
    """``assemble`` == ``assemble_serial`` leaf for leaf on randomized
    record streams (holes, ghosts, repeated users), and ``assemble_serial``
    equals the JAX package's over the same stream."""
    gen, (col, ser), jax_scorer = _serial_pair()
    rng = np.random.default_rng(7)
    for it in range(5):
        records = _mutate(gen.generate_batch(int(rng.integers(1, 40))), rng)
        now = 1000.0 + it
        got = ser.assemble_serial(records, now=now)
        _assert_leaves_equal(col.assemble(records, now=now), got)
        _assert_leaves_equal(got, jax_scorer.assemble_serial(records, now=now),
                             exact=False)
        np.testing.assert_array_equal(ser.last_features, got.features)
        results = [{"transaction_id": r["transaction_id"], "fraud_score": 0.1,
                    "decision": "APPROVE", "risk_level": "LOW", "confidence": 0.9}
                   for r in records]
        for s in (col, ser, jax_scorer):
            s._write_back(records, results, now)


def test_assemble_serial_scores_and_profile_rewrites_match_assemble():
    """The same batch through both assembly paths gives identical responses,
    and a profile rewrite between batches is seen by both (the columnar
    path's join cache is invalidated)."""
    gen, (col, ser), _ = _serial_pair(seed=9)
    for step in range(2):
        records = gen.generate_batch(12)
        if step:
            uid = str(records[0]["user_id"])
            for s in (col, ser):
                s.profiles.put_user(uid, dict(s.profiles.get_user(uid) or {},
                                              risk_score=0.97))
        a = col.assemble(records, now=50.0 + step)
        b = ser.assemble_serial(records, now=50.0 + step)
        _assert_leaves_equal(a, b)
        ra = col.finalize(col.dispatch_assembled(a, records), now=50.0 + step)
        rb = ser.finalize(ser.dispatch_assembled(b, records), now=50.0 + step)
        for x, y in zip(ra, rb):
            assert (x["fraud_probability"], x["decision"], x["model_predictions"]) == \
                (y["fraud_probability"], y["decision"], y["model_predictions"])
    assert float(np.asarray(a.txn.user_risk_score)[0]) == pytest.approx(0.97)
