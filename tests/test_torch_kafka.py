"""The port's Kafka wire tier against the JAX package's, on the CPU.

- Golden frames: the Produce v2 body, the JoinGroup v1 body with its
  subscription and a whole RecordBatch v2, from the port's encoders, equal
  frames assembled by hand from the public protocol spec.
- Encodings: message sets, RecordBatch v2 (with and without gzip, with a
  producer id), CRC32C, the group subscription and assignment and the range
  assignor, byte-equal to JAX's on seeded inputs, and each package decodes
  the other's.
- Each package's client against the other package's fake (and the port's
  against its own): keyed order, batch produce, fetch, commit and replay,
  snapshot commits, lag, idempotent dedupe of a retried batch and the
  refusal of a sequence gap, a backlog larger than one fetch.
- Groups: two members split the partitions (one of them the other
  package's), a killed member loses no record, a zombie's commit is fenced;
  ``KafkaGroupConsumer`` has every consumer call the port's ``StreamJob``
  makes.
- ``StreamJob`` over each package's ``KafkaBroker`` and fake gives equal
  decisions off a rung and scores within the JAX kernel drill's bound.
- Two replicas in one group sharing one state server, at a toy size, in
  both packages: replica A dies after its first batch; each id is on the
  predictions topic, every repeat there is a cache re-emission, and each
  user's 24hour velocity count on the server equals the stream's.
"""

import torch_threads  # noqa: F401  (first: torch held to one CPU thread)
import re
import struct
import threading
import time
import zlib
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from realtime_fraud_detection_tpu.ensemble.combine import (
    EnsembleParams as JaxEnsembleParams,
)
from realtime_fraud_detection_tpu.scoring import FraudScorer
from realtime_fraud_detection_tpu.scoring import ScorerConfig as JaxScorerConfig
from realtime_fraud_detection_tpu.state import resp as jresp
from realtime_fraud_detection_tpu.state import shared as jshared
from realtime_fraud_detection_tpu.stream import JobConfig as JaxJobConfig
from realtime_fraud_detection_tpu.stream import StreamJob as JaxStreamJob
from realtime_fraud_detection_tpu.stream import kafka as jk
from realtime_fraud_detection_tpu.stream import kafka_fake as jkf
from realtime_fraud_detection_tpu.stream import kafka_group as jkg
from realtime_fraud_detection_tpu.utils.config import Config as JaxConfig
from realtime_fraud_detection_tpu_torch.bridge import models_from_numpy
from realtime_fraud_detection_tpu_torch.scoring.pipeline import MODEL_NAMES, ScorerConfig
from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
from realtime_fraud_detection_tpu_torch.state import resp as presp
from realtime_fraud_detection_tpu_torch.state import shared as pshared
from realtime_fraud_detection_tpu_torch.stream import KafkaBroker, KafkaTransport
from realtime_fraud_detection_tpu_torch.stream import kafka as pk
from realtime_fraud_detection_tpu_torch.stream import kafka_fake as pkf
from realtime_fraud_detection_tpu_torch.stream import kafka_group as pkg
from realtime_fraud_detection_tpu_torch.stream import topics as T
from realtime_fraud_detection_tpu_torch.stream.job import JobConfig, StreamJob
from realtime_fraud_detection_tpu_torch.stream.transport import Consumer
from test_torch_stream import _jax_models
from torch_bounds import near_rung, noise_bound

ROOT = Path(__file__).resolve().parents[1]
KAFKA = {"jax": jk, "port": pk}
FAKE = {"jax": jkf, "port": pkf}
GROUP = {"jax": jkg, "port": pkg}
RESP = {"jax": jresp, "port": presp}
SHARED = {"jax": jshared, "port": pshared}
PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port")]      # client, fake


def _fake(pkg_name):
    return FAKE[pkg_name].FakeKafkaServer(port=0).start()


def _broker(pkg_name, server, **kw):
    return KAFKA[pkg_name].KafkaBroker(bootstrap=f"127.0.0.1:{server.port}", **kw)


def _raw_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">h", len(b)) + b


def _raw_bytes(b: bytes) -> bytes:
    return struct.pack(">i", len(b)) + b


# ----------------------------------------------------------- golden frames
def test_golden_request_header_bytes():
    raw = pk.Writer().i16(3).i16(1).i32(42).string("cid").done()
    assert raw == struct.pack(">hhi", 3, 1, 42) + struct.pack(">h", 3) + b"cid"
    r = pk.Reader(raw)
    assert (r.i16(), r.i16(), r.i32(), r.string()) == (3, 1, 42, "cid")


def test_golden_produce_v2_request_bytes():
    record_set = pk.encode_message_set([(b"k", b"v", 1234)])
    body = struct.pack(">bbq", 1, 0, 1234) + _raw_bytes(b"k") + _raw_bytes(b"v")
    msg = struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF) + body
    expected_set = struct.pack(">qi", 0, len(msg)) + msg
    assert record_set == expected_set
    got = (pk.Writer().i16(-1).i32(30000)
           .array([None], lambda w, _: w.string("topic-a").array(
               [None], lambda w2, _2: w2.i32(3).bytes_(record_set)))
           .done())
    assert got == (struct.pack(">hi", -1, 30000) + struct.pack(">i", 1)
                   + _raw_str("topic-a") + struct.pack(">i", 1) + struct.pack(">i", 3)
                   + _raw_bytes(expected_set))


def test_golden_join_group_v1_request_bytes():
    meta = pkg.encode_subscription(["t-b", "t-a"])
    expected_meta = (struct.pack(">h", 0) + struct.pack(">i", 2) + _raw_str("t-a")
                     + _raw_str("t-b") + _raw_bytes(b""))
    assert meta == expected_meta
    got = (pk.Writer().string("grp").i32(10000).i32(10000).string("")
           .string("consumer")
           .array([("range", meta)], lambda w, p: w.string(p[0]).bytes_(p[1]))
           .done())
    assert got == (_raw_str("grp") + struct.pack(">ii", 10000, 10000) + _raw_str("")
                   + _raw_str("consumer") + struct.pack(">i", 1) + _raw_str("range")
                   + _raw_bytes(expected_meta))


def test_golden_record_batch_v2_full_bytes():
    got = pk.encode_record_batch([(b"K", b"VAL", 5000)], producer_id=77,
                                 producer_epoch=3, base_sequence=9)
    record_body = bytes([0, 0x00, 0x00, 0x02]) + b"K" + bytes([0x06]) + b"VAL" + bytes([0x00])
    record = bytes([len(record_body) << 1]) + record_body
    after_crc = struct.pack(">hiqqqhii", 0, 0, 5000, 5000, 77, 3, 9, 1) + record
    assert got == (struct.pack(">qi", 0, 4 + 1 + 4 + len(after_crc))
                   + struct.pack(">ibI", -1, 2, pk.crc32c(after_crc)) + after_crc)
    assert pk.crc32c(b"123456789") == 0xE3069283          # Castagnoli


# --------------------------------------------------------------- encodings
def _messages(seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        key = None if rng.random() < 0.2 else f"user_{rng.integers(1000)}".encode()
        value = None if rng.random() < 0.05 else (
            b'{"n":%d,"pad":"' % i + b"x" * int(rng.integers(0, 300)) + b'"}')
        out.append((key, value, 1_700_000_000_000 + int(rng.integers(0, 10_000))))
    out.sort(key=lambda m: m[2])
    return out


@pytest.mark.parametrize("case", ["message_set", "record_batch", "record_batch_gzip",
                                  "record_batch_idempotent"])
@pytest.mark.parametrize("seed", [0, 1])
def test_encodings_are_byte_equal_to_jax(case, seed):
    msgs = _messages(seed)
    if case == "message_set":
        got, want = pk.encode_message_set(msgs), jk.encode_message_set(msgs)
        assert got == want
        assert pk.decode_message_set(want) == jk.decode_message_set(got)
        return
    kw = {"compression": "gzip"} if case.endswith("gzip") else {}
    if case.endswith("idempotent"):
        kw = dict(producer_id=1000 + seed, producer_epoch=2, base_sequence=37)
    got, want = pk.encode_record_batch(msgs, **kw), jk.encode_record_batch(msgs, **kw)
    assert got == want
    assert pk.decode_record_batch(want) == jk.decode_record_batch(got)
    # a fetch of a raw v2 batch decodes alike in both packages
    assert pk.decode_message_set(got) == jk.decode_message_set(want)
    blob = np.random.default_rng(seed).bytes(4096)
    assert pk.crc32c(blob) == jk.crc32c(blob)


def test_group_protocol_encodings_equal_jax():
    subs = {f"consumer-{i}": [T.TRANSACTIONS, T.LABELS][: 1 + i % 2] for i in range(5)}
    counts = {T.TRANSACTIONS: 12, T.LABELS: 4}
    got, want = pkg.range_assign(subs, counts), jkg.range_assign(subs, counts)
    assert got == want
    for member, parts in want.items():
        assert pkg.encode_assignment(parts) == jkg.encode_assignment(parts)
        assert pkg.decode_assignment(jkg.encode_assignment(parts)) == parts
        assert pkg.encode_subscription(subs[member]) == jkg.encode_subscription(
            subs[member])
    assert sorted(p for parts in want.values() for p in parts.get(T.TRANSACTIONS, [])) \
        == list(range(12))


def test_transport_factory_and_config(caplog):
    from types import SimpleNamespace

    from realtime_fraud_detection_tpu_torch.serving.app import ServingApp
    from realtime_fraud_detection_tpu_torch.testing import ABTestManager, Variant
    from realtime_fraud_detection_tpu_torch.utils.config import Config

    server = _fake("port")
    try:
        broker = KafkaTransport(f"127.0.0.1:{server.port}", idempotent=True,
                                compression="gzip")
        assert isinstance(broker, KafkaBroker) and broker.compression == "gzip"
        broker.close()
    finally:
        server.stop()
    with pytest.raises(ValueError, match="compression requires"):
        KafkaBroker(bootstrap="127.0.0.1:1", compression="gzip")
    assert (Config().stream.alert_score_threshold
            == JaxConfig().stream.alert_score_threshold)
    # a JAX config file's stream block loads: the threshold is honoured, and
    # each transport field, which no code reads, warns instead of vanishing
    block = dict(vars(JaxConfig().stream), alert_score_threshold=0.25)
    with caplog.at_level("WARNING"):
        cfg = Config.from_dict({"stream": block})
    assert cfg.stream.alert_score_threshold == 0.25
    unread = sorted(k for k in block if k != "alert_score_threshold")
    assert sorted(re.findall(r"unknown key '(\w+)' on StreamConfig",
                             caplog.text)) == unread
    # the serving app's experiments flag a prediction above that threshold
    ab = ABTestManager()
    ab.create_experiment("t", [Variant("only", 1.0)])
    app = SimpleNamespace(config=cfg, ab=ab)
    txns = [{"user_id": "u1", "is_fraud": True}] * 2
    ServingApp._apply_experiments(app, txns, [{"fraud_score": 0.3},
                                              {"fraud_score": 0.2}])
    stats = ab.results("t")["variants"]["only"]
    assert stats["predictions"] == 2 and stats["recall"] == 0.5


# --------------------------------------------- each client, each fake
@pytest.mark.parametrize("client_pkg,fake_pkg", PAIRS,
                         ids=[f"{c}-client-{f}-fake" for c, f in PAIRS])
def test_produce_fetch_commit_and_lag_across_packages(client_pkg, fake_pkg):
    server = _fake(fake_pkg)
    b = _broker(client_pkg, server)
    try:
        for i in range(20):
            b.produce(T.TRANSACTIONS, {"n": i}, key="user_7")
        recs = b.consumer([T.TRANSACTIONS], "g1").poll(100)
        assert [r.value["n"] for r in recs] == list(range(20))
        assert len({r.partition for r in recs}) == 1
        # the partitioner is crc32(key), the in-memory broker's
        assert recs[0].partition == zlib.crc32(b"user_7") % b.partitions(T.TRANSACTIONS)
        n = b.produce_batch(T.TRANSACTIONS, [{"n": 100 + i} for i in range(24)],
                            key_fn=lambda v: str(v["n"] % 5))
        n += b.produce_batch_keyed(T.PREDICTIONS, [(f"u{i}", {"i": i}) for i in range(7)])
        assert n == 31
        assert sum(b.end_offsets(T.TRANSACTIONS)) == 44
        c = b.consumer([T.TRANSACTIONS], "g")
        assert len(c.poll(6)) == 6
        snap = c.snapshot_positions()
        assert len(c.poll(1000)) == 38
        c.commit(snap)
        assert b.lag("g", T.TRANSACTIONS) == 38
        c2 = b.consumer([T.TRANSACTIONS], "g")
        per_key = {}
        for r in c2.poll(1000):
            per_key.setdefault(r.key, []).append(r.value["n"])
        assert all(ns == sorted(ns) for ns in per_key.values())
        c2.commit()
        assert b.lag("g", T.TRANSACTIONS) == 0
        assert b.consumer([T.TRANSACTIONS], "g").poll(100) == []
        b.produce(T.TRANSACTIONS, {"désc": "caffè ☕", "amount": 12.5}, key="ü")
        rec = b.consumer([T.TRANSACTIONS], "g").poll(10)[0]
        assert rec.value == {"désc": "caffè ☕", "amount": 12.5} and rec.key == "ü"
        assert [r.value["i"] for r in b.consumer([T.PREDICTIONS], "p").poll(100)
                if r.key == "u3"] == [3]
    finally:
        b.close()
        server.stop()


@pytest.mark.parametrize("client_pkg,fake_pkg", PAIRS,
                         ids=[f"{c}-client-{f}-fake" for c, f in PAIRS])
def test_idempotent_dedupe_and_sequence_gap_across_packages(client_pkg, fake_pkg):
    k = KAFKA[client_pkg]
    server = _fake(fake_pkg)
    b = _broker(client_pkg, server, idempotent=True, compression="gzip")
    try:
        r1 = b.produce(T.TRANSACTIONS, {"n": 1}, key="k")
        replay = k.encode_record_batch([(b"k", b'{"n":1}', 1)], producer_id=b._pid,
                                       producer_epoch=b._pepoch, base_sequence=0)
        assert b._produce_request(T.TRANSACTIONS, r1.partition, replay,
                                  api_version=3) == r1.offset
        b.produce(T.TRANSACTIONS, {"n": 2}, key="k")
        recs = b.read(T.TRANSACTIONS, r1.partition, 0, 100)
        assert [r.value["n"] for r in recs] == [1, 2]
        gap = k.encode_record_batch([(b"k", b'{"n":9}', 1)], producer_id=b._pid,
                                    producer_epoch=b._pepoch, base_sequence=5)
        with pytest.raises(k.KafkaProtocolError, match="OUT_OF_ORDER"):
            b._produce_request(T.TRANSACTIONS, r1.partition, gap, api_version=3)
        # a gzip batch of many records lands whole and in order
        b.produce_batch(T.TRANSACTIONS, [{"n": 10 + i} for i in range(50)],
                        key_fn=lambda v: "k")
        assert [r.value["n"] for r in b.read(T.TRANSACTIONS, r1.partition, 0, 100)] == \
            [1, 2] + list(range(10, 60))
    finally:
        b.close()
        server.stop()


@pytest.mark.parametrize("client_pkg,fake_pkg", [("port", "port"), ("port", "jax")])
def test_fetch_large_backlog_across_polls(client_pkg, fake_pkg):
    server = _fake(fake_pkg)
    b = _broker(client_pkg, server)
    try:
        big = "x" * 64_000
        b.produce_batch(T.TRANSACTIONS, [{"n": i, "pad": big} for i in range(120)],
                        key_fn=lambda v: "one-key")
        c = b.consumer([T.TRANSACTIONS], "g-big")
        seen = []
        for _ in range(50):
            recs = c.poll(500)
            if not recs:
                break
            seen.extend(r.value["n"] for r in recs)
        assert seen == list(range(120))
    finally:
        b.close()
        server.stop()


# ------------------------------------------------------------------ groups
def _member(pkg_name, broker, group, session_ms=1000):
    return GROUP[pkg_name].KafkaGroupConsumer(broker, [T.TRANSACTIONS], group,
                                              session_timeout_ms=session_ms,
                                              heartbeat_interval_s=0.1)


def _join_second(first, pkg_name, broker, group, session_ms=1000):
    """The second member joins on a thread while the first keeps polling
    (its heartbeat inside poll sees the rebalance and it rejoins)."""
    made = {}
    t = threading.Thread(target=lambda: made.update(
        c=_member(pkg_name, broker, group, session_ms)))
    t.start()
    deadline = time.monotonic() + 8.0
    while "c" not in made and time.monotonic() < deadline:
        first.poll(0)
        time.sleep(0.05)
    t.join(timeout=8.0)
    return made["c"]


GROUP_CASES = [("port", "port", "port"), ("port", "jax", "jax"), ("jax", "port", "port")]


@pytest.mark.parametrize("first_pkg,second_pkg,fake_pkg", GROUP_CASES,
                         ids=[f"{a}-{b}-members-{f}-fake" for a, b, f in GROUP_CASES])
def test_group_members_split_the_partitions(first_pkg, second_pkg, fake_pkg):
    server = _fake(fake_pkg)
    b1, b2 = _broker(first_pkg, server), _broker(second_pkg, server)
    try:
        c1 = _member(first_pkg, b1, "g-split", 2000)
        n_parts = b1.partitions(T.TRANSACTIONS)
        assert sorted(c1.assigned_partitions()[T.TRANSACTIONS]) == list(range(n_parts))
        c2 = _join_second(c1, second_pkg, b2, "g-split", 2000)
        p1 = set(c1.assigned_partitions().get(T.TRANSACTIONS, []))
        p2 = set(c2.assigned_partitions().get(T.TRANSACTIONS, []))
        assert p1 and p2 and not p1 & p2 and p1 | p2 == set(range(n_parts))
        c2.close()
        deadline = time.monotonic() + 8.0
        while set(c1.assigned_partitions().get(T.TRANSACTIONS, [])) != \
                set(range(n_parts)) and time.monotonic() < deadline:
            c1.poll(10)
            time.sleep(0.05)
        assert set(c1.assigned_partitions()[T.TRANSACTIONS]) == set(range(n_parts))
        c1.close()
    finally:
        b1.close()
        b2.close()
        server.stop()


@pytest.mark.parametrize("first_pkg,second_pkg,fake_pkg", GROUP_CASES[:2],
                         ids=[f"{a}-{b}-members-{f}-fake" for a, b, f in GROUP_CASES[:2]])
def test_group_killed_member_loses_no_record(first_pkg, second_pkg, fake_pkg):
    server = _fake(fake_pkg)
    b1, b2, prod = (_broker(first_pkg, server), _broker(second_pkg, server),
                    _broker("port", server))
    try:
        prod.produce_batch(T.TRANSACTIONS, [{"n": i} for i in range(200)],
                           key_fn=lambda v: str(v["n"]))
        c1 = _member(first_pkg, b1, "g-kill")
        c2 = _join_second(c1, second_pkg, b2, "g-kill")
        seen_c1 = [r.value["n"] for r in c1.poll(40)]
        c1.commit()
        server.kill_member("g-kill", c1.membership.member_id)
        seen_c2 = []
        n_parts = b2.partitions(T.TRANSACTIONS)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            seen_c2.extend(r.value["n"] for r in c2.poll(100))
            c2.commit()
            if set(c2.assigned_partitions().get(T.TRANSACTIONS, [])) == \
                    set(range(n_parts)) and c2.lag() == 0:
                break
            time.sleep(0.05)
        assert set(seen_c1) | set(seen_c2) == set(range(200))
        assert not set(seen_c1) & set(seen_c2)
        assert c2.membership.rebalances >= 2
        c2.close()
    finally:
        for b in (b1, b2, prod):
            b.close()
        server.stop()


@pytest.mark.parametrize("fake_pkg", ["port", "jax"])
def test_group_zombie_commit_is_fenced(fake_pkg):
    server = _fake(fake_pkg)
    b1, prod = _broker("port", server), _broker("port", server)
    try:
        prod.produce_batch(T.TRANSACTIONS, [{"n": i} for i in range(20)],
                           key_fn=lambda v: str(v["n"]))
        c1 = _member("port", b1, "g-fence")
        c1.poll(20)
        positions = c1.snapshot_positions()
        server.kill_member("g-fence", c1.membership.member_id)
        c1.commit(positions)                      # fenced: swallowed, then rejoin
        assert all(b1.committed("g-fence", t, p) == 0 for (t, p) in positions)
        assert c1.membership.generation >= 0      # rejoined
        c1.close()
    finally:
        b1.close()
        prod.close()
        server.stop()


def test_group_consumer_has_every_call_the_stream_job_makes():
    stream = ROOT / "realtime_fraud_detection_tpu_torch" / "stream"
    # the job's own calls and its assembler's
    source = (stream / "job.py").read_text() + (stream / "microbatch.py").read_text()
    calls = set(re.findall(r"self\.consumer\.(\w+)", source))
    assert {"poll", "commit", "snapshot_positions", "lag"} <= calls
    calls |= {"positions"}                 # run-job's checkpoint reads it too
    for name in calls:
        assert callable(getattr(Consumer, name)), name
        assert callable(getattr(pkg.KafkaGroupConsumer, name)), name


# ------------------------------------------------------- the job over Kafka
def _job_over_kafka(package, models, records):
    server = FAKE[package].FakeKafkaServer(port=0).start()
    broker = KAFKA[package].KafkaBroker(bootstrap=f"127.0.0.1:{server.port}")
    tokens = []
    try:
        if package == "jax":
            gen = TransactionGenerator(num_users=30, num_merchants=12, seed=29)
            scorer = FraudScorer(models=models, scorer_config=JaxScorerConfig(text_len=32))
            job_cls, cfg = JaxStreamJob, JaxJobConfig(max_batch=16, max_delay_ms=1.0)
        else:
            gen = TransactionGenerator(num_users=30, num_merchants=12, seed=29)
            scorer = TorchFraudScorer(models=models_from_numpy(models),
                                      scorer_config=ScorerConfig(text_len=32), device="cpu")
            job_cls, cfg = StreamJob, JobConfig(max_batch=16, max_delay_ms=1.0)
        assemble = scorer.assemble

        def keep_tokens(*a, **k):
            batch = assemble(*a, **k)
            tokens.append((np.asarray(batch.token_ids), np.asarray(batch.token_mask)))
            return batch

        scorer.assemble = keep_tokens
        scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
        job = job_cls(broker, scorer, cfg)
        broker.produce_batch(T.TRANSACTIONS, records, key_fn=lambda r: str(r["user_id"]))
        assert job.run_until_drained(now=1000.0) == len(records)
        preds = [r.value for r in broker.consumer([T.PREDICTIONS], "check").poll(1000)]
        assert broker.lag(job.config.group_id, T.TRANSACTIONS) == 0
        return preds, dict(job.counters), tokens
    finally:
        broker.close()
        server.stop()


def test_stream_job_over_each_packages_kafka_gives_equal_decisions():
    models = _jax_models()
    records = TransactionGenerator(num_users=30, num_merchants=12,
                                   seed=29).generate_batch(48)
    preds, counters, _ = _job_over_kafka("port", models, records)
    jpreds, jcounters, tokens = _job_over_kafka("jax", models, records)
    assert counters == jcounters and counters["scored"] == 48
    assert [p["transaction_id"] for p in preds] == [q["transaction_id"] for q in jpreds]
    weights = JaxEnsembleParams.from_config(JaxConfig(), MODEL_NAMES).weights
    bound = noise_bound(models.bert, tokens, weights, np.ones(5, bool))
    prob = np.array([q["fraud_probability"] for q in jpreds])
    conf = np.array([q["confidence"] for q in jpreds])
    near = near_rung(prob, bound) | near_rung(conf, bound)
    assert int(near.sum()) == 0
    for p, q in zip(preds, jpreds):
        assert (p["decision"], p["risk_level"]) == (q["decision"], q["risk_level"])
    np.testing.assert_allclose([p["fraud_score"] for p in preds],
                               [q["fraud_score"] for q in jpreds], rtol=0, atol=bound)


# ------------------------------------------- two replicas, one state plane
class _GroupBroker:
    def __init__(self, broker, group_mod):
        self.broker, self.group_mod = broker, group_mod

    def __getattr__(self, name):
        return getattr(self.broker, name)

    def consumer(self, topics, group_id, faults=None):
        return self.group_mod.KafkaGroupConsumer(self.broker, list(topics), group_id,
                                                 session_timeout_ms=1000,
                                                 heartbeat_interval_s=0.1)


class _Died(Exception):
    pass


def _replica(package, rep, kafka_port, redis_port, models, done, kill_after):
    broker = KAFKA[package].KafkaBroker(bootstrap=f"127.0.0.1:{kafka_port}")
    client = RESP[package].RespClient(port=redis_port)
    job = None
    try:
        if package == "jax":
            scorer = FraudScorer(models=models, scorer_config=JaxScorerConfig(text_len=32),
                                 state_client=client)
            job = JaxStreamJob(_GroupBroker(broker, jkg), scorer,
                               JaxJobConfig(max_batch=16, max_delay_ms=1.0))
        else:
            scorer = TorchFraudScorer(models=models_from_numpy(models),
                                      scorer_config=ScorerConfig(text_len=32),
                                      device="cpu", state_client=client)
            job = StreamJob(_GroupBroker(broker, pkg), scorer,
                            JobConfig(max_batch=16, max_delay_ms=1.0))
        rep["job"], rep["cached"] = job, 0
        complete, emit = job.complete_batch, job._emit_cached_dups
        done_batches = [0]

        def complete_batch(ctx, *a, **k):
            if done_batches[0] == kill_after:
                raise _Died
            out = complete(ctx, *a, **k)
            done_batches[0] += 1
            return out

        def emit_cached(ctx):
            rep["cached"] += len(ctx.cached_dups)
            return emit(ctx)

        job.complete_batch, job._emit_cached_dups = complete_batch, emit_cached
        rep["ready"].set()
        while not done.is_set():
            job.run_until_drained(now=1000.0)
            time.sleep(0.02)
    except _Died:
        rep["died"] = True
        job.consumer._closed.set()          # no more heartbeats, no LeaveGroup
    except Exception as e:  # noqa: BLE001 - reported by the test thread
        rep["error"] = e
    finally:
        rep["ready"].set()
        if job is not None and "died" not in rep:
            job.consumer.close()
        broker.close()
        client.close()


@pytest.mark.parametrize("package", ["jax", "port"])
def test_two_replicas_share_one_state_plane_over_kafka(package):
    fake = FAKE[package].FakeKafkaServer(port=0).start()
    redis = RESP[package].MiniRedisServer().start()
    gen = TransactionGenerator(num_users=40, num_merchants=15, seed=23)
    records = gen.generate_batch(96)
    models = _jax_models()
    done = threading.Event()
    reps = {"A": {"ready": threading.Event()}, "B": {"ready": threading.Event()}}
    threads = []
    client = RESP[package].RespClient(port=redis.port)
    producer = KAFKA[package].KafkaBroker(bootstrap=f"127.0.0.1:{fake.port}",
                                          idempotent=True, compression="gzip")
    try:
        SHARED[package].SharedProfileStore(client).seed(gen.users.profiles(),
                                                        gen.merchants.profiles())
        producer.produce_batch(T.TRANSACTIONS, records, key_fn=lambda r: str(r["user_id"]))
        for name, kill in (("A", 1), ("B", None)):
            t = threading.Thread(target=_replica, args=(
                package, reps[name], fake.port, redis.port, models, done, kill))
            t.start()
            threads.append(t)
            assert reps[name]["ready"].wait(120) and "error" not in reps[name], reps[name]
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            assert not any("error" in r for r in reps.values()), reps
            if reps["A"].get("died") and producer.lag(
                    "fraud-detection-job", T.TRANSACTIONS) == 0:
                break
            time.sleep(0.05)
        done.set()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        preds = [r.value for r in producer.consumer([T.PREDICTIONS], "check").poll(1 << 20)]
        ids = Counter(p["transaction_id"] for p in preds)
        assert set(ids) == {r["transaction_id"] for r in records} and len(ids) == 96
        replays = sum(bool(p["explanation"].get("replayed_from_cache")) for p in preds)
        assert len(preds) - len(ids) == replays == reps["A"]["cached"] + reps["B"]["cached"]
        scored = Counter(p["transaction_id"] for p in preds
                         if not p["explanation"].get("replayed_from_cache"))
        assert set(scored.values()) == {1}
        for user, n in Counter(str(r["user_id"]) for r in records).items():
            assert int(client.hget(f"velocity:{user}:24hour", "count")) == n, user
        assert reps["A"]["died"]
    finally:
        done.set()
        for t in threads:
            t.join(timeout=60)
        client.close()
        producer.close()
        redis.stop()
        fake.stop()
