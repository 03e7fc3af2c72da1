"""The port's partition-parallel plane (``cluster/``), its scorer seam
(``TorchFraudScorer(stores=...)``) and the serving router against the JAX
package's, on the CPU.

- Placement: ``partition_for_key`` against the in-memory broker's and the
  Kafka client's partitioner and JAX's, over 10,000 keys; the ring's
  assignments, routes and moved partitions equal JAX's.
- State: ``PartitionState.digest`` equals JAX's on the same state (the same
  records through each package's ``ShardScorer``, graph and labelled
  buffer included), also after a pickle round trip; the stores' contract
  (ownership, ``PartitionNotOwned``, the history store's seams).
- ``shard-drill --fast``: the port's summary, verdict and digest equal
  JAX's.
- The scorer: ``stores=`` with ``state_client=`` refused as JAX refuses
  it; a scorer over a ``PartitionedStore`` equals an unsharded one bit for
  bit; a fleet of real ``TorchFraudScorer`` workers with a worker killed
  scores each id once, commits every offset and equals a single scorer
  that replays the fleet's batches (the fleet's cuts) within 1e-6, but for
  the rows a handoff's state replay reaches.
- Serving: the 421 and ``/cluster`` bodies equal JAX's app; the
  ``cluster_*`` and ``device_pool_*`` series; ``serve --device-pool``'s
  answers equal the unpooled service's.
- ``ClusterSettings`` validates like JAX's; the modules import with JAX
  blocked.
"""

import torch_threads  # first: torch held to one CPU thread
import dataclasses
import json
import logging
import pickle
import subprocess
import sys
import textwrap
import zlib
from pathlib import Path

import numpy as np
import pytest

from realtime_fraud_detection_tpu.cluster import drill as jdrill
from realtime_fraud_detection_tpu.cluster import hashring as jring
from realtime_fraud_detection_tpu.cluster import partition as jpartition
from realtime_fraud_detection_tpu.obs.metrics import MetricsCollector as JaxMetricsCollector
from realtime_fraud_detection_tpu.scoring import FraudScorer
from realtime_fraud_detection_tpu.serving import ServingApp as JaxServingApp
from realtime_fraud_detection_tpu.stream import InMemoryBroker as JaxInMemoryBroker
from realtime_fraud_detection_tpu.utils.config import ClusterSettings as JaxClusterSettings
from realtime_fraud_detection_tpu.utils.config import Config as JaxConfig
from realtime_fraud_detection_tpu_torch.__main__ import main as port_main
from realtime_fraud_detection_tpu_torch.cluster import drill as pdrill
from realtime_fraud_detection_tpu_torch.cluster import hashring as pring
from realtime_fraud_detection_tpu_torch.cluster import partition as ppartition
from realtime_fraud_detection_tpu_torch.obs.metrics import MetricsCollector
from realtime_fraud_detection_tpu_torch.scoring.pipeline import init_scoring_models
from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
from realtime_fraud_detection_tpu_torch.serving.app import ServingApp
from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
from realtime_fraud_detection_tpu_torch.state.history import UserHistoryStore
from realtime_fraud_detection_tpu_torch.state.resp import RespClient
from realtime_fraud_detection_tpu_torch.stream.kafka import KafkaBroker
from realtime_fraud_detection_tpu_torch.stream.transport import InMemoryBroker
from realtime_fraud_detection_tpu_torch.utils.config import ClusterSettings, Config
from test_torch_serving import _Served, _serving_config

ROOT = Path(__file__).resolve().parents[1]
NOW = 1000.0


# ------------------------------------------------------------- placement
def test_partition_for_key_matches_the_partitioners_and_jax():
    rng = np.random.default_rng(3)
    keys = [f"user_{int(i):07d}" for i in rng.integers(0, 10_000_000, 9_000)]
    keys += [str(rng.bytes(6).hex()) for _ in range(1_000)]
    broker = InMemoryBroker()
    kafka = KafkaBroker.__new__(KafkaBroker)           # no connection: the
    kafka._metadata = lambda topic: list(range(12))    # partitioner alone
    kafka._rr = {}
    for n in (1, 12, 64):
        got = [pring.partition_for_key(k, n) for k in keys]
        assert got == [jring.partition_for_key(k, n) for k in keys]
        assert got == [zlib.crc32(k.encode()) % n for k in keys]
    assert [pring.partition_for_key(k, 12) for k in keys] == \
        [broker.select_partition("payment-transactions", k) for k in keys]
    assert [pring.partition_for_key(k, 12) for k in keys] == \
        [kafka._pick_partition("payment-transactions", k) for k in keys]
    for mod in (pring, jring):
        with pytest.raises(ValueError):
            mod.partition_for_key("u", 0)


@pytest.mark.parametrize("vnodes", [1, 16, 256])
def test_ring_placement_routes_and_moves_equal_jax(vnodes):
    members = [f"w{i}" for i in range(6)]
    got, want = pring.HashRing(members, vnodes), jring.HashRing(members, vnodes)
    for n in (12, 64):
        assert got.assignment(n) == want.assignment(n)
    keys = [f"user_{i}" for i in range(2_000)]
    assert [got.route_key(k, 12) for k in keys] == [want.route_key(k, 12) for k in keys]
    pr = pring.ShardRouter(12, members[:4], virtual_nodes=vnodes,
                           addresses={m: f"http://{m}" for m in members})
    jr = jring.ShardRouter(12, members[:4], virtual_nodes=vnodes,
                           addresses={m: f"http://{m}" for m in members})
    for step in (members[:3], members[:5], ["w1", "w4"], members):
        assert pr.set_membership(step, keys_per_partition=2.5) == \
            jr.set_membership(step, keys_per_partition=2.5)
        assert [pr.route(k) for k in keys[:300]] == [jr.route(k) for k in keys[:300]]
    assert pr.snapshot() == jr.snapshot()
    assert pr.address_of("w4") == "http://w4" and pr.partition_of("u9") == \
        jr.partition_of("u9")


# ------------------------------------------------------------------ state
def _fill(mod_partition, mod_drill, records):
    """A full-ownership PartitionedStore of one package, driven through that
    package's ShardScorer, plus graph links and labelled rows."""
    store = mod_partition.PartitionedStore(12, seq_len=4, feature_dim=4)
    for p in range(12):
        store.acquire(p)
    scorer = mod_drill.ShardScorer(store)
    scorer.finalize(scorer.dispatch(records[:200]))
    scorer.replay_state(records[200:])
    store.graph.add_batch([r["user_id"] for r in records],
                          [r["merchant_id"] for r in records],
                          [str(r.get("device_id", "")) for r in records],
                          [str(r.get("ip_address", "")) for r in records])
    for i, r in enumerate(records[:40]):
        store.state_for_user(r["user_id"]).labeled.append(
            np.full(4, i, np.float32), bool(i % 3 == 0), 0.1 * (i % 10), float(i))
    return store


def test_partition_digests_equal_jax_on_the_same_state():
    gen = TransactionGenerator(num_users=300, num_merchants=40, seed=5)
    records = gen.generate_batch(320)
    for i, r in enumerate(records):
        r["event_ts"] = round(i * 0.001, 9)
    got = _fill(ppartition, pdrill, records)
    want = _fill(jpartition, jdrill, records)
    assert got.digests(now=NOW) == want.digests(now=NOW)
    assert len(set(got.digests(now=NOW).values())) == 12
    assert got.stats() == want.stats()
    for p in (0, 7):
        blob = got.state(p).snapshot_bytes()
        restored = ppartition.PartitionState.restore_bytes(blob)
        assert restored.digest(NOW) == got.state(p).digest(NOW)
        assert restored.digest(NOW) == want.state(p).digest(NOW)
    with pytest.raises(ValueError, match="not PartitionState"):
        ppartition.PartitionState.restore_bytes(pickle.dumps({"x": 1}))


def test_partitioned_store_ownership_contract():
    store = ppartition.PartitionedStore(12)
    uid = "user_42"
    p = store.partition_for(uid)
    with pytest.raises(ppartition.PartitionNotOwned):
        store.profiles.put_user(uid, {"a": 1})
    with pytest.raises(ppartition.PartitionNotOwned):
        store.txn_cache.store_features("t0", {"f": 1})
    store.acquire(p)
    with pytest.raises(ValueError, match="already owned"):
        store.acquire(p)
    with pytest.raises(ValueError, match="outside"):
        store.acquire(12)
    epoch = store.ownership_epoch
    store.profiles.put_user(uid, {"a": 1})
    store.txn_cache.store_features("t0", {"f": 1})         # unknown txn: owned slot
    assert store.txn_cache.get_features("t0") == {"f": 1}
    assert store.profiles.get_user(uid) == {"a": 1}
    gen_before = store.profiles.generation
    store.profiles.seed(merchants={"m1": {"risk_level": "low"}})
    assert store.profiles.generation > gen_before
    state = store.release(p)
    assert store.ownership_epoch == epoch + 1 and state.profiles.get_user(uid) == {"a": 1}
    assert store.owned() == []


def test_history_store_seams_equal_jax():
    from realtime_fraud_detection_tpu.state.history import UserHistoryStore as JaxHistory

    rng = np.random.default_rng(1)
    uids = [f"u{int(i)}" for i in rng.integers(0, 30, 200)]
    feats = rng.normal(size=(200, 6)).astype(np.float32)
    got, want = UserHistoryStore(5, 6), JaxHistory(5, 6)
    for lo in range(0, 200, 50):
        got.append_batch(uids[lo:lo + 50], feats[lo:lo + 50])
        want.append_batch(uids[lo:lo + 50], feats[lo:lo + 50])
    query = sorted(set(uids)) + ["never"]
    for a, b in zip(got.gather(query), want.gather(query)):
        np.testing.assert_array_equal(a, b)
    assert got.user_ids() == want.user_ids()
    restored = pickle.loads(pickle.dumps(got))
    assert restored._table.shape[0] == len(got.user_ids())     # trimmed
    restored.append_batch(["new"] * 3, feats[:3])
    for a, b in zip(restored.gather(query), got.gather(query)):
        np.testing.assert_array_equal(a, b)


def test_consumer_set_assignment_equals_jax():
    out = []
    for broker in (InMemoryBroker(), JaxInMemoryBroker()):
        broker.create_topic("t", 4)
        for i in range(40):
            broker.produce("t", {"i": i}, key=f"k{i}")
        c = broker.consumer(["t"], "g", partitions={"t": [0, 1]})
        first = [(r.partition, r.offset) for r in c.poll(6)]
        broker.commit("g", {("t", 2): 3})
        c.set_assignment({"t": [1, 2]})
        out.append((first, c.assigned_partitions(), sorted(c._position.items()),
                    [(r.partition, r.offset) for r in c.poll(100)], c.lag()))
    assert out[0] == out[1]


# ------------------------------------------------------------- the drill
def test_shard_drill_summary_and_digest_equal_jax(capsys):
    assert port_main(["shard-drill", "--fast"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    got, compact = json.loads(lines[-2]), json.loads(lines[-1])
    want = jdrill.run_shard_drill(jdrill.ShardDrillConfig.fast())
    assert got == json.loads(json.dumps(want))
    assert compact == jdrill.compact_shard_summary(want)
    assert got["passed"] is True and got["replay_identical"] is True
    assert len(lines[-1].encode()) < 2048
    # the fleet snapshot mirrors into the same cluster_* series
    port, ref = MetricsCollector(), JaxMetricsCollector()
    port.sync_cluster(got["fleet"])
    ref.sync_cluster(want["fleet"])

    def lines_of(text):
        return [ln for ln in text.splitlines() if "cluster_" in ln]

    assert lines_of(port.render_prometheus()) == lines_of(ref.render_prometheus())
    assert "cluster_handoff_total 4" in port.render_prometheus()


def test_shard_drill_smaller_fleet_without_replay(capsys):
    assert port_main(["shard-drill", "--fast", "--workers", "3", "--no-replay",
                      "--seed", "11"]) == 1           # workers_enough needs 4
    compact = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg = dataclasses.replace(jdrill.ShardDrillConfig.fast(), n_workers=3, seed=11,
                              replay_check=False)
    assert compact == jdrill.compact_shard_summary(jdrill.run_shard_drill(cfg))
    assert compact["checks"]["workers_enough"] is False
    assert compact["checks"]["zero_lost"] and "replay_bit_identical" not in compact["checks"]


# ------------------------------------------------------------- the scorer
def test_stores_with_state_client_refused_like_jax():
    store = ppartition.PartitionedStore(12)
    client = RespClient.__new__(RespClient)
    with pytest.raises(ValueError) as got:
        TorchFraudScorer(device="cpu", stores=store, state_client=client)
    with pytest.raises(ValueError) as want:
        FraudScorer(stores=jpartition.PartitionedStore(12), state_client=object())
    assert str(got.value) == str(want.value)


def test_stores_with_other_history_widths_refused():
    with pytest.raises(ValueError, match=r"\(4, 4\), scorer expects \(10, 64\)"):
        TorchFraudScorer(device="cpu",
                         stores=ppartition.PartitionedStore(12, seq_len=4, feature_dim=4))


def test_scorer_over_partitioned_store_equals_unsharded():
    gen = TransactionGenerator(num_users=200, num_merchants=50, seed=9)
    profiles = (gen.users.profiles(), gen.merchants.profiles())
    batches = [gen.generate_batch(32) for _ in range(4)]
    models = init_scoring_models(4)
    store = ppartition.PartitionedStore(12)
    for p in range(12):
        store.acquire(p)
    sharded = TorchFraudScorer(models=models, device="cpu", stores=store)
    plain = TorchFraudScorer(models=models, device="cpu")
    out = []
    for s in (sharded, plain):
        s.seed_profiles(*profiles)
        out.append([s.score_batch(b, now=NOW + i) for i, b in enumerate(batches)])
    strip = lambda r: {k: v for k, v in r.items() if k != "processing_time_ms"}  # noqa: E731
    assert [[strip(r) for r in b] for b in out[0]] == [[strip(r) for r in b] for b in out[1]]
    assert sharded.velocity.get_all(batches[0][0]["user_id"]) == \
        plain.velocity.get_all(batches[0][0]["user_id"])
    assert len(store.history) == len(plain.history)


def test_real_scorer_fleet_equals_the_cut_replay_oracle():
    """Four ``TorchFraudScorer`` workers over their ``PartitionedStore``s,
    one killed at 45% of the stream: each id scored once, offsets gap free,
    affinity clean, and every score equal to one unsharded scorer replaying
    the fleet's batches in the fleet's order (the dead worker's lost batch
    left out), but for the rows of a replayed user after the kill: the
    handoff's state replay re-assembles the committed gap in one batch, so
    its history rows carry that moment's velocity (both packages). The GNN
    branch is off in the blend: the bipartite graph is scorer-local in both
    packages, so a worker's GNN sees only its own users' edges."""
    cfg = dataclasses.replace(pdrill.ShardDrillConfig(), num_users=10_000,
                              num_merchants=5_000, n_txns=1_024, batch=64,
                              replay_check=False)
    sched = pdrill.build_schedule(cfg)
    gen = TransactionGenerator(num_users=cfg.num_users, num_merchants=cfg.num_merchants,
                               seed=cfg.seed)
    profiles = (gen.users.profiles(), gen.merchants.profiles())
    models = init_scoring_models(0)
    config = Config()
    config.disable_model("graph_neural")
    log, replayed = [], set()

    def factory(worker_id, store):
        s = TorchFraudScorer(config, models=models, device="cpu", stores=store)
        dispatch, finalize = s.dispatch, s.finalize

        def logged_dispatch(records, now=None, trace=None):
            pending = dispatch(records, now=now, trace=trace)
            log.append(("dispatch", id(pending), list(records), now))
            return pending

        def logged_finalize(pending, now=None, lock=None):
            log.append(("finalize", id(pending), None, now))
            return finalize(pending, now=now, lock=lock)

        replay = s.replay_state

        def logged_replay(records, now=None):
            replayed.update(str(r["user_id"]) for r in records)
            log.append(("replay", None, None, now))
            return replay(records, now=now)

        s.dispatch, s.finalize, s.replay_state = (logged_dispatch, logged_finalize,
                                                  logged_replay)
        return s

    out = pdrill.run_fleet(cfg, sched, 4, kill=True, scorer_factory=factory,
                           store_kwargs={"seq_len": 10, "feature_dim": 64},
                           profiles=profiles)
    scored = [p for p in out["preds"] if p[3] == "scored"]
    assert sorted(p[0] for p in scored) == sorted(t["transaction_id"] for _, t in sched)
    assert out["committed"] == out["tx_ends"] and out["affinity_violations"] == 0
    assert out["fleet"]["kills"] == 1 and out["fleet"]["replayed_total"] > 0
    done = {key for kind, key, _, _ in log if kind == "finalize"}
    oracle = TorchFraudScorer(config, models=models, device="cpu")
    oracle.seed_profiles(*profiles)
    pending, want = {}, {}
    for kind, key, records, now in log:
        if kind == "dispatch" and key in done:
            pending[key] = oracle.dispatch(records, now=now)
        elif kind == "finalize":
            for r in oracle.finalize(pending.pop(key), now=now):
                want[r["transaction_id"]] = r
    assert len(done) < sum(1 for kind, *_ in log if kind == "dispatch")   # a lost batch
    first_replay = next(i for i, e in enumerate(log) if e[0] == "replay")
    reached = {r["transaction_id"] for kind, _, records, _ in log[first_replay:]
               if kind == "dispatch" for r in records if r["user_id"] in replayed}
    assert replayed and reached
    for tid, score, decision, _ in scored:
        if tid not in reached:
            assert decision == want[tid]["decision"]
            assert abs(score - want[tid]["fraud_score"]) <= 1e-6


# --------------------------------------------------------------- serving
CLUSTER = {"enabled": True, "worker_id": "w0", "n_partitions": 12, "virtual_nodes": 64,
           "workers": {"w0": "http://10.0.0.1:8080", "w1": "http://10.0.0.2:8080"}}


def _cluster_config(cls):
    config = _serving_config(cls)
    for k, v in CLUSTER.items():
        setattr(config.cluster, k, v)
    return config


def test_router_421_and_cluster_bodies_equal_jax():
    ring = pring.ShardRouter(12, ["w0", "w1"], virtual_nodes=64)
    users = [f"user_{i:06d}" for i in range(40)]
    foreign = [u for u in users if ring.route(u) == "w1"][:3]
    owned = next(u for u in users if ring.route(u) == "w0")
    gen = TransactionGenerator(num_users=50, num_merchants=20, seed=13)
    carrier = {"v": 1, "tid": "t-1", "sp": "s", "org": "ingress", "ts": 5.0, "pr": "high",
               "flt": "", "rh": 1, "rs": 0.25}
    bodies = {}
    for name, app in (
            ("jax", JaxServingApp(_cluster_config(JaxConfig), scorer=FraudScorer(),
                                  host="127.0.0.1", port=0)),
            ("port", ServingApp(_cluster_config(Config), host="127.0.0.1", port=0,
                                device="cpu"))):
        served = _Served(app)
        try:
            got = []
            for i, uid in enumerate(foreign):
                txn = dict(gen.generate_batch(1)[0], user_id=uid)
                if i == 0:
                    txn["trace_carrier"] = carrier
                got.append(served.request("POST", "/predict", txn))
            got.append(served.request("GET", "/cluster"))
            bodies[name] = got
            if name == "port":
                status, res = served.request(
                    "POST", "/predict", dict(gen.generate_batch(1)[0], user_id=owned))
                assert status == 200 and res["decision"]
                _, text = served.request("GET", "/metrics/prometheus")
                assert "cluster_workers_alive 2" in text
                assert 'cluster_partitions_owned{worker="w1"}' in text
        finally:
            served.close()
    assert bodies["port"] == bodies["jax"]
    status, body = bodies["port"][0]
    assert status == 421 and body["owner"] == "w1"
    assert body["location"] == "http://10.0.0.2:8080" and body["trace_carrier"]["rh"] == 2
    assert bodies["port"][-1][1]["worker_id"] == "w0"


def test_serving_device_pool_answers_like_the_unpooled_service():
    gen = TransactionGenerator(num_users=80, num_merchants=20, seed=23)
    profiles = (gen.users.profiles(), gen.merchants.profiles())
    body = gen.generate_batch(24)
    models = init_scoring_models(2)
    out = {}
    for pooled in (False, True):
        config = _serving_config(Config)
        config.tracing.enabled = False
        config.serving.device_pool = pooled
        scorer = TorchFraudScorer(config, models=models, device="cpu")
        scorer.seed_profiles(*profiles)
        app = ServingApp(config, scorer=scorer, host="127.0.0.1", port=0, device="cpu")
        assert (app.pool is not None) == pooled
        served = _Served(app)
        try:
            status, data = served.request("POST", "/batch-predict", body)
            assert status == 200
            out[pooled] = [{k: v for k, v in r.items() if k != "processing_time_ms"}
                           for r in data["results"]]
            if pooled:
                assert app.batcher.pipeline_depth == app.pool.total_slots() == 2
                _, metrics = served.request("GET", "/metrics")
                assert metrics["device_pool"]["completed"] == 1
                _, text = served.request("GET", "/metrics/prometheus")
                assert 'device_pool_dispatched_total{device="cpu#0"} 1' in text
                assert "device_pool_healthy_replicas 1" in text
        finally:
            served.close()
    assert out[True] == out[False]


# ---------------------------------------------------------------- config
@pytest.mark.parametrize("bad", [
    {"n_partitions": 0}, {"virtual_nodes": 0}, {"checkpoint_every": 0},
    {"enabled": True}, {"enabled": True, "workers": {"a": "u"}, "worker_id": "b"},
    {"min_workers": 0}, {"min_workers": 5, "max_workers": 4},
    {"per_worker_tps": 0.0}, {"autoscale_headroom": 0.9},
    {"autoscale_lead_s": -1.0}, {"autoscale_interval_s": 0.0},
    {"autoscale_down_patience": 0},
])
def test_cluster_settings_validate_like_jax(bad):
    with pytest.raises(ValueError) as got:
        ClusterSettings(**bad).validate()
    with pytest.raises(ValueError) as want:
        JaxClusterSettings(**bad).validate()
    assert str(got.value) == str(want.value)


def test_cluster_block_loads_and_autoscale_keys_warn(caplog):
    """The autoscale fields are ported: a config that sets them loads them
    with no unknown-key warning, and the block's fields are JAX's."""
    block = dict(CLUSTER, max_workers=6, min_workers=2, per_worker_tps=150.0,
                 autoscale_lead_s=1.5)
    with caplog.at_level(logging.WARNING):
        config = Config.from_dict({"cluster": block})
    assert config.cluster.workers == CLUSTER["workers"] and config.cluster.enabled
    assert not any("max_workers" in rec.getMessage() for rec in caplog.records)
    want = JaxConfig.from_dict({"cluster": block}).cluster
    assert dataclasses.asdict(config.cluster) == dataclasses.asdict(want)
    fields = {f.name for f in dataclasses.fields(ClusterSettings)}
    assert fields == {f.name for f in dataclasses.fields(JaxClusterSettings)}


# ------------------------------------------------------------ JAX blocked
def test_cluster_modules_import_with_jax_blocked():
    script = textwrap.dedent("""
        import dataclasses, sys
        for name in ("jax", "jaxlib", "flax", "ml_dtypes",
                     "realtime_fraud_detection_tpu"):
            sys.modules[name] = None
        from realtime_fraud_detection_tpu_torch.cluster import (
            HashRing, PartitionedStore, ShardRouter, WorkerFleet, partition_for_key)
        from realtime_fraud_detection_tpu_torch.cluster.drill import (
            ShardDrillConfig, run_shard_drill)
        from realtime_fraud_detection_tpu_torch.chaos import WorkerKill
        from realtime_fraud_detection_tpu_torch.serving.app import ServingApp
        from realtime_fraud_detection_tpu_torch.utils.config import Config
        cfg = dataclasses.replace(ShardDrillConfig.fast(), n_txns=1024,
                                  num_users=2000, replay_check=False)
        summary = run_shard_drill(cfg)
        assert summary["passed"], summary["checks"]
        assert HashRing(["a", "b"]).route_key("u", 12) in ("a", "b")
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=torch_threads.spawn_env())
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
