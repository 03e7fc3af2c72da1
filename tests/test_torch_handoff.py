"""The port's process fleet against the JAX package: the network handoff
store, the autoscale controller, the ``autoscale_*`` / ``handoff_server_*``
mirrors, the shard ingress client, ``ClusterWorker.abandon``, the cadence
snapshot with a batch in flight, a scripted ``ProcessFleet`` and the
elastic drill.

- Handoff: a round trip across a server restart, a torn blob served from
  the previous checkpoint, a zombie fenced by epoch and a restart mid-
  restore retried; both packages' clients against both packages' servers
  (one wire); a ``PartitionedStore`` snapshot through the store restores
  to the JAX store's digest on the same records.
- Autoscale: the decision ledger equal to JAX's on the same arrivals,
  ahead of the ramp and drained after it, the down-patience hysteresis;
  ``sync_autoscale`` renders JAX's series.
- The ingress client: its 421 cases, and two live clustered apps.
- The cadence snapshot: a checkpoint taken while a batch is in flight
  already holds that batch's history rows (a real scorer appends them at
  assembly), so an inheritor that rescores the uncommitted batch appends
  them again; both packages show the same rows.
- A fleet of two worker processes, one drained by SIGTERM and one killed
  by SIGKILL: the survivor's state digests equal the oracle's.
- The elastic oracle's schedule and digests equal JAX's; ``elastic-drill
  --fast`` passes as a command, ``processes_enough`` and ``sigkill_real``
  among its checks.
"""

import torch_threads  # first: torch held to one CPU thread
import dataclasses
import glob
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from realtime_fraud_detection_tpu.cluster import autoscale as jautoscale
from realtime_fraud_detection_tpu.cluster import elastic_drill as jelastic
from realtime_fraud_detection_tpu.cluster import fleet as jfleet
from realtime_fraud_detection_tpu.cluster import handoff as jhandoff
from realtime_fraud_detection_tpu.cluster import partition as jpartition
from realtime_fraud_detection_tpu.cluster.drill import ShardScorer as JaxShardScorer
from realtime_fraud_detection_tpu.obs.metrics import MetricsCollector as JaxMetricsCollector
from realtime_fraud_detection_tpu.scoring import FraudScorer
from realtime_fraud_detection_tpu.sim.arrivals import DiurnalBurstConfig as JaxBurstConfig
from realtime_fraud_detection_tpu.sim.arrivals import DiurnalBurstProcess as JaxBurstProcess
from realtime_fraud_detection_tpu.stream import InMemoryBroker as JaxInMemoryBroker
from realtime_fraud_detection_tpu.tuning.forecast import ArrivalForecaster as JaxForecaster
from realtime_fraud_detection_tpu_torch.bridge import models_from_numpy
from realtime_fraud_detection_tpu_torch.cluster import elastic_drill as pelastic
from realtime_fraud_detection_tpu_torch.cluster import fleet as pfleet
from realtime_fraud_detection_tpu_torch.cluster import partition as ppartition
from realtime_fraud_detection_tpu_torch.cluster.autoscale import AutoscaleController
from realtime_fraud_detection_tpu_torch.cluster.drill import ShardScorer
from realtime_fraud_detection_tpu_torch.cluster.handoff import HandoffClient, HandoffServer
from realtime_fraud_detection_tpu_torch.cluster.hashring import ShardRouter, partition_for_key
from realtime_fraud_detection_tpu_torch.cluster.procfleet import DIGEST_NOW, ProcessFleet
from realtime_fraud_detection_tpu_torch.obs.metrics import MetricsCollector
from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
from realtime_fraud_detection_tpu_torch.serving.app import ServingApp
from realtime_fraud_detection_tpu_torch.serving.ingress_client import (
    NoShardAvailableError,
    ShardIngressClient,
)
from realtime_fraud_detection_tpu_torch.sim.arrivals import (
    DiurnalBurstConfig,
    DiurnalBurstProcess,
)
from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
from realtime_fraud_detection_tpu_torch.stream import topics as T
from realtime_fraud_detection_tpu_torch.stream.netbroker import BrokerServer
from realtime_fraud_detection_tpu_torch.stream.transport import InMemoryBroker
from realtime_fraud_detection_tpu_torch.tuning.forecast import ArrivalForecaster
from realtime_fraud_detection_tpu_torch.utils.config import Config
from test_torch_serving import _Served, _jax_models, _serving_config

ROOT = Path(__file__).resolve().parents[1]


# ------------------------------------------------------------------ handoff
def test_handoff_roundtrip_and_server_restart_scan(tmp_path):
    """Blobs survive a server restart: the committed files are rescanned
    and served, sha-verified."""
    blob_dir = str(tmp_path / "blobs")
    srv = HandoffServer(blob_dir=blob_dir).start()
    port = srv.port
    cli = HandoffClient(port=port)
    cli.epoch = 1
    cli.put(3, 120, b"state-blob-a")
    cli.put(3, 150, b"state-blob-b")
    assert cli.get(3) == (150, b"state-blob-b")
    assert cli.offsets() == {3: 150}
    cli.close()
    srv.stop()
    srv2 = HandoffServer(port=port, blob_dir=blob_dir).start()
    try:
        cli2 = HandoffClient(port=port)
        assert cli2.get(3) == (150, b"state-blob-b")
        assert cli2.stats()["restores_total"] == 1
        cli2.close()
    finally:
        srv2.stop()


def test_handoff_torn_blob_served_from_the_previous_checkpoint(tmp_path):
    blob_dir = str(tmp_path / "blobs")
    srv = HandoffServer(blob_dir=blob_dir).start()
    try:
        cli = HandoffClient(port=srv.port)
        cli.put(0, 100, b"good-old-checkpoint")
        cli.put(0, 200, b"torn-new-checkpoint")
        newest = sorted(glob.glob(os.path.join(blob_dir, "p0-*.blob")),
                        key=lambda p: int(os.path.basename(p).split("-")[1]))[-1]
        assert "200" in os.path.basename(newest)
        with open(newest, "r+b") as f:
            f.truncate(70)                 # the sha header and a few bytes
        with srv._lock:                    # the disk path, as after a restart
            srv._ledger[0] = [(off, ep, sha, None, path)
                              for off, ep, sha, _, path in srv._ledger[0]]
        assert cli.get(0) == (100, b"good-old-checkpoint")
        stats = cli.stats()
        assert stats["torn_blobs_total"] == 1 and stats["restores_total"] == 1
        cli.close()
    finally:
        srv.stop()


def test_handoff_zombie_writer_fenced_by_epoch(tmp_path):
    srv = HandoffServer(blob_dir=str(tmp_path / "b")).start()
    try:
        cli = HandoffClient(port=srv.port)
        cli.epoch = 3
        cli.put(5, 10, b"gen3")
        cli.fence(5, 4)
        with pytest.raises(RuntimeError, match="FencedEpochError"):
            cli.put(5, 12, b"zombie-gen3")
        assert cli.stats()["fenced_rejects_total"] == 1
        cli.epoch = 4
        cli.put(5, 15, b"gen4")
        assert cli.get(5) == (15, b"gen4")
        cli.close()
    finally:
        srv.stop()


def test_handoff_restart_mid_restore_retried_with_backoff(tmp_path):
    blob_dir = str(tmp_path / "blobs")
    srv = HandoffServer(blob_dir=blob_dir).start()
    port = srv.port
    slept = []

    def _sleep(d):
        slept.append(d)
        time.sleep(min(d, 0.05))

    cli = HandoffClient(port=port, retry_sleep=_sleep)
    cli.put(7, 42, b"before-restart")
    srv.stop()
    restarted = []

    def _restart():
        time.sleep(0.15)
        restarted.append(HandoffServer(port=port, blob_dir=blob_dir).start())

    t = threading.Thread(target=_restart, daemon=True)
    t.start()
    try:
        assert cli.get(7) == (42, b"before-restart")
        assert slept, "reconnect goes through the backoff seam"
    finally:
        t.join()
        cli.close()
        for s in restarted:
            s.stop()


@pytest.mark.parametrize("server_pkg,client_pkg", [("port", "jax"), ("jax", "port")])
def test_handoff_wire_is_the_jax_wire(tmp_path, server_pkg, client_pkg):
    """Either package's client against either package's server: puts,
    fences, refusals and stats alike."""
    servers = {"port": HandoffServer, "jax": jhandoff.HandoffServer}
    clients = {"port": HandoffClient, "jax": jhandoff.HandoffClient}
    srv = servers[server_pkg](blob_dir=str(tmp_path / "b")).start()
    try:
        cli = clients[client_pkg](port=srv.port)
        cli.epoch = 2
        cli.put(1, 10, b"a")
        cli.put(1, 20, b"b")
        cli.fence(1, 3)
        with pytest.raises(RuntimeError, match="FencedEpochError"):
            cli.put(1, 30, b"zombie")
        assert cli.get(1) == (20, b"b") and cli.offsets() == {1: 20}
        stats = cli.stats()
        assert (stats["checkpoints_total"], stats["fenced_rejects_total"]) == (2, 1)
        cli.close()
    finally:
        srv.stop()


def _shard_records(n=240, users=30, seed=5):
    rng = np.random.default_rng(seed)
    return [{"transaction_id": f"tx{i}", "user_id": f"user_{int(rng.integers(users))}",
             "merchant_id": f"m_{int(rng.integers(9))}",
             "amount": float(np.round(rng.lognormal(3.0, 0.8), 2)),
             "payment_method": "card", "event_ts": 0.01 * i} for i in range(n)]


def test_handoff_restore_digest_equals_jax(tmp_path):
    """The same records through both packages' shard scorers: the port's
    partition snapshots, put through the network store and restored into a
    fresh store, digest as the JAX store does."""
    records = _shard_records()
    stores = {}
    for name, store_cls, scorer_cls in (
            ("jax", jpartition.PartitionedStore, JaxShardScorer),
            ("port", ppartition.PartitionedStore, ShardScorer)):
        store = store_cls(12, seq_len=4, feature_dim=4,
                          cache_kwargs={"txn_ttl_s": 1e12, "features_ttl_s": 1e12})
        for p in range(12):
            store.acquire(p)
        scorer = scorer_cls(store)
        for txn in records:
            scorer._score_and_update(dict(txn))
        stores[name] = store
    srv = HandoffServer(blob_dir=str(tmp_path / "b")).start()
    try:
        cli = HandoffClient(port=srv.port)
        for p in range(12):
            cli.put(p, 100 + p, stores["port"].state(p).snapshot_bytes())
        restored = ppartition.PartitionedStore(12, seq_len=4, feature_dim=4)
        for p in range(12):
            off, blob = cli.get(p)
            assert off == 100 + p
            restored.acquire(p, ppartition.PartitionState.restore_bytes(blob))
        cli.close()
    finally:
        srv.stop()
    want = stores["jax"].digests(now=DIGEST_NOW)
    assert restored.digests(now=DIGEST_NOW) == want
    assert stores["port"].digests(now=DIGEST_NOW) == want


# ---------------------------------------------------------------- autoscale
def _ramp(pkg, seed=7):
    cfg_cls, proc_cls = ((JaxBurstConfig, JaxBurstProcess) if pkg == "jax"
                         else (DiurnalBurstConfig, DiurnalBurstProcess))
    proc = proc_cls(cfg_cls(trough_tps=100.0, peak_tps=700.0, period_s=12.0,
                            burst_duration_s=0.0), seed=seed)
    return proc, proc.generate(12.0)


def _controller(pkg):
    cls, fc = ((jautoscale.AutoscaleController, JaxForecaster) if pkg == "jax"
               else (AutoscaleController, ArrivalForecaster))
    return cls(per_worker_tps=110.0, min_workers=4, max_workers=8, headroom=1.25,
               lead_s=1.5, decide_interval_s=0.5, down_patience=3,
               forecaster=fc(bucket_s=0.25))


def test_autoscale_validation_like_jax():
    for kw in ({"per_worker_tps": 0.0},
               {"per_worker_tps": 10, "min_workers": 5, "max_workers": 4},
               {"per_worker_tps": 10, "headroom": 0.9}):
        with pytest.raises(ValueError) as got:
            AutoscaleController(**kw)
        with pytest.raises(ValueError) as want:
            jautoscale.AutoscaleController(**kw)
        assert str(got.value) == str(want.value)


def test_autoscale_ledger_equals_jax_and_ignores_idle_polls():
    """The decision ledger is a pure function of the arrivals, the same
    as JAX's, and idle polls between arrivals do not change it."""
    _, times = _ramp("port")
    _, jtimes = _ramp("jax")
    np.testing.assert_array_equal(times, jtimes)
    a, b, j = _controller("port"), _controller("port"), _controller("jax")
    for t in times:
        a.observe(float(t), 1)
        j.observe(float(t), 1)
    a.observe(14.0, 0)
    j.observe(14.0, 0)
    nxt = 0.137
    for t in times:
        while nxt < t:
            b.observe(nxt, 0)
            nxt += 0.137
        b.observe(float(t), 1)
    while nxt < 14.0:
        b.observe(nxt, 0)
        nxt += 0.137
    b.observe(14.0, 0)
    assert a.snapshot() == j.snapshot()
    assert a.snapshot()["decisions"] == b.snapshot()["decisions"]
    assert a.events == b.events and a.events["up"] >= 1


def test_autoscale_ahead_of_the_ramp_then_drained():
    proc, times = _ramp("port")
    c = _controller("port")
    for t in times:
        c.observe(float(t), 1)
    decisions = list(c.decisions)
    target_at = [(0.0, 4)] + [(d["t"], d["target"]) for d in decisions]

    def target(t):
        return [tg for td, tg in target_at if td <= t][-1]

    for i in range(25):
        assert target(i * 0.5) * 110.0 >= proc.rate_at(i * 0.5) - 1e-6
    ups = [d for d in decisions if d["direction"] == "up"]
    assert ups and ups[-1]["t"] < 6.0 and max(d["target"] for d in ups) == 8
    for i in range(1, 30):
        c.observe(12.0 + i * 0.25, 0)
    assert c.target == 4 and c.events["down"] >= 1


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_autoscale_down_patience_hysteresis(pkg):
    cls, fc = ((jautoscale.AutoscaleController, JaxForecaster) if pkg == "jax"
               else (AutoscaleController, ArrivalForecaster))
    c = cls(per_worker_tps=100.0, min_workers=1, max_workers=8, headroom=1.0,
            lead_s=0.0, decide_interval_s=1.0, down_patience=3,
            forecaster=fc(bucket_s=0.5))
    t = 0.0
    for _ in range(4000):
        c.observe(t, 1)
        t += 0.0025
    high = c.target
    assert high >= 4
    c.observe(t + 1.0, 0)
    assert c.target == high                      # one quiet decision: no drain
    for i in range(2, 6):
        c.observe(t + i * 1.0, 0)
    assert c.target == 1


def _autoscale_snapshot(up=2, down=1, ckpts=10, restores=3, torn=1):
    return {"target_workers": 6, "forecast_rate": 512.3,
            "events": {"up": up, "down": down},
            "handoff_server": {"checkpoints_total": ckpts, "restores_total": restores,
                               "torn_blobs_total": torn}}


def _lines(m, prefixes):
    return [ln for ln in m.render_prometheus().splitlines() if ln.startswith(prefixes)]


def test_sync_autoscale_renders_the_jax_series():
    got, want = MetricsCollector(), JaxMetricsCollector()
    for snap in (_autoscale_snapshot(), _autoscale_snapshot(),
                 _autoscale_snapshot(up=4, ckpts=15),
                 {"target_workers": 3, "forecast_rate": 9.0,
                  "events": {"up": 4, "down": 1}}):
        got.sync_autoscale(snap)
        want.sync_autoscale(snap)
        prefixes = ("autoscale_", "handoff_server_", "# HELP autoscale",
                    "# TYPE autoscale", "# HELP handoff_server", "# TYPE handoff_server")
        assert _lines(got, prefixes) == _lines(want, prefixes)
    assert got.autoscale_events.total() == 5
    assert got.handoff_server_checkpoints.total() == 15
    assert got.autoscale_target_workers.value() == 3


# ------------------------------------------------------------ ingress client
def test_ingress_unreachable_fleet_retries_then_raises():
    slept = []
    cli = ShardIngressClient(["http://127.0.0.1:1"], retries=3, timeout_s=0.5,
                             retry_sleep=slept.append)
    with pytest.raises(NoShardAvailableError):
        cli.predict({"transaction_id": "t1", "user_id": "u1", "merchant_id": "m1",
                     "amount": 1.0})
    assert len(slept) == 3 and cli.snapshot()["retried"] == 3


def test_ingress_stale_ring_pingpong_ends_with_an_error():
    urls = ["http://a", "http://b"]
    cli = ShardIngressClient(urls, max_redirects=3, retry_sleep=lambda s: None)
    posts = []

    def _pingpong(url, payload):
        posts.append(url)
        return 421, {"owner": "elsewhere", "location": urls[url == urls[0]]}

    cli._post = _pingpong
    with pytest.raises(NoShardAvailableError):
        cli.predict({"transaction_id": "t1", "user_id": "u9", "merchant_id": "m1",
                     "amount": 1.0})
    assert len(posts) == 1 + 3
    snap = cli.snapshot()
    assert snap["redirects_followed"] == 3 and snap["affinity_size"] == 0


def test_ingress_drops_affinity_on_421_for_a_confirmed_user():
    cli = ShardIngressClient(["http://a", "http://b"], retry_sleep=lambda s: None)
    script = {"phase": "confirm"}

    def _post(url, payload):
        if script["phase"] == "confirm":
            return 200, {"transaction_id": "t", "fraud_score": 0.1}
        if url == script["stale_url"]:
            return 421, {"owner": None, "location": ""}
        return 200, {"transaction_id": "t", "fraud_score": 0.2}

    cli._post = _post
    txn = {"transaction_id": "t", "user_id": "u1", "merchant_id": "m", "amount": 1.0}
    cli.predict(txn)
    stale_url = cli._affinity["u1"]
    script.update(phase="moved", stale_url=stale_url)
    with pytest.raises(NoShardAvailableError):
        cli.predict(txn)
    assert "u1" not in cli._affinity
    assert cli.predict(txn)["fraud_score"] == 0.2
    assert cli._affinity["u1"] != stale_url


def test_ingress_follows_421_to_the_owner_and_learns_affinity():
    """Two live clustered port apps on the CPU: a request sent to the
    wrong shard follows the 421 to the owner; the next goes direct."""
    served = {}
    for wid in ("w0", "w1"):
        config = _serving_config(Config)
        config.cluster.enabled = True
        config.cluster.worker_id = wid
        config.cluster.workers = {"w0": "", "w1": ""}
        served[wid] = _Served(ServingApp(config, host="127.0.0.1", port=0, device="cpu"))
    try:
        urls = {wid: f"http://127.0.0.1:{s.app.port}" for wid, s in served.items()}
        for s in served.values():
            s.app.cluster_router.addresses.update(urls)
        ref = ShardRouter(12, ["w0", "w1"])
        uid = next(f"user_{i:06d}" for i in range(10_000)
                   if ref.route(f"user_{i:06d}") == "w1")
        gen = TransactionGenerator(num_users=20, num_merchants=10, seed=3)
        txn = dict(gen.generate_batch(1)[0], user_id=uid, transaction_id="t_ingress_1")
        cli = ShardIngressClient([urls["w0"], urls["w1"]])
        res = cli.predict(txn)
        assert res.get("fraud_probability") is not None
        assert res["_ingress"]["redirects"] == 1
        assert res["_ingress"]["worker_url"] == urls["w1"]
        res2 = cli.predict({**txn, "transaction_id": "t_ingress_2"})
        assert res2["_ingress"]["redirects"] == 0
        snap = cli.snapshot()
        assert snap["redirects_followed"] == 1 and snap["affinity_hits"] == 1
    finally:
        for s in served.values():
            s.close()


# --------------------------------------------- abandon, the cadence snapshot
def _fleet_parts(pkg):
    if pkg == "jax":
        return (JaxInMemoryBroker, jpartition.PartitionedStore, jfleet.ClusterWorker,
                jfleet.HandoffStore)
    return (InMemoryBroker, ppartition.PartitionedStore, pfleet.ClusterWorker,
            pfleet.HandoffStore)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_abandon_drops_partitions_without_a_checkpoint(pkg):
    broker_cls, store_cls, worker_cls, handoff_cls = _fleet_parts(pkg)
    broker = broker_cls()
    store = store_cls(12, seq_len=4, feature_dim=4)
    handoff = handoff_cls()
    scorer = (JaxShardScorer if pkg == "jax" else ShardScorer)(store)
    worker = worker_cls("w0", broker, scorer, store, handoff, "g", max_batch=64,
                        checkpoint_every=1000)
    worker.set_assignment(list(range(12)), now=0.0)
    broker.produce_batch(T.TRANSACTIONS, _shard_records(n=40),
                         key_fn=lambda r: str(r["user_id"]))
    worker.assembler.next_batch(block=False)        # records pending
    before = handoff.snapshots_taken
    assert worker.abandon() == 12
    assert store.owned() == [] and not worker.in_flight
    assert handoff.snapshots_taken == before         # no checkpoint
    assert not (worker.assembler.next_batch(block=False) or worker.assembler.flush())


@pytest.fixture(scope="module")
def jax_models():
    return _jax_models()


def _cadence_run(pkg, jax_models):
    """One worker with two batches in flight takes its cadence checkpoint
    when the first completes; an inheritor restores it and rescores the
    second, uncommitted batch. Returns the user's history rows (oracle,
    inheritor) and the committed offsets."""
    broker_cls, store_cls, worker_cls, handoff_cls = _fleet_parts(pkg)
    gen = TransactionGenerator(num_users=40, num_merchants=10, seed=31)
    uid = str(gen.generate_batch(1)[0]["user_id"])
    records = [dict(r, user_id=uid, transaction_id=f"cad{i}")
               for i, r in enumerate(gen.generate_batch(6))]
    p = partition_for_key(uid, 12)

    def scorer(store):
        if pkg == "jax":
            s = FraudScorer(models=jax_models, stores=store)
        else:
            s = TorchFraudScorer(models=models_from_numpy(jax_models), device="cpu",
                                 stores=store)
        return s

    broker, handoff = broker_cls(), handoff_cls()
    stores = [store_cls(12, seq_len=10, feature_dim=64) for _ in range(2)]
    workers = [worker_cls(f"w{i}", broker, scorer(stores[i]), stores[i], handoff, "g",
                          max_batch=3, max_delay_ms=1e6, checkpoint_every=1)
               for i in range(2)]
    w0, w1 = workers
    w0.set_assignment([p], now=100.0)
    broker.produce_batch(T.TRANSACTIONS, records, key_fn=lambda r: str(r["user_id"]))
    a = w0.assembler.next_batch(block=False)
    ctx_a = w0.job.dispatch_batch(a, now=100.0)
    b = w0.assembler.next_batch(block=False)
    w0.job.dispatch_batch(b, now=100.5)              # in flight, never completed
    assert [len(a), len(b)] == [3, 3]
    w0.job.complete_batch(ctx_a, now=101.0)
    w0.on_batch_complete()                            # the cadence snapshot
    snap_offset = handoff.offsets()[p]
    snap_rows = int(stores[0].history.gather([uid])[1][0])
    w1.set_assignment([p], now=102.0)                 # w0 is lost
    batch = w1.assembler.next_batch(block=False) or w1.assembler.flush()
    w1.job.complete_batch(w1.job.dispatch_batch(batch, now=102.0), now=102.5)
    oracle = store_cls(12, seq_len=10, feature_dim=64)
    single = worker_cls("o", broker_cls(), scorer(oracle), oracle, handoff_cls(), "g2",
                        max_batch=3, max_delay_ms=1e6, checkpoint_every=1000)
    single.set_assignment([p], now=100.0)
    single.broker.produce_batch(T.TRANSACTIONS, records,
                                key_fn=lambda r: str(r["user_id"]))
    for now in (100.0, 100.5):
        batch = single.assembler.next_batch(block=False)
        single.job.complete_batch(single.job.dispatch_batch(batch, now=now), now=now)
    return {"snapshot_offset": snap_offset, "snapshot_rows": snap_rows,
            "rescored": [r.value["transaction_id"] for r in batch],
            "inheritor_rows": int(stores[1].history.gather([uid])[1][0]),
            "oracle_rows": int(oracle.history.gather([uid])[1][0]),
            "committed": broker.committed("g", T.TRANSACTIONS, p)}


def test_cadence_snapshot_with_a_batch_in_flight_matches_jax(jax_models):
    """The snapshot is keyed to offset 3 but holds the in-flight batch's
    history rows (appended at assembly); the inheritor rescores that batch
    from offset 3 and appends its rows a second time: 9 rows where one
    scorer has 6. Both packages behave alike."""
    got = _cadence_run("port", jax_models)
    want = _cadence_run("jax", jax_models)
    assert got == want
    assert got["snapshot_offset"] == 3 and got["snapshot_rows"] == 6
    assert got["committed"] == 6 and got["oracle_rows"] == 6
    assert got["inheritor_rows"] == 9


# ------------------------------------------------------------- process fleet
def test_process_fleet_sigterm_drain_and_sigkill_equal_the_oracle(tmp_path):
    """Three worker processes. w0 gets SIGTERM: it drains, final-checkpoints
    every partition it owns and exits 0, so its inheritors replay nothing.
    w1 is SIGKILLed (-9) and recovered from the network store plus the
    committed-gap replay. w2, the survivor, ends owning every partition,
    and its digests at shutdown equal the single-process oracle's."""
    cfg = dataclasses.replace(pelastic.ElasticDrillConfig.fast(), num_users=5_000,
                              hot_users=300)
    records = [txn for _, txn in pelastic.build_elastic_schedule(cfg)][:900]
    oracle = pelastic.run_elastic_oracle(cfg, [(0.0, t) for t in records])
    broker = BrokerServer(port=0).start()
    handoff = HandoffServer(blob_dir=str(tmp_path / "blobs")).start()
    fleet = ProcessFleet(
        f"127.0.0.1:{broker.port}", f"127.0.0.1:{handoff.port}", n_partitions=12,
        spawn_env=torch_threads.spawn_env(),
        worker_spec={"batch": 32, "max_delay_ms": 5.0, "checkpoint_every": 4,
                     "seq_len": 4, "feature_dim": 4, "base_ms": 1.0,
                     "per_txn_ms": 0.2})

    def produce(chunk):
        fleet.client.produce_batch_stamped(
            T.TRANSACTIONS, [(t["user_id"], t, time.time()) for t in chunk])

    def committed():
        return sum(fleet.client.committed(fleet.group_id, T.TRANSACTIONS, p)
                   for p in range(12))

    def wait_for(pred, what, timeout=90.0):
        deadline = time.time() + timeout
        while not pred():
            fleet.poll_events()
            assert time.time() < deadline, what
            time.sleep(0.02)

    try:
        fleet.start(3, now=0.0)
        third = len(records) // 3
        produce(records[:third])
        wait_for(lambda: committed() >= third // 2, "no progress")
        owned0 = fleet.assignment()["w0"]
        st0 = fleet.workers["w0"]
        os.kill(st0["pid"], signal.SIGTERM)
        assert st0["proc"].wait(timeout=60) == 0
        wait_for(lambda: "w0" in fleet.all_byes(), "no bye from w0")
        bye = fleet.all_byes()["w0"]
        assert bye["graceful"] and bye["reason"] == "SIGTERM"
        assert bye["final_checkpoints"] == len(owned0)
        offsets = fleet.handoff.offsets()
        assert all(offsets[p] == fleet.client.committed(fleet.group_id,
                                                        T.TRANSACTIONS, p)
                   for p in owned0)
        # a worker that said bye is not a death to reap: the coordinator
        # takes it out of the ring as its drain does, and its inheritors
        # replay nothing
        st0["alive"] = False
        fleet.ring.remove("w0")
        event = fleet._rebalance(reason="drain:w0", now=1.0)
        assert event["replayed"] == 0 and set(event["moved"]) == set(owned0)
        produce(records[third:2 * third])
        wait_for(lambda: committed() >= third + third // 2, "no progress")
        killed = fleet.kill_worker("w1", now=2.0)
        assert killed["returncode"] == -signal.SIGKILL and fleet.kills == 1
        produce(records[2 * third:])
        wait_for(lambda: committed() == len(records), "survivor did not finish", 120.0)
        assert fleet.ready_ids() == ["w2"] and len(fleet.assignment()["w2"]) == 12
        summaries = fleet.shutdown_all(now=3.0)
        got = {int(p): d for p, d in summaries["w2"]["digests"].items()}
        assert got == oracle["digests"]
        assert "w1" not in fleet.all_byes()
    finally:
        fleet.terminate()
        handoff.stop()
        broker.stop()


# ------------------------------------------------------------ elastic drill
def test_elastic_schedule_and_oracle_equal_jax():
    cfg = pelastic.ElasticDrillConfig.fast()
    jcfg = jelastic.ElasticDrillConfig.fast()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    sched = pelastic.build_elastic_schedule(cfg)
    jsched = jelastic.build_elastic_schedule(jcfg)
    assert sched == jsched
    got = pelastic.run_elastic_oracle(cfg, sched)
    want = jelastic.run_elastic_oracle(jcfg, jsched)
    assert got["digests"] == want["digests"] and got["scores"] == want["scores"]


def test_elastic_drill_fast_command():
    """``elastic-drill --fast`` as a command: real worker processes, the
    network store, a real SIGKILL mid-peak, autoscale up then drained,
    oracle equality and a digest-equal second run."""
    proc = subprocess.run(
        [sys.executable, "-m", "realtime_fraud_detection_tpu_torch", "elastic-drill",
         "--fast"], cwd=ROOT, capture_output=True, text=True, timeout=400,
        env=torch_threads.spawn_env())
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    compact = json.loads(lines[-1])
    assert len(lines[-1].encode()) < 2048
    assert compact["passed"] is True and compact["kill_returncode"] == -9
    assert compact["workers_joined"] >= 8
    assert compact["lost"] == 0 and compact["conflicting_scored"] == 0
    full = json.loads(lines[-2])
    assert set(full["checks"]) == {
        "processes_real", "processes_enough", "sigkill_real", "zero_lost",
        "zero_double_scored", "zero_errors", "offsets_gap_free",
        "per_key_order_preserved", "state_equals_oracle", "scores_equal_oracle",
        "handoff_replay_exercised", "autoscale_ahead_of_ramp", "scaled_up_before_peak",
        "drained_after_peak", "movement_bounded", "replay_deterministic"}
    assert all(full["checks"].values())


def test_compact_elastic_summary_fits_2kb_like_jax():
    summary = {"metric": "elastic_drill", "passed": False,
               "autoscale_events": {"up": 99, "down": 99},
               "checks": {f"very_long_check_name_{i}" * 4: False for i in range(64)}}
    got = pelastic.compact_elastic_summary(summary)
    assert got == jelastic.compact_elastic_summary(summary)
    assert len(json.dumps(got, separators=(",", ":")).encode()) < 2048


# -------------------------------------------------------------- JAX blocked
def test_process_fleet_modules_import_with_jax_blocked():
    script = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "flax", "ml_dtypes",
                     "realtime_fraud_detection_tpu"):
            sys.modules[name] = None
        from realtime_fraud_detection_tpu_torch.cluster import (
            AutoscaleController, FencedEpochError, HandoffClient, HandoffServer)
        from realtime_fraud_detection_tpu_torch.cluster.procfleet import (
            ProcessFleet, worker_main)
        from realtime_fraud_detection_tpu_torch.cluster.elastic_drill import (
            run_elastic_drill)
        from realtime_fraud_detection_tpu_torch.chaos import LinkFaultPlane
        from realtime_fraud_detection_tpu_torch.chaos.drill import run_chaos_drill
        from realtime_fraud_detection_tpu_torch.chaos.partition_drill import (
            run_partition_drill)
        from realtime_fraud_detection_tpu_torch.serving.ingress_client import (
            ShardIngressClient)
        from realtime_fraud_detection_tpu_torch.obs.fleetmetrics import FleetTraceStore
        from realtime_fraud_detection_tpu_torch.__main__ import build_parser
        build_parser().parse_args(["cluster-worker", "--spec", "{}"])
        assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
                       if sys.modules[m] is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=torch_threads.spawn_env())
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_fleet_trace_store_equals_jax():
    """The coordinator's stitched flight recorder: two workers' bye rings
    (one stitched from an ingress carrier, one minted locally, one shed)
    give JAX's rows, stitch statistics, breakdown and merged Chrome trace."""
    from realtime_fraud_detection_tpu.obs.fleetmetrics import (
        FleetTraceStore as JaxFleetTraceStore,
    )
    from realtime_fraud_detection_tpu_torch.obs.fleetmetrics import FleetTraceStore

    rng = np.random.default_rng(3)
    rings = {}
    for w in ("w0", "w1"):
        rows = []
        for i in range(40):
            stages = {"broker_transit": float(rng.uniform(0.1, 2.0)),
                      "queue": float(rng.uniform(0.5, 5.0)),
                      "device_wait": float(rng.uniform(1.0, 9.0))}
            rows.append({"trace_id": f"t{w}-{i:08x}", "txn_id": f"{w}-{i}",
                         "t_start": 100.0 + 0.01 * i, "e2e_ms": sum(stages.values()),
                         "stages": stages, "meta": {}, "priority": "normal",
                         "terminal": "shed" if i % 13 == 0 else "scored",
                         **({"origin": "ingress"} if i % 3 else {})})
        rings[w] = rows
    stores = []
    for cls in (FleetTraceStore, JaxFleetTraceStore):
        store = cls(ring_size=64, slowest_n=4)
        for pid, (w, rows) in enumerate(sorted(rings.items()), start=100):
            assert store.ingest(w, rows + [{"no": "trace_id"}], pid=pid) == 40
        stores.append(store)
    got, want = stores
    assert got.rows() == want.rows() and len(got.rows()) == 64
    assert got.stitch_stats() == want.stitch_stats()
    assert got.breakdown() == want.breakdown()
    assert got.export_chrome_trace() == want.export_chrome_trace()
