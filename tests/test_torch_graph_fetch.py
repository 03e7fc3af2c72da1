"""The port's cross-partition graph fetch against the JAX package.

- ``GraphFetchClient`` / ``GraphFetchServer``: each case of the JAX
  package's ``TestGraphFetch`` (``tests/test_graph.py``) runs through both
  packages with the same calls: round trip and merge, the node budget, the
  deadline, a dead peer gated by backoff, generation fencing, a netfault
  partition. The returned maps, degrade flags and every counter of
  ``stats()`` are equal, and the JAX test's own assertions hold on the port.
- The wire both ways: a JAX client against a port server and a port client
  against a JAX server give the same neighbour maps.
- The sampler with fetch attached: each package's ``NeighborSampler`` over
  one of two partition graphs, its client fetching from a server over the
  other, on a fraud-ring stream: every neighbour tensor, the sampler's
  stats and the client's stats equal, batch by batch.
- ``attach_graph_fetch`` and ``graph_snapshot``; the seven ``graph_*`` fetch
  families render JAX's exposition lines for the same snapshots.
- ``cluster-worker`` with a ``fetch`` spec: it serves its graph, announces
  it, builds its client from the ``peers`` message, fetches each batch and
  reports the counts in its bye.

Tolerances: none; everything here is exact.
"""

import torch_threads  # first: torch held to one CPU thread
import json
import os
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import pytest

from realtime_fraud_detection_tpu.chaos.netfaults import LinkState as JaxLinkState
from realtime_fraud_detection_tpu.graph import fetch as jfetch
from realtime_fraud_detection_tpu.graph.sampler import NeighborSampler as JaxSampler
from realtime_fraud_detection_tpu.graph.store import TypedEntityGraph as JaxGraph
from realtime_fraud_detection_tpu.obs.metrics import MetricsCollector as JaxMetricsCollector
from realtime_fraud_detection_tpu.sim.fraud_patterns import FraudRingConfig
from realtime_fraud_detection_tpu.sim.simulator import TransactionGenerator
from realtime_fraud_detection_tpu_torch.chaos.netfaults import LinkState
from realtime_fraud_detection_tpu_torch.graph import fetch as pfetch
from realtime_fraud_detection_tpu_torch.graph.sampler import NeighborSampler
from realtime_fraud_detection_tpu_torch.graph.store import TypedEntityGraph
from realtime_fraud_detection_tpu_torch.obs.metrics import MetricsCollector

ROOT = Path(__file__).resolve().parent.parent

# (fetch module, graph class, link class) of each package
JAX = (jfetch, JaxGraph, JaxLinkState)
PORT = (pfetch, TypedEntityGraph, LinkState)


def _ring_graph(graph_cls, fanout=8):
    """u1 has device d1 (shared with u2, u3), ip i1, merchant m1."""
    g = graph_cls(fanout=fanout)
    g.add_batch(["u1", "u2", "u3"], ["m1", "m2", "m2"],
                ["d1", "d1", "d1"], ["i1", "i2", "i3"])
    g.drain_dirty()
    return g


# ------------------------------------------------------------ client cases
# each case drives one package's client (and server) and returns what it
# observed; the test runs it on both packages and holds them equal


def _round_trip(fetch, graph_cls, link_cls):
    srv = fetch.GraphFetchServer(lambda g=_ring_graph(graph_cls): g,
                                 worker_id="w0").start()
    try:
        c = fetch.GraphFetchClient({"w0": ("127.0.0.1", srv.port)},
                                   deadline_ms=2_000.0, node_budget=64)
        c.begin_batch()
        maps, degraded = c.fetch("device->user", ["d1", "dX"], 8)
        assert not degraded
        assert maps[0]["d1"] == ["u1", "u2", "u3"]
        assert "dX" not in maps[0]                # empties omitted
        assert c.remote_fetch_total == 1 and c.fetched_nodes_total == 1
        ended = c.end_batch()
        assert not ended
        c.close()
        return {"maps": maps, "degraded": [degraded, ended], "stats": c.stats(),
                "served": srv.requests_total}
    finally:
        srv.stop()


def _budget(fetch, graph_cls, link_cls):
    srv = fetch.GraphFetchServer(lambda g=_ring_graph(graph_cls): g,
                                 worker_id="w0").start()
    try:
        c = fetch.GraphFetchClient({"w0": ("127.0.0.1", srv.port)},
                                   deadline_ms=2_000.0, node_budget=1)
        c.begin_batch()
        maps, degraded = c.fetch("device->user", ["d1", "dX"], 8)
        assert degraded and c.budget_exhausted_total == 1
        # the second fetch of the batch: the budget is gone
        maps2, degraded2 = c.fetch("ip->user", ["i1"], 8)
        assert degraded2 and maps2 == []
        ended = c.end_batch()
        assert ended and c.degraded_batches_total == 1
        c.close()
        return {"maps": [maps, maps2], "degraded": [degraded, degraded2, ended],
                "stats": c.stats(), "served": srv.requests_total}
    finally:
        srv.stop()


def _deadline(fetch, graph_cls, link_cls):
    c = fetch.GraphFetchClient({"w0": ("127.0.0.1", 1)},  # never contacted
                               deadline_ms=0.0, node_budget=64)
    c.begin_batch()
    maps, degraded = c.fetch("device->user", ["d1"], 8)
    assert degraded and maps == []
    # several expired fetches in one window count one deadline batch
    c.fetch("ip->user", ["i1"], 8)
    ended = c.end_batch()
    assert ended and c.fetch_deadline_total == 1
    assert c.degraded_batches_total == 1 and c.remote_fetch_total == 0
    return {"maps": maps, "degraded": [degraded, ended], "stats": c.stats()}


def _dead_peer(fetch, graph_cls, link_cls):
    tnow = [0.0]
    c = fetch.GraphFetchClient({"w0": ("127.0.0.1", 9)},  # refused port
                               deadline_ms=50.0, node_budget=64,
                               clock=lambda: tnow[0])
    c.begin_batch()
    _, degraded = c.fetch("device->user", ["d1"], 8)
    assert degraded and c.fetch_error_total == 1
    # at once after: the peer is down and the attempt is skipped on the
    # injected clock, with no sleep and no connect
    c.begin_batch()
    c.fetch("device->user", ["d1"], 8)
    assert c.fetch_error_total == 2 and not c.backoff.slept
    # past the backoff's delay the client connects again
    tnow[0] += 10.0
    c.begin_batch()
    c.fetch("device->user", ["d1"], 8)
    assert c.fetch_error_total == 3
    return {"degraded": [degraded], "stats": c.stats()}


def _fencing(fetch, graph_cls, link_cls):
    srv = fetch.GraphFetchServer(lambda g=_ring_graph(graph_cls): g,
                                 worker_id="w0").start()
    try:
        srv.fence(5)
        c = fetch.GraphFetchClient({"w0": ("127.0.0.1", srv.port)},
                                   deadline_ms=2_000.0, node_budget=64)
        c.begin_batch()
        maps, degraded = c.fetch("device->user", ["d1"], 8)
        assert degraded and maps == []
        assert c.stale_generation_total == 1 and srv.fenced_requests_total == 1
        c.set_generation(5)                      # the rebalance adopted
        c.begin_batch()
        maps2, degraded2 = c.fetch("device->user", ["d1"], 8)
        assert not degraded2 and maps2[0]["d1"]
        c.close()
        return {"maps": [maps, maps2], "degraded": [degraded, degraded2],
                "stats": c.stats(), "served": srv.requests_total,
                "server_stats": srv.dispatch({"op": "stats"})}
    finally:
        srv.stop()


def _netfault(fetch, graph_cls, link_cls):
    srv = fetch.GraphFetchServer(lambda g=_ring_graph(graph_cls): g,
                                 worker_id="w0").start()
    try:
        link = link_cls("graphfetch", "peers", sleep=lambda _s: None)
        c = fetch.GraphFetchClient({"w0": ("127.0.0.1", srv.port)},
                                   deadline_ms=2_000.0, node_budget=64,
                                   link=link)
        link.set_partition("full")
        c.begin_batch()
        _, degraded = c.fetch("device->user", ["d1"], 8)
        assert degraded and link.partitioned_sends == 1
        ended = c.end_batch()
        assert ended
        link.clear_partition()
        c.begin_batch()
        maps, healed = c.fetch("device->user", ["d1"], 8)
        c.end_batch()
        c.close()
        return {"maps": maps, "degraded": [degraded, ended, healed],
                "stats": c.stats(), "link": link.snapshot_entry()}
    finally:
        srv.stop()


CASES = {"round_trip_and_merge": _round_trip,
         "budget_truncates_and_counts": _budget,
         "deadline_degrades_without_stalling": _deadline,
         "dead_peer_backoff_gated_no_sleep": _dead_peer,
         "generation_fencing_refused_and_adopted": _fencing,
         "netfault_link_partition_degrades": _netfault}


@pytest.mark.parametrize("case", list(CASES))
def test_fetch_case_equals_jax(case):
    """The port's client and server observe what JAX's do for the same
    calls: maps, degrade flags, every counter of ``stats()``."""
    got, want = CASES[case](*PORT), CASES[case](*JAX)
    assert got == want


def test_stale_generation_error_is_a_runtime_error():
    assert issubclass(pfetch.StaleGraphGenerationError, RuntimeError)
    srv = pfetch.GraphFetchServer(lambda: _ring_graph(TypedEntityGraph)).start()
    try:
        srv.fence(3)
        srv.fence(1)                             # the fence never lowers
        with pytest.raises(pfetch.StaleGraphGenerationError):
            srv.dispatch({"op": "neighbors", "edge": "device->user",
                          "ids": ["d1"], "generation": 2})
        assert srv.dispatch({"op": "ping"}) == {"pong": True, "worker": ""}
        with pytest.raises(ValueError):
            srv.dispatch({"op": "nope"})
    finally:
        srv.stop()


@pytest.mark.parametrize("client_pkg,server_pkg", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_client_port_server", "port_client_jax_server"])
def test_wire_crosses_packages(client_pkg, server_pkg):
    """A client of one package reads a server of the other: the frames are
    the same, so the neighbour maps and counters equal a same-package
    pair's."""
    def run(cli, srv_pkg):
        g = srv_pkg[1](fanout=8)
        g.add_batch([f"u{i}" for i in range(12)], [f"m{i % 3}" for i in range(12)],
                    [f"d{i % 4}" for i in range(12)], [f"i{i % 5}" for i in range(12)])
        srv = srv_pkg[0].GraphFetchServer(lambda: g, worker_id="peer").start()
        try:
            c = cli[0].GraphFetchClient({"peer": ("127.0.0.1", srv.port)},
                                        deadline_ms=5_000.0, node_budget=64)
            c.begin_batch()
            out = [c.fetch(et, ids, k) for et, ids, k in (
                ("device->user", ["d0", "d1", "d9"], 2),
                ("ip->user", ["i0", "i4"], None),
                ("merchant->user", ["m0", "m1", "m2"], 8),
                ("user->device", ["u3", "u11"], 4))]
            c.end_batch()
            c.close()
            return out, c.stats(), srv.requests_total
        finally:
            srv.stop()

    got = run(client_pkg, server_pkg)
    assert got == run(client_pkg, client_pkg) == run(server_pkg, server_pkg)
    assert got[0][0][0][0]["d0"] == ["u4", "u8"]


# ------------------------------------------------------------- the sampler
def _rows(node_dim):
    def rows(ids):
        out = np.zeros((len(ids), node_dim), np.float32)
        for i, e in enumerate(ids):
            out[i] = np.random.default_rng(zlib.crc32(str(e).encode())).random(node_dim)
        return out
    return rows


def _sample_stream(pkg, sampler_cls, records_by_batch, owner_a):
    """Partition A's sampler, with a client fetching from a server over
    partition B; each batch is sampled (A's rows) before it is ingested
    into the graph its user owns."""
    fetch, graph_cls, _ = pkg
    graphs = {True: graph_cls(fanout=4), False: graph_cls(fanout=4)}
    srv = fetch.GraphFetchServer(lambda: graphs[False], worker_id="b").start()
    try:
        client = fetch.GraphFetchClient({"b": ("127.0.0.1", srv.port)},
                                        deadline_ms=10_000.0, node_budget=24)
        sampler = sampler_cls(graphs[True], 16, 4, 4, _rows(16), _rows(16), fetch=client)
        outs = []
        for recs in records_by_batch:
            mine = [r for r in recs if owner_a(r["user_id"])]
            outs.append(sampler.sample([r["user_id"] for r in mine],
                                       [r["merchant_id"] for r in mine]))
            outs.append((dict(sampler.stats()), client.stats()))
            for owned in (True, False):
                part = [r for r in recs if owner_a(r["user_id"]) == owned]
                if part:
                    graphs[owned].add_batch(
                        [r["user_id"] for r in part], [r["merchant_id"] for r in part],
                        [r.get("device_id") or r.get("device_fingerprint") or "" for r in part],
                        [r.get("ip_address") or "" for r in part])
            sampler.sync()
        client.close()
        return outs, graphs[True].digest(), graphs[False].digest()
    finally:
        srv.stop()


def test_sampler_with_fetch_equals_jax():
    """Each package's sampler over partition A fetching partition B's
    shares of a fraud ring: equal tensors, sampler stats and client stats
    after every batch (the node budget runs out on some batches)."""
    gen = TransactionGenerator(num_users=40, num_merchants=10, seed=13)
    gen.inject_fraud_ring(FraudRingConfig(rate=0.3, n_members=10))
    batches = [gen.generate_batch(24) for _ in range(6)]

    def owner_a(uid):
        return zlib.crc32(str(uid).encode()) % 2 == 0

    got = _sample_stream(PORT, NeighborSampler, batches, owner_a)
    want = _sample_stream(JAX, JaxSampler, batches, owner_a)
    assert got[1:] == want[1:]
    fetched = 0
    for g, w in zip(got[0], want[0]):
        if isinstance(w, dict):
            assert set(g) == set(w)
            for key in w:
                assert np.array_equal(g[key], w[key]), key
        else:
            assert g == w
            fetched = w[1]["fetched_nodes_total"]
    assert fetched > 0 and want[0][-1][1]["budget_exhausted_total"] > 0


def test_scorer_attach_graph_fetch_and_snapshot():
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import (
        ScorerConfig, init_scoring_models)
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer

    flat = TorchFraudScorer(models=init_scoring_models(1, n_trees=2, tree_depth=2),
                            device="cpu")
    with pytest.raises(ValueError, match="typed"):
        flat.attach_graph_fetch(object())
    typed = TorchFraudScorer(
        models=init_scoring_models(1, n_trees=2, tree_depth=2, gnn_typed=True),
        scorer_config=ScorerConfig(graph_mode="typed", text_len=16), device="cpu")
    assert "fetch" not in typed.graph_snapshot()
    client = pfetch.GraphFetchClient({})
    typed.attach_graph_fetch(client)
    assert typed.graph_snapshot()["fetch"] == client.stats()


def test_sync_graph_renders_the_jax_fetch_series():
    got, want = MetricsCollector(), JaxMetricsCollector()
    families = ("graph_remote_fetch_total", "graph_remote_nodes_total",
                "graph_fetch_deadline_total", "graph_fetch_errors_total",
                "graph_fetch_budget_exhausted_total",
                "graph_fetch_stale_generation_total", "graph_degraded_batches_total")

    def lines(m):
        return [ln for ln in m.render_prometheus().splitlines()
                if any(f in ln for f in families)]

    keys = ("remote_fetch_total", "fetched_nodes_total", "fetch_deadline_total",
            "fetch_error_total", "budget_exhausted_total", "stale_generation_total",
            "degraded_batches_total")
    # a restart (3 -> 2) adds nothing and lowers the mark: 2+4+0+0+10
    for step in (1, 3, 3, 2, 7):
        snap = {"mode": "typed", "store": {"nodes": {"user": 4}, "edges_added": 9},
                "sampler": {"hits": step, "misses": 1, "evictions": 0, "entries": 2},
                "fetch": {k: step * (i + 1) for i, k in enumerate(keys)}}
        got.sync_graph(snap)
        want.sync_graph(snap)
        assert lines(got) == lines(want)
    assert len([ln for ln in lines(got) if ln.startswith("# HELP")]) == 7
    assert got.graph_remote_nodes.value() == 16.0


# ------------------------------------------------------------ the worker
def test_cluster_worker_serves_and_fetches_with_a_fetch_spec():
    """Two ``cluster-worker`` processes with ``fetch`` in their spec: each
    announces its fetch server, builds its client from the coordinator's
    ``peers`` map, fetches remote shares each batch, and reports the counts
    in its bye (the JAX worker's contract; a worker without the spec never
    serves)."""
    from realtime_fraud_detection_tpu_torch.cluster.handoff import HandoffServer
    from realtime_fraud_detection_tpu_torch.cluster.procfleet import ProcessFleet
    from realtime_fraud_detection_tpu_torch.stream import topics as T
    from realtime_fraud_detection_tpu_torch.stream.netbroker import BrokerServer

    broker = BrokerServer(port=0).start()
    tmp = tempfile.mkdtemp(prefix="fetch-worker-")
    handoff = HandoffServer(blob_dir=os.path.join(tmp, "blobs")).start()
    fleet = None
    try:
        fleet = ProcessFleet(
            f"127.0.0.1:{broker.port}", f"127.0.0.1:{handoff.port}", n_partitions=12,
            ack_timeout_s=60.0, spawn_env=torch_threads.spawn_env(),
            worker_spec={"batch": 8, "max_delay_ms": 5.0, "seq_len": 4,
                         "feature_dim": 4, "heartbeat_s": 0.2,
                         "fetch": {"edge": "user->device", "k": 4, "ids": 4,
                                   "deadline_ms": 2_000.0}})
        fleet.start(2, now=0.0)
        addrs = fleet.wait_fetch_addrs(["w0", "w1"])
        assert sorted(addrs) == ["w0", "w1"] and addrs["w0"] != addrs["w1"]
        fleet.broadcast_peers()
        t0 = time.time()
        items = [(f"user_{i % 9}", {"transaction_id": f"t{i}", "user_id": f"user_{i % 9}",
                                    "merchant_id": "m_1", "amount": 10.0 + i,
                                    "event_ts": 0.01 * i}, t0) for i in range(64)]
        time.sleep(0.5)                     # the peers message reaches both
        fleet.client.produce_batch_stamped(T.TRANSACTIONS, items)
        deadline = time.time() + 60
        while fleet.client.lag(fleet.group_id, T.TRANSACTIONS) and time.time() < deadline:
            fleet.tick(time.time() - t0)
            time.sleep(0.05)
        fleet.shutdown_all(now=time.time() - t0)
        byes = fleet.all_byes()
    finally:
        if fleet is not None:
            fleet.terminate()
        handoff.stop()
        broker.stop()
    assert sorted(byes) == ["w0", "w1"]
    for bye in byes.values():
        assert bye["fetch"]["peers"] == 1 and bye["fetch"]["remote_fetch_total"] > 0
        assert bye["fetch"]["fetch_error_total"] == 0
    assert sum(b["fetch_served"] for b in byes.values()) == \
        sum(b["fetch"]["remote_fetch_total"] for b in byes.values())
    assert sum(b["counters"]["scored"] for b in byes.values()) == 64


def test_graph_fetch_modules_import_with_jax_blocked():
    script = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'ml_dtypes', 'realtime_fraud_detection_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from realtime_fraud_detection_tpu_torch.graph import (\n"
        "    GraphFetchClient, GraphFetchServer, StaleGraphGenerationError)\n"
        "from realtime_fraud_detection_tpu_torch.graph.store import TypedEntityGraph\n"
        "g = TypedEntityGraph(fanout=4)\n"
        "g.add_batch(['u1', 'u2'], ['m', 'm'], ['d', 'd'], ['i', 'j'])\n"
        "srv = GraphFetchServer(lambda: g).start()\n"
        "c = GraphFetchClient({'p': ('127.0.0.1', srv.port)})\n"
        "c.begin_batch()\n"
        "maps, degraded = c.fetch('device->user', ['d'], 4)\n"
        "assert maps == [{'d': ['u1', 'u2']}] and not degraded and not c.end_batch()\n"
        "c.close(); srv.stop()\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=torch_threads.spawn_env())
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_fetch_stats_keys_equal_jax():
    assert json.dumps(pfetch.GraphFetchClient({}).stats(), sort_keys=True) == \
        json.dumps(jfetch.GraphFetchClient({}).stats(), sort_keys=True)
