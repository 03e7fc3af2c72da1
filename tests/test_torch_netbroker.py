"""The TCP log broker, the native microbatch queue, the ingress gateway and
the deployed commands of the port, on the CPU.

The port's ``NetBrokerClient`` against the JAX ``BrokerServer`` and the JAX
client against the port's server (produce, poll, commit, lag, positions, a
durable restart from the other package's write-ahead log, one
``HaBrokerClient`` failover); the port's ``NativeMicrobatchQueue``, built
with g++ into ``build/native/``, against its deque fallback; the
``IngressGateway`` on both queues; and ``broker`` + ``simulate --broker`` +
``run-job --broker --count 0 --device cpu`` stopped with SIGTERM and
restarted from its checkpoint, then ``alert-router --once``, at a toy size.
"""

import torch_threads  # first: torch held to one CPU thread
import json
import signal
import subprocess
import sys
import threading
import time
from collections import Counter
from pathlib import Path

import pytest

from realtime_fraud_detection_tpu.stream import netbroker as jnb
from realtime_fraud_detection_tpu.stream.transport import (
    StaleGenerationError as JaxStaleGenerationError,
)
from realtime_fraud_detection_tpu_torch import native
from realtime_fraud_detection_tpu_torch.obs.tracing import Tracer
from realtime_fraud_detection_tpu_torch.stream import netbroker as pnb
from realtime_fraud_detection_tpu_torch.stream import topics as T
from realtime_fraud_detection_tpu_torch.stream.gateway import (
    IngressGateway,
    _DequeFallback,
)
from realtime_fraud_detection_tpu_torch.stream.transport import (
    InMemoryBroker,
    StaleGenerationError,
)
from realtime_fraud_detection_tpu_torch.utils.backoff import DeterministicBackoff

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = {"port": pnb, "jax": jnb}
# (server package, client package)
PAIRS = [("jax", "port"), ("port", "jax"), ("port", "port")]


def _ids(pair):
    return f"{pair[0]}-server-{pair[1]}-client"


@pytest.fixture
def pair(request):
    server_pkg, client_pkg = request.param
    server = PACKAGES[server_pkg].BrokerServer(port=0).start()
    client = PACKAGES[client_pkg].NetBrokerClient(port=server.port)
    try:
        yield server, client
    finally:
        client.close()
        server.stop()


@pytest.mark.parametrize("pair", PAIRS, ids=_ids, indirect=True)
def test_produce_poll_commit_lag_interoperate(pair):
    server, client = pair
    assert client.ping()
    rec = client.produce(T.TRANSACTIONS, {"n": -1}, key="user_0")
    assert rec.offset == 0
    assert client.produce_batch(T.TRANSACTIONS, [{"n": i} for i in range(20)],
                                key_fn=lambda v: f"user_{v['n'] % 4}") == 20
    assert client.produce_batch_keyed(T.PREDICTIONS,
                                      [(f"user_{i}", {"p": i}) for i in range(6)]) == 6
    assert client.produce_batch_stamped(T.LABELS,
                                        [("k", {"l": i}, 100.0 + i) for i in range(3)]) == 3
    assert sum(client.end_offsets(T.TRANSACTIONS)) == 21
    assert client.partitions(T.TRANSACTIONS) == server.broker.partitions(T.TRANSACTIONS)
    c = client.consumer([T.TRANSACTIONS], "g")
    first = c.poll(8)
    snap = c.snapshot_positions()
    rest = c.poll(100)
    assert len(first) == 8 and len(rest) == 13
    # per-key order survives the wire
    seq = [r.value["n"] for r in first + rest if r.key == "user_1"]
    assert seq == sorted(seq) and seq
    c.commit(snap)
    assert c.lag() == 13 == client.lag("g", T.TRANSACTIONS)
    # a checkpoint's positions carry over to a fresh consumer
    positions = c.positions()
    c2 = client.consumer([T.TRANSACTIONS], "g")
    assert len(c2.poll(100)) == 13          # from the committed snapshot
    c3 = client.consumer([T.TRANSACTIONS], "g")
    c3.seek_to_positions(positions)
    assert c3.poll(100) == []
    c3.seek_to_committed()
    assert len(c3.poll(100)) == 13
    c3.commit()
    assert client.lag("g", T.TRANSACTIONS) == 0
    labels = client.consumer([T.LABELS], "l").poll(10)
    assert [r.timestamp for r in labels] == [100.0, 101.0, 102.0]
    client.create_topic("extra-topic", 3)
    assert client.partitions("extra-topic") == 3
    assert client.status()["role"] == "primary"


@pytest.mark.parametrize("pair", PAIRS, ids=_ids, indirect=True)
def test_generation_fence_interoperates(pair):
    """A stamped produce or commit below a partition's fence is refused
    across the wire, as the other package's error type."""
    server, client = pair
    key = next(f"k{i}" for i in range(1000)
               if server.broker.select_partition(T.TRANSACTIONS, f"k{i}") == 0)
    client.fence_producers(T.TRANSACTIONS, [0, 1], generation=3)
    client.generation = 2
    stale = (JaxStaleGenerationError, StaleGenerationError)
    with pytest.raises(stale):
        client.produce(T.TRANSACTIONS, {"n": 0}, key=key)
    with pytest.raises(stale):
        client.commit("g", {(T.TRANSACTIONS, 0): 1})
    client.generation = 3
    client.produce(T.TRANSACTIONS, {"n": 1}, key=key)
    client.commit("g", {(T.TRANSACTIONS, 0): 1})
    status = client.status()
    assert (status["fenced_produces"], status["fenced_commits"]) == (1, 1)
    assert client.committed("g", T.TRANSACTIONS, 0) == 1


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_durable_restart_across_packages(tmp_path, writer, reader):
    """One package's server writes the log and the offsets; the other's
    server restarts from the same directory and serves both."""
    log_dir = str(tmp_path / "wal")
    server = PACKAGES[writer].BrokerServer(port=0, log_dir=log_dir).start()
    client = PACKAGES[reader].NetBrokerClient(port=server.port)
    client.produce_batch(T.TRANSACTIONS, [{"n": i} for i in range(15)],
                         key_fn=lambda v: str(v["n"] % 4))
    c = client.consumer([T.TRANSACTIONS], "g")
    got = c.poll(9)
    c.commit()
    client.close()
    server.stop()

    server = PACKAGES[reader].BrokerServer(port=0, log_dir=log_dir).start()
    client = PACKAGES[writer].NetBrokerClient(port=server.port)
    try:
        assert sum(client.end_offsets(T.TRANSACTIONS)) == 15
        rest = client.consumer([T.TRANSACTIONS], "g").poll(100)
        assert not {(r.partition, r.offset) for r in got} & {
            (r.partition, r.offset) for r in rest}
        assert sorted(r.value["n"] for r in got + rest) == list(range(15))
        # keyed routing after the restart lands where the log put the key
        rec = client.produce(T.TRANSACTIONS, {"n": 99}, key="3")
        assert rec.partition == next(r.partition for r in got + rest
                                     if r.value["n"] == 3)
    finally:
        client.close()
        server.stop()


def test_consumer_rewinds_to_committed_after_reconnect(tmp_path):
    """The port's consumer over the port's client: a broker restart bumps
    the reconnect epoch, and the consumer re-reads from the committed
    offsets instead of its cursor."""
    log_dir = str(tmp_path / "wal")
    server = pnb.BrokerServer(port=0, log_dir=log_dir).start()
    port = server.port
    waits = []
    client = pnb.NetBrokerClient(port=port, reconnect_attempts=8,
                                 retry_sleep=waits.append)
    try:
        client.produce_batch(T.TRANSACTIONS, [{"n": i} for i in range(20)],
                             key_fn=lambda v: str(v["n"]))
        c = client.consumer([T.TRANSACTIONS], "g")
        first = c.poll(8)
        c.commit()
        mid = c.poll(6)                      # polled, not committed
        server.stop()
        server = pnb.BrokerServer(port=port, log_dir=log_dir).start()
        rest = []
        for _ in range(20):
            rest.extend(c.poll(100))
            if len({r.value["n"] for r in first + rest}) == 20:
                break
        assert waits and client.reconnect_epoch() >= 1
        # the uncommitted slice is delivered again, nothing committed is
        assert {(r.partition, r.offset) for r in mid} <= {
            (r.partition, r.offset) for r in rest}
        assert not {(r.partition, r.offset) for r in first} & {
            (r.partition, r.offset) for r in rest}
        assert {r.value["n"] for r in first + rest} == set(range(20))
    finally:
        client.close()
        server.stop()


@pytest.mark.parametrize("replica_pkg", ["port", "jax"])
def test_ha_client_fails_over_to_promoted_replica(replica_pkg):
    """The port's primary ships every produce and commit to a replica (of
    either package) before the ack; the primary dies, the replica is
    promoted, and the port's ``HaBrokerClient`` rotates to it and resumes
    the group where the primary acked it."""
    replica = PACKAGES[replica_pkg].BrokerServer(port=0, role="replica").start()
    primary = pnb.BrokerServer(port=0, min_isr=2).start()
    primary.add_replica("127.0.0.1", replica.port)
    client = pnb.HaBrokerClient([("127.0.0.1", primary.port),
                                 ("127.0.0.1", replica.port)], timeout_s=5.0)
    try:
        client.produce_batch(T.TRANSACTIONS, [{"n": i} for i in range(12)],
                             key_fn=lambda v: str(v["n"]))
        c = client.consumer([T.TRANSACTIONS], "g")
        first = c.poll(5)
        assert len(first) == 5
        c.commit()
        primary.stop()
        replica.promote()
        client.produce(T.TRANSACTIONS, {"n": 12}, key="12")
        rest = c.poll(100)                    # rewound to the acked commit
        assert sorted(r.value["n"] for r in first + rest) == list(range(13))
        assert client.status()["role"] == "primary"
        assert client.reconnect_epoch() >= 1
    finally:
        client.close()
        primary.stop()
        replica.stop()


def test_backoff_matches_jax():
    from realtime_fraud_detection_tpu.utils.backoff import (
        DeterministicBackoff as JaxBackoff,
    )

    got, want = [], []
    a = DeterministicBackoff(base_s=0.05, mult=2.0, max_s=0.8, seed=7, sleep=got.append)
    b = JaxBackoff(base_s=0.05, mult=2.0, max_s=0.8, seed=7, sleep=want.append)
    assert [a.sleep(k) for k in range(8)] == [b.sleep(k) for k in range(8)]
    assert got == want and max(got) <= 0.8


# ------------------------------------------------------- native queue
@pytest.fixture(scope="module")
def native_queue():
    if not native.native_available():
        pytest.fail(f"native build failed: {native.native_build_error()}")
    path = native.native_library_path()
    assert path.exists() and (ROOT / "build" / "native") in path.parents
    return native.NativeMicrobatchQueue


@pytest.mark.parametrize("max_batch,count", [(8, 8), (8, 21), (32, 100)])
def test_native_queue_batches_equal_the_deque_fallback(native_queue, max_batch, count):
    q = native_queue(capacity=128, slot_bytes=256, max_batch=max_batch,
                     max_delay_ms=1e9)
    d = _DequeFallback(128, max_batch)
    payloads = [json.dumps({"n": i, "pad": "x" * (i % 7)}).encode() for i in range(count)]
    for p in payloads:
        assert q.push(p) and d.push(p)
    assert q.pending() == d.pending() == count
    got, want = [], []
    while d.pending():
        want.append(d.next_batch(block_ms=0))
        # the native close is size or deadline: the tail closes at the block
        got.append(q.next_batch(block_ms=0 if len(want[-1]) == max_batch else 50))
    assert got == want
    assert q.stats()["records"] == count and q.pending() == 0
    q.close()


def test_native_queue_backpressure_and_oversize(native_queue):
    q = native_queue(capacity=4, slot_bytes=16, max_batch=4, max_delay_ms=1e9)
    assert all(q.push(b"x") for _ in range(4))
    assert not q.push(b"y")                    # full: backpressure
    with pytest.raises(ValueError, match="exceeds slot size"):
        q.push(b"z" * 64)
    q.close()
    with pytest.raises(ValueError, match="closed"):
        q.push(b"x")


def test_native_disabled_by_environment():
    code = ("import os; os.environ['RTFD_DISABLE_NATIVE'] = '1'; "
            "from realtime_fraud_detection_tpu_torch import native as n; "
            "print(n.native_available(), n.native_build_error())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=60, env=torch_threads.spawn_env())
    assert out.stdout.strip() == "False disabled via RTFD_DISABLE_NATIVE"


def test_stress_harness_runs(tmp_path):
    """The copied ThreadSanitizer harness builds and every record of its
    eight producers is consumed once (a plain build; ThreadSanitizer when
    the toolchain has it)."""
    src = ROOT / "realtime_fraud_detection_tpu_torch" / "native" / "stress_main.cpp"
    binary = tmp_path / "stress"
    flags = ["-fsanitize=thread", "-O1", "-g"]
    build = subprocess.run(["g++", *flags, "-std=c++17", "-pthread", str(src), "-o",
                            str(binary)], capture_output=True, text=True, timeout=120)
    if build.returncode != 0:
        build = subprocess.run(["g++", "-O2", "-std=c++17", "-pthread", str(src), "-o",
                                str(binary)], capture_output=True, text=True, timeout=120)
    assert build.returncode == 0, build.stderr
    run = subprocess.run([str(binary)], capture_output=True, text=True, timeout=120)
    assert run.returncode == 0 and run.stdout.startswith("OK"), run.stdout + run.stderr


# -------------------------------------------------------------- gateway
@pytest.mark.parametrize("disable_native", [False, True], ids=["native", "deque"])
def test_gateway_delivers_each_record_once_in_key_order(native_queue, monkeypatch,
                                                        disable_native):
    if disable_native:
        monkeypatch.setattr(native, "native_available", lambda: False)
    broker = InMemoryBroker()
    gw = IngressGateway(broker, T.TRANSACTIONS, stamp_ingest=True,
                        tracer=Tracer(origin="gw"))
    assert gw.native is (not disable_native)

    def producer(tid):
        for i in range(200):
            txn = {"transaction_id": f"{tid}:{i}", "user_id": f"u{tid}",
                   "merchant_id": "m", "amount": 1.0}
            while not gw.submit(txn):
                time.sleep(0.0005)

    threads = [threading.Thread(target=producer, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert gw.submit({"transaction_id": "big", "user_id": "u9", "description": "x" * 9000})
    assert gw.flush(timeout_s=30)
    gw.close()
    recs = broker.consumer([T.TRANSACTIONS], "check").poll(10_000)
    ids = [r.value["transaction_id"] for r in recs]
    assert len(ids) == len(set(ids)) == 801 and gw.dropped == 0 and gw.sent == 801
    for tid in range(4):
        seq = [int(r.value["transaction_id"].split(":")[1]) for r in recs
               if r.value["user_id"] == f"u{tid}"]
        assert seq == list(range(200))
    assert all("ingest_ts" in r.value and r.value["trace_carrier"]["org"] == "gw"
               for r in recs)


# ------------------------------------------------------------- commands
def _port(*args, **kw):
    env = torch_threads.spawn_env()
    return subprocess.Popen([sys.executable, "-m", "realtime_fraud_detection_tpu_torch",
                             *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, **kw)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_deployed_commands_stop_and_resume_exactly_once(tmp_path):
    """``broker`` -> ``simulate --broker`` -> ``run-job --broker --count 0``
    stopped by SIGTERM (drain, commit, final checkpoint) -> the same command
    again (resumes, replays nothing) -> ``alert-router --once``."""
    port = _free_port()
    addr = f"127.0.0.1:{port}"
    sim = ["--users", "60", "--merchants", "20", "--seed", "5"]
    job_args = ["run-job", "--broker", addr, "--count", "0", "--duration", "120",
                "--batch", "32", "--analytics", "--enrichment", "--checkpoint-dir",
                str(tmp_path / "ck"), "--metadata-db", str(tmp_path / "meta.db"),
                "--device", "cpu", *sim]
    procs = [_port("broker", "--host", "127.0.0.1", "--port", str(port), "--log-dir",
                   str(tmp_path / "wal"))]
    try:
        client = None
        for _ in range(200):
            try:
                client = pnb.NetBrokerClient(port=port, reconnect_attempts=0)
                break
            except OSError:
                time.sleep(0.05)
        assert client is not None
        topics = _port("topics", "--broker", addr, "--create")
        out, err = topics.communicate(timeout=60)
        assert topics.returncode == 0 and out.count("created") == len(T.TOPIC_SPECS)
        simulate = _port("simulate", "--broker", addr, "--count", "160", "--tps",
                         "100000", *sim)
        _, err = simulate.communicate(timeout=120)
        assert simulate.returncode == 0 and "native_queue=True" in err, err

        def run_until(stop_when):
            job = _port(*job_args)
            procs.append(job)
            deadline = time.time() + 120
            while not stop_when() and time.time() < deadline and job.poll() is None:
                time.sleep(0.05)
            job.send_signal(signal.SIGTERM)
            out, err = job.communicate(timeout=120)
            assert job.returncode == 0, err[-3000:]
            return json.loads(out.strip().splitlines()[-1]), err

        def predictions():
            return sum(client.end_offsets(T.PREDICTIONS))

        first, err1 = run_until(lambda: predictions() >= 32)
        second, err2 = run_until(lambda: client.lag("fraud-detection-job",
                                                    T.TRANSACTIONS) == 0)
        assert first["stopped_by"] == second["stopped_by"] == "SIGTERM"
        assert "graceful shutdown on SIGTERM" in err1
        assert "resumed from checkpoint" in err2
        assert first["scored"] + second["scored"] == 160
        assert second["counters"]["duplicates_skipped"] == 0
        assert first["counters"]["errors"] == second["counters"]["errors"] == 0
        for topic in (T.PREDICTIONS, T.ENRICHED):
            ids = Counter(r.value["transaction_id"] for r in
                          client.consumer([topic], "check").poll(1 << 20))
            assert len(ids) == 160 and set(ids.values()) == {1}, topic
        fired = Counter()
        for summary in (first, second):
            fired.update(summary["analytics"])
        from realtime_fraud_detection_tpu_torch.stream.windows import ANALYTICS_TOPIC

        for topic in set(ANALYTICS_TOPIC.values()):
            want = sum(fired[op] for op, t in ANALYTICS_TOPIC.items() if t == topic)
            assert sum(client.end_offsets(topic)) == want, topic
        router = _port("alert-router", "--broker", addr, "--once")
        out, err = router.communicate(timeout=120)
        alerts = sum(client.end_offsets(T.ALERTS))
        assert router.returncode == 0 and f"routed {alerts} alerts" in err
        assert len(out.strip().splitlines()) == alerts
        preds = client.consumer([T.PREDICTIONS], "check2").poll(1 << 20)
        assert alerts == sum(r.value["fraud_score"] > 0.7 for r in preds)
        import sqlite3

        db = sqlite3.connect(str(tmp_path / "meta.db"))
        assert db.execute("select status from jobs").fetchall() == [("FINISHED",)]
        assert db.execute("select count(*) from checkpoints").fetchone()[0] >= 3
        db.close()
        client.close()
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
