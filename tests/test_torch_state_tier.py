"""The port's shared RESP state tier against the JAX package's, on the CPU.

- RESP: a seeded command script (WRONGTYPE errors and a TTL expiry
  included) gives equal replies whichever package's client talks to
  whichever package's server; the same write script leaves byte-equal
  append-only files, each package loads the other's (a truncated tail
  too), eviction under one ``maxmemory`` takes the same victims in the same
  order, and a replica of either package follows a primary of the other
  and takes over on failover.
- The stores: the shared stores (``state/shared.py``), the in-process
  ``AggregationStore`` and ``VelocityStore.update_batch``, and the
  ``FeatureStore`` equal JAX's on one seeded stream, key by key.
- The scorer on the shared tier: a seeded 512-transaction stream through
  JAX's ``FraudScorer(state_client=...)`` and the port's
  ``TorchFraudScorer(state_client=..., device="cpu")`` on the same bridged
  models, each on its own package's server: decisions equal off a rung,
  scores within the JAX kernel drill's bf16 noise bound (``torch_bounds``),
  the two keyspaces equal key by key (each cached transaction's scores
  within that bound); the port's shared run equals its in-process run
  (predictions, velocity windows, cached transactions and lists).
- ``RTFD_STATE_BACKEND=redis`` with ``REDIS_HOST`` / ``REDIS_PORT``: the
  scorer connects, owns its client and ``close()`` releases it (both
  packages).
- The refusal of ``run-job --state ... --checkpoint-dir``, and its reason:
  a JAX host-state snapshot of a shared-tier scorer cannot be pickled.
- The commands at a toy size: ``state-server``, ``run-job --state --device
  cpu`` and ``serve --device cpu`` through ``RTFD_STATE_ADDR``.
- ``NativeTreeScorer``, built with g++: bit-equal to JAX's, within 1e-5 of
  the port's plain tree path.
"""

import torch_threads  # first: torch held to one CPU thread
import json
import pickle
import shutil
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from realtime_fraud_detection_tpu.models.trees import TreeEnsemble as JaxTreeEnsemble
from realtime_fraud_detection_tpu.scoring import FraudScorer
from realtime_fraud_detection_tpu.scoring import ScorerConfig as JaxScorerConfig
from realtime_fraud_detection_tpu.state import feature_store as jfs
from realtime_fraud_detection_tpu.state import resp as jresp
from realtime_fraud_detection_tpu.state import shared as jshared
from realtime_fraud_detection_tpu.state import stores as jstores
from realtime_fraud_detection_tpu.stream import InMemoryBroker as JaxInMemoryBroker
from realtime_fraud_detection_tpu.stream import JobConfig as JaxJobConfig
from realtime_fraud_detection_tpu.stream import StreamJob as JaxStreamJob
from realtime_fraud_detection_tpu.utils.config import Config as JaxConfig
from realtime_fraud_detection_tpu_torch.__main__ import main as port_main
from realtime_fraud_detection_tpu_torch.bridge import models_from_numpy
from realtime_fraud_detection_tpu_torch.checkpoint import (
    restore_scorer_host_state,
    snapshot_scorer_host_state,
)
from realtime_fraud_detection_tpu_torch.ensemble.combine import EnsembleParams
from realtime_fraud_detection_tpu_torch.scoring.pipeline import MODEL_NAMES, ScorerConfig
from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
from realtime_fraud_detection_tpu_torch.state import feature_store as pfs
from realtime_fraud_detection_tpu_torch.state import resp as presp
from realtime_fraud_detection_tpu_torch.state import shared as pshared
from realtime_fraud_detection_tpu_torch.state import stores as pstores
from realtime_fraud_detection_tpu_torch.stream import topics as T
from realtime_fraud_detection_tpu_torch.stream.job import JobConfig, StreamJob
from realtime_fraud_detection_tpu_torch.stream.transport import InMemoryBroker
from realtime_fraud_detection_tpu_torch.utils.config import Config
from test_torch_stream import _jax_models
from torch_bounds import near_rung, noise_bound

ROOT = Path(__file__).resolve().parents[1]
RESP = {"jax": jresp, "port": presp}
SHARED = {"jax": jshared, "port": pshared}
PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port")]     # client, server
FAR_FUTURE_MS = 4_102_444_800_000        # 2100-01-01, an absolute PEXPIREAT


# ------------------------------------------------------------------ helpers
def _server(pkg, **kw):
    return RESP[pkg].MiniRedisServer(**kw).start()


def _client(pkg, server, **kw):
    return RESP[pkg].RespClient(port=server.port, **kw)


def _run(client, script):
    """Each command's reply; an error reply as ("error", its text); a
    ("SLEEP", s) pseudo-command sleeps on the client."""
    out = []
    for cmd in script:
        if cmd[0] == "SLEEP":
            time.sleep(cmd[1])
            continue
        try:
            out.append(client.execute(*cmd))
        except (jresp.RespError, presp.RespError) as e:
            out.append(("error", str(e)))
    return out


def _dump(client):
    """The live keyspace: key -> ("string", bytes) / ("hash", dict) /
    ("list", [bytes])."""
    out = {}
    for key in sorted(client.keys("*")):
        for kind, cmd in (("string", ("GET", key)), ("hash", ("HGETALL", key)),
                          ("list", ("LRANGE", key, 0, -1))):
            try:
                out[key] = (kind, client.execute(*cmd))
                break
            except (jresp.RespError, presp.RespError):
                continue
    return out


def _command_script(seed, with_expiry=True):
    """A seeded mix of the server's commands over a few keys of each type:
    collisions between types give WRONGTYPE errors, a string INCR on a
    non-number an ERR, and with ``with_expiry`` a 30 ms PEXPIRE is read
    back after it expired."""
    rng = np.random.default_rng(seed)
    strings = [f"s{i}" for i in range(4)]
    hashes = [f"h{i}" for i in range(3)]
    lists = [f"l{i}" for i in range(3)]
    keys = strings + hashes + lists
    script = [("PING",), ("FLUSHDB",)]
    for _ in range(160):
        op = rng.integers(0, 18)
        s, h, lst = (strings[rng.integers(4)], hashes[rng.integers(3)],
                     lists[rng.integers(3)])
        any_key = keys[rng.integers(len(keys))]
        f = f"f{rng.integers(4)}"
        x = float(np.round(rng.normal(50, 40), 2))
        script.append([
            ("SET", s, f"v{rng.integers(100)}"),
            ("GET", any_key),
            ("SETNX", s, "nx"),
            ("INCR", any_key),
            ("INCRBYFLOAT", s, x),
            ("HSET", h, f, x, "g", "text"),
            ("HSETNX", h, f, "first"),
            ("HGET", any_key, f),
            ("HGETALL", any_key),
            ("HINCRBY", h, f, int(rng.integers(-3, 9))),
            ("HINCRBYFLOAT", h, "sum", x),
            ("HDEL", h, f),
            ("LPUSH", lst, f"a{rng.integers(50)}", "b"),
            ("RPUSH", any_key, "z"),
            ("LTRIM", lst, 0, int(rng.integers(1, 6))),
            ("LRANGE", any_key, 0, -1),
            ("LLEN", lst),
            ("EXISTS", any_key, s),
        ][op])
        if rng.random() < 0.05:
            script.append(("DEL", any_key))
    script += [("KEYS", "*"), ("KEYS", "h*"), ("DBSIZE",), ("TTL", "s0"),
               ("TTL", "missing"), ("SET", "long", "x", "EX", 3600), ("TTL", "long"),
               ("EXPIRE", "missing", 5), ("NOSUCH", "x")]
    if with_expiry:
        script += [("SET", "short", "v"), ("PEXPIRE", "short", 30),
                   ("EXISTS", "short"), ("SLEEP", 0.06), ("GET", "short"),
                   ("TTL", "short"), ("EXISTS", "short")]
    return script


def _write_script(seed):
    """A deterministic write script for the append-only file: no relative
    TTL (its absolute rewrite depends on the wall clock), a PEXPIREAT far in
    the future and one in the past, conditional writes that miss."""
    script = [c for c in _command_script(seed, with_expiry=False)
              if c[0] not in ("SET",) or len(c) == 3]
    return script + [("SET", "ttl", "t"), ("PEXPIREAT", "ttl", FAR_FUTURE_MS),
                     ("SET", "gone", "g"), ("PEXPIREAT", "gone", 1_000),
                     ("SETNX", "ttl", "again"), ("HSETNX", "h0", "g", "again")]


# --------------------------------------------------------------------- RESP
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("client_pkg,server_pkg", PAIRS,
                         ids=[f"{c}-client-{s}-server" for c, s in PAIRS])
def test_replies_equal_across_packages(client_pkg, server_pkg, seed):
    script = _command_script(seed)
    got, want = [], []
    for pkgs, sink in (((client_pkg, server_pkg), got), (("jax", "jax"), want)):
        server = _server(pkgs[1])
        client = _client(pkgs[0], server)
        try:
            sink.extend(_run(client, script))
        finally:
            client.close()
            server.stop()
    assert got == want
    errors = [r[1] for r in want if isinstance(r, tuple)]
    assert any(e.startswith("WRONGTYPE") for e in errors)
    assert any(e.startswith("ERR unknown command") for e in errors)
    assert want[-3:] == [None, -2, 0]          # the short key expired


def test_floats_keep_the_17_digit_form():
    server = _server("port")
    client = _client("port", server)
    try:
        total = 0.0
        for x in (0.1, 0.2, 1e-300, 123456.789, -7.25):
            total += x
            assert client.hincrbyfloat("h", "f", x) == total
            assert client.hget("h", "f") == f"{total:.17g}".encode()
    finally:
        client.close()
        server.stop()


@pytest.mark.parametrize("seed", [0, 1])
def test_aof_is_byte_equal_and_rewrites_alike(tmp_path, seed):
    script = _write_script(seed)
    paths = {}
    for pkg in ("jax", "port"):
        paths[pkg] = str(tmp_path / f"{pkg}.aof")
        server = _server(pkg, aof_path=paths[pkg])
        client = _client(pkg, server)
        try:
            _run(client, script)
        finally:
            client.close()
            server.stop()
    data = {pkg: Path(p).read_bytes() for pkg, p in paths.items()}
    assert data["port"] == data["jax"] and len(data["jax"]) > 1000
    for pkg, path in paths.items():
        server = _server(pkg, aof_path=path)
        server.rewrite_aof()
        server.stop()
    assert Path(paths["port"]).read_bytes() == Path(paths["jax"]).read_bytes()


@pytest.mark.parametrize("truncate", [0, 7], ids=["whole", "torn_tail"])
def test_each_package_loads_the_others_aof(tmp_path, truncate):
    script = _write_script(2)
    dumps = {}
    for writer in ("jax", "port"):
        path = tmp_path / f"{writer}.aof"
        server = _server(writer, aof_path=str(path))
        client = _client(writer, server)
        _run(client, script)
        client.close()
        server.stop()
        if truncate:
            path.write_bytes(path.read_bytes()[:-truncate])
        for reader in ("jax", "port"):
            server = _server(reader, aof_path=str(path))
            client = _client(reader, server)
            try:
                dumps[(writer, reader)] = _dump(client)
            finally:
                client.close()
                server.stop()
    first = dumps[("jax", "jax")]
    assert first and b"gone" not in first and first[b"ttl"] == ("string", b"t")
    assert all(d == first for d in dumps.values())


@pytest.mark.parametrize("policy", ["allkeys-lru", "noeviction"])
def test_eviction_takes_the_same_victims(tmp_path, policy):
    out = {}
    for pkg in ("jax", "port"):
        aof = tmp_path / f"{pkg}.aof"
        server = _server(pkg, maxmemory=6_000, policy=policy, aof_path=str(aof))
        client = _client(pkg, server)
        rng = np.random.default_rng(5)
        script = []
        for i in range(120):
            script.append(("SET", f"k{i}", "x" * int(rng.integers(10, 90))))
            script.append(("HSET", f"h{i % 7}", f"f{i}", "y" * 20))
            script.append(("GET", f"k{int(rng.integers(0, i + 1))}"))
        replies = _run(client, script)
        out[pkg] = (replies, _dump(client), server.used_memory, server.evicted_keys,
                    aof.read_bytes())
        client.close()
        server.stop()
    assert out["port"] == out["jax"]
    replies, dump, used, evicted, _ = out["jax"]
    if policy == "allkeys-lru":
        assert evicted > 0 and used <= 6_000 and len(dump) < 127
    else:
        assert evicted == 0 and any(isinstance(r, tuple) and r[1].startswith("OOM")
                                    for r in replies)


def _wait_for(pred, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


@pytest.mark.parametrize("primary_pkg,replica_pkg",
                         [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_replication_and_failover_across_packages(primary_pkg, replica_pkg):
    primary = _server(primary_pkg)
    cp = _client(primary_pkg, primary)
    cp.set("pre-sync", "snapshot-me")
    cp.hset("h", "f", "1")
    replica = _server(replica_pkg, replica_of=("127.0.0.1", primary.port))
    cr = _client(replica_pkg, replica)
    try:
        assert _wait_for(lambda: cr.get("pre-sync") == b"snapshot-me")
        cp.set("post-sync", "stream-me")
        cp.hincrby("h", "f", 4)
        cp.set("ttl-key", "x", ex=3600)
        cp.lpush("l", "a", "b")
        assert _wait_for(lambda: cr.hget("h", "f") == b"5")
        assert _wait_for(lambda: cr.lrange("l", 0, -1) == [b"b", b"a"])
        assert cr.execute("TTL", "ttl-key") > 3000
        assert cr.info()["role"] == "slave"
        with pytest.raises((jresp.RespError, presp.RespError), match="READONLY"):
            cr.set("nope", "1")
        assert _dump(cr) == _dump(cp)
        cp.close()
        primary.stop()
        replica.promote()
        assert _wait_for(lambda: cr.info()["role"] == "master")
        cr.set("after-failover", "1")
        assert cr.get("after-failover") == b"1" and cr.get("post-sync") == b"stream-me"
    finally:
        cr.close()
        replica.stop()


# ------------------------------------------------------------------- stores
def _stream(n=200, seed=13):
    gen = TransactionGenerator(num_users=25, num_merchants=9, seed=seed)
    records = gen.generate_batch(n)
    for i, r in enumerate(records):
        r["fraud_score"] = float(np.round((i * 37 % 100) / 100.0, 2))
    return gen, records


def test_shared_stores_equal_jax_on_a_seeded_stream():
    gen, records = _stream()
    dumps, reads = {}, {}
    for pkg in ("jax", "port"):
        server = _server(pkg)
        client = _client(pkg, server)
        sh = SHARED[pkg]
        try:
            profiles = sh.SharedProfileStore(client)
            profiles.seed(gen.users.profiles(), gen.merchants.profiles())
            velocity = sh.SharedVelocityStore(client)
            cache = sh.SharedTransactionCache(client, user_list_len=5,
                                              merchant_list_len=7)
            agg = sh.SharedAggregationStore(client)
            for i, r in enumerate(records):
                now = 1000.0 + i
                velocity.update_batch([r["user_id"]], [r["amount"]], now)
                cache.cache_transaction(r, now=now)
                cache.store_features(r["transaction_id"], [float(i), 0.5], now=now)
                agg.record(r, now=now)
            users = sorted({r["user_id"] for r in records})
            reads[pkg] = (
                [velocity.get_all(u) for u in users],
                [cache.get_user_transactions(u) for u in users],
                [profiles.get_user(u) for u in users],
                cache.get_transaction(records[-1]["transaction_id"]),
                cache.get_features(records[3]["transaction_id"]),
                [agg.get(k.decode()[4:]) for k in sorted(client.keys("agg:*"))])
            dumps[pkg] = _dump(client)
        finally:
            client.close()
            server.stop()
    assert dumps["port"] == dumps["jax"]
    assert reads["port"] == reads["jax"]
    assert any(k.startswith(b"velocity:") for k in dumps["jax"])


def test_in_process_stores_equal_jax():
    _, records = _stream()
    got_v, want_v = pstores.VelocityStore(), jstores.VelocityStore()
    got_a, want_a = pstores.AggregationStore(), jstores.AggregationStore()
    for i in range(0, len(records), 16):
        chunk = records[i:i + 16]
        now = 1000.0 + 60.0 * i
        for store in (got_v, want_v):
            store.update_batch([r["user_id"] for r in chunk],
                               [r["amount"] for r in chunk], now)
        for r in chunk:
            got_a.record(r, now=now)
            want_a.record(r, now=now)
    assert got_v.entries() == want_v.entries()
    assert got_a._backend._data.keys() == want_a._backend._data.keys()
    for key in want_a._backend._data:
        assert got_a.get(key[4:], now=1e4) == want_a.get(key[4:], now=1e4)


def test_feature_store_equals_jax():
    _, records = _stream(60)
    stores = {"port": pfs.FeatureStore(), "jax": jfs.FeatureStore()}
    out = {}
    for pkg, fs in stores.items():
        fs.register_feature("amount", "NUMERICAL", "txn amount", now=1.0)
        fs.register_feature("amount", "NUMERICAL", "re-registered",
                            properties={"unit": "usd"}, now=2.0)
        fs.register_feature("transaction_type", "CATEGORICAL", now=3.0)
        with pytest.raises(ValueError, match="unknown feature type"):
            fs.register_feature("x", "VECTOR")
        for i, r in enumerate(records):
            fs.store_feature_values(r["user_id"], "user", {
                "amount": r["amount"], "transaction_type": r["transaction_type"],
                "is_online": bool(i % 3), "note": None}, now=10.0 + i)
        users = sorted({r["user_id"] for r in records})
        out[pkg] = (fs.get_metadata("amount"), sorted(fs.registered_features()),
                    fs.get_batch_feature_values(users, "user", now=20.0),
                    fs.get_selected_features(users[0], "user", ["amount"], now=20.0),
                    fs.get_feature_values(users[0], "user", now=1e6),
                    [fs.get_feature_statistics(n) for n in
                     ("amount", "transaction_type", "is_online", "note", "absent")],
                    fs.all_statistics(), fs.health())
    assert out["port"] == out["jax"]
    assert out["jax"][5][0]["std"] > 0 and out["jax"][4] == {}


# ------------------------------------------------- the scorer on the tier
SCORER_TXNS, SCORER_BATCH, SCORER_NOW = 512, 128, 1000.0


def _drive_job(job, broker, records, topic_mod):
    broker.produce_batch(topic_mod.TRANSACTIONS, records,
                         key_fn=lambda r: str(r["user_id"]))
    n = job.run_until_drained(now=SCORER_NOW)
    preds = [r.value for r in broker.consumer([topic_mod.PREDICTIONS], "check")
             .poll(1 << 20)]
    return n, dict(job.counters), preds


@pytest.fixture(scope="module")
def scorer_runs():
    from realtime_fraud_detection_tpu.stream import topics as JT

    jax_models = _jax_models()
    gen = TransactionGenerator(num_users=120, num_merchants=40, seed=17)
    profiles = (gen.users.profiles(), gen.merchants.profiles())
    records = gen.generate_batch(SCORER_TXNS)
    out = {"records": records}
    servers = {pkg: _server(pkg) for pkg in ("jax", "port")}
    try:
        # JAX on its own server
        jc = _client("jax", servers["jax"])
        tokens = []
        js = FraudScorer(models=jax_models, scorer_config=JaxScorerConfig(text_len=32),
                         state_client=jc)
        assemble = js.assemble

        def keep_tokens(*a, **k):
            batch = assemble(*a, **k)
            tokens.append((np.asarray(batch.token_ids), np.asarray(batch.token_mask)))
            return batch

        js.assemble = keep_tokens
        js.seed_profiles(*profiles)
        jb = JaxInMemoryBroker()
        out["jax"] = _drive_job(JaxStreamJob(jb, js, JaxJobConfig(
            max_batch=SCORER_BATCH, max_delay_ms=1.0)), jb, records, JT)
        out["jax_keys"] = _dump(jc)
        out["jax_snapshot_error"] = None
        from realtime_fraud_detection_tpu.checkpoint import (
            snapshot_scorer_host_state as jax_snapshot,
        )
        try:
            pickle.dumps(jax_snapshot(js))
        except TypeError as e:
            out["jax_snapshot_error"] = str(e)
        jc.close()
        weights = EnsembleParams.from_config(Config(), MODEL_NAMES).weights.numpy()
        out["bound"] = noise_bound(jax_models.bert, tokens, weights, np.ones(5, bool))
        # the port, on its own server and in process
        for name, client in (("port", _client("port", servers["port"])), ("local", None)):
            ps = TorchFraudScorer(models=models_from_numpy(jax_models),
                                  scorer_config=ScorerConfig(text_len=32),
                                  device="cpu", state_client=client)
            ps.seed_profiles(*profiles)
            pb = InMemoryBroker()
            out[name] = _drive_job(StreamJob(pb, ps, JobConfig(
                max_batch=SCORER_BATCH, max_delay_ms=1.0)), pb, records, T)
            out[f"{name}_scorer"] = ps
            if client is not None:
                out["port_keys"] = _dump(client)
                out["port_client"] = client
        yield out
        out["port_client"].close()
    finally:
        for server in servers.values():
            server.stop()


def _strip(pred):
    return {k: v for k, v in pred.items() if k != "processing_time_ms"}


def test_shared_tier_scorer_decisions_match_jax(scorer_runs):
    n, counters, preds = scorer_runs["port"]
    jn, jcounters, jpreds = scorer_runs["jax"]
    bound = scorer_runs["bound"]
    assert n == jn == SCORER_TXNS and counters == jcounters
    assert counters["errors"] == 0 and counters["batches"] == SCORER_TXNS // SCORER_BATCH
    assert [p["transaction_id"] for p in preds] == [q["transaction_id"] for q in jpreds]
    assert 1e-4 <= bound <= 1e-3
    prob = np.array([q["fraud_probability"] for q in jpreds])
    conf = np.array([q["confidence"] for q in jpreds])
    near = near_rung(prob, bound) | near_rung(conf, bound)
    assert int(near.sum()) == 1          # rows skipped near a rung
    for p, q, skip in zip(preds, jpreds, near):
        if not skip:
            assert (p["decision"], p["risk_level"]) == (q["decision"], q["risk_level"])
    np.testing.assert_allclose([p["fraud_score"] for p in preds],
                               [q["fraud_score"] for q in jpreds], rtol=0, atol=bound)


def test_shared_tier_keyspace_equals_jax(scorer_runs):
    got, want = scorer_runs["port_keys"], scorer_runs["jax_keys"]
    bound = scorer_runs["bound"]
    assert got.keys() == want.keys()
    kinds = {k.split(b":")[0] for k in want}
    assert kinds == {b"user", b"merchant", b"velocity", b"transaction",
                     b"user_transactions", b"merchant_transactions"}
    n_txn = 0
    for key, (kind, value) in want.items():
        if not key.startswith(b"transaction:"):
            assert got[key] == (kind, value), key
            continue
        n_txn += 1
        mine, theirs = json.loads(got[key][1]), json.loads(value)
        assert mine.keys() == theirs.keys()
        near = near_rung([theirs["fraud_score"]], bound)[0] or \
            near_rung([theirs["confidence"]], bound)[0]
        for field in ("fraud_score", "confidence"):
            assert abs(mine.pop(field) - theirs.pop(field)) <= bound, (key, field)
        if near:                # the one row near a rung: its ladder may differ
            for field in ("decision", "risk_level"):
                mine.pop(field), theirs.pop(field)
        assert mine == theirs, key
    assert n_txn == SCORER_TXNS


def test_shared_tier_run_equals_the_in_process_run(scorer_runs):
    shared, local = scorer_runs["port"], scorer_runs["local"]
    assert shared[:2] == local[:2]
    assert [_strip(p) for p in shared[2]] == [_strip(p) for p in local[2]]
    keys = scorer_runs["port_keys"]
    loc = scorer_runs["local_scorer"]
    windows = {}
    for uid, window, count, amount, start in loc.velocity.entries():
        windows[f"velocity:{uid}:{window}".encode()] = ("hash", [
            b"timestamp", repr(start).encode(), b"count", str(int(count)).encode(),
            b"amount", f"{amount:.17g}".encode()])
    assert {k: v for k, v in keys.items() if k.startswith(b"velocity:")} == windows
    cached = dict(loc.txn_cache.entries(now=SCORER_NOW))
    assert len(cached) == SCORER_TXNS
    for tid, txn in cached.items():
        assert json.loads(keys[f"transaction:{tid}".encode()][1]) == json.loads(
            json.dumps(txn))
        uid = str(txn["user_id"])
        assert keys[f"user_transactions:{uid}".encode()] == (
            "list", [t.encode() for t in loc.txn_cache.get_user_transactions(uid)])


def test_shared_tier_snapshot_is_refused_with_the_reason(scorer_runs):
    # the reason for the refusal: JAX's snapshot holds the client's socket
    assert "socket" in scorer_runs["jax_snapshot_error"]
    with pytest.raises(ValueError, match="live on the shared state server"):
        snapshot_scorer_host_state(scorer_runs["port_scorer"])
    # a restore into a shared-tier scorer keeps reading the server
    shared, local = scorer_runs["port_scorer"], scorer_runs["local_scorer"]
    stores = (shared.profiles, shared.velocity, shared.txn_cache)
    restore_scorer_host_state(shared, snapshot_scorer_host_state(local))
    assert (shared.profiles, shared.velocity, shared.txn_cache) == stores
    assert shared.history is local.history


def test_run_job_refuses_state_with_checkpoint_dir(tmp_path, capsys):
    rc = port_main(["run-job", "--state", "127.0.0.1:1", "--checkpoint-dir",
                    str(tmp_path), "--count", "8", "--device", "cpu"])
    assert rc == 2
    err = capsys.readouterr().err
    assert "--state with --checkpoint-dir refused" in err and "--aof" in err
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_scorer_connects_shared_tier_from_config_env(monkeypatch, pkg):
    server = _server(pkg)
    try:
        monkeypatch.setenv("RTFD_STATE_BACKEND", "redis")
        monkeypatch.setenv("REDIS_HOST", "127.0.0.1")
        monkeypatch.setenv("REDIS_PORT", str(server.port))
        gen = TransactionGenerator(num_users=12, num_merchants=6, seed=8)
        if pkg == "jax":
            cfg = JaxConfig()
            scorer = FraudScorer(config=cfg)
        else:
            cfg = Config()
            scorer = TorchFraudScorer(config=cfg, device="cpu")
        assert (cfg.state.backend, cfg.state.redis_port) == ("redis", server.port)
        assert isinstance(scorer.profiles, SHARED[pkg].SharedProfileStore)
        assert scorer._owned_state_client is not None
        scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
        assert len(scorer.score_batch(gen.generate_batch(4), now=5.0)) == 4
        client = scorer._owned_state_client
        scorer.close()
        assert scorer._owned_state_client is None
        with pytest.raises(OSError):
            client.ping()
        probe = _client(pkg, server)
        assert probe.keys("velocity:*") and probe.keys("transaction:*")
        probe.close()
    finally:
        server.stop()
    monkeypatch.delenv("RTFD_STATE_BACKEND")
    assert Config().state.backend == JaxConfig().state.backend == "memory"


STATE_ENV = ["RTFD_RTFD_STATE_BACKEND", "RTFD_STATE_BACKEND", "STATE_BACKEND",
             "RTFD_REDIS_HOST", "REDIS_HOST", "RTFD_REDIS_PORT", "REDIS_PORT"]


@pytest.mark.parametrize("setting", [
    {},
    {"RTFD_STATE_BACKEND": "redis", "REDIS_HOST": "10.0.0.7", "REDIS_PORT": "6380"},
    # the prefixed name wins; a plain STATE_BACKEND is not read (JAX's lookup)
    {"RTFD_REDIS_HOST": "a", "REDIS_HOST": "b", "STATE_BACKEND": "redis"},
    {"RTFD_RTFD_STATE_BACKEND": "redis", "RTFD_STATE_BACKEND": "memory"},
], ids=["unset", "redis", "prefixed_wins", "double_prefix"])
def test_state_config_follows_the_environment_like_jax(monkeypatch, setting):
    import dataclasses

    for name in STATE_ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in setting.items():
        monkeypatch.setenv(name, value)
    got, want = Config().state, JaxConfig().state
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ----------------------------------------------------------------- commands
def _proc(args, env=None):
    return subprocess.Popen(
        [sys.executable, "-m", "realtime_fraud_detection_tpu_torch", *args],
        cwd=ROOT, env=torch_threads.spawn_env(**(env or {})), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_state_server_run_job_and_serve_share_state(tmp_path):
    port, http_port = _free_port(), _free_port()
    config = tmp_path / "serve.json"
    config.write_text(json.dumps({"monitoring": {"prometheus_port": 0}}))
    procs = [_proc(["state-server", "--host", "127.0.0.1", "--port", str(port),
                    "--aof", str(tmp_path / "state.aof")])]
    try:
        client = None
        for _ in range(100):
            try:
                client = presp.RespClient(port=port)
                break
            except OSError:
                time.sleep(0.1)
        assert client is not None and client.ping()
        sim = ["--users", "20", "--merchants", "8", "--seed", "4"]
        job = subprocess.run(
            [sys.executable, "-m", "realtime_fraud_detection_tpu_torch", "run-job",
             "--state", f"127.0.0.1:{port}", "--count", "48", "--batch", "16",
             "--device", "cpu", *sim], cwd=ROOT, capture_output=True, text=True,
            timeout=120, env=torch_threads.spawn_env())
        assert job.returncode == 0, job.stderr
        summary = json.loads(job.stdout.strip().splitlines()[-1])
        assert summary["scored"] == 48 and summary["counters"]["errors"] == 0
        records = TransactionGenerator(num_users=20, num_merchants=8,
                                       seed=4).generate_batch(48)
        want = {}
        for r in records:
            want[r["user_id"]] = want.get(r["user_id"], 0) + 1

        def counts():
            return {u: int(client.hget(f"velocity:{u}:24hour", "count") or 0)
                    for u in want}

        assert counts() == want
        procs.append(_proc(["serve", "--host", "127.0.0.1", "--port", str(http_port),
                            "--config", str(config), "--device", "cpu"],
                           env={"RTFD_STATE_ADDR": f"127.0.0.1:{port}"}))
        url = f"http://127.0.0.1:{http_port}"
        for _ in range(300):
            try:
                urllib.request.urlopen(url + "/health", timeout=2).read()
                break
            except OSError:
                time.sleep(0.1)
        extra = TransactionGenerator(num_users=20, num_merchants=8,
                                     seed=5).generate_batch(6)
        for txn in extra:
            txn["user_id"] = records[0]["user_id"]
            req = urllib.request.Request(url + "/predict", data=json.dumps(txn).encode(),
                                         headers={"Content-Type": "application/json"})
            assert json.loads(urllib.request.urlopen(req, timeout=60).read())[
                "transaction_id"] == txn["transaction_id"]
        want[records[0]["user_id"]] += len(extra)
        assert counts() == want
    finally:
        if client is not None:
            client.close()
        for p in procs:
            p.terminate()
        errs = [p.communicate(timeout=30)[1] for p in procs]
    assert "listening on 127.0.0.1" in errs[0]
    assert f"using shared state tier at 127.0.0.1:{port}" in errs[1]


# --------------------------------------------------------- native trees
@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
def test_native_tree_scorer_equals_jax_and_the_plain_path():
    from realtime_fraud_detection_tpu.native import NativeTreeScorer as JaxNative
    from realtime_fraud_detection_tpu_torch import native
    from realtime_fraud_detection_tpu_torch.models.trees import (
        TreeEnsemble,
        tree_ensemble_logits,
    )

    assert native.native_trees_available()
    assert (ROOT / "build" / "native") in native.native_trees_library_path().parents
    rng = np.random.default_rng(21)
    depth, n_trees = 5, 24
    arrays = dict(
        feature=rng.integers(0, 64, (n_trees, 2 ** depth - 1)).astype(np.int32),
        threshold=rng.normal(0.0, 1.0, (n_trees, 2 ** depth - 1)).astype(np.float32),
        leaf=rng.normal(0.0, 0.3, (n_trees, 2 ** depth)).astype(np.float32),
        base_score=np.float32(-0.2))
    x = rng.normal(0.0, 1.0, (300, 64)).astype(np.float32)
    ens = TreeEnsemble(**{k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()})
    got = native.NativeTreeScorer(ens, n_threads=4).logits(x)
    want = JaxNative(JaxTreeEnsemble(**arrays), n_threads=4).logits(x)
    np.testing.assert_array_equal(got, want)
    plain = tree_ensemble_logits(ens, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(native.NativeTreeScorer(ens, n_threads=1).logits(x), got)
    with pytest.raises(ValueError, match="features"):
        native.NativeTreeScorer(ens).logits(x[:, :3])
