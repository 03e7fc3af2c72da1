"""The port's device pool (``scoring/device_pool.py``), its drill
(``scoring/pool_drill.py``) and the pool's fault injectors
(``chaos/faults.py``) against the JAX package's, on the CPU.

- Pooled scoring: the same seeded stream through JAX's ``FraudScorer`` with a
  ``DevicePool`` over two virtual CPU devices and the port's
  ``TorchFraudScorer`` (bridged models) with a pool of replicas on the CPU:
  decisions equal off a rung, scores within the JAX kernel drill's bf16
  noise bound (``torch_bounds``); inside the port, pooled equals unpooled
  bit for bit at 1, 2 and 4 replicas under the same in-flight window.
- The pool's contract, mirroring JAX ``tests/test_device_pool.py``: FIFO and
  the rotation, the rescue on a healthy replica (and with every replica at
  full depth), all replicas dead raises, the QoS step with batches in
  flight, the hot swap, a slow replica keeping FIFO, ``revive`` clearing
  armed faults, ``total_slots``; the job and the service with the pool on.
- The per-batch launch count under concurrent dispatch: two threads, each
  batch's count its own.
- ``pool-drill --fast --device cpu``: the verdict equals JAX's drill.
- The fault plan: ``DeviceReplicaDeath`` / ``SlowDevice`` windows on the
  port's pool, the plan's snapshot equal to JAX's on the same timeline.
- The modules import with JAX blocked.
"""

import json
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from realtime_fraud_detection_tpu.chaos import faults as jfaults
from realtime_fraud_detection_tpu.obs.metrics import MetricsCollector as JaxMetricsCollector
from realtime_fraud_detection_tpu.scoring import DevicePool as JaxDevicePool
from realtime_fraud_detection_tpu.scoring import FraudScorer
from realtime_fraud_detection_tpu.scoring import ScorerConfig as JaxScorerConfig
from realtime_fraud_detection_tpu.scoring import pool_drill as jpool_drill
from realtime_fraud_detection_tpu_torch import ops
from realtime_fraud_detection_tpu_torch.__main__ import main as port_main
from realtime_fraud_detection_tpu_torch.bridge import models_from_numpy
from realtime_fraud_detection_tpu_torch.chaos import faults as pfaults
from realtime_fraud_detection_tpu_torch.ensemble.combine import EnsembleParams
from realtime_fraud_detection_tpu_torch.obs.metrics import MetricsCollector
from realtime_fraud_detection_tpu_torch.ops import build as ops_build
from realtime_fraud_detection_tpu_torch.scoring import scorer as scorer_module
from realtime_fraud_detection_tpu_torch.scoring.device_pool import DevicePool
from realtime_fraud_detection_tpu_torch.scoring.pipeline import (
    MODEL_NAMES,
    ScorerConfig,
    init_scoring_models,
)
from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
from realtime_fraud_detection_tpu_torch.stream import topics as T
from realtime_fraud_detection_tpu_torch.stream.job import JobConfig, StreamJob
from realtime_fraud_detection_tpu_torch.stream.transport import InMemoryBroker
from realtime_fraud_detection_tpu_torch.utils.config import Config
from test_torch_stream import _jax_models
from torch_bounds import near_rung, noise_bound

ROOT = Path(__file__).resolve().parents[1]
BATCH = 16
NOW = 1000.0


def make_scorer(seed=3, model_seed=0, models=None, **kw):
    gen = TransactionGenerator(num_users=300, num_merchants=60, seed=seed)
    s = TorchFraudScorer(models=models, seed=model_seed, device="cpu", **kw)
    s.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    return gen, s


@pytest.fixture
def pooled():
    gen, scorer = make_scorer()
    pool = DevicePool(scorer, devices=["cpu"] * 4, inflight_depth=2)
    return gen, scorer, pool


def _run(scorer, batches, window):
    """Dispatch / finalize with at most ``window`` batches in flight."""
    out, inflight = [], []
    for b in batches:
        inflight.append(scorer.dispatch(b, now=NOW))
        while len(inflight) >= window:
            out.append(scorer.finalize(inflight.pop(0), now=NOW))
    while inflight:
        out.append(scorer.finalize(inflight.pop(0), now=NOW))
    return out


def _rows(results):
    return [(r["transaction_id"], r["fraud_probability"], r["confidence"],
             r["decision"], r["risk_level"]) for b in results for r in b]


# ------------------------------------------------------------ against JAX
@pytest.fixture(scope="module")
def jax_parity():
    jax_models = _jax_models()
    gen = TransactionGenerator(num_users=200, num_merchants=50, seed=21)
    profiles = (gen.users.profiles(), gen.merchants.profiles())
    batches = [gen.generate_batch(32) for _ in range(4)]
    js = FraudScorer(models=jax_models, scorer_config=JaxScorerConfig(text_len=32))
    tokens = []
    assemble = js.assemble

    def keep(*a, **k):
        batch = assemble(*a, **k)
        tokens.append((np.asarray(batch.token_ids), np.asarray(batch.token_mask)))
        return batch

    js.assemble = keep
    js.seed_profiles(*profiles)
    jpool = JaxDevicePool(js, devices=jax.devices()[:2], inflight_depth=2)
    want = _run(js, batches, jpool.total_slots())
    ps = TorchFraudScorer(models=models_from_numpy(jax_models),
                          scorer_config=ScorerConfig(text_len=32), device="cpu")
    ps.seed_profiles(*profiles)
    pool = DevicePool(ps, devices=["cpu"] * 2, inflight_depth=2)
    got = _run(ps, batches, pool.total_slots())
    weights = EnsembleParams.from_config(Config(), MODEL_NAMES).weights.numpy()
    bound = noise_bound(jax_models.bert, tokens, weights, np.ones(5, bool))
    return dict(got=got, want=want, bound=bound, pool=pool, jpool=jpool)


def test_pooled_scores_match_jax_pooled(jax_parity):
    got = [r for b in jax_parity["got"] for r in b]
    want = [r for b in jax_parity["want"] for r in b]
    bound = jax_parity["bound"]
    assert [r["transaction_id"] for r in got] == [r["transaction_id"] for r in want]
    prob = np.array([r["fraud_probability"] for r in want])
    conf = np.array([r["confidence"] for r in want])
    near = near_rung(prob, bound) | near_rung(conf, bound)
    assert int(near.sum()) == 0
    for p, q in zip(got, want):
        assert (p["decision"], p["risk_level"]) == (q["decision"], q["risk_level"])
    np.testing.assert_allclose([p["fraud_score"] for p in got],
                               [q["fraud_score"] for q in want], rtol=0, atol=bound)


def test_pool_schedule_and_stats_equal_jax(jax_parity):
    got, want = jax_parity["pool"].stats(), jax_parity["jpool"].stats()
    keys = ("dispatched", "completed", "inflight", "retries", "failures", "healthy",
            "index")
    assert [{k: d[k] for k in keys} for d in got["devices"]] == \
        [{k: d[k] for k in keys} for d in want["devices"]]
    for k in ("n_devices", "healthy", "inflight_depth", "dispatched", "completed",
              "retries"):
        assert got[k] == want[k], k
    assert list(jax_parity["pool"].assignment_log) == \
        list(jax_parity["jpool"].assignment_log)


# ------------------------------------------------------- inside the port
@pytest.mark.parametrize("replicas", [1, 2, 4])
def test_pooled_bit_equal_to_unpooled(replicas):
    gen_a, serial = make_scorer()
    gen_b, pooled_scorer = make_scorer()
    pool = DevicePool(pooled_scorer, devices=["cpu"] * replicas, inflight_depth=2)
    window = pool.total_slots()
    ref = _run(serial, [gen_a.generate_batch(BATCH) for _ in range(6)], window)
    got = _run(pooled_scorer, [gen_b.generate_batch(BATCH) for _ in range(6)], window)
    assert _rows(got) == _rows(ref)
    assert pool.stats()["completed"] == 6


def test_round_robin_and_fifo(pooled):
    gen, scorer, pool = pooled
    batches = [gen.generate_batch(BATCH) for _ in range(8)]
    pend = [scorer.dispatch(b, now=NOW) for b in batches]
    results = [scorer.finalize(p, now=NOW) for p in pend]
    got = [r["transaction_id"] for batch in results for r in batch]
    assert got == [str(r["transaction_id"]) for b in batches for r in b]
    st = pool.stats()
    assert [d["dispatched"] for d in st["devices"]] == [2] * 4
    assert st["completed"] == 8 and st["retries"] == 0
    assert list(pool.assignment_log) == [0, 1, 2, 3] * 2
    assert [d["device"] for d in st["devices"]] == [f"cpu#{i}" for i in range(4)]


def test_replicas_on_one_device_share_parameter_tensors(pooled):
    _, scorer, pool = pooled
    placed = pool._models
    assert list(placed) == [torch.device("cpu")]
    assert placed[torch.device("cpu")].models is scorer.models


def test_device_loss_mid_flight_retries_on_healthy(pooled):
    gen, scorer, pool = pooled
    pend = scorer.dispatch(gen.generate_batch(BATCH), now=NOW)
    victim = pend.pool_token.replica_idx
    pool.inject_fault(victim, 1)
    res = scorer.finalize(pend, now=NOW)
    assert len(res) == BATCH and all(np.isfinite(r["fraud_probability"]) for r in res)
    st = pool.stats()
    assert st["healthy"] == len(pool) - 1 and not st["devices"][victim]["healthy"]
    assert st["devices"][victim]["failures"] == 1 and st["retries"] == 1
    assert pend.pool_token.replica_idx != victim
    p2 = scorer.dispatch(gen.generate_batch(BATCH), now=NOW)
    assert p2.pool_token.replica_idx != victim
    scorer.finalize(p2, now=NOW)
    pool.revive(victim)
    assert pool.stats()["healthy"] == len(pool)


def test_rescued_batch_equals_its_fault_free_twin():
    """The relaunch runs from the token's host blob copies: the rescued
    batch's rows are bit-equal to the same batch with no fault."""
    outs = []
    for fault in (False, True):
        gen, scorer = make_scorer()
        pool = DevicePool(scorer, devices=["cpu"] * 2, inflight_depth=2)
        pend = [scorer.dispatch(gen.generate_batch(BATCH), now=NOW) for _ in range(2)]
        if fault:
            pool.inject_fault(0, 1)
        outs.append([scorer.finalize(p, now=NOW) for p in pend])
        assert pool.stats()["retries"] == int(fault)
    assert _rows(outs[0]) == _rows(outs[1])


def test_retry_with_all_replicas_at_full_depth(pooled):
    gen, scorer, pool = pooled
    window = pool.total_slots()
    pend = [scorer.dispatch(gen.generate_batch(BATCH), now=NOW) for _ in range(window)]
    pool.inject_fault(pend[0].pool_token.replica_idx, 1)
    results = [scorer.finalize(p, now=NOW) for p in pend]
    assert all(len(r) == BATCH for r in results)
    st = pool.stats()
    assert st["retries"] == 1 and st["completed"] == window


def test_all_replicas_dead_raises(pooled):
    gen, scorer, pool = pooled
    pend = scorer.dispatch(gen.generate_batch(BATCH), now=NOW)
    for i in range(len(pool)):
        pool.inject_fault(i, 2)
    with pytest.raises(RuntimeError):
        pool.wait(pend.pool_token)
    with pytest.raises(RuntimeError, match="no healthy replicas"):
        scorer.dispatch(gen.generate_batch(BATCH), now=NOW)


def test_qos_ladder_transition_with_batches_in_flight(pooled):
    gen, scorer, pool = pooled
    pend_full = scorer.dispatch(gen.generate_batch(BATCH), now=NOW)
    scorer.set_degradation(np.array([True, False, False, False, True]), level=2)
    pend_deg = [scorer.dispatch(gen.generate_batch(BATCH), now=NOW) for _ in range(4)]
    res_full = scorer.finalize(pend_full, now=NOW)
    res_deg = [scorer.finalize(p, now=NOW) for p in pend_deg]
    assert set(res_full[0]["model_predictions"]) == set(MODEL_NAMES)
    for batch_res in res_deg:
        for r in batch_res:
            assert set(r["model_predictions"]) == {"xgboost_primary", "isolation_forest"}
    scorer.set_degradation(None)
    for p in [scorer.dispatch(gen.generate_batch(BATCH), now=NOW) for _ in range(2)]:
        for r in scorer.finalize(p, now=NOW):
            assert len(r["model_predictions"]) == 5


def test_hot_swap_fans_out_to_all_replicas(pooled):
    gen, scorer, pool = pooled
    recs = [gen.generate_batch(BATCH) for _ in range(len(pool) + 1)]
    before = scorer.score_batch(recs[0], now=NOW)
    in_flight = scorer.dispatch(recs[0], now=NOW)
    old_models = scorer.models
    scorer.set_models(init_scoring_models(99, scorer.bert_config,
                                          feature_dim=scorer.sc.feature_dim,
                                          node_dim=scorer.sc.node_dim))
    # the batch in flight keeps what it launched with
    assert in_flight.pool_token.launched_with[0] is old_models
    scorer.finalize(in_flight, now=NOW)
    pend = [scorer.dispatch(b, now=NOW) for b in recs[1:]]
    assert len({p.pool_token.replica_idx for p in pend}) > 1
    assert all(p.pool_token.launched_with[0] is scorer.models for p in pend)
    results = [scorer.finalize(p, now=NOW) for p in pend]
    assert all(len(r) == BATCH for r in results)
    assert any(b["fraud_probability"] != a["fraud_probability"]
               for b, a in zip(before, results[0]))


def test_total_slots_tracks_health(pooled):
    _, _, pool = pooled
    assert pool.total_slots() == len(pool) * 2
    pool.replicas[0].healthy = False
    assert pool.total_slots() == (len(pool) - 1) * 2


def test_slow_replica_keeps_fifo(pooled):
    gen, scorer, pool = pooled
    batches = [gen.generate_batch(BATCH) for _ in range(len(pool))]
    pend = [scorer.dispatch(b, now=NOW) for b in batches]
    victim = pend[0].pool_token.replica_idx
    pool.inject_slow(victim, 0.05, n=1)
    t0 = time.monotonic()
    results = [scorer.finalize(p, now=NOW) for p in pend]
    assert time.monotonic() - t0 >= 0.05
    got = [r["transaction_id"] for batch in results for r in batch]
    assert got == [str(r["transaction_id"]) for b in batches for r in b]
    st = pool.stats()
    assert st["retries"] == 0 and st["healthy"] == len(pool)
    assert st["devices"][victim]["failures"] == 0 and pool.replicas[victim].slow_next == 0


def test_revive_clears_armed_faults(pooled):
    gen, scorer, pool = pooled
    pool.inject_fault(0, 3)
    pool.inject_slow(0, 5.0, n=4)
    pool.revive(0)
    assert pool.replicas[0].fail_next == 0 and pool.replicas[0].slow_next == 0
    pend = [scorer.dispatch(gen.generate_batch(BATCH), now=NOW) for _ in range(len(pool))]
    assert 0 in {p.pool_token.replica_idx for p in pend}
    for p in pend:
        assert len(scorer.finalize(p, now=NOW)) == BATCH
    st = pool.stats()
    assert st["retries"] == 0 and st["healthy"] == len(pool)


def test_pool_metrics_mirror_equals_jax(pooled):
    gen, scorer, pool = pooled
    pend = scorer.dispatch(gen.generate_batch(BATCH), now=NOW)
    pool.inject_fault(pend.pool_token.replica_idx, 1)
    scorer.finalize(pend, now=NOW)
    stats = pool.stats()
    port, ref = MetricsCollector(), JaxMetricsCollector()
    for _ in range(2):              # a second sync with the same stats adds 0
        port.sync_device_pool(stats)
        ref.sync_device_pool(stats)
    assert port.pool_retries.total() == 1 and port.pool_healthy.value() == len(pool) - 1

    def lines(text):
        return [ln for ln in text.splitlines() if "device_pool_" in ln]

    assert lines(port.render_prometheus()) == lines(ref.render_prometheus())
    assert len(lines(port.render_prometheus())) > 12


def test_traced_pooled_dispatch_annotates_replica_and_depth(pooled):
    from realtime_fraud_detection_tpu_torch.obs.tracing import Tracer
    from realtime_fraud_detection_tpu_torch.utils.config import TracingSettings

    gen, scorer, pool = pooled
    tracer = Tracer(TracingSettings(enabled=True))
    pend = []
    for _ in range(6):
        b = gen.generate_batch(BATCH)
        tb = tracer.batch([tracer.begin(str(r["transaction_id"])) for r in b],
                          batch_size=len(b))
        pend.append(scorer.dispatch(b, now=NOW, trace=tb))
    for p in pend:
        scorer.finalize(p, now=NOW)
        tracer.finish_batch(p.trace)
        assert p.trace.meta["replica"] == p.pool_token.replica_idx
        assert 1 <= p.trace.meta["inflight_depth"] <= pool.inflight_depth
    assert len(tracer.traces(terminal="scored")) == 6 * BATCH


@pytest.mark.parametrize("overlap", [False, True])
def test_job_with_device_pool_drains_and_utilizes(overlap):
    gen, scorer = make_scorer()
    broker = InMemoryBroker()
    job = StreamJob(broker, scorer, JobConfig(
        max_batch=BATCH, emit_features=False, device_pool=True, inflight_depth=2,
        overlap_assembly=overlap))
    # on the CPU the pool is one replica, the scorer's device
    assert job.pool is scorer.pool and len(job.pool) == 1
    assert job._inflight_depth() == job.pool.total_slots() == 2
    n = BATCH * 8
    broker.produce_batch(T.TRANSACTIONS, gen.generate_batch(n),
                         key_fn=lambda r: str(r["user_id"]))
    try:
        assert job.run_until_drained(now=NOW) == n
    finally:
        job.close()
    st = job.pool.stats()
    assert st["completed"] == 8 and st["retries"] == 0
    assert len(broker.consumer([T.PREDICTIONS], "t").poll(n + 10)) == n


def test_job_keeps_a_pool_the_caller_attached():
    gen, scorer = make_scorer()
    pool = DevicePool(scorer, devices=["cpu"] * 3, inflight_depth=1)
    job = StreamJob(InMemoryBroker(), scorer, JobConfig(device_pool=True,
                                                        pipeline_depth=5))
    assert job.pool is pool and job._inflight_depth() == 3


# ------------------------------------------------- launches per batch
def test_launch_count_is_per_batch_under_concurrent_dispatch(monkeypatch):
    """Two threads dispatch at once; each batch's fused call "launches" a
    number of kernels of its own (3 or 5, interleaved with the other
    thread's): every batch's ``kernel_launches`` is its own count."""
    real = scorer_module.score_fused_packed
    barrier = threading.Barrier(2)

    def counting(models, blobs, spec, params, mv, **kw):
        n = 3 if threading.current_thread().name == "a" else 5
        barrier.wait(timeout=30)
        for _ in range(n):
            ops_build.count_launch(ops.fused_megakernel)
            time.sleep(0.002)
        return real(models, blobs, spec, params, mv, **kw)

    monkeypatch.setattr(scorer_module, "score_fused_packed", counting)
    before = ops.fused_megakernel.launches
    scorers = {name: make_scorer(seed=s) for name, s in (("a", 3), ("b", 4))}
    out = {}

    def run(name):
        gen, scorer = scorers[name]
        out[name] = [scorer.dispatch(gen.generate_batch(8), now=NOW).kernel_launches
                     for _ in range(3)]

    threads = [threading.Thread(target=run, args=(n,), name=n) for n in scorers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert out == {"a": [3, 3, 3], "b": [5, 5, 5]}
    assert ops.fused_megakernel.launches - before == 24
    assert scorers["a"][1].kernel_snapshot()["kernel_launches"] == 3
    assert scorers["b"][1].kernel_snapshot()["kernel_launches"] == 5


def test_launch_counters_hold_under_thread_stress():
    """More counting threads than cores with a short switch interval: the
    process-wide count loses no increment and each thread's own count is
    exactly its launches."""
    import os

    n_threads, per_thread = 2 * (os.cpu_count() or 2) + 2, 2_000
    before = ops.dequant_rows.launches
    seen = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def run(i):
            start = ops.thread_launches()
            for _ in range(per_thread + i):
                ops_build.count_launch(ops.dequant_rows)
            seen[i] = ops.thread_launches() - start

        threads = [threading.Thread(target=run, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert seen == {i: per_thread + i for i in range(n_threads)}
    assert ops.dequant_rows.launches - before == sum(seen.values())


def test_rescue_launches_count_toward_their_batch(pooled, monkeypatch):
    real = scorer_module.score_fused_packed

    def counting(*a, **kw):
        ops_build.count_launch(ops.epilogue_packed)
        return real(*a, **kw)

    monkeypatch.setattr(scorer_module, "score_fused_packed", counting)
    gen, scorer, pool = pooled
    pend = scorer.dispatch(gen.generate_batch(BATCH), now=NOW)
    assert pend.kernel_launches == 1
    pool.inject_fault(pend.pool_token.replica_idx, 1)
    scorer.finalize(pend, now=NOW)
    assert pend.kernel_launches == 2
    assert scorer.kernel_snapshot()["kernel_launches"] == 2


# ------------------------------------------------------------ the drill
def test_pool_drill_verdict_equals_jax(monkeypatch, capsys):
    from realtime_fraud_detection_tpu import cli as jcli

    assert port_main(["pool-drill", "--fast", "--device", "cpu"]) == 0
    port_lines = capsys.readouterr().out.strip().splitlines()
    monkeypatch.setenv("_RTFD_POOL_DRILL_CHILD", "1")
    assert jcli.main(["pool-drill", "--fast"]) == 0
    jax_lines = capsys.readouterr().out.strip().splitlines()
    got, want = json.loads(port_lines[-1]), json.loads(jax_lines[-1])
    assert got == want and got["passed"] is True
    assert len(port_lines[-1].encode()) < 2048
    full, jfull = json.loads(port_lines[-2]), json.loads(jax_lines[-2])
    assert full["hot_swap"] == jfull["hot_swap"]
    assert full["virtual_time"] == jfull["virtual_time"]
    assert full["devices"] == ["cpu"] * 8


def test_pool_drill_virtual_makespan_equals_jax():
    for log, n, depth in (([0, 1, 2, 3] * 3, 4, 2), ([0] * 9, 1, 2),
                          ([0, 1, 0, 1, 1, 0], 2, 1)):
        args = (log, n, depth, 5.0, 25.0)
        from realtime_fraud_detection_tpu_torch.scoring import pool_drill

        assert pool_drill._virtual_makespan_ms(*args) == \
            jpool_drill._virtual_makespan_ms(*args)


def test_pool_drill_refuses_to_start_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    assert port_main(["pool-drill", "--fast"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePool(make_scorer()[1], devices=["cuda:0"])


# ------------------------------------------------------- fault injectors
def _fault_plan(mod, pool):
    plan = mod.ChaosPlan([mod.FaultWindow("replica_death", "device", 0.1, 0.3),
                          mod.FaultWindow("slow_device", "device", 0.2, 0.25)])
    plan.bind("replica_death", mod.DeviceReplicaDeath(pool, 1, n_faults=1))
    plan.bind("slow_device", mod.SlowDevice(pool, 0, 0.02, n=1))
    return plan


def test_device_faults_on_the_pool_follow_the_plan(pooled):
    gen, scorer, pool = pooled
    plan = _fault_plan(pfaults, pool)
    # the JAX plan on the same timeline, its injectors bound to a stand-in
    stub = SimpleNamespace(inject_fault=lambda *a: None, inject_slow=lambda *a: None,
                           revive=lambda *a: None)
    jplan = _fault_plan(jfaults, stub)
    ref_gen, ref = make_scorer()
    ref_rows, got_rows = [], []
    for tick in range(6):
        now = tick * 0.1
        assert [(e, w.name) for e, w in plan.poll(now)] == \
            [(e, w.name) for e, w in jplan.poll(now)]
        pend = [scorer.dispatch(gen.generate_batch(BATCH), now=NOW) for _ in range(4)]
        got_rows += _rows([scorer.finalize(p, now=NOW) for p in pend])
        ref_rows += _rows(_run(ref, [ref_gen.generate_batch(BATCH) for _ in range(4)],
                               8))
    assert plan.snapshot(0.6) == jplan.snapshot(0.6)
    st = pool.stats()
    assert st["retries"] == 1 and st["devices"][1]["failures"] == 1
    assert st["healthy"] == len(pool)                    # revived at the end
    ids = [r[0] for r in got_rows]
    assert len(ids) == len(set(ids)) == 6 * 4 * BATCH
    assert got_rows == ref_rows                          # FIFO, fault-free rows


# ------------------------------------------------------------ JAX blocked
def test_pool_modules_import_with_jax_blocked():
    script = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "flax", "ml_dtypes",
                     "realtime_fraud_detection_tpu"):
            sys.modules[name] = None
        from realtime_fraud_detection_tpu_torch.chaos import (
            ChaosPlan, DeviceReplicaDeath, FaultWindow, SlowDevice)
        from realtime_fraud_detection_tpu_torch.scoring.device_pool import DevicePool
        from realtime_fraud_detection_tpu_torch.scoring.pool_drill import (
            PoolDrillConfig, run_pool_drill)
        from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
        from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
        gen = TransactionGenerator(num_users=50, num_merchants=20, seed=1)
        s = TorchFraudScorer(device="cpu", seed=1)
        s.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
        pool = DevicePool(s, devices=["cpu", "cpu"])
        plan = ChaosPlan([FaultWindow("d", "device", 0.0, 1.0)])
        plan.bind("d", DeviceReplicaDeath(pool, 0))
        plan.poll(0.0)
        res = s.score_batch(gen.generate_batch(8), now=1000.0)
        assert len(res) == 8 and pool.stats()["retries"] == 1
        assert PoolDrillConfig.fast().n_batches == 10
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
