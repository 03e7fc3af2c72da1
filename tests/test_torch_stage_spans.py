"""The host stage table and the collector's pauses on the profiler's clock.

``obs/profiling.py``: ``SpanTimer`` (a sample ring and cumulative totals,
``span`` opening the region ``rtfd.<stage>``), ``annotate`` (a region only
while a profiler records) and ``GcPauses`` (the process's one collector
recorder, ``rtfd.gc.gen<N>`` regions). The scorer and the job time their
stages through the table; ``host_stats`` reports it with the collector's
``gc.gen*`` entries and ``obs/metrics.py sync_host_stats`` mirrors both.
"""

import torch_threads  # noqa: F401  (first: torch held to one CPU thread)
import gc
import json
import pathlib
import threading
import weakref

import pytest

from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
from realtime_fraud_detection_tpu_torch.obs import profiling
from realtime_fraud_detection_tpu_torch.obs.metrics import MetricsCollector
from realtime_fraud_detection_tpu_torch.obs.profiling import (
    GC_PAUSES,
    GcPauses,
    SpanTimer,
    annotate,
    device_trace,
)
from realtime_fraud_detection_tpu_torch.qos.drill import DrillScorer
from realtime_fraud_detection_tpu_torch.scoring.pipeline import (
    ScorerConfig,
    init_scoring_models,
)
from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
from realtime_fraud_detection_tpu_torch.stream import topics as T
from realtime_fraud_detection_tpu_torch.stream.job import JobConfig, StreamJob
from realtime_fraud_detection_tpu_torch.stream.transport import InMemoryBroker

# every stage of one job batch and the stage whose region encloses it
PARENT = {
    "rtfd.assemble": None, "rtfd.encode": "rtfd.assemble",
    "rtfd.features": "rtfd.assemble", "rtfd.history": "rtfd.assemble",
    "rtfd.graph": "rtfd.assemble", "rtfd.tokens": "rtfd.assemble",
    "rtfd.pack": None, "rtfd.dispatch": None, "rtfd.h2d": "rtfd.dispatch",
    "rtfd.launch": "rtfd.dispatch", "rtfd.device_wait": None,
    "rtfd.responses": None, "rtfd.write_back": None, "rtfd.fan_out": None,
}


@pytest.fixture(scope="module")
def models():
    return init_scoring_models(0, TINY_CONFIG, feature_dim=ScorerConfig().feature_dim,
                               node_dim=ScorerConfig().node_dim)


def _job(models):
    gen = TransactionGenerator(num_users=40, num_merchants=15, seed=7)
    scorer = TorchFraudScorer(models=models, scorer_config=ScorerConfig(text_len=16),
                              bert_config=TINY_CONFIG, device="cpu")
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    broker = InMemoryBroker()
    broker.produce_batch(T.TRANSACTIONS, gen.generate_batch(48),
                         key_fn=lambda r: str(r["user_id"]))
    return StreamJob(broker, scorer, JobConfig(max_batch=16, max_delay_ms=1.0))


def _regions(trace_path):
    events = json.loads(pathlib.Path(trace_path).read_text())["traceEvents"]
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in events if e.get("cat") == "user_annotation"
                  and e.get("ph") == "X" and e["name"].startswith("rtfd."))


def test_a_job_batch_opens_every_stage_region_nested_in_its_parent(models, tmp_path):
    job = _job(models)
    job.process_batch(job.consumer.poll(16), now=1000.0)      # warm
    batch = job.consumer.poll(16)
    with device_trace(str(tmp_path), device="cpu") as prof:
        job.process_batch(batch, now=1001.0)
        gc.collect()
    regions = _regions(prof.trace_path)
    names = [name for _, _, name in regions]
    for stage, parent in PARENT.items():
        assert names.count(stage) == 1, stage
        s, e, _ = next(r for r in regions if r[2] == stage)
        if parent is not None:
            ps, pe, _ = next(r for r in regions if r[2] == parent)
            assert ps <= s and e <= pe, (stage, parent)
    assert "rtfd.gc.gen2" in names
    # no region left open, none outside the program's prefix of this table
    assert set(names) <= set(PARENT) | {"rtfd.gc.gen0", "rtfd.gc.gen1", "rtfd.gc.gen2"}
    stages = job.scorer.host_stats()["stages"]
    assert stages["fan_out"]["count"] == 2
    assert stages["h2d"]["total_s"] + stages["launch"]["total_s"] \
        <= stages["dispatch"]["total_s"]


def test_no_region_is_opened_outside_a_profiler(models, monkeypatch):
    opened = []
    monkeypatch.setattr(profiling, "_open_region",
                        lambda name: opened.append(name))
    job = _job(models)
    job.process_batch(job.consumer.poll(16), now=1000.0)
    gc.collect()
    with annotate("rtfd.outside"):
        pass
    assert opened == []
    assert job.scorer.host_stats()["stages"]["fan_out"]["count"] == 1


def test_a_stand_in_scorer_records_no_fan_out():
    gen = TransactionGenerator(num_users=10, num_merchants=5, seed=1)
    broker = InMemoryBroker()
    broker.produce_batch(T.TRANSACTIONS, gen.generate_batch(4),
                         key_fn=lambda r: str(r["user_id"]))
    job = StreamJob(broker, DrillScorer(), JobConfig(max_batch=4, emit_features=False))
    assert job._spans is None
    out = job.process_batch(job.consumer.poll(4), now=5.0)
    assert len(out) == 4 and job.counters["errors"] == 0


def test_a_collection_under_the_span_timers_lock_completes_and_counts():
    timer = SpanTimer()
    profiling.install_gc_pauses()
    before = GC_PAUSES.count[2]
    done = []

    def collect_under_lock():
        with timer._lock:
            gc.collect()
        timer.record("pack", 0.001)     # the lock was released
        done.append(True)

    t = threading.Thread(target=collect_under_lock, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and done == [True]
    assert GC_PAUSES.count[2] >= before + 1


def test_fifty_scorers_leave_one_recorder_and_are_collected(models):
    for _ in range(50):
        TorchFraudScorer(models=models, scorer_config=ScorerConfig(text_len=16),
                         bert_config=TINY_CONFIG, device="cpu")
    assert sum(1 for cb in gc.callbacks if isinstance(cb, GcPauses)) == 1
    assert sum(1 for cb in gc.callbacks if cb is GC_PAUSES) == 1
    scorer = TorchFraudScorer(models=models, scorer_config=ScorerConfig(text_len=16),
                              bert_config=TINY_CONFIG, device="cpu")
    gen = TransactionGenerator(num_users=20, num_merchants=8, seed=2)
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    scorer.score_batch(gen.generate_batch(8), now=10.0)
    gc.collect()
    stages = scorer.host_stats()["stages"]
    assert stages["gc.gen2"]["count"] == GC_PAUSES.count[2] >= 1
    ref = weakref.ref(scorer)
    del scorer
    gc.collect()
    assert ref() is None


def test_ten_thousand_and_one_samples_count_whole_while_the_ring_is_capped(models):
    scorer = TorchFraudScorer(models=models, scorer_config=ScorerConfig(text_len=16),
                              bert_config=TINY_CONFIG, device="cpu")
    for _ in range(10_001):
        scorer.spans.record("pack", 0.5)
    st = scorer.host_stats()["stages"]["pack"]
    assert st["count"] == 10_001
    assert st["total_s"] == pytest.approx(5000.5, rel=1e-12)
    assert st["mean_ms"] == pytest.approx(500.0)
    assert st["p50_ms"] == st["p99_ms"] == st["max_ms"] == 500.0
    ring = scorer.spans.stats("pack")["pack"]
    assert ring["count"] == 10_000 and ring["total_s"] == pytest.approx(5000.0)
    # reset empties the ring; the cumulative totals run on
    scorer.spans.reset()
    scorer.spans.record("pack", 0.25)
    st = scorer.spans.stage_stats()["pack"]
    assert st["count"] == 10_002 and st["p50_ms"] == 250.0


def test_gc_recorder_counts_per_generation_and_closes_only_its_own_region(monkeypatch):
    clock = [0.0]
    rec = GcPauses(clock=lambda: clock[0])
    assert rec.stats() == {}
    running = [False]
    closed = []

    class Region:
        def __init__(self, name):
            self.name = name

        def __exit__(self, *exc):
            closed.append(self.name)

    monkeypatch.setattr(profiling, "profiler_running", lambda: running[0])
    monkeypatch.setattr(profiling, "_open_region", Region)
    # the process's own recorder sees the patched check too: keep real
    # collections out of this test
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        _drive_recorder(rec, clock, running, closed)
    finally:
        if was_enabled:
            gc.enable()


def _drive_recorder(rec, clock, running, closed):
    # a profiler that starts between the two callbacks: nothing to close
    rec("start", {"generation": 0})
    running[0] = True
    clock[0] += 0.002
    rec("stop", {"generation": 0})
    assert closed == []
    # one that stops between them: the region it opened is closed
    rec("start", {"generation": 2})
    running[0] = False
    clock[0] += 0.5
    rec("stop", {"generation": 2})
    assert closed == ["rtfd.gc.gen2"]
    # a stop whose start read no clock counts nothing
    rec("stop", {"generation": 1})
    stats = rec.stats()
    assert set(stats) == {"gc.gen0", "gc.gen2"}
    assert stats["gc.gen0"] == {"count": 1, "total_s": pytest.approx(0.002),
                                "mean_ms": pytest.approx(2.0)}
    assert stats["gc.gen2"]["count"] == 1
    assert stats["gc.gen2"]["mean_ms"] == pytest.approx(500.0)


def test_sync_host_stats_mirrors_totals_and_only_the_stats_a_stage_has():
    m = MetricsCollector(clock=lambda: 0.0)
    stats = {"stages": {
        "dispatch": {"count": 4, "total_s": 0.1, "mean_ms": 25.0,
                     "p50_ms": 24.0, "p99_ms": 30.0, "max_ms": 31.0},
        "gc.gen2": {"count": 2, "total_s": 1.5, "mean_ms": 750.0}}}
    m.sync_host_stats(stats)
    stats["stages"]["dispatch"].update(count=6, total_s=0.16)
    m.sync_host_stats(stats)
    text = m.render_prometheus()
    assert 'host_stage_count_total{stage="dispatch"} 6' in text
    assert 'host_stage_seconds_total{stage="gc.gen2"} 1.5' in text
    assert 'host_assembly_stage_ms{stage="gc.gen2",stat="mean"} 750' in text
    assert 'host_assembly_stage_ms{stage="gc.gen2",stat="p50"}' not in text
    assert 'host_assembly_stage_ms{stage="dispatch",stat="p99"} 30' in text
