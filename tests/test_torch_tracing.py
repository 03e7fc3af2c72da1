"""The port's tracing plane against the JAX package's, on the CPU.

The tracing plane is deterministic Python on an injected clock, so the
comparisons here are exact on a virtual clock: the same seeded inputs (made
with numpy) go through both packages. Covered: ``TracingSettings`` defaults
and refusals, the carrier helpers and the thread-local log context,
``SloTracker`` burn rates, ``Tracer`` (breakdown, snapshot, the Chrome-trace
export, the ring and slowest-N store) on one synthetic trace set, the
``trace_*`` exposition after ``sync_tracing``, the trace drill's summary on
every field not read from the wall clock, the scorer's stage marks, and a
TINY ``TorchFraudScorer`` stream with tracing, autotune and QoS on against
the JAX ``StreamJob`` on the same stream and virtual clock. Tracing on
against off in the port gives the same outputs.
"""

import torch_threads  # noqa: F401  (first: torch held to one CPU thread)
import dataclasses
import json
import threading
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import realtime_fraud_detection_tpu.obs.trace_drill as jax_drill
import realtime_fraud_detection_tpu.obs.tracing as jax_tracing
import realtime_fraud_detection_tpu.tuning as jax_tuning
import realtime_fraud_detection_tpu_torch.obs.trace_drill as port_drill
import realtime_fraud_detection_tpu_torch.obs.tracing as port_tracing
import realtime_fraud_detection_tpu_torch.tuning as port_tuning
from realtime_fraud_detection_tpu.ensemble.combine import (
    EnsembleParams as JaxEnsembleParams,
)
from realtime_fraud_detection_tpu.obs.metrics import (
    MetricsCollector as JaxMetricsCollector,
)
from realtime_fraud_detection_tpu.qos import QosPlane as JaxQosPlane
from realtime_fraud_detection_tpu.scoring import FraudScorer
from realtime_fraud_detection_tpu.scoring import ScorerConfig as JaxScorerConfig
from realtime_fraud_detection_tpu.sim.simulator import (
    TransactionGenerator as JaxTransactionGenerator,
)
from realtime_fraud_detection_tpu.stream import InMemoryBroker as JaxInMemoryBroker
from realtime_fraud_detection_tpu.stream import JobConfig as JaxJobConfig
from realtime_fraud_detection_tpu.stream import StreamJob as JaxStreamJob
from realtime_fraud_detection_tpu.stream import topics as JT
from realtime_fraud_detection_tpu.stream.microbatch import (
    MicrobatchAssembler as JaxAssembler,
)
from realtime_fraud_detection_tpu.utils.config import Config as JaxConfig
from realtime_fraud_detection_tpu.utils.config import QosSettings as JaxQosSettings
from realtime_fraud_detection_tpu.utils.config import (
    TracingSettings as JaxTracingSettings,
)
from realtime_fraud_detection_tpu.utils.config import (
    TuningSettings as JaxTuningSettings,
)
from realtime_fraud_detection_tpu_torch.__main__ import main as port_main
from realtime_fraud_detection_tpu_torch.bridge import models_from_numpy
from realtime_fraud_detection_tpu_torch.obs.metrics import MetricsCollector
from realtime_fraud_detection_tpu_torch.qos.plane import QosPlane
from realtime_fraud_detection_tpu_torch.scoring.host_pipeline import AssemblerStage
from realtime_fraud_detection_tpu_torch.scoring.pipeline import MODEL_NAMES
from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
from realtime_fraud_detection_tpu_torch.sim.arrivals import (
    DiurnalBurstConfig,
    DiurnalBurstProcess,
)
from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
from realtime_fraud_detection_tpu_torch.stream import topics as T
from realtime_fraud_detection_tpu_torch.stream.job import JobConfig, StreamJob
from realtime_fraud_detection_tpu_torch.stream.microbatch import MicrobatchAssembler
from realtime_fraud_detection_tpu_torch.stream.transport import InMemoryBroker
from realtime_fraud_detection_tpu_torch.utils.config import (
    Config,
    QosSettings,
    TracingSettings,
    TuningSettings,
)
from torch_bounds import near_rung, noise_bound

JAX = SimpleNamespace(
    tracing=jax_tracing, tuning=jax_tuning, TracingSettings=JaxTracingSettings,
    TuningSettings=JaxTuningSettings, QosSettings=JaxQosSettings, QosPlane=JaxQosPlane,
    Metrics=JaxMetricsCollector, Broker=JaxInMemoryBroker, JobConfig=JaxJobConfig,
    StreamJob=JaxStreamJob, Assembler=JaxAssembler, topics=JT)
PORT = SimpleNamespace(
    tracing=port_tracing, tuning=port_tuning, TracingSettings=TracingSettings,
    TuningSettings=TuningSettings, QosSettings=QosSettings, QosPlane=QosPlane,
    Metrics=MetricsCollector, Broker=InMemoryBroker, JobConfig=JobConfig,
    StreamJob=StreamJob, Assembler=MicrobatchAssembler, topics=T)
# the JAX package's export names its own command; the rest is equal
_EXPORT_TOOL = {"rtfd trace-export", "realtime_fraud_detection_tpu_torch trace-export"}


def both(scenario):
    """Run ``scenario`` through both packages; the results must be equal.
    Returns the port's."""
    got, want = scenario(PORT), scenario(JAX)
    assert got == want
    return got


def _raised(fn):
    """(exception type name, message) of what ``fn()`` raises, or None."""
    try:
        fn()
    except (TypeError, ValueError) as e:
        return type(e).__name__, str(e)
    return None


# ---------------------------------------------------------------- settings
def test_tracing_settings_defaults_equal_jax():
    assert dataclasses.asdict(TracingSettings()) == dataclasses.asdict(JaxTracingSettings())
    assert dataclasses.asdict(Config().tracing) == dataclasses.asdict(JaxConfig().tracing)
    assert port_tracing.TRACE_STAGES == jax_tracing.TRACE_STAGES
    assert port_tracing.TRACE_STAGE_BUCKETS_MS == jax_tracing.TRACE_STAGE_BUCKETS_MS


TRACING_REFUSALS = [
    dict(slo_objective_frac=1.0),
    dict(slo_objective_frac=0.0),
    dict(slo_objective_ms=0.0),
    dict(ring_size=8),
    dict(slowest_n=0),
    dict(slo_bucket_s=0.0),
    dict(slo_fast_window_s=30.0, slo_bucket_s=60.0),
    dict(slo_fast_window_s=100.0, slo_slow_window_s=50.0, slo_bucket_s=1.0),
    dict(slo_burn_threshold=0.0),
    dict(slo_gate_patience=0),
    dict(slo_gate_up_patience=0),
]


@pytest.mark.parametrize("kw", TRACING_REFUSALS,
                         ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_tracing_settings_refusals_equal_jax(kw):
    got = both(lambda pkg: _raised(lambda: pkg.TracingSettings(**kw).validate()))
    assert got is not None and got[0] == "ValueError"


def test_config_validates_its_tracing_block():
    cfg = Config()
    cfg.tracing.ring_size = 4
    with pytest.raises(ValueError, match="ring_size"):
        cfg.validate()


# --------------------------------------------------- carriers, log context
CARRIERS = [
    dict(trace_id="t1"),
    dict(trace_id="t2", origin="w0", produced_ts=1234.5678901, priority="high",
         fault="netfault", parent="sp9", hops=2, redirect_s=0.0123456789),
    dict(trace_id=7, produced_ts=0.0),
]
GARBLED = [None, "t1", {}, {"tid": ""}, {"tid": 5}, {"tid": "x", "ts": "bad", "rh": [1]},
           {"tid": "y", "ts": "1.5", "rh": "3", "rs": None, "pr": None}]


def test_carriers_equal_jax():
    def scenario(pkg):
        made = [pkg.tracing.make_carrier(**kw) for kw in CARRIERS]
        return made, [pkg.tracing.parse_carrier(c) for c in made + GARBLED]

    made, parsed = both(scenario)
    assert parsed[len(made)] is None and parsed[-1]["ts"] == 1.5


def test_log_context_is_thread_local_as_in_jax():
    # a test of another file run earlier on this worker may leave this
    # thread's context set (tests/test_serving.py does, on the JAX side)
    for pkg in (PORT, JAX):
        pkg.tracing.clear_log_context()

    def scenario(pkg):
        t = pkg.tracing
        out = [t.current_log_context()]
        t.set_log_context("t00000001", "w3")
        out.append(t.current_log_context())
        seen = []
        th = threading.Thread(target=lambda: seen.append(t.current_log_context()))
        th.start()
        th.join()
        out.append(seen[0])
        t.clear_log_context()
        out.append(t.current_log_context())
        return out

    assert both(scenario) == [None, {"trace_id": "t00000001", "worker": "w3"}, None, None]


# ------------------------------------------------------------ SLO tracker
@pytest.mark.parametrize("seed", [0, 1])
def test_slo_tracker_burn_rates_equal_jax(seed):
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(0.004, 1500)).tolist()
    lat = (rng.gamma(2.0, 6.0, 1500) * np.where(rng.random(1500) < 0.1, 3.0, 1.0)).tolist()

    def scenario(pkg):
        slo = pkg.tracing.SloTracker(objective_ms=20.0, objective_frac=0.95,
                                     fast_window_s=0.4, slow_window_s=1.6,
                                     bucket_s=0.02, clock=lambda: 0.0)
        burns = []
        for i, (t, ms) in enumerate(zip(times, lat)):
            slo.record(ms, now=t)
            if i % 50 == 0:
                burns.append((slo.burn_rate(0.4, now=t), slo.burn_rate(1.6, now=t)))
        return burns, slo.snapshot(now=times[-1]), slo.snapshot(now=times[-1] + 5.0)

    burns, snap, later = both(scenario)
    assert max(b for b, _ in burns) > 1.0 and snap["violations_total"] > 0
    assert later["windows"]["fast"]["observed"] == 0


# ----------------------------------------------------------------- tracer
def _synthetic_traces(pkg, seed=5):
    """One seeded trace set on a virtual clock: batches with the scorer's
    five marks at seeded stage costs, child spans, annotations, carriers
    (adopted with a producer fault, garbled, expected but missing), sheds,
    errors, cached, and a ring small enough to evict."""
    rng = np.random.default_rng(seed)
    clock = [100.0]
    tracer = pkg.tracing.Tracer(pkg.TracingSettings(
        enabled=True, ring_size=64, slowest_n=5, slo_objective_ms=15.0,
        slo_fast_window_s=0.5, slo_slow_window_s=2.0, slo_bucket_s=0.05),
        clock=lambda: clock[0])
    prios = ("high", "normal", "low", "")
    for b in range(24):
        n = int(rng.integers(1, 9))
        ctxs = []
        for i in range(n):
            carrier = None
            if i % 5 == 1:
                carrier = pkg.tracing.make_carrier(
                    f"c{b}-{i}", origin="gw", produced_ts=50.0 - 0.001 * i,
                    priority="high", hops=i % 2, redirect_s=0.0005 * (i % 2),
                    fault="netfault" if b % 3 == 0 else "")
            elif i % 5 == 2:
                carrier = {"tid": ""}
            ctxs.append(tracer.begin(
                f"x{b}-{i}", ingest_lag_s=float(rng.uniform(0, 0.004)),
                priority=prios[i % 4], carrier=carrier, now_wall=50.002,
                expect_carrier=(i % 5 == 3)))
            clock[0] += float(rng.uniform(0, 0.002))
        tb = tracer.batch(ctxs + [None], batch_size=n, close_reason="jit")
        for stage in ("assemble", "pack", "dispatch", "device_wait", "finalize"):
            tb.mark(stage)
            clock[0] += float(rng.gamma(2.0, 0.0015 if stage != "device_wait" else 0.004))
            if stage == "dispatch" and b % 6 == 0:
                tb.child_span("remote_fetch", float(rng.uniform(0.1, 1.0)), peer="p1")
        tb.annotate(replica=b % 2)
        tracer.finish_batch(tb, terminal="error" if b == 7 else "scored")
        if b % 4 == 0:
            tracer.finish_terminal(tracer.begin(f"s{b}", priority="low"), "shed",
                                   reason="rate_limit")
            tracer.finish_terminal(tracer.begin(f"k{b}"), "cached")
    tracer.finish_terminal(None, "shed")
    assert tracer.batch([None]) is None
    return tracer, clock


def _tracer_view(tracer):
    export = tracer.export_chrome_trace()
    assert export["metadata"].pop("tool") in _EXPORT_TOOL
    return dict(breakdown=tracer.breakdown(), snapshot=tracer.snapshot(),
                export=export, ring=[t.to_dict() for t in tracer.traces()],
                slowest=[t.to_dict() for t in tracer.slowest()],
                counters=dict(tracer.counters))


def test_tracer_breakdown_snapshot_and_export_equal_jax():
    def scenario(pkg):
        tracer, _ = _synthetic_traces(pkg)
        view = _tracer_view(tracer)
        tracer.reset()
        view["after_reset"] = (tracer.breakdown(), tracer.snapshot()["counters"])
        return view

    view = both(scenario)
    bd = view["breakdown"]
    assert 0 < bd["n"] < 64 and set(bd["quantiles"]) == {"p50", "p95", "p99"}
    for q in bd["quantiles"].values():
        # additive: the stage shares sum to the tail's mean end to end
        assert sum(q["stage_ms"].values()) == pytest.approx(
            q["e2e_ms"], rel=0.5) and q["dominant_stage"] in q["stage_ms"]
    assert view["counters"]["carrier_adopted"] > 0 and view["counters"]["carrier_lost"] > 0
    assert len(view["slowest"]) == 5 and view["after_reset"][0]["n"] == 0
    assert any("fault" in t["meta"] for t in view["ring"])


def test_disabled_tracer_costs_nothing_as_in_jax():
    def scenario(pkg):
        tracer = pkg.tracing.Tracer(pkg.TracingSettings(enabled=False))
        ctx = tracer.begin("x")
        tracer.finish_batch(tracer.batch([ctx]))
        tracer.finish_terminal(ctx, "shed")
        return ctx, tracer.snapshot()["counters"], tracer.breakdown()

    both(scenario)


# ----------------------------------------------------------------- metrics
def _trace_lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith("trace_") or ln.startswith(("# HELP trace_",
                                                         "# TYPE trace_",
                                                         "# exemplar trace_"))]


def test_trace_exposition_equals_jax_line_for_line():
    def scenario(pkg):
        tracer, _ = _synthetic_traces(pkg)
        m = pkg.Metrics(clock=lambda: 100.0)
        m.sync_tracing(tracer.snapshot())
        first = _trace_lines(m.render_prometheus())
        m.sync_tracing(tracer.snapshot())          # unchanged: +0
        again = _trace_lines(m.render_prometheus())
        more, _ = _synthetic_traces(pkg, seed=6)
        m.sync_tracing(more.snapshot())            # a restarted source
        return first, again, _trace_lines(m.render_prometheus())

    first, again, _ = both(scenario)
    assert first == again and any(ln.startswith("# exemplar trace_stage_ms")
                                  for ln in first)
    assert 'trace_completed_total{terminal="shed"} 6' in first


# ------------------------------------------------------------------ drill
# the drill's fields read from the wall clock: the plane's measured cost
_WALL_CLOCK = {("overhead", "enabled_us_per_txn"), ("overhead", "disabled_us_per_txn"),
               ("checks", "overhead_under_bound"), ("checks", "noop_under_bound"),
               ("passed",)}


def _without_wall_clock(summary):
    out = json.loads(json.dumps(summary))
    for path in _WALL_CLOCK:
        d = out
        for k in path[:-1]:
            d = d[k]
        d.pop(path[-1])
    return out


def test_trace_drill_fast_equals_jax_but_for_the_wall_clock():
    got = port_drill.run_trace_drill(port_drill.TraceDrillConfig.fast())
    want = jax_drill.run_trace_drill(jax_drill.TraceDrillConfig.fast())
    assert _without_wall_clock(got) == _without_wall_clock(want)
    checks = {k: v for k, v in got["checks"].items()
              if ("checks", k) not in _WALL_CLOCK}
    assert all(checks.values()), checks
    assert got["slow_assembly"]["dominant_stage"] == "assemble"
    assert got["slow_device"]["dominant_stage"] == "device_wait"


def test_trace_drill_cli_prints_the_compact_verdict_last(capsys, monkeypatch):
    summary = json.loads(json.dumps(dict(
        config={"slo_burn_threshold": 2.0}, passed=True, checks={"x": True},
        slow_assembly={"dominant_stage": "assemble"},
        slow_device={"dominant_stage": "device_wait", "burn_peak": 25.0},
        recovery={"burn_final": 0.0}, fifo_shed={"shed_traced": 3, "shed_untraced": 3},
        overhead={"enabled_us_per_txn": 9.0, "disabled_us_per_txn": 0.3,
                  "bound_us": 75.0})))
    seen = []
    monkeypatch.setattr(port_drill, "run_trace_drill",
                        lambda cfg: seen.append(cfg) or summary)
    assert port_main(["trace-drill", "--fast"]) == 0
    assert seen == [port_drill.TraceDrillConfig.fast()]
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == port_drill.compact_trace_summary(summary)


# ------------------------------------------------------- scorer stage marks
class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def test_scorer_marks_the_jax_stages_and_the_stage_carries_the_trace():
    gen = TransactionGenerator(num_users=12, num_merchants=5, seed=4)
    scorer = TorchFraudScorer(device="cpu", seed=1)
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    tracer = port_tracing.Tracer(TracingSettings(enabled=True), clock=_Clock())
    names = ["assemble", "pack", "dispatch", "device_wait", "finalize"]

    tb = tracer.batch([tracer.begin("a"), tracer.begin("b")])
    scorer.finalize(scorer.dispatch(gen.generate_batch(2), now=1.0, trace=tb))
    assert [n for n, _ in tb.marks] == names
    stage = AssemblerStage(scorer)
    try:
        tb2 = tracer.batch([tracer.begin("c")])
        pending = stage.submit(gen.generate_batch(1), now=2.0, trace=tb2).result()
        assert pending.trace is tb2
        scorer.finalize(pending)
    finally:
        stage.close()
    assert [n for n, _ in tb2.marks] == names
    tracer.finish_batch(tb)
    tracer.finish_batch(tb2)
    stages = [list(t.stages) for t in tracer.traces()]
    assert stages == [["queue"] + names] * 3
    # no trace: no marks, the same responses
    assert scorer.dispatch(gen.generate_batch(1), now=3.0).trace is None


# --------------------------------------------------------- the stream
STREAM_USERS, STREAM_MERCHANTS, STREAM_SEED = 60, 20, 13
STREAM_BATCH = 32


@pytest.fixture(scope="module")
def jax_models():
    return jax.tree_util.tree_map(
        np.asarray, FraudScorer(scorer_config=JaxScorerConfig(), seed=3).models)


def _arrival_times(n):
    """``n`` seeded arrivals of a compressed diurnal cycle with one burst:
    lone transactions at trough, batches of a few dozen at the burst."""
    proc = DiurnalBurstProcess(DiurnalBurstConfig(
        trough_tps=60.0, peak_tps=1_500.0, period_s=0.6, burst_every_s=0.3,
        burst_offset_s=0.2, burst_duration_s=0.04, burst_mult=5.0), seed=3)
    return proc.generate(10.0)[:n].tolist()


def _traced_stream(side, models, tracing=True, autotune=True, qos=True, n=96,
                   objective_ms=3.0, admission_rate=0.0):
    """A seeded stream of ``n`` simulator records at the ``_arrival_times``
    through one package's job on a virtual clock: the assembler, the
    tracer, the QoS plane's budget and the tuning plane all read it; each
    dispatched batch is completed at once and advances the clock by the
    autotune drill's bucket-padded service curve (2 ms + 6 us a padded
    row). Returns what the checks read."""
    pkg = PORT if side == "port" else JAX
    clock = [0.0]
    vclock = lambda: clock[0]                                   # noqa: E731
    if side == "port":
        gen = TransactionGenerator(num_users=STREAM_USERS,
                                   num_merchants=STREAM_MERCHANTS, seed=STREAM_SEED)
        scorer = TorchFraudScorer(models=models_from_numpy(models), device="cpu")
    else:
        gen = JaxTransactionGenerator(num_users=STREAM_USERS,
                                      num_merchants=STREAM_MERCHANTS, seed=STREAM_SEED)
        scorer = FraudScorer(models=models)
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    tokens = []
    if side == "jax":
        assemble = scorer.assemble

        def keep(*args, **kwargs):
            batch = assemble(*args, **kwargs)
            tokens.append((np.asarray(batch.token_ids), np.asarray(batch.token_mask)))
            return batch

        scorer.assemble = keep
    plane = pkg.QosPlane(pkg.QosSettings(
        enabled=True, budget_ms=20.0, ladder_high_backlog=1e9,
        ladder_low_backlog=1e8, admission_rate=admission_rate,
        admission_burst=4.0 if admission_rate else 0.0)) if qos else None
    tracer = pkg.tracing.Tracer(pkg.TracingSettings(
        enabled=True, ring_size=4096, slo_objective_ms=objective_ms,
        slo_fast_window_s=0.2, slo_slow_window_s=0.8, slo_bucket_s=0.02,
        slo_gate_patience=2, slo_gate_up_patience=4), clock=vclock) if tracing else None
    tuning = pkg.tuning.TuningPlane(pkg.TuningSettings(
        enabled=True, deadline_max_ms=6.0, tune_interval_batches=4,
        inflight_min=1, inflight_max=1)) if autotune else None
    broker = pkg.Broker()
    job = pkg.StreamJob(broker, scorer, pkg.JobConfig(
        max_batch=STREAM_BATCH, emit_features=False, emit_enriched=False,
        qos=plane, tracing=tracer, autotune=tuning))
    job.assembler = pkg.Assembler(
        job.consumer, max_batch=STREAM_BATCH, max_delay_ms=5.0, clock=vclock,
        budget=plane.budget if plane is not None else None, budget_clock=vclock,
        controller=job.tuning)
    times = _arrival_times(n)
    recs = gen.generate_batch(n)
    sizes, rungs, next_i = [], [], 0
    while True:
        while next_i < n and times[next_i] <= clock[0]:
            broker.produce(pkg.topics.TRANSACTIONS, recs[next_i],
                           key=str(recs[next_i]["user_id"]), timestamp=times[next_i])
            next_i += 1
        batch = job.assembler.next_batch(block=False)
        if not batch and next_i >= n and job.consumer.lag() == 0:
            batch = job.assembler.flush()
        if batch:
            ctx = job.dispatch_batch(batch, now=clock[0])
            sizes.append(len(batch))
            rungs.append(plane.effective_level() if plane is not None else 0)
            bucket = next(b for b in (1, 8, 32) if len(ctx.fresh) <= b) if ctx.fresh else 0
            clock[0] += (2.0 + 0.006 * bucket) / 1e3 if ctx.fresh else 0.0005
            job.complete_batch(ctx, now=clock[0])
            continue
        if next_i >= n and job.consumer.lag() == 0 and not job.assembler._pending:
            break
        clock[0] = (max(clock[0] + 0.0005, times[next_i]) if next_i < n
                    and not job.assembler._pending else clock[0] + 0.0005)
    preds = [p.value for p in broker.consumer([pkg.topics.PREDICTIONS], "c").poll(10_000)]
    out = dict(preds=preds, sizes=sizes, rungs=rungs, tokens=tokens,
               counters=dict(job.counters),
               close_reasons=dict(sorted(job.assembler.close_reasons.items())))
    if tracer is not None:
        out.update(trace_counters=dict(tracer.counters),
                   stage_names=[list(t.stages) for t in tracer.traces()],
                   breakdown=tracer.breakdown(), slo=tracer.slo.snapshot(),
                   terminals=[(t.txn_id, t.terminal) for t in tracer.traces()])
    if tuning is not None:
        out["tuning"] = job.tuning.snapshot()
    if plane is not None:
        out["slo_gate"] = plane.snapshot()["slo_gate"]
    return out


def _held(preds, jpreds, bound):
    """Same ids; fraud_score within ``bound``; decision and risk level equal
    on every row whose JAX probability and confidence lie farther than
    ``bound`` from a rung. Returns the rows skipped."""
    assert [p["transaction_id"] for p in preds] == [q["transaction_id"] for q in jpreds]
    prob = np.array([q["fraud_probability"] for q in jpreds])
    conf = np.array([q["confidence"] for q in jpreds])
    near = near_rung(prob, bound) | near_rung(conf, bound)
    for p, q, skip in zip(preds, jpreds, near):
        assert abs(p["fraud_score"] - q["fraud_score"]) <= bound
        if not skip:
            assert (p["decision"], p["risk_level"]) == (q["decision"], q["risk_level"])
    return int(near.sum())


@pytest.fixture(scope="module")
def jax_stream(jax_models):
    return _traced_stream("jax", jax_models)


def test_traced_autotuned_stream_matches_the_jax_job(jax_models, jax_stream):
    got, want = _traced_stream("port", jax_models), jax_stream
    assert got["sizes"] == want["sizes"] and got["rungs"] == want["rungs"]
    assert got["close_reasons"] == want["close_reasons"]
    assert got["counters"] == want["counters"] and got["counters"]["scored"] == 96
    assert got["trace_counters"] == want["trace_counters"]
    assert got["terminals"] == want["terminals"]
    assert got["stage_names"] == want["stage_names"]
    assert got["tuning"] == want["tuning"] and got["slo_gate"] == want["slo_gate"]
    assert got["breakdown"] == want["breakdown"] and got["slo"] == want["slo"]
    # the stream reaches lone transactions and multi-row batches, the JIT
    # closer and the SLO-burn gate
    assert 1 in got["sizes"] and max(got["sizes"]) > 1
    assert got["rungs"][0] == 0 and max(got["rungs"]) == 1 and got["slo_gate"]["engaged"]
    assert got["close_reasons"].get("jit", 0) > 0
    assert got["trace_counters"]["completed"] == 96
    assert sorted(t for t, term in got["terminals"] if term == "scored") == \
        sorted(r["transaction_id"] for r in got["preds"])
    assert all(names[-6:] == ["queue", "assemble", "pack", "dispatch", "device_wait",
                              "finalize"] and names[:-6] in ([], ["ingest"])
               for names in got["stage_names"])
    weights = JaxEnsembleParams.from_config(JaxConfig(), MODEL_NAMES).weights
    bound = noise_bound(jax_models.bert, want["tokens"], weights, np.ones(5, bool))
    assert _held(got["preds"], want["preds"], bound) == 0


def test_tracing_on_and_off_give_the_same_outputs(jax_models):
    """The plane observes and never perturbs: with the fixed deadline and
    the QoS plane, the traced and the untraced port jobs emit the same
    predictions (but for the wall-clock processing time) in the same
    order, through the same batches."""
    kw = dict(autotune=False, n=64, objective_ms=1e3, admission_rate=100.0)
    on = _traced_stream("port", jax_models, tracing=True, **kw)
    off = _traced_stream("port", jax_models, tracing=False, **kw)

    def strip(preds):
        return [{k: v for k, v in p.items() if k != "processing_time_ms"} for p in preds]

    assert strip(on["preds"]) == strip(off["preds"])
    assert on["sizes"] == off["sizes"] and on["close_reasons"] == off["close_reasons"]
    assert on["counters"] == off["counters"] and on["counters"]["shed"] > 0
    assert on["trace_counters"]["shed"] == on["counters"]["shed"]
    assert on["trace_counters"]["completed"] == on["counters"]["scored"]


def test_job_closes_terminal_traces_for_invalid_records_and_duplicates():
    gen = TransactionGenerator(num_users=12, num_merchants=5, seed=4)
    scorer = TorchFraudScorer(device="cpu", seed=1)
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    broker = InMemoryBroker()
    job = StreamJob(broker, scorer, JobConfig(
        max_batch=16, tracing=TracingSettings(enabled=True), emit_features=False))
    recs = gen.generate_batch(6)
    broker.produce_batch(T.TRANSACTIONS, recs + [recs[0], {"amount": "x"}],
                         key_fn=lambda r: str(r.get("user_id", "")))
    job.run_until_drained(now=5.0)
    broker.produce_batch(T.TRANSACTIONS, recs[:2], key_fn=lambda r: str(r["user_id"]))
    job.run_until_drained(now=6.0)
    c = job.tracer.counters
    assert (c["completed"], c["cached"], c["errors"]) == (6, 3, 1)
    assert job.counters["duplicates_skipped"] == 3
    reasons = {t.meta.get("reason") for t in job.tracer.traces() if t.terminal != "scored"}
    assert reasons == {"duplicate", "invalid"}


def test_job_config_takes_a_tracer_and_refuses_other_objects():
    tracer = port_tracing.Tracer(TracingSettings(enabled=True))
    scorer = TorchFraudScorer(device="cpu", seed=1)
    job = StreamJob(InMemoryBroker(), scorer, JobConfig(tracing=tracer))
    assert job.tracer is tracer
    built = StreamJob(InMemoryBroker(), scorer,
                      JobConfig(tracing=TracingSettings(enabled=True)))
    assert isinstance(built.tracer, port_tracing.Tracer)
    assert StreamJob(InMemoryBroker(), scorer,
                     JobConfig(tracing=TracingSettings())).tracer is None
    for bad in (object(), {"enabled": True}, JaxTracingSettings(enabled=True)):
        with pytest.raises(TypeError):
            JobConfig(tracing=bad)


def test_trace_export_and_run_job_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "trace.json"
    assert port_main(["trace-export", "--count", "48", "--batch", "16", "--users", "20",
                      "--merchants", "8", "--device", "cpu", "--out", str(out)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    payload = json.loads(out.read_text())
    assert line["traces"] == 48 and len(payload["traceEvents"]) == line["events"]
    assert {e["name"] for e in payload["traceEvents"]} >= {
        "queue", "assemble", "pack", "dispatch", "device_wait", "finalize"}
    assert port_main(["run-job", "--count", "40", "--batch", "16", "--users", "20",
                      "--merchants", "8", "--device", "cpu", "--trace", "--autotune",
                      "--qos"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["tracing"]["traces"] == 40
    assert summary["tracing"]["counters"]["completed"] == 40
    assert set(summary["autotune"]) == {"decisions", "max_wait_ms", "tuner",
                                        "close_reasons"}
    assert summary["autotune"]["max_wait_ms"] <= 18.0      # the QoS floor's clamp
