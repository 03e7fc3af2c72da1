"""The port's tuning plane against the JAX package's, on the CPU.

The tuning plane is deterministic Python, so every comparison here is
exact: the same seeded inputs (made with numpy) go through both packages
and the results must be equal. Covered: ``DiurnalBurstProcess``
timestamps, ``ArrivalForecaster`` state, the ``JitBatchController``
decision sequence, ``ConfigTuner`` moves and its freeze under a degraded
ladder or an engaged burn, ``TuningPlane`` snapshots, ``TuningSettings``
defaults and refusals (the QoS-floor conflict included), the
``autotune_*`` exposition after ``sync_autotune``, the assembler's
controller branch, the job's in-flight depth, and the whole
``autotune-drill --fast`` summary.
"""

import torch_threads  # noqa: F401  (first: torch held to one CPU thread)
import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest

import realtime_fraud_detection_tpu.sim.arrivals as jax_arrivals
import realtime_fraud_detection_tpu.tuning as jax_tuning
import realtime_fraud_detection_tpu.tuning.drill as jax_drill
import realtime_fraud_detection_tpu_torch.sim.arrivals as port_arrivals
import realtime_fraud_detection_tpu_torch.tuning as port_tuning
import realtime_fraud_detection_tpu_torch.tuning.drill as port_drill
from realtime_fraud_detection_tpu.obs.metrics import (
    MetricsCollector as JaxMetricsCollector,
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
    TuningSettings as JaxTuningSettings,
)
from realtime_fraud_detection_tpu_torch.__main__ import main as port_main
from realtime_fraud_detection_tpu_torch.obs.metrics import MetricsCollector
from realtime_fraud_detection_tpu_torch.stream import topics as T
from realtime_fraud_detection_tpu_torch.stream.job import JobConfig, StreamJob
from realtime_fraud_detection_tpu_torch.stream.microbatch import MicrobatchAssembler
from realtime_fraud_detection_tpu_torch.stream.transport import InMemoryBroker
from realtime_fraud_detection_tpu_torch.utils.config import Config, QosSettings, TuningSettings

JAX = SimpleNamespace(
    arrivals=jax_arrivals, tuning=jax_tuning, drill=jax_drill,
    Config=JaxConfig, QosSettings=JaxQosSettings, TuningSettings=JaxTuningSettings,
    Metrics=JaxMetricsCollector, Broker=JaxInMemoryBroker, JobConfig=JaxJobConfig,
    StreamJob=JaxStreamJob, Assembler=JaxAssembler, topics=JT)
PORT = SimpleNamespace(
    arrivals=port_arrivals, tuning=port_tuning, drill=port_drill,
    Config=Config, QosSettings=QosSettings, TuningSettings=TuningSettings,
    Metrics=MetricsCollector, Broker=InMemoryBroker, JobConfig=JobConfig,
    StreamJob=StreamJob, Assembler=MicrobatchAssembler, topics=T)


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


# ---------------------------------------------------------------- arrivals
ARRIVAL_CASES = {
    "defaults": (dict(), 4.0, 0),
    "drill_fast": (dict(trough_tps=150.0, peak_tps=8_000.0, period_s=3.0,
                        burst_every_s=1.5, burst_offset_s=1.2,
                        burst_duration_s=0.15, burst_mult=4.0), 3.0, 7),
    "offset_start": (dict(trough_tps=40.0, peak_tps=900.0, period_s=2.0,
                          burst_mult=6.0, t0=12.5), 2.5, 123),
}


@pytest.mark.parametrize("case", sorted(ARRIVAL_CASES))
def test_arrival_timestamps_equal_jax_bit_for_bit(case):
    kw, duration, seed = ARRIVAL_CASES[case]

    def scenario(pkg):
        proc = pkg.arrivals.DiurnalBurstProcess(
            pkg.arrivals.DiurnalBurstConfig(**kw), seed=seed)
        times = proc.generate(duration)
        return (times.tobytes(), proc.summary(times.tolist()),
                [proc.rate_at(t) for t in np.linspace(0.0, duration, 7)],
                proc.peak_rate())

    got = both(scenario)
    assert len(got[0]) > 8 * 50 and got[1]["n"] * 8 == len(got[0])


def test_arrival_config_refusals_equal_jax():
    bad = [dict(trough_tps=0.0), dict(trough_tps=10.0, peak_tps=5.0),
           dict(period_s=0.0), dict(burst_mult=0.5), dict(burst_duration_s=-1.0)]

    def scenario(pkg):
        out = []
        for kw in bad:
            out.append(_raised(lambda kw=kw: pkg.arrivals.DiurnalBurstProcess(
                pkg.arrivals.DiurnalBurstConfig(**kw)).generate(1.0)))
        return out

    assert all(r is not None for r in both(scenario))


# -------------------------------------------------------------- forecaster
def _gaps(seed, n=600):
    """Seeded arrival gaps: a steady stretch, a 10x burst, a silence."""
    rng = np.random.default_rng(seed)
    gaps = np.concatenate([rng.exponential(1e-3, n // 2),
                           rng.exponential(1e-4, n // 4),
                           [0.35],
                           rng.exponential(5e-4, n - n // 2 - n // 4 - 1)])
    batch = rng.integers(1, 4, size=n)
    return gaps.tolist(), batch.tolist()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forecaster_state_equals_jax(seed):
    gaps, counts = _gaps(seed)

    def scenario(pkg):
        f = pkg.tuning.ArrivalForecaster(bucket_s=0.01, alpha=0.6, beta=0.3)
        t, trail = 0.0, []
        for i, (g, n) in enumerate(zip(gaps, counts)):
            t += g
            f.observe(t, n=n)
            if i % 25 == 0:
                trail.append((f.rate(t + 0.002), f.expected_gap_s(t + 0.002)))
        state = {k: getattr(f, k) for k in (
            "gap_ewma", "level", "trend", "last_arrival", "observed_total",
            "folds", "_cur_idx", "_cur_count")}
        return trail, state, f.snapshot(), f.rate(t + 10.0)

    both(scenario)


def test_forecaster_refusals_equal_jax():
    def scenario(pkg):
        return [_raised(lambda kw=kw: pkg.tuning.ArrivalForecaster(**kw))
                for kw in (dict(bucket_s=0.0), dict(alpha=0.0), dict(alpha=1.5),
                           dict(beta=-0.1))]

    assert all(r is not None for r in both(scenario))


# -------------------------------------------------------------- controller
@pytest.mark.parametrize("seed", [3, 4])
def test_controller_decision_sequence_equals_jax(seed):
    """A seeded mix of arrivals, completed batches and close decisions
    (with and without a QoS close-by instant): every decision and the final
    snapshot equal JAX's."""
    rng = np.random.default_rng(seed)
    ops = []
    t = 0.0
    for i in range(600):
        # a quiet stretch, a busy one, a quiet one again
        t += float(rng.exponential(2e-4 if 200 <= i < 400 else 4e-3))
        kind = rng.integers(0, 4)
        if kind == 0:
            ops.append(("batch", int(rng.integers(1, 300)),
                        float(rng.uniform(1e-3, 6e-3))))
        elif kind == 1:
            n = int(rng.integers(1, 40))
            close_by = float(t + rng.uniform(-1e-3, 8e-3)) if rng.random() < 0.3 else None
            ops.append(("close", n, t - float(rng.uniform(0, 0.008)), t, close_by))
        else:
            ops.append(("observe", t, int(rng.integers(1, 5))))

    def scenario(pkg):
        c = pkg.tuning.JitBatchController(max_wait_ms=6.0, patience_factor=1.3,
                                          buckets=(1, 8, 32, 128, 256))
        out = []
        for op in ops:
            if op[0] == "observe":
                c.observe(op[1], op[2])
            elif op[0] == "batch":
                c.observe_batch(op[1], op[2])
            else:
                d = c.should_close(op[1], op[2], op[3], close_by=op[4])
                out.append((d.close, d.reason, d.recheck_s))
        return out, c.snapshot(), [c.service.ms(b) for b in (1, 2, 8, 100, 256, 512)]

    decisions, snap, _ = both(scenario)
    assert {r for _, r, _ in decisions} == {"jit", "wait", "deadline"}
    assert sum(snap["decisions"].values()) == len(decisions)


def test_controller_service_model_prior_and_one_point_equal_jax():
    def scenario(pkg):
        c = pkg.tuning.JitBatchController(prior_fixed_ms=0.7, prior_row_us=3.0)
        prior = [c.service.ms(b) for b in (1, 8, 256)]
        c.observe_batch(5, 0.004)
        one = [c.service.ms(b) for b in (1, 8, 256)]
        c.observe_batch(200, 0.009)
        two = [c.service.ms(b) for b in (1, 8, 32, 128, 256)]
        return prior, one, two, c.bucket_for(9), c._next_bucket(256)

    both(scenario)


# ------------------------------------------------------------------- tuner
def _tuner_run(pkg, signal, latencies):
    """Epochs of 5 batches with seeded latencies; ``signal`` injects a
    degraded ladder or an engaged burn from the third epoch's middle on,
    cleared two epochs later. The snapshot after every batch."""
    s = pkg.TuningSettings(enabled=True, tune_interval_batches=5,
                           hysteresis_frac=0.05, tuner_cooldown_epochs=0,
                           inflight_min=1, inflight_max=4)
    c = pkg.tuning.JitBatchController(max_wait_ms=s.deadline_max_ms)
    t = pkg.tuning.ConfigTuner(s, c)
    now, trail = 0.0, []
    for i, lat in enumerate(latencies):
        for ms in lat:
            t.observe_result(ms, n=2)
        now += 0.01
        hot = 12 <= i < 22
        t.on_batch(now, burn_rate=3.0 if hot and signal == "burn" else 0.4,
                   ladder_level=2 if hot and signal == "ladder" else 0)
        trail.append(t.snapshot())
    return trail


@pytest.mark.parametrize("signal", ["calm", "ladder", "burn"])
def test_tuner_moves_and_freeze_equal_jax(signal):
    rng = np.random.default_rng(11)
    # a better regime in epochs 5-8 so some trial is accepted
    latencies = [(rng.gamma(4.0, 1.2, size=16) * (0.5 if 25 <= i < 40 else 1.0)).tolist()
                 for i in range(60)]
    trail = both(lambda pkg: _tuner_run(pkg, signal, latencies))
    counters = trail[-1]["counters"]
    assert counters["trials"] >= 2 and counters["epochs"] == 12
    if signal == "calm":
        assert counters["frozen_epochs"] == 0 and not any(s["frozen"] for s in trail)
    else:
        # a trial in flight reverts at once and no trial starts while hot
        assert counters["frozen_epochs"] >= 1
        assert all(not s["in_trial"] for s in trail[12:22])
        assert any(s["frozen"] for s in trail[12:22]) and not trail[-1]["frozen"]


def test_tuner_sample_decimation_equals_jax():
    """Past EPOCH_LATENCY_CAP the epoch sample halves and doubles its
    stride (deterministic decimation), identically in both packages."""
    rng = np.random.default_rng(5)
    lat = rng.gamma(3.0, 1.0, size=20_000).tolist()

    def scenario(pkg):
        s = pkg.TuningSettings(enabled=True, tune_interval_batches=3)
        t = pkg.tuning.ConfigTuner(s, pkg.tuning.JitBatchController())
        for ms in lat:
            t.observe_result(ms)
        return len(t._latencies), t._lat_stride, t._lat_count, t._objective(1.0)

    n, stride, count, _ = both(scenario)
    assert stride > 1 and count == len(lat) and n < 8192


def test_interpolated_percentile_equals_jax_on_tuner_epoch_samples():
    """The tuner's objective (and the tracer's breakdown) read the port's
    ``interpolated_percentile``: it gives JAX's values on epoch samples."""
    from realtime_fraud_detection_tpu.obs.profiling import (
        interpolated_percentile as jax_percentile,
    )
    from realtime_fraud_detection_tpu_torch.obs.profiling import interpolated_percentile

    rng = np.random.default_rng(9)
    for n in (1, 2, 7, 100, 8191):
        sample = sorted(rng.gamma(3.0, 2.0, size=n).tolist())
        for q in (0.0, 0.5, 0.95, 0.99, 1.0):
            assert interpolated_percentile(sample, q) == jax_percentile(sample, q)


# ------------------------------------------------------------------- plane
def test_tuning_plane_snapshots_equal_jax():
    rng = np.random.default_rng(8)
    arrivals = np.cumsum(rng.exponential(2e-3, 300)).tolist()

    def scenario(pkg):
        p = pkg.tuning.TuningPlane(pkg.TuningSettings(enabled=True,
                                                      tune_interval_batches=4))
        out, first = [], arrivals[0]
        for i, t in enumerate(arrivals):
            p.observe(t)
            d = p.should_close(1 + i % 9, first, t)
            if d.close:
                p.on_batch_complete(1 + i % 9, 0.002 + 1e-5 * (i % 9), t,
                                    latencies_ms=[3.0 + (i % 5)] * 3,
                                    burn_rate=0.0, ladder_level=int(i > 250))
                first = t
            out.append((d.close, d.reason))
        return out, p.snapshot(), p.recommended_inflight_depth()

    both(scenario)


# ---------------------------------------------------------------- settings
def test_tuning_settings_defaults_equal_jax():
    assert dataclasses.asdict(TuningSettings()) == dataclasses.asdict(JaxTuningSettings())
    assert dataclasses.asdict(Config().tuning) == dataclasses.asdict(JaxConfig().tuning)


TUNING_REFUSALS = [
    dict(deadline_min_ms=0.0),
    dict(deadline_min_ms=5.0, deadline_max_ms=1.0),
    dict(bucket_sets=[]),
    dict(bucket_sets=[[]]),
    dict(bucket_sets=[[8, 1]]),
    dict(bucket_sets=[[0, 8]]),
    dict(bucket_sets=[[8, 8, 32]]),
    dict(forecast_alpha=0.0),
    dict(forecast_beta=1.5),
    dict(forecast_bucket_s=0.0),
    dict(tune_interval_batches=0),
    dict(hysteresis_frac=-0.1),
    dict(tuner_cooldown_epochs=-1),
    dict(inflight_min=0),
    dict(inflight_min=3, inflight_max=2),
    dict(patience_factor=0.0),
]


@pytest.mark.parametrize("kw", TUNING_REFUSALS, ids=lambda kw: ",".join(kw))
def test_tuning_settings_refusals_equal_jax(kw):
    got = both(lambda pkg: _raised(lambda: pkg.TuningSettings(**kw).validate()))
    assert got is not None and got[0] == "ValueError"


def test_tuning_qos_floor_and_clamp_equal_jax():
    def scenario(pkg):
        qos = pkg.QosSettings(enabled=True, budget_ms=8.0, assemble_margin_ms=2.0)
        refused = _raised(lambda: pkg.TuningSettings(enabled=True).validate(qos=qos))
        # a disabled tuner imposes nothing; a disabled QoS plane neither
        off = _raised(lambda: pkg.TuningSettings().validate(qos=qos))
        calm = _raised(lambda: pkg.TuningSettings(enabled=True).validate(
            qos=pkg.QosSettings(budget_ms=8.0)))
        clamped = pkg.TuningSettings(enabled=True, deadline_min_ms=7.0)
        clamped.clamp_to_qos(qos)
        cfg = pkg.Config()
        cfg.qos.enabled, cfg.qos.budget_ms, cfg.tuning.enabled = True, 8.0, True
        tree = _raised(cfg.validate)
        return refused, off, calm, dataclasses.asdict(clamped), tree

    refused, off, calm, clamped, tree = both(scenario)
    assert "violates the QoS budget" in refused[1] and tree == refused
    assert off is None and calm is None
    assert clamped["deadline_max_ms"] == 6.0 and clamped["deadline_min_ms"] == 6.0


# ----------------------------------------------------------------- metrics
def _autotune_lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith("autotune_") or ln.startswith(("# HELP autotune_",
                                                            "# TYPE autotune_"))]


def test_autotune_exposition_equals_jax_line_for_line():
    rng = np.random.default_rng(21)
    arrivals = np.cumsum(rng.exponential(1e-3, 200)).tolist()

    def scenario(pkg):
        p = pkg.tuning.TuningPlane(pkg.TuningSettings(enabled=True,
                                                      tune_interval_batches=2))
        m = pkg.Metrics(clock=lambda: 100.0)
        first, texts = arrivals[0], []
        for i, t in enumerate(arrivals):
            p.observe(t)
            if p.should_close(1 + i % 4, first, t).close:
                p.on_batch_complete(1 + i % 4, 0.002, t, latencies_ms=[2.0 + i % 7],
                                    burn_rate=0.0, ladder_level=0)
                first = t
            if i % 50 == 49:
                m.sync_autotune(p.snapshot())
                m.sync_autotune(p.snapshot())        # unchanged: +0
                texts.append(_autotune_lines(m.render_prometheus()))
        return texts, m.autotune_decisions.total()

    texts, total = both(scenario)
    assert total > 0 and all(len(t) > 20 for t in texts)


# --------------------------------------------------------- stream wiring
def _replay(pkg, autotune):
    """The JAX off-path test's replay (a stand-in scorer, batches of 8,
    a 2 ms deadline, 40 records at uneven gaps) through one package's job
    on a virtual clock: (close reason, size) per batch."""
    clock = [0.0]
    broker = pkg.Broker()
    job = pkg.StreamJob(broker, pkg.drill.AutotuneDrillScorer(pkg.drill.AutotuneDrillConfig()),
                        pkg.JobConfig(max_batch=8, max_delay_ms=2.0, emit_features=False,
                                      emit_enriched=False,
                                      autotune=autotune(pkg) if autotune else None))
    job.assembler = pkg.Assembler(job.consumer, max_batch=8, max_delay_ms=2.0,
                                  clock=lambda: clock[0], controller=job.tuning)
    seq = []
    for i in range(40):
        broker.produce(pkg.topics.TRANSACTIONS,
                       {"transaction_id": f"x{i}", "user_id": "u", "amount": 10.0,
                        "timestamp": str(clock[0])}, timestamp=clock[0])
        clock[0] += 0.0003 if i % 7 else 0.004
        batch = job.assembler.next_batch(block=False)
        if batch:
            seq.append((job.assembler.last_close_reason, len(batch)))
            ctx = job.dispatch_batch(batch, now=clock[0])
            if ctx is not None:
                job.complete_batch(ctx, now=clock[0])
    tail = job.assembler.flush()
    if tail:
        seq.append((job.assembler.last_close_reason, len(tail)))
    return seq, dict(job.assembler.close_reasons), (
        job.tuning.snapshot() if job.tuning is not None else None)


@pytest.mark.parametrize("on", [False, True], ids=["fixed_deadline", "autotune"])
def test_assembler_close_decisions_equal_jax(on):
    plane = (lambda pkg: pkg.tuning.TuningPlane(pkg.TuningSettings(enabled=True))) \
        if on else None
    seq, reasons, _ = both(lambda pkg: _replay(pkg, plane))
    if on:
        assert "jit" in reasons and "deadline" not in reasons
    else:
        assert set(reasons) <= {"size", "deadline", "flush"} and "deadline" in reasons
    assert sum(n for _, n in seq) == 40


def test_job_takes_a_plane_follows_its_depth_and_refuses_other_objects():
    plane = port_tuning.TuningPlane(TuningSettings(enabled=True, inflight_min=1,
                                                   inflight_max=6))
    scorer = port_drill.AutotuneDrillScorer(port_drill.AutotuneDrillConfig())
    job = StreamJob(InMemoryBroker(), scorer, JobConfig(pipeline_depth=2, autotune=plane))
    assert job.tuning is plane and job.assembler.controller is plane
    plane.tuner.inflight_depth = 5
    assert job._inflight_depth() == 5
    built = StreamJob(InMemoryBroker(), scorer,
                      JobConfig(autotune=TuningSettings(enabled=True)))
    assert isinstance(built.tuning, port_tuning.TuningPlane)
    off = StreamJob(InMemoryBroker(), scorer, JobConfig(autotune=TuningSettings()))
    assert off.tuning is None and off.assembler.controller is None
    assert off._inflight_depth() == 2
    for bad in (object(), {"enabled": True}, JaxTuningSettings(enabled=True)):
        with pytest.raises(TypeError):
            JobConfig(autotune=bad)
    with pytest.raises(TypeError):
        JobConfig(feedback=object())         # an unported plane stays refused


def test_run_loop_rereads_the_tuned_depth():
    """``run_until_drained`` keeps as many batches in flight as the tuner
    recommends now, not at the loop's start."""
    plane = port_tuning.TuningPlane(TuningSettings(enabled=True, inflight_min=1,
                                                   inflight_max=4))
    scorer = port_drill.AutotuneDrillScorer(port_drill.AutotuneDrillConfig())
    broker = InMemoryBroker()
    job = StreamJob(broker, scorer, JobConfig(max_batch=4, autotune=plane,
                                              emit_features=False))
    depths, in_flight = [], [0]
    dispatch, complete = job.dispatch_batch, job.complete_batch

    def counting_dispatch(records, now=None):
        in_flight[0] += 1
        depths.append(in_flight[0])
        plane.tuner.inflight_depth = 1 if len(depths) < 3 else 3
        return dispatch(records, now=now)

    def counting_complete(ctx, now=None):
        in_flight[0] -= 1
        return complete(ctx, now=now)

    job.dispatch_batch, job.complete_batch = counting_dispatch, counting_complete
    for i in range(40):
        broker.produce(T.TRANSACTIONS, {"transaction_id": f"d{i}", "user_id": "u",
                                        "merchant_id": "m", "amount": 10.0,
                                        "timestamp": "1.0"}, timestamp=1.0)
    assert job.run_until_drained(now=1.0) == 40
    assert depths[:2] == [1, 1] and max(depths) == 3


# ------------------------------------------------------------------ drill
@pytest.fixture(scope="module")
def fast_drills():
    cfg = port_drill.AutotuneDrillConfig.fast()
    jcfg = jax_drill.AutotuneDrillConfig.fast()
    return port_drill.run_autotune_drill(cfg), jax_drill.run_autotune_drill(jcfg)


def test_autotune_drill_fast_summary_equals_jax(fast_drills):
    got, want = fast_drills
    assert got == want
    assert got["passed"] and all(got["checks"].values())
    assert port_drill.compact_autotune_summary(got) == \
        jax_drill.compact_autotune_summary(want)


def test_autotune_drill_cli_prints_the_compact_verdict_last(capsys, fast_drills,
                                                           monkeypatch):
    seen = []

    def run(cfg):
        seen.append(cfg)
        return fast_drills[0]

    monkeypatch.setattr(port_drill, "run_autotune_drill", run)
    assert port_main(["autotune-drill", "--fast"]) == 0
    assert seen == [port_drill.AutotuneDrillConfig.fast()]
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out[-1].encode()) < 2048
    assert json.loads(out[-1]) == json.loads(json.dumps(
        port_drill.compact_autotune_summary(fast_drills[0])))
