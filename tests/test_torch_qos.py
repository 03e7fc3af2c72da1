"""The port's QoS plane, metrics and config layer against the JAX package's,
on the CPU.

Every scenario of ``tests/test_qos.py`` (admission, ladder, budget, plane,
scorer degradation) runs through both packages and the two results must be
equal; the facts that file asserts are asserted on the port's. Then: the
overload drill's summary equals JAX's exactly; a real TINY
``TorchFraudScorer`` stream under QoS (the JAX overlap drill's stream,
``tests/test_host_pipeline.py``) gives JAX's shed set, prediction order and
served rung sequence, with decisions held to the JAX kernel drill's bf16
noise bound floored at 1e-4 (``torch_bounds.py``); the ported metric
families render JAX's exposition lines for the same observations; and the
config layer (file and environment layering, refusals, the quality
artifact) gives JAX's model table.
"""

import torch_threads  # noqa: F401  (first: torch held to one CPU thread)
import dataclasses
import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import realtime_fraud_detection_tpu.qos as jax_qos
import realtime_fraud_detection_tpu_torch.qos as port_qos
from realtime_fraud_detection_tpu.ensemble.combine import (
    EnsembleParams as JaxEnsembleParams,
)
from realtime_fraud_detection_tpu.obs.metrics import (
    MetricsCollector as JaxMetricsCollector,
)
from realtime_fraud_detection_tpu.scoring import FraudScorer
from realtime_fraud_detection_tpu.scoring import ScorerConfig as JaxScorerConfig
from realtime_fraud_detection_tpu.sim.simulator import (
    TransactionGenerator as JaxTransactionGenerator,
)
from realtime_fraud_detection_tpu.stream import InMemoryBroker as JaxInMemoryBroker
from realtime_fraud_detection_tpu.stream import JobConfig as JaxJobConfig
from realtime_fraud_detection_tpu.stream import StreamJob as JaxStreamJob
from realtime_fraud_detection_tpu.stream import topics as JT
from realtime_fraud_detection_tpu.utils.config import Config as JaxConfig
from realtime_fraud_detection_tpu.utils.config import QosSettings as JaxQosSettings
from realtime_fraud_detection_tpu_torch.bridge import models_from_numpy
from realtime_fraud_detection_tpu_torch.ensemble.combine import EnsembleParams
from realtime_fraud_detection_tpu_torch.obs.metrics import MetricsCollector
from realtime_fraud_detection_tpu_torch.qos.plane import QosPlane
from realtime_fraud_detection_tpu_torch.scoring.pipeline import MODEL_NAMES, ScorerConfig
from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
from realtime_fraud_detection_tpu_torch.stream import topics as T
from realtime_fraud_detection_tpu_torch.stream.job import JobConfig, StreamJob
from realtime_fraud_detection_tpu_torch.stream.transport import InMemoryBroker
from realtime_fraud_detection_tpu_torch.utils.config import (
    Config,
    KernelSettings,
    ModelConfig,
    QosSettings,
)
from torch_bounds import near_rung, noise_bound

JAX = SimpleNamespace(qos=jax_qos, Config=JaxConfig, QosSettings=JaxQosSettings)
PORT = SimpleNamespace(qos=port_qos, Config=Config, QosSettings=QosSettings)
QUALITY_ARTIFACT = "QUALITY_r05.json"


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


# ------------------------------------------------------------- admission
class TestAdmission:
    def test_token_bucket_refills_at_rate(self):
        def scenario(p):
            b = p.qos.TokenBucket(rate=10.0, burst=5.0)
            b.refill(0.0)
            for _ in range(5):
                b.take()
            seen = [b.tokens]
            b.refill(0.25)                  # +2.5 tokens
            seen.append(b.tokens)
            b.refill(10.0)                  # capped at burst
            return seen + [b.tokens]

        got = both(scenario)
        assert got[0] == 0.0
        assert got[1] == pytest.approx(2.5)
        assert got[2] == 5.0

    def test_high_never_shed_low_sheds_first(self):
        def scenario(p):
            c = p.qos.AdmissionController(rate=10.0, burst=4.0,
                                          low_reserve_frac=0.25)
            out = [c.decide("normal", 0.0) for _ in range(6)]
            out += [c.decide("high", 0.0), c.decide("low", 0.0)]
            c2 = p.qos.AdmissionController(rate=10.0, burst=4.0,
                                           low_reserve_frac=0.25)
            c2.decide("normal", 0.0)
            c2.decide("normal", 0.0)
            c2.bucket.tokens = 1.9
            out += [c2.decide("low", 0.0), c2.decide("normal", 0.0)]
            return [dataclasses.astuple(d) for d in out]

        got = both(scenario)
        assert [d[0] for d in got[:6]] == [True] * 4 + [False] * 2
        assert got[5][2] == "shed:rate_limit"
        assert got[6][0]                              # high admits in debt
        assert not got[7][0] and got[7][2] == "shed:low_reserve"
        assert not got[8][0] and got[9][0]

    def test_rate_zero_is_unlimited(self):
        def scenario(p):
            c = p.qos.AdmissionController(rate=0.0)
            return [dataclasses.astuple(c.decide(pr, 0.0))
                    for pr in ("high", "normal", "low")]

        for admitted, _, reason, _ in both(scenario):
            assert admitted and reason == "unlimited"


# ----------------------------------------------------------------- ladder
class TestLadder:
    def test_hysteresis_requires_consecutive_observations(self):
        def scenario(p):
            ladder = p.qos.DegradationLadder(p.qos.LadderConfig(
                high_backlog=100, low_backlog=10, patience=2))
            levels = [ladder.observe(b) for b in
                      (500, 50, 500, 500, 5, 50, 5, 5)]
            return levels, ladder.transitions_down, ladder.transitions_up

        levels, down, up = both(scenario)
        assert levels == [0, 0, 0, 1, 1, 1, 1, 0]
        assert (down, up) == (1, 1)

    def test_up_patience_slows_recovery(self):
        def scenario(p):
            ladder = p.qos.DegradationLadder(p.qos.LadderConfig(
                high_backlog=100, low_backlog=10, patience=2, up_patience=5))
            ladder.observe(500)
            ladder.observe(500)
            return [ladder.level] + [ladder.observe(0) for _ in range(5)]

        assert both(scenario) == [1, 1, 1, 1, 1, 0]

    def test_ladder_masks_follow_the_documented_rungs(self):
        def scenario(p):
            ladder = p.qos.DegradationLadder(p.qos.LadderConfig(
                high_backlog=1, low_backlog=0, patience=1))
            masks = []
            for _ in range(3):
                ladder.observe(10)
                masks.append(ladder.level_mask(MODEL_NAMES).tolist())
            return masks, ladder.current.rules_only, ladder.snapshot()

        masks, rules_only, _ = both(scenario)
        names = np.asarray(MODEL_NAMES)
        assert list(names[~np.asarray(masks[0])]) == ["bert_text", "graph_neural"]
        assert set(names[np.asarray(masks[1])]) == {"xgboost_primary",
                                                    "isolation_forest"}
        assert not any(masks[2]) and rules_only

    def test_never_steps_past_the_ends(self):
        def scenario(p):
            ladder = p.qos.DegradationLadder(p.qos.LadderConfig(
                high_backlog=1, low_backlog=0, patience=1))
            down = [ladder.observe(100) for _ in range(10)]
            up = [ladder.observe(0) for _ in range(10)]
            return down, up

        down, up = both(scenario)
        assert down[-1] == 3 and up[-1] == 0


# ----------------------------------------------------------------- budget
class TestBudget:
    def test_remaining_and_close_by(self):
        def scenario(p):
            b = p.qos.LatencyBudget(budget_ms=20.0, margin_ms=2.0)
            return [b.remaining_ms(100.0, 100.0), b.remaining_ms(100.0, 100.015),
                    b.remaining_ms(100.0, 100.025), b.should_close(100.0, 100.017),
                    b.should_close(100.0, 100.0181)]

        got = both(scenario)
        assert got[:3] == pytest.approx([20.0, 5.0, -5.0])
        assert got[3:] == [False, True]

    def test_config_validates_budget_and_watermarks(self):
        def scenario(p):
            return [
                _raised(lambda: p.Config(qos=p.QosSettings(
                    budget_ms=5.0, assemble_margin_ms=5.0))),
                _raised(lambda: p.Config(qos=p.QosSettings(
                    ladder_low_backlog=100, ladder_high_backlog=10))),
            ]

        margin, marks = both(scenario)
        assert margin[0] == "ValueError" and "assemble_margin_ms" in margin[1]
        assert marks[0] == "ValueError" and "watermarks" in marks[1]


# ------------------------------------------------------------------ plane
def _qos_lines(text):
    """The exposition lines of the qos_* families."""
    return [ln for ln in text.splitlines()
            if ln.startswith(("qos_", "# HELP qos_", "# TYPE qos_"))]


class TestPlane:
    def test_classify_by_amount_and_explicit_priority(self):
        def scenario(p):
            plane = p.qos.QosPlane(p.QosSettings(high_value_amount=500,
                                                 low_value_amount=25))
            return [plane.classify(t) for t in (
                {"amount": 900}, {"amount": 100}, {"amount": 5},
                {"amount": 5, "priority": "high"}, {"amount": "garbage"})]

        assert both(scenario) == ["high", "normal", "low", "high", "low"]

    def test_shed_result_carries_reason_on_the_score_schema(self):
        def scenario(p):
            plane = p.qos.QosPlane(p.QosSettings(enabled=True, admission_rate=1.0,
                                                 admission_burst=1.0))
            txn = {"transaction_id": "t1", "amount": 5.0}
            plane.admit(txn, 0.0)
            decision = plane.admission.decide("low", 0.0)
            return plane.shed_result(txn, decision), plane.snapshot()

        res, _ = both(scenario)
        for field in ("transaction_id", "fraud_probability", "fraud_score",
                      "risk_level", "decision", "model_predictions",
                      "confidence", "processing_time_ms", "explanation"):
            assert field in res, field
        assert (res["risk_level"], res["decision"]) == ("SHED", "REVIEW")
        assert res["explanation"]["shed"] is True
        assert res["explanation"]["shed_reason"].startswith("shed:")
        assert res["explanation"]["priority"] == "low"

    def test_metrics_flow_to_prometheus_exposition(self):
        def scenario(p):
            plane = p.qos.QosPlane(p.QosSettings(enabled=True, admission_rate=2.0,
                                                 admission_burst=2.0))
            plane.admit({"amount": 900}, 0.0)
            plane.admit({"amount": 5}, 0.0)
            plane.observe_backlog(0)
            return _qos_lines(plane.metrics.render_prometheus())

        text = "\n".join(both(scenario))
        assert 'qos_admitted_total{priority="high"} 1' in text
        assert 'qos_shed_total{priority="low",reason="shed:low_reserve"} 1' in text
        assert "qos_ladder_level 0" in text
        assert "qos_budget_remaining_seconds_bucket" in text

    def test_configure_rejects_unknown_and_applies_known(self):
        def scenario(p):
            plane = p.qos.QosPlane(p.QosSettings())
            err = _raised(lambda: plane.configure({"nope": 1}))
            applied = plane.configure({"enabled": True, "budget_ms": 15,
                                       "admission_rate": 100})
            return (err, applied, plane.enabled, plane.budget.budget_ms,
                    plane.admission.bucket.rate)

        err, applied, enabled, budget, rate = both(scenario)
        assert "unknown qos setting" in err[1]
        assert applied == {"enabled": True, "budget_ms": 15.0,
                           "admission_rate": 100.0}
        assert enabled and budget == 15.0 and rate == 100.0

    def test_configure_rederives_burst_from_the_new_rate(self):
        def scenario(p):
            plane = p.qos.QosPlane(p.QosSettings())
            bursts = [plane.admission.bucket.burst]
            plane.configure({"enabled": True, "admission_rate": 20_000})
            bursts.append(plane.admission.bucket.burst)
            plane.configure({"admission_burst": 500.0})
            return bursts + [plane.admission.bucket.burst]

        assert both(scenario) == [1.0, 20_000.0, 500.0]

    def test_configure_enforces_load_time_invariants(self):
        def scenario(p):
            plane = p.qos.QosPlane(p.QosSettings())
            out = [_raised(lambda: plane.configure({"assemble_margin_ms": 25.0})),
                   plane.settings.assemble_margin_ms,
                   _raised(lambda: plane.configure({"ladder_low_backlog": 5000.0})),
                   plane.settings.ladder_low_backlog,
                   _raised(lambda: plane.configure({"budget_ms": 0}))]
            return out

        margin, kept_margin, marks, kept_low, budget = both(scenario)
        assert "assemble_margin_ms" in margin[1] and kept_margin == 2.0
        assert "watermarks" in marks[1] and kept_low == 256.0
        assert "budget" in budget[1]

    def test_configure_rejects_stringly_typed_booleans(self):
        def scenario(p):
            plane = p.qos.QosPlane(p.QosSettings())
            return (_raised(lambda: plane.configure({"enabled": "false"})),
                    plane.enabled,
                    _raised(lambda: plane.configure({"admission_rate": "100"})))

        boolean, enabled, number = both(scenario)
        assert "boolean" in boolean[1] and not enabled
        assert "number" in number[1]


# ------------------------------------------------------- scorer degradation
@pytest.fixture(scope="module")
def scorers():
    """The JAX ``FraudScorer`` of ``tests/test_qos.py`` and the port's
    scorer on the same (bridged) models and profiles."""
    jgen = JaxTransactionGenerator(num_users=16, num_merchants=8, seed=5)
    jscorer = FraudScorer(scorer_config=JaxScorerConfig(text_len=32))
    jscorer.seed_profiles(jgen.users.profiles(), jgen.merchants.profiles())
    jax_models = jax.tree_util.tree_map(np.asarray, jscorer.models)
    gen = TransactionGenerator(num_users=16, num_merchants=8, seed=5)
    scorer = TorchFraudScorer(models=models_from_numpy(jax_models),
                              scorer_config=ScorerConfig(text_len=32), device="cpu")
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    return SimpleNamespace(jax=(jscorer, jgen), port=(scorer, gen),
                           models=jax_models)


def _keep_tokens(scorer, sink):
    """Append each batch's (ids, mask) the JAX scorer assembles to
    ``sink``: the noise bound is measured on the run's own tokens."""
    assemble = scorer.assemble

    def keep(*args, **kwargs):
        batch = assemble(*args, **kwargs)
        sink.append((np.asarray(batch.token_ids), np.asarray(batch.token_mask)))
        return batch

    scorer.assemble = keep


def _held(preds, jpreds, bound):
    """Same ids and branches; fraud_score within ``bound``; decision and
    risk level equal on every row whose JAX probability and confidence lie
    farther than ``bound`` from a rung. Returns the rows skipped."""
    assert [p["transaction_id"] for p in preds] == [q["transaction_id"] for q in jpreds]
    prob = np.array([q["fraud_probability"] for q in jpreds])
    conf = np.array([q["confidence"] for q in jpreds])
    near = near_rung(prob, bound) | near_rung(conf, bound)
    for p, q, skip in zip(preds, jpreds, near):
        assert set(p["model_predictions"]) == set(q["model_predictions"])
        assert abs(p["fraud_score"] - q["fraud_score"]) <= bound
        if not skip:
            assert (p["decision"], p["risk_level"]) == (q["decision"], q["risk_level"])
    return int(near.sum())


def _score_both(scorers, n, now, mask=None, rules_only=False, level=0):
    """One batch through both scorers at a rung; returns (port, JAX, bound)."""
    out, tokens = [], []
    _keep_tokens(scorers.jax[0], tokens)
    try:
        for scorer, gen in (scorers.port, scorers.jax):
            txns = gen.generate_batch(n)
            scorer.set_degradation(mask, rules_only=rules_only, level=level)
            try:
                out.append(scorer.score_batch(txns, now=now))
            finally:
                scorer.set_degradation(None)
    finally:
        del scorers.jax[0].assemble
    weights = JaxEnsembleParams.from_config(JaxConfig(), MODEL_NAMES).weights
    valid = np.ones(5, bool) if mask is None else mask
    return out[0], out[1], noise_bound(scorers.models.bert, tokens, weights, valid)


class TestScorerDegradation:
    def test_mask_narrows_model_predictions(self, scorers):
        full, jfull, bound = _score_both(scorers, 4, 1000.0)
        assert set(full[0]["model_predictions"]) == set(MODEL_NAMES)
        assert _held(full, jfull, bound) == 0
        mask = np.asarray([n not in ("bert_text", "graph_neural") for n in MODEL_NAMES])
        degraded, jdegraded, bound = _score_both(scorers, 4, 1001.0, mask, level=1)
        assert _held(degraded, jdegraded, bound) == 0
        assert set(degraded[0]["model_predictions"]) == \
            set(MODEL_NAMES) - {"bert_text", "graph_neural"}

    def test_rules_only_serves_the_rule_score(self, scorers):
        results, jresults, _ = _score_both(scorers, 4, 1002.0, np.zeros(5, bool),
                                           rules_only=True, level=3)
        keys = ("transaction_id", "fraud_probability", "confidence", "decision",
                "risk_level", "model_predictions")
        assert [[r[k] for k in keys] for r in results] == \
            [[r[k] for k in keys] for r in jresults]
        for r in results:
            assert r["model_predictions"] == {}
            assert r["explanation"]["degraded"] == "rules_only"
            assert r["fraud_probability"] == pytest.approx(
                r["explanation"]["rule_score"], abs=1e-6)
            assert r["confidence"] == 1.0
            assert r["decision"] in ("APPROVE", "APPROVE_WITH_MONITORING",
                                     "REVIEW", "DECLINE")


# ------------------------------------------------------------------ drill
def test_overload_drill_summary_equals_jax():
    kw = dict(offered_multiplier=2.0, overload_s=1.0, recovery_s=1.0, seed=7)
    got = port_qos.run_overload_drill(**kw)
    assert got == jax_qos.run_overload_drill(**kw)
    assert got["max_ladder_level"] == 3 and got["ladder"]["level"] == 0
    assert got["p99_within_budget"] and got["shed"] > 0
    assert set(got["shed_by_priority_reason"]) == {"low:shed:low_reserve"}


# ----------------------------------------------- a real scorer under QoS
QOS_CASES = {
    # the JAX overlap drill's settings (tests/test_host_pipeline.py)
    "admission": dict(enabled=True, admission_rate=50.0, admission_burst=120.0),
    # watermarks low enough for the 192-record stream to step the ladder
    "ladder": dict(enabled=True, admission_rate=50.0, admission_burst=120.0,
                   ladder_high_backlog=64.0, ladder_low_backlog=32.0,
                   ladder_patience=1, ladder_up_patience=1),
}


def _qos_stream(side, models, settings, overlap):
    """The JAX overlap drill's stream (60 users, 20 merchants, seed 13, 192
    records at amounts 5 / 100 / 900, batches of 32, admission at t=500)
    through one package's job; returns predictions in topic order, the
    served rung after each dispatch and the counters."""
    if side == "port":
        gen = TransactionGenerator(num_users=60, num_merchants=20, seed=13)
        scorer = TorchFraudScorer(models=models_from_numpy(models), device="cpu")
        broker, topics = InMemoryBroker(), T
        job = StreamJob(broker, scorer, JobConfig(
            max_batch=32, overlap_assembly=overlap, pipeline_depth=2,
            qos=QosSettings(**settings), emit_features=False))
    else:
        gen = JaxTransactionGenerator(num_users=60, num_merchants=20, seed=13)
        scorer = FraudScorer(models=models)
        broker, topics = JaxInMemoryBroker(), JT
        job = JaxStreamJob(broker, scorer, JaxJobConfig(
            max_batch=32, overlap_assembly=overlap, pipeline_depth=2,
            qos=JaxQosSettings(**settings), emit_features=False))
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    if side == "port" and overlap:
        _serial_interleaving(job)
    tokens = []
    if side == "jax":
        _keep_tokens(scorer, tokens)
    rng = np.random.default_rng(3)
    recs = gen.generate_batch(192)
    for r in recs:      # spread priorities so sheds hit a defined subset
        r["amount"] = float(rng.choice([5.0, 100.0, 900.0]))
    rungs = []
    dispatch = job.dispatch_batch

    def record_rung(records, now=None):
        ctx = dispatch(records, now=now)
        rungs.append(job.qos.effective_level())
        return ctx

    job.dispatch_batch = record_rung
    broker.produce_batch(topics.TRANSACTIONS, recs, key_fn=lambda r: str(r["user_id"]))
    try:
        job.run_until_drained(now=500.0)
    finally:
        job.close()
    preds = [p.value for p in broker.consumer([topics.PREDICTIONS], "check").poll(1000)]
    return dict(preds=preds, rungs=rungs, counters=dict(job.counters),
                ladder=job.qos.ladder.snapshot(), recs=recs, tokens=tokens)


def _serial_interleaving(job):
    """Pin the overlapped job's interleaving to the serial job's: each
    submitted batch is assembled and dispatched on the stage thread before
    the job goes on, so (as in the serial loop) batch N+1 is assembled after
    its own rung was applied and before batch N writes back. Without this,
    which rung a batch reads and which write-backs land before its assembly
    depend on thread timing, and with them its features, decisions and the
    alert counter."""
    stage = job._stage
    submit = stage.submit

    def submit_and_wait(*args, **kw):
        handle = submit(*args, **kw)
        try:
            handle.result()
        except Exception:           # surfaces at the batch's own completion
            pass
        return handle

    stage.submit = submit_and_wait


_JAX_STREAMS = {}


def _jax_qos_stream(models, case):
    """The JAX job's run of a case (serial), once per module."""
    if case not in _JAX_STREAMS:
        _JAX_STREAMS[case] = _qos_stream("jax", models, QOS_CASES[case], False)
    return _JAX_STREAMS[case]


@pytest.fixture(scope="module")
def jax_models():
    return jax.tree_util.tree_map(
        np.asarray, FraudScorer(scorer_config=JaxScorerConfig(), seed=3).models)


@pytest.mark.parametrize("overlap", [False, True], ids=["serial", "overlap"])
@pytest.mark.parametrize("case", sorted(QOS_CASES))
def test_scorer_stream_under_qos_matches_jax(jax_models, case, overlap):
    """Shed set, prediction order, the served rung per dispatched batch and
    the counters equal the JAX job's; decisions match within the bound.
    Under overlapped assembly the job's interleaving is pinned to the
    serial one (``_serial_interleaving``): which rung a batch reads and
    which write-back lands before its assembly otherwise depend on timing
    (in both packages)."""
    settings = QOS_CASES[case]
    got = _qos_stream("port", jax_models, settings, overlap)
    want = _jax_qos_stream(jax_models, case)
    assert got["recs"] == want["recs"]
    ids = [p["transaction_id"] for p in got["preds"]]
    assert ids == [p["transaction_id"] for p in want["preds"]]
    assert sorted(ids) == sorted(r["transaction_id"] for r in got["recs"])
    shed = {p["transaction_id"]: p["explanation"] for p in got["preds"]
            if p["explanation"].get("shed")}
    assert shed == {p["transaction_id"]: p["explanation"] for p in want["preds"]
                    if p["explanation"].get("shed")}
    assert 0 < len(shed) < 192
    assert all(e["priority"] != "high" for e in shed.values())
    assert got["rungs"] == want["rungs"] and got["ladder"] == want["ladder"]
    assert got["counters"] == want["counters"]
    if case == "ladder":
        assert max(got["rungs"]) >= 1 and got["ladder"]["transitions_down"] >= 1
    else:
        assert set(got["rungs"]) == {0}
    # the bound of the full rung covers every lower one (BERT's share only
    # shrinks down the ladder)
    weights = JaxEnsembleParams.from_config(JaxConfig(), MODEL_NAMES).weights
    bound = noise_bound(jax_models.bert, want["tokens"], weights, np.ones(5, bool))
    scored = [(p, q) for p, q in zip(got["preds"], want["preds"])
              if not q["explanation"].get("shed")]
    assert _held([p for p, _ in scored], [q for _, q in scored], bound) == 0


def test_job_config_takes_a_plane_and_refuses_other_objects():
    plane = QosPlane(QosSettings(enabled=True))
    gen = TransactionGenerator(num_users=4, num_merchants=2, seed=1)
    job = StreamJob(InMemoryBroker(), TorchFraudScorer(device="cpu", seed=1),
                    JobConfig(qos=plane))
    assert job.qos is plane and job.assembler.budget is plane.budget
    off = StreamJob(InMemoryBroker(), TorchFraudScorer(device="cpu", seed=1),
                    JobConfig(qos=QosSettings()))
    assert off.qos is None and off.assembler.budget is None
    for bad in (object(), {"enabled": True}, JaxQosSettings(enabled=True)):
        with pytest.raises(TypeError):
            JobConfig(qos=bad)
    del gen


def test_budget_close_runs_before_the_deadline_and_nothing_changes_without_one():
    """A budget close fires as soon as the oldest record's budget runs low,
    ahead of the deadline trigger, in both packages; without a budget the
    assembler closes the same batches as before (size, then deadline)."""
    from realtime_fraud_detection_tpu.stream.microbatch import (
        MicrobatchAssembler as JaxAssembler,
    )
    from realtime_fraud_detection_tpu_torch.stream.microbatch import (
        MicrobatchAssembler,
    )

    def scenario(broker_cls, assembler_cls, budget_cls, with_budget):
        broker = broker_cls()
        consumer = broker.consumer([T.TRANSACTIONS], "g")
        clock = [0.0]
        budget = budget_cls(budget_ms=20.0, margin_ms=2.0) if with_budget else None
        asm = assembler_cls(consumer, max_batch=8, max_delay_ms=50.0,
                            clock=lambda: clock[0], budget=budget,
                            budget_clock=lambda: clock[0])
        closes = []
        for step in range(40):
            broker.produce(T.TRANSACTIONS, {"i": step}, key="k", timestamp=clock[0])
            if step % 3 == 0:
                broker.produce(T.TRANSACTIONS, {"i": -step}, key="k",
                               timestamp=clock[0] - 0.015)
            batch = asm.next_batch(block=False)
            if batch:
                closes.append((asm.last_close_reason, len(batch), round(clock[0], 4)))
            clock[0] += 0.004
        return closes, dict(asm.close_reasons)

    for with_budget in (True, False):
        got = scenario(InMemoryBroker, MicrobatchAssembler, port_qos.LatencyBudget,
                       with_budget)
        want = scenario(JaxInMemoryBroker, JaxAssembler, jax_qos.LatencyBudget,
                        with_budget)
        assert got == want
        assert ("budget" in got[1]) == with_budget


# ---------------------------------------------------------------- metrics
# families whose help text names the device layer: their sample lines are
# compared, their HELP lines differ (Pallas / XLA / VMEM in the JAX package)
DEVICE_HELP = ("kernel_site_mode", "kernel_dispatch_total", "kernel_fallback_total",
               "kernel_mega_fallback_total")
PORT_ONLY = {"host_stage_seconds_total", "host_stage_count_total"}


def _observe(m, kernel_mode):
    m.record_prediction("APPROVE", 0.12, 0.004, {"xgboost_primary": 0.1})
    m.record_prediction("DECLINE", 0.97, 0.03, {"xgboost_primary": 0.9,
                                                  "bert_text": 0.8})
    m.record_prediction("REVIEW", float("nan"), 0.5)
    m.record_batch(32, 0.012)
    m.record_batch(256, 0.4)
    m.record_error("finalize")
    m.qos_admitted.inc(priority="high")
    m.qos_shed.inc(3, priority="low", reason="shed:low_reserve")
    m.qos_ladder_level.set(2)
    m.qos_ladder_transitions.inc(direction="down")
    m.qos_degraded_scored.inc(64, level="trees_iforest")
    for v in (-0.03, -0.001, 0.0, 0.004, 0.019, 0.2):
        m.qos_budget_remaining.observe(v)
    m.sync_microbatch({"size": 5, "deadline": 2, "budget": 3})
    m.sync_microbatch({"size": 7, "deadline": 1, "budget": 4, "flush": 1})
    stages = {"assemble": {"count": 3, "total_s": 0.0045, "mean_ms": 1.5,
                           "p50_ms": 1.25, "p99_ms": 4.0},
              "pack": {"count": 3, "total_s": 0.00075, "mean_ms": 0.25,
                       "p50_ms": 0.2, "p99_ms": 0.5}}
    m.sync_host_stats({"caches": {"tokens": {"hits": 10, "misses": 4},
                                  "entity_rows": {"hits": 3, "misses": 9}},
                       "stages": stages})
    m.sync_host_stats({"caches": {"tokens": {"hits": 25, "misses": 5}},
                       "stages": stages})
    snap = {"modes": {"dequant_matmul": kernel_mode, "epilogue": kernel_mode,
                      "attention": "flash", "megakernel": "off"},
            "dispatch": {"dequant_matmul": 3, "epilogue": 3, "attention": 3,
                         "megakernel": 2},
            "fallback": {"dequant_matmul": 1, "epilogue": 0, "attention": 0,
                         "megakernel": 1},
            "launches_per_batch": 7}
    m.sync_kernels(snap)
    m.sync_kernels(dict(snap, dispatch=dict(snap["dispatch"], megakernel=5)))
    m.sync_graph({"mode": "typed",
                  "store": {"nodes": {"user": 5, "ip": 2},
                            "edges": {"user->ip": 4}, "edges_added": 6},
                  "sampler": {"hits": 2, "misses": 8, "evictions": 1, "entries": 7},
                  "fetch": {"remote_fetch_total": 9, "fetched_nodes_total": 40,
                            "fetch_deadline_total": 1, "fetch_error_total": 2,
                            "budget_exhausted_total": 3, "stale_generation_total": 1,
                            "degraded_batches_total": 4}})
    m.sync_graph({"mode": "bipartite"})
    m.queue_depth.set(3)
    m.sync_quant({"modes": {"bert_text": "int8", "xgboost_primary": "gemm",
                            "isolation_forest": "gather"},
                  "param_bytes": {"bert_text": 4445168}, "gate": {"pass": 2, "fail": 0}})
    m.sync_quant({"modes": {"bert_text": "f32"}, "gate": {"pass": 3, "fail": 1}})
    pool = {"healthy": 1, "devices": [
        {"device": "r0", "dispatched": 4, "completed": 3, "retries": 0,
         "queue_wait_ms": 1.5, "inflight": 1},
        {"device": "r1", "dispatched": 2, "completed": 2, "retries": 1,
         "queue_wait_ms": 0.0, "inflight": 0}]}
    m.sync_device_pool(pool)
    m.sync_device_pool(dict(pool, devices=[dict(pool["devices"][0], dispatched=6),
                                           pool["devices"][1]]))
    m.sync_cluster({"workers_alive": 3, "workers": {"w0": {"partitions_owned": 5},
                                                    "w1": {"partitions_owned": 7}},
                    "handoffs_total": 4, "last_replay_depth": 17,
                    "router": {"moved_keys_total": 4}})
    m.sync_cluster({"workers_alive": 3, "workers": {"w0": {"partitions_owned": 6}},
                    "router": {"moved_keys_total": 6}})
    m.sync_chaos({"windows": [{"fault": "broker_outage", "begun": True, "active": True},
                              {"fault": "label_stall", "begun": False}],
                  "recovery_s": {"flash_crowd": 0.75}})
    m.sync_autoscale({"target_workers": 6, "forecast_rate": 512.3,
                      "events": {"up": 2, "down": 1},
                      "handoff_server": {"checkpoints_total": 10, "restores_total": 3,
                                         "torn_blobs_total": 1}})
    m.sync_netfaults({"links": {"worker-w0->broker": {
        "active": True, "windows_begun": 1, "delayed_sends_total": 7,
        "dropped_sends_total": 1, "partitioned_sends_total": 5,
        "lost_responses_total": 0, "throttled_bytes_total": 2048}},
        "fencing": {"fenced_produces_total": 2, "fenced_commits_total": 1}})
    mesh = {"data_axis": 4, "model_axis": 2, "replicas": 2,
            "placement": {n: ("sharded" if n == "bert_text" else "replicated")
                          for n in ("xgboost_primary", "lstm_sequential", "bert_text",
                                    "graph_neural", "isolation_forest")},
            "param_bytes": {"bert_text": {"per_chip": 8545800, "replicated": 17017352},
                            "graph_neural": {"per_chip": 26372, "replicated": 26372}},
            "dispatched": {"0": 3, "1": 2}, "completed": {"0": 3, "1": 1}}
    m.sync_mesh(mesh)
    m.sync_mesh(dict(mesh, dispatched={"0": 5, "1": 2}))


def _family_lines(text, names):
    """The exposition lines of the families ``names``, in render order."""
    keep = []
    for ln in text.splitlines():
        body = ln.split(" ", 3)[2] if ln.startswith(("# HELP ", "# TYPE ")) else ln
        base = body.split("{")[0].split(" ")[0]
        for suffix in ("_bucket", "_sum", "_count"):
            if base.endswith(suffix) and base[: -len(suffix)] in names:
                base = base[: -len(suffix)]
        if base in names:
            keep.append(ln)
    return keep


def test_metric_exposition_equals_jax_line_for_line():
    clock = lambda: 1000.0                                     # noqa: E731
    port, ref = MetricsCollector(clock=clock), JaxMetricsCollector(clock=clock)
    _observe(port, "cuda")
    _observe(ref, "pallas")
    text = port.render_prometheus()
    # the stage table's cumulative counters are the port's own (the JAX
    # package's stage stats are a sample ring with no running totals)
    names = {ln.split(" ")[2] for ln in text.splitlines()
             if ln.startswith("# TYPE ")} - PORT_ONLY
    got = _family_lines(text, names)
    want = _family_lines(ref.render_prometheus(), names)
    own = _family_lines(text, PORT_ONLY)
    assert 'host_stage_count_total{stage="assemble"} 3' in own
    assert 'host_stage_seconds_total{stage="pack"} 0.00075' in own
    # 33 families, the tracing plane's 6 trace_* and the tuning plane's 7
    # autotune_* ones, the serving queue's, the quant plane's 3 quant_*, the
    # feedback plane's 4 prequential_* and 6 feedback_* ones, the device
    # pool's 6 device_pool_* and the cluster plane's 5 cluster_* ones, the
    # chaos plane's 3 chaos_*, the elastic fleet's 3 autoscale_* and 3
    # handoff_server_* ones, the network fault plane's 7 netfault_* and the
    # broker fence's 2 fenced_* ones, the graph fetch plane's 7 graph_* ones,
    # the mesh executor's 8 mesh_* ones
    assert len(names) == 104 and len(got) == len(want)
    # the JAX package's mode "pallas" is the port's "cuda", which sorts to
    # another place among the site-mode samples: compare those as sets
    want = [w.replace('mode="pallas"', 'mode="cuda"') for w in want]
    modes = [ln for ln in got if ln.startswith("kernel_site_mode{")]
    assert sorted(modes) == sorted(w for w in want if w.startswith("kernel_site_mode{"))
    for g, w in zip(got, want):
        if g in modes:
            continue
        if g.startswith("# HELP ") and g.split(" ")[2] in DEVICE_HELP:
            assert w.split(" ")[2] == g.split(" ")[2]
            continue
        assert g == w
    assert 'microbatch_close_reason_total{reason="budget"} 4' in got
    # json: the NaN score makes the average NaN on both sides
    assert json.dumps(port.summary()) == json.dumps(ref.summary())
    port.reset()
    ref.reset()
    assert json.dumps(port.summary()) == json.dumps(ref.summary())


def test_histogram_quantiles_deltas_and_exemplars_equal_jax():
    from realtime_fraud_detection_tpu.obs import metrics as jax_metrics
    from realtime_fraud_detection_tpu_torch.obs import metrics as port_metrics

    def scenario(m):
        h = m.Histogram("trace_stage_ms", "Stage ms", ("stage",),
                        buckets=(1.0, 5.0, 25.0))
        for v in (0.5, 3.0, 3.0, 40.0, float("inf")):
            h.observe(v, stage="assemble")
        h.add_bucket_deltas([1, 0, 2, 1], 61.5, max_value=90.0,
                            exemplar={"value": 4.2, "trace_id": "t-7"}, stage="pack")
        err = _raised(lambda: h.add_bucket_deltas([1, 2], 1.0, stage="pack"))
        neg = _raised(lambda: h.add_bucket_deltas([0, -1, 0, 0], 1.0))
        reg = m.Registry()
        reg.register(h)
        dup = _raised(lambda: reg.counter("trace_stage_ms", "again"))
        c = reg.counter("events_total", "Events", ("kind",))
        c.inc(2, kind="b")
        c.inc(kind="a")
        quantiles = [h.quantile(q, stage=st) for st in ("assemble", "pack", "none")
                     for q in (0.1, 0.5, 0.99)]
        return (reg.render(), quantiles, h.count(stage="pack"), h.sum(stage="pack"),
                c.by_label(), c.total(), err, neg, dup)

    got, want = scenario(port_metrics), scenario(jax_metrics)
    assert got == want
    assert "# exemplar trace_stage_ms_bucket" in got[0] and got[2] == 4


# ----------------------------------------------------------- config layer
ENV_NAMES = [f"{prefix}{name}" for prefix in ("RTFD_", "")
             for name in ("ENSEMBLE_STRATEGY", "CONFIDENCE_THRESHOLD",
                          "FRAUD_THRESHOLD")]


@pytest.fixture
def env(monkeypatch):
    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _on_port_keys(value, like):
    """``value`` (a JAX-side dict tree) cut to the keys of ``like`` (the
    port's): the port's blocks leave out knobs of tiers it does not have,
    such as the serving tier's prediction cache."""
    if isinstance(value, dict) and isinstance(like, dict):
        return {k: _on_port_keys(value.get(k), like[k]) for k in like}
    if isinstance(value, tuple) and isinstance(like, tuple):
        return tuple(_on_port_keys(v, lk) for v, lk in zip(value, like))
    return value


def _tables(cfg, like=None):
    tables = ({n: dataclasses.asdict(m) for n, m in cfg.models.items()},
              dataclasses.asdict(cfg.ensemble), dataclasses.asdict(cfg.qos))
    return tables if like is None else _on_port_keys(tables, _tables(like))


def test_default_model_table_and_blend_weights_equal_jax(env):
    assert _tables(Config()) == _tables(JaxConfig(), like=Config())
    assert Config().normalized_weights() == JaxConfig().normalized_weights()
    # the blend of the default config, pinned
    np.testing.assert_array_equal(
        EnsembleParams.from_config(Config(), MODEL_NAMES).weights.numpy(),
        np.asarray([0.40, 0.25, 0.15, 0.15, 0.05], np.float32))
    assert TorchFraudScorer(device="cpu", seed=1).model_valid.all()


def test_from_file_then_environment_layering_equals_jax(env, tmp_path):
    data = {"ensemble": {"strategy": "voting", "fraud_threshold": 0.4},
            "qos": {"enabled": True, "budget_ms": 15.0, "admission_rate": 500.0},
            "models": {"bert_text": {"enabled": False, "weight": 0.3},
                       "extra_model": {"model_type": "gbdt", "weight": 0.1}},
            "no_such_block": {"x": 1}}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(data))
    env.setenv("RTFD_FRAUD_THRESHOLD", "0.45")      # env wins over the file
    got, want = Config.from_file(str(path)), JaxConfig.from_file(str(path))
    assert _tables(got) == _tables(want, like=got)
    assert got.ensemble.fraud_threshold == 0.45 and got.ensemble.strategy == "voting"
    assert got.qos.enabled and got.qos.budget_ms == 15.0
    assert isinstance(got.models["extra_model"], ModelConfig)
    assert not got.models["bert_text"].enabled
    assert got.normalized_weights() == want.normalized_weights()
    assert got.to_dict() == _on_port_keys(want.to_dict(), got.to_dict())


def test_registry_helpers_and_refusals_equal_jax(env):
    def scenario(p):
        cfg = p.Config()
        cfg.update_model_weight("lstm_sequential", 0.5)
        cfg.disable_model("graph_neural")
        cfg.disable_model("no_such_model")
        weights = cfg.normalized_weights()
        cfg.enable_model("graph_neural")
        return (weights, sorted(cfg.get_enabled_models()),
                _raised(lambda: cfg.get_model_config("nope")),
                _raised(lambda: p.Config.from_dict({"ensemble": {"strategy": "mean"}})),
                _raised(lambda: p.Config.from_dict(
                    {"ensemble": {"monitor_threshold": 0.9}})),
                _raised(lambda: p.Config.from_dict({"qos": {"budget_ms": -1.0}})))

    weights, enabled, missing, strategy, ladder, budget = both(scenario)
    assert "graph_neural" not in weights and len(enabled) == 5
    assert "not found" in missing[1] and "strategy" in strategy[1]
    assert "decision ladder" in ladder[1] and "budget" in budget[1]


def test_quality_artifact_gives_the_jax_model_table(env, tmp_path):
    got, want = Config(), JaxConfig()
    assert got.apply_quality_artifact(QUALITY_ARTIFACT) == \
        want.apply_quality_artifact(QUALITY_ARTIFACT)
    assert _tables(got) == _tables(want, like=got)
    for loader in ("load_selected_blend_weights", "load_selected_blend_strategy",
                   "load_artifact_text_model"):
        assert getattr(Config, loader)(QUALITY_ARTIFACT) == \
            getattr(JaxConfig, loader)(QUALITY_ARTIFACT), loader
    scorer = TorchFraudScorer(got, device="cpu", seed=1)
    assert scorer.model_valid.tolist() == [True, True, False, False, True]
    np.testing.assert_allclose(
        EnsembleParams.from_config(got, MODEL_NAMES).weights.numpy(),
        np.asarray(JaxEnsembleParams.from_config(want, MODEL_NAMES).weights),
        rtol=0, atol=0)
    # a malformed artifact is refused the same way
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"selected_blend": {"weights": {"nope": 1.0}}}))
    assert _raised(lambda: Config().apply_quality_artifact(str(bad))) == \
        _raised(lambda: JaxConfig().apply_quality_artifact(str(bad)))
    bad.write_text(json.dumps({"protocol": {}}))
    assert _raised(lambda: Config.load_selected_blend_weights(str(bad)))[0] == "ValueError"


def test_quality_artifact_scorer_serves_its_blend_through_one_megakernel_launch(env):
    """The artifact's three-branch blend is the megakernel's
    ``mega_valid`` (T, T, F, F, T) as a deployment, not a degradation; on
    the CPU the scorer's packed output equals the JAX scorer's under the
    same config, within the bound."""
    jscorer = FraudScorer(scorer_config=JaxScorerConfig(text_len=32), seed=2)
    jcfg = JaxConfig()
    jcfg.apply_quality_artifact(QUALITY_ARTIFACT)
    jscorer_art = FraudScorer(jcfg, models=jscorer.models,
                              scorer_config=JaxScorerConfig(text_len=32))
    models = jax.tree_util.tree_map(np.asarray, jscorer.models)
    cfg = Config(kernels=KernelSettings.mega())
    cfg.apply_quality_artifact(QUALITY_ARTIFACT)
    scorer = TorchFraudScorer(cfg, models=models_from_numpy(models),
                              scorer_config=ScorerConfig(text_len=32), device="cpu")
    assert scorer.kernel_static(256)["mega_valid"] == (True, True, False, False, True)
    gens = [TransactionGenerator(num_users=30, num_merchants=10, seed=4),
            JaxTransactionGenerator(num_users=30, num_merchants=10, seed=4)]
    for s, g in zip((scorer, jscorer_art), gens):
        s.seed_profiles(g.users.profiles(), g.merchants.profiles())
    got = scorer.score_batch(gens[0].generate_batch(16), now=100.0)
    want = jscorer_art.score_batch(gens[1].generate_batch(16), now=100.0)
    assert scorer.kernel_snapshot()["launches_per_batch"] == 1
    for p, q in zip(got, want):
        assert set(p["model_predictions"]) == set(q["model_predictions"]) == {
            "xgboost_primary", "lstm_sequential", "isolation_forest"}
        assert abs(p["fraud_score"] - q["fraud_score"]) <= 1e-4
        assert p["decision"] == q["decision"]
