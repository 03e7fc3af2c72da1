"""The main-path gate: the port's streaming job against the JAX job, on the
CPU.

The seeded stream of ``tests/test_stream.py`` (60 users, 25 merchants, seed
11, microbatches of 32) goes through the JAX ``StreamJob`` + ``FraudScorer``
and through the port's ``StreamJob`` + ``TorchFraudScorer(device="cpu")``
on the same (bridged) models, each job on its own in-memory broker and its
own simulator. Both must emit the same ids in the same order on every
topic, the same decisions and risk levels on every row whose JAX
probability and confidence lie farther than the bound from every rung
(the number of rows skipped is asserted), ``fraud_score`` within the bound,
the same feature rows (exact apart from the three transcendental columns,
within 1e-5), the same counters and lag 0; then the replay-dedupe sequence
of ``tests/test_stream.py`` gives the same counters and cache re-emissions
on both. The bound is the JAX kernel drill's measured bf16 noise bound on
the JAX job's own tokens, floored at 1e-4 (``torch_bounds.py``). Last, both
jobs are stepped down the QoS ladder through ``set_degradation`` and score
one batch at each lower rung: decisions equal there too, and at
``rules_only`` every score bit-exact.
"""

import torch_threads  # noqa: F401  (first: torch held to one CPU thread)
import time
from collections import Counter

import jax
import numpy as np
import pytest
import torch

from realtime_fraud_detection_tpu.ensemble.combine import (
    EnsembleParams as JaxEnsembleParams,
)
from realtime_fraud_detection_tpu.models.isolation_forest import (
    IsolationForest as JaxIsolationForest,
)
from realtime_fraud_detection_tpu.models.trees import (
    TreeEnsemble as JaxTreeEnsemble,
)
from realtime_fraud_detection_tpu.scoring import FraudScorer
from realtime_fraud_detection_tpu.scoring import ScorerConfig as JaxScorerConfig
from realtime_fraud_detection_tpu.sim.simulator import (
    TransactionGenerator as JaxTransactionGenerator,
)
from realtime_fraud_detection_tpu.stream import InMemoryBroker as JaxInMemoryBroker
from realtime_fraud_detection_tpu.stream import JobConfig as JaxJobConfig
from realtime_fraud_detection_tpu.stream import StreamJob as JaxStreamJob
from realtime_fraud_detection_tpu.obs.tracing import make_carrier as jax_make_carrier
from realtime_fraud_detection_tpu.utils.config import Config as JaxConfig
from realtime_fraud_detection_tpu.utils.config import TracingSettings as JaxTracingSettings
from realtime_fraud_detection_tpu_torch.__main__ import main as port_main
from realtime_fraud_detection_tpu_torch.bridge import models_from_numpy
from realtime_fraud_detection_tpu_torch.features.extract import FEATURE_NAMES
from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
from realtime_fraud_detection_tpu_torch.obs.tracing import CARRIER_KEY, make_carrier
from realtime_fraud_detection_tpu_torch.qos.ladder import LADDER_LEVELS
from realtime_fraud_detection_tpu_torch.scoring.pipeline import MODEL_NAMES, ScorerConfig
from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
from realtime_fraud_detection_tpu_torch.stream import topics as T
from realtime_fraud_detection_tpu_torch.stream.job import JobConfig, StreamJob
from realtime_fraud_detection_tpu_torch.stream.transport import InMemoryBroker
from realtime_fraud_detection_tpu_torch.utils.config import QosSettings, TracingSettings
from torch_bounds import near_rung, noise_bound

ALERT_THRESHOLD = 0.7
RUNG_LEVELS = (1, 2, 3)                 # the lower rungs (0 is the stream)
OUT_TOPICS = (T.PREDICTIONS, T.ALERTS, T.ENRICHED, T.FEATURES)
TRANSCENDENTAL = [FEATURE_NAMES.index(n) for n in (
    "amount_log", "amount_sqrt", "distance_to_merchant_km")]
EXACT = [i for i in range(len(FEATURE_NAMES)) if i not in TRANSCENDENTAL]


def _jax_models():
    """The JAX model set with random trees and forest (every branch works),
    f32 BERT, numpy leaves."""
    rng = np.random.default_rng(29)
    scorer = FraudScorer(scorer_config=JaxScorerConfig(text_len=32), seed=29)
    depth, n_trees = 4, 16
    trees = JaxTreeEnsemble(
        feature=rng.integers(0, 64, (n_trees, 2 ** depth - 1)).astype(np.int32),
        threshold=rng.normal(0.5, 1.0, (n_trees, 2 ** depth - 1)).astype(np.float32),
        leaf=rng.normal(0.0, 0.4, (n_trees, 2 ** depth)).astype(np.float32),
        base_score=np.float32(0.1))
    forest = JaxIsolationForest(
        feature=rng.integers(0, 64, (n_trees, 2 ** depth - 1)).astype(np.int32),
        threshold=rng.normal(0.5, 1.0, (n_trees, 2 ** depth - 1)).astype(np.float32),
        path_length=(4 + 4 * rng.random((n_trees, 2 ** depth))).astype(np.float32),
        c_psi=np.float32(6.0))
    return jax.tree_util.tree_map(
        np.asarray, scorer.models.replace(trees=trees, iforest=forest))


def _topic(broker, topic):
    return [r.value for r in broker.consumer([topic], "check").poll(100_000)]


def _rung_mask(level):
    rung = LADDER_LEVELS[level]
    return np.asarray([n not in rung.dropped_branches for n in MODEL_NAMES])


def _drive(gen, job, broker):
    """The stream, the replay-dedupe sequence and one batch at each lower
    QoS rung; returns what each phase left behind, with the token batches
    the scorer assembled for the stream and for each rung."""
    out = {}
    tokens = []
    assemble = job.scorer.assemble

    def keep_tokens(*args, **kwargs):
        batch = assemble(*args, **kwargs)
        tokens.append((np.asarray(batch.token_ids), np.asarray(batch.token_mask)))
        return batch

    job.scorer.assemble = keep_tokens
    records = gen.generate_batch(96)
    broker.produce_batch(T.TRANSACTIONS, records, key_fn=lambda r: str(r["user_id"]))
    out["scored"] = job.run_until_drained(now=1000.0)
    out["stream_tokens"] = list(tokens)
    out["counters"] = dict(job.counters)
    out["lag"] = broker.lag(job.config.group_id, T.TRANSACTIONS)
    out["topics"] = {t: _topic(broker, t) for t in OUT_TOPICS}
    out["records"] = records
    # replay-dedupe (tests/test_stream.py test_stream_job_replay_dedupe)
    replay = gen.generate_batch(10)
    broker.produce_batch(T.TRANSACTIONS, replay, key_fn=lambda r: str(r["user_id"]))
    job.run_until_drained(now=2000.0)
    before = job.counters["scored"]
    broker.produce_batch(T.TRANSACTIONS, replay, key_fn=lambda r: str(r["user_id"]))
    job.run_until_drained(now=2001.0)
    out["after_redelivery"] = dict(job.counters)
    broker.produce_batch(T.TRANSACTIONS, replay + replay,
                         key_fn=lambda r: str(r["user_id"]))
    job.run_until_drained(now=2002.0)
    out["after_double"] = dict(job.counters)
    out["rescored"] = job.counters["scored"] - before
    out["replayed"] = Counter(
        p["transaction_id"] for p in _topic(broker, T.PREDICTIONS)
        if p["explanation"].get("replayed_from_cache"))
    out["final_lag"] = broker.lag(job.config.group_id, T.TRANSACTIONS)
    # both jobs step down the ladder the same way, one batch a rung
    out["rungs"], out["rung_tokens"] = {}, {}
    for level in RUNG_LEVELS:
        job.scorer.set_degradation(_rung_mask(level),
                                   rules_only=LADDER_LEVELS[level].rules_only,
                                   level=level)
        batch = gen.generate_batch(32)
        start = len(tokens)
        broker.produce_batch(T.TRANSACTIONS, batch, key_fn=lambda r: str(r["user_id"]))
        job.run_until_drained(now=3000.0 + level)
        ids = {r["transaction_id"] for r in batch}
        out["rungs"][level] = [p for p in _topic(broker, T.PREDICTIONS)
                               if p["transaction_id"] in ids]
        out["rung_tokens"][level] = tokens[start:]
    job.scorer.set_degradation(None, rules_only=False, level=0)
    job.scorer.assemble = assemble
    return out


@pytest.fixture(scope="module")
def runs():
    jax_models = _jax_models()
    jax_gen = JaxTransactionGenerator(num_users=60, num_merchants=25, seed=11)
    jax_scorer = FraudScorer(models=jax_models,
                             scorer_config=JaxScorerConfig(text_len=32))
    jax_scorer.seed_profiles(jax_gen.users.profiles(), jax_gen.merchants.profiles())
    jax_broker = JaxInMemoryBroker()
    jax_job = JaxStreamJob(jax_broker, jax_scorer,
                           JaxJobConfig(max_batch=32, max_delay_ms=1.0))

    gen = TransactionGenerator(num_users=60, num_merchants=25, seed=11)
    scorer = TorchFraudScorer(models=models_from_numpy(jax_models),
                              scorer_config=ScorerConfig(text_len=32),
                              bert_config=TINY_CONFIG, device="cpu")
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    broker = InMemoryBroker()
    job = StreamJob(broker, scorer, JobConfig(max_batch=32, max_delay_ms=1.0))
    got, want = _drive(gen, job, broker), _drive(jax_gen, jax_job, jax_broker)
    # the JAX drill's noise bound on the JAX job's own tokens, per rung
    weights = JaxEnsembleParams.from_config(JaxConfig(), MODEL_NAMES).weights
    want["bound"] = noise_bound(jax_models.bert, want["stream_tokens"], weights,
                                np.ones(5, bool))
    want["rung_bound"] = {level: noise_bound(jax_models.bert,
                                             want["rung_tokens"][level], weights,
                                             _rung_mask(level))
                          for level in RUNG_LEVELS}
    return got, want


def _compare_decisions(preds, jpreds, bound):
    """Decisions and risk levels equal on every row whose JAX probability
    and confidence lie farther than ``bound`` from a rung, fraud_score
    within ``bound``; returns the rows skipped near a rung."""
    assert [p["transaction_id"] for p in preds] == [q["transaction_id"] for q in jpreds]
    assert not any(p["explanation"].get("error") for p in preds)
    prob = np.array([q["fraud_probability"] for q in jpreds])
    conf = np.array([q["confidence"] for q in jpreds])
    near = near_rung(prob, bound) | near_rung(conf, bound)
    for p, q, skip in zip(preds, jpreds, near):
        if not skip:
            assert (p["decision"], p["risk_level"]) == (q["decision"], q["risk_level"])
    np.testing.assert_allclose([p["fraud_score"] for p in preds],
                               [q["fraud_score"] for q in jpreds], rtol=0, atol=bound)
    return near


def test_stream_records_and_ids_per_topic_match_jax(runs):
    got, want = runs
    assert got["records"] == want["records"]           # the same stream
    assert got["scored"] == want["scored"] == 96
    for topic in OUT_TOPICS:
        ids = [v["transaction_id"] for v in got["topics"][topic]]
        assert ids == [v["transaction_id"] for v in want["topics"][topic]], topic
    ids = [v["transaction_id"] for v in got["topics"][T.PREDICTIONS]]
    assert sorted(ids) == sorted(r["transaction_id"] for r in got["records"])
    for topic in (T.PREDICTIONS, T.ENRICHED, T.FEATURES):
        assert len(got["topics"][topic]) == len(set(ids)) == 96


def test_stream_decisions_and_scores_match_jax(runs):
    got, want = runs
    preds = got["topics"][T.PREDICTIONS]
    jpreds = want["topics"][T.PREDICTIONS]
    bound = want["bound"]
    assert 1e-4 <= bound <= 1e-3
    near = _compare_decisions(preds, jpreds, bound)
    # the rows within the bound of a rung: the comparison skips these
    assert int(near.sum()) == 0
    # the alert count is exact: no score lies within the bound of the threshold
    prob = np.array([q["fraud_probability"] for q in jpreds])
    assert np.min(np.abs(prob - ALERT_THRESHOLD)) > bound
    enriched = [(e["decision"], e["risk_level"]) for e in got["topics"][T.ENRICHED]]
    assert enriched == [(p["decision"], p["risk_level"]) for p in preds]


@pytest.mark.parametrize("level", RUNG_LEVELS,
                         ids=[LADDER_LEVELS[lv].name for lv in RUNG_LEVELS])
def test_stream_degraded_rungs_match_jax(runs, level):
    got, want = runs
    preds, jpreds = got["rungs"][level], want["rungs"][level]
    assert len(preds) == len(jpreds) == 32
    if LADDER_LEVELS[level].rules_only:
        # the rule score and its ladder are pure f32 comparisons: bit-exact
        for key in ("fraud_score", "confidence", "decision", "risk_level"):
            assert [p[key] for p in preds] == [q[key] for q in jpreds], key
        assert all(p["explanation"]["degraded"] == "rules_only" for p in preds)
        return
    near = _compare_decisions(preds, jpreds, want["rung_bound"][level])
    assert int(near.sum()) == 0
    dropped = [j for j, on in enumerate(_rung_mask(level)) if not on]
    for p in preds:
        assert set(p["model_predictions"]) == {
            n for j, n in enumerate(MODEL_NAMES) if j not in dropped}


def test_stream_features_match_jax(runs):
    got, want = runs
    feats = np.array([v["features"] for v in got["topics"][T.FEATURES]], np.float32)
    jfeats = np.array([v["features"] for v in want["topics"][T.FEATURES]], np.float32)
    assert feats.shape == (96, 64)
    np.testing.assert_array_equal(feats[:, EXACT], jfeats[:, EXACT])
    np.testing.assert_allclose(feats[:, TRANSCENDENTAL], jfeats[:, TRANSCENDENTAL],
                               rtol=1e-5, atol=1e-5)


def test_stream_counters_and_lag_match_jax(runs):
    got, want = runs
    assert got["counters"] == want["counters"]
    assert got["counters"]["scored"] == 96 and got["counters"]["errors"] == 0
    assert got["counters"]["batches"] == 3
    assert got["lag"] == want["lag"] == 0


def test_stream_replay_dedupe_matches_jax(runs):
    got, want = runs
    for key in ("after_redelivery", "after_double", "rescored", "final_lag"):
        assert got[key] == want[key], key
    assert got["rescored"] == 0 and got["final_lag"] == 0
    assert got["after_redelivery"]["duplicates_skipped"] == 10
    assert got["replayed"] == want["replayed"]
    assert set(got["replayed"].values()) == {2} and len(got["replayed"]) == 10


def test_job_config_refuses_unported_planes():
    """``JobConfig`` still type-checks its planes; ``expect_carrier`` (the
    process fleet's) is ported: records without a producer carrier count
    as carrier_lost, those with one as adopted, exactly as in JAX."""
    with pytest.raises(TypeError):
        JobConfig(qos=object())
    assert JobConfig(expect_carrier=True).expect_carrier
    assert not JobConfig().expect_carrier
    # the overlapped assembly stage, the QoS plane and the device pool are
    # ported too
    assert JobConfig(overlap_assembly=True).overlap_assembly
    assert JobConfig(qos=QosSettings(enabled=True)).qos.enabled
    assert JobConfig(device_pool=True, inflight_depth=3).inflight_depth == 3
    _, (jax_gen, jax_scorer), (gen, scorer) = _stage_scorers(17)
    counts = {}
    for name, g, sc, broker, job_cls, cfg_cls, tr_cls, carrier_fn in (
            ("jax", jax_gen, jax_scorer, JaxInMemoryBroker(), JaxStreamJob,
             JaxJobConfig, JaxTracingSettings, jax_make_carrier),
            ("port", gen, scorer, InMemoryBroker(), StreamJob, JobConfig,
             TracingSettings, make_carrier)):
        records = g.generate_batch(24)
        for i, rec in enumerate(records):
            if i % 2:
                rec[CARRIER_KEY] = carrier_fn(f"tingress-{i:04x}", origin="ingress",
                                              produced_ts=999.0)
        job = job_cls(broker, sc, cfg_cls(max_batch=8, max_delay_ms=1.0,
                                          tracing=tr_cls(enabled=True),
                                          expect_carrier=True))
        broker.produce_batch(T.TRANSACTIONS, records,
                             key_fn=lambda r: str(r["user_id"]))
        job.run_until_drained(now=1000.0)
        counts[name] = {k: job.tracer.counters[k]
                        for k in ("started", "carrier_lost", "carrier_adopted")}
    assert counts["port"] == counts["jax"]
    assert counts["port"] == {"started": 24, "carrier_lost": 12, "carrier_adopted": 12}


def test_dispatch_error_is_counted_not_hidden():
    """A scorer that fails to dispatch takes the whole-batch REVIEW path,
    and the job counts every record of it as an error."""
    gen = TransactionGenerator(num_users=10, num_merchants=5, seed=3)
    scorer = TorchFraudScorer(scorer_config=ScorerConfig(text_len=16), device="cpu")
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    broker = InMemoryBroker()
    job = StreamJob(broker, scorer, JobConfig(max_batch=8))
    broker.produce_batch(T.TRANSACTIONS, gen.generate_batch(6),
                         key_fn=lambda r: str(r["user_id"]))

    def broken(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    scorer.dispatch = broken
    assert job.run_until_drained(now=5.0) == 6
    assert job.counters["errors"] == 6
    preds = _topic(broker, T.PREDICTIONS)
    assert all(p["explanation"] == {"error": True} for p in preds)
    assert _topic(broker, T.FEATURES) == []


def test_malformed_record_gets_its_own_error_result():
    """Per-record degradation: a record the sanitizer rejects gets an error
    result of its own; its batch-mates are scored."""
    gen = TransactionGenerator(num_users=10, num_merchants=5, seed=6)
    scorer = TorchFraudScorer(scorer_config=ScorerConfig(text_len=16), device="cpu")
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    broker = InMemoryBroker()
    job = StreamJob(broker, scorer, JobConfig(max_batch=8))
    records = gen.generate_batch(5)
    bad = dict(records[0], transaction_id="bad-1", amount="not a number")
    broker.produce_batch(T.TRANSACTIONS, records + [bad],
                         key_fn=lambda r: str(r["user_id"]))
    assert job.run_until_drained(now=7.0) == 5
    assert job.counters["errors"] == 1
    preds = {p["transaction_id"]: p for p in _topic(broker, T.PREDICTIONS)}
    assert preds["bad-1"]["explanation"]["validation_errors"] == [
        "amount must be a number"]
    assert all(not preds[r["transaction_id"]]["explanation"].get("error")
               for r in records)
    assert broker.lag(job.config.group_id, T.TRANSACTIONS) == 0


def test_run_for_scores_within_its_window_and_commits():
    gen = TransactionGenerator(num_users=10, num_merchants=5, seed=8)
    scorer = TorchFraudScorer(scorer_config=ScorerConfig(text_len=16), device="cpu")
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    broker = InMemoryBroker()
    job = StreamJob(broker, scorer, JobConfig(max_batch=8, max_delay_ms=1.0))
    broker.produce_batch(T.TRANSACTIONS, gen.generate_batch(11),
                         key_fn=lambda r: str(r["user_id"]))
    # each window ends the polling but completes and commits every batch it
    # dispatched; the next window picks up what is left
    scored = []
    while sum(scored) < 11 and len(scored) < 20:
        scored.append(job.run_for(0.5))
        assert broker.lag(job.config.group_id, T.TRANSACTIONS) <= 11 - sum(scored)
    assert sum(scored) == job.counters["scored"] == 11
    assert job.counters["errors"] == 0 and job.counters["batches"] == 2
    assert broker.lag(job.config.group_id, T.TRANSACTIONS) == 0


def test_run_job_refuses_to_start_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    assert port_main(["run-job", "--count", "4"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_run_job_on_the_cpu_when_asked(capsys):
    import json

    rc = port_main(["run-job", "--count", "40", "--users", "30", "--merchants",
                    "10", "--batch", "32", "--device", "cpu", "--seed", "4"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert summary["scored"] == 40 and summary["lag"] == 0
    assert summary["counters"]["errors"] == 0 and summary["counters"]["batches"] == 2
    stages = set(summary["host_stage_mean_ms"])
    assert {s for s in stages if not s.startswith("gc.")} == {
        "assemble", "encode", "features", "history", "graph", "tokens",
        "pack", "dispatch", "h2d", "launch", "device_wait", "responses",
        "write_back", "fan_out"}
    assert {s for s in stages if s.startswith("gc.")} <= {
        "gc.gen0", "gc.gen1", "gc.gen2"}


# ------------------------------------------------ overlapped assembly stage
def _stage_scorers(seed):
    """A JAX scorer and a port scorer on the same (bridged) models and
    profiles, with their simulators."""
    jax_models = _jax_models()
    jax_gen = JaxTransactionGenerator(num_users=60, num_merchants=20, seed=seed)
    gen = TransactionGenerator(num_users=60, num_merchants=20, seed=seed)
    jax_scorer = FraudScorer(models=jax_models,
                             scorer_config=JaxScorerConfig(text_len=32))
    scorer = TorchFraudScorer(models=models_from_numpy(jax_models),
                              scorer_config=ScorerConfig(text_len=32),
                              bert_config=TINY_CONFIG, device="cpu")
    jax_scorer.seed_profiles(jax_gen.users.profiles(), jax_gen.merchants.profiles())
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    return jax_models, (jax_gen, jax_scorer), (gen, scorer)


def test_assembler_stage_direct_matches_jax():
    """``submit`` / ``finalize`` join in FIFO order on both stages, with the
    same decisions as the JAX stage's (velocity written back between
    batches: each is finalized before the next is submitted)."""
    from realtime_fraud_detection_tpu.scoring import AssemblerStage as JaxAssemblerStage
    from realtime_fraud_detection_tpu_torch.scoring.host_pipeline import AssemblerStage

    jax_models, (jax_gen, jax_scorer), (gen, scorer) = _stage_scorers(21)
    weights = JaxEnsembleParams.from_config(JaxConfig(), MODEL_NAMES).weights
    tokens = []
    assemble = jax_scorer.assemble

    def keep_tokens(*args, **kwargs):
        batch = assemble(*args, **kwargs)
        tokens.append((np.asarray(batch.token_ids), np.asarray(batch.token_mask)))
        return batch

    jax_scorer.assemble = keep_tokens
    stage, jstage = AssemblerStage(scorer, depth=2), JaxAssemblerStage(jax_scorer, depth=2)
    try:
        got, want = [], []
        for i in range(3):
            batch = gen.generate_batch(8)
            assert batch == jax_gen.generate_batch(8)
            got.append(stage.finalize(stage.submit(batch, now=100.0 + i), now=100.0 + i))
            want.append(jstage.finalize(jstage.submit(batch, now=100.0 + i),
                                        now=100.0 + i))
            assert [r["transaction_id"] for r in got[-1]] == \
                [str(rec["transaction_id"]) for rec in batch]
        # submitted back to back: FIFO, whatever the thread interleaving
        batches = [gen.generate_batch(8) for _ in range(3)]
        handles = [stage.submit(b, now=200.0) for b in batches]
        order = [r["transaction_id"] for h in handles
                 for r in stage.finalize(h, now=200.0)]
        assert order == [str(r["transaction_id"]) for b in batches for r in b]
        assert stage.batches == 6 and stage.busy_s > 0.0
    finally:
        stage.close()
        jstage.close()
    with pytest.raises(RuntimeError, match="closed"):
        stage.submit(batches[0])
    bound = noise_bound(jax_models.bert, tokens, weights, np.ones(5, bool))
    near = _compare_decisions([r for b in got for r in b],
                              [r for b in want for r in b], bound)
    assert int(near.sum()) == 0


class _SlowScorer(TorchFraudScorer):
    """A port scorer with a fixed assembly and device latency and a timeline
    of (stage, start, end) intervals from whichever thread ran them."""

    ASSEMBLE_S = 0.015
    DEVICE_S = 0.03

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.events = []

    def assemble(self, records, now=None):
        t0 = time.perf_counter()
        time.sleep(self.ASSEMBLE_S)
        batch = super().assemble(records, now)
        self.events.append(("assemble", t0, time.perf_counter()))
        return batch

    def finalize(self, pending, now=None, lock=None):
        t0 = time.perf_counter()
        time.sleep(self.DEVICE_S)
        out = super().finalize(pending, now=now, lock=lock)
        self.events.append(("device", t0, time.perf_counter()))
        return out


def _overlap_run(overlap, jax_side=False):
    """192 records (a duplicate and a malformed one among them) in batches
    of 32 at a fixed virtual clock, through the port's or the JAX job."""
    seed = 13
    if jax_side:
        gen = JaxTransactionGenerator(num_users=60, num_merchants=20, seed=seed)
        scorer = FraudScorer(scorer_config=JaxScorerConfig(text_len=16))
        broker = JaxInMemoryBroker()
        job = JaxStreamJob(broker, scorer, JaxJobConfig(
            max_batch=32, overlap_assembly=overlap, pipeline_depth=2,
            emit_features=False))
    else:
        gen = TransactionGenerator(num_users=60, num_merchants=20, seed=seed)
        scorer = _SlowScorer(scorer_config=ScorerConfig(text_len=16), device="cpu")
        broker = InMemoryBroker()
        job = StreamJob(broker, scorer, JobConfig(
            max_batch=32, overlap_assembly=overlap, pipeline_depth=2,
            emit_features=False))
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    records = gen.generate_batch(190)
    records += [dict(records[5]), dict(records[6], transaction_id="bad", amount="x")]
    broker.produce_batch(T.TRANSACTIONS, records, key_fn=lambda r: str(r["user_id"]))
    job.run_until_drained(now=500.0)
    job.close()
    order = [p["transaction_id"] for p in _topic(broker, T.PREDICTIONS)]
    return job, scorer, order, broker


def test_overlap_keeps_order_admission_and_delivery_like_jax():
    """The stage changes when work happens, not what happens: the same
    prediction order, counters and commits as the serial run and as the
    JAX job with overlap on, while an assembly provably overlaps another
    batch's device wait. Decisions are not compared: which write-backs
    land before an assembly depends on timing."""
    job_a, sc_a, order_a, broker_a = _overlap_run(overlap=False)
    job_b, sc_b, order_b, broker_b = _overlap_run(overlap=True)
    jax_job, _, jax_order, _ = _overlap_run(overlap=True, jax_side=True)
    assert order_a == order_b == jax_order
    assert job_a.counters == job_b.counters == jax_job.counters
    assert job_b.counters["scored"] == 190 and job_b.counters["errors"] == 1
    assert job_b.counters["duplicates_skipped"] == 1
    for broker, job in ((broker_a, job_a), (broker_b, job_b)):
        assert broker.lag(job.config.group_id, T.TRANSACTIONS) == 0
    assert len(set(order_b)) == len(order_b) == 191

    def overlapped(events, slack):
        asm = [e for e in events if e[0] == "assemble"]
        dev = [e for e in events if e[0] == "device"]
        return any(min(a1, d1) - max(a0, d0) > slack
                   for _, a0, a1 in asm for _, d0, d1 in dev)

    assert overlapped(sc_b.events, 0.005), "no assemble / device overlap"
    assert not overlapped(sc_a.events, 0.0)
    assert job_b._stage.batches == 6


@pytest.mark.parametrize("jax_side", [False, True], ids=["port", "jax"])
def test_stage_error_takes_the_degradation_path(jax_side):
    """An assembly error inside the stage surfaces at completion as the
    whole-batch REVIEW result, on both jobs alike: never a hang or a lost
    batch."""
    if jax_side:
        gen = JaxTransactionGenerator(num_users=20, num_merchants=10, seed=2)
        scorer = FraudScorer(scorer_config=JaxScorerConfig(text_len=16))
        broker = JaxInMemoryBroker()
        job = JaxStreamJob(broker, scorer, JaxJobConfig(
            max_batch=16, overlap_assembly=True, emit_features=False))
    else:
        gen = TransactionGenerator(num_users=20, num_merchants=10, seed=2)
        scorer = TorchFraudScorer(scorer_config=ScorerConfig(text_len=16), device="cpu")
        broker = InMemoryBroker()
        job = StreamJob(broker, scorer, JobConfig(
            max_batch=16, overlap_assembly=True, emit_features=False))
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())

    def boom(*args, **kwargs):
        raise RuntimeError("assembly exploded")

    scorer.assemble = boom
    broker.produce_batch(T.TRANSACTIONS, gen.generate_batch(16),
                         key_fn=lambda r: str(r["user_id"]))
    job.run_until_drained(now=10.0)
    job.close()
    preds = _topic(broker, T.PREDICTIONS)
    assert len(preds) == 16 and all(p["decision"] == "REVIEW" for p in preds)
    assert job.counters["errors"] == 16
    assert broker.lag(job.config.group_id, T.TRANSACTIONS) == 0
