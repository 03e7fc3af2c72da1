"""The job's remaining seams against the JAX package, on the CPU.

The enrichment pair (``features/rules.py enrichment_score`` /
``blend_enrichment``) within 1e-6 with equal ladders, rows put exactly on
the ladder's cuts included; the seven window operators, the joins and the
multi-stream correlator on one seeded enriched stream; the port's
``StreamJob`` with ``enable_analytics`` and ``enable_enrichment`` against
the JAX job over a seeded 1,024-transaction stream, decision for decision
(away from a cut, held to the JAX drill's bf16 noise bound); the stop seam
(``request_stop`` after a batch, a checkpoint, a resume: every transaction
once, equal to JAX's, in both packages) and the polled-tail drain;
``replay_state``; and ``SimConfig``, ``Config.models_base_path`` /
``MODELS_PATH``, ``ServingFeatureProcessor`` and ``MetadataStore``.
"""

import dataclasses
import math
from collections import Counter

import jax
import numpy as np
import pytest
import torch

from realtime_fraud_detection_tpu.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
)
from realtime_fraud_detection_tpu.checkpoint import (
    restore_scorer_host_state as jax_restore_host_state,
)
from realtime_fraud_detection_tpu.checkpoint import (
    snapshot_scorer_host_state as jax_snapshot_host_state,
)
from realtime_fraud_detection_tpu.ensemble.combine import (
    EnsembleParams as JaxEnsembleParams,
)
from realtime_fraud_detection_tpu.features import rules as jrules
from realtime_fraud_detection_tpu.features.serving import (
    ServingFeatureProcessor as JaxServingFeatureProcessor,
)
from realtime_fraud_detection_tpu.models.isolation_forest import (
    IsolationForest as JaxIsolationForest,
)
from realtime_fraud_detection_tpu.models.trees import TreeEnsemble as JaxTreeEnsemble
from realtime_fraud_detection_tpu.scoring import FraudScorer
from realtime_fraud_detection_tpu.scoring import ScorerConfig as JaxScorerConfig
from realtime_fraud_detection_tpu.sim.simulator import (
    TransactionGenerator as JaxTransactionGenerator,
)
from realtime_fraud_detection_tpu.state.metadata import MetadataStore as JaxMetadataStore
from realtime_fraud_detection_tpu.stream import InMemoryBroker as JaxInMemoryBroker
from realtime_fraud_detection_tpu.stream import JobConfig as JaxJobConfig
from realtime_fraud_detection_tpu.stream import StreamJob as JaxStreamJob
from realtime_fraud_detection_tpu.stream import joins as jjoins
from realtime_fraud_detection_tpu.stream import windows as jwin
from realtime_fraud_detection_tpu.utils import config as jconfig
from realtime_fraud_detection_tpu_torch.bridge import models_from_numpy
from realtime_fraud_detection_tpu_torch.checkpoint import (
    CheckpointManager,
    restore_scorer_host_state,
    snapshot_scorer_host_state,
)
from realtime_fraud_detection_tpu_torch.features import rules
from realtime_fraud_detection_tpu_torch.features.extract import FEATURE_NAMES
from realtime_fraud_detection_tpu_torch.features.serving import ServingFeatureProcessor
from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
from realtime_fraud_detection_tpu_torch.scoring.pipeline import MODEL_NAMES, ScorerConfig
from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
from realtime_fraud_detection_tpu_torch.state.metadata import MetadataStore
from realtime_fraud_detection_tpu_torch.state.stores import _event_time_ms
from realtime_fraud_detection_tpu_torch.stream import joins, windows
from realtime_fraud_detection_tpu_torch.stream import topics as T
from realtime_fraud_detection_tpu_torch.stream.job import JobConfig, StreamJob
from realtime_fraud_detection_tpu_torch.stream.transport import InMemoryBroker
from realtime_fraud_detection_tpu_torch.utils import config as pconfig
from torch_bounds import noise_bound

ENRICH_TOL = 1e-6
CUTS = (0.3, 0.6, 0.8, 0.95)             # the enrichment ladder's cuts
DECISION_CUTS = (0.6, 0.95)
HIGH_RISK = 0.7                          # windows.py's high-risk cut
ANALYTICS_TOPICS = sorted(set(windows.ANALYTICS_TOPIC.values()))
# each analytics topic's key field (two operators share velocity-checks,
# both keyed by user)
TOPIC_KEY = {"velocity-checks": ("user_id", lambda t: str(t.get("user_id"))),
             "merchant-transactions": ("merchant_id",
                                       lambda t: str(t.get("merchant_id"))),
             "user-sessions": ("user_id", lambda t: str(t.get("user_id"))),
             "geographic-analysis": ("geo_key", windows.geo_grid_key),
             "pattern-detection": ("pattern_key", windows.fraud_pattern_key),
             "transaction-metrics": ("amount_bucket", windows.amount_cluster_key)}
STREAM = 1024
BATCH = 256
TRANSCENDENTAL = [FEATURE_NAMES.index(n) for n in (
    "amount_log", "amount_sqrt", "distance_to_merchant_km")]


# ------------------------------------------------------------- enrichment
def _feature_matrix(seed: int, rows: int) -> np.ndarray:
    """Seeded 64-wide rows shaped like extracted features: flags, small
    counts, categories, rates and unbounded reals."""
    rng = np.random.default_rng(seed)
    f = rng.normal(0.0, 1.0, (rows, len(FEATURE_NAMES))).astype(np.float32)
    flags = rng.random((rows, len(FEATURE_NAMES))) < 0.5
    f = np.where(flags, (rng.random(f.shape) < 0.4).astype(np.float32), f)
    ix = FEATURE_NAMES.index
    f[:, ix("amount_category")] = rng.integers(0, 6, rows)
    f[:, ix("velocity_5min_count")] = rng.integers(0, 8, rows)
    f[:, ix("velocity_1hour_count")] = rng.integers(0, 20, rows)
    for name in ("user_risk_score", "merchant_fraud_rate", "ip_risk_score",
                 "weekend_activity_factor"):
        f[:, ix(name)] = rng.random(rows)
    return f


def _rows_on_cuts():
    """Rows whose JAX blended score is exactly each cut (as f32): a feature
    row whose clipped enrichment score is exactly 0 or 1, and the prior
    searched ulp by ulp until the JAX blend lands on the cut."""
    ix = FEATURE_NAMES.index
    low = np.zeros((1, len(FEATURE_NAMES)), np.float32)
    low[0, ix("user_risk_score")] = -100.0          # clipped to 0
    high = np.zeros((1, len(FEATURE_NAMES)), np.float32)
    high[0, ix("ip_risk_score")] = 100.0            # clipped to 1
    priors, feats = [], []
    for cut in CUTS:
        for row, base in ((low, 0.0), (high, 0.4)):
            p = np.float32((cut - base) / 0.6)
            for _ in range(64):
                got = np.asarray(jrules.blend_enrichment(
                    np.array([p], np.float32), row)[0])[0]
                if got == np.float32(cut):
                    priors.append(p)
                    feats.append(row[0])
                    break
                p = np.nextafter(p, np.float32(np.inf if got < np.float32(cut)
                                                  else -np.inf))
            else:
                raise AssertionError(f"no prior lands the blend on {cut}")
    return np.array(priors, np.float32), np.stack(feats)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_enrichment_matches_jax(seed):
    f = _feature_matrix(seed, 512)
    prior = np.random.default_rng(seed + 100).random(512).astype(np.float32)
    on_prior, on_feats = _rows_on_cuts()
    prior = np.concatenate([prior, on_prior])
    f = np.concatenate([f, on_feats])
    want_e = np.asarray(jrules.enrichment_score(f))
    want_b, want_d, want_r = (np.asarray(x) for x in jrules.blend_enrichment(prior, f))
    got_e = rules.enrichment_score(torch.from_numpy(f)).numpy()
    got_b, got_d, got_r = (x.numpy() for x in rules.blend_enrichment(
        torch.from_numpy(prior), torch.from_numpy(f)))
    np.testing.assert_allclose(got_e, want_e, rtol=0, atol=ENRICH_TOL)
    np.testing.assert_allclose(got_b, want_b, rtol=0, atol=ENRICH_TOL)
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_r, want_r)
    # the rows on the cuts took the upper rung on both sides
    tail = got_b[-len(on_prior):]
    assert sorted(set(tail.tolist())) == sorted(float(np.float32(c)) for c in CUTS)
    assert got_d.dtype == np.int32 and got_r.dtype == np.int32
    assert set(got_d.tolist()) <= {rules.APPROVE, rules.REVIEW, rules.DECLINE}


# ---------------------------------------------------------------- windows
def _enriched_stream(n: int = 1500, seed: int = 5):
    """A seeded stream with enrichment fields and event times, the same
    dicts for both packages (the port's simulator equals JAX's)."""
    gen = TransactionGenerator(num_users=40, num_merchants=15, seed=seed)
    rng = np.random.default_rng(seed)
    out = []
    for t in gen.generate_batch(n):
        t = dict(t, fraud_score=float(rng.random()))
        out.append((t, _event_time_ms(t, None) / 1000.0))
    # a few late events and a jump that fires the long windows
    out[700:705] = [(t, ts - 4000.0) for t, ts in out[700:705]]
    out.append((dict(out[0][0], transaction_id="late-0"), out[-1][1] + 7200.0))
    return out


FACTORIES = [name for name in windows.__all__ if name.endswith("_windows")]


@pytest.mark.parametrize("factory", FACTORIES)
def test_window_operator_matches_jax(factory):
    stream = _enriched_stream()
    op, jop = getattr(windows, factory)(), getattr(jwin, factory)()
    got = [op.process(t, ts) for t, ts in stream] + [op.flush()]
    want = [jop.process(t, ts) for t, ts in stream] + [jop.flush()]
    assert got == want
    assert sum(map(len, got)) > 0
    assert (op.fired, op.late_dropped, op.watermark, len(op)) == (
        jop.fired, jop.late_dropped, jop.watermark, len(jop))


def test_windowed_analytics_topics_and_stats_match_jax():
    stream = _enriched_stream()
    broker, jbroker = InMemoryBroker(), JaxInMemoryBroker()
    wa, jwa = windows.WindowedAnalytics(broker), jwin.WindowedAnalytics(jbroker)
    for t, ts in stream[:900]:
        assert wa.process(t, ts) == jwa.process(t, ts)
    assert wa.stats() == jwa.stats()
    for t, ts in stream[900:]:
        wa.process(t, ts), jwa.process(t, ts)
    assert wa.flush() == jwa.flush()
    assert wa.stats() == jwa.stats()
    for topic in ANALYTICS_TOPICS:
        got = [r.value for r in broker.consumer([topic], "c").poll(1 << 20)]
        want = [r.value for r in jbroker.consumer([topic], "c").poll(1 << 20)]
        assert got == want and got, topic
    assert windows.ANALYTICS_TOPIC == jwin.ANALYTICS_TOPIC


# ------------------------------------------------------------------ joins
def _join_events(seed: int = 9):
    """Seeded transactions and side events for the three joins and the
    correlator, interleaved in event time."""
    rng = np.random.default_rng(seed)
    gen = TransactionGenerator(num_users=12, num_merchants=6, seed=seed)
    txns = gen.generate_batch(300)
    users = sorted({t["user_id"] for t in txns})
    merchants = sorted({t["merchant_id"] for t in txns})
    events = []
    for i, t in enumerate(txns):
        ts = 20.0 * i
        events.append(("txn", dict(t, hour_of_day=int(rng.integers(0, 24))), ts))
        u = users[rng.integers(len(users))]
        events.append(("behavior", {"user_id": u,
                                    "anomalous_login": bool(rng.random() < 0.3),
                                    "short_session": bool(rng.random() < 0.3),
                                    "anomalous_navigation": bool(rng.random() < 0.2)},
                       ts + rng.random() * 30))
        events.append(("device", {"user_id": u,
                                  "is_new_device": bool(rng.random() < 0.3),
                                  "fingerprint_changed": bool(rng.random() < 0.1)},
                       ts + rng.random() * 30))
        events.append(("network", {"user_id": u, "is_vpn": bool(rng.random() < 0.2),
                                   "country_mismatch": bool(rng.random() < 0.2)},
                       ts + rng.random() * 30))
        if i % 3 == 0:
            events.append(("merchant", {
                "merchant_id": merchants[rng.integers(len(merchants))],
                "risk_level_increased": bool(rng.random() < 0.5),
                "fraud_rate_increased": bool(rng.random() < 0.5),
                "newly_blacklisted": bool(rng.random() < 0.1)}, ts + 5.0))
            events.append(("pattern", {
                "payment_method": t.get("payment_method"),
                "merchant_category": t.get("merchant_category"),
                "amount_range": float(t.get("amount") or 0.0) + rng.normal(0, 20),
                "hour_of_day": int(rng.integers(0, 24)),
                "fraud_rate": float(rng.random()),
                "occurrence_count": int(rng.integers(0, 300)),
                "recent_pattern": bool(rng.random() < 0.5)}, ts + 7.0))
    events.append(("txn", dict(txns[0], transaction_id="end"), 20.0 * 300 + 9000.0))
    return events


def _drive_joins(mod, events):
    out = {}
    for name, right in (("txn_user_behavior_join", "behavior"),
                        ("txn_merchant_update_join", "merchant"),
                        ("txn_historical_pattern_join", "pattern")):
        j = getattr(mod, name)()
        fired = []
        for kind, ev, ts in events:
            if kind == "txn":
                fired.extend(j.process_left(ev, ts))
            elif kind == right:
                fired.extend(j.process_right(ev, ts))
        open_windows = len(j)
        fired.extend(j.flush())
        out[name] = (fired, open_windows, j.watermark, j.joined, j.late_dropped)
    corr = mod.MultiStreamCorrelator(min_signals=2, sweep_interval_events=50)
    complex_events = []
    for kind, ev, ts in events:
        if kind == "txn":
            complex_events.append(corr.on_transaction(ev, ts))
        elif kind in ("behavior", "device", "network"):
            getattr(corr, f"on_{kind}")(ev, ts)
    out["correlator"] = (complex_events, corr.emitted, corr.sweep())
    out["similarity"] = [mod.pattern_similarity(ev, ev2) for (k, ev, _), (k2, ev2, _)
                         in zip(events, events[1:]) if k == "txn" and k2 == "behavior"]
    return out


@pytest.mark.parametrize("part", ["txn_user_behavior_join", "txn_merchant_update_join",
                                  "txn_historical_pattern_join", "correlator",
                                  "similarity"])
def test_joins_and_correlator_match_jax(part):
    events = _join_events()
    got, want = _drive_joins(joins, events)[part], _drive_joins(jjoins, events)[part]
    assert got == want
    if part.endswith("_join"):
        assert len(got[0]) > 0
    if part == "correlator":
        assert got[1] > 0


# --------------------------------------------------------------- the job
def _jax_models():
    """The model set of ``test_torch_stream.py``: random trees and forest
    (every branch works), f32 TINY BERT, numpy leaves."""
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
    return [r.value for r in broker.consumer([topic], "check").poll(1 << 20)]


class _Side:
    """One package's scorer, job classes and checkpoint helpers."""

    def __init__(self, jax_side: bool, models, users=80, merchants=30, seed=21):
        self.jax = jax_side
        gen_cls = JaxTransactionGenerator if jax_side else TransactionGenerator
        self.gen = gen_cls(num_users=users, num_merchants=merchants, seed=seed)
        if jax_side:
            self.scorer = FraudScorer(models=models,
                                      scorer_config=JaxScorerConfig(text_len=32))
        else:
            self.scorer = TorchFraudScorer(models=models_from_numpy(models),
                                           scorer_config=ScorerConfig(text_len=32),
                                           bert_config=TINY_CONFIG, device="cpu")
        self.scorer.seed_profiles(self.gen.users.profiles(),
                                  self.gen.merchants.profiles())
        self.tokens = []
        assemble = self.scorer.assemble

        def keep_tokens(*args, **kwargs):
            batch = assemble(*args, **kwargs)
            self.tokens.append((np.asarray(batch.token_ids),
                                np.asarray(batch.token_mask)))
            return batch

        self.scorer.assemble = keep_tokens

    def broker(self):
        return JaxInMemoryBroker() if self.jax else InMemoryBroker()

    def job(self, broker, **kw):
        cfg = (JaxJobConfig if self.jax else JobConfig)(
            max_batch=BATCH, max_delay_ms=1.0, enable_analytics=True,
            enable_enrichment=True, **kw)
        return (JaxStreamJob if self.jax else StreamJob)(broker, self.scorer, cfg)

    def checkpoint(self, path, job):
        mgr = (JaxCheckpointManager if self.jax else CheckpointManager)(path)
        snap = jax_snapshot_host_state if self.jax else snapshot_scorer_host_state
        mgr.save(1, host_state=snap(self.scorer), offsets=job.consumer.positions())
        return mgr

    def restore(self, mgr, job):
        ck = mgr.restore()
        (jax_restore_host_state if self.jax else restore_scorer_host_state)(
            self.scorer, ck.host_state)
        job.consumer.seek_to_positions(ck.offsets)


def _outputs(broker):
    return {topic: _topic(broker, topic)
            for topic in (T.PREDICTIONS, T.ENRICHED, *ANALYTICS_TOPICS)}


@pytest.fixture(scope="module")
def jax_models():
    return _jax_models()


@pytest.fixture(scope="module")
def job_runs(jax_models):
    """The seeded 1,024-transaction stream through both packages' jobs with
    analytics and enrichment on, then each package's analytics flushed."""
    runs = {}
    for name in ("port", "jax"):
        side = _Side(name == "jax", jax_models)
        broker = side.broker()
        job = side.job(broker)
        records = side.gen.generate_batch(STREAM)
        broker.produce_batch(T.TRANSACTIONS, records, key_fn=lambda r: str(r["user_id"]))
        scored = job.run_until_drained(now=1000.0)
        job.analytics.flush()
        runs[name] = dict(records=records, scored=scored, out=_outputs(broker),
                          counters=dict(job.counters), stats=job.analytics.stats(),
                          tokens=side.tokens)
        if name == "port":
            job.close()
    weights = JaxEnsembleParams.from_config(jconfig.Config(), MODEL_NAMES).weights
    runs["bound"] = noise_bound(jax_models.bert, runs["jax"]["tokens"], weights,
                                np.ones(5, bool))
    return runs


def _near(values, cuts, tol):
    v = np.asarray(values, np.float64)
    return np.min(np.abs(v[:, None] - np.asarray(cuts)[None, :]), axis=1) <= tol


def _compare_outputs(got, want, bound):
    """Predictions, enriched records and analytics records equal JAX's:
    ids and order exact, scores within the bound (the blend: 0.6 x the
    bound + ENRICH_TOL), decisions and risk levels equal off a cut, every
    analytics record equal but for the high-risk count of a window holding
    a row within the blend's bound of 0.7. Returns the counts skipped."""
    from torch_bounds import near_rung

    skipped = {}
    preds, jpreds = got[T.PREDICTIONS], want[T.PREDICTIONS]
    assert [p["transaction_id"] for p in preds] == [q["transaction_id"] for q in jpreds]
    near = near_rung([q["fraud_probability"] for q in jpreds], bound) | near_rung(
        [q["confidence"] for q in jpreds], bound)
    for p, q, skip in zip(preds, jpreds, near):
        assert skip or (p["decision"], p["risk_level"]) == (q["decision"], q["risk_level"])
    np.testing.assert_allclose([p["fraud_score"] for p in preds],
                               [q["fraud_score"] for q in jpreds], rtol=0, atol=bound)
    skipped["predictions"] = int(near.sum())

    enriched, jenriched = got[T.ENRICHED], want[T.ENRICHED]
    assert [e["transaction_id"] for e in enriched] == [
        e["transaction_id"] for e in jenriched]
    blend_tol = 0.6 * bound + ENRICH_TOL
    jblend = [e["fraud_score"] for e in jenriched]
    np.testing.assert_allclose([e["fraud_score"] for e in enriched], jblend,
                               rtol=0, atol=blend_tol)
    np.testing.assert_allclose([e["ensemble_score"] for e in enriched],
                               [e["ensemble_score"] for e in jenriched],
                               rtol=0, atol=bound)
    near_dec, near_risk = _near(jblend, DECISION_CUTS, blend_tol), _near(
        jblend, CUTS, blend_tol)
    for e, f, nd, nr in zip(enriched, jenriched, near_dec, near_risk):
        assert nd or e["decision"] == f["decision"]
        assert nr or e["risk_level"] == f["risk_level"]
        rest = {k: v for k, v in e.items()
                if k not in ("fraud_score", "ensemble_score", "decision", "risk_level")}
        assert rest == {k: v for k, v in f.items() if k in rest} and len(rest) == len(
            [k for k in f if k not in ("fraud_score", "ensemble_score", "decision",
                                       "risk_level")])
    skipped["enriched_decisions"] = int(near_dec.sum())

    near_hr = [(e, _event_time_ms(e, None) / 1000.0) for e, f in zip(enriched, jenriched)
               if abs(f["fraud_score"] - HIGH_RISK) <= blend_tol]
    differing = 0
    for topic in ANALYTICS_TOPICS:
        recs, jrecs = got[topic], want[topic]
        assert len(recs) == len(jrecs) and recs, topic
        key_field, key_fn = TOPIC_KEY[topic]
        for r, s in zip(recs, jrecs):
            if r == s:
                continue
            assert {k: v for k, v in r.items() if k != "high_risk_count"} == {
                k: v for k, v in s.items() if k != "high_risk_count"}, topic
            assert any(key_fn(e) == r[key_field]
                       and r["window_start"] <= ts < r["window_end"]
                       for e, ts in near_hr), (topic, r)
            differing += 1
    skipped["analytics_windows"] = differing
    return skipped


def test_job_with_analytics_and_enrichment_matches_jax(job_runs):
    got, want = job_runs["port"], job_runs["jax"]
    assert got["records"] == want["records"]
    assert got["scored"] == want["scored"] == STREAM
    assert got["counters"] == want["counters"]
    assert got["stats"] == want["stats"]
    bound = job_runs["bound"]
    assert 1e-4 <= bound <= 1e-3
    skipped = _compare_outputs(got["out"], want["out"], bound)
    # one prediction lies within the bound of a rung on this stream; no
    # blended score near 0.6 / 0.95, no window holding a row near 0.7
    assert skipped == {"predictions": 1, "enriched_decisions": 0,
                       "analytics_windows": 0}
    # each id once on the predictions and enriched topics; the blend moved
    # scores and the enrichment ladder's decisions
    for topic in (T.PREDICTIONS, T.ENRICHED):
        assert Counter(v["transaction_id"] for v in got["out"][topic]) == Counter(
            r["transaction_id"] for r in got["records"])
    enriched = got["out"][T.ENRICHED]
    assert any(e["fraud_score"] != e["ensemble_score"] for e in enriched)
    assert all(e["decision"] in ("APPROVE", "REVIEW", "DECLINE") for e in enriched)
    assert sum(got["stats"][op]["fired"] for op in got["stats"]) == sum(
        len(got["out"][t]) for t in ANALYTICS_TOPICS)


# --------------------------------------------------------------- the drain
def _drain_run(side, tmp_path, stop_after: int):
    """The stream of the job test, cut to 768, with ``request_stop`` after
    batch ``stop_after`` completes; a checkpoint (host state and positions),
    then a second job on the same broker resumed from it."""
    broker = side.broker()
    job = side.job(broker)
    records = side.gen.generate_batch(3 * BATCH)
    broker.produce_batch(T.TRANSACTIONS, records, key_fn=lambda r: str(r["user_id"]))
    complete = job.complete_batch

    def complete_and_stop(ctx, *args, **kwargs):
        out = complete(ctx, *args, **kwargs)
        if job.counters["batches"] == stop_after:
            job.request_stop()
        return out

    job.complete_batch = complete_and_stop
    first = job.run_until_drained(now=1000.0)
    first_counters = dict(job.counters)
    lag_at_stop = broker.lag(job.config.group_id, T.TRANSACTIONS)
    committed = job.consumer.positions()
    mgr = side.checkpoint(tmp_path / ("jax" if side.jax else "port"), job)
    if not side.jax:
        job.close()
    resumed = side.job(broker)
    side.restore(mgr, resumed)
    second = resumed.run_until_drained(now=1000.0)
    resumed.analytics.flush()
    if not side.jax:
        resumed.close()
    return dict(first=first, second=second, first_counters=first_counters,
                tokens=side.tokens,
                lag_at_stop=lag_at_stop, committed=committed,
                second_counters=dict(resumed.counters), records=records,
                out=_outputs(broker), lag=broker.lag(resumed.config.group_id,
                                                     T.TRANSACTIONS))


def test_stop_checkpoint_resume_exactly_once_and_equal_to_jax(jax_models, tmp_path):
    runs = {name: _drain_run(_Side(name == "jax", jax_models), tmp_path, stop_after=1)
            for name in ("port", "jax")}
    got, want = runs["port"], runs["jax"]
    # the stop after batch 1 drains batch 2 (in flight at depth 2) and
    # commits it; the resume scores the rest, nothing twice
    for run in (got, want):
        assert (run["first"], run["second"]) == (2 * BATCH, BATCH)
        assert run["lag_at_stop"] == BATCH and run["lag"] == 0
        assert run["second_counters"]["duplicates_skipped"] == 0
        for topic in (T.PREDICTIONS, T.ENRICHED):
            ids = Counter(v["transaction_id"] for v in run["out"][topic])
            assert ids == Counter(r["transaction_id"] for r in run["records"])
    assert got["committed"] == want["committed"]
    assert got["first_counters"] == want["first_counters"]
    assert got["second_counters"] == want["second_counters"]
    weights = JaxEnsembleParams.from_config(jconfig.Config(), MODEL_NAMES).weights
    bound = noise_bound(jax_models.bert, want["tokens"], weights, np.ones(5, bool))
    skipped = _compare_outputs(got["out"], want["out"], bound)
    assert skipped == {"predictions": 1, "enriched_decisions": 0,
                       "analytics_windows": 0}


class _StubScorer:
    """A scorer stand-in both jobs drive: 0.5 REVIEW for every record,
    feature rows of zeros, write-back into a plain transaction cache."""

    class _Cache:
        def __init__(self):
            self.seen = {}

        def get_transaction(self, txn_id, now=None):
            return self.seen.get(txn_id)

    def __init__(self):
        self.txn_cache = self._Cache()
        self.device = "cpu"

    def dispatch(self, records, now=None):
        return dataclasses.make_dataclass("P", ["records", "features"])(
            list(records), np.zeros((len(records), 64), np.float32))

    def assemble(self, records, now=None):          # the overlapped stage's half
        return records

    def dispatch_assembled(self, batch, records, t0=None, trace=None):
        return self.dispatch(records)

    def finalize(self, pending, now=None, lock=None):
        out = []
        for r in pending.records:
            self.txn_cache.seen[r["transaction_id"]] = {"fraud_score": 0.5}
            out.append({"transaction_id": r["transaction_id"], "fraud_probability": 0.5,
                        "fraud_score": 0.5, "risk_level": "MEDIUM",
                        "decision": "REVIEW", "model_predictions": {},
                        "confidence": 1.0, "processing_time_ms": 0.0,
                        "explanation": {}})
        return out


@pytest.mark.parametrize("package", ["port", "jax"])
@pytest.mark.parametrize("loop", ["run_until_drained", "run_for"])
@pytest.mark.parametrize("overlap", [False, True], ids=["serial", "overlap"])
def test_stop_drains_the_polled_tail(package, loop, overlap):
    """Records the assembler polled but had not batched when the stop came
    are scored and committed by the drain, in both run loops, through the
    overlapped assembly stage too."""
    gen = TransactionGenerator(num_users=10, num_merchants=4, seed=3)
    broker = JaxInMemoryBroker() if package == "jax" else InMemoryBroker()
    cfg = dict(max_batch=32, max_delay_ms=1e9, enable_enrichment=True,
               enable_analytics=True, overlap_assembly=overlap)
    job = (JaxStreamJob(broker, _StubScorer(), JaxJobConfig(**cfg)) if package == "jax"
           else StreamJob(broker, _StubScorer(), JobConfig(**cfg)))
    records = gen.generate_batch(10)
    broker.produce_batch(T.TRANSACTIONS, records, key_fn=lambda r: str(r["user_id"]))
    assert job.assembler.next_batch(block=False) == []     # polled, not batched
    assert len(job.assembler._pending) == 10
    job.request_stop()
    assert job.stop_requested
    scored = (job.run_until_drained(now=5.0) if loop == "run_until_drained"
              else job.run_for(30.0))
    assert scored == 10 and broker.lag(job.config.group_id, T.TRANSACTIONS) == 0
    assert sorted(p["transaction_id"] for p in _topic(broker, T.PREDICTIONS)) == sorted(
        r["transaction_id"] for r in records)
    assert job.assembler.close_reasons == {"flush": 1}
    # the enrichment blend ran on the stub's zero feature rows
    enriched = _topic(broker, T.ENRICHED)
    assert [e["ensemble_score"] for e in enriched] == [0.5] * 10
    if package == "port":
        job.close()


def test_process_batch_matches_jax():
    records = TransactionGenerator(num_users=5, num_merchants=3, seed=4).generate_batch(6)
    recs = [dataclasses.make_dataclass("R", ["value", "timestamp"])(r, 1.0)
            for r in records]
    enriched = {}
    for package, job_cls, cfg_cls, broker in (
            ("port", StreamJob, JobConfig, InMemoryBroker()),
            ("jax", JaxStreamJob, JaxJobConfig, JaxInMemoryBroker())):
        job = job_cls(broker, _StubScorer(), cfg_cls(enable_enrichment=True))
        out = job.process_batch(recs, now=2.0)
        assert [o["transaction_id"] for o in out] == [r["transaction_id"] for r in records]
        assert job.process_batch([], now=2.0) == []
        enriched[package] = _topic(broker, T.ENRICHED)
    assert enriched["port"] == enriched["jax"] and len(enriched["port"]) == 6


# ------------------------------------------------------------ replay_state
def test_replay_state_matches_jax(jax_models):
    sides = {name: _Side(name == "jax", jax_models, seed=33) for name in ("port", "jax")}
    records = sides["port"].gen.generate_batch(96)
    assert records == sides["jax"].gen.generate_batch(96)
    for side in sides.values():
        side.scorer.replay_state(records[:64], now=500.0)
        side.scorer.replay_state(records[64:], now=560.0)
        side.scorer.replay_state([], now=600.0)
    port, jx = sides["port"].scorer, sides["jax"].scorer
    assert port.velocity.entries() == jx.velocity.entries()
    assert port.txn_cache.entries(now=600.0) == jx.txn_cache.entries(now=600.0)
    cached = port.txn_cache.get_transaction(records[0]["transaction_id"], now=600.0)
    assert (cached["decision"], cached["fraud_score"], cached["risk_level"]) == (
        "REVIEW", 0.5, "UNKNOWN")
    users = sorted({r["user_id"] for r in records})
    hist, n = port.history._gather_slots(port.history._slot_ids(users, False))
    jhist, jn = jx.history._gather_slots(jx.history._slot_ids(users, False))
    np.testing.assert_array_equal(n, jn)
    exact = [i for i in range(64) if i not in TRANSCENDENTAL]
    np.testing.assert_array_equal(np.asarray(hist)[..., exact],
                                  np.asarray(jhist)[..., exact])
    np.testing.assert_allclose(np.asarray(hist)[..., TRANSCENDENTAL],
                               np.asarray(jhist)[..., TRANSCENDENTAL], rtol=1e-5, atol=1e-5)
    # nothing was scored or counted
    assert port.stats["batches"] == jx.stats.get("batches", 0) == 0


# ---------------------------------------- config, serving features, metadata
def test_sim_config_and_models_base_path_match_jax(monkeypatch):
    assert dataclasses.asdict(pconfig.SimConfig()) == dataclasses.asdict(
        jconfig.SimConfig())
    assert pconfig.Config().sim == pconfig.SimConfig()
    for env in ({}, {"MODELS_PATH": "/models/a"},
                {"MODELS_PATH": "/models/a", "RTFD_MODELS_PATH": "/models/b"}):
        for key in ("MODELS_PATH", "RTFD_MODELS_PATH"):
            monkeypatch.delenv(key, raising=False)
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        assert pconfig.Config().models_base_path == jconfig.Config().models_base_path
    assert pconfig.Config().models_base_path == "/models/b"
    cfg = pconfig.Config.from_dict({"sim": {"tps": 250}, "models_base_path": "x"})
    assert cfg.sim.tps == 250 and cfg.to_dict()["sim"]["tps"] == 250


def test_serving_feature_processor_matches_jax():
    rng = np.random.default_rng(8)
    p, jp = ServingFeatureProcessor(), JaxServingFeatureProcessor()
    names = p.get_feature_names()
    assert names == jp.get_feature_names()
    raws = []
    for i in range(40):
        raw = {n: float(rng.normal(0, 50)) for n in names if rng.random() < 0.6}
        raw["amount"] = float(abs(rng.normal(100, 80)))
        raw["transaction_id"] = f"t{i}"
        if i % 5 == 0:
            raw["is_tor_ip"] = "yes"
            raw["hour_of_day"] = math.nan
        if i % 7 == 0:
            raw["features"] = {"merchant_fraud_rate": 2.0}
        raws.append(raw)
    got, want = p.process_batch(raws), jp.process_batch(raws)
    assert got == want
    np.testing.assert_array_equal(p.to_model_matrix(got), jp.to_model_matrix(want))
    assert p.validate_feature_schema(raws[1]) == jp.validate_feature_schema(raws[1])
    with pytest.raises(ValueError, match="Required feature"):
        p.process_features({})


def test_metadata_store_matches_jax(tmp_path):
    def drive(cls, path):
        s = cls(path)
        s.register_job("job-1", "fraud-detection-job", parallelism=2)
        s.record_checkpoint("job-1", 1, "/ck/1", duration_ms=3.5)
        s.record_checkpoint("job-1", 2, "/ck/2", duration_ms=4.0)
        s.set_job_status("job-1", "FINISHED")
        s.register_feature_group("g", "group")
        s.register_feature("f1", group="g")
        s.put_feature_values("user", "u1", {"f1": 1.5}, ttl_s=10.0)
        s.put_profiles({"u1": {"risk": 0.2}}, {"m1": {"cat": "retail"}})
        out = dict(job={k: v for k, v in s.get_job("job-1").items()
                        if not k.endswith(("_at", "_time"))},
                   checkpoints=[{k: v for k, v in c.items() if not k.endswith("_time")}
                                for c in s.checkpoints("job-1")],
                   latest=s.latest_checkpoint("job-1")["step"],
                   names=s.feature_names("g"),
                   values=s.get_feature_values("user", "u1"),
                   profiles=s.load_all_profiles(), stats=s.stats())
        s.close()
        reopened = cls(path)
        out["durable"] = reopened.get_job("job-1")["status"]
        reopened.close()
        return out

    got = drive(MetadataStore, str(tmp_path / "port.db"))
    assert got == drive(JaxMetadataStore, str(tmp_path / "jax.db"))
    assert got["durable"] == "FINISHED" and got["latest"] == 2
