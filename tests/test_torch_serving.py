"""The port's scoring service against the JAX package's, on the CPU.

- ``RequestMicrobatcher``: the JAX batcher and the port's, driven by one
  seeded arrival schedule on an injected virtual clock (deadline only, with
  a QoS budget, with a budget and the tuning plane's controller), close the
  same batches for the same reasons.
- ``PredictionCache``, ``FeatureDriftMonitor`` and ``ABTestManager`` give
  equal outputs on seeded inputs.
- A JAX ``ServingApp`` and a port ``ServingApp`` (``device="cpu"``, the same
  bridged models and seeded profiles, tracing on), each on 127.0.0.1:0, get
  the same three ``/batch-predict`` bodies and eight sequential
  ``/predict``: the same keys, decision and risk level equal on every row
  whose JAX probability and confidence lie farther than the bound from a
  rung (the rows skipped are asserted), ``fraud_score`` and ``confidence``
  within the JAX kernel drill's bf16 noise bound on the JAX app's own
  tokens and each branch's prediction within its own bf16 gap
  (``torch_bounds.py``, floored at 1e-4); ``/health``, ``/model-info`` and
  ``/metrics`` with equal keys.
- The port-side analogues of ``tests/test_serving.py``'s endpoint tests
  (cache retry, admission 503, 413 / 404 / 405 / 400 / 422, reloads and
  their failure paths, a QoS rung applied at dispatch, traces closed
  ``cached`` / ``error``, ``/latency/breakdown``, ``/slo``, ``/autotune``),
  and ``serve`` refusing to start without a card.
"""

import torch_threads  # noqa: F401  (first: torch held to one CPU thread)
import asyncio
import http.client
import json
import random
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

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
from realtime_fraud_detection_tpu.models.trees import TreeEnsemble as JaxTreeEnsemble
from realtime_fraud_detection_tpu.obs.drift import DriftConfig as JaxDriftConfig
from realtime_fraud_detection_tpu.obs.drift import (
    FeatureDriftMonitor as JaxFeatureDriftMonitor,
)
from realtime_fraud_detection_tpu.qos.budget import LatencyBudget as JaxLatencyBudget
from realtime_fraud_detection_tpu.scoring import FraudScorer
from realtime_fraud_detection_tpu.scoring import ScorerConfig as JaxScorerConfig
from realtime_fraud_detection_tpu.serving import ServingApp as JaxServingApp
from realtime_fraud_detection_tpu.serving.batcher import (
    RequestMicrobatcher as JaxRequestMicrobatcher,
)
from realtime_fraud_detection_tpu.serving.cache import (
    PredictionCache as JaxPredictionCache,
)
from realtime_fraud_detection_tpu.sim.simulator import (
    TransactionGenerator as JaxTransactionGenerator,
)
from realtime_fraud_detection_tpu.testing import ABTestManager as JaxABTestManager
from realtime_fraud_detection_tpu.testing import Variant as JaxVariant
from realtime_fraud_detection_tpu.testing import (
    apply_weight_overrides as jax_apply_weight_overrides,
)
from realtime_fraud_detection_tpu.tuning import TuningPlane as JaxTuningPlane
from realtime_fraud_detection_tpu.utils.config import Config as JaxConfig
from realtime_fraud_detection_tpu.utils.config import (
    TuningSettings as JaxTuningSettings,
)
from realtime_fraud_detection_tpu_torch.__main__ import main as port_main
from realtime_fraud_detection_tpu_torch.bridge import models_from_numpy
from realtime_fraud_detection_tpu_torch.checkpoint import CheckpointManager
from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
from realtime_fraud_detection_tpu_torch.models.quant import quantize_bert_params
from realtime_fraud_detection_tpu_torch.obs.drift import DriftConfig, FeatureDriftMonitor
from realtime_fraud_detection_tpu_torch.obs.tracing import clear_log_context
from realtime_fraud_detection_tpu_torch.qos.budget import LatencyBudget
from realtime_fraud_detection_tpu_torch.scoring.pipeline import (
    MODEL_NAMES,
    ScorerConfig,
    init_scoring_models,
)
from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
from realtime_fraud_detection_tpu_torch.serving.app import ServingApp
from realtime_fraud_detection_tpu_torch.serving.batcher import RequestMicrobatcher
from realtime_fraud_detection_tpu_torch.serving.cache import PredictionCache
from realtime_fraud_detection_tpu_torch.serving.loadgen import run_load
from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
from realtime_fraud_detection_tpu_torch.testing import (
    ABTestManager,
    Variant,
    apply_weight_overrides,
)
from realtime_fraud_detection_tpu_torch.tuning.plane import TuningPlane
from realtime_fraud_detection_tpu_torch.utils.config import Config, TuningSettings
from torch_bounds import branch_bounds, near_rung, noise_bound


# ---------------------------------------------------------------------------
# the microbatcher under one virtual clock
# ---------------------------------------------------------------------------

def _schedule(seed, scale):
    """(virtual time, arrivals) ticks: gaps from short to past the close
    bounds, one to five arrivals a tick."""
    rng = random.Random(seed)
    t, out = 0.0, []
    for _ in range(40):
        t += rng.choice((0.02, 0.1, 0.4, 0.9, 1.6)) * scale
        out.append((t, rng.randint(1, 5)))
    return out


async def _settle(b, closes):
    """Let the drain loop take every queued arrival, and every closed batch
    finish scoring, before the clock moves: a close is decided when the loop
    takes an item, and a finished batch feeds the controller the clock's
    time (a later tick's would teach it another service time)."""
    for _ in range(2000):
        await asyncio.sleep(0.005)
        if b.queue_depth == 0 and b.batches == len(closes):
            break
    await asyncio.sleep(0.01)


def _drive_batcher(batcher_cls, budget, controller, scale):
    vnow = [0.0]
    closes = []

    def score(txns, trace=None):
        closes.append((len(txns), b.last_close_reason))
        return [dict(t) for t in txns]

    async def main():
        nonlocal b
        b = batcher_cls(score, max_batch=8, deadline_ms=1e3 * scale,
                        budget=budget, controller=controller,
                        clock=lambda: vnow[0])
        await b.start()
        futs = []
        for t, n in _schedule(3, scale):
            vnow[0] = t
            futs += [b.submit_nowait({"i": len(futs) + k}) for k in range(n)]
            await _settle(b, closes)
        await b.stop()
        got = await asyncio.gather(*futs)
        assert [g["i"] for g in got] == list(range(len(futs)))
        return dict(b.close_reasons)

    b = None
    reasons = asyncio.run(main())
    return closes, reasons


@pytest.mark.parametrize("mode", ["deadline", "budget", "budget_controller"])
def test_microbatcher_closes_like_jax_under_one_clock(mode, monkeypatch):
    # A close is decided when an arrival wakes the drain loop: its timed
    # waits never expire here (a real timeout racing an arrival at the same
    # virtual instant would make the batch depend on thread timing). The
    # controller works in milliseconds, its clock scaled to match.
    real_wait_for = asyncio.wait_for
    monkeypatch.setattr(asyncio, "wait_for",
                        lambda aw, timeout=None: real_wait_for(aw, None))
    scale = 1e-3 if mode == "budget_controller" else 60.0
    sides = []
    for budget_cls, plane_cls, settings_cls, batcher_cls in (
            (JaxLatencyBudget, JaxTuningPlane, JaxTuningSettings,
             JaxRequestMicrobatcher),
            (LatencyBudget, TuningPlane, TuningSettings, RequestMicrobatcher)):
        budget = (budget_cls(budget_ms=1e3 * scale * 0.9, margin_ms=1e3 * scale * 0.2)
                  if mode != "deadline" else None)
        controller = (plane_cls(settings_cls(enabled=True))
                      if mode == "budget_controller" else None)
        sides.append(_drive_batcher(batcher_cls, budget, controller, scale))
    (jax_closes, jax_reasons), (closes, reasons) = sides
    assert closes == jax_closes
    assert reasons == jax_reasons
    kinds = {"deadline": {"deadline", "size"}, "budget": {"budget", "size"},
             "budget_controller": {"jit"}}[mode]
    assert kinds <= set(reasons), reasons


# ---------------------------------------------------------------------------
# cache, drift, A/B on seeded inputs
# ---------------------------------------------------------------------------

def test_prediction_cache_matches_jax():
    rng = random.Random(5)
    sides = [JaxPredictionCache(ttl_seconds=10.0, max_entries=6),
             PredictionCache(ttl_seconds=10.0, max_entries=6)]
    outs = [[], []]
    for step in range(300):
        now = step * 0.1
        key = f"t{rng.randint(0, 12)}"
        op = rng.random()
        for cache, out in zip(sides, outs):
            if op < 0.5:
                cache.put(key, {"k": key, "step": step, "nested": {"a": [step]}},
                          now=now)
            else:
                hit = cache.get(key, now=now)
                out.append(hit)
                if hit is not None:
                    hit["nested"]["a"].append(-1)      # deep copies out
        if step % 97 == 0:
            for cache in sides:
                cache.clear()
    assert outs[0] == outs[1]
    assert sides[0].stats() == sides[1].stats()
    assert sides[1].hits > 0 and sides[1].misses > 0


def test_feature_drift_matches_jax():
    rng = np.random.default_rng(9)
    cfg = dict(num_features=16, warmup_rows=300, window_rows=200, min_report_rows=100)
    jax_mon, mon = JaxFeatureDriftMonitor(JaxDriftConfig(**cfg)), \
        FeatureDriftMonitor(DriftConfig(**cfg))
    for step in range(12):
        shift = 0.0 if step < 6 else 1.5
        x = rng.normal(0.0, 1.0, (64, 16)).astype(np.float32)
        x[:, 3] += shift
        jax_mon.update(x)
        mon.update(x)
        a, b = jax_mon.report(), mon.report()
        assert (a.drifted, a.top_features, a.rows_seen, a.baseline_frozen) == (
            b.drifted, b.top_features, b.rows_seen, b.baseline_frozen)
        np.testing.assert_array_equal(a.psi, b.psi)
    assert b.drifted and b.top_features[0] == 3


def test_ab_manager_matches_jax(tmp_path):
    rng = random.Random(11)
    sides = [(JaxABTestManager(), JaxVariant), (ABTestManager(), Variant)]
    for mgr, variant in sides:
        mgr.create_experiment("exp", [variant("control", 0.3),
                                      variant("treatment", 0.7,
                                              {"weights": {"bert_text": 0.9}})],
                              salt="s")
    artifact = tmp_path / "q.json"
    artifact.write_text(json.dumps({"selected_blend": {"weights": {
        "xgboost_primary": 0.6, "lstm_sequential": 0.4}}}))
    for mgr, _ in sides:
        mgr.experiment_from_artifact("canary", str(artifact), traffic=0.25)
    for i in range(400):
        uid, score = f"u{rng.randint(0, 150)}", rng.random()
        label = rng.random() < 0.3 if i % 3 else None
        for mgr, _ in sides:
            for name in mgr.active_experiments():
                v = mgr.assign(name, uid)
                mgr.record_prediction(name, v.name, score, score > 0.7, label)
    for name in ("exp", "canary"):
        a, b = sides[0][0].results(name), sides[1][0].results(name)
        a.pop("running_seconds"), b.pop("running_seconds")
        assert a == b
    preds = {"xgboost_primary": 0.91, "lstm_sequential": 0.42, "bert_text": 0.77,
             "graph_neural": 0.15, "isolation_forest": 0.5}
    base = JaxConfig().normalized_weights()
    for overrides in ({"bert_text": 0.9}, {"xgboost_primary": 0.0, "graph_neural": 2.0},
                      {n: 0.0 for n in preds}):
        assert apply_weight_overrides(preds, base, overrides) == \
            jax_apply_weight_overrides(preds, base, overrides)


# ---------------------------------------------------------------------------
# a JAX app and a port app on the same traffic
# ---------------------------------------------------------------------------

class _Served:
    """An app serving from its own event loop thread."""

    def __init__(self, app):
        self.app = app
        self.loop = asyncio.new_event_loop()
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)

            async def _start():
                await app.start()
                started.set()

            self.loop.run_until_complete(_start())
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert started.wait(timeout=60)

    def request(self, method, path, body=None, raw=None, headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.app.port, timeout=120)
        payload = raw if raw is not None else (
            json.dumps(body) if body is not None else None)
        conn.request(method, path, body=payload, headers=headers or (
            {"Content-Type": "application/json"} if payload else {}))
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        ctype = resp.getheader("Content-Type", "")
        return resp.status, (json.loads(data) if "json" in ctype else data.decode())

    def close(self):
        asyncio.run_coroutine_threadsafe(self.app.stop(), self.loop).result(timeout=30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


def _jax_models():
    """The JAX model set with random trees and forest, f32 BERT, numpy
    leaves (``tests/test_torch_stream.py``'s)."""
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


def _serving_config(cls):
    config = cls()
    config.serving.microbatch_deadline_ms = 1.0
    config.serving.prediction_timeout_seconds = 180.0
    config.monitoring.prometheus_port = 0
    config.tracing.enabled = True
    return config


def _drive_app(served):
    """Three /batch-predict bodies, then eight sequential /predict, the
    records from the service's own seeded simulator."""
    gen = served.gen
    out = {"batches": [], "predicts": []}
    for n in (8, 6, 5):
        status, data = served.request("POST", "/batch-predict",
                                      {"transactions": gen.generate_batch(n)})
        assert status == 200 and data["count"] == n
        out["batches"].append(data["results"])
    for txn in gen.generate_batch(8):
        status, data = served.request("POST", "/predict", txn)
        assert status == 200
        out["predicts"].append(data)
    for path in ("/health", "/model-info", "/metrics"):
        status, out[path] = served.request("GET", path)
        assert status == 200
    return out


@pytest.fixture(scope="module")
def parity():
    jax_models = _jax_models()
    jax_scorer = FraudScorer(_serving_config(JaxConfig), models=jax_models,
                             scorer_config=JaxScorerConfig(text_len=32))
    batches = []
    assemble = jax_scorer.assemble

    def keep(*args, **kwargs):
        batch = assemble(*args, **kwargs)
        batches.append(jax.tree_util.tree_map(np.asarray, batch))
        return batch

    jax_scorer.assemble = keep
    config = _serving_config(Config)
    scorer = TorchFraudScorer(config, models=models_from_numpy(jax_models),
                              scorer_config=ScorerConfig(text_len=32),
                              bert_config=TINY_CONFIG, device="cpu")
    runs = {}
    for name, app, gen in (
            ("jax", JaxServingApp(jax_scorer.config, scorer=jax_scorer,
                                  host="127.0.0.1", port=0),
             JaxTransactionGenerator(num_users=50, num_merchants=20, seed=13)),
            ("port", ServingApp(config, scorer=scorer, host="127.0.0.1", port=0,
                                device="cpu"),
             TransactionGenerator(num_users=50, num_merchants=20, seed=13))):
        app.scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
        served = _Served(app)
        served.gen = gen
        try:
            runs[name] = _drive_app(served)
        finally:
            served.close()
    weights = JaxEnsembleParams.from_config(JaxConfig(), MODEL_NAMES).weights
    runs["bound"] = noise_bound(
        jax_models.bert, [(b.token_ids, b.token_mask) for b in batches], weights,
        np.ones(5, bool))
    stacked = SimpleNamespace(**{
        k: np.concatenate([getattr(b, k) for b in batches])
        for k in ("history", "history_len", "token_ids", "token_mask")})
    runs["branch"] = branch_bounds(jax_models, stacked)
    return runs


def _rows(run):
    return [r for b in run["batches"] for r in b] + run["predicts"]


def test_app_answers_like_jax(parity):
    got, want = _rows(parity["port"]), _rows(parity["jax"])
    bound, branch = parity["bound"], parity["branch"]
    assert [r["transaction_id"] for r in got] == [r["transaction_id"] for r in want]
    prob = np.array([r["fraud_probability"] for r in want])
    conf = np.array([r["confidence"] for r in want])
    near = near_rung(prob, bound) | near_rung(conf, bound)
    assert int(near.sum()) == 0, "rows near a rung for this seed"
    for p, q, skip in zip(got, want, near):
        assert set(p) == set(q)
        assert set(p["explanation"]) == set(q["explanation"])
        if not skip:
            assert (p["decision"], p["risk_level"]) == (q["decision"], q["risk_level"])
        assert abs(p["fraud_score"] - q["fraud_score"]) <= bound
        assert abs(p["confidence"] - q["confidence"]) <= bound
        for j, name in enumerate(MODEL_NAMES):
            assert abs(p["model_predictions"][name]
                       - q["model_predictions"][name]) <= branch[j], name


def test_app_endpoints_have_jax_keys(parity):
    for path in ("/health", "/model-info", "/metrics"):
        assert set(parity["port"][path]) == set(parity["jax"][path]), path
    assert parity["port"]["/model-info"]["models"] == parity["jax"]["/model-info"]["models"]
    assert parity["port"]["/health"]["prediction_cache"] == \
        parity["jax"]["/health"]["prediction_cache"]


# ---------------------------------------------------------------------------
# the port's endpoints (tests/test_serving.py's analogues)
# ---------------------------------------------------------------------------

def _small_models(seed):
    return init_scoring_models(seed, n_trees=8, tree_depth=4)


@pytest.fixture(scope="module")
def served():
    config = _serving_config(Config)
    config.serving.microbatch_deadline_ms = 10.0
    scorer = TorchFraudScorer(config, models=_small_models(1),
                              scorer_config=ScorerConfig(text_len=32), device="cpu")
    app = ServingApp(config, scorer=scorer, host="127.0.0.1", port=0, device="cpu")
    gen = TransactionGenerator(num_users=128, num_merchants=32, seed=17)
    app.scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    s = _Served(app)
    s.gen = gen
    yield s
    s.close()


def _txn(s, **kw):
    return dict(s.gen.generate_batch(1)[0], **kw)


class TestEndpoints:
    def test_predict_schema(self, served):
        status, data = served.request("POST", "/predict", _txn(served))
        assert status == 200
        for field in ("transaction_id", "fraud_probability", "fraud_score",
                      "risk_level", "decision", "model_predictions", "confidence",
                      "processing_time_ms", "explanation"):
            assert field in data, field
        assert set(data["model_predictions"]) == set(MODEL_NAMES)

    def test_prediction_cache_serves_idempotent_retry(self, served):
        app, txn = served.app, _txn(served)
        _, first = served.request("POST", "/predict", txn)
        hits = app.prediction_cache.hits
        _, retry = served.request("POST", "/predict", txn)
        assert app.prediction_cache.hits == hits + 1
        assert retry == first
        _, health = served.request("GET", "/health")
        assert health["prediction_cache"]["hits"] >= 1

    def test_admission_control_sheds_load_at_capacity(self, served):
        app = served.app
        limit = app.config.serving.max_concurrent_predictions
        app.config.serving.max_concurrent_predictions = 5
        try:
            status, data = served.request("POST", "/batch-predict",
                                          {"transactions": served.gen.generate_batch(10)})
            assert status == 413 and "split into smaller batches" in json.dumps(data)
            app._inflight_txns = 3
            status, data = served.request("POST", "/batch-predict",
                                          {"transactions": served.gen.generate_batch(4)})
            assert status == 503 and "at capacity" in json.dumps(data)
            app._inflight_txns = 0
            status, data = served.request("POST", "/batch-predict",
                                          {"transactions": served.gen.generate_batch(4)})
            assert status == 200 and data["count"] == 4
            assert app._inflight_txns == 0
        finally:
            app.config.serving.max_concurrent_predictions = limit

    def test_concurrent_predicts_microbatch(self, served):
        txns = served.gen.generate_batch(32)
        before = served.app.batcher.batches
        with ThreadPoolExecutor(max_workers=32) as ex:
            out = list(ex.map(lambda t: served.request("POST", "/predict", t), txns))
        assert all(s == 200 for s, _ in out)
        assert {d["transaction_id"] for _, d in out} == {t["transaction_id"] for t in txns}
        assert served.app.batcher.batches - before < 32

    def test_loadgen_answers_each_once(self, served):
        txns = served.gen.generate_batch(24)
        result = run_load("127.0.0.1", served.app.port, txns, clients=6)
        assert not result["errors"] and result["shed_503"] == 0
        assert sorted(a["body"]["transaction_id"] for a in result["answers"]) == \
            sorted(t["transaction_id"] for t in txns)
        assert all(a["status"] == 200 and a["t1"] >= a["t0"] for a in result["answers"])

    def test_health_model_info_metrics(self, served):
        status, data = served.request("GET", "/health")
        assert status == 200 and data["status"] == "healthy" and data["models_loaded"] == 5
        status, data = served.request("GET", "/model-info")
        assert status == 200 and data["num_models"] == 5
        assert abs(sum(m["weight"] for m in data["models"].values()) - 1.0) < 1e-6
        status, data = served.request("GET", "/metrics")
        assert status == 200 and data["total_predictions"] >= 1
        status, text = served.request("GET", "/metrics/prometheus")
        assert status == 200
        for series in ("ml_predictions_total", "scoring_microbatch_size_bucket",
                       "serving_queue_depth", "quant_branch_mode",
                       "kernel_mega_fallback_total", "microbatch_close_reason_total"):
            assert series in text, series
        status, text = served.request("GET", "/metrics/fleet")
        assert status == 200 and 'rtfd_worker_trace_completed_total{worker="serving"}' in text

    def test_dedicated_prometheus_port(self):
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            free_port = s.getsockname()[1]
        config = Config()
        config.monitoring.prometheus_port = free_port
        scorer = TorchFraudScorer(config, models=_small_models(2), device="cpu")
        app = ServingApp(config, scorer=scorer, host="127.0.0.1", port=0, device="cpu")
        assert app.metrics_http is not None

        async def main():
            await app.start()
            try:
                conn = http.client.HTTPConnection("127.0.0.1", free_port, timeout=30)
                await asyncio.to_thread(conn.request, "GET", "/metrics")
                resp = await asyncio.to_thread(conn.getresponse)
                return resp.status, resp.read().decode()
            finally:
                await app.stop()

        status, text = asyncio.run(main())
        assert status == 200 and "ml_predictions_total" in text

    def test_errors_422_413_404_405_400(self, served):
        status, data = served.request("POST", "/predict", {"transaction_id": "x"})
        assert status == 422 and any("user_id" in e for e in data["detail"])
        status, _ = served.request("GET", "/health", headers={"X-Big": "a" * 70_000})
        assert status == 413
        assert served.request("GET", "/nope")[0] == 404
        assert served.request("GET", "/predict")[0] == 405
        assert served.request("POST", "/predict", raw="{not json",
                              headers={"Content-Type": "application/json"})[0] == 400
        assert served.request("POST", "/reload-models",
                              {"checkpoint_dir": "/nonexistent", "step": "three"})[0] == 422
        assert served.request("GET", "/experiments")[0] == 422

    def test_drift_and_experiments(self, served):
        status, data = served.request("GET", "/drift")
        assert status == 200 and data["rows_seen"] >= 1
        spec = {"name": "my exp", "variants": [
            {"name": "control", "traffic": 0.5},
            {"name": "treatment", "traffic": 0.5,
             "overrides": {"weights": {"bert_text": 0.9}}}]}
        assert served.request("POST", "/experiments", spec)[0] == 200
        for txn in served.gen.generate_batch(8):
            assert served.request("POST", "/predict", txn)[0] == 200
        status, data = served.request("GET", "/experiments?name=my%20exp")
        assert status == 200 and data["experiment"] == "my exp"
        assert sum(v["predictions"] for v in data["variants"].values()) >= 8
        assert served.request("GET", "/experiments?name=ghost")[0] == 404
        served.app.ab.stop_experiment("my exp")

    def test_qos_status_configuration_and_shed(self, served):
        status, snap = served.request("GET", "/qos")
        assert status == 200 and snap["enabled"] is False
        assert served.request("POST", "/qos", {"nope": 1})[0] == 422
        status, data = served.request("POST", "/qos", {
            "enabled": True, "admission_rate": 0.001, "admission_burst": 1.0})
        assert status == 200 and data["applied"]["enabled"] is True
        try:
            status, res = served.request("POST", "/predict", _txn(served, amount=5.0))
            assert status == 200 and res["risk_level"] == "SHED"
            assert res["explanation"]["priority"] == "low"
            status, res = served.request("POST", "/predict", _txn(served, amount=5000.0))
            assert status == 200 and res["model_predictions"]
            status, text = served.request("GET", "/metrics/prometheus")
            assert "qos_shed_total" in text
        finally:
            assert served.request("POST", "/qos", {"enabled": False,
                                                   "admission_rate": 0.0})[0] == 200

    def test_predict_applies_rung_change_at_dispatch(self, served):
        app = served.app
        assert served.request("POST", "/qos", {"enabled": True,
                                               "admission_rate": 0.0})[0] == 200
        try:
            assert app.scorer.qos_level == 0
            app.qos.slo_engaged = True            # floors the served rung at 1
            status, res = served.request("POST", "/predict", _txn(served, amount=5000.0))
            assert status == 200 and app.scorer.qos_level == 1
            assert set(res["model_predictions"]) == {
                "xgboost_primary", "lstm_sequential", "isolation_forest"}
            app.qos.slo_engaged = False
            served.request("POST", "/predict", _txn(served, amount=5000.0))
            assert app.scorer.qos_level == 0
        finally:
            app.qos.slo_engaged = False
            assert served.request("POST", "/qos", {"enabled": False,
                                                   "admission_rate": 0.0})[0] == 200

    def test_autotune_disabled(self, served):
        status, data = served.request("GET", "/autotune")
        assert status == 200 and data["enabled"] is False


class TestTracing:
    def test_breakdown_and_slo(self, served):
        for _ in range(3):
            assert served.request("POST", "/predict", _txn(served))[0] == 200
        status, bd = served.request("GET", "/latency/breakdown")
        assert status == 200 and bd["n"] >= 3
        p99 = bd["quantiles"]["p99"]
        assert {"queue", "assemble", "device_wait"} <= set(p99["stage_ms"])
        status, slo = served.request("GET", "/slo")
        assert status == 200 and slo["enabled"] is True
        assert slo["windows"]["fast"]["observed"] >= 1 and "engaged" in slo["qos_gate"]
        status, text = served.request("GET", "/metrics/prometheus")
        assert 'trace_completed_total{terminal="scored"}' in text

    def test_cached_retry_closes_trace_as_cached(self, served):
        txn = _txn(served)
        served.request("POST", "/predict", txn)
        before = served.app.tracer.counters["cached"]
        served.request("POST", "/predict", txn)
        assert served.app.tracer.counters["cached"] == before + 1

    def test_error_path_closes_traces_as_error(self, served, monkeypatch):
        app = served.app
        trace = app.tracer.batch([app.tracer.begin("trace-err-1")], batch_size=1)

        def boom(*a, **k):
            raise RuntimeError("injected dispatch failure")

        monkeypatch.setattr(app.scorer, "dispatch", boom)
        before = app.tracer.counters["errors"]
        try:
            with pytest.raises(RuntimeError):
                app._score_batch_sync([_txn(served, transaction_id="trace-err-1")],
                                      trace)
        finally:
            # tracer.batch published the trace id on this thread; a failed
            # batch never reaches finish_batch, which clears it
            clear_log_context()
        assert app.tracer.counters["errors"] == before + 1
        assert any(t.txn_id == "trace-err-1" for t in app.tracer.traces(terminal="error"))


class TestReload:
    """Run last: each reload replaces the served models."""

    @pytest.fixture(autouse=True)
    def restore_blend(self, served):
        table = {n: (mc.enabled, mc.weight) for n, mc in served.app.config.models.items()}
        yield
        for n, (enabled, weight) in table.items():
            served.app.config.models[n].enabled = enabled
            served.app.config.models[n].weight = weight
        served.app.scorer.refresh_blend_from_config()

    def test_reload_from_seed(self, served):
        status, data = served.request("POST", "/reload-models", {"seed": 123})
        assert status == 200 and data == {"status": "reloaded",
                                          "source": {"reinit_seed": 123}}
        assert served.app.prediction_cache.stats()["entries"] == 0
        assert served.request("POST", "/predict", _txn(served))[0] == 200

    def test_reload_from_checkpoint(self, served, tmp_path):
        models = _small_models(99)
        CheckpointManager(tmp_path).save(3, params=models)
        txn = _txn(served)
        status, data = served.request("POST", "/reload-models",
                                      {"checkpoint_dir": str(tmp_path)})
        assert status == 200 and data["source"]["step"] == 3
        status, got = served.request("POST", "/predict", txn)
        assert status == 200
        torch.testing.assert_close(served.app.scorer.models.trees.leaf,
                                   models.trees.leaf, rtol=0, atol=0)

    def test_reload_refuses_a_crossed_quant_mode(self, served, tmp_path):
        models = _small_models(7)
        import dataclasses

        int8 = dataclasses.replace(models, bert=quantize_bert_params(models.bert))
        CheckpointManager(tmp_path).save(1, params=int8)
        before = served.app.scorer.models
        status, data = served.request("POST", "/reload-models",
                                      {"checkpoint_dir": str(tmp_path)})
        assert status == 409 and "quantization-mode mismatch" in data["detail"]
        assert served.app.scorer.models is before
        status, data = served.request("POST", "/reload-models", {
            "checkpoint_dir": str(tmp_path), "allow_arch_mismatch": True})
        assert status == 200
        assert served.app.scorer.quant_snapshot()["modes"]["bert_text"] == "int8"
        assert served.request("POST", "/predict", _txn(served))[0] == 200

    def test_reload_quality_artifact_reblends_live(self, served, tmp_path):
        artifact = tmp_path / "q.json"
        artifact.write_text(json.dumps({"selected_blend": {"weights": {
            "xgboost_primary": 0.4, "lstm_sequential": 0.1}}}))
        status, data = served.request("POST", "/reload-models",
                                      {"quality_artifact": str(artifact)})
        assert status == 200
        assert data["source"]["quality_artifact"]["weights"] == {
            "xgboost_primary": 0.4, "lstm_sequential": 0.1}
        _, info = served.request("GET", "/model-info")
        enabled = {n for n, m in info["models"].items() if m["enabled"]}
        assert enabled == {"xgboost_primary", "lstm_sequential"}
        status, pred = served.request("POST", "/predict", _txn(served))
        assert status == 200 and set(pred["model_predictions"]) == enabled

    def test_reload_failure_paths_leave_the_blend(self, served, tmp_path):
        _, before = served.request("GET", "/model-info")
        bad = tmp_path / "bad.json"
        bad.write_text("{}")
        assert served.request("POST", "/reload-models",
                              {"quality_artifact": str(bad)})[0] == 422
        assert served.request("POST", "/reload-models",
                              {"quality_artifact": str(tmp_path / "none.json")})[0] == 404
        artifact = tmp_path / "q.json"
        artifact.write_text(json.dumps({"selected_blend": {"weights": {
            "xgboost_primary": 0.9, "isolation_forest": 0.1}},
            "protocol": {"text_model": {"hidden_size": 64}}}))
        assert served.request("POST", "/reload-models", {
            "quality_artifact": str(artifact),
            "checkpoint_dir": str(tmp_path / "missing")})[0] == 404
        unknown = tmp_path / "u.json"
        unknown.write_text(json.dumps({"selected_blend": {"weights": {"nope": 1.0}}}))
        assert served.request("POST", "/reload-models",
                              {"quality_artifact": str(unknown)})[0] == 422
        ck = tmp_path / "ck"
        CheckpointManager(ck).save(1, params=_small_models(3),
                                   metadata={"text_model": {"hidden_size": 128}})
        status, data = served.request("POST", "/reload-models", {
            "quality_artifact": str(artifact), "checkpoint_dir": str(ck)})
        assert status == 409 and "architecture mismatch" in data["detail"]
        assert served.request("POST", "/reload-models",
                              {"checkpoint_dir": str(tmp_path / "missing")})[0] == 404
        _, after = served.request("GET", "/model-info")
        assert after == before

    def test_canary_artifact_requires_enabled_branches(self, served, tmp_path):
        artifact = tmp_path / "q.json"
        artifact.write_text(json.dumps({"selected_blend": {"weights": {
            "xgboost_primary": 0.4, "bert_text": 0.15}}}))
        idx = MODEL_NAMES.index("bert_text")
        was = bool(served.app.scorer.model_valid[idx])
        served.app.scorer.model_valid[idx] = False
        try:
            assert served.request("POST", "/experiments", {
                "name": "canary-off", "from_quality_artifact": str(artifact)})[0] == 409
            served.app.scorer.model_valid[idx] = True
            status, data = served.request("POST", "/experiments", {
                "name": "canary-on", "from_quality_artifact": str(artifact),
                "traffic": 0.3})
            assert status == 200 and data["experiment"] == "canary-on"
        finally:
            served.app.scorer.model_valid[idx] = was
            served.app.ab.stop_experiment("canary-on")


def test_autotune_endpoint_when_enabled():
    config = Config()
    config.serving.autotune = True
    config.monitoring.prometheus_port = 0
    scorer = TorchFraudScorer(config, models=_small_models(4),
                              scorer_config=ScorerConfig(text_len=32), device="cpu")
    app = ServingApp(config, scorer=scorer, host="127.0.0.1", port=0, device="cpu")
    assert app.tuning.signals_fn() == (0.0, 0)
    assert app.tuning.settings.inflight_min == app.tuning.settings.inflight_max == 1
    gen = TransactionGenerator(num_users=16, num_merchants=8, seed=2)
    app.scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    s = _Served(app)
    try:
        assert s.request("POST", "/predict", gen.generate_batch(1)[0])[0] == 200
        status, data = s.request("GET", "/autotune")
        assert status == 200 and data["enabled"] is True and "controller" in data
        _, text = s.request("GET", "/metrics/prometheus")
        assert "autotune_close_decisions_total" in text
    finally:
        s.close()


def test_serve_refuses_to_start_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: serve would start")
    assert port_main(["serve"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the scorer's serving seams, the metrics mirror and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True])
def test_quant_snapshot_and_model_info_match_jax(quant):
    from realtime_fraud_detection_tpu.obs.metrics import (
        MetricsCollector as JaxMetricsCollector,
    )
    from realtime_fraud_detection_tpu.utils.config import QuantSettings as JaxQuantSettings
    from realtime_fraud_detection_tpu_torch.obs.metrics import MetricsCollector
    from realtime_fraud_detection_tpu_torch.utils.config import QuantSettings

    jax_models = _jax_models()
    jax_scorer = FraudScorer(JaxConfig(quant=JaxQuantSettings.full() if quant
                                       else JaxQuantSettings()),
                             models=jax_models, scorer_config=JaxScorerConfig(text_len=32))
    scorer = TorchFraudScorer(Config(quant=QuantSettings.full() if quant
                                     else QuantSettings()),
                              models=models_from_numpy(jax_models),
                              scorer_config=ScorerConfig(text_len=32), device="cpu")
    for s in (jax_scorer, scorer):
        s.record_quant_gate(True)
        s.record_quant_gate(False)
    assert scorer.quant_snapshot() == jax_scorer.quant_snapshot()
    info, jinfo = scorer.model_info(), jax_scorer.model_info()
    assert set(info) == set(jinfo) and set(info["mesh"]) == set(jinfo["mesh"])
    assert {k: v for k, v in info.items() if k != "mesh"} == \
        {k: v for k, v in jinfo.items() if k != "mesh"}
    m, jm = MetricsCollector(), JaxMetricsCollector()
    m.sync_quant(scorer.quant_snapshot())
    jm.sync_quant(jax_scorer.quant_snapshot())

    def quant_lines(text):
        return sorted(line for line in text.splitlines()
                      if re.match(r"(# TYPE )?quant_", line))

    assert quant_lines(m.render_prometheus()) == quant_lines(jm.render_prometheus())


def test_refresh_blend_from_config_matches_jax(tmp_path):
    artifact = tmp_path / "q.json"
    artifact.write_text(json.dumps({"selected_blend": {
        "weights": {"xgboost_primary": 0.7, "graph_neural": 0.3},
        "strategy": "voting"}}))
    jax_scorer = FraudScorer(models=_jax_models(), scorer_config=JaxScorerConfig(text_len=32))
    scorer = TorchFraudScorer(models=models_from_numpy(_jax_models()),
                              scorer_config=ScorerConfig(text_len=32), device="cpu")
    for s in (jax_scorer, scorer):
        s.config.apply_quality_artifact(str(artifact))
        s.refresh_blend_from_config()
    np.testing.assert_array_equal(scorer.model_valid, jax_scorer.model_valid)
    np.testing.assert_array_equal(scorer.ensemble_params.weights.numpy(),
                                  np.asarray(jax_scorer.ensemble_params.weights))
    assert scorer.ensemble_params.strategy == int(jax_scorer.ensemble_params.strategy)


def test_health_check_command(served, capsys):
    assert port_main(["health-check", "--url",
                      f"http://127.0.0.1:{served.app.port}"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["healthy"] is True and out["models_loaded"] >= 1
    assert port_main(["health-check", "--url", "http://127.0.0.1:1",
                      "--timeout", "2"]) == 1


def test_serve_builds_at_the_artifact_text_model(monkeypatch, tmp_path, capsys):
    """``serve --quality-artifact`` builds the scorer at the artifact's text
    model, text length and tokenizer and serves its blend; a restore the
    checkpoint's stamps refuse exits 2 before the service listens."""
    started = []
    monkeypatch.setattr(ServingApp, "run_forever", lambda self: started.append(self))
    artifact = Path(__file__).resolve().parents[1] / "QUALITY_r05.json"
    assert port_main(["serve", "--device", "cpu", "--port", "0",
                      "--quality-artifact", str(artifact)]) == 0
    app = started[0]
    proto = json.loads(artifact.read_text())["protocol"]
    assert app.scorer.bert_config.hidden_size == proto["text_model"]["hidden_size"]
    assert app.scorer.bert_config.num_heads == proto["text_model"]["num_heads"]
    assert (app.scorer.sc.text_len, app.scorer.sc.tokenizer) == (
        proto["text_len"], proto["tokenizer"])
    assert sorted(app.config.get_enabled_models()) == [
        "isolation_forest", "lstm_sequential", "xgboost_primary"]
    int8 = tmp_path / "int8"
    models = _small_models(0)
    import dataclasses

    CheckpointManager(int8).save(1, params=dataclasses.replace(
        models, bert=quantize_bert_params(models.bert)))
    assert port_main(["serve", "--device", "cpu", "--port", "0",
                      "--checkpoint-dir", str(int8)]) == 2
    assert "quantization-mode mismatch" in capsys.readouterr().err
    assert port_main(["serve", "--device", "cpu", "--port", "0",
                      "--checkpoint-dir", str(tmp_path / "none")]) == 2
    assert "no checkpoints under" in capsys.readouterr().err
    assert port_main(["serve", "--device", "cpu", "--port", "0", "--quant",
                      "--checkpoint-dir", str(int8)]) == 0
    assert started[-1].scorer.quant_snapshot()["modes"]["bert_text"] == "int8"
