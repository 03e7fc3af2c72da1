"""The port's feedback plane against the JAX package's, on the CPU.

Each test feeds the same NumPy-seeded inputs through the JAX function and
the port's:

- the prequential math (``sliding_auc``, ``weighted_auc``, ``FadingAUC``,
  the evaluator's calibration error, drop-one attribution and snapshot) on
  a tie-heavy event sequence: exactly equal;
- a ``LabelJoin`` event sequence (early labels, duplicates, replays,
  expiry, the pending cap): the matches and the stats equal;
- ``make_label_events`` and ``generate_batch`` with ``inject_drift``
  mid-stream and ``label_events`` interleaved: dict for dict;
- ``LabeledExampleBuffer``: ``arrays()`` equal, dtypes and order included;
- ``Retrainer.retrain`` on one buffer: trees and forest bit-equal, the
  selection AUCs, the strategy and the gate's verdict equal, the holdout
  candidate scores within ``BLEND_SCORE_TOL``; the permuted-label control
  rejected by both gates; with the LSTM (``train_neural``, the JAX initial
  weights bridged in as ``lstm_init``) its probabilities within
  ``LOOP_PROB_BOUND["lstm"]``;
- ``RetrainPolicy`` triggers, ``FeedbackSettings`` and its validation
  messages, ``sync_feedback``'s exposition;
- the stream job's seams, and ``promote_candidate`` on a scorer with a
  batch in flight;
- the serving app (CPU): ``POST /labels``, ``GET /quality/live``, the 409
  with the plane off, the 400 on a malformed body and the 422 on an event
  without its fields, and the ``prequential_*`` / ``feedback_*`` family
  names equal to the JAX app's.
"""

import torch_threads  # noqa: F401  (first: torch held to one CPU thread)
import asyncio
import dataclasses
import json
import math
import threading

import jax
import numpy as np
import pytest
import torch

from realtime_fraud_detection_tpu.feedback import labels as jlabels
from realtime_fraud_detection_tpu.feedback import policy as jpolicy
from realtime_fraud_detection_tpu.feedback import prequential as jpreq
from realtime_fraud_detection_tpu.models import lstm as jlstm
from realtime_fraud_detection_tpu.obs.metrics import MetricsCollector as JaxMetrics
from realtime_fraud_detection_tpu.serving import ServingApp as JaxServingApp
from realtime_fraud_detection_tpu.sim.simulator import (
    TransactionGenerator as JaxTransactionGenerator,
)
from realtime_fraud_detection_tpu.state.labeled import (
    LabeledExampleBuffer as JaxLabeledExampleBuffer,
)
from realtime_fraud_detection_tpu.utils.config import Config as JaxConfig
from realtime_fraud_detection_tpu.utils.config import (
    FeedbackSettings as JaxFeedbackSettings,
)
from realtime_fraud_detection_tpu_torch.bridge import params_from_numpy
from realtime_fraud_detection_tpu_torch.feedback import labels, plane, policy
from realtime_fraud_detection_tpu_torch.feedback import prequential as preq
from realtime_fraud_detection_tpu_torch.obs.metrics import MetricsCollector
from realtime_fraud_detection_tpu_torch.scoring.pipeline import (
    ScorerConfig,
    init_scoring_models,
)
from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
from realtime_fraud_detection_tpu_torch.serving.app import ServingApp
from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
from realtime_fraud_detection_tpu_torch.state.labeled import LabeledExampleBuffer
from realtime_fraud_detection_tpu_torch.stream import topics as T
from realtime_fraud_detection_tpu_torch.stream.job import JobConfig, StreamJob
from realtime_fraud_detection_tpu_torch.stream.transport import InMemoryBroker
from realtime_fraud_detection_tpu_torch.utils.config import Config, FeedbackSettings
from test_torch_serving import _Served
from torch_bounds import BLEND_SCORE_TOL, LOOP_PROB_BOUND


def _events(n=1500, seed=0):
    """Labels at 25 %, scores informative, noisy and quantized to two
    decimals (heavy ties), plus two branch columns (one with NaN gaps)."""
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.25).astype(float)
    s = np.round(np.clip(0.55 * y + 0.3 * rng.random(n), 0, 1), 2)
    good = np.round(0.7 * y + 0.2 * rng.random(n), 2)
    noise = rng.random(n)
    noise[rng.random(n) < 0.1] = np.nan
    return y, s, good, noise


# ---------------------------------------------------------------------------
# prequential math: exactly equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["sliding", "sliding_constant", "weighted",
                                  "weighted_single_class", "fading"])
def test_auc_functions_equal_jax(case):
    y, s, _, _ = _events()
    w = 0.997 ** np.arange(len(y) - 1, -1, -1, dtype=float)
    if case == "sliding":
        got, want = preq.sliding_auc(y, s), jpreq.sliding_auc(y, s)
    elif case == "sliding_constant":
        # ties are not credited in argsort order: a constant scorer is 0.5
        c = np.full(6, 0.7)
        yc = np.array([0, 1, 0, 1, 1, 0], float)
        got, want = preq.sliding_auc(yc, c), jpreq.sliding_auc(yc, c)
        assert got == 0.5
    elif case == "weighted":
        got, want = preq.weighted_auc(y, s, w), jpreq.weighted_auc(y, s, w)
    elif case == "weighted_single_class":
        got = preq.weighted_auc(np.ones(5), np.arange(5.0), np.ones(5))
        want = jpreq.weighted_auc(np.ones(5), np.arange(5.0), np.ones(5))
        assert math.isnan(got) and math.isnan(want)
        return
    else:
        f, jf = preq.FadingAUC(gamma=0.98), jpreq.FadingAUC(gamma=0.98)
        for yi, si in zip(y, s):
            f.update(si, bool(yi))
            jf.update(si, bool(yi))
        assert len(f) == len(jf)
        assert f.precision_recall() == jf.precision_recall()
        got, want = f.auc(), jf.auc()
    assert got == want


def test_evaluator_snapshot_equals_jax():
    """Calibration error, drop-one attribution (with NaN branch gaps) and
    the whole snapshot, number for number."""
    y, s, good, noise = _events(n=900, seed=1)
    ev = preq.PrequentialEvaluator(window=400, threshold=0.5, fading_gamma=0.99,
                                   calibration_bins=7)
    jev = jpreq.PrequentialEvaluator(window=400, threshold=0.5, fading_gamma=0.99,
                                     calibration_bins=7)
    for i in range(len(y)):
        bp = {"good": good[i], "noise": noise[i]}
        ev.update(s[i], bool(y[i]), branch_preds=bp, label_lag_s=0.1 * i)
        jev.update(s[i], bool(y[i]), branch_preds=bp, label_lag_s=0.1 * i)
    weights = {"good": 0.8, "noise": 0.2, "off": 0.0}
    assert ev.calibration_error() == jev.calibration_error()
    attr = ev.drop_one_attribution(weights)
    assert attr == jev.drop_one_attribution(weights) and attr["good"] > 0.1
    assert json.dumps(ev.snapshot(weights)) == json.dumps(jev.snapshot(weights))


# ---------------------------------------------------------------------------
# the label join and the label events
# ---------------------------------------------------------------------------

def _join_script(rng):
    """A seeded sequence of predictions and labels: early labels, duplicate
    labels, replayed predictions, labels that never match, and a silent
    stretch that trips the pending cap."""
    ops = []
    for i in range(400):
        tid = f"t{i}"
        ts = float(i)
        if rng.random() < 0.15:      # the label beats its prediction
            ops.append(("label", {"transaction_id": tid, "is_fraud": bool(rng.random() < 0.1),
                                  "fraud_type": None, "label_ts": ts + 0.5}))
            ops.append(("pred", tid, ts, {"score": float(rng.random())}))
        else:
            ops.append(("pred", tid, ts, {"score": float(rng.random())}))
            if rng.random() < 0.8:
                ops.append(("label", {"transaction_id": tid,
                                      "is_fraud": bool(rng.random() < 0.1),
                                      "label_ts": ts + float(rng.integers(1, 30))}))
        if rng.random() < 0.05:      # replays of both topics
            ops.append(("pred", tid, ts, {"score": 0.0}))
            ops.append(("label", {"transaction_id": tid, "is_fraud": True,
                                  "label_ts": ts + 40.0}))
        if rng.random() < 0.03:      # an orphan label
            ops.append(("label", {"transaction_id": f"orphan{i}", "is_fraud": False,
                                  "label_ts": ts}))
    for i in range(400, 460):        # a silent label stream: the pending cap
        ops.append(("pred", f"t{i}", float(i), {"score": 0.5}))
    return ops


def test_label_join_matches_and_stats_equal_jax():
    ops = _join_script(np.random.default_rng(3))
    got, want = [], []
    for join, out in ((labels.LabelJoin(horizon_s=50.0, pred_ooo_s=1.0,
                                        label_ooo_s=2.0, max_pending=40), got),
                      (jlabels.LabelJoin(horizon_s=50.0, pred_ooo_s=1.0,
                                         label_ooo_s=2.0, max_pending=40), want)):
        for op in ops:
            if op[0] == "pred":
                out.append(join.process_prediction(op[1], op[2], op[3]))
            else:
                out.append(join.process_label(op[1]))
            out.append(join.stats())
        out.append(join.watermark)
    assert got == want
    stats = got[-2]
    assert stats["matched"] > 200 and stats["duplicate_labels"] > 0
    assert stats["expired_unlabeled"] > 0 and stats["orphan_labels"] > 0


def test_drift_and_label_events_equal_jax():
    """``generate_batch`` with ``inject_drift`` mid-stream and
    ``label_events`` between batches (their lognormal draws come from the
    generator's own rng, so they move every later record), and
    ``make_label_events`` on an explicit generator: dict for dict."""
    out = []
    for cls in (TransactionGenerator, JaxTransactionGenerator):
        gen = cls(num_users=300, num_merchants=120, seed=9, tps=50.0)
        recs = gen.generate_batch(120)
        evs = gen.label_events(recs[:60], event_ts=[float(i) for i in range(60)],
                               delay_scale=1e-5)
        gen.inject_drift(0.3)
        recs += gen.generate_batch(200)
        evs += gen.label_events(recs[120:], delay_scale=1e-4)
        gen.clear_drift()
        recs += gen.generate_batch(60)
        out.append((recs, evs))
    (recs, evs), (jrecs, jevs) = out
    assert recs == jrecs and evs == jevs
    drifted = [r for r in recs if r["fraud_type"] == "drifted_pattern"]
    assert 30 < len(drifted) and all(r["payment_method"] == "digital_wallet"
                                     for r in drifted)
    assert not any(r["fraud_type"] == "drifted_pattern" for r in recs[-60:])
    rng, jrng = np.random.default_rng(4), np.random.default_rng(4)
    assert labels.make_label_events(recs[:50], rng) == \
        jlabels.make_label_events(recs[:50], jrng)


# ---------------------------------------------------------------------------
# the buffer and the retrainer
# ---------------------------------------------------------------------------

def _fill(buffer_cls, n=900, seed=4, history=False):
    rng = np.random.default_rng(seed)
    buf = buffer_cls(capacity=700, store_history=history)
    for i in range(n):
        y = bool(rng.random() < 0.12)
        x = rng.standard_normal(64).astype(np.float32) + 0.9 * y
        hist = (rng.standard_normal((5, 64)).astype(np.float32) + 0.6 * y
                if history else None)
        # timestamps out of order, as labels arrive in label time
        buf.append(x, y, float(0.05 * y + 0.4 * rng.random()),
                   ts=float(i) + float(rng.integers(0, 40)),
                   branch_preds={"xgboost_primary": float(rng.random())},
                   history=hist, history_len=5 if history else None)
    return buf


@pytest.mark.parametrize("history", [False, True], ids=["plain", "history"])
def test_labeled_buffer_arrays_equal_jax(history):
    buf, jbuf = _fill(LabeledExampleBuffer, history=history), \
        _fill(JaxLabeledExampleBuffer, history=history)
    assert buf.stats() == jbuf.stats() and buf.stats()["evicted"] > 0
    got, want = buf.arrays(), jbuf.arrays()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    assert buf.branch_preds() == jbuf.branch_preds()
    empty = LabeledExampleBuffer(store_history=history).arrays()
    jempty = JaxLabeledExampleBuffer(store_history=history).arrays()
    assert {k: (v.shape, v.dtype) for k, v in empty.items()} == \
        {k: (v.shape, v.dtype) for k, v in jempty.items()}


WEIGHTS = {"xgboost_primary": 0.7, "isolation_forest": 0.3}


@pytest.fixture(scope="module")
def buffer_arrays():
    return _fill(JaxLabeledExampleBuffer).arrays()


@pytest.fixture(scope="module")
def retrained(buffer_arrays):
    kw = dict(n_trees=12, depth=4, iforest_trees=20, select_frac=0.15,
              holdout_frac=0.2)
    out = {}
    for noise in (None, 7):
        want = jpolicy.Retrainer(**kw).retrain(buffer_arrays, weights=WEIGHTS,
                                               label_noise_seed=noise)
        got = policy.Retrainer(device="cpu", **kw).retrain(
            buffer_arrays, weights=WEIGHTS, label_noise_seed=noise)
        out[noise] = (got, want)
    return out


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("noise", [None, 7], ids=["genuine", "permuted_labels"])
def test_retrainer_candidate_equals_jax(retrained, noise):
    got, want = retrained[noise]
    for name, fields in (("trees", ("feature", "threshold", "leaf", "base_score")),
                         ("iforest", ("feature", "threshold", "path_length", "c_psi"))):
        for f in fields:
            np.testing.assert_array_equal(_np(getattr(got[name], f)),
                                          np.asarray(getattr(want[name], f)),
                                          err_msg=f"{name}.{f}")
    for key in ("weights", "strategy", "select_auc", "trained_on", "label_noise"):
        assert got[key] == want[key], key
    for key in ("y", "as_served"):
        np.testing.assert_array_equal(got["holdout"][key], want["holdout"][key])
    np.testing.assert_allclose(got["holdout"]["candidate"],
                               np.asarray(want["holdout"]["candidate"]),
                               rtol=0, atol=BLEND_SCORE_TOL)
    gate_kw = dict(min_positives=12)
    verdict = policy.PromotionGate(**gate_kw).evaluate(got)
    assert verdict == jpolicy.PromotionGate(**gate_kw).evaluate(want)
    if noise is not None:
        # the negative control: a candidate trained on permuted labels
        assert verdict["passed"] is False and verdict["reason"] == "auc_regression"
    else:
        assert verdict["passed"] is True


def test_retrainer_trains_the_lstm_from_jax_initial_weights():
    """``train_neural`` on a buffer with history: the port's LSTM, started
    from the JAX trainer's own initial weights (``lstm_init``), gives
    probabilities within the training plane's LSTM bound of JAX's."""
    arrays = _fill(JaxLabeledExampleBuffer, n=800, seed=6, history=True).arrays()
    kw = dict(n_trees=8, depth=3, iforest_trees=16, train_neural=True,
              neural_hidden=16, neural_epochs=1)
    w = {"xgboost_primary": 0.5, "isolation_forest": 0.2, "lstm_sequential": 0.3}
    want = jpolicy.Retrainer(**kw).retrain(arrays, weights=w)
    init = jlstm.init_lstm_params(jax.random.PRNGKey(11), 64, 16)
    got = policy.Retrainer(device="cpu", lstm_init=params_from_numpy(
        jax.tree_util.tree_map(np.asarray, init)), **kw).retrain(arrays, weights=w)
    assert got["lstm"] is not None and got["weights"] == want["weights"]
    sl = slice(0, 256)
    p = policy._branch_scores(got, arrays, sl, torch.device("cpu"))["lstm_sequential"]
    jp = jpolicy._branch_scores(want, arrays, sl)["lstm_sequential"]
    assert np.isfinite(p).all()
    assert float(np.max(np.abs(p - jp))) <= LOOP_PROB_BOUND["lstm"]
    assert float(np.max(np.abs(got["holdout"]["candidate"]
                               - want["holdout"]["candidate"]))) <= LOOP_PROB_BOUND["lstm"]


def test_retrainer_refuses_a_small_buffer_like_jax():
    arrays = _fill(JaxLabeledExampleBuffer, n=60).arrays()
    with pytest.raises(ValueError) as got:
        policy.Retrainer(device="cpu").retrain(arrays)
    with pytest.raises(ValueError) as want:
        jpolicy.Retrainer().retrain(arrays)
    assert str(got.value) == str(want.value)


def test_retrain_policy_triggers_equal_jax():
    report = type("R", (), {"drifted": True, "max_psi": 0.4,
                            "top_features": list(range(8))})()
    snaps = [{"labeled_total": 100, "sliding": {"auc": 0.6}, "fading": {"auc": 0.9}},
             {"labeled_total": 400, "sliding": {"auc": 0.6}, "fading": {"auc": 0.9}},
             {"labeled_total": 500, "sliding": {"auc": 0.6}, "fading": {"auc": 0.9}},
             {"labeled_total": 900, "sliding": {"auc": 0.7}, "fading": {"auc": 0.72}},
             {"labeled_total": 900, "sliding": {"auc": float("nan")},
              "fading": {"auc": 0.72}}]
    for kw in ({}, {"auc_floor": 0.8}, {"use_drift": False}):
        p, jp = policy.RetrainPolicy(**kw), jpolicy.RetrainPolicy(**kw)
        for t, snap in enumerate(snaps):
            for rep in (None, report):
                now = 400.0 * t
                assert p.observe(snap, rep, now) == jp.observe(snap, rep, now)
        assert p.last_trigger_ts == jp.last_trigger_ts


# ---------------------------------------------------------------------------
# config and metrics
# ---------------------------------------------------------------------------

def test_feedback_settings_equal_jax():
    got, want = FeedbackSettings(), JaxFeedbackSettings()
    names = [f.name for f in dataclasses.fields(want)]
    assert [f.name for f in dataclasses.fields(got)] == names
    for name in names:
        assert getattr(got, name) == getattr(want, name), name
    assert Config().feedback == FeedbackSettings()
    assert dataclasses.asdict(JaxConfig().feedback) == dataclasses.asdict(Config().feedback)


@pytest.mark.parametrize("bad", [
    {"fading_gamma": 1.0}, {"sliding_window": 5}, {"buffer_size": 9},
    {"gate_holdout_frac": 0.5, "gate_select_frac": 0.45},
    {"gate_select_frac": 0.0}, {"label_horizon_s": 0.0},
    {"label_delay_scale": -1.0},
], ids=lambda d: ",".join(d))
def test_feedback_settings_validation_messages_equal_jax(bad):
    with pytest.raises(ValueError) as got:
        FeedbackSettings(**bad).validate()
    with pytest.raises(ValueError) as want:
        JaxFeedbackSettings(**bad).validate()
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="feedback"):
        Config.from_dict({"feedback": bad})


def _feedback_lines(text):
    """The exposition's lines of the prequential_* / feedback_* families."""
    def name(ln):
        return ln.split()[2] if ln.startswith("#") else ln.split("{")[0].split()[0]
    return [ln for ln in text.splitlines()
            if ln and name(ln).startswith(("prequential_", "feedback_"))]


def test_sync_feedback_exposition_equals_jax():
    """The same plane snapshots, mirrored twice (the second as counter
    deltas): the feedback families render line for line as JAX's."""
    y, s, good, _ = _events(n=300, seed=2)
    snaps = []
    for p in (plane.FeedbackPlane(FeedbackSettings(enabled=True, sliding_window=100)),):
        for i in range(len(y)):
            p.join.process_prediction(f"t{i}", float(i), {"score": s[i]})
            for m in p.join.process_label({"transaction_id": f"t{i}",
                                           "is_fraud": bool(y[i]),
                                           "label_ts": i + 3.0}):
                p._ingest_match({**m, "features": np.zeros(64, np.float32)})
            if i in (150, 299):
                p.counters["triggers"] += 1
                p.counters["gate_fail" if i == 150 else "gate_pass"] += 1
                snaps.append(p.snapshot())
    got, want = MetricsCollector(), JaxMetrics()
    for snap in snaps:
        got.sync_feedback(snap)
        want.sync_feedback(snap)
    lines = _feedback_lines(got.render_prometheus())
    assert lines == _feedback_lines(want.render_prometheus())
    assert 'feedback_gate_verdicts_total{verdict="pass"} 1' in lines


# ---------------------------------------------------------------------------
# the stream job and the promotion
# ---------------------------------------------------------------------------

def test_job_config_refuses_a_feedback_settings_object():
    with pytest.raises(TypeError, match="JobConfig.feedback"):
        JobConfig(feedback=FeedbackSettings(enabled=True))


def _small_scorer(config=None, seed=1):
    return TorchFraudScorer(config or Config(),
                            models=init_scoring_models(seed, n_trees=8, tree_depth=4),
                            scorer_config=ScorerConfig(text_len=16), device="cpu")


@pytest.mark.parametrize("overlap", [False, True], ids=["serial", "overlap"])
def test_job_feeds_the_plane_and_drains_labels(overlap):
    """The job registers each scored batch with the join (the emitted
    results and the batch's host feature rows), drains the labels topic
    under its own consumer group and commits it; a pending trigger's
    retrain runs between batches (under the assembler stage's lock with
    overlapped assembly) and goes through the gate."""
    gen = TransactionGenerator(num_users=60, num_merchants=30, seed=5)
    scorer = _small_scorer()
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    feedback = plane.FeedbackPlane(
        FeedbackSettings(enabled=True, min_labels=10 ** 9), scorer=scorer,
        config=scorer.config)
    broker = InMemoryBroker()
    job = StreamJob(broker, scorer, JobConfig(max_batch=32, feedback=feedback,
                                              overlap_assembly=overlap))
    recs = gen.generate_batch(128)
    broker.produce_batch(T.TRANSACTIONS, recs, key_fn=lambda r: str(r["user_id"]))
    broker.produce_batch(T.LABELS, gen.label_events(recs[:96], delay_scale=1e-5),
                         key_fn=lambda e: str(e["transaction_id"]))
    assert job.run_until_drained() == 128
    assert feedback.join.matched == 96 and len(feedback.join) == 32
    assert broker.lag("fraud-detection-job-labels", T.LABELS) == 0
    # the buffer holds exactly the feature rows the job emitted
    topic = broker.consumer([T.FEATURES], "check").poll(10_000)
    emitted = {r.value["transaction_id"]: r.value["features"] for r in topic}
    x = feedback.buffer.arrays()["x"]
    want = np.asarray([emitted[r["transaction_id"]] for r in recs[:96]], np.float32)
    assert x.dtype == np.float32 and x.shape == (96, 64)
    assert sorted(map(tuple, x)) == sorted(map(tuple, want))
    # a parked trigger: the job's run loop retrains between batches and
    # the candidate (here a hand-made one) goes through the gate
    trees_before = _np(scorer.models.trees.threshold).copy()
    feedback.pending_trigger = {"type": "retrain_trigger", "reason": "test"}
    feedback.retrainer = policy.Retrainer(n_trees=4, depth=3, iforest_trees=8,
                                          select_frac=0.2, holdout_frac=0.2,
                                          device="cpu")
    broker.produce_batch(T.TRANSACTIONS, gen.generate_batch(64),
                         key_fn=lambda r: str(r["user_id"]))
    job.run_until_drained()
    job.close()
    assert feedback.pending_trigger is None
    verdicts = [e for e in feedback.events if e["type"] == "gate_verdict"]
    assert len(verdicts) == 1
    promoted = feedback.counters["promotions"] == 1
    assert promoted == verdicts[0]["passed"]
    assert promoted != np.array_equal(_np(scorer.models.trees.threshold), trees_before)


def test_promotion_lands_between_batches_in_flight():
    """``promote_candidate`` while a batch is dispatched: the pending batch
    keeps the models it was launched with and finalizes with them; the next
    batch runs the promoted set under its strategy."""
    config = Config()
    for name, mc in config.models.items():
        mc.enabled = name in ("xgboost_primary", "isolation_forest")
    scorer = _small_scorer(config)
    gen = TransactionGenerator(num_users=60, num_merchants=30, seed=6)
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    recs = gen.generate_batch(16)
    pending = scorer.dispatch(recs, now=0.0)
    old_models = pending.launched_with[0]
    cand = init_scoring_models(9, n_trees=8, tree_depth=4)
    lock = threading.Lock()
    out = plane.promote_candidate(
        scorer, config, {"trees": cand.trees, "iforest": cand.iforest,
                         "weights": {"xgboost_primary": 0.6, "isolation_forest": 0.4},
                         "strategy": "stacking"}, lock=lock)
    assert out == {"branches": ["isolation_forest", "xgboost_primary"],
                   "strategy": "stacking"}
    assert pending.launched_with[0] is old_models and scorer.models is not old_models
    assert scorer.ensemble_params.strategy == 2 and not lock.locked()
    first = scorer.finalize(pending, now=0.0)
    assert pending.launched_with is None and len(first) == 16
    # the batch in flight scored with the incumbent, exactly
    incumbent = Config()
    for name, mc in incumbent.models.items():
        mc.enabled = name in ("xgboost_primary", "isolation_forest")
    ref = _small_scorer(incumbent)
    ref.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    def answers(results):
        return [{k: v for k, v in r.items() if k != "processing_time_ms"}
                for r in results]

    assert answers(ref.score_batch(recs, now=0.0)) == answers(first)
    # the next batch runs the promoted models under stacking
    assert scorer.model_info()["strategy"] == "stacking"
    assert [r["fraud_score"] for r in scorer.score_batch(recs, now=0.0)] != \
        [r["fraud_score"] for r in first]


# ---------------------------------------------------------------------------
# the serving app (CPU)
# ---------------------------------------------------------------------------

def _app_config(cls, enabled=True):
    cfg = cls()
    cfg.feedback.enabled = enabled
    cfg.feedback.min_labels = 10 ** 9       # the endpoints only, never a retrain
    cfg.monitoring.prometheus_port = 0
    cfg.serving.microbatch_deadline_ms = 1.0
    return cfg


@pytest.fixture(scope="module")
def apps():
    cfg = _app_config(Config)
    scorer = TorchFraudScorer(cfg, models=init_scoring_models(2, n_trees=8, tree_depth=4),
                              scorer_config=ScorerConfig(text_len=32), device="cpu")
    served = _Served(ServingApp(cfg, scorer=scorer, host="127.0.0.1", port=0,
                                device="cpu"))
    yield served, JaxServingApp(config=_app_config(JaxConfig))
    served.close()


def test_serving_labels_and_quality_live_like_jax(apps):
    served, japp = apps
    out = {}
    for side, gen_cls in (("port", TransactionGenerator), ("jax", JaxTransactionGenerator)):
        gen = gen_cls(num_users=50, num_merchants=20, seed=2)
        txns = gen.generate_batch(8)
        if side == "port":
            status, body = served.request("POST", "/batch-predict", {"transactions": txns})
            assert status == 200
            results = body["results"]
        else:
            results = japp._score_batch_sync(txns)
        events = [{"transaction_id": r["transaction_id"], "is_fraud": bool(t["is_fraud"])}
                  for t, r in zip(txns, results)]
        events.append({"transaction_id": "never-scored", "is_fraud": False})
        if side == "port":
            _, ingest = served.request("POST", "/labels", events)
            _, quality = served.request("GET", "/quality/live")
            _, prom = served.request("GET", "/metrics/prometheus")
        else:
            _, ingest = asyncio.run(japp._ingest_labels(events, {}))
            _, quality = asyncio.run(japp._quality_live(None, {}))
            _, prom = asyncio.run(japp._metrics_prometheus(None, {}))
        out[side] = (ingest, quality, prom)
    (ingest, quality, prom), (jingest, jquality, jprom) = out["port"], out["jax"]
    assert ingest == jingest and ingest["matched"] == 8 and ingest["ingested"] == 9
    assert sorted(quality) == sorted(jquality)
    for key in ("label_join", "buffer", "policy", "enabled"):
        assert quality[key] == jquality[key], key
    for key in ("labeled_total", "fraud_total", "window_size", "operating_threshold"):
        assert quality["prequential"][key] == jquality["prequential"][key], key
    assert sorted(quality["prequential"]["sliding"]) == \
        sorted(jquality["prequential"]["sliding"])

    def families(text):
        return sorted({ln.split()[2] for ln in text.splitlines()
                       if ln.startswith("# TYPE ")
                       and ln.split()[2].startswith(("prequential_", "feedback_"))})

    assert families(prom) == families(jprom) and len(families(prom)) == 10
    assert 'feedback_labels_total{outcome="matched"} 8' in prom


def test_serving_labels_refusals(apps):
    served, japp = apps
    status, body = served.request("POST", "/labels", raw="{not json")
    assert status == 400
    status, body = served.request("POST", "/labels", [{"is_fraud": True}])
    assert status == 422 and "transaction_id" in body["detail"]
    from realtime_fraud_detection_tpu.serving.httpd import HttpError as JaxHttpError

    with pytest.raises(JaxHttpError) as jerr:
        asyncio.run(japp._ingest_labels([{"is_fraud": True}], {}))
    assert jerr.value.status == 422 and jerr.value.detail == body["detail"]
    off = ServingApp(_app_config(Config, enabled=False), scorer=_small_scorer(),
                     host="127.0.0.1", port=0, device="cpu")
    from realtime_fraud_detection_tpu_torch.serving.httpd import HttpError

    with pytest.raises(HttpError) as err:
        asyncio.run(off._ingest_labels([{"transaction_id": "t", "is_fraud": True}], {}))
    assert err.value.status == 409
    status, snap = 200, asyncio.run(off._quality_live(None, {}))[1]
    assert snap["enabled"] is False and snap["label_join"]["matched"] == 0
