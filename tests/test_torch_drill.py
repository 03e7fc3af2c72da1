"""The port's kernel drill against the JAX package's, on the CPU.

``_noise_floor`` on the same models (through the bridge) and the same
numpy-seeded tokens: the BERT blend weight equal to 1e-7, the bound exactly
``max(delta x w_bert, 1e-4)`` given the port's delta, and the port's bf16
BERT delta within 2x of the JAX one (the two frameworks round bf16 at
different places). The drill itself on the CPU through its command, where
both sides run the kernels' plain versions: every check passes, the
``rules_only`` rung bit-exact, the replay digest equal to a second run's.
The ladder's rung table equals the JAX one field by field, and the drill
and ladder modules import with JAX blocked.
"""

import torch_threads  # first: torch held to one CPU thread
import contextlib
import dataclasses
import io
import json
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from realtime_fraud_detection_tpu.ensemble.combine import (
    EnsembleParams as JaxEnsembleParams,
)
from realtime_fraud_detection_tpu.models import bert as jbert
from realtime_fraud_detection_tpu.models.quant import (
    quantize_bert_params as jax_quantize_bert_params,
)
from realtime_fraud_detection_tpu.qos import ladder as jladder
from realtime_fraud_detection_tpu.scoring import kernel_drill as jkd
from realtime_fraud_detection_tpu.scoring import pipeline as jax_pipeline
from realtime_fraud_detection_tpu.utils.config import Config as JaxConfig
from realtime_fraud_detection_tpu_torch.__main__ import main as port_main
from realtime_fraud_detection_tpu_torch.bridge import models_from_numpy
from realtime_fraud_detection_tpu_torch.ensemble.combine import EnsembleParams
from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
from realtime_fraud_detection_tpu_torch.ops import epilogue as ops_epilogue
from realtime_fraud_detection_tpu_torch.qos import ladder
from realtime_fraud_detection_tpu_torch.scoring import kernel_drill as kd
from realtime_fraud_detection_tpu_torch.scoring.pipeline import MODEL_NAMES
from realtime_fraud_detection_tpu_torch.utils.config import Config

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_models():
    """The JAX TINY model set with int8 BERT (the drill's served plane)."""
    models = jax_pipeline.init_scoring_models(jax.random.PRNGKey(5),
                                              jbert.TINY_CONFIG)
    models = models.replace(bert=jax_quantize_bert_params(
        jax.device_get(models.bert)))
    return jax.tree_util.tree_map(np.asarray, models)


@pytest.fixture(scope="module")
def tokens():
    rng = np.random.default_rng(41)
    out = []
    for _ in range(2):
        ids = rng.integers(0, TINY_CONFIG.vocab_size, (16, 64)).astype(np.int32)
        mask = np.arange(64)[None, :] < rng.integers(1, 65, 16)[:, None]
        out.append((ids, mask))
    return out


# ------------------------------------------------------------ noise floor
@pytest.mark.parametrize("valid", [
    (True,) * 5,
    (True, True, True, False, True),     # GNN dropped: BERT's share grows
    (True, True, False, True, True),     # BERT dropped: the floor alone
], ids=["full", "no_graph", "no_bert"])
def test_noise_floor_matches_jax(jax_models, tokens, valid):
    weights = np.asarray(JaxEnsembleParams.from_config(
        JaxConfig(), jax_pipeline.MODEL_NAMES).weights)
    stub = SimpleNamespace(bert_config=jbert.TINY_CONFIG, models=jax_models,
                           ensemble_params=SimpleNamespace(weights=weights),
                           effective_model_valid=lambda: np.asarray(valid))
    want = jkd._noise_floor(jkd.KernelDrillConfig(), stub, tokens)
    port_weights = EnsembleParams.from_config(Config(), MODEL_NAMES).weights
    got = kd._noise_floor(models_from_numpy(jax_models), TINY_CONFIG, tokens,
                          port_weights, valid)

    assert abs(got["bert_blend_weight"] - want["bert_blend_weight"]) <= 1e-7
    w = port_weights.double().numpy() * np.asarray(valid)
    w_bert = w[2] / max(w.sum(), 1e-9)
    assert got["bound"] == max(got["bert_branch_bf16_delta"] * w_bert, 1e-4)
    delta, jdelta = got["bert_branch_bf16_delta"], want["bert_branch_bf16_delta"]
    assert 0 < jdelta and jdelta / 2 <= delta <= 2 * jdelta
    if not valid[2]:
        assert got["bound"] == want["bound"] == 1e-4


def test_noise_floor_reads_the_blend_under_the_rung():
    models = SimpleNamespace(trees=SimpleNamespace(threshold=torch.zeros(1)),
                             bert=None)
    got = kd._noise_floor(models, TINY_CONFIG, [], torch.ones(5) / 5,
                          (True,) * 5, noise_floor_abs=3e-4)
    assert got == {"bert_branch_bf16_delta": 0.0, "bert_blend_weight": 0.2,
                   "bound": 3e-4}


# ----------------------------------------------------------------- ladder
def test_ladder_levels_match_jax():
    assert len(ladder.LADDER_LEVELS) == len(jladder.LADDER_LEVELS) == 4
    for got, want in zip(ladder.LADDER_LEVELS, jladder.LADDER_LEVELS):
        assert (got.name, got.dropped_branches, got.rules_only) == (
            want.name, want.dropped_branches, want.rules_only)
    assert set().union(*(lv.dropped_branches for lv in ladder.LADDER_LEVELS)) \
        == set(MODEL_NAMES)


def test_drill_config_matches_jax():
    want = jkd.KernelDrillConfig()
    got = kd.KernelDrillConfig()
    for name in (f.name for f in dataclasses.fields(want)):
        assert getattr(got, name) == getattr(want, name), name
    assert kd.KernelDrillConfig.fast().rung_levels == \
        jkd.KernelDrillConfig.fast().rung_levels == (0, 3)
    assert got.device == "cuda"


# ------------------------------------------------------- the drill on CPU
@pytest.fixture(scope="module", params=[False, True], ids=["chain", "mega"])
def drill_run(request):
    argv = ["kernel-drill", "--fast", "--device", "cpu"]
    if request.param:
        argv.append("--mega")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_main(argv)
    lines = out.getvalue().strip().splitlines()
    return request.param, rc, json.loads(lines[-2]), json.loads(lines[-1])


def test_kernel_drill_passes_on_cpu(drill_run):
    mega, rc, summary, verdict = drill_run
    assert rc == 0 and verdict["passed"] is True and summary["passed"] is True
    assert all(verdict["checks"].values())
    expected = {"divergence_below_noise", "zero_decision_flips",
                "masked_rungs_equal", "rules_only_exact", "dequant_matmul_parity",
                "dequant_rows_parity", "epilogue_parity", "attention_parity",
                "zero_fallbacks", "replay_bit_identical"}
    expected |= ({"mega_reference_parity", "gemm_tree_leaves_exact",
                  "mega_dispatched", "per_site_subsumed",
                  "launches_collapsed_to_one"} if mega else {"all_sites_dispatched"})
    assert set(verdict["checks"]) == expected
    # both sides run the plain versions on the CPU: no divergence at all
    assert verdict["max_divergence"] == 0.0 and verdict["decision_flips"] == 0
    assert verdict["noise_bound"] == summary["divergence"]["noise_floor"]["bound"] >= 1e-4


def test_kernel_drill_rules_only_is_bit_exact(drill_run):
    _, _, summary, _ = drill_run
    assert set(summary["rungs"]) == {"full_ensemble", "rules_only"}
    rules = summary["rungs"]["rules_only"]
    assert rules["exact"] and rules["max_divergence"] == 0.0
    assert rules["decision_flips"] == rules["risk_flips"] == 0


def test_kernel_drill_replay_digest_is_stable(drill_run):
    _, _, summary, verdict = drill_run
    assert summary["replay"]["bit_identical"]
    assert summary["replay"]["digest"] == summary["digest"]
    assert verdict["digest"] == summary["digest"][:16]


def test_kernel_oracle_holds_the_main_path_epilogue_call(monkeypatch):
    """The oracle's epilogue check runs the packed entry as the main path
    calls it (the rung's flags, one validity byte a row) for each strategy,
    so a fault there (here: the row validity dropped) fails the check."""
    cfg = dataclasses.replace(kd.KernelDrillConfig.fast(), device="cpu")
    _, scorer = kd._make_side(cfg, kernels_on=True)
    good = kd._kernel_oracle(cfg, scorer)["epilogue"]
    assert good["ok"] and good["packed_ladders_exact"]
    assert good["packed_max_delta"] == 0.0
    real, calls = ops_epilogue.epilogue_packed, []

    def faulty(preds, rule, params, model_valid=None, row_valid=None, **kw):
        if model_valid is not None:
            calls.append((tuple(model_valid), params.strategy, row_valid is not None))
        return real(preds, rule, params, model_valid=model_valid, **kw)

    monkeypatch.setattr(ops_epilogue, "epilogue_packed", faulty)
    bad = kd._kernel_oracle(cfg, scorer)["epilogue"]
    assert calls == [((True,) * 5, s, True) for s in range(3)]
    assert not bad["ok"] and bad["packed_max_delta"] > 0.0


def test_kernel_drill_refuses_to_start_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    assert port_main(["kernel-drill", "--fast"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_drill_and_ladder_import_with_jax_blocked():
    script = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "flax", "ml_dtypes",
                     "realtime_fraud_detection_tpu"):
            sys.modules[name] = None          # any import of them now fails
        from realtime_fraud_detection_tpu_torch.qos.ladder import LADDER_LEVELS
        from realtime_fraud_detection_tpu_torch.scoring import kernel_drill as kd
        from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
        s = TorchFraudScorer(device="cpu", seed=1)
        s.set_degradation(None, rules_only=False, level=0)
        assert len(LADDER_LEVELS) == 4 and kd.KernelDrillConfig.fast().batch == 32
        # the QoS plane, its drill, the metrics and the config layer
        from realtime_fraud_detection_tpu_torch.obs.metrics import MetricsCollector
        from realtime_fraud_detection_tpu_torch.qos import (
            AdmissionController, DegradationLadder, LatencyBudget, QosPlane,
            run_overload_drill)
        from realtime_fraud_detection_tpu_torch.utils.config import Config, QosSettings
        from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
        plane = QosPlane(QosSettings(enabled=True, admission_rate=10.0),
                         metrics=MetricsCollector())
        assert plane.admit({"amount": 900}, 0.0).admitted
        assert plane.apply_degradation(s) == 0
        assert "qos_admitted_total" in plane.metrics.render_prometheus()
        assert AdmissionController(0).decide("low", 0.0).admitted
        assert DegradationLadder().level == 0 and LatencyBudget().budget_ms == 20.0
        summary = run_overload_drill(overload_s=0.1, recovery_s=0.1)
        assert summary["scored"] > 0 and summary["p99_within_budget"]
        cfg = Config()
        cfg.apply_quality_artifact("QUALITY_r05.json")
        assert sorted(cfg.get_enabled_models()) == [
            "isolation_forest", "lstm_sequential", "xgboost_primary"]
        # the tracing and tuning planes, their drills and the arrivals
        import dataclasses
        from realtime_fraud_detection_tpu_torch.obs.trace_drill import (
            TraceDrillConfig, run_trace_drill)
        from realtime_fraud_detection_tpu_torch.obs.tracing import SloTracker, Tracer
        from realtime_fraud_detection_tpu_torch.sim.arrivals import DiurnalBurstProcess
        from realtime_fraud_detection_tpu_torch.tuning import (
            ArrivalForecaster, ConfigTuner, JitBatchController, TuningPlane)
        from realtime_fraud_detection_tpu_torch.tuning.drill import (
            AutotuneDrillConfig, run_autotune_drill)
        assert len(DiurnalBurstProcess(seed=1).generate(0.5)) > 0
        assert Tracer().enabled and SloTracker().burn_rate(60.0) == 0.0
        assert ArrivalForecaster().rate(0.0) == 0.0 and JitBatchController().buckets
        assert TuningPlane().recommended_inflight_depth() >= 1 and ConfigTuner
        trace = run_trace_drill(dataclasses.replace(
            TraceDrillConfig.fast(), bursts_per_phase=4, overhead_txns=256))
        assert trace["checks"]["slow_device_attributed"]
        auto = run_autotune_drill(AutotuneDrillConfig(duration_s=0.5,
                                                      static_grid=(2.5,)))
        assert auto["controller"]["scored"] > 0 and auto["reproducible"]
        # the serving tier's host-side modules
        import asyncio, numpy as np
        from realtime_fraud_detection_tpu_torch.obs.drift import FeatureDriftMonitor
        from realtime_fraud_detection_tpu_torch.obs.fleetmetrics import FleetMetrics
        from realtime_fraud_detection_tpu_torch.obs.logs import JsonFormatter
        from realtime_fraud_detection_tpu_torch.serving.batcher import RequestMicrobatcher
        from realtime_fraud_detection_tpu_torch.serving.cache import PredictionCache
        from realtime_fraud_detection_tpu_torch.testing import ABTestManager, Variant
        cache = PredictionCache(ttl_seconds=1.0)
        cache.put("t", {"a": 1}, now=0.0)
        assert cache.get("t", now=0.5) == {"a": 1} and cache.get("t", now=2.0) is None
        mon = FeatureDriftMonitor()
        mon.update(np.zeros((8, 64), np.float32))
        assert mon.report().rows_seen == 8
        ab = ABTestManager()
        ab.create_experiment("e", [Variant("a", 0.5), Variant("b", 0.5)])
        assert ab.assign("e", "u1").name in ("a", "b")
        fleet = FleetMetrics()
        fleet.ingest_cumulative("w0", {"scored": 3})
        assert "rtfd_fleet_scored_total 3" in fleet.render()
        assert JsonFormatter("svc").service_name == "svc"

        async def batch():
            b = RequestMicrobatcher(lambda txns: [dict(t) for t in txns],
                                    max_batch=4, deadline_ms=1.0)
            await b.start()
            got = await asyncio.gather(*[b.submit({"i": i}) for i in range(6)])
            await b.stop()
            return got

        assert [g["i"] for g in asyncio.run(batch())] == list(range(6))
        # the training plane: trainers, calibration, the protocol's blend
        from realtime_fraud_detection_tpu_torch.ensemble.combine import blend_branch_scores
        from realtime_fraud_detection_tpu_torch.features.extract import (
            top_feature_importances)
        from realtime_fraud_detection_tpu_torch.models.isolation_forest import (
            IsolationForestTrainer)
        from realtime_fraud_detection_tpu_torch.models.lstm import init_lstm_params
        from realtime_fraud_detection_tpu_torch.training import GBDTTrainer
        from realtime_fraud_detection_tpu_torch.training.blend_eval import (
            BlendEvalConfig, _auc)
        from realtime_fraud_detection_tpu_torch.training.calibrate import (
            calibrate_lstm_head, platt_fit)
        from realtime_fraud_detection_tpu_torch.training.neural import (
            NeuralTrainer, weighted_bce_loss)
        from realtime_fraud_detection_tpu_torch.training.text import build_text_dataset
        from realtime_fraud_detection_tpu_torch.models.lstm import lstm_logits
        rng = np.random.default_rng(0)
        x = rng.standard_normal((200, 64)).astype(np.float32)
        y = (x[:, 0] > 1.0).astype(np.float32)
        gbdt = GBDTTrainer(n_estimators=2, max_depth=3)
        trees = gbdt.fit(x, y)
        assert trees.leaf.shape == (2, 8)
        assert len(top_feature_importances(gbdt.feature_importances_)) > 0
        assert IsolationForestTrainer(n_estimators=2, max_samples=32).fit(x).c_psi > 0
        a, b = platt_fit(x[:, 0] * 3.0, y)
        lstm = init_lstm_params(rng, 64, 8)
        seqs = rng.standard_normal((64, 4, 64)).astype(np.float32)
        lens = np.full(64, 4, np.int32)
        trained = NeuralTrainer(epochs=1, batch_size=32, device="cpu").train(
            lstm, lambda p, i, t: weighted_bce_loss(lstm_logits(p, *i), t, 3.0),
            (seqs, lens), (rng.random(64) < 0.2).astype(np.float32))
        assert calibrate_lstm_head(trained, a, b)["w_head2"].shape == trained["w_head2"].shape
        assert 0.0 <= _auc(y, x[:, 0]) <= 1.0 and BlendEvalConfig().n_trees == 40
        assert blend_branch_scores({"xgboost_primary": y}, {"xgboost_primary": 1.0}).shape == (200,)
        ids, mask, labels = build_text_dataset(TransactionGenerator(
            num_users=20, num_merchants=5, seed=1), 8, max_length=8)
        assert ids.shape == (8, 8) and labels.shape == (8,)
        # the feedback drill and the quantization drill, at toy sizes
        from realtime_fraud_detection_tpu_torch.feedback.drill import (
            FeedbackDrillConfig, compact_drill_summary, run_feedback_drill)
        from realtime_fraud_detection_tpu_torch.scoring.quant_drill import (
            QuantDrillConfig, compact_quant_summary, run_quant_drill)
        fb = run_feedback_drill(FeedbackDrillConfig(
            num_users=80, num_merchants=40, batch=64, n_train=256, n_healthy=128,
            n_drift=128, n_recovery=64, n_trees=3, sliding_window=64,
            min_labels=32, device="cpu"))
        assert compact_drill_summary(fb)["labels_matched"] > 0
        qz = run_quant_drill(QuantDrillConfig(
            num_users=60, num_merchants=20, batch=32, n_train=128, n_batches=1,
            eval_batches=2, n_trees=3, replay=False, device="cpu"))
        assert compact_quant_summary(qz)["checks"]["bert_is_quantized"]
        # the graph drill and the distributed obs drill, with the fetch plane
        from realtime_fraud_detection_tpu_torch.graph.drill import (
            GraphDrillConfig, compact_graph_summary)
        from realtime_fraud_detection_tpu_torch.graph.fetch import (
            GraphFetchClient, GraphFetchServer, StaleGraphGenerationError)
        from realtime_fraud_detection_tpu_torch.obs.obs_drill import (
            ObsDrillConfig, _carrier_plan, build_obs_schedule)
        from realtime_fraud_detection_tpu_torch.obs.fleetmetrics import (
            merge_chrome_traces)
        assert GraphDrillConfig.fast().n_workers == 2
        assert compact_graph_summary({"passed": True})["passed"] is True
        ocfg = ObsDrillConfig.fast()
        ocfg.validate()
        plan = _carrier_plan(ocfg, build_obs_schedule(ocfg))
        assert list(plan.values()).count("stripped") == 156
        assert merge_chrome_traces([])["metadata"]["n_traces"] == 0
        assert issubclass(StaleGraphGenerationError, RuntimeError)
        assert GraphFetchClient({}).fetch("device->user", ["d"]) == ([], False)
        # the mesh plane: the executor, its drill's verdict, the parallel layer
        import torch
        from realtime_fraud_detection_tpu_torch.__main__ import DRILL_COMMANDS
        from realtime_fraud_detection_tpu_torch.core.mesh import MeshConfig, build_mesh
        from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
        from realtime_fraud_detection_tpu_torch.parallel import (
            MoEConfig, init_moe_params, init_train_state, make_train_step, moe_ffn,
            moe_ffn_reference, pipeline_forward, ring_attention, stack_stage_params)
        from realtime_fraud_detection_tpu_torch.parallel.train import tiny_train_setup
        from realtime_fraud_detection_tpu_torch.scoring.mesh_drill import (
            MeshDrillConfig, compact_mesh_summary)
        from realtime_fraud_detection_tpu_torch.scoring.mesh_executor import MeshExecutor
        assert "mesh-drill" in DRILL_COMMANDS and MeshDrillConfig.fast().batch == 256
        assert compact_mesh_summary({"passed": True})["passed"] is True
        gen = TransactionGenerator(num_users=30, num_merchants=10, seed=2)
        ms = TorchFraudScorer(device="cpu", seed=1)
        ms.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
        ex = MeshExecutor(ms, devices=["cpu"] * 4, model_axis=2)
        assert len(ms.score_batch(gen.generate_batch(3))) == 3
        assert ex.stats()["completed"] == 1 and ms.model_info()["mesh"]["data"] == 2
        mesh = build_mesh(MeshConfig(seq=2), ["cpu"] * 4)
        q = torch.randn(2, 2, 8, 8)
        assert ring_attention(mesh, q, q, q).shape == q.shape
        mesh2 = build_mesh(MeshConfig(model=2), ["cpu"] * 4)
        moe = MoEConfig(4, 8, 16, 8.0)
        mp, xm = init_moe_params(0, moe), torch.randn(8, 8)
        assert torch.allclose(moe_ffn(mesh2, mp, xm, moe), moe_ffn_reference(mp, xm),
                              atol=1e-5)
        stages = stack_stage_params([{"w": torch.eye(4)}, {"w": 2 * torch.eye(4)}])
        out = pipeline_forward(mesh2, lambda p, h: h @ p["w"], stages, torch.ones(2, 3, 4))
        assert torch.equal(out, 2 * torch.ones(2, 3, 4))
        tp, tb = tiny_train_setup(4)
        st = init_train_state(mesh2, tp, lambda ps: torch.optim.SGD(ps, lr=0.1))
        st, met = make_train_step(bert_config=TINY_CONFIG)(st, tb)
        assert st.step == 1 and np.isfinite(met["loss"])
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=torch_threads.spawn_env())
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
