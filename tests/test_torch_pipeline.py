"""The PyTorch port's slice as a whole against the JAX package, on the CPU:
packing, bucketing, the fused packed scorer with the kernel plane's
statics (int8 BERT, GEMM-form trees, fused dequant-matmul, fused epilogue,
flash attention; the JAX kernels through the Pallas interpreter), the
scorer's dispatch / finalize responses, and the port's isolation from JAX.

Tolerances: decision, risk and rules-only ladders exact (the seed is
checked to keep every probability and confidence farther than the bound
from a rung); on the bf16 served path (the frameworks round bf16 at
different places) probability and confidence within the JAX kernel drill's
measured bf16 noise bound for these models and tokens, each branch's
prediction and contribution within that branch's own bf16 gap on the JAX
side, both floored at 1e-4 (``torch_bounds.py``), the rule score exact;
<= 1e-5 at f32 compute.
"""

import torch_threads  # first: torch held to one CPU thread
import dataclasses
import re
import subprocess
import sys
import textwrap
from functools import partial
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_fraud_detection_tpu.core.batching import (
    bucket_for as jax_bucket_for,
    pad_to_bucket as jax_pad_to_bucket,
)
from realtime_fraud_detection_tpu.core.packing import pack_tree as jax_pack_tree
from realtime_fraud_detection_tpu.ensemble.combine import (
    EnsembleParams as JaxEnsembleParams,
)
from realtime_fraud_detection_tpu.features.schema import (
    TransactionBatch as JaxTransactionBatch,
)
from realtime_fraud_detection_tpu.models import bert as jbert
from realtime_fraud_detection_tpu.models import lstm as jlstm
from realtime_fraud_detection_tpu.models.isolation_forest import (
    IsolationForest as JaxIsolationForest,
)
from realtime_fraud_detection_tpu.models.quant import (
    quantize_bert_params as jax_quantize_bert_params,
)
from realtime_fraud_detection_tpu.models.trees import (
    TreeEnsemble as JaxTreeEnsemble,
)
from realtime_fraud_detection_tpu.scoring import pipeline as jax_pipeline
from realtime_fraud_detection_tpu.scoring.scorer import FraudScorer
from realtime_fraud_detection_tpu.utils.config import Config as JaxConfig
from realtime_fraud_detection_tpu_torch.bridge import models_from_numpy
from realtime_fraud_detection_tpu_torch.core.batching import (
    BATCH_BUCKETS,
    bucket_for,
    pad_to_bucket,
)
from realtime_fraud_detection_tpu_torch.core.packing import (
    pack_tree,
    tree_flatten,
    unpack_tree,
)
from realtime_fraud_detection_tpu_torch.ensemble.combine import EnsembleParams
from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
from realtime_fraud_detection_tpu_torch.scoring.pipeline import (
    MODEL_NAMES,
    ScoreBatch,
    make_example_batch,
    packed_width,
    score_fused_packed,
)
from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
from realtime_fraud_detection_tpu_torch.utils.config import (
    Config,
    KernelSettings,
    QuantSettings,
)

from torch_bounds import branch_bounds, near_rung, noise_bound

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "realtime_fraud_detection_tpu_torch"
N_ROWS = 8
JAX_STATICS = dict(bert_config=jbert.TINY_CONFIG, use_pallas=True,
                   tree_kernel="gemm", iforest_kernel="gemm",
                   dequant_kernel="pallas", epilogue_kernel="pallas",
                   kernel_interpret=True)
PORT_STATICS = dict(bert_config=TINY_CONFIG, **QuantSettings.full().static(),
                    **KernelSettings.full().static())


def _to_jax_batch(batch: ScoreBatch):
    """The port's host batch as the JAX package's ScoreBatch (same arrays)."""
    fields = {f.name: getattr(batch, f.name)
              for f in dataclasses.fields(batch) if f.name != "txn"}
    return jax_pipeline.ScoreBatch(
        txn=JaxTransactionBatch(**vars(batch.txn)), **fields)


@pytest.fixture(scope="module")
def batch():
    return make_example_batch(N_ROWS, rng=np.random.default_rng(2))


@pytest.fixture(scope="module")
def jax_models():
    """The JAX model set with random trees and forest, int8 BERT."""
    rng = np.random.default_rng(17)
    models = jax_pipeline.init_scoring_models(jax.random.PRNGKey(17),
                                              jbert.TINY_CONFIG)
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
    models = models.replace(trees=trees, iforest=forest,
                            bert=jax_quantize_bert_params(models.bert))
    return jax.tree_util.tree_map(np.asarray, models)


@pytest.fixture(scope="module")
def port_models(jax_models):
    return models_from_numpy(jax_models)


def _jax_params():
    return JaxEnsembleParams.from_config(JaxConfig(), jax_pipeline.MODEL_NAMES)


def _port_matrix(port_models, batch, compute_dtype=torch.bfloat16):
    blobs, spec = pack_tree(batch)
    return score_fused_packed(
        port_models, {k: torch.from_numpy(v) for k, v in blobs.items()}, spec,
        EnsembleParams.from_config(Config(), MODEL_NAMES),
        torch.ones(len(MODEL_NAMES), dtype=torch.bool),
        compute_dtype=compute_dtype, **PORT_STATICS).numpy()


def _jax_matrix(jax_models, batch, fn=jax_pipeline.score_fused_packed):
    blobs, spec = jax_pack_tree(_to_jax_batch(batch))
    return np.asarray(fn(
        jax_models, blobs["f32"], blobs["i32"], blobs["u8"], spec=spec,
        params=_jax_params(), model_valid=np.ones(len(MODEL_NAMES), bool),
        **JAX_STATICS))


# ------------------------------------------------------- packing / buckets
def test_pack_tree_is_byte_identical_to_jax(batch):
    blobs, spec = pack_tree(batch)
    jblobs, jspec = jax_pack_tree(_to_jax_batch(batch))
    assert jblobs["bf16"].shape == (N_ROWS, 0)
    for name in ("f32", "i32", "u8"):
        assert blobs[name].dtype == jblobs[name].dtype
        assert blobs[name].tobytes() == jblobs[name].tobytes()
    assert [e[1:] for e in spec.entries] == [e[1:] for e in jspec.entries]


def test_unpack_round_trip(batch):
    blobs, spec = pack_tree(batch)
    restored = unpack_tree({k: torch.from_numpy(v) for k, v in blobs.items()},
                           spec)
    before, after = tree_flatten(batch)[0], tree_flatten(restored)[0]
    assert len(before) == len(after) == len(spec.entries)
    for a, b in zip(before, after):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert restored.user_neigh2_feat is None


@pytest.mark.parametrize("n", [1, 5, 8, 31, 33, 200, 256, 300])
def test_bucketing_matches_jax(n):
    assert bucket_for(n) == jax_bucket_for(n) and BATCH_BUCKETS[-1] == 256
    small = make_example_batch(min(n, 40), rng=np.random.default_rng(n))
    rows = small.batch_size
    padded, mask, size = pad_to_bucket(small, rows)
    jpadded, jmask, jsize = jax_pad_to_bucket(_to_jax_batch(small), rows)
    assert size == jsize
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(padded.history, jpadded.history)
    np.testing.assert_array_equal(padded.txn.amount, jpadded.txn.amount)


# ------------------------------------------------------------- the slice
def test_slice_bf16_matches_jax(jax_models, port_models, batch):
    want = _jax_matrix(jax_models, batch)
    got = _port_matrix(port_models, batch)
    assert got.shape == want.shape == (N_ROWS, packed_width(5, epilogue=True))
    bound = noise_bound(jax_models.bert, [(batch.token_ids, batch.token_mask)],
                        _jax_params().weights, np.ones(5, bool))
    branch = branch_bounds(jax_models, batch)
    # the seed keeps every served probability and confidence away from a
    # rung, so the ladders must agree exactly; the rule score is computed
    # identically on both sides, so the rules-only ladder needs no margin
    for col in (0, 1):                    # probability, confidence
        assert not near_rung(want[:, col], bound).any()
    exact = [2, 3, 4, 5, 6, 7, 18, 19]    # decision, risk, rule, key factors,
    np.testing.assert_array_equal(got[:, exact], want[:, exact])  # rule ladder
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=0, atol=bound)
    for j, tol in enumerate(branch):      # predictions, then contributions
        for col in (8 + j, 13 + j):
            np.testing.assert_allclose(got[:, col], want[:, col], rtol=0,
                                       atol=tol, err_msg=f"column {col}")


def test_slice_f32_compute_matches_jax(jax_models, port_models, batch,
                                       monkeypatch):
    # the JAX pipeline computes its LSTM and BERT products in bf16; widen
    # them to f32 for this comparison
    monkeypatch.setattr(jax_pipeline, "bert_predict",
                        partial(jbert.bert_predict, compute_dtype=jnp.float32))
    monkeypatch.setattr(jax_pipeline, "lstm_logits",
                        partial(jlstm.lstm_logits, compute_dtype=jnp.float32))
    want = _jax_matrix(jax_models, batch,
                       fn=jax_pipeline._score_fused_packed_impl)
    got = _port_matrix(port_models, batch, compute_dtype=torch.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_slice_kernels_off_layout(port_models, batch):
    blobs, spec = pack_tree(batch)
    out = score_fused_packed(
        port_models, {k: torch.from_numpy(v) for k, v in blobs.items()}, spec,
        EnsembleParams.from_config(Config(), MODEL_NAMES),
        torch.ones(len(MODEL_NAMES), dtype=torch.bool),
        bert_config=TINY_CONFIG)
    assert out.shape == (N_ROWS, packed_width(5, epilogue=False))
    ext = _port_matrix(port_models, batch)
    # same decisions; probabilities differ only by the tree traversal's
    # summation order (gather vs GEMM form)
    np.testing.assert_array_equal(out.numpy()[:, 2:8], ext[:, 2:8])
    np.testing.assert_allclose(out.numpy()[:, :13], ext[:, :13], atol=1e-5)


# ----------------------------------------------------------------- scorer
def _jax_scorer_stub(model_valid):
    return SimpleNamespace(model_valid=model_valid, ensemble_params=_jax_params(),
                           config=JaxConfig(), _top_importances=None)


def _strip_time(responses):
    return [{k: v for k, v in r.items() if k != "processing_time_ms"}
            for r in responses]


@pytest.mark.parametrize("rules_only", [False, True])
def test_scorer_responses_match_jax(port_models, batch, rules_only):
    cfg = Config(quant=QuantSettings.full(), kernels=KernelSettings.full())
    scorer = TorchFraudScorer(cfg, models=port_models, bert_config=TINY_CONFIG,
                              device="cpu")
    n = 6                                   # pads to the 8-row bucket
    small = dataclasses.replace(
        batch, txn=type(batch.txn)(**{k: v[:n] for k, v in vars(batch.txn).items()}),
        **{f.name: getattr(batch, f.name)[:n] for f in dataclasses.fields(batch)
           if f.name != "txn" and getattr(batch, f.name) is not None})
    records = [{"transaction_id": f"t{i}"} for i in range(n)]
    mask = np.array([True, True, False, True, True])
    scorer.set_degradation(mask, rules_only=rules_only)
    pending = scorer.dispatch_assembled(small, records)
    assert pending.out.shape == (8, packed_width(5, epilogue=True))
    got = scorer.finalize(pending)
    want = FraudScorer._build_responses(
        _jax_scorer_stub(mask), records, pending.out.numpy(), n, 1.0,
        model_valid=mask, rules_only=rules_only)
    assert _strip_time(got) == _strip_time(want)
    # the unextended layout goes through the host ladder in both
    narrow = pending.out.numpy()[:, :13]
    assert _strip_time(scorer._build_responses(
        records, narrow, n, 1.0, model_valid=mask, rules_only=rules_only)) == \
        _strip_time(FraudScorer._build_responses(
            _jax_scorer_stub(mask), records, narrow, n, 1.0, model_valid=mask,
            rules_only=rules_only))


def test_scorer_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchFraudScorer()


# -------------------------------------------------------------- isolation
_FORBIDDEN_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|ml_dtypes|"
    r"realtime_fraud_detection_tpu)(?:\.|\s|$)", re.MULTILINE)


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*.py")] + [ROOT / "chip_smoke.py",
                                       ROOT / "megakernel_phases.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_nothing_of_jax(path):
    found = _FORBIDDEN_IMPORT.findall(path.read_text())
    assert not found, f"{path.name} imports {found}"


def test_port_runs_with_jax_blocked():
    script = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "flax", "ml_dtypes",
                     "realtime_fraud_detection_tpu"):
            sys.modules[name] = None          # any import of them now fails
        import numpy as np, torch, pkgutil, importlib
        import realtime_fraud_detection_tpu_torch as port
        for mod in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
            importlib.import_module(mod.name)
        import chip_smoke, megakernel_phases
        from realtime_fraud_detection_tpu_torch.scoring.pipeline import make_example_batch
        from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
        from realtime_fraud_detection_tpu_torch.utils.config import (
            Config, KernelSettings, QuantSettings)
        s = TorchFraudScorer(Config(quant=QuantSettings.full(),
                                    kernels=KernelSettings.full()),
                             device="cpu", seed=1)
        b = make_example_batch(3, rng=np.random.default_rng(0))
        out = s.finalize(s.dispatch_assembled(b, [{}] * 3))
        assert len(out) == 3 and all(0 <= r["fraud_probability"] <= 1 for r in out)
        # the typed graph on a ring stream, bf16 wire, overlapped assembly
        from realtime_fraud_detection_tpu_torch.scoring.pipeline import (
            ScorerConfig, init_scoring_models)
        from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
        from realtime_fraud_detection_tpu_torch.stream import topics as T
        from realtime_fraud_detection_tpu_torch.stream.job import JobConfig, StreamJob
        from realtime_fraud_detection_tpu_torch.stream.transport import InMemoryBroker
        gen = TransactionGenerator(num_users=30, num_merchants=10, seed=2)
        gen.inject_fraud_ring()
        t = TorchFraudScorer(
            Config(kernels=KernelSettings.mega()),
            models=init_scoring_models(1, n_trees=4, tree_depth=3, gnn_typed=True),
            scorer_config=ScorerConfig(graph_mode="typed", text_len=16,
                                       transfer_bf16=True), device="cpu")
        t.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
        broker = InMemoryBroker()
        job = StreamJob(broker, t, JobConfig(max_batch=16, overlap_assembly=True))
        broker.produce_batch(T.TRANSACTIONS, gen.generate_batch(32),
                             key_fn=lambda r: str(r["user_id"]))
        assert job.run_until_drained(now=1.0) == 32 and job.counters["errors"] == 0
        job.close()
        assert t.kernel_snapshot()["fallback"]["megakernel"] == 2
        assert t.graph_snapshot()["store"]["edges_added"] == 96
        # the wordpiece tokenizer under the QoS plane, with its metrics
        from realtime_fraud_detection_tpu_torch.models.wordpiece import WordPieceTokenizer
        from realtime_fraud_detection_tpu_torch.utils.config import QosSettings
        w = TorchFraudScorer(scorer_config=ScorerConfig(tokenizer="wordpiece",
                                                        text_len=16),
                             models=init_scoring_models(1, n_trees=4, tree_depth=3),
                             device="cpu")
        assert isinstance(w.tokenizer, WordPieceTokenizer)
        w.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
        broker = InMemoryBroker()
        job = StreamJob(broker, w, JobConfig(
            max_batch=16, qos=QosSettings(enabled=True, admission_rate=1e6)))
        broker.produce_batch(T.TRANSACTIONS, gen.generate_batch(16),
                             key_fn=lambda r: str(r["user_id"]))
        assert job.run_until_drained(now=2.0) == 16 and job.counters["shed"] == 0
        job.qos.metrics.sync_microbatch(job.assembler.close_reasons)
        assert "microbatch_close_reason_total" in job.qos.metrics.render_prometheus()
        # the tracing and tuning planes in the job, with their metrics
        from realtime_fraud_detection_tpu_torch.utils.config import (
            TracingSettings, TuningSettings)
        broker = InMemoryBroker()
        job = StreamJob(broker, w, JobConfig(
            max_batch=16, qos=QosSettings(enabled=True),
            tracing=TracingSettings(enabled=True),
            autotune=TuningSettings(enabled=True)))
        broker.produce_batch(T.TRANSACTIONS, gen.generate_batch(16),
                             key_fn=lambda r: str(r["user_id"]))
        assert job.run_until_drained(now=3.0) == 16
        assert job.tracer.counters["completed"] == 16
        assert job.tracer.breakdown()["n"] == 16
        job.qos.metrics.sync_tracing(job.tracer.snapshot())
        job.qos.metrics.sync_autotune(job.tuning.snapshot())
        text = job.qos.metrics.render_prometheus()
        assert "trace_completed_total" in text and "autotune_max_wait_ms" in text
        # the scoring service over HTTP, a checkpoint hot swap included
        import asyncio, http.client, json, tempfile
        from realtime_fraud_detection_tpu_torch.checkpoint import CheckpointManager
        from realtime_fraud_detection_tpu_torch.serving.app import ServingApp
        from realtime_fraud_detection_tpu_torch.utils.config import Config
        cfg = Config()
        cfg.monitoring.prometheus_port = 0
        cfg.tracing.enabled = True
        app = ServingApp(cfg, scorer=w, host="127.0.0.1", port=0, device="cpu")

        def call(method, path, body=None):
            conn = http.client.HTTPConnection("127.0.0.1", app.port, timeout=60)
            conn.request(method, path, body=json.dumps(body) if body else None)
            resp = conn.getresponse()
            out = (resp.status, json.loads(resp.read()))
            conn.close()
            return out

        async def serve():
            await app.start()
            try:
                with tempfile.TemporaryDirectory() as ck:
                    CheckpointManager(ck).save(
                        1, params=init_scoring_models(2, n_trees=4, tree_depth=3))
                    status, out = await asyncio.to_thread(
                        call, "POST", "/batch-predict",
                        {"transactions": gen.generate_batch(4)})
                    assert status == 200 and out["count"] == 4
                    status, out = await asyncio.to_thread(
                        call, "POST", "/reload-models", {"checkpoint_dir": ck})
                    assert status == 200 and out["source"]["step"] == 1
                    status, out = await asyncio.to_thread(
                        call, "POST", "/predict", gen.generate_batch(1)[0])
                    assert status == 200 and 0 <= out["fraud_score"] <= 1
            finally:
                await app.stop()

        asyncio.run(serve())
        assert app.tracer.counters["completed"] == 1      # /predict is traced
        # the feedback plane: the labeled buffer, the job's labels topic and
        # the app's /labels and /quality/live
        from realtime_fraud_detection_tpu_torch.feedback import FeedbackPlane
        from realtime_fraud_detection_tpu_torch.state.labeled import (
            LabeledExampleBuffer)
        from realtime_fraud_detection_tpu_torch.utils.config import FeedbackSettings
        buf = LabeledExampleBuffer(capacity=10)
        buf.append(np.zeros(4, np.float32), True, 0.9, ts=1.0)
        assert buf.arrays()["x"].shape == (1, 4)
        plane = FeedbackPlane(FeedbackSettings(enabled=True), scorer=w,
                              config=w.config)
        broker = InMemoryBroker()
        job = StreamJob(broker, w, JobConfig(max_batch=16, feedback=plane))
        recs = gen.generate_batch(16)
        broker.produce_batch(T.TRANSACTIONS, recs, key_fn=lambda r: str(r["user_id"]))
        broker.produce_batch(T.LABELS, gen.label_events(recs, delay_scale=1e-5),
                             key_fn=lambda e: str(e["transaction_id"]))
        assert job.run_until_drained(now=4.0) == 16 and plane.join.matched == 16
        cfg.feedback.enabled = True
        fapp = ServingApp(cfg, scorer=w, host="127.0.0.1", port=0, device="cpu")
        res = fapp._score_batch_sync(recs[:4])
        ok, out = asyncio.run(fapp._ingest_labels(
            [{"transaction_id": r["transaction_id"], "is_fraud": False} for r in res], {}))
        assert ok == 200 and out["matched"] == 4
        assert asyncio.run(fapp._quality_live(None, {}))[1]["buffer"]["size"] == 4
        # the training commands: train, then validate its checkpoint
        from realtime_fraud_detection_tpu_torch.__main__ import main
        with tempfile.TemporaryDirectory() as ck:
            sim = ["--users", "60", "--merchants", "20", "--device", "cpu"]
            assert main(["train", "--rows", "400", "--trees", "2", "--out", ck] + sim) == 0
            assert main(["validate", "--checkpoint-dir", ck, "--rows", "64",
                         "--min-auc", "0.0"] + sim) == 0
        # the deployed job: enrichment and analytics over the TCP broker fed
        # through the ingress gateway, a stop, a resume from the positions,
        # the joins, replay_state, the metadata store, the serving features
        from realtime_fraud_detection_tpu_torch.features.serving import (
            ServingFeatureProcessor)
        from realtime_fraud_detection_tpu_torch.state.metadata import MetadataStore
        from realtime_fraud_detection_tpu_torch.stream import (
            BrokerServer, IngressGateway, MultiStreamCorrelator, NetBrokerClient)
        from realtime_fraud_detection_tpu_torch.stream.joins import (
            txn_user_behavior_join)
        from realtime_fraud_detection_tpu_torch.utils.config import SimConfig
        server = BrokerServer(port=0).start()
        client = NetBrokerClient(port=server.port)
        gw = IngressGateway(client, T.TRANSACTIONS)
        for r in gen.generate_batch(48):
            assert gw.submit(r)
        gw.close()
        assert gw.native and gw.sent == 48
        job = StreamJob(client, w, JobConfig(max_batch=16, enable_analytics=True,
                                             enable_enrichment=True))
        done = job.complete_batch
        def stop_after_first(ctx, *a, **k):
            out = done(ctx, *a, **k)
            job.request_stop()
            return out
        job.complete_batch = stop_after_first
        assert job.run_until_drained(now=5.0) == 32
        resumed = StreamJob(client, w, JobConfig(max_batch=16, enable_analytics=True,
                                                 enable_enrichment=True))
        resumed.consumer.seek_to_positions(job.consumer.positions())
        assert resumed.run_until_drained(now=6.0) == 16
        enriched = [r.value for r in client.consumer([T.ENRICHED], "c").poll(1000)]
        assert len(enriched) == 48 and all("ensemble_score" in e for e in enriched)
        resumed.analytics.flush()
        assert sum(v["fired"] for v in resumed.analytics.stats().values()) > 0
        client.close()
        server.stop()
        j = txn_user_behavior_join()
        j.process_left(dict(enriched[0]), 10.0)
        j.process_right({"user_id": enriched[0]["user_id"], "short_session": True}, 11.0)
        assert len(j.flush()) == 1
        corr = MultiStreamCorrelator()
        corr.on_device({"user_id": "u", "is_new_device": True}, 1.0)
        assert corr.on_transaction({"user_id": "u", "amount": 9000.0}, 2.0)
        w.replay_state(gen.generate_batch(4), now=7.0)
        with tempfile.TemporaryDirectory() as d:
            meta = MetadataStore(d + "/m.db")
            meta.register_job("j", "fraud-detection-job")
            meta.set_job_status("j", "FINISHED")
            assert meta.get_job("j")["status"] == "FINISHED"
            meta.close()
        assert ServingFeatureProcessor().process_features({"amount": 5.0})["amount"] == 5.0
        assert SimConfig().tps == 100 and Config().models_base_path
        # the shared state tier and the Kafka wire tier: a scorer on the RESP
        # server, its job over the Kafka fake, a group member, the stores, the
        # native tree scorer
        from realtime_fraud_detection_tpu_torch.models.trees import tree_ensemble_logits
        from realtime_fraud_detection_tpu_torch.native import NativeTreeScorer
        from realtime_fraud_detection_tpu_torch.state import (
            AggregationStore, FeatureStore, MiniRedisServer, RespClient)
        from realtime_fraud_detection_tpu_torch.stream import KafkaTransport
        from realtime_fraud_detection_tpu_torch.stream.kafka_fake import FakeKafkaServer
        from realtime_fraud_detection_tpu_torch.stream.kafka_group import (
            KafkaGroupConsumer)
        redis, fake = MiniRedisServer().start(), FakeKafkaServer().start()
        rc = RespClient(port=redis.port)
        kb = KafkaTransport(f"127.0.0.1:{fake.port}", idempotent=True, compression="gzip")
        models = init_scoring_models(1, n_trees=4, tree_depth=3)
        shared = TorchFraudScorer(models=models, scorer_config=ScorerConfig(text_len=16),
                                  device="cpu", state_client=rc)
        shared.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
        job = StreamJob(kb, shared, JobConfig(max_batch=16))
        recs = gen.generate_batch(16)
        kb.produce_batch(T.TRANSACTIONS, recs, key_fn=lambda r: str(r["user_id"]))
        assert job.run_until_drained(now=8.0) == 16
        assert kb.lag(job.config.group_id, T.TRANSACTIONS) == 0
        assert len(rc.keys("transaction:*")) == 16 and rc.keys("velocity:*")
        member = KafkaGroupConsumer(kb, [T.TRANSACTIONS], "g", session_timeout_ms=1000,
                                    heartbeat_interval_s=0.1)
        assert len(member.poll(100)) == 16 and member.lag() == 16
        member.commit()
        assert member.lag() == 0
        member.close()
        kb.close(); rc.close(); fake.stop(); redis.stop()
        agg, fs = AggregationStore(), FeatureStore()
        for r in recs:
            agg.record(r, now=8.0)
            fs.store_feature_values(r["user_id"], "user", {"amount": r["amount"]}, now=8.0)
        assert fs.get_feature_statistics("amount")["count"] == 16
        x = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 64)).astype(np.float32))
        got = NativeTreeScorer(models.trees).logits(x.numpy())
        assert np.allclose(got, tree_ensemble_logits(models.trees, x).numpy(), atol=1e-5)
        # cross-partition graph fetch into a typed scorer's sampler
        from realtime_fraud_detection_tpu_torch.graph import (
            GraphFetchClient, GraphFetchServer, TypedEntityGraph)
        peer = TypedEntityGraph(fanout=8)
        peer.add_batch(["x1", "x2"], ["m", "m"], ["d", "d"], ["i", "j"])
        srv = GraphFetchServer(lambda: peer, worker_id="peer").start()
        client = GraphFetchClient({"peer": ("127.0.0.1", srv.port)})
        t.attach_graph_fetch(client)
        t.assemble(gen.generate_batch(8), now=9.0)
        assert t.graph_snapshot()["fetch"]["remote_fetch_total"] > 0
        client.close(); srv.stop()
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=torch_threads.spawn_env())
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
