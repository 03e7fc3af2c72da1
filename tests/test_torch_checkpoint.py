"""The port's checkpoint manager against the JAX package's, on the CPU.

The JAX model set (f32 BERT, int8 BERT, the typed GNN) is bridged to the
port and saved by the port's ``CheckpointManager``; the manifest's stamps
(``model_shapes``, ``quant_mode``, ``graph_mode``) must equal the JAX
manager's ``_derive_*`` on the JAX models, and the restored tensors the
saved ones exactly. A restore that crosses the scorer's quantization mode,
graph mode or widths is refused with the JAX manager's own ``ValueError``
text (the JAX manager reads the port's manifest: the step layout and the
manifest are shared; the parameters are not, orbax against ``torch.save``).
Then retention, torn saves, partial restores, ``weights_only`` loading and
the scorer's host state: a scorer restored from a snapshot scores the next
batch exactly as the scorer it was taken from.
"""

import torch_threads  # noqa: F401  (first: torch held to one CPU thread)
import dataclasses
import pickle
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from realtime_fraud_detection_tpu import checkpoint as jax_checkpoint
from realtime_fraud_detection_tpu.models.quant import (
    quantize_bert_params as jax_quantize_bert_params,
)
from realtime_fraud_detection_tpu.scoring import pipeline as jax_pipeline
from realtime_fraud_detection_tpu.utils.config import QuantSettings as JaxQuantSettings
from realtime_fraud_detection_tpu_torch.bridge import models_from_numpy
from realtime_fraud_detection_tpu_torch.checkpoint import (
    CheckpointManager,
    restore_scorer_host_state,
    snapshot_scorer_host_state,
)
from realtime_fraud_detection_tpu_torch.checkpoint import _models_state
from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG, BertConfig
from realtime_fraud_detection_tpu_torch.scoring.pipeline import (
    ScorerConfig,
    init_scoring_models,
)
from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
from realtime_fraud_detection_tpu_torch.utils.config import Config, QuantSettings


def _jax_models(form):
    models = jax_pipeline.init_scoring_models(
        jax.random.PRNGKey(3), n_trees=6, tree_depth=3, gnn_typed=form == "typed")
    models = jax.tree_util.tree_map(np.asarray, models)
    if form == "int8":
        models = models.replace(bert=jax_quantize_bert_params(models.bert))
    return models


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("form", ["f32", "int8", "typed"])
def test_round_trip_and_stamps_match_jax(tmp_path, form):
    jm = _jax_models(form)
    models = models_from_numpy(jm)
    mgr = CheckpointManager(tmp_path)
    mgr.save(7, params=models, offsets={"payment-transactions": {"0": 42}},
             metadata={"run": "x"})
    manifest = mgr.manifest()
    assert manifest["model_shapes"] == jax_checkpoint._derive_model_shapes(jm)
    assert manifest["quant_mode"] == jax_checkpoint._derive_quant_mode(jm)
    assert manifest["graph_mode"] == jax_checkpoint._derive_graph_mode(jm)
    ck = mgr.restore()
    assert (ck.step, ck.offsets, ck.metadata, ck.host_state) == (
        7, {"payment-transactions": {"0": 42}}, {"run": "x"}, None)
    want, got = _flat(_models_state(models)), _flat(_models_state(ck.params))
    assert set(want) == set(got)
    for key in want:
        assert want[key].dtype == got[key].dtype, key
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)


def _stub_jax_scorer(quant="f32", graph="bipartite", hidden=128):
    """What the JAX manager's restore checks read of a scorer."""
    q = JaxQuantSettings.full() if quant == "int8" else JaxQuantSettings()
    return SimpleNamespace(
        quant=q, sc=SimpleNamespace(graph_mode=graph, feature_dim=64, node_dim=16),
        bert_config=SimpleNamespace(hidden_size=hidden, num_layers=2))


@pytest.mark.parametrize("case", ["quant", "graph", "shape"])
def test_refusals_match_jax(tmp_path, case):
    form = {"quant": "int8", "graph": "typed", "shape": "f32"}[case]
    CheckpointManager(tmp_path).save(1, params=models_from_numpy(_jax_models(form)))
    hidden = 64 if case == "shape" else 128
    bert = BertConfig(hidden_size=hidden, num_layers=2, num_heads=2,
                      intermediate_size=256)
    scorer = TorchFraudScorer(models=init_scoring_models(0, bert, n_trees=4, tree_depth=3),
                              bert_config=bert, device="cpu")
    with pytest.raises(ValueError) as got:
        CheckpointManager(tmp_path).restore_into_scorer(scorer)
    with pytest.raises(ValueError) as want:
        jax_checkpoint.CheckpointManager(tmp_path).restore_into_scorer(
            _stub_jax_scorer(hidden=hidden))
    assert str(got.value) == str(want.value)
    assert {"quant": "quantization-mode", "graph": "graph-mode",
            "shape": "bert_hidden"}[case] in str(got.value)


def test_allow_arch_mismatch_serves_the_checkpoint_form(tmp_path):
    CheckpointManager(tmp_path).save(1, params=models_from_numpy(_jax_models("int8")))
    scorer = TorchFraudScorer(models=init_scoring_models(0, n_trees=4, tree_depth=3),
                              device="cpu")
    assert scorer.quant_snapshot()["modes"]["bert_text"] == "f32"
    ck = CheckpointManager(tmp_path).restore_into_scorer(scorer, allow_arch_mismatch=True)
    assert ck.step == 1
    assert scorer.quant_snapshot()["modes"]["bert_text"] == "int8"
    # the other way: an f32 checkpoint into an int8 scorer is quantized
    CheckpointManager(tmp_path / "f32").save(1, params=models_from_numpy(_jax_models("f32")))
    q = TorchFraudScorer(Config(quant=QuantSettings.full()),
                         models=init_scoring_models(0, n_trees=4, tree_depth=3),
                         device="cpu")
    with pytest.raises(ValueError, match="quantization-mode"):
        CheckpointManager(tmp_path / "f32").restore_into_scorer(q)
    CheckpointManager(tmp_path / "f32").restore_into_scorer(q, allow_arch_mismatch=True)
    assert q.quant_snapshot()["modes"]["bert_text"] == "int8"


def test_retention_latest_step_and_torn_saves(tmp_path):
    missing = tmp_path / "never"
    mgr = CheckpointManager(missing)
    assert mgr.latest_step() is None and not missing.exists()
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    mgr = CheckpointManager(tmp_path / "ck", keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, host_state={"step": step})
    assert mgr.steps() == [3, 4]
    (tmp_path / "ck" / "step_0000000009").mkdir()        # a torn save
    assert mgr.latest_step() == 4
    assert mgr.restore().host_state == {"step": 4}
    assert mgr.restore(step=3).params is None
    # the same layout the JAX manager reads
    assert jax_checkpoint.CheckpointManager(tmp_path / "ck").steps() == [3, 4]


def test_params_load_with_weights_only(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, params=init_scoring_models(0, n_trees=4, tree_depth=3))
    with open(tmp_path / "step_0000000001" / "params.pt", "wb") as f:
        pickle.dump({"trees": SimpleNamespace(x=1)}, f, protocol=2)   # not tensors
    with pytest.raises(pickle.UnpicklingError):
        mgr.restore()


def test_host_state_round_trip_scores_like_the_source(tmp_path):
    gen = TransactionGenerator(num_users=12, num_merchants=6, seed=4)
    models = init_scoring_models(2, n_trees=6, tree_depth=3)
    sc = ScorerConfig(text_len=16)

    def scorer():
        s = TorchFraudScorer(models=models, scorer_config=sc, device="cpu")
        s.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
        return s

    source = scorer()
    for step in range(3):
        source.score_batch(gen.generate_batch(16), now=1000.0 + step)
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, params=models, host_state=snapshot_scorer_host_state(source))
    restored = TorchFraudScorer(models=init_scoring_models(9, n_trees=6, tree_depth=3),
                                scorer_config=sc, device="cpu")
    mgr.restore_into_scorer(restored)
    assert restored.stats["scored"] == source.stats["scored"] == 48
    nxt = gen.generate_batch(16)
    a = source.score_batch(nxt, now=1010.0)
    b = restored.score_batch(nxt, now=1010.0)
    strip = [{k: v for k, v in r.items() if k != "processing_time_ms"} for r in a]
    assert strip == [{k: v for k, v in r.items() if k != "processing_time_ms"} for r in b]


def test_typed_graph_host_state_swaps_the_sampler(tmp_path):
    gen = TransactionGenerator(num_users=20, num_merchants=8, seed=6)
    gen.inject_fraud_ring()
    models = init_scoring_models(1, n_trees=4, tree_depth=3, gnn_typed=True)
    sc = ScorerConfig(graph_mode="typed", text_len=16)
    source = TorchFraudScorer(models=models, scorer_config=sc, device="cpu")
    source.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    source.score_batch(gen.generate_batch(24), now=50.0)
    state = snapshot_scorer_host_state(source)
    target = TorchFraudScorer(models=models, scorer_config=sc, device="cpu")
    restore_scorer_host_state(target, pickle.loads(pickle.dumps(state)))
    assert target._sampler.graph is target.typed_graph
    assert target.typed_graph.stats() == source.typed_graph.stats()
    nxt = gen.generate_batch(8)
    a = source.score_batch(nxt, now=60.0)
    b = target.score_batch(nxt, now=60.0)
    assert [r["fraud_score"] for r in a] == [r["fraud_score"] for r in b]
    CheckpointManager(tmp_path).save(1, params=models)
    with pytest.raises(ValueError, match="graph-mode"):
        CheckpointManager(tmp_path).restore_into_scorer(
            TorchFraudScorer(models=init_scoring_models(1, n_trees=4, tree_depth=3),
                             device="cpu"))


def test_host_quantized_bert_saves_as_int8(tmp_path):
    """A model set whose BERT was quantized on the host (numpy leaves) saves
    as tensors and stamps int8."""
    models = init_scoring_models(0, TINY_CONFIG, n_trees=4, tree_depth=3)
    from realtime_fraud_detection_tpu_torch.models.quant import quantize_bert_params

    int8 = dataclasses.replace(models, bert=quantize_bert_params(models.bert))
    CheckpointManager(tmp_path).save(1, params=int8)
    ck = CheckpointManager(tmp_path).restore()
    assert CheckpointManager(tmp_path).manifest()["quant_mode"] == {"bert_weights": "int8"}
    assert ck.params.bert["word_emb"]["qe"].dtype == torch.int8
