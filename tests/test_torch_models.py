"""The PyTorch port's model branches, features, rules, combine,
quantization and parameter bridge against the JAX package on the CPU.

Inputs come from numpy seeds and the JAX package's own initialisers; the
port receives the JAX parameters through ``bridge.models_from_numpy``.
Tolerances: tree and isolation-forest leaves exact, probabilities <= 1e-4;
LSTM, GNN and BERT <= 1e-5 at f32 compute; on the bf16 served path the
LSTM and BERT outputs within that branch's own bf16-against-f32 gap on the
JAX side on the same inputs, floored at 1e-4 (the frameworks round bf16 at
different places; ``torch_bounds.py``); features
<= 1e-5 relative on the transcendental columns and exact elsewhere;
combine <= 1e-6 with exact ladders; int8 quantization bit for bit.
"""

import torch_threads  # noqa: F401  (first: torch held to one CPU thread)
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_fraud_detection_tpu.ensemble.combine import (
    EnsembleParams as JaxEnsembleParams,
    combine_predictions as jax_combine,
)
from realtime_fraud_detection_tpu.features.extract import (
    extract_features as jax_extract,
)
from realtime_fraud_detection_tpu.features.rules import (
    risk_level_code as jax_risk_level_code,
    rule_score as jax_rule_score,
)
from realtime_fraud_detection_tpu.features.schema import (
    TransactionBatch as JaxTransactionBatch,
)
from realtime_fraud_detection_tpu.models import bert as jbert
from realtime_fraud_detection_tpu.models import gnn as jgnn
from realtime_fraud_detection_tpu.models import lstm as jlstm
from realtime_fraud_detection_tpu.models import trees as jtrees
from realtime_fraud_detection_tpu.models.isolation_forest import (
    IsolationForest as JaxIsolationForest,
    iforest_predict as jax_iforest_predict,
)
from realtime_fraud_detection_tpu.models.quant import (
    quantize_bert_params as jax_quantize_bert_params,
)
from realtime_fraud_detection_tpu.scoring.pipeline import (
    MODEL_NAMES,
    init_scoring_models as jax_init_scoring_models,
)
from realtime_fraud_detection_tpu.utils.config import Config as JaxConfig
from realtime_fraud_detection_tpu_torch.bridge import models_from_numpy
from realtime_fraud_detection_tpu_torch.ensemble.combine import (
    EnsembleParams,
    combine_predictions,
)
from realtime_fraud_detection_tpu_torch.features.extract import (
    FEATURE_NAMES,
    extract_features,
)
from realtime_fraud_detection_tpu_torch.features.rules import (
    risk_level_code,
    rule_score,
)
from realtime_fraud_detection_tpu_torch.features.schema import TransactionBatch
from realtime_fraud_detection_tpu_torch.models import bert as tbert
from realtime_fraud_detection_tpu_torch.models.gnn import gnn_logits
from realtime_fraud_detection_tpu_torch.models.isolation_forest import (
    IsolationForest,
    iforest_predict,
)
from realtime_fraud_detection_tpu_torch.models.lstm import lstm_logits
from realtime_fraud_detection_tpu_torch.models.quant import (
    is_quantized_bert,
    quantize_bert_params,
)
from realtime_fraud_detection_tpu_torch.models.trees import (
    TreeEnsemble,
    descend_complete_trees,
    gather_leaf_values,
    gemm_leaf_index,
    tree_ensemble_logits,
    tree_ensemble_predict,
)
from realtime_fraud_detection_tpu_torch.scoring.pipeline import (
    make_example_batch,
)
from realtime_fraud_detection_tpu_torch.utils.config import Config
from torch_bounds import FLOOR

TINY = tbert.TINY_CONFIG
JTINY = jbert.TINY_CONFIG


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_models():
    """The JAX package's own model set at TINY width, numpy leaves."""
    return _np_tree(jax_init_scoring_models(jax.random.PRNGKey(3), JTINY))


@pytest.fixture(scope="module")
def port_models(jax_models):
    return models_from_numpy(jax_models)


# ------------------------------------------------------------------ trees
def _random_trees(seed, n_trees=16, depth=4, n_features=64):
    rng = np.random.default_rng(seed)
    n_internal = 2 ** depth - 1
    feature = rng.integers(0, n_features, (n_trees, n_internal)).astype(np.int32)
    threshold = rng.normal(0.0, 1.0, (n_trees, n_internal)).astype(np.float32)
    threshold[rng.random(threshold.shape) < 0.2] = np.inf   # unsplit nodes
    leaf = rng.normal(0.0, 0.3, (n_trees, 2 ** depth)).astype(np.float32)
    x = rng.normal(0.0, 1.0, (32, n_features)).astype(np.float32)
    # ties: x == threshold must go right in both implementations
    x[0, feature[0, 0]] = threshold[0, 0] if np.isfinite(threshold[0, 0]) else 0.0
    return feature, threshold, leaf, x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_leaves_exact_both_traversals(seed):
    feature, threshold, leaf, x = _random_trees(seed)
    want = np.asarray(jtrees.descend_complete_trees(
        jnp.asarray(feature), jnp.asarray(threshold), jnp.asarray(x)))
    got = descend_complete_trees(_t(feature), _t(threshold), _t(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        gemm_leaf_index(_t(feature), _t(threshold), _t(x)).numpy(), want)
    np.testing.assert_array_equal(
        gather_leaf_values(_t(leaf), _t(got)).numpy(),
        np.asarray(jtrees.gather_leaf_values(jnp.asarray(leaf), jnp.asarray(want))))


@pytest.mark.parametrize("kernel", ["gather", "gemm"])
def test_tree_ensemble_matches_jax(kernel):
    feature, threshold, leaf, x = _random_trees(5)
    jens = jtrees.TreeEnsemble(jnp.asarray(feature), jnp.asarray(threshold),
                               jnp.asarray(leaf), jnp.asarray(0.25, jnp.float32))
    tens = TreeEnsemble(_t(feature), _t(threshold), _t(leaf), torch.tensor(0.25))
    want = np.asarray(jtrees.tree_ensemble_logits(jens, jnp.asarray(x),
                                                  kernel=kernel))
    got = tree_ensemble_logits(tens, _t(x), kernel=kernel).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        tree_ensemble_predict(tens, _t(x), kernel=kernel).numpy(),
        np.asarray(jtrees.tree_ensemble_predict(jens, jnp.asarray(x),
                                                kernel=kernel)),
        rtol=0, atol=1e-4)


@pytest.mark.parametrize("kernel", ["gather", "gemm"])
def test_isolation_forest_matches_jax(kernel):
    feature, threshold, _, x = _random_trees(6, n_trees=12, depth=5)
    rng = np.random.default_rng(6)
    plen = (5 + 3 * rng.random((12, 32))).astype(np.float32)
    jf = JaxIsolationForest(jnp.asarray(feature), jnp.asarray(threshold),
                            jnp.asarray(plen), jnp.asarray(6.0, jnp.float32))
    tf = IsolationForest(_t(feature), _t(threshold), _t(plen), torch.tensor(6.0))
    np.testing.assert_allclose(
        iforest_predict(tf, _t(x), kernel=kernel).numpy(),
        np.asarray(jax_iforest_predict(jf, jnp.asarray(x), kernel=kernel)),
        rtol=0, atol=1e-4)


# ------------------------------------------------------------- lstm / gnn
def _branch_bound(jax_fn, compute):
    """f32 compute: 1e-5; bf16: the JAX branch's own bf16-vs-f32 gap on
    the same inputs, floored at 1e-4."""
    if compute == "f32":
        return 1e-5
    gap = np.abs(np.asarray(jax_fn(jnp.bfloat16), np.float64)
                 - np.asarray(jax_fn(jnp.float32), np.float64)).max()
    return max(float(gap), FLOOR)


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_lstm_matches_jax(jax_models, port_models, compute):
    rng = np.random.default_rng(21)
    seq = rng.standard_normal((16, 10, 64)).astype(np.float32)
    lengths = rng.integers(0, 11, 16).astype(np.int32)      # incl. empty

    def jax_fn(dt):
        return jlstm.lstm_logits(jax_models.lstm, jnp.asarray(seq),
                                 jnp.asarray(lengths), compute_dtype=dt)

    tdt = torch.float32 if compute == "f32" else torch.bfloat16
    want = np.asarray(jax_fn(jnp.float32 if compute == "f32" else jnp.bfloat16))
    got = lstm_logits(port_models.lstm, _t(seq), _t(lengths),
                      compute_dtype=tdt).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=_branch_bound(jax_fn, compute))


def test_gnn_matches_jax(jax_models, port_models):
    rng = np.random.default_rng(22)
    b, k, d = 16, 16, 16
    args = [rng.standard_normal((b, 64)), rng.standard_normal((b, d)),
            rng.standard_normal((b, d)), rng.standard_normal((b, k, d)),
            rng.random((b, k)) < 0.7, rng.standard_normal((b, k, d)),
            rng.random((b, k)) < 0.7]
    args = [a.astype(np.float32) if a.dtype.kind == "f" else a for a in args]
    args[4][0] = False                           # no neighbours at all
    want = np.asarray(jgnn.gnn_logits(jax_models.gnn,
                                      *[jnp.asarray(a) for a in args]))
    got = gnn_logits(port_models.gnn, *[_t(a) for a in args]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_typed_gnn_is_not_ported_yet(port_models):
    # the typed layout is ported now (tests/test_torch_graph.py holds it
    # against JAX): identity projections and untagged rows reduce it to the
    # bipartite GNN over clipped transaction features
    typed = dict(port_models.gnn, **{f"w_node_{t}": torch.eye(16) for t in
                                     ("user", "merchant", "device", "ip")})
    rng = np.random.default_rng(23)
    args = [_t(rng.standard_normal(s).astype(np.float32))
            for s in ((2, 64), (2, 16), (2, 16), (2, 4, 16))]
    for node in args[1:]:
        node[..., 8:11] = 0.0                 # the type-tag slots: users
    mask = torch.ones((2, 4), dtype=torch.bool)
    got = gnn_logits(typed, args[0] * 20, *args[1:], mask, args[3], mask)
    want = gnn_logits(port_models.gnn, torch.clamp(args[0] * 20, -10.0, 10.0),
                      *args[1:], mask, args[3], mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


# -------------------------------------------------- features / rules / blend
@pytest.fixture(scope="module")
def txn_columns():
    return {k: v for k, v in vars(make_example_batch(
        64, rng=np.random.default_rng(31)).txn).items()}


def test_features_match_jax(txn_columns):
    want = np.asarray(jax_extract(JaxTransactionBatch(**txn_columns)))
    got = extract_features(TransactionBatch(
        **{k: _t(v) for k, v in txn_columns.items()})).numpy()
    assert got.shape == want.shape == (64, len(FEATURE_NAMES))
    transcendental = [FEATURE_NAMES.index(n) for n in (
        "amount_log", "amount_sqrt", "distance_to_merchant_km")]
    exact = [i for i in range(len(FEATURE_NAMES)) if i not in transcendental]
    np.testing.assert_array_equal(got[:, exact], want[:, exact])
    np.testing.assert_allclose(got[:, transcendental], want[:, transcendental],
                               rtol=1e-5, atol=1e-5)


def test_rule_score_and_risk_ladder_match_jax(txn_columns):
    want = np.asarray(jax_rule_score(JaxTransactionBatch(**txn_columns)))
    got = rule_score(TransactionBatch(
        **{k: _t(v) for k, v in txn_columns.items()})).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    probs = np.linspace(0.0, 1.0, 101, dtype=np.float32)
    np.testing.assert_array_equal(risk_level_code(_t(probs)).numpy(),
                                  np.asarray(jax_risk_level_code(jnp.asarray(probs))))


@pytest.mark.parametrize("strategy", ["weighted_average", "voting", "stacking"])
def test_combine_predictions_matches_jax(strategy):
    rng = np.random.default_rng(41)
    preds = rng.random((64, 5)).astype(np.float32)
    valid = rng.random((64, 5)) < 0.8
    jcfg = JaxConfig()
    jcfg.ensemble.strategy = strategy
    cfg = Config()
    cfg.ensemble.strategy = strategy
    want = jax_combine(jnp.asarray(preds), jnp.asarray(valid),
                       JaxEnsembleParams.from_config(jcfg, MODEL_NAMES))
    got = combine_predictions(_t(preds), _t(valid),
                              EnsembleParams.from_config(cfg, MODEL_NAMES))
    for key in ("decision", "risk_level"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    for key in ("fraud_probability", "confidence", "model_confidences"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-6)


def test_ensemble_params_match_jax():
    jp = JaxEnsembleParams.from_config(JaxConfig(), MODEL_NAMES)
    tp = EnsembleParams.from_config(Config(), MODEL_NAMES)
    np.testing.assert_array_equal(tp.weights.numpy(), np.asarray(jp.weights))
    np.testing.assert_array_equal(tp.confidence_multipliers.numpy(),
                                  np.asarray(jp.confidence_multipliers))
    assert (tp.strategy, tp.fraud_threshold, tp.confidence_threshold,
            tp.decline_threshold, tp.review_threshold, tp.monitor_threshold) == (
        jp.strategy, jp.fraud_threshold, jp.confidence_threshold,
        jp.decline_threshold, jp.review_threshold, jp.monitor_threshold)


# ------------------------------------------------------- quant and bridge
def test_quantization_is_bit_identical(jax_models, port_models):
    want = _np_tree(jax_quantize_bert_params(jax_models.bert))
    got = quantize_bert_params(port_models.bert)
    assert is_quantized_bert(got) and not is_quantized_bert(port_models.bert)
    want_leaves, want_def = jax.tree_util.tree_flatten(want)
    got_leaves, got_def = jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(np.asarray, got))
    assert want_def == got_def
    for a, b in zip(got_leaves, want_leaves):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert quantize_bert_params(got) is got            # idempotent


def test_bridge_carries_every_branch(jax_models):
    quantized = _np_tree(jax_models.replace(
        bert=jax_quantize_bert_params(jax_models.bert)))
    for src in (quantized, vars(quantized)):          # attributes or keys
        m = models_from_numpy(src)
        assert m.trees.feature.dtype == torch.int32
        assert m.iforest.path_length.shape == tuple(
            quantized.iforest.path_length.shape)
        assert m.bert["word_emb"]["qe"].dtype == torch.int8
        assert m.bert["layers"][0]["ffn1"]["qw"].shape == (
            JTINY.hidden_size, JTINY.intermediate_size)
        np.testing.assert_array_equal(m.lstm["w_gates"].numpy(),
                                      quantized.lstm["w_gates"])


# ------------------------------------------------------------------- bert
def _bert_inputs(seed=51, b=4, s=64):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, TINY.vocab_size, (b, s)).astype(np.int32)
    mask = np.arange(s)[None, :] < rng.integers(1, s + 1, b)[:, None]
    return ids, mask


def test_bert_embed_matches_jax(jax_models, port_models):
    ids, _ = _bert_inputs()
    want = np.asarray(jbert.bert_embed(jax_models.bert, jnp.asarray(ids), JTINY))
    got = tbert.bert_embed(port_models.bert, _t(ids), TINY).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_bert_layer_matches_jax(jax_models, port_models):
    ids, mask = _bert_inputs()
    x = np.asarray(jbert.bert_embed(jax_models.bert, jnp.asarray(ids), JTINY))
    want = np.asarray(jbert.bert_layer(jax_models.bert["layers"][0],
                                       jnp.asarray(x), jnp.asarray(mask), JTINY,
                                       compute_dtype=jnp.float32))
    got = tbert.bert_layer(port_models.bert["layers"][0], _t(x), _t(mask), TINY,
                           compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("layout", ["f32", "int8"])
@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_bert_predict_matches_jax(jax_models, layout, compute):
    ids, mask = _bert_inputs()
    jparams = jax_models.bert
    kernels = {}
    if layout == "int8":
        jparams = _np_tree(jax_quantize_bert_params(jparams))
        kernels = dict(dequant_kernel="pallas", kernel_interpret=True)
    tparams = models_from_numpy(jax_models.replace(bert=jparams)).bert

    def jax_fn(dt):
        return jbert.bert_predict(jparams, jnp.asarray(ids), jnp.asarray(mask),
                                  JTINY, use_pallas=True, compute_dtype=dt,
                                  **dict(kernels, kernel_interpret=True))

    tdt = torch.float32 if compute == "f32" else torch.bfloat16
    want = np.asarray(jax_fn(jnp.float32 if compute == "f32" else jnp.bfloat16))
    predict = partial(tbert.bert_predict, tparams, _t(ids), _t(mask), TINY,
                      compute_dtype=tdt)
    got = predict(use_flash=True,
                  dequant_kernel="cuda" if layout == "int8" else "off").numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=_branch_bound(jax_fn, compute))
    # the plain path gives the same numbers on the CPU
    np.testing.assert_array_equal(predict().numpy(), got)
