"""The port's training plane against the JAX package's, on the CPU.

- Exact: ``GBDTTrainer`` (arrays and ``feature_importances_``) and
  ``IsolationForestTrainer`` bit-equal to JAX's on the same seeded data;
  ``platt_fit`` equal; the three head folds equal to JAX's on bridged
  parameters.
- The dataset builders (sequence, bipartite graph, typed graph, text) on
  the same seeded stream: exact apart from the three transcendental feature
  columns (``FEATURE_TOL``, the host feature tolerance).
- One optimizer step's loss and gradients for the LSTM, GNN, typed GNN and
  BERT branches at f32 compute (``TRAIN_LOSS_REL``, ``TRAIN_GRAD_REL``), and
  five ``torch.optim`` Adam / AdamW steps against optax (``OPTIMIZER_TOL``).
- The public trainers from JAX's own initial weights (bridged through
  ``params_from_numpy``) for at most 20 steps: the trained branches'
  probabilities within ``LOOP_PROB_BOUND`` of JAX's (after Adam, raw
  weights are not compared: a gradient near zero whose sign differs by
  rounding moves a weight by +-lr).
- ``run_blend_eval`` at ``tests/test_blend_eval.py``'s tiny config from the
  bridged initial weights: the evidence dict's keys, the tree and
  isolation-forest scores (``BLEND_SCORE_TOL``) and their AUCs.
- The commands: ``simulate`` lines equal to JAX's; ``train`` printing
  JAX's AUC and ``top_feature_importances`` for the same trees, then
  ``validate`` on its checkpoint (the eval seed moved off the training
  seed, exit 1 below ``--min-auc``, the textfile), and the restored
  scorer's explanations carrying the importances; refusals without a card.
- The megakernel's plan admits typed GNN parameters on a one-hop batch as
  JAX's does, and a direct call's GNN column is JAX's typed ``gnn_logits``;
  its FFN limit takes the protocol's encoder (FFN 512).
"""

import torch_threads  # noqa: F401  (first: torch held to one CPU thread)
import dataclasses
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from realtime_fraud_detection_tpu import cli as jax_cli
from realtime_fraud_detection_tpu.ensemble.combine import (
    blend_branch_scores as jax_blend_branch_scores,
)
from realtime_fraud_detection_tpu.features.extract import extract_features as jax_extract
from realtime_fraud_detection_tpu.features.extract import (
    top_feature_importances as jax_top_importances,
)
from realtime_fraud_detection_tpu.models import bert as jbert
from realtime_fraud_detection_tpu.models import gnn as jgnn
from realtime_fraud_detection_tpu.models import isolation_forest as jiforest
from realtime_fraud_detection_tpu.models import lstm as jlstm
from realtime_fraud_detection_tpu.ops import megakernel as jmk
from realtime_fraud_detection_tpu.scoring import pipeline as jax_pipeline
from realtime_fraud_detection_tpu.sim.simulator import TransactionGenerator as JaxGenerator
from realtime_fraud_detection_tpu.training import blend_eval as jbe
from realtime_fraud_detection_tpu.training import calibrate as jcal
from realtime_fraud_detection_tpu.training import gbdt as jgbdt
from realtime_fraud_detection_tpu.training import neural as jneural
from realtime_fraud_detection_tpu.training import text as jtext
from realtime_fraud_detection_tpu_torch.__main__ import main as port_main
from realtime_fraud_detection_tpu_torch.bridge import models_from_numpy, params_from_numpy
from realtime_fraud_detection_tpu_torch.checkpoint import (
    CheckpointManager,
    restore_scorer_host_state,
    snapshot_scorer_host_state,
)
from realtime_fraud_detection_tpu_torch.ensemble.combine import (
    STRATEGIES,
    blend_branch_scores,
)
from realtime_fraud_detection_tpu_torch.features.extract import (
    FEATURE_NAMES,
    top_feature_importances,
)
from realtime_fraud_detection_tpu_torch.models import bert as tbert
from realtime_fraud_detection_tpu_torch.models import gnn as tgnn
from realtime_fraud_detection_tpu_torch.models import lstm as tlstm
from realtime_fraud_detection_tpu_torch.models.isolation_forest import (
    IsolationForestTrainer,
)
from realtime_fraud_detection_tpu_torch.ops import megakernel as tmk
from realtime_fraud_detection_tpu_torch.scoring.pipeline import (
    MODEL_NAMES,
    init_scoring_models,
)
from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
from realtime_fraud_detection_tpu_torch.training import blend_eval as tbe
from realtime_fraud_detection_tpu_torch.training import calibrate as tcal
from realtime_fraud_detection_tpu_torch.training import neural as tneural
from realtime_fraud_detection_tpu_torch.training import text as ttext
from realtime_fraud_detection_tpu_torch.training.gbdt import GBDTTrainer
from test_blend_eval import _tiny_cfg
from torch_bounds import (
    BLEND_SCORE_TOL,
    FEATURE_TOL,
    LOOP_PROB_BOUND,
    OPTIMIZER_TOL,
    TRAIN_GRAD_REL,
    TRAIN_LOSS_REL,
)

TRANSCENDENTAL = [FEATURE_NAMES.index(n) for n in (
    "amount_log", "amount_sqrt", "distance_to_merchant_km")]
EXACT = [i for i in range(len(FEATURE_NAMES)) if i not in TRANSCENDENTAL]
SMALL_BERT = dict(hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64)


def assert_close_arrays(got, want):
    """Exact, apart from the three transcendental feature columns of a
    64-wide last axis (``FEATURE_TOL``)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if got.ndim and got.shape[-1] == len(FEATURE_NAMES):
        np.testing.assert_array_equal(got[..., EXACT], want[..., EXACT])
        np.testing.assert_allclose(got[..., TRANSCENDENTAL], want[..., TRANSCENDENTAL],
                                   rtol=FEATURE_TOL, atol=FEATURE_TOL)
    else:
        np.testing.assert_array_equal(got, want.astype(got.dtype))


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=()):
    """{path: leaf} of nested dicts / lists (either package's)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, prefix + (i,)))
        return out
    return {prefix: tree}


def _xy(n=700, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 64)).astype(np.float32)
    x[:, 5] = np.round(x[:, 5])          # heavy ties in the quantile bins
    x[:, 9] = 1.0                        # a constant column
    y = (x[:, 0] + 0.5 * x[:, 3] * x[:, 7] + rng.normal(0, 0.5, n) > 1.2)
    return x, y.astype(np.float32)


# --------------------------------------------------------------- exact parts
@pytest.mark.parametrize("kw", [
    dict(n_estimators=6, max_depth=4, seed=3),
    # large child weights prune subtrees early (the +inf padding path)
    dict(n_estimators=4, max_depth=5, min_child_weight=20.0, subsample=0.5,
         colsample_bytree=0.3, seed=9),
], ids=["default", "pruned"])
def test_gbdt_trainer_is_bit_equal_to_jax(kw):
    x, y = _xy()
    jt, tt = jgbdt.GBDTTrainer(**kw), GBDTTrainer(**kw)
    want, got = jt.fit(x, y), tt.fit(x, y)
    for f in ("feature", "threshold", "leaf", "base_score"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tt.feature_importances_, jt.feature_importances_)
    assert np.isinf(got.threshold.numpy()).any()     # unsplit nodes padded


@pytest.mark.parametrize("dupes", [False, True], ids=["distinct", "duplicate_rows"])
def test_isolation_forest_trainer_is_bit_equal_to_jax(dupes):
    x, _ = _xy(400, seed=1)
    if dupes:                        # unsplittable nodes seal early
        x[100:300] = x[0]
    kw = dict(n_estimators=7, max_samples=128, seed=4)
    want = jiforest.IsolationForestTrainer(**kw).fit(x)
    got = IsolationForestTrainer(**kw).fit(x)
    for f in ("feature", "threshold", "path_length", "c_psi"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["shifted", "inverted", "empty", "constant"])
def test_platt_fit_equals_jax(case):
    rng = np.random.default_rng(2)
    y = (rng.random(500) < 0.1).astype(np.float32)
    z = {"shifted": 2.8 + 1.5 * y + rng.normal(0, 1, 500),
         "inverted": -3.0 * y + rng.normal(0, 0.5, 500),
         "empty": np.zeros(0),
         "constant": np.full(500, 1.25)}[case]
    if case == "empty":
        y = y[:0]
    assert tcal.platt_fit(z, y) == jcal.platt_fit(z, y)
    np.testing.assert_array_equal(tcal.platt_apply(z, 1.3, -0.2),
                                  jcal.platt_apply(z, 1.3, -0.2))


@pytest.mark.parametrize("branch", ["lstm", "gnn", "bert"])
def test_head_folds_equal_jax(branch):
    key = jax.random.PRNGKey(5)
    params = {"lstm": lambda: jlstm.init_lstm_params(key, 64, 32),
              "gnn": lambda: jgnn.init_gnn_params(key, 16, 64, 64),
              "bert": lambda: jbert.init_bert_params(
                  key, jbert.BertConfig(**SMALL_BERT))}[branch]()
    fold = {"lstm": (jcal.calibrate_lstm_head, tcal.calibrate_lstm_head),
            "gnn": (jcal.calibrate_gnn_head, tcal.calibrate_gnn_head),
            "bert": (jcal.calibrate_bert_head, tcal.calibrate_bert_head)}[branch]
    tparams = params_from_numpy(_numpy(params))
    want = _flat(_numpy(fold[0](params, 0.731, -1.37)))
    got = _flat(fold[1](tparams, 0.731, -1.37))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    # the input is left as it was
    for k, v in _flat(tparams).items():
        np.testing.assert_array_equal(v.numpy(), _flat(_numpy(params))[k])


# ----------------------------------------------------------------- builders
def _gens(seed=7, users=60, merchants=20):
    return (JaxGenerator(num_users=users, num_merchants=merchants, seed=seed),
            TransactionGenerator(num_users=users, num_merchants=merchants, seed=seed))


@pytest.mark.parametrize("builder", ["sequence", "graph", "typed_graph", "text"])
def test_dataset_builders_match_jax(builder):
    jg, tg = _gens()
    n = 300
    if builder == "sequence":
        want = jneural.build_sequence_dataset(jg, n, chunk=128)
        got = tneural.build_sequence_dataset(tg, n, chunk=128)
    elif builder == "graph":
        want = jneural.build_graph_dataset(jg, n, chunk=64)[:2]
        got = tneural.build_graph_dataset(tg, n, chunk=64)[:2]
    elif builder == "typed_graph":
        want = jneural.build_typed_graph_dataset(jg, n, chunk=64)[:2]
        got = tneural.build_typed_graph_dataset(tg, n, chunk=64)[:2]
    else:
        want = jtext.build_text_dataset(jg, n, max_length=16)
        got = ttext.build_text_dataset(tg, n, max_length=16)
    want, got = _flat(want), _flat(got)
    assert got.keys() == want.keys()
    for k in want:
        assert_close_arrays(got[k], want[k])


# ------------------------------------------------------- one step per branch
def _step_case(branch, rng, b=48):
    """(JAX params, JAX loss fn, port loss fn) at f32 compute."""
    y = (rng.random(b) < 0.2).astype(np.float32)
    if branch == "lstm":
        p = jlstm.init_lstm_params(jax.random.PRNGKey(0), 64, 32)
        s = rng.standard_normal((b, 10, 64)).astype(np.float32)
        ln = rng.integers(1, 11, b).astype(np.int32)
        return p, (lambda q: jneural.weighted_bce_loss(
            jlstm.lstm_logits(q, s, ln, compute_dtype=jnp.float32), y, 5.0)), (
            lambda q: tneural.weighted_bce_loss(tlstm.lstm_logits(
                q, torch.from_numpy(s), torch.from_numpy(ln),
                compute_dtype=torch.float32), torch.from_numpy(y), 5.0))
    if branch == "bert":
        jcfg = jbert.BertConfig(vocab_size=3000, **SMALL_BERT)
        tcfg = tbert.BertConfig(vocab_size=3000, **SMALL_BERT)
        p = jbert.init_bert_params(jax.random.PRNGKey(1), jcfg)
        ids = rng.integers(0, 3000, (b, 16)).astype(np.int32)
        mask = np.ones((b, 16), bool)
        mask[:, 10:] = rng.random((b, 6)) < 0.5

        def jloss(q):
            lg = jbert.bert_logits(q, ids, mask, jcfg, compute_dtype=jnp.float32)
            per = optax.softmax_cross_entropy_with_integer_labels(
                lg, y.astype(jnp.int32))
            return (per * jnp.where(y > 0.5, 5.0, 1.0)).mean()

        def tloss(q):
            lg = tbert.bert_logits(q, torch.from_numpy(ids), torch.from_numpy(mask),
                                   tcfg, compute_dtype=torch.float32)
            per = torch.nn.functional.cross_entropy(
                lg, torch.from_numpy(y).long(), reduction="none")
            return (per * torch.where(torch.from_numpy(y) > 0.5, 5.0, 1.0)).mean()

        return p, jloss, tloss
    typed = branch == "typed_gnn"
    p = jgnn.init_gnn_params(jax.random.PRNGKey(2), 16, 64, 64, typed=typed)
    args = [rng.standard_normal((b, 64)).astype(np.float32) * 4,
            rng.random((b, 16)).astype(np.float32), rng.random((b, 16)).astype(np.float32),
            rng.random((b, 8, 16)).astype(np.float32), rng.random((b, 8)) < 0.6,
            rng.random((b, 8, 16)).astype(np.float32), rng.random((b, 8)) < 0.6]
    if typed:
        args += [rng.random((b, 8, 4, 16)).astype(np.float32), rng.random((b, 8, 4)) < 0.5,
                 rng.random((b, 8, 4, 16)).astype(np.float32), rng.random((b, 8, 4)) < 0.5]
    return p, (lambda q: jneural.weighted_bce_loss(jgnn.gnn_logits(q, *args), y, 5.0)), (
        lambda q: tneural.weighted_bce_loss(
            tgnn.gnn_logits(q, *[torch.from_numpy(a) for a in args]),
            torch.from_numpy(y), 5.0))


@pytest.mark.parametrize("branch", ["lstm", "gnn", "typed_gnn", "bert"])
def test_one_step_loss_and_gradients_match_jax(branch):
    p, jloss, tloss = _step_case(branch, np.random.default_rng(11))
    jl, jgrads = jax.value_and_grad(jloss)(p)
    tparams = params_from_numpy(_numpy(p))
    for leaf in tneural.tree_leaves(tparams):
        leaf.requires_grad_(True)
    tl = tloss(tparams)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= TRAIN_LOSS_REL * abs(float(jl))
    want = _flat(_numpy(jgrads))
    got = {k: v.grad.numpy() for k, v in _flat(tparams).items()}
    assert got.keys() == want.keys()
    scale = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        # a leaf whose exact gradient is zero (the attention key bias: the
        # softmax is shift-invariant) carries rounding noise only, so its
        # bound is taken against the tree's largest gradient
        leaf_scale = max(np.abs(w).max(), 1e-6 * scale)
        assert np.abs(got[k] - w).max() <= TRAIN_GRAD_REL * leaf_scale, k


@pytest.mark.parametrize("opt", ["adam", "adamw"])
def test_optimizer_steps_match_optax(opt):
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((16, 8)).astype(np.float32),
              "b": rng.standard_normal(8).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * 10 ** rng.uniform(-6, 0)).astype(np.float32)
              for k, v in params.items()} for _ in range(5)]
    tx = optax.adam(1e-3) if opt == "adam" else optax.adamw(5e-4)
    factory = tneural.adam(1e-3) if opt == "adam" else tneural.adamw(5e-4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in params.items()}
    topt = factory(list(tp.values()))
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, v in tp.items():
            v.grad = torch.from_numpy(g[k].copy())
        topt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=OPTIMIZER_TOL)


# ----------------------------------------------------------- the loop itself
def _held_out(branch, gen):
    """Held-out inputs for the trained branch's probabilities."""
    if branch == "lstm":
        s, ln, _ = jneural.build_sequence_dataset(gen, 256)
        return (s, ln)
    if branch == "gnn":
        return jneural.build_graph_dataset(gen, 256)[0]
    ids, mask, _ = jtext.build_text_dataset(gen, 256, max_length=16)
    return (ids, mask)


@pytest.mark.parametrize("branch", ["lstm", "gnn", "bert"])
def test_trainers_from_the_jax_init_match_jax(branch):
    """The public trainers (dataset, loop, tail calibration, fold) from
    JAX's own initial weights: 1,100 training rows of 256 for 2 epochs
    (8 steps), BERT 1,100 of 64 for 1 epoch (17 steps)."""
    jg, tg = _gens(seed=21, users=120, merchants=40)
    n = 1300
    if branch == "lstm":
        init = jlstm.init_lstm_params(jax.random.PRNGKey(0), 64, 32)
        want = jneural.train_lstm(jg, n_transactions=n, hidden=32, epochs=2, seed=0)
        got = tneural.train_lstm(tg, n_transactions=n, hidden=32, epochs=2, seed=0,
                                 init=params_from_numpy(_numpy(init)), device="cpu")

        def jprob(p, x):
            return jax.nn.sigmoid(jlstm.lstm_logits(p, *x))

        def tprob(p, x):
            return torch.sigmoid(tlstm.lstm_logits(p, *map(torch.from_numpy, x)))
    elif branch == "gnn":
        init = jgnn.init_gnn_params(jax.random.PRNGKey(0), 16, 64, 32)
        want = jneural.train_gnn(jg, n_transactions=n, hidden=32, epochs=2, seed=0)[0]
        got = tneural.train_gnn(tg, n_transactions=n, hidden=32, epochs=2, seed=0,
                                init=params_from_numpy(_numpy(init)), device="cpu")[0]

        def jprob(p, x):
            return jax.nn.sigmoid(jgnn.gnn_logits(p, *x))

        def tprob(p, x):
            return torch.sigmoid(tgnn.gnn_logits(p, *map(torch.from_numpy, x)))
    else:
        jcfg, tcfg = jbert.BertConfig(**SMALL_BERT), tbert.BertConfig(**SMALL_BERT)
        init = jbert.init_bert_params(jax.random.PRNGKey(0), jcfg)
        want = jtext.train_bert(jg, config=jcfg, n_transactions=n, max_length=16,
                                epochs=1, seed=0)
        got = ttext.train_bert(tg, config=tcfg, n_transactions=n, max_length=16,
                               epochs=1, seed=0, init=params_from_numpy(_numpy(init)),
                               device="cpu")

        def jprob(p, x):
            return jbert.bert_predict(p, *x, jcfg)

        def tprob(p, x):
            return tbert.bert_predict(p, *map(torch.from_numpy, x), tcfg)
    x = _held_out(branch, JaxGenerator(num_users=120, num_merchants=40, seed=22))
    gap = np.abs(tprob(got, x).numpy() - np.asarray(jprob(want, x))).max()
    assert gap <= LOOP_PROB_BOUND[branch], gap


def test_trainer_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tneural.NeuralTrainer().train({"w": torch.zeros(2)}, None, (np.zeros((2, 2)),),
                                      np.zeros(2))


# ---------------------------------------------------------- the protocol
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_blend_branch_scores_match_jax(strategy):
    rng = np.random.default_rng(4)
    scores = {n: rng.random(64).astype(np.float32) for n in MODEL_NAMES[:4]}
    weights = {"xgboost_primary": 0.3, "lstm_sequential": 0.1, "bert_text": 0.0,
               "graph_neural": 0.2, "isolation_forest": 0.4}
    np.testing.assert_allclose(
        blend_branch_scores(scores, weights, strategy),
        np.asarray(jax_blend_branch_scores(scores, weights, strategy)),
        rtol=0, atol=BLEND_SCORE_TOL)


def _keys(tree):
    """The key structure of nested dicts / lists."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_keys(v) for v in tree]
    return None


def test_run_blend_eval_matches_jax_from_the_same_init(monkeypatch, tmp_path):
    jcfg = _tiny_cfg()
    tcfg = tbe.BlendEvalConfig(**{**{f.name: getattr(jcfg, f.name)
                                     for f in dataclasses.fields(jcfg)},
                                  "bert": tbert.BertConfig(**dataclasses.asdict(jcfg.bert))})
    init = {"lstm": jlstm.init_lstm_params(jax.random.PRNGKey(0), 64, jcfg.lstm_hidden),
            "bert": jbert.init_bert_params(jax.random.PRNGKey(1), jcfg.bert),
            "gnn": jgnn.init_gnn_params(jax.random.PRNGKey(2), 16, 64, 64)}
    captured = {}

    def spy(module, side):
        inner = module._train_branches

        def wrapped(*args, **kw):
            out = inner(*args, **kw)
            captured[side] = out[0]
            return out

        monkeypatch.setattr(module, "_train_branches", wrapped)

    spy(jbe, "jax")
    spy(tbe, "port")
    want = jbe.run_blend_eval(jcfg)
    stages = {}
    got = tbe.run_blend_eval(tcfg, checkpoint_dir=str(tmp_path / "ck"), device="cpu",
                             init={k: params_from_numpy(_numpy(v)) for k, v in init.items()},
                             stage_seconds=stages)
    # the blend's branch set follows the neural branches' AUCs, so the keys
    # of the sections sized by it are compared one level down
    assert got.keys() == want.keys()
    for k in ("protocol", "branch_auc", "test", "operating_points"):
        assert _keys(got[k]) == _keys(want[k]), k
    assert _keys(got["selected_blend"]).keys() == _keys(want["selected_blend"]).keys()
    assert [_keys(a) for a in got["admission"]] == [_keys(a) for a in want["admission"]]
    assert got["strategy_selection"].keys() == want["strategy_selection"].keys()
    assert got["protocol"]["segments_txns"] == want["protocol"]["segments_txns"]
    assert got["protocol"]["fraud_rate"] == want["protocol"]["fraud_rate"]
    for seg in ("val", "test"):
        for name in ("xgboost_primary", "isolation_forest"):
            np.testing.assert_allclose(captured["port"][seg][name],
                                       captured["jax"][seg][name],
                                       rtol=0, atol=BLEND_SCORE_TOL)
            assert got["branch_auc"][name] == want["branch_auc"][name]
    assert {"collect", "trees_iforest", "lstm", "text", "gnn", "selection"} <= stages.keys()
    # the checkpoint: JAX's metadata keys, and the text architecture guard
    meta = CheckpointManager(tmp_path / "ck").manifest()["metadata"]
    assert meta["source"] == "blend_eval" and meta["text_model"] == dataclasses.asdict(tcfg.bert)
    assert meta["selected_blend"] == got["selected_blend"]["branches"]
    with pytest.raises(ValueError, match="allow_arch_mismatch"):
        tbe.run_blend_eval(dataclasses.replace(tcfg, bert=tbert.TINY_CONFIG),
                           checkpoint_dir=str(tmp_path / "ck"), device="cpu")


# ------------------------------------------------------------ the commands
def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_simulate_lines_equal_jax(capsys):
    argv = ["simulate", "--count", "25", "--users", "40", "--merchants", "15",
            "--seed", "5"]
    rc_j, want, _ = _run(jax_cli.main, argv, capsys)
    rc_t, got, err = _run(port_main, argv, capsys)
    assert rc_j == rc_t == 0 and got == want and len(got.splitlines()) == 25
    assert "generated 25 txns" in err


def test_train_then_validate_round_trip(tmp_path, capsys):
    sim = ["--users", "200", "--merchants", "50"]
    ck = str(tmp_path / "ck")
    rc, out, err = _run(port_main, ["train", "--rows", "1500", "--trees", "5",
                                    "--device", "cpu", "--out", ck] + sim, capsys)
    assert rc == 0 and "train timing:" in err
    got = json.loads(out.strip().splitlines()[-1])
    # JAX's trainer, AUC and importances on the same rows and trees
    gen = JaxGenerator(num_users=200, num_merchants=50, seed=42)
    batch, labels = gen.generate_encoded(1500)
    x = np.asarray(jax_extract(batch))
    y = labels["is_fraud"].astype(np.float32)
    jt = jgbdt.GBDTTrainer(n_estimators=5, seed=42)
    from realtime_fraud_detection_tpu.models.trees import tree_ensemble_logits
    trees = jt.fit(x[:1200], y[:1200])
    auc = jax_cli._auc(y[1200:], np.asarray(tree_ensemble_logits(trees, x[1200:])))
    assert got["auc"] == round(auc, 4) and got["fraud_rate"] == round(float(y.mean()), 4)
    assert got["top_feature_importances"] == jax_top_importances(jt.feature_importances_)
    assert got["neural_trained"] is False
    # validate: the eval seed moves off the checkpoint's training seed
    prom = tmp_path / "v.prom"
    rc, out, _ = _run(port_main, ["validate", "--checkpoint-dir", ck, "--rows", "256",
                                  "--seed", "41", "--device", "cpu", "--min-auc", "0.99",
                                  "--metrics-out", str(prom)] + sim, capsys)
    report = json.loads(out.strip().splitlines()[-1])
    assert rc == 1 and report["passed"] is False and report["eval_seed"] == 43
    assert list(report) == ["n", "fraud_rate", "auc", "accuracy", "precision", "recall",
                            "min_auc", "passed", "eval_seed", "checkpoint_step"]
    assert "rtfd_validation_auc " in prom.read_text()
    rc, out, _ = _run(port_main, ["validate", "--checkpoint-dir", ck, "--rows", "256",
                                  "--device", "cpu", "--min-auc", "0.0"] + sim, capsys)
    assert rc == 0 and json.loads(out.strip().splitlines()[-1])["eval_seed"] == 43
    # a restored scorer's explanations carry the trainer's importances
    scorer = TorchFraudScorer(device="cpu")
    CheckpointManager(ck).restore_into_scorer(scorer)
    tgen = TransactionGenerator(num_users=200, num_merchants=50, seed=3)
    scorer.seed_profiles(tgen.users.profiles(), tgen.merchants.profiles())
    res = scorer.score_batch(tgen.generate_batch(3))
    for r in res:
        assert r["explanation"]["top_feature_importances"] == got["top_feature_importances"]


@pytest.mark.parametrize("command", [
    ["train", "--rows", "100"], ["validate", "--checkpoint-dir", "x"], ["quality-eval"]])
def test_training_commands_refuse_to_start_without_a_card(command, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    assert port_main(command) == 2
    assert "no CUDA device" in capsys.readouterr().err


# --------------------------------------------- the importances in serving
def test_importances_are_cleared_by_set_models_and_carried_by_host_state():
    imp = np.linspace(0.0, 1.0, 64).astype(np.float32)
    s = TorchFraudScorer(device="cpu", models=init_scoring_models(1, n_trees=4, tree_depth=3))
    s.set_feature_importances(imp)
    assert s._top_importances == top_feature_importances(imp)
    snap = snapshot_scorer_host_state(s)
    s.set_models(init_scoring_models(2, n_trees=4, tree_depth=3))
    assert s._top_importances is None
    restore_scorer_host_state(s, snap)
    assert s._top_importances == top_feature_importances(imp)
    s.set_feature_importances(None)
    assert s._top_importances is None
    with pytest.raises(ValueError, match="canonical feature contract"):
        top_feature_importances(np.ones(3))


def test_a_bad_manifest_importance_restores_leniently(tmp_path, caplog):
    mgr = CheckpointManager(tmp_path)
    models = init_scoring_models(1, n_trees=4, tree_depth=3)
    mgr.save(0, params=models, metadata={"feature_importances": [0.5, 0.5]})
    scorer = TorchFraudScorer(device="cpu", models=models)
    with caplog.at_level(logging.WARNING):
        mgr.restore_into_scorer(scorer)
    assert scorer._top_importances is None
    assert "omit top_feature_importances" in caplog.text


# ------------------------------------------------- the megakernel's typed GNN
def _typed_models():
    """A TINY model set with typed GNN parameters and int8 BERT (the form
    both plans admit)."""
    from realtime_fraud_detection_tpu.models.quant import quantize_bert_params

    jm = _numpy(jax_pipeline.init_scoring_models(
        jax.random.PRNGKey(4), n_trees=4, tree_depth=3, gnn_typed=True))
    jm = jm.replace(bert=quantize_bert_params(jm.bert))
    return jm, models_from_numpy(jm)


def test_megakernel_plan_admits_typed_params_on_a_one_hop_batch_like_jax():
    jm, tm = _typed_models()
    for two_hop in (False, True):
        want = jmk.mega_plan(jm, jbert.TINY_CONFIG, b=256, text_len=64, seq_len=10,
                             feature_dim=64, has_two_hop=two_hop)
        got = tmk.mega_plan(tm, tbert.TINY_CONFIG, b=256, text_len=64, seq_len=10,
                            feature_dim=64, has_two_hop=two_hop)
        assert got["typed_gnn"] and got["supported"] == want["supported"] == (not two_hop)


def test_megakernel_typed_gnn_column_matches_jax():
    """A direct ``fused_megakernel`` call on typed parameters and a one-hop
    batch (its plain version on the CPU): the GNN column is JAX's typed
    ``gnn_logits`` through a sigmoid."""
    from realtime_fraud_detection_tpu_torch.core.packing import pack_tree, unpack_tree
    from realtime_fraud_detection_tpu_torch.ensemble.combine import EnsembleParams
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import make_example_batch
    from realtime_fraud_detection_tpu_torch.utils.config import Config

    jm, tm = _typed_models()
    rng = np.random.default_rng(5)
    batch = make_example_batch(8, rng=rng)
    for f in ("user_feat", "merchant_feat", "user_neigh_feat", "merch_neigh_feat"):
        x = getattr(batch, f)          # one-hot type tags, users untagged
        x[..., 8:11] = np.eye(4, 3, -1, dtype=np.float32)[rng.integers(0, 4, x.shape[:-1])]
    host = batch
    blobs, spec = pack_tree(batch)
    batch = unpack_tree({k: torch.from_numpy(v) for k, v in blobs.items()}, spec)
    params = EnsembleParams.from_config(Config(), MODEL_NAMES)
    out = tmk.fused_megakernel(tm, batch, params, mega_valid=(True,) * 5,
                               bert_config=tbert.TINY_CONFIG)
    want = jax.nn.sigmoid(jgnn.gnn_logits(jm.gnn, *(getattr(host, f) for f in (
        "features", "user_feat", "merchant_feat", "user_neigh_feat", "user_neigh_mask",
        "merch_neigh_feat", "merch_neigh_mask"))))
    col = 8 + MODEL_NAMES.index("graph_neural")
    np.testing.assert_allclose(out.numpy()[:, col], np.asarray(want), rtol=0, atol=1e-6)


def test_megakernel_ffn_limit_matches_the_source_and_takes_the_protocol_encoder():
    """The quality-eval text model (FFN 512) is inside the kernel's limits,
    so its artifact and checkpoint serve through the megakernel."""
    import re
    from pathlib import Path

    from realtime_fraud_detection_tpu_torch.models.quant import quantize_bert_params

    text = (Path(tmk.__file__).parents[1] / "csrc" / "megakernel.cu").read_text()
    assert int(re.search(r"#define MEGA_MAX_FFN (\d+)", text).group(1)) == tmk.MEGA_MAX_FFN
    cfg = tbe.BlendEvalConfig().bert
    models = init_scoring_models(0, cfg, n_trees=4, tree_depth=3)
    models = dataclasses.replace(models, bert=quantize_bert_params(models.bert))
    plan = tmk.mega_plan(models, cfg, b=256, text_len=32, seq_len=10, feature_dim=64,
                         has_two_hop=False)
    assert plan["kernel_shapes"] and plan["supported"]
