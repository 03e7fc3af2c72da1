"""The PyTorch port's megakernel slice against the JAX package, on the CPU:
the shape plan and launch accounting, ``fused_megakernel`` (its plain
version here) against the JAX megakernel run through the Pallas
interpreter, the plain version against the per-site chain, the scorer's
kernel dispatch / fallback accounting against ``FraudScorer``'s, the
responses, and the C interface the CUDA kernel is bound through.

Tolerances: decision and risk ladders exact (the seed is checked to keep
every probability and confidence farther than the bound from a rung);
against JAX (the frameworks round bf16 at different places) probability and
confidence within the JAX kernel drill's measured bf16 noise bound for
these models, tokens and rung, each branch's prediction and contribution
within that branch's own bf16 gap on the JAX side, both floored at 1e-4
(``torch_bounds.py``); <= 1e-5 within the port at f32 compute; pruned
lanes exactly 0.
The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""

import torch_threads  # noqa: F401  (first: torch held to one CPU thread)
import ctypes
import dataclasses
import re
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from realtime_fraud_detection_tpu.ensemble.combine import (
    EnsembleParams as JaxEnsembleParams,
)
from realtime_fraud_detection_tpu.features.schema import (
    TransactionBatch as JaxTransactionBatch,
)
from realtime_fraud_detection_tpu.models import bert as jbert
from realtime_fraud_detection_tpu.models.isolation_forest import (
    IsolationForest as JaxIsolationForest,
)
from realtime_fraud_detection_tpu.models.quant import (
    quantize_bert_params as jax_quantize_bert_params,
)
from realtime_fraud_detection_tpu.models.trees import (
    TreeEnsemble as JaxTreeEnsemble,
)
from realtime_fraud_detection_tpu.ops import megakernel as jmk
from realtime_fraud_detection_tpu.scoring import pipeline as jax_pipeline
from realtime_fraud_detection_tpu.scoring.scorer import FraudScorer
from realtime_fraud_detection_tpu.utils.config import (
    VALID_KERNEL_SITES,
    Config as JaxConfig,
    KernelSettings as JaxKernelSettings,
)
from realtime_fraud_detection_tpu_torch import ops
from realtime_fraud_detection_tpu_torch.bridge import models_from_numpy
from realtime_fraud_detection_tpu_torch.core.packing import pack_tree, unpack_tree
from realtime_fraud_detection_tpu_torch.ensemble.combine import EnsembleParams
from realtime_fraud_detection_tpu_torch.models.bert import (
    DISTILBERT_BASE,
    TINY_CONFIG,
    BertConfig,
)
from realtime_fraud_detection_tpu_torch.models.isolation_forest import _c
from realtime_fraud_detection_tpu_torch.ops import megakernel as mk
from realtime_fraud_detection_tpu_torch.scoring.pipeline import (
    MODEL_NAMES,
    OUT_COLUMNS,
    ScoreBatch,
    ScorerConfig,
    ScoringModels,
    make_example_batch,
    packed_width,
    score_fused_packed,
)
from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
from realtime_fraud_detection_tpu_torch.utils.config import (
    VALID_KERNEL_SITES as PORT_KERNEL_SITES,
    Config,
    KernelSettings,
    QuantSettings,
)

from torch_bounds import branch_bounds, near_rung, noise_bound

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "realtime_fraud_detection_tpu_torch" / "csrc"
B = 16
FULL = (True,) * 5
NO_BERT = (True, True, False, True, True)
DEC, RISK = OUT_COLUMNS.index("decision"), OUT_COLUMNS.index("risk_level")
PRED = slice(len(OUT_COLUMNS), len(OUT_COLUMNS) + len(MODEL_NAMES))
SC = ScorerConfig()


def _to_jax_batch(batch: ScoreBatch):
    """The port's host batch as the JAX package's ScoreBatch (same arrays)."""
    fields = {f.name: getattr(batch, f.name)
              for f in dataclasses.fields(batch) if f.name != "txn"}
    return jax_pipeline.ScoreBatch(
        txn=JaxTransactionBatch(**vars(batch.txn)), **fields)


def _to_port_batch(batch: ScoreBatch) -> ScoreBatch:
    """Host numpy batch -> CPU tensors, through the packed wire format."""
    blobs, spec = pack_tree(batch)
    return unpack_tree({k: torch.from_numpy(v) for k, v in blobs.items()}, spec)


def _jax_models(bert_int8: bool):
    """JAX TINY model set at full width with random trees and forest (100
    trees of depth 6, 100 isolation trees of depth 8)."""
    rng = np.random.default_rng(23)
    models = jax_pipeline.init_scoring_models(jax.random.PRNGKey(23),
                                              jbert.TINY_CONFIG)
    trees = JaxTreeEnsemble(
        feature=rng.integers(0, 64, (100, 63)).astype(np.int32),
        threshold=rng.normal(0.5, 1.0, (100, 63)).astype(np.float32),
        leaf=rng.normal(0.0, 0.15, (100, 64)).astype(np.float32),
        base_score=np.float32(0.1))
    forest = JaxIsolationForest(
        feature=rng.integers(0, 64, (100, 255)).astype(np.int32),
        threshold=rng.normal(0.5, 1.0, (100, 255)).astype(np.float32),
        path_length=(8 + _c(256) * rng.random((100, 256))).astype(np.float32),
        c_psi=np.float32(_c(256)))
    models = models.replace(trees=trees, iforest=forest)
    if bert_int8:
        models = models.replace(
            bert=jax_quantize_bert_params(jax.device_get(models.bert)))
    return jax.tree_util.tree_map(np.asarray, models)


@pytest.fixture(scope="module")
def jax_models_q():
    return _jax_models(bert_int8=True)


@pytest.fixture(scope="module")
def jax_models_f32():
    return _jax_models(bert_int8=False)


@pytest.fixture(scope="module")
def batch():
    return make_example_batch(B, rng=np.random.default_rng(4))


def _jax_params():
    return JaxEnsembleParams.from_config(JaxConfig(), jax_pipeline.MODEL_NAMES)


def _port_params():
    return EnsembleParams.from_config(Config(), MODEL_NAMES)


# ------------------------------------------------------------- shape plan
def _act_row_bytes(bert_config, trees=100 * 64 + 100 * 256):
    return mk.mega_act_row_bytes(bert_config, text_len=SC.text_len,
                                 seq_len=SC.seq_len, feature_dim=SC.feature_dim,
                                 tree_onehot=trees)


def _plans(jax_models, port_models, b, two_hop=False):
    kw = dict(b=b, text_len=SC.text_len, seq_len=SC.seq_len,
              feature_dim=SC.feature_dim, has_two_hop=two_hop)
    return (jmk.mega_plan(jax_models, jbert.TINY_CONFIG, **kw),
            mk.mega_plan(port_models, TINY_CONFIG, **kw))


@pytest.mark.parametrize("b", [8, 32, 128, 256])
def test_plan_admits_tiny_int8_like_jax(jax_models_q, b):
    want, got = _plans(jax_models_q, models_from_numpy(jax_models_q), b)
    assert want["supported"] and got["supported"]
    for key in ("param_bytes", "has_two_hop"):
        assert got[key] == want[key]
    assert got["param_bytes"] == 5_334_976
    assert _act_row_bytes(jbert.TINY_CONFIG) == want["act_row_bytes"] == 294_656


@pytest.mark.parametrize("b, two_hop", [(1, False), (32, True)])
def test_plan_declines_like_jax(jax_models_q, b, two_hop):
    want, got = _plans(jax_models_q, models_from_numpy(jax_models_q), b, two_hop)
    assert not want["supported"] and not got["supported"]


def test_plan_admits_tiny_f32_where_jax_declines(jax_models_f32):
    # the documented difference: 17.9 MB of f32 parameters exceed the TPU
    # core's VMEM budget but sit well inside the H100's L2 budget
    want, got = _plans(jax_models_f32, models_from_numpy(jax_models_f32), 32)
    assert got["param_bytes"] == want["param_bytes"] == 17_907_160
    assert not want["supported"] and got["supported"]


def _shape_tree(tree, make):
    """Map a JAX ShapeDtypeStruct tree to ``make(shape, dtype)`` leaves."""
    return jax.tree_util.tree_map(lambda s: make(tuple(s.shape), s.dtype), tree)


def _quantized_shapes(bert, make):
    """The int8 layout of ``models/quant.py`` from an f32 BERT shape tree."""
    def dense(p):
        n = p["w"].shape[-1]
        return {"qw": make(p["w"].shape, np.int8), "scale": make((n,), np.float32),
                "b": p["b"]}

    def emb(t):
        return {"qe": make(t.shape, np.int8), "scale": make((t.shape[0],), np.float32)}

    out = dict(bert, word_emb=emb(bert["word_emb"]), pos_emb=emb(bert["pos_emb"]))
    out["layers"] = [dict(layer, **{s: dense(layer[s]) for s in mk.DENSE_SITES})
                     for layer in bert["layers"]]
    return out


@pytest.mark.parametrize("int8, param_bytes",
                         [(True, 70_095_552), (False, 268_709_848)])
def test_plan_declines_distilbert_like_jax(int8, param_bytes):
    shapes = jax.eval_shape(lambda k: jax_pipeline.init_scoring_models(
        k, jbert.BertConfig()), jax.random.PRNGKey(0))

    def meta(shape, dtype):
        return torch.empty(shape, dtype=getattr(torch, np.dtype(dtype).name),
                           device="meta")

    def sds(shape, dtype):
        return jax.ShapeDtypeStruct(shape, dtype)

    jax_models = shapes.replace(
        bert=_quantized_shapes(shapes.bert, sds)) if int8 else shapes
    port_tree = _shape_tree(jax_models, meta)
    port_models = ScoringModels(
        trees=port_tree.trees, iforest=port_tree.iforest, lstm=port_tree.lstm,
        gnn=port_tree.gnn, bert=port_tree.bert)
    kw = dict(b=256, text_len=SC.text_len, seq_len=SC.seq_len,
              feature_dim=SC.feature_dim, has_two_hop=False)
    want = jmk.mega_plan(jax_models, jbert.BertConfig(), **kw)
    got = mk.mega_plan(port_models, DISTILBERT_BASE, **kw)
    assert got["param_bytes"] == want["param_bytes"] == param_bytes
    trees = (port_models.trees.leaf.numel()
             + port_models.iforest.path_length.numel())
    assert _act_row_bytes(DISTILBERT_BASE, trees) == want["act_row_bytes"] == 1_507_072
    assert not want["supported"] and not got["supported"]
    assert not got["kernel_shapes"]       # hidden 768 > the kernel's 256 too


@pytest.mark.parametrize("mv", [FULL, NO_BERT, (True, False, False, False, True)])
def test_launch_accounting_matches_jax(mv):
    for b in (8, 256):
        assert mk.mega_launch_accounting(b, 5, mv) == \
            jmk.mega_launch_accounting(b, 5, mv)


def test_smem_layout_fits_one_cta_at_tiny(jax_models_q):
    port_models = models_from_numpy(jax_models_q)
    _, got = _plans(jax_models_q, port_models, 256)
    dims = mk._dims(port_models, TINY_CONFIG, SC.text_len, SC.feature_dim,
                    SC.seq_len)
    # f32 compute: x, q [64, 128]; k|v [64, 257]; scratch 32 x 256;
    # features, slots, mask
    f32 = 4 * (2 * 64 * 128 + 64 * 257 + 32 * 256 + 64 + 16 + 64)
    assert mk.mega_smem_bytes_f32(dims, SC.fanout) == f32 == 164_672

    def tc(rows):
        rs = rows * 64
        bert = (rs * 136 * 4                          # x f32 [R*S, H+8]
                + max(3 * rs * 130 * 2,               # q|k|v bf16 [R*S, H+2]
                      rs * 264 * 2 + rs * 130 * 2)    # FFN hidden + output
                + max(2 * 64 * 136 * 2,               # widened ring, or the
                      8 * ((64 + 64) * 8 + 128) * 4)  # attention scratch
                + 2 * 64 * 128)                       # raw ring
        lstm = (192 * 520 * 2 + rows * 192 * 4        # w_gates bf16, [x ; h]
                + rows * 10 * 64 * 4                  # the history
                + rows * (512 + 256 + 64) * 4)        # z, h|c, head
        tail = rows * (64 + 64 + 16 + 128) * 4        # features, mask, slots, [CLS]
        return max(bert, lstm) + tail

    # bf16 compute: one row is bounded by the staged LSTM weight, two rows
    # by BERT's region; the plan charges the one-row layout
    assert mk.mega_smem_bytes_tc(dims, SC.fanout, 1) == tc(1) == 207_424
    assert mk.mega_smem_bytes_tc(dims, SC.fanout, 2) == tc(2) == 225_920
    assert got["smem_bytes"] == tc(1) <= mk.MEGA_SMEM_LIMIT and got["kernel_shapes"]
    assert tc(2) <= mk.MEGA_SMEM_LIMIT < tc(3)       # so MEGA_MAX_ROWS is 2


# ------------------------------------------------------- parity with JAX
def _jax_mega(jax_models, batch, mv, block=None):
    return np.asarray(jmk.fused_megakernel(
        jax_models, _to_jax_batch(batch), _jax_params(), mega_valid=mv,
        bert_config=jbert.TINY_CONFIG, interpret=True, block=block))


def _port_mega(port_models, batch, mv, **kw):
    return mk.fused_megakernel(port_models, _to_port_batch(batch), _port_params(),
                               mega_valid=mv, bert_config=TINY_CONFIG, **kw).numpy()


def _assert_matches_jax(want, got, mv, jax_models, batch):
    assert got.shape == want.shape == (B, packed_width(5, epilogue=True))
    bound = noise_bound(jax_models.bert, [(batch.token_ids, batch.token_mask)],
                        _jax_params().weights, mv)
    branch = branch_bounds(jax_models, batch)
    for col in (0, 1):                    # probability, confidence
        assert not near_rung(want[:, col], bound).any()
    exact = [DEC, RISK, 4, 5, 6, 7, 18, 19]
    np.testing.assert_array_equal(got[:, exact], want[:, exact])
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=0, atol=bound)
    for j, tol in enumerate(branch):      # predictions, then contributions
        for col in (PRED.start + j, PRED.stop + j):
            np.testing.assert_allclose(got[:, col], want[:, col], rtol=0,
                                       atol=tol, err_msg=f"column {col}")
    for j, on in enumerate(mv):
        if not on:                        # a pruned lane is exactly zero
            assert not got[:, PRED][:, j].any() and not want[:, PRED][:, j].any()


@pytest.mark.parametrize("mv", [FULL, NO_BERT], ids=["full", "no_bert"])
def test_fused_megakernel_int8_matches_jax(jax_models_q, batch, mv):
    want = _jax_mega(jax_models_q, batch, mv)
    got = _port_mega(models_from_numpy(jax_models_q), batch, mv)
    _assert_matches_jax(want, got, mv, jax_models_q, batch)


def test_fused_megakernel_f32_params_explicit_block_matches_jax(
        jax_models_f32, batch):
    # the block is the TPU grid's tile; the CUDA kernel has none to set
    want = _jax_mega(jax_models_f32, batch, FULL, block=8)
    got = _port_mega(models_from_numpy(jax_models_f32), batch, FULL)
    _assert_matches_jax(want, got, FULL, jax_models_f32, batch)


def test_rules_only_rung_serves_the_rule_score(jax_models_q, batch):
    got = _port_mega(models_from_numpy(jax_models_q), batch, (False,) * 5)
    assert not got[:, PRED].any() and not got[:, 13:18].any()
    rule_col = OUT_COLUMNS.index("rule_score")
    want = _jax_mega(jax_models_q, batch, (False,) * 5)
    np.testing.assert_array_equal(got[:, rule_col], want[:, rule_col])
    np.testing.assert_array_equal(got[:, 18:20], want[:, 18:20])


# --------------------------------------------------------- port-internal
def test_reference_matches_the_chain_at_f32_compute(jax_models_q, batch):
    port_models = models_from_numpy(jax_models_q)
    got = _port_mega(port_models, batch, FULL, compute_dtype=torch.float32)
    blobs, spec = pack_tree(batch)
    chain = score_fused_packed(
        port_models, {k: torch.from_numpy(v) for k, v in blobs.items()}, spec,
        _port_params(), torch.ones(5, dtype=torch.bool), bert_config=TINY_CONFIG,
        compute_dtype=torch.float32, **QuantSettings.full().static(),
        **KernelSettings.full().static()).numpy()
    ladders = [DEC, RISK, 4, 5, 6, 7, 18, 19]
    np.testing.assert_array_equal(got[:, ladders], chain[:, ladders])
    np.testing.assert_allclose(got, chain, rtol=0, atol=1e-5)


def test_packed_dispatch_takes_the_megakernel_only_where_planned(
        mega_scorer, batch, monkeypatch):
    scorer = TorchFraudScorer(    # a scorer of its own: counters start at 0
        Config(quant=QuantSettings.full(), kernels=KernelSettings.mega()),
        models=mega_scorer.models, bert_config=TINY_CONFIG, device="cpu")
    calls = []
    real = mk.fused_megakernel_packed

    def spy(*args, **kw):
        calls.append(kw["mega_valid"])
        return real(*args, **kw)

    from realtime_fraud_detection_tpu_torch.scoring import pipeline
    monkeypatch.setattr(pipeline, "fused_megakernel_packed", spy)
    # the scorer reads its plan once per batch: bucket 8 carries the rung
    # down, bucket 1 carries None and runs the per-site chain
    assert scorer.kernel_static(8, np.asarray(FULL))["mega_valid"] == FULL
    assert scorer.kernel_static(1, np.asarray(FULL))["mega_valid"] is None
    for n, expect in ((8, [FULL]), (1, [FULL])):
        pending = scorer.dispatch_assembled(_sub_batch(batch, n), [{}] * n)
        assert pending.out.shape == (n, packed_width(5, epilogue=True))
        assert calls == expect
    kw = dict(bert_config=TINY_CONFIG, **QuantSettings.full().static(),
              **KernelSettings.mega().static())
    blobs, spec = pack_tree(batch)
    score_fused_packed(scorer.models,
                       {k: torch.from_numpy(v) for k, v in blobs.items()},
                       spec, _port_params(), torch.ones(5, dtype=torch.bool),
                       mega_valid=None, **kw)
    assert len(calls) == 1                    # no rung: the chain runs


def test_wrapper_refuses_what_the_kernel_cannot_take(jax_models_q):
    port_models = models_from_numpy(jax_models_q)
    eight = _to_port_batch(make_example_batch(8, rng=np.random.default_rng(0)))
    with pytest.raises(ValueError, match="mega_valid"):
        mk.fused_megakernel(port_models, eight, _port_params(),
                            mega_valid=(True,) * 4)
    one_head = dataclasses.replace(TINY_CONFIG, num_heads=1)   # head width 128
    with pytest.raises(ValueError, match="does not take"):
        mk.fused_megakernel(port_models, eight, _port_params(), mega_valid=FULL,
                            bert_config=one_head)
    two_hop = dataclasses.replace(eight, user_neigh2_feat=eight.user_neigh_feat)
    with pytest.raises(ValueError, match="does not take"):
        mk.fused_megakernel(port_models, two_hop, _port_params(), mega_valid=FULL)


def test_cpu_tensors_never_launch(jax_models_q, batch):
    ops.reset_launch_counts()
    _port_mega(models_from_numpy(jax_models_q), batch, FULL)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNEL_WRAPPERS}
    assert ops.KERNEL_WRAPPERS["megakernel"] is mk.fused_megakernel


def test_unpack_keep_u8_leaves_byte_views(batch):
    blobs, spec = pack_tree(batch)
    tb = {k: torch.from_numpy(v) for k, v in blobs.items()}
    raw, cast = unpack_tree(tb, spec, keep_u8=True), unpack_tree(tb, spec)
    assert raw.token_mask.dtype == torch.uint8 and cast.token_mask.dtype == torch.bool
    assert raw.token_mask.data_ptr() == tb["u8"].data_ptr() + raw.token_mask.storage_offset() \
        - tb["u8"].storage_offset()
    np.testing.assert_array_equal(raw.token_mask.numpy().astype(bool),
                                  cast.token_mask.numpy())
    np.testing.assert_array_equal(raw.history.numpy(), cast.history.numpy())


# ------------------------------------------------------- kernel settings
def test_kernel_settings_megakernel_site():
    mega = KernelSettings.mega()
    assert mega.site_modes() == {"dequant_matmul": "cuda", "epilogue": "cuda",
                                 "attention": "flash", "megakernel": "cuda"}
    assert mega.static()["megakernel"] == "cuda"
    assert KernelSettings.full().static()["megakernel"] == "off"
    assert KernelSettings().site_modes()["megakernel"] == "off"
    assert tuple(mega.site_modes()) == VALID_KERNEL_SITES == PORT_KERNEL_SITES
    with pytest.raises(ValueError, match="megakernel"):
        Config(kernels=KernelSettings(enabled=True, megakernel="pallas"))


# ------------------------------------------------------ scorer accounting
def _jax_stub(jax_models, mv):
    stub = SimpleNamespace(
        kernels=JaxKernelSettings.mega(), models=jax_models,
        bert_config=jbert.TINY_CONFIG, sc=jax_pipeline.ScorerConfig(),
        _sampler=None, _last_launches_per_batch=0,
        _kernel_counts={"dispatch": {s: 0 for s in VALID_KERNEL_SITES},
                        "fallback": {s: 0 for s in VALID_KERNEL_SITES}})
    stub._mega_plan = lambda size: FraudScorer._mega_plan(stub, size)
    stub.effective_model_valid = lambda: np.asarray(mv, bool)
    return stub


@pytest.fixture(scope="module")
def mega_scorer(jax_models_q):
    return TorchFraudScorer(
        Config(quant=QuantSettings.full(), kernels=KernelSettings.mega()),
        models=models_from_numpy(jax_models_q), bert_config=TINY_CONFIG,
        device="cpu")


def _sub_batch(batch, n):
    return dataclasses.replace(
        batch, txn=type(batch.txn)(**{k: v[:n] for k, v in vars(batch.txn).items()}),
        **{f.name: getattr(batch, f.name)[:n] for f in dataclasses.fields(batch)
           if f.name != "txn" and getattr(batch, f.name) is not None})


def test_scorer_kernel_accounting_matches_jax(jax_models_q, mega_scorer, batch):
    big = make_example_batch(20, rng=np.random.default_rng(5))
    stub = _jax_stub(jax_models_q, FULL)
    steps = ((big, 20, 32), (batch, 8, 8), (batch, 1, 1))
    for rows, n, size in steps:
        pending = mega_scorer.dispatch_assembled(
            _sub_batch(rows, n), [{"transaction_id": f"t{i}"} for i in range(n)])
        assert pending.out.shape == (size, packed_width(5, epilogue=True))
        mega_scorer.finalize(pending)
        FraudScorer._record_kernel_dispatch(stub, size)
        snap = mega_scorer.kernel_snapshot()
        assert snap["dispatch"] == stub._kernel_counts["dispatch"]
        assert snap["fallback"] == stub._kernel_counts["fallback"]
        assert snap["launches_per_batch"] == stub._last_launches_per_batch
        assert snap["kernel_launches"] == 0     # plain versions on the CPU
    snap = mega_scorer.kernel_snapshot()
    assert snap["dispatch"] == {"dequant_matmul": 1, "epilogue": 1,
                                "attention": 1, "megakernel": 3}
    assert snap["fallback"] == {"dequant_matmul": 0, "epilogue": 0,
                                "attention": 0, "megakernel": 1}
    assert snap["launches_per_batch"] == 7          # bucket 1: the chain
    assert snap["modes"]["megakernel"] == "cuda"


def test_kernel_static_carries_the_dispatch_rung(mega_scorer):
    assert mega_scorer.kernel_static(8)["mega_valid"] == FULL
    assert mega_scorer.kernel_static(8, np.asarray(NO_BERT))["mega_valid"] == NO_BERT
    off = TorchFraudScorer(Config(kernels=KernelSettings.full()), device="cpu",
                           seed=1)
    assert off.kernel_static(8)["mega_valid"] is None


@pytest.mark.parametrize("cfg, site", [
    (BertConfig(hidden_size=64, num_layers=1, num_heads=2, intermediate_size=128),
     "flash attention"),                      # head width 32
    (BertConfig(hidden_size=128, num_layers=1, num_heads=2, intermediate_size=160),
     "dequant_matmul"),                       # FFN 160: no whole 64-wide N tiles
], ids=["attention", "dequant_matmul"])
def test_scorer_refuses_widths_its_kernels_do_not_take(cfg, site):
    # the wrappers raise on such widths, so the scorer refuses them up front
    # instead of counting a fallback that never runs
    with pytest.raises(ValueError, match=site):
        TorchFraudScorer(
            Config(quant=QuantSettings.full(), kernels=KernelSettings.full()),
            bert_config=cfg, device="cpu", seed=2)


def test_scorer_counts_f32_weights_as_a_dequant_fallback(batch):
    scorer = TorchFraudScorer(Config(kernels=KernelSettings.full()),
                              device="cpu", seed=2)
    scorer.finalize(scorer.dispatch_assembled(_sub_batch(batch, 3), [{}] * 3))
    snap = scorer.kernel_snapshot()
    assert snap["dispatch"] == {"dequant_matmul": 1, "epilogue": 1,
                                "attention": 1, "megakernel": 0}
    assert snap["fallback"] == {"dequant_matmul": 1, "epilogue": 0,
                                "attention": 0, "megakernel": 0}
    assert snap["kernel_launches"] == 0       # the CPU runs the plain versions


# ---------------------------------------------------------------- responses
@pytest.mark.parametrize("rules_only", [False, True])
def test_mega_responses_match_jax(mega_scorer, batch, rules_only):
    n = 6                                   # pads to the 8-row bucket
    records = [{"transaction_id": f"t{i}"} for i in range(n)]
    mask = np.array([True, True, False, True, True])
    mega_scorer.set_degradation(mask, rules_only=rules_only)
    try:
        pending = mega_scorer.dispatch_assembled(_sub_batch(batch, n), records)
        got = mega_scorer.finalize(pending)
    finally:
        mega_scorer.set_degradation(None)
    assert mega_scorer.kernel_snapshot()["launches_per_batch"] == 1
    assert not pending.out[:, PRED][:, 2].any()      # BERT pruned by the rung
    stub = SimpleNamespace(model_valid=mask, ensemble_params=_jax_params(),
                           config=JaxConfig(), _top_importances=None)
    want = FraudScorer._build_responses(stub, records, pending.out.numpy(), n, 1.0,
                                        model_valid=mask, rules_only=rules_only)
    strip = [{k: v for k, v in r.items() if k != "processing_time_ms"}
             for r in got]
    assert strip == [{k: v for k, v in r.items() if k != "processing_time_ms"}
                     for r in want]


# -------------------------------------------------------- the C interface
def _c_block(text: str, head: str) -> str:
    start = text.index(head)
    return text[start:text.index("};", start)]


def test_input_enum_matches_the_python_order():
    text = (CSRC / "megakernel.cu").read_text()
    names = re.findall(r"^\s*IN_(\w+),", _c_block(text, "enum MegaInput"), re.M)
    assert [n.lower() for n in names] == [name for name, _ in mk.MEGA_INPUTS]


def test_args_struct_matches_ctypes():
    text = (CSRC / "megakernel.cu").read_text()
    fields = re.findall(r"^\s*(?:const\s+)?(?:void\*|int|float|long long)\s+(\w+)",
                        _c_block(text, "struct MegaArgs {"), re.M)
    assert fields == [name for name, _ in mk.MegaArgs._fields_]
    assert ctypes.sizeof(mk.MegaArgs) <= 4096    # the C static_assert


def test_kernel_limits_match_the_python_plan():
    text = (CSRC / "megakernel.cu").read_text()
    for name in ("MEGA_KC", "MEGA_NP", "MEGA_KC_F32", "MEGA_MAX_ROWS", "MEGA_ATT_Q",
                 "MEGA_NUM_MODELS", "MEGA_MAX_LAYERS", "MEGA_MAX_TEXT",
                 "MEGA_MAX_WIDTH", "MEGA_MAX_HEAD_DIM", "MEGA_MAX_LSTM",
                 "MEGA_SMEM_LIMIT"):
        value = re.search(rf"#define {name} (\d+)", text).group(1)
        assert int(value) == getattr(mk, name), name
    assert re.search(r"#define MEGA_THREADS (\d+)", text).group(1) == \
        str(32 * mk.MEGA_WARPS)


def test_megakernel_module_is_in_the_isolation_checks():
    # test_torch_pipeline's no-JAX checks take every port module by rglob
    port = ROOT / "realtime_fraud_detection_tpu_torch"
    assert port / "ops" / "megakernel.py" in set(port.rglob("*.py"))
    assert 'PORT.rglob("*.py")' in (ROOT / "tests" / "test_torch_pipeline.py").read_text()


# ------------------------------------- tensor-core dense, emulated on the CPU
# csrc/megakernel.cu dense_tc and lstm_tc issue mma.sync.m16n8k16 (bf16 in,
# f32 accumulate) with A fragments built from shared memory by load_a and B
# fragments loaded by ldmatrix.x4.trans (ldsm_b_pair). The emulation below
# follows those fragment maps lane by lane, with the kernel's warp split,
# passes and weight chunks, and must reproduce matmul_cd: the same
# bf16-rounded operands, f32 sums in another order, one bf16 rounding.
_LANES = np.arange(32)
_G, _T = _LANES >> 2, _LANES & 3
# register r of lane l holds the pair (row, col) and (row, col + 1)
_A_MAP = [(_G, 2 * _T), (_G + 8, 2 * _T), (_G, 2 * _T + 8), (_G + 8, 2 * _T + 8)]
_C_MAP = [(_G, 2 * _T), (_G + 8, 2 * _T)]                  # c0,c1 and c2,c3
# B (k x n): register r of lane l holds (k, n) and (k + 1, n)
_B_MAP = [(2 * _T, _G), (2 * _T + 8, _G)]


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _load_a(x, m, step, r0, k0):
    """load_a: per lane four registers, each an (even, odd) column pair."""
    regs = np.zeros((32, 4, 2), np.float32)
    for r, (rows, cols) in enumerate(_A_MAP):
        rows = rows + r0
        ok = rows < m
        for e in range(2):
            regs[ok, r, e] = x[rows[ok] * step, k0 + cols[ok] + e]
    return _bf16(regs)


def _ldsm_b_pair(tile, k0, n0):
    """ldmatrix.x4.trans over a [k][n] tile: lane l addresses row l & 7 of
    matrix l >> 3 (k half (l >> 3) & 1, n half l >> 4); after the transpose
    lane l receives, from each matrix, column l >> 2 at rows 2(l & 3) and
    2(l & 3) + 1."""
    mats = [tile[k0 + (mi & 1) * 8:k0 + (mi & 1) * 8 + 8,
                 n0 + (mi >> 1) * 8:n0 + (mi >> 1) * 8 + 8] for mi in range(4)]
    return np.stack([np.stack([mat[2 * _T, _G], mat[2 * _T + 1, _G]], axis=-1)
                     for mat in mats], axis=1)             # [32, 4 regs, 2]


def _mma(acc, a, b0, b1):
    """mma.sync.m16n8k16: assemble A [16, 16] and B [16, 8] from the lanes'
    registers (every element exactly once), D += A @ B in f32, scatter."""
    A = np.full((16, 16), np.nan, np.float32)
    B = np.full((16, 8), np.nan, np.float32)
    for r, (rows, cols) in enumerate(_A_MAP):
        A[rows, cols], A[rows, cols + 1] = a[:, r, 0], a[:, r, 1]
    for r, (ks, ns) in enumerate(_B_MAP):
        bb = (b0, b1)[r]
        B[ks, ns], B[ks + 1, ns] = bb[:, 0], bb[:, 1]
    assert not np.isnan(A).any() and not np.isnan(B).any()
    D = (A.astype(np.float32) @ B.astype(np.float32)).astype(np.float32)
    for h, (rows, cols) in enumerate(_C_MAP):
        acc[:, 2 * h] += D[rows, cols]
        acc[:, 2 * h + 1] += D[rows, cols + 1]


def _store_c(y, acc, m, step, r0, n):
    for h, (rows, cols) in enumerate(_C_MAP):
        rows = rows + r0
        ok = rows < m
        for e in range(2):
            y[rows[ok] * step, n + cols[ok] + e] = _bf16(acc[ok, 2 * h + e])


def _emulate_dense_tc(x, w, m, step):
    """dense_tc: passes of MEGA_NP columns, chunks of MEGA_KC rows widened
    into a [k][n] tile, 2 x 4 or 1 x 8 warps, up to 4 row tiles a warp."""
    k, n = w.shape
    y = np.full((x.shape[0], n), np.nan, np.float32)
    m_tiles = -(-m // 16)
    wm_n = 2 if m_tiles >= 2 else 1
    n_per_warp = mk.MEGA_NP // (mk.MEGA_WARPS // wm_n)
    for n0 in range(0, n, mk.MEGA_NP):
        np_ = min(mk.MEGA_NP, n - n0)
        acc = np.zeros((mk.MEGA_WARPS, 4, 4, 32, 4), np.float32)
        for k0 in range(0, k, mk.MEGA_KC):
            wide = _bf16(w[k0:k0 + mk.MEGA_KC, n0:n0 + np_])
            for warp in range(mk.MEGA_WARPS):
                wm, wn = warp % wm_n, warp // wm_n
                nb = wn * n_per_warp
                if nb >= np_:
                    continue
                for ks in range(0, wide.shape[0], 16):
                    for jp in range(n_per_warp // 16):
                        b = _ldsm_b_pair(wide, ks, nb + 16 * jp)
                        for i in range(4):
                            mt = wm + wm_n * i
                            if mt >= m_tiles:
                                continue
                            a = _load_a(x, m, step, mt * 16, k0 + ks)
                            _mma(acc[warp, i, 2 * jp], a, b[:, 0], b[:, 1])
                            _mma(acc[warp, i, 2 * jp + 1], a, b[:, 2], b[:, 3])
        for warp in range(mk.MEGA_WARPS):
            wm, wn = warp % wm_n, warp // wm_n
            nb = wn * n_per_warp
            if nb >= np_:
                continue
            for i in range(4):
                mt = wm + wm_n * i
                if mt < m_tiles:
                    for j in range(n_per_warp // 8):
                        _store_c(y, acc[warp, i, j], m, step, mt * 16, n0 + nb + 8 * j)
    return y


def _emulate_lstm_gates(x, w, m):
    """lstm_tc: the rows in one 16-row tile, warp w taking 16-column pairs
    w, w + 8, ... over the whole K."""
    k, n = w.shape
    wide = _bf16(w)
    y = np.full((m, n), np.nan, np.float32)
    for warp in range(mk.MEGA_WARPS):
        for pair in range(warp, n // 16, mk.MEGA_WARPS):
            acc = np.zeros((2, 32, 4), np.float32)
            for k0 in range(0, k, 16):
                a = _load_a(x, m, 1, 0, k0)
                b = _ldsm_b_pair(wide, k0, pair * 16)
                _mma(acc[0], a, b[:, 0], b[:, 1])
                _mma(acc[1], a, b[:, 2], b[:, 3])
            for j in range(2):
                _store_c(y, acc[j], m, 1, 0, pair * 16 + 8 * j)
    return y


@pytest.mark.parametrize("k, n, rows, site", [
    (128, 128, 1, "dense"), (128, 128, 64, "dense"), (128, 128, 128, "dense"),
    (128, 256, 1, "dense"), (128, 256, 64, "dense"), (128, 256, 128, "dense"),
    (256, 128, 1, "dense"), (256, 128, 64, "dense"), (256, 128, 128, "dense"),
    (256, 256, 128, "dense"), (128, 128, 2, "cls"), (192, 512, 2, "lstm"),
])
def test_tensor_core_fragment_mapping_reproduces_matmul_cd(k, n, rows, site):
    from realtime_fraud_detection_tpu_torch.core.precision import matmul_cd

    rng = np.random.default_rng(k + n + rows)
    step = 64 if site == "cls" else 1      # [CLS] rows sit S rows apart
    x = rng.standard_normal((rows * step, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    got = (_emulate_lstm_gates(x, w, rows) if site == "lstm"
           else _emulate_dense_tc(x, w, rows, step))[::step][:rows]
    want = matmul_cd(torch.from_numpy(x[::step][:rows]), torch.from_numpy(w),
                     torch.bfloat16).numpy()
    assert not np.isnan(got).any()         # every output written once
    # the sums run in another order: at most one bf16 ulp apart
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp).all()
    assert np.mean(got == want) > 0.97


# ------------------------------------------------ the wrapper's host side
def test_parameter_args_are_cached_per_models_and_rebuilt_on_set_models(
        jax_models_q, batch, monkeypatch):
    scorer = TorchFraudScorer(
        Config(quant=QuantSettings.full(), kernels=KernelSettings.mega()),
        models=models_from_numpy(jax_models_q), bert_config=TINY_CONFIG,
        device="cpu")
    from realtime_fraud_detection_tpu_torch.scoring import pipeline

    passed = []
    real = mk.fused_megakernel_packed

    def spy(*args, **kw):
        passed.append(kw["param_args"])
        return real(*args, **kw)

    monkeypatch.setattr(pipeline, "fused_megakernel_packed", spy)
    for n in (8, 6):                       # two megakernel batches
        scorer.finalize(scorer.dispatch_assembled(_sub_batch(batch, n), [{}] * n))
    first = passed[0]
    assert passed[1] is first              # built once, reused
    assert first.models is scorer.models
    assert first.args.lstm_w_gates == scorer.models.lstm["w_gates"].data_ptr()
    old_ptr = first.args.dense_w[0][0]
    scorer.set_models(models_from_numpy(_jax_models(bert_int8=False)))
    scorer.finalize(scorer.dispatch_assembled(_sub_batch(batch, 8), [{}] * 8))
    second = passed[2]
    assert second is not first             # new models: rebuilt
    # (the scorer quantizes the new f32 weights, so the layout stays int8)
    assert second.args.dense_w[0][0] == scorer.models.bert["layers"][0]["q"]["qw"].data_ptr()
    assert second.args.dense_w[0][0] != old_ptr and second.args.int8 == 1
    # arguments built from other models, or for another compute dtype,
    # are refused rather than launched with their pointers
    eight = _to_port_batch(make_example_batch(8, rng=np.random.default_rng(0)))
    for stale, cd in ((first, torch.bfloat16), (second, torch.float32)):
        with pytest.raises(ValueError, match="param_args"):
            mk.fused_megakernel(scorer.models, eight, _port_params(), mega_valid=FULL,
                                bert_config=TINY_CONFIG, compute_dtype=cd,
                                param_args=stale)


@pytest.mark.parametrize("rows", [8, 32])
def test_packed_entry_points_into_the_blobs_like_unpack(jax_models_q, rows):
    port_models = models_from_numpy(jax_models_q)
    host = make_example_batch(rows, rng=np.random.default_rng(rows))
    blobs, spec = pack_tree(host)
    tb = {k: torch.from_numpy(v) for k, v in blobs.items()}
    cols, widths = mk._packed_layout(spec)
    assert widths == (SC.text_len, SC.feature_dim, SC.seq_len, SC.fanout)
    raw = unpack_tree(tb, spec, keep_u8=True)
    for (name, _), (blob, offset) in zip(mk.MEGA_INPUTS, cols):
        leaf = mk._batch_field(raw, name)
        t = tb[blob]
        assert leaf.data_ptr() == t.data_ptr() + offset * t.element_size(), name
        assert leaf.stride(0) == t.stride(0), name
    got = mk.fused_megakernel_packed(port_models, tb, spec, _port_params(),
                                     mega_valid=FULL, bert_config=TINY_CONFIG)
    want = mk.fused_megakernel(port_models, unpack_tree(tb, spec), _port_params(),
                               mega_valid=FULL, bert_config=TINY_CONFIG)
    assert torch.equal(got, want)
    two_hop = dataclasses.replace(host, user_neigh2_feat=host.user_neigh_feat)
    with pytest.raises(ValueError, match="two-hop"):
        mk._packed_layout(pack_tree(two_hop)[1])


def test_phase_profiler_stamps_every_phase_of_the_kernel(monkeypatch):
    # megakernel_phases.py labels the kernel's MEGA_PHASE() stamps: group
    # start, before/after the LSTM, after the GNN, after BERT, the
    # embeddings' LN, and per layer 6 dense + attention + 2 LN (in the loop)
    monkeypatch.syspath_prepend(str(ROOT))
    import megakernel_phases as mp

    from realtime_fraud_detection_tpu_torch.ops import build

    src = (CSRC / "megakernel.cu").read_text()
    assert src.count("MEGA_PHASE();") == 6 + len(mp.LAYER_PHASES)
    one_layer = mp.phase_labels(1)
    assert len(one_layer) + 1 == 6 + len(mp.LAYER_PHASES)
    assert len(mp.phase_labels(TINY_CONFIG.num_layers)) == len(one_layer) + len(mp.LAYER_PHASES)
    # the stamps and their reader exist only in the MEGA_PHASES build, which
    # the package's build hashes, compiles and caches apart from the plain one
    assert re.search(r"#ifdef MEGA_PHASES\s+// Copies the phase stamps", src)
    assert re.search(r"#ifndef MEGA_ATT_Q\s+#define MEGA_ATT_Q \d+", src)
    assert build.source_hash(("MEGA_PHASES",)) != build.source_hash()
    assert build._flags(("MEGA_PHASES", "MEGA_ATT_Q=4"))[-2:] == ["-DMEGA_PHASES",
                                                                  "-DMEGA_ATT_Q=4"]
