"""The PyTorch port's megakernel slice against the JAX package, on the CPU:
the shape plan and launch accounting, ``fused_megakernel`` (its plain
version here) against the JAX megakernel run through the Pallas
interpreter, the plain version against the per-site chain, the scorer's
kernel dispatch / fallback accounting against ``FraudScorer``'s, the
responses, and the C interface the CUDA kernel is bound through.

Tolerances: decision and risk ladders exact (the seed is checked to keep
every probability and confidence farther than the bound from a rung),
probability <= 2e-3 against JAX (the frameworks round bf16 at different
places), <= 1e-5 within the port at f32 compute; pruned lanes exactly 0.
The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""

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

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "realtime_fraud_detection_tpu_torch" / "csrc"
SERVED_BF16_TOL = 2e-3
RUNGS = (0.3, 0.6, 0.8, 0.95, 0.7)      # risk + decision rungs, confidence
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
    _, got = _plans(jax_models_q, models_from_numpy(jax_models_q), 256)
    # x, q [64, 128]; k|v [64, 257]; scratch 32 x 256; features, slots, mask
    assert got["smem_bytes"] == 4 * (2 * 64 * 128 + 64 * 257 + 32 * 256 + 64 + 16 + 64)
    assert got["smem_bytes"] <= mk.MEGA_SMEM_LIMIT and got["kernel_shapes"]


# ------------------------------------------------------- parity with JAX
def _jax_mega(jax_models, batch, mv, block=None):
    return np.asarray(jmk.fused_megakernel(
        jax_models, _to_jax_batch(batch), _jax_params(), mega_valid=mv,
        bert_config=jbert.TINY_CONFIG, interpret=True, block=block))


def _port_mega(port_models, batch, mv, **kw):
    return mk.fused_megakernel(port_models, _to_port_batch(batch), _port_params(),
                               mega_valid=mv, bert_config=TINY_CONFIG, **kw).numpy()


def _assert_matches_jax(want, got, mv):
    assert got.shape == want.shape == (B, packed_width(5, epilogue=True))
    for col in (0, 1):                    # probability, confidence
        gap = np.min(np.abs(want[:, col][:, None] - np.asarray(RUNGS)[None, :]))
        assert gap > SERVED_BF16_TOL
    ladders = [DEC, RISK, 4, 5, 6, 7, 18, 19]
    np.testing.assert_array_equal(got[:, ladders], want[:, ladders])
    np.testing.assert_allclose(got, want, rtol=0, atol=SERVED_BF16_TOL)
    for j, on in enumerate(mv):
        if not on:                        # a pruned lane is exactly zero
            assert not got[:, PRED][:, j].any() and not want[:, PRED][:, j].any()


@pytest.mark.parametrize("mv", [FULL, NO_BERT], ids=["full", "no_bert"])
def test_fused_megakernel_int8_matches_jax(jax_models_q, batch, mv):
    want = _jax_mega(jax_models_q, batch, mv)
    got = _port_mega(models_from_numpy(jax_models_q), batch, mv)
    _assert_matches_jax(want, got, mv)


def test_fused_megakernel_f32_params_explicit_block_matches_jax(
        jax_models_f32, batch):
    # the block is the TPU grid's tile; the CUDA kernel has none to set
    want = _jax_mega(jax_models_f32, batch, FULL, block=8)
    got = _port_mega(models_from_numpy(jax_models_f32), batch, FULL)
    _assert_matches_jax(want, got, FULL)


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
    real = mk.fused_megakernel

    def spy(*args, **kw):
        calls.append(kw["mega_valid"])
        return real(*args, **kw)

    from realtime_fraud_detection_tpu_torch.scoring import pipeline
    monkeypatch.setattr(pipeline, "fused_megakernel", spy)
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
    for name in ("MEGA_KC", "MEGA_NUM_MODELS", "MEGA_MAX_LAYERS",
                 "MEGA_MAX_TEXT", "MEGA_MAX_WIDTH", "MEGA_MAX_HEAD_DIM",
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
