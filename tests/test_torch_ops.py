"""The PyTorch port's kernel modules against the JAX package's Pallas
kernels (run through the Pallas interpreter), on the CPU.

On the CPU each port wrapper runs its plain PyTorch version; the CUDA
kernels themselves are held against those plain versions on the card by
``chip_smoke.py``. Tolerances are the reference's own (docs/kernels.md):
epilogue ladders exact and probabilities <= 1e-6, attention <= 5e-5,
f32 dequant-matmul <= 1e-5 relative, bf16 within one bf16 ulp of the output
scale, dequant_rows bit-exact.
"""

import torch_threads  # noqa: F401  (first: torch held to one CPU thread)
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_fraud_detection_tpu.ensemble.combine import (
    EnsembleParams as JaxEnsembleParams,
)
from realtime_fraud_detection_tpu.models.quant import (
    quantize_dense as jax_quantize_dense,
    quantize_embedding as jax_quantize_embedding,
)
from realtime_fraud_detection_tpu.ops import (
    dequant_matmul as jax_dequant_matmul,
    dequant_rows as jax_dequant_rows,
    epilogue_reference as jax_epilogue_reference,
    flash_attention as jax_flash_attention,
    fused_epilogue as jax_fused_epilogue,
)
from realtime_fraud_detection_tpu.scoring.pipeline import MODEL_NAMES
from realtime_fraud_detection_tpu.utils.config import Config as JaxConfig
from realtime_fraud_detection_tpu_torch import ops
from realtime_fraud_detection_tpu_torch.ensemble.combine import EnsembleParams
from realtime_fraud_detection_tpu_torch.models.bert import (
    DISTILBERT_BASE,
    TINY_CONFIG,
    bert_layer,
    init_bert_params,
)
from realtime_fraud_detection_tpu_torch.ops.attention import (
    HEAD_DIM,
    MAX_SEQ,
    attention_reference,
    attention_supported,
    flash_attention,
)
from realtime_fraud_detection_tpu_torch.ops.dequant_matmul import (
    dequant_matmul,
    dequant_rows,
    matmul_supported,
    rows_supported,
)
from realtime_fraud_detection_tpu_torch.ops.epilogue import (
    MAX_EPILOGUE_MODELS,
    EpilogueArgs,
    combine_matrix,
    epilogue_args,
    epilogue_matrix,
    epilogue_packed,
    packed_columns,
    fused_epilogue,
)
from realtime_fraud_detection_tpu_torch.utils.config import Config

BF16_ULP = 2.0 ** -7
CSRC = Path(__file__).resolve().parents[1] / "realtime_fraud_detection_tpu_torch" / "csrc"


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _params(strategy: int):
    jp = JaxEnsembleParams.from_config(JaxConfig(), MODEL_NAMES).replace(
        strategy=strategy)
    tp = EnsembleParams.from_config(Config(), MODEL_NAMES)
    tp.strategy = strategy
    return jp, tp


# --------------------------------------------------------------- epilogue
@pytest.mark.parametrize("strategy", [0, 1, 2])
def test_epilogue_matches_pallas(strategy):
    rng = np.random.default_rng(11 + strategy)
    b, m = 32, len(MODEL_NAMES)
    preds = rng.random((b, m)).astype(np.float32)
    valid = rng.random((b, m)) < 0.8
    valid[0] = False                              # a row with no branch
    valid[1] = [False, False, True, False, False]  # a QoS-style rung
    rule = rng.random(b).astype(np.float32)
    jp, tp = _params(strategy)
    want = jax_fused_epilogue(jnp.asarray(preds), jnp.asarray(valid),
                              jnp.asarray(rule), jp, interpret=True)
    got = fused_epilogue(_t(preds), _t(valid), _t(rule), tp)
    for key in ("decision", "risk_level", "rule_decision", "rule_risk"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    for key in ("fraud_probability", "confidence", "model_contributions"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-6)


def test_epilogue_matrix_layout_and_launch_count_on_cpu():
    rng = np.random.default_rng(3)
    preds = _t(rng.random((8, 5)).astype(np.float32))
    valid = torch.ones(5, dtype=torch.bool)
    rule = _t(rng.random(8).astype(np.float32))
    _, tp = _params(0)
    ops.reset_launch_counts()
    mat = epilogue_matrix(preds, valid, rule, tp)
    assert mat.shape == (8, 5 + 6)
    # the CPU runs the plain version: no kernel was launched
    assert ops.launch_counts() == {name: 0 for name in ops.KERNEL_WRAPPERS}
    torch.testing.assert_close(mat[:, 4:9], tp.weights[None, :] * preds)
    ref = combine_matrix(preds, torch.ones_like(preds), rule[:, None],
                         tp.weights[None, :], tp.confidence_multipliers[None, :],
                         strategy=0, fraud_threshold=0.5,
                         confidence_threshold=0.7, decline=0.95, review=0.8,
                         monitor=0.6)
    torch.testing.assert_close(mat, ref, rtol=0, atol=0)


def test_epilogue_rejects_empty_batch():
    _, tp = _params(0)
    with pytest.raises(ValueError, match="unsupported"):
        epilogue_matrix(torch.zeros((0, 5)), torch.ones(5, dtype=torch.bool),
                        torch.zeros(0), tp)


@pytest.mark.parametrize("b", [1, 37, 256])
@pytest.mark.parametrize("strategy", [0, 1, 2])
def test_packed_epilogue_matches_pallas(strategy, b):
    """The packed entry's columns (validity from the rung's host flags and
    one byte a row) against the JAX kernel (interpret mode) and its XLA
    reference under the same mask."""
    rng = np.random.default_rng(100 * strategy + b)
    m = len(MODEL_NAMES)
    preds = rng.random((b, m)).astype(np.float32)
    rule = rng.random(b).astype(np.float32)
    row_valid = rng.random(b) < 0.9                   # bucket padding rows
    rung = (True, True, False, True, True)             # BERT dropped
    valid = row_valid[:, None] & np.asarray(rung)[None, :]
    jp, tp = _params(strategy)
    got = epilogue_packed(_t(preds), _t(rule), tp, model_valid=rung,
                          row_valid=_t(row_valid)).numpy()
    cols = packed_columns(m)
    assert got.shape == (b, 8 + 2 * m + 2)
    np.testing.assert_array_equal(got[:, cols["rule_score"]][:, 0], rule)
    np.testing.assert_array_equal(got[:, cols["model_predictions"]], preds)
    assert not got[:, cols["key_factors"]].any()    # the caller's columns
    for want in (jax_fused_epilogue(jnp.asarray(preds), jnp.asarray(valid),
                                    jnp.asarray(rule), jp, interpret=True),
                 jax_epilogue_reference(jnp.asarray(preds), jnp.asarray(valid),
                                        jnp.asarray(rule), jp)):
        want = {k: np.asarray(v) for k, v in want.items()}
        for j, key in ((2, "decision"), (3, "risk_level")):
            np.testing.assert_array_equal(got[:, j], want[key])
        np.testing.assert_array_equal(got[:, cols["rule_ladder"]],
                                      np.stack([want["rule_decision"],
                                                want["rule_risk"]], axis=1))
        for j, key in ((0, "fraud_probability"), (1, "confidence")):
            np.testing.assert_allclose(got[:, j], want[key], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[:, cols["model_contributions"]],
                                   want["model_contributions"], rtol=0, atol=1e-6)


def test_epilogue_args_carry_weights_and_multipliers_by_value():
    _, tp = _params(2)
    tp.fraud_threshold = 0.45
    a = epilogue_args(tp, 5)
    assert (a.M, a.strategy) == (5, 2)
    np.testing.assert_array_equal(np.array(a.w[:5], np.float32), tp.weights.numpy())
    np.testing.assert_array_equal(np.array(a.cm[:5], np.float32),
                                  tp.confidence_multipliers.numpy())
    assert list(a.w[5:]) == list(a.cm[5:]) == [0.0] * (MAX_EPILOGUE_MODELS - 5)
    assert (a.fraud_threshold, a.confidence_threshold) == (np.float32(0.45),
                                                           np.float32(0.7))
    assert (a.decline, a.review, a.monitor) == (np.float32(0.95), np.float32(0.8),
                                                np.float32(0.6))
    # new weights are read again (the host copy is keyed by the tensors)
    tp.weights = tp.weights * 2
    assert a.w[0] * 2 == epilogue_args(tp, 5).w[0]


def test_epilogue_args_follow_weights_replaced_twice_between_calls():
    """The host copy is held with the tensors themselves: a tensor that
    replaces another, even one that could reuse a freed tensor's address at
    the same version counter, or an in-place write, is read again."""
    _, tp = _params(0)
    w0, cm0 = tp.weights.clone(), tp.confidence_multipliers.clone()
    epilogue_args(tp, 5)
    tp.weights = w0 * 2                  # replaced, then replaced again
    tp.weights = w0 * 3                  # before the next call
    tp.confidence_multipliers = cm0 * 0.5
    a = epilogue_args(tp, 5)
    np.testing.assert_array_equal(np.array(a.w[:5], np.float32), (w0 * 3).numpy())
    np.testing.assert_array_equal(np.array(a.cm[:5], np.float32), (cm0 * 0.5).numpy())
    tp.weights.mul_(2)                   # in place: same tensor, new version
    np.testing.assert_array_equal(np.array(epilogue_args(tp, 5).w[:5], np.float32),
                                  (w0 * 6).numpy())


def test_epilogue_kernel_specialises_the_served_model_count():
    """The kernel's compile-time instance is the served ensemble's width;
    every other width up to the struct's runs the generic instance."""
    text = (CSRC / "epilogue.cu").read_text()
    assert re.search(rf"EPI_SERVED_M = {len(MODEL_NAMES)};", text)
    assert len(re.findall(r"epilogue_packed_kernel<[^>]+><<<", text)) == 2


def test_epilogue_args_struct_matches_the_kernel_source():
    text = (CSRC / "epilogue.cu").read_text()
    body = text[text.index("struct EpilogueArgs {"):]
    body = body[:body.index("};")]
    body = re.sub(r"//[^\n]*", "", body)
    names = re.findall(r"(\w+)(?:\[\w+\])?\s*[,;]", body)
    assert names == [name for name, _ in EpilogueArgs._fields_]
    assert re.search(rf"EPI_MAX_M = {MAX_EPILOGUE_MODELS};", text)


def test_epilogue_refuses_more_models_than_the_kernel_carries():
    b, m = 4, MAX_EPILOGUE_MODELS + 1
    tp = EnsembleParams(weights=torch.full((m,), 1.0 / m),
                        confidence_multipliers=torch.ones(m))
    with pytest.raises(ValueError, match="unsupported epilogue shape"):
        epilogue_packed(torch.rand(b, m), torch.rand(b), tp)
    with pytest.raises(ValueError, match="models"):
        epilogue_args(tp, m)
    with pytest.raises(ValueError, match="unsupported"):
        epilogue_matrix(torch.rand(b, m), torch.ones(m, dtype=torch.bool),
                        torch.rand(b), tp)


# -------------------------------------------------------------- attention
@pytest.mark.parametrize("seed", [0, 1])
def test_attention_matches_pallas_flash(seed):
    rng = np.random.default_rng(seed)
    b, h, s, d = 2, 2, 64, 64
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32)
               for _ in range(3))
    mask = np.arange(s)[None, :] < rng.integers(1, s + 1, b)[:, None]
    mask[-1] = False                              # a fully masked row
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(mask), interpret=True)
    got = flash_attention(_t(q), _t(k), _t(v), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=5e-5)
    # the fully masked row averages all values uniformly, as the kernel does
    np.testing.assert_allclose(got[-1].numpy(),
                               np.broadcast_to(v[-1].mean(axis=1, keepdims=True),
                                               v[-1].shape), atol=1e-5)


def test_attention_reference_takes_strided_views():
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((2, 64, 128)).astype(np.float32))
    view = x.reshape(2, 64, 2, 64).permute(0, 2, 1, 3)
    mask = torch.ones((2, 64), dtype=torch.bool)
    torch.testing.assert_close(flash_attention(view, view, view, mask),
                               attention_reference(view.contiguous(),
                                                   view.contiguous(),
                                                   view.contiguous(), mask))


def test_attention_guard():
    x = torch.zeros((1, 2, 64, 32))
    with pytest.raises(ValueError, match="D=64"):
        flash_attention(x, x, x)


def _tf32(x):
    """Round f32 to TF32 as ``cvt.rna.tf32.f32`` does: 10 mantissa bits,
    ties away from zero, low 13 bits cleared."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _mm_tf32(a, b, split):
    """a @ b on TF32 tensor cores: products of TF32 operands are exact in
    f32; ``split`` adds the 3xTF32 correction terms (small = tf32(x - big))."""
    ab, bb = _tf32(a), _tf32(b)
    out = np.matmul(ab, bb, dtype=np.float32)
    if split:
        a_small, b_small = _tf32(a - ab), _tf32(b - bb)
        out = (np.matmul(a_small, bb, dtype=np.float32)
               + np.matmul(ab, b_small, dtype=np.float32) + out)
    return out


def _emulated_attention(q, k, v, mask, split):
    """The CUDA kernel's arithmetic for one 64-key block: scaled q, both
    products in (3x)TF32, masked scores at -1e30, f32 softmax state."""
    d = q.shape[-1]
    scores = _mm_tf32(q * np.float32(1.0 / np.sqrt(d)), np.swapaxes(k, -1, -2), split)
    scores = np.where(mask[:, None, None, :], scores, np.float32(-1e30))
    m = np.maximum(scores.max(axis=-1, keepdims=True), np.float32(-1e30))
    p = np.exp(scores - m).astype(np.float32)
    denom = np.maximum(p.sum(axis=-1, keepdims=True), np.float32(1e-30))
    return _mm_tf32(p, v, split) / denom


def test_attention_3xtf32_split_meets_the_tolerance_and_1xtf32_does_not():
    rng = np.random.default_rng(21)
    b, h, s, d = 4, 4, 64, 64
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))
    mask = np.arange(s)[None, :] < rng.integers(1, s + 1, b)[:, None]
    mask[0] = False                               # a fully masked row
    want = np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(mask), interpret=True))
    err3 = float(np.abs(_emulated_attention(q, k, v, mask, split=True) - want).max())
    err1 = float(np.abs(_emulated_attention(q, k, v, mask, split=False) - want).max())
    assert err3 <= 5e-5
    assert err1 > 5e-5


def test_flash_attention_returns_a_heads_major_view_of_a_seq_major_buffer():
    rng = np.random.default_rng(8)
    b, s, h, d = 2, 100, 3, HEAD_DIM
    x = _t(rng.standard_normal((b, s, 3 * h * d)).astype(np.float32))
    q, k, v = (x[..., i * h * d:(i + 1) * h * d].reshape(b, s, h, d).permute(0, 2, 1, 3)
               for i in range(3))
    mask = torch.from_numpy(np.arange(s)[None, :] < np.array([[37], [100]]))
    out = flash_attention(q, k, v, mask)
    assert out.shape == (b, h, s, d)
    assert out.permute(0, 2, 1, 3).is_contiguous()    # [B, S, H, D] underneath
    ref = attention_reference(q.contiguous(), k.contiguous(), v.contiguous(), mask)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    # the encoder's head merge is a view of that buffer, no copy
    merged = out.permute(0, 2, 1, 3).reshape(b, s, h * d)
    assert merged.data_ptr() == out.data_ptr()


def test_bert_layer_is_the_same_through_the_flash_wrapper():
    cfg = TINY_CONFIG
    params = init_bert_params(np.random.default_rng(4), cfg)
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((3, 64, cfg.hidden_size)).astype(np.float32))
    mask = torch.from_numpy(np.arange(64)[None, :] < np.array([[64], [10], [0]]))
    layer = params["layers"][0]
    plain = bert_layer(layer, x, mask, cfg, use_flash=False)
    flash = bert_layer(layer, x, mask, cfg, use_flash=True)
    torch.testing.assert_close(flash, plain, rtol=0, atol=0)


def _constants(name):
    """``constexpr int NAME = <expr>`` values of a CUDA source, evaluated in
    order (later ones may use earlier ones)."""
    text = (CSRC / name).read_text()
    values = {}
    for decl in re.findall(r"^constexpr int ([^;]+);", text, re.M):
        for part in re.split(r",\s*(?=[A-Za-z_]\w* =)", decl):
            key, expr = (t.strip() for t in part.split("=", 1))
            values[key] = eval(re.sub(r"//.*", "", expr), {}, dict(values))
    return values


SMEM_PER_BLOCK = 232448            # the 227 KB a block may use on an H100


def test_kernel_tile_constants_agree_with_the_shape_guards():
    dm = _constants("dequant_matmul.cu")
    assert (dm["BM"], dm["BN"], dm["BK"]) == (128, 128, 64)
    assert dm["SMEM_BYTES"] <= SMEM_PER_BLOCK
    assert dm["STAGE_BYTES"] % 1024 == 0 and dm["STAGES"] >= 3
    assert dm["THREADS"] == (dm["CONSUMERS"] + 1) * 128 + 32
    # K steps of 64 over whole 32-deep steps and N tiles of 128 over 64-wide
    # tiles: the kernel masks the tail (TMA zero fill), so the guard holds
    # every width the tiles do not divide; TMA strides need K % 4, N % 16
    assert dm["BK"] % 32 == 0 and dm["BN"] % 64 == 0
    for k, n in ((32, 64), (96, 192), (dm["BK"] + 32, dm["BN"] + 64)):
        assert matmul_supported(1, k, n) and k % 4 == 0 and n % 16 == 0
    for cfg in (DISTILBERT_BASE, TINY_CONFIG):
        h, f = cfg.hidden_size, cfg.intermediate_size
        for m in (1, 64, 256 * 64):
            assert all(matmul_supported(m, k, n) for k, n in ((h, h), (h, f), (f, h)))
    at = _constants("attention.cu")
    assert at["kD"] == HEAD_DIM and at["kTile"] == 64 and at["kThreads"] == 4 * 32
    assert at["kSmemBytes"] == 3 * at["kTile"] * at["kLd"] * 4 + at["kTile"] * 4
    assert at["kSmemBytes"] <= SMEM_PER_BLOCK
    # K and V stream through in 64-key blocks: S is not held by shared memory
    assert attention_supported(MAX_SEQ, HEAD_DIM) and attention_supported(100, HEAD_DIM)
    assert not attention_supported(MAX_SEQ + 1, HEAD_DIM)
    assert not attention_supported(64, HEAD_DIM // 2)


# --------------------------------------------------------- dequant-matmul
def _int8_dense(rng, k, n):
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.2
    return jax_quantize_dense({"w": w,
                               "b": rng.standard_normal(n).astype(np.float32)})


@pytest.mark.parametrize("k,n", [(128, 128), (256, 128), (128, 256)])
def test_dequant_matmul_f32_matches_pallas(k, n):
    rng = np.random.default_rng(k + n)
    q = _int8_dense(rng, k, n)
    x = rng.standard_normal((64, k)).astype(np.float32)
    want = np.asarray(jax_dequant_matmul(
        jnp.asarray(x), jnp.asarray(q["qw"]), jnp.asarray(q["scale"]),
        jnp.asarray(q["b"]), compute_dtype=jnp.float32, interpret=True))
    got = dequant_matmul(_t(x), _t(q["qw"]), _t(q["scale"]), _t(q["b"]),
                         compute_dtype=torch.float32).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) / scale <= 1e-5


@pytest.mark.parametrize("k,n", [(128, 128), (256, 128), (128, 256)])
def test_dequant_matmul_bf16_matches_pallas(k, n):
    rng = np.random.default_rng(7 * k + n)
    q = _int8_dense(rng, k, n)
    x = rng.standard_normal((64, k)).astype(np.float32)
    want = np.asarray(jax_dequant_matmul(
        jnp.asarray(x), jnp.asarray(q["qw"]), jnp.asarray(q["scale"]),
        jnp.asarray(q["b"]), interpret=True))
    got = dequant_matmul(_t(x), _t(q["qw"]), _t(q["scale"]), _t(q["b"])).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) / scale <= BF16_ULP


def test_dequant_matmul_guard():
    assert matmul_supported(64, 768, 768) and matmul_supported(7, 3072, 768)
    assert not matmul_supported(64, 200, 128)     # K not in whole 32-steps
    assert not matmul_supported(64, 256, 100)     # N not in 64-wide tiles
    q = {"qw": torch.zeros((200, 128), dtype=torch.int8),
         "scale": torch.ones(128), "b": torch.zeros(128)}
    with pytest.raises(ValueError, match="unsupported"):
        dequant_matmul(torch.zeros((8, 200)), q["qw"], q["scale"], q["b"])


# ----------------------------------------------------------- dequant-rows
def test_dequant_rows_gather_is_bit_exact_with_pallas():
    rng = np.random.default_rng(9)
    table = jax_quantize_embedding(
        rng.standard_normal((500, 128)).astype(np.float32) * 0.02)
    idx = rng.integers(0, 500, (4, 16)).astype(np.int32)     # 64 rows
    want = np.asarray(jax_dequant_rows(
        jnp.asarray(table["qe"][idx.reshape(-1)]),
        jnp.asarray(table["scale"][idx.reshape(-1)]), interpret=True))
    got = dequant_rows(_t(table["qe"]), _t(table["scale"]), idx=_t(idx)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_dequant_rows_prefix_is_bit_exact_with_pallas():
    rng = np.random.default_rng(10)
    table = jax_quantize_embedding(
        rng.standard_normal((512, 256)).astype(np.float32) * 0.02)
    want = np.asarray(jax_dequant_rows(jnp.asarray(table["qe"][:64]),
                                       jnp.asarray(table["scale"][:64]),
                                       interpret=True))
    got = dequant_rows(_t(table["qe"]), _t(table["scale"]), length=64).numpy()
    np.testing.assert_array_equal(got, want)


def test_dequant_rows_guard():
    assert rows_supported(768) and not rows_supported(100)
    table = torch.zeros((10, 100), dtype=torch.int8)
    with pytest.raises(ValueError, match="unsupported"):
        dequant_rows(table, torch.ones(10), length=4)
    with pytest.raises(ValueError, match="length"):
        dequant_rows(torch.zeros((10, 128), dtype=torch.int8), torch.ones(10),
                     length=11)



def test_dequant_rows_block_constants_agree_with_rows_supported():
    dm = _constants("dequant_matmul.cu")
    # a flat grid of whole-warp blocks, a thread per ROWS_VEC columns (a
    # 4-byte i8 load, a 16-byte f32 store): every width the guard admits
    # splits into whole units, so no lane of a row straddles two rows
    assert dm["ROWS_THREADS"] % 32 == 0 and dm["ROWS_THREADS"] <= 1024
    assert dm["ROWS_VEC"] == 4
    for h in range(1, 1025):
        if rows_supported(h):
            assert h % dm["ROWS_VEC"] == 0 and h % 16 == 0
    for cfg in (DISTILBERT_BASE, TINY_CONFIG):
        assert rows_supported(cfg.hidden_size)
