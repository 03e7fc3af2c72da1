"""The PyTorch port's kernel modules against the JAX package's Pallas
kernels (run through the Pallas interpreter), on the CPU.

On the CPU each port wrapper runs its plain PyTorch version; the CUDA
kernels themselves are held against those plain versions on the card by
``chip_smoke.py``. Tolerances are the reference's own (docs/kernels.md):
epilogue ladders exact and probabilities <= 1e-6, attention <= 5e-5,
f32 dequant-matmul <= 1e-5 relative, bf16 within one bf16 ulp of the output
scale, dequant_rows bit-exact.
"""

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
    flash_attention as jax_flash_attention,
    fused_epilogue as jax_fused_epilogue,
)
from realtime_fraud_detection_tpu.scoring.pipeline import MODEL_NAMES
from realtime_fraud_detection_tpu.utils.config import Config as JaxConfig
from realtime_fraud_detection_tpu_torch import ops
from realtime_fraud_detection_tpu_torch.ensemble.combine import EnsembleParams
from realtime_fraud_detection_tpu_torch.ops.attention import (
    attention_reference,
    flash_attention,
)
from realtime_fraud_detection_tpu_torch.ops.dequant_matmul import (
    dequant_matmul,
    dequant_rows,
    matmul_supported,
    rows_supported,
)
from realtime_fraud_detection_tpu_torch.ops.epilogue import (
    combine_matrix,
    epilogue_matrix,
    fused_epilogue,
)
from realtime_fraud_detection_tpu_torch.utils.config import Config

BF16_ULP = 2.0 ** -7


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

