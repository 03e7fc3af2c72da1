"""Parity bounds for the port's end-to-end checks, measured on the JAX side.

The north-star contract holds the port to "the measured bf16
calibration-noise bound, floored at 1e-4, with zero decision flips at every
QoS rung". ``noise_bound`` is that bound, computed by the JAX kernel drill's
own arithmetic (``scoring/kernel_drill.py _noise_floor``: BERT in bf16
against f32 on the given tokens, times BERT's share of the blend, floored
at 1e-4): it bounds the blended columns (probability, confidence,
fraud_score). ``branch_bounds`` is each branch's own bf16-against-f32 gap on
the same inputs, floored the same way: it bounds that branch's prediction
and contribution columns. Trees, isolation forest and GNN compute in f32
only, so theirs is the floor.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np

from realtime_fraud_detection_tpu.models import bert as jbert
from realtime_fraud_detection_tpu.models import lstm as jlstm
from realtime_fraud_detection_tpu.scoring import kernel_drill as jkd

FLOOR = jkd.KernelDrillConfig().noise_floor_abs
RUNGS = (0.3, 0.6, 0.8, 0.95, 0.7)      # risk + decision rungs, confidence


def noise_bound(bert_params, tokens, weights, valid,
                bert_config=jbert.TINY_CONFIG) -> float:
    """The JAX drill's noise bound for these BERT parameters (numpy leaves),
    ``tokens`` (a list of (ids, mask) pairs), blend ``weights`` and branch
    ``valid`` flags."""
    scorer = SimpleNamespace(
        bert_config=bert_config, models=SimpleNamespace(bert=bert_params),
        ensemble_params=SimpleNamespace(weights=np.asarray(weights)),
        effective_model_valid=lambda: np.asarray(valid, bool))
    return jkd._noise_floor(jkd.KernelDrillConfig(), scorer, tokens)["bound"]


def branch_bounds(jax_models, batch, bert_config=jbert.TINY_CONFIG) -> np.ndarray:
    """f64[5] in ``MODEL_NAMES`` order: each branch's bf16-vs-f32 gap on
    ``batch`` (host arrays), floored at ``FLOOR``."""
    def lstm(dt):
        return jax.nn.sigmoid(jlstm.lstm_logits(
            jax_models.lstm, jnp.asarray(batch.history),
            jnp.asarray(batch.history_len), compute_dtype=dt))

    def bert(dt):
        return jax.jit(lambda p, i, m: jbert.bert_predict(
            p, i, m, bert_config, compute_dtype=dt))(
                jax_models.bert, jnp.asarray(batch.token_ids),
                jnp.asarray(batch.token_mask))

    gaps = np.zeros(5)
    gaps[1] = float(jnp.max(jnp.abs(lstm(jnp.bfloat16) - lstm(jnp.float32))))
    gaps[2] = float(jnp.max(jnp.abs(bert(jnp.bfloat16) - bert(jnp.float32))))
    return np.maximum(gaps, FLOOR)


def text_bound(bert_params, ids, mask, bert_config=jbert.TINY_CONFIG) -> float:
    """The text analyzer's bound for these BERT parameters (numpy leaves) on
    these tokens: BERT's bf16-vs-f32 gap on the JAX side, floored at
    ``FLOOR`` (the analyzer's field risks are BERT probabilities unblended)."""
    def bert(dt):
        return jax.jit(lambda p, i, m: jbert.bert_predict(
            p, i, m, bert_config, compute_dtype=dt))(
                bert_params, jnp.asarray(ids), jnp.asarray(mask))

    return max(float(jnp.max(jnp.abs(bert(jnp.bfloat16) - bert(jnp.float32)))), FLOOR)


def near_rung(values, bound) -> np.ndarray:
    """bool mask of ``values`` within ``bound`` of a rung."""
    values = np.asarray(values, np.float64)
    return np.min(np.abs(values[:, None] - np.asarray(RUNGS)[None, :]), axis=1) <= bound


# ------------------------------------------------------- the training plane
# host feature columns: exact apart from amount_log, amount_sqrt and the
# haversine distance, which PyTorch's CPU loops round differently
FEATURE_TOL = 1e-5
# one optimizer step at f32 compute, the same parameters and batch: the
# loss relative to JAX's, and each gradient leaf against its own largest
# absolute value
TRAIN_LOSS_REL = 1e-6
TRAIN_GRAD_REL = 1e-5
# five torch.optim Adam / AdamW steps against optax on the same gradients
OPTIMIZER_TOL = 1e-6
# the trained branch's probabilities on 256 held-out rows after the public
# trainer ran from JAX's own initial weights (8-17 steps, then the tail Platt
# fit). Measured on the CPU: LSTM 8.4e-4 and BERT 2.4e-4 (both at the served
# bf16 product rounding, which XLA and the port's f32 emulation round at
# different points), GNN 1.2e-6 (f32); the bounds are about 5x those
LOOP_PROB_BOUND = {"lstm": 4e-3, "gnn": 6e-6, "bert": 1.2e-3}
# the tree / isolation-forest scores and the host blend: f32 round-off
BLEND_SCORE_TOL = 1e-6

# ------------------------------------------------------- the kernels on the card
# flash attention against its plain version, the kernel's own tolerance
# (chip_smoke.py ATTENTION_TOL; tests/test_torch_ops.py)
ATTENTION_TOL = 5e-5
# the text analyzer at DistilBERT-base (768 texts, S = 128) with the flash
# kernel against its plain run: chip_smoke.py phase 26 measures its bound as
# BERT's bf16-vs-f32 gap on the same tokens, floored at FLOOR, and holds every
# field risk to it. On an NVIDIA H100 80GB HBM3 at 700 W (seed 0 weights) the
# bound read 5.814e-4 and the largest field-risk error 4.782e-4.
TEXT_ANALYZER_FLASH_BOUND_H100 = 5.814e-4
