"""Text-branch training: fine-tune the BERT classifier on simulated text.

Port of the JAX package's ``training/text.py``. The generator's merchant
pool provides the supervision: transaction text assembled the way serving
assembles it, labelled with the stream's fraud labels (suspicious merchant
names correlate with high-risk categories and fraud). The loop is
``training/neural.py NeuralTrainer`` with AdamW at optax's weight decay
(1e-4), over the plain BERT path (plain attention, dense f32 weights, the
served bf16 product rounding).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from realtime_fraud_detection_tpu_torch.models.bert import (
    BertConfig,
    bert_logits,
    init_bert_params,
)
from realtime_fraud_detection_tpu_torch.models.text import combined_text
from realtime_fraud_detection_tpu_torch.models.tokenizer import FraudTokenizer
from realtime_fraud_detection_tpu_torch.training.calibrate import (
    calibrate_bert_head,
    platt_fit,
)
from realtime_fraud_detection_tpu_torch.training.neural import (
    NeuralTrainer,
    _calibration_split,
    _record,
    adamw,
    auto_pos_weight,
    eval_logits,
    training_device,
)


def build_text_dataset(
    generator, n_transactions: int, max_length: int = 64
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(input_ids, attention_mask, labels) from a simulated stream."""
    tok = FraudTokenizer(max_length=max_length)
    texts, labels = [], []
    _, lab = generator.generate_encoded(n_transactions)
    mp = generator.merchants
    for i in range(n_transactions):
        m = int(lab["merchant_index"][i])
        texts.append(combined_text({
            "merchant_name": str(mp.names[m]),
            "category": str(mp.category[m]),
        }))
        labels.append(float(lab["is_fraud"][i]))
    ids, mask = tok.encode_batch(texts)
    return ids, mask, np.asarray(labels, np.float32)


def bert_class_loss(config: BertConfig, pos_weight: float):
    """The text branch's class-weighted 2-way cross entropy over
    ``bert_logits`` (``F.cross_entropy`` is optax's
    ``softmax_cross_entropy_with_integer_labels``)."""
    def loss_fn(p, inputs, by):
        bi, bm = inputs
        logits = bert_logits(p, bi, bm, config)
        per = F.cross_entropy(logits, by.long(), reduction="none")
        return (per * torch.where(by > 0.5, pos_weight, 1.0)).mean()

    return loss_fn


def train_bert(
    generator,
    config: BertConfig | None = None,
    n_transactions: int = 20_000,
    max_length: int = 64,
    batch_size: int = 64,
    epochs: int = 2,
    learning_rate: float = 5e-5,
    seed: int = 0,
    pos_weight: float | None = None,
    calibrate: bool = True,
    *,
    init: Any = None,
    device: str = "cuda",
    stats: Optional[Dict[str, Any]] = None,
) -> Dict:
    """Fine-tune (from random init) the classifier on stream text.
    ``pos_weight=None`` is auto class weighting; ``calibrate`` folds a
    tail-fitted Platt transform into the classifier head."""
    dev = training_device(device)
    config = config or BertConfig()
    ids, mask, labels = build_text_dataset(generator, n_transactions, max_length)
    n_cal = _calibration_split(len(labels)) if calibrate else 0
    tr_sl = slice(0, len(labels) - n_cal)
    if init is None:
        init = init_bert_params(np.random.default_rng(seed), config)
    pw = (auto_pos_weight(labels[tr_sl]) if pos_weight is None
          else float(pos_weight))
    trainer = NeuralTrainer(batch_size=batch_size, epochs=epochs, seed=seed,
                            optimizer=adamw(learning_rate), device=str(dev))
    params = trainer.train(init, bert_class_loss(config, pw),
                           (ids[tr_sl], mask[tr_sl]), labels[tr_sl])
    _record(stats, trainer)
    if n_cal and 0 < labels[-n_cal:].sum() < n_cal:
        lg = eval_logits(lambda p, i, m: bert_logits(p, i, m, config), params,
                          (ids[-n_cal:], mask[-n_cal:]), dev)
        a, b = platt_fit(lg[:, 1] - lg[:, 0], labels[-n_cal:])
        params = calibrate_bert_head(params, a, b)
    return params
