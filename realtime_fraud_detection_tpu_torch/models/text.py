"""Transaction text analysis: BERT scoring + keyword rules + text stats.

Port of the JAX package's ``models/text.py``, the capability mirror of
``BertTextAnalyzer`` (bert_text_analyzer.py:21-412), batched: where the
reference runs three single-text BERT calls a transaction (merchant,
description, combined; :123-143), ``TextAnalyzer`` tokenizes all of them
into one (N, L) batch, pads it to the shared bucket set and makes one
encoder call (``models/bert.py bert_predict``) on its device. With
``use_flash`` each encoder layer's attention launches the hand-written
kernel (``ops/attention.py flash_attention``, ``csrc/attention.cu``) on a
card; on the CPU the wrapper runs its plain version.

``combined_text`` is also the scorer's text branch input: the merchant
name, description, category and location joined into one string.
``detect_fraud_patterns`` and ``get_text_features`` are the reference's
keyword rules and text statistics, plain Python.
"""

from __future__ import annotations

import re
import time
from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

from realtime_fraud_detection_tpu_torch.core.batching import bucket_for
from realtime_fraud_detection_tpu_torch.core.mesh import tree_map
from realtime_fraud_detection_tpu_torch.models.bert import (
    BertConfig,
    bert_predict,
    init_bert_params,
)
from realtime_fraud_detection_tpu_torch.models.keywords import (  # noqa: F401
    CRYPTO_KEYWORDS,
    GIFT_CARD_KEYWORDS,
    SCAM_PATTERNS,
    SUSPICIOUS_PATTERNS,
    URGENT_KEYWORDS,
)
from realtime_fraud_detection_tpu_torch.models.tokenizer import FraudTokenizer

# Per-field weights for the overall risk (bert_text_analyzer.py:148-152)
FIELD_WEIGHTS = {"merchant_name_risk": 0.4, "description_risk": 0.3,
                 "combined_text_risk": 0.3}


def combined_text(text_data: Mapping[str, str]) -> str:
    """Combined contextual text (bert_text_analyzer.py:253-281)."""
    parts = []
    if text_data.get("merchant_name"):
        parts.append(f"Merchant: {text_data['merchant_name']}")
    if text_data.get("description"):
        parts.append(f"Description: {text_data['description']}")
    if text_data.get("category"):
        parts.append(f"Category: {text_data['category']}")
    if text_data.get("location"):
        parts.append(f"Location: {text_data['location']}")
    return " | ".join(parts)


def _keyword_hit(text: str, keywords) -> bool:
    # word-boundary match for single short keywords ("irs" must not fire
    # inside "first"); plain substring for multi-word phrases
    for k in keywords:
        if " " in k or len(k) >= 6:
            if k in text:
                return True
        elif re.search(rf"\b{re.escape(k)}\b", text):
            return True
    return False


def detect_fraud_patterns(text_data: Mapping[str, str]) -> Dict[str, bool]:
    """Rule-based keyword detection (bert_text_analyzer.py:283-344)."""
    all_text = " ".join(
        text_data.get(k, "") or ""
        for k in ("merchant_name", "description", "category", "location")
    ).lower()
    return {
        "crypto_keywords": _keyword_hit(all_text, CRYPTO_KEYWORDS),
        "gift_card_keywords": _keyword_hit(all_text, GIFT_CARD_KEYWORDS),
        "urgent_language": _keyword_hit(all_text, URGENT_KEYWORDS),
        "suspicious_merchant": _keyword_hit(all_text, SUSPICIOUS_PATTERNS),
        "known_scam_patterns": _keyword_hit(all_text, SCAM_PATTERNS),
    }


def get_text_features(text_data: Mapping[str, str]) -> Dict[str, float]:
    """Numeric text statistics (bert_text_analyzer.py:346-399)."""
    merchant = text_data.get("merchant_name", "") or ""
    description = text_data.get("description", "") or ""
    f: Dict[str, float] = {
        "merchant_name_length": len(merchant),
        "description_length": len(description),
    }
    f["total_text_length"] = f["merchant_name_length"] + f["description_length"]
    if merchant:
        f["merchant_name_unique_chars"] = len(set(merchant.lower()))
        f["merchant_name_char_diversity"] = (
            f["merchant_name_unique_chars"] / max(len(merchant), 1)
        )
    else:
        f["merchant_name_unique_chars"] = 0
        f["merchant_name_char_diversity"] = 0
    f["numbers_in_merchant"] = len(re.findall(r"\d", merchant))
    f["numbers_in_description"] = len(re.findall(r"\d", description))
    f["total_numbers"] = f["numbers_in_merchant"] + f["numbers_in_description"]
    f["special_chars_merchant"] = len(re.findall(r"[^a-zA-Z0-9\s]", merchant))
    f["special_chars_description"] = len(re.findall(r"[^a-zA-Z0-9\s]", description))
    f["total_special_chars"] = (
        f["special_chars_merchant"] + f["special_chars_description"]
    )
    f["merchant_word_count"] = len(merchant.split()) if merchant else 0
    f["description_word_count"] = len(description.split()) if description else 0
    f["total_word_count"] = f["merchant_word_count"] + f["description_word_count"]
    return f


class TextAnalyzer:
    """Batched BERT text analyzer on ``device`` (the card unless the caller
    asks for the CPU). ``params`` are the encoder's weights (a tree of
    tensors, e.g. ``bridge.params_from_numpy`` of the JAX analyzer's);
    without them ``init_bert_params`` draws them from ``seed``. With
    ``use_flash`` the attention runs through ``ops/attention.py
    flash_attention``, which raises for a text length or head width the
    kernel does not take (``attention_supported``) rather than fall back."""

    def __init__(
        self,
        config: BertConfig | None = None,
        params: Dict | None = None,
        max_length: int = 128,
        use_flash: bool = False,
        seed: int = 0,
        device: str = "cuda",
    ):
        self.config = config or BertConfig()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TextAnalyzer on the card asked for, but CUDA is "
                               "not available (pass device='cpu')")
        self.tokenizer = FraudTokenizer(self.config.vocab_size, max_length)
        if params is None:
            params = init_bert_params(np.random.default_rng(seed), self.config)
        self.params = tree_map(
            lambda t: t.to(self.device) if isinstance(t, torch.Tensor) else t,
            params)
        self.use_flash = use_flash
        self.total_predictions = 0
        self.total_time_ms = 0.0

    def score_texts(self, texts: Sequence[str]) -> np.ndarray:
        """Fraud probability per text, one encoder call. f32[N].

        The batch is padded to the shared bucket set
        (``core/batching.py BATCH_BUCKETS``), so ragged per-transaction
        field counts meet a few shapes only.
        """
        n = len(texts)
        bucket = bucket_for(n)
        ids, mask = self.tokenizer.encode_batch(
            list(texts) + [""] * (bucket - n))
        with torch.inference_mode():
            probs = bert_predict(
                self.params, torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device), self.config,
                use_flash=self.use_flash)
            # rtfd-lint: allow[d2h] the call's one pull: the [n] probabilities to the host once the encoder has run
            return probs[:n].cpu().numpy()

    def analyze_transaction_text(
        self, batch: Sequence[Mapping[str, str]]
    ) -> List[Dict[str, float]]:
        """Per-transaction field risks + weighted overall
        (bert_text_analyzer.py:104-177), all fields in one encoder call."""
        start = time.perf_counter()
        texts: List[str] = []
        index: List[List[tuple[str, int]]] = []
        for td in batch:
            fields = []
            if td.get("merchant_name"):
                fields.append(("merchant_name_risk", len(texts)))
                texts.append(td["merchant_name"])
            if td.get("description"):
                fields.append(("description_risk", len(texts)))
                texts.append(td["description"])
            combo = combined_text(td)
            if combo:
                fields.append(("combined_text_risk", len(texts)))
                texts.append(combo)
            index.append(fields)

        scores = self.score_texts(texts) if texts else np.zeros((0,))
        results = []
        for fields in index:
            res = {name: float(scores[i]) for name, i in fields}
            if res:
                total_w = sum(FIELD_WEIGHTS.get(n, 0.1) for n in res)
                res["overall_text_risk"] = (
                    sum(s * FIELD_WEIGHTS.get(n, 0.1) for n, s in res.items()) / total_w
                    if total_w > 0 else 0.0
                )
            else:
                res["overall_text_risk"] = 0.0
            results.append(res)
        self.total_predictions += len(batch)
        self.total_time_ms += (time.perf_counter() - start) * 1000
        return results

    def get_performance_stats(self) -> Dict[str, float]:
        """(bert_text_analyzer.py:401-412)"""
        n = self.total_predictions
        return {
            "total_predictions": n,
            "avg_processing_time_ms": self.total_time_ms / n if n else 0.0,
            "total_processing_time_ms": self.total_time_ms,
        }
