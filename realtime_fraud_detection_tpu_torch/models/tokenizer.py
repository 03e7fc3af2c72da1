"""Deterministic fraud-domain word tokenizer.

Port of the JAX package's ``models/tokenizer.py`` (the ``"word"`` tokenizer,
``ScorerConfig.tokenizer``'s default): the reference's preprocessing
(bert_text_analyzer.py:228-251: lowercase, non-alphanumerics to spaces,
whitespace collapsed), a built-in fraud-domain vocabulary with stable ids,
out-of-vocabulary words hashed with crc32 into a reserved id range (so ids
are the same in every process), and BERT's special ids: [PAD]=0, [UNK]=100,
[CLS]=101, [SEP]=102.
"""

from __future__ import annotations

import re
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from realtime_fraud_detection_tpu_torch.models.keywords import vocabulary_words

PAD_ID, UNK_ID, CLS_ID, SEP_ID = 0, 100, 101, 102
_WORD_ID_START = 1000
_HASH_ID_START = 2000


class TokenLruCache:
    """Bounded LRU of text -> token-id rows for the assembly hot path.

    Merchant and description strings repeat across a stream, so most
    per-record tokenization is one dict hit; under eviction pressure the hot
    texts stay resident. ``hits`` / ``misses`` are cumulative.
    """

    __slots__ = ("max_entries", "hits", "misses", "_data")

    def __init__(self, max_entries: int = 65_536):
        self.max_entries = max(1, int(max_entries))
        self.hits = 0
        self.misses = 0
        self._data: "OrderedDict[str, Tuple[int, ...]]" = OrderedDict()

    def get(self, key: str) -> Optional[Tuple[int, ...]]:
        row = self._data.get(key)
        if row is None:
            self.misses += 1
            return None
        self._data.move_to_end(key)
        self.hits += 1
        return row

    def put(self, key: str, row: Sequence[int]) -> None:
        data = self._data
        data[key] = tuple(row)
        data.move_to_end(key)
        while len(data) > self.max_entries:
            data.popitem(last=False)

    def __len__(self) -> int:
        return len(self._data)

    def clear(self) -> None:
        self._data.clear()

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._data), "max_entries": self.max_entries}


class FraudTokenizer:
    """Whitespace word tokenizer with fixed domain vocab + hashed OOV."""

    def __init__(self, vocab_size: int = 30522, max_length: int = 128,
                 cache_entries: int = 65_536):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.vocab = {w: _WORD_ID_START + i for i, w in enumerate(vocabulary_words())}
        assert _WORD_ID_START + len(self.vocab) <= _HASH_ID_START
        # whole-text rows in an LRU; OOV words repeating across texts in a
        # dict that is cleared when full
        self.text_cache = TokenLruCache(cache_entries)
        self._oov_cache: dict[str, int] = {}

    @staticmethod
    def preprocess(text: str) -> str:
        """Reference preprocessing (bert_text_analyzer.py:228-251)."""
        if not text:
            return ""
        text = text.strip().lower()
        text = re.sub(r"[^a-zA-Z0-9\s]", " ", text)
        return " ".join(text.split())

    def _word_id(self, word: str) -> int:
        wid = self.vocab.get(word)
        if wid is not None:
            return wid
        wid = self._oov_cache.get(word)
        if wid is None:
            span = self.vocab_size - _HASH_ID_START
            wid = _HASH_ID_START + zlib.crc32(word.encode()) % span
            if len(self._oov_cache) >= 100_000:
                self._oov_cache.clear()
            self._oov_cache[word] = wid
        return wid

    def encode(self, text: str) -> List[int]:
        cached = self.text_cache.get(text)
        if cached is not None:
            return list(cached)     # copy: callers may mutate their row
        words = self.preprocess(text).split()
        ids = [CLS_ID] + [self._word_id(w) for w in words] + [SEP_ID]
        ids = ids[: self.max_length]
        self.text_cache.put(text, ids)
        return ids

    def encode_batch(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Batch to fixed (B, max_length) ids + attention mask."""
        b = len(texts)
        ids = np.full((b, self.max_length), PAD_ID, np.int32)
        mask = np.zeros((b, self.max_length), bool)
        for i, text in enumerate(texts):
            row = self.encode(text)
            ids[i, : len(row)] = row
            mask[i, : len(row)] = True
        return ids, mask

    def cache_stats(self) -> dict:
        return self.text_cache.stats()
