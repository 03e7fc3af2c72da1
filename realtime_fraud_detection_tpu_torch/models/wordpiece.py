"""WordPiece subword tokenizer: trainer + greedy encoder, no downloads.

Port of the JAX package's ``models/wordpiece.py`` (the ``"wordpiece"``
tokenizer of ``ScorerConfig.tokenizer``; the reference's tokenizer class,
bert_text_analyzer.py:47-66, minus the hub download):

- ``train_wordpiece_vocab``: the likelihood-scored merge trainer
  (repeatedly merge the symbol pair maximizing ``count(ab) / (count(a) *
  count(b))``), deterministic, ties broken lexicographically;
- ``WordPieceTokenizer``: BERT's greedy longest-match-first encoding with
  ``##`` continuation pieces and a per-word [UNK] fallback, over the trained
  vocabulary, with the whole-text ``TokenLruCache`` of ``models/tokenizer.py``;
- ``build_default_vocab``: trains the domain vocabulary from the simulator's
  merchant texts plus the rule keywords.

Special ids are BERT's ([PAD]=0, [UNK]=100, [CLS]=101, [SEP]=102) and the
pieces start at id 1000. The committed vocabulary ``wordpiece_vocab.txt``
in this directory is a byte-for-byte copy of the JAX package's (1,815
pieces, ``vocab_size`` 2,815); regenerate it with ``python -m
realtime_fraud_detection_tpu_torch.models.wordpiece``.
"""

from __future__ import annotations

import collections
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from realtime_fraud_detection_tpu_torch.models.tokenizer import (
    CLS_ID,
    PAD_ID,
    SEP_ID,
    UNK_ID,
    FraudTokenizer,
    TokenLruCache,
)

_PIECE_ID_START = 1000
DEFAULT_VOCAB_PATH = Path(__file__).with_name("wordpiece_vocab.txt")

__all__ = ["train_wordpiece_vocab", "WordPieceTokenizer",
           "build_default_vocab", "DEFAULT_VOCAB_PATH"]


def _word_counts(texts: Iterable[str]) -> Dict[str, int]:
    counts: Dict[str, int] = collections.Counter()
    for text in texts:
        for w in FraudTokenizer.preprocess(text).split():
            counts[w] += 1
    return counts


def train_wordpiece_vocab(
    texts: Iterable[str],
    vocab_size: int = 4096,
    min_pair_count: int = 2,
) -> List[str]:
    """Learn a WordPiece vocabulary from raw texts.

    Starts from every character (word-initial form and ``##`` continuation
    form), then merges the adjacent pair with the best score ``count(ab) /
    (count(a) * count(b))`` until the vocabulary holds ``vocab_size`` pieces
    or no pair reaches ``min_pair_count``. Ties break lexicographically.
    """
    word_counts = _word_counts(texts)
    # each word is a list of current symbols; first symbol bare, rest ##'d
    splits: Dict[str, List[str]] = {
        w: [w[0]] + [f"##{c}" for c in w[1:]] for w in word_counts
    }
    vocab: Dict[str, None] = dict.fromkeys(
        s for parts in splits.values() for s in parts)

    while len(vocab) < vocab_size:
        pair_counts: Dict[Tuple[str, str], int] = collections.Counter()
        sym_counts: Dict[str, int] = collections.Counter()
        for w, parts in splits.items():
            c = word_counts[w]
            for s in parts:
                sym_counts[s] += c
            for a, b in zip(parts, parts[1:]):
                pair_counts[(a, b)] += c
        best, best_score = None, 0.0
        for (a, b), c in pair_counts.items():
            if c < min_pair_count:
                continue
            score = c / (sym_counts[a] * sym_counts[b])
            if score > best_score or (score == best_score
                                      and best is not None
                                      and (a, b) < best):
                best, best_score = (a, b), score
        if best is None:
            break
        a, b = best
        merged = a + b[2:] if b.startswith("##") else a + b
        vocab[merged] = None
        for w, parts in splits.items():
            i = 0
            while i < len(parts) - 1:
                if parts[i] == a and parts[i + 1] == b:
                    parts[i:i + 2] = [merged]
                else:
                    i += 1
    return list(vocab)


class WordPieceTokenizer:
    """Greedy longest-match-first subword encoder over a trained vocab.

    Same surface as ``FraudTokenizer`` (``encode`` / ``encode_batch`` with
    CLS / SEP framing and fixed-length padding, ``cache_stats``), so the
    scorer selects it by ``ScorerConfig.tokenizer="wordpiece"``.
    """

    def __init__(self, vocab: Sequence[str] | None = None,
                 vocab_path: Path | str | None = None,
                 max_length: int = 128, max_word_chars: int = 64,
                 cache_entries: int = 65_536):
        if vocab is None:
            path = Path(vocab_path) if vocab_path else DEFAULT_VOCAB_PATH
            vocab = [ln.rstrip("\n") for ln in
                     path.read_text(encoding="utf-8").splitlines()
                     if ln.strip()]
        self.pieces = list(vocab)
        self.piece_to_id = {p: _PIECE_ID_START + i
                            for i, p in enumerate(self.pieces)}
        self.vocab_size = _PIECE_ID_START + len(self.pieces)
        self.max_length = max_length
        self.max_word_chars = max_word_chars
        # whole-text rows in an LRU, encoded words in a memo cleared when
        # full; the vocabulary is fixed, so neither can go stale
        self.text_cache = TokenLruCache(cache_entries)
        self._word_cache: Dict[str, List[int]] = {}

    def _encode_word(self, word: str) -> List[int]:
        """BERT's WordPiece inference: greedy longest prefix, ## the rest;
        a word with any span no piece covers becomes one [UNK]."""
        if len(word) > self.max_word_chars:
            return [UNK_ID]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece_id = None
            while end > start:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                pid = self.piece_to_id.get(piece)
                if pid is not None:
                    piece_id = pid
                    break
                end -= 1
            if piece_id is None:
                return [UNK_ID]
            ids.append(piece_id)
            start = end
        return ids

    def _encode_word_cached(self, word: str) -> List[int]:
        ids = self._word_cache.get(word)
        if ids is None:
            if len(self._word_cache) >= 200_000:
                self._word_cache.clear()
            self._word_cache[word] = ids = self._encode_word(word)
        return ids

    def encode(self, text: str) -> List[int]:
        cached = self.text_cache.get(text)
        if cached is not None:
            return list(cached)     # copy: callers may mutate their row
        words = FraudTokenizer.preprocess(text).split()
        ids = [CLS_ID]
        for w in words:
            ids.extend(self._encode_word_cached(w))
        ids.append(SEP_ID)
        ids = ids[: self.max_length]
        self.text_cache.put(text, ids)
        return ids

    def cache_stats(self) -> dict:
        return self.text_cache.stats()

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

    def decode_pieces(self, ids: Sequence[int]) -> List[str]:
        """Ids back to piece strings, specials named (tests and debugging)."""
        names = {PAD_ID: "[PAD]", UNK_ID: "[UNK]", CLS_ID: "[CLS]",
                 SEP_ID: "[SEP]"}
        out = []
        for i in ids:
            if i in names:
                out.append(names[i])
            elif _PIECE_ID_START <= i < self.vocab_size:
                out.append(self.pieces[i - _PIECE_ID_START])
            else:
                out.append(f"[{i}?]")
        return out


def build_default_vocab(vocab_size: int = 4096, n_texts: int = 40_000,
                        seed: int = 0) -> List[str]:
    """Train the domain vocabulary from the simulator's merchant texts (the
    strings assembly tokenizes, ``models/text.py combined_text``) plus the
    rule keywords, so every fraud-signal word gets a whole-word piece."""
    from realtime_fraud_detection_tpu_torch.models.keywords import vocabulary_words
    from realtime_fraud_detection_tpu_torch.models.text import combined_text
    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator

    gen = TransactionGenerator(num_users=4000, num_merchants=1500, seed=seed)
    mp = gen.merchants
    texts = [" ".join(vocabulary_words())]
    _, lab = gen.generate_encoded(n_texts)
    for i in range(n_texts):
        m = int(lab["merchant_index"][i])
        texts.append(combined_text({
            "merchant_name": str(mp.names[m]),
            "category": str(mp.category[m]),
        }))
    return train_wordpiece_vocab(texts, vocab_size=vocab_size)


if __name__ == "__main__":
    pieces = build_default_vocab()
    DEFAULT_VOCAB_PATH.write_text("\n".join(pieces) + "\n", encoding="utf-8")
    print(f"wrote {len(pieces)} pieces to {DEFAULT_VOCAB_PATH}")
