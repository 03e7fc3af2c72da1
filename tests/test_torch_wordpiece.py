"""The port's wordpiece tokenizer against the JAX package's, on the CPU.

The cases of ``tests/test_text.py``'s ``TestWordPiece`` run through both
packages. Then: the trainer learns JAX's vocabulary on the same corpus;
the committed vocabulary file is byte-identical to JAX's; ids and masks
equal JAX's exactly on a seeded simulator corpus and on the JAX test
strings; and a ``TorchFraudScorer`` with ``ScorerConfig(tokenizer=
"wordpiece")`` assembles JAX's tokens and matches the JAX scorer's packed
output, each branch column within that branch's own bf16 gap and the
blended columns within the kernel drill's noise bound (``torch_bounds.py``),
both floored at 1e-4.
"""

import torch_threads  # noqa: F401  (first: torch held to one CPU thread)
import jax
import numpy as np
import pytest

from realtime_fraud_detection_tpu.ensemble.combine import (
    EnsembleParams as JaxEnsembleParams,
)
from realtime_fraud_detection_tpu.models import wordpiece as jax_wordpiece
from realtime_fraud_detection_tpu.models.text import combined_text as jax_combined_text
from realtime_fraud_detection_tpu.models.tokenizer import CLS_ID, PAD_ID, SEP_ID
from realtime_fraud_detection_tpu.scoring import FraudScorer
from realtime_fraud_detection_tpu.scoring import ScorerConfig as JaxScorerConfig
from realtime_fraud_detection_tpu.sim.simulator import (
    TransactionGenerator as JaxTransactionGenerator,
)
from realtime_fraud_detection_tpu.utils.config import Config as JaxConfig
from realtime_fraud_detection_tpu_torch.bridge import models_from_numpy
from realtime_fraud_detection_tpu_torch.models import wordpiece as port_wordpiece
from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG, BertConfig
from realtime_fraud_detection_tpu_torch.models.text import combined_text
from realtime_fraud_detection_tpu_torch.scoring.pipeline import MODEL_NAMES, ScorerConfig
from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
from torch_bounds import branch_bounds, noise_bound

# the strings of tests/test_text.py's TestWordPiece, plus edge cases
JAX_TEST_STRINGS = [
    "cryptopay", "abc zzz", "crypto exchange", "", "crypto", "exchange", "gift",
    "card", "wire", "transfer", "casino", "casino cash out",
    "crypto exchange wire transfer", "Amazon.com  Online -- Purchase #42!",
    "x" * 80, "Ünïcödé café 東京", "   ", "gift card gift card " * 10,
]


def both(scenario):
    got, want = scenario(port_wordpiece), scenario(jax_wordpiece)
    assert got == want
    return got


def _simulator_corpus(n=400, seed=9):
    """Merchant + description texts of a seeded simulator stream, built the
    way assembly builds them, through each package's own simulator and
    ``combined_text``."""
    corpora = []
    for gen_cls, text in ((TransactionGenerator, combined_text),
                          (JaxTransactionGenerator, jax_combined_text)):
        gen = gen_cls(num_users=50, num_merchants=40, seed=seed)
        merchants = gen.merchants.profiles()
        corpora.append([text({
            "merchant_name": merchants[r["merchant_id"]]["name"],
            "description": str(r.get("description", "") or ""),
            "category": merchants[r["merchant_id"]]["category"],
            "location": str(r.get("location", "") or ""),
        }) for r in gen.generate_batch(n)])
    assert corpora[0] == corpora[1]
    return corpora[0]


class TestWordPiece:
    def test_trainer_learns_frequent_words_as_whole_pieces(self):
        vocab = both(lambda wp: wp.train_wordpiece_vocab(
            ["crypto exchange wire transfer"] * 50 + ["casino cash out"] * 30,
            vocab_size=200))
        for w in ("crypto", "exchange", "wire", "transfer", "casino"):
            assert w in vocab, f"frequent word {w!r} not a whole piece"

    def test_greedy_longest_match_and_continuations(self):
        def scenario(wp):
            t = wp.WordPieceTokenizer(vocab=["crypto", "pay", "##pay", "c", "##r"],
                                      max_length=16)
            return t.decode_pieces(t.encode("cryptopay"))

        assert both(scenario) == ["[CLS]", "crypto", "##pay", "[SEP]"]

    def test_uncoverable_word_becomes_unk_not_crash(self):
        def scenario(wp):
            t = wp.WordPieceTokenizer(vocab=["abc"], max_length=16)
            return t.decode_pieces(t.encode("abc zzz"))

        assert both(scenario) == ["[CLS]", "abc", "[UNK]", "[SEP]"]

    def test_committed_domain_vocab_loads_and_covers_fraud_terms(self):
        def scenario(wp):
            t = wp.WordPieceTokenizer(max_length=32)
            return t.vocab_size, {term: t.encode(term) for term in (
                "crypto", "exchange", "gift", "card", "wire", "transfer", "casino")}

        vocab_size, ids = both(scenario)
        assert vocab_size == 2815
        for term, row in ids.items():
            assert len(row) == 3, term

    def test_encode_batch_shapes_and_special_ids(self):
        def scenario(wp):
            t = wp.WordPieceTokenizer(max_length=12)
            ids, mask = t.encode_batch(["crypto exchange", ""])
            return ids.tolist(), mask.tolist(), str(ids.dtype)

        ids, mask, dtype = both(scenario)
        assert np.asarray(ids).shape == (2, 12) and dtype == "int32"
        assert ids[0][0] == CLS_ID and SEP_ID in ids[0]
        assert ids[1][2] == PAD_ID and not mask[1][2]

    def test_scorer_uses_wordpiece_by_config(self):
        gen = TransactionGenerator(num_users=16, num_merchants=8, seed=1)
        scorer = TorchFraudScorer(
            scorer_config=ScorerConfig(text_len=32, tokenizer="wordpiece"),
            device="cpu")
        assert isinstance(scorer.tokenizer, port_wordpiece.WordPieceTokenizer)
        assert scorer.tokenizer.text_cache.max_entries == 65_536
        results = scorer.score_batch(gen.generate_batch(4))
        assert len(results) == 4


def test_vocab_file_is_byte_identical_to_jax():
    assert port_wordpiece.DEFAULT_VOCAB_PATH.read_bytes() == \
        jax_wordpiece.DEFAULT_VOCAB_PATH.read_bytes()
    assert port_wordpiece.DEFAULT_VOCAB_PATH.parent.name == "models"
    assert "realtime_fraud_detection_tpu_torch" in str(port_wordpiece.DEFAULT_VOCAB_PATH)


@pytest.mark.parametrize("vocab_size,min_pair_count", [(120, 2), (400, 2), (400, 5)])
def test_trainer_gives_jax_vocab_on_a_simulator_corpus(vocab_size, min_pair_count):
    corpus = _simulator_corpus(300)
    vocab = both(lambda wp: wp.train_wordpiece_vocab(
        corpus, vocab_size=vocab_size, min_pair_count=min_pair_count))
    assert len(vocab) <= vocab_size


def test_default_vocab_builder_equals_jax_at_a_small_size():
    vocab = both(lambda wp: wp.build_default_vocab(vocab_size=300, n_texts=400, seed=3))
    assert 200 < len(vocab) <= 300


@pytest.mark.parametrize("max_length", [8, 32, 64])
def test_ids_and_masks_equal_jax(max_length):
    texts = _simulator_corpus() + JAX_TEST_STRINGS

    def scenario(wp):
        t = wp.WordPieceTokenizer(max_length=max_length, cache_entries=64)
        ids, mask = t.encode_batch(texts)
        again, _ = t.encode_batch(texts[::-1])     # through the warm caches
        return ids.tolist(), mask.tolist(), again.tolist(), t.cache_stats()

    ids, mask, again, stats = both(scenario)
    assert np.asarray(ids).shape == (len(texts), max_length)
    assert again == ids[::-1]
    assert stats["hits"] > 0 and stats["entries"] <= 64


def test_a_bert_narrower_than_the_vocab_is_refused():
    narrow = BertConfig(hidden_size=32, num_layers=1, num_heads=2,
                        intermediate_size=64, vocab_size=2000)
    with pytest.raises(ValueError, match="vocab_size"):
        TorchFraudScorer(bert_config=narrow, device="cpu",
                         scorer_config=ScorerConfig(tokenizer="wordpiece"))
    with pytest.raises(ValueError, match="tokenizer"):
        TorchFraudScorer(device="cpu", scorer_config=ScorerConfig(tokenizer="bpe"))


def test_wordpiece_scorer_matches_the_jax_scorer():
    """Both scorers on the same bridged models and stream: the tokens the
    port assembles equal JAX's, the packed output matches within the
    bounds, the highest id lies inside the embedding table."""
    jscorer = FraudScorer(scorer_config=JaxScorerConfig(text_len=32,
                                                        tokenizer="wordpiece"),
                          seed=4)
    models = jax.tree_util.tree_map(np.asarray, jscorer.models)
    scorer = TorchFraudScorer(models=models_from_numpy(models), device="cpu",
                              scorer_config=ScorerConfig(text_len=32,
                                                         tokenizer="wordpiece"))
    gens = [TransactionGenerator(num_users=40, num_merchants=15, seed=6),
            JaxTransactionGenerator(num_users=40, num_merchants=15, seed=6)]
    for s, g in zip((scorer, jscorer), gens):
        s.seed_profiles(g.users.profiles(), g.merchants.profiles())
    for step in range(2):
        recs = [g.generate_batch(24) for g in gens]
        assert recs[0] == recs[1]
        now = 100.0 + step
        batch = scorer.assemble(recs[0], now=now)
        jbatch = jscorer.assemble(recs[1], now=now)
        np.testing.assert_array_equal(batch.token_ids, np.asarray(jbatch.token_ids))
        np.testing.assert_array_equal(batch.token_mask, np.asarray(jbatch.token_mask))
        assert int(batch.token_ids.max()) < TINY_CONFIG.vocab_size
        assert int(batch.token_ids.max()) >= 1000      # pieces, not only specials
        out = scorer.finalize(scorer.dispatch_assembled(batch, recs[0]), now=now)
        jout = jscorer.finalize(jscorer.dispatch_assembled(jbatch, recs[1]), now=now)
        weights = JaxEnsembleParams.from_config(JaxConfig(), MODEL_NAMES).weights
        bound = noise_bound(models.bert, [(np.asarray(jbatch.token_ids),
                                           np.asarray(jbatch.token_mask))],
                            weights, np.ones(5, bool))
        branch = branch_bounds(models, jbatch)
        for p, q in zip(out, jout):
            assert p["transaction_id"] == q["transaction_id"]
            assert abs(p["fraud_score"] - q["fraud_score"]) <= bound
            assert abs(p["confidence"] - q["confidence"]) <= bound
            for j, name in enumerate(MODEL_NAMES):
                assert abs(p["model_predictions"][name]
                           - q["model_predictions"][name]) <= branch[j], name
    assert scorer.host_stats()["caches"]["tokens"] == jscorer.tokenizer.cache_stats()
