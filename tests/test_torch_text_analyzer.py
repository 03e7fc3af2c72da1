"""The port's text analyzer (``models/text.py``) against the JAX package's,
on the CPU.

- ``detect_fraud_patterns`` and ``get_text_features`` equal JAX's exactly on
  ``tests/test_text.py``'s cases and on seeded simulator texts.
- ``TextAnalyzer`` at ``TINY_CONFIG``, ``max_length`` 32, with the JAX
  analyzer's weights carried over by ``bridge.params_from_numpy``:
  ``score_texts`` and ``analyze_transaction_text`` within the text bound of
  ``torch_bounds`` (BERT's bf16-vs-f32 gap on the same tokens, floored at
  1e-4), with ``use_flash`` off and on (on the CPU the flash wrapper runs its
  plain version, so both equal each other bit for bit); the field keys and
  ``overall_text_risk`` of rows without text exactly.
- ``get_performance_stats`` has JAX's keys; a text length the flash kernel
  does not take raises instead of falling back; ``device="cuda"`` raises
  without a card.
"""

import torch_threads  # first: torch held to one CPU thread
import jax
import numpy as np
import pytest
import torch

from realtime_fraud_detection_tpu.models import bert as jbert
from realtime_fraud_detection_tpu.models import text as jtext
from realtime_fraud_detection_tpu_torch.bridge import params_from_numpy
from realtime_fraud_detection_tpu_torch.models import text
from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
from torch_bounds import text_bound

MAX_LEN = 32

RULE_CASES = [
    {"merchant_name": "QuickBitcoin Wallet", "description": "urgent gift card reload"},
    {"description": "nigerian prince inheritance"},
    {"merchant_name": "Shop-24x7!", "description": "pay 99"},
    {"merchant_name": "Acme", "category": "retail"},
    {"merchant_name": "first national", "location": "IRS office"},
    {},
]


def text_records(n, seed):
    """Seeded simulator transactions as text records: the merchant's name
    and category, a description and the merchant's location."""
    gen = TransactionGenerator(num_users=200, num_merchants=50, seed=seed)
    merchants = gen.merchants.profiles()
    out = []
    for r in gen.generate_batch(n):
        m, geo = merchants[r["merchant_id"]], r["merchant_location"]
        out.append({"merchant_name": m["name"], "category": m["category"],
                    "description": r.get("fraud_reason") or (
                        f"{r['transaction_type']} by {r['payment_method']} of "
                        f"{r['amount']} {r['currency']}"),
                    "location": f"{geo['lat']:.2f} {geo['lon']:.2f}"})
    return out


RECORDS = text_records(40, 5) + RULE_CASES


@pytest.fixture(scope="module")
def jax_analyzer():
    return jtext.TextAnalyzer(config=jbert.TINY_CONFIG, max_length=MAX_LEN, seed=3)


@pytest.fixture(scope="module")
def bridged(jax_analyzer):
    return jax.tree_util.tree_map(np.asarray, jax_analyzer.params)


@pytest.fixture(scope="module")
def jax_scores(jax_analyzer):
    """JAX's scores of the records' texts, its rows, and the text bound on
    the same tokens."""
    texts = _texts(RECORDS)
    ids, mask = jax_analyzer.tokenizer.encode_batch(texts)
    return (jax_analyzer.score_texts(texts), jax_analyzer.analyze_transaction_text(RECORDS),
            text_bound(jax_analyzer.params, ids, mask))


def _port(params, use_flash):
    return text.TextAnalyzer(config=TINY_CONFIG, params=params_from_numpy(params),
                             max_length=MAX_LEN, use_flash=use_flash, device="cpu")


def _texts(records):
    return [t for r in records for t in (r.get("merchant_name"), r.get("description"),
                                         text.combined_text(r)) if t]


@pytest.mark.parametrize("record", RECORDS[:8] + RULE_CASES)
def test_rules_and_text_features_equal_jax(record):
    assert text.detect_fraud_patterns(record) == jtext.detect_fraud_patterns(record)
    got, want = text.get_text_features(record), jtext.get_text_features(record)
    assert got == want and [type(v) for v in got.values()] == [type(v) for v in want.values()]
    assert text.combined_text(record) == jtext.combined_text(record)
    assert text.FIELD_WEIGHTS == jtext.FIELD_WEIGHTS


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
def test_analyzer_matches_jax(jax_scores, bridged, use_flash):
    port = _port(bridged, use_flash)
    texts = _texts(RECORDS)
    want, want_rows, bound = jax_scores
    got = port.score_texts(texts)
    assert got.dtype == np.float32 and got.shape == want.shape == (len(texts),)
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)

    got_rows = port.analyze_transaction_text(RECORDS)
    assert [list(r) for r in got_rows] == [list(r) for r in want_rows]
    for g, w in zip(got_rows, want_rows):
        np.testing.assert_allclose([g[k] for k in w], [w[k] for k in w], rtol=0, atol=bound)
    assert got_rows[-1] == want_rows[-1] == {"overall_text_risk": 0.0}


def test_flash_equals_plain_on_the_cpu(bridged):
    texts = _texts(RECORDS)
    flash, plain = _port(bridged, True), _port(bridged, False)
    assert flash.score_texts(texts).tobytes() == plain.score_texts(texts).tobytes()


def test_performance_stats_keys(bridged, jax_analyzer):
    port = _port(bridged, False)
    port.analyze_transaction_text(RECORDS[:3])
    stats = port.get_performance_stats()
    assert list(stats) == list(jax_analyzer.get_performance_stats())
    assert stats["total_predictions"] == 3 and stats["avg_processing_time_ms"] > 0


def test_default_weights_are_seeded():
    a = text.TextAnalyzer(config=TINY_CONFIG, max_length=16, seed=1, device="cpu")
    b = text.TextAnalyzer(config=TINY_CONFIG, max_length=16, seed=1, device="cpu")
    assert torch.equal(a.params["word_emb"], b.params["word_emb"])
    assert a.score_texts(["Biz 4 Crypto Exchange"]).tobytes() == \
        b.score_texts(["Biz 4 Crypto Exchange"]).tobytes()


def test_flash_raises_outside_the_kernels_shapes(bridged):
    long = text.TextAnalyzer(config=TINY_CONFIG, params=params_from_numpy(bridged),
                             max_length=512, use_flash=True, device="cpu")
    with pytest.raises(ValueError, match="flash_attention takes"):
        long.score_texts(["Acme"])


def test_card_asked_for_without_one_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        text.TextAnalyzer(config=TINY_CONFIG, max_length=16)
