"""Frozen copy for the benchmark's plain reference: ``realtime_fraud_detection_tpu_torch/models/keywords.py`` as of
the commit that added ``perfbench/``. It imports nothing of the program;
the program may change, the yardstick does not.

Fraud keyword lists: the one source of the tokenizer's domain vocabulary.

Copy of the JAX package's ``models/keywords.py`` (groups mirror
bert_text_analyzer.py:309-342), kept here so the port imports nothing of the
JAX package. The order of the tuples fixes the tokenizer's word ids.
"""

CRYPTO_KEYWORDS = ("bitcoin", "btc", "ethereum", "eth", "crypto", "blockchain",
                   "coinbase", "binance", "wallet", "mining", "satoshi")
GIFT_CARD_KEYWORDS = ("gift card", "giftcard", "itunes", "amazon card",
                      "google play", "steam card", "prepaid card", "reload card")
URGENT_KEYWORDS = ("urgent", "emergency", "immediate", "quickly", "asap",
                   "limited time", "act now", "expires soon")
SUSPICIOUS_PATTERNS = ("temp", "temporary", "cash advance", "payday", "loan",
                       "invest", "forex", "trading", "pyramid", "mlm")
SCAM_PATTERNS = ("nigerian prince", "inheritance", "lottery winner", "tax refund",
                 "irs", "social security", "medicare", "warranty expired")

ALL_KEYWORD_GROUPS = (CRYPTO_KEYWORDS, GIFT_CARD_KEYWORDS, URGENT_KEYWORDS,
                      SUSPICIOUS_PATTERNS, SCAM_PATTERNS)

# Extra vocabulary: regex tokens (FeatureExtractor.java:30-41), merchant
# categories (simulator.py:255-266), template/common merchant words.
EXTRA_VOCAB_WORDS = (
    "exchange vanilla western union moneygram remit transfer wire paypal venmo "
    "casino gambling betting lottery investment "
    "retail grocery gas station restaurant online pharmacy jewelry electronics "
    "adult entertainment "
    "merchant description category location biz market store shop house depot "
    "corner bros royale mart outlet co company inc llc payment purchase refund "
    "authorization winner prince play card prepaid reload the and of for a"
).split()


def vocabulary_words() -> list[str]:
    """Flat, order-stable word list (multi-word phrases split)."""
    words: list[str] = []
    for group in ALL_KEYWORD_GROUPS:
        for phrase in group:
            words.extend(phrase.split())
    words.extend(EXTRA_VOCAB_WORDS)
    return list(dict.fromkeys(words))
