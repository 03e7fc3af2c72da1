"""The text branch's input string.

Port of ``combined_text`` from the JAX package's ``models/text.py``
(bert_text_analyzer.py:253-281): the merchant name, description, category
and location joined into one string, which the tokenizer turns into the
BERT branch's token ids.
"""

from __future__ import annotations

from typing import Mapping


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
