"""Faults planted under a run, to see ``correct`` come out false.

Each fault breaks the timed path underneath the harness, by wrapping the
program's instances the way ``perfbench/system.py`` does, and the rest of
the run (window, replay, comparison) goes on as always:

- ``stale_state``: the write-back leaves the streaming state unchanged
  (velocity and the transaction cache never move);
- ``half_batch``: every batch scores only its first half; the rest never
  gets a decision;
- ``altered_answer``: one decision a batch is altered where it is produced
  (its score moved by 0.05 and its decision and risk level changed);
- ``altered_token``: one token id a batch is altered where the tokenizer
  produced it;
- ``dropped_edges``: the graph join never records a batch's edges.

A one-chip cell has no exchange between chips to leave out.
"""

from __future__ import annotations

FAULTS = ("stale_state", "half_batch", "altered_answer", "altered_token",
          "dropped_edges")


def plant(name: str, system) -> None:
    scorer = system.scorer
    if name == "stale_state":
        scorer._write_back = lambda records, results, now: None
    elif name == "half_batch":
        dispatch = scorer.dispatch

        def half(records, now=None, **kw):
            return dispatch(records[:max(1, len(records) // 2)], now, **kw)

        scorer.dispatch = half
    elif name == "altered_answer":
        finalize = scorer.finalize

        def altered(pending, now=None, lock=None):
            out = finalize(pending, now=now, lock=lock)
            if out:
                r = out[0]
                r["fraud_score"] = r["fraud_probability"] = r["fraud_score"] + 0.05
                r["decision"] = "DECLINE" if r["decision"] != "DECLINE" else "APPROVE"
                r["risk_level"] = "CRITICAL" if r["risk_level"] != "CRITICAL" else "LOW"
            return out

        scorer.finalize = altered
    elif name == "altered_token":
        encode = scorer.tokenizer.encode_batch

        def altered_tokens(texts):
            ids, mask = encode(texts)
            ids = ids.copy()
            if len(ids):
                ids[0, 1] = (int(ids[0, 1]) + 1) % 1000 + 1000
            return ids, mask

        scorer.tokenizer.encode_batch = altered_tokens
    elif name == "dropped_edges":
        scorer.graph.add_edges = lambda u, m: None
    else:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
