"""The reference's replay of a run: the streaming state and the branch
inputs of every transaction drawn for the check.

The program's state depends on where the batch boundaries fell and on the
order of assemblies and write-backs (with ``pipeline_depth`` 2 a batch is
assembled before the previous one has written back). The harness records
that order (``Recorder.events``): ("D", k, records) when batch k was
assembled, ("F", k) when it was written back. The replay walks the same
events with its own plain state, record by record:

- at an assembly, each record reads its user's velocity as the write-backs
  so far left it, is encoded with its user and merchant profiles
  (``schema.encode_transactions``, a frozen copy), gets its 64 features
  (``extract.extract_features_host``), is appended to its user's last
  ``seq_len`` feature rows and reads them back oldest first; the batch's
  one-hop neighbourhoods are read from the edges of earlier batches, then
  its own user -> merchant edges are added (each side keeps its ``fanout``
  most recent counterparties); node rows are the profiles' features;
- at a write-back, each record adds one transaction and its amount to its
  user's velocity.

Velocity windows (5 min, 1 h, 24 h) restart when their period has passed
since they opened; a run's write-backs span less than five minutes, so
every window holds the same count and amount here.
"""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Any, Dict, List, Mapping, Sequence

import numpy as np

from perfbench.reference.extract import extract_features_host
from perfbench.reference.schema import MERCHANT_CATEGORIES, _code, encode_transactions
from perfbench.reference.tokenizer import FraudTokenizer

WINDOWS = ("5min", "1hour", "24hour")


def node_row(p: Mapping[str, Any] | None, is_merchant: bool, dim: int) -> np.ndarray:
    """A user's or merchant's node features (the GNN's input slots)."""
    row = np.zeros((dim,), np.float32)
    if p is None:
        row[8] = 1.0 if is_merchant else 0.0
        return row
    if is_merchant:
        risk = {"low": 0, "medium": 1, "high": 2}.get(str(p.get("risk_level")), 1)
        hours = p.get("operating_hours") or {}
        row[0] = risk / 2.0
        row[1] = float(p.get("fraud_rate", 0.05))
        row[2] = np.log1p(float(p.get("avg_transaction_amount", 0.0)))
        row[3] = float(bool(p.get("is_blacklisted", False)))
        row[4] = _code(MERCHANT_CATEGORIES, p.get("category")) / 10.0
        row[5] = float(hours.get("start_hour", 0)) / 24.0
        row[6] = float(hours.get("end_hour", 24)) / 24.0
        row[8] = 1.0
    else:
        pat = p.get("behavioral_patterns") or {}
        row[0] = float(p.get("risk_score", 0.5))
        row[1] = np.log1p(float(p.get("avg_transaction_amount", 0.0)))
        row[2] = float(p.get("transaction_frequency", 0.0))
        row[3] = float(p.get("account_age_days", 0.0)) / 365.0
        row[4] = float(str(p.get("kyc_status", "")) == "verified")
        row[5] = float(pat.get("weekend_activity", 0.5))
        row[6] = float(pat.get("international_transactions", 0.0) or 0.0)
        row[7] = float(pat.get("online_preference", 0.7))
    return row


def text_of(rec: Mapping[str, Any], mp: Mapping[str, Any] | None) -> str:
    """The text branch's input: merchant name, description, category and
    location, the present ones joined as "Field: value" by " | "."""
    mp = mp or {}
    fields = (("Merchant", mp.get("name") or str(rec.get("merchant_name", ""))),
              ("Description", str(rec.get("description", "") or "")),
              ("Category", str(mp.get("category", "") or "")),
              ("Location", str(rec.get("location", "") or "")))
    return " | ".join(f"{k}: {v}" for k, v in fields if v)


class Replay:
    def __init__(self, users: Mapping[str, Any], merchants: Mapping[str, Any],
                 ens: Dict[str, Any], vocab_size: int):
        self.users, self.merchants, self.ens = users, merchants, ens
        self.vel: Dict[str, List[float]] = {}
        self.hist: Dict[str, deque] = defaultdict(lambda: deque(maxlen=ens["seq_len"]))
        self.u_adj: Dict[str, deque] = defaultdict(lambda: deque(maxlen=ens["fanout"]))
        self.m_adj: Dict[str, deque] = defaultdict(lambda: deque(maxlen=ens["fanout"]))
        self.tokenizer = FraudTokenizer(vocab_size=vocab_size,
                                        max_length=ens["text_len"])
        self.batches: Dict[int, Sequence[Mapping[str, Any]]] = {}

    def run(self, events, keep) -> Dict[int, Dict[str, np.ndarray]]:
        """Walk the events; the branch inputs of the batches in ``keep``."""
        out = {}
        for ev in events:
            if ev[0] == "D":
                _, k, records = ev
                self.batches[k] = records
                inputs = self._assemble(records, full=k in keep)
                if k in keep:
                    out[k] = inputs
            else:
                for r in self.batches.pop(ev[1]):
                    v = self.vel.setdefault(str(r.get("user_id", "")), [0.0, 0.0])
                    v[0] += 1
                    v[1] += float(r.get("amount", 0.0))
        return out

    def _assemble(self, records, full: bool) -> Dict[str, np.ndarray]:
        ens = self.ens
        uids = [str(r.get("user_id", "")) for r in records]
        mids = [str(r.get("merchant_id", "")) for r in records]
        uprofs = {u: self.users[u] for u in uids if u in self.users}
        mprofs = {m: self.merchants[m] for m in mids if m in self.merchants}
        vels = {}
        for u in set(uids):
            c = self.vel.get(u)
            vels[u] = ({w: {"count": c[0], "amount": c[1]} for w in WINDOWS}
                       if c else {w: {} for w in WINDOWS})
        txn = encode_transactions(records, uprofs, mprofs, vels)
        feats = extract_features_host(txn)
        t, f = ens["seq_len"], ens["feature_dim"]
        hist = np.zeros((len(records), t, f), np.float32)
        hlen = np.zeros((len(records),), np.int32)
        for i, u in enumerate(uids):
            ring = self.hist[u]
            ring.append(feats[i])
            hlen[i] = len(ring)
            hist[i, t - len(ring):] = np.stack(list(ring))
        out = None
        if full:
            d, k = ens["node_dim"], ens["fanout"]
            b = len(records)
            un = np.zeros((b, k, d), np.float32)
            mn = np.zeros((b, k, d), np.float32)
            un_m = np.zeros((b, k), bool)
            mn_m = np.zeros((b, k), bool)
            for i, (u, m) in enumerate(zip(uids, mids)):
                for j, mm in enumerate(self.u_adj.get(u, ())):
                    un[i, j] = node_row(self.merchants.get(mm), True, d)
                    un_m[i, j] = True
                for j, uu in enumerate(self.m_adj.get(m, ())):
                    mn[i, j] = node_row(self.users.get(uu), False, d)
                    mn_m[i, j] = True
            ids, mask = self.tokenizer.encode_batch(
                [text_of(r, mprofs.get(m)) for r, m in zip(records, mids)])
            out = {"txn": txn, "features": feats, "history": hist,
                   "history_len": hlen,
                   "user_feat": np.stack([node_row(self.users.get(u), False, d)
                                          for u in uids]),
                   "merchant_feat": np.stack([node_row(self.merchants.get(m), True, d)
                                              for m in mids]),
                   "user_neigh_feat": un, "user_neigh_mask": un_m,
                   "merch_neigh_feat": mn, "merch_neigh_mask": mn_m,
                   "token_ids": ids.astype(np.int32), "token_mask": mask.astype(bool),
                   "ids": [str(r.get("transaction_id", "")) for r in records]}
        for u, m in zip(uids, mids):
            self.u_adj[u].append(m)
            self.m_adj[m].append(u)
        return out
