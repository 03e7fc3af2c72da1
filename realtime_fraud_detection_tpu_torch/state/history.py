"""Per-entity history: sequence ring buffers and the user-merchant graph.

Port of the JAX package's ``state/history.py``. The histories live on the
host in preallocated numpy tables, so a whole microbatch gathers into dense
``(B, T, F)`` and neighbour tensors without per-row Python work:

- ``UserHistoryStore``: a (T, F) float ring per user -> the LSTM input
  (sequence length 10, config.py:151-157);
- ``EntityGraphStore``: bounded user <-> merchant neighbour rings -> the
  bipartite GNN's neighbour sampling (fan-out K).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np


def _occurrence_index(slots: np.ndarray) -> np.ndarray:
    """occ[i] = number of earlier rows in this batch with the same slot."""
    occ = np.zeros((len(slots),), np.int64)
    seen: Dict[int, int] = {}
    get = seen.get
    for i, s in enumerate(slots.tolist()):
        k = get(s, 0)
        occ[i] = k
        seen[s] = k + 1
    return occ


class UserHistoryStore:
    """Ring buffer of recent feature vectors per user.

    Storage is one dense (capacity, T, F) slot table plus a uid -> slot map:
    a microbatch appends with one fancy-index scatter and gathers with one
    indexed read.
    """

    def __init__(self, seq_len: int = 10, feature_dim: int = 64):
        self.seq_len = seq_len
        self.feature_dim = feature_dim
        self._slots: Dict[str, int] = {}
        cap = 1024
        self._table = np.zeros((cap, seq_len, feature_dim), np.float32)
        self._counts = np.zeros((cap,), np.int64)

    def __getstate__(self) -> Dict:
        """Pickle the used slot rows only: a checkpoint or a partition's
        handoff snapshot (``cluster/partition.py``) is sized by occupancy,
        not by the preallocated capacity (``_grow`` doubles from the trimmed
        size after a restore)."""
        used = max(len(self._slots), 1)
        state = dict(self.__dict__)
        state["_table"] = self._table[:used].copy()
        state["_counts"] = self._counts[:used].copy()
        return state

    def _grow(self, need: int) -> None:
        cap = self._table.shape[0]
        if need <= cap:
            return
        new_cap = cap
        while new_cap < need:
            new_cap *= 2
        table = np.zeros((new_cap, self.seq_len, self.feature_dim), np.float32)
        table[:cap] = self._table
        counts = np.zeros((new_cap,), np.int64)
        counts[:cap] = self._counts
        self._table, self._counts = table, counts

    def _slot_ids(self, user_ids: Sequence[str], create: bool) -> np.ndarray:
        """uid -> slot indices; unknown uids get fresh slots (``create``)
        or the sentinel -1, which ``_gather_slots`` masks to zero rows."""
        slots = np.empty((len(user_ids),), np.int64)
        get = self._slots.get
        for i, uid in enumerate(user_ids):
            s = get(uid)
            if s is None:
                if not create:
                    s = -1
                else:
                    s = len(self._slots)
                    self._slots[uid] = s
            slots[i] = s
        if create and self._slots:
            self._grow(len(self._slots))
        return slots

    def _scatter_append(self, slots: np.ndarray, features: np.ndarray,
                        occ: np.ndarray) -> None:
        """Ring-write one row per (slot, occurrence); duplicate (slot, pos)
        targets resolve last-write-wins in index order, the sequential ring
        semantics."""
        pos = (self._counts[slots] + occ) % self.seq_len
        self._table[slots, pos] = features
        np.add.at(self._counts, slots, 1)

    def append_batch(self, user_ids: Sequence[str], features: np.ndarray) -> None:
        """Append one feature row per user (features: [B, F]), in order."""
        if not len(user_ids):
            return
        slots = self._slot_ids(user_ids, create=True)
        occ = _occurrence_index(slots)
        self._scatter_append(slots, np.asarray(features, np.float32), occ)

    def _gather_slots(self, slots: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Dense (B, T, F) oldest-first readout for resolved slots
        (slot -1 = never seen -> zero rows, length 0)."""
        t = self.seq_len
        safe = np.maximum(slots, 0)
        counts = np.where(slots >= 0, self._counts[safe], 0)
        k = np.minimum(counts, t)
        # output position j holds ring[(count - k + (j - (T - k))) % T]
        # for j >= T - k, zero-pad in front of that
        jj = np.arange(t)[None, :] - (t - k[:, None])
        src = (counts[:, None] - k[:, None] + np.maximum(jj, 0)) % t
        vals = self._table[safe[:, None], src]
        out = np.where((jj >= 0)[:, :, None], vals, np.float32(0.0))
        return out, k.astype(np.int32)

    def append_and_gather(
        self, user_ids: Sequence[str], features: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Per row, in order: append the row, then gather that user's state,
        so each transaction is scored against a history that ends with
        itself. Vectorized in occurrence rounds: round r handles every row
        that is its user's (r+1)-th in this batch, so a user's later rows
        see its earlier rows' appends."""
        b = len(user_ids)
        out = np.zeros((b, self.seq_len, self.feature_dim), np.float32)
        lengths = np.zeros((b,), np.int32)
        if not b:
            return out, lengths
        features = np.asarray(features, np.float32)
        slots = self._slot_ids(user_ids, create=True)
        occ = _occurrence_index(slots)
        for r in range(int(occ.max()) + 1):
            rows = np.nonzero(occ == r)[0]
            rs = slots[rows]
            self._scatter_append(rs, features[rows],
                                 np.zeros((len(rows),), np.int64))
            out[rows], lengths[rows] = self._gather_slots(rs)
        return out, lengths

    def gather(self, user_ids: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Dense (B, T, F) history, oldest first and zero-padded in front,
        plus the lengths (B,); a user never seen reads zero rows."""
        if not len(user_ids):
            return (np.zeros((0, self.seq_len, self.feature_dim), np.float32),
                    np.zeros((0,), np.int32))
        return self._gather_slots(self._slot_ids(user_ids, create=False))

    def user_ids(self) -> List[str]:
        """Users with any history, in first-seen order (the state digests'
        iteration seam)."""
        return list(self._slots)

    def __len__(self) -> int:
        return len(self._slots)


class EntityGraphStore:
    """Bounded bipartite adjacency between users and merchants.

    Node ids are stable integer indices. Each side keeps a ring of its K
    most recent counterparties; sampling pads with -1 and returns a mask.
    """

    def __init__(self, fanout: int = 16):
        self.fanout = fanout
        self._user_adj: Dict[int, List[int]] = {}
        self._merchant_adj: Dict[int, List[int]] = {}

    def add_edges(self, user_idx: Iterable[int], merchant_idx: Iterable[int]) -> None:
        for u, m in zip(user_idx, merchant_idx):
            u, m = int(u), int(m)
            ua = self._user_adj.setdefault(u, [])
            ua.append(m)
            del ua[:-self.fanout]
            ma = self._merchant_adj.setdefault(m, [])
            ma.append(u)
            del ma[:-self.fanout]

    def _sample(self, adj: Dict[int, List[int]], ids: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        b, k = len(ids), self.fanout
        out = np.full((b, k), -1, np.int32)
        for i, n in enumerate(ids):
            neigh = adj.get(int(n))
            if neigh:
                out[i, : len(neigh)] = neigh[-k:]
        return out, out >= 0

    def user_neighbors(self, user_idx: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        """Merchant neighbours of users -> (idx [B,K], mask [B,K])."""
        return self._sample(self._user_adj, user_idx)

    def merchant_neighbors(self, merchant_idx: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        """User neighbours of merchants -> (idx [B,K], mask [B,K])."""
        return self._sample(self._merchant_adj, merchant_idx)

    def _two_hop(self, first_adj, second_adj, ids):
        hop1, mask1 = self._sample(first_adj, ids)
        b, k = hop1.shape
        flat_idx = np.where(mask1, hop1, 0).reshape(-1)
        hop2, mask2 = self._sample(second_adj, flat_idx)
        hop2 = hop2.reshape(b, k, k)
        mask2 = mask2.reshape(b, k, k) & mask1[:, :, None]
        return hop1, mask1, hop2, mask2

    def user_two_hop(self, user_idx: Sequence[int]):
        """1-hop merchants + their 2-hop users:
        (hop1 [B,K], mask1, hop2 [B,K,K], mask2) for the GNN's 2-hop path."""
        return self._two_hop(self._user_adj, self._merchant_adj, user_idx)

    def merchant_two_hop(self, merchant_idx: Sequence[int]):
        """1-hop users + their 2-hop merchants."""
        return self._two_hop(self._merchant_adj, self._user_adj, merchant_idx)
