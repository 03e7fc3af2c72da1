"""Serve-time neighbourhood sampling: typed graph -> padded GNN tensors.

Port of the JAX package's ``graph/sampler.py`` for one partition's store.
Per microbatch it builds the dense fixed-shape tensors the typed GNN takes:
``[B, K, D]`` frontier features and masks and ``[B, K, K2, D]`` two-hop
context, walking the typed graph across edge types:

- user centres: the 1-hop frontier is the user's recent devices, IPs and
  merchants interleaved most recent first; the 2-hop context is each
  frontier entity's USER ring with the centre excluded (a benign device's
  is empty, a ring device's holds the cohort);
- merchant centres: the 1-hop frontier is the merchant's recent users, the
  2-hop context those users' merchant rings.

**Cache.** Samples are cached per centre id. The graph reports which ids'
adjacency changed (``drain_dirty``) and ``sync`` evicts exactly the
entries depending on them (centre id and frontier ids); entries also age
out after ``max_entry_age`` syncs (a counter of syncs, not a clock), an
ownership-epoch change clears the cache, and a full cache is cleared
before a batch's probes.

The entity-keyed two-hop rings (``device->user``, ``ip->user``,
``merchant->user``) are the rings a fraud ring spreads across partitions, so
those, and only those, are resolved across partitions through an attached
``graph/fetch.py GraphFetchClient`` (``fetch=`` or ``attach_fetch``): one
fetch window a batch, at most one fetch an edge type, budgeted, deadlined,
degraded to the local subgraph on any failure.

Determinism: a pure function of (graph state, fetch responses); every
iteration is over insertion-ordered dicts or sorted lists.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from realtime_fraud_detection_tpu_torch.graph.store import merge_neighbor_lists
from realtime_fraud_detection_tpu_torch.models.gnn import (
    MERCHANT_TAG_SLOT,
    typed_entity_features,
)

__all__ = ["NeighborSampler"]

# the entity-keyed rings resolved across partitions (a ring's shared devices,
# IPs and merchants gather user edges in every partition its members hash
# to); user-keyed rings are local by ownership
REMOTE_EDGE_TYPES = ("device->user", "ip->user", "merchant->user")

_KIND_TO_USER_EDGE = {"device": "device->user", "ip": "ip->user",
                      "merchant": "merchant->user"}


class _Entry:
    """One cached centre sample and its adjacency dependencies. ``born`` is
    the sampler's sync count at build time; age is checked at probe time."""

    __slots__ = ("feat", "mask", "feat2", "mask2", "deps", "born")

    def __init__(self, feat, mask, feat2, mask2, deps, born):
        self.feat = feat
        self.mask = mask
        self.feat2 = feat2
        self.mask2 = mask2
        self.deps = deps
        self.born = born


class NeighborSampler:
    """Deterministic fixed-fan-out two-hop sampler with a dependency-evicting
    cache.

    ``user_rows`` / ``merchant_rows`` resolve known centre-table feature rows
    for user / merchant ids without creating entries (the scorer's
    ``_EntityIndex.peek_rows``); unknown ids resolve to zero rows.
    """

    def __init__(self, graph: Any, node_dim: int, fanout: int,
                 fanout2: int,
                 user_rows: Callable[[Sequence[str]], np.ndarray],
                 merchant_rows: Callable[[Sequence[str]], np.ndarray],
                 max_entries: int = 65_536, max_entry_age: int = 64,
                 fetch: Optional[Any] = None):
        self.graph = graph
        self.node_dim = int(node_dim)
        self.fanout = int(fanout)
        self.fanout2 = int(fanout2)
        self._user_rows = user_rows
        self._merchant_rows = merchant_rows
        self.fetch = fetch
        self.max_entries = max(1, int(max_entries))
        self.max_entry_age = max(1, int(max_entry_age))
        self._cache: Dict[str, _Entry] = {}
        self._deps: Dict[str, set] = {}      # entity id -> dependent keys
        self._epoch_seen = getattr(graph, "ownership_epoch", 0)
        self._syncs = 0                      # the age-out clock
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def attach_fetch(self, client: Any) -> None:
        self.fetch = client

    # ------------------------------------------------------------ coherence
    def sync(self) -> None:
        """Post-ingest coherence pass (the scorer calls it right after the
        write-back's graph ingest): evict the entries whose dependencies
        changed, advance the age-out clock, and clear everything on an
        ownership-epoch change."""
        self._syncs += 1
        epoch = getattr(self.graph, "ownership_epoch", 0)
        if epoch != self._epoch_seen:
            self._epoch_seen = epoch
            self.evictions += len(self._cache)
            self._cache.clear()
            self._deps.clear()
            self.graph.drain_dirty()
            return
        for eid in self.graph.drain_dirty():
            for key in self._deps.pop(eid, ()):
                if self._cache.pop(key, None) is not None:
                    self.evictions += 1

    def _fresh(self, key: str) -> bool:
        """Is there a live entry for ``key`` younger than ``max_entry_age``
        syncs? An aged one is evicted here and reported as a miss."""
        entry = self._cache.get(key)
        if entry is None:
            return False
        if self._syncs - entry.born >= self.max_entry_age:
            self._evict(key)
            return False
        return True

    def _evict(self, key: str) -> None:
        entry = self._cache.pop(key, None)
        if entry is None:
            return
        self.evictions += 1
        for dep in entry.deps:
            keys = self._deps.get(dep)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._deps[dep]

    def _store(self, key: str, entry: _Entry) -> None:
        self._cache[key] = entry
        for dep in entry.deps:
            self._deps.setdefault(dep, set()).add(key)

    # ------------------------------------------------------------- sampling
    def sample(self, user_ids: Sequence[str], merchant_ids: Sequence[str],
               ) -> Dict[str, np.ndarray]:
        """One microbatch's neighbour tensors (``ScoreBatch`` fields).

        One fetch window (budget and deadline) covers the whole batch; the
        remote rings every missed centre needs go out as at most one fetch
        an entity-keyed edge type."""
        b = len(user_ids)
        k, k2, d = self.fanout, self.fanout2, self.node_dim
        out = {
            "user_neigh_feat": np.zeros((b, k, d), np.float32),
            "user_neigh_mask": np.zeros((b, k), bool),
            "user_neigh2_feat": np.zeros((b, k, k2, d), np.float32),
            "user_neigh2_mask": np.zeros((b, k, k2), bool),
            "merch_neigh_feat": np.zeros((b, k, d), np.float32),
            "merch_neigh_mask": np.zeros((b, k), bool),
            "merch_neigh2_feat": np.zeros((b, k, k2, d), np.float32),
            "merch_neigh2_mask": np.zeros((b, k, k2), bool),
        }
        if b == 0:
            return out
        if self.fetch is not None:
            self.fetch.begin_batch()
        if len(self._cache) >= self.max_entries:
            # cleared BEFORE the probes: within one call entries only grow,
            # so every probed or built centre is resident at the scatter
            self.evictions += len(self._cache)
            self._cache.clear()
            self._deps.clear()

        # probe, and discover the frontier of each miss
        u_missing: Dict[str, List[Tuple[str, str]]] = {}
        m_missing: Dict[str, None] = {}      # ordered id set
        for uid in dict.fromkeys(str(u) for u in user_ids):
            if self._fresh(f"u:{uid}"):
                self.hits += 1
                continue
            devs, mers, ips = (
                self.graph.neighbors(et, [uid], k)[0]
                for et in ("user->device", "user->merchant", "user->ip"))
            u_missing[uid] = self._interleave(devs, ips, mers)
        for mid in dict.fromkeys(str(m) for m in merchant_ids):
            if self._fresh(f"m:{mid}"):
                self.hits += 1
                continue
            m_missing[mid] = None

        # one batched remote resolution an entity-keyed edge type
        remote: Dict[str, List[Dict[str, List[str]]]] = {
            et: [] for et in REMOTE_EDGE_TYPES}
        if self.fetch is not None and (u_missing or m_missing):
            need: Dict[str, List[str]] = {et: [] for et in REMOTE_EDGE_TYPES}
            for frontier in u_missing.values():
                for kind, eid in frontier:
                    need[_KIND_TO_USER_EDGE[kind]].append(eid)
            need["merchant->user"].extend(m_missing)
            for et in REMOTE_EDGE_TYPES:
                ids = sorted(dict.fromkeys(need[et]))
                if ids:
                    maps, _degraded = self.fetch.fetch(et, ids, k)
                    remote[et] = maps

        for uid, frontier in u_missing.items():
            self._store(f"u:{uid}", self._build_user(uid, frontier, remote))
            self.misses += 1
        for mid in m_missing:
            self._store(f"m:{mid}", self._build_merchant(mid, remote))
            self.misses += 1

        # scatter the (now fully cached) rows
        for i, uid in enumerate(str(u) for u in user_ids):
            e = self._cache[f"u:{uid}"]
            out["user_neigh_feat"][i] = e.feat
            out["user_neigh_mask"][i] = e.mask
            out["user_neigh2_feat"][i] = e.feat2
            out["user_neigh2_mask"][i] = e.mask2
        for i, mid in enumerate(str(m) for m in merchant_ids):
            e = self._cache[f"m:{mid}"]
            out["merch_neigh_feat"][i] = e.feat
            out["merch_neigh_mask"][i] = e.mask
            out["merch_neigh2_feat"][i] = e.feat2
            out["merch_neigh2_mask"][i] = e.mask2
        if self.fetch is not None:
            self.fetch.end_batch()
        return out

    # ----------------------------------------------------------- internals
    def _interleave(self, devs: List[str], ips: List[str],
                    mers: List[str]) -> List[Tuple[str, str]]:
        """Typed frontier slots: devices, IPs and merchants interleaved most
        recent first (rings are oldest first), at most ``fanout``."""
        streams = (("device", list(reversed(devs))),
                   ("ip", list(reversed(ips))),
                   ("merchant", list(reversed(mers))))
        frontier: List[Tuple[str, str]] = []
        i = 0
        while len(frontier) < self.fanout:
            added = False
            for kind, ring in streams:
                if i < len(ring):
                    frontier.append((kind, ring[i]))
                    added = True
                    if len(frontier) >= self.fanout:
                        break
            if not added:
                break
            i += 1
        return frontier

    def _users_of(self, kind: str, eid: str,
                  remote: Dict[str, List[Dict[str, List[str]]]]) -> List[str]:
        """The local ring of ``eid`` merged with its fetched remote shares."""
        et = _KIND_TO_USER_EDGE[kind]
        local = {eid: self.graph.neighbors(et, [eid], self.fanout)[0]}
        return merge_neighbor_lists(local, remote.get(et, ()), [eid],
                                    self.fanout)[eid]

    def _build_user(self, uid: str, frontier: List[Tuple[str, str]],
                    remote: Dict[str, List[Dict[str, List[str]]]]) -> _Entry:
        k, k2, d = self.fanout, self.fanout2, self.node_dim
        feat = np.zeros((k, d), np.float32)
        mask = np.zeros((k,), bool)
        feat2 = np.zeros((k, k2, d), np.float32)
        mask2 = np.zeros((k, k2), bool)
        deps = {uid}
        for j, (kind, eid) in enumerate(frontier):
            deps.add(eid)
            users = [u for u in self._users_of(kind, eid, remote)
                     if u != uid][-k2:]
            if kind == "merchant":
                feat[j] = self._merchant_row(eid)
            else:
                feat[j] = typed_entity_features(
                    kind, np.asarray([len(users) + 1], np.float32), d, k2)[0]
            mask[j] = True
            if users:
                feat2[j, : len(users)] = self._user_rows(users)
                mask2[j, : len(users)] = True
        return _Entry(feat, mask, feat2, mask2, deps, self._syncs)

    def _build_merchant(self, mid: str,
                        remote: Dict[str, List[Dict[str, List[str]]]]) -> _Entry:
        k, k2, d = self.fanout, self.fanout2, self.node_dim
        feat = np.zeros((k, d), np.float32)
        mask = np.zeros((k,), bool)
        feat2 = np.zeros((k, k2, d), np.float32)
        mask2 = np.zeros((k, k2), bool)
        users = self._users_of("merchant", mid, remote)[-k:]
        deps = {mid, *users}
        if users:
            feat[: len(users)] = self._user_rows(users)
            mask[: len(users)] = True
            # each frontier user's merchant ring, this merchant excluded
            # (local by ownership: a user this worker does not own has an
            # empty ring here)
            rings = self.graph.neighbors("user->merchant", users, k2)
            for j, ring in enumerate(rings):
                ring = [m for m in ring if m != mid][-k2:]
                if ring:
                    rows = np.stack([self._merchant_row(m) for m in ring])
                    feat2[j, : len(ring)] = rows
                    mask2[j, : len(ring)] = True
        return _Entry(feat, mask, feat2, mask2, deps, self._syncs)

    def _merchant_row(self, mid: str) -> np.ndarray:
        row = np.asarray(self._merchant_rows([mid])[0], np.float32).copy()
        # a cold merchant (no profile row yet) still carries its type tag
        row[MERCHANT_TAG_SLOT] = 1.0
        return row

    # ------------------------------------------------------------- summary
    def stats(self) -> Dict[str, Any]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "entries": len(self._cache),
                "fanout": self.fanout, "fanout2": self.fanout2}
