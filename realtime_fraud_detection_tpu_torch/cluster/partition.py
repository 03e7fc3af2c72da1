"""Key-partitioned state: the stores, sliced by the transport's hash.

Port of the JAX package's ``cluster/partition.py``. All host state the
stream job mutates per transaction (profiles, velocity windows, the
transaction cache, the history rings, the labelled buffer, the typed graph)
is keyed by ``user_id``, and the transactions topic is partitioned by the
same key, so the partition is the unit of state ownership: the worker that
consumes partition ``p`` owns exactly the state of the users hashing to
``p``, and a handoff moves whole partitions.

- :class:`PartitionState`: one partition's store bundle, snapshottable
  (pickle) and content-digestable (``digest``: the JSON and sha256 recipe of
  the JAX package, so a digest compares across the packages on the same
  state);
- :class:`PartitionedStore`: the owned-partition map plus store facades
  (``.profiles`` / ``.velocity`` / ``.txn_cache`` / ``.history`` /
  ``.graph``) that route every call by user key with the interfaces
  ``TorchFraudScorer`` and ``StreamJob`` consume, so a scorer built over them
  (``TorchFraudScorer(stores=...)``) is partition-parallel without knowing
  it.

Merchant profiles are not partitioned: they are read-mostly reference data
every worker needs, replicated fleet-wide like the models.
"""

from __future__ import annotations

import hashlib
import json
import pickle
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

from realtime_fraud_detection_tpu_torch.cluster.hashring import partition_for_key
from realtime_fraud_detection_tpu_torch.graph.store import (
    EDGE_TYPES,
    TypedEntityGraph,
    merge_neighbor_lists,
)
from realtime_fraud_detection_tpu_torch.state.history import UserHistoryStore
from realtime_fraud_detection_tpu_torch.state.labeled import LabeledExampleBuffer
from realtime_fraud_detection_tpu_torch.state.stores import (
    ProfileStore,
    TransactionCache,
    VelocityStore,
)

__all__ = ["PartitionState", "PartitionedStore", "PartitionNotOwned"]


class PartitionNotOwned(KeyError):
    """A key routed to a partition this store does not own — a routing
    bug (router/fleet disagreement) surfacing loudly, never as silently
    missing state."""


class PartitionState:
    """One partition's complete mutable-state bundle."""

    def __init__(self, seq_len: int = 10, feature_dim: int = 64,
                 labeled_capacity: int = 1024,
                 cache_kwargs: Optional[Mapping[str, Any]] = None,
                 graph_fanout: int = 16):
        self.seq_len = int(seq_len)
        self.feature_dim = int(feature_dim)
        self.labeled_capacity = int(labeled_capacity)
        self.cache_kwargs = dict(cache_kwargs or {})
        self.graph_fanout = int(graph_fanout)
        self.profiles = ProfileStore()
        self.velocity = VelocityStore()
        self.txn_cache = TransactionCache(**self.cache_kwargs)
        self.history = UserHistoryStore(self.seq_len, self.feature_dim)
        self.labeled = LabeledExampleBuffer(
            capacity=max(self.labeled_capacity, 10))
        # typed entity graph (graph/store.py): edge data partitioned by
        # the TRANSACTION's user key, so graph writes are always local to
        # the owning worker and the bundle rides handoff snapshot /
        # SIGKILL replay / the drill digests exactly like the other stores
        self.graph = TypedEntityGraph(self.graph_fanout)

    # ------------------------------------------------------------- handoff
    def snapshot_bytes(self) -> bytes:
        """Serialized copy for the handoff store. A VALUE copy: the live
        stores keep mutating after the snapshot; the blob stays pinned to
        the offsets it was keyed to."""
        return pickle.dumps(self, protocol=pickle.HIGHEST_PROTOCOL)

    @staticmethod
    def restore_bytes(blob: bytes) -> "PartitionState":
        state = pickle.loads(blob)
        if not isinstance(state, PartitionState):
            raise ValueError(
                f"handoff blob decoded to {type(state).__name__}, "
                f"not PartitionState")
        return state

    # -------------------------------------------------------------- digest
    def digest(self, now: Optional[float] = None) -> str:
        """Deterministic content hash over everything the oracle-equality
        check cares about: user profiles, velocity windows, per-user
        history rings, and the txn cache's (id → score/decision) map.
        Stable across pickling round trips and across different BATCHINGS
        of the same per-partition record sequence (state updates are
        keyed to event time, so batch boundaries leave no residue).
        ``now`` is the TTL clock for the cache listing — pass the run's
        virtual end time on a virtual timeline (the default would expire
        virtual-time entries against the wall clock)."""
        h = hashlib.sha256()

        def feed(obj: Any) -> None:
            h.update(json.dumps(obj, sort_keys=True,
                                default=str).encode())

        feed({"users": self.profiles.users})
        feed(self.velocity.entries())
        feed([(tid, round(float(v.get("fraud_score", -1.0)), 6),
               str(v.get("decision", "")))
              for tid, v in self.txn_cache.entries(now)])
        uids = sorted(self.history.user_ids())
        feed(uids)
        if uids:
            hist, lens = self.history.gather(uids)
            h.update(np.ascontiguousarray(
                np.round(hist, 5).astype(np.float32)).tobytes())
            h.update(np.ascontiguousarray(lens.astype(np.int64)).tobytes())
        feed({"labeled": self.labeled.stats()})
        feed({"graph": self.graph.digest()})
        return h.hexdigest()


# ---------------------------------------------------------------- facades


class _ProfilesFacade:
    """ProfileStore interface over the owned-partition map. User profiles
    route by key; merchant profiles live in the shared replicated store."""

    def __init__(self, store: "PartitionedStore"):
        self._store = store

    @property
    def generation(self) -> int:
        # columnar-assembly cache coherence (features/schema.EntityRowCache
        # compares this stamp): sum of per-partition generations — any
        # partition's write (or a handoff swapping a whole partition in)
        # changes the sum
        return (sum(s.profiles.generation
                    for s in self._store.states().values())
                + self._store.merchants_generation)

    def seed(self, users: Optional[Mapping[str, Mapping[str, Any]]] = None,
             merchants: Optional[Mapping[str, Mapping[str, Any]]] = None,
             ) -> None:
        if users:
            for uid, prof in users.items():
                self._store.state_for_user(uid).profiles.seed(
                    users={uid: prof})
        if merchants:
            self._store.shared_merchants.update(merchants)
            self._store.merchants_generation += 1

    def get_user(self, user_id: str) -> Optional[Mapping[str, Any]]:
        return self._store.state_for_user(user_id).profiles.get_user(user_id)

    def put_user(self, user_id: str, profile: Mapping[str, Any]) -> None:
        self._store.state_for_user(user_id).profiles.put_user(user_id,
                                                              profile)

    def get_merchant(self, merchant_id: str) -> Optional[Mapping[str, Any]]:
        return self._store.shared_merchants.get(merchant_id)

    def put_merchant(self, merchant_id: str,
                     profile: Mapping[str, Any]) -> None:
        self._store.shared_merchants[merchant_id] = profile
        self._store.merchants_generation += 1


class _VelocityFacade:
    def __init__(self, store: "PartitionedStore"):
        self._store = store

    def update(self, user_id: str, amount: float, now: float) -> None:
        self._store.state_for_user(user_id).velocity.update(
            user_id, amount, now)

    def update_batch(self, user_ids, amounts, now: float) -> None:
        for uid, amt in zip(user_ids, amounts):
            self.update(uid, float(amt), now)

    def get(self, user_id: str, window: str,
            now: Optional[float] = None) -> Dict[str, float]:
        return self._store.state_for_user(user_id).velocity.get(
            user_id, window, now)

    def get_all(self, user_id: str,
                now: Optional[float] = None) -> Dict[str, Dict[str, float]]:
        return self._store.state_for_user(user_id).velocity.get_all(
            user_id, now)


class _TxnCacheFacade:
    """TransactionCache interface. Writes route by the transaction's own
    user key; id-only reads scan the owned partitions (a user's records
    always land in one partition, so a hit is unique; the scan is a
    handful of dict lookups)."""

    def __init__(self, store: "PartitionedStore"):
        self._store = store

    def cache_transaction(self, txn: Mapping[str, Any],
                          now: Optional[float] = None) -> None:
        uid = str(txn.get("user_id", ""))
        self._store.state_for_user(uid).txn_cache.cache_transaction(
            txn, now=now)

    def get_transaction(self, txn_id: str,
                        now: Optional[float] = None) -> Any:
        for state in self._store.states().values():
            hit = state.txn_cache.get_transaction(txn_id, now=now)
            if hit is not None:
                return hit
        return None

    def store_features(self, txn_id: str, features: Any,
                       now: Optional[float] = None) -> None:
        # features are keyed by txn id alone; store them with the txn's
        # user partition when the txn is cached. For an unknown txn the
        # id hashes to an arbitrary partition this worker almost surely
        # does NOT own — fall back to an owned partition picked by the
        # id hash (get_features scans every owned partition, so reads
        # still hit; the blob is worker-local best-effort cache, not
        # handed-off truth)
        txn = self.get_transaction(txn_id, now=now)
        if txn is not None:
            state = self._store.state_for_user(str(txn.get("user_id", "")))
        else:
            owned = self._store.owned()
            if not owned:
                raise PartitionNotOwned(
                    f"cannot store features for {txn_id!r}: no owned "
                    f"partitions")
            state = self._store.state(
                owned[partition_for_key(str(txn_id), len(owned))])
        state.txn_cache.store_features(txn_id, features, now=now)

    def get_features(self, txn_id: str, now: Optional[float] = None) -> Any:
        for state in self._store.states().values():
            hit = state.txn_cache.get_features(txn_id, now=now)
            if hit is not None:
                return hit
        return None

    def get_user_transactions(self, user_id: str,
                              limit: int = 100) -> List[str]:
        return self._store.state_for_user(
            user_id).txn_cache.get_user_transactions(user_id, limit)

    def get_merchant_transactions(self, merchant_id: str,
                                  limit: int = 500) -> List[str]:
        out: List[str] = []
        for state in self._store.states().values():
            out.extend(state.txn_cache.get_merchant_transactions(
                merchant_id, limit))
        return out[:limit]


class _HistoryFacade:
    """UserHistoryStore interface with per-user routing. Batch calls are
    regrouped by partition and scattered back in input order, preserving
    the store's sequential per-user semantics (a user's rows all live in
    one partition, so in-batch duplicate handling is unchanged)."""

    def __init__(self, store: "PartitionedStore"):
        self._store = store

    @property
    def seq_len(self) -> int:
        return self._store.seq_len

    @property
    def feature_dim(self) -> int:
        return self._store.feature_dim

    def _group(self, user_ids: Sequence[str]) -> Dict[int, List[int]]:
        groups: Dict[int, List[int]] = {}
        for i, uid in enumerate(user_ids):
            groups.setdefault(self._store.partition_for(uid), []).append(i)
        return groups

    def append_batch(self, user_ids: Sequence[str],
                     features: np.ndarray) -> None:
        if not len(user_ids):
            return
        features = np.asarray(features, np.float32)
        for p, idxs in self._group(user_ids).items():
            self._store.state(p).history.append_batch(
                [user_ids[i] for i in idxs], features[idxs])

    def append_and_gather(self, user_ids: Sequence[str],
                          features: np.ndarray):
        b = len(user_ids)
        out = np.zeros((b, self.seq_len, self.feature_dim), np.float32)
        lens = np.zeros((b,), np.int32)
        if not b:
            return out, lens
        features = np.asarray(features, np.float32)
        for p, idxs in self._group(user_ids).items():
            sub_out, sub_lens = self._store.state(p).history.append_and_gather(
                [user_ids[i] for i in idxs], features[idxs])
            out[idxs], lens[idxs] = sub_out, sub_lens
        return out, lens

    def gather(self, user_ids: Sequence[str]):
        b = len(user_ids)
        out = np.zeros((b, self.seq_len, self.feature_dim), np.float32)
        lens = np.zeros((b,), np.int32)
        if not b:
            return out, lens
        for p, idxs in self._group(user_ids).items():
            sub_out, sub_lens = self._store.state(p).history.gather(
                [user_ids[i] for i in idxs])
            out[idxs], lens[idxs] = sub_out, sub_lens
        return out, lens

    def __len__(self) -> int:
        return sum(len(s.history) for s in self._store.states().values())


class _GraphFacade:
    """TypedEntityGraph interface over the owned-partition map.

    Writes route by the transaction's USER key — the same affinity rule
    as every other store, so graph mutation is always partition-local
    and the bundle hands off with its partition. Reads for user-keyed
    edge types (``user->*``) route the same way; entity-keyed reads
    (``device->user`` etc.) merge the OWNED partitions' rings (a device
    shared by users of several owned partitions has its adjacency spread
    across them); non-owned shares are the fetch plane's job
    (the JAX package's graph/fetch.py, not ported yet), not this facade's."""

    def __init__(self, store: "PartitionedStore"):
        self._store = store

    @property
    def fanout(self) -> int:
        return self._store.graph_fanout

    @property
    def generation(self) -> int:
        # observability stamp (stats()/graph_snapshot): any partition's
        # ingest changes the sum. Coherence is drain_dirty +
        # ownership_epoch, not this counter.
        return sum(s.graph.generation
                   for s in self._store.states().values())

    @property
    def ownership_epoch(self) -> int:
        # wholesale-invalidation signal: acquire/release swap whole
        # graphs without per-id dirt (NeighborSampler.sync clears on it)
        return self._store.ownership_epoch

    def add_batch(self, user_ids: Sequence[str],
                  merchant_ids: Sequence[str],
                  device_ids: Sequence[str], ips: Sequence[str]) -> None:
        groups: Dict[int, List[int]] = {}
        for i, uid in enumerate(user_ids):
            groups.setdefault(self._store.partition_for(str(uid)),
                              []).append(i)
        for p, idxs in groups.items():
            self._store.state(p).graph.add_batch(
                [user_ids[i] for i in idxs],
                [merchant_ids[i] for i in idxs],
                [device_ids[i] for i in idxs],
                [ips[i] for i in idxs])

    def neighbors(self, edge_type: str, ids: Sequence[str],
                  fanout: Optional[int] = None) -> List[List[str]]:
        if edge_type not in EDGE_TYPES:
            raise ValueError(f"unknown edge type {edge_type!r}")
        k = self.fanout if fanout is None else max(1, int(fanout))
        if edge_type.startswith("user->"):
            out: List[List[str]] = [[] for _ in ids]
            groups: Dict[int, List[int]] = {}
            for i, uid in enumerate(ids):
                groups.setdefault(self._store.partition_for(str(uid)),
                                  []).append(i)
            for p, idxs in groups.items():
                state = self._store.states().get(p)
                if state is None:
                    continue      # non-owned user: cold locally, not a bug
                rings = state.graph.neighbors(
                    edge_type, [ids[i] for i in idxs], k)
                for i, ring in zip(idxs, rings):
                    out[i] = ring
            return out
        # entity-keyed: merge the owned partitions' rings in sorted
        # partition order (deterministic; cross-partition shares arrive
        # via the fetch plane)
        maps = [self._store.state(p).graph.neighbor_map(edge_type, ids, k)
                for p in self._store.owned()]
        if not maps:
            return [[] for _ in ids]
        merged = merge_neighbor_lists(maps[0], maps[1:], ids, k)
        return [merged[str(i)] for i in ids]

    def neighbor_map(self, edge_type: str, ids: Sequence[str],
                     fanout: Optional[int] = None) -> Dict[str, List[str]]:
        """Local merged view ({id: neighbors}, empties omitted) — the
        GraphFetchServer's read seam: exactly what THIS worker's owned
        partitions know, never a recursive remote fetch."""
        out: Dict[str, List[str]] = {}
        for i, ring in zip(ids, self.neighbors(edge_type, ids, fanout)):
            if ring:
                out[str(i)] = ring
        return out

    def degree(self, edge_type: str, ids: Sequence[str]) -> List[int]:
        return [len(r) for r in self.neighbors(edge_type, ids)]

    def drain_dirty(self) -> List[str]:
        dirty: set = set()
        for s in self._store.states().values():
            dirty.update(s.graph.drain_dirty())
        return sorted(dirty)

    def stats(self) -> Dict[str, Any]:
        per = [s.graph.stats() for s in self._store.states().values()]
        nodes = {t: sum(p["nodes"][t] for p in per) for t in
                 ("user", "device", "merchant", "ip")} if per else {}
        edges = {et: sum(p["edges"][et] for p in per)
                 for et in EDGE_TYPES} if per else {}
        return {"fanout": self.fanout, "generation": self.generation,
                "edges_added": sum(p["edges_added"] for p in per),
                "nodes": nodes, "edges": edges}


# ----------------------------------------------------------------- store


class PartitionedStore:
    """Owned-partition state map + routing facades.

    One instance per worker. The fleet acquires/releases partitions on
    rebalance (`acquire`/`release`); every facade call on an un-owned key
    raises :class:`PartitionNotOwned` — the affinity contract is enforced,
    not assumed.
    """

    def __init__(self, n_partitions: int, seq_len: int = 10,
                 feature_dim: int = 64, labeled_capacity: int = 1024,
                 cache_kwargs: Optional[Mapping[str, Any]] = None,
                 graph_fanout: int = 16):
        if n_partitions < 1:
            raise ValueError(
                f"n_partitions must be >= 1, got {n_partitions}")
        self.n_partitions = int(n_partitions)
        self.seq_len = int(seq_len)
        self.feature_dim = int(feature_dim)
        self.labeled_capacity = int(labeled_capacity)
        self.cache_kwargs = dict(cache_kwargs or {})
        self.graph_fanout = int(graph_fanout)
        self._states: Dict[int, PartitionState] = {}
        # bumped on every acquire/release: a handoff swaps WHOLE graphs
        # in/out without marking per-id dirt, so ownership changes are the
        # sampler cache's wholesale-invalidation signal
        self.ownership_epoch = 0
        # read-mostly reference data replicated to every worker (never in
        # a handoff blob): merchant profiles
        self.shared_merchants: Dict[str, Mapping[str, Any]] = {}
        self.merchants_generation = 0
        self.profiles = _ProfilesFacade(self)
        self.velocity = _VelocityFacade(self)
        self.txn_cache = _TxnCacheFacade(self)
        self.history = _HistoryFacade(self)
        self.graph = _GraphFacade(self)

    # ------------------------------------------------------------- routing
    def partition_for(self, key: str) -> int:
        return partition_for_key(str(key), self.n_partitions)

    def owned(self) -> List[int]:
        return sorted(self._states)

    def owns(self, partition: int) -> bool:
        return partition in self._states

    def states(self) -> Dict[int, PartitionState]:
        return self._states

    def state(self, partition: int) -> PartitionState:
        try:
            return self._states[partition]
        except KeyError:
            raise PartitionNotOwned(
                f"partition {partition} not owned "
                f"(owned: {self.owned()})") from None

    def state_for_user(self, user_id: str) -> PartitionState:
        return self.state(self.partition_for(user_id))

    # ------------------------------------------------------------ ownership
    def fresh_state(self) -> PartitionState:
        return PartitionState(self.seq_len, self.feature_dim,
                              self.labeled_capacity, self.cache_kwargs,
                              graph_fanout=self.graph_fanout)

    def acquire(self, partition: int,
                state: Optional[PartitionState] = None) -> PartitionState:
        """Take ownership of a partition, adopting a restored state (the
        handoff path) or a fresh one."""
        if not 0 <= partition < self.n_partitions:
            raise ValueError(
                f"partition {partition} outside [0, {self.n_partitions})")
        if partition in self._states:
            raise ValueError(f"partition {partition} already owned")
        st = state if state is not None else self.fresh_state()
        self._states[partition] = st
        self.ownership_epoch += 1
        return st

    def release(self, partition: int) -> PartitionState:
        """Give up a partition, returning its (live) state for snapshot."""
        st = self._states.pop(partition)
        self.ownership_epoch += 1
        return st

    # -------------------------------------------------------------- summary
    def stats(self) -> Dict[str, Any]:
        return {
            "n_partitions": self.n_partitions,
            "owned": self.owned(),
            "users": sum(len(s.profiles.users)
                         for s in self._states.values()),
            "history_users": len(self.history),
            "merchants": len(self.shared_merchants),
        }

    def digests(self, now: Optional[float] = None) -> Dict[int, str]:
        """Per-owned-partition content digests (oracle-equality checks)."""
        return {p: s.digest(now) for p, s in sorted(self._states.items())}
