"""Typed incremental entity graph: user <-> device <-> merchant <-> IP.

Port of the JAX package's ``graph/store.py``. The bipartite
``state.history.EntityGraphStore`` holds only user <-> merchant edges, so
the device fingerprints and egress IPs a coordinated fraud ring shares
never reach the GNN. This store has four node types and six directed edge
types; each source node keeps a bounded recency ring of distinct
neighbours (most recent last, the oldest evicted at the fan-out cap).

Identity is the string entity id. The sampler resolves ids to feature rows
at gather time (``models.gnn.typed_entity_features`` for device and IP
nodes, the scorer's entity tables for users and merchants).

Mutation and reads take one internal lock, never held across a blocking
call. The store is a pure function of the ingest order (no clock, no RNG).
"""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

__all__ = ["NODE_TYPES", "EDGE_TYPES", "TypedEntityGraph",
           "merge_neighbor_lists"]

NODE_TYPES = ("user", "device", "merchant", "ip")

# directed edge types; each transaction ingests the user's three
# counterparty links in both directions
EDGE_TYPES = (
    "user->device", "device->user",
    "user->merchant", "merchant->user",
    "user->ip", "ip->user",
)

_REVERSE = {
    "user->device": "device->user",
    "user->merchant": "merchant->user",
    "user->ip": "ip->user",
}


class TypedEntityGraph:
    """Heterogeneous bounded-recency adjacency over string entity ids."""

    def __init__(self, fanout: int = 16):
        if fanout < 1:
            raise ValueError(f"fanout must be >= 1, got {fanout}")
        self.fanout = int(fanout)
        self._adj: Dict[str, Dict[str, List[str]]] = {
            et: {} for et in EDGE_TYPES}
        # bumped on every mutating ingest (an observability stamp); the
        # sampler's cache coherence runs on drain_dirty
        self.generation = 0
        self.edges_added = 0
        # ids whose adjacency changed since the last drain_dirty()
        self._dirty: set = set()
        self._lock = threading.Lock()

    # ------------------------------------------------------------- pickling
    def __getstate__(self) -> Dict[str, Any]:
        state = dict(self.__dict__)
        del state["_lock"]
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._lock = threading.Lock()

    # -------------------------------------------------------------- ingest
    @staticmethod
    def _ring_add(adj: Dict[str, List[str]], src: str, dst: str,
                  fanout: int) -> bool:
        """Recency-ring insert: distinct neighbours, most recent last, the
        oldest evicted at the cap. True when the ring changed."""
        ring = adj.get(src)
        if ring is None:
            adj[src] = [dst]
            return True
        if ring and ring[-1] == dst:
            return False
        try:
            ring.remove(dst)              # move to the end on re-observation
        except ValueError:
            pass
        ring.append(dst)
        del ring[:-fanout]
        return True

    def add_transaction(self, user_id: str, merchant_id: str,
                        device_id: str, ip: str) -> None:
        self.add_batch([user_id], [merchant_id], [device_id], [ip])

    def add_batch(self, user_ids: Sequence[str],
                  merchant_ids: Sequence[str],
                  device_ids: Sequence[str],
                  ips: Sequence[str]) -> None:
        """Ingest one finalized microbatch's entity links, both directions
        per link; an empty counterparty id adds no edge."""
        with self._lock:
            changed = False
            for uid, mid, did, ip in zip(user_ids, merchant_ids,
                                         device_ids, ips):
                uid = str(uid)
                if not uid:
                    continue
                for fwd, dst in (("user->device", str(did)),
                                 ("user->merchant", str(mid)),
                                 ("user->ip", str(ip))):
                    if not dst or dst == "None":
                        continue
                    rev = _REVERSE[fwd]
                    if self._ring_add(self._adj[fwd], uid, dst,
                                      self.fanout):
                        changed = True
                        self._dirty.add(uid)
                    if self._ring_add(self._adj[rev], dst, uid,
                                      self.fanout):
                        changed = True
                        self._dirty.add(dst)
                    self.edges_added += 1
            if changed:
                self.generation += 1

    # ------------------------------------------------------------- queries
    def neighbors(self, edge_type: str, ids: Sequence[str],
                  fanout: Optional[int] = None) -> List[List[str]]:
        """Per-source recency lists (oldest first, at most ``fanout``
        each); an unknown source has an empty list."""
        if edge_type not in EDGE_TYPES:
            raise ValueError(f"unknown edge type {edge_type!r}; expected "
                             f"one of {EDGE_TYPES}")
        k = self.fanout if fanout is None else max(1, int(fanout))
        adj = self._adj[edge_type]
        with self._lock:
            return [list(adj.get(str(i), ())[-k:]) for i in ids]

    def neighbor_map(self, edge_type: str, ids: Iterable[str],
                     fanout: Optional[int] = None) -> Dict[str, List[str]]:
        """{id: neighbours}, sources with no adjacency omitted."""
        ids = [str(i) for i in ids]
        out: Dict[str, List[str]] = {}
        for i, ring in zip(ids, self.neighbors(edge_type, ids, fanout)):
            if ring:
                out[i] = ring
        return out

    def degree(self, edge_type: str, ids: Sequence[str]) -> List[int]:
        """Ring occupancy per source (capped at the fan-out)."""
        if edge_type not in EDGE_TYPES:
            raise ValueError(f"unknown edge type {edge_type!r}")
        adj = self._adj[edge_type]
        with self._lock:
            return [len(adj.get(str(i), ())) for i in ids]

    # ---------------------------------------------------- sampler coherence
    def drain_dirty(self) -> List[str]:
        """Ids whose adjacency changed since the last drain, sorted; the
        set is cleared."""
        with self._lock:
            dirty = sorted(self._dirty)
            self._dirty.clear()
            return dirty

    # ------------------------------------------------------------- summary
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            nodes = {
                "user": len(set(self._adj["user->device"])
                            | set(self._adj["user->merchant"])
                            | set(self._adj["user->ip"])),
                "device": len(self._adj["device->user"]),
                "merchant": len(self._adj["merchant->user"]),
                "ip": len(self._adj["ip->user"]),
            }
            edges = {et: sum(len(r) for r in self._adj[et].values())
                     for et in EDGE_TYPES}
        return {"fanout": self.fanout, "generation": self.generation,
                "edges_added": self.edges_added, "nodes": nodes,
                "edges": edges}

    def digest(self) -> str:
        """Deterministic SHA-256 over the full typed adjacency."""
        with self._lock:
            payload = {
                et: sorted((src, tuple(ring))
                           for src, ring in self._adj[et].items())
                for et in EDGE_TYPES
            }
        h = hashlib.sha256()
        h.update(json.dumps(payload, sort_keys=True,
                            default=list).encode())
        return h.hexdigest()

    def __len__(self) -> int:
        with self._lock:
            return sum(len(adj) for adj in self._adj.values())


def merge_neighbor_lists(local: Mapping[str, List[str]],
                         remotes: Sequence[Mapping[str, List[str]]],
                         ids: Sequence[str], fanout: int,
                         ) -> Dict[str, List[str]]:
    """Deterministic neighbourhood merge across stores: local first, then
    each remote in the caller's order, first occurrence kept, the LAST
    ``fanout`` entries returned."""
    out: Dict[str, List[str]] = {}
    for i in ids:
        i = str(i)
        seen: Dict[str, None] = {}
        for src in (local, *remotes):
            for n in src.get(i, ()):
                seen.setdefault(str(n))
        merged = list(seen)
        out[i] = merged[-max(1, int(fanout)):]
    return out
