"""Consistent-hash placement: key -> partition -> worker.

Port of the JAX package's ``cluster/hashring.py``. Two layers:

1. **key -> partition** is the transport's hash: ``partition_for_key`` is
   bit-identical to ``stream/transport.py InMemoryBroker.select_partition``
   and the Kafka client's partitioner (crc32), so broker-partition affinity
   is state affinity: the worker consuming a user's partition owns that
   user's state, and the serving router sends ``/predict`` for that user to
   the same worker. It never changes with membership.

2. **partition -> worker** is a consistent-hash ring (``HashRing``): each
   worker projects ``virtual_nodes`` points onto a 64-bit ring and a
   partition belongs to the first worker point at or after its own hash. A
   membership change moves only the arcs the joining or leaving worker
   touches. The fleet and the serving router both compute placement from
   (members, n_partitions) alone, so they agree without talking.

``ShardRouter`` is the serving-facing wrapper: route a user key to the
owning worker, and count key movement across membership changes (the
``cluster_router_moved_keys_total`` series).
"""

from __future__ import annotations

import hashlib
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["partition_for_key", "HashRing", "ShardRouter"]


def partition_for_key(key: str, n_partitions: int) -> int:
    """The transport's key→partition hash (transport.select_partition /
    stream/kafka.py partitioner): crc32, NOT ``hash()`` — Python salts
    ``str.__hash__`` per process, and state affinity must survive worker
    restarts."""
    if n_partitions <= 0:
        raise ValueError(f"n_partitions must be >= 1, got {n_partitions}")
    return zlib.crc32(key.encode()) % n_partitions


def _ring_point(label: str) -> int:
    """Stable 64-bit ring coordinate. blake2b, not crc32: the ring needs
    well-spread points for the K/N movement bound to hold at small
    virtual-node counts; crc32's 32-bit space with structured labels
    ("w0#17") clusters measurably."""
    return int.from_bytes(
        hashlib.blake2b(label.encode(), digest_size=8).digest(), "big")


class HashRing:
    """Consistent-hash ring over worker ids with virtual nodes.

    Placement is a pure function of (members, virtual_nodes): every
    caller that knows the membership computes the same assignment, so the
    fleet coordinator (partition ownership) and the serving router (key
    routing) never exchange assignment tables.
    """

    def __init__(self, members: Sequence[str] = (),
                 virtual_nodes: int = 256):
        if virtual_nodes < 1:
            raise ValueError(
                f"virtual_nodes must be >= 1, got {virtual_nodes}")
        self.virtual_nodes = int(virtual_nodes)
        self._members: List[str] = []
        self._points: List[Tuple[int, str]] = []   # sorted (point, member)
        for m in members:
            self.add(m)

    # ------------------------------------------------------------ membership
    def members(self) -> List[str]:
        return sorted(self._members)

    def add(self, member: str) -> None:
        if not member:
            raise ValueError("member id must be non-empty")
        if member in self._members:
            return
        self._members.append(member)
        for v in range(self.virtual_nodes):
            self._points.append((_ring_point(f"{member}#{v}"), member))
        # ties broken by member id so placement is total-ordered even on
        # the (astronomically unlikely) 64-bit point collision
        self._points.sort()

    def remove(self, member: str) -> None:
        if member not in self._members:
            return
        self._members.remove(member)
        self._points = [(p, m) for p, m in self._points if m != member]

    # ------------------------------------------------------------- placement
    def owner_of_partition(self, partition: int) -> str:
        """The worker owning a partition: first ring point at or after the
        partition's own 64-bit coordinate (wrapping)."""
        if not self._points:
            raise ValueError("hash ring has no members")
        target = _ring_point(f"partition:{partition}")
        lo, hi = 0, len(self._points)
        while lo < hi:
            mid = (lo + hi) // 2
            if self._points[mid][0] < target:
                lo = mid + 1
            else:
                hi = mid
        return self._points[lo % len(self._points)][1]

    def assignment(self, n_partitions: int) -> Dict[str, List[int]]:
        """member → sorted owned partitions, exhaustive over
        ``range(n_partitions)``. Every member appears (possibly empty)."""
        out: Dict[str, List[int]] = {m: [] for m in self.members()}
        for p in range(n_partitions):
            out[self.owner_of_partition(p)].append(p)
        return out

    def route_key(self, key: str, n_partitions: int) -> str:
        """user key → owning worker, THROUGH the transport's partition
        hash — so routing agrees with broker-partition consumption by
        construction."""
        return self.owner_of_partition(partition_for_key(key, n_partitions))


class ShardRouter:
    """Thin consistent-hash router in front of serving.

    Maps ``/predict`` user keys to the owning worker and accounts key
    movement across membership changes. ``set_membership`` measures the
    moved set in PARTITIONS (the unit of state handoff — a moved
    partition moves every key in it) and exposes the cumulative count for
    the ``cluster_router_moved_keys_total`` mirror.
    """

    def __init__(self, n_partitions: int, members: Sequence[str] = (),
                 virtual_nodes: int = 256,
                 addresses: Optional[Dict[str, str]] = None):
        if n_partitions < 1:
            raise ValueError(
                f"n_partitions must be >= 1, got {n_partitions}")
        self.n_partitions = int(n_partitions)
        self.ring = HashRing(members, virtual_nodes=virtual_nodes)
        self.addresses = dict(addresses or {})
        self.rebalances = 0
        self.moved_partitions_total = 0
        self.moved_keys_total = 0          # partition moves × keys ≈ tracked
        self._routed = 0

    # --------------------------------------------------------------- routing
    def route(self, user_key: str) -> str:
        """The worker owning this user's partition."""
        self._routed += 1
        return self.ring.route_key(str(user_key), self.n_partitions)

    def partition_of(self, user_key: str) -> int:
        return partition_for_key(str(user_key), self.n_partitions)

    def address_of(self, worker_id: str) -> Optional[str]:
        return self.addresses.get(worker_id)

    def assignment(self) -> Dict[str, List[int]]:
        return self.ring.assignment(self.n_partitions)

    # ------------------------------------------------------------ membership
    def set_membership(self, members: Sequence[str],
                       keys_per_partition: float = 1.0) -> int:
        """Adopt a new member set; returns the number of partitions whose
        owner changed. ``keys_per_partition`` scales the moved-keys
        counter (a fleet that knows its live key population per partition
        passes the real density; the default counts partitions)."""
        before = (self.ring.assignment(self.n_partitions)
                  if self.ring.members() else {})
        owner_before = {p: m for m, parts in before.items() for p in parts}
        for m in list(self.ring.members()):
            if m not in members:
                self.ring.remove(m)
        for m in members:
            self.ring.add(m)
        moved = 0
        if owner_before:
            after = self.ring.assignment(self.n_partitions)
            owner_after = {p: m for m, parts in after.items() for p in parts}
            moved = sum(1 for p, m in owner_after.items()
                        if owner_before.get(p) != m)
        self.rebalances += 1
        self.moved_partitions_total += moved
        self.moved_keys_total += int(round(moved * keys_per_partition))
        return moved

    # -------------------------------------------------------------- snapshot
    def snapshot(self) -> Dict[str, Any]:
        """JSON-able state for ``GET /cluster`` and ``sync_cluster``."""
        return {
            "members": self.ring.members(),
            "n_partitions": self.n_partitions,
            "virtual_nodes": self.ring.virtual_nodes,
            "assignment": {m: parts
                           for m, parts in self.assignment().items()},
            "rebalances": self.rebalances,
            "moved_partitions_total": self.moved_partitions_total,
            "moved_keys_total": self.moved_keys_total,
            "routed": self._routed,
        }
