"""Kafka consumer-group membership: JoinGroup/SyncGroup/Heartbeat/LeaveGroup.

Port of the JAX package's ``stream/kafka_group.py``. The reference runs
group-managed consumers (config/kafka/consumer.properties:5
``group.id=fraud-detection-group``, ``:36`` CooperativeStickyAssignor): when
a consumer process dies, the coordinator rebalances its partitions onto the
survivors, which resume from the committed offsets. This module is that
client side over the port's wire client (``stream/kafka.py``):

- ``GroupMembership``: the membership state machine: JoinGroup v1 (member
  id and generation), leader-side range assignment, SyncGroup v0
  (assignment distribution), Heartbeat v0 (liveness and the rebalance
  signal), LeaveGroup v0.
- ``KafkaGroupConsumer``: the port ``Consumer``'s contract as ``StreamJob``
  uses it (poll / snapshot_positions / commit / positions / lag) over a
  dynamic partition assignment. Commits carry (generation, member_id), so
  the coordinator fences a zombie member's commit after it has been
  rebalanced away.

Assignor: range (the protocol's default), computed by the group leader as
Kafka's RangeAssignor does: per topic, the sorted members get near-even
contiguous partition spans.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from realtime_fraud_detection_tpu_torch.stream.kafka import (
    API_HEARTBEAT,
    API_JOIN_GROUP,
    API_LEAVE_GROUP,
    API_SYNC_GROUP,
    ERR_ILLEGAL_GENERATION,
    ERR_REBALANCE_IN_PROGRESS,
    ERR_UNKNOWN_MEMBER_ID,
    KafkaBroker,
    KafkaProtocolError,
    Reader,
    Writer,
)
from realtime_fraud_detection_tpu_torch.stream.transport import Record

__all__ = ["GroupMembership", "KafkaGroupConsumer"]

_REJOIN_ERRORS = (ERR_ILLEGAL_GENERATION, ERR_UNKNOWN_MEMBER_ID,
                  ERR_REBALANCE_IN_PROGRESS)


def encode_subscription(topics: List[str]) -> bytes:
    """ConsumerProtocolSubscription v0: version, topics, user_data."""
    return (Writer().i16(0).array(sorted(topics), Writer.string)
            .bytes_(b"").done())


def decode_subscription(buf: bytes) -> List[str]:
    r = Reader(buf)
    r.i16()                                       # version
    return r.array(Reader.string)


def encode_assignment(parts_by_topic: Dict[str, List[int]]) -> bytes:
    """ConsumerProtocolAssignment v0: version, [topic -> partitions], data."""
    return (
        Writer().i16(0)
        .array(sorted(parts_by_topic.items()), lambda w, kv:
               w.string(kv[0]).array(sorted(kv[1]), Writer.i32))
        .bytes_(b"").done()
    )


def decode_assignment(buf: bytes) -> Dict[str, List[int]]:
    if not buf:
        return {}
    r = Reader(buf)
    r.i16()                                       # version
    pairs = r.array(lambda rr: (rr.string(), rr.array(Reader.i32)))
    return {topic: parts for topic, parts in pairs}


def range_assign(
    subscriptions: Dict[str, List[str]],
    partition_counts: Dict[str, int],
) -> Dict[str, Dict[str, List[int]]]:
    """Kafka RangeAssignor: per topic, sorted subscribers split the sorted
    partition list into contiguous near-even spans (first members get the
    remainder). Returns member -> topic -> partitions."""
    out: Dict[str, Dict[str, List[int]]] = {m: {} for m in subscriptions}
    topics = sorted({t for ts in subscriptions.values() for t in ts})
    for topic in topics:
        members = sorted(m for m, ts in subscriptions.items() if topic in ts)
        n_parts = partition_counts[topic]
        base, extra = divmod(n_parts, len(members))
        start = 0
        for i, member in enumerate(members):
            n = base + (1 if i < extra else 0)
            if n:
                out[member][topic] = list(range(start, start + n))
            start += n
    return out


class GroupMembership:
    """One consumer's membership in a Kafka consumer group."""

    def __init__(self, broker: KafkaBroker, group_id: str, topics: List[str],
                 session_timeout_ms: int = 10_000,
                 rebalance_timeout_ms: int = 10_000,
                 rejoin_sleep=None):
        from realtime_fraud_detection_tpu_torch.utils.backoff import (
            DeterministicBackoff,
            instance_seed,
        )

        self.broker = broker
        self.group_id = group_id
        self.topics = list(topics)
        self.session_timeout_ms = session_timeout_ms
        self.rebalance_timeout_ms = rebalance_timeout_ms
        # rejoin-retry schedule: bounded exponential + deterministic jitter
        # seeded PER MEMBER INSTANCE (a group's members are exactly the
        # herd that must stagger its rejoin storm — a group-keyed seed
        # would synchronize them); ``rejoin_sleep`` is the injected seam
        self._backoff = DeterministicBackoff(
            base_s=0.05, mult=2.0, max_s=0.4,
            seed=instance_seed(group_id), sleep=rejoin_sleep)
        self.member_id = ""
        self.generation = -1
        self.is_leader = False
        self.assignment: Dict[str, List[int]] = {}
        self.rebalances = 0
        # serializes join/heartbeat/leave between the poll thread and the
        # background heartbeat thread (KafkaGroupConsumer)
        self.lock = threading.RLock()

    # ------------------------------------------------------------------ join
    def ensure_active(self) -> bool:
        """Join (or rejoin) if not currently in a stable generation.
        Returns True when a (re)join happened — positions must be reset."""
        with self.lock:
            if self.generation >= 0:
                return False
            deadline = (time.monotonic()
                        + self.rebalance_timeout_ms / 1000.0 * 2)
            attempt = 0
            while True:
                try:
                    self._join_sync()
                    self.rebalances += 1
                    return True
                except KafkaProtocolError as e:
                    if (e.code not in _REJOIN_ERRORS
                            or time.monotonic() > deadline):
                        raise
                    if e.code == ERR_UNKNOWN_MEMBER_ID:
                        self.member_id = ""
                    # The membership lock deliberately spans this retry
                    # wait (no concurrent join/heartbeat allowed); the
                    # wait goes through the injected backoff seam —
                    # bounded exponential + deterministic jitter instead
                    # of a fixed bare sleep.
                    self._backoff.sleep(attempt)
                    attempt += 1

    def _join_sync(self) -> None:
        join_body = (
            Writer().string(self.group_id).i32(self.session_timeout_ms)
            .i32(self.rebalance_timeout_ms).string(self.member_id)
            .string("consumer")
            .array([("range", encode_subscription(self.topics))],
                   lambda w, p: w.string(p[0]).bytes_(p[1]))
            .done()
        )

        def _join(conn):
            r = conn.request(API_JOIN_GROUP, 1, join_body)
            err = r.i16()
            if err:
                raise KafkaProtocolError("JoinGroup", err)
            generation = r.i32()
            r.string()                            # protocol name
            leader = r.string()
            member_id = r.string()
            members = r.array(lambda rr: (rr.string(), rr.bytes_()))
            return generation, leader, member_id, members

        generation, leader, member_id, members = (
            self.broker._with_coordinator(self.group_id, "JoinGroup", _join))
        self.member_id = member_id
        self.is_leader = leader == member_id
        assignments: List[Tuple[str, bytes]] = []
        if self.is_leader:
            subscriptions = {
                mid: decode_subscription(meta) for mid, meta in members
            }
            counts = {
                t: self.broker.partitions(t)
                for ts in subscriptions.values() for t in ts
            }
            computed = range_assign(subscriptions, counts)
            assignments = [(mid, encode_assignment(parts))
                           for mid, parts in computed.items()]

        sync_body = (
            Writer().string(self.group_id).i32(generation)
            .string(self.member_id)
            .array(assignments, lambda w, a: w.string(a[0]).bytes_(a[1]))
            .done()
        )

        def _sync(conn):
            r = conn.request(API_SYNC_GROUP, 0, sync_body)
            err = r.i16()
            if err:
                raise KafkaProtocolError("SyncGroup", err)
            return r.bytes_()

        my_assignment = self.broker._with_coordinator(
            self.group_id, "SyncGroup", _sync)
        self.assignment = decode_assignment(my_assignment or b"")
        self.generation = generation

    # ------------------------------------------------------------- liveness
    def heartbeat(self) -> bool:
        """Returns False when the coordinator demands a rejoin (rebalance
        in progress / evicted); the caller must ensure_active() again."""
        with self.lock:
            if self.generation < 0:
                return False
            body = (Writer().string(self.group_id).i32(self.generation)
                    .string(self.member_id).done())

            def _hb(conn):
                r = conn.request(API_HEARTBEAT, 0, body)
                return r.i16()

            err = self.broker._with_coordinator(
                self.group_id, "Heartbeat", _hb)
            if err == 0:
                return True
            if err in _REJOIN_ERRORS:
                self.generation = -1
                if err == ERR_UNKNOWN_MEMBER_ID:
                    self.member_id = ""
                return False
            raise KafkaProtocolError("Heartbeat", err)

    def leave(self) -> None:
        with self.lock:
            self._leave_locked()

    def _leave_locked(self) -> None:
        if not self.member_id:
            return
        body = (Writer().string(self.group_id).string(self.member_id).done())

        def _leave(conn):
            r = conn.request(API_LEAVE_GROUP, 0, body)
            return r.i16()

        try:
            self.broker._with_coordinator(self.group_id, "LeaveGroup", _leave)
        except (KafkaProtocolError, ConnectionError, OSError):
            pass                                  # dying anyway
        self.generation = -1
        self.member_id = ""


class KafkaGroupConsumer:
    """The port ``Consumer``'s contract over a group-managed assignment.

    The StreamJob drives this exactly like the static transport.Consumer —
    poll / snapshot_positions / commit(positions) / lag — but partitions
    come and go with group rebalances, and commits are fenced by
    (generation, member_id). On any rebalance the positions reset to the
    committed offsets of the NEW assignment: records in flight from the old
    assignment simply replay on whichever member now owns the partition
    (at-least-once; dedupe is the scorer's txn-cache, stream/job.py).
    """

    def __init__(self, broker: KafkaBroker, topics: List[str], group_id: str,
                 session_timeout_ms: int = 10_000,
                 heartbeat_interval_s: float = 1.0,
                 rejoin_sleep=None):
        self.broker = broker
        self.topics = list(topics)
        self.group_id = group_id
        self.membership = GroupMembership(
            broker, group_id, topics, session_timeout_ms=session_timeout_ms,
            rejoin_sleep=rejoin_sleep)
        self.heartbeat_interval_s = heartbeat_interval_s
        self._last_heartbeat = 0.0
        self._position: Dict[tuple, int] = {}
        self._lock = threading.Lock()
        self._closed = threading.Event()
        self.membership.ensure_active()
        self.seek_to_committed()
        # Background heartbeat (Kafka's heartbeat thread): keeps the member
        # alive through processing gaps longer than the session timeout —
        # e.g. a first batch that builds the CUDA kernels — during which poll() isn't called.
        # It only SIGNALS rebalances (generation=-1); the rejoin itself
        # happens on the poll thread, which owns the positions.
        self._hb_thread = threading.Thread(
            target=self._hb_loop, name=f"kafka-hb-{group_id}", daemon=True)
        self._hb_thread.start()

    def _hb_loop(self) -> None:
        while not self._closed.wait(self.heartbeat_interval_s):
            try:
                self.membership.heartbeat()
                self._last_heartbeat = time.monotonic()
            except (KafkaProtocolError, ConnectionError, OSError):
                pass                      # next poll's _maintain recovers

    # ---------------------------------------------------------- assignment
    def _maintain(self) -> None:
        """Heartbeat on cadence; rejoin + reset positions on rebalance."""
        now = time.monotonic()
        if now - self._last_heartbeat >= self.heartbeat_interval_s:
            self._last_heartbeat = now
            if not self.membership.heartbeat():
                self.membership.ensure_active()
                self.seek_to_committed()
        elif self.membership.generation < 0:
            self.membership.ensure_active()
            self.seek_to_committed()

    def assigned_partitions(self) -> Dict[str, List[int]]:
        return dict(self.membership.assignment)

    def seek_to_committed(self) -> None:
        with self._lock:
            self._position = {
                (t, p): self.broker.committed(self.group_id, t, p)
                for t, parts in self.membership.assignment.items()
                for p in parts
            }

    # ---------------------------------------------------------------- poll
    def poll(self, max_records: int = 256) -> List[Record]:
        self._maintain()
        out: List[Record] = []
        with self._lock:
            positions = list(self._position.items())
        for (t, p), pos in positions:
            if len(out) >= max_records:
                break
            recs = self.broker.read(t, p, pos, max_records - len(out))
            if recs:
                with self._lock:
                    self._position[(t, p)] = recs[-1].offset + 1
                out.extend(recs)
        return out

    def commit(self, offsets: Optional[Dict[tuple, int]] = None) -> None:
        """Fenced commit: ILLEGAL_GENERATION / UNKNOWN_MEMBER_ID mean this
        member was rebalanced away — drop the commit (the new owner will
        rescore from its committed offset) and rejoin."""
        with self._lock:
            to_commit = dict(self._position) if offsets is None else offsets
        if not to_commit:
            return
        m = self.membership
        try:
            self.broker.commit(self.group_id, to_commit,
                               generation_id=m.generation,
                               member_id=m.member_id)
        except KafkaProtocolError as e:
            if e.code not in _REJOIN_ERRORS:
                raise
            m.generation = -1
            self._maintain()

    def snapshot_positions(self) -> Dict[tuple, int]:
        with self._lock:
            return dict(self._position)

    def positions(self) -> Dict[str, int]:
        with self._lock:
            return {f"{t}:{p}": pos for (t, p), pos in self._position.items()}

    def lag(self) -> int:
        """Lag over this member's ASSIGNED partitions only (the group's
        total lag is the sum across members)."""
        total = 0
        for t, parts in self.membership.assignment.items():
            ends = self.broker.end_offsets(t)
            for p in parts:
                total += max(0, ends[p] - self.broker.committed(
                    self.group_id, t, p))
        return total

    def close(self) -> None:
        self._closed.set()
        self.membership.leave()
