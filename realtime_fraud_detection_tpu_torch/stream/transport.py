"""Partitioned in-memory broker: the streaming transport of the port.

Port of the in-memory half of the JAX package's ``stream/transport.py``:
``InMemoryBroker`` is a partitioned, offset-addressed topic log with
consumer groups, in process, with deterministic fault injection
(drop / duplicate) for failure-path tests. Keys route to partitions by
crc32, so routing is the same in every process and agrees with the Kafka
partitioner. Consumers read from their group's committed offset; the job
commits only after write-back and fan-out, so a crash replays the tail and
the scorer's transaction cache deduplicates it. The producer generation
fences come along as they are. The network transport
(``stream/netbroker.py``) serves an ``InMemoryBroker`` over TCP, and
``Consumer`` runs over its client unchanged; ``KafkaTransport`` returns
the Kafka wire-protocol client (``stream/kafka.py``), which implements the
same broker interface.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np

from realtime_fraud_detection_tpu_torch.stream.topics import TOPIC_SPECS, TopicSpec


@dataclasses.dataclass
class Record:
    topic: str
    partition: int
    offset: int
    key: Optional[str]
    value: Any
    timestamp: float


class StaleGenerationError(RuntimeError):
    """A generation-stamped produce or commit hit a partition fenced at a
    newer assignment generation: the writer lost ownership in a rebalance
    it has not seen yet. Unstamped producers are unaffected."""


@dataclasses.dataclass
class FaultInjector:
    """Deterministic transport fault injection.

    A *drop* withholds the record from this poll and stops the consumer's
    position at it, so it is re-delivered on the next poll (at-least-once).
    A *duplicate* delivers the record twice in one poll.
    """

    drop_prob: float = 0.0
    duplicate_prob: float = 0.0
    seed: int = 0

    def __post_init__(self) -> None:
        self._rng = np.random.default_rng(self.seed)

    def apply(self, records: List[Record]) -> tuple[List[Record], Optional[Record]]:
        """Returns (delivered, first_dropped). Delivery truncates at the
        first drop so the caller can rewind its position to it."""
        out: List[Record] = []
        for r in records:
            u = self._rng.random()
            if u < self.drop_prob:
                return out, r
            out.append(r)
            if u > 1.0 - self.duplicate_prob:
                out.append(r)
        return out, None


class _PartitionLog:
    __slots__ = ("records", "lock")

    def __init__(self) -> None:
        self.records: List[Record] = []
        self.lock = threading.Lock()


class InMemoryBroker:
    """Partitioned topic log with consumer groups, single process."""

    def __init__(self, topics: Sequence[TopicSpec] = TOPIC_SPECS,
                 auto_create_partitions: int = 4):
        self._topics: Dict[str, List[_PartitionLog]] = {}
        self._committed: Dict[tuple, int] = {}   # (group, topic, part) -> next offset
        self._rr: Dict[str, int] = {}            # round-robin cursor per topic
        self._lock = threading.Lock()
        self._auto_partitions = auto_create_partitions
        # (topic, partition) -> the least generation a stamped produce or
        # commit must carry
        self._gen_fence: Dict[tuple, int] = {}
        self.fenced_produces = 0
        self.fenced_commits = 0
        for t in topics:
            self.create_topic(t.name, t.partitions)

    # ------------------------------------------------------------- topology
    def create_topic(self, name: str, partitions: int) -> None:
        with self._lock:
            if name not in self._topics:
                self._topics[name] = [_PartitionLog() for _ in range(partitions)]

    def _logs(self, topic: str) -> List[_PartitionLog]:
        logs = self._topics.get(topic)
        if logs is None:
            self.create_topic(topic, self._auto_partitions)
            logs = self._topics[topic]
        return logs

    def partitions(self, topic: str) -> int:
        return len(self._logs(topic))

    # -------------------------------------------------------------- produce
    def select_partition(self, topic: str, key: Optional[str]) -> int:
        """crc32 of the key (same key -> same partition -> per-key order),
        or round-robin for unkeyed records, like Kafka's default
        partitioner. Not ``hash()``: Python salts it per process."""
        logs = self._logs(topic)
        if key is not None:
            return zlib.crc32(key.encode()) % len(logs)
        with self._lock:
            part = self._rr.get(topic, 0) % len(logs)
            self._rr[topic] = part + 1
        return part

    def append(self, topic: str, partition: int, value: Any,
               key: Optional[str] = None,
               timestamp: Optional[float] = None) -> Record:
        """Append to a specific partition (produce = select + append)."""
        log = self._logs(topic)[partition]
        with log.lock:
            rec = Record(topic, partition, len(log.records), key, value,
                         timestamp if timestamp is not None else time.time())
            log.records.append(rec)
        return rec

    def produce(self, topic: str, value: Any, key: Optional[str] = None,
                timestamp: Optional[float] = None,
                generation: Optional[int] = None) -> Record:
        """Append one record; partition chosen by key hash. A stamped
        ``generation`` is checked against the partition's producer fence."""
        part = self.select_partition(topic, key)
        self.check_producer_generation(topic, part, generation)
        return self.append(topic, part, value, key, timestamp)

    # ------------------------------------------------ generation fencing
    def fence_producers(self, topic: str, partitions: Sequence[int],
                        generation: int) -> None:
        """Refuse later stamped produces / commits for these partitions
        older than ``generation`` (a fence never moves backwards)."""
        with self._lock:
            for p in partitions:
                key = (topic, int(p))
                if int(generation) > self._gen_fence.get(key, 0):
                    self._gen_fence[key] = int(generation)

    def producer_fence(self, topic: str, partition: int) -> int:
        return self._gen_fence.get((topic, int(partition)), 0)

    def check_producer_generation(self, topic: str, partition: int,
                                  generation: Optional[int],
                                  op: str = "produce") -> None:
        """Raise ``StaleGenerationError`` when a stamped write hits a newer
        fence. ``None`` (unstamped) always passes."""
        if generation is None:
            return
        fence = self._gen_fence.get((topic, int(partition)))
        if fence is not None and int(generation) < fence:
            with self._lock:
                if op == "commit":
                    self.fenced_commits += 1
                else:
                    self.fenced_produces += 1
            raise StaleGenerationError(
                f"{op} to {topic}-{partition} at generation {generation} "
                f"refused: partition fenced at generation {fence}")

    def producer_fence_stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "fenced_produces": self.fenced_produces,
                "fenced_commits": self.fenced_commits,
                "fenced_partitions": len(self._gen_fence),
            }

    def produce_batch(self, topic: str, values: Iterable[Any],
                      key_fn: Optional[Callable[[Any], str]] = None) -> int:
        n = 0
        for v in values:
            self.produce(topic, v, key_fn(v) if key_fn else None)
            n += 1
        return n

    def produce_batch_keyed(self, topic: str,
                            items: Iterable[tuple]) -> int:
        """Batch produce of explicit (key, value) pairs, for payloads that
        do not carry their own routing key (the predictions fan-out is
        keyed by user, but a prediction has no user field)."""
        n = 0
        for k, v in items:
            self.produce(topic, v, k)
            n += 1
        return n

    # -------------------------------------------------------------- consume
    def consumer(self, topics: Sequence[str], group_id: str,
                 faults: Optional[FaultInjector] = None,
                 partitions: Optional[Mapping[str, Sequence[int]]] = None,
                 ) -> "Consumer":
        """``partitions`` scopes the consumer to an explicit topic ->
        partition-list assignment instead of every partition."""
        return Consumer(self, list(topics), group_id, faults,
                        partitions=partitions)

    def end_offsets(self, topic: str) -> List[int]:
        return [len(p.records) for p in self._logs(topic)]

    def read(self, topic: str, partition: int, start: int, limit: int) -> List[Record]:
        log = self._logs(topic)[partition]
        with log.lock:
            return log.records[start:start + limit]

    # -------------------------------------------------------------- offsets
    def committed(self, group: str, topic: str, partition: int) -> int:
        return self._committed.get((group, topic, partition), 0)

    def commit(self, group: str, offsets: Mapping[tuple, int],
               generation: Optional[int] = None) -> None:
        # a stamped commit is fence-checked for every partition before any
        # offset moves
        if generation is not None:
            for (topic, part) in offsets:
                self.check_producer_generation(topic, part, generation,
                                               op="commit")
        with self._lock:
            for (topic, part), off in offsets.items():
                key = (group, topic, part)
                if off > self._committed.get(key, 0):
                    self._committed[key] = off

    def lag(self, group: str, topic: str) -> int:
        return sum(
            max(0, end - self.committed(group, topic, p))
            for p, end in enumerate(self.end_offsets(topic))
        )


class Consumer:
    """Offset-tracking consumer over the in-memory broker.

    ``poll`` returns up to max_records across the assigned partitions from
    the *position* (not yet committed); ``commit`` advances the group
    offset; ``seek_to_committed`` rewinds to the last commit (the
    crash-recovery path); ``positions`` / ``seek_to_positions`` carry the
    read positions through a checkpoint. With an explicit ``partitions``
    assignment the consumer reads only those partitions. Over a networked
    broker client that exposes ``reconnect_epoch`` the consumer rewinds to
    the committed offsets after every reconnect it observes.
    """

    def __init__(self, broker: InMemoryBroker, topics: List[str],
                 group_id: str, faults: Optional[FaultInjector] = None,
                 partitions: Optional[Mapping[str, Sequence[int]]] = None):
        self.broker = broker
        self.topics = topics
        self.group_id = group_id
        self.faults = faults
        self._assignment: Optional[Dict[str, List[int]]] = (
            {t: sorted(int(p) for p in parts)
             for t, parts in partitions.items()}
            if partitions is not None else None)
        self._position: Dict[tuple, int] = {}
        # a networked client's monotonic reconnect epoch; each consumer
        # keeps its own last-seen value, so every consumer sharing one
        # client observes every reconnect (see poll)
        self._epoch_fn = getattr(broker, "reconnect_epoch", None)
        self._seen_epoch = self._epoch_fn() if self._epoch_fn else 0
        self.seek_to_committed()

    def _assigned(self, topic: str) -> Sequence[int]:
        if self._assignment is not None:
            return self._assignment.get(topic, ())
        return range(self.broker.partitions(topic))

    def seek_to_committed(self) -> None:
        self._position = {
            (t, p): self.broker.committed(self.group_id, t, p)
            for t in self.topics
            for p in self._assigned(t)
        }

    def poll(self, max_records: int = 256) -> List[Record]:
        # after a reconnect (possibly a broker restart) the cursor may sit
        # past records polled but never committed: continuing from it would
        # let the next commit advance past them, so rewind to the committed
        # offsets; the re-delivered records dedupe downstream
        if self._epoch_fn is not None:
            epoch = self._epoch_fn()
            if epoch != self._seen_epoch:
                self._seen_epoch = epoch
                self.seek_to_committed()
        out: List[Record] = []
        for (t, p), pos in self._position.items():
            if len(out) >= max_records:
                break
            recs = self.broker.read(t, p, pos, max_records - len(out))
            if not recs:
                continue
            if self.faults is not None:
                recs, dropped = self.faults.apply(recs)
                if dropped is not None:
                    # position stops at the dropped record: re-delivered on
                    # the next poll, never lost past a commit
                    self._position[(t, p)] = dropped.offset
                    out.extend(recs)
                    continue
            if recs:
                self._position[(t, p)] = recs[-1].offset + 1
                out.extend(recs)
        return out

    def commit(self, offsets: Optional[Dict[tuple, int]] = None) -> None:
        """Commit positions; with ``offsets`` (a ``snapshot_positions()``
        result) exactly those, so a batch still in flight is never committed
        past by a later poll."""
        self.broker.commit(
            self.group_id,
            dict(self._position) if offsets is None else offsets)

    def snapshot_positions(self) -> Dict[tuple, int]:
        """Copy of current read positions keyed (topic, partition)."""
        return dict(self._position)

    def positions(self) -> Dict[str, int]:
        """JSON-safe read positions ("topic:partition" -> next offset), for
        a checkpoint's manifest."""
        return {f"{t}:{p}": pos for (t, p), pos in self._position.items()}

    def seek_to_positions(self, offsets: Mapping[str, int]) -> None:
        """Inverse of ``positions()``: restore the read positions of a
        checkpoint, so scorer state and transport positions resume from the
        same point even against a broker whose group offsets were lost."""
        for key, off in offsets.items():
            t, _, p = key.rpartition(":")
            self._position[(t, int(p))] = int(off)

    def lag(self) -> int:
        """Uncommitted lag over this consumer's assigned partitions."""
        total = 0
        for t in self.topics:
            ends = self.broker.end_offsets(t)
            for p in self._assigned(t):
                total += max(0, ends[p] - self.broker.committed(
                    self.group_id, t, p))
        return total


def KafkaTransport(bootstrap_servers: str = "localhost:9092", **kwargs):
    """The Kafka adapter: the port's own wire-protocol client
    (``stream/kafka.py``, no client library). Returns a ``KafkaBroker``
    implementing this module's broker interface, so
    ``StreamJob(broker=KafkaTransport(...))`` runs unchanged against a
    cluster."""
    from realtime_fraud_detection_tpu_torch.stream.kafka import KafkaBroker

    return KafkaBroker(bootstrap=bootstrap_servers, **kwargs)
