"""In-process Kafka-protocol broker: the contract test double for KafkaBroker.

Port of the JAX package's ``stream/kafka_fake.py``: a TCP server speaking
the wire-protocol subset the client uses (Metadata v1, Produce v2/v3, Fetch
v2, ListOffsets v1, FindCoordinator v0, OffsetCommit v2, OffsetFetch v1,
InitProducerId v0, JoinGroup v1, SyncGroup v0, Heartbeat v0, LeaveGroup
v0), so the Kafka transport's produce / fetch / commit / membership logic
(encoding, CRC32 / CRC32C, partitioning, offset bookkeeping, sequence
fencing, rebalancing) runs end to end over real sockets without a Kafka
installation.

Broker-side semantics the contract needs:
- **Group coordinator** (``_Group``): generations, join barriers, leader
  selection, session-timeout eviction, commit fencing: the server half of
  the reference's consumer-group failover (consumer.properties:5).
- **Idempotent produce fencing**: per-(producer_id, partition) sequence
  tracking; a replayed batch is acked with its original offset, a sequence
  gap is refused (producer.properties:8).

Still a fake, not a broker: one node, no replication, topics auto-created on
first touch with the port's partition counts (``stream/topics.py``).
Request decoding is written against the public protocol spec
(kafka.apache.org/protocol).
"""

from __future__ import annotations

import socketserver
import struct
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from realtime_fraud_detection_tpu_torch.stream.kafka import (
    API_FETCH,
    API_FIND_COORDINATOR,
    API_HEARTBEAT,
    API_INIT_PRODUCER_ID,
    API_JOIN_GROUP,
    API_LEAVE_GROUP,
    API_LIST_OFFSETS,
    API_METADATA,
    API_OFFSET_COMMIT,
    API_OFFSET_FETCH,
    API_PRODUCE,
    API_SYNC_GROUP,
    ERR_ILLEGAL_GENERATION,
    ERR_OUT_OF_ORDER_SEQUENCE,
    ERR_REBALANCE_IN_PROGRESS,
    ERR_UNKNOWN_MEMBER_ID,
    Reader,
    Writer,
    decode_message_set,
    decode_record_batch,
    encode_message_set,
)
from realtime_fraud_detection_tpu_torch.stream.topics import TOPIC_SPECS, TopicSpec

__all__ = ["FakeKafkaServer"]


class _Partition:
    __slots__ = ("messages", "producer_state")

    def __init__(self) -> None:
        # (key bytes|None, value bytes|None, timestamp_ms)
        self.messages: List[Tuple[Optional[bytes], Optional[bytes], int]] = []
        # idempotence fencing: producer_id -> (base_seq, count, base_offset)
        # of the last accepted batch — a replay of the same base_seq is a
        # duplicate and returns the original offset without appending
        self.producer_state: Dict[int, Tuple[int, int, int]] = {}


class _Group:
    """Coordinator-side consumer group (JoinGroup/SyncGroup state machine).

    States mirror Kafka's GroupCoordinator: ``empty`` -> ``joining``
    (PreparingRebalance: members must (re)join) -> ``awaiting_sync``
    (CompletingRebalance: leader computes assignment) -> ``stable``.
    A join while stable, a member death (session timeout), or a leave all
    kick the group back to ``joining`` and bump the generation when the
    round completes.
    """

    def __init__(self) -> None:
        self.cond = threading.Condition()
        self.state = "empty"
        self.generation = 0
        self.members: Dict[str, dict] = {}        # id -> {last_seen, meta}
        # rejoined members this round: id -> (metadata, session_ms)
        self.pending: Dict[str, Tuple[bytes, int]] = {}
        self.leader = ""
        self.assignments: Dict[str, bytes] = {}
        self.join_deadline = 0.0
        self.next_member_n = 0


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        server: FakeKafkaServer = self.server.outer  # type: ignore[attr-defined]
        sock = self.request
        while True:
            try:
                header = self._recv_exact(sock, 4)
            except ConnectionError:
                return
            if header is None:
                return
            (length,) = struct.unpack(">i", header)
            frame = self._recv_exact(sock, length)
            if frame is None:
                return
            r = Reader(frame)
            api_key, api_version, corr = r.i16(), r.i16(), r.i32()
            r.string()                             # client_id
            try:
                body = server.dispatch(api_key, api_version, r)
            except Exception:  # noqa: BLE001 - kill the connection like a broker
                return
            resp = Writer().i32(corr).raw(body).done()
            sock.sendall(struct.pack(">i", len(resp)) + resp)

    @staticmethod
    def _recv_exact(sock, n: int) -> Optional[bytes]:
        buf = bytearray()
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                return None
            buf.extend(chunk)
        return bytes(buf)


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class FakeKafkaServer:
    """Single-node Kafka-wire-protocol log over TCP (testing/dev only)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 topics: Sequence[TopicSpec] = TOPIC_SPECS,
                 auto_create_partitions: int = 4):
        self._log: Dict[str, List[_Partition]] = {}
        self._committed: Dict[Tuple[str, str, int], int] = {}
        self._lock = threading.Lock()
        self._auto_partitions = auto_create_partitions
        self._groups: Dict[str, _Group] = {}
        self._next_pid = 1000
        for t in topics:
            self._log[t.name] = [_Partition() for _ in range(t.partitions)]
        self._tcp = _TCPServer((host, port), _Handler)
        self._tcp.outer = self  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._tcp.serve_forever, name="fake-kafka", daemon=True)

    def start(self) -> "FakeKafkaServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._tcp.shutdown()
        self._tcp.server_close()

    @property
    def port(self) -> int:
        return self._tcp.server_address[1]

    @property
    def host(self) -> str:
        return self._tcp.server_address[0]

    def _partitions(self, topic: str) -> List[_Partition]:
        with self._lock:
            parts = self._log.get(topic)
            if parts is None:
                parts = [_Partition() for _ in range(self._auto_partitions)]
                self._log[topic] = parts
            return parts

    # -------------------------------------------------------------- dispatch
    def dispatch(self, api_key: int, api_version: int, r: Reader) -> bytes:
        if api_key == API_METADATA:
            return self._metadata(r)
        if api_key == API_PRODUCE:
            return self._produce(r, api_version)
        if api_key == API_FETCH:
            return self._fetch(r)
        if api_key == API_LIST_OFFSETS:
            return self._list_offsets(r)
        if api_key == API_FIND_COORDINATOR:
            r.string()                             # group id — we coordinate
            return (Writer().i16(0).i32(1).string(self.host)
                    .i32(self.port).done())
        if api_key == API_OFFSET_COMMIT:
            return self._offset_commit(r)
        if api_key == API_OFFSET_FETCH:
            return self._offset_fetch(r)
        if api_key == API_JOIN_GROUP:
            return self._join_group(r)
        if api_key == API_SYNC_GROUP:
            return self._sync_group(r)
        if api_key == API_HEARTBEAT:
            return self._heartbeat(r)
        if api_key == API_LEAVE_GROUP:
            return self._leave_group(r)
        if api_key == API_INIT_PRODUCER_ID:
            r.string()                             # transactional_id (null)
            r.i32()                                # transaction_timeout_ms
            with self._lock:
                pid = self._next_pid
                self._next_pid += 1
            return Writer().i32(0).i16(0).i64(pid).i16(0).done()
        raise NotImplementedError(f"api_key {api_key}")

    def _metadata(self, r: Reader) -> bytes:
        names = r.array(Reader.string)
        if not names:                              # null/empty -> all topics
            with self._lock:
                names = sorted(self._log)
        w = Writer()
        w.array([(1, self.host, self.port, None)], lambda ww, b:
                ww.i32(b[0]).string(b[1]).i32(b[2]).string(b[3]))
        w.i32(1)                                   # controller id
        w.i32(len(names))
        for name in names:
            parts = self._partitions(name)
            w.i16(0).string(name).i8(0)
            w.i32(len(parts))
            for pid in range(len(parts)):
                w.i16(0).i32(pid).i32(1)
                w.array([1], Writer.i32).array([1], Writer.i32)
        return w.done()

    def _append(self, topic: str, part_id: int,
                record_set: bytes) -> Tuple[int, int]:
        """Append one record set; returns (error_code, base_offset).

        Detects the format by the magic byte (offset 16 in both layouts).
        RecordBatch v2 with a producer id goes through sequence fencing:
        a replayed baseSequence is a DUPLICATE -> acked with the original
        base offset, nothing appended (enable.idempotence=true semantics);
        a gap is OUT_OF_ORDER_SEQUENCE (45).
        """
        part = self._partitions(topic)[part_id]
        if len(record_set) > 16 and record_set[16] == 2:
            msgs4, pid, _pepoch, base_seq = decode_record_batch(record_set)
            msgs = [(key, value, ts) for _off, key, value, ts in msgs4]
            with self._lock:
                if pid >= 0:
                    state = part.producer_state.get(pid)
                    if state is not None:
                        last_seq, last_count, last_base = state
                        if base_seq == last_seq:          # retry: dedupe
                            return 0, last_base
                        if base_seq != last_seq + last_count:
                            return ERR_OUT_OF_ORDER_SEQUENCE, -1
                base = len(part.messages)
                part.messages.extend(msgs)
                if pid >= 0:
                    part.producer_state[pid] = (base_seq, len(msgs), base)
            return 0, base
        msgs = [(key, value, ts)
                for _off, key, value, ts in decode_message_set(record_set)]
        with self._lock:
            base = len(part.messages)
            part.messages.extend(msgs)
        return 0, base

    def _produce(self, r: Reader, api_version: int = 2) -> bytes:
        if api_version >= 3:
            r.string()                             # transactional_id
        acks, _timeout = r.i16(), r.i32()
        del acks                                   # single node: always "all"
        results = []                               # (topic, part, err, base)
        for _ in range(r.i32()):
            topic = r.string()
            for _ in range(r.i32()):
                part_id = r.i32()
                record_set = r.bytes_() or b""
                err, base = self._append(topic, part_id, record_set)
                results.append((topic, part_id, err, base))
        w = Writer()
        by_topic: Dict[str, List[Tuple[int, int, int]]] = {}
        for topic, pid, err, base in results:
            by_topic.setdefault(topic, []).append((pid, err, base))
        w.i32(len(by_topic))
        for topic, parts in by_topic.items():
            w.string(topic).i32(len(parts))
            for pid, err, base in parts:
                w.i32(pid).i16(err).i64(base).i64(-1)
        w.i32(0)                                   # throttle_time_ms
        return w.done()

    def _fetch(self, r: Reader) -> bytes:
        r.i32(); r.i32(); r.i32()                  # replica, max_wait, min_bytes
        req = []
        for _ in range(r.i32()):
            topic = r.string()
            for _ in range(r.i32()):
                pid, offset, max_bytes = r.i32(), r.i64(), r.i32()
                req.append((topic, pid, offset, max_bytes))
        w = Writer()
        w.i32(0)                                   # throttle_time_ms
        by_topic: Dict[str, List[Tuple[int, int, int]]] = {}
        for topic, pid, offset, max_bytes in req:
            by_topic.setdefault(topic, []).append((pid, offset, max_bytes))
        w.i32(len(by_topic))
        for topic, parts in by_topic.items():
            w.string(topic).i32(len(parts))
            for pid, offset, max_bytes in parts:
                part = self._partitions(topic)[pid]
                with self._lock:
                    msgs = part.messages[offset:]
                    hw = len(part.messages)
                # encode incrementally with absolute offsets and stop once
                # max_bytes is exceeded (the overflowing message is
                # truncated, Kafka-style) — never the whole partition tail
                chunks: list = []
                used = 0
                for i, msg in enumerate(msgs):
                    piece = encode_message_set([msg])
                    piece = struct.pack(">q", offset + i) + piece[8:]
                    chunks.append(piece)
                    used += len(piece)
                    if used > max_bytes:
                        break
                encoded = b"".join(chunks)
                if len(encoded) > max_bytes:
                    encoded = encoded[:max_bytes]
                w.i32(pid).i16(0).i64(hw).bytes_(encoded)
        return w.done()

    def _list_offsets(self, r: Reader) -> bytes:
        r.i32()                                    # replica id
        req = []
        for _ in range(r.i32()):
            topic = r.string()
            for _ in range(r.i32()):
                pid, _ts = r.i32(), r.i64()
                req.append((topic, pid))
        w = Writer()
        by_topic: Dict[str, List[int]] = {}
        for topic, pid in req:
            by_topic.setdefault(topic, []).append(pid)
        w.i32(len(by_topic))
        for topic, pids in by_topic.items():
            w.string(topic).i32(len(pids))
            for pid in pids:
                part = self._partitions(topic)[pid]
                with self._lock:
                    end = len(part.messages)
                w.i32(pid).i16(0).i64(-1).i64(end)
        return w.done()

    def _offset_commit(self, r: Reader) -> bytes:
        group = r.string()
        generation, member = r.i32(), r.string()
        r.i64()                                    # retention
        # fence group-managed commits (simple consumers send gen=-1, ""):
        # a member evicted by a rebalance must NOT advance offsets the new
        # owner is already consuming from
        err = 0
        if member:
            g = self._groups.get(group)
            if g is None:
                err = ERR_UNKNOWN_MEMBER_ID
            else:
                with g.cond:
                    self._evict_dead(g)
                    if member not in g.members:
                        err = ERR_UNKNOWN_MEMBER_ID
                    elif generation != g.generation:
                        err = ERR_ILLEGAL_GENERATION
                    elif g.state != "stable":
                        err = ERR_REBALANCE_IN_PROGRESS
        committed = []
        for _ in range(r.i32()):
            topic = r.string()
            for _ in range(r.i32()):
                pid, off = r.i32(), r.i64()
                r.string()                         # metadata
                if err == 0:
                    with self._lock:
                        key = (group, topic, pid)
                        if off > self._committed.get(key, 0):
                            self._committed[key] = off
                committed.append((topic, pid))
        w = Writer()
        by_topic: Dict[str, List[int]] = {}
        for topic, pid in committed:
            by_topic.setdefault(topic, []).append(pid)
        w.i32(len(by_topic))
        for topic, pids in by_topic.items():
            w.string(topic).i32(len(pids))
            for pid in pids:
                w.i32(pid).i16(err)
        return w.done()

    def _offset_fetch(self, r: Reader) -> bytes:
        group = r.string()
        req = []
        for _ in range(r.i32()):
            topic = r.string()
            for pid in r.array(Reader.i32):
                req.append((topic, pid))
        w = Writer()
        by_topic: Dict[str, List[int]] = {}
        for topic, pid in req:
            by_topic.setdefault(topic, []).append(pid)
        w.i32(len(by_topic))
        for topic, pids in by_topic.items():
            w.string(topic).i32(len(pids))
            for pid in pids:
                with self._lock:
                    off = self._committed.get((group, topic, pid), -1)
                w.i32(pid).i64(off).string(None).i16(0)
        return w.done()

    # ----------------------------------------------------- group coordinator
    def _group(self, group_id: str) -> _Group:
        with self._lock:
            g = self._groups.get(group_id)
            if g is None:
                g = self._groups[group_id] = _Group()
            return g

    @staticmethod
    def _evict_dead(g: _Group) -> None:
        """Session-timeout eviction (lock held): a member that stopped
        heartbeating is removed; if the group was stable, that triggers a
        rebalance — the survivors' next heartbeat says REBALANCE_IN_PROGRESS
        and they rejoin to adopt the dead member's partitions."""
        # rtfd-lint: allow[wall-clock] broker-protocol timeouts (real I/O even in the fake)
        now = time.monotonic()
        dead = [mid for mid, m in g.members.items()
                if now - m["last_seen"] > m["session_ms"] / 1000.0]
        for mid in dead:
            del g.members[mid]
            g.pending.pop(mid, None)
        if dead and g.state == "stable":
            g.state = "joining"
            g.pending = {}
            g.join_deadline = now + 10.0
            g.cond.notify_all()

    def _join_group(self, r: Reader) -> bytes:
        group_id = r.string()
        session_ms, rebalance_ms = r.i32(), r.i32()
        member_id = r.string()
        proto_type = r.string()
        protocols = r.array(lambda rr: (rr.string(), rr.bytes_()))
        metadata = protocols[0][1] if protocols else b""
        g = self._group(group_id)
        with g.cond:
            self._evict_dead(g)
            if not member_id:
                g.next_member_n += 1
                member_id = f"{proto_type}-{g.next_member_n}"
            if g.state in ("empty", "stable", "awaiting_sync"):
                g.state = "joining"
                g.pending = {}
                # rtfd-lint: allow[wall-clock] broker-protocol timeouts (real I/O even in the fake)
                g.join_deadline = (time.monotonic()
                                   + min(rebalance_ms, 30_000) / 1000.0)
            # each member's OWN session timeout rides with its join — the
            # completing thread must not stamp everyone with its value
            g.pending[member_id] = (metadata, session_ms)
            g.cond.notify_all()
            # the round completes when every live member has rejoined, or
            # at the rebalance deadline (stragglers are dropped)
            while g.state == "joining":
                known = set(g.members)
                if (known <= set(g.pending)
                        # rtfd-lint: allow[wall-clock] broker-protocol timeouts (real I/O even in the fake)
                        or time.monotonic() >= g.join_deadline):
                    g.generation += 1
                    # rtfd-lint: allow[wall-clock] broker-protocol timeouts (real I/O even in the fake)
                    now = time.monotonic()
                    g.members = {
                        mid: {"last_seen": now, "session_ms": sess,
                              "metadata": meta}
                        for mid, (meta, sess) in g.pending.items()
                    }
                    g.leader = sorted(g.members)[0]
                    g.assignments = {}
                    g.state = "awaiting_sync"
                    g.cond.notify_all()
                    break
                g.cond.wait(timeout=0.05)
            if member_id not in g.members:
                # joined too late: this round closed without us
                return (Writer().i16(ERR_UNKNOWN_MEMBER_ID).i32(-1)
                        .string("").string("").string("")
                        .array([], lambda w, _: None).done())
            members = (
                [(mid, m["metadata"]) for mid, m in sorted(g.members.items())]
                if member_id == g.leader else []
            )
            return (
                Writer().i16(0).i32(g.generation).string("range")
                .string(g.leader).string(member_id)
                .array(members,
                       lambda w, kv: w.string(kv[0]).bytes_(kv[1]))
                .done()
            )

    def _sync_group(self, r: Reader) -> bytes:
        group_id = r.string()
        generation, member_id = r.i32(), r.string()
        assignments = r.array(lambda rr: (rr.string(), rr.bytes_()))
        g = self._group(group_id)
        with g.cond:
            if member_id not in g.members:
                return Writer().i16(ERR_UNKNOWN_MEMBER_ID).bytes_(b"").done()
            if generation != g.generation:
                return Writer().i16(ERR_ILLEGAL_GENERATION).bytes_(b"").done()
            if member_id == g.leader and assignments:
                g.assignments = dict(assignments)
                g.state = "stable"
                g.cond.notify_all()
            # rtfd-lint: allow[wall-clock] broker-protocol timeouts (real I/O even in the fake)
            deadline = time.monotonic() + 10.0
            while (g.state == "awaiting_sync"
                   and g.generation == generation
                   # rtfd-lint: allow[wall-clock] broker-protocol timeouts (real I/O even in the fake)
                   and time.monotonic() < deadline):
                g.cond.wait(timeout=0.05)
            if g.generation != generation or g.state == "joining":
                return (Writer().i16(ERR_REBALANCE_IN_PROGRESS)
                        .bytes_(b"").done())
            if g.state != "stable":
                return (Writer().i16(ERR_REBALANCE_IN_PROGRESS)
                        .bytes_(b"").done())
            # rtfd-lint: allow[wall-clock] broker-protocol timeouts (real I/O even in the fake)
            g.members[member_id]["last_seen"] = time.monotonic()
            return (Writer().i16(0)
                    .bytes_(g.assignments.get(member_id, b"")).done())

    def _heartbeat(self, r: Reader) -> bytes:
        group_id = r.string()
        generation, member_id = r.i32(), r.string()
        g = self._group(group_id)
        with g.cond:
            self._evict_dead(g)
            if member_id not in g.members:
                return Writer().i16(ERR_UNKNOWN_MEMBER_ID).done()
            # rtfd-lint: allow[wall-clock] broker-protocol timeouts (real I/O even in the fake)
            g.members[member_id]["last_seen"] = time.monotonic()
            if generation != g.generation:
                return Writer().i16(ERR_ILLEGAL_GENERATION).done()
            if g.state != "stable":
                return Writer().i16(ERR_REBALANCE_IN_PROGRESS).done()
            return Writer().i16(0).done()

    def _leave_group(self, r: Reader) -> bytes:
        group_id = r.string()
        member_id = r.string()
        g = self._group(group_id)
        with g.cond:
            if member_id in g.members:
                del g.members[member_id]
                g.pending.pop(member_id, None)
                if g.state == "stable":
                    g.state = "joining" if g.members else "empty"
                    g.pending = {}
                    # rtfd-lint: allow[wall-clock] broker-protocol timeouts (real I/O even in the fake)
                    g.join_deadline = time.monotonic() + 10.0
                g.cond.notify_all()
        return Writer().i16(0).done()

    def kill_member(self, group_id: str, member_id: str) -> None:
        """Test hook: drop a member as if its process died (no LeaveGroup,
        no more heartbeats) by expiring its session immediately."""
        g = self._group(group_id)
        with g.cond:
            if member_id in g.members:
                g.members[member_id]["last_seen"] = -1e9
                self._evict_dead(g)
