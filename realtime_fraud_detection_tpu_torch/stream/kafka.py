"""Kafka transport: a dependency-free client speaking the Kafka wire protocol.

Port of the JAX package's ``stream/kafka.py``. The reference's backbone is
Kafka: idempotent lz4 producers, read_committed consumers, 29 topics
(config/kafka/producer.properties, FraudDetectionJob.java:141-213,
scripts/setup/create-topics.sh). This module implements the protocol
directly over TCP (the format is public: kafka.apache.org/protocol), with
no client library:

  Metadata v1 · Produce v2 (MessageSet v1 + CRC32) · Produce v3
  (RecordBatch v2 + CRC32C, idempotent) · Fetch v2 · ListOffsets v1 ·
  FindCoordinator v0 · OffsetCommit v2 · OffsetFetch v1 ·
  InitProducerId v0 · JoinGroup v1 · SyncGroup v0 · Heartbeat v0 ·
  LeaveGroup v0 (the membership client is ``stream/kafka_group.py``)

``KafkaBroker`` exposes the broker interface the port's
``transport.Consumer`` consumes (committed / partitions / read / commit /
lag and the producer surface), so ``StreamJob(broker=KafkaBroker(...))``
runs unchanged against a cluster, or against the in-process protocol fake
(``stream/kafka_fake.py``). Its frames are the JAX client's byte for byte,
so a client of either package talks to a fake of either.

Production semantics (reference config/kafka/*.properties):
- ``idempotent=True`` == ``enable.idempotence=true`` (producer.properties:8):
  batches go out as RecordBatch v2 stamped (producer_id, epoch,
  base_sequence) via InitProducerId + Produce v3; a retry after a lost ack
  resends the same sequence and the broker dedupes it. acks defaults to -1
  (``acks=all``, producer.properties:19).
- ``consumer(..., group_managed=True)`` == the reference's consumer group
  (consumer.properties:5): coordinator-managed membership with automatic
  partition rebalance on member death (``stream/kafka_group.py``).

Scope notes:
- ``compression="gzip"`` on the RecordBatch v2 producer path stands in for
  the reference's ``compression.type=lz4`` (producer.properties:11) with a
  codec the Python standard library has (it has no lz4); the codec is
  chosen per batch in the protocol. The legacy v1 message-set path
  (non-idempotent producers) stays uncompressed. CRC32C is pure Python.
- Exactly-once is the job's own offset / dedupe protocol (commit after
  fan-out, transaction-cache dedupe, ``stream/job.py``), not Kafka
  transactions.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
import zlib
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from realtime_fraud_detection_tpu_torch.stream.transport import (
    Consumer,
    FaultInjector,
    Record,
)

__all__ = ["KafkaBroker", "KafkaConnection", "KafkaProtocolError"]

API_PRODUCE = 0
API_FETCH = 1
API_LIST_OFFSETS = 2
API_METADATA = 3
API_OFFSET_COMMIT = 8
API_OFFSET_FETCH = 9
API_FIND_COORDINATOR = 10
API_JOIN_GROUP = 11
API_HEARTBEAT = 12
API_LEAVE_GROUP = 13
API_SYNC_GROUP = 14
API_INIT_PRODUCER_ID = 22

ERR_OFFSET_OUT_OF_RANGE = 1
ERR_ILLEGAL_GENERATION = 22
ERR_UNKNOWN_MEMBER_ID = 25
ERR_REBALANCE_IN_PROGRESS = 27
ERR_OUT_OF_ORDER_SEQUENCE = 45

_ERRORS = {
    0: "NONE", 1: "OFFSET_OUT_OF_RANGE", 3: "UNKNOWN_TOPIC_OR_PARTITION",
    5: "LEADER_NOT_AVAILABLE", 6: "NOT_LEADER_FOR_PARTITION",
    15: "COORDINATOR_NOT_AVAILABLE", 16: "NOT_COORDINATOR",
    22: "ILLEGAL_GENERATION", 25: "UNKNOWN_MEMBER_ID",
    27: "REBALANCE_IN_PROGRESS", 45: "OUT_OF_ORDER_SEQUENCE_NUMBER",
}


class KafkaProtocolError(RuntimeError):
    def __init__(self, api: str, code: int):
        super().__init__(
            f"{api}: error_code={code} ({_ERRORS.get(code, 'UNKNOWN')})")
        self.code = code


# ---------------------------------------------------------------------------
# primitive codec (big-endian, pre-flexible-versions encoding)
# ---------------------------------------------------------------------------


class Writer:
    __slots__ = ("_parts",)

    def __init__(self) -> None:
        self._parts: List[bytes] = []

    def i8(self, v: int) -> "Writer":
        self._parts.append(struct.pack(">b", v)); return self

    def i16(self, v: int) -> "Writer":
        self._parts.append(struct.pack(">h", v)); return self

    def i32(self, v: int) -> "Writer":
        self._parts.append(struct.pack(">i", v)); return self

    def i64(self, v: int) -> "Writer":
        self._parts.append(struct.pack(">q", v)); return self

    def u32(self, v: int) -> "Writer":
        self._parts.append(struct.pack(">I", v)); return self

    def string(self, s: Optional[str]) -> "Writer":
        if s is None:
            return self.i16(-1)
        b = s.encode()
        self.i16(len(b)); self._parts.append(b); return self

    def bytes_(self, b: Optional[bytes]) -> "Writer":
        if b is None:
            return self.i32(-1)
        self.i32(len(b)); self._parts.append(b); return self

    def raw(self, b: bytes) -> "Writer":
        self._parts.append(b); return self

    def array(self, items, encode_one) -> "Writer":
        self.i32(len(items))
        for it in items:
            encode_one(self, it)
        return self

    def done(self) -> bytes:
        return b"".join(self._parts)


class Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0) -> None:
        self.buf = buf
        self.pos = pos

    def _take(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) < n:
            raise EOFError("short read in Kafka frame")
        self.pos += n
        return b

    def i8(self) -> int:
        return struct.unpack(">b", self._take(1))[0]

    def i16(self) -> int:
        return struct.unpack(">h", self._take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def string(self) -> Optional[str]:
        n = self.i16()
        return None if n < 0 else self._take(n).decode()

    def bytes_(self) -> Optional[bytes]:
        n = self.i32()
        return None if n < 0 else self._take(n)

    def array(self, decode_one) -> list:
        return [decode_one(self) for _ in range(self.i32())]

    def remaining(self) -> int:
        return len(self.buf) - self.pos


# ---------------------------------------------------------------------------
# MessageSet v1 (magic=1): the on-wire record format for Produce/Fetch v0-v3
# ---------------------------------------------------------------------------


def encode_message_set(
    messages: Sequence[Tuple[Optional[bytes], Optional[bytes], int]],
) -> bytes:
    """[(key, value, timestamp_ms)] -> MessageSet v1 bytes (offsets 0..n-1;
    the broker rewrites offsets on append)."""
    w = Writer()
    for i, (key, value, ts) in enumerate(messages):
        body = (
            Writer().i8(1).i8(0).i64(ts).bytes_(key).bytes_(value).done()
        )  # magic=1, attributes=0 (uncompressed)
        crc = zlib.crc32(body) & 0xFFFFFFFF
        msg = Writer().u32(crc).raw(body).done()
        w.i64(i).i32(len(msg)).raw(msg)
    return w.done()


def decode_message_set(buf: bytes) -> List[Tuple[int, Optional[bytes], Optional[bytes], int]]:
    """MessageSet bytes -> [(offset, key, value, timestamp_ms)].

    A Fetch response may end with a truncated message (Kafka semantics);
    the incomplete tail is dropped. CRC is verified per message.

    Handles what a real broker can hand a Fetch v2 consumer:
    - plain v0/v1 messages;
    - a gzip WRAPPER message (codec bits 1): its value is itself an encoded
      message set holding the batch — the down-converted form of this
      client's own gzip RecordBatch v2 produces. The wrapper's offset is
      the offset of the LAST inner message (v1 semantics); inner relative
      offsets are rebased accordingly;
    - a raw RecordBatch v2 (magic=2) if the broker skips down-conversion.
    """
    out: List[Tuple[int, Optional[bytes], Optional[bytes], int]] = []
    r = Reader(buf)
    while r.remaining() >= 12:
        # magic=2 batches are not framed as [offset][size][message]: peek
        # the magic byte at its fixed RecordBatch position (offset 16)
        if r.remaining() >= 17 and r.buf[r.pos + 16] == 2:
            base = r.pos
            _off, size = struct.unpack_from(">qi", r.buf, base)
            if r.remaining() < 12 + size:
                break                  # truncated trailing batch
            batch = r._take(12 + size)
            recs, _pid, _pe, _seq = decode_record_batch(batch)
            out.extend(recs)
            continue
        offset = r.i64()
        size = r.i32()
        if r.remaining() < size:
            break                      # truncated trailing message
        msg = Reader(r._take(size))
        crc = msg.u32()
        body_start = msg.pos
        if zlib.crc32(msg.buf[body_start:]) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in message at offset {offset}")
        magic = msg.i8()
        attributes = msg.i8()
        codec = attributes & 0x07
        ts = msg.i64() if magic >= 1 else -1
        key = msg.bytes_()
        value = msg.bytes_()
        if codec == 0:
            out.append((offset, key, value, ts))
            continue
        if codec != 1 or value is None:
            raise NotImplementedError(
                f"unsupported message-set codec {codec} (gzip only)")
        import gzip as _gzip

        inner = decode_message_set(_gzip.decompress(value))
        # v1 wrapper offset = offset of the LAST inner message; inner
        # offsets are 0..n-1 relative
        last_rel = inner[-1][0] if inner else 0
        for rel, ik, iv, its in inner:
            out.append((offset - last_rel + rel, ik, iv,
                        its if its != -1 else ts))
    return out


# ---------------------------------------------------------------------------
# RecordBatch v2 (magic=2): the format idempotent producers must use — it is
# the only record format carrying producerId/producerEpoch/baseSequence
# (reference producer.properties:8 enable.idempotence=true). Varint-encoded
# records, CRC32C (Castagnoli) integrity — implemented here because zlib
# only has CRC32.
# ---------------------------------------------------------------------------


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _write_varint(out: bytearray, v: int) -> None:
    """Zigzag + LEB128, the Kafka record field encoding."""
    u = ((v << 1) ^ (v >> 63)) & ((1 << 64) - 1)
    while True:
        if u < 0x80:
            out.append(u)
            return
        out.append((u & 0x7F) | 0x80)
        u >>= 7


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift, u = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        u |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    v = (u >> 1) ^ -(u & 1)
    return v, pos


def encode_record_batch(
    messages: Sequence[Tuple[Optional[bytes], Optional[bytes], int]],
    producer_id: int = -1, producer_epoch: int = -1,
    base_sequence: int = -1, compression: Optional[str] = None,
) -> bytes:
    """[(key, value, timestamp_ms)] -> RecordBatch v2 bytes.

    ``compression="gzip"`` gzips the records section and sets the batch
    attributes codec bits (codec 1) — the v2 analog of the reference's
    ``compression.type`` producer setting (producer.properties:11; the
    reference uses lz4, whose codec has no stdlib implementation here, so
    this client speaks gzip — codec negotiation is per-batch in the
    protocol, brokers accept any supported codec).
    """
    first_ts = messages[0][2]
    max_ts = max(m[2] for m in messages)
    records = bytearray()
    for i, (key, value, ts) in enumerate(messages):
        body = bytearray()
        body.append(0)                            # record attributes
        _write_varint(body, ts - first_ts)
        _write_varint(body, i)                    # offset delta
        for blob in (key, value):
            if blob is None:
                _write_varint(body, -1)
            else:
                _write_varint(body, len(blob))
                body.extend(blob)
        _write_varint(body, 0)                    # headers
        _write_varint(records, len(body))
        records.extend(body)
    if compression is None:
        attrs, records_wire = 0, bytes(records)
    elif compression == "gzip":
        import gzip as _gzip

        attrs, records_wire = 1, _gzip.compress(bytes(records), mtime=0)
    else:
        raise ValueError(f"unsupported compression codec: {compression}")
    after_crc = (
        struct.pack(">hiqqqhii", attrs, len(messages) - 1, first_ts, max_ts,
                    producer_id, producer_epoch, base_sequence,
                    len(messages))
        + records_wire
    )
    crc = crc32c(after_crc)
    tail = struct.pack(">ibI", -1, 2, crc) + after_crc   # leaderEpoch, magic
    return struct.pack(">qi", 0, len(tail)) + tail       # baseOffset, length


def decode_record_batch(buf: bytes) -> Tuple[
    List[Tuple[int, Optional[bytes], Optional[bytes], int]], int, int, int,
]:
    """RecordBatch v2 bytes -> ([(offset_delta, key, value, ts_ms)],
    producer_id, producer_epoch, base_sequence). Verifies CRC32C."""
    base_offset, _length, _epoch, magic, crc = struct.unpack_from(">qiibI", buf)
    if magic != 2:
        raise ValueError(f"not a v2 record batch (magic={magic})")
    after_crc = buf[21:]
    if crc32c(after_crc) != crc:
        raise ValueError("bad CRC32C in record batch")
    (attrs, _last_delta, first_ts, _max_ts, pid, pepoch, base_seq,
     count) = struct.unpack_from(">hiqqqhii", after_crc)
    hdr_end = struct.calcsize(">hiqqqhii")
    codec = attrs & 0x07
    if codec == 0:
        recs, pos = after_crc, hdr_end
    elif codec == 1:                              # gzip
        import gzip as _gzip

        recs, pos = _gzip.decompress(after_crc[hdr_end:]), 0
    else:
        raise ValueError(f"unsupported record-batch codec {codec}")
    out: List[Tuple[int, Optional[bytes], Optional[bytes], int]] = []
    for _ in range(count):
        _rec_len, pos = _read_varint(recs, pos)
        pos += 1                                  # record attributes
        ts_delta, pos = _read_varint(recs, pos)
        off_delta, pos = _read_varint(recs, pos)
        blobs: List[Optional[bytes]] = []
        for _f in range(2):
            n, pos = _read_varint(recs, pos)
            if n < 0:
                blobs.append(None)
            else:
                blobs.append(recs[pos:pos + n])
                pos += n
        n_headers, pos = _read_varint(recs, pos)
        for _h in range(n_headers):
            for _kv in range(2):
                n, pos = _read_varint(recs, pos)
                pos += max(0, n)
        out.append((base_offset + off_delta, blobs[0], blobs[1],
                    first_ts + ts_delta))
    return out, pid, pepoch, base_seq


# ---------------------------------------------------------------------------
# connection: framed request/response with correlation ids
# ---------------------------------------------------------------------------


class KafkaConnection:
    """One broker connection. Thread-safe; requests are serialized."""

    def __init__(self, host: str, port: int, client_id: str = "rtfd-tpu",
                 timeout_s: float = 30.0):
        self.host, self.port = host, port
        self.client_id = client_id
        self.timeout_s = timeout_s
        self._sock = socket.create_connection((host, port), timeout=timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()
        self._corr = 0

    def reconnect(self) -> None:
        """Re-dial after a broken connection (the idempotent producer's
        retry path: resend the SAME batch/sequence on the new socket)."""
        with self._lock:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout_s)
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def request(self, api_key: int, api_version: int, body: bytes,
                expect_response: bool = True) -> Optional[Reader]:
        with self._lock:
            self._corr += 1
            corr = self._corr
            header = (
                Writer().i16(api_key).i16(api_version).i32(corr)
                .string(self.client_id).done()
            )
            frame = header + body
            self._sock.sendall(struct.pack(">i", len(frame)) + frame)
            if not expect_response:   # acks=0 Produce: broker sends nothing
                return None
            resp = self._recv_frame()
        r = Reader(resp)
        got_corr = r.i32()
        if got_corr != corr:
            raise RuntimeError(
                f"correlation mismatch: sent {corr}, got {got_corr}")
        return r

    def _recv_frame(self) -> bytes:
        header = self._recv_exact(4)
        (length,) = struct.unpack(">i", header)
        return self._recv_exact(length)

    def _recv_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("Kafka broker closed the connection")
            buf.extend(chunk)
        return bytes(buf)


# ---------------------------------------------------------------------------
# the transport adapter
# ---------------------------------------------------------------------------


class KafkaBroker:
    """Kafka-backed implementation of the port's broker interface.

    Values are JSON dicts, keys are UTF-8 strings. The client partitions:
    a keyed produce goes to crc32(key) % partitions, as ``InMemoryBroker``
    routes it (same key -> same partition -> per-key order).
    """

    def __init__(self, bootstrap: str = "127.0.0.1:9092",
                 client_id: str = "rtfd-tpu", acks: int = -1,
                 timeout_s: float = 30.0, idempotent: bool = False,
                 compression: Optional[str] = None,
                 retry_sleep=None):
        from realtime_fraud_detection_tpu_torch.utils.backoff import (
            DeterministicBackoff,
            instance_seed,
        )

        host, _, port = bootstrap.partition(":")
        # produce-retry schedule: bounded exponential + deterministic
        # jitter, seeded per client INSTANCE (most callers share the
        # default client_id, and those are exactly the producers whose
        # retry storms must de-synchronize); ``retry_sleep`` is the
        # injected seam (tests / the chaos plane pass a recording or
        # virtual-clock sleep)
        self._backoff = DeterministicBackoff(
            base_s=0.05, mult=2.0, max_s=0.8,
            seed=instance_seed(client_id), sleep=retry_sleep)
        self.acks = acks                         # -1 == acks=all (reference)
        self.timeout_s = timeout_s
        # producer-side codec (reference compression.type=lz4,
        # producer.properties:11; we speak gzip — see encode_record_batch).
        # Applied on the RecordBatch v2 path, i.e. requires idempotent=True.
        if compression is not None and not idempotent:
            raise ValueError(
                "compression requires the RecordBatch v2 producer "
                "(idempotent=True); the legacy v1 message-set path stays "
                "uncompressed")
        self.compression = compression
        self._conn = KafkaConnection(host, int(port or 9092), client_id,
                                     timeout_s)
        self._coord: Optional[KafkaConnection] = None
        self._meta: Dict[str, List[int]] = {}    # topic -> partition ids
        self._rr: Dict[str, int] = {}
        # idempotent produce (producer.properties:8 enable.idempotence=true):
        # RecordBatch v2 stamped with (producer_id, epoch, base_sequence);
        # the broker dedupes a retried batch by sequence number, so a resend
        # after a lost ack cannot double-append.
        self.idempotent = idempotent
        if idempotent and acks == 0:
            raise ValueError("idempotent produce requires acks != 0")
        self._pid = -1
        self._pepoch = -1
        self._seq: Dict[Tuple[str, int], int] = {}   # (topic, part) -> next
        # _seq_lock guards only pid init + per-partition lock creation; the
        # network I/O (and its retries/backoff) runs under a PER-PARTITION
        # lock, so a wedged partition can't serialize the whole producer —
        # while same-partition produces stay strictly in sequence order.
        self._seq_lock = threading.Lock()
        self._part_locks: Dict[Tuple[str, int], threading.Lock] = {}

    def close(self) -> None:
        self._conn.close()
        if self._coord is not None and self._coord is not self._conn:
            self._coord.close()

    # ------------------------------------------------------------- metadata
    def _metadata(self, topic: str) -> List[int]:
        parts = self._meta.get(topic)
        if parts:
            return parts
        # LEADER_NOT_AVAILABLE (5) while an auto-created topic elects a
        # leader is transient — retry with backoff before giving up
        # rtfd-lint: allow[wall-clock] real-broker client: I/O deadlines and record timestamps
        deadline = time.monotonic() + min(self.timeout_s, 10.0)
        last_err = 3
        while True:
            body = Writer().array([topic], lambda w, t: w.string(t)).done()
            r = self._conn.request(API_METADATA, 1, body)
            r.array(lambda rr: (rr.i32(), rr.string(), rr.i32(), rr.string()))
            r.i32()                               # controller_id
            topics = r.array(lambda rr: (
                rr.i16(), rr.string(), rr.i8(),
                rr.array(lambda p: (
                    p.i16(), p.i32(), p.i32(),
                    p.array(Reader.i32), p.array(Reader.i32))),
            ))
            for err, name, _internal, partitions in topics:
                if err:
                    last_err = err
                    continue
                self._meta[name] = sorted(p[1] for p in partitions)
            parts = self._meta.get(topic)
            if parts:
                return parts
            # rtfd-lint: allow[wall-clock] real-broker client: I/O deadlines and record timestamps
            if last_err not in (5, 3) or time.monotonic() >= deadline:
                raise KafkaProtocolError("Metadata", last_err)
            time.sleep(0.1)

    def partitions(self, topic: str) -> int:
        return len(self._metadata(topic))

    # -------------------------------------------------------------- produce
    def _pick_partition(self, topic: str, key: Optional[str]) -> int:
        n = self.partitions(topic)
        if key is not None:
            # stable across processes (Python's str hash is salted per
            # process): same key -> same partition from every producer
            return zlib.crc32(key.encode()) % n
        cur = self._rr.get(topic, 0)
        self._rr[topic] = cur + 1
        return cur % n

    def produce(self, topic: str, value: Any, key: Optional[str] = None,
                timestamp: Optional[float] = None) -> Record:
        part = self._pick_partition(topic, key)
        # rtfd-lint: allow[wall-clock] real-broker client: I/O deadlines and record timestamps
        ts = timestamp if timestamp is not None else time.time()
        offset = self._produce_raw(topic, part, [(
            key.encode() if key is not None else None,
            json.dumps(value, separators=(",", ":")).encode(),
            int(ts * 1000),
        )])
        return Record(topic, part, offset, key, value, ts)

    def produce_batch(self, topic: str, values, key_fn=None) -> int:
        by_part: Dict[int, list] = {}
        # rtfd-lint: allow[wall-clock] real-broker client: I/O deadlines and record timestamps
        now_ms = int(time.time() * 1000)
        n = 0
        for v in values:
            key = key_fn(v) if key_fn else None
            part = self._pick_partition(topic, key)
            by_part.setdefault(part, []).append((
                key.encode() if key is not None else None,
                json.dumps(v, separators=(",", ":")).encode(), now_ms))
            n += 1
        for part, msgs in by_part.items():
            self._produce_raw(topic, part, msgs)
        return n

    def produce_batch_keyed(self, topic: str, items) -> int:
        """(key, value) pairs batched into per-partition RecordBatches —
        same wire efficiency as produce_batch, explicit keys."""
        by_part: Dict[int, list] = {}
        # rtfd-lint: allow[wall-clock] real-broker client: I/O deadlines and record timestamps
        now_ms = int(time.time() * 1000)
        n = 0
        for key, v in items:
            part = self._pick_partition(topic, key)
            by_part.setdefault(part, []).append((
                key.encode() if key is not None else None,
                json.dumps(v, separators=(",", ":")).encode(), now_ms))
            n += 1
        for part, msgs in by_part.items():
            self._produce_raw(topic, part, msgs)
        return n

    def _init_producer_id(self) -> None:
        """InitProducerId v0: acquire (producer_id, epoch) for idempotence."""
        body = Writer().string(None).i32(60_000).done()
        r = self._conn.request(API_INIT_PRODUCER_ID, 0, body)
        r.i32()                                   # throttle_time_ms
        err = r.i16()
        if err:
            raise KafkaProtocolError("InitProducerId", err)
        self._pid = r.i64()
        self._pepoch = r.i16()

    def _produce_raw(self, topic: str, partition: int,
                     messages: List[Tuple[Optional[bytes], Optional[bytes], int]]) -> int:
        if not self.idempotent:
            return self._produce_request(
                topic, partition, encode_message_set(messages), api_version=2)
        key = (topic, partition)
        with self._seq_lock:
            if self._pid < 0:
                self._init_producer_id()
            pid, pepoch = self._pid, self._pepoch
            plock = self._part_locks.setdefault(key, threading.Lock())
        with plock:
            with self._seq_lock:
                if self._pid != pid:       # identity reset by another thread
                    pid, pepoch = self._pid, self._pepoch
                    if pid < 0:
                        self._init_producer_id()
                        pid, pepoch = self._pid, self._pepoch
                seq = self._seq.get(key, 0)
            record_set = encode_record_batch(
                messages, producer_id=pid, producer_epoch=pepoch,
                base_sequence=seq, compression=self.compression)
            # Retry the SAME bytes (same baseSequence) across connection
            # failures: the broker recognizes a replayed sequence and
            # returns the original offset instead of double-appending —
            # this is what enable.idempotence=true means.
            last_exc: Optional[Exception] = None
            for attempt in range(3):
                try:
                    off = self._produce_request(
                        topic, partition, record_set, api_version=3)
                    with self._seq_lock:
                        self._seq[key] = seq + len(messages)
                    return off
                except (ConnectionError, OSError) as e:
                    last_exc = e
                    # The partition lock deliberately spans this retry wait
                    # (baseSequence must not interleave); the wait itself
                    # goes through the injected backoff seam — bounded
                    # exponential with deterministic jitter, virtualizable
                    # by tests/drills instead of a fixed bare sleep.
                    self._backoff.sleep(attempt)
                    try:
                        self._conn.reconnect()
                    except OSError:
                        continue
            # Retries exhausted with the batch's fate unknown: the broker
            # may have appended it. The sequence is now unresolvable — a
            # LATER batch reusing it would be silently deduped as a
            # "retry" and lost. Discard the producer identity; the next
            # produce re-runs InitProducerId for a fresh (pid, seq=0).
            with self._seq_lock:
                self._pid = -1
                self._pepoch = -1
                self._seq.clear()
            raise ConnectionError(
                f"produce to {topic}/{partition} failed after retries"
            ) from last_exc

    def _produce_request(self, topic: str, partition: int,
                         record_set: bytes, api_version: int) -> int:
        w = Writer()
        if api_version >= 3:
            w.string(None)                        # transactional_id
        body = (
            w.i16(self.acks).i32(int(self.timeout_s * 1000))
            .array([None], lambda ww, _:
                   ww.string(topic).array([None], lambda w2, _2:
                                          w2.i32(partition).bytes_(record_set)))
            .done()
        )
        r = self._conn.request(API_PRODUCE, api_version, body,
                               expect_response=self.acks != 0)
        if r is None:                             # acks=0: fire and forget
            return -1
        base_offset = -1
        for _ in range(r.i32()):                  # topics
            r.string()
            for _ in range(r.i32()):              # partitions
                _part, err, off = r.i32(), r.i16(), r.i64()
                r.i64()                           # log_append_time
                if err:
                    raise KafkaProtocolError("Produce", err)
                base_offset = off
        r.i32()                                   # throttle_time_ms
        return base_offset

    # --------------------------------------------------------------- fetch
    def read(self, topic: str, partition: int, start: int,
             limit: int) -> List[Record]:
        body = (
            Writer().i32(-1).i32(0).i32(1)        # replica=-1, wait=0, min=1
            .array([None], lambda w, _:
                   w.string(topic).array([None], lambda w2, _2:
                                         w2.i32(partition).i64(start)
                                         .i32(4 * 1024 * 1024)))
            .done()
        )
        r = self._conn.request(API_FETCH, 2, body)
        r.i32()                                   # throttle_time_ms
        out: List[Record] = []
        for _ in range(r.i32()):
            t = r.string()
            for _ in range(r.i32()):
                part, err = r.i32(), r.i16()
                r.i64()                           # high watermark
                record_set = r.bytes_() or b""
                if err == 1:                      # OFFSET_OUT_OF_RANGE: empty
                    continue
                if err:
                    raise KafkaProtocolError("Fetch", err)
                for off, key, value, ts in decode_message_set(record_set):
                    if off < start:               # log-compaction semantics
                        continue
                    out.append(Record(
                        t, part, off,
                        key.decode() if key is not None else None,
                        json.loads(value) if value else None,
                        ts / 1000.0))
                    if len(out) >= limit:
                        break
        return out[:limit]

    def end_offsets(self, topic: str) -> List[int]:
        parts = self._metadata(topic)
        body = (
            Writer().i32(-1)
            .array([None], lambda w, _:
                   w.string(topic).array(parts, lambda w2, p:
                                         w2.i32(p).i64(-1)))
            .done()
        )
        r = self._conn.request(API_LIST_OFFSETS, 1, body)
        ends = {p: 0 for p in parts}
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                part, err, _ts, off = r.i32(), r.i16(), r.i64(), r.i64()
                if err:
                    raise KafkaProtocolError("ListOffsets", err)
                ends[part] = off
        return [ends[p] for p in parts]

    # ------------------------------------------------------------- offsets
    def _coordinator(self, group: str) -> KafkaConnection:
        if self._coord is not None:
            return self._coord
        body = Writer().string(group).done()
        r = self._conn.request(API_FIND_COORDINATOR, 0, body)
        err = r.i16()
        if err:
            raise KafkaProtocolError("FindCoordinator", err)
        node, host, port = r.i32(), r.string(), r.i32()
        del node
        if (host, port) == (self._conn.host, self._conn.port):
            self._coord = self._conn
        else:
            self._coord = KafkaConnection(host, port, self._conn.client_id,
                                          self.timeout_s)
        return self._coord

    def _invalidate_coordinator(self) -> None:
        if self._coord is not None and self._coord is not self._conn:
            self._coord.close()
        self._coord = None

    def _with_coordinator(self, group: str, api: str, do):
        """Run a coordinator request; on NOT_COORDINATOR (16) or
        COORDINATOR_NOT_AVAILABLE (15) — a coordinator failover —
        re-discover once and retry."""
        try:
            return do(self._coordinator(group))
        except KafkaProtocolError as e:
            if e.code not in (15, 16):
                raise
            self._invalidate_coordinator()
            return do(self._coordinator(group))

    def commit(self, group: str, offsets: Mapping[tuple, int],
               generation_id: int = -1, member_id: str = "") -> None:
        """Commit offsets. ``generation_id``/``member_id`` default to simple
        consumer mode; a GroupConsumer passes its membership so the
        coordinator fences commits from a member evicted by a rebalance."""
        by_topic: Dict[str, List[Tuple[int, int]]] = {}
        for (topic, part), off in offsets.items():
            by_topic.setdefault(topic, []).append((part, off))
        if not by_topic:
            return
        body = (
            Writer().string(group).i32(generation_id).string(member_id)
            .i64(-1)
            .array(sorted(by_topic.items()), lambda w, kv:
                   w.string(kv[0]).array(kv[1], lambda w2, po:
                                         w2.i32(po[0]).i64(po[1])
                                         .string(None)))
            .done()
        )

        def _do(conn: KafkaConnection) -> None:
            r = conn.request(API_OFFSET_COMMIT, 2, body)
            for _ in range(r.i32()):
                r.string()
                for _ in range(r.i32()):
                    _part, err = r.i32(), r.i16()
                    if err:
                        raise KafkaProtocolError("OffsetCommit", err)

        self._with_coordinator(group, "OffsetCommit", _do)

    def committed(self, group: str, topic: str, partition: int) -> int:
        body = (
            Writer().string(group)
            .array([None], lambda w, _:
                   w.string(topic).array([partition], Writer.i32))
            .done()
        )

        def _do(conn: KafkaConnection) -> int:
            r = conn.request(API_OFFSET_FETCH, 1, body)
            result = 0
            for _ in range(r.i32()):
                r.string()
                for _ in range(r.i32()):
                    _part, off = r.i32(), r.i64()
                    r.string()                    # metadata
                    err = r.i16()
                    if err:
                        raise KafkaProtocolError("OffsetFetch", err)
                    result = max(0, off)          # -1 == no commit yet
            return result

        return self._with_coordinator(group, "OffsetFetch", _do)

    def lag(self, group: str, topic: str) -> int:
        ends = self.end_offsets(topic)
        return sum(
            max(0, end - self.committed(group, topic, p))
            for p, end in enumerate(ends)
        )

    # ------------------------------------------------------------- consume
    def consumer(self, topics: Sequence[str], group_id: str,
                 faults: Optional[FaultInjector] = None,
                 group_managed: bool = False):
        """Static-assignment consumer by default; ``group_managed=True``
        returns a coordinator-managed member (JoinGroup/SyncGroup/Heartbeat,
        stream/kafka_group.py) so N StreamJob processes in one group split
        partitions and fail over automatically, like the reference's
        consumer group (consumer.properties:5)."""
        if group_managed:
            if faults is not None:
                raise ValueError(
                    "fault injection is not supported on group-managed "
                    "consumers; use the static consumer for chaos tests")
            from realtime_fraud_detection_tpu_torch.stream.kafka_group import (
                KafkaGroupConsumer,
            )

            return KafkaGroupConsumer(self, list(topics), group_id)
        return Consumer(self, list(topics), group_id, faults)

    def create_topic(self, name: str, partitions: int) -> None:
        """Topic creation is an admin-plane operation (the reference uses
        scripts/setup/create-topics.sh); rely on broker auto-create or the
        admin CLI. Refresh our metadata cache so a newly-created topic is
        visible."""
        self._meta.pop(name, None)
