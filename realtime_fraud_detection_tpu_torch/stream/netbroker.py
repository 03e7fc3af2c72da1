"""Networked, durable transport: a standalone TCP log broker + client.

Port of the JAX package's ``stream/netbroker.py``, frame for frame: the
wire format (4-byte big-endian length + compact JSON), the ops and their
fields are the JAX broker's, so a port client talks to a JAX broker and the
reverse. The reference's data backbone is an external Kafka cluster — the
stream job, the simulator and the serving tier are separate processes
joined by brokers (docker-compose.yml, FraudDetectionJob.java:141-213):

- ``BrokerServer`` — a TCP server exposing the partitioned-log operations
  (produce / fetch / commit / committed / lag / end_offsets / create_topic)
  over the framed JSON protocol. State is an ``InMemoryBroker`` plus an
  optional write-ahead segment directory: every produce is appended to
  ``<log_dir>/<topic>-<partition>.jsonl`` and fsync'd before the ack, group
  offsets land in ``<log_dir>/offsets.json`` on commit, and a restarting
  server replays both, so the broker survives process death the way
  Kafka's log does.
- ``NetBrokerClient`` — speaks the protocol from any process and implements
  the broker interface ``stream.transport.Consumer`` consumes (committed /
  partitions / read / commit / lag / end_offsets, and the reconnect epoch),
  so ``StreamJob(broker=NetBrokerClient(...))`` runs unchanged against a
  remote broker. One TCP connection, request / response framing,
  thread-safe. ``link=`` takes an optional in-path object with
  ``before_send(req, nbytes)`` / ``after_recv(req)`` (fault injection);
  None in production.

Replication (the reference runs 3 brokers with RF=3, minISR=2,
scripts/setup/create-topics.sh:9-12):

- A second ``BrokerServer`` started with ``role="replica"`` serves reads
  but refuses writes (``READONLY``). ``primary.add_replica(host, port)``
  catches it up (topic layout, record backlog, group offsets) and then
  ships every produce to it synchronously before the producer's ack.
  ``min_isr`` gates the ack: a produce that cannot reach ``min_isr``
  in-sync copies (self included) fails with ``NotEnoughReplicasError``; a
  replica that errors is dropped from the ISR.
- Offset commits are forwarded to replicas too, so a promoted replica
  resumes every consumer group where the dead primary acked it.
- ``promote()`` (or the ``promote`` wire op) flips a replica to primary.
- ``HaBrokerClient([(h1, p1), (h2, p2)])`` is the client side of failover:
  on connection loss or READONLY it rotates to the next address and
  retries. A retried produce can duplicate (at-least-once, like any
  acks=all producer retry); consumers dedupe by transaction id
  (``stream/job.py dispatch_batch``).

High watermark: consumers read only up to the per-partition watermark,
which advances when a produce reaches its ``min_isr`` copies, so no
consumer observes a record whose producer was told it was not written.
Pinned watermarks are persisted (``hw.json``), so a primary restart cannot
re-expose a WAL-replayed unacked tail either.

Producer generation fencing: ``fence_producers`` refuses stamped produces
and commits below a partition's fence with ``StaleGenerationError``
(``NetBrokerClient.generation`` stamps them; unstamped producers pass), and
fences forward to replicas like commits. The contract tests run against
both packages' brokers (tests/test_torch_netbroker.py).
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import struct
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence

from realtime_fraud_detection_tpu_torch.stream.topics import TOPIC_SPECS, TopicSpec
from realtime_fraud_detection_tpu_torch.stream.transport import (
    Consumer,
    FaultInjector,
    InMemoryBroker,
    Record,
    StaleGenerationError,
)

__all__ = ["BrokerServer", "NetBrokerClient", "HaBrokerClient",
           "StaleGenerationError"]

_LEN = struct.Struct(">I")
_MAX_FRAME = 64 * 1024 * 1024


def _send_frame(sock: socket.socket, obj: Any) -> None:
    payload = json.dumps(obj, separators=(",", ":")).encode()
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int,
                deadline: Optional[float] = None) -> Optional[bytes]:
    """Read exactly ``n`` bytes. With ``deadline`` (an absolute monotonic
    instant) the WHOLE read is bounded — a hung-not-dead peer (SIGSTOP'd
    broker, stalled middlebox) trickling one byte per socket-timeout
    window would otherwise reset the per-recv timeout forever and wedge
    the caller; here every chunk shrinks the remaining budget."""
    buf = bytearray()
    while len(buf) < n:
        if deadline is not None:
            # rtfd-lint: allow[wall-clock] socket I/O deadlines are genuinely wall-bound
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"frame read deadline exceeded with {n - len(buf)} "
                    f"bytes outstanding")
            sock.settimeout(remaining)
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock: socket.socket,
                deadline: Optional[float] = None) -> Optional[Any]:
    header = _recv_exact(sock, _LEN.size, deadline)
    if header is None:
        return None
    (length,) = _LEN.unpack(header)
    if length > _MAX_FRAME:
        raise ValueError(f"frame of {length} bytes exceeds limit")
    payload = _recv_exact(sock, length, deadline)
    if payload is None:
        return None
    return json.loads(payload)


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:  # one connection, many requests
        server: BrokerServer = self.server.outer  # type: ignore[attr-defined]
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        server._conns.add(sock)
        try:
            while True:
                try:
                    req = _recv_frame(sock)
                except (ConnectionError, ValueError, json.JSONDecodeError,
                        OSError):
                    return
                if req is None:
                    return
                try:
                    resp = server.dispatch(req)
                except Exception as e:  # noqa: BLE001 - per-request isolation
                    resp = {"error": f"{type(e).__name__}: {e}"}
                try:
                    _send_frame(sock, resp)
                except (ConnectionError, OSError):
                    return
        finally:
            server._conns.discard(sock)


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class _ReplicaLink:
    """Primary-held connection to one replica server (the shipping lane)."""

    def __init__(self, host: str, port: int, timeout_s: float = 10.0):
        self.addr = (host, port)
        self._sock = socket.create_connection((host, port), timeout=timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()

    def call(self, req: Mapping[str, Any]) -> Dict[str, Any]:
        with self._lock:
            _send_frame(self._sock, req)
            resp = _recv_frame(self._sock)
        if resp is None:
            raise ConnectionError("replica closed the connection")
        if "error" in resp:
            raise RuntimeError(f"replica error: {resp['error']}")
        return resp

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class NotEnoughReplicasError(RuntimeError):
    """Produce could not reach min_isr in-sync copies (Kafka's
    NOT_ENOUGH_REPLICAS). The record may exist on the primary's log but was
    NOT acked — a retried producer may duplicate it (at-least-once)."""


class BrokerServer:
    """Serve an (optionally durable, optionally replicated) partitioned log
    over TCP. ``role="replica"`` starts read-only; ``min_isr`` counts the
    primary itself (min_isr=2 means "me plus at least one replica")."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 topics: Sequence[TopicSpec] = TOPIC_SPECS,
                 log_dir: Optional[str] = None,
                 role: str = "primary", min_isr: int = 1):
        if role not in ("primary", "replica"):
            raise ValueError(f"role must be primary|replica, got {role!r}")
        self.broker = InMemoryBroker(topics)
        self.log_dir = Path(log_dir) if log_dir else None
        self.role = role
        self.min_isr = int(min_isr)
        # High watermark per (topic, partition): consumers only ever read
        # up to it. It advances when a produce reaches min_isr in-sync
        # copies, so a record whose replication FAILED sits on the local
        # log above the watermark — never exposed to a consumer before its
        # durability ack (Kafka's HW semantics; closes the read-uncommitted
        # window where a consumer could act on a record whose producer was
        # told it was NOT written). A partition with no entry is fully
        # visible. Because the WAL is written BEFORE replication, a pinned
        # watermark (hw < log end) is also persisted to ``hw.json`` —
        # without that, a restart would replay the fsync'd-but-unacked
        # tail as visible. Only the pin set is persisted (rare,
        # failure-path writes; the steady state costs no I/O).
        self._hw: Dict[tuple, int] = {}
        self._persisted_pins: Dict[str, int] = {}
        self._replicas: List[_ReplicaLink] = []
        self._conns: set = set()          # live handler sockets (for stop())
        self._seg_files: Dict[tuple, Any] = {}
        self._io_lock = threading.Lock()
        if self.log_dir is not None:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            self._replay()
        self._tcp = _TCPServer((host, port), _Handler)
        self._tcp.outer = self  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._tcp.serve_forever, name="broker-server", daemon=True)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "BrokerServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._tcp.shutdown()
        self._tcp.server_close()
        # drop live connections so peers (clients, a primary's replica
        # link) observe the death immediately — a stopped server must not
        # keep acking replication traffic from a lingering handler thread
        for sock in list(self._conns):
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        with self._io_lock:
            for link in self._replicas:
                link.close()
            self._replicas.clear()
            for f in self._seg_files.values():
                try:
                    f.close()
                except OSError:
                    pass
            self._seg_files.clear()

    @property
    def port(self) -> int:
        return self._tcp.server_address[1]

    # ----------------------------------------------------------- durability
    def _segment(self, topic: str, partition: int):
        key = (topic, partition)
        f = self._seg_files.get(key)
        if f is None:
            path = self.log_dir / f"{topic}-{partition}.jsonl"
            f = open(path, "a", encoding="utf-8")
            self._seg_files[key] = f
        return f

    def _produce(self, topic: str, items: List[tuple],
                 generation: Optional[int] = None) -> List[Record]:
        """Produce with WAL-first durability + synchronous replication:
        partition is chosen, the WAL line is written + fsync'd, the record
        is published to the in-memory log, and it is shipped to every
        in-sync replica — the ack happens only once ``min_isr`` copies
        (self included) hold it. A WAL write failure errors the produce
        *before* any consumer could see the record; ``_io_lock`` serializes
        produces so WAL line order always matches log offset order per
        partition AND replicas receive offsets contiguously.
        ``items``: [(key, value, timestamp|None)].

        A stamped ``generation`` is fence-checked for EVERY target
        partition BEFORE the WAL write — a refused frame is all-or-
        nothing (no partial batch, no invisible above-watermark residue),
        so a zombie writer's whole fan-out bounces with
        ``StaleGenerationError`` and nothing it wrote can surface later.
        """
        b = self.broker
        with self._io_lock:
            planned = [
                (b.select_partition(topic, k), k, v,
                 # rtfd-lint: allow[wall-clock] record-timestamp default; callers pass ts
                 ts if ts is not None else time.time())
                for k, v, ts in items
            ]
            if generation is not None:
                for part in sorted({p for p, _k, _v, _ts in planned}):
                    b.check_producer_generation(topic, part, generation)
            if self.log_dir is not None:
                touched = set()
                for part, k, v, ts in planned:
                    f = self._segment(topic, part)
                    f.write(json.dumps({"k": k, "v": v, "ts": ts},
                                       separators=(",", ":")) + "\n")
                    touched.add(f)
                for f in touched:
                    f.flush()
                    os.fsync(f.fileno())
            # the watermark shipped WITH the records is the pre-produce
            # visible end: these records are not acked yet, so a replica
            # applying them must not expose them to its readers. The same
            # watermark is PRE-PINNED locally BEFORE the append: fetch/lag
            # handlers run on other threads without _io_lock, and a
            # partition with no _hw entry defaults to the physical log end
            # — without the pre-pin, a fetch racing the replication round
            # trip would serve the not-yet-acked record.
            pre_hw = {p: self._visible_end(topic, p)
                      for p in range(len(b._logs(topic)))}
            for p, hw in pre_hw.items():
                self._hw[(topic, p)] = hw
            recs = [b.append(topic, part, v, k, ts)
                    for part, k, v, ts in planned]
            try:
                self._replicate(topic, recs, pre_hw)
            except Exception:
                # NOT acked: the pre-pinned watermark stays — consumers
                # never see the unreplicated tail (it stays on the local
                # log; a successful later replication round — e.g.
                # add_replica's backlog sync — re-advances past it). The
                # pin is persisted so a RESTART cannot re-expose the
                # WAL-replayed tail either.
                self._sync_hw_pins()
                raise
            for p, log in enumerate(b._logs(topic)):
                self._hw[(topic, p)] = len(log.records)
            self._sync_hw_pins()
            # acked: let replicas expose the records too (their visible end
            # follows the primary's watermark, never their raw log end)
            self._sync_replica_hw(topic)
            return recs

    def _sync_replica_hw(self, topic: str) -> None:
        """Push the primary's committed watermark to replicas after an ack.
        A replica that misses the sync just serves a slightly stale (more
        conservative) view until the next one — never the unsafe
        direction — so errors here do not shrink the ISR. Caller holds
        ``_io_lock``. COST: one extra frame per replica per acked produce,
        chosen deliberately — Kafka piggybacks the HW on the next data
        frame and lets follower reads lag one produce; this broker's
        replicas promise read-your-ack freshness (tests pin it), and the
        produce path is already synchronous per replica, so the extra
        frame is a constant factor, not a new round-trip class."""
        if not self._replicas:
            return
        hws = {str(p): self._visible_end(topic, p)
               for p in range(len(self.broker._logs(topic)))}
        for link in self._replicas:
            try:
                link.call({"op": "hw_sync", "topic": topic, "hws": hws})
            except Exception:  # noqa: BLE001 — stale-but-safe on failure
                pass

    def _sync_hw_pins(self) -> None:
        """Persist the PIN SET — partitions whose watermark sits below the
        log end (an unacked, replication-failed tail). Written only when
        the set changes (pins appear on the failure path and clear on
        re-sync), so the acked steady state never touches this file.
        Residual window: a crash between a produce's WAL fsync and this
        pin write re-exposes that produce's tail on restart — the same
        at-least-once compromise as Kafka's periodically-checkpointed HW.
        Caller holds ``_io_lock``."""
        if self.log_dir is None:
            return
        pins = {
            f"{t}\x00{p}": hw
            for (t, p), hw in self._hw.items()
            if p < len(self.broker._logs(t))
            and hw < len(self.broker._logs(t)[p].records)
        }
        if pins == self._persisted_pins:
            return
        tmp = self.log_dir / "hw.json.tmp"
        tmp.write_text(json.dumps(pins))
        tmp.replace(self.log_dir / "hw.json")
        self._persisted_pins = pins

    def _visible_end(self, topic: str, part: int) -> int:
        """Consumer-visible end offset: the high watermark when one is
        tracked, else the physical log end."""
        logs = self.broker._logs(topic)
        end = len(logs[part].records) if part < len(logs) else 0
        return min(end, self._hw.get((topic, part), end))

    # ---------------------------------------------------------- replication
    def _replicate(self, topic: str, recs: List[Record],
                   ship_hw: Optional[Dict[int, int]] = None) -> None:
        """Ship freshly appended records to every replica, synchronously.
        Caller holds ``_io_lock``. A replica that errors is dropped from
        the ISR; if fewer than ``min_isr`` copies hold the records, the
        produce fails (the records stay on the local log unacked — a
        producer retry may duplicate them: at-least-once)."""
        acks = 1  # self: WAL already fsync'd (or in-memory by configuration)
        if self._replicas:
            parts: Dict[int, List[Dict[str, Any]]] = {}
            for r in recs:
                parts.setdefault(r.partition, []).append(
                    {"k": r.key, "v": r.value, "ts": r.timestamp,
                     "o": r.offset})
            req = {
                "op": "replicate", "topic": topic,
                # partition COUNT rides along: an auto-created topic must
                # have the same layout on the replica even for partitions
                # that never received a record, or key routing diverges
                # after a promote
                "n_parts": len(self.broker._logs(topic)),
                # the primary's CURRENT watermark rides along too: the
                # replica's visible end follows the primary's (a record
                # being shipped is not yet acked — the replica must not
                # serve reads past what the primary has committed)
                "parts": [{"p": p, "base": rows[0]["o"], "records": rows,
                           "hw": (ship_hw.get(p, 0) if ship_hw is not None
                                  else self._visible_end(topic, p))}
                          for p, rows in parts.items()],
            }
            alive = []
            for link in self._replicas:
                try:
                    link.call(req)
                    acks += 1
                    alive.append(link)
                except Exception:  # noqa: BLE001 — ISR shrink on any failure
                    link.close()
            self._replicas[:] = alive
        if acks < self.min_isr:
            raise NotEnoughReplicasError(
                f"produce reached {acks} in-sync copies < min_isr "
                f"{self.min_isr}; record NOT acked")

    def add_replica(self, host: str, port: int,
                    chunk: int = 500) -> None:
        """Attach a replica server: sync topic layout, push the record
        backlog and group offsets, then admit it to the ISR — every later
        produce ships to it before the producer's ack."""
        link = _ReplicaLink(host, port)
        with self._io_lock:
            b = self.broker
            for t in list(b._topics):
                logs = b._logs(t)
                link.call({"op": "sync_topic", "name": t,
                           "partitions": len(logs)})
                rends = link.call({"op": "end_offsets", "topic": t})["ends"]
                for p, log in enumerate(logs):
                    start = rends[p] if p < len(rends) else 0
                    while start < len(log.records):
                        rows = [
                            {"k": r.key, "v": r.value, "ts": r.timestamp,
                             "o": r.offset}
                            for r in log.records[start:start + chunk]
                        ]
                        link.call({"op": "replicate", "topic": t,
                                   "parts": [{"p": p, "base": rows[0]["o"],
                                              "records": rows,
                                              "hw": self._visible_end(
                                                  t, p)}]})
                        start += len(rows)
            link.call({"op": "offsets_sync", "committed": {
                f"{g}\x00{t}\x00{p}": off
                for (g, t, p), off in b._committed.items()
            }})
            self._replicas.append(link)
            if 1 + len(self._replicas) >= self.min_isr:
                # the full backlog (any previously unacked tail included)
                # now holds on min_isr copies: expose it, replicas included
                for t in list(b._topics):
                    for p, log in enumerate(b._logs(t)):
                        self._hw[(t, p)] = len(log.records)
                self._sync_hw_pins()
                for t in list(b._topics):
                    self._sync_replica_hw(t)

    def _apply_replicated(self, topic: str, part: int, base: int,
                          rows: List[Mapping[str, Any]],
                          primary_hw: Optional[int] = None) -> None:
        """Replica side: append shipped records at their primary offsets,
        WAL-first when durable. Idempotent for already-held offsets; a gap
        (shipped offset beyond local end) is refused loudly — the primary
        re-syncs via add_replica rather than silently diverging."""
        b = self.broker
        logs = b._logs(topic)
        if part >= len(logs):
            with b._lock:
                while len(logs) < part + 1:
                    logs.append(type(logs[0])())
        log = logs[part]
        with self._io_lock:
            local_end = len(log.records)
            fresh = [(base + j, d) for j, d in enumerate(rows)
                     if base + j >= local_end]
            if fresh and fresh[0][0] > local_end:
                raise RuntimeError(
                    f"replication gap on {topic}-{part}: local end "
                    f"{local_end}, shipped base {fresh[0][0]}")
            if self.log_dir is not None and fresh:
                f = self._segment(topic, part)
                for _, d in fresh:
                    f.write(json.dumps(
                        {"k": d.get("k"), "v": d.get("v"),
                         "ts": d.get("ts", 0.0)},
                        separators=(",", ":")) + "\n")
                f.flush()
                os.fsync(f.fileno())
            for _, d in fresh:
                b.append(topic, part, d.get("v"), d.get("k"),
                         d.get("ts", 0.0))
            # visibility follows the PRIMARY's watermark, not the local
            # log end: the shipped records are not yet acked (the primary
            # is still collecting min_isr acks when this runs), so a read
            # from this warm standby must not run ahead of what the
            # primary serves. Legacy replicate frames without "hw" keep
            # the old expose-on-apply behavior.
            self._hw[(topic, part)] = (
                min(int(primary_hw), len(log.records))
                if primary_hw is not None else len(log.records))
            # deliberately NOT persisted here: on the acked path this pin
            # is transient (the post-ack hw_sync clears it milliseconds
            # later), and persisting would cost two hw.json writes per
            # produce on a durable replica's synchronous path. The cost: a
            # replica crashing inside that window replays the applied-but-
            # not-yet-acked records as visible — the same bounded
            # WAL-vs-pin compromise the primary documents.

    def _forward_commit(self, group: str, wire: Mapping[str, Any]) -> None:
        """Ship an offset commit to replicas so a promoted replica resumes
        every group where the primary acked it. A failing replica drops
        from the ISR (same policy as record shipping)."""
        with self._io_lock:
            if not self._replicas:
                return
            alive = []
            for link in self._replicas:
                try:
                    link.call({"op": "commit_sync", "group": group,
                               "offsets": dict(wire)})
                    alive.append(link)
                except Exception:  # noqa: BLE001
                    link.close()
            self._replicas[:] = alive

    def _grow_topic(self, name: str, partitions: int) -> None:
        """Ensure ``name`` exists with AT LEAST ``partitions`` partitions
        (replica-side layout sync; partition counts only ever grow)."""
        b = self.broker
        b.create_topic(name, partitions)
        logs = b._logs(name)
        if len(logs) < partitions:
            with b._lock:
                while len(logs) < partitions:
                    logs.append(type(logs[0])())

    def promote(self) -> None:
        """Replica -> primary: start accepting writes. The log, offsets and
        WAL carry over as-is (they were kept in sync by the shipping lane).

        Promotion commits the local log tail: the new primary's log IS the
        partition's truth, so the watermark advances to the log end — the
        same retroactive commit a Kafka leader election performs. A record
        whose producer was told "not written" (its ack round died with the
        old primary) may therefore surface after failover; producer
        retries then duplicate it, which is the documented at-least-once
        contract (consumers dedupe by transaction id).
        """
        with self._io_lock:
            for t in list(self.broker._topics):
                for p, log in enumerate(self.broker._logs(t)):
                    self._hw[(t, p)] = len(log.records)
            self._sync_hw_pins()
        self.role = "primary"

    def isr_size(self) -> int:
        with self._io_lock:
            return 1 + len(self._replicas)

    def _persist_offsets(self) -> None:
        if self.log_dir is None:
            return
        with self._io_lock:
            snap = {
                f"{g}\x00{t}\x00{p}": off
                for (g, t, p), off in self.broker._committed.items()
            }
            tmp = self.log_dir / "offsets.json.tmp"
            tmp.write_text(json.dumps(snap))
            tmp.replace(self.log_dir / "offsets.json")

    def _replay(self) -> None:
        for path in sorted(self.log_dir.glob("*-*.jsonl")):
            topic, _, part_s = path.stem.rpartition("-")
            try:
                part = int(part_s)
            except ValueError:
                continue
            logs = self.broker._logs(topic)
            if part >= len(logs):
                self.broker._topics[topic].extend(
                    type(logs[0])() for _ in range(part + 1 - len(logs)))
            log = self.broker._logs(topic)[part]
            with open(path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    d = json.loads(line)
                    log.records.append(Record(
                        topic, part, len(log.records), d.get("k"),
                        d.get("v"), d.get("ts", 0.0)))
        off_path = self.log_dir / "offsets.json"
        if off_path.exists():
            for key, off in json.loads(off_path.read_text()).items():
                g, t, p = key.split("\x00")
                self.broker._committed[(g, t, int(p))] = int(off)
        hw_path = self.log_dir / "hw.json"
        if hw_path.exists():
            # re-pin watermarks for partitions whose WAL tail was never
            # acked: the replayed records stay invisible until a replica
            # re-sync makes them min_isr-replicated
            self._persisted_pins = json.loads(hw_path.read_text())
            for key, hw in self._persisted_pins.items():
                t, p = key.split("\x00")
                self._hw[(t, int(p))] = int(hw)

    # ------------------------------------------------------------- dispatch
    _WRITE_OPS = frozenset({"produce", "produce_batch", "commit",
                            "create_topic"})

    def dispatch(self, req: Mapping[str, Any]) -> Dict[str, Any]:
        op = req.get("op")
        b = self.broker
        if self.role == "replica" and op in self._WRITE_OPS:
            # reads stay served (a replica is a warm standby + read scale-
            # out); writes go to the primary or wait for promote()
            return {"error": "READONLY: replica accepts reads and "
                             "replication traffic only; promote() to "
                             "accept writes"}
        if op == "replicate":
            n_parts = req.get("n_parts")
            if n_parts:
                self._grow_topic(req["topic"], int(n_parts))
            for blob in req["parts"]:
                hw = blob.get("hw")
                self._apply_replicated(req["topic"], int(blob["p"]),
                                       int(blob["base"]), blob["records"],
                                       primary_hw=(int(hw) if hw is not None
                                                   else None))
            return {}
        if op == "hw_sync":
            # post-ack watermark push: expose records the primary just
            # committed (clamped to the local log — never past what this
            # replica actually holds)
            topic = req["topic"]
            logs = self.broker._logs(topic)
            with self._io_lock:
                for p_s, hw in req["hws"].items():
                    p = int(p_s)
                    if p < len(logs):
                        self._hw[(topic, p)] = min(
                            int(hw), len(logs[p].records))
                self._sync_hw_pins()
            return {}
        if op == "sync_topic":
            self._grow_topic(req["name"], int(req["partitions"]))
            return {}
        if op == "commit_sync":
            offsets = {}
            for key, off in req["offsets"].items():
                t, _, p = key.rpartition(":")
                offsets[(t, int(p))] = int(off)
            b.commit(req["group"], offsets)
            self._persist_offsets()
            return {}
        if op == "offsets_sync":
            for key, off in req["committed"].items():
                g, t, p = key.split("\x00")
                b._committed[(g, t, int(p))] = int(off)
            self._persist_offsets()
            return {}
        if op == "promote":
            self.promote()
            return {"role": self.role}
        if op == "status":
            return {"role": self.role, "min_isr": self.min_isr,
                    "isr": self.isr_size(),
                    **self.broker.producer_fence_stats()}
        if op == "fence_producers":
            # the coordinator's rebalance fence step: stamped writes to
            # these partitions below `generation` are refused from now
            # on. Forwarded to replicas like offset commits, so a
            # promoted replica keeps fencing the same zombies.
            self.broker.fence_producers(req["topic"], req["partitions"],
                                        int(req["generation"]))
            with self._io_lock:
                alive = []
                for link in self._replicas:
                    try:
                        link.call({"op": "fence_producers",
                                   "topic": req["topic"],
                                   "partitions": req["partitions"],
                                   "generation": int(req["generation"])})
                        alive.append(link)
                    except Exception:  # noqa: BLE001 — ISR shrink policy
                        link.close()
                self._replicas[:] = alive
            return {}
        if op == "produce":
            gen = req.get("gen")
            rec = self._produce(req["topic"], [(
                req.get("key"), req["value"], req.get("timestamp"))],
                generation=int(gen) if gen is not None else None)[0]
            return {"partition": rec.partition, "offset": rec.offset}
        if op == "produce_batch":
            # optional per-record "ts": producers may stamp arrival times
            # so consumer-side budget/latency math shares one time base
            gen = req.get("gen")
            recs = self._produce(req["topic"], [
                (item.get("k"), item["v"], item.get("ts"))
                for item in req["records"]],
                generation=int(gen) if gen is not None else None)
            return {"n": len(recs)}
        if op == "fetch":
            # reads stop at the high watermark: a record above it exists on
            # the log but its produce was never acked (min_isr not reached)
            end = self._visible_end(req["topic"], req["partition"])
            limit = min(int(req["max_records"]),
                        max(0, end - int(req["offset"])))
            recs = b.read(req["topic"], req["partition"], req["offset"],
                          limit) if limit > 0 else []
            return {"records": [
                {"p": r.partition, "o": r.offset, "k": r.key, "v": r.value,
                 "ts": r.timestamp} for r in recs]}
        if op == "commit":
            offsets = {}
            for key, off in req["offsets"].items():
                t, _, p = key.rpartition(":")
                offsets[(t, int(p))] = int(off)
            gen = req.get("gen")
            b.commit(req["group"], offsets,
                     generation=int(gen) if gen is not None else None)
            self._persist_offsets()
            self._forward_commit(req["group"], req["offsets"])
            return {}
        if op == "committed":
            return {"offset": b.committed(req["group"], req["topic"],
                                          req["partition"])}
        if op == "partitions":
            return {"n": b.partitions(req["topic"])}
        if op == "end_offsets":
            # replication internals (add_replica's catch-up) need PHYSICAL
            # ends; consumer-facing visibility is enforced at fetch/lag
            return {"ends": b.end_offsets(req["topic"])}
        if op == "lag":
            # lag against the VISIBLE ends, matching what fetch can serve —
            # otherwise a drain loop would spin forever on an unacked tail
            topic, group = req["topic"], req["group"]
            total = 0
            for p in range(len(b._logs(topic))):
                total += max(0, self._visible_end(topic, p)
                             - b.committed(group, topic, p))
            return {"lag": total}
        if op == "create_topic":
            b.create_topic(req["name"], req["partitions"])
            # layout changes ship to replicas like records do: a topic
            # created after add_replica must exist with the same partition
            # count on the survivor, or key routing diverges post-promote
            with self._io_lock:
                alive = []
                for link in self._replicas:
                    try:
                        link.call({"op": "sync_topic", "name": req["name"],
                                   "partitions": req["partitions"]})
                        alive.append(link)
                    except Exception:  # noqa: BLE001
                        link.close()
                self._replicas[:] = alive
            return {}
        if op == "ping":
            return {"pong": True}
        raise ValueError(f"unknown op {op!r}")


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class NetBrokerClient:
    """Broker-interface client over one pipelined TCP connection.

    Implements the five methods ``transport.Consumer`` needs (committed /
    partitions / read / commit / lag) plus the producer surface, so every
    component that takes an ``InMemoryBroker`` takes one of these.

    Reconnect semantics (broker RESTART survival): on a dead connection
    the client retries up to ``reconnect_attempts`` times with bounded
    exponential backoff + deterministic jitter, reconnecting to the same
    address — a broker that restarts from its WAL resumes serving the
    same log. A retried *produce* across the gap may duplicate (the ack
    may have been lost in flight — standard at-least-once; consumers
    dedupe by transaction id). Every reconnect bumps the client's
    ``reconnect_epoch``: each ``transport.Consumer`` sharing this client
    observes the change independently and re-fetches from the last
    COMMITTED offset instead of its in-memory cursor — records
    polled-but-uncommitted at the moment of the outage are re-delivered
    rather than silently skipped past by a later commit (the
    crash-recovery contract).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 9092,
                 timeout_s: float = 30.0, reconnect_attempts: int = 5,
                 retry_sleep=None, link=None):
        from realtime_fraud_detection_tpu_torch.utils.backoff import (
            DeterministicBackoff,
            instance_seed,
        )

        self._addr = (host, int(port))
        self._timeout_s = timeout_s
        self._sock = socket.create_connection((host, port), timeout=timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()
        self._part_cache: Dict[str, int] = {}
        self._reconnect_attempts = max(0, int(reconnect_attempts))
        # optional in-path link (fault injection): consulted before every
        # send and after every recv — latency / throttle sleeps, partition
        # or drop connection errors. None in production.
        self._link = link
        # optional producer assignment generation: when set, every
        # produce/commit frame is stamped with it and the broker refuses
        # the write if the target partition was fenced at a newer
        # generation (StaleGenerationError — the zombie-writer fence).
        self.generation: Optional[int] = None
        # monotonically increasing reconnect epoch: EVERY consumer sharing
        # this client compares its last-seen epoch and rewinds to committed
        # offsets when it observes a newer one (a read-and-clear flag would
        # rewind only the first consumer to poll — the others would keep a
        # stale cursor past re-delivered records)
        self._reconnect_epoch = 0
        # per-instance seed: all clients of one broker port are exactly
        # the herd whose reconnect storms must de-correlate
        self._backoff = DeterministicBackoff(
            base_s=0.05, mult=2.0, max_s=0.8,
            seed=instance_seed(str(port)), sleep=retry_sleep)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def _reconnect_locked(self) -> None:
        """Drop the dead socket and dial the same address. Caller holds
        ``_lock``. Raises OSError while the broker is still down."""
        try:
            self._sock.close()
        except OSError:
            pass
        self._sock = socket.create_connection(self._addr,
                                              timeout=self._timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._reconnect_epoch += 1

    def reconnect_epoch(self) -> int:
        """Monotonic count of reconnects this client has survived.
        ``transport.Consumer`` compares against its own last-seen value
        and rewinds to committed offsets on any change — epoch-based so
        EVERY consumer sharing this client observes every reconnect (a
        read-and-clear flag would rewind only the first to poll)."""
        with self._lock:
            return self._reconnect_epoch

    def _call(self, req: Dict[str, Any]) -> Dict[str, Any]:
        resp = None
        last: Optional[Exception] = None
        for attempt in range(self._reconnect_attempts + 1):
            resp = None
            try:
                with self._lock:
                    if self._link is not None:
                        # frame size rides along so slow-link throttling
                        # can pace by bytes (the double serialization is
                        # paid only while a link is attached)
                        self._link.before_send(
                            req, len(json.dumps(
                                req, separators=(",", ":")).encode()))
                    _send_frame(self._sock, req)
                    # absolute per-op deadline: a hung-not-dead broker
                    # (SIGSTOP, stalled VM) trickling bytes cannot reset
                    # the budget — the whole frame read is bounded
                    # rtfd-lint: allow[wall-clock] socket I/O deadline is genuinely wall-bound
                    deadline = time.monotonic() + self._timeout_s
                    try:
                        resp = _recv_frame(self._sock, deadline=deadline)
                    finally:
                        # the deadline path shrinks the socket timeout to
                        # the residual budget; restore the full op
                        # timeout so the NEXT call's sendall never runs
                        # under a near-zero leftover
                        try:
                            self._sock.settimeout(self._timeout_s)
                        except OSError:
                            pass
                if resp is None:
                    raise ConnectionError("broker closed the connection")
                if self._link is not None:
                    # one-way partition: the op was APPLIED broker-side
                    # but the ack is lost — surfaces as a connection
                    # error, so a retried produce may duplicate
                    # (at-least-once; consumers dedupe by txn id)
                    self._link.after_recv(req)
                break
            except (ConnectionError, OSError) as e:
                last = e
                if attempt >= self._reconnect_attempts:
                    raise
                self._backoff.sleep(attempt)
                try:
                    with self._lock:
                        self._reconnect_locked()
                except OSError as e2:
                    last = e2          # still down: next attempt backs off
        if resp is None:
            raise ConnectionError(f"broker unreachable: {last}")
        if "error" in resp:
            msg = str(resp["error"])
            if msg.startswith("StaleGenerationError"):
                raise StaleGenerationError(f"broker refused: {msg}")
            raise RuntimeError(f"broker error: {msg}")
        return resp

    def _stamp_gen(self, req: Dict[str, Any]) -> Dict[str, Any]:
        if self.generation is not None:
            req["gen"] = int(self.generation)
        return req

    # ------------------------------------------------------------- produce
    def produce(self, topic: str, value: Any, key: Optional[str] = None,
                timestamp: Optional[float] = None) -> Record:
        r = self._call(self._stamp_gen(
            {"op": "produce", "topic": topic, "value": value,
             "key": key, "timestamp": timestamp}))
        return Record(topic, r["partition"], r["offset"], key, value,
                      timestamp or 0.0)

    def produce_batch(self, topic: str, values, key_fn=None) -> int:
        items = [{"v": v, "k": key_fn(v) if key_fn else None} for v in values]
        if not items:
            return 0
        return self._call(self._stamp_gen(
            {"op": "produce_batch", "topic": topic,
             "records": items}))["n"]

    def produce_batch_keyed(self, topic: str, items) -> int:
        """(key, value) pairs in ONE frame — the fan-out hot path
        (one TCP round trip instead of one per record)."""
        records = [{"v": v, "k": k} for k, v in items]
        if not records:
            return 0
        return self._call(self._stamp_gen(
            {"op": "produce_batch", "topic": topic,
             "records": records}))["n"]

    def produce_batch_stamped(self, topic: str, items) -> int:
        """(key, value, timestamp) triples in ONE frame — the replay
        producer path: explicit record timestamps (virtual-clock arrivals)
        at produce_batch_keyed's wire efficiency."""
        records = [{"v": v, "k": k, "ts": ts} for k, v, ts in items]
        if not records:
            return 0
        return self._call(self._stamp_gen(
            {"op": "produce_batch", "topic": topic,
             "records": records}))["n"]

    def fence_producers(self, topic: str, partitions, generation: int,
                        ) -> None:
        """Coordinator op: refuse stamped writes below ``generation`` for
        these partitions (the rebalance fence step's write-seam half)."""
        self._call({"op": "fence_producers", "topic": topic,
                    "partitions": [int(p) for p in partitions],
                    "generation": int(generation)})

    # ------------------------------------------------------------- consume
    def consumer(self, topics: Sequence[str], group_id: str,
                 faults: Optional[FaultInjector] = None,
                 partitions: Optional[Mapping[str, Sequence[int]]] = None,
                 ) -> Consumer:
        """``partitions`` scopes the consumer to an explicit topic →
        partition-list assignment — same contract as ``InMemoryBroker.consumer``,
        so a partition-scoped worker runs unchanged over TCP."""
        return Consumer(self, list(topics), group_id, faults,
                        partitions=partitions)

    def read(self, topic: str, partition: int, start: int,
             limit: int) -> List[Record]:
        resp = self._call({"op": "fetch", "topic": topic,
                           "partition": partition, "offset": start,
                           "max_records": limit})
        return [
            Record(topic, d["p"], d["o"], d.get("k"), d.get("v"),
                   d.get("ts", 0.0))
            for d in resp["records"]
        ]

    # ------------------------------------------------------------- offsets
    def committed(self, group: str, topic: str, partition: int) -> int:
        return self._call({"op": "committed", "group": group, "topic": topic,
                           "partition": partition})["offset"]

    def commit(self, group: str, offsets: Mapping[tuple, int]) -> None:
        wire = {f"{t}:{p}": off for (t, p), off in offsets.items()}
        self._call(self._stamp_gen(
            {"op": "commit", "group": group, "offsets": wire}))

    def partitions(self, topic: str) -> int:
        n = self._part_cache.get(topic)
        if n is None:
            n = self._call({"op": "partitions", "topic": topic})["n"]
            self._part_cache[topic] = n
        return n

    def end_offsets(self, topic: str) -> List[int]:
        return self._call({"op": "end_offsets", "topic": topic})["ends"]

    def lag(self, group: str, topic: str) -> int:
        return self._call({"op": "lag", "group": group, "topic": topic})["lag"]

    def create_topic(self, name: str, partitions: int) -> None:
        self._part_cache.pop(name, None)
        self._call({"op": "create_topic", "name": name,
                    "partitions": partitions})

    def ping(self) -> bool:
        return bool(self._call({"op": "ping"}).get("pong"))

    def status(self) -> Dict[str, Any]:
        return self._call({"op": "status"})

    def promote(self) -> Dict[str, Any]:
        """Remote promote (the ops-script path for a failover)."""
        return self._call({"op": "promote"})


class HaBrokerClient(NetBrokerClient):
    """Failover-aware client over an ordered broker list.

    On connection loss or a READONLY response (we were talking to a
    not-yet-promoted replica) the client rotates to the next address,
    reconnects, and retries the request. NOTE the produce-retry semantics:
    a produce whose ack was lost mid-failover may already be on the log,
    so a retry can duplicate it — at-least-once, exactly like a Kafka
    acks=all producer retrying across a leader change. Stream consumers
    dedupe by transaction id (stream/job.py dispatch_batch).
    """

    def __init__(self, addrs: Sequence[tuple], timeout_s: float = 30.0):
        if not addrs:
            raise ValueError("HaBrokerClient needs at least one address")
        self._addrs = [(str(h), int(p)) for h, p in addrs]
        self._which = 0
        self._timeout_s = timeout_s
        # construction must survive a dead first broker (a process started
        # AFTER the failover still lists the old primary first): try each
        # address in order
        last: Optional[Exception] = None
        for i, (host, port) in enumerate(self._addrs):
            try:
                # failover is THIS class's rotation, not same-address
                # reconnection — the base client's reconnect loop stays off
                super().__init__(host=host, port=port, timeout_s=timeout_s,
                                 reconnect_attempts=0)
                self._which = i
                return
            except OSError as e:
                last = e
        raise ConnectionError(
            f"no broker in {self._addrs} reachable: {last}")

    def _rotate(self) -> None:
        self._which = (self._which + 1) % len(self._addrs)
        host, port = self._addrs[self._which]
        with self._lock:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = socket.create_connection(
                (host, port), timeout=self._timeout_s)
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def _call(self, req: Dict[str, Any]) -> Dict[str, Any]:
        last: Optional[Exception] = None
        for attempt in range(2 * len(self._addrs)):
            try:
                return super()._call(req)
            except RuntimeError as e:
                if "READONLY" not in str(e):
                    raise
                last = e
            except (ConnectionError, OSError) as e:
                last = e
            try:
                self._rotate()
                # a successful rotation is a reconnect: sharing consumers
                # must rewind to committed offsets (transport.Consumer)
                with self._lock:
                    self._reconnect_epoch += 1
            except OSError as e:
                last = e
                self._backoff.sleep(attempt)
        raise ConnectionError(
            f"no broker in {self._addrs} reachable and writable: {last}")
