"""Network-served handoff: checkpoint blobs that survive any worker's death.

Port of the JAX package's ``cluster/handoff.py``. ``cluster/fleet.py
HandoffStore`` is a locked dict shared by threads; its blob (the pickled
``PartitionState.snapshot_bytes`` keyed to a committed offset) is already
what a networked store would hold, and this module makes it one. The
process fleet's workers are OS processes (cluster/procfleet.py), so a
worker's SIGKILL must not take its partitions' recovery state with it:

- :class:`HandoffServer` — a TCP server (the netbroker's length-prefixed
  JSON framing) owning the snapshot ledger, durable on disk with
  **crash-safe atomic commit**: every blob is written to a temp file,
  fsync'd, then renamed into place, and the previous checkpoint file is
  RETAINED until the new one is committed. A restore verifies the blob
  against its recorded sha256 — a torn/truncated file (server crash
  mid-write, disk corruption) is detected and the PREVIOUS checkpoint is
  served instead, with the committed-gap replay covering the difference
  (the gap is just larger). Torn blobs are counted, never silently used.
- **offset-epoch fencing**: the fleet coordinator fences a partition at a
  new epoch on every rebalance; a checkpoint ``put`` carrying a stale
  epoch — a zombie worker that lost the partition but kept running — is
  refused loudly (``FENCED``), so a slow old owner can never overwrite an
  inheritor's newer state (the classic split-brain writer, closed the same
  way Kafka fences zombie producers).
- :class:`HandoffClient` — the worker-side client, implementing the exact
  ``put``/``get`` surface ``cluster.fleet.ClusterWorker`` consumes, with
  bounded ``DeterministicBackoff`` reconnect: a handoff-server restart
  mid-restore is retried against the same address, not surfaced as a
  worker crash.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import socket
import socketserver
import threading
import time
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

from realtime_fraud_detection_tpu_torch.stream.netbroker import (
    _recv_frame,
    _send_frame,
)

__all__ = ["HandoffServer", "HandoffClient", "FencedEpochError"]


class FencedEpochError(RuntimeError):
    """A checkpoint put carried an epoch older than the partition's fence —
    the writer lost ownership in a rebalance it has not observed yet (a
    zombie). The put is refused; the zombie must re-read its assignment."""


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:  # one connection, many requests
        server: HandoffServer = self.server.outer  # type: ignore[attr-defined]
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        server._conns.add(sock)
        try:
            while True:
                try:
                    req = _recv_frame(sock)
                except (ConnectionError, ValueError, OSError):
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


class HandoffServer:
    """Serve the partition-snapshot ledger over TCP, durably.

    Disk layout (``blob_dir``): one committed file per checkpoint,
    ``p{partition}-{offset}-{epoch}.blob``, whose first 65 bytes are the
    hex sha256 of the payload plus a newline. Writes go temp→fsync→rename
    (atomic on POSIX), and the previous committed file for the partition
    is kept until the NEXT checkpoint lands — so at any crash instant a
    partition has at least one fully-committed, checksum-verifiable blob
    on disk. ``blob_dir=None`` keeps everything in memory (unit tests).
    """

    KEEP_PER_PARTITION = 2      # current + previous (torn-blob fallback)

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 blob_dir: Optional[str] = None):
        self.blob_dir = Path(blob_dir) if blob_dir else None
        self._lock = threading.Lock()
        # partition -> newest-first [(offset, epoch, sha, blob|None, path)]
        self._ledger: Dict[int, list] = {}
        self._fence: Dict[int, int] = {}
        self._conns: set = set()
        self.checkpoints_total = 0
        self.restores_total = 0
        self.torn_blobs_total = 0
        self.fenced_rejects_total = 0
        if self.blob_dir is not None:
            self.blob_dir.mkdir(parents=True, exist_ok=True)
            self._scan()
        self._tcp = _TCPServer((host, port), _Handler)
        self._tcp.outer = self  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._tcp.serve_forever, name="handoff-server",
            daemon=True)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "HandoffServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._tcp.shutdown()
        self._tcp.server_close()
        for sock in list(self._conns):
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    @property
    def port(self) -> int:
        return self._tcp.server_address[1]

    # ------------------------------------------------------------ durability
    def _scan(self) -> None:
        """Rebuild the ledger from committed files (server restart). Files
        are trusted only as far as their embedded checksum — verification
        happens at restore time, so a torn file found here still falls
        back to its predecessor."""
        for path in self.blob_dir.glob("p*-*-*.blob"):
            try:
                p_s, off_s, ep_s = path.stem[1:].split("-")
                p, off, ep = int(p_s), int(off_s), int(ep_s)
            except ValueError:
                continue
            self._ledger.setdefault(p, []).append((off, ep, None, None, path))
        for entries in self._ledger.values():
            # newest first: highest (epoch, offset) wins
            entries.sort(key=lambda e: (e[1], e[0]), reverse=True)

    def _commit_blob(self, p: int, offset: int, epoch: int,
                     sha: str, blob: bytes) -> Optional[Path]:
        if self.blob_dir is None:
            return None
        path = self.blob_dir / f"p{p}-{offset}-{epoch}.blob"
        tmp = self.blob_dir / f".p{p}-{offset}-{epoch}.tmp"
        with open(tmp, "wb") as f:
            f.write(sha.encode() + b"\n" + blob)
            f.flush()
            os.fsync(f.fileno())
        tmp.replace(path)          # atomic: a reader sees old file or new
        return path

    @staticmethod
    def _read_blob(entry: tuple) -> Optional[Tuple[str, bytes]]:
        """(sha, payload) from a ledger entry, or None when the committed
        file is torn (checksum mismatch / truncation)."""
        off, ep, sha, blob, path = entry
        if blob is not None:
            return sha, blob
        try:
            raw = path.read_bytes()
        except OSError:
            return None
        head, _, payload = raw.partition(b"\n")
        want = head.decode(errors="replace")
        if len(want) != 64:
            return None
        if hashlib.sha256(payload).hexdigest() != want:
            return None
        return want, payload

    # -------------------------------------------------------------- ledger
    def put(self, p: int, offset: int, blob: bytes, epoch: int = 0) -> None:
        p, offset, epoch = int(p), int(offset), int(epoch)
        sha = hashlib.sha256(blob).hexdigest()
        with self._lock:
            fence = self._fence.get(p, 0)
            if epoch < fence:
                self.fenced_rejects_total += 1
                raise FencedEpochError(
                    f"partition {p} fenced at epoch {fence}; stale writer "
                    f"at epoch {epoch} refused")
            path = self._commit_blob(p, offset, epoch, sha, blob)
            entries = self._ledger.setdefault(p, [])
            # a client-retried put (response lost, request resent) must
            # REPLACE its twin, not duplicate it: a duplicate would alias
            # the same committed file and the retention pass below would
            # unlink the genuine previous checkpoint through the alias —
            # silently destroying the torn-blob fallback this store
            # exists to provide
            entries[:] = [e for e in entries
                          if (e[0], e[1]) != (offset, epoch)]
            entries.insert(0, (offset, epoch, sha,
                               blob if path is None else None, path))
            # retain current + previous; drop (and unlink) older — but
            # never a file a retained entry still references
            keep_paths = {e[4] for e in entries[:self.KEEP_PER_PARTITION]
                          if e[4] is not None}
            for off2, ep2, _, _, path2 in entries[self.KEEP_PER_PARTITION:]:
                if path2 is not None and path2 not in keep_paths:
                    try:
                        path2.unlink()
                    except OSError:
                        pass
            del entries[self.KEEP_PER_PARTITION:]
            self.checkpoints_total += 1

    def get(self, p: int) -> Optional[Tuple[int, bytes, int]]:
        """Latest VERIFIED (offset, blob, epoch) for a partition: a torn
        newest blob is counted and the previous checkpoint served — the
        committed-gap replay covers the difference."""
        with self._lock:
            entries = list(self._ledger.get(int(p), ()))
        for i, entry in enumerate(entries):
            got = self._read_blob(entry)
            if got is None:
                with self._lock:
                    self.torn_blobs_total += 1
                continue
            with self._lock:
                self.restores_total += 1
            return entry[0], got[1], entry[1]
        return None

    def fence(self, p: int, epoch: int) -> None:
        with self._lock:
            self._fence[int(p)] = max(self._fence.get(int(p), 0), int(epoch))

    def offsets(self) -> Dict[int, int]:
        with self._lock:
            return {p: entries[0][0]
                    for p, entries in sorted(self._ledger.items())
                    if entries}

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "checkpoints_total": self.checkpoints_total,
                "restores_total": self.restores_total,
                "torn_blobs_total": self.torn_blobs_total,
                "fenced_rejects_total": self.fenced_rejects_total,
                "partitions": len(self._ledger),
            }

    # ------------------------------------------------------------- dispatch
    def dispatch(self, req: Mapping[str, Any]) -> Dict[str, Any]:
        op = req.get("op")
        if op == "put":
            self.put(req["p"], req["offset"],
                     base64.b64decode(req["blob"]),
                     epoch=req.get("epoch", 0))
            return {}
        if op == "get":
            got = self.get(req["p"])
            if got is None:
                return {"found": False}
            offset, blob, epoch = got
            return {"found": True, "offset": offset, "epoch": epoch,
                    "blob": base64.b64encode(blob).decode()}
        if op == "fence":
            self.fence(req["p"], req["epoch"])
            return {}
        if op == "offsets":
            return {"offsets": {str(p): off
                                for p, off in self.offsets().items()}}
        if op == "stats":
            return self.stats()
        if op == "ping":
            return {"pong": True}
        raise ValueError(f"unknown op {op!r}")


class HandoffClient:
    """Worker-side handoff client: the ``HandoffStore`` surface
    (``put``/``get``/``offsets``) over one TCP connection, plus ``fence``
    for the coordinator.

    ``epoch`` is the mutable writer epoch stamped onto every ``put`` —
    the worker's run loop sets it to the fleet generation each time it
    adopts an assignment, so the server's fence can refuse a zombie
    (:class:`FencedEpochError` surfaces as a loud RuntimeError, never a
    silent stale write). Connection loss retries against the SAME address
    with ``DeterministicBackoff`` — a handoff-server restart mid-restore
    is a bounded wait, not a failure.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 9095,
                 timeout_s: float = 30.0, reconnect_attempts: int = 6,
                 retry_sleep=None, link=None):
        from realtime_fraud_detection_tpu_torch.utils.backoff import (
            DeterministicBackoff,
            instance_seed,
        )

        self._addr = (host, int(port))
        self._timeout_s = timeout_s
        self._sock = socket.create_connection(self._addr, timeout=timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()
        self._reconnect_attempts = max(0, int(reconnect_attempts))
        # optional in-path chaos link (chaos/netfaults.py) — None in
        # production; the partition drill degrades/partitions this
        # connection exactly like the broker one
        self._link = link
        self.backoff = DeterministicBackoff(
            base_s=0.05, mult=2.0, max_s=1.0,
            seed=instance_seed(f"handoff:{port}"), sleep=retry_sleep)
        self.epoch = 0
        self.snapshots_taken = 0      # HandoffStore counter parity

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def _call(self, req: Dict[str, Any]) -> Dict[str, Any]:
        resp = None
        last: Optional[Exception] = None
        for attempt in range(self._reconnect_attempts + 1):
            resp = None
            try:
                with self._lock:
                    if self._link is not None:
                        # frame size for byte-paced throttling (the
                        # double serialization is paid only while a
                        # chaos link is attached)
                        self._link.before_send(
                            req, len(json.dumps(
                                req, separators=(",", ":")).encode()))
                    _send_frame(self._sock, req)
                    # bounded whole-frame read: a SIGSTOP'd handoff
                    # server cannot wedge a restoring worker forever
                    deadline = time.monotonic() + self._timeout_s  # socket I/O deadline is genuinely wall-bound
                    try:
                        resp = _recv_frame(self._sock, deadline=deadline)
                    finally:
                        # restore the full op timeout: the deadline path
                        # shrinks it to the residual budget
                        try:
                            self._sock.settimeout(self._timeout_s)
                        except OSError:
                            pass
                if resp is None:
                    raise ConnectionError("handoff server closed connection")
                if self._link is not None:
                    self._link.after_recv(req)
                break
            except (ConnectionError, OSError) as e:
                last = e
                if attempt >= self._reconnect_attempts:
                    raise
                self.backoff.sleep(attempt)
                try:
                    with self._lock:
                        try:
                            self._sock.close()
                        except OSError:
                            pass
                        self._sock = socket.create_connection(
                            self._addr, timeout=self._timeout_s)
                        self._sock.setsockopt(socket.IPPROTO_TCP,
                                              socket.TCP_NODELAY, 1)
                except OSError as e2:
                    last = e2          # still down: next attempt backs off
        if resp is None:
            raise ConnectionError(f"handoff server unreachable: {last}")
        if "error" in resp:
            msg = str(resp["error"])
            if msg.startswith("FencedEpochError"):
                # typed re-raise: the fenced-writer path (a worker that
                # lost its partitions in an unobserved rebalance) must be
                # distinguishable from a genuine server error — the
                # worker's response is abandon-and-rejoin, not crash
                raise FencedEpochError(f"handoff refused: {msg}")
            raise RuntimeError(f"handoff error: {msg}")
        return resp

    # -------------------------------------------------- HandoffStore surface
    def put(self, partition: int, offset: int, blob: bytes) -> None:
        self._call({"op": "put", "p": int(partition), "offset": int(offset),
                    "epoch": int(self.epoch),
                    "blob": base64.b64encode(blob).decode()})
        self.snapshots_taken += 1

    def get(self, partition: int) -> Optional[Tuple[int, bytes]]:
        resp = self._call({"op": "get", "p": int(partition)})
        if not resp.get("found"):
            return None
        return int(resp["offset"]), base64.b64decode(resp["blob"])

    def offsets(self) -> Dict[int, int]:
        resp = self._call({"op": "offsets"})
        return {int(p): int(off) for p, off in resp["offsets"].items()}

    # ------------------------------------------------------- coordinator ops
    def fence(self, partition: int, epoch: int) -> None:
        self._call({"op": "fence", "p": int(partition), "epoch": int(epoch)})

    def stats(self) -> Dict[str, int]:
        return self._call({"op": "stats"})

    def ping(self) -> bool:
        return bool(self._call({"op": "ping"}).get("pong"))
