"""RESP (REdis Serialization Protocol) client and mini server, stdlib only.

Port of the JAX package's ``state/resp.py``; the wire format, the replies and
the append-only file are byte-compatible with it, so a process of either
package can share one server. ``RespClient`` speaks RESP2 to any
Redis-compatible server, and ``MiniRedisServer`` is a Redis-protocol server
over an in-process keyspace (strings, hashes, lists, TTLs): the shared state
plane N scorer replicas use (``state/shared.py``), with no Redis binary
needed.

Command subset (what the reference's key schema needs): PING, GET, SET [EX],
SETEX, SETNX, DEL, EXISTS, EXPIRE, TTL, INCR, INCRBYFLOAT, HSET, HSETNX, HGET,
HGETALL, HINCRBY, HINCRBYFLOAT, HDEL, LPUSH, RPUSH, LTRIM, LRANGE, LLEN,
KEYS, FLUSHDB, DBSIZE, INFO, SYNC, PEXPIREAT. Hash-field increments are
atomic on the server, so replicas sharing a user cannot lose an update (the
reference's GET-then-SET velocity race, RedisTransactionSink.java:116-135).
Floats are written in the ``%.17g`` form, so a shared velocity sum is
bit-equal to the in-process one.

Production semantics (reference config/redis/redis-master.conf:17-18 and its
3-master + 3-replica topology):

- **maxmemory + allkeys-lru**: ``MiniRedisServer(maxmemory=...)`` tracks
  approximate per-key memory and evicts the least recently accessed keys
  when a write pushes usage over the cap (exact LRU, not Redis's 5-key
  sampling). ``policy="noeviction"`` gives Redis's OOM-error mode instead.
- **Append-only persistence**: ``aof_path=`` logs every effective write
  (TTLs rewritten to absolute PEXPIREAT, so a replay does not extend them)
  and replays the log on start; a truncated tail (a crash mid-write) is
  dropped, like ``aof-load-truncated yes``. ``rewrite_aof()`` compacts the
  log to a snapshot of the live keyspace.
- **Replication**: ``replica_of=(host, port)`` makes the server a read-only
  replica: it SYNCs a snapshot from the primary, then applies the primary's
  streamed write commands; ``promote()`` detaches it for failover. Replicas
  reject client writes with -READONLY, like Redis.
"""

from __future__ import annotations

import fnmatch
import os
import queue
import socket
import socketserver
import sys
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = ["RespClient", "MiniRedisServer", "RespError"]


class RespError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------


def encode_command(args: Tuple[Any, ...]) -> bytes:
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        if isinstance(a, bytes):
            b = a
        elif isinstance(a, str):
            b = a.encode()
        elif isinstance(a, float):
            b = repr(a).encode()
        else:
            b = str(a).encode()
        out.append(b"$%d\r\n%s\r\n" % (len(b), b))
    return b"".join(out)


class _SockReader:
    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = bytearray()

    def read_line(self) -> bytes:
        while True:
            i = self._buf.find(b"\r\n")
            if i >= 0:
                line = bytes(self._buf[:i])
                del self._buf[: i + 2]
                return line
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("connection closed")
            self._buf.extend(chunk)

    def read_exact(self, n: int) -> bytes:
        while len(self._buf) < n + 2:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("connection closed")
            self._buf.extend(chunk)
        data = bytes(self._buf[:n])
        del self._buf[: n + 2]          # strip trailing \r\n
        return data

    def read_value(self) -> Any:
        line = self.read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RespError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            return None if n < 0 else self.read_exact(n)
        if kind == b"*":
            n = int(rest)
            return None if n < 0 else [self.read_value() for _ in range(n)]
        raise RespError(f"bad RESP type byte {kind!r}")


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class RespClient:
    """One-connection Redis client. Thread-safe (requests serialized)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 timeout_s: float = 30.0):
        self._sock = socket.create_connection((host, port), timeout=timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._reader = _SockReader(self._sock)
        self._lock = threading.Lock()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def execute(self, *args: Any) -> Any:
        with self._lock:
            self._sock.sendall(encode_command(args))
            return self._reader.read_value()

    # ------------------------------------------------------------- strings
    def ping(self) -> bool:
        return self.execute("PING") == "PONG"

    def get(self, key: str) -> Optional[bytes]:
        return self.execute("GET", key)

    def set(self, key: str, value: Any, ex: Optional[float] = None) -> None:
        if ex is not None:
            self.execute("SET", key, value, "PX", int(ex * 1000))
        else:
            self.execute("SET", key, value)

    def setnx(self, key: str, value: Any) -> bool:
        return self.execute("SETNX", key, value) == 1

    def delete(self, *keys: str) -> int:
        return self.execute("DEL", *keys)

    def exists(self, key: str) -> bool:
        return self.execute("EXISTS", key) == 1

    def expire(self, key: str, seconds: float) -> bool:
        return self.execute("PEXPIRE", key, int(seconds * 1000)) == 1

    def incr(self, key: str) -> int:
        return self.execute("INCR", key)

    def incrbyfloat(self, key: str, amount: float) -> float:
        return float(self.execute("INCRBYFLOAT", key, amount))

    # -------------------------------------------------------------- hashes
    def hset(self, key: str, *pairs: Any) -> int:
        return self.execute("HSET", key, *pairs)

    def hsetnx(self, key: str, field: str, value: Any) -> bool:
        return self.execute("HSETNX", key, field, value) == 1

    def hget(self, key: str, field: str) -> Optional[bytes]:
        return self.execute("HGET", key, field)

    def hgetall(self, key: str) -> Dict[str, bytes]:
        flat = self.execute("HGETALL", key) or []
        return {flat[i].decode(): flat[i + 1] for i in range(0, len(flat), 2)}

    def hincrby(self, key: str, field: str, amount: int = 1) -> int:
        return self.execute("HINCRBY", key, field, amount)

    def hincrbyfloat(self, key: str, field: str, amount: float) -> float:
        return float(self.execute("HINCRBYFLOAT", key, field, amount))

    # --------------------------------------------------------------- lists
    def lpush(self, key: str, *values: Any) -> int:
        return self.execute("LPUSH", key, *values)

    def rpush(self, key: str, *values: Any) -> int:
        return self.execute("RPUSH", key, *values)

    def ltrim(self, key: str, start: int, stop: int) -> None:
        self.execute("LTRIM", key, start, stop)

    def lrange(self, key: str, start: int, stop: int) -> List[bytes]:
        return self.execute("LRANGE", key, start, stop) or []

    def llen(self, key: str) -> int:
        return self.execute("LLEN", key)

    # --------------------------------------------------------------- admin
    def keys(self, pattern: str = "*") -> List[bytes]:
        return self.execute("KEYS", pattern) or []

    def flushdb(self) -> None:
        self.execute("FLUSHDB")

    def dbsize(self) -> int:
        return self.execute("DBSIZE")

    def info(self) -> Dict[str, str]:
        raw = self.execute("INFO")
        out: Dict[str, str] = {}
        for line in (raw or b"").decode().splitlines():
            if line and not line.startswith("#") and ":" in line:
                k, v = line.split(":", 1)
                out[k] = v
        return out


# ---------------------------------------------------------------------------
# mini server
# ---------------------------------------------------------------------------


def _approx_size(key: bytes, value: Any) -> int:
    """Approximate resident bytes for a key (Redis-style accounting: payload
    plus fixed per-object overheads; exactness doesn't matter, monotonicity
    with real usage does)."""
    n = len(key) + 48
    if isinstance(value, bytes):
        return n + len(value) + 16
    if isinstance(value, dict):
        return n + 64 + sum(len(f) + len(v) + 64 for f, v in value.items())
    if isinstance(value, list):
        return n + 64 + sum(len(v) + 16 for v in value)
    return n + 64


class _Store:
    """The keyspace: key -> (value, expires_at_ms|None). Values are bytes
    (strings), dict (hashes), or list (lists). One lock — command atomicity
    is the contract that matters (HINCRBY etc.), not parallelism.

    ``access``/``sizes``/``used_memory`` feed the LRU eviction: every command
    touch bumps a logical clock, every write recomputes the touched key's
    approximate size."""

    def __init__(self) -> None:
        self.data: Dict[bytes, Tuple[Any, Optional[float]]] = {}
        self.lock = threading.Lock()
        self.access: Dict[bytes, int] = {}
        self.sizes: Dict[bytes, int] = {}
        self.used_memory = 0
        self.clock = 0

    def now_ms(self) -> float:
        return time.time() * 1000.0

    def touch(self, key: bytes) -> None:
        """Move ``key`` to the recently-used end. ``access`` doubles as the
        LRU order (dict preserves insertion order; pop+reinsert = move-to-
        end), so eviction pops from the front in O(1) — no keyspace scan."""
        self.clock += 1
        if key in self.data:
            self.access.pop(key, None)
            self.access[key] = self.clock

    def lru_victim(self) -> Optional[bytes]:
        for key in self.access:
            return key
        for key in self.data:          # untouched keys (shouldn't happen)
            return key
        return None

    def drop(self, key: bytes) -> None:
        self.data.pop(key, None)
        self.access.pop(key, None)
        self.used_memory -= self.sizes.pop(key, 0)

    def resize(self, key: bytes) -> None:
        """Re-account ``key`` after a mutation (or removal)."""
        self.used_memory -= self.sizes.pop(key, 0)
        item = self.data.get(key)
        if item is None:
            self.access.pop(key, None)
            return
        size = _approx_size(key, item[0])
        self.sizes[key] = size
        self.used_memory += size

    def live(self, key: bytes) -> Optional[Any]:
        item = self.data.get(key)
        if item is None:
            return None
        value, exp = item
        if exp is not None and self.now_ms() >= exp:
            self.drop(key)
            return None
        return value

    def put(self, key: bytes, value: Any,
            expires_at_ms: Optional[float] = None) -> None:
        self.data[key] = (value, expires_at_ms)

    def keep_ttl_put(self, key: bytes, value: Any) -> None:
        old = self.data.get(key)
        self.data[key] = (value, old[1] if old else None)


def _num(b: bytes) -> float:
    return float(b)


def _fmt_float(v: float) -> bytes:
    s = f"{v:.17g}"
    return s.encode()


class _RespHandler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        server: MiniRedisServer = self.server.outer  # type: ignore[attr-defined]
        reader = _SockReader(self.request)
        while True:
            try:
                cmd = reader.read_value()
            except (ConnectionError, RespError):
                return
            if not isinstance(cmd, list) or not cmd:
                return
            if bytes(cmd[0]).upper() == b"SYNC":
                # replication handshake: snapshot + live write stream ride
                # this very connection from now on. The replica never sends
                # again; park this thread tolerating the 5 s send-timeout
                # (set by handle_sync) bleeding into our recv, and exit —
                # closing the socket — only once the primary has dropped
                # the replica from its propagation list.
                server.handle_sync(self.request)
                while server.is_replica_socket(self.request):
                    try:
                        reader.read_value()
                    except socket.timeout:
                        continue
                    except (ConnectionError, RespError, OSError):
                        break
                return
            try:
                resp = server.run_command([bytes(c) for c in cmd],
                                          from_client=True)
            except RespError as e:
                resp = e
            except Exception as e:  # noqa: BLE001
                resp = RespError(f"ERR {type(e).__name__}: {e}")
            try:
                self.request.sendall(_encode_reply(resp))
            except OSError:
                return


def _encode_reply(v: Any) -> bytes:
    if isinstance(v, RespError):
        return b"-%s\r\n" % str(v).encode()
    if v is True:
        return b"+OK\r\n"
    if isinstance(v, str):
        return b"+%s\r\n" % v.encode()
    if isinstance(v, bool):
        return b":%d\r\n" % int(v)
    if isinstance(v, int):
        return b":%d\r\n" % v
    if v is None:
        return b"$-1\r\n"
    if isinstance(v, bytes):
        return b"$%d\r\n%s\r\n" % (len(v), v)
    if isinstance(v, list):
        return b"*%d\r\n" % len(v) + b"".join(_encode_reply(x) for x in v)
    raise TypeError(f"cannot encode {type(v)}")


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


_WRITE_CMDS = frozenset({
    "SET", "SETEX", "SETNX", "DEL", "EXPIRE", "PEXPIRE", "PEXPIREAT",
    "INCR", "INCRBYFLOAT", "HSET", "HSETNX", "HINCRBY", "HINCRBYFLOAT",
    "HDEL", "LPUSH", "RPUSH", "LTRIM", "FLUSHDB",
})


def _iter_aof(buf: bytes) -> Iterator[List[bytes]]:
    """Parse an append-only file of RESP command arrays. Stops silently at
    a truncated/corrupt tail (aof-load-truncated yes)."""
    i, n = 0, len(buf)
    while i < n:
        try:
            if buf[i:i + 1] != b"*":
                return
            j = buf.index(b"\r\n", i)
            argc = int(buf[i + 1:j])
            i = j + 2
            parts: List[bytes] = []
            for _ in range(argc):
                if buf[i:i + 1] != b"$":
                    return
                j = buf.index(b"\r\n", i)
                ln = int(buf[i + 1:j])
                i = j + 2
                if i + ln + 2 > n:
                    return
                parts.append(buf[i:i + ln])
                i += ln + 2
        except ValueError:
            return
        yield parts


class _ReplicaLink:
    """Per-replica output buffer + sender thread (Redis's client output
    buffer): the primary's write path only ENQUEUES under the store lock —
    a slow or drip-feeding replica can never stall client commands. A full
    buffer (replica hopelessly behind) drops the link; the replica
    reconnects and re-SYNCs."""

    def __init__(self, sock: socket.socket, maxlen: int = 10_000):
        self.sock = sock
        self.q: "queue.Queue[Optional[bytes]]" = queue.Queue(maxsize=maxlen)
        self.alive = True
        self.thread = threading.Thread(
            target=self._drain, name="mini-redis-repl-out", daemon=True)
        self.thread.start()

    def send(self, payload: bytes) -> bool:
        """Non-blocking enqueue; False = buffer overrun, drop this link."""
        if not self.alive:
            return False
        try:
            self.q.put_nowait(payload)
            return True
        except queue.Full:
            self.close()
            return False

    def _drain(self) -> None:
        while True:
            payload = self.q.get()
            if payload is None or not self.alive:
                return
            try:
                self.sock.sendall(payload)
            except OSError:
                self.alive = False
                return

    def close(self) -> None:
        self.alive = False
        try:
            self.q.put_nowait(None)
        except queue.Full:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class MiniRedisServer:
    """Redis-protocol-compatible server over an in-process keyspace, with
    maxmemory/LRU eviction, append-only persistence and primary→replica
    replication (see module docstring)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 maxmemory: int = 0, policy: str = "allkeys-lru",
                 aof_path: Optional[str] = None,
                 replica_of: Optional[Tuple[str, int]] = None):
        if policy not in ("allkeys-lru", "noeviction"):
            raise ValueError(f"unsupported eviction policy {policy!r}")
        self._store = _Store()
        self._maxmemory = int(maxmemory)
        self._policy = policy
        self._evicted = 0
        self._aof_path = aof_path
        self._aof_file = None
        self._loading = False
        self._aof_skipped = 0
        self._replicas: List[_ReplicaLink] = []
        self._replica_of = replica_of
        self._repl_stop = threading.Event()
        self._repl_sock: Optional[socket.socket] = None
        self._repl_thread: Optional[threading.Thread] = None
        if aof_path:
            self._load_aof(aof_path)
            self._aof_file = open(aof_path, "ab")
        self._tcp = _TCPServer((host, port), _RespHandler)
        self._tcp.outer = self  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._tcp.serve_forever, name="mini-redis", daemon=True)

    def start(self) -> "MiniRedisServer":
        self._thread.start()
        if self._replica_of is not None:
            self._repl_thread = threading.Thread(
                target=self._replicate_from, args=self._replica_of,
                name="mini-redis-replica", daemon=True)
            self._repl_thread.start()
        return self

    def stop(self) -> None:
        self._repl_stop.set()
        if self._repl_sock is not None:
            try:
                self._repl_sock.close()
            except OSError:
                pass
        self._tcp.shutdown()
        self._tcp.server_close()
        for link in self._replicas:
            link.close()
        with self._store.lock:
            if self._aof_file is not None:
                self._aof_file.close()
                self._aof_file = None

    @property
    def port(self) -> int:
        return self._tcp.server_address[1]

    @property
    def is_replica(self) -> bool:
        return self._replica_of is not None

    @property
    def used_memory(self) -> int:
        return self._store.used_memory

    @property
    def evicted_keys(self) -> int:
        return self._evicted

    # ------------------------------------------------------------- commands
    def run_command(self, parts: List[bytes],
                    from_client: bool = False) -> Any:
        name = parts[0].upper().decode()
        args = parts[1:]
        s = self._store
        is_write = name in _WRITE_CMDS
        if is_write and from_client and self.is_replica:
            raise RespError(
                "READONLY You can't write against a read only replica.")
        with s.lock:
            handler = getattr(self, f"_cmd_{name.lower()}", None)
            if handler is None:
                raise RespError(f"ERR unknown command '{name}'")
            if (is_write and self._maxmemory
                    and self._policy == "noeviction"
                    and s.used_memory > self._maxmemory
                    and name not in ("DEL", "FLUSHDB")
                    and not self._loading):
                # never OOM-reject during AOF replay — Redis loads the full
                # log and only then enforces maxmemory on new writes
                raise RespError("OOM command not allowed when used memory "
                                "> 'maxmemory'.")
            result = handler(s, args)
            if args:
                s.touch(args[0])
            if is_write:
                self._after_write(name, args, result)
            return result

    # ------------------------------------------------- write-path machinery
    def _after_write(self, name: str, args: List[bytes], result: Any) -> None:
        """Re-account sizes, persist/propagate the effective command, evict.
        Called with the store lock held."""
        s = self._store
        if name == "FLUSHDB":
            s.access.clear()
            s.sizes.clear()
            s.used_memory = 0
        elif name == "DEL":
            for key in args:
                s.resize(key)
        else:
            s.resize(args[0])
        for entry in self._effective_entries(name, args, result):
            self._persist(entry)
        if self._maxmemory and self._policy == "allkeys-lru":
            while s.used_memory > self._maxmemory and s.data:
                victim = s.lru_victim()
                if victim is None:
                    break
                s.drop(victim)
                self._evicted += 1
                # evictions are state changes: AOF + replicas must see them
                self._persist((b"DEL", victim))

    def _effective_entries(self, name: str, args: List[bytes],
                           result: Any) -> List[Tuple[bytes, ...]]:
        """Translate a write command into replay-safe AOF/replication entries.

        Relative TTLs become absolute PEXPIREAT (replay later must not
        extend them); conditional writes that didn't fire log nothing."""
        s = self._store
        if name in ("SET", "SETEX", "SETNX"):
            if result is None or result == 0:
                return []
            key = args[0]
            value, exp = s.data[key]
            out = [(b"SET", key, value)]
            if exp is not None:
                out.append((b"PEXPIREAT", key, str(int(exp)).encode()))
            return out
        if name in ("EXPIRE", "PEXPIRE", "PEXPIREAT"):
            if result != 1:
                return []
            exp = s.data[args[0]][1]
            return [(b"PEXPIREAT", args[0], str(int(exp)).encode())]
        return [tuple([name.encode(), *args])]

    def _persist(self, entry: Tuple[bytes, ...]) -> None:
        payload = encode_command(entry)
        if self._aof_file is not None:
            self._aof_file.write(payload)
            self._aof_file.flush()
        for link in list(self._replicas):
            # enqueue only — the per-replica sender thread does the socket
            # I/O, so a slow replica can never stall commands on the primary
            if not link.send(payload):
                self._replicas.remove(link)

    # ----------------------------------------------------------- AOF replay
    def _load_aof(self, path: str) -> None:
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            buf = f.read()
        self._loading = True
        try:
            for parts in _iter_aof(buf):
                try:
                    self.run_command(parts)
                except RespError as e:
                    # replay of a well-formed log shouldn't error; count and
                    # surface rather than silently dropping data
                    self._aof_skipped += 1
                    print(f"mini-redis: AOF entry skipped during replay: {e}",
                          file=sys.stderr)
        finally:
            self._loading = False

    def _snapshot_entries(self) -> List[Tuple[bytes, ...]]:
        """The live keyspace as replay commands (lock must be held)."""
        s = self._store
        out: List[Tuple[bytes, ...]] = []
        for key in list(s.data):
            value = s.live(key)
            if value is None:
                continue
            _, exp = s.data[key]
            if isinstance(value, bytes):
                out.append((b"SET", key, value))
            elif isinstance(value, dict):
                flat: List[bytes] = []
                for f, v in value.items():
                    flat.extend((f, v))
                if flat:
                    out.append((b"HSET", key, *flat))
            elif isinstance(value, list):
                if value:
                    out.append((b"RPUSH", key, *value))
            if exp is not None:
                out.append((b"PEXPIREAT", key, str(int(exp)).encode()))
        return out

    def rewrite_aof(self) -> None:
        """Compact the append-only file to a snapshot of the live keyspace
        (BGREWRITEAOF analog, synchronous)."""
        if not self._aof_path:
            return
        with self._store.lock:
            tmp = self._aof_path + ".rewrite"
            with open(tmp, "wb") as f:
                for entry in self._snapshot_entries():
                    f.write(encode_command(entry))
            if self._aof_file is not None:
                self._aof_file.close()
            os.replace(tmp, self._aof_path)
            self._aof_file = open(self._aof_path, "ab")

    # ---------------------------------------------------------- replication
    def handle_sync(self, sock: socket.socket) -> None:
        """Primary side of SYNC: send a snapshot array, then register the
        connection for the live write stream (atomically, so no write is
        lost between snapshot and subscription)."""
        with self._store.lock:
            entries = self._snapshot_entries()
            payload = (b"*%d\r\n" % len(entries)
                       + b"".join(encode_command(e) for e in entries))
            link = _ReplicaLink(sock)
            if not link.send(payload):
                return
            self._replicas.append(link)

    def is_replica_socket(self, sock: socket.socket) -> bool:
        return any(link.sock is sock and link.alive
                   for link in self._replicas)

    def _replicate_from(self, host: str, port: int) -> None:
        """Replica side: SYNC snapshot, then apply the primary's stream.
        Reconnects (fresh SYNC) until stopped/promoted."""
        while not self._repl_stop.is_set():
            sock = None
            try:
                sock = socket.create_connection((host, port), timeout=10.0)
                self._repl_sock = sock
                sock.sendall(encode_command(("SYNC",)))
                reader = _SockReader(sock)
                snapshot = reader.read_value()
                self.run_command([b"FLUSHDB"])
                for parts in snapshot or []:
                    self.run_command([bytes(p) for p in parts])
                sock.settimeout(None)
                while not self._repl_stop.is_set():
                    parts = reader.read_value()
                    if not isinstance(parts, list) or not parts:
                        break
                    self.run_command([bytes(p) for p in parts])
            except (OSError, ConnectionError, RespError):
                pass
            finally:
                self._repl_sock = None
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
            if not self._repl_stop.is_set():
                time.sleep(0.2)

    def promote(self) -> None:
        """Detach from the primary and accept writes (failover: REPLICAOF
        NO ONE analog)."""
        self._repl_stop.set()
        if self._repl_sock is not None:
            try:
                self._repl_sock.close()
            except OSError:
                pass
        self._replica_of = None

    # strings ---------------------------------------------------------------
    @staticmethod
    def _cmd_ping(s: _Store, args) -> str:
        return args[0].decode() if args else "PONG"

    @staticmethod
    def _cmd_get(s: _Store, args):
        v = s.live(args[0])
        if v is not None and not isinstance(v, bytes):
            raise RespError("WRONGTYPE Operation against a key holding the "
                            "wrong kind of value")
        return v

    @staticmethod
    def _cmd_set(s: _Store, args) -> Any:
        key, value, rest = args[0], args[1], args[2:]
        expires = None
        i = 0
        nx = xx = False
        while i < len(rest):
            opt = rest[i].upper()
            if opt == b"EX":
                expires = s.now_ms() + float(rest[i + 1]) * 1000.0
                i += 2
            elif opt == b"PX":
                expires = s.now_ms() + float(rest[i + 1])
                i += 2
            elif opt == b"NX":
                nx = True
                i += 1
            elif opt == b"XX":
                xx = True
                i += 1
            else:
                raise RespError(f"ERR syntax error near {opt!r}")
        exists = s.live(key) is not None
        if (nx and exists) or (xx and not exists):
            return None
        s.put(key, value, expires)
        return True

    @staticmethod
    def _cmd_setex(s: _Store, args) -> Any:
        key, seconds, value = args
        s.put(key, value, s.now_ms() + float(seconds) * 1000.0)
        return True

    @staticmethod
    def _cmd_setnx(s: _Store, args) -> int:
        if s.live(args[0]) is not None:
            return 0
        s.put(args[0], args[1])
        return 1

    @staticmethod
    def _cmd_del(s: _Store, args) -> int:
        n = 0
        for key in args:
            if s.live(key) is not None:
                del s.data[key]
                n += 1
        return n

    @staticmethod
    def _cmd_exists(s: _Store, args) -> int:
        return sum(1 for key in args if s.live(key) is not None)

    @staticmethod
    def _cmd_expire(s: _Store, args) -> int:
        if s.live(args[0]) is None:
            return 0
        value, _ = s.data[args[0]]
        s.put(args[0], value, s.now_ms() + float(args[1]) * 1000.0)
        return 1

    @staticmethod
    def _cmd_pexpire(s: _Store, args) -> int:
        if s.live(args[0]) is None:
            return 0
        value, _ = s.data[args[0]]
        s.put(args[0], value, s.now_ms() + float(args[1]))
        return 1

    @staticmethod
    def _cmd_pexpireat(s: _Store, args) -> int:
        """Absolute-deadline expiry — the replay-safe TTL form the AOF and
        replication stream use (relative EXPIREs are rewritten to this)."""
        if s.live(args[0]) is None:
            return 0
        value, _ = s.data[args[0]]
        s.put(args[0], value, float(args[1]))
        return 1

    @staticmethod
    def _cmd_ttl(s: _Store, args) -> int:
        if s.live(args[0]) is None:
            return -2
        _, exp = s.data[args[0]]
        if exp is None:
            return -1
        return max(0, int((exp - s.now_ms()) / 1000.0))

    @staticmethod
    def _cmd_incr(s: _Store, args) -> int:
        v = s.live(args[0])
        cur = int(v) if v is not None else 0
        cur += 1
        s.keep_ttl_put(args[0], str(cur).encode())
        return cur

    @staticmethod
    def _cmd_incrbyfloat(s: _Store, args) -> bytes:
        v = s.live(args[0])
        cur = _num(v) if v is not None else 0.0
        cur += _num(args[1])
        out = _fmt_float(cur)
        s.keep_ttl_put(args[0], out)
        return out

    # hashes ----------------------------------------------------------------
    @staticmethod
    def _hash(s: _Store, key: bytes) -> Dict[bytes, bytes]:
        v = s.live(key)
        if v is None:
            v = {}
            s.put(key, v)
        elif not isinstance(v, dict):
            raise RespError("WRONGTYPE Operation against a key holding the "
                            "wrong kind of value")
        return v

    @classmethod
    def _cmd_hset(cls, s: _Store, args) -> int:
        h = cls._hash(s, args[0])
        added = 0
        for i in range(1, len(args), 2):
            if args[i] not in h:
                added += 1
            h[args[i]] = args[i + 1]
        return added

    @classmethod
    def _cmd_hsetnx(cls, s: _Store, args) -> int:
        h = cls._hash(s, args[0])
        if args[1] in h:
            return 0
        h[args[1]] = args[2]
        return 1

    @classmethod
    def _cmd_hget(cls, s: _Store, args):
        v = s.live(args[0])
        if v is None:
            return None
        if not isinstance(v, dict):
            raise RespError("WRONGTYPE Operation against a key holding the "
                            "wrong kind of value")
        return v.get(args[1])

    @classmethod
    def _cmd_hgetall(cls, s: _Store, args) -> list:
        v = s.live(args[0])
        if v is None:
            return []
        if not isinstance(v, dict):
            raise RespError("WRONGTYPE Operation against a key holding the "
                            "wrong kind of value")
        out = []
        for field, val in v.items():
            out.extend((field, val))
        return out

    @classmethod
    def _cmd_hincrby(cls, s: _Store, args) -> int:
        h = cls._hash(s, args[0])
        cur = int(h.get(args[1], b"0")) + int(args[2])
        h[args[1]] = str(cur).encode()
        return cur

    @classmethod
    def _cmd_hincrbyfloat(cls, s: _Store, args) -> bytes:
        h = cls._hash(s, args[0])
        cur = _num(h.get(args[1], b"0")) + _num(args[2])
        out = _fmt_float(cur)
        h[args[1]] = out
        return out

    @classmethod
    def _cmd_hdel(cls, s: _Store, args) -> int:
        v = s.live(args[0])
        if not isinstance(v, dict):
            return 0
        n = 0
        for field in args[1:]:
            if field in v:
                del v[field]
                n += 1
        return n

    # lists -----------------------------------------------------------------
    @staticmethod
    def _list(s: _Store, key: bytes) -> list:
        v = s.live(key)
        if v is None:
            v = []
            s.put(key, v)
        elif not isinstance(v, list):
            raise RespError("WRONGTYPE Operation against a key holding the "
                            "wrong kind of value")
        return v

    @classmethod
    def _cmd_lpush(cls, s: _Store, args) -> int:
        lst = cls._list(s, args[0])
        for v in args[1:]:
            lst.insert(0, v)
        return len(lst)

    @classmethod
    def _cmd_rpush(cls, s: _Store, args) -> int:
        lst = cls._list(s, args[0])
        lst.extend(args[1:])
        return len(lst)

    @classmethod
    def _cmd_ltrim(cls, s: _Store, args) -> bool:
        lst = cls._list(s, args[0])
        start, stop = int(args[1]), int(args[2])
        n = len(lst)
        if start < 0:
            start += n
        if stop < 0:
            stop += n
        lst[:] = lst[max(0, start): stop + 1]
        return True

    @classmethod
    def _cmd_lrange(cls, s: _Store, args) -> list:
        v = s.live(args[0])
        if v is None:
            return []
        if not isinstance(v, list):
            raise RespError("WRONGTYPE Operation against a key holding the "
                            "wrong kind of value")
        start, stop = int(args[1]), int(args[2])
        n = len(v)
        if start < 0:
            start += n
        if stop < 0:
            stop += n
        return list(v[max(0, start): stop + 1])

    @classmethod
    def _cmd_llen(cls, s: _Store, args) -> int:
        v = s.live(args[0])
        return len(v) if isinstance(v, list) else 0

    # admin -----------------------------------------------------------------
    @staticmethod
    def _cmd_keys(s: _Store, args) -> list:
        pattern = (args[0] if args else b"*").decode()
        return [k for k in list(s.data)
                if s.live(k) is not None
                and fnmatch.fnmatchcase(k.decode(), pattern)]

    @staticmethod
    def _cmd_flushdb(s: _Store, args) -> bool:
        s.data.clear()
        return True

    def _cmd_info(self, s: _Store, args) -> bytes:
        lines = [
            "# Server",
            f"role:{'slave' if self.is_replica else 'master'}",
            "# Memory",
            f"used_memory:{s.used_memory}",
            f"maxmemory:{self._maxmemory}",
            f"maxmemory_policy:{self._policy}",
            "# Stats",
            f"evicted_keys:{self._evicted}",
            f"db0_keys:{sum(1 for k in list(s.data) if s.live(k) is not None)}",
            f"connected_replicas:{sum(r.alive for r in self._replicas)}",
            f"aof_enabled:{int(self._aof_path is not None)}",
            f"aof_entries_skipped_on_load:{self._aof_skipped}",
        ]
        return ("\r\n".join(lines) + "\r\n").encode()

    @staticmethod
    def _cmd_dbsize(s: _Store, args) -> int:
        return sum(1 for k in list(s.data) if s.live(k) is not None)
