"""Cross-partition neighbour fetch: resolve non-owned graph nodes over TCP.

Port of the JAX package's ``graph/fetch.py``; the frames are the same, so a
client of either package reads a server of the other. Graph edges are
partitioned by the transaction's user key (every write is local to the
owning worker, which is what lets the graph ride handoff snapshots), so the
adjacency of one shared entity, a ring device serving users of several
partitions, is spread over the fleet. A partition-scoped worker sampling a
two-hop neighbourhood resolves the remote shares of its frontier inside
``assemble``, where the latency budget lives.

The protocol is ``cluster/handoff.py``'s framing (``stream/netbroker.py``
length-prefixed JSON frames, one TCP connection a peer) with the score
path's rules on top:

- **one absolute deadline a batch**: a single wall-clock budget covers all
  of a microbatch's remote resolution; a slow or partitioned peer eats what
  is left, never more (``_recv_frame(deadline=...)``);
- **a node budget a batch**: remote lookups are capped per microbatch;
- **degrade to local, never stall**: any failure (deadline, budget, refused
  connection, a netfault window, a fenced generation) gives a partial result
  and a ``degraded`` flag, and the batch scores with fewer neighbours;
- **reconnects gated by backoff**: a dead peer is retried on a
  ``DeterministicBackoff`` schedule measured on the injected clock; the
  score path never sleeps, and an attempt before the next allowed instant
  is skipped as degraded;
- **generation fencing**: every request carries the client's assignment
  generation; a coordinator can fence a server at a new generation, and a
  stale client's requests are refused with :class:`StaleGraphGenerationError`
  (counted and degraded on the client; the worker's adoption of the new
  assignment refreshes the stamp).
"""

from __future__ import annotations

import socket
import socketserver
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from realtime_fraud_detection_tpu_torch.stream.netbroker import (
    _recv_frame,
    _send_frame,
)

__all__ = ["GraphFetchServer", "GraphFetchClient",
           "StaleGraphGenerationError"]


class StaleGraphGenerationError(RuntimeError):
    """A fetch carried an assignment generation older than the server's
    fence: the requester has not adopted a rebalance yet. Refused on the
    server; on the client a counted degrade, never a crash."""


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:  # one connection, many requests
        server: GraphFetchServer = self.server.outer  # type: ignore[attr-defined]
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


class GraphFetchServer:
    """Serve one worker's local typed-graph view to its peers.

    ``graph_source`` is a zero-argument callable returning the object to
    read (a ``TypedEntityGraph`` or a ``PartitionedStore.graph`` facade: any
    ``neighbor_map(edge_type, ids, fanout)`` provider), so a handoff that
    swaps the worker's store swaps the served view with it. The server never
    fetches recursively: it answers with what this worker's partitions know.
    """

    def __init__(self, graph_source: Callable[[], Any],
                 worker_id: str = "", host: str = "127.0.0.1",
                 port: int = 0, max_ids_per_request: int = 512):
        self._graph_source = graph_source
        self.worker_id = str(worker_id)
        self.max_ids_per_request = int(max_ids_per_request)
        self._fence_generation = 0
        self._lock = threading.Lock()
        self._conns: set = set()
        self.requests_total = 0
        self.fenced_requests_total = 0
        self._tcp = _TCPServer((host, port), _Handler)
        self._tcp.outer = self  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._tcp.serve_forever,
            name=f"graph-fetch-{self.worker_id or 'server'}", daemon=True)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "GraphFetchServer":
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

    # ------------------------------------------------------------- fencing
    def fence(self, generation: int) -> None:
        """Refuse requests stamped below ``generation`` from here on
        (monotonic, like the handoff fence)."""
        with self._lock:
            self._fence_generation = max(self._fence_generation,
                                         int(generation))

    # ------------------------------------------------------------- dispatch
    def dispatch(self, req: Mapping[str, Any]) -> Dict[str, Any]:
        op = req.get("op")
        if op == "neighbors":
            with self._lock:
                self.requests_total += 1
                fence = self._fence_generation
            gen = int(req.get("generation", 0))
            if gen < fence:
                with self._lock:
                    self.fenced_requests_total += 1
                raise StaleGraphGenerationError(
                    f"graph fetch fenced at generation {fence}; stale "
                    f"requester at generation {gen} refused")
            ids = [str(i) for i in (req.get("ids") or ())]
            ids = ids[: self.max_ids_per_request]
            graph = self._graph_source()
            k = req.get("k")
            # the handling time rides the reply, so the client's
            # remote_fetch span can report the server's share of it
            # rtfd-lint: allow[wall-clock] real RPC handling time reported to the caller
            t0 = time.perf_counter()
            neighbors = graph.neighbor_map(
                str(req.get("edge")), ids,
                int(k) if k is not None else None)
            return {
                "worker": self.worker_id,
                "neighbors": neighbors,
                # rtfd-lint: allow[wall-clock] real RPC handling time reported to the caller
                "srv_ms": round((time.perf_counter() - t0) * 1e3, 4),
            }
        if op == "ping":
            return {"pong": True, "worker": self.worker_id}
        if op == "stats":
            with self._lock:
                return {"requests_total": self.requests_total,
                        "fenced_requests_total": self.fenced_requests_total,
                        "fence_generation": self._fence_generation}
        raise ValueError(f"unknown op {op!r}")


class GraphFetchClient:
    """Score-path client resolving remote neighbour shares from peers.

    One instance a worker, used from the worker's assembly thread. Peers are
    ``{peer_id: (host, port)}``; connections open lazily and reopen on a
    ``utils/backoff.py DeterministicBackoff`` schedule measured against the
    injected clock. ``link`` is an optional ``chaos/netfaults.py LinkState``
    in the request path (None in production).
    """

    def __init__(self, peers: Mapping[str, Tuple[str, int]],
                 deadline_ms: float = 25.0, node_budget: int = 64,
                 connect_timeout_s: float = 1.0,
                 clock: Optional[Callable[[], float]] = None,
                 backoff=None, link=None):
        from realtime_fraud_detection_tpu_torch.utils.backoff import (
            DeterministicBackoff,
            instance_seed,
        )

        self.peers: Dict[str, Tuple[str, int]] = {
            str(p): (str(h), int(port))
            for p, (h, port) in sorted(peers.items())}
        self.deadline_ms = float(deadline_ms)
        self.node_budget = int(node_budget)
        self.connect_timeout_s = float(connect_timeout_s)
        self._clock = clock if clock is not None else time.monotonic
        self.backoff = backoff if backoff is not None else \
            DeterministicBackoff(base_s=0.05, mult=2.0, max_s=2.0,
                                 seed=instance_seed("graph-fetch"),
                                 sleep=lambda _s: None)
        self._link = link
        self.generation = 0
        self._socks: Dict[str, socket.socket] = {}
        # peer -> (consecutive failures, next retry instant on the clock)
        self._down: Dict[str, Tuple[int, float]] = {}
        # per-batch state (begin_batch resets it)
        self._batch_deadline = float("inf")
        self._budget_left = self.node_budget
        self._batch_degraded = False
        self._batch_deadline_hit = False
        # cumulative counters (obs/metrics.py sync_graph mirrors deltas)
        self.remote_fetch_total = 0        # peer requests attempted
        self.fetched_nodes_total = 0       # node adjacency entries received
        self.fetch_deadline_total = 0      # batches that hit the deadline
        self.fetch_error_total = 0         # refused or failed peer calls
        self.budget_exhausted_total = 0    # fetches cut by the node budget
        self.stale_generation_total = 0    # fenced-generation refusals
        self.degraded_batches_total = 0    # batches with any degrade cause
        # the active batch's TraceBatch (begin_batch(trace=...)): every peer
        # call records a remote_fetch child span on it
        self._trace: Optional[Any] = None

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        for sock in self._socks.values():
            try:
                sock.close()
            except OSError:
                pass
        self._socks.clear()

    def set_generation(self, generation: int) -> None:
        """Adopt the fleet's assignment generation (stamped on requests)."""
        self.generation = int(generation)

    # ------------------------------------------------------------ batch API
    def begin_batch(self, trace: Optional[Any] = None) -> None:
        """Open one microbatch's window: a fresh node budget and one
        absolute deadline shared by every fetch of the batch. With
        ``trace`` (an ``obs/tracing.py TraceBatch``) each peer call records
        a ``remote_fetch`` child span with the server's ``srv_ms``."""
        self._batch_deadline = self._clock() + self.deadline_ms / 1e3
        self._budget_left = self.node_budget
        self._batch_degraded = False
        self._batch_deadline_hit = False
        self._trace = trace

    def end_batch(self) -> bool:
        """Close the window; True (and counted) when any fetch degraded.
        The deadline counts once a microbatch, however many fetches of the
        window saw it expired."""
        if self._batch_deadline_hit:
            self.fetch_deadline_total += 1
        if self._batch_degraded:
            self.degraded_batches_total += 1
        self._trace = None
        return self._batch_degraded

    # -------------------------------------------------------------- fetch
    def fetch(self, edge_type: str, ids: Sequence[str],
              fanout: Optional[int] = None,
              ) -> Tuple[List[Dict[str, List[str]]], bool]:
        """Resolve ``ids``' remote adjacency shares from every reachable
        peer: (neighbour maps in sorted peer order, degraded), partial on
        any failure. The caller merges them with its local view
        (``graph/store.py merge_neighbor_lists``)."""
        ids = [str(i) for i in ids]
        degraded = False
        if not ids or not self.peers:
            return [], False
        if self._budget_left <= 0:
            self.budget_exhausted_total += 1
            self._batch_degraded = True
            return [], True
        if len(ids) > self._budget_left:
            ids = ids[: self._budget_left]
            self.budget_exhausted_total += 1
            degraded = True
        self._budget_left -= len(ids)
        out: List[Dict[str, List[str]]] = []
        req = {"op": "neighbors", "edge": str(edge_type), "ids": ids,
               "generation": int(self.generation)}
        if fanout is not None:
            req["k"] = int(fanout)
        for peer in self.peers:
            now = self._clock()
            if now >= self._batch_deadline:
                self._batch_deadline_hit = True
                degraded = True
                break
            resp = self._call_peer(peer, req)
            if self._trace is not None:
                # the whole call as the worker waited for it, with the
                # peer's own handling time from the reply
                self._trace.child_span(
                    "remote_fetch", (self._clock() - now) * 1e3,
                    peer=peer,
                    server=(resp or {}).get("worker", ""),
                    srv_ms=float((resp or {}).get("srv_ms", 0.0) or 0.0),
                    error=resp is None)
            if resp is None:
                degraded = True
                continue
            neigh = resp.get("neighbors") or {}
            out.append({str(i): [str(n) for n in ring]
                        for i, ring in neigh.items()})
            self.fetched_nodes_total += len(neigh)
        if degraded:
            self._batch_degraded = True
        return out, degraded

    # ---------------------------------------------------------- peer calls
    def _call_peer(self, peer: str,
                   req: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """One request and reply inside the batch deadline. A failure marks
        the peer down (retried on a later batch, after the backoff) and
        returns None."""
        down = self._down.get(peer)
        now = self._clock()
        if down is not None and now < down[1]:
            self.fetch_error_total += 1
            return None
        sock = self._socks.get(peer)
        try:
            if sock is None:
                budget = min(self.connect_timeout_s,
                             max(self._batch_deadline - now, 1e-3))
                sock = socket.create_connection(self.peers[peer],
                                                timeout=budget)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                self._socks[peer] = sock
            if self._link is not None:
                self._link.before_send(req, 0)
            self.remote_fetch_total += 1
            _send_frame(sock, req)
            resp = _recv_frame(sock, deadline=self._batch_deadline)
            if resp is None:
                raise ConnectionError("graph fetch peer closed connection")
            if self._link is not None:
                self._link.after_recv(req)
        except (ConnectionError, OSError, ValueError):
            self._mark_down(peer)
            self.fetch_error_total += 1
            return None
        err = resp.get("error")
        if err is not None:
            if str(err).startswith("StaleGraphGenerationError"):
                self.stale_generation_total += 1
            else:
                self.fetch_error_total += 1
            return None
        self._down.pop(peer, None)
        return resp

    def _mark_down(self, peer: str) -> None:
        sock = self._socks.pop(peer, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        attempt = self._down.get(peer, (0, 0.0))[0]
        # the next allowed attempt is an instant on the clock, never a sleep
        self._down[peer] = (attempt + 1,
                            self._clock() + self.backoff.delay(attempt))

    # ------------------------------------------------------------- summary
    def stats(self) -> Dict[str, Any]:
        return {
            "peers": len(self.peers),
            "peers_down": len(self._down),
            "generation": self.generation,
            "remote_fetch_total": self.remote_fetch_total,
            "fetched_nodes_total": self.fetched_nodes_total,
            "fetch_deadline_total": self.fetch_deadline_total,
            "fetch_error_total": self.fetch_error_total,
            "budget_exhausted_total": self.budget_exhausted_total,
            "stale_generation_total": self.stale_generation_total,
            "degraded_batches_total": self.degraded_batches_total,
        }
