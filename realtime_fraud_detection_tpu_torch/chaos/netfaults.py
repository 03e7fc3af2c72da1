"""Deterministic in-path link faults for the framing transports.

Port of the JAX package's ``chaos/netfaults.py``. The chaos plane
(chaos/faults.py) kills *things*: replicas, members, devices, processes.
This module degrades the *network* the process fleet (cluster/procfleet.py)
lives on: named links keyed by ``(role, peer)``
sit in the request path of the netbroker framing clients
(``stream/netbroker.NetBrokerClient``, ``cluster/handoff.HandoffClient``)
and inject, per frame:

- **added latency** (fixed + seeded jitter) and **slow-link throttling**
  (bytes/s — the delay scales with the frame size);
- **bounded drop-then-reconnect** (the next N matched sends fail with a
  connection reset, exercising the client's REAL reconnect machinery —
  bounded, so the link heals by itself);
- **partitions** — ``full`` (requests never reach the peer: refused at
  send) and ``one_way`` (the request reaches the peer and is APPLIED, but
  the response is lost: the caller observes a connection error, retries,
  and may duplicate the op — exactly the at-least-once ack-loss window of
  a real asymmetric partition).

Faults can be scoped with a ``match`` spec (``{"ops": [...], "topics":
[...]}``): a partition matched to the cluster control/events topics is the
drill's **asymmetric partition** — the worker is deaf to the coordinator
while its data path still reaches the broker (the zombie-writer scenario
the broker's producer generation fencing exists for; see
``stream/netbroker.py``).

Everything is driven from :class:`~realtime_fraud_detection_tpu_torch.chaos.
faults.ChaosPlan` windows on the caller's clock — the link layer never
reads time itself (the poll clock and the sleep seam are injected), so a
seeded drill replays the identical fault timeline. The injectors
:class:`NetworkPartition` and :class:`LinkDegrade` are exported beside
the fault injectors of ``chaos/faults.py`` in ``chaos/__init__.py``.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np

from realtime_fraud_detection_tpu_torch.chaos.faults import ChaosPlan, FaultWindow

__all__ = [
    "LinkState",
    "LinkFaultPlane",
    "NetworkPartition",
    "LinkDegrade",
    "ScheduledLink",
    "scheduled_link_from_spec",
]


def _match_frame(match: Optional[Mapping[str, Any]],
                 req: Mapping[str, Any]) -> bool:
    """Does a request frame fall under a fault's ``match`` spec?

    ``None`` matches everything. ``{"ops": [...]}`` restricts by wire op;
    ``{"topics": [...]}`` by the frame's topic (``topic`` or ``name``
    field — ``create_topic`` frames carry ``name``). Both given = AND."""
    if match is None:
        return True
    ops = match.get("ops") or ()
    if ops and req.get("op") not in ops:
        return False
    topics = match.get("topics") or ()
    if topics:
        topic = req.get("topic", req.get("name"))
        if topic not in topics:
            return False
    return True


class LinkState:
    """One named link's live fault state + counters.

    The framing clients call :meth:`before_send` under their connection
    lock and :meth:`after_recv` once a response frame arrived; both are
    cheap no-ops while no fault is armed. Thread-safe: a link is shared
    by every consumer of one client connection."""

    def __init__(self, role: str, peer: str,
                 sleep: Optional[Callable[[float], None]] = None,
                 seed: int = 0):
        self.role = str(role)
        self.peer = str(peer)
        self.name = f"{self.role}->{self.peer}"
        self._sleep = sleep if sleep is not None else time.sleep
        self._lock = threading.Lock()
        # jitter is a seeded per-link stream: replayable, de-correlated
        # across links by the (role, peer) identity mixed into the seed
        # (crc32, not hash() — str hashing is salted per process, and the
        # schedule must replay identically inside a fresh worker process)
        self._rng = np.random.default_rng(
            (int(seed) * 1_000_003
             + zlib.crc32(self.name.encode())) % (2**32))
        # live fault state
        self.partition_mode: Optional[str] = None    # "full" | "one_way"
        self._partition_match: Optional[Dict[str, Any]] = None
        self.latency_s = 0.0
        self.jitter_s = 0.0
        self.throttle_bytes_per_s = 0.0
        self.drop_remaining = 0
        self._degrade_match: Optional[Dict[str, Any]] = None
        # counters (cumulative — mirrored by sync_netfaults as deltas)
        self.windows_begun = 0
        self.delayed_sends = 0
        self.dropped_sends = 0
        self.partitioned_sends = 0
        self.lost_responses = 0
        self.throttled_bytes = 0

    # ------------------------------------------------------------- arming
    def set_partition(self, mode: str,
                      match: Optional[Mapping[str, Any]] = None) -> None:
        if mode not in ("full", "one_way"):
            raise ValueError(f"partition mode must be full|one_way, "
                             f"got {mode!r}")
        with self._lock:
            self.partition_mode = mode
            self._partition_match = dict(match) if match else None
            self.windows_begun += 1

    def clear_partition(self) -> None:
        with self._lock:
            self.partition_mode = None
            self._partition_match = None

    def set_degrade(self, latency_s: float = 0.0, jitter_s: float = 0.0,
                    throttle_bytes_per_s: float = 0.0, drop_next: int = 0,
                    match: Optional[Mapping[str, Any]] = None) -> None:
        if latency_s < 0 or jitter_s < 0 or throttle_bytes_per_s < 0 \
                or drop_next < 0:
            raise ValueError("degrade parameters must be >= 0")
        with self._lock:
            self.latency_s = float(latency_s)
            self.jitter_s = float(jitter_s)
            self.throttle_bytes_per_s = float(throttle_bytes_per_s)
            self.drop_remaining = int(drop_next)
            self._degrade_match = dict(match) if match else None
            self.windows_begun += 1

    def clear_degrade(self) -> None:
        with self._lock:
            self.latency_s = self.jitter_s = 0.0
            self.throttle_bytes_per_s = 0.0
            self.drop_remaining = 0
            self._degrade_match = None

    def active(self) -> bool:
        return (self.partition_mode is not None or self.latency_s > 0
                or self.throttle_bytes_per_s > 0 or self.drop_remaining > 0)

    # ----------------------------------------------------------- the path
    def before_send(self, req: Mapping[str, Any], nbytes: int = 0) -> None:
        """In-path hook BEFORE a frame is written. May sleep (latency /
        throttle) or raise ``ConnectionResetError`` (full partition /
        bounded drop) — the client's normal reconnect+retry machinery
        handles the error exactly as it would a real network fault."""
        delay = 0.0
        with self._lock:
            if self.partition_mode == "full" \
                    and _match_frame(self._partition_match, req):
                self.partitioned_sends += 1
                raise ConnectionResetError(
                    f"chaos: link {self.name} partitioned (full)")
            if _match_frame(self._degrade_match, req):
                if self.drop_remaining > 0:
                    self.drop_remaining -= 1
                    self.dropped_sends += 1
                    raise ConnectionResetError(
                        f"chaos: link {self.name} dropped frame "
                        f"({self.drop_remaining} drops remaining)")
                if self.latency_s > 0 or self.jitter_s > 0:
                    delay += self.latency_s
                    if self.jitter_s > 0:
                        delay += float(self._rng.random()) * self.jitter_s
                    self.delayed_sends += 1
                if self.throttle_bytes_per_s > 0 and nbytes > 0:
                    delay += nbytes / self.throttle_bytes_per_s
                    self.throttled_bytes += int(nbytes)
        if delay > 0:
            self._sleep(delay)

    def after_recv(self, req: Mapping[str, Any]) -> None:
        """In-path hook AFTER a response frame arrived. A one-way
        partition loses the RESPONSE: the peer applied the op, but the
        caller observes a connection error — a retry may duplicate the op
        (the at-least-once ack-loss window, dedup'd downstream)."""
        with self._lock:
            if self.partition_mode == "one_way" \
                    and _match_frame(self._partition_match, req):
                self.lost_responses += 1
                raise ConnectionError(
                    f"chaos: link {self.name} partitioned (one_way) — "
                    f"response lost")

    # ------------------------------------------------------------ snapshot
    def snapshot_entry(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "active": self.active(),
                "partition_mode": self.partition_mode,
                "windows_begun": self.windows_begun,
                "delayed_sends_total": self.delayed_sends,
                "dropped_sends_total": self.dropped_sends,
                "partitioned_sends_total": self.partitioned_sends,
                "lost_responses_total": self.lost_responses,
                "throttled_bytes_total": self.throttled_bytes,
            }


class LinkFaultPlane:
    """Registry of named links keyed by ``(role, peer)``.

    One plane per process; drills hand each framing client the link for
    its role, bind :class:`NetworkPartition` / :class:`LinkDegrade`
    injectors to :class:`ChaosPlan` windows against those links, and
    mirror :meth:`snapshot` through ``MetricsCollector.sync_netfaults``
    (optionally merged with the broker's fencing counters)."""

    def __init__(self, sleep: Optional[Callable[[float], None]] = None,
                 seed: int = 0):
        self._sleep = sleep
        self._seed = int(seed)
        self._links: Dict[tuple, LinkState] = {}
        self._lock = threading.Lock()

    def link(self, role: str, peer: str) -> LinkState:
        key = (str(role), str(peer))
        with self._lock:
            st = self._links.get(key)
            if st is None:
                st = LinkState(role, peer, sleep=self._sleep,
                               seed=self._seed)
                self._links[key] = st
            return st

    def links(self) -> List[LinkState]:
        with self._lock:
            return list(self._links.values())

    def snapshot(self, fencing: Optional[Mapping[str, Any]] = None,
                 ) -> Dict[str, Any]:
        """JSON-able state shaped for ``sync_netfaults``. ``fencing`` is
        an optional broker fence-counter block (``NetBrokerClient.
        status()`` / ``InMemoryBroker.producer_fence_stats()``)."""
        snap: Dict[str, Any] = {
            "links": {st.name: st.snapshot_entry()
                      for st in sorted(self.links(),
                                       key=lambda s: s.name)},
        }
        if fencing is not None:
            snap["fencing"] = {
                "fenced_produces_total":
                    int(fencing.get("fenced_produces", 0)),
                "fenced_commits_total":
                    int(fencing.get("fenced_commits", 0)),
            }
        return snap


# ---------------------------------------------------------------------------
# injectors (exported beside chaos/faults.py's in chaos/__init__.py)
# ---------------------------------------------------------------------------


class NetworkPartition:
    """Partition one or more links for the window.

    ``mode="full"`` — matched requests are refused at send (they never
    reach the peer); ``mode="one_way"`` — matched requests REACH the peer
    and are applied, but the responses are lost (ack-loss: a retrying
    producer duplicates, the documented at-least-once window). ``match``
    scopes the partition to an op/topic subset — a control-plane-only
    match is the asymmetric "deaf to the coordinator, data still flows"
    scenario."""

    def __init__(self, links: Sequence[LinkState], mode: str = "full",
                 match: Optional[Mapping[str, Any]] = None):
        if not links:
            raise ValueError("NetworkPartition needs >= 1 link")
        self.links = list(links)
        self.mode = mode
        self.match = dict(match) if match else None
        self.partitions = 0

    def begin(self, now: float) -> None:
        self.partitions += 1
        for link in self.links:
            link.set_partition(self.mode, self.match)

    def end(self, now: float) -> None:
        for link in self.links:
            link.clear_partition()


class LinkDegrade:
    """Degrade (never sever) one or more links for the window: added
    latency (+ seeded jitter), slow-link throttling (bytes/s), and/or a
    bounded run of dropped sends (drop-then-reconnect: the client's real
    reconnect path runs, then the link heals)."""

    def __init__(self, links: Sequence[LinkState], latency_s: float = 0.0,
                 jitter_s: float = 0.0, throttle_bytes_per_s: float = 0.0,
                 drop_next: int = 0,
                 match: Optional[Mapping[str, Any]] = None):
        if not links:
            raise ValueError("LinkDegrade needs >= 1 link")
        if latency_s <= 0 and jitter_s <= 0 and throttle_bytes_per_s <= 0 \
                and drop_next <= 0:
            raise ValueError("LinkDegrade needs at least one effect")
        self.links = list(links)
        self.latency_s = float(latency_s)
        self.jitter_s = float(jitter_s)
        self.throttle_bytes_per_s = float(throttle_bytes_per_s)
        self.drop_next = int(drop_next)
        self.match = dict(match) if match else None
        self.degrades = 0

    def begin(self, now: float) -> None:
        self.degrades += 1
        for link in self.links:
            link.set_degrade(latency_s=self.latency_s,
                             jitter_s=self.jitter_s,
                             throttle_bytes_per_s=self.throttle_bytes_per_s,
                             drop_next=self.drop_next, match=self.match)

    def end(self, now: float) -> None:
        for link in self.links:
            link.clear_degrade()


# ---------------------------------------------------------------------------
# schedule-driven link (the worker-process form)
# ---------------------------------------------------------------------------


class ScheduledLink:
    """A link whose fault windows advance on every frame.

    Worker processes cannot be reached by the drill coordinator once
    partitioned — so the schedule rides INTO the process (the worker
    spec) and the link polls its own :class:`ChaosPlan` on the injected
    clock before every frame. Until the clock has a base (the drill
    coordinator announces the shared epoch over the control topic before
    any window opens), the plan never begins."""

    def __init__(self, state: LinkState, plan: ChaosPlan,
                 clock: Callable[[], float]):
        self.state = state
        self.plan = plan
        self.clock = clock

    def _poll(self) -> None:
        now = self.clock()
        if now == now and now > float("-inf"):    # NaN/-inf = no epoch yet
            self.plan.poll(now)

    def before_send(self, req: Mapping[str, Any], nbytes: int = 0) -> None:
        self._poll()
        self.state.before_send(req, nbytes)

    def after_recv(self, req: Mapping[str, Any]) -> None:
        self._poll()
        self.state.after_recv(req)


def scheduled_link_from_spec(windows: Sequence[Mapping[str, Any]],
                             role: str, peer: str,
                             clock: Callable[[], float],
                             sleep: Optional[Callable[[float], None]] = None,
                             seed: int = 0) -> ScheduledLink:
    """Build a :class:`ScheduledLink` from JSON-able window dicts (the
    worker-spec wire form). Each window::

        {"name": ..., "kind": "partition"|"degrade",
         "t_start": ..., "t_end": ...,
         # partition: "mode" ("full"|"one_way"), optional "match"
         # degrade: "latency_s"/"jitter_s"/"throttle_bytes_per_s"/
         #          "drop_next", optional "match"
        }
    """
    state = LinkState(role, peer, sleep=sleep, seed=seed)
    fws = [FaultWindow(str(w["name"]), str(w["kind"]),
                       float(w["t_start"]), float(w["t_end"]))
           for w in windows]
    plan = ChaosPlan(fws)
    for w in windows:
        kind = str(w["kind"])
        if kind == "partition":
            inj: Any = NetworkPartition(
                [state], mode=str(w.get("mode", "full")),
                match=w.get("match"))
        elif kind == "degrade":
            inj = LinkDegrade(
                [state], latency_s=float(w.get("latency_s", 0.0)),
                jitter_s=float(w.get("jitter_s", 0.0)),
                throttle_bytes_per_s=float(
                    w.get("throttle_bytes_per_s", 0.0)),
                drop_next=int(w.get("drop_next", 0)),
                match=w.get("match"))
        else:
            raise ValueError(f"unknown netfault window kind {kind!r}")
        plan.bind(str(w["name"]), inj)
    return ScheduledLink(state, plan, clock)
