"""Deterministic fault scheduling and the per-layer injectors.

Port of the JAX package's ``chaos/faults.py``, whole. A :class:`ChaosPlan`
is a set of named :class:`FaultWindow` intervals on the caller's clock (the
drills' virtual clock: the plan never reads time itself; callers pass
``now``). The drill loop calls :meth:`ChaosPlan.poll` once a tick and gets
the ``("begin"|"end", window)`` transitions that became due, each applying
its window's bound injector, so one seed replays one fault timeline.

Each injector wraps one layer's real failure seam of the port:

- :class:`BrokerReplicaOutage`: stops a ``stream/netbroker.py`` replica so
  the primary's next produce shrinks the ISR below ``min_isr`` and fails
  with ``NotEnoughReplicasError``; ``end`` starts a fresh replica and
  ``add_replica``'s backlog sync re-replicates the tail;
- :class:`ConsumerMemberKill`: expires a consumer-group member's session on
  ``stream/kafka_fake.py``'s coordinator (death without LeaveGroup),
  forcing a rebalance onto the survivors;
- :class:`DeviceReplicaDeath`: arms ``scoring/device_pool.py
  DevicePool.inject_fault``, so the replica's next result fetches raise
  (the rescue onto a healthy replica); ``end`` revives it;
- :class:`SlowDevice`: arms ``DevicePool.inject_slow``: a delayed replica,
  not a dead one (FIFO completion must hold while it lags);
- :class:`WorkerKill`: kills a ``cluster/fleet.py WorkerFleet`` worker with
  process-death semantics (handoff recovers it);
- :class:`LabelStall`: a gate the feedback plane's label-release loop
  consults; while active the label stream is withheld.

The plan keeps a bounded event ledger and a ``snapshot`` in the shape
``MetricsCollector.sync_chaos`` reads (the ``chaos_*`` family); the chaos
drill (``chaos/drill.py``) composes the injectors on one timeline.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "FaultWindow",
    "ChaosPlan",
    "BrokerReplicaOutage",
    "ConsumerMemberKill",
    "DeviceReplicaDeath",
    "SlowDevice",
    "LabelStall",
    "WorkerKill",
]


@dataclasses.dataclass(frozen=True)
class FaultWindow:
    """One scheduled fault: ``[t_start, t_end)`` on the caller's clock."""

    name: str            # unique within a plan ("broker_outage", ...)
    kind: str            # injector family (for reporting/metrics labels)
    t_start: float
    t_end: float

    def validate(self) -> None:
        if not self.name or not self.kind:
            raise ValueError("fault window needs a name and a kind")
        if not self.t_end > self.t_start:
            raise ValueError(
                f"fault window {self.name!r} needs t_end > t_start, got "
                f"[{self.t_start}, {self.t_end})")


class ChaosPlan:
    """Fault timeline + injector binding + transition ledger."""

    def __init__(self, windows: List[FaultWindow]):
        names = [w.name for w in windows]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate fault window names in {names}")
        for w in windows:
            w.validate()
        self.windows = sorted(windows, key=lambda w: (w.t_start, w.name))
        self._injectors: Dict[str, Any] = {}
        self._begun: set = set()
        self._ended: set = set()
        self.events: List[Dict[str, Any]] = []
        # recovery bookkeeping: window name -> virtual seconds from the
        # window's end to the plane's observed recovery (the drill records
        # it via note_recovered; sync_chaos exposes it as a gauge)
        self.recovery_s: Dict[str, float] = {}

    def bind(self, name: str, injector: Any) -> None:
        """Attach an injector (an object with ``begin(now)``/``end(now)``)
        to a scheduled window. Unbound windows are annotation-only (e.g.
        flash_crowd, whose 'injection' is the arrival schedule itself)."""
        if name not in {w.name for w in self.windows}:
            raise ValueError(f"no fault window named {name!r}")
        self._injectors[name] = injector

    # ---------------------------------------------------------------- state
    def active(self, now: float) -> List[str]:
        """Names of windows covering ``now``, in schedule order."""
        return [w.name for w in self.windows
                if w.t_start <= now < w.t_end]

    def is_active(self, name: str, now: float) -> bool:
        return name in self.active(now)

    # ----------------------------------------------------------- transitions
    def poll(self, now: float) -> List[Tuple[str, FaultWindow]]:
        """Apply every transition due at ``now``; returns them in order.
        ``begin`` fires once when ``now`` reaches ``t_start``; ``end``
        once when it reaches ``t_end`` (a window fully in the past fires
        both, in order — the plan never skips an injector's cleanup)."""
        transitions: List[Tuple[str, FaultWindow]] = []
        for w in self.windows:
            if w.name not in self._begun and now >= w.t_start:
                self._begun.add(w.name)
                transitions.append(("begin", w))
                inj = self._injectors.get(w.name)
                if inj is not None:
                    inj.begin(now)
                self.events.append({"event": "begin", "fault": w.name,
                                    "kind": w.kind, "ts": now})
            if w.name not in self._ended and now >= w.t_end:
                self._ended.add(w.name)
                transitions.append(("end", w))
                inj = self._injectors.get(w.name)
                if inj is not None:
                    inj.end(now)
                self.events.append({"event": "end", "fault": w.name,
                                    "kind": w.kind, "ts": now})
        return transitions

    def note_recovered(self, name: str, now: float) -> None:
        """Record the plane-recovery instant for an ended window (idempotent
        — the first observation wins; recovery is measured from t_end)."""
        w = next((w for w in self.windows if w.name == name), None)
        if w is None or name in self.recovery_s:
            return
        self.recovery_s[name] = max(0.0, now - w.t_end)

    # -------------------------------------------------------------- snapshot
    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """JSON-able state for the drill summary and ``sync_chaos``."""
        return {
            "windows": [{
                "fault": w.name, "kind": w.kind,
                "t_start": w.t_start, "t_end": w.t_end,
                "begun": w.name in self._begun,
                "ended": w.name in self._ended,
                "active": (now is not None
                           and w.t_start <= now < w.t_end),
            } for w in self.windows],
            "events": list(self.events),
            "recovery_s": {k: round(v, 4)
                           for k, v in sorted(self.recovery_s.items())},
        }


# ---------------------------------------------------------------------------
# injectors
# ---------------------------------------------------------------------------


class BrokerReplicaOutage:
    """Kill a netbroker replica; restore by attaching a fresh one.

    ``replica_factory`` returns a started, read-only ``BrokerServer``
    (role="replica"); on ``end`` the primary's ``add_replica`` backlog
    sync catches the newcomer up and — once the ISR is back at
    ``min_isr`` — re-exposes any tail produced (unacked) during the
    outage. The produce failures in between are the REAL
    ``NotEnoughReplicasError`` path, not a simulation of it.
    """

    def __init__(self, primary, replica,
                 replica_factory: Callable[[], Any]):
        self.primary = primary
        self.replica = replica
        self.replica_factory = replica_factory
        self.restored_replica = None
        self.outages = 0

    def begin(self, now: float) -> None:
        self.outages += 1
        self.replica.stop()

    def end(self, now: float) -> None:
        self.restored_replica = self.replica_factory()
        self.primary.add_replica("127.0.0.1", self.restored_replica.port)


class ConsumerMemberKill:
    """Expire one consumer-group member's session on the fake Kafka
    coordinator — process death without a LeaveGroup. One-shot: ``end``
    is a no-op (the group heals by rebalancing, not by resurrection)."""

    def __init__(self, server, group_id: str, member_id: str):
        self.server = server
        self.group_id = group_id
        self.member_id = member_id
        self.killed = 0

    def begin(self, now: float) -> None:
        self.server.kill_member(self.group_id, self.member_id)
        self.killed += 1

    def end(self, now: float) -> None:
        return None


class DeviceReplicaDeath:
    """Arm a pool replica to fail its next ``n_faults`` result fetches
    mid-flight (the rescue-onto-healthy-replica path); revive on end."""

    def __init__(self, pool, replica_idx: int, n_faults: int = 1):
        self.pool = pool
        self.replica_idx = int(replica_idx)
        self.n_faults = max(1, int(n_faults))

    def begin(self, now: float) -> None:
        self.pool.inject_fault(self.replica_idx, self.n_faults)

    def end(self, now: float) -> None:
        self.pool.revive(self.replica_idx)


class SlowDevice:
    """Arm a pool replica to DELAY its next ``n`` result fetches — the
    degraded-but-alive failure mode (no retry, no health change; FIFO
    completion across the pool is the property under test)."""

    def __init__(self, pool, replica_idx: int, delay_s: float, n: int = 1):
        self.pool = pool
        self.replica_idx = int(replica_idx)
        self.delay_s = float(delay_s)
        self.n = max(1, int(n))

    def begin(self, now: float) -> None:
        self.pool.inject_slow(self.replica_idx, self.delay_s, self.n)

    def end(self, now: float) -> None:
        return None


class WorkerKill:
    """Kill a partition-parallel fleet worker with process-death
    semantics: live state and in-flight batches are gone, no graceful
    flush — the fleet's checkpointed-handoff path (snapshot restore +
    committed-gap state replay on the survivors) is what recovers.
    One-shot like :class:`ConsumerMemberKill`: ``end`` is a no-op; the
    fleet heals by rebalancing, not by resurrection.

    ``target`` is anything with ``kill_worker(worker_id, now=...)``:

    - ``cluster.fleet.WorkerFleet`` — the in-process fleet (shard-drill):
      a SIMULATED death (the thread's state is dropped cooperatively);
    - ``cluster.procfleet.ProcessFleet``, the process fleet (elastic-
      drill), takes the same injector and sends a real ``SIGKILL``;
    - or a stub in tests.

    ``last_result`` keeps the target's kill report (returncode, replay
    depth) for the drill's verdict."""

    def __init__(self, target: Any, worker_id: str):
        self.target = target
        self.worker_id = worker_id
        self.killed = 0
        self.last_result: Optional[Dict[str, Any]] = None

    def begin(self, now: float) -> None:
        self.last_result = self.target.kill_worker(self.worker_id, now=now)
        self.killed += 1

    def end(self, now: float) -> None:
        return None


class LabelStall:
    """Gate the label stream: while active, the drill's label-release loop
    withholds due labels; on end they flood in as one out-of-order burst
    (the label join's watermark discipline must absorb it)."""

    def __init__(self) -> None:
        self.active = False
        self.stalls = 0

    def begin(self, now: float) -> None:
        self.active = True
        self.stalls += 1

    def end(self, now: float) -> None:
        self.active = False
