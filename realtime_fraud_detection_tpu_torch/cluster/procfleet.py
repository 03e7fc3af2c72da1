"""The worker fleet across the process boundary: real OS processes,
autoscaled, surviving a real SIGKILL.

Port of the JAX package's ``cluster/procfleet.py``. ``cluster/fleet.py
WorkerFleet`` runs its workers as threads; here every seam that was already
network-shaped crosses a process:

- **workers are spawned subprocesses** (``python -m
  realtime_fraud_detection_tpu_torch cluster-worker``), one consumer group
  over the TCP netbroker (``stream/netbroker.py``), each running its
  partition-scoped ``StreamJob`` against its own ``PartitionedStore`` slice
  (the ``ClusterWorker`` core, unchanged);
- **handoff is network-served** (``cluster/handoff.py``): checkpoint blobs
  survive any worker's death, sha256-verified and epoch-fenced;
- **membership is coordinated over the broker itself**: one control topic
  (coordinator to workers) and one events topic (workers to coordinator),
  so the broker's ordering is the protocol's ordering;
- **rebalances are two-phase**: releasers checkpoint, stop consuming the
  moved partitions and ack before the coordinator fences those partitions
  at the new generation and the acquirers restore and replay, so an
  acquirer never restores while a releaser still has a batch in flight;
  partitions that do not move never stop;
- **death is found by reaping**: a SIGKILLed worker is a dead pid whose
  partitions are fenced and re-acquired from its last network checkpoint
  plus the committed-gap replay (what ``elastic-drill`` proves); a worker
  whose heartbeats go silent past the session timeout is evicted and
  rejoins as a fresh member;
- **elasticity**: an ``AutoscaleController`` target (``cluster/
  autoscale.py``) is executed as a spawn (restore and replay) or a graceful
  drain (final checkpoint and commit before exit), and consistent-hash
  placement keeps each rebalance to about K/N keys.

A worker scores with the shard drill's ``ShardScorer`` (``cluster/
drill.py``), a host stand-in with event-time state updates and an optional
wall-time cost model in place of device compute. A worker never touches
``torch.cuda``: the fleet runs on the card's host and leaves the card to
the scoring process. With ``fetch`` in its spec a worker serves its local
graph view (``graph/fetch.py GraphFetchServer``, announced as a
``fetch_addr`` event) and, once the coordinator broadcasts the ``peers``
map, resolves remote neighbour shares each batch with a
``GraphFetchClient``, recording a ``remote_fetch`` child span on the
batch's trace.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

from realtime_fraud_detection_tpu_torch.cluster.handoff import HandoffClient
from realtime_fraud_detection_tpu_torch.cluster.hashring import HashRing
from realtime_fraud_detection_tpu_torch.stream import topics as T

__all__ = ["ProcessFleet", "worker_main", "CONTROL_TOPIC", "EVENTS_TOPIC",
           "DIGEST_NOW"]

CONTROL_TOPIC = "cluster-control"
EVENTS_TOPIC = "cluster-events"

# the fixed "now" every state digest is computed at (workers at shutdown,
# the drill's oracle in-process): state TTLs are configured far beyond it,
# so the digest is a pure content hash on any clock base
DIGEST_NOW = 1.0e9


def _wall() -> float:
    # the process plane is genuinely wall-clock: real OS processes over real TCP
    # rtfd-lint: allow[wall-clock] the process plane is genuinely wall-clock: real OS processes over real TCP
    return time.time()


def _mono() -> float:
    # coordinator timeouts/pacing are wall-bound by definition
    # rtfd-lint: allow[wall-clock] coordinator timeouts/pacing are wall-bound by definition
    return time.monotonic()


# ---------------------------------------------------------------------------
# coordinator
# ---------------------------------------------------------------------------


class ProcessFleet:
    """Coordinator for a fleet of ``cluster-worker`` subprocesses.

    Owns membership (the consistent-hash ring), the two-phase rebalance
    protocol over the control/events topics, death detection (process
    reaping), and autoscale-target execution. The coordinator holds NO
    scoring state — the broker log, the handoff server, and the workers'
    own stores are the only state planes, which is what makes a worker's
    SIGKILL recoverable and the coordinator restartable.
    """

    def __init__(self, broker_addr: str, handoff_addr: str,
                 n_partitions: int = 12, group_id: str = "fraud-cluster",
                 topic: str = T.TRANSACTIONS, virtual_nodes: int = 256,
                 worker_spec: Optional[Dict[str, Any]] = None,
                 python: str = sys.executable,
                 ack_timeout_s: float = 90.0,
                 spawn_env: Optional[Dict[str, str]] = None,
                 session_timeout_s: float = 30.0,
                 per_worker_spec: Optional[Dict[str, Dict[str, Any]]] = None):
        from realtime_fraud_detection_tpu_torch.stream.netbroker import (
            NetBrokerClient,
        )

        self.broker_addr = broker_addr
        self.handoff_addr = handoff_addr
        self.n_partitions = int(n_partitions)
        self.group_id = group_id
        self.topic = topic
        self.python = python
        self.ack_timeout_s = float(ack_timeout_s)
        self.spawn_env = spawn_env
        from realtime_fraud_detection_tpu_torch.obs.fleetmetrics import (
            FleetMetrics,
            FleetTraceStore,
        )

        bh, _, bp = broker_addr.rpartition(":")
        self.client = NetBrokerClient(host=bh or "127.0.0.1", port=int(bp))
        hh, _, hp = handoff_addr.rpartition(":")
        self.handoff = HandoffClient(host=hh or "127.0.0.1", port=int(hp))
        # fleet observability plane (obs/fleetmetrics.py): workers stream
        # counter-delta ``metrics`` events (seq-deduped) into one honest
        # aggregation, and their bye frames ship flight-recorder rings the
        # coordinator stitches into fleet-level critical-path analysis
        self.fleet_metrics = FleetMetrics()
        self.fleet_traces = FleetTraceStore()
        self.client.create_topic(CONTROL_TOPIC, 1)
        self.client.create_topic(EVENTS_TOPIC, 1)
        self._ev_pos = 0
        self.ring = HashRing([], virtual_nodes=virtual_nodes)
        self.generation = 0
        self.worker_spec = dict(worker_spec or {})
        # worker id -> "host:port" of its graph-fetch server (``fetch_addr``
        # events); broadcast_peers hands the map to every worker
        self.fetch_addrs: Dict[str, str] = {}
        # per-worker overlays on top of worker_spec (keyed by worker id):
        # the partition drill stamps each target's scheduled link-fault
        # windows + phase windows into exactly that worker's spec
        self.per_worker_spec = {k: dict(v)
                                for k, v in (per_worker_spec or {}).items()}
        # wid -> {"proc", "pid", "alive", "ready", "summary"}
        self.workers: Dict[str, Dict[str, Any]] = {}
        self._next_idx = 0
        self._acks: Dict[tuple, Dict[str, Any]] = {}
        self._byes: Dict[str, Dict[str, Any]] = {}
        self._last_assignment: Dict[str, List[int]] = {}
        self._pending_deaths: List[str] = []
        self._pending_rejoins: List[str] = []
        self._pending_evictions: List[str] = []
        self._in_rebalance = False
        self.events: List[Dict[str, Any]] = []
        self.kills = 0
        self.spawns = 0
        self.evictions = 0
        self.rejoins = 0
        self.handoffs_total = 0
        self.replayed_total = 0
        self.last_replay_depth = 0
        self.rebalance_pauses_s: List[float] = []
        # liveness: a worker whose heartbeats (or any event) go silent
        # past session_timeout_s is EVICTED from the ring — its process
        # may be alive but deaf (the asymmetric-partition zombie); its
        # partitions are fenced + reassigned, and when it can reach the
        # control plane again it rejoins as a fresh member (hello).
        # This is the Kafka session-expiry analog on the broker-carried
        # membership plane; process reaping stays the fast path for
        # actual deaths.
        self.session_timeout_s = float(session_timeout_s)

    # ------------------------------------------------------------ membership
    def alive_ids(self) -> List[str]:
        return sorted(w for w, st in self.workers.items() if st["alive"])

    def ready_ids(self) -> List[str]:
        # an evicted worker is alive-but-deaf: never expected to ack,
        # never counted toward the serving fleet until it rejoins
        return sorted(w for w, st in self.workers.items()
                      if st["alive"] and st["ready"]
                      and not st.get("evicted"))

    def assignment(self) -> Dict[str, List[int]]:
        if not self.ring.members():
            return {}
        return self.ring.assignment(self.n_partitions)

    def spawn_worker(self, wid: Optional[str] = None) -> str:
        wid = wid or f"w{self._next_idx}"
        self._next_idx = max(self._next_idx,
                             int(wid[1:]) + 1 if wid[1:].isdigit() else 0)
        spec = dict(self.worker_spec)
        spec.update(self.per_worker_spec.get(wid, {}))
        spec.update(broker=self.broker_addr, handoff=self.handoff_addr,
                    worker_id=wid, group_id=self.group_id,
                    topic=self.topic, n_partitions=self.n_partitions)
        # a worker scores on the host: the card is hidden from it, so no
        # worker opens a CUDA context beside the scoring process's
        env = dict(self.spawn_env if self.spawn_env is not None
                   else os.environ)
        env["CUDA_VISIBLE_DEVICES"] = ""
        proc = subprocess.Popen(
            [self.python, "-m", "realtime_fraud_detection_tpu_torch",
             "cluster-worker", "--spec", json.dumps(spec)],
            env=env)
        self.workers[wid] = {"proc": proc, "pid": proc.pid, "alive": True,
                             "ready": False, "summary": None,
                             "joined_gen": None, "evicted": False,
                             "last_hb": _mono()}
        self.spawns += 1
        return wid

    def _join_ring(self, wid: str) -> None:
        """Admit a worker to the ring, stamping the generation it joined
        at (the chaos plane's ``busiest`` kill targets the most SENIOR
        cohort — a freshly-joined worker's checkpoints are seconds old,
        and a kill that moves no state proves nothing)."""
        self.ring.add(wid)
        if self.workers[wid]["joined_gen"] is None:
            self.workers[wid]["joined_gen"] = self.generation

    def start(self, n_workers: int,
              now: Optional[float] = None) -> List[str]:
        """Spawn the initial fleet and run the first rebalance once every
        worker has said hello."""
        ids = [self.spawn_worker() for _ in range(n_workers)]
        self.wait_ready(ids)
        for wid in ids:
            self._join_ring(wid)
        self._rebalance(reason="start", now=now)
        return ids

    def wait_ready(self, ids: Sequence[str],
                   timeout_s: Optional[float] = None) -> None:
        deadline = _mono() + (timeout_s or self.ack_timeout_s)
        while not all(self.workers[w]["ready"] for w in ids):
            self.poll_events()
            self._note_deaths()
            for w in ids:
                if not self.workers[w]["alive"]:
                    raise RuntimeError(f"worker {w} died before ready")
            if _mono() > deadline:
                raise RuntimeError(
                    f"workers not ready in time: "
                    f"{[w for w in ids if not self.workers[w]['ready']]}")
            time.sleep(0.02)

    # --------------------------------------------------------------- events
    def poll_events(self) -> None:
        recs = self.client.read(EVENTS_TOPIC, 0, self._ev_pos, 256)
        for r in recs:
            self._ev_pos = r.offset + 1
            ev = r.value if isinstance(r.value, dict) else {}
            kind = ev.get("type")
            wid = str(ev.get("worker", ""))
            st = self.workers.get(wid)
            if st is not None and kind in ("hello", "hb", "ack", "bye",
                                           "metrics", "fetch_addr"):
                # ANY event is proof of life on the control plane
                st["last_hb"] = _mono()
            if kind == "hello" and st is not None:
                st["ready"] = True
                self.fleet_metrics.set_worker_info(
                    wid, pid=ev.get("pid", st.get("pid", "")),
                    version=ev.get("version", ""))
                if st.get("evicted") and st["alive"] \
                        and wid not in self._pending_rejoins:
                    # an evicted worker that can reach the control plane
                    # again rejoins as a FRESH member: queued (never
                    # executed from inside a rebalance's ack wait) and
                    # batched into one rebalance by _process_rejoins
                    self._pending_rejoins.append(wid)
            elif kind == "ack":
                self._acks[(wid, int(ev.get("generation", -1)),
                            str(ev.get("phase", "")))] = ev
            elif kind == "metrics":
                # counter-delta snapshot: seq-deduped, exactly-once fold
                self.fleet_metrics.ingest_delta(ev)
            elif kind == "fetch_addr":
                self.fetch_addrs[wid] = str(ev.get("addr", ""))
            elif kind == "bye":
                self._byes[wid] = ev
                if st is not None:
                    st["summary"] = ev
                ring = ev.get("trace_ring")
                if ring:
                    # the worker's flight recorder, stitched verbatim
                    self.fleet_traces.ingest(
                        wid, ring,
                        pid=int(ev.get("pid", 0) or
                                (st or {}).get("pid", 0) or 0))

    def _publish(self, msg: Dict[str, Any]) -> None:
        self.client.produce(CONTROL_TOPIC, msg, key="ctl")

    def _wait_acks(self, ids: Sequence[str], generation: int,
                   phase: str,
                   now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Collect (worker, generation, phase) acks; a worker that DIES
        while we wait is dropped from the expectation — its partitions
        recover through the death path (queued, run after this
        rebalance), not this rebalance's."""
        deadline = _mono() + self.ack_timeout_s
        pending = set(ids)
        while pending:
            self.poll_events()
            self._note_deaths()
            for wid in list(pending):
                if (wid, generation, phase) in self._acks:
                    pending.discard(wid)
                elif not self.workers[wid]["alive"] \
                        or self.workers[wid].get("evicted"):
                    # dead OR evicted mid-wait: the fence (not this
                    # worker's cooperation) is what protects the moved
                    # partitions — drop it from the expectation
                    pending.discard(wid)
            if not pending:
                break
            # a releaser that goes SILENT while we wait is expired here
            # (mark-only — the ring change + recovery rebalance defer to
            # _recover_evictions), so one deaf worker cannot wedge the
            # whole fleet's rebalance until the ack timeout; the caller's
            # clock rides along so the eviction event keeps its timestamp
            self._expire_sessions(now)
            if _mono() > deadline:
                raise RuntimeError(
                    f"rebalance gen {generation} phase {phase}: no ack "
                    f"from {sorted(pending)}")
            time.sleep(0.02)
        return [self._acks[(w, generation, phase)] for w in ids
                if (w, generation, phase) in self._acks]

    # ------------------------------------------------------------ rebalance
    def _rebalance(self, reason: str,
                   now: Optional[float] = None) -> Dict[str, Any]:
        """Two-phase move to the ring's current assignment. Release phase
        only targets workers that actually lose partitions; moved
        partitions are fenced at the NEW generation between the phases so
        a zombie writer (a releaser that never saw the message) cannot
        overwrite an inheritor's checkpoint."""
        t0 = _mono()
        self._in_rebalance = True
        try:
            owner_old = {p: w
                         for w, ps in self._last_assignment.items()
                         for p in ps}
            self.generation += 1
            gen = self.generation
            new_assign = self.assignment()
            owner_new = {p: w for w, ps in new_assign.items() for p in ps}
            moved = sorted(p for p, w in owner_new.items()
                           if owner_old and owner_old.get(p) != w)
            releasers = sorted({owner_old[p] for p in moved
                                if owner_old.get(p) in self.workers
                                and self.workers[owner_old[p]]["alive"]
                                and not self.workers[
                                    owner_old[p]].get("evicted")})
            wire_assign = {w: sorted(ps) for w, ps in new_assign.items()}
            if releasers:
                self._publish({"type": "assign", "generation": gen,
                               "phase": "release",
                               "assignment": wire_assign})
                self._wait_acks(releasers, gen, "release", now=now)
            for p in moved:
                self.handoff.fence(p, gen)
            if moved:
                # the WRITE-seam half of the fence step: a releaser that
                # never saw (or never acked) the release — the asymmetric
                # -partition zombie — has its stamped produces AND offset
                # commits refused by the broker from this instant
                # (StaleGenerationError), for the moved transaction
                # partitions and their index-aligned prediction
                # partitions (both topics partition by the same crc32
                # user key, so partition p of one IS partition p of the
                # other; the alerts fan-out rides the same refusal
                # because predictions produce first in _finish_batch).
                self.client.fence_producers(self.topic, moved, gen)
                self.client.fence_producers(T.PREDICTIONS, moved, gen)
            self._publish({"type": "assign", "generation": gen,
                           "phase": "acquire", "assignment": wire_assign})
            acks = self._wait_acks(self.ready_ids(), gen, "acquire",
                                   now=now)
            replayed = sum(int(a.get("replayed", 0)) for a in acks)
            acquired = sum(int(a.get("acquired", 0)) for a in acks)
            pause = round(_mono() - t0, 4)
            self.rebalance_pauses_s.append(pause)
            self.handoffs_total += acquired
            self.replayed_total += replayed
            self.last_replay_depth = replayed
            self._last_assignment = wire_assign
            event = {"event": "rebalance", "reason": reason,
                     "generation": gen, "t": now,
                     "members": self.ring.members(),
                     "moved": moved, "moved_count": len(moved),
                     "replayed": replayed, "assignment": wire_assign,
                     "pause_s": pause}
            self.events.append(event)
        finally:
            self._in_rebalance = False
        return event

    # ------------------------------------------------ session expiry/rejoin
    def _expire_sessions(self, now: Optional[float]) -> None:
        """Mark ring members whose control plane went silent past
        ``session_timeout_s`` as EVICTED (heartbeats, acks, hellos and
        byes all count as life). Mark-only — safe from inside a
        rebalance's ack wait; the ring removal + recovery rebalance
        happen in :meth:`_recover_evictions` once no rebalance runs. The
        worker process may well be alive (asymmetric partition): its
        partitions are fenced at the new generation, so whatever it
        still produces is refused at the broker, and it rejoins as a
        fresh member when its hello gets through again."""
        for wid, st in self.workers.items():
            if st["alive"] and st["ready"] and not st.get("evicted") \
                    and wid in self.ring.members() \
                    and _mono() - st["last_hb"] > self.session_timeout_s:
                st["evicted"] = True
                self.evictions += 1
                self._pending_evictions.append(wid)
                self.events.append({
                    "event": "session_expired", "worker": wid, "t": now,
                    "silent_s": round(_mono() - st["last_hb"], 3)})

    def _recover_evictions(self, now: Optional[float]) -> None:
        if self._in_rebalance or not self._pending_evictions:
            return
        evicted = [w for w in self._pending_evictions
                   if w in self.ring.members()]
        self._pending_evictions.clear()
        if not evicted:
            return
        for wid in evicted:
            self.ring.remove(wid)
        if not self.ring.members():
            raise RuntimeError("all workers evicted or dead")
        self._rebalance(reason=f"session_timeout:{'+'.join(evicted)}",
                        now=now)

    def _process_rejoins(self, now: Optional[float]) -> None:
        """Admit evicted workers whose hello got through again — batched
        into ONE rebalance, never run from inside another rebalance. A
        rejoiner is a FRESH member: its seniority resets (the busiest-
        senior kill targeting must not treat a rejoin as tenure) and it
        restores every acquired partition from the handoff store exactly
        like a scale-up joiner."""
        if self._in_rebalance or not self._pending_rejoins:
            return
        rejoin = sorted({w for w in self._pending_rejoins
                         if self.workers[w]["alive"]
                         and self.workers[w].get("evicted")})
        self._pending_rejoins.clear()
        if not rejoin:
            return
        for wid in rejoin:
            st = self.workers[wid]
            st["evicted"] = False
            st["joined_gen"] = None     # fresh member, fresh seniority
            self._join_ring(wid)
            self.rejoins += 1
        self._rebalance(reason=f"rejoin:{'+'.join(rejoin)}", now=now)

    # ------------------------------------------------------- death handling
    def _note_deaths(self) -> None:
        """Mark dead worker processes (no recovery yet — safe to call from
        inside a rebalance's ack wait)."""
        for wid, st in self.workers.items():
            if st["alive"] and st["proc"].poll() is not None \
                    and st["summary"] is None:
                st["alive"] = False
                st["returncode"] = st["proc"].returncode
                self._pending_deaths.append(wid)

    def _reap(self, now: Optional[float]) -> List[str]:
        """Detect dead worker processes (SIGKILL, crash) and recover their
        partitions onto the survivors."""
        self._note_deaths()
        dead = list(self._pending_deaths)
        if dead and not self._in_rebalance:
            self._pending_deaths.clear()
            removed = []
            for wid in dead:
                if wid in self.ring.members():
                    self.ring.remove(wid)
                    removed.append(wid)
                    self.events.append({
                        "event": "worker_death", "worker": wid, "t": now,
                        "returncode": self.workers[wid]["returncode"]})
            # a worker that died before ever JOINING the ring (spawn
            # crash) owns nothing: no generation bump, no fleet-wide
            # acquire round, no misleading "death" rebalance event
            if removed:
                if not self.ring.members():
                    raise RuntimeError("all workers dead")
                self._rebalance(reason=f"death:{'+'.join(removed)}",
                                now=now)
        return dead

    def kill_worker(self, worker_id: str,
                    now: Optional[float] = None) -> Dict[str, Any]:
        """REAL process-death semantics: SIGKILL the worker's pid — no
        flush, no final snapshot, the OS reclaims everything — then
        recover through the fence + restore + committed-gap-replay path.
        ``worker_id="busiest"`` resolves to the most-partitions worker of
        the most SENIOR join cohort (deterministic tie-break by id), the
        chaos ``WorkerKill`` escalation target."""
        if worker_id == "busiest":
            # busiest of the most SENIOR cohort (earliest join
            # generation): a long-running worker's cadence checkpoints
            # necessarily lag its committed offsets, so the kill provably
            # exercises the committed-gap replay path — a freshly-joined
            # worker's checkpoints are seconds old (its release-phase
            # inheritance wrote them at exact committed offsets) and a
            # kill there can move state without replaying anything
            assign = self.assignment()
            in_ring = [w for w in self.ready_ids()
                       if w in self.ring.members()]
            if not in_ring:
                return {"killed": False}
            min_gen = min(self.workers[w]["joined_gen"] or 0
                          for w in in_ring)
            candidates = [(len(assign.get(w, ())), w) for w in in_ring
                          if (self.workers[w]["joined_gen"] or 0)
                          == min_gen]
            worker_id = max(candidates, key=lambda c: (c[0], c[1]))[1]
        st = self.workers.get(worker_id)
        if st is None or not st["alive"]:
            return {"killed": False}
        os.kill(st["pid"], signal.SIGKILL)
        st["proc"].wait(timeout=30)
        self.kills += 1
        before = len(self.events)
        self._reap(now)
        replayed = sum(e.get("replayed", 0)
                       for e in self.events[before:]
                       if e.get("event") == "rebalance")
        return {"killed": True, "worker": worker_id,
                "returncode": st["proc"].returncode, "replayed": replayed}

    # ------------------------------------------------------------ elasticity
    def scale_to(self, target: int,
                 now: Optional[float] = None) -> Dict[str, Any]:
        """Execute an autoscale target SYNCHRONOUSLY: spawn+join (restore
        + replay) or graceful drain (final checkpoint + offset commit
        before exit). Blocks until the fleet matches; the elastic drill's
        hot loop uses :meth:`ensure_target` instead so production never
        stalls behind a worker process's startup."""
        target = max(1, int(target))
        added: List[str] = []
        removed: List[str] = []
        alive = self.ready_ids()
        while len(alive) + len(added) < target:
            added.append(self.spawn_worker())
        if added:
            self.wait_ready(added)
            for wid in added:
                self._join_ring(wid)
            self._rebalance(reason=f"scale_up:{'+'.join(added)}", now=now)
        while len(self.ready_ids()) > target:
            victim = self.ready_ids()[-1]
            self.drain_worker(victim, now=now)
            removed.append(victim)
        return {"added": added, "removed": removed}

    def ensure_target(self, target: int,
                      now: Optional[float] = None) -> None:
        """Asynchronous autoscale execution for a hot coordinator loop:
        missing workers are SPAWNED immediately but joined (ring + one
        batched rebalance) only once they say hello — the spawn latency
        (interpreter + imports) is paid while production continues, which
        is exactly what the forecast lead buys. Scale-down waits until no
        joins are pending (a join-drain race would thrash the ring)."""
        target = max(1, int(target))
        in_ring = [w for w in self.ring.members()
                   if self.workers[w]["alive"]]
        pending = [w for w, st in self.workers.items()
                   if st["alive"] and not st.get("evicted")
                   and w not in self.ring.members()]
        for _ in range(target - len(in_ring) - len(pending)):
            pending.append(self.spawn_worker())
        joinable = [w for w in pending if self.workers[w]["ready"]]
        if joinable:
            for wid in joinable:
                self._join_ring(wid)
            self._rebalance(
                reason=f"scale_up:{'+'.join(sorted(joinable))}", now=now)
            pending = [w for w in pending if w not in joinable]
        if not pending:
            while len(self.ready_ids()) > target:
                self.drain_worker(self.ready_ids()[-1], now=now)

    def drain_worker(self, wid: str,
                     now: Optional[float] = None) -> Dict[str, Any]:
        """Graceful scale-down: the victim releases every partition
        (final checkpoint + offset commit) inside the rebalance's release
        phase, then exits on the shutdown message — its successors
        restore with ZERO committed-gap replay."""
        st = self.workers.get(wid)
        if st is None or not st["alive"]:
            return {"drained": False}
        self.ring.remove(wid)
        event = self._rebalance(reason=f"drain:{wid}", now=now)
        self._publish({"type": "shutdown", "worker": wid})
        self._await_bye(wid)
        st["alive"] = False
        self.events.append({"event": "worker_drained", "worker": wid,
                            "t": now})
        return {"drained": True, "rebalance": event}

    def _await_bye(self, wid: str) -> Dict[str, Any]:
        deadline = _mono() + self.ack_timeout_s
        while wid not in self._byes:
            self.poll_events()
            if self.workers[wid]["proc"].poll() is not None \
                    and wid not in self._byes:
                self.poll_events()
                if wid in self._byes:
                    break
                raise RuntimeError(f"worker {wid} exited without bye")
            if _mono() > deadline:
                raise RuntimeError(f"worker {wid} did not say bye")
            time.sleep(0.02)
        self.workers[wid]["proc"].wait(timeout=30)
        return self._byes[wid]

    def wait_fetch_addrs(self, ids: Sequence[str],
                         timeout_s: Optional[float] = None) -> Dict[str, str]:
        """Block until every worker in ``ids`` has published its graph-fetch
        server's address (``fetch_addr`` event)."""
        deadline = _mono() + (timeout_s or self.ack_timeout_s)
        while not all(w in self.fetch_addrs for w in ids):
            self.poll_events()
            self._note_deaths()
            if _mono() > deadline:
                raise RuntimeError(
                    f"no fetch_addr from "
                    f"{[w for w in ids if w not in self.fetch_addrs]}")
            time.sleep(0.02)
        return {w: self.fetch_addrs[w] for w in ids}

    def broadcast_peers(self) -> None:
        """Publish the fleet's graph-fetch peer map over the control topic:
        every worker builds its ``GraphFetchClient`` against every other
        worker's address."""
        self._publish({"type": "peers", "addrs": dict(self.fetch_addrs)})

    def announce_epoch(self, t0: float) -> None:
        """Publish the shared fault-window epoch over the control topic:
        workers anchor their scheduled link faults (and latency phase
        classification) to it, so one wall instant is the whole fleet's
        window t=0 — announced BEFORE any window opens."""
        self._publish({"type": "epoch", "t0": float(t0)})

    def tick(self, now: Optional[float] = None) -> None:
        """One coordinator heartbeat: drain events, reap deaths, expire
        silent sessions, recover evictions, admit rejoins."""
        self.poll_events()
        self._reap(now)
        self._expire_sessions(now)
        self._recover_evictions(now)
        self._process_rejoins(now)

    def all_byes(self) -> Dict[str, Dict[str, Any]]:
        """Every bye ever received — drained workers' final summaries
        included, not just the ones alive at shutdown."""
        return dict(self._byes)

    # ------------------------------------------------------------- shutdown
    def shutdown_all(self, now: Optional[float] = None,
                     ) -> Dict[str, Dict[str, Any]]:
        """Drain-free final stop: every worker final-checkpoints its owned
        partitions, reports digests/counters in its bye, and exits."""
        self._reap(now)
        byes: Dict[str, Dict[str, Any]] = {}
        ids = self.ready_ids()
        for wid in ids:
            self._publish({"type": "shutdown", "worker": wid})
        for wid in ids:
            byes[wid] = self._await_bye(wid)
            self.workers[wid]["alive"] = False
        return byes

    def terminate(self) -> None:
        """Hard cleanup (test teardown): kill anything still running."""
        for st in self.workers.values():
            if st["proc"].poll() is None:
                try:
                    st["proc"].kill()
                except OSError:
                    pass
                st["proc"].wait(timeout=10)
        self.client.close()
        self.handoff.close()

    # -------------------------------------------------------------- summary
    def snapshot(self) -> Dict[str, Any]:
        """JSON-able fleet state shaped like ``WorkerFleet.snapshot()``
        (the ``sync_cluster`` mirror accepts it), plus the process plane's
        own ledgers."""
        assign = self.assignment()
        return {
            "generation": self.generation,
            "workers_alive": len(self.alive_ids()),
            "workers": {
                wid: {"alive": st["alive"], "pid": st["pid"],
                      "evicted": bool(st.get("evicted")),
                      "partitions_owned": len(assign.get(wid, ()))}
                for wid, st in sorted(self.workers.items())
            },
            "handoffs_total": self.handoffs_total,
            "replayed_total": self.replayed_total,
            "last_replay_depth": self.last_replay_depth,
            "kills": self.kills,
            "spawns": self.spawns,
            "evictions": self.evictions,
            "rejoins": self.rejoins,
            "rebalance_pauses_s": list(self.rebalance_pauses_s),
            "events": list(self.events),
        }


# ---------------------------------------------------------------------------
# worker process main
# ---------------------------------------------------------------------------


def worker_main(spec: Dict[str, Any]) -> int:
    """Entry point of one ``cluster-worker`` subprocess.

    Runs the ``ClusterWorker`` core (partition-scoped StreamJob +
    PartitionedStore + checkpointed handoff) over the TCP netbroker and
    the network handoff store, driven by the control topic:

    - ``assign``/release: drain in-flight batches, commit, checkpoint the
      released partitions (still at the OLD epoch — the fence lands
      after the ack), ack;
    - ``assign``/acquire: adopt the new epoch, restore + committed-gap
      replay the acquired partitions, ack with the replay depth;
    - ``shutdown`` (or SIGTERM/SIGINT): graceful drain — complete
      in-flight microbatches, commit offsets, final-checkpoint every
      owned partition, report state digests + counters in the ``bye``
      event, exit 0. SIGKILL gets none of this, by definition — that is
      the failure mode the handoff plane exists for.

    The optional wall-time service-cost model (``base_ms``/``per_txn_ms``)
    stands in for device compute exactly like the in-process drills'
    virtual cost model, paid in real seconds so autoscaling and backlog
    are physically real.
    """
    from realtime_fraud_detection_tpu_torch.cluster.drill import ShardScorer
    from realtime_fraud_detection_tpu_torch.cluster.fleet import ClusterWorker
    from realtime_fraud_detection_tpu_torch.cluster.handoff import (
        FencedEpochError,
    )
    from realtime_fraud_detection_tpu_torch.cluster.partition import (
        PartitionedStore,
    )
    from realtime_fraud_detection_tpu_torch.stream.netbroker import (
        NetBrokerClient,
        StaleGenerationError,
    )
    from realtime_fraud_detection_tpu_torch.utils.backoff import (
        DeterministicBackoff,
        instance_seed,
    )

    wid = str(spec["worker_id"])
    bh, _, bp = str(spec["broker"]).rpartition(":")
    hh, _, hp = str(spec["handoff"]).rpartition(":")
    # optional scheduled link faults (chaos/netfaults.py): the drill
    # stamps this worker's fault windows into the spec; the shared epoch
    # (window t=0) arrives over the control topic before any window
    # opens, so until then the clock reads -inf and the plan never fires
    epoch = {"t0": None}

    def _fault_clock() -> float:
        t0 = epoch["t0"]
        return (_wall() - t0) if t0 is not None else float("-inf")

    link = None
    nf = spec.get("netfaults") or {}
    if nf.get("windows"):
        from realtime_fraud_detection_tpu_torch.chaos.netfaults import (
            scheduled_link_from_spec,
        )

        link = scheduled_link_from_spec(
            nf["windows"], role=f"worker-{wid}", peer="broker",
            clock=_fault_clock, seed=int(nf.get("seed", 0)))
    client = NetBrokerClient(
        host=bh or "127.0.0.1", port=int(bp),
        reconnect_attempts=int(spec.get("reconnect_attempts", 5)),
        link=link)
    handoff = HandoffClient(host=hh or "127.0.0.1", port=int(hp))
    store = PartitionedStore(
        int(spec.get("n_partitions", 12)),
        seq_len=int(spec.get("seq_len", 4)),
        feature_dim=int(spec.get("feature_dim", 4)),
        # TTLs beyond DIGEST_NOW: dedup truth must never lapse between a
        # record's event-time write and a wall-clock replay read
        cache_kwargs={"txn_ttl_s": 1e12, "features_ttl_s": 1e12})
    base_ms = float(spec.get("base_ms", 0.0))
    per_txn_ms = float(spec.get("per_txn_ms", 0.0))
    scorer = ShardScorer(store, base_ms=base_ms, per_txn_ms=per_txn_ms)
    # distributed tracing (obs/tracing.py): spec["tracing"] attaches a
    # WALL-clock tracer stamped with this worker's id as its origin —
    # wall because stitched fleet traces need ONE shared time base
    # across processes (t_start values must align in the merged export)
    tracer = None
    if spec.get("tracing"):
        from realtime_fraud_detection_tpu_torch.obs.tracing import Tracer
        from realtime_fraud_detection_tpu_torch.utils.config import (
            TracingSettings,
        )

        tr_spec = spec["tracing"] if isinstance(spec["tracing"], dict) \
            else {}
        tracer = Tracer(
            TracingSettings(
                enabled=True,
                ring_size=int(tr_spec.get("ring_size", 4096)),
                origin=wid),
            clock=_wall, origin=wid)
    autotune = None
    if spec.get("autotune"):
        from realtime_fraud_detection_tpu_torch.utils.config import TuningSettings

        # a short tuner epoch lets the in-flight-depth dimension actually
        # trial inside a drill-length run, measured against a real
        # overlapped multi-process pipeline
        autotune = TuningSettings(
            enabled=True,
            tune_interval_batches=int(spec.get("autotune_interval", 50)))
    worker = ClusterWorker(
        wid, client, scorer, store, handoff,
        str(spec.get("group_id", "fraud-cluster")),
        topic=str(spec.get("topic", T.TRANSACTIONS)),
        max_batch=int(spec.get("batch", 128)),
        max_delay_ms=float(spec.get("max_delay_ms", 20.0)),
        checkpoint_every=int(spec.get("checkpoint_every", 8)),
        autotune=autotune, tracing=tracer,
        expect_carrier=bool(spec.get("expect_carrier")))
    job = worker.job

    # serve-time cross-partition graph fetch (spec["fetch"]): serve this
    # worker's local graph view to its peers and, once the coordinator
    # broadcasts the peer map, resolve remote neighbour shares each batch;
    # every call records a remote_fetch child span on the batch's trace
    fetch_srv = None
    fetch_client_box: Dict[str, Any] = {"client": None}
    fetch_cfg = spec.get("fetch") if isinstance(spec.get("fetch"), dict) \
        else ({} if spec.get("fetch") else None)
    if fetch_cfg is not None:
        from realtime_fraud_detection_tpu_torch.graph.fetch import (
            GraphFetchServer,
        )

        fetch_srv = GraphFetchServer(
            lambda: store.graph, worker_id=wid,
            host="127.0.0.1", port=0).start()

    def _remote_fetch(ctx, batch) -> None:
        """Resolve remote adjacency for this batch's users, inside the
        client's budget and deadline (local only on any failure)."""
        fc = fetch_client_box["client"]
        if fc is None:
            return
        trace = getattr(ctx, "trace", None) if ctx is not None else None
        fc.begin_batch(trace=trace)
        ids = sorted({str(r.value.get("user_id", ""))
                      for r in batch if isinstance(r.value, dict)})
        ids = [i for i in ids if i][: int(fetch_cfg.get("ids", 16))]
        if ids:
            fc.fetch(str(fetch_cfg.get("edge", "user->device")), ids,
                     fanout=int(fetch_cfg.get("k", 4)))
        fc.end_batch()

    stop = {"reason": None}

    def _on_signal(signum, frame):  # noqa: ANN001 - signal contract
        stop["reason"] = signal.Signals(signum).name

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    # control cursor starts at the topic END: assignments published before
    # this worker existed are history, not instructions
    ctl_pos = client.end_offsets(CONTROL_TOPIC)[0]
    from realtime_fraud_detection_tpu_torch import __version__

    client.produce(EVENTS_TOPIC, {"type": "hello", "worker": wid,
                                  "pid": os.getpid(),
                                  "version": __version__}, key=wid)
    if fetch_srv is not None:
        client.produce(EVENTS_TOPIC, {
            "type": "fetch_addr", "worker": wid,
            "addr": f"127.0.0.1:{fetch_srv.port}"}, key=wid)

    in_flight: deque = deque()        # (ctx, done_at_wall, depth)
    busy_until = 0.0
    # per-depth admitted-latency feedback for the tuning plane (a real
    # overlapped multi-process run feeding the tuner's in-flight-depth
    # dimension); bounded, stride-decimated
    lat_by_depth: Dict[int, List[float]] = {}
    lat_seen = 0
    # per-phase latency (the partition drill's degraded_network story):
    # completions classified against the spec's named windows relative
    # to the shared epoch — the slow-link victim reports its in-window
    # p99 next to its own healthy p99
    phase_windows = {str(k): (float(v[0]), float(v[1]))
                     for k, v in (spec.get("phase_windows") or {}).items()}
    lat_by_phase: Dict[str, List[float]] = {}

    def _phase_of(t_done: float) -> str:
        t0 = epoch["t0"]
        if t0 is not None:
            rel = t_done - t0
            for label, (s, e) in phase_windows.items():
                if s <= rel < e:
                    return label
        return "healthy"

    def _complete(ctx, done_at: float, depth: int) -> None:
        nonlocal lat_seen
        wait = done_at - _wall()
        if wait > 0:
            time.sleep(wait)
        t_done = _wall()
        if ctx is not None:
            job.complete_batch(ctx, now=t_done)
            phase = _phase_of(t_done)
            for r in ctx.fresh:
                lat_seen += 1
                if lat_seen % 4 == 0 or len(ctx.fresh) < 8:
                    bucket = lat_by_depth.setdefault(depth, [])
                    if len(bucket) < 4096 and r.timestamp:
                        bucket.append((t_done - r.timestamp) * 1e3)
                if r.timestamp:
                    pbucket = lat_by_phase.setdefault(phase, [])
                    if len(pbucket) < 65536:
                        pbucket.append((t_done - r.timestamp) * 1e3)
        worker.on_batch_complete()

    def _drain_in_flight() -> None:
        while in_flight:
            _complete(*in_flight.popleft())

    def _drain_pending() -> None:
        """Score + commit everything already consumed (assembler pending
        included) — nothing consumed may be left uncommitted when a
        checkpoint claims the committed offset covers the state."""
        _drain_in_flight()
        while True:
            batch = worker.assembler.next_batch(block=False) \
                or worker.assembler.flush()
            if not batch:
                break
            ctx = job.dispatch_batch(batch, now=_wall())
            _remote_fetch(ctx, batch)
            _complete(ctx, _wall() + scorer.cost_s(len(batch)),
                      job._inflight_depth())

    fenced = {"abandons": 0, "stale_generation": 0, "fenced_epoch": 0,
              "partitions_dropped": 0}
    rejoin = {"pending": False, "next_try": 0.0}

    def _abandon(why: str) -> None:
        """Fenced-writer recovery: a rebalance we never observed moved
        our partitions (asymmetric partition → session expiry). Drop all
        local ownership WITHOUT checkpointing (the inheritors' restored
        state is the truth; our epoch is fenced anyway), then re-enter
        the fleet as a fresh member once a hello gets through."""
        nonlocal busy_until
        fenced["abandons"] += 1
        in_flight.clear()
        fenced["partitions_dropped"] += worker.abandon()
        busy_until = 0.0
        # unstamped until the next adopted assignment: an abandoned
        # worker's only writes are control-plane events, never fenced
        client.generation = None
        rejoin["pending"] = True
        rejoin["next_try"] = 0.0

    def _handle_control(msg: Dict[str, Any]) -> None:
        kind = msg.get("type")
        if kind == "epoch":
            # the drill coordinator's shared window epoch (netfault
            # schedules + phase classification are relative to it)
            epoch["t0"] = float(msg["t0"])
        elif kind == "peers" and fetch_cfg is not None:
            from realtime_fraud_detection_tpu_torch.graph.fetch import (
                GraphFetchClient,
            )

            addrs = {str(p): a for p, a in (msg.get("addrs") or {}).items()
                     if str(p) != wid and a}
            peers = {}
            for p, a in addrs.items():
                h, _, prt = str(a).rpartition(":")
                peers[p] = (h or "127.0.0.1", int(prt))
            old = fetch_client_box["client"]
            if old is not None:
                old.close()
            fetch_client_box["client"] = GraphFetchClient(
                peers,
                deadline_ms=float(fetch_cfg.get("deadline_ms", 25.0)),
                node_budget=int(fetch_cfg.get("node_budget", 64)))
        elif kind == "assign":
            gen = int(msg.get("generation", 0))
            assignment = msg.get("assignment") or {}
            mine = sorted(int(p) for p in assignment.get(wid, ()))
            phase = msg.get("phase")
            if phase == "release":
                to_keep = [p for p in store.owned() if p in set(mine)]
                if to_keep != store.owned():
                    # this worker actually loses partitions: everything
                    # consumed so far must be scored + committed before
                    # the release checkpoint claims its offset; workers
                    # keeping their whole set never stop (cooperative)
                    _drain_pending()
                counts = worker.set_assignment(to_keep)
                client.produce(EVENTS_TOPIC, {
                    "type": "ack", "worker": wid, "generation": gen,
                    "phase": "release",
                    "released": counts["released"]}, key=wid)
            elif phase == "acquire":
                if wid not in assignment and store.owned():
                    # a rebalance we never released for: we were EVICTED
                    # (the coordinator stopped hearing us). Adopting this
                    # epoch and release-checkpointing here would race the
                    # inheritors' restores with stale state — abandon
                    # instead; the coordinator is not waiting for an ack
                    # from an evicted member.
                    _abandon("excluded-from-assignment")
                    return
                handoff.epoch = gen
                # stamp every later produce/commit with the adopted
                # generation: the broker refuses the stamp once a newer
                # rebalance fences our partitions (StaleGenerationError
                # -> _abandon), closing the zombie-writer window
                client.generation = gen
                if fetch_client_box["client"] is not None:
                    fetch_client_box["client"].set_generation(gen)
                counts = worker.set_assignment(mine)
                client.produce(EVENTS_TOPIC, {
                    "type": "ack", "worker": wid, "generation": gen,
                    "phase": "acquire", "acquired": counts["acquired"],
                    "released": counts["released"],
                    "replayed": counts["replayed"]}, key=wid)
        elif kind == "shutdown" and str(msg.get("worker")) == wid:
            stop["reason"] = "shutdown"

    # fleet-metrics publishing (obs/fleetmetrics.py ingests these): the
    # worker ships counter DELTAS with a monotonic seq, and advances its
    # last-sent baseline only AFTER the produce returns — a netfault-
    # dropped publish is retried as a larger delta next interval, never
    # lost, so the coordinator's fleet sums stay exact
    met: Dict[str, Any] = {"seq": 0, "last": {}}

    def _metric_counters() -> Dict[str, float]:
        cur: Dict[str, float] = {str(k): float(v)
                                 for k, v in job.counters.items()}
        if tracer is not None:
            for k, v in tracer.counters.items():
                cur[f"trace_{k}"] = float(v)
        fc = fetch_client_box["client"]
        if fc is not None:
            cur["remote_fetch"] = float(fc.remote_fetch_total)
            cur["remote_fetch_errors"] = float(fc.fetch_error_total)
        return cur

    def _publish_metrics() -> None:
        cur = _metric_counters()
        # the FIRST snapshot ships every key (zeros included) so the
        # fleet exposition carries the full series set from the start
        # and the final fold equals the bye counters key for key;
        # afterwards only changed keys ride each delta
        delta = cur if met["seq"] == 0 else {
            k: v - met["last"].get(k, 0.0)
            for k, v in cur.items()
            if k not in met["last"] or v != met["last"][k]}
        if not delta and met["seq"] > 0:
            return
        client.produce(EVENTS_TOPIC, {
            "type": "metrics", "worker": wid, "seq": met["seq"] + 1,
            "counters": delta}, key=wid)
        met["seq"] += 1
        met["last"] = cur

    def _say_bye() -> None:
        from realtime_fraud_detection_tpu_torch.obs.profiling import (
            interpolated_percentile,
        )

        _drain_pending()
        n_ckpt = worker.checkpoint()
        digests = {str(p): d
                   for p, d in store.digests(now=DIGEST_NOW).items()}
        depth_stats = {}
        for depth, vals in sorted(lat_by_depth.items()):
            if vals:
                s = sorted(vals)
                depth_stats[str(depth)] = {
                    "n": len(s),
                    "p50_ms": round(interpolated_percentile(s, 0.50), 3),
                    "p99_ms": round(interpolated_percentile(s, 0.99), 3),
                }
        phase_stats = {}
        for label, vals in sorted(lat_by_phase.items()):
            if vals:
                s = sorted(vals)
                phase_stats[label] = {
                    "n": len(s),
                    "p50_ms": round(interpolated_percentile(s, 0.50), 3),
                    "p99_ms": round(interpolated_percentile(s, 0.99), 3),
                }
        # final delta BEFORE the bye: the coordinator's streamed fleet
        # sums equal these bye counters exactly (the obs-drill pin) —
        # best-effort; a dead broker here still gets the bye attempt
        try:
            _publish_metrics()
        except (ConnectionError, OSError):
            pass
        bye = {"type": "bye", "worker": wid, "graceful": True,
               "reason": stop["reason"], "final_checkpoints": n_ckpt,
               "pid": os.getpid(),
               "digests": digests, "counters": dict(job.counters),
               "checkpoints": worker.checkpoints,
               "replayed_total": worker.replayed_total,
               "latency_by_depth": depth_stats,
               "latency_phases": phase_stats,
               "fenced": dict(fenced),
               "link": (link.state.snapshot_entry()
                        if link is not None else None)}
        if job.tuning is not None:
            snap = job.tuning.snapshot()
            bye["autotune"] = {
                "inflight_depth": snap["tuner"]["inflight_depth"],
                "counters": snap["tuner"]["counters"]}
        if tracer is not None:
            # the flight recorder rides the bye verbatim: the coordinator
            # stitches every worker's ring into the fleet trace store
            bye["trace_ring"] = [ct.to_dict() for ct in tracer.traces()]
            bye["tracer_counters"] = dict(tracer.counters)
        fc = fetch_client_box["client"]
        if fc is not None:
            bye["fetch"] = fc.stats()
        if fetch_srv is not None:
            bye["fetch_served"] = fetch_srv.requests_total
        client.produce(EVENTS_TOPIC, bye, key=wid)

    hb_s = float(spec.get("heartbeat_s", 1.0))
    next_hb = 0.0
    next_ctl = 0.0
    # outer-loop resilience: the client's OWN reconnect retries are
    # bounded; past them the worker backs off deterministically and
    # stays alive until the link heals (full partition, broker restart,
    # SIGSTOP'd broker) — process death is for SIGKILL, not for weather
    conn_backoff = DeterministicBackoff(
        base_s=0.05, mult=2.0, max_s=1.0,
        seed=instance_seed(f"worker:{wid}"))
    conn_attempt = 0

    try:
        while True:
            try:
                # ---- control plane, fault-isolated: an asymmetric
                # partition (deaf to the coordinator, data path alive)
                # must not stall scoring — that IS the zombie scenario
                # the broker's generation fence closes
                if _wall() >= next_ctl:
                    try:
                        recs = client.read(CONTROL_TOPIC, 0, ctl_pos, 64)
                        for r in recs:
                            if isinstance(r.value, dict):
                                _handle_control(r.value)
                            # advance only past HANDLED messages: a
                            # transient failure mid-handler re-polls the
                            # same record instead of silently skipping
                            # an assignment
                            ctl_pos = r.offset + 1
                        next_ctl = 0.0
                    except (ConnectionError, OSError):
                        next_ctl = _wall() + 0.5
                if stop["reason"] is not None:
                    _say_bye()
                    return 0
                # ---- heartbeat (silence IS the eviction signal; a
                # partitioned worker keeps scoring regardless)
                if _wall() >= next_hb:
                    next_hb = _wall() + hb_s
                    try:
                        client.produce(EVENTS_TOPIC,
                                       {"type": "hb", "worker": wid},
                                       key=wid)
                    except (ConnectionError, OSError):
                        pass
                    try:
                        # rides the heartbeat cadence; baseline advances
                        # only on a successful produce (inside), so a
                        # fault window folds into the next delta
                        _publish_metrics()
                    except (ConnectionError, OSError):
                        pass
                # ---- fenced: rejoin as a fresh member once the control
                # plane lets a hello through (cursor jumps to the topic
                # END first — pre-eviction assignments are history)
                if rejoin["pending"] and _wall() >= rejoin["next_try"]:
                    try:
                        ctl_pos = client.end_offsets(CONTROL_TOPIC)[0]
                        client.produce(EVENTS_TOPIC,
                                       {"type": "hello", "worker": wid,
                                        "pid": os.getpid(),
                                        "rejoin": True}, key=wid)
                        rejoin["pending"] = False
                    except (ConnectionError, OSError):
                        rejoin["next_try"] = _wall() + 0.5
                # ---- data plane
                progressed = False
                while in_flight and in_flight[0][1] <= _wall():
                    _complete(*in_flight.popleft())
                    progressed = True
                if len(in_flight) < job._inflight_depth():
                    batch = worker.assembler.next_batch(block=False)
                    if batch:
                        now = _wall()
                        ctx = job.dispatch_batch(batch, now=now)
                        _remote_fetch(ctx, batch)
                        start = max(now, busy_until)
                        done = start + scorer.cost_s(len(batch))
                        busy_until = done
                        in_flight.append((ctx, done,
                                          job._inflight_depth()))
                        progressed = True
                if not progressed:
                    if in_flight:
                        _complete(*in_flight.popleft())
                    else:
                        time.sleep(0.005)
                conn_attempt = 0
            except StaleGenerationError:
                # the broker's producer-generation fence: a rebalance we
                # never observed moved our partitions — whatever we just
                # tried to write was refused whole, nothing landed
                fenced["stale_generation"] += 1
                _abandon("stale-generation")
            except FencedEpochError:
                # same story at the checkpoint seam (handoff epoch)
                fenced["fenced_epoch"] += 1
                _abandon("fenced-epoch")
            except (ConnectionError, OSError):
                conn_backoff.sleep(min(conn_attempt, 8))
                conn_attempt += 1
    finally:
        fc = fetch_client_box["client"]
        if fc is not None:
            fc.close()
        if fetch_srv is not None:
            fetch_srv.stop()
        client.close()
        handoff.close()
