"""Partition-parallel worker fleet: N partition-scoped ``StreamJob``
workers, key-sharded state, checkpointed handoff.

Port of the JAX package's ``cluster/fleet.py`` (the in-process fleet). One
``WorkerFleet`` is one consumer group over the transactions topic. Each
:class:`ClusterWorker` wraps a real ``stream/job.py StreamJob`` whose
consumer is scoped to the partitions the fleet's hash ring assigns it and
whose scorer reads and writes a ``cluster/partition.py PartitionedStore``
owning exactly those partitions (``TorchFraudScorer(stores=...)``, or the
shard drill's host stand-in), so no two workers ever write one user's state.

**Checkpointed handoff.** Every ``checkpoint_every`` completed batches a
worker snapshots one owned partition's state (round-robin) into the shared
:class:`HandoffStore`, keyed to that partition's committed offset at that
instant (write-back precedes the commit, so state and committed offset
agree). On a worker's loss the ring reassigns only its partitions; each
inheritor restores the latest snapshot (state as of offset ``O_s``),
state-replays the committed gap ``[O_s, O_c)`` through the scorer's
``replay_state`` seam (state updates re-applied, nothing re-emitted: those
predictions already reached the output topics), and resumes consumption at
``O_c``, so the uncommitted tail is scored exactly once.

The acceptance drill is ``shard-drill`` (``cluster/drill.py``). The same
worker runs in an OS process under ``cluster/procfleet.py``, with the
network handoff store of ``cluster/handoff.py`` and ``abandon`` as the
fenced writer's recovery.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from realtime_fraud_detection_tpu_torch.cluster.hashring import (
    HashRing,
    ShardRouter,
)
from realtime_fraud_detection_tpu_torch.cluster.partition import (
    PartitionedStore,
    PartitionState,
)
from realtime_fraud_detection_tpu_torch.stream import topics as T
from realtime_fraud_detection_tpu_torch.stream.job import JobConfig, StreamJob
from realtime_fraud_detection_tpu_torch.stream.microbatch import MicrobatchAssembler
from realtime_fraud_detection_tpu_torch.serving.validation import sanitize_for_stream

__all__ = ["HandoffStore", "ClusterWorker", "WorkerFleet"]


class HandoffStore:
    """Shared snapshot ledger: partition → (committed offset, state blob).

    The rendezvous between a dying worker's past checkpoints and its
    partitions' inheritors: a locked dict, in process. The network form,
    with the same ``put`` / ``get`` surface plus crash-safe blobs,
    sha256-verified restore and epoch fencing, is
    ``cluster/handoff.py HandoffServer`` / ``HandoffClient``; a
    ``ClusterWorker`` takes either."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._snaps: Dict[int, Tuple[int, bytes]] = {}
        self.snapshots_taken = 0

    def put(self, partition: int, offset: int, blob: bytes) -> None:
        with self._lock:
            self._snaps[int(partition)] = (int(offset), blob)
            self.snapshots_taken += 1

    def get(self, partition: int) -> Optional[Tuple[int, bytes]]:
        with self._lock:
            return self._snaps.get(int(partition))

    def offsets(self) -> Dict[int, int]:
        with self._lock:
            return {p: off for p, (off, _) in sorted(self._snaps.items())}


class ClusterWorker:
    """One partition-scoped StreamJob worker inside a fleet."""

    def __init__(self, worker_id: str, broker: Any, scorer: Any,
                 store: PartitionedStore, handoff: HandoffStore,
                 group_id: str, topic: str = T.TRANSACTIONS,
                 clock: Optional[Callable[[], float]] = None,
                 max_batch: int = 128, max_delay_ms: float = 20.0,
                 checkpoint_every: int = 8, autotune: Any = None,
                 tracing: Any = None, expect_carrier: bool = False):
        self.worker_id = worker_id
        self.broker = broker
        self.scorer = scorer
        self.store = store
        self.handoff = handoff
        self.group_id = group_id
        self.topic = topic
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.alive = True
        self.job = StreamJob(broker, scorer, JobConfig(
            group_id=group_id, max_batch=max_batch,
            max_delay_ms=max_delay_ms, emit_features=False,
            emit_enriched=False, transactions_topic=topic,
            autotune=autotune, tracing=tracing,
            expect_carrier=expect_carrier))
        # a partition-scoped consumer and a (virtual-clock capable)
        # assembler replace the job's defaults; the job's tuning plane, if
        # any, stays the new assembler's close controller
        self.consumer = broker.consumer([topic], group_id,
                                        partitions={topic: []})
        self.job.consumer = self.consumer
        kw = {"clock": clock} if clock is not None else {}
        self.assembler = MicrobatchAssembler(
            self.consumer, max_batch=max_batch,
            max_delay_ms=max_delay_ms, controller=self.job.tuning, **kw)
        self.job.assembler = self.assembler
        # virtual in-flight window (ctx, done_time), managed by the drive
        # loop; busy_until models the worker's serial compute resource
        self.in_flight: deque = deque()
        self.busy_until = 0.0
        self.completions = 0
        self.checkpoints = 0
        self.replayed_total = 0
        self.handoffs_in = 0
        self._since_checkpoint = 0
        self._ckpt_rr = 0

    # ------------------------------------------------------------ ownership
    def set_assignment(self, partitions: Sequence[int],
                       now: Optional[float] = None) -> Dict[str, int]:
        """Adopt a new partition set: released partitions are snapshotted
        then dropped; acquired ones restore + state-replay (the handoff
        path). Returns counters for the fleet ledger."""
        target = sorted(int(p) for p in partitions)
        current = set(self.store.owned())
        released = acquired = replayed = 0
        for p in sorted(current - set(target)):
            self._checkpoint_partition(p)
            self.store.release(p)
            released += 1
        for p in (q for q in target if q not in current):
            replayed += self._acquire_partition(p, now)
            acquired += 1
        self.consumer.set_assignment({self.topic: target})
        if acquired:
            self.handoffs_in += acquired
        self.replayed_total += replayed
        return {"released": released, "acquired": acquired,
                "replayed": replayed}

    def _acquire_partition(self, p: int, now: Optional[float]) -> int:
        """Restore the partition's last snapshot and state-replay the
        committed gap; returns the replay depth (records)."""
        snap = self.handoff.get(p)
        state: Optional[PartitionState] = None
        from_off = 0
        if snap is not None:
            from_off, blob = snap
            state = PartitionState.restore_bytes(blob)
        self.store.acquire(p, state)
        committed = self.broker.committed(self.group_id, self.topic, p)
        replayed = 0
        off = from_off
        while off < committed:
            recs = self.broker.read(self.topic, p, off,
                                    min(2048, committed - off))
            if not recs:
                break
            off = recs[-1].offset + 1
            batch = []
            for r in recs:
                txn, errors = sanitize_for_stream(r.value)
                if errors:
                    continue
                # the existing dedup path: anything the restored snapshot
                # already covers (or a producer duplicate) is skipped
                if self.store.txn_cache.get_transaction(
                        str(txn["transaction_id"]), now=now) is not None:
                    continue
                batch.append(txn)
            if batch:
                self.scorer.replay_state(batch, now=now)
                replayed += len(batch)
        return replayed

    # ----------------------------------------------------------- checkpoint
    def _checkpoint_partition(self, p: int) -> None:
        # offset FIRST, snapshot second: a commit landing between the two
        # would key the (newer) state to an older offset, and the replay
        # would re-apply records the snapshot already contains. Within a
        # single-threaded worker the order is moot; keep the safe one.
        committed = self.broker.committed(self.group_id, self.topic, p)
        self.handoff.put(p, committed,
                         self.store.state(p).snapshot_bytes())

    def checkpoint(self) -> int:
        """Snapshot every owned partition keyed to its committed offset."""
        for p in self.store.owned():
            self._checkpoint_partition(p)
        self.checkpoints += 1
        return len(self.store.owned())

    def abandon(self) -> int:
        """Fenced-writer recovery: drop every owned partition without a
        checkpoint. This worker lost its partitions in a rebalance it never
        saw (an asymmetric partition, a session expiry); the inheritors
        restored the last good checkpoint and replayed the committed gap,
        so their state is the truth, and a checkpoint from here would carry
        a stale epoch the handoff fence refuses. Pending assembler records
        are discarded too: nothing of a lost partition may be dispatched.
        Returns the number of partitions dropped; the worker re-enters the
        fleet as a fresh member (hello, rebalance, restore)."""
        while True:
            batch = self.assembler.next_batch(block=False) \
                or self.assembler.flush()
            if not batch:
                break
        dropped = 0
        for p in list(self.store.owned()):
            self.store.release(p)
            dropped += 1
        self.consumer.set_assignment({self.topic: []})
        self.in_flight.clear()
        return dropped

    def on_batch_complete(self) -> None:
        """Drive-loop hook after each ``complete_batch``: every
        ``checkpoint_every`` completions, snapshot ONE owned partition
        (round-robin). Amortized, not burst: a worker owning P partitions
        never pays P pickles in one completion, and the staggered
        snapshot ages mean a worker loss at ANY instant leaves most
        partitions with a committed gap for the state-replay path — the
        recovery cost is bounded by cadence × P, not by luck."""
        self.completions += 1
        self._since_checkpoint += 1
        if self._since_checkpoint >= self.checkpoint_every:
            self._since_checkpoint = 0
            owned = self.store.owned()
            if owned:
                self._checkpoint_partition(
                    owned[self._ckpt_rr % len(owned)])
                self._ckpt_rr += 1
                self.checkpoints += 1


class WorkerFleet:
    """N partition-scoped workers + ring placement + handoff + router."""

    def __init__(self, broker: Any, n_workers: int, n_partitions: int,
                 scorer_factory: Callable[[str, PartitionedStore], Any],
                 group_id: str = "fraud-cluster",
                 topic: str = T.TRANSACTIONS,
                 clock: Optional[Callable[[], float]] = None,
                 max_batch: int = 128, max_delay_ms: float = 20.0,
                 checkpoint_every: int = 8, virtual_nodes: int = 256,
                 store_kwargs: Optional[Dict[str, Any]] = None):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self.broker = broker
        self.n_partitions = int(n_partitions)
        self.topic = topic
        self.group_id = group_id
        self.handoff = HandoffStore()
        ids = [f"w{i}" for i in range(n_workers)]
        self.ring = HashRing(ids, virtual_nodes=virtual_nodes)
        self.router = ShardRouter(n_partitions, ids,
                                  virtual_nodes=virtual_nodes)
        self.generation = 1
        self.handoffs_total = 0
        self.replayed_total = 0
        self.last_replay_depth = 0
        self.kills = 0
        self.events: List[Dict[str, Any]] = []
        self.workers: Dict[str, ClusterWorker] = {}
        assignment = self.ring.assignment(self.n_partitions)
        for wid in ids:
            store = PartitionedStore(self.n_partitions,
                                     **(store_kwargs or {}))
            worker = ClusterWorker(
                wid, broker, scorer_factory(wid, store), store,
                self.handoff, group_id, topic=topic, clock=clock,
                max_batch=max_batch, max_delay_ms=max_delay_ms,
                checkpoint_every=checkpoint_every)
            worker.set_assignment(assignment[wid], now=0.0)
            self.workers[wid] = worker

    # -------------------------------------------------------------- queries
    def alive_workers(self) -> List[ClusterWorker]:
        return [w for w in self.workers.values() if w.alive]

    def owner_of_partition(self, p: int) -> str:
        return self.ring.owner_of_partition(p)

    def worker_for_user(self, user_id: str) -> ClusterWorker:
        return self.workers[self.router.route(user_id)]

    # ---------------------------------------------------------------- kill
    def kill_worker(self, worker_id: str,
                    now: Optional[float] = None) -> Dict[str, Any]:
        """Process-death semantics: the worker's live state and in-flight
        batches are GONE (no graceful flush, no final snapshot); its
        partitions move to the survivors via restore + state-replay."""
        w = self.workers.get(worker_id)
        if w is None or not w.alive:
            return {"killed": False}
        w.alive = False
        w.in_flight.clear()
        dead_parts = list(w.store.owned())
        for p in dead_parts:
            # the dead process's live state is GONE — drop it, so the
            # fleet snapshot (and the cluster_partitions_owned mirror)
            # never shows a corpse still owning partitions the survivors
            # now hold; inheritors recover from HandoffStore, never from
            # this store
            w.store.release(p)
        self.ring.remove(worker_id)
        survivors = [sw for sw in self.workers.values() if sw.alive]
        if not survivors:
            raise RuntimeError("cannot kill the last alive worker")
        self.generation += 1
        self.kills += 1
        assignment = self.ring.assignment(self.n_partitions)
        replayed = 0
        for sw in survivors:
            counts = sw.set_assignment(assignment[sw.worker_id], now=now)
            replayed += counts["replayed"]
        moved = self.router.set_membership(
            [sw.worker_id for sw in survivors])
        self.handoffs_total += len(dead_parts)
        self.replayed_total += replayed
        self.last_replay_depth = replayed
        self.events.append({
            "event": "worker_kill", "worker": worker_id,
            "ts": now, "partitions": sorted(dead_parts),
            "partitions_moved": len(dead_parts),
            "router_moved": moved, "replayed": replayed,
            "generation": self.generation,
        })
        return {"killed": True, "partitions_moved": dead_parts,
                "replayed": replayed, "router_moved": moved}

    # -------------------------------------------------------------- summary
    def assignment(self) -> Dict[str, List[int]]:
        return {wid: w.store.owned() for wid, w in self.workers.items()
                if w.alive}

    def counters(self) -> Dict[str, int]:
        c = {"scored": 0, "shed": 0, "duplicates_skipped": 0, "errors": 0,
             "batches": 0, "alerts": 0}
        for w in self.workers.values():
            for k in c:
                c[k] += w.job.counters.get(k, 0)
        return c

    def lag(self) -> int:
        return sum(w.consumer.lag() for w in self.alive_workers())

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able fleet state shaped for
        ``obs.metrics.MetricsCollector.sync_cluster``."""
        return {
            "generation": self.generation,
            "workers_alive": len(self.alive_workers()),
            "workers": {
                wid: {
                    "alive": w.alive,
                    "partitions_owned": len(w.store.owned()),
                    "completions": w.completions,
                    "checkpoints": w.checkpoints,
                    "replayed": w.replayed_total,
                } for wid, w in sorted(self.workers.items())
            },
            "handoffs_total": self.handoffs_total,
            "replayed_total": self.replayed_total,
            "last_replay_depth": self.last_replay_depth,
            "checkpoints_total": self.handoff.snapshots_taken,
            "kills": self.kills,
            "router": self.router.snapshot(),
            "events": list(self.events),
        }
