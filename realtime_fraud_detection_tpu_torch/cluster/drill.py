"""Shard drill: the partition-parallel worker plane end to end.

Port of the JAX package's ``cluster/drill.py`` (``shard-drill``). One
seeded, virtual-clock timeline drives a simulated user population (1M users
at the full config) through a ``cluster/fleet.py WorkerFleet`` of at least
four partition-scoped ``StreamJob`` workers over one shared broker log,
kills a worker mid-stream (``chaos/faults.py WorkerKill`` on a
``ChaosPlan`` window) and checks the contract:

- **zero lost / double-scored**: every produced transaction appears on the
  predictions topic exactly once;
- **gap-free committed offsets**: the group's committed offsets reach every
  partition's end;
- **per-key ordering**: each user's predictions appear in event order,
  across the kill;
- **state equality**: after the drain the fleet's per-partition state is
  digest-identical to a single-worker oracle run over the same schedule,
  and every served score equals the oracle's (the scores are coupled to
  state, so a lost or doubled update flips them);
- **affinity and routing**: every batch a worker scores holds only its own
  partitions, and the serving router agrees with fleet ownership for every
  user, with only the dead worker's partitions moving;
- **bit-identical replay**: a second fresh run produces the same digest.

Scoring is a deterministic host stand-in (:class:`ShardScorer`) with a
virtual service-cost model, so the drill runs on the CPU in seconds and
never touches a card; every state update is keyed to the record's event
time, which makes per-partition state independent of batch boundaries. The
summary, then a compact (< 2 KB) verdict as the last stdout line.
``run_shard_scaling`` is the benchmark's ``shard_scaling`` hook: the same
virtual-clock fleet at 1 / 2 / 4 workers over one saturating schedule, host
work only.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from realtime_fraud_detection_tpu_torch.cluster.fleet import WorkerFleet
from realtime_fraud_detection_tpu_torch.cluster.partition import PartitionedStore
from realtime_fraud_detection_tpu_torch.stream import topics as T

__all__ = ["ShardDrillConfig", "ShardScorer", "run_shard_drill", "run_fleet",
           "build_schedule", "compact_shard_summary", "run_shard_scaling"]


@dataclasses.dataclass
class ShardDrillConfig:
    """Drill sizes. Defaults = the full drill (1M users); ``fast()`` =
    the tier-1 smoke — same workers, same kill, smaller population."""

    seed: int = 7
    n_workers: int = 4
    n_partitions: int = 12          # the transactions topic's contract
    num_users: int = 1_000_000
    num_merchants: int = 1_000
    n_txns: int = 24_576
    batch: int = 128
    max_delay_ms: float = 25.0      # virtual assembler deadline
    inflight_depth: int = 2
    # deterministic service-cost model (virtual ms per dispatched batch)
    base_ms: float = 4.0
    per_txn_ms: float = 0.16
    # offered load (txn/s of virtual time)
    tps: float = 6_000.0
    # handoff cadence (completed batches between partition snapshots):
    # deliberately > 1 so the kill lands with snapshots OLDER than the
    # committed offsets and the state-replay path is actually exercised
    checkpoint_every: int = 6
    # "auto" = the worker owning the most partitions (deterministic
    # tie-break by id) — the kill must actually move state, not hit a
    # worker the ring left empty-handed
    kill_worker: str = "auto"
    kill_frac: float = 0.45         # kill at this fraction of the stream
    virtual_nodes: int = 256
    # partition-state dimensions (the stand-in scorer's feature rows)
    seq_len: int = 4
    feature_dim: int = 4
    # second, fully fresh run compared digest-for-digest with the first
    replay_check: bool = True

    @classmethod
    def fast(cls) -> "ShardDrillConfig":
        """Tier-1 smoke: every phase (including the kill + handoff +
        replay) still runs; the population and stream shrink."""
        return cls(num_users=20_000, num_merchants=400, n_txns=5_120,
                   checkpoint_every=4)

    def cost_s(self, n: int) -> float:
        return (self.base_ms + n * self.per_txn_ms) / 1e3

    def capacity_tps(self) -> float:
        """One worker's sustainable rate at the configured batch size."""
        return self.batch / self.cost_s(self.batch)


# --------------------------------------------------------------- scorer


class _ShardPending:
    def __init__(self, records: List[Dict[str, Any]],
                 now: Optional[float], trace: Any = None):
        self.records = records
        self.now = now
        self.features = None
        self.trace = trace


class ShardScorer:
    """Deterministic scorer stand-in over a PartitionedStore.

    The score is a pure function of the transaction id AND the user's
    partition state at scoring time (velocity count + profile txn count),
    and every state update is keyed to the record's embedded event time —
    so two runs that process each partition's records in offset order
    produce identical state and identical scores REGARDLESS of how the
    records were batched across workers. That is exactly the invariant
    the shard drill's oracle comparison verifies.

    ``replay_state`` re-applies the same per-record arithmetic without
    producing results — the checkpointed-handoff path's state-only
    replay of the committed gap.
    """

    def __init__(self, store: PartitionedStore, base_ms: float = 4.0,
                 per_txn_ms: float = 0.16):
        self.store = store
        self.base_ms = float(base_ms)
        self.per_txn_ms = float(per_txn_ms)
        self.txn_cache = store.txn_cache       # the job's dedupe seam

    def cost_s(self, n: int) -> float:
        return (self.base_ms + n * self.per_txn_ms) / 1e3

    # ------------------------------------------------- dispatch / finalize
    def dispatch(self, records, now: Optional[float] = None,
                 trace: Any = None) -> _ShardPending:
        # trace-drill mark convention: each mark labels the interval
        # STARTING at it; device_wait is marked at dispatch-return so it
        # labels the in-flight dwell until finalize's mark
        if trace is not None:
            trace.mark("assemble")
            trace.mark("pack")
            trace.mark("dispatch")
        pending = _ShardPending(list(records), now, trace)
        if trace is not None:
            trace.mark("device_wait")
        return pending

    def finalize(self, pending: _ShardPending,
                 now: Optional[float] = None,
                 lock=None) -> List[Dict[str, Any]]:
        if pending.trace is not None:
            pending.trace.mark("finalize")
        return [self._score_and_update(txn) for txn in pending.records]

    def replay_state(self, records, now: Optional[float] = None) -> None:
        """State-only replay of already-emitted records (handoff): same
        arithmetic, results discarded — nothing is re-produced."""
        for txn in records:
            self._score_and_update(txn)

    # ---------------------------------------------------------- per record
    @staticmethod
    def _event_ts(txn: Dict[str, Any]) -> float:
        # the drill embeds the arrival instant; records without it (e.g.
        # hand-built tests) fall back to 0.0 — still deterministic
        return float(txn.get("event_ts", 0.0))

    def _score_and_update(self, txn: Dict[str, Any]) -> Dict[str, Any]:
        ts = self._event_ts(txn)
        uid = str(txn.get("user_id", ""))
        tid = str(txn.get("transaction_id", ""))
        amount = float(txn.get("amount", 0.0))
        # reads BEFORE writes, in a fixed order
        vcount = float(self.store.velocity.get(uid, "5min", ts)
                       .get("count", 0))
        prof = self.store.profiles.get_user(uid) or {}
        pcount = float(prof.get("txn_count", 0))
        h = (zlib.crc32(tid.encode()) % 1000) / 1000.0
        score = round(0.5 * h + 0.3 * min(vcount, 8.0) / 8.0
                      + 0.2 * min(pcount, 16.0) / 16.0, 6)
        decision = ("APPROVE" if score < 0.5 else
                    "APPROVE_WITH_MONITORING" if score < 0.7 else
                    "REVIEW" if score < 0.85 else "DECLINE")
        risk = ("LOW" if score < 0.5 else "MEDIUM" if score < 0.7
                else "HIGH")
        # write-back, event-time keyed (batch-boundary independent)
        self.store.velocity.update(uid, amount, ts)
        self.store.profiles.put_user(uid, {
            "user_id": uid,
            "txn_count": int(pcount) + 1,
            "total_amount": round(float(prof.get("total_amount", 0.0))
                                  + amount, 2),
        })
        feat = np.asarray([[round(amount % 97.0 / 97.0, 6), h,
                            min(vcount, 8.0) / 8.0,
                            min(pcount, 16.0) / 16.0]], np.float32)
        self.store.history.append_batch([uid], feat)
        merged = dict(txn)
        merged.update(fraud_score=score, decision=decision,
                      risk_level=risk, confidence=0.9)
        self.store.txn_cache.cache_transaction(merged, now=ts)
        return {
            "transaction_id": tid,
            "fraud_probability": score,
            "fraud_score": score,
            "risk_level": risk,
            "decision": decision,
            "model_predictions": {},
            "confidence": 0.9,
            "processing_time_ms": 0.0,
            "explanation": {"shard": True},
        }


# ----------------------------------------------------------------- drive


def build_schedule(cfg: ShardDrillConfig,
                    ) -> List[Tuple[float, Dict[str, Any]]]:
    """The seeded arrival timeline: uniform spacing at ``cfg.tps``, each
    record stamped with its event instant (the clock every state update
    keys to)."""
    from realtime_fraud_detection_tpu_torch.sim.simulator import (
        TransactionGenerator,
    )

    gen = TransactionGenerator(num_users=cfg.num_users,
                               num_merchants=cfg.num_merchants,
                               seed=cfg.seed, tps=cfg.tps)
    sched: List[Tuple[float, Dict[str, Any]]] = []
    t = 0.0
    remaining = cfg.n_txns
    while remaining > 0:
        for txn in gen.generate_batch(min(2048, remaining)):
            txn["event_ts"] = round(t, 9)
            sched.append((t, txn))
            t += 1.0 / cfg.tps
        remaining = cfg.n_txns - len(sched)
    return sched


def run_fleet(cfg: ShardDrillConfig,
              sched: List[Tuple[float, Dict[str, Any]]],
              n_workers: int, kill: bool,
              scorer_factory: Optional[Callable[[str, PartitionedStore], Any]] = None,
              store_kwargs: Optional[Dict[str, Any]] = None,
              profiles: Optional[Tuple[Dict[str, Any], Dict[str, Any]]] = None,
              ) -> Dict[str, Any]:
    """Drive one fleet over the schedule on a fresh broker; returns the
    raw outcome (ledger + state digests + fleet snapshot + digest).
    ``scorer_factory(worker_id, store)`` builds each worker's scorer (the
    drill's ``ShardScorer`` when None; a ``TorchFraudScorer(stores=store)``
    runs the same timeline on the card), ``store_kwargs`` the
    ``PartitionedStore`` widths (the config's when None); ``profiles``
    (users, merchants) are seeded into each worker's scorer (its owned
    users, as the facade refuses others, and every merchant), and each
    worker then checkpoints its partitions, so a partition that moves
    before its first cadence snapshot still carries its seeded profiles."""
    from realtime_fraud_detection_tpu_torch.chaos.faults import (
        ChaosPlan,
        FaultWindow,
        WorkerKill,
    )
    from realtime_fraud_detection_tpu_torch.stream.transport import InMemoryBroker

    broker = InMemoryBroker()
    clock = [0.0]
    vclock = lambda: clock[0]                                  # noqa: E731

    def factory(worker_id: str, store: PartitionedStore) -> ShardScorer:
        return ShardScorer(store, base_ms=cfg.base_ms,
                           per_txn_ms=cfg.per_txn_ms)

    fleet = WorkerFleet(
        broker, n_workers, cfg.n_partitions, scorer_factory or factory,
        topic=T.TRANSACTIONS, clock=vclock, max_batch=cfg.batch,
        max_delay_ms=cfg.max_delay_ms,
        checkpoint_every=cfg.checkpoint_every,
        virtual_nodes=cfg.virtual_nodes,
        store_kwargs=store_kwargs or {"seq_len": cfg.seq_len,
                                      "feature_dim": cfg.feature_dim})
    if profiles is not None:
        users, merchants = profiles
        for w in fleet.workers.values():
            owned = set(w.store.owned())
            w.scorer.seed_profiles(
                {u: p for u, p in users.items()
                 if w.store.partition_for(u) in owned}, merchants)
            w.checkpoint()

    plan = None
    t_kill = None
    kill_target = None
    if kill and n_workers > 1:
        kill_target = cfg.kill_worker
        if kill_target == "auto":
            kill_target = max(fleet.assignment().items(),
                              key=lambda kv: (len(kv[1]), kv[0]))[0]
        t_kill = cfg.kill_frac * (len(sched) / cfg.tps)
        plan = ChaosPlan([FaultWindow("worker_kill", "cluster",
                                      t_kill, t_kill + 0.05)])
        plan.bind("worker_kill", WorkerKill(fleet, kill_target))

    pre_kill_assignment = fleet.assignment()
    next_i = 0
    n = len(sched)
    affinity_violations = 0
    handoff_pause_s = None
    moved_parts: set = set()

    while True:
        now = clock[0]
        if plan is not None:
            plan.poll(now)
            if not moved_parts:
                for ev in fleet.events:
                    if ev["event"] == "worker_kill":
                        moved_parts = set(ev.get("partitions") or ())
                        break
        while next_i < n and sched[next_i][0] <= now:
            ts, txn = sched[next_i]
            next_i += 1
            broker.produce(T.TRANSACTIONS, txn,
                           key=str(txn["user_id"]), timestamp=ts)
        progressed = False
        for w in fleet.alive_workers():
            while w.in_flight and w.in_flight[0][1] <= now:
                ctx, tdone = w.in_flight.popleft()
                if ctx is not None:
                    w.job.complete_batch(ctx, now=tdone)
                    if (handoff_pause_s is None and t_kill is not None
                            and tdone >= t_kill and moved_parts
                            and any(r.partition in moved_parts
                                    for r in ctx.fresh)):
                        # takeover gap: kill → first inherited-partition
                        # record completed by its new owner
                        handoff_pause_s = tdone - t_kill
                w.on_batch_complete()
                progressed = True
            if len(w.in_flight) < cfg.inflight_depth:
                batch = w.assembler.next_batch(block=False)
                if not batch and next_i >= n:
                    batch = w.assembler.flush()
                if batch:
                    owned = set(w.store.owned())
                    if any(r.partition not in owned for r in batch):
                        affinity_violations += 1
                    ctx = w.job.dispatch_batch(batch, now=now)
                    start = max(now, w.busy_until)
                    done = start + cfg.cost_s(len(batch))
                    w.busy_until = done
                    w.in_flight.append((ctx, done))
                    progressed = True
        if progressed:
            continue
        alive = fleet.alive_workers()
        if (next_i >= n and fleet.lag() == 0
                and not any(w.in_flight for w in alive)
                and not any(w.assembler._pending for w in alive)):
            break
        targets: List[float] = []
        if next_i < n:
            targets.append(sched[next_i][0])
        for w in alive:
            if w.in_flight:
                targets.append(w.in_flight[0][1])
            if w.assembler._first_ts is not None:
                targets.append(w.assembler._first_ts
                               + cfg.max_delay_ms / 1e3)
        if plan is not None:
            for fw in plan.windows:
                for edge in (fw.t_start, fw.t_end):
                    if edge > now:
                        targets.append(edge)
        clock[0] = max(now + 1e-9,
                       min(targets) if targets else now + 0.01)

    makespan = clock[0]

    # ---- ledger: read the predictions topic back (one pass: the scored
    # ledger AND the per-key ordering check — within each predictions
    # partition every user's transactions must appear in event order; txn
    # ids are globally sequence-numbered by the generator) ----------------
    preds: List[Tuple[str, float, str, str]] = []
    order_ok = True
    last_seq: Dict[Tuple[int, str], int] = {}
    pred_part: Dict[str, int] = {}
    for p in range(broker.partitions(T.PREDICTIONS)):
        off = 0
        while True:
            recs = broker.read(T.PREDICTIONS, p, off, 4096)
            if not recs:
                break
            off = recs[-1].offset + 1
            for r in recs:
                v = r.value if isinstance(r.value, dict) else {}
                ex = v.get("explanation") or {}
                kind = ("shed" if ex.get("shed")
                        else "replayed" if ex.get("replayed_from_cache")
                        else "error" if ex.get("error")
                        else "scored")
                tid = str(v.get("transaction_id", ""))
                preds.append((tid,
                              round(float(v.get("fraud_score", -1.0)), 6),
                              str(v.get("decision", "")), kind))
                uid = str(r.key or "")
                try:
                    seq = int(tid.rsplit("_", 1)[-1])
                except ValueError:
                    continue
                keyp = (p, uid)
                if last_seq.get(keyp, -1) >= seq:
                    order_ok = False
                last_seq[keyp] = seq
                pred_part[tid] = p

    tx_ends = broker.end_offsets(T.TRANSACTIONS)
    committed = [broker.committed(fleet.group_id, T.TRANSACTIONS, p)
                 for p in range(len(tx_ends))]

    digests: Dict[int, str] = {}
    for w in fleet.alive_workers():
        for p, d in w.store.digests(now=makespan).items():
            digests[p] = d

    digest = hashlib.sha256(json.dumps({
        "preds": sorted(preds),
        "committed": committed,
        "assignment": fleet.assignment(),
        "state": sorted(digests.items()),
        "events": [{k: (round(v, 6) if isinstance(v, float) else v)
                    for k, v in ev.items()} for ev in fleet.events],
    }, sort_keys=True).encode()).hexdigest()

    return {
        "n_workers": n_workers,
        "kill_target": kill_target,
        "makespan_s": round(makespan, 4),
        "preds": preds,
        "committed": committed,
        "tx_ends": tx_ends,
        "order_ok": order_ok,
        "digests": digests,
        "affinity_violations": affinity_violations,
        "handoff_pause_s": (round(handoff_pause_s, 4)
                            if handoff_pause_s is not None else None),
        "moved_partitions": sorted(moved_parts),
        "pre_kill_assignment": pre_kill_assignment,
        "fleet": fleet.snapshot(),
        "counters": fleet.counters(),
        "router": fleet.router,
        "digest": digest,
    }


# ------------------------------------------------------------------ drill


def run_shard_drill(config: Optional[ShardDrillConfig] = None,
                    fast: bool = False) -> Dict[str, Any]:
    """Run the shard drill: fleet-with-kill vs single-worker oracle, plus
    the bit-identical replay; assemble the verdict."""
    cfg = config or (ShardDrillConfig.fast() if fast
                     else ShardDrillConfig())
    sched = build_schedule(cfg)
    fleet_out = run_fleet(cfg, sched, cfg.n_workers, kill=True)
    oracle_out = run_fleet(cfg, sched, 1, kill=False)

    produced = [str(txn["transaction_id"]) for _, txn in sched]
    by_id: Dict[str, Dict[str, int]] = {}
    score_by_id: Dict[str, float] = {}
    for tid, score, _dec, kind in fleet_out["preds"]:
        by_id.setdefault(tid, {})
        by_id[tid][kind] = by_id[tid].get(kind, 0) + 1
        if kind == "scored":
            score_by_id[tid] = score
    oracle_scores = {tid: score
                     for tid, score, _dec, kind in oracle_out["preds"]
                     if kind == "scored"}

    covered = set(by_id)
    lost = len(set(produced) - covered)
    double = sum(1 for kinds in by_id.values()
                 if kinds.get("scored", 0) + kinds.get("error", 0) > 1)
    score_mismatches = sum(
        1 for tid, s in score_by_id.items()
        if oracle_scores.get(tid) != s)

    # router agreement + bounded movement
    router = fleet_out["router"]
    fleet_assign = fleet_out["fleet"]["router"]["assignment"]
    owner_of = {p: m for m, parts in fleet_assign.items() for p in parts}
    sample_users = {str(txn["user_id"]) for _, txn in sched[::97]}
    router_disagreements = sum(
        1 for uid in sample_users
        if router.route(uid) != owner_of.get(router.partition_of(uid)))
    pre = fleet_out["pre_kill_assignment"]
    post = {m: set(parts) for m, parts in fleet_assign.items()}
    survivors_stable = all(
        set(parts) <= post.get(m, set())
        for m, parts in pre.items() if m in post)
    moved = set(fleet_out["moved_partitions"])
    dead_parts = set(pre.get(fleet_out["kill_target"] or "", ()))

    replay_identical = None
    if cfg.replay_check:
        second = run_fleet(cfg, build_schedule(cfg), cfg.n_workers,
                            kill=True)
        replay_identical = second["digest"] == fleet_out["digest"]

    fl = fleet_out["fleet"]
    checks = {
        "workers_enough": cfg.n_workers >= 4,
        "worker_killed": fl["kills"] == 1,
        "zero_lost": lost == 0,
        "zero_double_scored": double == 0,
        "every_txn_scored_once": all(
            kinds.get("scored", 0) == 1 for kinds in by_id.values())
        and covered == set(produced),
        "offsets_gap_free": (fleet_out["committed"]
                             == fleet_out["tx_ends"]),
        "per_key_order_preserved": fleet_out["order_ok"],
        "state_equals_oracle": (fleet_out["digests"]
                                == oracle_out["digests"]),
        "scores_equal_oracle": score_mismatches == 0,
        "handoff_replay_exercised": fl["replayed_total"] >= 1,
        "handoff_observed": fleet_out["handoff_pause_s"] is not None,
        "affinity_clean": fleet_out["affinity_violations"] == 0,
        "router_agrees_with_fleet": router_disagreements == 0,
        "only_dead_partitions_moved": (moved == dead_parts
                                       and survivors_stable),
    }
    if replay_identical is not None:
        checks["replay_bit_identical"] = bool(replay_identical)

    summary: Dict[str, Any] = {
        "metric": "shard_drill",
        "passed": all(bool(v) for v in checks.values()),
        "checks": checks,
        "n_workers": cfg.n_workers,
        "n_partitions": cfg.n_partitions,
        "num_users": cfg.num_users,
        "produced": len(produced),
        "scored": fleet_out["counters"]["scored"],
        "duplicates_skipped": fleet_out["counters"]["duplicates_skipped"],
        "lost": lost,
        "double_scored": double,
        "score_mismatches": score_mismatches,
        "router_disagreements": router_disagreements,
        "moved_partitions": sorted(moved),
        "dead_worker_partitions": sorted(dead_parts),
        "handoff_pause_s": fleet_out["handoff_pause_s"],
        "replayed_total": fl["replayed_total"],
        "checkpoints_total": fl["checkpoints_total"],
        "fleet_makespan_s": fleet_out["makespan_s"],
        "oracle_makespan_s": oracle_out["makespan_s"],
        "virtual_speedup_vs_oracle": round(
            oracle_out["makespan_s"]
            / max(fleet_out["makespan_s"], 1e-9), 3),
        "fleet": {k: v for k, v in fl.items() if k != "events"},
        "events": fl["events"],
        "replay_identical": replay_identical,
        "digest": fleet_out["digest"],
    }
    return summary


def compact_shard_summary(summary: Dict[str, Any]) -> Dict[str, Any]:
    """The <2 KB final-stdout-line digest (bench.py convention: full
    result on the preceding line, compact parseable verdict last)."""
    compact = {
        "metric": "shard_drill",
        "passed": summary.get("passed"),
        "checks": {k: bool(v)
                   for k, v in (summary.get("checks") or {}).items()},
        "n_workers": summary.get("n_workers"),
        "num_users": summary.get("num_users"),
        "produced": summary.get("produced"),
        "scored": summary.get("scored"),
        "lost": summary.get("lost"),
        "double_scored": summary.get("double_scored"),
        "score_mismatches": summary.get("score_mismatches"),
        "moved_partitions": summary.get("moved_partitions"),
        "handoff_pause_s": summary.get("handoff_pause_s"),
        "replayed_total": summary.get("replayed_total"),
        "virtual_speedup_vs_oracle": summary.get(
            "virtual_speedup_vs_oracle"),
        "digest": (summary.get("digest") or "")[:16],
        "summary_of": "full result JSON on the preceding stdout line",
    }
    line = json.dumps(compact, separators=(",", ":"))
    while len(line.encode()) >= 2048:
        for victim in ("checks", "moved_partitions", "digest",
                       "summary_of"):
            if compact.pop(victim, None) is not None:
                break
        else:
            compact = {"metric": "shard_drill",
                       "passed": summary.get("passed")}
        line = json.dumps(compact, separators=(",", ":"))
    return compact


# ------------------------------------------------------------- bench hook


def run_shard_scaling(seed: int = 7,
                      workers: Tuple[int, ...] = (1, 2, 4),
                      ) -> Dict[str, Any]:
    """The benchmark's ``shard_scaling`` stage: aggregate virtual txn/s at
    each worker count over one saturating schedule (offered load at 1.5x
    the largest fleet's capacity, so every fleet is compute-bound and the
    makespan ratio is the scaling), plus the kill run's handoff pause."""
    base = ShardDrillConfig.fast()
    cfg = dataclasses.replace(
        base, seed=seed, replay_check=False,
        tps=max(workers) * 1.5 * base.capacity_tps())
    sched = build_schedule(cfg)
    per_w: Dict[int, Dict[str, Any]] = {}
    for w in sorted(workers):
        out = run_fleet(dataclasses.replace(cfg, n_workers=w), sched, w,
                        kill=False)
        per_w[w] = {
            "makespan_s": out["makespan_s"],
            "txn_per_s": round(len(sched) / max(out["makespan_s"], 1e-9), 1),
        }
    kill_out = run_fleet(cfg, sched, max(workers), kill=True)
    w1 = per_w[min(workers)]["txn_per_s"]
    wmax = max(workers)
    return {
        "n_txns": len(sched),
        "n_partitions": cfg.n_partitions,
        "workers": {str(w): v for w, v in per_w.items()},
        "single_worker_txn_per_s": w1,
        "aggregate_txn_per_s": per_w[wmax]["txn_per_s"],
        "scaling_vs_single": round(per_w[wmax]["txn_per_s"]
                                   / max(w1, 1e-9), 3),
        "scaling_efficiency": round(
            per_w[wmax]["txn_per_s"] / max(w1, 1e-9) / wmax, 3),
        "handoff": {
            "pause_s": kill_out["handoff_pause_s"],
            "replayed": kill_out["fleet"]["replayed_total"],
            "moved_partitions": len(kill_out["moved_partitions"]),
        },
    }
