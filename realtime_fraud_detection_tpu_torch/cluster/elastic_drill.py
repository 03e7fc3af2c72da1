"""Elastic drill: prove the distributed, autoscaled process fleet.

Port of the JAX package's ``cluster/elastic_drill.py``. ``elastic-drill``
is the acceptance drill of the process-mode cluster (cluster/procfleet.py).
One seeded diurnal-ramp timeline (``sim/arrivals.DiurnalBurstProcess``) over
a **10M-user id space** drives a fleet of REAL OS worker processes (spawned
``cluster-worker`` subprocesses in one consumer group over the TCP
netbroker; the card is hidden from them), with:

- an **elastic autoscale controller** (cluster/autoscale.py) feeding the
  tuning plane's arrival forecaster into target worker count — the fleet
  grows AHEAD of the forecast peak (scale-up = spawn + network-checkpoint
  restore + committed-gap replay) and drains after it (scale-down =
  graceful final checkpoint + offset commit before exit);
- a **real SIGKILL** at the busiest worker mid-peak (the chaos plane's
  ``WorkerKill`` bound to the ``ProcessFleet`` — the kernel delivers the
  fault, returncode ``-9`` is checked), recovered through the network
  handoff store's fence + sha256-verified restore + replay path.

Checked contract (all enforced, fast AND full):

- **effectively-once scoring**: zero lost transactions, zero records
  whose scored emissions disagree, committed offsets gap-free at every
  partition's end, per-key order preserved on first emission, and the
  final per-partition state digests EQUAL a single-process oracle that
  applies each partition's records in offset order (scores are
  state-coupled — a lost velocity update or a double-applied profile
  write flips later scores, so the equality is falsifiable). Emission is
  at-least-once across the SIGKILL window by design — a prediction
  produced in the instant between fan-out and commit is re-emitted with
  an IDENTICAL score by the inheritor, and downstream consumers dedupe
  by transaction id (the job's documented contract); the drill
  counts those duplicates and proves none of them disagree.
- **autoscaler ahead of the ramp**: at every decision boundary the
  provisioned capacity (ledger target × per-worker capacity) covers the
  TRUE diurnal envelope rate at that instant (a reactive scaler trails a
  steep ramp and fails this), the last scale-up decision lands before
  the peak and reaches the max target, ≥ 8 distinct workers join the
  ring and serve, and after the ramp the controller drains the fleet
  back to the floor (peak CONCURRENCY is wall-dependent and reported,
  never gated — a loaded machine can stretch a spawn past the scale
  window without changing what the fleet scored or where);
- **bounded movement**: every rebalance moves only the joining/leaving/
  dead workers' partitions (consistent hashing — survivors' partitions
  never move), ~K/N per single-member change;
- **deterministic verdict**: a second fully fresh run (new broker, new
  handoff dir, new processes) produces the same sha256 digest over the
  content invariants + the autoscale decision ledger. Host-timing fields
  (wall latencies, rebalance pauses, spawn timings) are reported but
  excluded from the digest — the machine's scheduler is not part of the
  contract.

The 10M-user population is an id SPACE, not 10M materialized profiles:
a seeded synthetic stream draws a hot cohort (repeat customers — the
state the oracle comparison exercises) plus a uniform long tail across
the full space, schema-complete for the stream sanitizer, O(1) memory.
(``TransactionGenerator`` at 10M users materializes ~3.6 GB of profiles
the drill's state-coupled stand-in scorer never reads.)

``run_elastic_scaling`` is the benchmark's ``elastic_scaling`` hook: the
process fleet pinned at each worker count over the TCP broker, host work
only (its workers never open a CUDA context).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from realtime_fraud_detection_tpu_torch.cluster.autoscale import (
    AutoscaleController,
)
from realtime_fraud_detection_tpu_torch.cluster.procfleet import (
    DIGEST_NOW,
    ProcessFleet,
)
from realtime_fraud_detection_tpu_torch.sim.arrivals import (
    DiurnalBurstConfig,
    DiurnalBurstProcess,
)
from realtime_fraud_detection_tpu_torch.stream import topics as T

__all__ = ["ElasticDrillConfig", "run_elastic_drill",
           "compact_elastic_summary", "build_elastic_schedule",
           "run_elastic_scaling"]


def _wall() -> float:
    # real OS processes are paced/measured on the wall clock by definition
    # rtfd-lint: allow[wall-clock] real OS processes are paced/measured on the wall clock by definition
    return time.time()


@dataclasses.dataclass
class ElasticDrillConfig:
    """Drill sizes. Defaults = the full drill (10M-user id space);
    ``fast()`` = the tier-1 smoke — same fleet shape (>= 8 processes, the
    kill, the full autoscale cycle), compressed timeline."""

    seed: int = 7
    n_partitions: int = 12          # the transactions topic's contract
    num_users: int = 10_000_000
    num_merchants: int = 2_000
    hot_users: int = 4_000          # repeat-customer cohort (state depth)
    hot_frac: float = 0.35
    # offered load: one diurnal cycle, peak mid-run
    duration_s: float = 28.0
    trough_tps: float = 250.0
    peak_tps: float = 1_600.0
    burst_mult: float = 1.25        # mild bursts ride the full config
    burst_every_s: float = 9.0
    burst_duration_s: float = 0.5
    # fleet + autoscale: per_worker_tps is the controller's capacity
    # model; the service-cost model below keeps real capacity ~20% above
    # it so an adequately-scaled fleet drains its backlog
    min_workers: int = 4
    max_workers: int = 8
    per_worker_tps: float = 250.0
    headroom: float = 1.25
    lead_s: float = 2.0
    decide_interval_s: float = 0.5
    down_patience: int = 4
    forecast_bucket_s: float = 0.25
    # worker knobs (wall-time service-cost model stands in for device
    # compute, like the in-process drills' virtual cost — paid for real)
    batch: int = 64
    max_delay_ms: float = 25.0
    checkpoint_every: int = 5
    base_ms: float = 10.0
    per_txn_ms: float = 3.2
    autotune: bool = True           # tuner trials in-flight depth live
    autotune_interval: int = 10     # short epochs: depth trials fit a run
    # the SIGKILL lands at this fraction of the timeline (the peak)
    kill_frac: float = 0.5
    ack_timeout_s: float = 120.0
    drain_timeout_s: float = 180.0
    # second, fully fresh run compared digest-for-digest with the first
    replay_check: bool = True

    @classmethod
    def fast(cls) -> "ElasticDrillConfig":
        """Tier-1 smoke: every phase (autoscale cycle, >= 8 processes,
        SIGKILL, replay, drain) still runs; timeline and id space shrink.
        """
        return cls(num_users=200_000, num_merchants=400, hot_users=1_500,
                   duration_s=12.0, trough_tps=100.0, peak_tps=700.0,
                   burst_mult=1.0, burst_duration_s=0.0,
                   per_worker_tps=110.0, lead_s=1.5, down_patience=3,
                   base_ms=10.0, per_txn_ms=7.0, checkpoint_every=4)

    def peak_time(self) -> float:
        return 0.5 * self.duration_s     # raised-cosine peak, one cycle

    def envelope(self) -> DiurnalBurstProcess:
        """The burst-free diurnal envelope — the deterministic intensity
        the ahead-of-ramp check compares provisioned capacity against
        (bursts are absorbed by headroom, not by permanent capacity)."""
        return DiurnalBurstProcess(DiurnalBurstConfig(
            trough_tps=self.trough_tps, peak_tps=self.peak_tps,
            period_s=self.duration_s, burst_duration_s=0.0),
            seed=self.seed)

    def arrivals(self) -> DiurnalBurstProcess:
        return DiurnalBurstProcess(DiurnalBurstConfig(
            trough_tps=self.trough_tps, peak_tps=self.peak_tps,
            period_s=self.duration_s, burst_mult=max(1.0, self.burst_mult),
            burst_every_s=self.burst_every_s,
            burst_duration_s=self.burst_duration_s), seed=self.seed)


# ------------------------------------------------------------- the stream


def build_elastic_schedule(cfg: ElasticDrillConfig,
                           ) -> List[Tuple[float, Dict[str, Any]]]:
    """Seeded (event_ts, txn) timeline: diurnal arrival instants joined to
    a synthetic transaction stream over the 10M-user id space — a hot
    repeat-customer cohort (per-user state actually accumulates) plus a
    uniform long tail, schema-complete for ``sanitize_for_stream``."""
    times = cfg.arrivals().generate(cfg.duration_s)
    n = len(times)
    rng = np.random.default_rng(cfg.seed + 1)
    hot_pool = rng.integers(0, cfg.num_users, size=max(1, cfg.hot_users))
    take_hot = rng.random(n) < cfg.hot_frac
    uid_idx = np.where(
        take_hot,
        hot_pool[rng.integers(0, len(hot_pool), size=n)],
        rng.integers(0, cfg.num_users, size=n))
    mid_idx = rng.integers(0, cfg.num_merchants, size=n)
    amounts = np.round(rng.lognormal(3.2, 0.9, size=n), 2)
    sched: List[Tuple[float, Dict[str, Any]]] = []
    for i in range(n):
        t = round(float(times[i]), 9)
        sched.append((t, {
            "transaction_id": f"etx_{i}",
            "user_id": f"user_{int(uid_idx[i])}",
            "merchant_id": f"m_{int(mid_idx[i])}",
            "amount": float(amounts[i]),
            "payment_method": "card",
            "event_ts": t,
        }))
    return sched


# ---------------------------------------------------------------- oracle


def run_elastic_oracle(cfg: ElasticDrillConfig,
                       sched: List[Tuple[float, Dict[str, Any]]],
                       ) -> Dict[str, Any]:
    """Single-process oracle: apply each partition's records in offset
    (== schedule) order through the SAME state-coupled scorer the workers
    run. Per-user state lives entirely inside the user's partition, so
    this is exactly the state/score truth any correct fleet must land on,
    independent of batching, membership, kills, or rebalances."""
    from realtime_fraud_detection_tpu_torch.cluster.drill import ShardScorer
    from realtime_fraud_detection_tpu_torch.cluster.partition import (
        PartitionedStore,
    )

    store = PartitionedStore(
        cfg.n_partitions, seq_len=4, feature_dim=4,
        cache_kwargs={"txn_ttl_s": 1e12, "features_ttl_s": 1e12})
    for p in range(cfg.n_partitions):
        store.acquire(p)
    scorer = ShardScorer(store)
    scores: Dict[str, Tuple[float, str]] = {}
    for _, txn in sched:
        res = scorer._score_and_update(txn)
        scores[res["transaction_id"]] = (res["fraud_score"],
                                         res["decision"])
    return {
        "scores": scores,
        "digests": {p: d for p, d in store.digests(now=DIGEST_NOW).items()},
    }


# ------------------------------------------------------------- fleet run


def _run_elastic_fleet(cfg: ElasticDrillConfig,
                       sched: List[Tuple[float, Dict[str, Any]]],
                       ) -> Dict[str, Any]:
    """One fresh fleet run over the schedule: own broker server, own
    handoff server + blob dir, own worker processes. Returns the raw
    outcome (ledger, digests, autoscale ledger, fleet events, digest)."""
    from realtime_fraud_detection_tpu_torch.chaos.faults import (
        ChaosPlan,
        FaultWindow,
        WorkerKill,
    )
    from realtime_fraud_detection_tpu_torch.stream.netbroker import BrokerServer
    from realtime_fraud_detection_tpu_torch.tuning.forecast import (
        ArrivalForecaster,
    )

    broker_srv = BrokerServer(port=0).start()
    tmp = tempfile.mkdtemp(prefix="rtfd-elastic-")
    handoff_srv = None
    fleet = None
    try:
        from realtime_fraud_detection_tpu_torch.cluster.handoff import (
            HandoffServer,
        )

        handoff_srv = HandoffServer(
            blob_dir=os.path.join(tmp, "blobs")).start()
        fleet = ProcessFleet(
            f"127.0.0.1:{broker_srv.port}",
            f"127.0.0.1:{handoff_srv.port}",
            n_partitions=cfg.n_partitions,
            ack_timeout_s=cfg.ack_timeout_s,
            worker_spec={
                "batch": cfg.batch, "max_delay_ms": cfg.max_delay_ms,
                "checkpoint_every": cfg.checkpoint_every,
                "seq_len": 4, "feature_dim": 4,
                "base_ms": cfg.base_ms, "per_txn_ms": cfg.per_txn_ms,
                "autotune": cfg.autotune,
                "autotune_interval": cfg.autotune_interval,
            })
        controller = AutoscaleController(
            per_worker_tps=cfg.per_worker_tps,
            min_workers=cfg.min_workers, max_workers=cfg.max_workers,
            headroom=cfg.headroom, lead_s=cfg.lead_s,
            decide_interval_s=cfg.decide_interval_s,
            down_patience=cfg.down_patience,
            forecaster=ArrivalForecaster(bucket_s=cfg.forecast_bucket_s))
        t_spawn0 = _wall()
        fleet.start(cfg.min_workers, now=0.0)
        spawn_floor_s = round(_wall() - t_spawn0, 3)

        t_kill = cfg.kill_frac * cfg.duration_s
        plan = ChaosPlan([FaultWindow("worker_kill", "cluster",
                                      t_kill, t_kill + 0.05)])
        kill = WorkerKill(fleet, "busiest")
        plan.bind("worker_kill", kill)

        alive_timeline: List[Tuple[float, int]] = []
        start_wall = _wall()
        next_i, n = 0, len(sched)
        produced = 0
        while True:
            now_ev = _wall() - start_wall
            if next_i < n:
                j = next_i
                items = []
                while j < n and sched[j][0] <= now_ev:
                    t_ev, txn = sched[j]
                    items.append((txn["user_id"], txn, start_wall + t_ev))
                    # strict event order into the controller: boundary
                    # decisions interleave deterministically (autoscale.py)
                    controller.observe(t_ev, 1)
                    j += 1
                if items:
                    fleet.client.produce_batch_stamped(T.TRANSACTIONS,
                                                       items)
                    produced += len(items)
                    next_i = j
            controller.observe(now_ev, 0)
            plan.poll(now_ev)
            fleet.tick(now_ev)
            # asynchronous scale execution: spawns never stall production
            # (the forecast lead pays for startup), joins batch into one
            # rebalance per loop pass, drains stay graceful
            fleet.ensure_target(controller.target, now=now_ev)
            alive_timeline.append((round(now_ev, 3),
                                   len(fleet.ready_ids())))
            if next_i >= n:
                lag = fleet.client.lag(fleet.group_id, T.TRANSACTIONS)
                if lag == 0 and controller.target == len(fleet.ready_ids()) \
                        and controller.target == cfg.min_workers:
                    break
                if now_ev > cfg.duration_s + cfg.drain_timeout_s:
                    raise RuntimeError(
                        f"drain timeout: lag={lag} "
                        f"target={controller.target} "
                        f"alive={len(fleet.ready_ids())}")
            time.sleep(0.02)
        makespan = _wall() - start_wall

        fleet.shutdown_all(now=_wall() - start_wall)
        byes = fleet.all_byes()   # drained workers' summaries included
        digests: Dict[int, str] = {}
        counters = {"scored": 0, "duplicates_skipped": 0, "errors": 0,
                    "batches": 0}
        lat_by_depth: Dict[str, Dict[str, Any]] = {}
        for wid, bye in sorted(byes.items()):
            for p, d in (bye.get("digests") or {}).items():
                digests[int(p)] = d
            for k in counters:
                counters[k] += int((bye.get("counters") or {}).get(k, 0))
            for depth, stats in (bye.get("latency_by_depth") or {}).items():
                cur = lat_by_depth.setdefault(depth, {"n": 0, "p99_ms": 0.0})
                cur["n"] += stats["n"]
                cur["p99_ms"] = max(cur["p99_ms"], stats["p99_ms"])

        # ---- predictions ledger: one pass over the topic (coverage +
        # score agreement + first-emission per-key order) ------------------
        inner = broker_srv.broker
        preds: Dict[str, List[Tuple[float, str, str]]] = {}
        order_ok = True
        last_seq: Dict[Tuple[int, str], int] = {}
        emissions = 0
        for p in range(inner.partitions(T.PREDICTIONS)):
            off = 0
            while True:
                recs = inner.read(T.PREDICTIONS, p, off, 4096)
                if not recs:
                    break
                off = recs[-1].offset + 1
                for r in recs:
                    v = r.value if isinstance(r.value, dict) else {}
                    ex = v.get("explanation") or {}
                    kind = ("replayed" if ex.get("replayed_from_cache")
                            else "error" if ex.get("error") else "scored")
                    tid = str(v.get("transaction_id", ""))
                    emissions += 1
                    first = tid not in preds
                    preds.setdefault(tid, []).append(
                        (round(float(v.get("fraud_score", -1.0)), 6),
                         str(v.get("decision", "")), kind))
                    if first:
                        uid = str(r.key or "")
                        try:
                            seq = int(tid.rsplit("_", 1)[-1])
                        except ValueError:
                            continue
                        keyp = (p, uid)
                        if last_seq.get(keyp, -1) >= seq:
                            order_ok = False
                        last_seq[keyp] = seq

        tx_ends = inner.end_offsets(T.TRANSACTIONS)
        committed = [inner.committed(fleet.group_id, T.TRANSACTIONS, p)
                     for p in range(len(tx_ends))]

        snap = fleet.snapshot()
        auto = controller.snapshot()
        digest = hashlib.sha256(json.dumps({
            "produced": produced,
            # unique (score, decision) per transaction: duplicate
            # emissions across the SIGKILL window collapse (identical by
            # the oracle property — checked separately), so the digest
            # depends only on content, never on where the kill landed
            "preds": sorted((tid, sorted({(s, d) for s, d, _ in e}))
                            for tid, e in preds.items()),
            "committed": committed,
            "state": sorted((p, d) for p, d in digests.items()),
            "autoscale": auto["decisions"],
        }, sort_keys=True).encode()).hexdigest()

        return {
            "produced": produced,
            "preds": preds,
            "emissions": emissions,
            "order_ok": order_ok,
            "committed": committed,
            "tx_ends": tx_ends,
            "digests": digests,
            "counters": counters,
            "byes": {w: {k: v for k, v in b.items() if k != "digests"}
                     for w, b in byes.items()},
            "latency_by_depth": lat_by_depth,
            "autoscale": auto,
            "fleet": snap,
            "kill": kill.last_result,
            "t_kill": t_kill,
            "alive_timeline": alive_timeline,
            "spawn_floor_s": spawn_floor_s,
            "handoff_stats": fleet.handoff.stats(),
            "makespan_s": round(makespan, 3),
            "digest": digest,
        }
    finally:
        if fleet is not None:
            fleet.terminate()
        if handoff_srv is not None:
            handoff_srv.stop()
        broker_srv.stop()


# ------------------------------------------------------------------ drill


def _movement_checks(cfg: ElasticDrillConfig,
                     events: List[Dict[str, Any]]) -> Tuple[bool, int]:
    """Only the joining/leaving/dead members' partitions may move on any
    rebalance (survivor stability — the consistent-hash contract), and a
    single-member change stays within ~2x the K/N expectation."""
    ok = True
    max_single = 0
    prev_assign: Optional[Dict[str, List[int]]] = None
    prev_members: set = set()
    for ev in events:
        if ev.get("event") != "rebalance":
            continue
        assign = ev["assignment"]
        members = set(ev["members"])
        if prev_assign is not None:
            joiners = members - prev_members
            leavers = prev_members - members
            owner_old = {p: w for w, ps in prev_assign.items() for p in ps}
            owner_new = {p: w for w, ps in assign.items() for p in ps}
            moved = set(ev["moved"])
            for p in moved:
                # every moved partition either lands ON a joiner or
                # leaves FROM a leaver/dead member — survivors never
                # exchange partitions among themselves
                if owner_new.get(p) not in joiners \
                        and owner_old.get(p) not in leavers:
                    ok = False
            if len(joiners | leavers) == 1:
                bound = 2 * math.ceil(cfg.n_partitions
                                      / max(1, len(members | prev_members)))
                max_single = max(max_single, len(moved))
                if len(moved) > bound:
                    ok = False
        prev_assign, prev_members = assign, members
    return ok, max_single


def run_elastic_drill(config: Optional[ElasticDrillConfig] = None,
                      fast: bool = False) -> Dict[str, Any]:
    """Run the elastic drill: process fleet with SIGKILL + autoscale vs
    the single-process oracle, plus the fresh-run determinism check."""
    cfg = config or (ElasticDrillConfig.fast() if fast
                     else ElasticDrillConfig())
    sched = build_elastic_schedule(cfg)
    oracle = run_elastic_oracle(cfg, sched)
    out = _run_elastic_fleet(cfg, sched)

    produced_ids = {txn["transaction_id"] for _, txn in sched}
    preds = out["preds"]
    lost = len(produced_ids - set(preds))
    conflicting = 0
    score_mismatches = 0
    duplicate_emissions = 0
    for tid, emits in preds.items():
        scored = [(s, d) for s, d, kind in emits if kind == "scored"]
        if len(scored) > 1:
            duplicate_emissions += len(scored) - 1
        if len(set(scored)) > 1:
            conflicting += 1
        want = oracle["scores"].get(tid)
        if scored and want is not None and any(sd != want for sd in scored):
            score_mismatches += 1
    errors = sum(1 for emits in preds.values()
                 for _, _, kind in emits if kind == "error")

    # --- autoscale: provably ahead of the (deterministic) diurnal ramp ---
    env = cfg.envelope()
    decisions = out["autoscale"]["decisions"]
    target_at: List[Tuple[float, int]] = [(0.0, cfg.min_workers)]
    for d in decisions:
        target_at.append((d["t"], d["target"]))
    probe_ts = [i * cfg.decide_interval_s
                for i in range(int(cfg.duration_s / cfg.decide_interval_s)
                               + 1)]

    def _target(t: float) -> int:
        cur = cfg.min_workers
        for td, tg in target_at:
            if td <= t:
                cur = tg
            else:
                break
        return cur

    ahead = all(_target(t) * cfg.per_worker_tps >= env.rate_at(t) - 1e-6
                for t in probe_ts)
    ups = [d for d in decisions if d["direction"] == "up"]
    downs = [d for d in decisions if d["direction"] == "down"]
    peak_t = cfg.peak_time()
    peak_target = max((d["target"] for d in ups), default=cfg.min_workers)
    scaled_up_before_peak = bool(ups) and ups[-1]["t"] < peak_t \
        and peak_target >= 8
    drained_after_peak = bool(downs) and all(d["t"] > peak_t for d in downs)
    max_alive = max(a for _, a in out["alive_timeline"])
    final_alive = out["alive_timeline"][-1][1]
    # distinct workers that actually joined the ring and served — the
    # deterministic form of "scored across >= 8 OS processes" (peak
    # CONCURRENCY is wall-dependent: on a loaded box a spawn can outlast
    # the scale window; it is reported, never gated)
    joiners = set()
    for ev in out["fleet"]["events"]:
        if ev.get("event") == "rebalance":
            joiners.update(ev.get("members") or ())
    movement_ok, max_single_move = _movement_checks(
        cfg, out["fleet"]["events"])

    kill = out["kill"] or {}
    replayed_after_kill = int(kill.get("replayed", 0))

    replay_identical = None
    second_digest = None
    if cfg.replay_check:
        second = _run_elastic_fleet(cfg, sched)
        second_digest = second["digest"]
        replay_identical = second_digest == out["digest"]

    distinct_pids = {st["pid"]
                     for st in out["fleet"]["workers"].values()}
    checks = {
        "processes_real": (len(distinct_pids)
                           == len(out["fleet"]["workers"])
                           and os.getpid() not in distinct_pids),
        "processes_enough": (out["fleet"]["spawns"] >= 8
                             and len(joiners) >= 8
                             and peak_target == cfg.max_workers),
        "sigkill_real": (bool(kill.get("killed"))
                         and kill.get("returncode") == -9),
        "zero_lost": lost == 0,
        "zero_double_scored": conflicting == 0,
        "zero_errors": errors == 0,
        "offsets_gap_free": out["committed"] == out["tx_ends"],
        "per_key_order_preserved": out["order_ok"],
        "state_equals_oracle": out["digests"] == oracle["digests"],
        "scores_equal_oracle": score_mismatches == 0,
        "handoff_replay_exercised": replayed_after_kill >= 1,
        "autoscale_ahead_of_ramp": ahead,
        "scaled_up_before_peak": scaled_up_before_peak,
        "drained_after_peak": (drained_after_peak
                               and final_alive == cfg.min_workers),
        "movement_bounded": movement_ok,
    }
    if replay_identical is not None:
        checks["replay_deterministic"] = bool(replay_identical)

    summary: Dict[str, Any] = {
        "metric": "elastic_drill",
        "passed": all(bool(v) for v in checks.values()),
        "checks": checks,
        "num_users": cfg.num_users,
        "n_partitions": cfg.n_partitions,
        "produced": out["produced"],
        "scored": out["counters"]["scored"],
        "emissions": out["emissions"],
        "duplicate_emissions": duplicate_emissions,
        "lost": lost,
        "conflicting_scored": conflicting,
        "score_mismatches": score_mismatches,
        "processes_spawned": out["fleet"]["spawns"],
        "workers_joined": len(joiners),
        "max_alive": max_alive,
        "final_alive": final_alive,
        "kill": kill,
        "t_kill": out["t_kill"],
        "replayed_after_kill": replayed_after_kill,
        "replayed_total": out["fleet"]["replayed_total"],
        "handoffs_total": out["fleet"]["handoffs_total"],
        "handoff_server": out["handoff_stats"],
        "autoscale_decisions": decisions,
        "autoscale_events": out["autoscale"]["events"],
        "peak_time_s": peak_t,
        "max_single_member_move": max_single_move,
        # wall-clock report (NEVER in the digest): real-machine numbers
        "wall": {
            "makespan_s": out["makespan_s"],
            "spawn_floor_s": out["spawn_floor_s"],
            "rebalance_pauses_s": out["fleet"]["rebalance_pauses_s"],
            "latency_by_depth_ms": out["latency_by_depth"],
        },
        "events": out["fleet"]["events"],
        "replay_identical": replay_identical,
        "digest": out["digest"],
        "second_digest": second_digest,
    }
    return summary


def compact_elastic_summary(summary: Dict[str, Any]) -> Dict[str, Any]:
    """The <2 KB final-stdout-line verdict (bench.py convention: full
    result on the preceding line, compact parseable verdict last)."""
    compact = {
        "metric": "elastic_drill",
        "passed": summary.get("passed"),
        "checks": {k: bool(v)
                   for k, v in (summary.get("checks") or {}).items()},
        "num_users": summary.get("num_users"),
        "produced": summary.get("produced"),
        "scored": summary.get("scored"),
        "lost": summary.get("lost"),
        "conflicting_scored": summary.get("conflicting_scored"),
        "duplicate_emissions": summary.get("duplicate_emissions"),
        "processes_spawned": summary.get("processes_spawned"),
        "workers_joined": summary.get("workers_joined"),
        "max_alive": summary.get("max_alive"),
        "kill_returncode": (summary.get("kill") or {}).get("returncode"),
        "replayed_after_kill": summary.get("replayed_after_kill"),
        "autoscale_events": summary.get("autoscale_events"),
        "makespan_s": (summary.get("wall") or {}).get("makespan_s"),
        "digest": (summary.get("digest") or "")[:16],
        "summary_of": "full result JSON on the preceding stdout line",
    }
    line = json.dumps(compact, separators=(",", ":"))
    while len(line.encode()) >= 2048:
        for victim in ("checks", "autoscale_events", "digest",
                       "summary_of"):
            if compact.pop(victim, None) is not None:
                break
        else:
            compact = {"metric": "elastic_drill",
                       "passed": summary.get("passed")}
        line = json.dumps(compact, separators=(",", ":"))
    return compact


# ------------------------------------------------------------- bench hook


def run_elastic_scaling(seed: int = 7,
                        workers: Tuple[int, ...] = (2, 4, 8),
                        n_txns: int = 3_000) -> Dict[str, Any]:
    """The benchmark's ``elastic_scaling`` stage: real aggregate txn/s of
    the process fleet pinned at each worker count over the TCP broker
    (autoscale off), plus a SIGKILL run's rebalance pause and replay
    depth. The per-batch service-cost model is fixed, so the ratio measures
    the orchestration overhead (TCP round trips, partition-scoped
    consumption, commit traffic) on top of perfectly parallel modelled
    compute: the process-plane analog of ``run_shard_scaling``'s virtual
    clock. The workers are ``cluster-worker`` processes with the card
    hidden (``ProcessFleet`` sets ``CUDA_VISIBLE_DEVICES=""``)."""
    from realtime_fraud_detection_tpu_torch.cluster.handoff import HandoffServer
    from realtime_fraud_detection_tpu_torch.stream.netbroker import BrokerServer

    spec = {"batch": 64, "max_delay_ms": 10.0, "checkpoint_every": 6,
            "seq_len": 4, "feature_dim": 4, "base_ms": 6.0,
            "per_txn_ms": 1.2, "autotune": False}
    cfg = dataclasses.replace(ElasticDrillConfig.fast(), seed=seed)
    sched = build_elastic_schedule(cfg)[:n_txns]

    def _one(n_workers: int, kill: bool) -> Dict[str, Any]:
        broker_srv = BrokerServer(port=0).start()
        tmp = tempfile.mkdtemp(prefix="rtfd-escale-")
        handoff_srv = HandoffServer(
            blob_dir=os.path.join(tmp, "blobs")).start()
        fleet = ProcessFleet(
            f"127.0.0.1:{broker_srv.port}",
            f"127.0.0.1:{handoff_srv.port}",
            n_partitions=cfg.n_partitions, worker_spec=spec)
        try:
            fleet.start(n_workers)
            t0 = _wall()
            items = [(txn["user_id"], txn, t + t0) for t, txn in sched]
            fleet.client.produce_batch_stamped(T.TRANSACTIONS, items)
            killed = None
            deadline = _wall() + 240
            while _wall() < deadline:
                fleet.tick()
                lag = fleet.client.lag(fleet.group_id, T.TRANSACTIONS)
                if kill and killed is None and lag < len(sched) // 2:
                    killed = fleet.kill_worker("busiest")
                if lag == 0:
                    break
                time.sleep(0.02)
            else:
                raise RuntimeError("elastic_scaling drain timeout")
            wall = _wall() - t0
            snap = fleet.snapshot()
            return {
                "wall_s": round(wall, 3),
                "txn_per_s": round(len(sched) / max(wall, 1e-9), 1),
                "kill": killed,
                "replayed": snap["replayed_total"],
                "rebalance_pauses_s": snap["rebalance_pauses_s"],
            }
        finally:
            fleet.terminate()
            handoff_srv.stop()
            broker_srv.stop()
            shutil.rmtree(tmp, ignore_errors=True)

    per_w = {w: _one(w, kill=False) for w in sorted(workers)}
    kill_out = _one(max(workers), kill=True)
    w_min, w_max = min(workers), max(workers)
    base = per_w[w_min]["txn_per_s"]
    return {
        "n_txns": len(sched),
        "n_partitions": cfg.n_partitions,
        "workers": {str(w): {k: v for k, v in r.items()
                             if k in ("wall_s", "txn_per_s")}
                    for w, r in per_w.items()},
        "aggregate_txn_per_s": per_w[w_max]["txn_per_s"],
        "scaling_vs_min": round(per_w[w_max]["txn_per_s"]
                                / max(base, 1e-9), 3),
        "scaling_efficiency": round(
            per_w[w_max]["txn_per_s"] / max(base, 1e-9)
            / (w_max / w_min), 3),
        "kill_run": {
            "returncode": (kill_out["kill"] or {}).get("returncode"),
            "replayed": kill_out["replayed"],
            "rebalance_pause_s": (max(kill_out["rebalance_pauses_s"][1:])
                                  if len(kill_out["rebalance_pauses_s"]) > 1
                                  else None),
        },
    }
