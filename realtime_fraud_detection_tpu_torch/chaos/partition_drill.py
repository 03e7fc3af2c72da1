"""Split-brain partition drill: prove the network fault plane end to end.

Port of the JAX package's ``chaos/partition_drill.py``. ``partition-drill``
is the acceptance drill of the network fault plane. One seeded timeline
drives >= 4 REAL OS worker processes (``cluster-worker`` over the TCP
netbroker, the process fleet of cluster/procfleet.py; the card is hidden
from them) while the link-fault layer (chaos/netfaults.py) degrades the
network they live on:

1. **asymmetric partition** at the initially-busiest worker: its
   control-plane traffic (``cluster-control`` fetches, ``cluster-events``
   produces — hellos, heartbeats, acks) is severed while its DATA path
   still reaches the broker. The coordinator's session expiry evicts it,
   fences its partitions (handoff epoch + broker producer generation),
   and reassigns them — while the deaf worker keeps scoring and
   producing. Its stamped produces bounce off the broker's generation
   fence (``StaleGenerationError``, counted): the zombie writer is
   stopped at the WRITE seam, not by luck. When the window heals, its
   hello gets through and it rejoins as a fresh member.
2. **slow link under load** at a second worker: per-frame latency (+
   seeded jitter) on every broker op — scored-traffic p99 inside the
   window vs the same worker's healthy p99 is the drill's
   ``degraded_network`` report (and the bench stage of the same name).
3. **full partition that heals** at a third worker: every broker op
   fails; the worker errors into its bounded ``DeterministicBackoff``
   loop (never crashes, never wedges — the socket-deadline hardening),
   gets evicted, and on heal discovers it was fenced (stale generation /
   fenced epoch), abandons without checkpointing, and rejoins fresh.

Checked contract (all enforced, fast AND full): real distinct processes;
the zombie's post-fence produces refused AND counted (nonzero); zero
lost and zero conflicting-scored transactions vs a single-process
oracle; gap-free committed offsets; per-key order on first emission;
state digest-equal to the oracle; both evicted workers reassigned within
the detection bound (session timeout + slack); both rejoin as fresh
members with no double-ownership interval (fenced abandon evidence +
zero conflicting emissions); scored duplicates bounded and
byte-identical; and a second fully fresh run producing the same sha256
digest over the content invariants (wall-timing fields reported, never
digested, the same policy as ``elastic-drill``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from realtime_fraud_detection_tpu_torch.chaos.faults import ChaosPlan, FaultWindow
from realtime_fraud_detection_tpu_torch.cluster.hashring import HashRing
from realtime_fraud_detection_tpu_torch.cluster.procfleet import (
    CONTROL_TOPIC,
    DIGEST_NOW,
    EVENTS_TOPIC,
    ProcessFleet,
)
from realtime_fraud_detection_tpu_torch.stream import topics as T

__all__ = ["PartitionDrillConfig", "run_partition_drill",
           "compact_partition_summary", "build_partition_schedule",
           "drill_targets"]


def _wall() -> float:
    # real OS processes over real TCP are paced on the wall clock by definition
    # rtfd-lint: allow[wall-clock] real OS processes over real TCP are paced on the wall clock by definition
    return time.time()


@dataclasses.dataclass
class PartitionDrillConfig:
    """Drill sizes. Defaults = the full drill; ``fast()`` = the tier-1
    smoke — same fleet shape (≥ 4 processes, all three fault windows,
    both rejoins), compressed timeline."""

    seed: int = 7
    n_partitions: int = 12          # the transactions topic's contract
    n_workers: int = 5
    num_users: int = 400_000
    num_merchants: int = 1_200
    hot_users: int = 3_000
    hot_frac: float = 0.35
    # offered load: constant-rate seeded Poisson arrivals
    duration_s: float = 24.0
    tps: float = 420.0
    # fault windows, relative to the announced epoch (window t=0).
    # Sequential by design: each fault's recovery must settle before the
    # next one opens, or a rejoin rebalance could wait on a partitioned
    # releaser's ack.
    asym_start: float = 4.0
    asym_end: float = 9.5
    slow_start: float = 11.5
    slow_end: float = 15.0
    slow_latency_s: float = 0.035
    slow_jitter_s: float = 0.01
    full_start: float = 17.0
    full_end: float = 21.0
    # liveness: the drill compresses the session timeout so detection
    # fits the timeline (production default is 30 s)
    session_timeout_s: float = 2.5
    heartbeat_s: float = 0.4
    detection_slack_s: float = 10.0
    # worker knobs (wall-time service-cost model, paid for real)
    batch: int = 64
    max_delay_ms: float = 20.0
    checkpoint_every: int = 5
    base_ms: float = 8.0
    per_txn_ms: float = 1.6
    reconnect_attempts: int = 2     # link faults burn client retries fast
    ack_timeout_s: float = 120.0
    drain_timeout_s: float = 180.0
    # scored-duplicate bound: an evicted worker's produce-then-refused-
    # commit window plus reconnect-epoch re-polls, never a flood
    dup_bound_abs: int = 256
    dup_bound_frac: float = 0.05
    # second, fully fresh run compared digest-for-digest with the first
    replay_check: bool = True

    @classmethod
    def fast(cls) -> "PartitionDrillConfig":
        """Tier-1 smoke: every window, both rejoins, ≥ 4 processes;
        timeline and id space shrink."""
        return cls(n_workers=4, num_users=60_000, num_merchants=400,
                   hot_users=1_200, duration_s=15.0, tps=180.0,
                   asym_start=2.5, asym_end=6.5,
                   slow_start=7.5, slow_end=10.0,
                   full_start=11.0, full_end=13.5,
                   session_timeout_s=2.0, heartbeat_s=0.35,
                   base_ms=7.0, per_txn_ms=2.2, checkpoint_every=4)

    def validate(self) -> None:
        if self.n_workers < 4:
            raise ValueError("partition drill needs >= 4 workers "
                             "(three distinct fault targets + survivors)")
        spans = [(self.asym_start, self.asym_end),
                 (self.slow_start, self.slow_end),
                 (self.full_start, self.full_end)]
        for s, e in spans:
            if not e > s >= 0:
                raise ValueError(f"bad fault window [{s}, {e})")
        for (_, e1), (s2, _) in zip(spans, spans[1:]):
            if s2 < e1:
                raise ValueError(
                    "fault windows must be sequential (a rejoin "
                    "rebalance must never wait on a partitioned "
                    "releaser)")

    def windows(self) -> List[FaultWindow]:
        return [
            FaultWindow("asym_partition", "netfault",
                        self.asym_start, self.asym_end),
            FaultWindow("slow_link", "netfault",
                        self.slow_start, self.slow_end),
            FaultWindow("full_partition", "netfault",
                        self.full_start, self.full_end),
        ]


def drill_targets(cfg: PartitionDrillConfig) -> Dict[str, str]:
    """Deterministic fault targets from the INITIAL ring placement (a
    pure function of membership — the coordinator computes the identical
    assignment): the busiest worker takes the asymmetric partition (the
    kill must threaten real state), the next two distinct workers take
    the slow link and the full partition."""
    ids = [f"w{i}" for i in range(cfg.n_workers)]
    assign = HashRing(ids).assignment(cfg.n_partitions)
    by_load = sorted(ids, key=lambda w: (len(assign.get(w, ())), w),
                     reverse=True)
    return {"zombie": by_load[0], "slow": by_load[1],
            "full": by_load[2]}


# ------------------------------------------------------------- the stream


def build_partition_schedule(cfg: PartitionDrillConfig,
                             ) -> List[Tuple[float, Dict[str, Any]]]:
    """Seeded (event_ts, txn) timeline: constant-rate Poisson arrivals
    joined to a synthetic stream (hot repeat-customer cohort + uniform
    long tail), schema-complete for ``sanitize_for_stream``."""
    rng = np.random.default_rng(cfg.seed)
    n_est = int(cfg.tps * cfg.duration_s * 1.3) + 64
    gaps = rng.exponential(1.0 / cfg.tps, size=n_est)
    times = np.cumsum(gaps)
    times = times[times < cfg.duration_s]
    n = len(times)
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
            "transaction_id": f"ptx_{i}",
            "user_id": f"user_{int(uid_idx[i])}",
            "merchant_id": f"m_{int(mid_idx[i])}",
            "amount": float(amounts[i]),
            "payment_method": "card",
            "event_ts": t,
        }))
    return sched


# ---------------------------------------------------------------- oracle


def run_partition_oracle(cfg: PartitionDrillConfig,
                         sched: List[Tuple[float, Dict[str, Any]]],
                         ) -> Dict[str, Any]:
    """Single-process oracle: each partition's records applied in offset
    (== schedule) order through the same state-coupled scorer the
    workers run — the truth any correct fleet must land on regardless of
    partitions, evictions, fencing, or rejoins."""
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


def _worker_netfault_specs(cfg: PartitionDrillConfig,
                           targets: Dict[str, str],
                           ) -> Dict[str, Dict[str, Any]]:
    """Per-worker spec overlays: each fault target carries exactly its
    own scheduled link windows (JSON-able — they ride the worker spec
    across the process boundary)."""
    ctl_match = {"topics": [CONTROL_TOPIC, EVENTS_TOPIC]}
    return {
        targets["zombie"]: {"netfaults": {"seed": cfg.seed, "windows": [{
            "name": "asym_partition", "kind": "partition",
            "t_start": cfg.asym_start, "t_end": cfg.asym_end,
            "mode": "full", "match": ctl_match,
        }]}},
        targets["slow"]: {
            "netfaults": {"seed": cfg.seed, "windows": [{
                "name": "slow_link", "kind": "degrade",
                "t_start": cfg.slow_start, "t_end": cfg.slow_end,
                "latency_s": cfg.slow_latency_s,
                "jitter_s": cfg.slow_jitter_s,
            }]},
            "phase_windows": {"slow_link": [cfg.slow_start, cfg.slow_end]},
        },
        targets["full"]: {"netfaults": {"seed": cfg.seed, "windows": [{
            "name": "full_partition", "kind": "partition",
            "t_start": cfg.full_start, "t_end": cfg.full_end,
            "mode": "full",
        }]}},
    }


def _run_partition_fleet(cfg: PartitionDrillConfig,
                         sched: List[Tuple[float, Dict[str, Any]]],
                         ) -> Dict[str, Any]:
    """One fresh fleet run over the schedule: own broker server, own
    handoff server + blob dir, own worker processes, own fault windows.
    """
    from realtime_fraud_detection_tpu_torch.cluster.handoff import HandoffServer
    from realtime_fraud_detection_tpu_torch.stream.netbroker import BrokerServer

    targets = drill_targets(cfg)
    broker_srv = BrokerServer(port=0).start()
    tmp = tempfile.mkdtemp(prefix="rtfd-partition-")
    handoff_srv = None
    fleet = None
    try:
        handoff_srv = HandoffServer(
            blob_dir=os.path.join(tmp, "blobs")).start()
        fleet = ProcessFleet(
            f"127.0.0.1:{broker_srv.port}",
            f"127.0.0.1:{handoff_srv.port}",
            n_partitions=cfg.n_partitions,
            ack_timeout_s=cfg.ack_timeout_s,
            session_timeout_s=cfg.session_timeout_s,
            worker_spec={
                "batch": cfg.batch, "max_delay_ms": cfg.max_delay_ms,
                "checkpoint_every": cfg.checkpoint_every,
                "seq_len": 4, "feature_dim": 4,
                "base_ms": cfg.base_ms, "per_txn_ms": cfg.per_txn_ms,
                "heartbeat_s": cfg.heartbeat_s,
                "reconnect_attempts": cfg.reconnect_attempts,
            },
            per_worker_spec=_worker_netfault_specs(cfg, targets))
        fleet.start(cfg.n_workers, now=0.0)

        # coordinator-side window ledger (annotation-only: the real
        # injections run INSIDE the target workers' clients, on the same
        # windows anchored to the same epoch)
        plan = ChaosPlan(cfg.windows())

        t0 = _wall()
        fleet.announce_epoch(t0)
        next_i, n = 0, len(sched)
        produced = 0
        while True:
            now_ev = _wall() - t0
            if next_i < n:
                j = next_i
                items = []
                while j < n and sched[j][0] <= now_ev:
                    t_ev, txn = sched[j]
                    items.append((txn["user_id"], txn, t0 + t_ev))
                    j += 1
                if items:
                    fleet.client.produce_batch_stamped(T.TRANSACTIONS,
                                                       items)
                    produced += len(items)
                    next_i = j
            plan.poll(now_ev)
            fleet.tick(now_ev)
            if next_i >= n and now_ev > cfg.full_end:
                lag = fleet.client.lag(fleet.group_id, T.TRANSACTIONS)
                healed = (fleet.rejoins >= 2
                          and not fleet._pending_rejoins
                          and len(fleet.ready_ids()) == cfg.n_workers)
                if lag == 0 and healed:
                    break
                if now_ev > cfg.duration_s + cfg.drain_timeout_s:
                    raise RuntimeError(
                        f"drain timeout: lag={lag} "
                        f"rejoins={fleet.rejoins} "
                        f"ready={len(fleet.ready_ids())}")
            time.sleep(0.01)
        makespan = _wall() - t0

        broker_status = fleet.client.status()
        fleet.shutdown_all(now=_wall() - t0)
        byes = fleet.all_byes()
        digests: Dict[int, str] = {}
        counters = {"scored": 0, "duplicates_skipped": 0, "errors": 0,
                    "batches": 0}
        for wid, bye in sorted(byes.items()):
            for p, d in (bye.get("digests") or {}).items():
                digests[int(p)] = d
            for k in counters:
                counters[k] += int((bye.get("counters") or {}).get(k, 0))

        # ---- predictions ledger: one pass (coverage + agreement +
        # first-emission per-key order), the elastic-drill discipline ----
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
        digest = hashlib.sha256(json.dumps({
            "produced": produced,
            # unique (score, decision) per transaction: duplicates
            # collapse (byte-identity is checked separately), so the
            # digest depends only on content, never on where inside the
            # windows the evictions landed
            "preds": sorted((tid, sorted({(s, d) for s, d, _ in e}))
                            for tid, e in preds.items()),
            "committed": committed,
            "state": sorted((p, d) for p, d in digests.items()),
            "windows": [[w.name, w.t_start, w.t_end]
                        for w in cfg.windows()],
        }, sort_keys=True).encode()).hexdigest()

        return {
            "targets": targets,
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
            "fleet": snap,
            "plan": plan.snapshot(now=makespan),
            "broker_status": broker_status,
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


def run_partition_drill(config: Optional[PartitionDrillConfig] = None,
                        fast: bool = False) -> Dict[str, Any]:
    """Run the partition drill: real process fleet under link chaos vs
    the single-process oracle, plus the fresh-run determinism check."""
    cfg = config or (PartitionDrillConfig.fast() if fast
                     else PartitionDrillConfig())
    cfg.validate()
    sched = build_partition_schedule(cfg)
    oracle = run_partition_oracle(cfg, sched)
    out = _run_partition_fleet(cfg, sched)
    targets = out["targets"]

    produced_ids = {txn["transaction_id"] for _, txn in sched}
    preds = out["preds"]
    lost = len(produced_ids - set(preds))
    conflicting = 0
    score_mismatches = 0
    scored_duplicates = 0
    for tid, emits in preds.items():
        scored = [(s, d) for s, d, kind in emits if kind == "scored"]
        if len(scored) > 1:
            scored_duplicates += len(scored) - 1
        if len(set(scored)) > 1:
            conflicting += 1
        want = oracle["scores"].get(tid)
        if scored and want is not None and any(sd != want for sd in scored):
            score_mismatches += 1
    errors = sum(1 for emits in preds.values()
                 for _, _, kind in emits if kind == "error")

    # --- eviction/rejoin accounting --------------------------------------
    events = out["fleet"]["events"]
    expired_at = {e["worker"]: e.get("t")
                  for e in events if e.get("event") == "session_expired"}
    rejoined = set()
    for e in events:
        if e.get("event") == "rebalance" \
                and str(e.get("reason", "")).startswith("rejoin:"):
            rejoined.update(str(e["reason"])[len("rejoin:"):].split("+"))
    window_start = {targets["zombie"]: cfg.asym_start,
                    targets["full"]: cfg.full_start}
    detect_bound = cfg.session_timeout_s + cfg.detection_slack_s
    detection_s = {}
    reassigned_in_bound = True
    for wid, w_start in window_start.items():
        t_exp = expired_at.get(wid)
        if t_exp is None:
            reassigned_in_bound = False
            continue
        detection_s[wid] = round(t_exp - w_start, 3)
        if not (0.0 <= t_exp - w_start <= detect_bound):
            reassigned_in_bound = False

    byes = out["byes"]
    z_bye = byes.get(targets["zombie"]) or {}
    f_bye = byes.get(targets["full"]) or {}
    s_bye = byes.get(targets["slow"]) or {}
    z_fenced = z_bye.get("fenced") or {}
    f_fenced = f_bye.get("fenced") or {}
    fenced_produces = int(out["broker_status"].get("fenced_produces", 0))
    fenced_commits = int(out["broker_status"].get("fenced_commits", 0))

    # --- degraded_network: the slow-link victim's own healthy-vs-window
    # scored-traffic latency + throughput (the bench stage's payload) -----
    phases = s_bye.get("latency_phases") or {}
    healthy = phases.get("healthy") or {}
    slow = phases.get("slow_link") or {}
    slow_span = cfg.slow_end - cfg.slow_start
    degraded_network = {
        "worker": targets["slow"],
        "injected_latency_ms": round(cfg.slow_latency_s * 1e3, 3),
        "healthy": {**healthy,
                    "tps": (round(healthy.get("n", 0)
                                  / max(out["makespan_s"] - slow_span,
                                        1e-9), 1))},
        "slow_link": {**slow,
                      "tps": round(slow.get("n", 0) / max(slow_span, 1e-9),
                                   1)},
        "p99_ratio": (round(slow["p99_ms"] / healthy["p99_ms"], 3)
                      if slow.get("p99_ms") and healthy.get("p99_ms")
                      else None),
    }

    dup_bound = cfg.dup_bound_abs + int(cfg.dup_bound_frac
                                        * out["produced"])

    replay_identical = None
    second_digest = None
    if cfg.replay_check:
        second = _run_partition_fleet(cfg, sched)
        second_digest = second["digest"]
        replay_identical = second_digest == out["digest"]

    distinct_pids = {st["pid"] for st in out["fleet"]["workers"].values()}
    checks = {
        "processes_real": (len(distinct_pids)
                           == len(out["fleet"]["workers"])
                           and os.getpid() not in distinct_pids),
        # the zombie kept producing after its partitions moved — and the
        # broker REFUSED it (counted, nonzero), both ends agreeing
        "zombie_fenced_produce": (fenced_produces >= 1
                                  and int(z_fenced.get(
                                      "stale_generation", 0)) >= 1),
        "zero_lost": lost == 0,
        "zero_conflicting_scored": conflicting == 0,
        "zero_errors": errors == 0,
        "offsets_gap_free": out["committed"] == out["tx_ends"],
        "per_key_order_preserved": out["order_ok"],
        "state_equals_oracle": out["digests"] == oracle["digests"],
        "scores_equal_oracle": score_mismatches == 0,
        "reassigned_within_bound": reassigned_in_bound,
        "both_targets_evicted": (targets["zombie"] in expired_at
                                 and targets["full"] in expired_at),
        "healed_workers_rejoined": (targets["zombie"] in rejoined
                                    and targets["full"] in rejoined
                                    and bool(z_bye.get("graceful"))
                                    and bool(f_bye.get("graceful"))),
        # no double-ownership interval: both evicted workers provably
        # ABANDONED on first fenced write (nothing they wrote after the
        # fence landed), and no transaction carries divergent emissions
        "no_double_ownership": (int(z_fenced.get("abandons", 0)) >= 1
                                and int(f_fenced.get("abandons", 0)) >= 1
                                and conflicting == 0),
        "duplicates_bounded": scored_duplicates <= dup_bound,
        "duplicates_identical": conflicting == 0,
        "slow_window_sampled": int(slow.get("n", 0)) >= 20,
    }
    if replay_identical is not None:
        checks["replay_deterministic"] = bool(replay_identical)

    summary: Dict[str, Any] = {
        "metric": "partition_drill",
        "passed": all(bool(v) for v in checks.values()),
        "checks": checks,
        "targets": targets,
        "n_workers": cfg.n_workers,
        "n_partitions": cfg.n_partitions,
        "produced": out["produced"],
        "scored": out["counters"]["scored"],
        "emissions": out["emissions"],
        "scored_duplicates": scored_duplicates,
        "duplicate_bound": dup_bound,
        "lost": lost,
        "conflicting_scored": conflicting,
        "score_mismatches": score_mismatches,
        "fenced_produces": fenced_produces,
        "fenced_commits": fenced_commits,
        "fenced_by_worker": {
            targets["zombie"]: z_fenced,
            targets["full"]: f_fenced,
        },
        "evictions": out["fleet"]["evictions"],
        "rejoins": out["fleet"]["rejoins"],
        "detection_s": detection_s,
        "detection_bound_s": detect_bound,
        "degraded_network": degraded_network,
        "handoff_server": out["handoff_stats"],
        "plan": out["plan"],
        "links": {w: b.get("link") for w, b in byes.items()
                  if b.get("link")},
        # wall-clock report (NEVER in the digest)
        "wall": {
            "makespan_s": out["makespan_s"],
            "rebalance_pauses_s": out["fleet"]["rebalance_pauses_s"],
        },
        "events": events,
        "replay_identical": replay_identical,
        "digest": out["digest"],
        "second_digest": second_digest,
    }
    return summary


def compact_partition_summary(summary: Dict[str, Any]) -> Dict[str, Any]:
    """The <2 KB final-stdout-line verdict (bench.py convention: full
    result on the preceding line, compact parseable verdict last)."""
    deg = summary.get("degraded_network") or {}
    compact = {
        "metric": "partition_drill",
        "passed": summary.get("passed"),
        "checks": {k: bool(v)
                   for k, v in (summary.get("checks") or {}).items()},
        "targets": summary.get("targets"),
        "produced": summary.get("produced"),
        "scored": summary.get("scored"),
        "lost": summary.get("lost"),
        "conflicting_scored": summary.get("conflicting_scored"),
        "scored_duplicates": summary.get("scored_duplicates"),
        "fenced_produces": summary.get("fenced_produces"),
        "fenced_commits": summary.get("fenced_commits"),
        "evictions": summary.get("evictions"),
        "rejoins": summary.get("rejoins"),
        "detection_s": summary.get("detection_s"),
        "slow_p99_ratio": deg.get("p99_ratio"),
        "makespan_s": (summary.get("wall") or {}).get("makespan_s"),
        "digest": (summary.get("digest") or "")[:16],
        "summary_of": "full result JSON on the preceding stdout line",
    }
    line = json.dumps(compact, separators=(",", ":"))
    while len(line.encode()) >= 2048:
        for victim in ("checks", "detection_s", "targets", "digest",
                       "summary_of"):
            if compact.pop(victim, None) is not None:
                break
        else:
            compact = {"metric": "partition_drill",
                       "passed": summary.get("passed")}
        line = json.dumps(compact, separators=(",", ":"))
    return compact
