"""Distributed observability drill: the fleet tracing plane end to end.

Port of the JAX package's ``obs/obs_drill.py``; ``obs-drill`` is the
acceptance drill of the fleet observability plane. One seeded timeline
drives 2+ worker processes (``cluster-worker`` over the TCP netbroker, the
process fleet of ``cluster/procfleet.py``) with the distributed tracing
plane on:

1. **cross-process trace propagation**: the drill plays the ingress edge;
   every produced record carries a wire trace carrier (trace id, the
   ``ingress`` origin, the produce wall stamp), which the consuming worker
   re-hydrates, so each stitched trace spans ingest, broker transit
   (produce stamp to consume stamp, nonzero by construction), the worker's
   queue / assemble / pack / dispatch / device_wait stages and the emit,
   with the worker's ``graph/fetch.py GraphFetchClient`` calls to the other
   worker's fetch server as ``remote_fetch`` child spans (the server's share
   in the reply frame);
2. **carrier loss under a fault window**: inside the netfault window the
   ingress stops stamping carriers while one worker's broker link is
   latency-degraded; every record without a carrier becomes a counted fresh
   local root (``trace_carrier_lost``), never a gap, and the count is pinned
   exactly against the schedule;
3. **fleet metrics and the critical path**: workers stream counter-delta
   ``metrics`` events that the coordinator folds (seq-deduped) into fleet
   sums pinned equal to the bye-frame counters; one worker runs with an
   inflated device cost, and the stitched fleet breakdown must put the p99
   tail on that worker's ``device_wait``.

The checks: distinct real processes; stitched traces cross 2+ processes
with nonzero broker transit and a remote graph-fetch child span; carrier
losses equal the stripped count and adoptions the carried count; no trace
on two workers' batches; every worker's tracer closes what it starts and
says a graceful bye; fleet counter sums equal the byes; the slow worker owns
the p99 tail with ``device_wait`` dominant; the merged Chrome export has a
named track a process and one broker-transit flow arrow a stitched trace;
the traced makespan within ``overhead_bound`` of the untraced one (wall
timings are reported, never digested); and a second fresh traced run gives
the same SHA-256 over the content. The workers score with the host
``ShardScorer`` and are spawned with the card hidden, so the drill never
touches a device.
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
from realtime_fraud_detection_tpu_torch.cluster.procfleet import ProcessFleet
from realtime_fraud_detection_tpu_torch.obs.fleetmetrics import FleetTraceStore
from realtime_fraud_detection_tpu_torch.obs.tracing import make_carrier
from realtime_fraud_detection_tpu_torch.stream import topics as T

__all__ = ["ObsDrillConfig", "run_obs_drill", "compact_obs_summary",
           "build_obs_schedule"]


def _wall() -> float:
    # real OS processes over real TCP are paced on the wall clock
    # rtfd-lint: allow[wall-clock] real OS processes over real TCP are paced on the wall clock by definition
    return time.time()


@dataclasses.dataclass
class ObsDrillConfig:
    """Drill sizes. The defaults are the full drill; ``fast()`` is the test
    size: the same shape (2+ processes, the carrier-strip window, the slow
    worker, traced and untraced runs) on a shorter timeline."""

    seed: int = 7
    n_partitions: int = 12          # the transactions topic's contract
    n_workers: int = 3
    num_users: int = 40_000
    num_merchants: int = 400
    hot_users: int = 800
    hot_frac: float = 0.35
    # offered load: constant-rate seeded Poisson arrivals
    duration_s: float = 14.0
    tps: float = 170.0
    # the netfault window, relative to the announced epoch: the ingress
    # stops stamping carriers (deterministic, schedule-counted) while the
    # degrade target's broker link gains per-frame latency
    fault_start: float = 5.0
    fault_end: float = 8.0
    degrade_latency_s: float = 0.004
    degrade_jitter_s: float = 0.0015
    # every Nth carried record arrives with one 421-redirect hop already
    # on its ledger (rh=1 + accumulated redirect seconds) — the stitched
    # rows must book them under redirect_hops, pinned exactly
    redirect_every: int = 50
    redirect_s: float = 0.0005
    # worker knobs (wall-time service-cost model, paid for real); the
    # LAST worker runs with slow_base_ms instead — the p99-attribution
    # target whose device_wait must dominate the fleet tail
    batch: int = 48
    max_delay_ms: float = 15.0
    checkpoint_every: int = 6
    base_ms: float = 4.0
    per_txn_ms: float = 0.4
    slow_base_ms: float = 110.0
    heartbeat_s: float = 0.3
    # graph-fetch plane: per-batch remote neighbor resolution knobs
    fetch_ids: int = 8
    fetch_deadline_ms: float = 50.0
    # traced-vs-untraced wall bound (tracing + carriers + fetch spans
    # must stay a small tax on an identical workload)
    overhead_bound: float = 1.5
    ring_size: int = 65536
    ack_timeout_s: float = 120.0
    drain_timeout_s: float = 150.0
    # second, fully fresh traced run compared digest-for-digest
    replay_check: bool = True
    # directory for the workers' flight-recorder ring dumps ({worker, pid,
    # traces} JSON, the ``trace-export --merge`` input); empty: none
    rings_out: str = ""

    @classmethod
    def fast(cls) -> "ObsDrillConfig":
        """The test size: 2 processes, the same windows and checks, a
        shorter timeline and a smaller id space."""
        return cls(n_workers=2, num_users=8_000, num_merchants=150,
                   hot_users=300, duration_s=6.0, tps=110.0,
                   fault_start=2.5, fault_end=4.0,
                   slow_base_ms=95.0, heartbeat_s=0.25)

    def validate(self) -> None:
        if self.n_workers < 2:
            raise ValueError("obs drill needs >= 2 worker processes "
                             "(a stitched trace must cross a boundary)")
        if not self.duration_s > self.fault_end > self.fault_start >= 0:
            raise ValueError(
                f"fault window [{self.fault_start}, {self.fault_end}) "
                f"must sit inside the {self.duration_s}s timeline")
        if self.redirect_every < 2 or self.overhead_bound <= 1.0:
            raise ValueError("redirect_every >= 2 and overhead_bound > 1 "
                             "required")

    def windows(self) -> List[FaultWindow]:
        return [FaultWindow("carrier_strip", "netfault",
                            self.fault_start, self.fault_end)]


def build_obs_schedule(cfg: ObsDrillConfig,
                       ) -> List[Tuple[float, Dict[str, Any]]]:
    """Seeded (event_ts, txn) timeline — the partition drill's synthetic
    stream shape (hot cohort + long tail), schema-complete."""
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
            "transaction_id": f"otx_{i}",
            "user_id": f"user_{int(uid_idx[i])}",
            "merchant_id": f"m_{int(mid_idx[i])}",
            "amount": float(amounts[i]),
            "payment_method": "card",
            "event_ts": t,
        }))
    return sched


def _carrier_plan(cfg: ObsDrillConfig,
                  sched: List[Tuple[float, Dict[str, Any]]],
                  ) -> Dict[int, str]:
    """Pure function of (config, schedule): which schedule indices carry
    a trace carrier ("carried"), carry one with a redirect ledger
    ("redirect"), or are stripped inside the fault window ("stripped").
    The drill's exact carrier-loss pin comes from here."""
    plan: Dict[int, str] = {}
    carried = 0
    for i, (t_ev, _) in enumerate(sched):
        if cfg.fault_start <= t_ev < cfg.fault_end:
            plan[i] = "stripped"
            continue
        carried += 1
        plan[i] = "redirect" if carried % cfg.redirect_every == 0 \
            else "carried"
    return plan


# ------------------------------------------------------------- fleet run


def _run_obs_fleet(cfg: ObsDrillConfig,
                   sched: List[Tuple[float, Dict[str, Any]]],
                   plan: Dict[int, str],
                   traced: bool) -> Dict[str, Any]:
    """One fresh fleet run over the schedule: own broker + handoff +
    worker processes. ``traced=False`` runs the IDENTICAL workload
    (carriers still produced, fetch plane still live) with the workers'
    tracing plane off — the overhead-ratio baseline."""
    from realtime_fraud_detection_tpu_torch.cluster.handoff import HandoffServer
    from realtime_fraud_detection_tpu_torch.stream.netbroker import BrokerServer

    ids = [f"w{i}" for i in range(cfg.n_workers)]
    slow_wid = ids[-1]
    degrade_wid = ids[0]
    broker_srv = BrokerServer(port=0).start()
    tmp = tempfile.mkdtemp(prefix="rtfd-obs-")
    handoff_srv = None
    fleet = None
    try:
        handoff_srv = HandoffServer(
            blob_dir=os.path.join(tmp, "blobs")).start()
        fetch_spec = {"edge": "user->device", "k": 4,
                      "ids": cfg.fetch_ids,
                      "deadline_ms": cfg.fetch_deadline_ms}
        worker_spec: Dict[str, Any] = {
            "batch": cfg.batch, "max_delay_ms": cfg.max_delay_ms,
            "checkpoint_every": cfg.checkpoint_every,
            "seq_len": 4, "feature_dim": 4,
            "base_ms": cfg.base_ms, "per_txn_ms": cfg.per_txn_ms,
            "heartbeat_s": cfg.heartbeat_s,
            "fetch": fetch_spec,
        }
        if traced:
            worker_spec["tracing"] = {"ring_size": cfg.ring_size}
            worker_spec["expect_carrier"] = True
        per_worker: Dict[str, Dict[str, Any]] = {
            slow_wid: {"base_ms": cfg.slow_base_ms},
        }
        per_worker.setdefault(degrade_wid, {})["netfaults"] = {
            "seed": cfg.seed, "windows": [{
                "name": "carrier_strip", "kind": "degrade",
                "t_start": cfg.fault_start, "t_end": cfg.fault_end,
                "latency_s": cfg.degrade_latency_s,
                "jitter_s": cfg.degrade_jitter_s,
            }]}
        fleet = ProcessFleet(
            f"127.0.0.1:{broker_srv.port}",
            f"127.0.0.1:{handoff_srv.port}",
            n_partitions=cfg.n_partitions,
            ack_timeout_s=cfg.ack_timeout_s,
            worker_spec=worker_spec,
            per_worker_spec=per_worker)
        fleet.start(cfg.n_workers, now=0.0)
        fleet.wait_fetch_addrs(ids)
        fleet.broadcast_peers()
        chaos = ChaosPlan(cfg.windows())

        t0 = _wall()
        fleet.announce_epoch(t0)
        next_i, n = 0, len(sched)
        produced = 0
        while True:
            now_ev = _wall() - t0
            if next_i < n:
                j = next_i
                items = []
                now_wall = _wall()
                while j < n and sched[j][0] <= now_ev:
                    t_ev, txn = sched[j]
                    kind = plan[j]
                    if kind != "stripped":
                        # the ingress edge: a fresh root carrier with the
                        # PRODUCE wall stamp (consume-minus-it == the
                        # broker_transit stage); the redirect cohort
                        # arrives with one 421 hop already on the ledger
                        txn = dict(txn)
                        txn["trace_carrier"] = make_carrier(
                            f"ting-{j:08x}", origin="ingress",
                            produced_ts=now_wall,
                            hops=1 if kind == "redirect" else 0,
                            redirect_s=(cfg.redirect_s
                                        if kind == "redirect" else 0.0))
                    items.append((txn["user_id"], txn, t0 + t_ev))
                    j += 1
                if items:
                    fleet.client.produce_batch_stamped(T.TRANSACTIONS,
                                                       items)
                    produced += len(items)
                    next_i = j
            chaos.poll(now_ev)
            fleet.tick(now_ev)
            if next_i >= n and now_ev > cfg.fault_end:
                lag = fleet.client.lag(fleet.group_id, T.TRANSACTIONS)
                if lag == 0:
                    break
                if now_ev > cfg.duration_s + cfg.drain_timeout_s:
                    raise RuntimeError(f"drain timeout: lag={lag}")
            time.sleep(0.01)
        makespan = _wall() - t0

        fleet.shutdown_all(now=_wall() - t0)
        byes = fleet.all_byes()
        digests: Dict[int, str] = {}
        for bye in byes.values():
            for p, d in (bye.get("digests") or {}).items():
                digests[int(p)] = d

        # ---- predictions ledger: coverage + per-txn content ----------
        inner = broker_srv.broker
        preds: Dict[str, List[Tuple[float, str, str]]] = {}
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
                    preds.setdefault(str(v.get("transaction_id", "")),
                                     []).append(
                        (round(float(v.get("fraud_score", -1.0)), 6),
                         str(v.get("decision", "")), kind))
        tx_ends = inner.end_offsets(T.TRANSACTIONS)
        committed = [inner.committed(fleet.group_id, T.TRANSACTIONS, p)
                     for p in range(len(tx_ends))]

        return {
            "ids": ids,
            "slow_worker": slow_wid,
            "degrade_worker": degrade_wid,
            "produced": produced,
            "preds": preds,
            "committed": committed,
            "tx_ends": tx_ends,
            "digests": digests,
            "byes": byes,
            "fleet_snapshot": fleet.snapshot(),
            "fleet_metrics": fleet.fleet_metrics.snapshot(),
            "fleet_metrics_render": fleet.fleet_metrics.render(),
            "makespan_s": round(makespan, 3),
            "chaos": chaos.snapshot(now=makespan),
        }
    finally:
        if fleet is not None:
            fleet.terminate()
        if handoff_srv is not None:
            handoff_srv.stop()
        broker_srv.stop()


def _stitch(out: Dict[str, Any], cfg: ObsDrillConfig) -> FleetTraceStore:
    store = FleetTraceStore(ring_size=max(cfg.ring_size * cfg.n_workers,
                                          1024))
    for wid, bye in sorted(out["byes"].items()):
        store.ingest(wid, bye.get("trace_ring") or [],
                     pid=int(bye.get("pid", 0) or 0))
    return store


def _traced_digest(cfg: ObsDrillConfig, out: Dict[str, Any],
                   carrier_ledger: Dict[str, int]) -> str:
    """sha256 over the run's CONTENT invariants — schedule-pinned carrier
    accounting, per-transaction scores, offsets, state digests. Wall
    timings (e2e, stage ms, makespans) are reported, never digested."""
    return hashlib.sha256(json.dumps({
        "produced": out["produced"],
        "preds": sorted((tid, sorted({(s, d) for s, d, _ in e}))
                        for tid, e in out["preds"].items()),
        "committed": out["committed"],
        "state": sorted((p, d) for p, d in out["digests"].items()),
        "carriers": carrier_ledger,
        "windows": [[w.name, w.t_start, w.t_end] for w in cfg.windows()],
    }, sort_keys=True).encode()).hexdigest()


def _analyze_traced(cfg: ObsDrillConfig, out: Dict[str, Any],
                    plan: Dict[int, str]) -> Dict[str, Any]:
    store = _stitch(out, cfg)
    rows = store.rows()
    stitch = store.stitch_stats()
    breakdown = store.breakdown()
    export = store.export_chrome_trace()

    stripped = sum(1 for k in plan.values() if k == "stripped")
    redirects = sum(1 for k in plan.values() if k == "redirect")
    carried = len(plan) - stripped

    lost_total = adopted_total = 0
    wedged: List[str] = []
    for wid, bye in sorted(out["byes"].items()):
        tc = bye.get("tracer_counters") or {}
        lost_total += int(tc.get("carrier_lost", 0))
        adopted_total += int(tc.get("carrier_adopted", 0))
        closed = sum(int(tc.get(k, 0)) for k in
                     ("completed", "shed", "errors", "cached"))
        if int(tc.get("started", 0)) != closed:
            wedged.append(wid)

    # no cross-attachment: a trace id consumed by one worker's batches
    # must never surface in another worker's ring
    owner: Dict[str, str] = {}
    cross_attached = 0
    for r in rows:
        tid, w = str(r.get("trace_id")), str(r.get("worker"))
        if owner.setdefault(tid, w) != w:
            cross_attached += 1

    redirect_rows = sum(
        1 for r in rows if "redirect_hops" in (r.get("stages") or {}))
    workers_with_stitched = sorted(
        {str(r.get("worker")) for r in rows
         if r.get("origin") == "ingress"})
    flow_starts = sum(1 for e in export["traceEvents"]
                      if e.get("ph") == "s")
    track_names = [e["args"]["name"] for e in export["traceEvents"]
                   if e.get("ph") == "M"]

    # fleet-metrics exactness: the coordinator's streamed (delta, seq)
    # fold must EQUAL each worker's bye-frame counters, key for key
    fm_workers = (out["fleet_metrics"] or {}).get("workers") or {}
    metrics_exact = True
    metrics_diffs: List[str] = []
    for wid, bye in sorted(out["byes"].items()):
        want: Dict[str, float] = {
            str(k): float(v)
            for k, v in (bye.get("counters") or {}).items()}
        for k, v in (bye.get("tracer_counters") or {}).items():
            want[f"trace_{k}"] = float(v)
        fetch = bye.get("fetch") or {}
        if fetch:
            want["remote_fetch"] = float(fetch.get("remote_fetch_total", 0))
            want["remote_fetch_errors"] = float(
                fetch.get("fetch_error_total", 0))
        got = {str(k): float(v)
               for k, v in (fm_workers.get(wid) or {}).items()}
        if got != want:
            metrics_exact = False
            metrics_diffs.append(wid)

    carrier_ledger = {"stripped": stripped, "carried": carried,
                      "redirects": redirects,
                      "lost_total": lost_total,
                      "adopted_total": adopted_total,
                      "stitched_rows": len(rows),
                      "redirect_rows": redirect_rows}
    return {
        "stitch": stitch,
        "breakdown_quantiles": breakdown.get("quantiles") or {},
        "per_worker": breakdown.get("per_worker") or {},
        "exemplars": (breakdown.get("exemplars") or [])[:4],
        "carrier_ledger": carrier_ledger,
        "wedged_workers": wedged,
        "cross_attached": cross_attached,
        "workers_with_stitched": workers_with_stitched,
        "flow_starts": flow_starts,
        "track_names": track_names,
        "metrics_exact": metrics_exact,
        "metrics_diffs": metrics_diffs,
        "digest": _traced_digest(cfg, out, carrier_ledger),
    }


# ------------------------------------------------------------------ drill


def run_obs_drill(config: Optional[ObsDrillConfig] = None,
                  fast: bool = False) -> Dict[str, Any]:
    """Run the obs drill: untraced baseline fleet, traced fleet with the
    full observability plane, stitched-trace + fleet-metrics pins, plus
    the fresh-run determinism check."""
    cfg = config or (ObsDrillConfig.fast() if fast else ObsDrillConfig())
    cfg.validate()
    sched = build_obs_schedule(cfg)
    plan = _carrier_plan(cfg, sched)

    untraced = _run_obs_fleet(cfg, sched, plan, traced=False)
    out = _run_obs_fleet(cfg, sched, plan, traced=True)
    if cfg.rings_out:
        os.makedirs(cfg.rings_out, exist_ok=True)
        for wid, bye in sorted(out["byes"].items()):
            with open(os.path.join(cfg.rings_out,
                                   f"ring_{wid}.json"), "w") as f:
                json.dump({"worker": wid,
                           "pid": int(bye.get("pid", 0) or 0),
                           "traces": bye.get("trace_ring") or []}, f)
    res = _analyze_traced(cfg, out, plan)
    ledger = res["carrier_ledger"]
    stitch = res["stitch"]

    produced_ids = {txn["transaction_id"] for _, txn in sched}
    preds = out["preds"]
    lost = len(produced_ids - set(preds))
    errors = sum(1 for emits in preds.values()
                 for _, _, kind in emits if kind == "error")

    p99 = (res["breakdown_quantiles"].get("p99") or {})
    slow = out["slow_worker"]
    slow_row = (res["per_worker"].get(slow) or {})
    transit = stitch.get("broker_transit_ms") or {}

    overhead_ratio = round(
        out["makespan_s"] / max(untraced["makespan_s"], 1e-9), 3)

    replay_identical = None
    second_digest = None
    if cfg.replay_check:
        second_out = _run_obs_fleet(cfg, sched, plan, traced=True)
        second = _analyze_traced(cfg, second_out, plan)
        second_digest = second["digest"]
        replay_identical = second_digest == res["digest"]

    pids = {st["pid"]
            for st in out["fleet_snapshot"]["workers"].values()}
    checks = {
        "processes_real": (len(pids) == cfg.n_workers
                          and os.getpid() not in pids),
        # the stitched plane: adopted traces landed on >= 2 distinct
        # worker processes, every one with a REAL produce->consume
        # transit, and remote graph-fetch child spans present
        "stitched_crosses_processes": (
            len(res["workers_with_stitched"]) >= 2
            and stitch.get("crossed_process", 0) > 0),
        "broker_transit_nonzero": (transit.get("n", 0) > 0
                                   and transit.get("p99", 0.0) > 0.0),
        "remote_fetch_spans": stitch.get("with_remote_span", 0) > 0,
        # carrier accounting pinned EXACTLY against the schedule
        "carrier_loss_exact": (ledger["stripped"] > 0
                               and ledger["lost_total"]
                               == ledger["stripped"]),
        "carrier_adopt_exact": (ledger["adopted_total"]
                                == ledger["carried"]),
        "redirects_booked": (ledger["redirects"] > 0
                             and ledger["redirect_rows"]
                             == ledger["redirects"]),
        "no_cross_attachment": res["cross_attached"] == 0,
        "tracer_never_wedged": (not res["wedged_workers"]
                                and all(b.get("graceful")
                                        for b in out["byes"].values())),
        "fleet_counters_exact": res["metrics_exact"],
        # slow-worker attribution: the inflated-cost worker owns the
        # fleet's p99 tail, and its own dominant stage is device_wait
        "slow_worker_attributed": (
            p99.get("dominant_worker") == slow
            and slow_row.get("dominant_stage") == "device_wait"),
        "export_tracks_and_flows": (
            len(res["track_names"]) >= cfg.n_workers + 1
            and res["flow_starts"] == stitch.get("crossed_process", 0)),
        "zero_lost": lost == 0,
        "zero_errors": errors == 0,
        "offsets_gap_free": out["committed"] == out["tx_ends"],
        "overhead_bounded": overhead_ratio <= cfg.overhead_bound,
    }
    if replay_identical is not None:
        checks["replay_deterministic"] = bool(replay_identical)

    summary: Dict[str, Any] = {
        "metric": "obs_drill",
        "passed": all(bool(v) for v in checks.values()),
        "checks": checks,
        "n_workers": cfg.n_workers,
        "n_partitions": cfg.n_partitions,
        "slow_worker": slow,
        "degrade_worker": out["degrade_worker"],
        "produced": out["produced"],
        "lost": lost,
        "errors": errors,
        "carriers": ledger,
        "stitch": stitch,
        "breakdown_p99": p99,
        "per_worker": res["per_worker"],
        "exemplars": res["exemplars"],
        "tracks": res["track_names"],
        "flow_arrows": res["flow_starts"],
        "fleet_metrics": out["fleet_metrics"],
        "chaos": out["chaos"],
        # wall-clock report (NEVER in the digest)
        "wall": {
            "makespan_traced_s": out["makespan_s"],
            "makespan_untraced_s": untraced["makespan_s"],
            "overhead_ratio": overhead_ratio,
            "broker_transit_ms": transit,
        },
        "replay_identical": replay_identical,
        "digest": res["digest"],
        "second_digest": second_digest,
    }
    return summary


def compact_obs_summary(summary: Dict[str, Any]) -> Dict[str, Any]:
    """The <2 KB last-stdout-line verdict (the full result is on the line
    before it)."""
    wall = summary.get("wall") or {}
    stitch = summary.get("stitch") or {}
    compact = {
        "metric": "obs_drill",
        "passed": summary.get("passed"),
        "checks": {k: bool(v)
                   for k, v in (summary.get("checks") or {}).items()},
        "produced": summary.get("produced"),
        "carriers": summary.get("carriers"),
        "stitch_rate": stitch.get("stitch_rate"),
        "crossed": stitch.get("crossed_process"),
        "slow_worker": summary.get("slow_worker"),
        "p99_dominant": (summary.get("breakdown_p99") or {}).get(
            "dominant_stage"),
        "overhead_ratio": wall.get("overhead_ratio"),
        "broker_transit_p99_ms": (wall.get("broker_transit_ms") or {}
                                  ).get("p99"),
        "makespan_s": wall.get("makespan_traced_s"),
        "digest": (summary.get("digest") or "")[:16],
        "summary_of": "full result JSON on the preceding stdout line",
    }
    line = json.dumps(compact, separators=(",", ":"))
    while len(line.encode()) >= 2048:
        for victim in ("checks", "carriers", "summary_of", "digest"):
            if compact.pop(victim, None) is not None:
                break
        else:
            compact = {"metric": "obs_drill",
                       "passed": summary.get("passed")}
        line = json.dumps(compact, separators=(",", ":"))
    return compact
