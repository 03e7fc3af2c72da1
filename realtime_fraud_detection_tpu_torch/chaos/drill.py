"""Combined recovery drill: every plane, one correlated-failure timeline.

Port of the JAX package's ``chaos/drill.py``. ``chaos-drill`` is the chaos
plane's acceptance drill. One seeded,
virtual-clock timeline layers the faults the planes were proven against
*in isolation* — and proves they hold TOGETHER:

1. **healthy** — baseline stream through the REAL pipeline: netbroker
   primary + synchronous replica (min_isr=2) over real TCP, NetBrokerClient
   consumer, MicrobatchAssembler on the virtual clock, QoS admission +
   ladder + budget, tracer + SLO burn, the ``DevicePool`` (``n_devices``
   replicas on the card, each on its own CUDA stream, or on the CPU),
   FeedbackPlane joining chargeback-delayed labels.
   Prequential AUC settles at the incumbent's baseline.
2. **flash crowd** — a ``sim.arrivals.DiurnalBurstProcess`` spike at a
   multiple of the (virtual) capacity: the QoS ladder engages, sheds only
   low-priority traffic, SLO burn spikes.
3. **broker outage** — the replica is stopped mid-stream: the primary's
   produces fail with the REAL ``NotEnoughReplicasError`` (records land
   above the high watermark, invisible), the drill's producer buffers and
   retries, the job's own fan-out failure takes the crash-recovery path
   (seek-to-committed + txn-cache replay). A fresh replica attaches;
   ``add_replica``'s backlog sync re-replicates and re-exposes the tail —
   effectively-once across the outage, offset-accounted.
4. **device faults** — one pool replica dies mid-flight (injected fetch
   failure → rescue-onto-healthy-replica), then a revived replica runs
   SLOW (delayed, not dead). FIFO completion and per-batch result
   integrity hold throughout.
5. **fraud ring** — ``sim.fraud_patterns.FraudRing``: a user cohort
   funnels traffic through shared merchants/devices/IPs, in-distribution
   per feature. The label stream stalls (and floods back); prequential
   AUC dips; the retrain policy fires; the gate passes a candidate that
   learned the ring signature; promotion deploys it through the pool's
   replica-by-replica swap.
6. **recovery** — the ring keeps flowing against the retrained blend: AUC
   recovers to the baseline band, the ladder returns to rung 0, SLO burn
   falls under 1, the pool is healthy and retry-free again.

Time is virtual throughout: arrivals carry virtual timestamps, the
assembler/admission/budget/tracer/feedback all read the injected clock,
and scoring advances the clock by a deterministic service-cost model
(``(base_ms + n*per_txn_ms) / speedup[rung]`` — the ladder's rungs
genuinely buy virtual capacity). The REAL parts — TCP broker, packed
fused-program scoring on the device pool, GBDT retraining — are
deterministic by seeding, so the whole timeline replays bit-identically:
the drill runs it twice and compares digests.

The JAX command re-execs the drill onto a virtual N-device CPU host; the
port does not: ``n_devices`` replicas go on the card
(``scoring/pool_drill.py pool_devices``), or on the CPU with ``device``
"cpu". ``run_chaos_drill(kernels=...)`` runs the same timeline with the
scorer's hand-written kernels selected (``KernelSettings``; off by default,
as in the JAX drill, which has no such switch). The summary's ``ledger``
(every prediction as id, score, decision, kind and the virtual instant its
batch completed) and
``first_promotion_ts`` let a caller compare two runs id by id; the command
prints the summary without the ledger.

Convention matches the sibling drills: full summary JSON, then a compact
(<2 KB) verdict as the FINAL stdout line.
"""

from __future__ import annotations

import dataclasses
import hashlib
import heapq
import json
import math
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["ChaosDrillConfig", "apply_chaos_settings", "run_chaos_drill",
           "compact_chaos_summary"]

_SPEEDUP = (1.0, 2.0, 4.0, 8.0)     # virtual capacity per ladder rung


@dataclasses.dataclass
class ChaosDrillConfig:
    """Drill sizes. Defaults = the full drill; ``fast()`` = tier-1."""

    seed: int = 11
    n_devices: int = 4
    # where the pool's replicas run: "cuda" (all on the card) or "cpu"
    device: str = "cuda"
    inflight_depth: int = 2
    num_users: int = 600
    num_merchants: int = 200
    batch: int = 64
    max_delay_ms: float = 120.0       # virtual assembler deadline
    # deterministic service-cost model (virtual ms per dispatched batch)
    base_ms: float = 10.0
    per_txn_ms: float = 1.25
    # offered load: baseline rate + the flash-crowd envelope (multiples of
    # the level-0 virtual capacity at `batch`)
    tps: float = 280.0
    flash_s: float = 2.4
    flash_mult: float = 2.6
    flash_burst_mult: float = 1.6
    # phase sizes (transactions)
    n_train: int = 1536
    n_healthy: int = 1152
    n_outage: int = 512
    n_pool: int = 384
    n_ring: int = 1664
    n_recovery: int = 2560
    # fault windows (virtual seconds, relative to their phase starts)
    outage_lead_s: float = 0.2
    outage_s: float = 1.0
    label_stall_s: float = 2.0
    replica_faults: int = 1
    slow_device_ms: float = 30.0
    # fraud ring
    ring_rate: float = 0.10
    ring_members: int = 24
    ring_merchants: int = 6
    ring_devices: int = 4
    ring_ips: int = 3
    # incumbent + retrain
    n_trees: int = 32
    tree_depth: int = 4
    # feedback plane
    sliding_window: int = 512
    fading_gamma: float = 0.998
    auc_drop: float = 0.10
    # the floor sits just under THIS config's settled sliding AUC (the
    # fast incumbent settles lower — fewer trees, smaller window): a
    # HALF-learned ring (first candidate promoted before most ring labels
    # landed) leaves the window visibly depressed, so the policy keeps
    # re-triggering — and the gate keeps judging — until a candidate that
    # actually ranks the ring serves. Early noisy windows also trip it;
    # those candidates are honestly REFUSED by the non-regression gate.
    auc_floor: float = 0.92
    min_labels: int = 256
    # short virtual cooldown: the gate may honestly REFUSE the first
    # candidate (too few ring labels in its training segment yet) and
    # pass a later, better-informed one while the stream still flows
    cooldown_s: float = 3.0
    label_delay_scale: float = 2e-6
    # second, fresh run compared digest-for-digest against the first
    replay_check: bool = True

    @classmethod
    def fast(cls) -> "ChaosDrillConfig":
        """Tier-1 smoke sizes: every phase and every fault still runs."""
        return cls(n_devices=2, n_train=1024, n_healthy=896, flash_s=1.6,
                   n_outage=384, n_pool=256, n_ring=1280, n_recovery=1536,
                   n_trees=24, sliding_window=448, min_labels=224,
                   auc_floor=0.82)

    # ------------------------------------------------------------- derived
    def cost_s(self, n: int, level: int) -> float:
        """Virtual service cost of one dispatched batch at a ladder rung."""
        return ((self.base_ms + n * self.per_txn_ms) / 1e3) \
            / _SPEEDUP[min(level, len(_SPEEDUP) - 1)]

    def capacity_tps(self) -> float:
        """Level-0 sustainable rate at the configured batch size."""
        return self.batch / self.cost_s(self.batch, 0)


def apply_chaos_settings(cfg: ChaosDrillConfig, s) -> ChaosDrillConfig:
    """Overlay ``utils/config.ChaosSettings`` (the ``chaos.*`` block of a
    JSON config file, reached via ``chaos-drill --config``) onto a
    drill config. All of the settings are virtual-clock quantities, so
    they reshape the replayed fault timeline deterministically."""
    return dataclasses.replace(
        cfg, seed=s.seed, outage_s=s.broker_outage_s,
        label_stall_s=s.label_stall_s, flash_mult=s.flash_crowd_mult,
        flash_burst_mult=s.flash_burst_mult, ring_rate=s.ring_rate,
        ring_members=s.ring_members, ring_merchants=s.ring_merchants,
        ring_devices=s.ring_devices, ring_ips=s.ring_ips,
        replica_faults=s.replica_faults, slow_device_ms=s.slow_device_ms)


def _rank_auc(scores: List[float], labels: List[bool]) -> float:
    """Tie-averaged Mann-Whitney AUC (host arithmetic, deterministic)."""
    y = np.asarray(labels, bool)
    s = np.asarray(scores, float)
    n_pos = int(y.sum())
    n_neg = int(len(y) - n_pos)
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    _, inv, counts = np.unique(s, return_inverse=True, return_counts=True)
    avg_rank = np.cumsum(counts) - (counts - 1) / 2.0
    r = avg_rank[inv]
    return float((r[y].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def _train_incumbent(cfg: ChaosDrillConfig, gen, scorer) -> Dict[str, Any]:
    """Historical labeled segment through the production assemble path →
    deployed trees + iforest (the feedback-drill recipe, chaos-sized)."""
    from realtime_fraud_detection_tpu_torch.models.isolation_forest import (
        IsolationForestTrainer,
    )
    from realtime_fraud_detection_tpu_torch.training.gbdt import GBDTTrainer

    xs, ys = [], []
    done, ts = 0, 0.0
    while done < cfg.n_train:
        n = min(cfg.batch, cfg.n_train - done)
        recs = gen.generate_batch(n)
        batch = scorer.assemble(recs, now=ts)
        xs.append(np.asarray(batch.features))
        ys.append(np.asarray([bool(r.get("is_fraud")) for r in recs],
                             np.float32))
        for r in recs:
            scorer.velocity.update(str(r.get("user_id", "")),
                                   float(r.get("amount", 0.0)), ts)
        done += n
        ts += n / cfg.tps
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    trees = GBDTTrainer(n_estimators=cfg.n_trees, max_depth=cfg.tree_depth,
                        seed=cfg.seed).fit(x, y)
    iforest = IsolationForestTrainer(n_estimators=48,
                                     seed=cfg.seed + 1).fit(
        x[y < 0.5][:4000])
    # single-threaded here: no batch is in flight during the swap
    # rtfd-lint: allow[lock-order] drill is single-threaded here (no batch in flight during the swap)
    scorer.set_models(dataclasses.replace(scorer.models, trees=trees,
                                          iforest=iforest))
    return {"rows": int(len(y)), "fraud_rate": round(float(y.mean()), 4),
            "virtual_end_s": ts}


def _build_schedule(cfg: ChaosDrillConfig, gen, t0: float,
                    ) -> Tuple[List[Tuple[float, Dict[str, Any]]],
                               Dict[str, float], Any,
                               Dict[str, Tuple[str, bool]]]:
    """The full arrival timeline, phase by phase (generation order is part
    of the seeded state, so the ring activates mid-sequence exactly as it
    would mid-stream). Returns (schedule, phase marks, live ring, truth) —
    ``truth`` maps txn_id -> (phase, is_fraud): the drill's own labeled
    ledger for the phase-scoped quality measurement."""
    from realtime_fraud_detection_tpu_torch.sim.arrivals import (
        DiurnalBurstConfig,
        DiurnalBurstProcess,
    )
    from realtime_fraud_detection_tpu_torch.sim.fraud_patterns import (
        FraudRingConfig,
    )

    sched: List[Tuple[float, Dict[str, Any]]] = []
    marks: Dict[str, float] = {}
    truth: Dict[str, Tuple[str, bool]] = {}
    phase = ["healthy"]
    t = t0

    def note(txns) -> None:
        for txn in txns:
            truth[str(txn["transaction_id"])] = (
                phase[0], bool(txn.get("is_fraud")))

    def uniform(n: int, start: float) -> float:
        txns = gen.generate_batch(n)
        note(txns)
        for i, txn in enumerate(txns):
            sched.append((start + i / cfg.tps, txn))
        return start + n / cfg.tps

    marks["healthy"] = t
    t = uniform(cfg.n_healthy, t)

    marks["flash"] = t
    phase[0] = "flash"
    proc = DiurnalBurstProcess(DiurnalBurstConfig(
        trough_tps=cfg.tps,
        peak_tps=cfg.flash_mult * cfg.capacity_tps(),
        period_s=cfg.flash_s,
        burst_every_s=cfg.flash_s / 2.0,
        burst_offset_s=cfg.flash_s / 3.0,
        burst_duration_s=cfg.flash_s / 8.0,
        burst_mult=cfg.flash_burst_mult,
        t0=t,
    ), seed=cfg.seed + 2)
    times = proc.generate(cfg.flash_s)
    flash_txns = gen.generate_batch(len(times))
    note(flash_txns)
    sched.extend(zip(times.tolist(), flash_txns))
    t += cfg.flash_s

    marks["outage"] = t
    phase[0] = "outage"
    t = uniform(cfg.n_outage, t)
    # margin so the heal lands while arrivals still flow
    t = max(t, marks["outage"] + cfg.outage_lead_s + cfg.outage_s + 0.3)

    marks["pool"] = t
    phase[0] = "pool"
    t = uniform(cfg.n_pool, t)

    marks["ring"] = t
    phase[0] = "ring"
    ring = gen.inject_fraud_ring(FraudRingConfig(
        n_members=cfg.ring_members, n_merchants=cfg.ring_merchants,
        n_devices=cfg.ring_devices, n_ips=cfg.ring_ips,
        rate=cfg.ring_rate))
    t = uniform(cfg.n_ring, t)

    marks["recovery"] = t
    phase[0] = "recovery"
    t = uniform(cfg.n_recovery, t)
    marks["end"] = t
    return sched, marks, ring, truth


def _run_once(cfg: ChaosDrillConfig, devices,
              kernels: Optional[Any] = None) -> Dict[str, Any]:
    """One full pass of the fault timeline; returns the raw outcome
    (summary fields + the replay digest)."""
    from realtime_fraud_detection_tpu_torch.chaos.faults import (
        BrokerReplicaOutage,
        ChaosPlan,
        DeviceReplicaDeath,
        FaultWindow,
        LabelStall,
        SlowDevice,
    )
    from realtime_fraud_detection_tpu_torch.feedback.plane import FeedbackPlane
    from realtime_fraud_detection_tpu_torch.obs.tracing import Tracer
    from realtime_fraud_detection_tpu_torch.qos import QosPlane
    from realtime_fraud_detection_tpu_torch.scoring.device_pool import DevicePool
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import ScorerConfig
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.sim.simulator import (
        TransactionGenerator,
    )
    from realtime_fraud_detection_tpu_torch.stream import topics as T
    from realtime_fraud_detection_tpu_torch.stream.job import JobConfig, StreamJob
    from realtime_fraud_detection_tpu_torch.stream.microbatch import (
        MicrobatchAssembler,
    )
    from realtime_fraud_detection_tpu_torch.stream.netbroker import (
        BrokerServer,
        NetBrokerClient,
    )
    from realtime_fraud_detection_tpu_torch.utils.config import (
        Config,
        FeedbackSettings,
        QosSettings,
        TracingSettings,
    )

    capacity = cfg.capacity_tps()

    # ---- serving pair + incumbent (the feedback-drill production baseline)
    app_config = Config()
    for name, mc in app_config.models.items():
        mc.enabled = name in ("xgboost_primary", "isolation_forest")
    app_config.models["xgboost_primary"].weight = 0.8
    app_config.models["isolation_forest"].weight = 0.2
    if kernels is not None:
        app_config.kernels = kernels

    gen = TransactionGenerator(num_users=cfg.num_users,
                               num_merchants=cfg.num_merchants,
                               seed=cfg.seed, tps=cfg.tps)
    scorer = TorchFraudScorer(app_config,
                              scorer_config=ScorerConfig(text_len=16,
                                                         tokenizer="word"),
                              device=devices[0])
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    incumbent = _train_incumbent(cfg, gen, scorer)

    # pool AFTER the incumbent deploys (replicas copy the live params)
    pool = DevicePool(scorer, devices=devices,
                      inflight_depth=cfg.inflight_depth)

    # ---- real networked broker: primary + synchronous replica, min_isr=2
    replica = BrokerServer(port=0, role="replica").start()
    primary = BrokerServer(port=0, min_isr=2).start()
    primary.add_replica("127.0.0.1", replica.port)
    producer = NetBrokerClient(port=primary.port, reconnect_attempts=2)
    job_client = NetBrokerClient(port=primary.port, reconnect_attempts=2)
    outage = None     # bound inside the try; the finally guards on None
    try:
        # ---- planes on one virtual clock
        clock = [incumbent["virtual_end_s"]]
        vclock = lambda: clock[0]                                  # noqa: E731

        w = max(1, len(devices) * cfg.inflight_depth)   # in-flight window
        steady_e2e_ms = (cfg.max_delay_ms
                         + (w + 1) * cfg.cost_s(cfg.batch, 0) * 1e3)
        qos_settings = QosSettings(
            enabled=True,
            budget_ms=4.0 * steady_e2e_ms,
            assemble_margin_ms=0.5 * steady_e2e_ms,
            admission_rate=capacity,
            admission_burst=capacity * 0.20,
            high_value_amount=500.0,
            low_value_amount=25.0,
            ladder_high_backlog=(w + 3) * cfg.batch,
            ladder_low_backlog=(w + 1) * cfg.batch,
            ladder_patience=3,
            ladder_up_patience=10,
        )
        plane = QosPlane(qos_settings)
        # rungs 1-2 are the capacity levers for this serving pair (the heavy
        # branches are already disabled); rules_only would change the scored
        # DISTRIBUTION mid-timeline and conflate the flash window with the
        # ring-quality measurement, so the drill caps the ladder below it
        plane.ladder.config.max_level = 2

        tracer = Tracer(TracingSettings(
            enabled=True, ring_size=16384, slowest_n=16,
            slo_objective_ms=1.25 * steady_e2e_ms, slo_objective_frac=0.95,
            slo_fast_window_s=3.0, slo_slow_window_s=12.0, slo_bucket_s=0.25,
            slo_burn_threshold=2.0, slo_gate_patience=3,
            slo_gate_up_patience=10), clock=vclock)

        fb = FeedbackPlane(FeedbackSettings(
            enabled=True,
            label_horizon_s=120.0, label_ooo_s=0.5, pred_ooo_s=0.5,
            label_delay_scale=cfg.label_delay_scale,
            buffer_size=max(cfg.n_healthy + cfg.n_ring + cfg.n_recovery, 4096),
            sliding_window=cfg.sliding_window, fading_gamma=cfg.fading_gamma,
            operating_threshold=0.5,
            auc_drop=cfg.auc_drop, auc_floor=cfg.auc_floor,
            min_labels=cfg.min_labels, cooldown_s=cfg.cooldown_s,
            retrain_trees=cfg.n_trees, retrain_depth=cfg.tree_depth + 1,
            gate_min_positives=12,
            gate_select_frac=0.1, gate_holdout_frac=0.15,
        ), scorer=scorer, config=app_config, clock=vclock)

        job = StreamJob(job_client, scorer, JobConfig(
            max_batch=cfg.batch, emit_features=False, emit_enriched=False,
            qos=plane, feedback=fb, tracing=tracer))
        job.assembler = MicrobatchAssembler(
            job.consumer, max_batch=cfg.batch, max_delay_ms=cfg.max_delay_ms,
            clock=vclock, budget=plane.budget, budget_clock=vclock)

        # ---- the seeded timeline + fault plan
        sched, marks, ring, truth = _build_schedule(cfg, gen, clock[0])
        t_outage = marks["outage"] + cfg.outage_lead_s
        t_pool = marks["pool"]
        # device-fault windows scale with the pool phase so the round-robin
        # rotation is guaranteed to land batches on the victim inside them
        pool_phase_s = cfg.n_pool / cfg.tps
        plan = ChaosPlan([
            FaultWindow("flash_crowd", "arrival_spike",
                        marks["flash"], marks["outage"]),
            FaultWindow("broker_outage", "broker",
                        t_outage, t_outage + cfg.outage_s),
            FaultWindow("replica_death", "device_pool",
                        t_pool + 0.05, t_pool + 0.05 + 0.55 * pool_phase_s),
            FaultWindow("slow_device", "device_pool",
                        t_pool + 0.7 * pool_phase_s,
                        t_pool + 0.9 * pool_phase_s),
            FaultWindow("label_stall", "labels",
                        marks["ring"], marks["ring"] + cfg.label_stall_s),
        ])
        outage = BrokerReplicaOutage(
            primary, replica,
            lambda: BrokerServer(port=0, role="replica").start())
        stall = LabelStall()
        victim = 1 % len(devices)
        plan.bind("broker_outage", outage)
        plan.bind("replica_death",
                  DeviceReplicaDeath(pool, victim, cfg.replica_faults))
        plan.bind("slow_device",
                  SlowDevice(pool, victim, cfg.slow_device_ms / 1e3, n=2))
        plan.bind("label_stall", stall)

        # ---- drive state
        label_heap: List = []
        lseq = [0]
        label_retry: deque = deque()
        txn_retry: deque = deque()
        produced_ids: List[str] = []
        produce_failures = [0]
        fanout_failures = 0
        batch_integrity_ok = True
        ladder_trace: List[int] = []
        burn_trace: List[float] = []
        auc_trace: List[Tuple[float, float]] = []
        verdicts: List[Dict[str, Any]] = []
        in_flight: deque = deque()
        # virtual instant each id's batch completed (the ledger's time)
        completed_at: Dict[str, float] = {}
        next_i = 0
        idle = 0.01
        max_burn = [0.0]

        def push_labels(due: List[Tuple[float, Dict[str, Any]]]) -> None:
            txns = [t for _, t in due]
            ts_list = [ts for ts, _ in due]
            for ev in gen.label_events(txns, event_ts=ts_list,
                                       delay_scale=cfg.label_delay_scale):
                heapq.heappush(label_heap, (ev["label_ts"], lseq[0], ev))
                lseq[0] += 1

        # Producer outage mode: a produce that fails NotEnoughReplicas has
        # still APPENDED its records above the high watermark — re-attempting
        # every tick would stack one invisible copy per attempt. After the
        # first failure the producer buffers and probes broker health (ISR >=
        # min_isr via the status op) before retrying — the client-side analog
        # of a real producer's bounded retry-with-backoff.
        outage_mode = [False]

        def broker_healthy() -> bool:
            try:
                st = producer.status()
                return int(st.get("isr", 1)) >= int(st.get("min_isr", 1))
            except (RuntimeError, ConnectionError, OSError):
                return False

        def produce_txns(items: List[Tuple[str, Dict[str, Any], float]]) -> bool:
            try:
                producer.produce_batch_stamped(T.TRANSACTIONS, items)
                return True
            except (RuntimeError, ConnectionError, OSError):
                produce_failures[0] += 1
                outage_mode[0] = True
                return False

        def release_labels(now: float) -> int:
            if stall.active:
                return 0
            released = 0
            due = []
            while label_heap and label_heap[0][0] <= now:
                due.append(heapq.heappop(label_heap)[2])
            if outage_mode[0]:
                label_retry.extend(due)
                return 0
            due.extend(label_retry)
            label_retry.clear()
            if not due:
                return 0
            items = [(ev["transaction_id"], ev, ev["label_ts"]) for ev in due]
            try:
                producer.produce_batch_stamped(T.LABELS, items)
                released = len(items)
            except (RuntimeError, ConnectionError, OSError):
                produce_failures[0] += 1
                outage_mode[0] = True
                label_retry.extend(due)
            return released

        def observe_auc(now: float) -> None:
            a = fb.evaluator.auc()
            if not math.isnan(a) and len(fb.evaluator) >= cfg.min_labels:
                auc_trace.append((now, round(float(a), 4)))

        def complete_one() -> None:
            nonlocal fanout_failures, batch_integrity_ok
            ctx = in_flight.popleft()
            if ctx is None:
                return
            want = [str(r.value.get("transaction_id", "")) for r in ctx.fresh]
            try:
                results = job.complete_batch(ctx, now=clock[0])
                for r in results:
                    completed_at.setdefault(str(r.get("transaction_id", "")),
                                            clock[0])
                got = [str(r.get("transaction_id", "")) for r in results
                       if not (r.get("explanation") or {}).get(
                           "validation_errors")]
                if want and got[-len(want):] != want:
                    batch_integrity_ok = False
            except Exception:  # noqa: BLE001 — the broker is DOWN by design
                # crash-recovery semantics: fan-out failed mid-batch, offsets
                # were not committed — rewind to committed; the scored records
                # replay through the txn-cache dedupe (re-emitted from cache)
                fanout_failures += 1
                job.consumer.seek_to_committed()
            burn = tracer.slo.burn_rate(tracer.settings.slo_fast_window_s)
            burn_trace.append(round(burn, 3))
            max_burn[0] = max(max_burn[0], burn)
            observe_auc(clock[0])
            if fb.pending_trigger is not None:
                v = fb.react(now=clock[0])
                if v is not None:
                    verdicts.append(v)

        # recovery bookkeeping (virtual instants, None until observed)
        recovered_at: Dict[str, Optional[float]] = {
            "flash_crowd": None, "broker_outage": None, "replica_death": None}

        # ---- the drive loop --------------------------------------------------
        while True:
            now = clock[0]
            plan.poll(now)
            tracer.set_fault_context(",".join(plan.active(now)))

            due: List[Tuple[float, Dict[str, Any]]] = []
            while next_i < len(sched) and sched[next_i][0] <= now:
                due.append(sched[next_i])
                next_i += 1
            if due:
                push_labels(due)
                items = [(str(t["user_id"]), t, ts) for ts, t in due]
                produced_ids.extend(str(t["transaction_id"]) for _, t in due)
                if outage_mode[0]:
                    txn_retry.extend(items)
                elif not produce_txns(items):
                    txn_retry.extend(items)
            if outage_mode[0] and broker_healthy():
                outage_mode[0] = False
            if txn_retry and not outage_mode[0]:
                retry = list(txn_retry)
                txn_retry.clear()
                if not produce_txns(retry):
                    txn_retry.extend(retry)
                elif recovered_at["broker_outage"] is None:
                    recovered_at["broker_outage"] = now
                    plan.note_recovered("broker_outage", now)
            if release_labels(now):
                job.drain_labels()
                fb.check_trigger(now=now)
                if fb.pending_trigger is not None:
                    v = fb.react(now=now)
                    if v is not None:
                        verdicts.append(v)
                observe_auc(now)

            batch = job.assembler.next_batch(block=False)
            if not batch and next_i >= len(sched) and not txn_retry:
                batch = job.assembler.flush()
            if batch:
                ctx = job.dispatch_batch(batch, now=now)
                level = plane.effective_level()
                ladder_trace.append(level)
                clock[0] += cfg.cost_s(len(batch), level)
                if recovered_at["flash_crowd"] is None and level == 0 \
                        and now > marks["outage"]:
                    recovered_at["flash_crowd"] = now
                    plan.note_recovered("flash_crowd", now)
                in_flight.append(ctx)
                while len(in_flight) >= w:
                    complete_one()
                continue
            if in_flight:
                complete_one()
                continue
            if next_i >= len(sched) and not txn_retry and not label_heap \
                    and not label_retry and job.consumer.lag() == 0:
                break
            # idle: jump to the next scheduled event (arrival, label release,
            # fault transition), never backwards
            targets = [now + 0.25]
            if next_i < len(sched):
                targets.append(sched[next_i][0])
            if label_heap and not stall.active:
                targets.append(label_heap[0][0])
            for fw in plan.windows:
                for edge in (fw.t_start, fw.t_end):
                    if edge > now:
                        targets.append(edge)
            clock[0] = max(now + idle, min(targets))

        # pool recovery: the dead replica was revived by the plan; retries
        # were absorbed mid-flight
        pool_stats = pool.stats()
        if pool_stats["healthy"] == len(devices) and pool_stats["retries"] > 0:
            recovered_at["replica_death"] = clock[0]
            plan.note_recovered("replica_death", clock[0])

        # ---- settle the delayed-label tail, then quiet-period recovery -------
        def settle_labels(horizon_s: float = 30.0) -> None:
            t_end = clock[0] + horizon_s
            while (label_heap or label_retry) and clock[0] < t_end:
                nxt = label_heap[0][0] if label_heap else clock[0] + 0.25
                clock[0] = min(max(nxt, clock[0] + 0.25), t_end)
                if release_labels(clock[0]):
                    job.drain_labels()
                    fb.check_trigger(now=clock[0])
                if fb.pending_trigger is not None:
                    v = fb.react(now=clock[0])
                    if v is not None:
                        verdicts.append(v)
                observe_auc(clock[0])

        settle_labels()
        # a drained system: backlog reads zero and the SLO window ages out its
        # violations — both hysteresis gates must walk back to rung 0 / off
        for _ in range(48):
            if plane.ladder.level == 0 and not plane.slo_engaged:
                break
            clock[0] += tracer.settings.slo_bucket_s
            plane.observe_backlog(0)
            ts = tracer.settings
            plane.observe_slo_burn(
                tracer.slo.burn_rate(ts.slo_fast_window_s),
                threshold=ts.slo_burn_threshold,
                patience=ts.slo_gate_patience,
                up_patience=ts.slo_gate_up_patience)
            # drill drives the plane from one thread on the virtual clock
            # rtfd-lint: allow[lock-order] drill drives the plane from one thread on the virtual clock
            plane.apply_degradation(scorer)
        final_burn = tracer.slo.burn_rate(tracer.settings.slo_fast_window_s)

        # ---- ledger: read the predictions + transactions topics back ---------
        preds: List[Tuple[str, float, str, str]] = []   # (id, score, dec, kind)
        # the same rows with unrounded scores and the virtual instant their
        # batch completed: the caller's id-by-id comparison of two runs
        # (not digested)
        ledger: List[Tuple[str, float, str, str, Optional[float]]] = []
        n_parts = job_client.partitions(T.PREDICTIONS)
        for p in range(n_parts):
            off = 0
            while True:
                recs = job_client.read(T.PREDICTIONS, p, off, 2048)
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
                    preds.append((str(v.get("transaction_id", "")),
                                  round(float(v.get("fraud_score", 0.0)), 6),
                                  str(v.get("decision", "")), kind))
                    ledger.append((preds[-1][0],
                                   float(v.get("fraud_score", 0.0)),
                                   preds[-1][2], kind,
                                   completed_at.get(preds[-1][0])))

        by_id: Dict[str, Dict[str, int]] = {}
        for tid, _, _, kind in preds:
            by_id.setdefault(tid, {})[kind] = by_id.get(tid, {}).get(kind, 0) + 1
        produced_unique = set(produced_ids)
        covered = set(by_id)
        # "effectively once": every delivered transaction is accounted for on
        # the predictions topic, and no transaction was device-scored twice —
        # at most ONE non-replayed scored/error record per id (replayed-from-
        # cache re-emissions and shed decisions are the documented
        # at-least-once surplus, never double scoring)
        fresh_counts = [kinds.get("scored", 0) + kinds.get("error", 0)
                        for kinds in by_id.values()]
        shed_only = sum(1 for kinds in by_id.values()
                        if set(kinds) == {"shed"})
        effectively_once = (
            covered == produced_unique
            and all(c <= 1 for c in fresh_counts))
        # offset accounting: every transaction offset acked, visible, committed
        tx_ends = job_client.end_offsets(T.TRANSACTIONS)
        committed = [job_client.committed(job.config.group_id,
                                          T.TRANSACTIONS, p)
                     for p in range(len(tx_ends))]
        offsets_gap_free = committed == tx_ends

        # high-value sheds: the admission contract, checked from the metrics
        shed_by: Dict[str, int] = {}
        for labels, count in plane.metrics.qos_shed.by_label():
            shed_by[f"{labels.get('priority')}:{labels.get('reason')}"] = \
                int(count)
        high_sheds = sum(n for k, n in shed_by.items()
                         if k.startswith("high:"))

        # ring quality story, two measurements with different jobs:
        #  - LIVE signal (prequential sliding window): baseline = the last
        #    observation before the ring activates, dip = the worst after it —
        #    this is the monitoring signal that fires the retrain trigger;
        #  - RECOVERY (the drill's own labeled ledger): per-phase rank AUC of
        #    generator truth x served scores. The prequential window at drain
        #    time fills with long-delay labels from PRE-promotion ring traffic,
        #    so it lags the deployed blend by a label horizon; phase-scoping on
        #    `truth` measures what the retrained blend actually served during
        #    the recovery phase.
        baseline_auc = float("nan")
        for t, a in auc_trace:
            if t <= marks["ring"]:
                baseline_auc = a
        ring_dip = min((a for t, a in auc_trace if t > marks["ring"]),
                       default=float("nan"))
        final_auc = auc_trace[-1][1] if auc_trace else float("nan")
        score_by_id: Dict[str, float] = {}
        for tid, score, _, kind in preds:
            if kind in ("scored", "replayed") and tid not in score_by_id:
                score_by_id[tid] = score
        phase_samples: Dict[str, Tuple[List[float], List[bool]]] = {}
        for tid, (ph, y) in truth.items():
            s = score_by_id.get(tid)
            if s is not None:
                ss, yy = phase_samples.setdefault(ph, ([], []))
                ss.append(s)
                yy.append(y)
        phase_auc = {ph: round(_rank_auc(ss, yy), 4)
                     for ph, (ss, yy) in sorted(phase_samples.items())
                     if not math.isnan(_rank_auc(ss, yy))}
        promotions = [v for v in verdicts
                      if v.get("passed") and "promoted" in v
                      and v.get("ts", 0.0) >= marks["ring"]]

        # fault-window trace attribution (flight recorder)
        fault_traces: Dict[str, int] = {}
        for ct in tracer.traces():
            f = (ct.meta or {}).get("fault")
            if f:
                for name in str(f).split(","):
                    fault_traces[name] = fault_traces.get(name, 0) + 1

        # degraded-mode service quality (the bench `chaos` stage's numbers):
        # e2e p99 + virtual throughput of SCORED traffic inside any fault
        # window vs in the post-fault recovery phase, straight off the
        # fault-attributed flight recorder
        def _p99_ms(vals: List[float]) -> Optional[float]:
            return (round(float(np.percentile(np.asarray(vals), 99.0)), 3)
                    if vals else None)

        scored_traces = tracer.traces(terminal="scored")
        in_fault = [ct.e2e_ms for ct in scored_traces
                    if (ct.meta or {}).get("fault")]
        post_fault = [ct.e2e_ms for ct in scored_traces
                      if not (ct.meta or {}).get("fault")
                      and ct.t_start >= marks["recovery"]]
        fault_span_s = sum(w.t_end - w.t_start for w in plan.windows)
        recovery_span_s = marks["end"] - marks["recovery"]
        degraded = {
            "in_fault": {"n": len(in_fault), "p99_ms": _p99_ms(in_fault),
                         "tps": round(len(in_fault) / max(fault_span_s, 1e-9),
                                      1)},
            "post_fault": {"n": len(post_fault),
                           "p99_ms": _p99_ms(post_fault),
                           "tps": round(len(post_fault)
                                        / max(recovery_span_s, 1e-9), 1)},
        }

        # chaos_* Prometheus mirror (the series the obs plane exposes)
        plane.metrics.sync_chaos(plan.snapshot(clock[0]))

        digest = hashlib.sha256(json.dumps({
            "preds": preds,
            "ladder": ladder_trace,
            "sheds": sorted(shed_by.items()),
            "committed": committed,
            "auc": auc_trace,
            "promoted": [v.get("promoted") for v in promotions],
        }, sort_keys=True).encode()).hexdigest()

        outcome = {
            "incumbent": incumbent,
            "capacity_tps": round(capacity, 1),
            "marks": {k: round(v, 3) for k, v in marks.items()},
            "plan": plan.snapshot(clock[0]),
            "produced": len(produced_ids),
            "produced_unique": len(produced_unique),
            "scored": job.counters["scored"],
            "shed": job.counters["shed"],
            "duplicates_skipped": job.counters["duplicates_skipped"],
            "shed_by_priority_reason": shed_by,
            "high_value_sheds": int(high_sheds),
            "shed_only_ids": int(shed_only),
            "produce_failures": int(produce_failures[0]),
            "fanout_failures": int(fanout_failures),
            "effectively_once": bool(effectively_once),
            "offsets_gap_free": bool(offsets_gap_free),
            "tx_end_offsets": tx_ends,
            "tx_committed": committed,
            "max_ladder_level": max(ladder_trace, default=0),
            "final_ladder_level": plane.effective_level(),
            "max_burn": round(max_burn[0], 3),
            "final_burn": round(final_burn, 3),
            "pool": pool_stats,
            "batch_integrity_ok": bool(batch_integrity_ok),
            "ring": ring.stats(),
            "label_join": fb.join.stats(),
            "label_stalls": stall.stalls,
            "baseline_auc": (None if math.isnan(baseline_auc)
                             else round(baseline_auc, 4)),
            "ring_dip_auc": (None if math.isnan(ring_dip)
                             else round(ring_dip, 4)),
            "final_auc": (None if math.isnan(final_auc)
                          else round(final_auc, 4)),
            "phase_auc": phase_auc,
            "ring_promotions": len(promotions),
            "gate_verdicts": len(verdicts),
            "policy": dict(fb.counters),
            "verdict_tail": [
                {"ts": round(float(v.get("ts", 0.0)), 2),
                 "type": v.get("type"),
                 "passed": v.get("passed"),
                 "reason": v.get("reason"),
                 "trigger_reason": v.get("trigger_reason")}
                for v in verdicts[-4:]],
            "fault_window_traces": fault_traces,
            "degraded": degraded,
            "recovered_at": {k: (None if v is None else round(v, 3))
                             for k, v in recovered_at.items()},
            "broker_outages": outage.outages,
            "virtual_duration_s": round(clock[0], 2),
            "digest": digest,
            "first_promotion_ts": min(
                (float(v.get("ts", 0.0)) for v in verdicts
                 if v.get("passed") and "promoted" in v), default=None),
            "ledger": ledger,
        }
        return outcome
    finally:
        # teardown (fresh servers per run keep the replay hermetic) runs
        # even when the drive section raises: the in-process tier-1 smoke
        # and the replay's second run must never inherit live listener
        # threads or sockets from a failed first run
        producer.close()
        job_client.close()
        primary.stop()
        replica.stop()          # already-stopped servers tolerate stop()
        if outage is not None and outage.restored_replica is not None:
            outage.restored_replica.stop()


def run_chaos_drill(config: Optional[ChaosDrillConfig] = None,
                    fast: bool = False,
                    kernels: Optional[Any] = None) -> Dict[str, Any]:
    """Run the combined recovery drill (twice, when ``replay_check``) and
    assemble the verdict. ``kernels`` (a ``KernelSettings``) selects the
    scorer's hand-written kernels; None keeps them off."""
    from realtime_fraud_detection_tpu_torch.scoring.pool_drill import (
        pool_devices,
    )

    cfg = config or (ChaosDrillConfig.fast() if fast else ChaosDrillConfig())
    devices = pool_devices(cfg.n_devices, cfg.device)

    first = _run_once(cfg, devices, kernels)
    replay_identical = None
    if cfg.replay_check:
        second = _run_once(cfg, devices, kernels)
        replay_identical = second["digest"] == first["digest"]

    checks = {
        "zero_high_value_sheds": first["high_value_sheds"] == 0,
        "low_priority_sheds_occurred": first["shed"] > 0,
        "ladder_engaged": first["max_ladder_level"] >= 1,
        "ladder_recovered": first["final_ladder_level"] == 0,
        "burn_spiked": first["max_burn"] > 2.0,
        "burn_recovered": first["final_burn"] < 1.0,
        "broker_outage_hit": first["produce_failures"] > 0
        and first["broker_outages"] >= 1,
        "effectively_once": first["effectively_once"],
        "offsets_gap_free": first["offsets_gap_free"],
        "pool_retry_absorbed": first["pool"]["retries"] >= 1,
        "pool_healthy_again": (first["pool"]["healthy"]
                               == first["pool"]["n_devices"]),
        "fifo_batch_integrity": first["batch_integrity_ok"],
        "ring_auc_dipped": (first["baseline_auc"] is not None
                            and first["ring_dip_auc"] is not None
                            and first["baseline_auc"] - first["ring_dip_auc"]
                            >= cfg.auc_drop / 2),
        "ring_promoted_via_gate": first["ring_promotions"] >= 1,
        # recovery is judged on what the retrained blend SERVED during the
        # recovery phase (the drill's own truth ledger), against the same
        # ledger's healthy-phase baseline — the prequential window at drain
        # time still trails pre-promotion ring labels by a label horizon
        "ring_auc_recovered": (
            first["phase_auc"].get("recovery") is not None
            and first["phase_auc"].get("healthy") is not None
            and first["phase_auc"]["recovery"]
            >= first["phase_auc"]["healthy"] - 0.01),
        "fault_windows_traced": len(first["fault_window_traces"]) >= 3,
    }
    if replay_identical is not None:
        checks["replay_bit_identical"] = bool(replay_identical)

    summary: Dict[str, Any] = {
        "metric": "chaos_drill",
        "passed": all(bool(v) for v in checks.values()),
        "checks": checks,
        "n_devices": cfg.n_devices,
        "replay_identical": replay_identical,
        **first,
    }
    return summary


def compact_chaos_summary(summary: Dict[str, Any]) -> Dict[str, Any]:
    """The <2 KB final-stdout-line digest (bench.py convention: full
    result on the preceding line, compact parseable verdict last)."""
    compact = {
        "metric": "chaos_drill",
        "passed": summary.get("passed"),
        "checks": {k: bool(v)
                   for k, v in (summary.get("checks") or {}).items()},
        "produced": summary.get("produced"),
        "scored": summary.get("scored"),
        "shed": summary.get("shed"),
        "high_value_sheds": summary.get("high_value_sheds"),
        "produce_failures": summary.get("produce_failures"),
        "max_ladder_level": summary.get("max_ladder_level"),
        "max_burn": summary.get("max_burn"),
        "final_burn": summary.get("final_burn"),
        "pool_retries": (summary.get("pool") or {}).get("retries"),
        "baseline_auc": summary.get("baseline_auc"),
        "ring_dip_auc": summary.get("ring_dip_auc"),
        "final_auc": summary.get("final_auc"),
        "phase_auc": summary.get("phase_auc"),
        "degraded": summary.get("degraded"),
        "virtual_duration_s": summary.get("virtual_duration_s"),
        "digest": (summary.get("digest") or "")[:16],
        "summary_of": "full result JSON on the preceding stdout line",
    }
    line = json.dumps(compact, separators=(",", ":"))
    while len(line.encode()) >= 2048:     # hard contract: < 2 KB, one line
        for victim in ("degraded", "phase_auc", "checks", "digest",
                       "summary_of"):
            if compact.pop(victim, None) is not None:
                break
        else:
            compact = {"metric": "chaos_drill",
                       "passed": summary.get("passed")}
        line = json.dumps(compact, separators=(",", ":"))
    return compact
