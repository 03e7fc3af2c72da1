"""Graph drill: prove the entity-graph plane earns the GNN its place.

Port of the JAX package's ``graph/drill.py``; ``graph-drill`` is the graph
plane's acceptance drill. A coordinated ``sim/fraud_patterns.py FraudRing``
is in distribution feature by feature, so a per-feature model barely ranks
it; its signal is the linkage, many users funnelling through a few shared
devices, IPs and merchants. With the typed entity graph kept from the
transaction flow, two-hop sampling feeding the GNN branch through the
columnar assemble path, and cross-partition neighbour fetch over TCP, the
blend with the GNN ranks the ring where the trees alone cannot.

One seeded virtual-clock timeline drives a healthy phase, then a ring phase,
through two or more partition-scoped workers (``cluster/fleet.py
WorkerFleet`` over one broker log) whose scorers are real typed-mode
``TorchFraudScorer`` instances on ``device``: GBDT trees trained on the
host, and a typed GNN trained (``training/neural.py train_typed_gnn``, on
``device``) on a different seeded cohort's ring, so any lift is the
structure generalising, not ids remembered. The checks:

- **ring-phase AUC lift**: the served blend's AUC on the truth ledger well
  above the trees alone (the GBDT branch's own predictions from the same
  run), in the ring phase; the healthy phase must not regress;
- **cross-partition fetch exercised**: ring members hash across workers,
  and the workers' fetch clients resolve remote neighbour shares;
- **graceful degrade**: a seeded netfault window fully partitions the fetch
  links mid-ring-phase; degraded batches are counted inside the window and
  none before it, and no transaction is lost or errored;
- **columnar == serial**: with sampling on, ``assemble`` and
  ``assemble_serial`` give bit-identical tensors and scores;
- **bit-identical replay**: a second, fully fresh run (broker, fleet, fetch
  servers) gives the same SHA-256 over predictions, offsets and state.

``_run_fleet(kernels=...)`` runs the fleet with the scorers' hand-written
kernels selected (``utils/config.py KernelSettings``; off by default, as in
the JAX drill, which has no such switch), and its result also carries each
transaction's decision (``decisions``, outside the digest), so two runs can
be compared id by id.

Convention: the full summary JSON, then a compact (<2 KB) verdict as the
last stdout line.

``run_graph_sampling_bench`` is the benchmark's ``graph_sampling`` hook:
the sampler's cost cold and cached, and the fetch client's per-node against
batched requests to a live local server, host work only.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from realtime_fraud_detection_tpu_torch.stream import topics as T

__all__ = ["GraphDrillConfig", "run_graph_drill", "compact_graph_summary",
           "run_graph_sampling_bench"]


@dataclasses.dataclass
class GraphDrillConfig:
    """Drill sizes. The defaults are the full drill; ``fast()`` is the test
    size: the same phases and netfault window, a smaller stream."""

    seed: int = 7
    n_workers: int = 3
    n_partitions: int = 12          # the transactions topic's contract
    num_users: int = 4_000
    num_merchants: int = 120
    # phases (transactions)
    healthy_txns: int = 2_048
    ring_txns: int = 4_096
    # training segments (separate seeded generators)
    trees_train_txns: int = 4_096
    gnn_train_txns: int = 8_000
    n_trees: int = 32
    tree_depth: int = 6
    # stream shape
    batch: int = 64
    max_delay_ms: float = 25.0
    inflight_depth: int = 2
    tps: float = 2_000.0
    # deterministic service-cost model (virtual ms per dispatched batch)
    base_ms: float = 4.0
    per_txn_ms: float = 0.16
    # graph shape
    fanout: int = 8
    fanout2: int = 8
    node_dim: int = 16
    # the ring (serving phase; the training generator draws its own)
    ring_rate: float = 0.2
    ring_members: int = 24
    ring_devices: int = 4
    ring_ips: int = 3
    # cross-partition fetch. The deadline is on the wall clock (socket reads
    # cannot run on the virtual one), so it sits far past any loopback
    # stall: a deadline firing would change what was sampled and break the
    # replay. The degrade path runs through the netfault window instead.
    fetch_deadline_ms: float = 30_000.0
    fetch_budget: int = 4_096
    # netfault window, as fractions of the ring phase
    netfault_start_frac: float = 0.35
    netfault_len_frac: float = 0.25
    # acceptance bars
    min_auc_lift: float = 0.05
    healthy_regression_slack: float = 0.05
    # second, fully fresh run compared digest for digest with the first
    replay_check: bool = True
    # where the scorers and the GNN trainer run: "cuda" (the card) or "cpu"
    device: str = "cuda"

    @classmethod
    def fast(cls) -> "GraphDrillConfig":
        """The test size: every phase (ring, remote fetch, netfault degrade,
        replay) still runs; the stream and the training shrink."""
        return cls(n_workers=2, num_users=1_500, num_merchants=60,
                   healthy_txns=768, ring_txns=1_536,
                   trees_train_txns=2_048, gnn_train_txns=4_000,
                   n_trees=24)

    def cost_s(self, n: int) -> float:
        return (self.base_ms + n * self.per_txn_ms) / 1e3

    def phase_edges(self) -> Tuple[float, float, float, float]:
        """(t_ring, t_nf_start, t_nf_end, t_end) on the virtual clock."""
        t_ring = self.healthy_txns / self.tps
        ring_len = self.ring_txns / self.tps
        t0 = t_ring + self.netfault_start_frac * ring_len
        return (t_ring, t0, t0 + self.netfault_len_frac * ring_len,
                t_ring + ring_len)


# ----------------------------------------------------------------- helpers


def _auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Tie-averaged Mann-Whitney AUC (``feedback/prequential.py``)."""
    from realtime_fraud_detection_tpu_torch.feedback.prequential import (
        sliding_auc,
    )

    return sliding_auc(np.asarray(labels, np.float64),
                       np.asarray(scores, np.float64))


def _drill_bert_config():
    from realtime_fraud_detection_tpu_torch.models.bert import BertConfig

    # a minimal text branch: it is disabled in the blend and keeps the
    # fused program's production shape
    return BertConfig(vocab_size=2_048, hidden_size=32, num_layers=1,
                      num_heads=2, intermediate_size=64,
                      max_position_embeddings=64)


def _scorer_config(cfg: GraphDrillConfig):
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import ScorerConfig

    return ScorerConfig(graph_mode="typed", fanout=cfg.fanout,
                        graph_fanout2=cfg.fanout2,
                        node_dim=cfg.node_dim, text_len=16,
                        token_cache_entries=4_096)


def _train_models(cfg: GraphDrillConfig):
    """Trained ``ScoringModels`` and the drill's BERT config: GBDT trees on
    a seeded stream through the production assemble path (the quant drill's
    recipe) and the typed GNN on a different seeded cohort's ring, which
    shares no member, device or IP id with the serving ring. The GNN's
    initial weights come from numpy (``train_typed_gnn``'s own)."""
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import (
        init_scoring_models,
    )
    from realtime_fraud_detection_tpu_torch.scoring.scorer import (
        TorchFraudScorer,
    )
    from realtime_fraud_detection_tpu_torch.sim.fraud_patterns import (
        FraudRingConfig,
    )
    from realtime_fraud_detection_tpu_torch.sim.simulator import (
        TransactionGenerator,
    )
    from realtime_fraud_detection_tpu_torch.training.gbdt import GBDTTrainer
    from realtime_fraud_detection_tpu_torch.training.neural import (
        train_typed_gnn,
    )

    bert_config = _drill_bert_config()
    # trees: the per-feature incumbent
    gen_t = TransactionGenerator(num_users=cfg.num_users,
                                 num_merchants=cfg.num_merchants,
                                 seed=cfg.seed + 1_000)
    scorer = TorchFraudScorer(scorer_config=_scorer_config(cfg),
                              bert_config=bert_config, seed=cfg.seed,
                              device=cfg.device)
    scorer.seed_profiles(gen_t.users.profiles(), gen_t.merchants.profiles())
    xs, ys = [], []
    done, ts = 0, 0.0
    while done < cfg.trees_train_txns:
        n = min(cfg.batch, cfg.trees_train_txns - done)
        recs = gen_t.generate_batch(n)
        batch = scorer.assemble(recs, now=ts)
        xs.append(np.asarray(batch.features))
        ys.append(np.asarray([bool(r.get("is_fraud")) for r in recs],
                             np.float32))
        for r in recs:     # serving's write-back: later segments see state
            scorer.velocity.update(str(r.get("user_id", "")),
                                   float(r.get("amount", 0.0)), ts)
        done += n
        ts += n / 200.0
    trees = GBDTTrainer(n_estimators=cfg.n_trees, max_depth=cfg.tree_depth,
                        seed=cfg.seed).fit(np.concatenate(xs),
                                           np.concatenate(ys))
    # typed GNN: a different cohort's ring
    gen_g = TransactionGenerator(num_users=cfg.num_users,
                                 num_merchants=cfg.num_merchants,
                                 seed=cfg.seed + 2_000)
    gen_g.inject_fraud_ring(FraudRingConfig(
        rate=cfg.ring_rate, n_members=cfg.ring_members,
        n_devices=cfg.ring_devices, n_ips=cfg.ring_ips))
    gnn = train_typed_gnn(gen_g, n_transactions=cfg.gnn_train_txns,
                          fanout=cfg.fanout, fanout2=cfg.fanout2,
                          node_dim=cfg.node_dim, seed=cfg.seed,
                          device=cfg.device)
    models = init_scoring_models(
        cfg.seed, bert_config=bert_config, node_dim=cfg.node_dim,
        n_trees=cfg.n_trees, tree_depth=cfg.tree_depth, gnn_typed=True)
    return dataclasses.replace(models, trees=trees, gnn=gnn), bert_config


def _build_schedule(cfg: GraphDrillConfig):
    """The seeded two-phase arrival timeline: (sched, truth,
    ring_member_ids, profiles), where truth maps a transaction id to
    (phase, is_fraud, is_ring)."""
    from realtime_fraud_detection_tpu_torch.sim.fraud_patterns import (
        FraudRingConfig,
    )
    from realtime_fraud_detection_tpu_torch.sim.simulator import (
        TransactionGenerator,
    )

    gen = TransactionGenerator(num_users=cfg.num_users,
                               num_merchants=cfg.num_merchants,
                               seed=cfg.seed, tps=cfg.tps)
    sched: List[Tuple[float, Dict[str, Any]]] = []
    truth: Dict[str, Tuple[str, bool, bool]] = {}
    t = 0.0

    def emit(txns, phase):
        nonlocal t
        for txn in txns:
            txn["event_ts"] = round(t, 9)
            sched.append((t, txn))
            truth[str(txn["transaction_id"])] = (
                phase, bool(txn.get("is_fraud")),
                txn.get("fraud_type") == "fraud_ring")
            t += 1.0 / cfg.tps

    done = 0
    while done < cfg.healthy_txns:
        n = min(1_024, cfg.healthy_txns - done)
        emit(gen.generate_batch(n), "healthy")
        done += n
    ring = gen.inject_fraud_ring(FraudRingConfig(
        rate=cfg.ring_rate, n_members=cfg.ring_members,
        n_devices=cfg.ring_devices, n_ips=cfg.ring_ips))
    done = 0
    while done < cfg.ring_txns:
        n = min(1_024, cfg.ring_txns - done)
        emit(gen.generate_batch(n), "ring")
        done += n
    return (sched, truth, [str(u) for u in ring.member_ids],
            (gen.users.profiles(), gen.merchants.profiles()))


# ------------------------------------------------------------------- fleet


def _run_fleet(cfg: GraphDrillConfig, sched, profiles, models,
               bert_config, kernels: Optional[Any] = None) -> Dict[str, Any]:
    """One fleet of typed-graph scorers over the schedule on a fresh broker,
    with a TCP fetch server a worker and a seeded netfault window
    partitioning the fetch links mid-ring-phase. ``kernels`` (a
    ``KernelSettings``) selects the scorers' hand-written kernels."""
    from realtime_fraud_detection_tpu_torch.chaos.faults import (
        ChaosPlan,
        FaultWindow,
    )
    from realtime_fraud_detection_tpu_torch.chaos.netfaults import (
        LinkState,
        NetworkPartition,
    )
    from realtime_fraud_detection_tpu_torch.cluster.fleet import WorkerFleet
    from realtime_fraud_detection_tpu_torch.cluster.hashring import (
        partition_for_key,
    )
    from realtime_fraud_detection_tpu_torch.graph.fetch import (
        GraphFetchClient,
        GraphFetchServer,
    )
    from realtime_fraud_detection_tpu_torch.scoring.scorer import (
        TorchFraudScorer,
    )
    from realtime_fraud_detection_tpu_torch.stream.transport import (
        InMemoryBroker,
    )
    from realtime_fraud_detection_tpu_torch.utils.backoff import (
        DeterministicBackoff,
    )
    from realtime_fraud_detection_tpu_torch.utils.config import Config

    uprofs, mprofs = profiles
    broker = InMemoryBroker()
    clock = [0.0]
    vclock = lambda: clock[0]                                  # noqa: E731

    def factory(worker_id: str, store) -> TorchFraudScorer:
        config = Config()
        for name in ("lstm_sequential", "bert_text", "isolation_forest"):
            config.disable_model(name)
        config.update_model_weight("xgboost_primary", 0.5)
        config.update_model_weight("graph_neural", 0.5)
        if kernels is not None:
            config.kernels = kernels
        return TorchFraudScorer(config=config, models=models,
                                scorer_config=_scorer_config(cfg),
                                bert_config=bert_config, stores=store,
                                device=cfg.device)

    fleet = WorkerFleet(
        broker, cfg.n_workers, cfg.n_partitions, factory,
        topic=T.TRANSACTIONS, clock=vclock, max_batch=cfg.batch,
        max_delay_ms=cfg.max_delay_ms,
        store_kwargs={"graph_fanout": cfg.fanout})

    # profiles: each worker seeds the users it owns (the store refuses the
    # others) and the replicated merchant set
    for w in fleet.workers.values():
        owned = set(w.store.owned())
        w.scorer.seed_profiles(
            {u: p for u, p in uprofs.items()
             if partition_for_key(u, cfg.n_partitions) in owned},
            mprofs)

    # the fetch plane: one TCP server a worker over its owned partitions'
    # graph; each worker's client targets the other workers through a
    # chaos link in the request path
    servers = {
        wid: GraphFetchServer(
            graph_source=(lambda w=w: w.store.graph),
            worker_id=wid).start()
        for wid, w in fleet.workers.items()}
    links: Dict[str, LinkState] = {}
    clients: Dict[str, GraphFetchClient] = {}
    for wid, w in fleet.workers.items():
        link = LinkState(f"graphfetch-{wid}", "peers",
                         sleep=lambda _s: None, seed=cfg.seed)
        client = GraphFetchClient(
            {pid: ("127.0.0.1", srv.port)
             for pid, srv in servers.items() if pid != wid},
            deadline_ms=cfg.fetch_deadline_ms,
            node_budget=cfg.fetch_budget,
            # a down peer is retried on the very next batch: failures come
            # only from the seeded link windows, so the heal instant is the
            # window's edge, not a wall-clock backoff
            backoff=DeterministicBackoff(base_s=1e-6, mult=1.0,
                                         max_s=1e-6, jitter_frac=0.0,
                                         sleep=lambda _s: None),
            link=link)
        w.scorer.attach_graph_fetch(client)
        links[wid] = link
        clients[wid] = client

    t_ring, t_nf0, t_nf1, _t_end = cfg.phase_edges()
    plan = ChaosPlan([FaultWindow("graph_partition", "net", t_nf0, t_nf1)])
    plan.bind("graph_partition",
              NetworkPartition(list(links.values()), mode="full"))

    next_i = 0
    n = len(sched)
    degraded_pre_window: Optional[int] = None
    window_open = False

    def degraded_total() -> int:
        return sum(c.degraded_batches_total for c in clients.values())

    while True:
        now = clock[0]
        if not window_open and now >= t_nf0:
            degraded_pre_window = degraded_total()
            window_open = True
        plan.poll(now)
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
                w.on_batch_complete()
                progressed = True
            if len(w.in_flight) < cfg.inflight_depth:
                batch = w.assembler.next_batch(block=False)
                if not batch and next_i >= n:
                    batch = w.assembler.flush()
                if batch:
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
        for fw in plan.windows:
            for edge in (fw.t_start, fw.t_end):
                if edge > now:
                    targets.append(edge)
        clock[0] = max(now + 1e-9,
                       min(targets) if targets else now + 0.01)

    makespan = clock[0]
    degraded_in_window = (degraded_total() - (degraded_pre_window or 0))

    # the ledger: the predictions topic, with the branches' predictions
    preds: List[Tuple[str, float, float, float, str]] = []
    decisions: Dict[str, str] = {}
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
                mp = v.get("model_predictions") or {}
                tid = str(v.get("transaction_id", ""))
                preds.append((tid,
                              round(float(v.get("fraud_score", -1.0)), 6),
                              round(float(mp.get("xgboost_primary", -1.0)),
                                    6),
                              round(float(mp.get("graph_neural", -1.0)), 6),
                              kind))
                if kind == "scored":
                    decisions.setdefault(tid, str(v.get("decision", "")))

    tx_ends = broker.end_offsets(T.TRANSACTIONS)
    committed = [broker.committed(fleet.group_id, T.TRANSACTIONS, p)
                 for p in range(len(tx_ends))]
    digests: Dict[int, str] = {}
    for w in fleet.alive_workers():
        for p, d in w.store.digests(now=makespan).items():
            digests[p] = d

    fetch_stats = {wid: c.stats() for wid, c in sorted(clients.items())}
    server_stats = {wid: {"requests_total": s.requests_total,
                          "fenced_requests_total": s.fenced_requests_total}
                    for wid, s in sorted(servers.items())}
    link_stats = {wid: lk.snapshot_entry()
                  for wid, lk in sorted(links.items())}
    graph_stats = {wid: w.scorer.graph_snapshot()
                   for wid, w in sorted(fleet.workers.items())}
    for srv in servers.values():
        srv.stop()
    for c in clients.values():
        c.close()

    # the digest covers the ledger, offsets, per-partition state (the graph
    # rides PartitionState.digest) and the assignment; the fetch and link
    # counters are left out: the partition window's refusal count can vary
    # with batch timing while which neighbourhoods were resolvable is
    # pinned by the virtual-clock schedule
    digest = hashlib.sha256(json.dumps({
        "preds": sorted(preds),
        "committed": committed,
        "assignment": fleet.assignment(),
        "state": sorted(digests.items()),
    }, sort_keys=True).encode()).hexdigest()

    return {
        "makespan_s": round(makespan, 4),
        "preds": preds,
        "decisions": decisions,
        "committed": committed,
        "tx_ends": tx_ends,
        "digests": digests,
        "counters": fleet.counters(),
        "assignment": fleet.assignment(),
        "fetch": fetch_stats,
        "servers": server_stats,
        "links": link_stats,
        "graph": graph_stats,
        "degraded_pre_window": degraded_pre_window,
        "degraded_in_window": degraded_in_window,
        "digest": digest,
    }


# ---------------------------------------------------------- serial check


def _columnar_serial_check(cfg: GraphDrillConfig, models,
                           bert_config) -> Dict[str, Any]:
    """``assemble`` against ``assemble_serial`` with typed sampling on:
    fresh scorers, the same trained models, ring traffic, local sampling
    (no fetch client, as in the JAX drill)."""
    from realtime_fraud_detection_tpu_torch.core.packing import tree_flatten
    from realtime_fraud_detection_tpu_torch.scoring.scorer import (
        TorchFraudScorer,
    )
    from realtime_fraud_detection_tpu_torch.sim.fraud_patterns import (
        FraudRingConfig,
    )
    from realtime_fraud_detection_tpu_torch.sim.simulator import (
        TransactionGenerator,
    )

    gen = TransactionGenerator(num_users=400, num_merchants=40,
                               seed=cfg.seed + 3_000)
    gen.inject_fraud_ring(FraudRingConfig(rate=cfg.ring_rate))
    pair = []
    for _ in range(2):
        s = TorchFraudScorer(models=models, scorer_config=_scorer_config(cfg),
                             bert_config=bert_config, seed=cfg.seed,
                             device=cfg.device)
        s.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
        pair.append(s)
    col, ser = pair
    leaves_equal = True
    score_mismatches = 0
    checked = 0
    for i in range(4):
        recs = gen.generate_batch(24)
        ts = float(i)
        b_col = col.assemble(recs, now=ts)
        b_ser = ser.assemble_serial(recs, now=ts)
        la, ta = tree_flatten(b_col)
        lb, tb = tree_flatten(b_ser)
        if ta != tb:
            leaves_equal = False
            break
        for x, y in zip(la, lb):
            if not np.array_equal(np.asarray(x), np.asarray(y)):
                leaves_equal = False
        r_col = col.finalize(col.dispatch_assembled(b_col, recs), now=ts)
        r_ser = ser.finalize(ser.dispatch_assembled(b_ser, recs), now=ts)
        for a, b in zip(r_col, r_ser):
            checked += 1
            if a["fraud_score"] != b["fraud_score"]:
                score_mismatches += 1
    return {"leaves_equal": leaves_equal,
            "score_mismatches": score_mismatches,
            "scores_checked": checked}


# ------------------------------------------------------------------ drill


def run_graph_drill(config: Optional[GraphDrillConfig] = None,
                    fast: bool = False) -> Dict[str, Any]:
    from realtime_fraud_detection_tpu_torch.cluster.hashring import (
        partition_for_key,
    )

    cfg = config or (GraphDrillConfig.fast() if fast
                     else GraphDrillConfig())
    models, bert_config = _train_models(cfg)
    sched, truth, ring_members, profiles = _build_schedule(cfg)
    out = _run_fleet(cfg, sched, profiles, models, bert_config)

    # the truth ledger's AUCs by phase: the served blend against the trees
    # alone, read from the same run's branch predictions
    phase_rows: Dict[str, Dict[str, List[float]]] = {
        "healthy": {"y": [], "served": [], "trees": [], "gnn": [],
                    "ring": []},
        "ring": {"y": [], "served": [], "trees": [], "gnn": [],
                 "ring": []},
    }
    by_id: Dict[str, int] = {}
    for tid, served, trees_p, gnn_p, kind in out["preds"]:
        if kind != "scored":
            continue
        by_id[tid] = by_id.get(tid, 0) + 1
        t = truth.get(tid)
        if t is None:
            continue
        phase, is_fraud, is_ring = t
        rows = phase_rows[phase]
        rows["y"].append(float(is_fraud))
        rows["served"].append(served)
        rows["trees"].append(trees_p)
        rows["gnn"].append(gnn_p)
        rows["ring"].append(float(is_ring))

    def aucs(phase: str) -> Dict[str, float]:
        rows = phase_rows[phase]
        y = np.asarray(rows["y"], bool)
        ring_mask = np.asarray(rows["ring"], bool)
        served = np.asarray(rows["served"])
        trees_p = np.asarray(rows["trees"])
        gnn_p = np.asarray(rows["gnn"])
        res = {
            "graph_on": round(_auc(y, served), 4),
            "incumbent_trees": round(_auc(y, trees_p), 4),
            "gnn_branch": round(_auc(y, gnn_p), 4),
        }
        keep = ring_mask | ~y          # ring fraud against benign
        if ring_mask.any():
            res["ring_vs_benign_graph_on"] = round(
                _auc(ring_mask[keep], served[keep]), 4)
            res["ring_vs_benign_incumbent"] = round(
                _auc(ring_mask[keep], trees_p[keep]), 4)
        return res

    auc_healthy = aucs("healthy")
    auc_ring = aucs("ring")
    lift = round(auc_ring["graph_on"] - auc_ring["incumbent_trees"], 4)

    # coverage, fetch and degrade facts
    produced = list(truth)
    lost = len(set(produced) - set(by_id))
    double = sum(1 for c in by_id.values() if c > 1)
    remote_fetches = sum(s["remote_fetch_total"]
                         for s in out["fetch"].values())
    remote_nodes = sum(s["fetched_nodes_total"]
                       for s in out["fetch"].values())
    partition_refusals = sum(lk["partitioned_sends_total"]
                             for lk in out["links"].values())
    # the ring straddles shards: its members' partitions span 2+ workers
    owner_of = {p: wid for wid, parts in out["assignment"].items()
                for p in parts}
    ring_workers = sorted({owner_of.get(
        partition_for_key(u, cfg.n_partitions), "?")
        for u in ring_members})

    serial = _columnar_serial_check(cfg, models, bert_config)

    replay_identical = None
    if cfg.replay_check:
        sched2, _truth2, _rm2, profiles2 = _build_schedule(cfg)
        second = _run_fleet(cfg, sched2, profiles2, models, bert_config)
        replay_identical = second["digest"] == out["digest"]

    checks = {
        "workers_enough": cfg.n_workers >= 2,
        "ring_straddles_shards": len(ring_workers) >= 2,
        "zero_lost": lost == 0,
        "every_txn_scored_once": (double == 0
                                  and len(by_id) == len(produced)),
        "zero_errors": out["counters"]["errors"] == 0,
        "offsets_gap_free": out["committed"] == out["tx_ends"],
        "remote_fetch_exercised": (remote_fetches > 0
                                   and remote_nodes > 0),
        "degrade_exercised_in_window": out["degraded_in_window"] > 0,
        "no_degrade_before_window": (out["degraded_pre_window"] or 0) == 0,
        "partition_refusals_counted": partition_refusals > 0,
        "ring_auc_lift": lift >= cfg.min_auc_lift,
        "healthy_not_regressed": (
            auc_healthy["graph_on"]
            >= auc_healthy["incumbent_trees"]
            - cfg.healthy_regression_slack),
        "columnar_serial_bitexact": (serial["leaves_equal"]
                                     and serial["score_mismatches"] == 0),
    }
    if replay_identical is not None:
        checks["replay_bit_identical"] = bool(replay_identical)

    summary: Dict[str, Any] = {
        "metric": "graph_drill",
        "passed": all(bool(v) for v in checks.values()),
        "checks": checks,
        "n_workers": cfg.n_workers,
        "n_partitions": cfg.n_partitions,
        "num_users": cfg.num_users,
        "produced": len(produced),
        "scored": out["counters"]["scored"],
        "lost": lost,
        "double_scored": double,
        "auc": {"healthy": auc_healthy, "ring": auc_ring,
                "ring_phase_lift": lift},
        "ring_workers": ring_workers,
        "ring_members": len(ring_members),
        "remote_fetches": remote_fetches,
        "remote_nodes": remote_nodes,
        "partition_refusals": partition_refusals,
        "degraded_in_window": out["degraded_in_window"],
        "degraded_pre_window": out["degraded_pre_window"],
        "fetch": out["fetch"],
        "graph": out["graph"],
        "columnar_serial": serial,
        "makespan_s": out["makespan_s"],
        "replay_identical": replay_identical,
        "digest": out["digest"],
    }
    return summary


def compact_graph_summary(summary: Dict[str, Any]) -> Dict[str, Any]:
    """The <2 KB last-stdout-line verdict (the full result is on the line
    before it)."""
    auc = summary.get("auc") or {}
    compact = {
        "metric": "graph_drill",
        "passed": summary.get("passed"),
        "checks": {k: bool(v)
                   for k, v in (summary.get("checks") or {}).items()},
        "n_workers": summary.get("n_workers"),
        "produced": summary.get("produced"),
        "scored": summary.get("scored"),
        "lost": summary.get("lost"),
        "ring_phase_lift": auc.get("ring_phase_lift"),
        "ring_auc": auc.get("ring"),
        "remote_fetches": summary.get("remote_fetches"),
        "degraded_in_window": summary.get("degraded_in_window"),
        "ring_workers": summary.get("ring_workers"),
        "digest": (summary.get("digest") or "")[:16],
        "summary_of": "full result JSON on the preceding stdout line",
    }
    line = json.dumps(compact, separators=(",", ":"))
    while len(line.encode()) >= 2048:
        for victim in ("ring_auc", "checks", "ring_workers", "digest",
                       "summary_of"):
            if compact.pop(victim, None) is not None:
                break
        else:
            compact = {"metric": "graph_drill",
                       "passed": summary.get("passed")}
        line = json.dumps(compact, separators=(",", ":"))
    return compact


# ------------------------------------------------------------- bench hook


def run_graph_sampling_bench(seed: int = 7) -> Dict[str, Any]:
    """The benchmark's ``graph_sampling`` micro half: per-txn sampler cost
    cold against cached on a seeded synthetic graph, and remote-fetch
    amortisation (one node a request against one batched request) against
    a live local fetch server. Host work only; no device is touched."""
    import time

    from realtime_fraud_detection_tpu_torch.graph.fetch import (
        GraphFetchClient,
        GraphFetchServer,
    )
    from realtime_fraud_detection_tpu_torch.graph.sampler import NeighborSampler
    from realtime_fraud_detection_tpu_torch.graph.store import TypedEntityGraph

    rng = np.random.default_rng(seed)
    node_dim, fanout = 16, 8
    n_users, n_devices, n_merchants = 4_096, 1_024, 256
    graph = TypedEntityGraph(fanout=fanout)
    users = [f"u{i}" for i in range(n_users)]
    for start in range(0, n_users, 512):
        chunk = users[start:start + 512]
        graph.add_batch(
            chunk,
            [f"m{int(i)}" for i in rng.integers(0, n_merchants, len(chunk))],
            [f"d{int(i)}" for i in rng.integers(0, n_devices, len(chunk))],
            [f"ip{int(i)}" for i in rng.integers(0, 2_048, len(chunk))])

    def zeros(ids):
        return np.zeros((len(ids), node_dim), np.float32)

    sampler = NeighborSampler(graph, node_dim, fanout, fanout,
                              user_rows=zeros, merchant_rows=zeros)
    batch_u = [f"u{int(i)}" for i in rng.integers(0, n_users, 256)]
    batch_m = [f"m{int(i)}" for i in rng.integers(0, n_merchants, 256)]
    t0 = time.perf_counter()  # rtfd-lint: allow[wall-clock] bench timing: real host microseconds
    sampler.sample(batch_u, batch_m)
    cold_us = (time.perf_counter() - t0) / len(batch_u) * 1e6  # rtfd-lint: allow[wall-clock] bench timing: real host microseconds
    t0 = time.perf_counter()  # rtfd-lint: allow[wall-clock] bench timing: real host microseconds
    sampler.sample(batch_u, batch_m)
    cached_us = (time.perf_counter() - t0) / len(batch_u) * 1e6  # rtfd-lint: allow[wall-clock] bench timing: real host microseconds

    server = GraphFetchServer(lambda: graph, worker_id="bench").start()
    try:
        client = GraphFetchClient({"peer": ("127.0.0.1", server.port)},
                                  deadline_ms=5_000.0, node_budget=10_000)
        dev_ids = [f"d{int(i)}" for i in rng.integers(0, n_devices, 128)]
        client.begin_batch()
        t0 = time.perf_counter()  # rtfd-lint: allow[wall-clock] bench timing: real host microseconds
        for d in dev_ids:
            client.fetch("device->user", [d], fanout)
        per_node_us = (time.perf_counter() - t0) / len(dev_ids) * 1e6  # rtfd-lint: allow[wall-clock] bench timing: real host microseconds
        client.end_batch()
        client.begin_batch()
        t0 = time.perf_counter()  # rtfd-lint: allow[wall-clock] bench timing: real host microseconds
        client.fetch("device->user", dev_ids, fanout)
        batched_us = (time.perf_counter() - t0) / len(dev_ids) * 1e6  # rtfd-lint: allow[wall-clock] bench timing: real host microseconds
        client.end_batch()
        client.close()
    finally:
        server.stop()
    return {
        "graph_nodes": graph.stats()["nodes"],
        "sampler_cold_us_per_txn": round(cold_us, 2),
        "sampler_cached_us_per_txn": round(cached_us, 2),
        "cache_speedup": round(cold_us / max(cached_us, 1e-9), 2),
        "remote_per_node_us": round(per_node_us, 1),
        "remote_batched_us_per_node": round(batched_us, 1),
        "remote_batch_amortization": round(
            per_node_us / max(batched_us, 1e-9), 2),
        "sampler": sampler.stats(),
    }
