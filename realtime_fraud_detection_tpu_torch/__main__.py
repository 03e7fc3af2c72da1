"""Command-line entry point of the port.

    python -m realtime_fraud_detection_tpu_torch run-job --count 10000 --mega [--overlap-assembly] [--device-pool [--inflight-depth N]] [--qos] [--trace] [--autotune] [--feedback] [--analytics] [--enrichment]
    python -m realtime_fraud_detection_tpu_torch run-job --broker 127.0.0.1:9092 --count 0 [--duration S] --checkpoint-dir D [--metadata-db F]
    python -m realtime_fraud_detection_tpu_torch run-job --state 127.0.0.1:6379 --count 4096 --quant --mega
    python -m realtime_fraud_detection_tpu_torch state-server --port 6379 [--aof F] [--maxmemory B] [--policy P] [--replica-of H:P]
    python -m realtime_fraud_detection_tpu_torch broker --port 9092 [--log-dir D] [--role replica] [--min-isr N] [--replica H:P]
    python -m realtime_fraud_detection_tpu_torch topics [--broker 127.0.0.1:9092 --create]
    python -m realtime_fraud_detection_tpu_torch alert-router --broker 127.0.0.1:9092 [--webhook URL] [--once]
    python -m realtime_fraud_detection_tpu_torch kernel-drill --fast [--mega]
    python -m realtime_fraud_detection_tpu_torch feedback-drill [--fast]
    python -m realtime_fraud_detection_tpu_torch quant-drill [--fast] [--no-replay]
    python -m realtime_fraud_detection_tpu_torch pool-drill [--fast] [--devices N] [--inflight-depth D]
    python -m realtime_fraud_detection_tpu_torch mesh-drill [--fast] [--devices N] [--model-axis M] [--no-replay] [--device cpu]
    python -m realtime_fraud_detection_tpu_torch shard-drill [--fast] [--workers N] [--no-replay]
    python -m realtime_fraud_detection_tpu_torch elastic-drill [--fast] [--no-replay]
    python -m realtime_fraud_detection_tpu_torch partition-drill [--fast] [--workers N] [--no-replay]
    python -m realtime_fraud_detection_tpu_torch chaos-drill [--fast] [--devices N] [--config F] [--no-replay]
    python -m realtime_fraud_detection_tpu_torch graph-drill [--fast] [--workers N] [--no-replay]
    python -m realtime_fraud_detection_tpu_torch obs-drill [--fast] [--workers N] [--rings-out D] [--no-replay]
    python -m realtime_fraud_detection_tpu_torch cluster-worker --spec JSON
    python -m realtime_fraud_detection_tpu_torch qos-drill
    python -m realtime_fraud_detection_tpu_torch trace-drill [--fast]
    python -m realtime_fraud_detection_tpu_torch autotune-drill [--fast]
    python -m realtime_fraud_detection_tpu_torch trace-export --count 2048 --out trace.json
    python -m realtime_fraud_detection_tpu_torch trace-export --merge ring_w0.json ring_w1.json --out fleet.json
    python -m realtime_fraud_detection_tpu_torch serve --port 8080 [--state H:P] [--quant] [--kernels|--mega] [--trace] [--qos] [--autotune] [--overlap-assembly] [--device-pool [--inflight-depth N]]
    python -m realtime_fraud_detection_tpu_torch health-check --url http://127.0.0.1:8080
    python -m realtime_fraud_detection_tpu_torch simulate --count 1000 [--broker 127.0.0.1:9092]
    python -m realtime_fraud_detection_tpu_torch train --rows 10000 [--neural] --out ./checkpoints
    python -m realtime_fraud_detection_tpu_torch validate --checkpoint-dir ./checkpoints [--min-auc 0.8]
    python -m realtime_fraud_detection_tpu_torch quality-eval [--checkpoint-dir D] [--output Q.json]

``run-job`` is the port of the JAX package's ``rtfd run-job`` (``cli.py
cmd_run_job``): the seeded simulator produces transactions into an
in-memory broker (or, with ``--broker``, a running ``broker`` process;
``--count 0`` then only consumes, in checkpointed slices, until
``--duration`` or a signal), keyed by user; with ``--state host:port`` the
scorer's profiles, velocity and transaction cache live on a shared state
server (``state-server``), which replicas share; ``--state`` together with
``--checkpoint-dir`` exits 2 before the scorer is built, because that state
lives on the server (persisted by its ``--aof``) and a scorer checkpoint
cannot hold it; the port's ``StreamJob`` scores
them in microbatches through ``TorchFraudScorer`` and fans the results out
to the predictions, alerts, enriched and features topics; with
``--enrichment`` the enriched topic carries the 60/40 feature-score blend,
with ``--analytics`` the seven window operators feed the stream-processing
topics (the summary's ``analytics`` block: the windows each fired);
``--checkpoint-dir`` saves the models, the host state and the read
positions after every chunk or slice and resumes from the latest at start;
``--metadata-db`` records the job and its checkpoints in a SQLite store;
SIGTERM or SIGINT drains the batches in flight, commits, writes a final
checkpoint and ends with ``stopped_by`` in the summary; with
``--overlap-assembly`` the scorer's host assembly runs on a background
thread, overlapped with the card; with ``--device-pool`` the batches run on
the device pool (``scoring/device_pool.py``: a replica of the models on each
visible card, each with its own CUDA stream and ``--inflight-depth`` batches
in flight); with ``--qos`` the deadline-aware QoS
plane (admission at ``--qos-rate`` txn/s, the ``--qos-budget-ms`` budget and
the degradation ladder) runs in the job; with ``--trace`` the tracing plane
(the summary's ``tracing`` block: the p99 stage breakdown, the fast SLO
window, the trace counters); with ``--autotune`` the tuning plane, its
deadline bound clamped to the QoS budget under ``--qos`` (the ``autotune``
block: the controller's decisions, the tuned max-wait, the tuner's counters,
the close reasons); with ``--feedback`` the feedback plane (the command
also plays the label producer: each chunk's delayed label events, their
delays scaled by ``--feedback-delay-scale``, go onto the labels topic; the
``feedback`` block: the sliding prequential window, the labels matched, the
buffer's size and the policy's counters); ``--predictions-out`` writes every
prediction the job emitted as a JSON line. It runs on the CUDA card unless
``--device cpu`` is given, and fails without a card. The last line of
standard output is a JSON summary.

``kernel-drill`` is the port of the JAX package's ``rtfd kernel-drill``
(``scoring/kernel_drill.py``): two seeded scorers on the quantized plane,
kernels off and kernels on (``KernelSettings.full()``, or ``mega()`` with
``--mega``), held to the measured bf16 noise bound with zero decision flips
at every QoS rung, each kernel against its plain version, honest dispatch
counts and a bit-identical replay. It prints the full summary, then the
compact verdict as the last line, and exits 1 unless every check passed.
It runs on the card (``--device cpu`` runs both sides' plain versions).

``feedback-drill`` and ``quant-drill`` are the ports of the JAX package's
drills of the same names (``feedback/drill.py``, ``scoring/quant_drill.py``):
the closed continuous-learning loop on a virtual clock (drift, the
prequential dip, the retrain trigger, the gate's negative control, the
promotion, the recovery), and the f32 plane against the quantized one
(divergence under the bf16 noise bound, no decision flip, the AUC, the
GEMM-form leaves, the bytes, a replay digest). Each prints the full summary,
then the compact verdict as the last line, and exits 1 unless it passed. They
run on the card unless ``--device cpu``.

``pool-drill`` is the port of ``rtfd pool-drill`` (``scoring/pool_drill.py``):
the real pooled scoring path, ``--devices`` replicas placed round-robin over
the visible cards (several on one card, each on its own stream), or all on
the CPU with ``--device cpu`` (the JAX command re-execs onto virtual CPU
devices; this one does not); bit-equality with unpooled scoring, FIFO,
utilization, hot-swap purity and the schedule's virtual-time scaling of at
least 3x. ``shard-drill`` is the port of ``rtfd shard-drill``
(``cluster/drill.py``): a fleet of partition-scoped workers over one broker
log on a virtual clock, a worker killed mid-stream and recovered by
checkpointed handoff, held against a single-worker oracle; its scorer is a
host stand-in, so it runs on the CPU and needs no card. Each prints the full
summary, then the compact verdict as the last line, and exits 1 unless every
check passed.

``elastic-drill`` and ``partition-drill`` are the ports of the JAX
commands of the same names (``cluster/elastic_drill.py``,
``chaos/partition_drill.py``): a fleet of real worker processes
(``cluster/procfleet.py``) over the TCP netbroker and the network handoff
store, held against a single-process oracle; the elastic drill grows the
fleet ahead of a diurnal ramp, SIGKILLs the busiest worker mid-peak and
drains after the peak, the partition drill cuts, slows and heals links
(``chaos/netfaults.py``). Their workers are ``cluster-worker`` processes,
spawned by the coordinator with a JSON spec; they score with the shard
drill's host stand-in and never see the card. ``chaos-drill`` is the port
of ``rtfd chaos-drill`` (``chaos/drill.py``): one virtual-clock timeline of
a flash crowd, a broker replica outage, device-pool faults, a label stall
and a fraud ring, through the real scorer on ``--devices`` pool replicas
(on the card; the JAX command re-execs onto virtual CPU devices, this one
does not), with a bit-identical second run unless ``--no-replay``. Each
prints the full summary, then the compact verdict as the last line, and
exits 1 unless every check passed.

``mesh-drill`` is the port of ``rtfd mesh-drill`` (``scoring/mesh_drill.py``):
the real mesh-sharded scoring path (``scoring/mesh_executor.py``) on
``--devices`` positions over the visible cards, cycled (several on one card,
each on its own stream), or all on the CPU with ``--device cpu`` (the JAX
command re-execs onto virtual CPU devices; this one does not), a
``--model-axis`` split: bit-equality with a single-position scorer for six
branch placements, every QoS rung and a hot swap, the BERT bytes a position
stores, a bit-identical second pass unless ``--no-replay``. It prints the
full summary, then the compact verdict as the last line, and exits 1 unless
every check passed.

``graph-drill`` and ``obs-drill`` are the ports of the JAX commands of the
same names (``graph/drill.py``, ``obs/obs_drill.py``). The graph drill
drives typed-graph scorers (on the card unless ``--device cpu``) across
partition workers in one process, with cross-partition neighbour fetch over
TCP (``graph/fetch.py``) and a netfault window on the fetch links. The obs
drill drives ``cluster-worker`` processes with the fetch plane and the
tracing plane on; its workers score on the host and never see the card.
Each prints the full summary, then the compact verdict as the last line,
and exits 1 unless every check passed.

``qos-drill`` is the port of ``rtfd qos-drill`` (``qos/drill.py``): offered
load at ``--multiplier`` x the sustainable rate through the port's stream
path on a virtual clock, the scorer a deterministic stand-in that touches
no device. The last line is the summary as compact JSON; it exits 1 when
the admitted p99 missed the budget.

``trace-drill`` and ``autotune-drill`` are the ports of the JAX package's
drills of the same names (``obs/trace_drill.py``, ``tuning/drill.py``): the
port's stream path on a virtual clock with a deterministic stand-in scorer
that touches no device. Each prints the full summary, then the compact
verdict as the last line, and exits 1 unless every check passed.

``serve`` is the port of ``rtfd serve`` (``cli.py cmd_serve``): the
scoring HTTP service (``serving/app.py ServingApp``) on the card, or on the
CPU with ``--device cpu``; it fails without a card. It takes the JAX
command's flags (``--device-pool``: the device pool, with the two-phase
microbatcher at its capacity; a config file's ``cluster`` block turns on
the shard router, its 421 and ``/cluster``); with
``--state host:port``, or else ``RTFD_STATE_ADDR``, the scorer reads and
writes the shared state server, and standard error names it. With ``--quality-artifact`` it serves the artifact's
blend and builds the scorer at the text model, text length and tokenizer
the artifact records; ``--checkpoint-dir`` restores a port checkpoint
(``checkpoint.py``) before it listens, and a missing checkpoint or a
refused restore (a crossed quantization or graph mode, or other widths)
exits 2. The CUDA kernels are
built before the service listens. ``health-check`` probes a running
service's ``/health`` and prints the JSON verdict (exit 1 unless healthy).

``state-server`` is the port of ``rtfd state-server``: the shared state
node (``state/resp.py MiniRedisServer``, the Redis protocol; its replies and
append-only file are the JAX server's, so either package's scorers share
it), with ``--maxmemory`` / ``--policy`` eviction, ``--aof`` persistence and
``--replica-of`` replication, until SIGINT or SIGTERM. The Kafka transport
has no command-line flag, as in the JAX package: it is a library transport,
``StreamJob(broker=KafkaTransport("host:9092"))``.

``broker``, ``topics`` and ``alert-router`` are the ports of the JAX
commands: the durable TCP log broker (``stream/netbroker.py``; its frames
are the JAX broker's, so either package's client talks to either server),
the topic contract (created on a broker with ``--create``), and the alert
router (a consumer on the alerts topic that posts each batch to a webhook,
or prints JSON lines, and commits after; ``--once`` drains and exits).

``simulate``, ``train``, ``validate`` and ``quality-eval`` are the ports of
the JAX commands of the same names, with their arguments, defaults, printed
JSON and exit codes. ``simulate`` writes the seeded simulator's transactions
as JSON lines, or with ``--broker`` produces them at ~``--tps`` through the
ingress gateway (``stream/gateway.py``: the C++ queue of ``native/``, built
with g++ on first use, or a deque without g++), and says on standard error
which queue it used. ``train`` fits the GBDT (on the host) and the isolation
forest on simulated rows, with ``--neural`` also the LSTM, GNN and TINY BERT
branches (on the card unless ``--device cpu``), and saves a port checkpoint
whose manifest carries the trees' feature importances; per-branch step times
go to standard error. ``validate`` restores a checkpoint into a scorer,
scores a fresh labelled stream (its seed moved off the checkpoint's training
seed), prints the report and exits 1 below ``--min-auc``; ``--metrics-out``
writes the ``rtfd_validation_*`` Prometheus textfile. ``quality-eval`` runs
the blend-selection protocol (``training/blend_eval.py``) and prints or
writes its evidence JSON; the seconds of each stage go to standard error.

``trace-export`` runs a traced ``run-job`` stream (on the card unless
``--device cpu``) and writes the flight recorder's window as Chrome-trace /
Perfetto JSON to ``--out``; a one-line capture summary goes to stdout.
With ``--merge RING...`` it runs nothing and needs no card: it folds the
workers' ring dumps (``obs-drill --rings-out``) into one fleet trace.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional


# the port's deterministic drill commands (the JAX package's
# ``analysis/lockwatch.py LOCKWATCH_DRILLS``, and the port's quant drill)
DRILL_COMMANDS = ("qos-drill", "trace-drill", "autotune-drill", "feedback-drill",
                  "pool-drill", "chaos-drill", "shard-drill", "mesh-drill",
                  "elastic-drill", "partition-drill", "graph-drill", "kernel-drill",
                  "obs-drill", "quant-drill")


def _no_card(command: str, device: str) -> bool:
    import torch

    if device.startswith("cuda") and not torch.cuda.is_available():
        print(f"{command}: no CUDA device available (pass --device cpu to run on "
              "the CPU)", file=sys.stderr)
        return True
    return False


def _addr(spec: str, default_port: int) -> tuple[str, int]:
    host, _, port = spec.partition(":")
    return host or "127.0.0.1", int(port or default_port)


def _broker_client(spec: str, default_port: int = 9092):
    """Broker client from an address spec: a comma-separated list (the
    replicated cluster, primary first) gives an ``HaBrokerClient``, a single
    address the plain ``NetBrokerClient``."""
    from realtime_fraud_detection_tpu_torch.stream.netbroker import (
        HaBrokerClient,
        NetBrokerClient,
    )

    addrs = [_addr(a, default_port) for a in spec.split(",") if a.strip()]
    if not addrs:
        raise ValueError(f"no broker address in {spec!r}")
    if len(addrs) > 1:
        return HaBrokerClient(addrs)
    return NetBrokerClient(host=addrs[0][0], port=addrs[0][1])


def cmd_run_job(args: argparse.Namespace) -> int:
    import signal

    from realtime_fraud_detection_tpu_torch.checkpoint import (
        SHARED_TIER_REFUSAL,
        CheckpointManager,
        snapshot_scorer_host_state,
    )
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
    from realtime_fraud_detection_tpu_torch.state.metadata import MetadataStore
    from realtime_fraud_detection_tpu_torch.state.resp import RespClient
    from realtime_fraud_detection_tpu_torch.stream import topics as T
    from realtime_fraud_detection_tpu_torch.stream.job import JobConfig, StreamJob
    from realtime_fraud_detection_tpu_torch.stream.transport import InMemoryBroker
    from realtime_fraud_detection_tpu_torch.utils.config import (
        Config,
        FeedbackSettings,
        KernelSettings,
        QosSettings,
        QuantSettings,
        TracingSettings,
        TuningSettings,
    )

    if _no_card("run-job", args.device):
        return 2
    if args.state and args.checkpoint_dir:
        print(f"run-job: --state with --checkpoint-dir refused: {SHARED_TIER_REFUSAL}",
              file=sys.stderr)
        return 2
    config = Config()
    if args.quant:
        config.quant = QuantSettings.full()
    if args.mega:
        config.kernels = KernelSettings.mega()
    elif args.kernels:
        config.kernels = KernelSettings.full()
    gen = TransactionGenerator(num_users=args.users, num_merchants=args.merchants,
                               seed=args.seed, tps=args.tps)
    broker = _broker_client(args.broker) if args.broker else InMemoryBroker()
    state_client = None
    if args.state:
        state_client = RespClient(*_addr(args.state, 6379))
    scorer = TorchFraudScorer(config, seed=args.seed, device=args.device,
                              state_client=state_client)
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    qos = (QosSettings(enabled=True, budget_ms=args.qos_budget_ms,
                       admission_rate=args.qos_rate) if args.qos else None)
    tracing = TracingSettings(enabled=True) if args.trace else None
    tuning = None
    if args.autotune:
        tuning = TuningSettings(enabled=True)
        # the QoS floor: with --qos the tuner's deadline search space is
        # clamped to the budget's assembly slice, then validated
        tuning.clamp_to_qos(qos)
    feedback = None
    if args.feedback:
        from realtime_fraud_detection_tpu_torch.feedback import FeedbackPlane
        from realtime_fraud_detection_tpu_torch.obs.drift import (
            DriftConfig,
            FeatureDriftMonitor,
        )

        feedback = FeedbackPlane(
            FeedbackSettings(enabled=True,
                             label_delay_scale=args.feedback_delay_scale),
            scorer=scorer, config=scorer.config,
            drift_monitor=FeatureDriftMonitor(
                DriftConfig(num_features=scorer.sc.feature_dim)))
    job = StreamJob(broker, scorer, JobConfig(
        max_batch=args.batch, pipeline_depth=args.pipeline_depth,
        enable_analytics=args.analytics, enable_enrichment=args.enrichment,
        overlap_assembly=args.overlap_assembly, device_pool=args.device_pool,
        inflight_depth=args.inflight_depth, qos=qos, tracing=tracing,
        autotune=tuning, feedback=feedback))

    metadata = ckpt = None
    job_id = f"job-{args.seed}"
    if args.metadata_db:
        metadata = MetadataStore(args.metadata_db)
        metadata.register_job(job_id, "fraud-detection-job", parallelism=1)
        metadata.put_profiles(gen.users.profiles(), gen.merchants.profiles())
    if args.checkpoint_dir:
        ckpt = CheckpointManager(args.checkpoint_dir)

    def checkpoint(step: int) -> None:
        if ckpt is None:
            return
        t_ck = time.perf_counter()
        path = ckpt.save(step, params=scorer.models,
                         host_state=snapshot_scorer_host_state(scorer),
                         offsets=job.consumer.positions())
        if metadata is not None:
            metadata.record_checkpoint(
                job_id, step, str(path),
                duration_ms=(time.perf_counter() - t_ck) * 1e3)

    # SIGTERM / SIGINT drain: the run loops stop polling, complete and
    # commit every batch in flight, and a final checkpoint pins (state,
    # offsets) at the drained point, so a restart replays nothing (only
    # SIGKILL replays the uncommitted tail)
    stop = {"name": None}

    def graceful(signum, frame):
        stop["name"] = signal.Signals(signum).name
        job.request_stop()

    try:
        signal.signal(signal.SIGTERM, graceful)
        signal.signal(signal.SIGINT, graceful)
    except ValueError:
        pass                      # not the main thread (embedded use)

    t0 = time.perf_counter()
    produced = scored = step = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        # resume models, host state and transport positions from the latest
        # checkpoint; step numbering continues so retention never collides
        ck = ckpt.restore_into_scorer(scorer)
        if ck.offsets:
            job.consumer.seek_to_positions(ck.offsets)
        step = ck.step
        print(f"resumed from checkpoint step {ck.step} ({args.checkpoint_dir})",
              file=sys.stderr, flush=True)
    try:
        if args.count == 0:
            # consume only: an external producer feeds the broker; run in
            # checkpointed slices of at most 10 s until --duration (0 =
            # until stopped)
            while (args.duration <= 0
                   or time.perf_counter() - t0 < args.duration) \
                    and not job.stop_requested:
                scored += job.run_for(
                    min(10.0, args.duration - (time.perf_counter() - t0))
                    if args.duration > 0 else 10.0)
                step += 1
                checkpoint(step)
        while produced < args.count and not job.stop_requested:
            chunk = min(args.count - produced, 10_000)
            records = gen.generate_batch(chunk)
            broker.produce_batch(T.TRANSACTIONS, records,
                                 key_fn=lambda r: str(r["user_id"]))
            if feedback is not None:
                # the label producer: the chunk's delayed ground truth
                broker.produce_batch(
                    T.LABELS, gen.label_events(
                        records, delay_scale=args.feedback_delay_scale),
                    key_fn=lambda e: str(e["transaction_id"]))
            produced += chunk
            scored += job.run_until_drained()
            step += 1
            checkpoint(step)
    except BaseException:
        if metadata is not None:
            metadata.set_job_status(job_id, "FAILED")
            metadata.close()
        raise
    finally:
        job.close()
    if job.analytics is not None:
        job.analytics.flush()
    if stop["name"] is not None:
        # the run loops drained and committed before returning
        step += 1
        checkpoint(step)
        print(f"graceful shutdown on {stop['name']}: in-flight drained, offsets "
              f"committed" + (f", final checkpoint step {step}" if ckpt is not None
                              else ""), file=sys.stderr, flush=True)
    dt = time.perf_counter() - t0
    if metadata is not None:
        metadata.set_job_status(job_id, "FINISHED")
        metadata.close()
    if args.predictions_out:
        with open(args.predictions_out, "w") as f:
            for rec in broker.consumer([T.PREDICTIONS], "predictions-out").poll(1 << 30):
                f.write(json.dumps(rec.value) + "\n")
    stages = {name: round(st["mean_ms"], 4)
              for name, st in scorer.host_stats()["stages"].items()}
    summary = {
        "scored": scored, "wall_s": round(dt, 3),
        "txn_per_s": round(scored / dt, 1) if dt > 0 else 0.0,
        "counters": job.counters,
        "lag": broker.lag(job.config.group_id, T.TRANSACTIONS),
        "host_stage_mean_ms": stages,
        "kernels": scorer.kernel_snapshot(),
        "qos": job.qos.snapshot() if job.qos is not None else None,
        "tracing": _tracing_block(job),
        "autotune": _autotune_block(job),
        "feedback": _feedback_block(feedback),
        "analytics": ({k: v["fired"] for k, v in job.analytics.stats().items()}
                      if job.analytics is not None else None),
    }
    if stop["name"] is not None:
        summary["stopped_by"] = stop["name"]
    if args.broker:
        broker.close()
    if state_client is not None:
        state_client.close()
    print(json.dumps(summary), flush=True)
    return 0 if job.counters["errors"] == 0 else 1


def _feedback_block(plane) -> Optional[dict]:
    """The ``feedback`` block of the JAX ``rtfd run-job`` summary."""
    if plane is None:
        return None
    snap = plane.snapshot()
    return {"prequential_sliding": snap["prequential"]["sliding"],
            "labels_matched": snap["label_join"]["matched"],
            "buffer": snap["buffer"]["size"],
            "policy": snap["policy"]}


def _tracing_block(job) -> Optional[dict]:
    """The ``tracing`` block of the JAX ``rtfd run-job`` summary."""
    if job.tracer is None:
        return None
    bd = job.tracer.breakdown()
    return {"traces": bd["n"], "p99": bd["quantiles"].get("p99"),
            "slo_fast": job.tracer.slo.snapshot()["windows"]["fast"],
            "counters": dict(job.tracer.counters)}


def _autotune_block(job) -> Optional[dict]:
    """The ``autotune`` block of the JAX ``rtfd run-job`` summary."""
    if job.tuning is None:
        return None
    snap = job.tuning.snapshot()
    return {"decisions": snap["controller"]["decisions"],
            "max_wait_ms": snap["controller"]["max_wait_ms"],
            "tuner": snap["tuner"]["counters"],
            "close_reasons": dict(job.assembler.close_reasons)}


def cmd_kernel_drill(args: argparse.Namespace) -> int:
    import dataclasses

    from realtime_fraud_detection_tpu_torch.scoring.kernel_drill import (
        KernelDrillConfig,
        compact_kernel_summary,
        run_kernel_drill,
    )

    if _no_card("kernel-drill", args.device):
        return 2
    cfg = KernelDrillConfig.fast() if args.fast else KernelDrillConfig()
    cfg = dataclasses.replace(cfg, seed=args.seed, mega=args.mega, device=args.device)
    summary = run_kernel_drill(cfg)
    print(json.dumps(summary, default=str))
    print(json.dumps(compact_kernel_summary(summary), default=str))
    return 0 if summary["passed"] else 1


def cmd_pool_drill(args: argparse.Namespace) -> int:
    import dataclasses

    from realtime_fraud_detection_tpu_torch.scoring.pool_drill import (
        PoolDrillConfig,
        compact_pool_summary,
        run_pool_drill,
    )

    if _no_card("pool-drill", args.device):
        return 2
    cfg = PoolDrillConfig.fast() if args.fast else PoolDrillConfig()
    cfg = dataclasses.replace(cfg, n_devices=args.devices,
                              inflight_depth=args.inflight_depth, seed=args.seed)
    summary = run_pool_drill(cfg, device=args.device)
    print(json.dumps(summary), flush=True)
    print(json.dumps(compact_pool_summary(summary), separators=(",", ":")), flush=True)
    return 0 if summary["passed"] else 1


def cmd_mesh_drill(args: argparse.Namespace) -> int:
    import dataclasses

    from realtime_fraud_detection_tpu_torch.scoring.mesh_drill import (
        MeshDrillConfig,
        compact_mesh_summary,
        run_mesh_drill,
    )

    if _no_card("mesh-drill", args.device):
        return 2
    # before the first product on the card: the mesh's scores equal one
    # position's with cuBLAS's split-K off
    from realtime_fraud_detection_tpu_torch.core.precision import batch_invariant_blas

    batch_invariant_blas()
    cfg = MeshDrillConfig.fast() if args.fast else MeshDrillConfig()
    cfg = dataclasses.replace(
        cfg, n_devices=args.devices, model_axis=args.model_axis,
        inflight_depth=args.inflight_depth, seed=args.seed,
        replay_check=not args.no_replay, device=args.device)
    summary = run_mesh_drill(cfg)
    print(json.dumps(summary), flush=True)
    print(json.dumps(compact_mesh_summary(summary), separators=(",", ":")), flush=True)
    return 0 if summary["passed"] else 1


def cmd_shard_drill(args: argparse.Namespace) -> int:
    import dataclasses

    from realtime_fraud_detection_tpu_torch.cluster.drill import (
        ShardDrillConfig,
        compact_shard_summary,
        run_shard_drill,
    )

    cfg = ShardDrillConfig.fast() if args.fast else ShardDrillConfig()
    cfg = dataclasses.replace(cfg, seed=args.seed, replay_check=not args.no_replay,
                              **({"n_workers": args.workers} if args.workers else {}))
    summary = run_shard_drill(cfg)
    print(json.dumps(summary), flush=True)
    print(json.dumps(compact_shard_summary(summary), separators=(",", ":")), flush=True)
    return 0 if summary["passed"] else 1


def cmd_elastic_drill(args: argparse.Namespace) -> int:
    import dataclasses

    from realtime_fraud_detection_tpu_torch.cluster.elastic_drill import (
        ElasticDrillConfig,
        compact_elastic_summary,
        run_elastic_drill,
    )

    cfg = ElasticDrillConfig.fast() if args.fast else ElasticDrillConfig()
    cfg = dataclasses.replace(cfg, seed=args.seed, replay_check=not args.no_replay)
    summary = run_elastic_drill(cfg)
    print(json.dumps(summary), flush=True)
    print(json.dumps(compact_elastic_summary(summary), separators=(",", ":")),
          flush=True)
    return 0 if summary["passed"] else 1


def cmd_partition_drill(args: argparse.Namespace) -> int:
    import dataclasses

    from realtime_fraud_detection_tpu_torch.chaos.partition_drill import (
        PartitionDrillConfig,
        compact_partition_summary,
        run_partition_drill,
    )

    cfg = PartitionDrillConfig.fast() if args.fast else PartitionDrillConfig()
    cfg = dataclasses.replace(cfg, seed=args.seed, replay_check=not args.no_replay,
                              **({"n_workers": args.workers} if args.workers else {}))
    summary = run_partition_drill(cfg)
    print(json.dumps(summary), flush=True)
    print(json.dumps(compact_partition_summary(summary), separators=(",", ":")),
          flush=True)
    return 0 if summary["passed"] else 1


def cmd_chaos_drill(args: argparse.Namespace) -> int:
    import dataclasses

    from realtime_fraud_detection_tpu_torch.chaos.drill import (
        ChaosDrillConfig,
        apply_chaos_settings,
        compact_chaos_summary,
        run_chaos_drill,
    )

    if _no_card("chaos-drill", args.device):
        return 2
    cfg = ChaosDrillConfig.fast() if args.fast else ChaosDrillConfig()
    if args.config:
        from realtime_fraud_detection_tpu_torch.utils.config import Config

        cfg = apply_chaos_settings(cfg, Config.from_file(args.config).chaos)
    cfg = dataclasses.replace(cfg, replay_check=not args.no_replay, device=args.device,
                              **({"seed": args.seed} if args.seed is not None else {}),
                              **({"n_devices": args.devices} if args.devices else {}))
    summary = run_chaos_drill(cfg)
    summary.pop("ledger", None)
    print(json.dumps(summary), flush=True)
    print(json.dumps(compact_chaos_summary(summary), separators=(",", ":")), flush=True)
    return 0 if summary["passed"] else 1


def cmd_graph_drill(args: argparse.Namespace) -> int:
    """The entity-graph drill (``graph/drill.py``): typed-graph scorers on
    the card (or the CPU) across 2+ partition workers with cross-partition
    fetch over TCP, a netfault window, the ring-phase AUC lift over the
    trees alone, columnar == serial and a bit-identical replay. Full
    summary, then the compact verdict last; exit 1 unless every check
    passed."""
    import dataclasses

    from realtime_fraud_detection_tpu_torch.graph.drill import (
        GraphDrillConfig,
        compact_graph_summary,
        run_graph_drill,
    )

    if _no_card("graph-drill", args.device):
        return 2
    cfg = GraphDrillConfig.fast() if args.fast else GraphDrillConfig()
    cfg = dataclasses.replace(cfg, seed=args.seed, replay_check=not args.no_replay,
                              device=args.device,
                              **({"n_workers": args.workers} if args.workers else {}))
    summary = run_graph_drill(cfg)
    print(json.dumps(summary), flush=True)
    print(json.dumps(compact_graph_summary(summary), separators=(",", ":")),
          flush=True)
    return 0 if summary["passed"] else 1


def cmd_obs_drill(args: argparse.Namespace) -> int:
    """The distributed observability drill (``obs/obs_drill.py``): 2+
    ``cluster-worker`` processes on the host with trace carriers, fleet
    metrics pinned exact, the slow worker's p99 attribution, carrier loss
    counted under a netfault window, and the merged Chrome trace. Its
    workers never see the card; like every entry point it asks for one
    unless ``--device cpu``. Full summary, then the compact verdict last;
    exit 1 unless every check passed."""
    import dataclasses

    from realtime_fraud_detection_tpu_torch.obs.obs_drill import (
        ObsDrillConfig,
        compact_obs_summary,
        run_obs_drill,
    )

    if _no_card("obs-drill", args.device):
        return 2
    cfg = ObsDrillConfig.fast() if args.fast else ObsDrillConfig()
    cfg = dataclasses.replace(cfg, seed=args.seed, replay_check=not args.no_replay,
                              rings_out=args.rings_out,
                              **({"n_workers": args.workers} if args.workers else {}))
    summary = run_obs_drill(cfg)
    print(json.dumps(summary), flush=True)
    print(json.dumps(compact_obs_summary(summary), separators=(",", ":")),
          flush=True)
    return 0 if summary["passed"] else 1


def cmd_cluster_worker(args: argparse.Namespace) -> int:
    """One partition-scoped fleet worker process, spawned by the process
    fleet's coordinator (``cluster/procfleet.py ProcessFleet``) with a JSON
    spec; it scores on the host and never touches the card."""
    from realtime_fraud_detection_tpu_torch.cluster.procfleet import worker_main

    return worker_main(json.loads(args.spec))


def cmd_feedback_drill(args: argparse.Namespace) -> int:
    import dataclasses

    from realtime_fraud_detection_tpu_torch.feedback.drill import (
        FeedbackDrillConfig,
        compact_drill_summary,
        run_feedback_drill,
    )

    if _no_card("feedback-drill", args.device):
        return 2
    cfg = FeedbackDrillConfig.fast() if args.fast else FeedbackDrillConfig()
    cfg = dataclasses.replace(cfg, seed=args.seed, drift_rate=args.drift_rate,
                              device=args.device)
    summary = run_feedback_drill(cfg)
    print(json.dumps(summary), flush=True)
    print(json.dumps(compact_drill_summary(summary), separators=(",", ":")),
          flush=True)
    return 0 if summary["passed"] else 1


def cmd_quant_drill(args: argparse.Namespace) -> int:
    import dataclasses

    from realtime_fraud_detection_tpu_torch.scoring.quant_drill import (
        QuantDrillConfig,
        compact_quant_summary,
        run_quant_drill,
    )

    if _no_card("quant-drill", args.device):
        return 2
    cfg = QuantDrillConfig.fast() if args.fast else QuantDrillConfig()
    cfg = dataclasses.replace(cfg, seed=args.seed, replay=not args.no_replay,
                              device=args.device)
    summary = run_quant_drill(cfg)
    print(json.dumps(summary), flush=True)
    print(json.dumps(compact_quant_summary(summary), separators=(",", ":")),
          flush=True)
    return 0 if summary["passed"] else 1


def cmd_qos_drill(args: argparse.Namespace) -> int:
    from realtime_fraud_detection_tpu_torch.qos.drill import run_overload_drill

    summary = run_overload_drill(
        offered_multiplier=args.multiplier,
        overload_s=args.overload_s,
        recovery_s=args.recovery_s,
        max_batch=args.batch,
        budget_ms=args.budget_ms,
        high_frac=args.high_frac,
        low_frac=args.low_frac,
        seed=args.seed,
    )
    print(json.dumps(summary))
    return 0 if summary["p99_within_budget"] else 1


def cmd_trace_drill(args: argparse.Namespace) -> int:
    import dataclasses

    from realtime_fraud_detection_tpu_torch.obs.trace_drill import (
        TraceDrillConfig,
        compact_trace_summary,
        run_trace_drill,
    )

    cfg = TraceDrillConfig.fast() if args.fast else TraceDrillConfig()
    summary = run_trace_drill(dataclasses.replace(cfg, seed=args.seed))
    print(json.dumps(summary), flush=True)
    print(json.dumps(compact_trace_summary(summary), separators=(",", ":")),
          flush=True)
    return 0 if summary["passed"] else 1


def cmd_autotune_drill(args: argparse.Namespace) -> int:
    import dataclasses

    from realtime_fraud_detection_tpu_torch.tuning.drill import (
        AutotuneDrillConfig,
        compact_autotune_summary,
        run_autotune_drill,
    )

    cfg = AutotuneDrillConfig.fast() if args.fast else AutotuneDrillConfig()
    summary = run_autotune_drill(dataclasses.replace(cfg, seed=args.seed))
    print(json.dumps(summary), flush=True)
    print(json.dumps(compact_autotune_summary(summary), separators=(",", ":")),
          flush=True)
    return 0 if summary["passed"] else 1


def cmd_trace_export(args: argparse.Namespace) -> int:
    """Run a traced stream and write the flight recorder as a Chrome trace.
    With ``--merge RING...`` no stream runs: the per-worker ring dumps
    (``{worker, pid, traces}``, as ``obs-drill --rings-out`` writes them)
    fold into one fleet trace, a named track a process and the broker hop
    as a flow arrow; nothing touches a device, so no card is asked for."""
    if args.merge:
        from realtime_fraud_detection_tpu_torch.obs.fleetmetrics import (
            merge_chrome_traces,
        )

        dumps = []
        for path in args.merge:
            with open(path) as f:
                dumps.append(json.load(f))
        payload = merge_chrome_traces(dumps)
        with open(args.out, "w") as f:
            json.dump(payload, f)
        print(json.dumps({"merged_rings": len(dumps),
                          "traces": payload["metadata"]["n_traces"],
                          "tracks": payload["metadata"]["tracks"],
                          "events": len(payload["traceEvents"]),
                          "out": args.out}))
        return 0
    from realtime_fraud_detection_tpu_torch.obs.tracing import Tracer
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
    from realtime_fraud_detection_tpu_torch.stream import topics as T
    from realtime_fraud_detection_tpu_torch.stream.job import JobConfig, StreamJob
    from realtime_fraud_detection_tpu_torch.stream.transport import InMemoryBroker
    from realtime_fraud_detection_tpu_torch.utils.config import TracingSettings

    if _no_card("trace-export", args.device):
        return 2
    gen = TransactionGenerator(num_users=args.users, num_merchants=args.merchants,
                               seed=args.seed, tps=args.tps)
    scorer = TorchFraudScorer(seed=args.seed, device=args.device)
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    tracer = Tracer(TracingSettings(enabled=True, ring_size=max(64, args.count)))
    broker = InMemoryBroker()
    job = StreamJob(broker, scorer, JobConfig(max_batch=args.batch, tracing=tracer,
                                              emit_features=False))
    produced = 0
    while produced < args.count:
        chunk = min(args.count - produced, 10_000)
        broker.produce_batch(T.TRANSACTIONS, gen.generate_batch(chunk),
                             key_fn=lambda r: str(r["user_id"]))
        produced += chunk
        job.run_until_drained()
    payload = tracer.export_chrome_trace()
    with open(args.out, "w") as f:
        json.dump(payload, f)
    bd = tracer.breakdown()
    print(json.dumps({"traces": bd["n"], "events": len(payload["traceEvents"]),
                      "p99": bd["quantiles"].get("p99"), "out": args.out}))
    return 0


def cmd_serve(args: argparse.Namespace) -> int:
    from realtime_fraud_detection_tpu_torch.checkpoint import CheckpointManager
    from realtime_fraud_detection_tpu_torch.models.bert import BertConfig
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import ScorerConfig
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.serving.app import ServingApp
    from realtime_fraud_detection_tpu_torch.utils.config import (
        Config,
        KernelSettings,
        QuantSettings,
    )

    if _no_card("serve", args.device):
        return 2
    config = Config.from_file(args.config) if args.config else Config()
    if args.host:
        config.serving.host = args.host
    if args.port is not None:
        config.serving.port = args.port
    if args.qos:
        config.qos.enabled = True
    if args.qos_budget_ms:
        config.qos.budget_ms = args.qos_budget_ms
    if args.qos_rate:
        config.qos.admission_rate = args.qos_rate
    if args.trace:
        config.tracing.enabled = True
    if args.quant:
        config.quant = QuantSettings.full()
    if args.mega:
        config.kernels = KernelSettings.mega()
    elif args.kernels:
        config.kernels = KernelSettings.full()
    if args.autotune:
        config.tuning.enabled = True
        # the tuner's deadline search space clamped to the budget's
        # assembly slice, then validated
        config.tuning.clamp_to_qos(config.qos)
    if args.overlap_assembly:
        config.serving.overlap_assembly = True
    if args.device_pool:
        config.serving.device_pool = True
    if args.inflight_depth:
        config.serving.inflight_depth = args.inflight_depth
    if config.mesh.enabled:
        # before the first product on the card: the mesh's scores equal one
        # position's with cuBLAS's split-K off
        from realtime_fraud_detection_tpu_torch.core.precision import batch_invariant_blas

        batch_invariant_blas()
    scorer_kwargs = {}
    if args.quality_artifact:
        applied = config.apply_quality_artifact(args.quality_artifact)
        print(f"serving the measured blend from {args.quality_artifact}: "
              f"{applied}", file=sys.stderr)
        # the text model, text length and tokenizer the blend was measured
        # with: the scorer is built to match, or a restore would mismatch
        with open(args.quality_artifact) as f:
            proto = json.load(f).get("protocol", {})
        if proto.get("text_model"):
            scorer_kwargs["bert_config"] = BertConfig(**proto["text_model"])
            scorer_kwargs["scorer_config"] = ScorerConfig(
                text_len=int(proto.get("text_len", 32)),
                tokenizer=proto.get("tokenizer", "word"))
    state_addr = args.state or os.environ.get("RTFD_STATE_ADDR", "")
    if state_addr:
        from realtime_fraud_detection_tpu_torch.state.resp import RespClient

        scorer_kwargs["state_client"] = RespClient(*_addr(state_addr, 6379))
        print(f"using shared state tier at {state_addr}", file=sys.stderr)
    scorer = TorchFraudScorer(config, device=args.device, **scorer_kwargs)
    app = ServingApp(config=config, scorer=scorer)
    if args.checkpoint_dir:
        mgr = CheckpointManager(args.checkpoint_dir)
        try:
            if args.quality_artifact:
                # an artifact and a checkpoint recording different text
                # encoders are refused; --allow-arch-mismatch overrides
                art_tm = Config.load_artifact_text_model(args.quality_artifact)
                ck_tm = (mgr.manifest().get("metadata") or {}).get("text_model")
                if (art_tm is not None and ck_tm is not None
                        and dict(art_tm) != dict(ck_tm) and not args.allow_arch_mismatch):
                    print(f"text-encoder architecture mismatch: artifact "
                          f"{args.quality_artifact} records {art_tm}, checkpoint "
                          f"{args.checkpoint_dir} records {ck_tm}; pass "
                          f"--allow-arch-mismatch to combine anyway", file=sys.stderr)
                    return 2
            ck = mgr.restore_into_scorer(app.scorer,
                                         allow_arch_mismatch=args.allow_arch_mismatch)
        except (FileNotFoundError, ValueError) as e:
            # no checkpoint there, or its stamps refuse this server's config
            print(str(e), file=sys.stderr)
            return 2
        print(f"restored checkpoint step {ck.step} from {args.checkpoint_dir}",
              file=sys.stderr)
    print(f"serving on {config.serving.host}:{config.serving.port} "
          f"({scorer.device})", file=sys.stderr)
    app.run_forever()
    return 0


def _sim_generator(args: argparse.Namespace, seed: int):
    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator

    return TransactionGenerator(num_users=args.users, num_merchants=args.merchants,
                                seed=seed, tps=args.tps)


def cmd_simulate(args: argparse.Namespace) -> int:
    """Generate transactions as JSON lines (event time is synthesised), or
    with ``--broker`` produce them into a broker at ~``--tps`` through the
    ingress gateway (its C++ queue and sender thread overlap the network
    produce with generation)."""
    gen = _sim_generator(args, args.seed)
    if args.broker:
        from realtime_fraud_detection_tpu_torch.stream import topics as T
        from realtime_fraud_detection_tpu_torch.stream.gateway import IngressGateway

        client = _broker_client(args.broker)
        gateway = IngressGateway(client, T.TRANSACTIONS)
        n_fraud = produced = 0
        try:
            while produced < args.count:
                chunk = min(1000, args.count - produced, max(1, int(args.tps)))
                t0 = time.perf_counter()
                for txn in gen.generate_batch(chunk):
                    n_fraud += bool(txn.get("is_fraud"))
                    while not gateway.submit(txn):     # backpressure: spin
                        time.sleep(0.001)
                produced += chunk
                budget = chunk / args.tps - (time.perf_counter() - t0)
                if budget > 0:
                    time.sleep(budget)
        finally:
            gateway.close()
            client.close()
        print(f"produced {produced} txns ({n_fraud} fraud, "
              f"native_queue={gateway.native}, dropped={gateway.dropped}) "
              f"to {args.broker}", file=sys.stderr)
        return 0 if gateway.dropped == 0 else 1
    out = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        n_fraud = 0
        remaining = args.count
        while remaining > 0:
            for txn in gen.generate_batch(min(1000, remaining)):
                n_fraud += bool(txn.get("is_fraud"))
                out.write(json.dumps(txn) + "\n")
            remaining -= min(1000, remaining)
    finally:
        if out is not sys.stdout:
            out.close()
    print(f"generated {args.count} txns ({n_fraud} fraud)", file=sys.stderr)
    return 0


def _wait_forever() -> None:  # pragma: no cover - blocks until a signal
    import threading

    threading.Event().wait()


def cmd_broker(args: argparse.Namespace) -> int:
    """Run the standalone durable log broker (``stream/netbroker.py``), the
    Kafka-role process of a multi-process deployment, until SIGINT /
    SIGTERM."""
    import signal

    from realtime_fraud_detection_tpu_torch.stream.netbroker import BrokerServer

    server = BrokerServer(host=args.host, port=args.port,
                          log_dir=args.log_dir or None, role=args.role,
                          min_isr=args.min_isr).start()
    for addr in args.replica:
        rhost, _, rport = addr.rpartition(":")
        # a cluster starting in parallel may bring the primary up first:
        # retry the attachment until the replica answers
        for attempt in range(60):
            try:
                server.add_replica(rhost or "127.0.0.1", int(rport))
                break
            except OSError as e:
                if attempt == 59:
                    raise
                print(f"replica {addr} not reachable yet ({e}); retrying",
                      file=sys.stderr)
                time.sleep(2.0)
        print(f"replica {addr} caught up and in sync", file=sys.stderr)
    print(f"broker listening on {args.host}:{server.port}"
          + (f" (log_dir={args.log_dir})" if args.log_dir else "")
          + f" role={server.role} min_isr={server.min_isr}",
          file=sys.stderr, flush=True)

    def stop(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, stop)
    try:
        _wait_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


def cmd_state_server(args: argparse.Namespace) -> int:
    """Run the shared state node (``state/resp.py MiniRedisServer``, the
    Redis protocol), the RedisService-role process N scorer replicas share,
    until SIGINT / SIGTERM."""
    import signal

    from realtime_fraud_detection_tpu_torch.state.resp import MiniRedisServer

    replica_of = None
    if args.replica_of:
        host, _, port = args.replica_of.rpartition(":")
        replica_of = (host, int(port))
    server = MiniRedisServer(
        host=args.host, port=args.port, maxmemory=args.maxmemory,
        policy=args.policy, aof_path=args.aof or None,
        replica_of=replica_of).start()
    role = "replica" if server.is_replica else "master"
    print(f"state server (RESP, {role}) listening on {args.host}:{server.port}",
          file=sys.stderr, flush=True)

    def stop(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, stop)
    try:
        _wait_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


def cmd_topics(args: argparse.Namespace) -> int:
    """Print the topic contract; with ``--broker --create``, create it on a
    running broker."""
    from realtime_fraud_detection_tpu_torch.stream.topics import TOPIC_SPECS

    broker = None
    if args.create:
        if not args.broker:
            print("--create requires --broker host:port", file=sys.stderr)
            return 2
        from realtime_fraud_detection_tpu_torch.stream.netbroker import NetBrokerClient

        host, _, port = args.broker.rpartition(":")
        broker = NetBrokerClient(host=host or "127.0.0.1", port=int(port))
    try:
        for t in TOPIC_SPECS:
            flag = " compacted" if t.compacted else ""
            if broker is not None:
                broker.create_topic(t.name, t.partitions)
                print(f"created {t.name:28s} partitions={t.partitions}{flag}")
            else:
                print(f"{t.name:28s} partitions={t.partitions}{flag}")
    finally:
        if broker is not None:
            broker.close()
    return 0


def cmd_alert_router(args: argparse.Namespace) -> int:
    """Fan fraud alerts out to notification receivers: a consumer on the
    alerts topic that POSTs each polled batch to an Alertmanager-compatible
    webhook, or prints JSON lines without one. Offsets commit only after the
    receiver took the batch (at-least-once; receivers dedupe on the
    transaction id). ``--once`` drains the topic and exits; otherwise it
    follows the topic until interrupted."""
    import urllib.request

    from realtime_fraud_detection_tpu_torch.stream import topics as T

    broker = _broker_client(args.broker)
    consumer = broker.consumer([T.ALERTS], args.group)
    routed = 0
    backoff = 1.0
    try:
        while True:
            recs = consumer.poll(500)
            if not recs:
                if args.once:
                    break
                time.sleep(args.poll_interval)
                continue
            payload = []
            for r in recs:
                a = r.value if isinstance(r.value, dict) else {}
                payload.append({
                    "labels": {
                        "alertname": str(a.get("alert_type", "FRAUD_DETECTED")),
                        "severity": ("critical" if str(a.get("decision")) == "DECLINE"
                                     else "warning"),
                        "risk_level": str(a.get("risk_level", "UNKNOWN")),
                        "merchant_id": str(a.get("merchant_id", "")),
                        "service": "rtfd",
                    },
                    "annotations": {
                        "transaction_id": str(a.get("transaction_id", "")),
                        "user_id": str(a.get("user_id", "")),
                        "amount": str(a.get("amount", "")),
                        "fraud_score": str(a.get("fraud_score", "")),
                    },
                })
            if args.webhook:
                req = urllib.request.Request(
                    args.webhook, data=json.dumps(payload).encode(),
                    headers={"Content-Type": "application/json"}, method="POST")
                try:
                    with urllib.request.urlopen(req, timeout=10) as resp:
                        resp.read()
                except OSError as e:
                    # a receiver blip must not crash-loop the router: rewind
                    # to the committed offsets (the batch is delivered again)
                    # and back off; --once fails loudly instead
                    if args.once:
                        raise
                    print(f"webhook unreachable ({e}); retrying in {backoff:.0f}s",
                          file=sys.stderr)
                    time.sleep(backoff)
                    backoff = min(backoff * 2, 60.0)
                    consumer.seek_to_committed()
                    continue
            else:
                for item in payload:
                    print(json.dumps(item), flush=True)
            backoff = 1.0
            consumer.commit()
            routed += len(payload)
    except KeyboardInterrupt:  # pragma: no cover - operator stop
        pass
    finally:
        broker.close()
    print(f"routed {routed} alerts", file=sys.stderr)
    return 0


def _auc(y, score) -> float:
    """Mann-Whitney AUC with tie-averaged ranks; 0.5 when a class is
    missing (the JAX commands' convention)."""
    import math

    from realtime_fraud_detection_tpu_torch.training.blend_eval import _auc as auc

    value = auc(y, score)
    return 0.5 if math.isnan(value) else value


def cmd_train(args: argparse.Namespace) -> int:
    """Train the tree models (and with ``--neural`` the neural branches) on
    simulated data and save a full ``ScoringModels`` checkpoint that
    ``serve --checkpoint-dir`` and ``/reload-models`` load directly."""
    import dataclasses

    import numpy as np
    import torch

    from realtime_fraud_detection_tpu_torch.checkpoint import CheckpointManager
    from realtime_fraud_detection_tpu_torch.features.extract import (
        extract_features_host,
        top_feature_importances,
    )
    from realtime_fraud_detection_tpu_torch.models.isolation_forest import (
        IsolationForestTrainer,
    )
    from realtime_fraud_detection_tpu_torch.models.trees import tree_ensemble_logits
    from realtime_fraud_detection_tpu_torch.scoring.pipeline import init_scoring_models
    from realtime_fraud_detection_tpu_torch.training import GBDTTrainer

    if _no_card("train", args.device):
        return 2
    gen = _sim_generator(args, args.seed)
    batch, labels = gen.generate_encoded(args.rows)
    x = extract_features_host(batch)
    y = labels["is_fraud"].astype(np.float32)
    split = int(0.8 * len(y))

    timing = {}
    t0 = time.perf_counter()
    gbdt_trainer = GBDTTrainer(n_estimators=args.trees, seed=args.seed)
    trees = gbdt_trainer.fit(x[:split], y[:split])
    timing["gbdt_host_s"] = time.perf_counter() - t0
    logits = tree_ensemble_logits(trees, torch.from_numpy(x[split:])).numpy()
    auc = _auc(y[split:], logits)

    t0 = time.perf_counter()
    iforest = IsolationForestTrainer(seed=args.seed).fit(
        x[:split][y[:split] == 0])          # fit on normals only
    timing["iforest_host_s"] = time.perf_counter() - t0

    models = dataclasses.replace(init_scoring_models(args.seed),
                                 trees=trees, iforest=iforest)
    if args.neural:
        from realtime_fraud_detection_tpu_torch.models.bert import TINY_CONFIG
        from realtime_fraud_detection_tpu_torch.training.neural import (
            train_gnn,
            train_lstm,
        )
        from realtime_fraud_detection_tpu_torch.training.text import train_bert

        n = args.rows
        for name in ("lstm", "gnn", "bert"):
            timing[name] = {}
        lstm = train_lstm(gen, n_transactions=n, hidden=128, epochs=2,
                          seed=args.seed, device=args.device, stats=timing["lstm"])
        gnn, _, _, _ = train_gnn(gen, n_transactions=n, node_dim=16, hidden=64,
                                 epochs=2, seed=args.seed, device=args.device,
                                 stats=timing["gnn"])
        bert = train_bert(gen, config=TINY_CONFIG, n_transactions=min(n, 8000),
                          epochs=1, seed=args.seed, device=args.device,
                          stats=timing["bert"])
        models = dataclasses.replace(models, lstm=lstm, gnn=gnn, bert=bert)

    mgr = CheckpointManager(args.out)
    # a fresh step per run (never overwrite in place); the recorded
    # sim_seed lets validate refuse a contaminated eval stream
    latest = mgr.latest_step()
    step = 0 if latest is None else latest + 1
    path = mgr.save(step, params=models,
                    metadata={"rows": args.rows, "auc": auc,
                              "fraud_rate": float(y.mean()),
                              "sim_seed": args.seed,
                              "sim_users": args.users,
                              "sim_merchants": args.merchants,
                              # restored by restore_into_scorer so served
                              # explanations keep their importances
                              "feature_importances":
                                  [round(float(v), 6) for v in
                                   gbdt_trainer.feature_importances_]})
    print(f"train timing: {json.dumps(timing)}", file=sys.stderr)
    print(json.dumps({"auc": round(auc, 4),
                      "fraud_rate": round(float(y.mean()), 4),
                      "neural_trained": bool(args.neural),
                      "top_feature_importances": top_feature_importances(
                          gbdt_trainer.feature_importances_),
                      "checkpoint": str(path)}))
    return 0


def cmd_validate(args: argparse.Namespace) -> int:
    """Validate a trained checkpoint against a fresh labelled stream:
    restore it into a scorer, score a simulated stream with known fraud,
    report AUC / accuracy / precision / recall, optionally write a
    Prometheus textfile, and exit 1 below ``--min-auc``."""
    import numpy as np

    from realtime_fraud_detection_tpu_torch.checkpoint import CheckpointManager
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer

    if _no_card("validate", args.device):
        return 2
    scorer = TorchFraudScorer(device=args.device)
    ckpt = CheckpointManager(args.checkpoint_dir).restore_into_scorer(
        scorer, step=args.step)
    # a held-out eval stream: never the checkpoint's recorded training seed
    train_seed = (ckpt.metadata or {}).get("sim_seed")
    val_seed = args.seed + 1
    if train_seed is not None and val_seed == int(train_seed):
        val_seed += 1
    gen = _sim_generator(args, val_seed)
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())

    ys, ss = [], []
    remaining = args.rows
    while remaining > 0:
        recs = gen.generate_batch(min(256, remaining))
        remaining -= len(recs)
        res = scorer.score_batch(recs)
        ys += [bool(r.get("is_fraud")) for r in recs]
        ss += [r["fraud_probability"] for r in res]
    y = np.asarray(ys, float)
    s = np.asarray(ss, float)
    pos = y > 0.5
    flag = s >= 0.5
    auc = _auc(y, s)
    tp = float((flag & pos).sum())
    report = {
        "n": int(len(y)),
        "fraud_rate": round(float(pos.mean()), 4),
        "auc": round(auc, 4),
        "accuracy": round(float((flag == pos).mean()), 4),
        "precision": round(tp / max(float(flag.sum()), 1.0), 4),
        "recall": round(tp / max(float(pos.sum()), 1.0), 4),
        "min_auc": args.min_auc,
        "passed": bool(auc >= args.min_auc),
        "eval_seed": val_seed,
        "checkpoint_step": int(ckpt.step),
    }
    if args.metrics_out:
        # a Prometheus textfile (node-exporter textfile-collector format)
        from realtime_fraud_detection_tpu_torch.obs.metrics import Registry

        reg = Registry()
        for k, v in report.items():
            if isinstance(v, bool):
                v = int(v)
            elif not isinstance(v, (int, float)):
                continue
            reg.gauge(f"rtfd_validation_{k}",
                      f"model validation gate: {k}").set(float(v))
        with open(args.metrics_out, "w") as f:
            f.write(reg.render())
    print(json.dumps(report))
    return 0 if report["passed"] else 1


def cmd_quality_eval(args: argparse.Namespace) -> int:
    """Run the blend-selection protocol (``training/blend_eval.py``): train
    all five branches on a stream-matched segment, admit branches into the
    blend by validation A/B, report held-out quality and ablations."""
    import dataclasses

    from realtime_fraud_detection_tpu_torch.training.blend_eval import (
        BlendEvalConfig,
        run_blend_eval,
    )

    if _no_card("quality-eval", args.device):
        return 2

    def log(m: str) -> None:
        print(f"[quality-eval] {m}", file=sys.stderr, flush=True)

    # an argument left out takes BlendEvalConfig's default, so the command and
    # the Python entry make identical admission decisions
    cfg = dataclasses.replace(BlendEvalConfig(), seed=args.seed, **{
        k: getattr(args, k) for k in ("train_batches", "val_batches", "test_batches")
        if getattr(args, k) is not None})
    stages = {}
    result = run_blend_eval(cfg, log=log, checkpoint_dir=args.checkpoint_dir or None,
                            device=args.device, stage_seconds=stages)
    log(f"seconds: {json.dumps(stages)}")
    payload = json.dumps(result, indent=2)
    if args.output:
        with open(args.output, "w") as f:
            f.write(payload + "\n")
        print(f"wrote {args.output}", file=sys.stderr)
    else:
        print(payload)
    return 0


def cmd_health_check(args: argparse.Namespace) -> int:
    import urllib.error
    import urllib.request

    url = args.url.rstrip("/") + "/health"
    try:
        with urllib.request.urlopen(url, timeout=args.timeout) as resp:
            body = json.loads(resp.read())
    except (urllib.error.URLError, OSError, json.JSONDecodeError) as e:
        print(json.dumps({"healthy": False, "error": str(e)}))
        return 1
    healthy = body.get("status") == "healthy"
    print(json.dumps({"healthy": healthy, **body}))
    return 0 if healthy else 1


def _add_sim_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--users", type=int, default=10_000, help="user pool size")
    p.add_argument("--merchants", type=int, default=5_000, help="merchant pool size")
    p.add_argument("--tps", type=float, default=1000.0,
                   help="simulated event-time rate")
    p.add_argument("--seed", type=int, default=42)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="realtime_fraud_detection_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("run-job", help="run the streaming scoring job "
                                        "(simulator -> in-memory broker -> "
                                        "scorer -> output topics)")
    sp.add_argument("--users", type=int, default=10_000, help="user pool size")
    sp.add_argument("--merchants", type=int, default=5_000,
                    help="merchant pool size")
    sp.add_argument("--tps", type=float, default=1000.0,
                    help="simulated event-time rate")
    sp.add_argument("--seed", type=int, default=42)
    sp.add_argument("--count", type=int, default=10_000,
                    help="transactions to generate and score; 0 = consume "
                         "only, from --broker")
    sp.add_argument("--duration", type=float, default=0.0,
                    help="consume-only runtime seconds (0 = until stopped)")
    sp.add_argument("--broker", default="",
                    help="external broker host:port, or a comma list for the "
                         "replicated cluster (default: in-memory)")
    sp.add_argument("--state", default="",
                    help="shared state server host:port (RESP)")
    sp.add_argument("--batch", type=int, default=256, help="microbatch size")
    sp.add_argument("--pipeline-depth", type=int, default=2,
                    help="microbatches in flight")
    sp.add_argument("--quant", action="store_true",
                    help="int8 BERT + GEMM-form trees (QuantSettings.full())")
    sp.add_argument("--kernels", action="store_true",
                    help="the per-site CUDA kernels (KernelSettings.full())")
    sp.add_argument("--mega", action="store_true",
                    help="the megakernel, with the per-site kernels as its "
                         "fallback (KernelSettings.mega())")
    sp.add_argument("--overlap-assembly", action="store_true",
                    help="assemble + dispatch on a background thread while "
                         "the card runs the previous batch "
                         "(JobConfig.overlap_assembly)")
    sp.add_argument("--device-pool", action="store_true",
                    help="replicate the models onto every visible card and "
                         "dispatch microbatches round-robin across per-replica "
                         "in-flight queues (scoring/device_pool.py)")
    sp.add_argument("--inflight-depth", type=int, default=2,
                    help="per-replica in-flight batches for --device-pool")
    sp.add_argument("--qos", action="store_true",
                    help="enable the deadline-aware QoS plane (admission + "
                         "degradation ladder + latency budgets)")
    sp.add_argument("--qos-budget-ms", type=float, default=20.0,
                    help="per-transaction latency budget")
    sp.add_argument("--qos-rate", type=float, default=0.0,
                    help="admission token rate in txn/s (0 = unlimited)")
    sp.add_argument("--trace", action="store_true",
                    help="enable the tracing plane (per-transaction stage "
                         "spans, the SLO burn rate and its QoS gate)")
    sp.add_argument("--autotune", action="store_true",
                    help="enable the tuning plane (the just-in-time batch "
                         "closer and the online tuner)")
    sp.add_argument("--feedback", action="store_true",
                    help="enable the feedback plane: delayed labels -> "
                         "prequential metrics -> drift-gated retrain and "
                         "promotion (feedback/)")
    sp.add_argument("--feedback-delay-scale", type=float, default=1e-4,
                    help="compresses the chargeback label-delay distribution "
                         "(1.0 = realistic days)")
    sp.add_argument("--analytics", action="store_true",
                    help="attach the windowed-analytics stage")
    sp.add_argument("--enrichment", action="store_true",
                    help="blend the six-category feature score into the "
                         "enriched output (FeatureEnrichmentProcessor)")
    sp.add_argument("--checkpoint-dir", default="",
                    help="checkpoint models, host state and offsets here after "
                         "each chunk or slice; resume from the latest at start")
    sp.add_argument("--metadata-db", default="",
                    help="SQLite path for the durable job / checkpoint records")
    sp.add_argument("--predictions-out", default="",
                    help="write the emitted predictions here, one JSON line each")
    sp.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    sp.set_defaults(fn=cmd_run_job)
    kd = sub.add_parser("kernel-drill", help="parity drill of the kernel plane: "
                                             "kernels on vs off under the bf16 "
                                             "noise bound")
    kd.add_argument("--fast", action="store_true",
                    help="tier-1 sizes (KernelDrillConfig.fast())")
    kd.add_argument("--mega", action="store_true",
                    help="the kernel side serves the megakernel (KernelSettings.mega())")
    kd.add_argument("--seed", type=int, default=13)
    kd.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain versions)")
    kd.set_defaults(fn=cmd_kernel_drill)
    pd = sub.add_parser("pool-drill",
                        help="deterministic device-pool drill: the real pooled "
                             "scoring path, bit-equality, FIFO, hot swap, "
                             "virtual-time scaling")
    pd.add_argument("--fast", action="store_true",
                    help="the test sizes (PoolDrillConfig.fast())")
    pd.add_argument("--devices", type=int, default=8,
                    help="replicas, placed round-robin over the visible cards")
    pd.add_argument("--inflight-depth", type=int, default=2,
                    help="per-replica in-flight batches")
    pd.add_argument("--seed", type=int, default=7)
    pd.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: where the replicas run")
    pd.set_defaults(fn=cmd_pool_drill)
    md = sub.add_parser("mesh-drill",
                        help="deterministic mesh-sharding drill: the real data x "
                             "model serving path, bit-equality per branch "
                             "placement, every QoS rung, hot swap, the BERT "
                             "bytes a position stores")
    md.add_argument("--fast", action="store_true",
                    help="the test sizes (MeshDrillConfig.fast())")
    md.add_argument("--devices", type=int, default=8,
                    help="mesh positions, placed round-robin over the visible cards")
    md.add_argument("--model-axis", type=int, default=2,
                    help="model-parallel axis size per mesh replica")
    md.add_argument("--inflight-depth", type=int, default=2,
                    help="in-flight batches per mesh replica")
    md.add_argument("--seed", type=int, default=7)
    md.add_argument("--no-replay", action="store_true",
                    help="skip the second bit-identical pass")
    md.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: where the positions are")
    md.set_defaults(fn=cmd_mesh_drill)
    sd = sub.add_parser("shard-drill",
                        help="deterministic partition-parallel worker drill: "
                             "key-sharded state across >= 4 workers, a "
                             "mid-stream worker kill, checkpointed handoff, "
                             "oracle state equality")
    sd.add_argument("--fast", action="store_true",
                    help="the test sizes (ShardDrillConfig.fast())")
    sd.add_argument("--workers", type=int, default=0,
                    help="fleet size (0 = the config default, 4)")
    sd.add_argument("--seed", type=int, default=7)
    sd.add_argument("--no-replay", action="store_true",
                    help="skip the second bit-identical replay run")
    sd.set_defaults(fn=cmd_shard_drill)
    ed = sub.add_parser("elastic-drill",
                        help="elastic-cluster drill: real OS worker processes "
                             "over the TCP netbroker, network handoff, "
                             "autoscale ahead of a diurnal peak, a real "
                             "SIGKILL mid-peak, oracle state equality")
    ed.add_argument("--fast", action="store_true",
                    help="the test sizes (ElasticDrillConfig.fast())")
    ed.add_argument("--seed", type=int, default=7)
    ed.add_argument("--no-replay", action="store_true",
                    help="skip the second fresh determinism run")
    ed.set_defaults(fn=cmd_elastic_drill)
    pt = sub.add_parser("partition-drill",
                        help="split-brain partition drill: real OS worker "
                             "processes under link faults (asymmetric, slow, "
                             "full partitions), generation fencing, session "
                             "eviction and rejoin, oracle state equality")
    pt.add_argument("--fast", action="store_true",
                    help="the test sizes (PartitionDrillConfig.fast())")
    pt.add_argument("--workers", type=int, default=0,
                    help="fleet size (0 = the config default)")
    pt.add_argument("--seed", type=int, default=7)
    pt.add_argument("--no-replay", action="store_true",
                    help="skip the second fresh determinism run")
    pt.set_defaults(fn=cmd_partition_drill)
    cd = sub.add_parser("chaos-drill",
                        help="combined recovery drill: flash crowd, broker "
                             "outage, device faults and a fraud ring on one "
                             "virtual-clock timeline")
    cd.add_argument("--fast", action="store_true",
                    help="the test sizes (ChaosDrillConfig.fast())")
    cd.add_argument("--devices", type=int, default=0,
                    help="pool replicas (0 = the config's default: 4 full, "
                         "2 fast)")
    cd.add_argument("--seed", type=int, default=None,
                    help="timeline seed (default: chaos.seed from --config "
                         "if given, else 11)")
    cd.add_argument("--config", default="",
                    help="JSON config file; its chaos block reshapes the "
                         "fault timeline")
    cd.add_argument("--no-replay", action="store_true",
                    help="skip the second bit-identical replay run")
    cd.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: where the pool replicas run")
    cd.set_defaults(fn=cmd_chaos_drill)
    gd = sub.add_parser("graph-drill",
                        help="entity-graph drill: typed graph and two-hop "
                             "sampling feeding the GNN across 2+ partition "
                             "workers, cross-partition fetch over TCP, a "
                             "netfault degrade window, the ring-phase AUC "
                             "lift over the trees alone")
    gd.add_argument("--fast", action="store_true",
                    help="the test sizes (GraphDrillConfig.fast())")
    gd.add_argument("--workers", type=int, default=0,
                    help="fleet size (0 = the config default)")
    gd.add_argument("--seed", type=int, default=7)
    gd.add_argument("--no-replay", action="store_true",
                    help="skip the second fresh determinism run")
    gd.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: where the scorers and the GNN "
                         "trainer run")
    gd.set_defaults(fn=cmd_graph_drill)
    od = sub.add_parser("obs-drill",
                        help="distributed observability drill: 2+ worker "
                             "processes with cross-process trace carriers, "
                             "fleet metrics pinned exact, slow-worker p99 "
                             "attribution, carrier loss under a netfault "
                             "window, the merged Chrome trace")
    od.add_argument("--fast", action="store_true",
                    help="the test sizes (ObsDrillConfig.fast())")
    od.add_argument("--workers", type=int, default=0,
                    help="fleet size (0 = the config default)")
    od.add_argument("--seed", type=int, default=7)
    od.add_argument("--rings-out", default="",
                    help="directory for the workers' flight-recorder ring dumps "
                         "(the `trace-export --merge` input)")
    od.add_argument("--no-replay", action="store_true",
                    help="skip the second fresh determinism run")
    od.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; the drill's workers score on "
                         "the host either way")
    od.set_defaults(fn=cmd_obs_drill)
    cw = sub.add_parser("cluster-worker",
                        help="one partition-scoped fleet worker process "
                             "(spawned by the process fleet's coordinator)")
    cw.add_argument("--spec", required=True,
                    help="JSON worker spec from the coordinator (broker and "
                         "handoff addresses, worker id, group, partitions, "
                         "batch and cost knobs)")
    cw.set_defaults(fn=cmd_cluster_worker)
    fd = sub.add_parser("feedback-drill",
                        help="deterministic closed-loop continuous-learning "
                             "drill (virtual clock, real retraining)")
    fd.add_argument("--fast", action="store_true",
                    help="the CPU test sizes (FeedbackDrillConfig.fast())")
    fd.add_argument("--seed", type=int, default=5)
    fd.add_argument("--drift-rate", type=float, default=0.08,
                    help="share of the stream turned into the drifted fraud "
                         "pattern")
    fd.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    fd.set_defaults(fn=cmd_feedback_drill)
    qz = sub.add_parser("quant-drill",
                        help="deterministic quantization drill: int8 BERT + "
                             "GEMM-form trees against the f32 plane under the "
                             "bf16 noise bound, no decision flip, the AUC, "
                             "a bit-identical replay")
    qz.add_argument("--fast", action="store_true",
                    help="the CPU test sizes (QuantDrillConfig.fast())")
    qz.add_argument("--seed", type=int, default=11)
    qz.add_argument("--no-replay", action="store_true",
                    help="skip the second run (the replay gate is waived)")
    qz.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    qz.set_defaults(fn=cmd_quant_drill)
    qd = sub.add_parser("qos-drill",
                        help="deterministic QoS overload drill (virtual clock, "
                             "the port's stream path; the scorer is a "
                             "stand-in that touches no device)")
    qd.add_argument("--multiplier", type=float, default=2.0,
                    help="offered load as a multiple of the sustainable rate")
    qd.add_argument("--overload-s", type=float, default=1.5,
                    help="virtual seconds of overload")
    qd.add_argument("--recovery-s", type=float, default=1.5,
                    help="virtual seconds of post-overload trickle")
    qd.add_argument("--batch", type=int, default=64)
    qd.add_argument("--budget-ms", type=float, default=20.0)
    qd.add_argument("--high-frac", type=float, default=0.2,
                    help="fraction of traffic in the high (never-shed) class")
    qd.add_argument("--low-frac", type=float, default=0.5,
                    help="fraction of traffic in the low (sheds-first) class")
    qd.add_argument("--seed", type=int, default=7)
    qd.set_defaults(fn=cmd_qos_drill)
    td = sub.add_parser("trace-drill",
                        help="deterministic tracing drill (virtual clock, the "
                             "port's stream path, a stand-in scorer): stage "
                             "attribution, the SLO burn and its gate, traced "
                             "vs untraced equality, the plane's overhead")
    td.add_argument("--fast", action="store_true",
                    help="tier-1 sizes (TraceDrillConfig.fast())")
    td.add_argument("--seed", type=int, default=7)
    td.set_defaults(fn=cmd_trace_drill)
    ad = sub.add_parser("autotune-drill",
                        help="deterministic self-tuning drill (virtual clock, a "
                             "diurnal + burst timeline): the just-in-time "
                             "closer against a grid of fixed deadlines")
    ad.add_argument("--fast", action="store_true",
                    help="tier-1 sizes (AutotuneDrillConfig.fast())")
    ad.add_argument("--seed", type=int, default=7)
    ad.set_defaults(fn=cmd_autotune_drill)
    te = sub.add_parser("trace-export",
                        help="run a traced stream and export the flight "
                             "recorder as Chrome-trace / Perfetto JSON")
    te.add_argument("--users", type=int, default=10_000)
    te.add_argument("--merchants", type=int, default=5_000)
    te.add_argument("--tps", type=float, default=1000.0)
    te.add_argument("--seed", type=int, default=42)
    te.add_argument("--count", type=int, default=2048,
                    help="transactions to score through the traced job")
    te.add_argument("--batch", type=int, default=128)
    te.add_argument("--out", default="trace.json",
                    help="Chrome-trace JSON output path (open in ui.perfetto.dev)")
    te.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain versions)")
    te.add_argument("--merge", nargs="+", default=None, metavar="RING",
                    help="merge per-worker ring dumps ({worker, pid, traces} "
                         "JSON, e.g. from `obs-drill --rings-out`) into one "
                         "fleet trace instead of running a stream")
    te.set_defaults(fn=cmd_trace_export)
    sv = sub.add_parser("serve", help="run the scoring HTTP service")
    sv.add_argument("--host", default="")
    sv.add_argument("--port", type=int, default=None)
    sv.add_argument("--state", default="",
                    help="shared state server host:port (RESP); also honours "
                         "RTFD_STATE_ADDR")
    sv.add_argument("--config", default="", help="JSON config file")
    sv.add_argument("--checkpoint-dir", default="",
                    help="restore a port checkpoint's params (and host state) "
                         "at startup")
    sv.add_argument("--quality-artifact", default="",
                    help="deploy the measured blend of a quality-eval JSON "
                         "(e.g. QUALITY_r05.json), at the text model it records")
    sv.add_argument("--qos", action="store_true",
                    help="enable the deadline-aware QoS plane (also at run "
                         "time through POST /qos)")
    sv.add_argument("--qos-budget-ms", type=float, default=0.0,
                    help="per-transaction latency budget (0 = default)")
    sv.add_argument("--qos-rate", type=float, default=0.0,
                    help="admission token rate in txn/s (0 = unlimited)")
    sv.add_argument("--overlap-assembly", action="store_true",
                    help="two-phase microbatcher: dispatch batch N+1 while "
                         "batch N waits on the card (serving.overlap_assembly)")
    sv.add_argument("--device-pool", action="store_true",
                    help="the device pool (serving.device_pool; implies the "
                         "two-phase microbatcher)")
    sv.add_argument("--inflight-depth", type=int, default=None,
                    help="per-replica in-flight batches for --device-pool "
                         "(default: serving.inflight_depth, 2)")
    sv.add_argument("--allow-arch-mismatch", action="store_true",
                    help="combine a checkpoint and a quality artifact whose "
                         "text encoders differ, and restore a checkpoint whose "
                         "quantization or graph mode crosses this server's")
    sv.add_argument("--quant", action="store_true",
                    help="int8 BERT + GEMM-form trees (QuantSettings.full())")
    sv.add_argument("--kernels", action="store_true",
                    help="the per-site CUDA kernels (KernelSettings.full())")
    sv.add_argument("--mega", action="store_true",
                    help="the megakernel, with the per-site kernels as its "
                         "fallback (KernelSettings.mega())")
    sv.add_argument("--trace", action="store_true",
                    help="enable the tracing plane: GET /latency/breakdown, "
                         "GET /slo, trace_* series")
    sv.add_argument("--autotune", action="store_true",
                    help="enable the tuning plane: the microbatcher closes "
                         "just in time against the arrival forecast; GET "
                         "/autotune, autotune_* series")
    sv.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    sv.set_defaults(fn=cmd_serve)
    hc = sub.add_parser("health-check", help="probe a running service's /health")
    hc.add_argument("--url", default="http://127.0.0.1:8080")
    hc.add_argument("--timeout", type=float, default=5.0)
    hc.set_defaults(fn=cmd_health_check)
    sm = sub.add_parser("simulate", help="generate transaction JSON lines")
    _add_sim_args(sm)
    sm.add_argument("--count", type=int, default=1000)
    sm.add_argument("--output", default="-")
    sm.add_argument("--broker", default="",
                    help="produce to a broker (host:port, or a comma list) at "
                         "~tps through the ingress gateway instead of writing "
                         "JSON lines")
    sm.set_defaults(fn=cmd_simulate)
    bk = sub.add_parser("broker", help="run the durable log broker (TCP)")
    bk.add_argument("--host", default="0.0.0.0")
    bk.add_argument("--port", type=int, default=9092)
    bk.add_argument("--log-dir", default="",
                    help="write-ahead segment directory (empty = in memory only)")
    bk.add_argument("--role", choices=("primary", "replica"), default="primary",
                    help="replica = read-only standby until promoted")
    bk.add_argument("--min-isr", type=int, default=1,
                    help="in-sync copies (self included) a produce must reach "
                         "before its ack")
    bk.add_argument("--replica", action="append", default=[], metavar="HOST:PORT",
                    help="attach a running replica server (repeatable)")
    bk.set_defaults(fn=cmd_broker)
    ss = sub.add_parser("state-server",
                        help="run the shared state server (Redis protocol)")
    ss.add_argument("--host", default="0.0.0.0")
    ss.add_argument("--port", type=int, default=6379)
    ss.add_argument("--maxmemory", type=int, default=1 << 30,
                    help="eviction threshold in bytes (0 = unlimited; default "
                         "1 GiB like the reference redis-master.conf)")
    ss.add_argument("--policy", default="allkeys-lru",
                    choices=["allkeys-lru", "noeviction"])
    ss.add_argument("--aof", default="",
                    help="append-only persistence file (empty = volatile)")
    ss.add_argument("--replica-of", default="",
                    help="host:port of the primary to replicate from "
                         "(read-only replica; promote by restarting without)")
    ss.set_defaults(fn=cmd_state_server)
    tp = sub.add_parser("topics", help="print the topic contract")
    tp.add_argument("--broker", default="",
                    help="broker host:port to create the topics on")
    tp.add_argument("--create", action="store_true",
                    help="create the contract's topics on --broker")
    tp.set_defaults(fn=cmd_topics)
    ar = sub.add_parser("alert-router",
                        help="fan fraud alerts out to notification receivers")
    ar.add_argument("--broker", default="127.0.0.1:9092",
                    help="broker host:port to consume fraud-alerts from")
    ar.add_argument("--webhook", default="",
                    help="Alertmanager /api/v2/alerts URL (empty = JSON lines "
                         "on stdout)")
    ar.add_argument("--group", default="alert-router",
                    help="consumer group (offset checkpointing)")
    ar.add_argument("--once", action="store_true",
                    help="drain the topic and exit")
    ar.add_argument("--poll-interval", type=float, default=1.0)
    ar.set_defaults(fn=cmd_alert_router)
    tr = sub.add_parser("train", help="train tree models on synthetic data")
    _add_sim_args(tr)
    tr.add_argument("--rows", type=int, default=10_000,
                    help="synthetic rows (model_trainer.py:123)")
    tr.add_argument("--trees", type=int, default=100)
    tr.add_argument("--neural", action="store_true",
                    help="also train the LSTM/GNN/BERT branches")
    tr.add_argument("--out", default="./checkpoints")
    tr.add_argument("--device", default="cuda",
                    help="torch device of the neural trainers (default cuda)")
    tr.set_defaults(fn=cmd_train)
    va = sub.add_parser("validate", help="quality-gate a checkpoint on a fresh stream")
    _add_sim_args(va)
    va.add_argument("--checkpoint-dir", required=True)
    va.add_argument("--step", type=int, default=None)
    va.add_argument("--rows", type=int, default=4096)
    va.add_argument("--min-auc", type=float, default=0.80)
    va.add_argument("--metrics-out", default=None,
                    help="write a Prometheus textfile here")
    va.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain versions)")
    va.set_defaults(fn=cmd_validate)
    qe = sub.add_parser("quality-eval", help="run the blend-selection quality protocol")
    qe.add_argument("--output", default="",
                    help="write the evidence JSON here (default stdout)")
    qe.add_argument("--seed", type=int, default=3)
    # the batch counts default to BlendEvalConfig's (read when the command
    # runs: building the parser imports no torch)
    qe.add_argument("--train-batches", type=int, default=None)
    qe.add_argument("--val-batches", type=int, default=None)
    qe.add_argument("--test-batches", type=int, default=None)
    qe.add_argument("--checkpoint-dir", default="",
                    help="also save the trained+calibrated branches as a "
                         "serving checkpoint (deploy with serve "
                         "--checkpoint-dir + --quality-artifact)")
    qe.add_argument("--device", default="cuda",
                    help="torch device of the neural trainers (default cuda)")
    qe.set_defaults(fn=cmd_quality_eval)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


def configure_process_logging() -> None:
    """The process's logging from the config's environment layer
    (``LOG_LEVEL``, ``LOG_FILE``: with a file, JSON lines stamped with the
    service name and the tracer's log context). Library callers and tests
    keep their own configuration; a bad level falls back to the default."""
    import logging

    from realtime_fraud_detection_tpu_torch.obs.logs import setup_logging
    from realtime_fraud_detection_tpu_torch.utils.config import Config

    try:
        cfg = Config()
        setup_logging(level=cfg.monitoring.log_level,
                      json_file=cfg.monitoring.log_file or None,
                      service_name=cfg.service_name)
    except ValueError as e:
        logging.basicConfig(level=logging.INFO)
        logging.getLogger(__name__).warning("logging setup failed (%s)", e)


if __name__ == "__main__":
    configure_process_logging()
    sys.exit(main())
