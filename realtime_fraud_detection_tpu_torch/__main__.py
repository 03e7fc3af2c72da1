"""Command-line entry point of the port.

    python -m realtime_fraud_detection_tpu_torch run-job --count 10000 --mega [--overlap-assembly] [--qos]
    python -m realtime_fraud_detection_tpu_torch kernel-drill --fast [--mega]
    python -m realtime_fraud_detection_tpu_torch qos-drill

``run-job`` is the in-memory path of the JAX package's ``rtfd run-job``
(``cli.py cmd_run_job``): the seeded simulator produces transactions into
an in-memory broker, keyed by user; the port's ``StreamJob`` scores them
in microbatches through ``TorchFraudScorer`` and fans the results out to
the predictions, alerts, enriched and features topics; with
``--overlap-assembly`` the scorer's host assembly runs on a background
thread, overlapped with the card; with ``--qos`` the deadline-aware QoS
plane (admission at ``--qos-rate`` txn/s, the ``--qos-budget-ms`` budget and
the degradation ladder) runs in the job. It runs on the CUDA card unless
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

``qos-drill`` is the port of ``rtfd qos-drill`` (``qos/drill.py``): offered
load at ``--multiplier`` x the sustainable rate through the port's stream
path on a virtual clock, the scorer a deterministic stand-in that touches
no device. The last line is the summary as compact JSON; it exits 1 when
the admitted p99 missed the budget.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional


def _no_card(command: str, device: str) -> bool:
    import torch

    if device.startswith("cuda") and not torch.cuda.is_available():
        print(f"{command}: no CUDA device available (pass --device cpu to run on "
              "the CPU)", file=sys.stderr)
        return True
    return False


def cmd_run_job(args: argparse.Namespace) -> int:
    from realtime_fraud_detection_tpu_torch.scoring.scorer import TorchFraudScorer
    from realtime_fraud_detection_tpu_torch.sim.simulator import TransactionGenerator
    from realtime_fraud_detection_tpu_torch.stream import topics as T
    from realtime_fraud_detection_tpu_torch.stream.job import JobConfig, StreamJob
    from realtime_fraud_detection_tpu_torch.stream.transport import InMemoryBroker
    from realtime_fraud_detection_tpu_torch.utils.config import (
        Config,
        KernelSettings,
        QosSettings,
        QuantSettings,
    )

    if _no_card("run-job", args.device):
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
    broker = InMemoryBroker()
    scorer = TorchFraudScorer(config, seed=args.seed, device=args.device)
    scorer.seed_profiles(gen.users.profiles(), gen.merchants.profiles())
    qos = (QosSettings(enabled=True, budget_ms=args.qos_budget_ms,
                       admission_rate=args.qos_rate) if args.qos else None)
    job = StreamJob(broker, scorer, JobConfig(
        max_batch=args.batch, pipeline_depth=args.pipeline_depth,
        overlap_assembly=args.overlap_assembly, qos=qos))

    t0 = time.perf_counter()
    produced = scored = 0
    try:
        while produced < args.count:
            chunk = min(args.count - produced, 10_000)
            broker.produce_batch(T.TRANSACTIONS, gen.generate_batch(chunk),
                                 key_fn=lambda r: str(r["user_id"]))
            produced += chunk
            scored += job.run_until_drained()
    finally:
        job.close()
    dt = time.perf_counter() - t0
    stages = {name: round(st["mean_ms"], 4)
              for name, st in scorer.host_stats()["stages"].items()}
    print(json.dumps({
        "scored": scored, "wall_s": round(dt, 3),
        "txn_per_s": round(scored / dt, 1) if dt > 0 else 0.0,
        "counters": job.counters,
        "lag": broker.lag(job.config.group_id, T.TRANSACTIONS),
        "host_stage_mean_ms": stages,
        "kernels": scorer.kernel_snapshot(),
        "qos": job.qos.snapshot() if job.qos is not None else None,
    }))
    return 0 if job.counters["errors"] == 0 else 1


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
                    help="transactions to generate and score")
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
    sp.add_argument("--qos", action="store_true",
                    help="enable the deadline-aware QoS plane (admission + "
                         "degradation ladder + latency budgets)")
    sp.add_argument("--qos-budget-ms", type=float, default=20.0,
                    help="per-transaction latency budget")
    sp.add_argument("--qos-rate", type=float, default=0.0,
                    help="admission token rate in txn/s (0 = unlimited)")
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
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
