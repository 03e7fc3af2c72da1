"""Command-line entry point of the port.

    python -m realtime_fraud_detection_tpu_torch run-job --count 10000 --mega [--overlap-assembly]
    python -m realtime_fraud_detection_tpu_torch kernel-drill --fast [--mega]

``run-job`` is the in-memory path of the JAX package's ``rtfd run-job``
(``cli.py cmd_run_job``): the seeded simulator produces transactions into
an in-memory broker, keyed by user; the port's ``StreamJob`` scores them
in microbatches through ``TorchFraudScorer`` and fans the results out to
the predictions, alerts, enriched and features topics; with
``--overlap-assembly`` the scorer's host assembly runs on a background
thread, overlapped with the card. It runs on the CUDA card unless
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
    job = StreamJob(broker, scorer, JobConfig(
        max_batch=args.batch, pipeline_depth=args.pipeline_depth,
        overlap_assembly=args.overlap_assembly))

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
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
