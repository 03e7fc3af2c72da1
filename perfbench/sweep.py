"""The rate sweep that fixes an open-loop cell's offered rate.

    python3 -m perfbench.sweep --workload <cell> --seed <n> --seconds <s> --rates R1,R2,...

Each rate is one run of the cell as the benchmark makes it, in a process of
its own, with the cell's arrivals replaced by Poisson arrivals at that
rate and the warm-up of an open-loop mix (every bucket the deadline
closes); any cell of ``BENCHMARK.json`` gives its configuration and job.
It prints one line a rate: the p50 and p99 latency from due time to
decision, the transactions still in the topic when the window closed and
those decided after it. The highest rate whose latency stays at its floor
and whose backlog does not grow is the sustained rate; a cell offers about
four fifths of it, written into its workload file as a number. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

OPEN_LOOP = {"warmup": {"buckets": [1, 8, 32, 128, 256], "batches_per_bucket": 2}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="perfbench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", default=None)
    p.add_argument("--rate", type=float, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rate is not None:
        from perfbench.harness import run

        return run(args.workload, args.seed, args.seconds, False, T_START,
                   overrides={"cell": {**OPEN_LOOP, "arrivals": {
                       "kind": "poisson", "rate_per_s": args.rate}}})
    for rate in args.rates.split(","):
        proc = subprocess.run(
            [sys.executable, "-m", "perfbench.sweep", "--workload", args.workload,
             "--seed", str(args.seed), "--seconds", str(args.seconds), "--rate", rate],
            capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        stats = [ln for ln in proc.stderr.splitlines() if ln.startswith("perfbench stats ")]
        if proc.returncode or not lines or not stats:
            print(json.dumps({"rate": float(rate), "rc": proc.returncode,
                              "stderr": proc.stderr[-1500:]}), flush=True)
            continue
        s = json.loads(stats[-1][len("perfbench stats "):])
        print(json.dumps({"rate": float(rate), "p50_ms": s["txn_p50_ms"],
                          "p99_ms": s["txn_p99_ms"],
                          "backlog_at_close": s["backlog_left"],
                          "decided_after_window": s["decided_after_window"],
                          "batches": s["batches"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
