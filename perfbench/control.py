"""The control and the faults, on the chip at a cell's own size.

    python3 -m perfbench.control --workload <cell> --seed <n> --seconds <s> [--fault NAME]

One run of the cell as the benchmark makes it, with the check computed
twice: for the program, and for the reference at the next precision below
each one the configuration states (``reference/models.py CONTROL``) put in
the program's place. Its standard error ends with the program's numbers
(``check <name>: ...``) and the stats line carries the control's
(``"control"``). ``--fault`` plants one of ``perfbench/faults.py``'s
faults under the program instead. The benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="perfbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    from perfbench.harness import run

    return run(args.workload, args.seed, args.seconds, False, T_START,
               fault=args.fault, control=args.fault is None)


if __name__ == "__main__":
    sys.exit(main())
