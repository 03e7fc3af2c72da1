"""Reading the profiler's trace of a run's steady slice.

The traced run profiles the last ``profile.slice_s`` seconds of its window
with ``torch.profiler`` (as ``obs/profiling.py device_trace`` does),
exports the Chrome trace into the checkout and reads it back here:

- device busy time: the union of every kernel, copy and set on the card;
- the slice's length: from its first to its last recorded event;
- device time and launch count per kernel name;
- idle gaps of the card, each named by what the host was doing at its
  middle (the job step's ``record_function`` region and the innermost host
  operation), gaps under ``SHORT_GAP_US`` pooled under one name.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Tuple

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}
SHORT_GAP_US = 50.0


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def read_trace(path: Path) -> Dict[str, Any]:
    events = json.loads(Path(path).read_text()).get("traceEvents", [])
    dev: List[Tuple[float, float]] = []
    per_kernel: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    host: List[Tuple[float, float, str, str]] = []
    t_lo, t_hi = float("inf"), float("-inf")
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        ts, dur = float(ev["ts"]), float(ev["dur"])
        t_lo, t_hi = min(t_lo, ts), max(t_hi, ts + dur)
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            if cat == "kernel":
                k = per_kernel[ev.get("name", "?")]
                k[0] += dur
                k[1] += 1
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, cat, ev.get("name", "?")))
    busy = _merge(dev)
    busy_us = sum(e - s for s, e in busy)
    window_us = (t_hi - t_lo) if dev else 0.0
    gaps: Dict[str, float] = defaultdict(float)
    steps = sorted(h for h in host if h[2] == "user_annotation"
                   and h[3].startswith("job."))
    ops = sorted(h for h in host if not (h[2] == "user_annotation"
                                         and h[3].startswith("job.")))
    step_starts, op_starts = [h[0] for h in steps], [h[0] for h in ops]
    edges = [(t_lo, t_lo)] + busy + [(t_hi, t_hi)]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        gap = b - a
        if gap <= 0:
            continue
        if gap < SHORT_GAP_US:
            gaps[f"short gaps (< {SHORT_GAP_US:g} us)"] += gap
            continue
        mid = (a + b) / 2.0
        parts = [p for p in (_covering(steps, step_starts, mid, 8),
                             _covering(ops, op_starts, mid, 400)) if p]
        gaps[" > ".join(parts) if parts else "host idle"] += gap
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": window_us * 1e-6,
        "kernels": {name: {"seconds": v[0] * 1e-6, "launches": int(v[1])}
                    for name, v in per_kernel.items()},
        "gaps": {name: us * 1e-6 for name, us in gaps.items()},
    }


def _covering(events, starts, t: float, lookback: int):
    """Name of the latest-starting event of ``events`` (sorted by start)
    that covers ``t``, looking back at most ``lookback`` events."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - lookback), -1):
        if events[j][1] >= t:
            return events[j][3]
    return None


def breakdown(summary: Dict[str, Any]) -> Dict[str, List[List[Any]]]:
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1]["seconds"])
    gaps = sorted(summary["gaps"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[name[:160], v["seconds"]] for name, v in ops[:10]],
            "idle_gaps": [[name[:160], s] for name, s in gaps[:10]]}


def kernel_stat(summary: Dict[str, Any], fragment: str) -> Tuple[float, int]:
    """(device seconds, launches) of every kernel whose name holds
    ``fragment``."""
    secs, n = 0.0, 0
    for name, v in summary["kernels"].items():
        if fragment in name:
            secs += v["seconds"]
            n += v["launches"]
    return secs, n
