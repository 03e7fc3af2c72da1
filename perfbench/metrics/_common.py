"""Shared arithmetic of the per-layer metric readers.

A reader is ``read(ctx) -> float | None`` in ``perfbench/metrics/<name>.py``.
``ctx`` holds the traced run's host spans (``spans``: (step, start, end,
rows)), the window's open time and length, the profiled slice's host
boundaries, the scorer's stage spans (``host_stats()["stages"]``) at the
window's open and at the slice's start, the collector's pauses and the
read trace (``perfbench/trace.py read_trace``). Host numbers are taken over
the part of the window before the profiled slice, so the profiler's own
cost stays out of them. A reader that finds nothing returns None.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


def steps(ctx: Dict[str, Any], name: str) -> List[tuple]:
    """The job step's spans that started inside the window and before the
    profiled slice."""
    lo = ctx["t0"]
    hi = ctx["slice"] if ctx.get("slice") else ctx["t0"] + ctx["seconds"]
    return [s for s in ctx["spans"] if s[0] == name and lo <= s[1] < hi]


def stage_mean_ms(ctx: Dict[str, Any], stage: str) -> Optional[float]:
    """Mean ms a batch of a scorer stage between the window's open and the
    slice's start, from the cumulative (count, total) of its spans."""
    before, after = ctx["stages_before"], ctx.get("stages_at_slice")
    if after is None or stage not in after:
        return None
    b = before.get(stage, {"count": 0, "total_s": 0.0})
    n = after[stage]["count"] - b["count"]
    if n <= 0:
        return None
    return 1e3 * (after[stage]["total_s"] - b["total_s"]) / n


def idle_pct(ctx: Dict[str, Any]) -> Optional[float]:
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def slice_batches(ctx: Dict[str, Any]) -> List[tuple]:
    """dispatch_batch spans inside the profiled slice."""
    lo, hi = ctx.get("slice"), ctx.get("slice_end")
    if lo is None or hi is None:
        return []
    return [s for s in ctx["spans"]
            if s[0] == "dispatch_batch" and lo <= s[1] < hi]
