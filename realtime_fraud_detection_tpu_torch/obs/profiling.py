"""Profiling: ``torch.profiler`` traces and wall-clock span accounting.

Port of the JAX package's ``obs/profiling.py``:

- ``device_trace``: a ``torch.profiler`` trace of the enclosed block (CPU
  and, on ``"cuda"``, the card's kernels), written as a Chrome trace into
  ``log_dir`` (open it in Perfetto or ``chrome://tracing``); ``annotate``
  names a region in it (``torch.profiler.record_function``).
- ``SpanTimer``: named wall-clock spans with aggregate stats (count, total,
  mean, p50, p99, max), cheap enough for the microbatch hot path.
  ``TorchFraudScorer.host_stats`` reads them.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
from collections import deque
from typing import Dict, Iterator, Optional

__all__ = ["device_trace", "SpanTimer", "annotate",
           "interpolated_percentile"]


def interpolated_percentile(xs_sorted, q: float) -> float:
    """Linear-interpolated percentile over a SORTED sample (numpy's default
    convention), unit-agnostic."""
    pos = q * (len(xs_sorted) - 1)
    lo = int(pos)
    frac = pos - lo
    if lo + 1 >= len(xs_sorted):
        return float(xs_sorted[-1])
    return float(xs_sorted[lo] + (xs_sorted[lo + 1] - xs_sorted[lo]) * frac)


@contextlib.contextmanager
def device_trace(log_dir: str, device: str = "cuda") -> Iterator[object]:
    """Profile the enclosed block with ``torch.profiler`` and write a
    Chrome trace ``trace_*.json`` into ``log_dir``. On ``"cuda"`` (the
    default) it records the host and the card's activity and raises when
    no card is present; on ``"cpu"`` the host's only. Yields the profiler;
    its ``trace_path`` names the written file once the block has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device_trace on {device!r} asked for, but CUDA is not available")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    with prof:
        yield prof
    fd, path = tempfile.mkstemp(prefix="trace_", suffix=".json", dir=log_dir)
    os.close(fd)
    prof.export_chrome_trace(path)
    prof.trace_path = path


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region visible in ``device_trace``'s trace."""
    from torch.profiler import record_function

    with record_function(name):
        yield


class SpanTimer:
    """Aggregating span timer for host-side stages of the scoring seam."""

    def __init__(self, clock=time.perf_counter, max_samples: int = 10_000):
        self._clock = clock
        self._lock = threading.Lock()
        self._max = max_samples      # per-span cap: O(1) memory
        self._spans: Dict[str, deque] = {}

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = self._clock()
        try:
            yield
        finally:
            self.record(name, self._clock() - t0)

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            self._spans.setdefault(
                name, deque(maxlen=self._max)).append(seconds)

    def stats(self, name: Optional[str] = None) -> Dict[str, Dict[str, float]]:
        # snapshot under the lock; sort and percentiles outside it
        with self._lock:
            names = [name] if name else list(self._spans)
            snap = {n: list(self._spans[n]) for n in names
                    if self._spans.get(n)}
        out: Dict[str, Dict[str, float]] = {}
        for n, xs in snap.items():
            xs.sort()
            out[n] = {
                "count": len(xs),
                "total_s": sum(xs),
                "mean_ms": 1e3 * sum(xs) / len(xs),
                "p50_ms": 1e3 * interpolated_percentile(xs, 0.50),
                "p99_ms": 1e3 * interpolated_percentile(xs, 0.99),
                "max_ms": 1e3 * xs[-1],
            }
        return out

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
