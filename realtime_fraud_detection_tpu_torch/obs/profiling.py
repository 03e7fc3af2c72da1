"""Wall-clock span accounting for the host stages of the scoring seam.

Port of ``SpanTimer`` and ``interpolated_percentile`` from the JAX
package's ``obs/profiling.py``: named spans with aggregate stats (count,
total, mean, p50, p99, max), cheap enough for the microbatch hot path.
``TorchFraudScorer.host_stats`` reads them.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

__all__ = ["SpanTimer", "interpolated_percentile"]


def interpolated_percentile(xs_sorted, q: float) -> float:
    """Linear-interpolated percentile over a SORTED sample (numpy's default
    convention), unit-agnostic."""
    pos = q * (len(xs_sorted) - 1)
    lo = int(pos)
    frac = pos - lo
    if lo + 1 >= len(xs_sorted):
        return float(xs_sorted[-1])
    return float(xs_sorted[lo] + (xs_sorted[lo + 1] - xs_sorted[lo]) * frac)


class SpanTimer:
    """Aggregating span timer for host-side stages of the scoring seam."""

    def __init__(self, clock=time.perf_counter, max_samples: int = 10_000):
        self._clock = clock
        self._lock = threading.Lock()
        self._max = max_samples      # per-span cap: O(1) memory
        self._spans: Dict[str, deque] = {}

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
