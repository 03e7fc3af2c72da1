"""Profiling: ``torch.profiler`` traces, regions on the profiler's clock,
the host layer's stage table and the collector's pauses.

Port of the JAX package's ``obs/profiling.py``, extended:

- ``device_trace``: a ``torch.profiler`` trace of the enclosed block (CPU
  and, on ``"cuda"``, the card's kernels), written as a Chrome trace into
  ``log_dir`` (open it in Perfetto or ``chrome://tracing``);
- ``annotate``: the program's one region helper. While a profiler records
  on the calling thread it opens a ``record_function`` region; otherwise
  it costs one check (``torch.autograd._profiler_enabled``, ~0.1-0.2 us);
- ``SpanTimer``: named wall-clock spans, cheap enough for the microbatch hot
  path: a sample ring per span (percentiles over the last ``max_samples``)
  and cumulative count and seconds since construction. ``span(name)`` also
  opens the region ``rtfd.<name>``. ``TorchFraudScorer.host_stats`` reads
  it (``stage_stats``);
- ``GcPauses``: the interpreter's collection pauses per generation, one
  process-wide recorder on ``gc.callbacks`` (``install_gc_pauses``). It
  opens the region ``rtfd.gc.gen<N>`` for a collection that starts while a
  profiler records, so the profiler's idle gaps on the card are named by
  the stage or the collection the host was in.
"""

from __future__ import annotations

import contextlib
import gc
import os
import tempfile
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional

__all__ = ["device_trace", "SpanTimer", "annotate", "GcPauses",
           "install_gc_pauses", "profiler_running", "interpolated_percentile",
           "REGION_PREFIX"]

# every region the program opens starts with this; none starts with
# ``job.``, which names the benchmark harness's job steps
REGION_PREFIX = "rtfd."

_profiler_enabled = None   # torch.autograd._profiler_enabled, bound on first use


def profiler_running() -> bool:
    """True while a ``torch.profiler`` records on the calling thread."""
    global _profiler_enabled
    if _profiler_enabled is None:
        from torch.autograd import _profiler_enabled
    return _profiler_enabled()


def _open_region(name: str):
    from torch.profiler import record_function

    region = record_function(name)
    region.__enter__()
    return region


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


class annotate:
    """Named region on the profiler's clock: a ``record_function`` region
    while a profiler records on this thread (visible in ``device_trace``'s
    trace), else nothing but that check. One instance is one region at a
    time."""

    __slots__ = ("name", "_region")

    def __init__(self, name: str):
        self.name = name
        self._region = None

    def __enter__(self) -> "annotate":
        if profiler_running():
            self._region = _open_region(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        region = self._region
        if region is not None:
            self._region = None
            region.__exit__(None, None, None)
        return False


class _Span(annotate):
    """``SpanTimer.span``: the region ``rtfd.<name>`` around one sample of
    the timer's clock."""

    __slots__ = ("_timer", "_stage", "_t0")

    def __init__(self, timer: "SpanTimer", stage: str):
        annotate.__init__(self, REGION_PREFIX + stage)
        self._timer = timer
        self._stage = stage

    def __enter__(self) -> "_Span":
        annotate.__enter__(self)
        self._t0 = self._timer._clock()
        return self

    def __exit__(self, *exc) -> bool:
        timer = self._timer
        timer.record(self._stage, timer._clock() - self._t0)
        return annotate.__exit__(self, *exc)


class SpanTimer:
    """Aggregating span timer for host-side stages of the scoring seam: a
    sample ring per span for percentiles, and cumulative count and seconds
    since construction, which ``reset`` leaves alone."""

    def __init__(self, clock=time.perf_counter, max_samples: int = 10_000):
        self._clock = clock
        self._lock = threading.Lock()
        self._max = max_samples      # per-span cap: O(1) memory
        self._spans: Dict[str, deque] = {}
        self._totals: Dict[str, List[float]] = {}   # name -> [count, seconds]

    def span(self, name: str) -> _Span:
        """Time the enclosed block as one sample of ``name`` (recorded when
        it raises too) inside the region ``rtfd.<name>``."""
        return _Span(self, name)

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            self._spans.setdefault(
                name, deque(maxlen=self._max)).append(seconds)
            tot = self._totals.get(name)
            if tot is None:
                self._totals[name] = [1, seconds]
            else:
                tot[0] += 1
                tot[1] += seconds

    def stats(self, name: Optional[str] = None) -> Dict[str, Dict[str, float]]:
        """Count, total, mean, p50, p99 and max over each span's sample
        ring (the JAX package's ``SpanTimer.stats``)."""
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

    def stage_stats(self) -> Dict[str, Dict[str, float]]:
        """Per span: ``count``, ``total_s`` and ``mean_ms`` since
        construction, and ``p50_ms``, ``p99_ms`` and ``max_ms`` over the
        sample ring while it holds samples. A reader that differences two
        snapshots' ``count`` and ``total_s`` gets the exact mean between
        them, however many samples passed."""
        with self._lock:
            totals = {n: tuple(t) for n, t in self._totals.items()}
        ring = self.stats()
        out: Dict[str, Dict[str, float]] = {}
        for n, (count, total) in totals.items():
            st = {"count": int(count), "total_s": total,
                  "mean_ms": 1e3 * total / count}
            r = ring.get(n)
            if r is not None:
                st.update(p50_ms=r["p50_ms"], p99_ms=r["p99_ms"],
                          max_ms=r["max_ms"])
            out[n] = st
        return out

    def reset(self) -> None:
        """Empty the sample rings; the cumulative totals run on."""
        with self._lock:
            self._spans.clear()


class GcPauses:
    """The interpreter's collection pauses, per generation: a ``gc.callbacks``
    hook keeping the cumulative count and seconds in plain attributes.

    It takes no lock (a collection can start on a thread that holds any
    lock, ``SpanTimer``'s included; a collection runs under the interpreter
    lock, one at a time) and costs two clock reads and two additions a
    collection, plus the region check. A collection that starts while a
    profiler records on its thread runs inside the region
    ``rtfd.gc.gen<N>``; the hook closes only a region it opened, so a
    profiler that starts or stops between the two callbacks leaves no
    region half open."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self.count = [0, 0, 0]
        self.total_s = [0.0, 0.0, 0.0]
        self._t0: Optional[float] = None
        self._region = None

    def __call__(self, phase: str, info: Dict[str, int]) -> None:
        if phase == "start":
            if profiler_running():
                self._region = _open_region(
                    f"{REGION_PREFIX}gc.gen{info['generation']}")
            self._t0 = self._clock()
            return
        t0 = self._t0
        if t0 is None:
            # its start read no clock: the region failed to open there (the
            # collector prints and drops a callback's exception)
            return
        gen = info["generation"]
        self.count[gen] += 1
        self.total_s[gen] += self._clock() - t0
        self._t0 = None
        region = self._region
        if region is not None:
            self._region = None
            region.__exit__(None, None, None)

    def stats(self) -> Dict[str, Dict[str, float]]:
        """``gc.gen<N>``: count, total_s and mean_ms of the collections of
        each generation that has collected since the hook was installed."""
        out: Dict[str, Dict[str, float]] = {}
        for gen in range(3):
            n, total = self.count[gen], self.total_s[gen]
            if n:
                out[f"gc.gen{gen}"] = {"count": n, "total_s": total,
                                       "mean_ms": 1e3 * total / n}
        return out


# the process's one collector recorder: the collector is process-wide
GC_PAUSES = GcPauses()
_install_lock = threading.Lock()


def install_gc_pauses() -> GcPauses:
    """Put ``GC_PAUSES`` on ``gc.callbacks`` once per process (idempotent);
    returns it. It holds no reference to whoever installed it."""
    profiler_running()      # bind the check here, never inside a collection
    with _install_lock:
        if not any(cb is GC_PAUSES for cb in gc.callbacks):
            gc.callbacks.append(GC_PAUSES)
    return GC_PAUSES
