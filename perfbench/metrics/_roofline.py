"""A kernel's share of its roofline over the profiled slice.

The least time of the slice's launches over the kernel's device time in
the trace. The launches expected are counted from the batches dispatched
in the slice and their bucket rows (the site list of ``perfbench/counts.py``
for each batch); CUPTI drops a record now and then, so the least time is
taken per expected launch and scaled to the launches the trace holds."""

from perfbench.metrics._common import slice_batches
from perfbench.trace import kernel_stat

BUCKETS = (1, 8, 32, 128, 256)


def bucket(n):
    for b in BUCKETS:
        if n <= b:
            return b
    return ((n + 255) // 256) * 256


def share(ctx, fragment, per_batch):
    """``per_batch(bucket_rows) -> (launches, least seconds)``."""
    tr = ctx.get("trace")
    if not tr:
        return None
    secs, traced = kernel_stat(tr, fragment)
    batches = slice_batches(ctx)
    if not secs or not traced or not batches:
        return None
    want_n, want_s = 0, 0.0
    for *_, rows in batches:
        n, s = per_batch(bucket(rows))
        want_n += n
        want_s += s
    if not want_n:
        return None
    counts = ctx.setdefault("launch_counts", {})
    counts[fragment] = {"traced": traced, "expected": want_n}
    return 100.0 * (want_s / want_n) * traced / secs
