"""Mean rows handed to the job's public ``dispatch_batch`` a batch: how far
the deadline closes batches before they fill."""

from perfbench.metrics._common import steps


def read(ctx):
    spans = steps(ctx, "dispatch_batch")
    if not spans:
        return None
    return sum(rows for *_, rows in spans) / len(spans)
