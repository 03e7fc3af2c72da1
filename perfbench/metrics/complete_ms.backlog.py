"""Mean host ms of the job's public ``complete_batch`` a batch: the wait
for the card, the responses, the state write-back, the fan-out to the
output topics and the commit."""

from perfbench.metrics._common import steps


def read(ctx):
    spans = steps(ctx, "complete_batch")
    if not spans:
        return None
    return 1e3 * sum(e - s for _, s, e, _ in spans) / len(spans)
