"""Mean host ms a batch in the scorer's ``write_back`` stage, inside
``finalize``: velocity, the transaction cache and the typed graph's links
written back, from the program's own stage table."""

from perfbench.metrics._common import stage_mean_ms


def read(ctx):
    return stage_mean_ms(ctx, "write_back")
