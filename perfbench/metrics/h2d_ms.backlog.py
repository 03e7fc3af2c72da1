"""Mean host ms a batch in the scorer's ``h2d`` stage, inside ``dispatch``:
every packed blob's pinned buffer, host copy and non-blocking copy to the
card, from the program's own stage table."""

from perfbench.metrics._common import stage_mean_ms


def read(ctx):
    return stage_mean_ms(ctx, "h2d")
