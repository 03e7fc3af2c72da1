"""Mean host ms a batch in the scorer's ``launch`` stage, inside
``dispatch``: the fused scorer's host time (its PyTorch and hand-written
launches), the result's copy into pinned memory and the event record, from
the program's own stage table."""

from perfbench.metrics._common import stage_mean_ms


def read(ctx):
    return stage_mean_ms(ctx, "launch")
