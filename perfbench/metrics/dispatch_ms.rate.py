"""Mean host ms a batch in the scorer's ``dispatch`` stage (kernel choice,
the copies to the card from pinned memory, the launches, the result copy's
event), from the scorer's own spans."""

from perfbench.metrics._common import stage_mean_ms


def read(ctx):
    return stage_mean_ms(ctx, "dispatch")
