"""Mean host ms a batch in the scorer's ``responses`` stage, inside
``finalize``: the response dicts built from the result matrix, from the
program's own stage table."""

from perfbench.metrics._common import stage_mean_ms


def read(ctx):
    return stage_mean_ms(ctx, "responses")
