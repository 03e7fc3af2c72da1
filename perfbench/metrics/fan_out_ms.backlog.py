"""Mean host ms a batch in the job's ``fan_out`` stage, inside
``complete_batch``: the produces to the output topics and the offset
commit, from the program's own stage table."""

from perfbench.metrics._common import stage_mean_ms


def read(ctx):
    return stage_mean_ms(ctx, "fan_out")
