"""Mean host ms a batch in the scorer's ``assemble`` stage (the join, the
encode, the features, the history ring, the graph join, the tokenizer),
from the scorer's own spans."""

from perfbench.metrics._common import stage_mean_ms


def read(ctx):
    return stage_mean_ms(ctx, "assemble")
