"""Share of the profiled slice in which no kernel, copy or set ran on the
card."""

from perfbench.metrics._common import idle_pct


def read(ctx):
    return idle_pct(ctx)
