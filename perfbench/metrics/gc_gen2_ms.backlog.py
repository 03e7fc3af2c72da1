"""Pause ms of the interpreter's full (generation 2) collections a second,
from the program's own collector counter (``host_stats()["stages"]
["gc.gen2"]``), between the window's open and the profiled slice's start.
A generation that has not collected is absent from the table: read as 0.
A program that keeps no collector counter (no ``gc.`` entry at all) gives
nothing."""

_NONE = {"count": 0, "total_s": 0.0}


def read(ctx):
    after = ctx.get("stages_at_slice")
    if after is None or not ctx.get("slice"):
        return None
    if not any(name.startswith("gc.") for name in after):
        return None
    span = ctx["slice"] - ctx["t0"]
    if span <= 0:
        return None
    before = ctx["stages_before"].get("gc.gen2", _NONE)
    total = after.get("gc.gen2", _NONE)["total_s"] - before["total_s"]
    return 1e3 * total / span
