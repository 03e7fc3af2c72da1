"""Pause ms of the interpreter's garbage collections a second of window
(``gc.callbacks``), over the whole window of a backlog cell."""


def read(ctx):
    t0, t1 = ctx["t0"], ctx["t0"] + ctx["seconds"]
    total = sum(min(e, t1) - max(s, t0) for s, e, _ in ctx["gc_pauses"]
                if e > t0 and s < t1)
    return 1e3 * total / ctx["seconds"]
