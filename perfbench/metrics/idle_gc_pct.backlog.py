"""Share of the profiled slice in which the card sat idle while the host
was inside one of the interpreter's collections: the idle gaps whose
innermost name is a program region ``rtfd.gc.<generation>`` (the
collector's regions, ``obs/profiling.py GcPauses``), over the slice. 0.0
when no collection lands in an idle gap; None without a trace, or when no
gap is named by any program region (a program that opens none)."""

REGION = "rtfd."
GC_REGION = REGION + "gc."


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    innermost = [(name.split(" > ")[-1], s) for name, s in tr["gaps"].items()]
    if not any(REGION in name for name in tr["gaps"]):
        return None
    idle = sum(s for name, s in innermost if name.startswith(GC_REGION))
    return 100.0 * idle / tr["window_s"]
