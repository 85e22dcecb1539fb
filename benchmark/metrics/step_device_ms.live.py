"""step_device_ms.live (ms): the device's time per step of the live
path. The trace's device events are grouped into steps (a step comes every
block's length of air time, ~524 ms; events more than GAP_MS apart start a
new step); each step's span runs from its first event to the end of its
last, the input and table copies included. The median over the traced
window's whole steps."""

import statistics

GAP_MS = 100.0


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    runs = tr.steps(GAP_MS * 1e3)
    # the first and last run may be cut by the window's edges
    whole = runs[1:-1]
    if not whole:
        return None
    return statistics.median(
        (max(d[2] for d in r) - r[0][1]) * 1e-3 for r in whole)
