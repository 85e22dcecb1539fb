"""fullblock_graph_nodes (nodes): the size of the native int8 runners' step
outside the planar gate, as the host launches it: the device events
(kernels and memsets) of one replay of the step's captured graph launched
inside the port's `airmodes.full_block` span (`benchmark/fullblock.py`),
the median over the whole replays in the window. The launch's host
cost and the card's per-kernel overhead grow with the nodes. A count, not
a time: a traced time of the step's host work reads the profiler, which
records every node of a launch and every op, more than the program. A
trace without the span (a program that lacks it) gives nothing to read."""

import statistics

from benchmark.fullblock import replays


def read(ctx):
    found = replays(ctx.trace)
    if not found:
        return None
    return float(statistics.median(len(events) for events in found))
