"""The replays of the full-block step's graph in a traced window: the step
that the port's native int8 runners take outside the planar gate, one
captured graph a step, replayed inside the port's span
`airmodes.full_block` (`airmodes_torch/io/native_stream._planar_step`).

A replay's device events (its kernels and memsets) share the correlation
of its `cudaGraphLaunch`; the host's launches carry no correlation in the
trace, so a replay is matched to the last launch that started before its
first event, and kept where that launch lies inside a span. A replay cut by
the window's edges is left out. A trace without the span (a program that
lacks it) has no replays.
"""

from __future__ import annotations

import bisect
from typing import List

SPAN = "airmodes.full_block"
LAUNCH = "cudaGraphLaunch"
EDGE_US = 0.01          # an event this close to the window's edge was cut


def replays(tr) -> List[list]:
    """The device events [(name, start us, end us, correlation, category)]
    of each whole replay launched inside a span, one list a replay."""
    if tr is None:
        return []
    inside = sorted((a, b) for n, _, a, b in tr.host if n == SPAN)
    if not inside:
        return []
    launches = sorted((a, any(sa <= a and b <= sb for sa, sb in inside))
                      for n, _, a, b in tr.host if LAUNCH in n)
    starts = [a for a, _ in launches]
    out = []
    for events in tr.by_correlation().values():
        if sum(1 for e in events if e[4] == "kernel") < 2:
            continue                    # not a graph replay
        first = min(e[1] for e in events)
        last = max(e[2] for e in events)
        if first <= tr.t0 + EDGE_US or last >= tr.t1 - EDGE_US:
            continue
        i = bisect.bisect_right(starts, first) - 1
        if i >= 0 and launches[i][1]:
            out.append(events)
    return out
