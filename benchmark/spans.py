"""The port's own spans in a traced window: the ranges its runners open
under the profiler (`airmodes_torch/utils/profiling.span`), named
`airmodes.<stage>`, which the trace keeps with the host's ranges
(`tracing.Trace.host`) on the profiler's clock:

- `airmodes.frame`: one block framed (the native framer's feeder or pool
  thread, or the fused runner's raw windowing on the caller's thread);
- `airmodes.source_wait`: inside a frame, a wait for the source's samples;
- `airmodes.dispatch`: one step's copies and graph replay;
- `airmodes.result_wait`: the caller's wait on the dispatch queue;
- `airmodes.fetch`: one step's tables copied from the card;
- `airmodes.decode`: one block's table unpacked into wire messages.

Every span is clipped to the window. A span's self time is its clipped
length less the clipped lengths of the spans directly inside it on the
same thread. A trace without the spans (a program that lacks them) gives
the readers nothing to read.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

PREFIX = "airmodes."
EPS_US = 0.01          # the trace's microseconds are rounded to ns


def spans(trace) -> Dict[str, List[Tuple[object, float, float]]]:
    """{name: [(tid, clipped length us, self time us)]} of the window's
    `airmodes.*` spans."""
    out: Dict[str, list] = defaultdict(list)
    if trace is None:
        return out
    t0, t1 = trace.t0, trace.t1
    by_tid: Dict[object, list] = defaultdict(list)
    for name, tid, a, b in trace.host:
        if name.startswith(PREFIX):
            by_tid[tid].append((a, b, name))
    for tid, evs in by_tid.items():
        evs.sort(key=lambda e: (e[0], -e[1]))
        stack: list = []           # open spans: [end, name, length, inner]

        def close(node):
            out[node[1]].append((tid, node[2], max(node[2] - node[3], 0.0)))
        for a, b, name in evs:
            while stack and stack[-1][0] <= a + EPS_US:
                close(stack.pop())
            length = max(min(b, t1) - max(a, t0), 0.0)
            if stack and b <= stack[-1][0] + EPS_US:
                stack[-1][3] += length
            stack.append([b, name, length, 0.0])
        while stack:
            close(stack.pop())
    return out


def total_ms(found, name: str, self_time: bool = False):
    """(ms, count) of the spans `name`: their clipped lengths, or self
    times, summed."""
    sel = found.get(name, [])
    return 1e-3 * sum(s[2] if self_time else s[1] for s in sel), len(sel)


def mean_ms(trace, name: str, self_time: bool = False):
    """The spans' mean clipped length (or self time) in ms, or None where
    the window holds none."""
    ms, n = total_ms(spans(trace), name, self_time)
    return ms / n if n else None
