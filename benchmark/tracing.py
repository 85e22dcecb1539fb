"""Reduction of a profiler trace (the Chrome trace of the port's
`utils.profiling.profiler()` session) to what the per-layer readers and the
result's `breakdown` need.

The traced window is the harness's own range `bench.traced_window`, opened
after the session's primer and settle; every device event is clipped to it.
Device events are kernels, copies and memsets; their union is the time the
card was busy.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

WINDOW = "bench.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Trace:
    """Device events [(name, start us, end us, correlation, category)] and
    host
    events [(name, tid, start us, end us)] inside the traced window
    (t0, t1), on the trace's clock."""

    def __init__(self, events: List[dict]):
        win = [e for e in events if e.get("ph") == "X"
               and e.get("name") == WINDOW]
        if not win:
            raise ValueError(f"trace has no {WINDOW!r} range")
        w = win[-1]
        self.t0 = float(w["ts"])
        self.t1 = self.t0 + float(w.get("dur", 0.0))
        self.device = []
        self.host = []
        names = {}
        for e in events:
            if e.get("ph") == "M" and e.get("name") == "thread_name":
                names[e.get("tid")] = e.get("args", {}).get("name", "")
            if e.get("ph") != "X":
                continue
            a = float(e["ts"])
            b = a + float(e.get("dur", 0.0))
            if b <= self.t0 or a >= self.t1:
                continue
            cat = e.get("cat")
            if cat in DEVICE_CATS:
                self.device.append((e["name"], max(a, self.t0),
                                    min(b, self.t1),
                                    e.get("args", {}).get("correlation"),
                                    cat))
            elif cat in HOST_CATS and e["name"] != WINDOW:
                self.host.append((e["name"], e.get("tid"), a, b))
        self.device.sort(key=lambda d: d[1])
        self.thread_names = names

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f).get("traceEvents", []))

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device events, merged, in us."""
        out: List[List[float]] = []
        for _, a, b, *_ in self.device:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def device_time(self, match) -> Tuple[float, int]:
        """(seconds, events) of the device events whose name `match`
        accepts."""
        sel = [b - a for n, a, b, *_ in self.device if match(n)]
        return sum(sel) * 1e-6, len(sel)

    def by_correlation(self) -> Dict[object, list]:
        """Device events grouped by the host call that launched them (a
        graph replay's kernels share its launch's correlation), each group
        in start order."""
        groups: Dict[object, list] = {}
        for d in self.device:
            groups.setdefault(d[3], []).append(d)
        return groups

    def steps(self, gap_us: float) -> List[List[tuple]]:
        """Device events in runs separated by idle gaps longer than
        gap_us."""
        runs: List[List[tuple]] = []
        end = None
        for d in self.device:
            if end is None or d[1] - end > gap_us:
                runs.append([])
            runs[-1].append(d)
            end = d[2] if end is None else max(end, d[2])
        return runs

    def top_ops(self, n: int = 10) -> List[list]:
        """[[name, seconds]] of the device operations that took most time,
        summed by name."""
        tot: Dict[str, float] = {}
        for name, a, b, *_ in self.device:
            tot[name] = tot.get(name, 0.0) + (b - a) * 1e-6
        return [[k[:120], v] for k, v in sorted(
            tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """[[label, seconds]] of the n longest idle gaps of the card in the
        window, each labelled by the host ranges that overlap it most
        (at most two, by thread), or "no host range" where the host ran
        only code the profiler does not see (the native framer, Python)."""
        busy = self.busy_intervals()
        gaps = []
        prev = self.t0
        for a, b in busy:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            over: Dict[tuple, float] = {}
            for name, tid, ha, hb in self.host:
                o = min(b, hb) - max(a, ha)
                if o > 0:
                    key = (self.thread_names.get(tid, str(tid)), name)
                    over[key] = over.get(key, 0.0) + o
            top = sorted(over.items(), key=lambda kv: -kv[1])[:2]
            label = "; ".join(f"{t}: {nm}"[:80] for (t, nm), _ in top)
            out.append([label or "no host range", (b - a) * 1e-6])
        return out
