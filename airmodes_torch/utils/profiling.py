"""Tracing and profiling hooks: the counterpart of
`airmodes/utils/profiling.py`, with `torch.profiler` in place of
`jax.profiler`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Profile the enclosed code with torch.profiler (host, and the card's
    kernels and copies when CUDA is available) when logdir is set, and
    write a Chrome trace (`trace_<pid>_<time>.json`, readable in Perfetto
    or chrome://tracing) into it."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{int(time.time())}.json"))


class RateMeter:
    """Interval throughput/latency meter for the host streaming loop."""

    def __init__(self):
        self.t0 = time.time()
        self.samples = 0
        self.blocks = 0
        self._last = self.t0
        self._last_samples = 0

    def add(self, samples: int) -> None:
        self.samples += samples
        self.blocks += 1

    def interval(self) -> dict:
        now = time.time()
        dt = max(now - self._last, 1e-9)
        rate = (self.samples - self._last_samples) / dt
        self._last, self._last_samples = now, self.samples
        return {"msps": rate / 1e6,
                "avg_msps": self.samples / max(now - self.t0, 1e-9) / 1e6,
                "blocks": self.blocks}
