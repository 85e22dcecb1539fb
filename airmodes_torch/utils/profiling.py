"""Tracing and profiling hooks: the counterpart of
`airmodes/utils/profiling.py`, with `torch.profiler` in place of
`jax.profiler`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional


# The profiler loses device events at a session's start, in two ways seen
# on an H100 (chip_smoke phase 17, trace_check.py). It keeps an event only
# where its start, mapped onto the host's clock, falls inside the session,
# and some sessions mapped the card's clock up to ~9 ms early, dropping
# the kernels of their first milliseconds. And a session opened after much
# unprofiled work lost the device events of the first 1-7 kernels launched
# in it, however long it waited first. So each session first launches
# PRIMER_LAUNCHES small kernels (in the range PRIMER) and waits for them,
# then records SETTLE_S more seconds before the caller's work starts.
PRIMER = "profiler primer"
PRIMER_LAUNCHES = 32
SETTLE_S = 0.1


@contextlib.contextmanager
def profiler():
    """A torch.profiler session of the host (every thread: the runners
    launch from their dispatch threads, which a default session does not
    record) and, when CUDA is available, of the card's kernels and copies,
    primed and settled before the enclosed code runs."""
    import torch
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, experimental_config=_ExperimentalConfig(
            profile_all_threads=True)) as prof:
        if cuda:
            with torch.profiler.record_function(PRIMER):
                one = torch.zeros(1, device="cuda")
                for _ in range(PRIMER_LAUNCHES - 1):
                    one.add_(1.0)
            torch.cuda.synchronize()
        time.sleep(SETTLE_S)
        yield prof


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Profile the enclosed code with `profiler()` when logdir is set, and
    write a Chrome trace (`trace_<pid>_<time>.json`, readable in Perfetto
    or chrome://tracing) into it."""
    if not logdir:
        yield
        return
    os.makedirs(logdir, exist_ok=True)
    with profiler() as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{int(time.time())}.json"))


# the context span() returns while no profiler records: made once, so a
# call allocates nothing (a nullcontext holds no state and may be entered
# by many threads at once)
_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named `name` around a piece of host work, in the
    profiler's trace on its clock, beside the card's events. Opened only
    while a profiler records (`profiler()`, which `trace()`, `modes_rx
    --profile` and the benchmark open); otherwise the one shared no-op
    context, since a range costs microseconds of host time.

    The runners name theirs `airmodes.<stage>` (io/native_stream.py,
    io/stream.py, native/__init__.py). Open and close a span on one thread,
    and never across a `yield`: the time between would be the caller's."""
    import torch
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def kernel_range(name: str):
    """The span (`span`) named `name` ("<ID> <kernel>", the IDs of PERF.md's
    kernel table, e.g. "B1 detect_cands") around one hand-kernel launch,
    or around its plain version for CPU tensors: the counterpart of the
    reference trace naming its Pallas kernels."""
    return span(name)


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
