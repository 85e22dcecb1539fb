"""Measuring probes on the card: the counterparts of the TPU probes in
`scripts/` that hold a Pallas kernel.

  bw_probe              P1-P3: copy and read rates of device memory, and
                        bulk asynchronous copies into shared memory, single
                        and double buffered (scripts/tpu_bw_probe.py)
  kernel_ablate         P4: kernel B4 cut after each stage of its rule
                        (scripts/tpu_kernel_ablate.py)
  unordered_stage_probe P5: the planar path's load floor, and the planar
                        step timed variant by variant
                        (scripts/tpu_unordered_stage_probe.py)

Each runs as `python -m airmodes_torch.probes.<name>` on the card (the
default `--device cuda`, which raises without one), or with `--device cpu`
through the kernels' plain versions. The helpers below time a function on
the card (chip_smoke.py and kernel_times.py take the same harness) and read
the card's name and power limit.
"""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable

import torch

__all__ = ["flush_buffer", "host_ms", "smi_line", "time_ms"]

# cycles the card first spins before each call that time_ms times with
# device_only: ~2 ms at the H100 SXM's 1.98 GHz boost clock
SPIN_CYCLES = 4_000_000


def smi_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def flush_buffer(device) -> torch.Tensor:
    """A 64 MiB buffer on the card, larger than its L2 cache: time_ms
    writes it before each call to evict the cache."""
    return torch.empty(64 << 20, dtype=torch.uint8, device=device)


def time_ms(fn: Callable[[], object], iters: int = 20, flush=None,
            device_only: bool = True):
    """Median milliseconds of fn() on the card by CUDA events, each call
    after a write of `flush` (flush_buffer) that evicts the L2 cache (the
    operands arrive from the host), after three untimed calls.

    device_only: the card first spins while the host enqueues the events
    and fn's launches, so the time is the card's alone and not the host's
    launch overhead; each such call ends in a synchronise, so that no
    call's launches wait for room in the launch queue behind earlier
    spins. Where the host took longer to enqueue than the card spun, the
    reading would hold host time: the calls are timed again with the spin
    doubled, up to 64 times SPIN_CYCLES, and None is returned if even that
    was too short (fn waits for the card). False times the call
    as a caller sees it, the gaps in which the card waits for the host
    inside. The median keeps a stalled call (a mean of the first kernel
    timed in a process moved by a third between runs) out of it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    spin = SPIN_CYCLES
    while True:
        runs = []
        for _ in range(iters):
            if flush is not None:
                flush.zero_()
            a, s, e = (torch.cuda.Event(enable_timing=True) for _ in range(3))
            t0 = time.perf_counter()
            if device_only:
                a.record()
                torch.cuda._sleep(spin)
            s.record()
            fn()
            e.record()
            runs.append((a, s, e, (time.perf_counter() - t0) * 1e3))
            if device_only:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        if not device_only or all(host < 0.9 * a.elapsed_time(s)
                                  for a, s, _, host in runs):
            return statistics.median(s.elapsed_time(e)
                                     for _, s, e, _ in runs)
        if spin >= 64 * SPIN_CYCLES:
            return None
        spin *= 2


def host_ms(fn: Callable[[], object], iters: int = 5,
            device: torch.device = None) -> list:
    """Host-clock milliseconds of each of `iters` calls of fn(), each ending
    in a synchronise of `device` when it is a card, after one untimed call."""
    def sync():
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
    fn()
    sync()
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync()
        out.append((time.perf_counter() - t0) * 1e3)
    return out
