"""Probes P1-P3: what the card's device memory sustains for a copy and for
a read, and whether bulk asynchronous copies into shared memory reach it.

The counterpart of `scripts/tpu_bw_probe.py`. Over a (2^21, 128) f32 array
(1 GiB) it times six lines:

  torch copy (R+W)  `x + 1.0`, one PyTorch call (the script's XLA copy)
  torch sum (R)     `torch.sum(x)` (the script's XLA reduction)
  torch window sums `window_sums`: the column sums of every 144-row window
                    in one call, reading the bytes P2 and P3 read (the
                    yardstick of P2 and P3)
  P1 copy           kernel `copy` (csrc/bw_probe.cu): y = x + 1, each CTA
                    over one contiguous 2 KB span
  P2 bulk read      kernel `dma_read`: per 144-row window one bulk copy
                    into shared memory, then its column sums, written to 8
                    output rows
  P3 ring read      kernel `dma2_read`: the same output from persistent
                    CTAs that take windows from a ticket counter and keep
                    rings of half-window copies in flight while two
                    warpgroups sum

Each line: the card's ms (`probes.time_ms`: CUDA events, median of 20),
the rate of its own bytes (each input byte read once, each output byte
written once), and the host clock's median, as the script read its
times. The torch lines are yardsticks, not kernels of the port.

    python -m airmodes_torch.probes.bw_probe

runs on the card (`--device cuda`, the default; raises without one);
`--device cpu` runs the plain versions, host clock only.
"""

from __future__ import annotations

import argparse
import statistics
import sys

import torch

from ..kernels.opcount import copy_probe_cost, read_probe_cost
from ..dsp.pipeline import resolve_device
from ..utils.profiling import kernel_range
from . import flush_buffer, host_ms, smi_line, time_ms

ROWS, LANES = 1 << 21, 128   # 2^21 x 128 f32 = 1 GiB
WROWS = 144                  # rows per window of P2 and P3
OUT_ROWS = 8                 # output rows per window
SMEM_PER_CTA = 232_448       # shared memory a CTA can have on Hopper
COPY_THREADS = 128           # P1's CTA, one float4 per thread
HALF_BYTES = WROWS // 2 * LANES * 4  # a half-window of P3's ring: 36,864
RING_GROUPS = 2              # P3's pipelines per CTA, a ring each
RING_OFFSET = 128            # P3's mbarriers and slot windows, then its ring

# kernel launches since the last reset_launches(); only the CUDA paths count
LAUNCHES = {"copy": 0, "dma_read": 0, "dma2_read": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def make_input(rows: int = ROWS, device="cuda", seed: int = 0):
    """(rows, 128) f32 standard normal samples made on `device` from a
    seeded generator (the values do not matter to a rate)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((rows, LANES), generator=g, device=dev,
                       dtype=torch.float32)


def windows(rows: int) -> int:
    """Windows P2 and P3 read; the last rows % 144 rows are never read."""
    return rows // WROWS


def copy_geometry(rows: int):
    """(span, grid) of P1 over (rows, 128) f32: each CTA takes one
    contiguous span of float4s, one per thread (2 KB); the last CTA's span
    is cut at the end of the array."""
    n4 = rows * LANES // 4
    return COPY_THREADS, -(-n4 // COPY_THREADS)


def ring_geometry(rows: int, sms: int):
    """(grid, stages, shared-memory bytes) of P3 over (rows, 128) f32 on a
    card of `sms` SMs: one persistent CTA per SM, or one per window when
    there are fewer (one that takes no window when there is none), and as
    many half-window slots as fit, an equal ring for each pipeline."""
    grid = max(1, min(windows(rows), sms))
    per = (SMEM_PER_CTA - RING_OFFSET) // HALF_BYTES // RING_GROUPS
    stages = per * RING_GROUPS
    return grid, stages, RING_OFFSET + stages * HALF_BYTES


def copy_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of P1: x + 1 in f32."""
    return x + 1.0


def read_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of P2 and P3: each window's column sums, taken in row
    order (the kernels' order), on each of the window's 8 output rows."""
    steps = windows(x.shape[0])
    w = x[:steps * WROWS].view(steps, WROWS, LANES)
    s = w[:, 0]
    for r in range(1, WROWS):
        s = s + w[:, r]
    return s[:, None, :].expand(steps, OUT_ROWS, LANES).reshape(
        steps * OUT_ROWS, LANES)


def window_sums(x: torch.Tensor) -> torch.Tensor:
    """Each window's column sums in one PyTorch call (the yardstick of P2
    and P3: their reads, without their 8-row broadcast)."""
    steps = windows(x.shape[0])
    return torch.sum(x[:steps * WROWS].view(steps, WROWS, LANES), dim=1)


def _operand(x: torch.Tensor) -> torch.Tensor:
    """x checked, and made contiguous and 16-byte aligned for a launch;
    None when x lies on the CPU (the plain versions take it)."""
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != LANES:
        raise ValueError(f"expected a (rows, {LANES}) f32 array, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return None
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


# P3's ticket counters, one per (card, stream): two zero ints, made once;
# each launch takes windows from the first and leaves both 0
_TICKETS = {}


def _tickets(dev: torch.device, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(2, dtype=torch.int32, device=dev)
    return _TICKETS[key]


def copy(x: torch.Tensor) -> torch.Tensor:
    """P1: x + 1 over a (rows, 128) f32 array."""
    xc = _operand(x)
    if xc is None:
        with kernel_range("P1 bw_copy"):
            return copy_plain(x)
    from ..kernels import _ext
    y = torch.empty_like(xc)
    if xc.numel() == 0:
        return y
    span4, grid = copy_geometry(xc.shape[0])
    lib = _ext.lib("bw_probe")
    with torch.cuda.device(xc.device), kernel_range("P1 bw_copy"):
        rc = lib.bw_copy_launch(xc.data_ptr(), y.data_ptr(), xc.numel(),
                                span4, grid,
                                torch.cuda.current_stream().cuda_stream)
    _ext.check(rc, "bw_copy")
    LAUNCHES["copy"] += 1
    return y


def _read_out(xc: torch.Tensor) -> torch.Tensor:
    return torch.empty((windows(xc.shape[0]) * OUT_ROWS, LANES),
                       dtype=torch.float32, device=xc.device)


def dma_read(x: torch.Tensor) -> torch.Tensor:
    """P2: the column sums of each 144-row window of a (rows, 128) f32
    array -> (windows * 8, 128) f32, one CTA per window."""
    xc = _operand(x)
    if xc is None:
        with kernel_range("P2 bw_read"):
            return read_plain(x)
    from ..kernels import _ext
    out = _read_out(xc)
    lib = _ext.lib("bw_probe")
    with torch.cuda.device(xc.device), kernel_range("P2 bw_read"):
        rc = lib.bw_read_launch(xc.data_ptr(), out.data_ptr(), xc.shape[0],
                                torch.cuda.current_stream().cuda_stream)
    _ext.check(rc, "bw_read")
    LAUNCHES["dma_read"] += 1
    return out


def dma2_read(x: torch.Tensor) -> torch.Tensor:
    """P3: dma_read's output from persistent CTAs that take windows from a
    ticket counter into rings of half-window copies (ring_geometry)."""
    xc = _operand(x)
    if xc is None:
        with kernel_range("P3 bw_ring_read"):
            return read_plain(x)
    from ..kernels import _ext
    out = _read_out(xc)
    grid, stages, smem = ring_geometry(
        xc.shape[0],
        torch.cuda.get_device_properties(xc.device).multi_processor_count)
    lib = _ext.lib("bw_probe")
    with torch.cuda.device(xc.device), kernel_range("P3 bw_ring_read"):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bw_ring_read_launch(
            xc.data_ptr(), out.data_ptr(),
            _tickets(xc.device, stream).data_ptr(), xc.shape[0], grid,
            stages, smem, stream)
    _ext.check(rc, "bw_ring_read")
    LAUNCHES["dma2_read"] += 1
    return out


def lines(rows: int):
    """(name, function of x, bytes moved) of each line, in the script's
    order."""
    copy_b = copy_probe_cost(rows, LANES)[0]
    read_b = read_probe_cost(rows, LANES, WROWS, OUT_ROWS)[0]
    return (("torch copy (R+W)", lambda x: x + 1.0, copy_b),
            ("torch sum (R)", torch.sum, rows * LANES * 4 + 4),
            ("torch window sums (R)", window_sums,
             read_probe_cost(rows, LANES, WROWS, 1)[0]),
            ("P1 copy kernel (R+W)", copy, copy_b),
            ("P2 bulk-copy read (R)", dma_read, read_b),
            ("P3 ring bulk-copy read (R)", dma2_read, read_b))


def measure(x: torch.Tensor) -> list:
    """Each line's {name, bytes, ms, gbps, host_ms}: the card's ms
    (time_ms, the L2 cache evicted before each call) and GB/s of
    the bytes moved over it (both None off the card), and the host
    clock's median of 5."""
    flush = flush_buffer(x.device) if x.device.type == "cuda" else None
    out = []
    for name, fn, nbytes in lines(x.shape[0]):
        host = statistics.median(host_ms(lambda: fn(x), 5, x.device))
        ms = time_ms(lambda: fn(x), flush=flush) \
            if x.device.type == "cuda" else None
        out.append({"name": name, "bytes": nbytes, "ms": ms,
                    "gbps": None if ms is None else nbytes / ms / 1e6,
                    "host_ms": host})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m airmodes_torch.probes.bw_probe",
        description="Copy and read rates of device memory (P1-P3).")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    card = smi_line() if on_card else "cpu: plain versions, host clock only"
    x = make_input(ROWS, dev)
    print(f"{card}; ({ROWS}, {LANES}) f32, "
          f"{ROWS * LANES * 4 / 2**30:.3f} GiB", flush=True)
    for r in measure(x):
        dev_txt = "device not measured" if r["ms"] is None else \
            f"{r['ms']:9.5f} ms {r['gbps']:8.1f} GB/s"
        print(f"{r['name']:30s} {dev_txt}  host "
              f"{r['host_ms']:9.3f} ms  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
