"""Probes P1-P3: what the card's device memory sustains for a copy and for
a read, and whether bulk asynchronous copies into shared memory reach it.

The counterpart of `scripts/tpu_bw_probe.py`. Over a (2^21, 128) f32 array
(1 GiB) it times five lines:

  torch copy (R+W)  `x + 1.0`, one PyTorch call (the script's XLA copy)
  torch sum (R)     `torch.sum(x)` (the script's XLA reduction)
  P1 copy           kernel `copy` (csrc/bw_probe.cu): y = x + 1
  P2 bulk read      kernel `dma_read`: per 144-row window one bulk copy
                    into shared memory, then its column sums, written to 8
                    output rows
  P3 2-slot read    kernel `dma2_read`: the same output from persistent
                    CTAs that fetch their next window while they sum this
                    one

Each line: the card's ms (`probes.time_ms`: CUDA events, median of 20),
the rate of the bytes it moves (each input byte read once, each output
byte written once), and the host clock's median, as the script read its
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
from . import flush_buffer, host_ms, smi_line, time_ms

ROWS, LANES = 1 << 21, 128   # 2^21 x 128 f32 = 1 GiB
WROWS = 144                  # rows per window of P2 and P3
OUT_ROWS = 8                 # output rows per window

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


def copy(x: torch.Tensor) -> torch.Tensor:
    """P1: x + 1 over a (rows, 128) f32 array."""
    xc = _operand(x)
    if xc is None:
        return copy_plain(x)
    from ..kernels import _ext
    y = torch.empty_like(xc)
    lib = _ext.lib("bw_probe")
    with torch.cuda.device(xc.device):
        rc = lib.bw_copy_launch(xc.data_ptr(), y.data_ptr(), xc.numel(),
                                torch.cuda.current_stream().cuda_stream)
    _ext.check(rc, "bw_copy")
    LAUNCHES["copy"] += 1
    return y


def dma_read(x: torch.Tensor, double_buffer: bool = False) -> torch.Tensor:
    """P2 (or P3 with double_buffer): the column sums of each 144-row
    window of a (rows, 128) f32 array -> (windows * 8, 128) f32."""
    xc = _operand(x)
    if xc is None:
        return read_plain(x)
    from ..kernels import _ext
    rows = xc.shape[0]
    out = torch.empty((windows(rows) * OUT_ROWS, LANES), dtype=torch.float32,
                      device=xc.device)
    lib = _ext.lib("bw_probe")
    with torch.cuda.device(xc.device):
        rc = lib.bw_read_launch(xc.data_ptr(), out.data_ptr(), rows,
                                int(double_buffer),
                                torch.cuda.current_stream().cuda_stream)
    _ext.check(rc, "bw_read")
    LAUNCHES["dma2_read" if double_buffer else "dma_read"] += 1
    return out


def dma2_read(x: torch.Tensor) -> torch.Tensor:
    """P3: dma_read's output from double-buffered persistent CTAs."""
    return dma_read(x, double_buffer=True)


def lines(rows: int):
    """(name, function of x, bytes moved) of each line, in the script's
    order."""
    copy_b = copy_probe_cost(rows, LANES)[0]
    read_b = read_probe_cost(rows, LANES, WROWS, OUT_ROWS)[0]
    return (("torch copy (R+W)", lambda x: x + 1.0, copy_b),
            ("torch sum (R)", torch.sum, rows * LANES * 4 + 4),
            ("P1 copy kernel (R+W)", copy, copy_b),
            ("P2 bulk-copy read (R)", dma_read, read_b),
            ("P3 2-slot bulk-copy read (R)", dma2_read, read_b))


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
