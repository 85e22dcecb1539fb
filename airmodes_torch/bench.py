"""Benchmark of the port: sustained demod throughput (Msamples/s per card)
and the decode counts that gate it.

    python -m airmodes_torch.bench [--device cuda|cpu]

The counterpart of the repository's `bench.py` (the JAX package's
benchmark), with its functions, sizes, order of figures and gates. It runs
the planar int8 step (kernels B1 and B2, the torch tail, the packed table),
as the reference runs its compiled program: one captured CUDA graph per
call (`demod_batch_packed_planar_jit`; the device loops capture the step
and its table's sum as one graph, over inputs kept in the graph's
buffers), over a synthetic 2 Msps capture of mixed Mode S traffic at 15 dB,
`DspConfig(block_size=1 << 22, max_detections=256)`, C = 16 blocks:

- `value`: Msps with the input resident on the device, C * REPS blocks per
  call, the sum of the packed table read back per call (2 calls in flight),
  the median of 5 runs (`device_msps_tablefetch`: the whole table read back);
- `streaming_incl_h2d_msps`: the same step with each host int8 batch copied
  to the device and its table copied back per call; the h2d control (a copy
  and an 8-element touch, no demod) measured around the end-to-end run;
- the native framer alone, the parse fan-out, `modes_rx` end to end into
  SQLite, the multi-channel aggregate, 10 Msps (sps 5), the fused
  resample -> int8 -> planar step, and the `PodPipeline` steady state.

Every timed figure keeps the rate of each of its runs (`spread`: minimum,
median, maximum) and the launches of kernels B1 and B2 during it
(`launches`). The capture must decode (DF17 misses <= 0.1%, every DF within
5%, spurious frames <= 2% of the injected, none of them with a clean CRC)
and every figure must pass its own check; on the card every figure that
runs the planar step must have launched B1 and B2. It prints one JSON line
last and exits 1 when a gate fails. `--device cuda` (the default) raises
without a card; nothing falls back to the CPU.

The sizes are the module constants (C, BLOCK, REPS, E2E_BLOCKS, POD_BLOCK);
the tests shrink them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sqlite3
import statistics
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .apps.modes_rx import main as rx_main
from .config import DspConfig
from .decode.parse import parse as parse_cls
from .dist import sharded
from .dist.multihost import PodPipeline
from .dsp import host
from .dsp.pipeline import (DetectionTable, iq_to_device_layout, pack_table,
                           resolve_device, unpack_table)
from .exceptions import ADSBError
from .io import sources
from .io.native_stream import _PlanarSource
from .kernels import preamble as K
from .kernels.opcount import PEAK_F32_INSTR_S, b1_ops_per_sample
from .testing import encoder
from .utils.graphs import graphed

C = 16                 # blocks of the capture (one device row each)
BLOCK = 1 << 22        # samples per block
MAX_DETECTIONS = 256
REPS = 16              # copies of the capture per device call: C * REPS rows
E2E_BLOCKS = 64        # blocks of the uc8 capture through modes_rx
POD_BLOCK = 1 << 24    # samples per PodPipeline step
BASELINE_MSPS = 10.0   # the reference receiver's real-time ceiling on a
#                        desktop CPU, its highest channel rate (BASELINE.md)


@dataclasses.dataclass
class Figure:
    """One figure: its rate in each timed run, whether its check held, what
    it decoded (the hexes, the aircraft rows in SQLite, or the blocks
    framed) out of what was injected (the hexes, the ICAO addresses, or
    the blocks of the capture), and the launches of B1 and B2 while it
    ran. `value` is the median of the runs unless the figure defines
    another statistic (a best-of, a span)."""

    runs: List[float]
    ok: bool = True
    decoded: object = None
    injected: object = None
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    value: Optional[float] = None
    capture_s: float = 0.0

    def __post_init__(self):
        if self.value is None:
            self.value = statistics.median(self.runs)

    @property
    def spread(self) -> List[float]:
        return [min(self.runs), statistics.median(self.runs),
                max(self.runs)]


def _counts() -> Dict[str, int]:
    return {"B1": K.LAUNCHES["detect_cands"],
            "B2": K.LAUNCHES["slice_windows"]}


def _since(before: Dict[str, int]) -> Dict[str, int]:
    """B1 and B2 launches since `before` (a `_counts()`); the CUDA wrappers
    count, the plain versions do not."""
    now = _counts()
    return {k: now[k] - before[k] for k in now}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _say(line: str) -> None:
    print(f"# {line}", file=sys.stderr, flush=True)


def build_capture(cfg: DspConfig, n_blocks: int, msg_rate_hz: float = 100.0,
                  seed: int = 0):
    """Mixed traffic (~60% DF17 and every other supported DF) at ~100 msg/s
    and 15 dB, framed into overlapped blocks and quantized to int8 at a
    peak of 120, as planar (n_blocks, P) I and Q rows; returns (xi, xq,
    truth)."""
    total = n_blocks * cfg.block_size
    duration_s = total / cfg.channel_rate
    n_msgs = max(int(duration_s * msg_rate_hz), 8)
    frames = encoder.random_mixed_frames(n_msgs, seed=seed)
    spacing = total // n_msgs
    iq, truth = encoder.make_capture(
        frames, rate=cfg.channel_rate, snr_db=15.0, spacing=spacing,
        seed=seed, total_samples=total)
    peak = float(np.max(np.abs(iq))) or 1.0
    scale = 120.0 / peak
    p = K.planar_length(cfg)
    xi = np.zeros((n_blocks, p), np.int8)
    xq = np.zeros((n_blocks, p), np.int8)
    for k, (b, _) in enumerate(sources.frame_blocks(iq, cfg)):
        f = iq_to_device_layout(b)
        n = f.shape[0]
        xi[k, :n] = np.clip(np.round(f[:, 0] * scale), -127, 127)
        xq[k, :n] = np.clip(np.round(f[:, 1] * scale), -127, 127)
    return xi, xq, truth


def pick_step(cfg: DspConfig, xi, xq, device="cuda"):
    """The planar step (B1, B2, the tail, the packed table; a captured
    graph on a card) on `device`, and its first call over the capture:
    returns (name, step, table), the table (C, K+1, 9) int32 on the host.
    Nothing else is tried: a step that fails raises."""
    dev = resolve_device(device)

    def step(a, b):
        return K.demod_batch_packed_planar_jit(a, b, cfg, device=dev)

    name = "cuda-planar-i8" if dev.type == "cuda" else "plain-planar-i8"
    out = step(xi, xq).cpu().numpy()
    if out.shape[0] != np.asarray(xi).shape[0]:
        raise RuntimeError(f"the step returned {out.shape[0]} tables for "
                           f"{np.asarray(xi).shape[0]} rows")
    return name, step, out


_STATUS_NAME = {0: "crc_ok", 1: "corrected_1", 2: "corrected_2", 3: "addr"}


def account(arr: np.ndarray, truth, cfg: DspConfig) -> dict:
    """The decode gates' counts over the packed tables of consecutive
    blocks: messages, decoded and missing hexes, per-DF "decoded/injected"
    (DF24's family as one class, as the wire numbers it), spurious hexes
    by table status (each hex once), DF17 misses, and whether each DF
    decoded within 5%."""
    msgs = []
    for i in range(arr.shape[0]):
        msgs.extend(host.table_to_messages(unpack_table(arr[i]),
                                           i * cfg.block_size,
                                           cfg.channel_rate))
    want = {t.hex for t in truth}
    got = {m.split()[1] for m in msgs}
    df_decode: Dict[str, List[int]] = {}
    for t in truth:
        d = df_decode.setdefault(f"df{min(t.df, 24)}", [0, 0])
        d[0] += 1
        d[1] += int(t.hex in got)
    df_ok = all(n_inj - n_dec <= max(1, n_inj // 20)
                for n_inj, n_dec in df_decode.values())
    spurious_by_status: Dict[str, int] = {}
    spurious_hexes = got - want
    for m in msgs:
        parts = m.split()
        if parts[1] in spurious_hexes:
            k = _STATUS_NAME.get(int(parts[3]), str(parts[3]))
            spurious_by_status[k] = spurious_by_status.get(k, 0) + 1
            spurious_hexes.discard(parts[1])
    n17 = [0, 0]
    for t in truth:
        if t.df == 17:
            n17[0] += 1
            n17[1] += int(t.hex not in got)
    return {"msgs": msgs, "want": want, "got": got,
            "missing": len(want - got), "spurious": len(got - want),
            "decoded_by_df": {k: f"{v[1]}/{v[0]}"
                              for k, v in sorted(df_decode.items())},
            "df_ok": df_ok, "spurious_by_status": spurious_by_status,
            "df17_injected": n17[0], "df17_missed": n17[1]}


def _in_flight(call, check, n_runs: int, iters: int, samples: int,
               dev: torch.device):
    """Time n_runs runs of `iters` calls, 2 calls in flight: each call's
    result goes to check(out), which reads it back (so waits for it) once
    the next call is queued, and says whether it is right. Returns (Msps of
    each run at `samples` per call, the number of wrong results)."""
    runs, wrong = [], 0
    for _ in range(n_runs):
        _sync(dev)
        t0 = time.perf_counter()
        inflight = []
        for _ in range(iters):
            inflight.append(call())
            if len(inflight) > 1:
                wrong += not check(inflight.pop(0))
        for o in inflight:
            wrong += not check(o)
        runs.append(iters * samples / (time.perf_counter() - t0) / 1e6)
    return runs, wrong


def _compiled(step, with_sum: bool):
    """step(a, b), and with_sum the sum of its table too, as one compiled
    step (one graph on a card), as the reference jits `t, sum(t)` as one
    program for its device loops."""
    def device_step(a, b, device="cuda"):
        t = step(a, b)
        return (t, torch.sum(t)) if with_sum else t
    return graphed(counters=K.LAUNCH_COUNTERS)(device_step)


def bench_device(step, cfg: DspConfig, xi, xq, table, reps: int,
                 n_runs: int = 5, iters: int = 10, sync_sum: bool = True,
                 device="cuda") -> Figure:
    """The step over the capture resident on the device (in the compiled
    step's input buffers), `reps` copies of it per call, 2 calls in
    flight, `iters` calls per run. sync_sum reads back the sum of each
    call's packed table (the whole table is computed; 4 bytes cross);
    otherwise the whole table comes back each call. The check: every sum
    (every table) equals `reps` copies of `table`, the step's table of one
    copy."""
    dev = resolve_device(device)
    di = torch.from_numpy(np.ascontiguousarray(xi)).to(dev).repeat(reps, 1)
    dq = torch.from_numpy(np.ascontiguousarray(xq)).to(dev).repeat(reps, 1)
    want_table = np.tile(table, (reps, 1, 1))
    want_sum = int(want_table.sum(dtype=np.int64))
    compiled = _compiled(step, sync_sum)
    before = _counts()
    di, dq = compiled.static_inputs(di, dq, device=dev)

    def call():
        out = compiled(di, dq, device=dev)
        return out[1] if sync_sum else out

    def check(out):
        if sync_sum:
            return out.item() == want_sum
        return np.array_equal(out.cpu().numpy(), want_table)

    ok = check(call())            # warm: the allocator sizes itself
    runs, wrong = _in_flight(call, check, n_runs, iters,
                             di.shape[0] * cfg.block_size, dev)
    return Figure(runs, ok=ok and not wrong, launches=_since(before))


def bench_streaming(step, cfg: DspConfig, xi, xq, table, iters: int = 4,
                    n_runs: int = 5, device="cuda") -> Figure:
    """The step over host int8 rows: each call copies the (C, P) planar
    batch host -> device and its packed table device -> host, 2 calls in
    flight. The check: every table equals `table`."""
    dev = resolve_device(device)
    before = _counts()
    runs, wrong = _in_flight(
        lambda: step(xi, xq),
        lambda out: np.array_equal(out.cpu().numpy(), table), n_runs, iters,
        np.asarray(xi).shape[0] * cfg.block_size, dev)
    return Figure(runs, ok=not wrong, launches=_since(before))


def h2d_control(xi, xq, block_size: int, device="cuda") -> Figure:
    """The transport alone: copy the (C, P) int8 batch from pageable host
    memory to the device and read back the sum of 8 elements of each plane,
    3 copies per run, 5 runs (Msps of the batch's blocks; an H100 host
    moved 5.1-7.7 GB/s so). The check: each sum is the host's."""
    dev = resolve_device(device)
    want = int(np.asarray(xi)[0, :8].astype(np.int64).sum()
               + np.asarray(xq)[0, :8].astype(np.int64).sum())

    def touch():
        a = torch.from_numpy(np.ascontiguousarray(xi)).to(dev)
        b = torch.from_numpy(np.ascontiguousarray(xq)).to(dev)
        return a[0, :8].to(torch.int32).sum() + b[0, :8].to(torch.int32).sum()

    def check(out):
        return out.item() == want

    ok = check(touch())
    runs, wrong = _in_flight(touch, check, 5, 3,
                             np.asarray(xi).shape[0] * block_size, dev)
    return Figure(runs, ok=ok and not wrong)


def write_uc8_capture(cfg: DspConfig, path: str, n_blocks: int,
                      seed: int = 1):
    """Write a uc8 (rtl-sdr byte format) capture of mixed traffic, 13
    frames per block at 18 dB; returns the injected ICAO set (the
    AP-overlaid DFs' addresses recovered from their frames)."""
    icaos = set()
    with open(path, "wb") as f:
        for b in range(n_blocks):
            frames = encoder.random_mixed_frames(13, seed=seed * 1000 + b)
            iq, truth = encoder.make_capture(
                frames, rate=cfg.channel_rate, snr_db=18.0,
                spacing=cfg.block_size // 14, seed=seed * 1000 + b,
                total_samples=cfg.block_size)
            icaos |= {encoder.frame_icao(t.frame, t.nbits) for t in truth}
            peak = float(np.max(np.abs(iq))) or 1.0
            x = iq / peak * 0.9
            u = np.empty(2 * cfg.block_size, np.uint8)
            u[0::2] = np.round(x.real * 127.5 + 127.5).astype(np.uint8)
            u[1::2] = np.round(x.imag * 127.5 + 127.5).astype(np.uint8)
            u.tofile(f)
    return icaos


def bench_parse_fanout(cfg: DspConfig, msgs, density_msgs_per_msample: float,
                       n_runs: int = 3):
    """The host decode fan-out: wire strings through the full parse + CPR
    stack, one thread. Returns (Figure in msg/s, ceiling Msps): the
    ceiling converts the median message rate to samples/s at the bench
    traffic's density."""
    wire = list(msgs)
    if not wire:
        return Figure([0.0]), float("inf")
    wire = wire * max(1, 20000 // len(wire))
    runs = []
    for _ in range(n_runs):
        p = parse_cls(my_position=None)
        t0 = time.perf_counter()
        for m in wire:
            try:
                p.parse(m)
            except ADSBError:
                pass
        runs.append(len(wire) / (time.perf_counter() - t0))
    fig = Figure(runs)
    ceiling = fig.value / density_msgs_per_msample
    _say(f"parse fan-out: {fig.value:.0f} msg/s single-threaded "
         f"({len(wire)} msgs, runs {min(runs):.0f}..{max(runs):.0f}) -> "
         f"{ceiling:.0f} Msps ceiling at bench density "
         f"{density_msgs_per_msample:.2f} msg/Msample")
    return fig, ceiling


def bench_host_only(cfg: DspConfig, path: str, n_blocks: int,
                    n_runs: int = 3) -> Figure:
    """The native framer alone: the C++ uc8 read, overlapped framing,
    per-block AGC, int8 quantize and planar split, no device call. The
    value is the best of `n_runs`; the check: every run frames
    `n_blocks` blocks."""
    P = K.planar_length(cfg)
    xi = np.zeros(P, np.int8)
    xq = np.zeros(P, np.int8)
    runs, counts = [], []
    for _ in range(n_runs):
        src = _PlanarSource(cfg, P, path=path, fmt="uc8")
        try:
            n = 0
            t0 = time.perf_counter()
            while src.next_row(xi, xq, scale=None) is not None:
                n += 1
            dt = time.perf_counter() - t0
        finally:
            src.close()
        counts.append(n)
        runs.append(n * cfg.block_size / dt / 1e6)
    fig = Figure(runs, ok=all(n == n_blocks for n in counts),
                 decoded=counts[0], injected=n_blocks, value=max(runs))
    _say(f"host-only native framer: {fig.value:.1f} Msps ({n_blocks} "
         f"blocks, best of {n_runs}; runs {min(runs):.1f}..{max(runs):.1f}),"
         f" blocks framed {counts}")
    return fig


def _aircraft_rows(db: str) -> int:
    con = sqlite3.connect(db)
    try:
        return con.execute("SELECT COUNT(*) FROM aircraft").fetchone()[0]
    finally:
        con.close()


def _timed_rx(args, n_runs: int, samples: int, dev: torch.device):
    """Run modes_rx n_runs times; returns (Msps of each run, exit codes)."""
    runs, rcs = [], []
    for _ in range(n_runs):
        _sync(dev)
        t0 = time.perf_counter()
        rcs.append(rx_main(args))
        _sync(dev)
        runs.append(samples / (time.perf_counter() - t0) / 1e6)
    return runs, rcs


def bench_e2e(cfg: DspConfig, path: str, icaos, n_blocks: int = 32,
              n_runs: int = 3, device="cuda") -> Figure:
    """The product path end to end: `modes_rx --int8` on a uc8 capture
    file (native framer, int8 quantize, batched planar step, wire
    messages, parser, SQLite plugin), batches of 16, after a 2-block
    warm-up run. The check: every run exits 0 and the database holds at
    least 90% of the injected aircraft."""
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="airmodes_bench_") as d:
        db = os.path.join(d, "out.db")
        args = ["-s", path, "--file-format", "uc8", "--int8",
                "--block-size", str(cfg.block_size),
                "--max-detections", str(cfg.max_detections),
                "--batch", "16", "-n", "-d", db, "--stats-interval", "0",
                "--device", str(dev)]
        before = _counts()
        rc0 = rx_main(args + ["--max-blocks", "2"])
        runs, rcs = _timed_rx(args, n_runs, n_blocks * cfg.block_size, dev)
        launches = _since(before)
        n_aircraft = _aircraft_rows(db)
    ok = rc0 == 0 and all(rc == 0 for rc in rcs) and \
        n_aircraft >= int(0.9 * len(icaos))
    fig = Figure(runs, ok=ok, decoded=n_aircraft, injected=set(icaos),
                 launches=launches)
    _say(f"e2e modes_rx: {fig.value:.1f} Msps over {n_blocks} blocks "
         f"(runs {min(runs):.1f}..{max(runs):.1f}), {n_aircraft}/"
         f"{len(icaos)} aircraft in DB, exit {rcs}; B1 {launches['B1']} "
         f"launches, B2 {launches['B2']}")
    return fig


def bench_e2e_multichannel(cfg: DspConfig, n_channels: int = 4,
                           n_blocks: int = 8, seed: int = 3,
                           n_runs: int = 3, device="cuda") -> Figure:
    """The multi-channel aggregate end to end: C uc8 captures through
    `modes_rx` with one -s each (one batched (C, P) device call per step,
    `run_native_channels`), parse and SQLite, after a 1-block warm-up.
    The check: every run exits 0 and the database holds at least 90% of
    the injected aircraft."""
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="airmodes_benchmc_") as d:
        t0 = time.perf_counter()
        icaos = set()
        srcs = []
        for c in range(n_channels):
            p = os.path.join(d, f"ch{c}.uc8")
            icaos |= write_uc8_capture(cfg, p, n_blocks, seed=seed * 100 + c)
            srcs += ["-s", p]
        capture_s = time.perf_counter() - t0
        db = os.path.join(d, "out.db")
        args = srcs + ["--file-format", "uc8", "--int8",
                       "--block-size", str(cfg.block_size),
                       "--max-detections", str(cfg.max_detections),
                       "-n", "-d", db, "--stats-interval", "0",
                       "--device", str(dev)]
        before = _counts()
        rc0 = rx_main(args + ["--max-blocks", "1"])
        runs, rcs = _timed_rx(args, n_runs,
                              n_channels * n_blocks * cfg.block_size, dev)
        launches = _since(before)
        n_aircraft = _aircraft_rows(db)
    ok = rc0 == 0 and all(rc == 0 for rc in rcs) and \
        n_aircraft >= int(0.9 * len(icaos))
    fig = Figure(runs, ok=ok, decoded=n_aircraft, injected=icaos,
                 launches=launches, capture_s=capture_s)
    _say(f"e2e multichannel: {fig.value:.1f} Msps aggregate over "
         f"{n_channels} channels x {n_blocks} blocks (runs "
         f"{min(runs):.1f}..{max(runs):.1f}), {n_aircraft}/{len(icaos)} "
         f"aircraft in DB, exit {rcs}; B1 {launches['B1']} launches, B2 "
         f"{launches['B2']}; captures written in {capture_s:.1f} s")
    return fig


def bench_sps5(n_runs: int = 5, seed: int = 100, block_size: int = 1 << 22,
               channels: int = 4, reps: int = 64, iters: int = 8,
               device="cuda") -> Figure:
    """The reference receiver's top rate, 10 Msps (sps 5): one block of 42
    DF17 frames at 15 dB per channel, decode parity, then the planar step
    over `reps` copies of the channels per call, the sum of the packed
    table read back per call, 2 calls in flight. The check: misses <=
    0.1%, spurious <= 1% of the injected, every sum equal to the first."""
    dev = resolve_device(device)
    cfg5 = DspConfig(channel_rate=10e6, block_size=block_size,
                     max_detections=256)
    P = K.planar_length(cfg5)
    xi = np.zeros((channels, P), np.int8)
    xq = np.zeros((channels, P), np.int8)
    want = set()
    t0 = time.perf_counter()
    for k in range(channels):
        frames = encoder.random_df17_frames(42, seed=seed + k)
        iq, truth = encoder.make_capture(
            frames, rate=10e6, snr_db=15.0, spacing=cfg5.block_size // 43,
            seed=seed + k, total_samples=cfg5.block_size)
        want |= {t.hex for t in truth}
        block, _ = next(sources.frame_blocks(iq, cfg5))
        x2 = np.stack([block.real, block.imag], -1)
        peak = float(np.abs(x2).max()) or 1.0
        b8 = np.clip(np.round(x2 / peak * 120), -127, 127).astype(np.int8)
        pi, pq = K.to_planar_i8(b8, cfg5)
        xi[k], xq[k] = pi[0], pq[0]
    capture_s = time.perf_counter() - t0

    before = _counts()
    arr = K.demod_batch_packed_planar_jit(xi, xq, cfg5,
                                          device=dev).cpu().numpy()
    got = set()
    for k in range(channels):
        for m in host.table_to_messages(unpack_table(arr[k]),
                                        k * cfg5.block_size, 10e6):
            got.add(m.split()[1])
    ok = (len(want - got) <= max(1, len(want) // 1000)
          and len(got - want) <= max(1, len(want) // 100))

    compiled = _compiled(lambda a, b: K.demod_batch_packed_planar_jit(
        a, b, cfg5, device=dev), True)
    di, dq = compiled.static_inputs(
        torch.from_numpy(xi).to(dev).repeat(reps, 1),
        torch.from_numpy(xq).to(dev).repeat(reps, 1), device=dev)

    def call():
        return compiled(di, dq, device=dev)[1]

    first = call().item()
    runs, wrong = _in_flight(call, lambda o: o.item() == first, n_runs,
                             iters, reps * channels * cfg5.block_size, dev)
    launches = _since(before)
    fig = Figure(runs, ok=ok and not wrong, decoded=got, injected=want,
                 launches=launches, capture_s=capture_s)
    _say(f"sps5 (10 Msps): {fig.value:.0f} Msps device (runs "
         f"{min(runs):.0f}..{max(runs):.0f}), decoded {len(got & want)}/"
         f"{len(want)}, spurious {len(got - want)}, sums off {wrong}; "
         f"B1 {launches['B1']} launches, B2 {launches['B2']}")
    return fig


def bench_sharded_resample(seed: int = 55, block_size: int = 1 << 22,
                           channels: int = 16, R: int = 4, iters: int = 4,
                           n_runs: int = 5, device="cuda") -> Figure:
    """The fused sharded resample + demod on a (1, 1) mesh: a 6 Msps
    capture of 24 DF17 frames at 25 dB resampled to 4 Msps (sps 2) by the
    group matmuls, quantized to int8 on the device and demodulated by the
    planar step (B1, B2) on a card; on the CPU the f32 path (the
    full-block demod). Decode parity first, then `channels` copies of the
    capture per application, R applications and the sum of their tables
    per call (one compiled step, as the reference's jitted loop), 2 calls
    in flight (Msps at the channel rate). The check: misses <= 1%, every
    sum equal to the first."""
    dev = resolve_device(device)
    cfgr = DspConfig(channel_rate=4e6, block_size=block_size,
                     max_detections=64)
    p_up, q_dn = 2, 3
    raw_total = cfgr.block_size * q_dn // p_up
    t0 = time.perf_counter()
    frames = encoder.random_df17_frames(24, seed=seed)
    iq_raw, truth = encoder.make_capture(
        frames, rate=6e6, snr_db=25.0, spacing=raw_total // 25, seed=seed,
        total_samples=raw_total)
    capture_s = time.perf_counter() - t0
    planar = dev.type == "cuda"
    gain = float(np.float32(120.0 / (float(np.abs(iq_raw).max()) or 1.0)))
    if planar:
        # planar (1, 2, N) f32, the layout the planar step's front takes
        x1 = torch.from_numpy(
            np.stack([iq_raw.real, iq_raw.imag]).astype(np.float32)[None])
    else:
        x1 = torch.from_numpy(iq_to_device_layout(iq_raw)[None])
    x1 = x1.to(dev)

    def make(n):
        """The fused step over n copies of the capture: a (n, 1) mesh on
        this one device (one planar call over the n channel shards)."""
        mesh = sharded.make_mesh(n_channel=n, n_time=1, device=dev)
        fn = sharded.make_sharded_resample_demod(mesh, cfgr, p_up, q_dn,
                                                 planar=planar)
        return (lambda x, g: fn(x, g)) if planar else (lambda x, g: fn(x))

    before = _counts()
    table = make(1)(x1, gain)
    sub = DetectionTable(*(f.cpu().numpy()[0, 0] for f in table))
    fs = gain / 127.0 if planar else 1.0
    got = {m.split()[1]
           for m in host.table_to_messages(sub, 0, cfgr.channel_rate,
                                           full_scale=fs)}
    want = {t.hex for t in truth}
    ok = len(want - got) <= max(1, len(want) // 100)

    step = make(channels)

    def r_steps(x, g, device="cuda"):
        """R applications of the step and the sum of their packed tables,
        as the reference jits its loop of R applications into one
        program."""
        s = torch.sum(pack_table(step(x, g)))
        for _ in range(R - 1):
            s = s + torch.sum(pack_table(step(x, g)))
        return s

    # one compiled step (one graph on a card, the step's own graph
    # inline), its input resident in the graph's buffers
    compiled = graphed(counters=K.LAUNCH_COUNTERS)(r_steps)
    xn, g = compiled.static_inputs(
        x1.repeat(channels, *(1,) * (x1.ndim - 1)),
        torch.tensor(gain, dtype=torch.float32), device=dev)

    def call():
        return compiled(xn, g, device=dev)

    first = call().item()
    runs, wrong = _in_flight(call, lambda o: o.item() == first, n_runs,
                             iters, R * channels * cfgr.block_size, dev)
    launches = _since(before)
    fig = Figure(runs, ok=ok and not wrong, decoded=got, injected=want,
                 launches=launches, capture_s=capture_s)
    _say(f"fused resample+demod 1x1 (planar={planar}, {channels}-channel "
         f"batch x {R} calls): {fig.value:.0f} Msps (channel rate; runs "
         f"{min(runs):.0f}..{max(runs):.0f}), decoded {len(got & want)}/"
         f"{len(want)}, sums off {wrong}; B1 {launches['B1']} launches,"
         f" B2 {launches['B2']}")
    return fig


def bench_podpipeline(cfg: DspConfig, n_steps: int = 14, seed: int = 2,
                      device="cuda") -> Figure:
    """The streaming pipeline `PodPipeline.run_stream` on a (1, 1) mesh
    (planar int8 on a card, f32 on the CPU): 3 steps for decode parity,
    then one stream of n_steps steps of the same capture, each yield
    stamped. The value is the rate over the interior steps 2 .. n_steps-2
    (no fill, no drain); the runs are each interior step's. The check:
    misses <= 1%."""
    pipe = PodPipeline(cfg, n_channel=1, n_time=1, device=device)
    dev = pipe.mesh.device
    S = pipe.samples_per_step
    t0 = time.perf_counter()
    frames = encoder.random_df17_frames(
        max(int(S / cfg.channel_rate * 100.0), 8), seed=seed)
    iq, truth = encoder.make_capture(
        frames, rate=cfg.channel_rate, snr_db=15.0,
        spacing=S // max(len(frames), 1), seed=seed, total_samples=S)
    capture_s = time.perf_counter() - t0
    peak = float(np.max(np.abs(iq))) or 1.0
    pipe.gain = 120.0 / peak

    def chunks(n):
        # the same step capture n times: the device work is that of fresh
        # traffic, the host memory that of one step
        for _ in range(n):
            yield iq[None]

    before = _counts()
    got = set()
    for msgs in pipe.run_stream(chunks(3)):
        got |= {m.split()[1] for m in msgs}
    want = {t.hex for t in truth}
    ok = len(want - got) <= max(1, len(want) // 100)

    _sync(dev)
    stamps = []
    for _ in pipe.run_stream(chunks(n_steps)):
        stamps.append(time.perf_counter())
    launches = _since(before)
    k0, k1 = 2, n_steps - 2
    runs = [S / (stamps[k + 1] - stamps[k]) / 1e6 for k in range(k0, k1)]
    fig = Figure(runs, ok=ok, decoded=got, injected=want,
                 launches=launches, capture_s=capture_s,
                 value=(k1 - k0) * S / (stamps[k1] - stamps[k0]) / 1e6)
    _say(f"podpipeline 1x1: {fig.value:.1f} Msps steady-state over steps "
         f"{k0}..{k1} of {n_steps} (planar={pipe.planar}, step {S}; steps "
         f"{min(runs):.1f}..{max(runs):.1f}), decoded {len(got & want)}/"
         f"{len(want)}; B1 {launches['B1']} launches, B2 {launches['B2']}")
    return fig


def f32_ops_per_sample(cfg: DspConfig) -> int:
    """f32 instructions kernel B1 needs per sample at cfg's sps and NMS
    half-width (`kernels.opcount`): with the Msps of the step it gives the
    share of the card's f32 instruction rate the detect alone would use.
    A canary, not a roofline: the step is more than B1."""
    return b1_ops_per_sample(cfg.sps, cfg.nms_chips * cfg.sps)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m airmodes_torch.bench",
        description="Demod throughput and decode gates of the port.")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (a card; raises without one) or 'cpu' "
                    "(the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t_wall = time.perf_counter()
    card = None
    build_s = 0.0
    if dev.type == "cuda":
        from .kernels import _ext
        from .probes import smi_line
        card = smi_line()
        build_s = _ext.build_all()
        torch.cuda.reset_peak_memory_stats(dev)
    capture_s = {}

    cfg = DspConfig(block_size=BLOCK, max_detections=MAX_DETECTIONS)
    t0 = time.perf_counter()
    xi, xq, truth = build_capture(cfg, C)
    capture_s["build_capture"] = time.perf_counter() - t0

    before = _counts()
    t0 = time.perf_counter()
    kernel, step, arr0 = pick_step(cfg, xi, xq, device=dev)
    warm_s = time.perf_counter() - t0
    launches = {"warm": _since(before)}
    figs = {}

    # the decode gates' counts: at 15 dB an occasional frame is marginal
    # (the reference misses the same ones), so DF17 keeps a 99.9% bound;
    # the AP-overlaid DFs have no ECC (a bit error mints a wrong-address
    # frame, a missing + spurious pair), so they carry 5% per class and
    # the spurious cap is 2% of the injected; a spurious frame with a
    # clean CRC (noise minting a valid frame) fails the bench
    acc = account(arr0, truth, cfg)
    msgs = acc["msgs"]

    density = len(msgs) / (C * cfg.block_size / 1e6)   # msg per Msample
    parse_fig, parse_ceiling_msps = bench_parse_fanout(cfg, msgs, density)
    figs["parse"] = parse_fig

    figs["device"] = bench_device(step, cfg, xi, xq, arr0, REPS, device=dev)
    figs["tablefetch"] = bench_device(step, cfg, xi, xq, arr0, REPS,
                                      n_runs=3, sync_sum=False, device=dev)
    ops = f32_ops_per_sample(cfg)
    dev_msps = figs["device"].value
    op_share = dev_msps * 1e6 * ops / PEAK_F32_INSTR_S
    figs["streaming"] = bench_streaming(step, cfg, xi, xq, arr0, device=dev)
    figs["h2d"] = h2d_control(xi, xq, cfg.block_size, device=dev)

    figs["sps5"] = bench_sps5(block_size=BLOCK,
                              reps=max(1, REPS * C // 4), device=dev)
    cfg5 = DspConfig(channel_rate=10e6, block_size=BLOCK, max_detections=256)
    ops5 = f32_ops_per_sample(cfg5)
    op_share5 = figs["sps5"].value * 1e6 * ops5 / PEAK_F32_INSTR_S
    figs["fused"] = bench_sharded_resample(block_size=BLOCK, channels=C,
                                           device=dev)

    figs["h2d_pre_pod"] = h2d_control(xi, xq, cfg.block_size, device=dev)
    figs["pod"] = bench_podpipeline(
        DspConfig(block_size=POD_BLOCK, max_detections=1024), device=dev)
    pod_vs_h2d = figs["pod"].value / figs["h2d_pre_pod"].value

    with tempfile.TemporaryDirectory(prefix="airmodes_bench_") as d:
        cap_path = os.path.join(d, "cap.uc8")
        t0 = time.perf_counter()
        cap_icaos = write_uc8_capture(cfg, cap_path, E2E_BLOCKS)
        capture_s["write_uc8_capture"] = time.perf_counter() - t0
        figs["host_only"] = bench_host_only(cfg, cap_path, E2E_BLOCKS)
        figs["e2e"] = bench_e2e(cfg, cap_path, cap_icaos,
                                n_blocks=E2E_BLOCKS, device=dev)
        figs["h2d_post"] = h2d_control(xi, xq, cfg.block_size, device=dev)
    h2d_a, h2d_b = figs["h2d"].value, figs["h2d_post"].value
    h2d_near = (h2d_a + h2d_b) / 2.0
    h2d_agree = min(h2d_a, h2d_b) / max(h2d_a, h2d_b)
    if h2d_agree < 0.85:
        _say(f"h2d warning: the bracketing controls disagree, {h2d_a:.1f} "
             f"vs {h2d_b:.1f} Msps (ratio {h2d_agree:.2f})")
    e2e_vs_h2d = figs["e2e"].value / h2d_near
    product_claim = min(figs["host_only"].value, h2d_near, dev_msps,
                        parse_ceiling_msps)

    figs["multichannel"] = bench_e2e_multichannel(cfg, device=dev)
    capture_s.update({k: figs[k].capture_s
                      for k in ("sps5", "fused", "pod", "multichannel")})

    launches.update({k: figs[k].launches for k in (
        "device", "tablefetch", "streaming", "sps5", "fused", "pod", "e2e",
        "multichannel")})
    gates = {
        "df17_ok": acc["df17_missed"] <= max(1, acc["df17_injected"] // 1000),
        "df_ok": acc["df_ok"],
        "spurious_ok": acc["spurious"] <= max(1, len(acc["want"]) // 50),
        "no_clean_crc_spurious":
            acc["spurious_by_status"].get("crc_ok", 0) == 0,
        "device_ok": figs["device"].ok and figs["tablefetch"].ok,
        "streaming_ok": figs["streaming"].ok,
        "h2d_ok": all(figs[k].ok for k in ("h2d", "h2d_pre_pod",
                                            "h2d_post")),
        "host_only_ok": figs["host_only"].ok,
        "e2e_ok": figs["e2e"].ok, "pod_ok": figs["pod"].ok,
        "sps5_ok": figs["sps5"].ok, "fused_ok": figs["fused"].ok,
        "mc_ok": figs["multichannel"].ok,
        # on the card every planar figure launched B1 and B2
        "launches_ok": dev.type != "cuda" or all(
            n["B1"] > 0 and n["B2"] > 0 for n in launches.values()),
    }
    ok = all(gates.values())
    dev_runs = sorted(figs["device"].runs)
    h2d_runs = figs["h2d"].runs + figs["h2d_post"].runs
    result = {
        "metric": "demod_throughput",
        "value": dev_msps,
        "unit": "Msamples/s/chip",
        "vs_baseline": dev_msps / BASELINE_MSPS,
        "device_msps_runs": dev_runs,
        "device_msps_min": dev_runs[0],
        "device_msps_max": dev_runs[-1],
        "device_msps_tablefetch": figs["tablefetch"].value,
        "f32_op_share_est": op_share,
        "b1_ops_per_sample": ops,
        "streaming_incl_h2d_msps": figs["streaming"].value,
        "podpipeline_msps": figs["pod"].value,
        "podpipeline_vs_h2d": pod_vs_h2d,
        "device_msps_sps5": figs["sps5"].value,
        "f32_op_share_est_sps5": op_share5,
        "b1_ops_per_sample_sps5": ops5,
        "sharded_resample_demod_msps": figs["fused"].value,
        "kernel": kernel,
        "batch_blocks": REPS * C,
        "spurious": acc["spurious"],
        "spurious_by_status": acc["spurious_by_status"],
        "decoded_by_df": acc["decoded_by_df"],
        "host_only_msps": figs["host_only"].value,
        "parse_only_msgs_per_s": parse_fig.value,
        "parse_ceiling_msps": parse_ceiling_msps,
        "e2e_modes_rx_msps": figs["e2e"].value,
        "e2e_multichannel_aggregate_msps": figs["multichannel"].value,
        "h2d_only_msps": h2d_a,
        "h2d_only_msps_post": h2d_b,
        "h2d_runs": h2d_runs,
        "h2d_bracket_agreement": h2d_agree,
        "e2e_vs_h2d": e2e_vs_h2d,
        "product_claim_msps": product_claim,
        "block_size": cfg.block_size,
        "channels": C,
        "warm_s": warm_s,
        "build_s": build_s,
        "capture_s": capture_s,
        "spread": {k: f.spread for k, f in figs.items()},
        "launches": launches,
        "gates": gates,
        "ok": ok,
        "wall_s": time.perf_counter() - t_wall,
        "card": card,
        "device": ({"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                    "count": torch.cuda.device_count()}
                   if dev.type == "cuda" else
                   {"platform": "cpu", "kind": "cpu", "count": 1}),
    }
    _say(f"device={dev} kernel={kernel} warm={warm_s:.2f}s "
         f"build={build_s:.2f}s block={cfg.block_size} C={C} "
         f"stream={figs['streaming'].value:.1f} Msps device={dev_msps:.0f} "
         f"Msps (runs {dev_runs[0]:.0f}..{dev_runs[-1]:.0f}) "
         f"decoded={len(acc['got'])}/{len(acc['want'])} "
         f"missing={acc['missing']} spurious={acc['spurious']} "
         f"by_status={acc['spurious_by_status']} "
         f"by_df={acc['decoded_by_df']} launches={launches} "
         f"failed={[k for k, v in gates.items() if not v]}")
    if dev.type == "cuda":
        _say(f"peak device memory {torch.cuda.max_memory_allocated(dev)} "
             f"bytes (every graph's pool and input buffers included) "
             f"[{card}]")
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
