"""Native-runtime product pipeline: C++ IQ framing -> planar int8 demod on
the card.

The counterpart of `airmodes/io/native_stream.py` (`run_native_pipelined`
for one capture, `run_native_channels` for several, one batched device
call per time step down the channel axis):

- the C++ framer (native/iqstream.cc) reads the capture (or UDP
  datagrams), converts the SDR wire format, frames overlapped blocks,
  quantizes to int8 with per-block AGC (gain = 120/peak) or a fixed gain
  (`scale`) and splits planar I/Q,
  on a FEEDER thread (a thread pool across channels), into page-locked
  host buffers when the target is a card;
- a DISPATCH thread copies each batch into the device step's input
  buffers (non-blocking) and replays `demod_batch_packed_planar_jit`, the
  captured graph of kernels B1 and B2 and the torch tail, with a bounded
  number of batches in flight. A config outside the planar gate (sps > 9,
  a noise window other than 128, a block that is not a multiple of 4096)
  takes the full-block path on the same rows, graphed the same way, as
  the reference does;
- the caller's thread drains each batch's packed (C, K+1, 9) table with
  `io.stream._drain` (the drain of every runner): one `.cpu()`, then
  `unpack_table` and `table_to_messages` per row.

Under a profiler each stage is a span (`utils.profiling.span`):
`airmodes.frame` per block framed (on the thread that frames), with
`airmodes.source_wait` inside it while the source has no block ready;
`airmodes.dispatch` per step on the dispatch thread, with
`airmodes.full_block` inside it around a step outside the planar gate; on
the caller's thread `airmodes.result_wait` on the dispatch queue,
`airmodes.fetch` per `.cpu()` and `airmodes.decode` per block, each closed
before the caller gets the messages.

Host buffers are allocated per batch, as the reference does; page-locked
ones come from PyTorch's caching host allocator, which does not hand a
block out again until the copies recorded on it have finished, so a buffer
is never refilled while its copy is in flight.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, List, Optional

import numpy as np
import torch

from ..config import DspConfig
from ..dsp import host as host_mod
from ..dsp.pipeline import _to_device, demod_batch_packed, resolve_device
from ..kernels.preamble import (demod_batch_packed_planar_jit, planar_length,
                                supported_planar_tile)
from ..utils.graphs import graphed
from ..utils.profiling import span
from .stream import _drain

# The kernels rescale int8 by 1/127: a row quantized as round(f32 * scale)
# has full scale scale/I8_SCALE (1.0 at scale = I8_SCALE), an AGC row
# gain/I8_SCALE
I8_SCALE = 127.0


def native_available() -> bool:
    try:
        from ..native import load
        load()
        return True
    except Exception:
        return False


@graphed(static_argnames=("cfg",))
def _full_block_rows(xi, xq, cfg: DspConfig, device="cuda"):
    """The step outside the planar gate: the (B, T) prefixes of the planar
    rows (T = L+N+R) stacked to (B, T, 2) int8 and run through the
    full-block path, in one captured graph on a card."""
    dev = resolve_device(device)
    T = cfg.left_halo + cfg.block_size + cfg.right_halo
    xb = torch.stack([_to_device(xi, dev)[:, :T],
                      _to_device(xq, dev)[:, :T]], dim=-1)
    return demod_batch_packed(xb, cfg, device=dev)


def _planar_step(cfg: DspConfig, device):
    """(step(xi, xq) -> packed (B, K+1, 9) on the device, planar length P).
    Inside the planar gate: the planar path (kernels B1 and B2). Outside
    it: rows of T = L+N+R samples rounded up to whole 128-sample lines,
    through the full-block path, as the reference's fallback does, one
    span `airmodes.full_block` a step. Both are compiled steps (captured
    graphs on a card)."""
    dev = resolve_device(device)
    if supported_planar_tile(cfg) is not None:
        return (lambda xi, xq: demod_batch_packed_planar_jit(xi, xq, cfg,
                                                             device=dev),
                planar_length(cfg))
    T = cfg.left_halo + cfg.block_size + cfg.right_halo

    def step(xi, xq):
        with span("airmodes.full_block"):
            return _full_block_rows(xi, xq, cfg, device=dev)
    return step, -(-T // 128) * 128


class _PlanarSource:
    """One channel's native framer reading a capture file (or, with no
    path, complex64 UDP datagrams) into planar int8 rows (P is the padded
    row length callers size their buffers to)."""

    def __init__(self, cfg: DspConfig, P: int, *, path: Optional[str] = None,
                 fmt: str = "complex64", udp_host: str = "0.0.0.0",
                 udp_port: int = 10000, start_sample: int = 0,
                 throttle_sps: float = 0.0,
                 ring_samples: Optional[int] = None,
                 udp_timeout_s: float = 0.0):
        # udp_timeout_s <= 0 = never time out (the C++ pump sets no
        # SO_RCVTIMEO; close() shutdown()s the socket to unblock recv)
        from ..native import IQStream
        self.stream = IQStream(cfg, ring_samples=ring_samples)
        if P < self.stream.total:
            raise ValueError(f"planar row length {P} < stream row "
                             f"{self.stream.total}")
        if path is not None:
            self.stream.start_file(path, fmt=fmt,
                                   throttle_sps=throttle_sps,
                                   offset_samples=start_sample)
        else:
            self.stream.start_udp(udp_host, udp_port,
                                  timeout_s=udp_timeout_s)

    @property
    def dropped(self) -> int:
        """Cumulative samples lost to ring overrun (real-time sources)."""
        return self.stream.dropped

    def next_row(self, out_i: np.ndarray, out_q: np.ndarray,
                 scale: Optional[float] = None,
                 stop=None) -> Optional[tuple]:
        """Fill one planar row pair; returns (start_sample, full_scale)
        or None at end of stream. scale=None selects per-block AGC
        (gain = 120/peak, full_scale = gain/127); a float fixes the gain
        (full_scale = scale/127). A set `stop` event ends the wait early
        (returns None) so teardown never races a live native call. One
        span `airmodes.frame` a call."""
        with span("airmodes.frame"):
            if scale is None:
                nxt = self.stream.next_block_planar_agc(
                    out_i, out_q, target=120.0, stop=stop)
                if nxt is None:
                    return None
                start, gain = nxt
                return start, gain / I8_SCALE
            nxt = self.stream.next_block_planar_i8(out_i, out_q,
                                                   scale=scale, stop=stop)
        if nxt is None:
            return None
        return nxt, scale / I8_SCALE

    def close(self) -> None:
        self.stream.close()


def _pipeline(produce, dispatch, depth, on_exit):
    """Generic feeder -> dispatcher -> consumer pipeline.

    produce(stop) is a generator of feed items, run on a FEEDER thread;
    dispatch(item) runs on a DISPATCH thread (device calls only); the
    returned generator yields dispatch results, in order, on the caller's
    thread. Exceptions from either thread re-raise in the caller.
    on_exit(dead) runs at teardown with whether both workers have exited —
    freeing native resources under a live worker is a use-after-free, so
    callers leak them instead when a worker is still inside a long native
    or device call.
    """
    feed_q: queue.Queue = queue.Queue(maxsize=2)
    out_q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()
    sentinel = object()

    def feeder() -> None:
        try:
            for item in produce(stop):
                feed_q.put(item)
        except BaseException as e:
            feed_q.put(e)
        finally:
            feed_q.put(sentinel)

    def dispatcher() -> None:
        try:
            while not stop.is_set():
                item = feed_q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                with span("airmodes.dispatch"):
                    res = dispatch(item)
                out_q.put(res)
        except BaseException as e:  # surface in the consumer
            out_q.put(e)
        finally:
            out_q.put(sentinel)

    fth = threading.Thread(target=feeder, daemon=True,
                           name="airmodes-torch-feeder")
    dth = threading.Thread(target=dispatcher, daemon=True,
                           name="airmodes-torch-dispatch")
    fth.start()
    dth.start()
    try:
        while True:
            with span("airmodes.result_wait"):
                item = out_q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        _drain_until_dead(feed_q, fth)
        try:  # wake a dispatcher whose sentinel was consumed by the drain
            feed_q.put_nowait(sentinel)
        except queue.Full:
            pass
        _drain_until_dead(out_q, dth)
        on_exit(not fth.is_alive() and not dth.is_alive())


def _drain_until_dead(out_q: queue.Queue, th: threading.Thread,
                      deadline_s: float = 10.0) -> None:
    """Unblock a worker stuck in a full-queue put (including the sentinel
    put in its finally) by draining REPEATEDLY while joining — one drain
    is not enough: the unblocked put refills the bounded queue before
    the thread reaches its stop check."""
    deadline = time.time() + deadline_s
    while th.is_alive() and time.time() < deadline:
        try:
            out_q.get_nowait()
        except queue.Empty:
            pass
        th.join(timeout=0.05)


def _host_rows(batch: int, P: int, pinned: bool):
    """Two (batch, P) int8 host arrays, zeroed (padding rows stay silent),
    and the tensors that own their memory."""
    if pinned:
        ti = torch.zeros((batch, P), dtype=torch.int8, pin_memory=True)
        tq = torch.zeros((batch, P), dtype=torch.int8, pin_memory=True)
    else:
        ti = torch.zeros((batch, P), dtype=torch.int8)
        tq = torch.zeros((batch, P), dtype=torch.int8)
    return ti, tq, ti.numpy(), tq.numpy()


def run_native_pipelined(
    cfg: DspConfig,
    *,
    path: Optional[str] = None,
    fmt: str = "complex64",
    udp_host: str = "0.0.0.0",
    udp_port: int = 10000,
    start_sample: int = 0,
    throttle_sps: float = 0.0,
    epoch: float = 0.0,
    stats: Optional[host_mod.BlockStats] = None,
    batch: int = 8,
    depth: int = 2,
    max_blocks: Optional[int] = None,
    scale: Optional[float] = None,
    ring_samples: Optional[int] = None,
    udp_timeout_s: float = 0.0,
    device="cuda",
) -> Iterator[List[str]]:
    """Drive a capture file (or, with no path, complex64 UDP datagrams on
    udp_host:udp_port) through the native framer + planar demod.

    Generator yielding one wire-message list per owned block, in stream
    order, for at most `max_blocks` blocks from sample `start_sample`.
    throttle_sps > 0 paces a file at that many samples per second;
    udp_timeout_s > 0 ends a UDP stream after that much silence (0 never
    does). Runs on the card unless `device` asks for the CPU; with no card
    and the default device it raises before opening the source."""
    step, P = _planar_step(cfg, device)
    pinned = torch.device(device).type == "cuda"
    src = _PlanarSource(cfg, P, path=path, fmt=fmt, udp_host=udp_host,
                        udp_port=udp_port, start_sample=start_sample,
                        throttle_sps=throttle_sps,
                        ring_samples=ring_samples,
                        udp_timeout_s=udp_timeout_s)

    def produce(stop):
        n_done = 0
        while not stop.is_set():
            if max_blocks is not None and n_done >= max_blocks:
                return
            b = batch
            if max_blocks is not None:
                b = min(b, max_blocks - n_done)
            ti, tq, xi, xq = _host_rows(batch, P, pinned)
            rows: List[tuple] = []     # (start_sample, full_scale)
            for j in range(b):
                st = src.next_row(xi[j], xq[j], scale=scale, stop=stop)
                if st is None:
                    break
                rows.append(st)
            if stats is not None:      # overrun gauge (real-time sources)
                stats.ring_dropped = src.dropped
            if not rows:
                return
            yield ti, tq, rows
            n_done += len(rows)
            if len(rows) < b:
                return

    def on_exit(dead: bool) -> None:
        if dead:
            src.close()

    for packed, rows in _pipeline(
            produce, lambda it: (step(it[0], it[1]), it[2]), depth,
            on_exit):
        yield from _drain(packed, rows, cfg, epoch, stats)


def run_native_channels(
    paths: List[str],
    cfg: DspConfig,
    *,
    fmt: str = "complex64",
    start_sample: int = 0,
    epoch: float = 0.0,
    stats: Optional[host_mod.BlockStats] = None,
    depth: int = 2,
    max_blocks: Optional[int] = None,
    scale: Optional[float] = None,
    ring_samples: Optional[int] = None,
    device="cuda",
) -> Iterator[List[Optional[List[str]]]]:
    """Native multi-channel loop: C capture files, one batched device call
    per time step down the channel axis (the native framer per channel,
    the planar kernels B1 and B2, threaded dispatch). Ended channels ride
    along as zero rows until all end, yielding None per dead channel (a
    live channel with no traffic yields []). Runs on the card unless
    `device` asks for the CPU; with no card and the default device it
    raises before opening a source."""
    from concurrent.futures import ThreadPoolExecutor

    step, P = _planar_step(cfg, device)
    pinned = torch.device(device).type == "cuda"
    srcs: List[_PlanarSource] = []
    try:
        for p in paths:
            srcs.append(_PlanarSource(cfg, P, path=p, fmt=fmt,
                                      start_sample=start_sample,
                                      ring_samples=ring_samples))
    except BaseException:
        for s in srcs:
            s.close()
        raise
    C = len(srcs)

    def produce(stop):
        ended = [False] * C
        n_steps = 0
        # per-channel framing (file read + AGC + quantize + planar split)
        # is a C call that releases the GIL, so a pool runs the channels'
        # host work in parallel (within one channel rows are ordered by
        # the stream, so the parallel axis is channels, not rows)
        pool = ThreadPoolExecutor(max_workers=min(C, 8)) if C > 1 else None
        try:
            while not stop.is_set() and not all(ended):
                if max_blocks is not None and n_steps >= max_blocks:
                    return
                ti, tq, xi, xq = _host_rows(C, P, pinned)
                # (start_sample, full_scale) of each live channel's row
                rows: List[Optional[tuple]] = [None] * C

                def fill(c):
                    if ended[c]:
                        return
                    rows[c] = srcs[c].next_row(xi[c], xq[c], scale=scale,
                                               stop=stop)
                    if rows[c] is None:
                        ended[c] = True
                        xi[c] = 0
                        xq[c] = 0

                if pool is None:
                    fill(0)
                else:
                    list(pool.map(fill, range(C)))
                if stats is not None:  # overrun gauge (real-time sources)
                    stats.ring_dropped = sum(s.dropped for s in srcs)
                if all(r is None for r in rows):
                    return
                yield ti, tq, rows
                n_steps += 1
        finally:
            if pool is not None:
                # wait=True is bounded: stop is set (or the streams
                # ended), so in-flight next_row calls leave their retry
                # loops within ~1 ms, and no worker is still inside a C
                # call when on_exit frees the native streams
                pool.shutdown(wait=True)

    def on_exit(dead: bool) -> None:
        if dead:
            for s in srcs:
                s.close()

    for packed, rows in _pipeline(
            produce, lambda it: (step(it[0], it[1]), it[2]), depth,
            on_exit):
        yield list(_drain(packed, rows, cfg, epoch, stats))
