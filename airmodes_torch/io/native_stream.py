"""Native-runtime product pipeline: C++ IQ framing -> planar int8 demod on
the card.

The counterpart of `airmodes/io/native_stream.py` (`run_native_pipelined`):

- the C++ framer (native/iqstream.cc) reads the capture, converts the SDR
  wire format, frames overlapped blocks, applies per-block AGC
  (gain = 120/peak), quantizes to int8 and splits planar I/Q, on a FEEDER
  thread, into page-locked host buffers when the target is a card;
- a DISPATCH thread copies each batch to the device (non-blocking) and
  launches `demod_batch_packed_planar` (kernels B1 and B2 and the torch
  tail), with a bounded number of batches in flight;
- the caller's thread does one `.cpu()` of the packed (C, K+1, 9) table per
  batch, then `unpack_table` and `table_to_messages`.

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
from ..dsp.pipeline import resolve_device, unpack_table
from ..kernels.preamble import (demod_batch_packed_planar, planar_length,
                                supported_planar_tile)


def _planar_step(cfg: DspConfig, device):
    """(step(xi, xq) -> packed (B, K+1, 9) on the device, planar length P).
    The port has one route: the planar path, on the card or, when the
    caller asks for it, on the CPU."""
    dev = resolve_device(device)
    if supported_planar_tile(cfg) is None:
        raise ValueError(
            "cfg is outside the planar path (noise_window 128, sps <= 9, "
            "block_size a multiple of 4096)")
    return (lambda xi, xq: demod_batch_packed_planar(xi, xq, cfg, device=dev),
            planar_length(cfg))


class _PlanarSource:
    """One channel's native framer reading a capture file into planar int8
    rows (P is the padded row length callers size their buffers to)."""

    def __init__(self, cfg: DspConfig, P: int, *, path: str,
                 fmt: str = "complex64"):
        from ..native import IQStream
        self.stream = IQStream(cfg)
        if P < self.stream.total:
            raise ValueError(f"planar row length {P} < stream row "
                             f"{self.stream.total}")
        self.stream.start_file(path, fmt=fmt)

    def next_row(self, out_i: np.ndarray, out_q: np.ndarray,
                 stop=None) -> Optional[tuple]:
        """Fill one planar row pair with per-block AGC; returns
        (start_sample, full_scale = gain/127) or None at end of stream."""
        nxt = self.stream.next_block_planar_agc(out_i, out_q, target=120.0,
                                                stop=stop)
        if nxt is None:
            return None
        start, gain = nxt
        return start, gain / 127.0

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
                out_q.put(dispatch(item))
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
    path: str,
    fmt: str = "complex64",
    stats: Optional[host_mod.BlockStats] = None,
    batch: int = 8,
    depth: int = 2,
    device="cuda",
) -> Iterator[List[str]]:
    """Drive a capture file through the native framer + planar demod.

    Generator yielding one wire-message list per owned block, in stream
    order. Runs on the card unless `device` asks for the CPU; with no card
    and the default device it raises before opening the source."""
    step, P = _planar_step(cfg, device)
    pinned = torch.device(device).type == "cuda"
    src = _PlanarSource(cfg, P, path=path, fmt=fmt)

    def produce(stop):
        while not stop.is_set():
            ti, tq, xi, xq = _host_rows(batch, P, pinned)
            rows: List[tuple] = []     # (start_sample, full_scale)
            for j in range(batch):
                st = src.next_row(xi[j], xq[j], stop=stop)
                if st is None:
                    break
                rows.append(st)
            if not rows:
                return
            yield ti, tq, rows
            if len(rows) < batch:
                return

    def on_exit(dead: bool) -> None:
        if dead:
            src.close()

    for packed, rows in _pipeline(
            produce, lambda it: (step(it[0], it[1]), it[2]), depth,
            on_exit):
        arr = packed.cpu().numpy()
        for j, (start, fs) in enumerate(rows):
            table = unpack_table(arr[j])
            yield host_mod.table_to_messages(
                table, start, cfg.channel_rate, stats=stats,
                full_scale=fs)
