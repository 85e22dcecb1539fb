"""Pipelined host->card streaming runners for framed blocks.

The counterpart of `airmodes/io/stream.py` (`run_pipelined`, `run_channels`):
framed blocks from any source (`io.sources`, `native.IQStream.blocks()`)
go to the card in batches, with a bounded number of device steps in flight,
and come back as wire-message lists in stream order.

Route selection copies the reference as it runs on its accelerator:

- f32 (or int16) blocks: kernel B4 (`demod_batch_packed_fast`), or B3
  (`demod_block_packed_fast`) at batch 1, when `supported_2d_tile(cfg)`
  admits the config;
- int8 batches (`quantize_i8=True`, or int8 sources): the planar path,
  kernels B1 and B2 (`demod_batch_packed_planar`); at batch 1 they take B3;
- otherwise the full-block path without a hand kernel (`demod_block`).

A host batch goes over in a page-locked buffer when the target is a card:
the runners stack each batch straight into one, and an entry holds its
buffer until it is drained, so nothing is refilled in flight. The step
itself never waits on the card; packed tables stay there until the drain
fetches them, one `.cpu()` per entry, in order.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config import DspConfig
from ..dsp import host as host_mod
from ..dsp.pipeline import (demod_batch_packed, demod_block_packed,
                            iq_to_device_layout, resolve_device,
                            unpack_table)
from ..kernels.preamble import (demod_batch_packed_fast,
                                demod_batch_packed_planar,
                                demod_block_packed_fast, supported_2d_tile,
                                supported_planar_tile, to_planar_i8)


def _to_card(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """One host array on `dev`: through a page-locked buffer to a card
    (staged into one unless `x` already lies in one), as it is to the
    CPU."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dev.type != "cuda":
        return t
    if not t.is_pinned():
        t = t.pin_memory()
    return t.to(dev, non_blocking=True)


def _stack_host(parts: List[np.ndarray], pinned: bool):
    """(batch, owner): the host arrays stacked down a new leading axis,
    into page-locked memory when the batch goes to a card, so `_to_card`
    copies it over with no staging copy. `owner` is the tensor that owns
    that memory (None for a plain numpy stack); the runner holds it until
    the entry is drained, when its copy has long finished."""
    if not pinned:
        return np.stack(parts), None
    dtype = torch.from_numpy(np.empty(0, parts[0].dtype)).dtype
    owner = torch.empty((len(parts),) + parts[0].shape, dtype=dtype,
                        pin_memory=True)
    batch = owner.numpy()
    np.stack(parts, out=batch)
    return batch, owner


def _default_step(cfg: DspConfig, device="cuda"):
    """The one-block packed step: x (L+N+R, 2) host array -> (K+1, 9) on
    the device. B3 where its gate admits cfg, else the XLA path."""
    dev = resolve_device(device)
    tile = supported_2d_tile(cfg)
    if tile is not None:
        return lambda x, cfg: demod_block_packed_fast(_to_card(x, dev), cfg,
                                                      tile=tile, device=dev)
    return lambda x, cfg: demod_block_packed(_to_card(x, dev), cfg,
                                             device=dev)


def _batch_step(cfg: DspConfig, device="cuda"):
    """The batched packed step: xb (C, L+N+R, 2) host array -> (C, K+1, 9)
    on the device. int8 batches take the planar path, the others B4, where
    the gates admit cfg; else the XLA path."""
    dev = resolve_device(device)

    def xla(xb, cfg):
        return demod_batch_packed(_to_card(xb, dev), cfg, device=dev)

    if supported_planar_tile(cfg) is None:
        return xla
    f32_tile = supported_2d_tile(cfg)

    def step(xb, cfg):
        if xb.dtype == np.int8:
            # planar split on the host, overlapped with the card's work
            # by the in-flight window
            xi, xq = to_planar_i8(xb, cfg)
            return demod_batch_packed_planar(_to_card(xi, dev),
                                             _to_card(xq, dev), cfg,
                                             device=dev)
        if f32_tile is not None:
            return demod_batch_packed_fast(_to_card(xb, dev), cfg,
                                           tile=f32_tile, device=dev)
        return xla(xb, cfg)
    return step


def _dev_layout(block, quantize_i8: bool):
    """(host array, full_scale): quantization applies a per-block gain of
    120/peak and the kernels rescale int8 by 1/127, so the measured
    ref_level is (gain/127)^2 times the float power; full_scale carries
    that factor to table_to_messages so reported dBFS stays referenced to
    the original float full scale (the native AGC framer applies the
    same rule)."""
    x = iq_to_device_layout(block)
    fs = 1.0
    if quantize_i8 and x.dtype == np.float32:
        # finite-only peak: one corrupt Inf sample would drive the gain to
        # 0 and quantize the whole block to silence
        ax = np.abs(x)
        peak = float(np.max(ax, initial=0.0, where=np.isfinite(ax))) or 1.0
        gain = 120.0 / peak
        x = host_mod.quantize_i8_np(x, gain)
        fs = gain / 127.0
    return x, fs


def _make_drain(cfg, epoch, stats, batched: bool):
    """Entry drainer: entry = (packed table on the device, starts,
    full_scales, n_real, host buffer owner) -> per-block wire-message
    lists (padding rows beyond n_real dropped)."""
    def drain(entry):
        packed, starts, scales, n_real, _ = entry
        arr = packed.cpu().numpy()
        out = []
        for j in range(n_real):
            table = unpack_table(arr[j] if batched else arr)
            out.append(host_mod.table_to_messages(
                table, starts[j], cfg.channel_rate, epoch=epoch,
                stats=stats, full_scale=scales[j]))
        return out
    return drain


def _pump(items, batch: int, depth: int, dispatch, drain):
    """Group `batch` items per dispatch(group) (a trailing partial group is
    the dispatcher's to pad; its entry carries n_real so the drain drops
    the padding), keep `depth` dispatched entries in flight, drain in
    order."""
    inflight: deque = deque()
    acc: List = []
    for item in items:
        acc.append(item)
        if len(acc) == batch:
            inflight.append(dispatch(acc))
            acc = []
            if len(inflight) > depth:
                yield from drain(inflight.popleft())
    if acc:
        inflight.append(dispatch(acc))
    while inflight:
        yield from drain(inflight.popleft())


def run_pipelined(
    blocks: Iterable[Tuple[np.ndarray, int]],
    cfg: DspConfig,
    *,
    epoch: float = 0.0,
    stats: Optional[host_mod.BlockStats] = None,
    depth: int = 2,
    step=None,
    quantize_i8: bool = False,
    batch: int = 1,
    device="cuda",
) -> Iterator[List[str]]:
    """Drive framed blocks through the demod with `depth` steps in flight.

    batch > 1 stacks that many blocks per device call. Yields the
    wire-message list per block, in stream order; a trailing partial batch
    is padded with the last block and the padding's messages dropped.
    Runs on the card unless `device` asks for the CPU; with no card and
    the default device it raises before reading a block. `step(x, cfg)`,
    when given, replaces the route the config selects."""
    pinned = resolve_device(device).type == "cuda"
    if step is None:
        step = (_batch_step(cfg, device) if batch > 1
                else _default_step(cfg, device))
    drain = _make_drain(cfg, epoch, stats, batched=batch > 1)

    if batch == 1:
        def dispatch1(acc):
            (block, start), = acc
            x, fs = _dev_layout(block, quantize_i8)
            return (step(x, cfg), [start], [fs], 1, None)
        yield from _pump(blocks, 1, depth, dispatch1, drain)
        return

    def dispatch(acc):
        # pad a partial batch with the last block's converted form
        devs = [_dev_layout(b, quantize_i8) for b, _ in acc]
        devs += [devs[-1]] * (batch - len(acc))
        xb, owner = _stack_host([d for d, _ in devs], pinned)
        return (step(xb, cfg), [s for _, s in acc],
                [f for _, f in devs], len(acc), owner)

    yield from _pump(blocks, batch, depth, dispatch, drain)


def run_channels(
    channel_blocks: List[Iterable[Tuple[np.ndarray, int]]],
    cfg: DspConfig,
    *,
    epoch: float = 0.0,
    stats: Optional[host_mod.BlockStats] = None,
    depth: int = 2,
    step=None,
    quantize_i8: bool = False,
    device="cuda",
) -> Iterator[List[Optional[List[str]]]]:
    """Concurrent multi-channel demod: C framed block iterators (one per
    SDR channel or capture) batched down the leading axis of one device
    call per time step. Yields one list per step: entry c is channel c's
    wire messages, timestamped by that channel's own sample counter.
    Channels may end at different times; ended channels ride along as
    silence until all end, yielding None (distinct from a live channel's
    empty list). Runs on the card unless `device` asks for the CPU."""
    C = len(channel_blocks)
    if C == 0:
        return
    iters = [iter(cb) for cb in channel_blocks]
    pinned = resolve_device(device).type == "cuda"
    step = step or _batch_step(cfg, device)
    inflight: deque = deque()
    # silence for ended channels, one per live dtype: a complex64 zero
    # block stacked against int8 blocks would upcast the batch to f32,
    # dropping the planar path and the 1/127 dBFS rescale for every channel
    zero_dev: dict = {}

    def drain_one() -> List[Optional[List[str]]]:
        packed, starts, scales, live, _ = inflight.popleft()
        arr = packed.cpu().numpy()
        out: List[Optional[List[str]]] = []
        for c in range(C):
            if not live[c]:
                out.append(None)
                continue
            table = unpack_table(arr[c])
            out.append(host_mod.table_to_messages(
                table, starts[c], cfg.channel_rate, epoch=epoch,
                stats=stats, full_scale=scales[c]))
        return out

    while True:
        items = [next(it, None) for it in iters]
        live = [it is not None for it in items]
        if not any(live):
            break
        devs: List = [None] * C
        for c in range(C):
            if live[c]:
                devs[c] = _dev_layout(items[c][0], quantize_i8)
        ref = next(d for d in devs if d is not None)
        dtypes = {d[0].dtype for d in devs if d is not None}
        if len(dtypes) > 1:
            # np.stack would upcast (int8+int16 -> int16, int8+f32 -> f32),
            # breaking the per-dtype full-scale accounting
            raise ValueError(
                f"run_channels: mixed live-channel dtypes {dtypes}; "
                "give every channel the same sample format/quantization")
        zkey = ref[0].dtype
        if zkey not in zero_dev:
            zero_dev[zkey] = (np.zeros_like(ref[0]), 1.0)
        for c in range(C):
            if devs[c] is None:
                devs[c] = zero_dev[zkey]
        xb, owner = _stack_host([d for d, _ in devs], pinned)
        starts = [items[c][1] if live[c] else 0 for c in range(C)]
        inflight.append((step(xb, cfg), starts,
                         [f for _, f in devs], live, owner))
        if len(inflight) > depth:
            yield drain_one()
    while inflight:
        yield drain_one()
