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

The resampled front end (`run_resampled_fused` and
`run_resampled_fused_channels`, the counterparts of the reference's runners
of those names) reads raw-rate windows of a capture as the file holds its
words (sc16, uc8 or complex64) into page-locked batch buffers, with no
conversion on the host, and runs one fused device step per batch: kernel R1
turns the words into planar f32 windows, then group-matmul resample, device
AGC and int8 quantize, the planar demod (kernels B1 and B2) in the graph of
`resample_demod_packed_planar_jit`, as `resample.fused` sets out.

Each device step is a compiled step (a `*_jit` entry point: one captured
CUDA graph per shape on a card, `utils.graphs`), as the reference's runners
call jitted programs. A host batch goes over in a page-locked buffer when
the target is a card, copied straight into the step's input buffer: the
runners stack each batch into one, and an entry holds its buffer until it
is drained, so nothing is refilled in flight. The step itself never waits
on the card; packed tables stay there until the drain fetches them, one
`.cpu()` per entry, in order.

Every runner here keeps its steps in flight with `_pump`, and every
runner of the port turns a step's packed table into messages with
`_drain`. Under a profiler they name their stages with spans
(`utils.profiling.span`), all on the caller's thread and none open across
a `yield`: `airmodes.frame` around taking each item from the source (a
block, or a step's blocks of every channel; with `airmodes.source_wait`
inside it around each read of the fused runners' captures),
`airmodes.dispatch` per step, `airmodes.fetch` per step's `.cpu()` and
`airmodes.decode` per row's table.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..config import DspConfig
from ..dsp import host as host_mod
from ..resample.fused import (raw_geometry, raw_to_planar,
                              resample_demod_packed_planar_jit)
from ..resample.polyphase import rational_rate
from . import sources as src_mod
from ..dsp.pipeline import (demod_batch_packed_jit, demod_block_packed_jit,
                            iq_to_device_layout, resolve_device,
                            unpack_table)
from ..kernels.preamble import (demod_batch_packed_fast_jit,
                                demod_batch_packed_planar_jit,
                                demod_block_packed_fast_jit,
                                supported_2d_tile, supported_planar_tile,
                                to_planar_i8)
from ..utils.profiling import span


def _host(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """One host array as a tensor, in a page-locked buffer when it goes to
    a card (staged into one unless `x` already lies in one), so the
    step's copy to its input buffer does not block."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dev.type == "cuda" and not t.is_pinned():
        t = t.pin_memory()
    return t


def _stack_host(parts: List[np.ndarray], pinned: bool):
    """(batch, owner): the host arrays stacked down a new leading axis,
    into page-locked memory when the batch goes to a card, so `_host`
    hands it over with no staging copy. `owner` is the tensor that owns
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
        return lambda x, cfg: demod_block_packed_fast_jit(
            _host(x, dev), cfg, tile=tile, device=dev)
    return lambda x, cfg: demod_block_packed_jit(_host(x, dev), cfg,
                                                 device=dev)


def _batch_step(cfg: DspConfig, device="cuda"):
    """The batched packed step: xb (C, L+N+R, 2) host array -> (C, K+1, 9)
    on the device. int8 batches take the planar path, the others B4, where
    the gates admit cfg; else the XLA path."""
    dev = resolve_device(device)

    def xla(xb, cfg):
        return demod_batch_packed_jit(_host(xb, dev), cfg, device=dev)

    if supported_planar_tile(cfg) is None:
        return xla
    f32_tile = supported_2d_tile(cfg)

    def step(xb, cfg):
        if xb.dtype == np.int8:
            # planar split on the host, overlapped with the card's work
            # by the in-flight window
            xi, xq = to_planar_i8(xb, cfg)
            return demod_batch_packed_planar_jit(_host(xi, dev),
                                                 _host(xq, dev), cfg,
                                                 device=dev)
        if f32_tile is not None:
            return demod_batch_packed_fast_jit(_host(xb, dev), cfg,
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


# table rows turned into wire lines, by the native pass
# (`native.WireLines`) and by the Python rule (`dsp.host.table_to_messages`
# on `unpack_table`), which takes the rows the pass does not
WIRE_ROWS = {"native": 0, "python": 0}

# each thread's passes by table size, built on first use and kept (None:
# the library does not load)
_PASSES = threading.local()


def _wire_lines(k: int) -> Optional[native.WireLines]:
    """This thread's native pass for tables of k slots, or None where every
    row takes the Python rule: the library does not load, or a caller has
    put another function in the rule's place (`dsp.host.table_to_messages`:
    a fault injected to check the checks, a recorder), which then sees every
    row. That identity check stays until the benchmark's fault check
    patches the native pass (ROADMAP.md, queue 2, item 8)."""
    if host_mod.table_to_messages is not host_mod.RULE:
        return None
    passes = _PASSES.__dict__
    if k not in passes:
        try:
            passes[k] = native.WireLines(k)
        except native.NativeUnavailable:
            passes[k] = None
    return passes[k]


def _messages(wire, row, start, rate, epoch, fs, stats) -> List[str]:
    """One packed row's wire messages: the native pass where it takes the
    row, else the Python rule; both add the same counts to `stats`."""
    msgs = None if wire is None else wire(row, start, rate, epoch, fs)
    if msgs is None:
        WIRE_ROWS["python"] += 1
        return host_mod.table_to_messages(unpack_table(row), start, rate,
                                          epoch=epoch, full_scale=fs,
                                          stats=stats)
    WIRE_ROWS["native"] += 1
    if stats is not None:
        for name, n in zip(native.WIRE_COUNTS, wire.counts.tolist()):
            setattr(stats, name, getattr(stats, name) + n)
    return msgs


def _drain(packed, rows, cfg, epoch, stats, gains=None):
    """One step's packed (n, K+1, 9) table on the device -> one entry per
    row of `rows`, yielded in order: the row's wire messages, decoded with
    rows[j] = (start, full_scale), or None where rows[j] is None (a row
    not decoded). Table rows past len(rows) (padding) are not read. With
    the fused step's device-AGC `gains`, fetched in the same span, row j's
    full scale is gains[j] / 127 in place of its own. A row's messages come
    from one native pass over its packed table (`_messages`). Spans: one
    `airmodes.fetch` around the step's `.cpu()`, one `airmodes.decode` per
    row decoded, each closed before its entry is yielded. A runner that
    yields a step's rows together takes the list; `run_native_pipelined`
    yields each row before it decodes the next."""
    with span("airmodes.fetch"):
        arr = packed.cpu().numpy()
        gs = None if gains is None else gains.cpu().numpy()
    wire = _wire_lines(arr.shape[1] - 1)
    for j, row in enumerate(rows):
        if row is None:
            yield None
            continue
        start, fs = row
        with span("airmodes.decode"):
            msgs = _messages(
                wire, arr[j], start, cfg.channel_rate, epoch,
                fs if gs is None else float(gs[j]) / 127.0, stats)
        yield msgs


_END = object()


def _pump(items, batch: int, depth: int, dispatch):
    """Group `batch` items per dispatch(group) (a trailing partial group is
    the dispatcher's to pad; its entry's rows are the real ones only),
    keep `depth` dispatched entries in flight, and yield each entry, in
    order, as it leaves the window, for the caller to drain. Spans:
    `airmodes.frame` per item taken (and one for the take that finds the
    end), `airmodes.dispatch` per group."""
    inflight: deque = deque()
    acc: List = []
    items = iter(items)
    while True:
        with span("airmodes.frame"):
            item = next(items, _END)
        if item is _END:
            break
        acc.append(item)
        if len(acc) == batch:
            with span("airmodes.dispatch"):
                inflight.append(dispatch(acc))
            acc = []
            if len(inflight) > depth:
                yield inflight.popleft()
    if acc:
        with span("airmodes.dispatch"):
            inflight.append(dispatch(acc))
    while inflight:
        yield inflight.popleft()


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
    on_messages: Optional[Callable[[List[str]], None]] = None,
    device="cuda",
) -> Iterator[List[str]]:
    """Drive framed blocks through the demod with `depth` steps in flight.

    batch > 1 stacks that many blocks per device call. Yields the
    wire-message list per block, in stream order, and hands each to
    `on_messages` when given; a trailing partial batch is padded with the
    last block and the padding's messages dropped. Runs on the card
    unless `device` asks for the CPU; with no card and the default device
    it raises before reading a block. `step(x, cfg)`, when given, replaces
    the route the config selects."""
    pinned = resolve_device(device).type == "cuda"
    if step is None:
        step = (_batch_step(cfg, device) if batch > 1
                else _default_step(cfg, device))

    def dispatch(acc):
        devs = [_dev_layout(b, quantize_i8) for b, _ in acc]
        rows = [(s, fs) for (_, s), (_, fs) in zip(acc, devs)]
        if batch == 1:
            # the one-block step's (K+1, 9) table, viewed as one row
            return step(devs[0][0], cfg)[None], rows, None
        # pad a partial batch with the last block's converted form
        devs += [devs[-1]] * (batch - len(acc))
        xb, owner = _stack_host([d for d, _ in devs], pinned)
        return step(xb, cfg), rows, owner

    for packed, rows, _owner in _pump(blocks, batch, depth, dispatch):
        for msgs in list(_drain(packed, rows, cfg, epoch, stats)):
            if on_messages:
                on_messages(msgs)
            yield msgs


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
    # silence for ended channels, one per live dtype: a complex64 zero
    # block stacked against int8 blocks would upcast the batch to f32,
    # dropping the planar path and the 1/127 dBFS rescale for every channel
    zeros: dict = {}

    def steps():
        while True:
            items = [next(it, None) for it in iters]
            if all(it is None for it in items):
                return
            yield items

    def dispatch(acc):
        (items,) = acc
        devs = [None if it is None else _dev_layout(it[0], quantize_i8)
                for it in items]
        dtypes = {d[0].dtype for d in devs if d is not None}
        if len(dtypes) > 1:
            # np.stack would upcast (int8+int16 -> int16, int8+f32 -> f32),
            # breaking the per-dtype full-scale accounting
            raise ValueError(
                f"run_channels: mixed live-channel dtypes {dtypes}; "
                "give every channel the same sample format/quantization")
        ref = next(d[0] for d in devs if d is not None)
        if ref.dtype not in zeros:
            zeros[ref.dtype] = np.zeros_like(ref)
        xb, owner = _stack_host(
            [zeros[ref.dtype] if d is None else d[0] for d in devs], pinned)
        rows = [None if it is None else (it[1], d[1])
                for it, d in zip(items, devs)]
        return step(xb, cfg), rows, owner

    for packed, rows, _owner in _pump(steps(), 1, depth, dispatch):
        yield list(_drain(packed, rows, cfg, epoch, stats))


# --- the resampled front end: a capture's words -> fused device step --------

class _RawReader:
    """One capture's raw-rate windows, read as the file holds its words
    (`io.sources.WIRE_FORMATS`) straight into the caller's rows.

    Window k holds the raw samples [k*block - left, k*block + block + right)
    from the seek point, zero outside the capture: the windows that
    `io.sources.buffered_framer` frames with the fused geometry, its
    flush's zero-padded tail windows included (one per block that owns a
    sample), without a complex64 conversion. `take` fills one window's
    (W, 2) rows: the left + right samples it shares with the previous
    window from a carry, the rest from the file on an unbuffered handle,
    read in a loop with `airmodes.source_wait` around each read; a read
    that returns nothing ends the capture, a trailing partial sample is
    dropped. The rows outside the capture are not written: `take` names
    the range of those that hold its samples, and the fused step writes
    0.0 elsewhere (kernel R1; a uc8 word cannot stand for 0.0)."""

    def __init__(self, path: str, dtype: str, in_skip: int, geometry):
        if dtype not in src_mod.WIRE_FORMATS:
            raise ValueError(f"unknown file dtype {dtype}")
        word = np.empty(0, src_mod.WIRE_FORMATS[dtype][0])
        self.wire = torch.from_numpy(word).dtype
        self._bps = 2 * word.itemsize
        self._path, self._skip = path, in_skip
        self.left, self.block, self.right = geometry
        self._f = None
        self._carry = None          # the next window's first left + right
        self._read = 0              # whole samples read
        self._eof = False
        self._taken = 0

    def take(self, row: np.ndarray) -> Optional[Tuple[int, int, int]]:
        """Fill `row` with the next window: (its raw start, the range
        [lo, hi) of the rows that hold capture samples), or None once the
        capture has no further sample."""
        left, block, right = self.left, self.block, self.right
        if self._f is None:
            self._f = open(self._path, "rb", buffering=0)
            if self._skip:
                self._f.seek(self._skip * self._bps)
            self._fill(row[left:])
        else:
            row[:left + right] = self._carry
            self._fill(row[left + right:])
        start = self._taken * block
        if self._read <= start:
            self.close()
            return None
        self._carry = row[block: block + left + right].copy()
        self._taken += 1
        return (start, left if start == 0 else 0,
                min(len(row), self._read - start + left))

    def _fill(self, out: np.ndarray) -> None:
        mem = memoryview(out).cast("B")
        pos = 0
        while pos < len(mem) and not self._eof:
            with span("airmodes.source_wait"):
                got = self._f.readinto(mem[pos:])
            if got:
                pos += got
            else:
                self._eof = True
        self._read += pos // self._bps

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._eof = True


def _raw_windows(reader: _RawReader, batch: int, max_blocks, pinned: bool):
    """One capture's windows for `_pump`: (batch buffer, raw start, valid
    range) per window. The buffer of a batch is one page-locked (n, 2)
    tensor of the file's words holding the contiguous raw span that its
    `batch` overlapping windows cover, n = (batch - 1) * block + W: window
    j is rows [j*block, j*block + W), so each raw sample is read once and
    only the left + right halo is carried into the next batch's buffer."""
    block = reader.block
    width = reader.left + block + reader.right
    n = (batch - 1) * block + width
    taken = 0
    try:
        while max_blocks is None or taken < max_blocks:
            j = taken % batch
            if j == 0:
                owner = torch.empty((n, 2), dtype=reader.wire,
                                    pin_memory=pinned)
                buf = owner.numpy()
            got = reader.take(buf[j * block: j * block + width])
            if got is None:
                return
            taken += 1
            yield owner, got[0], got[1:]
    finally:
        reader.close()


def _channel_windows(readers: List[_RawReader], max_blocks, pinned: bool):
    """Several captures' windows, one step at a time: (buffer, valid
    ranges, raw starts, live) per step while a channel has a window. The
    buffer is one page-locked (C * W, 2) tensor of the files' words with
    channel c's window in rows [c*W, (c+1)*W), the valid ranges a
    page-locked (C, 2) int32 tensor; an ended channel's range is empty,
    its start 0 and its `live` entry False from then on."""
    C = len(readers)
    width = readers[0].left + readers[0].block + readers[0].right
    live = [True] * C
    k = 0
    try:
        while max_blocks is None or k < max_blocks:
            owner = torch.empty((C * width, 2), dtype=readers[0].wire,
                                pin_memory=pinned)
            valid = torch.zeros((C, 2), dtype=torch.int32,
                                pin_memory=pinned)
            buf, rng = owner.numpy(), valid.numpy()
            raw_starts = [0] * C
            for c, rd in enumerate(readers):
                got = rd.take(buf[c * width: (c + 1) * width]) \
                    if live[c] else None
                if got is None:
                    live[c] = False
                else:
                    raw_starts[c] = got[0]
                    rng[c] = got[1:]
            if not any(live):
                return
            yield owner, valid, raw_starts, list(live)
            k += 1
    finally:
        for rd in readers:
            rd.close()


def _raw_step(cfg, p: int, q: int, stride: int, dev: torch.device):
    """The fused runners' step on a batch buffer of a capture's words and
    its (C, 2) valid ranges: kernel R1's planar windows (its plain version
    on the CPU) through the fused step's graph. Returns the step's
    ((C, K+1, 9) packed table, (C,) gains)."""
    width = sum(raw_geometry(cfg, p, q)[:3])

    def step(raw, valid, gain):
        x = raw_to_planar(raw.to(dev, non_blocking=True),
                          valid.to(dev, non_blocking=True), width, stride)
        return resample_demod_packed_planar_jit(x, gain, cfg, p, q,
                                                device=dev)
    return step


def _fused_setup(cfg, rate_in, start_sample):
    """(p, q, raw geometry, snapped start, raw seek) of a fused run.

    The raw-domain equivalent of start_sample must be an integer raw
    sample: flooring a fractional seek would shift the resampler grid by a
    fraction of a sample against the reported counters (~83 ns of
    permanent timestamp skew at 4 Msps). So the start snaps down to a
    multiple of p; messages before the requested start are dropped
    (`_resume_filter`)."""
    p_up, q_dn = rational_rate(rate_in, cfg.channel_rate)
    geometry = raw_geometry(cfg, p_up, q_dn)[:3]
    start = start_sample - start_sample % p_up
    return p_up, q_dn, geometry, start, start * q_dn // p_up


def _resume_filter(cfg, epoch: float, req_start: int):
    """keep(msgs, start): a fused row's messages, less those before the
    requested resume point when the row starts before it (possible only in
    a snapped first window, `_fused_setup`)."""
    epoch_ns = int(round(epoch * 1e9))
    irate = int(cfg.channel_rate)

    def _sample_of(m: str) -> int:
        # the message's global sample index from the wire's int64-ns
        # field, relative to the epoch: ns = epoch_ns + samples*1e9//rate,
        # so rounding (ns-epoch_ns)*rate/1e9 recovers samples exactly for
        # any integral rate < 1 GHz (the float seconds field sits near
        # 2^53 at a real epoch and lets every message through)
        ns = int(m.split()[6])
        return ((ns - epoch_ns) * irate + 500_000_000) // 1_000_000_000

    def keep(msgs: List[str], start: int) -> List[str]:
        if start >= req_start:
            return msgs
        return [m for m in msgs if _sample_of(m) >= req_start]
    return keep


def run_resampled_fused(
    path: str,
    cfg: DspConfig,
    *,
    dtype: str,
    rate_in: float,
    start_sample: int = 0,
    epoch: float = 0.0,
    stats: Optional[host_mod.BlockStats] = None,
    depth: int = 2,
    batch: int = 1,
    scale: Optional[float] = None,
    max_blocks: Optional[int] = None,
    on_messages: Optional[Callable[[List[str]], None]] = None,
    device="cuda",
) -> Iterator[List[str]]:
    """The resampled front end of one capture on the card: the capture's
    words, read into one page-locked buffer per batch of raw-rate windows
    (resample.fused.raw_geometry; `_raw_windows`) -> one fused device step
    per batch (kernel R1's planar windows, group-matmul resample, device
    AGC or the fixed gain `scale`, int8 quantize, the planar demod with
    kernels B1 and B2) -> wire messages. Yields the wire-message list per
    block, in stream order, and hands each to `on_messages` when given; a
    partial last batch is padded with zero windows. start_sample is in
    channel-rate samples. Runs on the card unless `device` asks for the
    CPU; with no card and the default device it raises before opening the
    capture."""
    dev = resolve_device(device)
    pinned = dev.type == "cuda"
    p_up, q_dn, geometry, start, in_skip = _fused_setup(cfg, rate_in,
                                                         start_sample)
    gain = None if scale is None else np.float32(scale)
    block = geometry[1]
    step = _raw_step(cfg, p_up, q_dn, block, dev)

    def dispatch(acc):
        buf = acc[0][0]
        # rows past the last real window: an empty range (zeros), their
        # tables not read
        valid = torch.zeros((batch, 2), dtype=torch.int32, pin_memory=pinned)
        valid.numpy()[:len(acc)] = [r for _, _, r in acc]
        # raw start k*raw_block -> channel-rate start + k*block
        rows = [(start + s * p_up // q_dn, None) for _, s, _ in acc]
        return step(buf, valid, gain), rows, (buf, valid)

    keep = _resume_filter(cfg, epoch, start_sample)
    reader = _RawReader(path, dtype, in_skip, geometry)
    for (packed, gains), rows, _bufs in _pump(
            _raw_windows(reader, batch, max_blocks, pinned), batch, depth,
            dispatch):
        for (s, _), msgs in zip(rows, list(_drain(packed, rows, cfg, epoch,
                                                  stats, gains))):
            msgs = keep(msgs, s)
            if on_messages:
                on_messages(msgs)
            yield msgs


def run_resampled_fused_channels(
    paths: List[str],
    cfg: DspConfig,
    *,
    dtype: str,
    rate_in: float,
    start_sample: int = 0,
    epoch: float = 0.0,
    stats: Optional[host_mod.BlockStats] = None,
    depth: int = 2,
    scale: Optional[float] = None,
    max_blocks: Optional[int] = None,
    device="cuda",
) -> Iterator[List[Optional[List[str]]]]:
    """Multi-channel twin of run_resampled_fused: C raw-rate captures, one
    batched fused device step per time step down the channel axis (row c
    of a step's buffer holds channel c's window, as its file's words).
    Yields one list per step; ended channels ride along as zero windows
    and yield None (the run_channels contract). Runs on the card unless
    `device` asks for the CPU."""
    dev = resolve_device(device)
    pinned = dev.type == "cuda"
    p_up, q_dn, geometry, start, in_skip = _fused_setup(cfg, rate_in,
                                                         start_sample)
    C = len(paths)
    if C == 0:
        return
    gain = None if scale is None else np.float32(scale)
    step = _raw_step(cfg, p_up, q_dn, sum(geometry), dev)

    def dispatch(acc):
        ((owner, valid, raw_starts, live),) = acc
        rows = [(start + s * p_up // q_dn, None) for s in raw_starts]
        return step(owner, valid, gain), rows, live, (owner, valid)

    keep = _resume_filter(cfg, epoch, start_sample)
    steps = _channel_windows([_RawReader(p, dtype, in_skip, geometry)
                              for p in paths], max_blocks, pinned)
    try:
        # an ended channel's zero window is decoded (BlockStats counts it,
        # as the reference's runner does) and yields None
        for (packed, gains), rows, live, _bufs in _pump(steps, 1, depth,
                                                         dispatch):
            msgs = _drain(packed, rows, cfg, epoch, stats, gains)
            yield [keep(m, s) if on else None
                   for (s, _), m, on in zip(rows, msgs, live)]
    finally:
        steps.close()
