"""The runners' spans (`utils.profiling.span`) on the CPU: each runner
(`run_native_pipelined`, `run_native_channels`, `run_resampled_fused`,
`run_resampled_fused_channels`, `run_channels`) on a small capture under
`profiling.profiler()`, read back from its Chrome trace. The spans are
named `airmodes.<stage>`:

- `frame` per block framed, on the thread that frames (the feeder of one
  channel, the pool threads of several, the caller's for the runners of
  `io/stream.py`), with `source_wait` inside it while the source has no
  block ready (every framing call of `native.IQStream`);
- `dispatch` per step; `result_wait` per take from the dispatch queue;
- `fetch` per step's `.cpu()`; `decode` per block's table.

None stays open across a `yield`, and with no profiler `span()` is the one
shared no-op context. Skips where there is no C++ toolchain, as
tests/test_native.py does."""

import contextlib
import json
import math
import threading
import time
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch

from airmodes_torch.config import DspConfig
from airmodes_torch.io import native_stream, sources
from airmodes_torch.io.native_stream import (run_native_channels,
                                             run_native_pipelined)
from airmodes_torch.io.stream import (run_channels, run_resampled_fused,
                                      run_resampled_fused_channels)
from airmodes_torch.resample.fused import raw_geometry
from airmodes_torch.testing import encoder
from airmodes_torch.utils import profiling

CFG = DspConfig(block_size=1 << 14, max_detections=32)
BLOCKS = 4
# 6 Msps raw -> 4 Msps, blocks of 2^16 (the fused runners' CPU tests' cfg)
FUSED_CFG = DspConfig(channel_rate=4e6, block_size=1 << 16, max_detections=32)
CONSUMER = "test.consumer"


@pytest.fixture(scope="module")
def native_ok():
    from airmodes_torch import native
    try:
        native.load()
    except native.NativeUnavailable:
        pytest.skip("no C++ toolchain")


@pytest.fixture(scope="module")
def uc8(tmp_path_factory, native_ok):
    """A uc8 capture of mixed traffic over BLOCKS blocks (the last one
    partial), as an RTL-SDR writes it."""
    frames = encoder.random_mixed_frames(14, seed=31)
    iq, _ = encoder.make_capture(frames, rate=2e6, snr_db=20.0,
                                 spacing=3700, seed=31,
                                 total_samples=3 * (1 << 14) + 5000)
    x = iq / float(np.max(np.abs(iq))) * 0.9
    u = np.empty(2 * len(x), np.uint8)
    u[0::2] = np.round(x.real * 127.5 + 127.5).astype(np.uint8)
    u[1::2] = np.round(x.imag * 127.5 + 127.5).astype(np.uint8)
    path = str(tmp_path_factory.mktemp("spans") / "cap.uc8")
    u.tofile(path)
    return path


@pytest.fixture(scope="module")
def c64(tmp_path_factory):
    """A complex64 capture of three raw windows at 6 Msps."""
    _, raw_block, _, _ = raw_geometry(FUSED_CFG, 2, 3)
    frames = encoder.random_df17_frames(9, seed=17)
    iq, _ = encoder.make_capture(frames, rate=6e6, snr_db=18.0,
                                 spacing=3 * raw_block // 10, seed=17,
                                 total_samples=3 * raw_block)
    path = str(tmp_path_factory.mktemp("spans") / "cap.c64")
    iq.astype(np.complex64).tofile(path)
    return path


@pytest.fixture(scope="module")
def c64_short(c64, tmp_path_factory):
    """The first raw window's samples of `c64`: a channel that ends
    before the other."""
    _, raw_block, _, _ = raw_geometry(FUSED_CFG, 2, 3)
    path = str(tmp_path_factory.mktemp("spans") / "short.c64")
    np.fromfile(c64, np.complex64)[:raw_block].tofile(path)
    return path


def _framed_channels():
    """Two channels of framed blocks, for `run_channels`: BLOCKS blocks,
    then 2 (the second ends first)."""
    out = []
    for n, seed in ((BLOCKS, 41), (2, 42)):
        frames = encoder.random_df17_frames(3 * n, seed=seed)
        iq, _ = encoder.make_capture(frames, rate=2e6, snr_db=20.0,
                                     spacing=4000, seed=seed,
                                     total_samples=n * CFG.block_size)
        out.append(sources.frame_blocks(iq, CFG))
    return out


def _consume(gen):
    """The caller's side: each item taken with next(), then a range of the
    caller's own opened around its work between two next() calls."""
    out = []
    while True:
        item = next(gen, None)
        if item is None:
            return out
        with torch.profiler.record_function(CONSUMER):
            out.append(item)
            time.sleep(0.001)


def _traced(run, tmp_path):
    """(what `run()` returned, [(name, tid, start, end)] of the trace's
    ranges) for `run` under the port's profiler."""
    with profiling.profiler() as prof:
        out = run()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [(e["name"], e["tid"], float(e["ts"]),
               float(e["ts"]) + float(e.get("dur", 0.0)))
              for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    return out, ranges


def _spans(ranges, name):
    return [r for r in ranges if r[0] == name]


def _tids(ranges, name):
    return {r[1] for r in _spans(ranges, name)}


def _record_framing_threads(monkeypatch):
    """{native thread id: thread name} of every call of the native framer's
    next_row. Each call first sleeps a little, outside its span, so that a
    pool's threads all take a channel."""
    seen = {}
    real = native_stream._PlanarSource.next_row

    def next_row(self, *a, **kw):
        seen[threading.get_native_id()] = threading.current_thread().name
        time.sleep(0.002)
        return real(self, *a, **kw)
    monkeypatch.setattr(native_stream._PlanarSource, "next_row", next_row)
    return seen


def _consumer_tid(ranges):
    (tid,) = _tids(ranges, CONSUMER)
    return tid


def _check_nesting_and_yields(ranges):
    """Every source_wait lies in a frame of its own thread; no span of the
    caller's thread overlaps the caller's own ranges between next() calls
    (so none stays open across a yield)."""
    frames = defaultdict(list)
    for _, tid, a, b in _spans(ranges, "airmodes.frame"):
        frames[tid].append((a, b))
    eps = 0.01        # the trace's microseconds, rounded to ns
    for _, tid, a, b in _spans(ranges, "airmodes.source_wait"):
        assert any(fa - eps <= a and b <= fb + eps
                   for fa, fb in frames[tid]), (tid, a, b)
    tid = _consumer_tid(ranges)
    mine = [(a, b) for n, t, a, b in ranges if n == CONSUMER]
    for n, t, a, b in ranges:
        if n.startswith("airmodes.") and t == tid:
            assert not any(min(b, cb) - max(a, ca) > eps
                           for ca, cb in mine), (n, a, b)


def test_span_is_off_without_a_profiler():
    """Off the profiler `span()` hands out the one nullcontext made at
    import (a call allocates nothing); inside one, a record_function; and
    kernel_range is a span."""
    off = profiling.span("airmodes.frame")
    assert isinstance(off, contextlib.nullcontext)
    assert profiling.span("airmodes.decode") is off
    assert profiling.kernel_range("B1 detect_cands") is off
    with profiling.profiler():
        assert isinstance(profiling.span("airmodes.frame"),
                          torch.profiler.record_function)
    assert profiling.span("airmodes.frame") is off


def test_a_wait_for_the_source_ends_with_a_block_the_end_or_stop(native_ok):
    """The wait (the span `airmodes.source_wait`) polls the ring's fill and
    ends once it holds a whole block, once the source has ended, or on
    `stop`; the framing call after it then returns at once."""
    from airmodes_torch.native import IQStream

    def waited(s, event, stop=None):
        """Seconds the wait took, `event` run 50 ms into it."""
        timer = threading.Timer(0.05, event)
        t = time.monotonic()
        timer.start()
        s._wait_for_block(stop)
        took = time.monotonic() - t
        timer.join(timeout=5)
        assert not timer.is_alive()
        return took

    s, quiet = IQStream(CFG), IQStream(CFG)
    out_i = np.zeros(s.total, np.int8)
    out_q = np.zeros(s.total, np.int8)
    try:
        s.push(np.zeros(s.block + s.right - 1, np.complex64))
        assert waited(s, lambda: s.push(np.zeros(1, np.complex64))) >= 0.04
        assert s.next_block_planar_agc(out_i, out_q) is not None
        s.push(np.zeros(10, np.complex64))            # less than a block
        assert waited(s, s.set_eof) >= 0.04
        assert waited(s, lambda: None) < 0.04         # ended: no wait
        assert s.next_block_planar_agc(out_i, out_q) is not None  # padded
        assert s.next_block_planar_agc(out_i, out_q) is None
        stop = threading.Event()
        assert waited(quiet, stop.set, stop) >= 0.04
    finally:
        s.close()
        quiet.close()


@pytest.mark.parametrize("call", ["next_block", "next_block_i8",
                                  "next_block_planar_i8",
                                  "next_block_planar_agc"])
def test_every_framing_call_waits_inside_source_wait(native_ok, tmp_path,
                                                     call):
    """Each framing call of `IQStream`, made before a whole block is
    ready, returns the block once it is; the time it waited for it lies
    in one `airmodes.source_wait` span inside the call."""
    from airmodes_torch.native import IQStream
    s = IQStream(CFG)
    args = ((np.zeros(s.total, np.int8), np.zeros(s.total, np.int8))
            if "planar" in call else ())
    timer = threading.Timer(0.05, lambda: s.push(np.zeros(1, np.complex64)))

    def run():
        timer.start()           # after the profiler's own (slow) start
        with torch.profiler.record_function(CONSUMER):
            return getattr(s, call)(*args)
    try:
        s.push(np.zeros(s.block + s.right - 1, np.complex64))
        got, ranges = _traced(run, tmp_path)
        timer.join(timeout=5)
        assert not timer.is_alive()
    finally:
        s.close()
    assert got is not None
    ((_, _, a, b),) = _spans(ranges, CONSUMER)
    ((_, _, wa, wb),) = _spans(ranges, "airmodes.source_wait")
    assert a <= wa and wb <= b
    assert wb - wa >= 40_000                  # the trace's microseconds


@pytest.mark.parametrize("to_end", [False, True])
def test_pipelined_runner_spans(uc8, tmp_path, monkeypatch, to_end):
    """One channel: frame and source_wait on the feeder thread, dispatch on
    the dispatch thread, result_wait, fetch and decode on the caller's.
    A run to the stream's end frames once more, in the call that finds the
    end; a run of max_blocks does not."""
    seen = _record_framing_threads(monkeypatch)
    # paced: the pump reads the capture in one chunk, then holds the end
    # of the stream back ~0.27 s, so the framer waits for the last block
    kw = dict(path=uc8, fmt="uc8", batch=2, device="cpu", throttle_sps=2e5)
    if not to_end:
        kw["max_blocks"] = BLOCKS
    out, ranges = _traced(lambda: _consume(run_native_pipelined(CFG, **kw)),
                          tmp_path)
    assert len(out) == BLOCKS
    n = Counter(r[0] for r in ranges if r[0].startswith("airmodes."))
    steps = math.ceil(BLOCKS / 2)
    assert n["airmodes.frame"] == BLOCKS + to_end
    assert n["airmodes.decode"] == BLOCKS
    assert n["airmodes.dispatch"] == n["airmodes.fetch"] == steps
    assert n["airmodes.result_wait"] == steps + 1      # + the end's take
    assert n["airmodes.source_wait"] > 0
    consumer = _consumer_tid(ranges)
    (feeder,) = _tids(ranges, "airmodes.frame")
    assert seen == {feeder: "airmodes-torch-feeder"}
    (dispatcher,) = _tids(ranges, "airmodes.dispatch")
    assert len({consumer, feeder, dispatcher}) == 3
    for name in ("airmodes.result_wait", "airmodes.fetch",
                 "airmodes.decode"):
        assert _tids(ranges, name) == {consumer}, name
    assert _tids(ranges, "airmodes.source_wait") == {feeder}
    _check_nesting_and_yields(ranges)


@pytest.mark.parametrize("to_end", [False, True])
def test_channel_runner_spans(uc8, tmp_path, monkeypatch, to_end):
    """Two channels: frame on the framer pool's threads, one step per time
    step, a table decoded per live channel-block. A run to the end frames
    once more per channel."""
    seen = _record_framing_threads(monkeypatch)
    kw = dict(fmt="uc8", device="cpu")
    if not to_end:
        kw["max_blocks"] = BLOCKS
    out, ranges = _traced(
        lambda: _consume(run_native_channels([uc8, uc8], CFG, **kw)),
        tmp_path)
    assert len(out) == BLOCKS
    blocks = sum(m is not None for step in out for m in step)
    assert blocks == 2 * BLOCKS
    n = Counter(r[0] for r in ranges if r[0].startswith("airmodes."))
    assert n["airmodes.frame"] == blocks + 2 * to_end
    assert n["airmodes.decode"] == blocks
    assert n["airmodes.dispatch"] == n["airmodes.fetch"] == BLOCKS
    consumer = _consumer_tid(ranges)
    framers = _tids(ranges, "airmodes.frame")
    assert framers == set(seen) and len(framers) == 2
    assert consumer not in framers
    assert all(seen[t].startswith("ThreadPoolExecutor") for t in framers)
    (dispatcher,) = _tids(ranges, "airmodes.dispatch")
    assert dispatcher not in framers | {consumer}
    assert _tids(ranges, "airmodes.decode") == {consumer}
    _check_nesting_and_yields(ranges)


@pytest.mark.parametrize("channels", [1, 2])
def test_fused_runner_spans(c64, c64_short, tmp_path, channels):
    """The fused runners frame on the caller's thread: frame per raw window
    taken (one channel) or per step's windows (two, the second ending
    first), and one for the take that finds the end; source_wait around
    each read of the capture inside it, dispatch and fetch per step,
    decode per block, an ended channel's zero window included (it yields
    None)."""
    if channels == 1:
        out, ranges = _traced(lambda: _consume(run_resampled_fused(
            c64, FUSED_CFG, dtype="complex64", rate_in=6e6, batch=2,
            device="cpu")), tmp_path)
        blocks = len(out)
        steps = math.ceil(blocks / 2)
    else:
        out, ranges = _traced(lambda: _consume(run_resampled_fused_channels(
            [c64, c64_short], FUSED_CFG, dtype="complex64", rate_in=6e6,
            device="cpu")), tmp_path)
        assert all(m is not None for m, _ in out)
        assert out[-1][1] is None                  # the short one ended
        steps = len(out)
        blocks = 2 * steps
    assert blocks >= 3
    n = Counter(r[0] for r in ranges if r[0].startswith("airmodes."))
    assert n["airmodes.frame"] == (blocks if channels == 1 else steps) + 1
    assert n["airmodes.decode"] == blocks
    assert n["airmodes.dispatch"] == n["airmodes.fetch"] == steps
    assert n["airmodes.source_wait"] >= 2      # the reads and the end's
    assert "airmodes.result_wait" not in n     # no dispatch queue here
    consumer = _consumer_tid(ranges)
    for name in n:
        assert _tids(ranges, name) == {consumer}, name
    _check_nesting_and_yields(ranges)


def test_framed_channel_runner_spans(tmp_path):
    """run_channels on framed blocks, on the caller's thread: frame per
    step's blocks taken and one for the take that finds the end, dispatch
    and fetch per step, decode per live channel's block (an ended channel
    is not decoded and yields None)."""
    out, ranges = _traced(lambda: _consume(run_channels(
        _framed_channels(), CFG, quantize_i8=True, device="cpu")), tmp_path)
    assert len(out) == BLOCKS
    assert [m is None for _, m in out] == [False] * 2 + [True] * 2
    n = Counter(r[0] for r in ranges if r[0].startswith("airmodes."))
    assert n["airmodes.frame"] == BLOCKS + 1
    assert n["airmodes.dispatch"] == n["airmodes.fetch"] == BLOCKS
    assert n["airmodes.decode"] == BLOCKS + 2
    assert "airmodes.source_wait" not in n     # the blocks are in memory
    assert "airmodes.result_wait" not in n
    consumer = _consumer_tid(ranges)
    for name in n:
        assert _tids(ranges, name) == {consumer}, name
    _check_nesting_and_yields(ranges)


def test_outputs_unchanged_by_the_spans(uc8, c64, c64_short, tmp_path):
    """Each runner yields the same messages with the profiler recording
    its spans as without one."""
    runs = [
        lambda: list(run_channels(_framed_channels(), CFG, quantize_i8=True,
                                  device="cpu")),
        lambda: list(run_resampled_fused_channels(
            [c64, c64_short], FUSED_CFG, dtype="complex64", rate_in=6e6,
            device="cpu")),
        lambda: list(run_native_pipelined(CFG, path=uc8, fmt="uc8",
                                          batch=2, device="cpu")),
        lambda: list(run_native_channels([uc8, uc8], CFG, fmt="uc8",
                                         device="cpu")),
        lambda: list(run_resampled_fused(c64, FUSED_CFG, dtype="complex64",
                                         rate_in=6e6, batch=2,
                                         device="cpu")),
    ]
    for run in runs:
        plain = run()
        traced, ranges = _traced(run, tmp_path)
        assert traced == plain
        assert any(r[0] == "airmodes.decode" for r in ranges)
        assert _n_messages(plain) > 0


def _n_messages(out):
    """Messages in a runner's output: lists of messages per block, or per
    step a list of them (None for an ended channel)."""
    return sum(len(m) for b in out
               for m in (b if b and not isinstance(b[0], str) else [b])
               if m)
