"""The port's native runners (C++ framer -> planar demod, or the full-block
path outside the planar gate) against the JAX package's, on small capture
files: `run_native_pipelined` with each of its options, and
`run_native_channels`. Messages are compared exactly, string for string.
Skips where there is no C++ toolchain, as tests/test_native.py does."""

import dataclasses

import numpy as np
import pytest
import torch

from airmodes.config import DspConfig as JaxCfg
from airmodes.testing import encoder
from airmodes_torch.config import DspConfig

KW = dict(block_size=1 << 14, max_detections=32)


@pytest.fixture(scope="module")
def native_ok():
    from airmodes_torch import native
    try:
        native.load()
    except native.NativeUnavailable:
        pytest.skip("no C++ toolchain")


def _write_uc8(path, iq):
    """Offset-binary uc8 at 0.9 of full scale, as an RTL-SDR writes it."""
    peak = float(np.max(np.abs(iq))) or 1.0
    x = iq / peak * 0.9
    u = np.empty(2 * len(x), np.uint8)
    u[0::2] = np.round(x.real * 127.5 + 127.5).astype(np.uint8)
    u[1::2] = np.round(x.imag * 127.5 + 127.5).astype(np.uint8)
    u.tofile(path)
    return path


def _write_sc16(path, iq):
    """Interleaved int16 I/Q at 0.9 of full scale, as a USRP writes sc16."""
    peak = float(np.max(np.abs(iq))) or 1.0
    x = iq / peak * 0.9
    s = np.empty(2 * len(x), np.int16)
    s[0::2] = np.round(x.real * 32767).astype(np.int16)
    s[1::2] = np.round(x.imag * 32767).astype(np.int16)
    s.tofile(path)
    return path


def _write_capture(path, n_frames, seed, total, rate=2e6, spacing=3700,
                   fmt="uc8"):
    frames = encoder.random_mixed_frames(n_frames, seed=seed)
    iq, truth = encoder.make_capture(frames, rate=rate, snr_db=20.0,
                                     spacing=spacing, seed=seed,
                                     total_samples=total)
    write = _write_sc16 if fmt == "sc16" else _write_uc8
    return write(path, iq), truth


@pytest.fixture(scope="module")
def capture(tmp_path_factory, native_ok):
    """A uc8 capture of mixed traffic over 3+ blocks, and its truth."""
    return _write_capture(str(tmp_path_factory.mktemp("cap") / "cap.uc8"),
                          14, 31, 3 * (1 << 14) + 5000)


def _cfgs(**kw):
    jc = JaxCfg(**kw)
    return jc, DspConfig.from_dict(dataclasses.asdict(jc))


def _flat(blocks):
    return [m for b in blocks for m in b]


def _key(msgs):
    return [(m.split()[0], m.split()[1], m.split()[3]) for m in msgs]


def test_runner_matches_reference_on_cpu(capture):
    from airmodes.io.native_stream import run_native_pipelined as jax_run
    from airmodes_torch.dsp.host import BlockStats
    from airmodes_torch.io.native_stream import run_native_pipelined
    path, truth = capture
    want = [m for b in jax_run(JaxCfg(**KW), path=path, fmt="uc8", batch=2)
            for m in b]
    stats = BlockStats()
    got_blocks = list(run_native_pipelined(DspConfig(**KW), path=path,
                                           fmt="uc8", batch=2, stats=stats,
                                           device="cpu"))
    got = [m for b in got_blocks for m in b]
    assert len(got_blocks) == 4
    assert _key(got) == _key(want)
    assert {t.hex for t in truth} <= {m.split()[1] for m in got}
    assert stats.emitted == len(got) and stats.preambles >= len(truth)


def test_runner_stops_early_and_cleans_up(capture):
    import threading
    from airmodes_torch.io.native_stream import run_native_pipelined
    path, _ = capture
    before = threading.active_count()
    gen = run_native_pipelined(DspConfig(**KW), path=path, fmt="uc8",
                               batch=1, device="cpu")
    next(gen)
    gen.close()
    assert threading.active_count() <= before


def test_runner_needs_a_card_by_default(capture):
    """With no card and the default device, the runner raises instead of
    running on the CPU."""
    from airmodes_torch.io.native_stream import run_native_pipelined
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    path, _ = capture
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(run_native_pipelined(DspConfig(**KW), path=path, fmt="uc8"))


# --- C1: configs outside the planar gate take the full-block path -----------

@pytest.mark.parametrize("kw,rate,spacing,fmt", [
    (dict(channel_rate=20e6, block_size=1 << 15), 20e6, 6000, "uc8"),
    (dict(noise_window=256, block_size=1 << 14), 2e6, 3700, "uc8"),
    (dict(block_size=5 * 1024), 2e6, 1700, "uc8"),
    (dict(channel_rate=20e6, block_size=1 << 15), 20e6, 6000, "sc16"),
], ids=["sps10", "noise_window256", "block5x1024", "sps10_sc16"])
def test_runner_outside_planar_gate_matches_reference(tmp_path, native_ok,
                                                       kw, rate, spacing,
                                                       fmt):
    """A config that the planar gate refuses runs through the full-block
    path on the stacked int8 rows, as the reference's runner does: the
    same messages, string for string, in the same order. At 20 Msps from
    rtl-sdr uc8 and from USRP sc16 samples."""
    from airmodes.io.native_stream import run_native_pipelined as jax_run
    from airmodes_torch.io.native_stream import run_native_pipelined
    from airmodes_torch.kernels.preamble import supported_planar_tile
    jc, tc = _cfgs(max_detections=32, **kw)
    assert supported_planar_tile(tc) is None
    path, truth = _write_capture(str(tmp_path / f"c.{fmt}"), 12, 41,
                                 3 * tc.block_size + 5000, rate=rate,
                                 spacing=spacing, fmt=fmt)
    want = _flat(jax_run(jc, path=path, fmt=fmt, batch=2))
    got = _flat(run_native_pipelined(tc, path=path, fmt=fmt, batch=2,
                                     device="cpu"))
    assert got == want
    assert {t.hex for t in truth} <= {m.split()[1] for m in got}


# --- run_native_pipelined's options against the reference ------------------

def _run_both(path, kw, **opts):
    """Both runners over `path` with the same options: (want, got,
    reference stats, port stats)."""
    from airmodes.dsp.host import BlockStats as JaxStats
    from airmodes.io.native_stream import run_native_pipelined as jax_run
    from airmodes_torch.dsp.host import BlockStats
    from airmodes_torch.io.native_stream import run_native_pipelined
    jc, tc = _cfgs(**kw)
    js, ts = JaxStats(), BlockStats()
    want = list(jax_run(jc, path=path, fmt="uc8", batch=2, stats=js, **opts))
    got = list(run_native_pipelined(tc, path=path, fmt="uc8", batch=2,
                                    stats=ts, device="cpu", **opts))
    return want, got, js, ts


@pytest.mark.parametrize("opts", [
    dict(start_sample=7000),
    dict(max_blocks=3),
    dict(max_blocks=1),
    dict(scale=64.0),
    dict(epoch=1.7e9),
    dict(ring_samples=1 << 15),
], ids=["start_sample", "max_blocks3", "max_blocks1", "scale", "epoch",
        "ring_samples"])
def test_runner_option_matches_reference(capture, opts):
    """Each restored option, set alike on both runners: the same blocks,
    the same messages (timestamps and levels included) and the same
    counters, ring_dropped among them."""
    path, _ = capture
    want, got, js, ts = _run_both(path, KW, **opts)
    assert len(got) == len(want)
    assert got == want
    assert sum(len(b) for b in got) > 0
    assert ts.ring_dropped == js.ring_dropped == 0
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    if "max_blocks" in opts:
        assert len(got) == opts["max_blocks"]
    if "epoch" in opts:
        assert all(float(m.split()[5]) > opts["epoch"] for b in got
                   for m in b)


def test_runner_options_change_the_output(capture):
    """The options are not ignored: a later start sample shifts every
    timestamp's block origin, a fixed gain changes the levels, an epoch
    offsets the timestamps."""
    path, _ = capture
    _, base, _, _ = _run_both(path, KW)
    _, start, _, _ = _run_both(path, KW, start_sample=7000)
    _, scaled, _, _ = _run_both(path, KW, scale=64.0)
    _, shifted, _, _ = _run_both(path, KW, epoch=100.0)
    assert _flat(start) != _flat(base)
    assert [m.split()[4] for m in _flat(scaled)] != \
        [m.split()[4] for m in _flat(base)]
    assert [float(m.split()[5]) - 100.0 for m in _flat(shifted)] == \
        pytest.approx([float(m.split()[5]) for m in _flat(base)])


def test_runner_ring_samples_check_matches_reference(capture):
    """A ring too small to ever hold a frame is refused by both runners
    before they start."""
    from airmodes.io.native_stream import run_native_pipelined as jax_run
    from airmodes_torch.io.native_stream import run_native_pipelined
    path, _ = capture
    jc, tc = _cfgs(**KW)
    small = tc.block_size
    with pytest.raises(ValueError, match="ring_samples"):
        next(jax_run(jc, path=path, fmt="uc8", ring_samples=small))
    with pytest.raises(ValueError, match="ring_samples"):
        next(run_native_pipelined(tc, path=path, fmt="uc8",
                                  ring_samples=small, device="cpu"))


def test_ring_dropped_gauge_follows_the_stream(native_ok):
    """`dropped` reads the framer's overrun counter, which a file stream
    never raises; the port's IQStream pushes, ends and counts like the
    reference's."""
    from airmodes import native as jnative
    from airmodes_torch import native
    jc, tc = _cfgs(**KW)
    rng = np.random.default_rng(5)
    iq = ((rng.standard_normal(2 * tc.block_size + 999)
           + 1j * rng.standard_normal(2 * tc.block_size + 999)) * 0.1
          ).astype(np.complex64)
    T = tc.left_halo + tc.block_size + tc.right_halo
    rows = {}
    for name, mod, cfg in (("jax", jnative, jc), ("torch", native, tc)):
        st = mod.IQStream(cfg)
        assert st.push(iq) == len(iq)
        assert st.available == len(iq)
        st.set_eof()
        out = []
        while True:
            xi, xq = np.zeros(T + 64, np.int8), np.zeros(T + 64, np.int8)
            start = st.next_block_planar_i8(xi, xq, scale=200.0)
            if start is None:
                break
            out.append((start, xi.copy(), xq.copy()))
        assert st.dropped == 0
        st.close()
        rows[name] = out
    assert len(rows["torch"]) == len(rows["jax"]) == 3
    for (s0, i0, q0), (s1, i1, q1) in zip(rows["torch"], rows["jax"]):
        assert s0 == s1
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_array_equal(q0, q1)


# --- run_native_channels -----------------------------------------------------

@pytest.fixture(scope="module")
def channel_captures(tmp_path_factory, native_ok):
    """Four uc8 captures: three of traffic with unequal lengths (4, 3 and 2
    blocks) and one silent (noise only, 3 blocks)."""
    d = tmp_path_factory.mktemp("chans")
    n = 1 << 14
    out = []
    for c, nblk in enumerate((4, 3, 2)):
        out.append(_write_capture(str(d / f"ch{c}.uc8"), 4 * nblk, 50 + c,
                                  nblk * n + 3000))
    rng = np.random.default_rng(9)
    m = 3 * n + 3000
    iq = ((rng.standard_normal(m) + 1j * rng.standard_normal(m)) * 0.05
          ).astype(np.complex64)
    out.append((_write_uc8(str(d / "silent.uc8"), iq), []))
    return out


def test_run_native_channels_matches_reference(channel_captures):
    """The port of test_native.py's test_run_native_channels_multi:
    reference against port on the CPU, channel for channel and step for
    step. A channel that has ended yields None; the silent channel yields
    [] while it lives."""
    from airmodes.io.native_stream import run_native_channels as jax_run
    from airmodes_torch.dsp.host import BlockStats
    from airmodes_torch.io.native_stream import run_native_channels
    paths = [p for p, _ in channel_captures]
    jc, tc = _cfgs(**KW)
    want = list(jax_run(paths, jc, fmt="uc8"))
    stats = BlockStats()
    got = list(run_native_channels(paths, tc, fmt="uc8", stats=stats,
                                   device="cpu"))
    assert got == want
    assert len(got) == 5
    # lengths 4, 3, 2 and 3 blocks (+ the tail each framer pads out)
    ended = [[msgs is None for msgs in step] for step in got]
    assert ended[0] == [False] * 4
    assert ended[-1] == [False, True, True, True]
    assert [step[3] for step in got] == [[], [], [], [], None]
    for c, (_, truth) in enumerate(channel_captures[:3]):
        seen = {m.split()[1] for step in got for m in (step[c] or [])}
        assert {t.hex for t in truth} <= seen, c
    assert stats.ring_dropped == 0


@pytest.mark.parametrize("opts", [dict(max_blocks=2),
                                  dict(start_sample=5000, scale=90.0,
                                       epoch=12.5)],
                         ids=["max_blocks", "start_scale_epoch"])
def test_run_native_channels_options_match_reference(channel_captures, opts):
    from airmodes.io.native_stream import run_native_channels as jax_run
    from airmodes_torch.io.native_stream import run_native_channels
    paths = [p for p, _ in channel_captures[:2]]
    jc, tc = _cfgs(**KW)
    want = list(jax_run(paths, jc, fmt="uc8", **opts))
    got = list(run_native_channels(paths, tc, fmt="uc8", device="cpu",
                                   **opts))
    assert got == want
    if "max_blocks" in opts:
        assert len(got) == opts["max_blocks"]


def test_run_native_channels_outside_planar_gate(channel_captures, tmp_path):
    """C1 on the channel runner: sps 10 through the full-block path."""
    from airmodes.io.native_stream import run_native_channels as jax_run
    from airmodes_torch.io.native_stream import run_native_channels
    jc, tc = _cfgs(channel_rate=20e6, block_size=1 << 15, max_detections=32)
    paths = [_write_capture(str(tmp_path / f"f{c}.uc8"), 8, 60 + c,
                            (2 + c) * tc.block_size, rate=20e6,
                            spacing=6000)[0] for c in range(2)]
    want = list(jax_run(paths, jc, fmt="uc8"))
    got = list(run_native_channels(paths, tc, fmt="uc8", device="cpu"))
    assert got == want
    assert sum(len(m or []) for step in got for m in step) > 0


def test_run_native_channels_stops_early_and_cleans_up(channel_captures):
    import threading
    from airmodes_torch.io.native_stream import run_native_channels
    before = threading.active_count()
    gen = run_native_channels([p for p, _ in channel_captures],
                              DspConfig(**KW), fmt="uc8", device="cpu")
    next(gen)
    gen.close()
    assert threading.active_count() <= before


def test_run_native_channels_needs_a_card_by_default(channel_captures):
    from airmodes_torch.io.native_stream import run_native_channels
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(run_native_channels([channel_captures[0][0]], DspConfig(**KW),
                                 fmt="uc8"))


def test_native_available():
    from airmodes.io.native_stream import native_available as jax_avail
    from airmodes_torch.io.native_stream import native_available
    assert native_available() == jax_avail()


# --- on the card -------------------------------------------------------------


# --- the native framer's UDP input and int8 reads ----------------------------

def test_iqstream_reads_match_reference(native_ok):
    """IQStream.next_block(out, stop), next_block_i8, blocks(i8, scale) and
    quantize_planar_i8 on a pushed capture: the same arrays and starts as
    the reference's IQStream, and the reference's quantize rule."""
    from airmodes import native as jax_native
    from airmodes.config import DspConfig as JaxCfg
    from airmodes_torch import native
    from airmodes_torch.dsp.host import quantize_i8_np, quantize_planar_i8_np
    rng = np.random.default_rng(8)
    n = 3 * (1 << 14) + 999
    iq = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.3
          ).astype(np.complex64)
    kw = dict(block_size=1 << 14, max_detections=16)
    for i8, scale in ((False, 127.0), (True, 127.0), (True, 90.0)):
        streams = [native.IQStream(DspConfig(**kw)),
                   jax_native.IQStream(JaxCfg(**kw))]
        try:
            for st in streams:
                st.push(iq)
                st.set_eof()
            got, want = (list(st.blocks(i8=i8, scale=scale))
                         for st in streams)
        finally:
            for st in streams:
                st.close()
        assert len(got) == len(want) == 4
        for (a, sa), (b, sb) in zip(got, want):
            assert sa == sb and a.dtype == b.dtype
            assert np.array_equal(a, b)
    gi, gq = native.quantize_planar_i8(iq, 100.0)
    wi, wq = jax_native.quantize_planar_i8(iq, 100.0)
    assert np.array_equal(gi, wi) and np.array_equal(gq, wq)
    assert np.array_equal(gi, quantize_i8_np(iq.real, 100.0))
    # the specials: NaN (also with payload bits, quiet and signalling),
    # +-inf, -0, subnormals, exact halves after the gain (k + 0.5) / 100,
    # +-127.5 and the neighbours of +-127 and +-127.5
    halves = (np.arange(-130, 130) + 0.5).astype(np.float32) / np.float32(100)
    edges = np.array([127.0, 127.5, 128.0, 126.5], np.float32) / np.float32(100)
    special = np.concatenate([
        np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1e-45, -1e-45, 3.4e38,
                  -3.4e38, 3.402e38], np.float32),
        np.array([0x7fc00005, 0xffc0007f, 0x7f800001, 0xff812345],
                 np.uint32).view(np.float32),
        halves, edges, -edges, np.nextafter(edges, np.float32(2)),
        np.nextafter(edges, np.float32(0))])
    sp = special.view(np.complex64)
    gi, gq = native.quantize_planar_i8(sp, 100.0)
    with np.errstate(over="ignore", invalid="ignore"):   # 3.4e38 * 100
        wi, wq = quantize_planar_i8_np(sp, np.float32(100.0))
    assert np.array_equal(gi, wi) and np.array_equal(gq, wq)
    ri, rq = jax_native.quantize_planar_i8(sp, 100.0)
    assert np.array_equal(gi, ri) and np.array_equal(gq, rq)


def _planar_row(st, agc: bool):
    """The stream's next block framed as planar int8 rows: with AGC
    (start, gain, I, Q), else with the fixed gain 90 (start, I, Q); None at
    its end. Rows are longer than the frame, filled beforehand."""
    P = st.total + 100
    xi, xq = np.full(P, 7, np.int8), np.full(P, 7, np.int8)
    nxt = (st.next_block_planar_agc(xi, xq) if agc
           else st.next_block_planar_i8(xi, xq, scale=90.0))
    if nxt is None:
        return None
    return (*(nxt if agc else (nxt,)), xi, xq)


def _planar_rows(st, agc: bool):
    """Every block the stream holds until its end (its source set)."""
    rows = []
    while (row := _planar_row(st, agc)) is not None:
        rows.append(row)
    return rows


def _same_rows(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            if isinstance(u, np.ndarray):
                assert np.array_equal(u, v)
            else:
                assert u == v


@pytest.mark.parametrize("agc", [True, False], ids=["agc", "fixed_gain"])
def test_iqstream_planar_rows_match_reference_at_edges(native_ok, agc):
    """The planar framers read the ring where it lies, frames wrapping it,
    and quantize without branches: the same rows, starts and gains as the
    reference's framer on NaN, +-inf, floats past the peak's limit, -0,
    subnormals, exact halves after the gain, and values past +-127."""
    from airmodes import native as jax_native
    from airmodes_torch import native
    bs = 1 << 14
    rng = np.random.default_rng(21)
    iq = ((rng.standard_normal(5 * bs + 321)
           + 1j * rng.standard_normal(5 * bs + 321)) * 0.2).astype(np.complex64)
    x = iq.view(np.float32)
    # block 1: the peak 0.9375 gives the AGC gain 128, and k/256 lands on
    # the half k/2 (the fixed gain 90 puts other values on halves)
    x[2 * bs: 4 * bs] = rng.integers(-240, 241, 2 * bs) / 256.0
    x[2 * bs + 5] = 0.9375
    x[3 * bs: 3 * bs + 8] = np.float32(1.5) / np.float32(90.0) * np.arange(
        -4, 4, dtype=np.float32)
    # block 3: values the peak skips or clamps
    special = np.array([np.nan, np.inf, -np.inf, 3.401e38, -3.401e38, -0.0,
                        1e-45, -1e-45, 5.0, -5.0], np.float32)
    x[6 * bs + 40: 6 * bs + 40 + len(special)] = special
    rows = _pushed_rows_both(iq, dict(block_size=bs, max_detections=16), agc)
    _same_rows(*rows)
    assert len(rows[0]) == 6


def _pushed_rows_both(iq, kw, agc):
    """`iq` pushed through the port's and the reference's IQStream, each
    with a ring of block + right halo (frames wrap it), framing whole
    blocks as the ring fills: both streams' planar rows."""
    from airmodes import native as jax_native
    from airmodes_torch import native
    cfg = DspConfig(**kw)
    ring = cfg.block_size + cfg.right_halo
    streams = [native.IQStream(cfg, ring_samples=ring),
               jax_native.IQStream(JaxCfg(**kw), ring_samples=ring)]
    try:
        rows = []
        for st in streams:
            # push what the ring takes, framing whole blocks as they fill
            got, pos = [], 0
            while pos < len(iq):
                pos += st.push(iq[pos:])
                while st.available >= st.block + st.right:
                    got.append(_planar_row(st, agc))
            st.set_eof()
            rows.append(got + _planar_rows(st, agc))
    finally:
        for st in streams:
            st.close()
    return rows


# Each case: the block size, and the block whose frame it builds with the
# AGC gain that frame must get (target 120 over its finite peak). The ring
# holds block + right halo: at 2^14 it wraps where a block ends; at 2^14 - 1
# the wrap of block 1's frame falls 2 samples into its right halo.
HALO_CASES = {"peak_in_left_halo": (1 << 14, 2, 120 / 0.75),
              "peak_in_right_halo": (1 << 14, 2, 120 / 0.625),
              "no_finite_sample": (1 << 14, 2, 120.0),
              "wrap_in_right_halo": ((1 << 14) - 1, 1, 120 / 0.875)}


@pytest.mark.parametrize("agc", [True, False], ids=["agc", "fixed_gain"])
@pytest.mark.parametrize("case", list(HALO_CASES))
def test_iqstream_planar_rows_match_reference_at_halos(native_ok, case,
                                                       agc):
    """Frames whose only finite peak lies in a halo (the left one comes from
    the carry, the right one from the ring), a frame of nothing but NaN and
    +-inf (the peak falls back to 1.0), and a ring that wraps inside a right
    halo: the same rows, starts and gains as the reference's framer."""
    bs, k, gain = HALO_CASES[case]
    rng = np.random.default_rng(23)
    n = 5 * bs + 99
    iq = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.1
          ).astype(np.complex64)
    kw = dict(block_size=bs, max_detections=16)
    cfg = DspConfig(**kw)
    lo, end = k * bs - cfg.left_halo, (k + 1) * bs    # frame k: [lo, hi)
    hi = end + cfg.right_halo
    x = iq.view(np.float32)
    if case == "no_finite_sample":
        x[2 * lo: 2 * hi] = np.resize(np.array(
            [0x7fc00000, 0x7f800000, 0xff800000, 0x7fc00021, 0xff800003],
            np.uint32).view(np.float32), 2 * (hi - lo))   # NaN (payloads), inf
    else:
        x[2 * lo: 2 * hi] *= 0.01
        x[2 * end + 1] = np.inf                 # in the ring, not finite
        x[2 * (end - 9)] = -np.inf
        x[2 * (end - 8) + 1] = np.nan
        at = {"peak_in_left_halo": (lo + 3, -0.75),
              "peak_in_right_halo": (hi - 2, 0.625),
              "wrap_in_right_halo": (end + 3, -0.875)}[case]
        x[2 * at[0] + 1] = at[1]
        if case == "wrap_in_right_halo":
            x[2 * (end + 1)] = 0.5              # just before the wrap
    rows = _pushed_rows_both(iq, kw, agc)
    _same_rows(*rows)
    assert len(rows[0]) == 6
    if agc:
        assert rows[0][k][1] == np.float32(gain)


@pytest.mark.parametrize("fmt", ["sc16", "uc8"])
def test_iqstream_file_pump_matches_reference(tmp_path, native_ok, fmt):
    """The file pump converts the wire format straight into the ring, in
    as many pieces as the ring's free space allows (a ring smaller than
    one read): the same AGC rows, starts and gains as the reference's."""
    from airmodes import native as jax_native
    from airmodes_torch import native
    rng = np.random.default_rng(22)
    n = 4 * (1 << 14) + 777
    path = str(tmp_path / f"cap.{fmt}")
    if fmt == "sc16":
        rng.integers(-32768, 32768, 2 * n).astype(np.int16).tofile(path)
    else:
        rng.integers(0, 256, 2 * n).astype(np.uint8).tofile(path)
    kw = dict(block_size=1 << 14, max_detections=16)
    cfg = DspConfig(**kw)
    ring = cfg.block_size + cfg.right_halo
    rows = []
    for st in (native.IQStream(cfg, ring_samples=ring),
               jax_native.IQStream(JaxCfg(**kw), ring_samples=ring)):
        try:
            st.start_file(path, fmt=fmt)
            rows.append(_planar_rows(st, agc=True))
        finally:
            st.close()
    _same_rows(*rows)
    assert len(rows[0]) == 5


@pytest.mark.parametrize("fmt", ["sc16", "uc8"])
def test_iqstream_fifo_pump_matches_reference(tmp_path, native_ok, fmt):
    """The file pump on a named pipe: a writer thread sends the capture in
    pieces that split its samples' words (the pump carries the partial
    sample to its next read) while the ring, smaller than one read, makes
    the pump wait: the same AGC rows, starts and gains as the reference's
    framer on the same capture from a file."""
    import os
    import threading
    from airmodes import native as jax_native
    from airmodes_torch import native
    rng = np.random.default_rng(24)
    n = 3 * (1 << 14) + 555
    if fmt == "sc16":
        words = rng.integers(-32768, 32768, 2 * n).astype(np.int16)
    else:
        words = rng.integers(0, 256, 2 * n).astype(np.uint8)
    path, fifo = str(tmp_path / f"cap.{fmt}"), str(tmp_path / f"fifo.{fmt}")
    words.tofile(path)
    os.mkfifo(fifo)
    data = words.tobytes()
    cuts = np.cumsum(rng.integers(1, 4099, len(data) // 1000))
    cuts = [0] + [int(c) for c in cuts[cuts < len(data)]] + [len(data)]
    assert any(c % (2 * words.itemsize) for c in cuts)   # a sample split

    def write():
        with open(fifo, "wb", buffering=0) as f:
            for a, b in zip(cuts[:-1], cuts[1:]):
                f.write(data[a:b])

    kw = dict(block_size=1 << 14, max_detections=16)
    cfg = DspConfig(**kw)
    ring = cfg.block_size + cfg.right_halo
    writer = threading.Thread(target=write, daemon=True)
    writer.start()
    st = native.IQStream(cfg, ring_samples=ring)
    try:
        st.start_file(fifo, fmt=fmt)
        got = _planar_rows(st, agc=True)
    finally:
        st.close()
    writer.join(timeout=60)
    assert not writer.is_alive()
    ref = jax_native.IQStream(JaxCfg(**kw), ring_samples=ring)
    try:
        ref.start_file(path, fmt=fmt)
        want = _planar_rows(ref, agc=True)
    finally:
        ref.close()
    _same_rows(got, want)
    assert len(got) == 4


def test_iqstream_next_block_into_a_buffer(native_ok):
    """next_block fills a caller's buffer (checked for dtype, shape and
    layout), and a set stop event ends a wait on a quiet stream."""
    import threading
    from airmodes_torch import native
    cfg = DspConfig(block_size=1 << 14, max_detections=16)
    st = native.IQStream(cfg)
    try:
        out = np.empty((st.total, 2), np.float32)
        for bad in (np.empty((st.total, 2), np.float64),
                    np.empty((st.total + 1, 2), np.float32),
                    np.empty((2, st.total), np.float32).T):
            with pytest.raises(ValueError, match="C-contiguous"):
                st.next_block(bad)
        with pytest.raises(ValueError, match="C-contiguous"):
            st.next_block_i8(out=np.empty((st.total, 2), np.float32))
        stop = threading.Event()
        stop.set()
        assert st.next_block(out, stop=stop) is None
        st.push(np.ones(2 * cfg.block_size, np.complex64))
        got = st.next_block(out)
        assert got is not None and got[0] is out and got[1] == 0
    finally:
        st.close()


def test_iqstream_udp_rejects_a_hostname(native_ok):
    from airmodes_torch import native
    st = native.IQStream(DspConfig(block_size=1 << 14, max_detections=16))
    try:
        with pytest.raises(OSError, match="numeric"):
            st.start_udp("localhost", 0)
    finally:
        st.close()


def _free_udp_port():
    import socket
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_runner_udp_matches_file(capture, tmp_path, monkeypatch):
    """run_native_pipelined over complex64 UDP datagrams (the C++ pump
    bound to 127.0.0.1, ending at a 1 s silence) gives the messages of the
    same samples read from a file; the socket's receive buffer is
    reported. A sender thread starts once the pump has bound."""
    import socket
    import threading
    import time
    from airmodes_torch import native
    from airmodes_torch.io.native_stream import run_native_pipelined
    path, truth = capture
    u = np.fromfile(path, np.uint8).astype(np.float32)
    iq = ((u - np.float32(127.5)) * np.float32(1 / 127.5)).view(np.complex64)
    c64 = str(tmp_path / "cap.c64")
    iq.tofile(c64)
    want = _flat(run_native_pipelined(DspConfig(**KW), path=c64, batch=2,
                                      device="cpu"))
    bound, rcvbuf = threading.Event(), []
    real_start = native.IQStream.start_udp

    def start_udp(self, *a, **kw):
        real_start(self, *a, **kw)
        rcvbuf.append(self.rcvbuf)
        bound.set()
    monkeypatch.setattr(native.IQStream, "start_udp", start_udp)
    port = _free_udp_port()

    def send():
        assert bound.wait(30)
        snd = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        raw = iq.tobytes()
        for off in range(0, len(raw), 8192):
            snd.sendto(raw[off: off + 8192], ("127.0.0.1", port))
            time.sleep(0.0005)
        snd.close()
    th = threading.Thread(target=send, daemon=True)
    th.start()
    got = _flat(run_native_pipelined(DspConfig(**KW), udp_host="127.0.0.1",
                                     udp_port=port, udp_timeout_s=1.0,
                                     batch=2, device="cpu"))
    th.join(10)
    assert not th.is_alive()
    assert got == want and rcvbuf and rcvbuf[0] > 0
    assert {t.hex for t in truth} <= {m.split()[1] for m in got}


def test_runner_throttle_keeps_the_messages(capture):
    """throttle_sps paces the file pump; what comes out is unchanged."""
    path, _ = capture
    want, got, _, _ = _run_both(path, KW, throttle_sps=5e7)
    base, _, _, _ = _run_both(path, KW)
    assert got == want == base

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_runners_match_cpu(cuda, channel_captures, capture):
    """Both runners on the card yield what they yield on the CPU, inside
    the planar gate (kernels B1 and B2) and outside it."""
    from airmodes_torch.io.native_stream import (run_native_channels,
                                                 run_native_pipelined)
    paths = [p for p, _ in channel_captures]
    for cfg in (DspConfig(**KW), DspConfig(noise_window=256, **KW)):
        assert list(run_native_channels(paths, cfg, fmt="uc8",
                                        device=cuda)) == \
            list(run_native_channels(paths, cfg, fmt="uc8", device="cpu"))
        assert list(run_native_pipelined(cfg, path=capture[0], fmt="uc8",
                                         device=cuda)) == \
            list(run_native_pipelined(cfg, path=capture[0], fmt="uc8",
                                      device="cpu"))
