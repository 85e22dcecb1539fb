"""The port's full-block demod path (`dsp.pipeline.demod_block`), its
framers and its streaming runners against the JAX reference.

Inputs are made with numpy from fixed seeds. The full-block path runs with
no hand kernel on either side; the runners' JAX side takes the route the
reference takes on its accelerator, forced through its `step=` argument
with the Pallas kernels in interpret mode, and the port runs with
device="cpu" (its kernels' plain versions). Discrete results and messages
must be equal; the noise column of the full-block path is compared within
rtol 1e-4 (both take a mean-centered cumsum, and XLA and PyTorch reduce it
in different orders).
"""

import dataclasses

import numpy as np
import pytest
import torch

from airmodes.config import DspConfig as JaxCfg
from airmodes.dsp import host as jhost
from airmodes.dsp import pipeline as JP
from airmodes.io import sources as jsrc
from airmodes.io import stream as jstream
from airmodes.kernels import preamble_pallas as JK
from airmodes.testing import encoder, golden
from airmodes_torch.config import DspConfig
from airmodes_torch.dsp import host as thost
from airmodes_torch.dsp import pipeline as TP
from airmodes_torch.io import sources as tsrc
from airmodes_torch.io import stream as tstream

TILE = 4096


def _cfgs(**kw):
    jc = JaxCfg(**kw)
    return jc, DspConfig.from_dict(dataclasses.asdict(jc))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _capture(jc, seed, n_frames=12, snr=16.0, spacing=1300, mixed=True,
             total=None):
    make = encoder.random_mixed_frames if mixed else encoder.random_df17_frames
    return encoder.make_capture(make(n_frames, seed=seed),
                                rate=jc.channel_rate, snr_db=snr,
                                spacing=spacing * jc.sps, seed=seed,
                                total_samples=total)


def _tables_equal(got, want, noise_rtol=1e-4):
    for name, g, w in zip(want._fields, got, want):
        g, w = g.numpy(), np.asarray(w)
        if name == "noise":
            np.testing.assert_allclose(g, w, rtol=noise_rtol, atol=1e-9)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


# --- the full-block path -----------------------------------------------------

@pytest.mark.parametrize("layout", ["f32", "c64", "int8", "int16"])
@pytest.mark.parametrize("rate", [2e6, 10e6])
def test_demod_block_matches_reference(rate, layout):
    """demod_block == the reference's on every block of a capture: the
    discrete columns and ref_level exact, noise within rtol 1e-4, for f32,
    complex64, int8 and int16 input, at sps 1 and 5."""
    jc, tc = _cfgs(channel_rate=rate, block_size=1 << 14, max_detections=32)
    iq, _ = _capture(jc, seed=40 + int(rate // 1e6), n_frames=16)
    hits = 0
    for block, _ in jsrc.frame_blocks(iq, jc):
        x = JP.iq_to_device_layout(block)
        if layout == "c64":
            x = block
        elif layout in ("int8", "int16"):
            full = 127.0 if layout == "int8" else 32767.0
            x = np.clip(np.round(x / np.max(np.abs(x)) * full), -full,
                        full).astype(layout)
        want = JP.demod_block_jit(x, jc)
        got = TP.demod_block(_t(x), tc)
        _tables_equal(got, want)
        hits += int(np.asarray(want.n_detected))
    assert hits > 0


def _jax_batch_packed(xb, jc):
    import jax
    return jax.jit(jax.vmap(lambda x: JP.pack_table(JP.demod_block(x, jc))))(
        xb)


def test_demod_batch_packed_matches_reference():
    """The batched packed form == the reference's jitted vmap of
    demod_block + pack_table, including a block with more hits than K
    (the grouped spill rule). Jitted: XLA's FMA contractions, which the
    port copies, happen only in compiled programs."""
    jc, tc = _cfgs(block_size=1 << 14, max_detections=8)
    iq, _ = _capture(jc, seed=21, n_frames=30, spacing=900)
    xb = np.stack([JP.iq_to_device_layout(b)
                   for b, _ in jsrc.frame_blocks(iq, jc)][:2])
    want = np.asarray(_jax_batch_packed(xb, jc))
    got = TP.demod_batch_packed(xb, tc, device="cpu").numpy()
    cols = [0, 1, 2, 3, 5, 6, 7, 8]
    np.testing.assert_array_equal(got[..., cols], want[..., cols])
    np.testing.assert_allclose(got[..., :-1, 4].view(np.float32),
                               want[..., :-1, 4].view(np.float32), rtol=1e-4)
    np.testing.assert_array_equal(got[..., -1, 4], want[..., -1, 4])
    assert want[0, -1, 1] > 0


def test_demod_block_rejects_short_block():
    _, tc = _cfgs(block_size=1 << 12, max_detections=4)
    x = torch.zeros((tc.left_halo + tc.block_size, 2))
    with pytest.raises(ValueError, match="block length"):
        TP.demod_block(x, tc)
    with pytest.raises(TypeError, match="uint8"):
        TP.magnitude_squared(torch.zeros((8, 2), dtype=torch.uint8))


def _port_decode(iq, cfg):
    out = []
    for block, start in tsrc.frame_blocks(iq, cfg):
        table = TP.demod_block(_t(TP.iq_to_device_layout(block)), cfg)
        for m in thost.table_to_messages(table, start, cfg.channel_rate):
            parts = m.split()
            out.append((int(float(parts[5]) * cfg.channel_rate + 0.5),
                        parts[1]))
    return sorted(out)


@pytest.mark.parametrize("case", ["healthy", "threshold", "ecc", "start"])
def test_demod_block_matches_numpy_oracle(case):
    """Twin of tests/test_golden.py's cross-checks: the port's full-block
    path and the reference's sequential numpy decoder give the identical
    (index, hex) set, at a healthy SNR, near threshold, through the
    single- and two-bit ECC, and at the capture's first samples."""
    jc, tc = _cfgs(block_size=1 << 16, max_detections=64)
    if case == "healthy":
        frames = encoder.random_df17_frames(25, seed=40)
        frames += [(encoder.df11_frame(0x600000 + i), 56) for i in range(5)]
        iq, _ = encoder.make_capture(frames, snr_db=14.0, spacing=2000,
                                     seed=40)
    elif case == "threshold":
        iq, _ = encoder.make_capture(encoder.random_df17_frames(30, seed=41),
                                     snr_db=8.0, spacing=2000, seed=41)
    elif case == "ecc":
        frames = [(int("8d4840d6202cc371c32ce0576098", 16), 112)]
        parts = []
        for seed, chips in ((46, [55]), (47, [30, 77])):
            iq1, truth = encoder.make_capture(frames, snr_db=25.0, seed=seed,
                                              random_phase=False)
            parts.append(golden.inject_chip_errors(iq1, truth[0], chips,
                                                   mode="dim"))
        iq = np.concatenate(parts)
    else:
        iq, _ = encoder.make_capture(encoder.random_df17_frames(3, seed=77),
                                     snr_db=20.0, start=40, spacing=9000,
                                     seed=77)
    want = sorted(golden.reference_decode(iq, jc))
    assert _port_decode(iq, tc) == want
    assert want


# --- compaction --------------------------------------------------------------

@pytest.mark.parametrize("case", [
    (1 << 14, 32, 60, 0),        # grouped, under K
    (1 << 14, 32, 300, 0),       # grouped, over K
    (1 << 14, 32, 40, 40),       # grouped, a group over its 16
    (3000, 8, 30, 0),            # plain top-K (n not a multiple of 1024)
    (2048, 8, 5, 0),             # plain top-K (n < 4 groups), under K
])
def test_compact_detections_matches_reference(case):
    """Both branches of compact_detections equal the reference: the first
    K hits, n_detected and n_overflow, with the per-group spill."""
    import jax
    n, K, n_hits, burst = case
    rng = np.random.default_rng(n + n_hits)
    mask = np.zeros(n, bool)
    mask[rng.choice(n, n_hits, replace=False)] = True
    mask[1024: 1024 + burst] = True
    want = [np.asarray(a) for a in JP.compact_detections(
        jax.numpy.asarray(mask), K)]
    got = [a.numpy() for a in TP.compact_detections(_t(mask), K)]
    for name, g, w in zip(("det_idx", "valid", "n_det", "overflow"),
                          got, want):
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)
    # batched: the same per row
    got2 = TP.compact_detections(_t(np.stack([mask, mask])), K)
    for g, w in zip(got2, want):
        np.testing.assert_array_equal(g.numpy()[1], w.astype(g.numpy().dtype))


# --- sources -----------------------------------------------------------------

def test_framers_match_reference(tmp_path):
    """frame_blocks, buffered_framer (uneven pushes, then flush) and
    file_source for each file dtype give the reference's blocks."""
    jc, tc = _cfgs(block_size=1 << 12)
    rng = np.random.default_rng(3)
    n = 3 * jc.block_size + 777
    iq = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64) * np.float32(0.3)

    def same(a, b):
        a, b = list(a), list(b)
        assert len(a) == len(b) and a
        for (x, s), (y, t) in zip(a, b):
            np.testing.assert_array_equal(x, y)
            assert s == t

    same(tsrc.frame_blocks(iq, tc, start_sample=5),
         jsrc.frame_blocks(iq, jc, start_sample=5))
    fa, fb = tsrc.buffered_framer(tc), jsrc.buffered_framer(jc)
    got, want = [], []
    for lo, hi in ((0, 1000), (1000, 9000), (9000, n)):
        got += list(fa.push(iq[lo:hi]))
        want += list(fb.push(iq[lo:hi]))
    same(got + list(fa.flush()), want + list(fb.flush()))
    x = np.clip(np.round(iq.view(np.float32) * 100), -127, 127)
    files = {"complex64": iq,
             "sc16": (x * 200).astype(np.int16),
             "uc8": (x + 127).astype(np.uint8)}
    for dtype, arr in files.items():
        path = str(tmp_path / f"cap.{dtype}")
        arr.tofile(path)
        same(tsrc.file_source(path, tc, dtype=dtype),
             jsrc.file_source(path, jc, dtype=dtype))


@pytest.fixture(scope="module")
def native_ok():
    from airmodes_torch import native
    try:
        native.load()
    except native.NativeUnavailable:
        pytest.skip("no C++ toolchain")


def test_iqstream_blocks_match_reference(tmp_path, native_ok):
    """IQStream.blocks() frames a complex64 file into the reference's f32
    blocks and start samples, each in a buffer of its own."""
    from airmodes.native import IQStream as JStream
    from airmodes_torch.native import IQStream as TStream
    jc, tc = _cfgs(block_size=1 << 12)
    rng = np.random.default_rng(4)
    n = 3 * jc.block_size + 100
    iq = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    path = str(tmp_path / "cap.c64")
    iq.tofile(path)
    streams = [TStream(tc), JStream(jc)]
    try:
        for s in streams:
            s.start_file(path)
        got, want = (list(s.blocks()) for s in streams)
    finally:
        for s in streams:
            s.close()
    assert len(got) == len(want) == 4
    for (x, s), (y, t) in zip(got, want):
        assert x.dtype == np.float32 and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
        assert s == t
    assert got[0][0] is not got[1][0]


# --- the runners -------------------------------------------------------------

def _jax_fast_step(jc):
    """The reference's streaming steps as its accelerator runs them, with
    the Pallas kernels in interpret mode."""
    def step1(x, cfg):
        return JK.demod_block_packed_fast_jit(x, cfg, tile=TILE,
                                              interpret=True)

    def step_b(xb, cfg):
        if xb.dtype == np.int8:
            xi, xq = JK.to_planar_i8(xb, cfg, tile=TILE)
            return JK.demod_batch_packed_planar_jit(xi, xq, cfg, tile=TILE,
                                                    interpret=True)
        return JK.demod_batch_packed_fast_jit(xb, cfg, tile=TILE,
                                              interpret=True)
    return step1, step_b


@pytest.fixture(scope="module")
def stream_capture():
    jc, tc = _cfgs(block_size=1 << 14, max_detections=32)
    iq, truth = _capture(jc, seed=55, n_frames=14, snr=18.0, spacing=3000,
                         total=3 * jc.block_size + 2000)
    return jc, tc, iq, truth


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("batch", [1, 4])
def test_run_pipelined_matches_reference(stream_capture, batch, quant):
    """run_pipelined emits the reference runner's messages, block for
    block: batch 1 (B3) and batch 4 (B4, or the planar path for int8),
    on f32 blocks and with quantize_i8 (per-block AGC)."""
    jc, tc, iq, truth = stream_capture
    step1, step_b = _jax_fast_step(jc)
    want = list(jstream.run_pipelined(
        jsrc.frame_blocks(iq, jc), jc, batch=batch, quantize_i8=quant,
        step=step1 if batch == 1 else step_b, epoch=1.5))
    stats = thost.BlockStats()
    got = list(tstream.run_pipelined(
        tsrc.frame_blocks(iq, tc), tc, batch=batch, quantize_i8=quant,
        epoch=1.5, stats=stats, device="cpu"))
    assert got == want
    assert {t.hex for t in truth} <= {m.split()[1] for b in got for m in b}
    assert stats.emitted == sum(len(b) for b in got)


def test_run_pipelined_falls_back_past_the_gate():
    """A config the f32 kernels' gate refuses (noise_window 64) runs the
    full-block path, as the reference's runner does."""
    jc, tc = _cfgs(block_size=1 << 12, max_detections=16, noise_window=64)
    iq, _ = _capture(jc, seed=56, n_frames=4, snr=20.0, spacing=2500)
    want = list(jstream.run_pipelined(jsrc.frame_blocks(iq, jc), jc,
                                      batch=2))
    got = list(tstream.run_pipelined(tsrc.frame_blocks(iq, tc), tc, batch=2,
                                     device="cpu"))
    assert got == want and any(got)


def test_run_channels_matches_reference(stream_capture):
    """Two channels ending at different times: each step's per-channel
    messages equal the reference's, ended channels yield None."""
    jc, tc, iq, _ = stream_capture
    iq_b, _ = _capture(jc, seed=57, n_frames=6, snr=20.0, spacing=2500,
                       total=jc.block_size + 500)
    _, step_b = _jax_fast_step(jc)
    want = list(jstream.run_channels(
        [jsrc.frame_blocks(iq, jc), jsrc.frame_blocks(iq_b, jc)], jc,
        step=step_b))
    got = list(tstream.run_channels(
        [tsrc.frame_blocks(iq, tc), tsrc.frame_blocks(iq_b, tc)], tc,
        device="cpu"))
    assert got == want
    assert len(got) == 4 and got[2][1] is None and got[3][1] is None
    assert got[0][1]


def test_run_channels_keeps_int8_after_a_channel_ends():
    """The silence of an ended channel has the live blocks' dtype: int8
    batches stay int8 (the planar path) after a channel ends, and the
    messages equal the reference's."""
    jc, tc = _cfgs(block_size=1 << 14, max_detections=16)
    seen = []

    def i8_blocks(seed, n):
        iq, _ = _capture(jc, seed=seed, n_frames=3 * n, snr=20.0,
                         spacing=4000, total=n * jc.block_size)
        for b, s in jsrc.frame_blocks(iq, jc):
            x = JP.iq_to_device_layout(b)
            yield jhost.quantize_i8_np(x, 120.0 / np.max(np.abs(x))), s

    _, step_b = _jax_fast_step(jc)
    want = list(jstream.run_channels([i8_blocks(1, 3), i8_blocks(2, 1)], jc,
                                     step=step_b))
    port_step = tstream._batch_step(tc, "cpu")

    def spy(xb, cfg):
        seen.append(xb.dtype)
        return port_step(xb, cfg)

    got = list(tstream.run_channels([i8_blocks(1, 3), i8_blocks(2, 1)], tc,
                                    step=spy, device="cpu"))
    assert got == want
    assert got[1][1] is None and got[2][1] is None
    assert seen == [np.int8] * 3


def test_run_channels_rejects_mixed_dtypes():
    _, tc = _cfgs(block_size=1 << 12, max_detections=8)
    T = tc.left_halo + tc.block_size + tc.right_halo

    def chan(dtype):
        yield np.zeros((T, 2), dtype), 0

    with pytest.raises(ValueError, match="mixed"):
        list(tstream.run_channels([chan(np.int8), chan(np.float32)], tc,
                                  device="cpu"))


def test_dev_layout_matches_reference():
    """The host-side layout and AGC: complex64 viewed as f32 pairs; the
    quantized form and its full scale equal the reference's, with a
    finite-only peak."""
    rng = np.random.default_rng(9)
    block = (rng.standard_normal(5000) + 1j * rng.standard_normal(5000)
             ).astype(np.complex64)
    block[17] = np.inf
    for quant in (False, True):
        x, fs = tstream._dev_layout(block, quant)
        y, gs = jstream._dev_layout(block, quant)
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype and fs == gs


def test_stream_entry_points_need_a_card_by_default():
    """With no card, the default device raises before a block is read; it
    never moves to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, tc = _cfgs(block_size=1 << 12, max_detections=4)
    x = np.zeros((tc.left_halo + tc.block_size + tc.right_halo, 2),
                 np.float32)

    def blocks():
        raise AssertionError("a block was read")
        yield

    for batch in (1, 4):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(tstream.run_pipelined(blocks(), tc, batch=batch))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(tstream.run_channels([blocks()], tc))
    for fn in (TP.demod_block_packed, TP.demod_batch, TP.demod_batch_packed):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(x if fn is TP.demod_block_packed else x[None], tc)
