"""The port's resampled front end against the JAX package's, on the CPU:
`airmodes_torch.resample.polyphase` (filter design, group matmuls, offline
and streaming resamplers), `resample.fused` (quantize, raw geometry, the
fused front half and demod), `io.sources.resampled_file_source` and the
fused runners of `io.stream`. Twins of tests/test_resample.py and
tests/test_fused_resample.py (not their `dist/sharded` tests).

The parity contract, and why it is not bit-exact: the resampler is an f32
matmul, and torch on the CPU, cuBLAS and XLA sum its 1,152-1,920 products
in different orders.
- filter design, rational_rate, raw_geometry, group matrices: exactly equal;
- resample outputs: rtol 3e-6, atol 3e-6 (the reference's own tolerance
  between its streaming and offline forms, tests/test_resample.py);
- the fused front half: AGC gains within rtol 1e-6; int8 equal in at least
  99.99% of samples and never more than 1 apart;
- the port's planar demod on the reference's own int8: identical packed
  tables (noise within rtol 1e-5, the ROADMAP parity contract);
- messages: the same df, hex, syndrome, status, timestamp and ns in the
  same order; ref_dbfs within 0.1 dB (a +-1 int8 sample inside a pulse
  moves the reference level). Captures are at 15 dB or more, so that no
  frame sits at the threshold.
"""

import dataclasses

import numpy as np
import pytest
import torch

import airmodes
from airmodes.io.sources import buffered_framer as jax_framer
from airmodes.resample import fused as jfused
from airmodes.resample import polyphase as jpoly
from airmodes.testing import encoder, golden
from airmodes_torch.config import DspConfig
from airmodes_torch.dsp import host
from airmodes_torch.dsp.pipeline import unpack_table
from airmodes_torch.io import sources
from airmodes_torch.resample import fused, polyphase
from airmodes_torch.utils import graphs

RTOL = ATOL = 3e-6
JCFG = airmodes.DspConfig(channel_rate=4e6, block_size=1 << 16,
                          max_detections=32)
CFG = DspConfig.from_dict(dataclasses.asdict(JCFG))
P_UP, Q_DN = 2, 3          # 6 Msps raw -> 4 Msps (sps=2)


def _cfgs(**kw):
    jc = airmodes.DspConfig(**kw)
    return jc, DspConfig.from_dict(dataclasses.asdict(jc))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same_messages(got, want):
    """Field by field, in order; ref_dbfs within 0.1 dB."""
    assert len(got) == len(want), (len(got), len(want))
    for a, b in zip(got, want):
        fa, fb = a.split(), b.split()
        assert fa[:4] + fa[5:] == fb[:4] + fb[5:], (a, b)
        assert abs(float(fa[4]) - float(fb[4])) <= 0.1, (a, b)


def _flat(blocks):
    return [m for b in blocks for m in b]


def _noise(n, seed, complex_=True):
    rng = np.random.default_rng(seed)
    if complex_:
        return (rng.standard_normal(n)
                + 1j * rng.standard_normal(n)).astype(np.complex64)
    return rng.standard_normal(n).astype(np.float32)


# --- polyphase: exact copies -------------------------------------------------

@pytest.mark.parametrize("rates", [(8e6, 2e6), (10e6, 2e6), (2.4e6, 2e6),
                                   (3e6, 2e6), (2.4e6, 4e6), (6e6, 4e6),
                                   (2e6, 2e6)])
def test_rational_rate_matches_reference(rates):
    assert polyphase.rational_rate(*rates) == jpoly.rational_rate(*rates)


def test_rational_rate_rejects_like_reference():
    assert polyphase.rational_rate(8e6, 2e6) == (1, 4)
    assert polyphase.rational_rate(2.4e6, 2e6) == (5, 6)
    for bad in ((np.pi * 1e6, 2e6), (2e6, 0.0)):
        with pytest.raises(ValueError):
            jpoly.rational_rate(*bad)
        with pytest.raises(ValueError):
            polyphase.rational_rate(*bad)


@pytest.mark.parametrize("pq", [(1, 4), (1, 5), (5, 6), (2, 3), (4, 1),
                                (5, 3), (3, 2)])
def test_filter_bank_and_group_matrices_exact(pq):
    p, q = pq
    assert np.array_equal(polyphase._polyphase_bank(p, q, 12),
                          jpoly._polyphase_bank(p, q, 12))
    for a, b in zip(polyphase._group_matrices(p, q, 12),
                    jpoly._group_matrices(p, q, 12)):
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a, b)


def test_design_lowpass_exact():
    for args, kw in (((48, 0.25), {}), ((60, 0.2), {"delay": 30.0}),
                     ((33, 0.5), {"beta": 5.0})):
        assert np.array_equal(polyphase.design_lowpass(*args, **kw),
                              jpoly.design_lowpass(*args, **kw))


# --- polyphase: resample outputs within the tolerance ------------------------

@pytest.mark.parametrize("pq", [(1, 4), (5, 6), (2, 3), (4, 1), (1, 5),
                                (17, 19)])
@pytest.mark.parametrize("layout", ["complex", "iq", "real"])
def test_resample_matches_reference(pq, layout):
    """complex (N,), (N, 2) I/Q and real (N,) input; (17, 19) takes the
    slice form above the group-matrix cap."""
    p, q = pq
    n = 12 * 1024 + 77
    x = _noise(n, 3)
    if layout == "iq":
        x = np.stack([x.real, x.imag], -1)
    elif layout == "real":
        x = x.real.copy()
    want = np.asarray(jpoly.resample(x, p, q))
    got = _np(polyphase.resample(x, p, q, device="cpu"))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_resample_groups_halo_matches_reference():
    for p, q in ((2, 3), (1, 5), (5, 3)):
        gi = 128 * q
        xc = _noise(3 * (gi * 9), 4, complex_=False).reshape(3, -1)
        want = np.asarray(jpoly.resample_groups_halo(xc, p, q))
        got = polyphase.resample_groups_halo(torch.from_numpy(xc), p, q)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError):
        polyphase.resample_groups_halo(torch.zeros(1, 2 * 384 + 5), 2, 3)


@pytest.mark.parametrize("pq", [(2, 3), (1, 1), (17, 19)])
def test_resample_planar_matches_reference(pq):
    p, q = pq
    xc = _noise(2 * 9000, 6, complex_=False).reshape(2, -1)
    want = np.asarray(jpoly.resample_planar(xc, p, q))
    got = polyphase.resample_planar(xc, p, q, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if p == q == 1:        # the same-rate short circuit passes through
        assert np.array_equal(got, xc)


def test_resample_to_rate_matches_reference():
    x = _noise(30000, 7)
    want = np.asarray(jpoly.resample_to_rate(x, 2.4e6, 2e6))
    got = polyphase.resample_to_rate(x, 2.4e6, 2e6, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_tone_preserved():
    """A tone well inside the output passband survives with the right
    frequency and near-unit amplitude."""
    fs_in, fs_out = 8e6, 2e6
    t = np.arange(1 << 15) / fs_in
    f0 = 300e3
    x = np.exp(2j * np.pi * f0 * t).astype(np.complex64)
    y = polyphase.resample_to_rate(x, fs_in, fs_out, device="cpu").numpy()
    y = y[200:-200]
    spec = np.fft.fft(y * np.hanning(len(y)))
    freqs = np.fft.fftfreq(len(y), 1 / fs_out)
    assert abs(freqs[np.argmax(np.abs(spec))] - f0) < 2e3
    assert np.median(np.abs(y)) > 0.9


def test_against_scipy_resample_poly():
    """On a band-limited signal the polyphase output tracks scipy's up to
    a small lag."""
    from scipy.signal import resample_poly
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096)
    spec = np.fft.rfft(x)
    spec[int(0.3 * len(spec)):] = 0
    x = np.fft.irfft(spec).astype(np.float32)
    ours = polyphase.resample(x, 5, 6, device="cpu").numpy()
    theirs = resample_poly(x, 5, 6, window=("kaiser", 8.6))
    n = min(len(ours), len(theirs)) - 64

    def up8(v):
        return np.fft.irfft(np.fft.rfft(v), 8 * len(v)) * 8

    a, b = up8(ours[32:n]), up8(theirs[32:n])
    best = max(np.corrcoef(a[64 + lag: -64 + lag], b[64: -64])[0, 1]
               for lag in range(-24, 25))
    assert best > 0.999, best


def _port_demod(iq, cfg):
    """The port's full-block demod over framed blocks, on the CPU."""
    from airmodes_torch.dsp.pipeline import demod_block_packed
    msgs = []
    for block, start in sources.frame_blocks(iq, cfg):
        table = unpack_table(demod_block_packed(block, cfg,
                                                device="cpu").numpy())
        msgs += host.table_to_messages(table, start, cfg.channel_rate)
    return {m.split()[1] for m in msgs}


@pytest.mark.parametrize("fs_in,start", [(4e6, 1024), (8e6, 1026),
                                         (10e6, 1024)])
def test_demod_after_resample(fs_in, start):
    """Capture at an SDR rate -> the port's polyphase to 2 Msps (within
    the tolerance of the reference's) -> the port's demod: every frame.
    Frame starts sit at a decodable sub-chip phase, as in the
    reference's test (one sample per chip after the resample)."""
    frames = encoder.random_df17_frames(10, seed=31)
    iq, truth = encoder.make_capture(
        frames, rate=fs_in, snr_db=25.0, start=start,
        spacing=int(3000 * fs_in / 2e6), seed=31)
    iq2 = polyphase.resample_to_rate(iq, fs_in, 2e6, device="cpu").numpy()
    np.testing.assert_allclose(
        iq2, np.asarray(jpoly.resample_to_rate(iq, fs_in, 2e6)),
        rtol=RTOL, atol=ATOL)
    got = _port_demod(iq2, DspConfig(block_size=1 << 16, max_detections=64))
    assert {t.hex for t in truth} <= got


def test_demod_fractional_rate_2p4():
    """rtl-sdr style 2.4 Msps -> 5/6 polyphase -> 2 Msps demod (the 2.4
    Msps stream is every 5th sample of a 12 Msps encoding)."""
    frames = encoder.random_df17_frames(8, seed=32)
    iq12, truth = encoder.make_capture(
        frames, rate=12e6, snr_db=25.0, spacing=18000, seed=32)
    iq24 = iq12[::5].copy()
    iq2 = polyphase.resample_to_rate(iq24, 2.4e6, 2e6, device="cpu").numpy()
    got = _port_demod(iq2, DspConfig(block_size=1 << 16, max_detections=64))
    assert {t.hex for t in truth} <= got


@pytest.mark.parametrize("pq", [(1, 4), (5, 6), (2, 3), (4, 1)])
def test_streaming_matches_offline(pq):
    """Chunked streaming output equals the offline resample, the
    reference's and the port's, length included, whatever the chunks."""
    p, q = pq
    n = 40 * 1024
    x = _noise(n, 5)
    want = np.asarray(jpoly.resample(x, p, q))
    rs = polyphase.streaming_resampler(p, q, stride_blocks=1024,
                                       device="cpu")
    outs, pos = [], 0
    for size in (777, 5000, 12345, 4096, n):
        chunk = x[pos: pos + size]
        pos += len(chunk)
        outs.append(rs.push(chunk))
        if pos >= n:
            break
    outs.append(rs.flush())
    streamed = np.concatenate(outs)
    assert streamed.dtype == np.complex64 and len(streamed) == len(want)
    np.testing.assert_allclose(streamed, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        streamed, polyphase.resample(x, p, q, device="cpu").numpy(),
        rtol=RTOL, atol=ATOL)
    assert len(rs.flush()) == 0


def test_streaming_matches_reference_streaming():
    x = _noise(50000, 8)
    a = polyphase.streaming_resampler(1, 5, device="cpu")
    b = jpoly.streaming_resampler(1, 5)
    got = np.concatenate([a.push(x[:30000]), a.push(x[30000:]), a.flush()])
    want = np.concatenate([b.push(x[:30000]), b.push(x[30000:]), b.flush()])
    assert (a.stride, a.delay_out, a.n_out) == (b.stride, b.delay_out,
                                                b.n_out)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pq,s_groups", [((1, 5), 16), ((2, 3), 5)])
def test_streaming_kernel_matches_reference(pq, s_groups):
    """The compiled stride `_streaming_kernel` against the reference's
    jitted `_streaming_kernel` on the same (hist + stride, 2) blocks."""
    p, q = pq
    for seed in (11, 12):
        x = _noise((s_groups + 2) * 128 * q, seed)
        block2 = np.stack([x.real, x.imag], -1)
        want = np.asarray(jpoly._streaming_kernel(block2, p, q, 12,
                                                  s_groups))
        got = polyphase._streaming_kernel(torch.from_numpy(block2), p, q, 12,
                                          s_groups, device="cpu")
        assert got.shape == want.shape == (2, s_groups * 128 * p)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="_streaming_kernel"):
        polyphase._streaming_kernel(torch.zeros(100, 2), p, q, 12, s_groups,
                                    device="cpu")


@pytest.fixture
def stand_in(monkeypatch):
    from torch_fake_graph import install_fake_graph
    return install_fake_graph(monkeypatch.setattr)


def _streamed(p, q, x):
    rs = polyphase.streaming_resampler(p, q, stride_blocks=1024,
                                       device="cpu")
    return np.concatenate([rs.push(x[:30000]), rs.push(x[30000:]),
                           rs.flush()])


def test_streaming_resampler_replays_one_graph(stand_in):
    """Under the stand-in graph: two streaming resamplers with equal
    (p, q, taps, S) replay one captured stride, and their output is the
    eager resampler's, sample for sample."""
    x = _noise(50000, 9)
    k = polyphase._streaming_kernel
    k.cache_clear()
    with graphs.disable():
        want = _streamed(2, 3, x)
    assert len(k) == 0 and not stand_in.made
    r0 = k.replays
    assert np.array_equal(_streamed(2, 3, x), want)
    replays = k.replays - r0
    assert np.array_equal(_streamed(2, 3, x), want)
    assert len(k) == 1 and len(stand_in.made) == 1
    assert k.replays - r0 == 2 * replays > 0


@pytest.mark.parametrize("layout", ["complex", "iq", "real", "planar"])
def test_resample_layouts_through_the_graph(layout, stand_in):
    """`resample` (complex, (N, 2) I/Q, real input) and `resample_planar`
    under the stand-in graph: the eager call's layout, dtype and values,
    within the tolerance of the reference's jitted call; a second input of
    the same shape replays the graph; p == q == 1 captures nothing."""
    p, q = 2, 3
    xs = [_noise(12 * 1024 + 77, seed) for seed in (13, 14)]
    if layout == "iq":
        xs = [np.stack([x.real, x.imag], -1) for x in xs]
    elif layout == "real":
        xs = [x.real.copy() for x in xs]
    elif layout == "planar":
        xs = [np.stack([x.real, x.imag]) for x in xs]
    ref = jpoly.resample_planar if layout == "planar" else jpoly.resample
    port = (polyphase.resample_planar if layout == "planar"
            else polyphase.resample)
    g = (polyphase._resample_planar_step if layout == "planar"
         else polyphase._resample_step)
    g.cache_clear()
    r0 = g.replays
    for x in xs:
        with graphs.disable():
            eager = port(x, p, q, device="cpu")
        got = port(x, p, q, device="cpu")
        assert got.dtype == eager.dtype and got.shape == eager.shape
        assert torch.equal(got, eager)
        want = np.asarray(ref(x, p, q))
        assert got.numpy().dtype == want.dtype
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert len(g) == 1 and g.replays - r0 == 2
    assert torch.equal(port(xs[0], 1, 1, device="cpu"),
                       polyphase._as_tensor(xs[0], torch.device("cpu")))
    assert len(g) == 1 and g.replays - r0 == 2


def test_streaming_resampler_rejects_huge_ratio():
    with pytest.raises(ValueError, match="MB"):
        polyphase.streaming_resampler(100, 61, device="cpu")


def test_resample_empty_output():
    y = polyphase.resample(np.zeros(3, np.float32), 17, 19, device="cpu")
    assert y.shape[0] == 2
    y2 = polyphase._resample_cols(torch.zeros((1, 1)), 1, 3, 12)
    assert y2.shape[0] == 0


def test_antialias_attenuation_decimation_ratios():
    """The bank scales with max(p, q): the worst alias band stays below
    -50 dB on the common SDR ratios."""
    for p, q in [(1, 3), (1, 4), (1, 5), (2, 3), (5, 6)]:
        proto = polyphase._polyphase_bank(p, q, 12).T.flatten()
        H = np.abs(np.fft.rfft(proto, 16384))
        H /= H[0]
        w = np.fft.rfftfreq(16384)
        cut = 1.0 / max(p, q) / 2
        worst = 20 * np.log10(H[w > 1.5 * cut].max() + 1e-12)
        assert worst < -50.0, (p, q, worst)


def test_streaming_resampler_tiny_chunks_match_bulk():
    """push() in UDP-sized chunks (empties included) emits exactly the
    stream one bulk push does."""
    n = 200_000
    x = _noise(n, 11)
    a = polyphase.streaming_resampler(2, 3, device="cpu")
    bulk = np.concatenate([a.push(x), a.flush()])
    b = polyphase.streaming_resampler(2, 3, device="cpu")
    outs = []
    i = 0
    while i < n:
        step = [0, 1, 977, 1024, 4096][i % 5]
        outs.append(b.push(x[i: i + step]))
        i += step if step else 1
        if step == 0:
            outs.append(b.push(x[i - 1: i]))
    outs.append(b.flush())
    np.testing.assert_array_equal(bulk, np.concatenate(outs))


def test_resample_rejects_planar_2d_layout():
    with pytest.raises(ValueError, match="planar"):
        polyphase.resample(np.zeros((2, 1024), np.float32), 2, 3,
                           device="cpu")
    with pytest.raises(ValueError, match="1-D"):
        polyphase.resample(np.zeros((4, 4, 4), np.float32), 2, 3,
                           device="cpu")


def test_entry_points_need_a_card_by_default():
    """Without a card the default device raises; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    x = np.zeros(4096, np.complex64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        polyphase.resample(x, 2, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        polyphase.streaming_resampler(2, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fused.resample_demod_packed_planar(
            np.zeros((1, 2, sum(fused.raw_geometry(CFG, 2, 3)[:3])),
                     np.float32), None, CFG, 2, 3)


# --- fused: geometry, quantize, front half -----------------------------------

@pytest.mark.parametrize("kw,rate_in", [
    (dict(), 10e6), (dict(), 8e6), (dict(channel_rate=4e6), 6e6),
    (dict(channel_rate=4e6, block_size=1 << 16), 6e6),
    (dict(channel_rate=4e6, block_size=1_024_000), 2.4e6),
    (dict(), 2e6)])
def test_raw_geometry_matches_reference(kw, rate_in):
    jc, tc = _cfgs(**kw)
    pq = jpoly.rational_rate(rate_in, jc.channel_rate)
    want = jfused.raw_geometry(jc, *pq)
    got = fused.raw_geometry(tc, *pq)
    assert got == want
    rl, rb, rr, off = got
    gi = 128 * pq[1]
    assert rl % gi == 0 and rb % gi == 0 and rr % gi == 0 and off >= 0


def test_raw_geometry_rejects_like_reference():
    """2.4 -> 2 Msps (p/q = 5/6) at blocks of 2^20 fails the block gate
    (block_size % 640), a block of 2^16 + 128 fails at 6 -> 4 Msps, and
    p*q above 256 fails the matrix cap: the fused path is refused and the
    CLI takes the host resample path."""
    cases = [(dict(), 5, 6),
             (dict(channel_rate=4e6, block_size=(1 << 16) + 128), 2, 3),
             (dict(block_size=17 * 19 * 128 * 16), 17, 19)]
    for kw, p, q in cases:
        jc, tc = _cfgs(**kw)
        with pytest.raises(ValueError):
            jfused.raw_geometry(jc, p, q)
        with pytest.raises(ValueError):
            fused.raw_geometry(tc, p, q)


def test_fused_gate_for_rtl_sdr_rates():
    """_fused_resample_ok: on a card, 2.4 -> 4 Msps at blocks of 1,024,000
    (250 x 4096, 1600 x 640; tile 8192) takes the fused path; 2.4 -> 2
    Msps at blocks of 2^20 does not; on the CPU neither does."""
    from airmodes_torch.apps.modes_rx import _fused_resample_ok
    from airmodes_torch.kernels.preamble import default_tile
    rtl = DspConfig(channel_rate=4e6, block_size=1_024_000)
    assert default_tile(rtl) == 8192
    assert _fused_resample_ok(rtl, 2.4e6, "cuda")
    assert not _fused_resample_ok(DspConfig(), 2.4e6, "cuda")
    assert _fused_resample_ok(DspConfig(), 10e6, "cuda")
    assert not _fused_resample_ok(rtl, 2.4e6, "cpu")


def test_quantize_i8_matches_host_rule():
    """Round half to even, clip to +-127, NaN to 0, +-Inf saturates: the
    device quantize equals the host rule and the reference's, exactly."""
    lace = np.array([np.nan, np.inf, -np.inf, 0.4, -127.6, 200.0, -0.5,
                     0.5, 1.5, 2.5, -2.5, 126.5, -126.5], np.float32)
    rng = np.random.default_rng(9)
    x = np.concatenate([lace, (rng.standard_normal(4096) * 90)
                        .astype(np.float32)])
    for gain in (1.0, 0.73, 127.0):
        got = fused.quantize_i8(torch.from_numpy(x), gain).numpy()
        assert np.array_equal(got, host.quantize_i8_np(x, gain))
        assert np.array_equal(got, np.asarray(jfused.quantize_i8(x, gain)))


def _raw_capture(n_windows, snr_db=15.0, n_msgs=6, seed=7, cfg=JCFG,
                 pq=(P_UP, Q_DN), rate=6e6):
    _, rb, _, _ = jfused.raw_geometry(cfg, *pq)
    total = n_windows * rb
    frames = encoder.random_df17_frames(n_msgs, seed=seed)
    return encoder.make_capture(
        frames, rate=rate, snr_db=snr_db, spacing=total // (n_msgs + 1),
        seed=seed, total_samples=total)


def _windows(iq_raw, cfg=JCFG, pq=(P_UP, Q_DN)):
    rl, rb, rr, _ = jfused.raw_geometry(cfg, *pq)
    fr = jax_framer(cfg, geometry=(rl, rb, rr))
    return list(fr.push(iq_raw)) + list(fr.flush())


def _planar(w):
    return np.stack([w.real, w.imag]).astype(np.float32)[None]


@pytest.fixture(scope="module")
def capture2():
    """Two raw windows of a 6 Msps capture at 15 dB, and the truth."""
    iq_raw, truth = _raw_capture(2, snr_db=15.0, n_msgs=8, seed=11)
    return iq_raw, truth, _windows(iq_raw)


def test_buffered_framer_geometry_matches_reference(capture2):
    from airmodes_torch.io.sources import buffered_framer
    iq_raw, _, want = capture2
    rl, rb, rr, _ = fused.raw_geometry(CFG, P_UP, Q_DN)
    fr = buffered_framer(CFG, geometry=(rl, rb, rr))
    got = list(fr.push(iq_raw[:70001])) + list(fr.push(iq_raw[70001:])) \
        + list(fr.flush())
    assert len(got) == len(want)
    for (a, sa), (b, sb) in zip(got, want):
        assert sa == sb and np.array_equal(a, b)


def _front_agrees(got, want, g_got, g_want):
    np.testing.assert_allclose(g_got, g_want, rtol=1e-6)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max(initial=0) <= 1
    assert (d > 0).mean() <= 1e-4


@pytest.mark.parametrize("gain", [None, 100.0, "per-channel"])
def test_front_half_matches_reference(capture2, gain):
    """resample_quantize_planar on two channels: the port's against the
    reference's, with device AGC, a scalar gain and a (C,) gain."""
    _, _, wins = capture2
    x = np.concatenate([_planar(w) for w, _ in wins])
    g = (np.float32([90.0, 140.0]) if gain == "per-channel"
         else None if gain is None else np.float32(gain))
    y_want, g_want = jfused.resample_quantize_planar(x, g, JCFG, P_UP, Q_DN)
    y_got, g_got = fused.resample_quantize_planar(torch.from_numpy(x), g,
                                                  CFG, P_UP, Q_DN)
    assert y_got.dtype == torch.int8 and tuple(y_got.shape) == \
        np.asarray(y_want).shape
    _front_agrees(y_got.numpy(), np.asarray(y_want), g_got.numpy(),
                  np.asarray(g_want))


def test_front_half_rejects_wrong_window(capture2):
    with pytest.raises(ValueError, match="planar"):
        fused.resample_quantize_planar(torch.zeros(1, 2, 1000), None, CFG,
                                       P_UP, Q_DN)


def test_planar_demod_on_reference_int8(capture2):
    """The port's planar demod fed the reference's own int8 (its fused
    front half, on the CPU) gives the reference's fused packed tables:
    every int32 column exactly, noise within rtol 1e-5."""
    from airmodes_torch.kernels.preamble import (demod_batch_packed_planar,
                                                 planar_length)
    _, _, wins = capture2
    x = np.concatenate([_planar(w) for w, _ in wins])
    want, _ = jfused.resample_demod_packed_planar_jit(
        x, None, JCFG, P_UP, Q_DN, interpret=True)
    want = np.asarray(want)
    y8, _ = jfused.resample_quantize_planar(x, None, JCFG, P_UP, Q_DN)
    y8 = np.asarray(y8)
    plen = planar_length(CFG)
    xi = np.zeros((len(x), plen), np.int8)
    xq = np.zeros((len(x), plen), np.int8)
    xi[:, :y8.shape[2]], xq[:, :y8.shape[2]] = y8[:, 0], y8[:, 1]
    got = demod_batch_packed_planar(xi, xq, CFG, device="cpu").numpy()
    cols = [0, 1, 2, 3, 5, 6, 7, 8]
    assert (want[:, :-1, 0] >= 0).sum() >= 8
    assert np.array_equal(got[..., cols], want[..., cols])
    np.testing.assert_allclose(got[..., :-1, 4].view(np.float32),
                               want[..., :-1, 4].view(np.float32),
                               rtol=1e-5)


def test_fused_oracle_parity_sps2_15db(capture2):
    """The port's fused demod against the reference's numpy oracle on
    exactly the int8 stream the fused demod sees: the same decodes,
    index for index, at 15 dB."""
    _, truth, wins = capture2
    iq_raw = capture2[0]
    gain = np.float32(120.0 / float(np.abs(iq_raw).max()))
    got, ref = [], []
    for w, s in wins:
        x = torch.from_numpy(_planar(w))
        table, _ = fused.resample_demod_planar(x, gain, CFG, P_UP, Q_DN)
        assert tuple(table.index.shape) == (1, CFG.max_detections)
        packed = fused.resample_demod_packed_planar(x, gain, CFG, P_UP, Q_DN,
                                                    device="cpu")[0]
        sub = unpack_table(packed.numpy()[0])
        start = s * P_UP // Q_DN
        for m in host.table_to_messages(sub, start, CFG.channel_rate):
            idx = int(float(m.split()[5]) * CFG.channel_rate + 0.5) - start
            got.append((idx, m.split()[1], start))
        y8 = fused.resample_quantize_planar(x, gain, CFG, P_UP, Q_DN)[0]
        y8 = y8.numpy()[0]
        iq8 = y8[0].astype(np.float32) + 1j * y8[1].astype(np.float32)
        for idx, hexmsg in golden.reference_decode(iq8, JCFG):
            own = idx - CFG.left_halo
            if 0 <= own < CFG.block_size:
                ref.append((own, hexmsg, start))
    assert sorted(got) == sorted(ref)
    want = {t.hex for t in truth}
    assert len(want - {h for _, h, _ in got}) <= 1, want


def test_fused_front_matches_offline_resample():
    """The fused front half of each window equals the offline resample of
    the whole stream, quantized, on every owned sample (to +-1 on at most
    1e-3 of samples: the matmuls' summation order)."""
    iq_raw, _ = _raw_capture(2, snr_db=20.0, seed=13)
    gain = np.float32(100.0)
    y_off = polyphase.resample(iq_raw, P_UP, Q_DN, device="cpu").numpy()
    xi_off = host.quantize_i8_np(y_off.real, float(gain))
    xq_off = host.quantize_i8_np(y_off.imag, float(gain))
    for w, s in _windows(iq_raw):
        y8 = fused.resample_quantize_planar(
            torch.from_numpy(_planar(w)), gain, CFG, P_UP, Q_DN)[0].numpy()[0]
        start = s * P_UP // Q_DN
        ref_i = xi_off[start: start + CFG.block_size]
        ref_q = xq_off[start: start + CFG.block_size]
        n = len(ref_i)
        own = slice(CFG.left_halo, CFG.left_halo + n)
        di = np.abs(y8[0, own].astype(np.int32) - ref_i.astype(np.int32))
        dq = np.abs(y8[1, own].astype(np.int32) - ref_q.astype(np.int32))
        assert di.max(initial=0) <= 1 and dq.max(initial=0) <= 1
        assert (di > 0).mean() < 1e-3 and (dq > 0).mean() < 1e-3


def test_device_agc_and_identity_passthrough():
    """gain=None: per-channel AGC on the resampled waveform (peak ->
    120); p = q = 1 passes the window through, quantized, instead of the
    half-sample group interpolator."""
    iq_raw, _ = _raw_capture(1, snr_db=20.0, seed=37)
    w, _ = _windows(iq_raw)[0]
    y8, gains = fused.resample_quantize_planar(torch.from_numpy(_planar(w)),
                                               None, CFG, P_UP, Q_DN)
    assert tuple(gains.shape) == (1,) and float(gains[0]) > 0
    assert 115 <= int(y8.abs().max()) <= 120
    jc1, cfg1 = _cfgs(channel_rate=2e6, block_size=1 << 16,
                      max_detections=16)
    rl, rb, rr, _ = fused.raw_geometry(cfg1, 1, 1)
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((rl + rb + rr, 2)) * 0.1).astype(np.float32)
    xp = np.ascontiguousarray(w.T)[None]
    y1, _ = fused.resample_quantize_planar(torch.from_numpy(xp),
                                           np.float32(100.0), cfg1, 1, 1)
    y1 = y1.numpy()[0]
    win = cfg1.left_halo + cfg1.block_size + cfg1.right_halo
    lo = rl - cfg1.left_halo
    ref = host.quantize_i8_np(w[lo: lo + win], 100.0)
    assert np.array_equal(y1[0], ref[:, 0]) and np.array_equal(y1[1],
                                                               ref[:, 1])
    want = np.asarray(jfused.resample_quantize_planar(
        xp, np.float32(100.0), jc1, 1, 1)[0])[0]
    assert np.array_equal(y1, want)


def test_resampler_group_delay_unbiased():
    """The prototype's group delay cancels the anchor advance exactly: a
    p/q-then-q/p round trip of band-limited noise has zero delay."""
    rng = np.random.default_rng(0)
    n = 1 << 14
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    X = np.fft.fft(x)
    X[n // 8: -n // 8] = 0
    x = np.fft.ifft(X).astype(np.complex64)
    for p, q in ((2, 3), (3, 2), (1, 4), (5, 3)):
        y = polyphase.resample(polyphase.resample(x, p, q, device="cpu"),
                               q, p, device="cpu").numpy()
        m = min(len(x), len(y))
        a, b = x[256: m - 256], y[256: m - 256]
        S = np.fft.fft(b) * np.conj(np.fft.fft(a))
        k = np.fft.fftfreq(len(S))
        band = np.abs(k) < 0.1
        lag = -np.polyfit(k[band], np.angle(S[band]), 1)[0] / (2 * np.pi)
        assert abs(lag) < 0.01, (p, q, lag)


def test_fused_nonfinite_raw_samples_do_not_silence_block():
    """A NaN and an Inf raw sample away from the frames: the device AGC
    scans finite values only, the quantize maps NaN to 0, the gains stay
    finite and the frames keep decoding."""
    iq_raw, truth = _raw_capture(1, snr_db=20.0, n_msgs=4, seed=21)
    guard = np.zeros(len(iq_raw), bool)
    for t in truth:
        guard[max(0, t.sample_index - 3000): t.sample_index + 4000] = True
    free = np.flatnonzero(~guard)
    iq_bad = iq_raw.copy()
    iq_bad[free[100]] = complex(np.nan, np.nan)
    iq_bad[free[len(free) // 2]] = complex(np.inf, 0.0)
    got = set()
    for w, s in _windows(iq_bad):
        packed, gains = fused.resample_demod_packed_planar(
            _planar(w), None, CFG, P_UP, Q_DN, device="cpu")
        assert np.isfinite(gains.numpy()).all()
        sub = unpack_table(packed.numpy()[0])
        got |= {m.split()[1] for m in host.table_to_messages(
            sub, s * P_UP // Q_DN, CFG.channel_rate)}
    want = {t.hex for t in truth}
    assert len(want - got) <= 1, want - got


# --- the runners and the host path -------------------------------------------

def _write(tmp_path, name, iq):
    path = str(tmp_path / name)
    iq.astype(np.complex64).tofile(path)
    return path


@pytest.fixture(scope="module")
def capture3(tmp_path_factory):
    iq_raw, truth = _raw_capture(3, snr_db=18.0, n_msgs=9, seed=17)
    path = str(tmp_path_factory.mktemp("rs") / "cap3.c64")
    iq_raw.astype(np.complex64).tofile(path)
    return path, truth


def test_run_resampled_fused_matches_reference(capture3):
    """The fused runner end to end on the CPU against the reference's:
    the same messages under the contract, the truth decoded, stats
    consistent, timestamps monotonic across blocks."""
    from airmodes.io.stream import run_resampled_fused as jax_run
    from airmodes_torch.io.stream import run_resampled_fused
    path, truth = capture3
    want = _flat(jax_run(path, JCFG, dtype="complex64", rate_in=6e6,
                         batch=2))
    stats = host.BlockStats()
    seen = []
    blocks = list(run_resampled_fused(path, CFG, dtype="complex64",
                                      rate_in=6e6, batch=2, stats=stats,
                                      on_messages=seen.append,
                                      device="cpu"))
    got = _flat(blocks)
    _same_messages(got, want)
    assert seen == blocks
    assert len({t.hex for t in truth} - {m.split()[1] for m in got}) <= 1
    assert stats.emitted == len(got) and stats.crc_ok > 0
    ts = [float(m.split()[5]) for m in got]
    assert ts == sorted(ts)


def test_run_resampled_fused_max_blocks_and_scale(capture3):
    """max_blocks stops early; a fixed gain (scale) replaces the AGC."""
    from airmodes.io.stream import run_resampled_fused as jax_run
    from airmodes_torch.io.stream import run_resampled_fused
    path, _ = capture3
    kw = dict(dtype="complex64", rate_in=6e6, batch=2, max_blocks=2,
              scale=300.0)
    want = list(jax_run(path, JCFG, **kw))
    got = list(run_resampled_fused(path, CFG, device="cpu", **kw))
    assert len(got) == len(want) == 2
    _same_messages(_flat(got), _flat(want))


def test_run_resampled_fused_start_sample(capture3):
    """Resume: start_sample (channel-rate units) seeks the raw capture and
    keeps the global counter continuous; the same as the reference's."""
    from airmodes.io.stream import run_resampled_fused as jax_run
    from airmodes_torch.io.stream import run_resampled_fused
    path, truth = capture3
    start = CFG.block_size
    got = _flat(run_resampled_fused(path, CFG, dtype="complex64",
                                    rate_in=6e6, start_sample=start,
                                    device="cpu"))
    want = _flat(jax_run(path, JCFG, dtype="complex64", rate_in=6e6,
                         start_sample=start))
    _same_messages(got, want)
    late = {t.hex for t in truth
            if t.sample_index * P_UP // Q_DN >= start + CFG.left_halo}
    assert late <= {m.split()[1] for m in got}
    assert all(float(m.split()[5]) * CFG.channel_rate >= start for m in got)


def test_run_resampled_fused_snapped_resume_with_epoch(capture3):
    """An odd resume point snaps down to a multiple of p; messages before
    the requested sample are dropped by the int64-ns field, relative to
    the epoch (a float-seconds form lets every message through at a real
    epoch)."""
    from airmodes.io.stream import run_resampled_fused as jax_run
    from airmodes_torch.io.stream import run_resampled_fused
    path, _ = capture3
    epoch = 1.7e9
    epoch_ns = int(round(epoch * 1e9))

    def index(m):
        ns = int(m.split()[6]) - epoch_ns
        return (ns * int(CFG.channel_rate) + 500_000_000) // 1_000_000_000

    full = {m.split()[1]: index(m) for m in _flat(run_resampled_fused(
        path, CFG, dtype="complex64", rate_in=6e6, epoch=epoch,
        device="cpu"))}
    cand = sorted((si, h) for h, si in full.items()
                  if si % P_UP == 0 and si > 0)
    assert cand
    si, boundary_hex = cand[len(cand) // 2]
    req = si + 1
    msgs = _flat(run_resampled_fused(path, CFG, dtype="complex64",
                                     rate_in=6e6, start_sample=req,
                                     epoch=epoch, device="cpu"))
    got = {m.split()[1]: index(m) for m in msgs}
    assert all(s >= req for s in got.values()), got
    assert boundary_hex not in got
    assert {h for h, s in full.items() if s >= req} <= set(got)
    _same_messages(msgs, _flat(jax_run(path, JCFG, dtype="complex64",
                                       rate_in=6e6, start_sample=req,
                                       epoch=epoch)))


def test_run_resampled_fused_channels_matches_reference(tmp_path):
    """Two captures of different lengths, one batched step per time step;
    the shorter channel ends first and yields None; the same messages as
    the reference's runner."""
    from airmodes.io.stream import run_resampled_fused_channels as jax_run
    from airmodes_torch.io.stream import run_resampled_fused_channels
    paths, truths = [], []
    for c, n_win in enumerate((1, 2)):
        iq_raw, truth = _raw_capture(n_win, snr_db=20.0, n_msgs=3 * n_win,
                                     seed=23 + c)
        paths.append(_write(tmp_path, f"ch{c}.c64", iq_raw))
        truths.append({t.hex for t in truth})
    stats = host.BlockStats()
    steps = list(run_resampled_fused_channels(
        paths, CFG, dtype="complex64", rate_in=6e6, stats=stats,
        device="cpu"))
    want = list(jax_run(paths, JCFG, dtype="complex64", rate_in=6e6))
    assert len(steps) == len(want) == 2
    assert steps[1][0] is None and steps[1][1] is not None
    for a, b in zip(steps, want):
        for ca, cb in zip(a, b):
            assert (ca is None) == (cb is None)
            _same_messages(ca or [], cb or [])
    for c in range(2):
        got = {m.split()[1] for st in steps for m in (st[c] or [])}
        assert len(truths[c] - got) <= 1
    assert stats.emitted == sum(len(m or []) for st in steps for m in st)


def _write_wire(tmp_path, name, iq, fmt):
    """A capture in a file format's words (sc16: int16 pairs, uc8: uint8
    pairs offset by 127.5), at 0.9 of its full scale."""
    x = iq / float(np.max(np.abs(iq))) * 0.9
    if fmt == "sc16":
        w = np.round(np.stack([x.real, x.imag], -1) * 32767).astype(np.int16)
    else:
        w = np.round(np.stack([x.real, x.imag], -1) * 127.5
                     + 127.5).astype(np.uint8)
    path = str(tmp_path / name)
    w.tofile(path)
    return path


@pytest.mark.parametrize("fmt", ["sc16", "uc8"])
def test_run_resampled_fused_wire_formats_match_reference(tmp_path, fmt):
    """sc16 and uc8 captures through the fused runner (their words sent
    as read, converted by R1's plain version) against the reference's
    runner, which converts on the host: three windows at batch 2 (a
    partial last batch), then max_blocks, then a resume point that snaps
    down to a multiple of p."""
    from airmodes.io.stream import run_resampled_fused as jax_run
    from airmodes_torch.io.stream import run_resampled_fused
    iq_raw, truth = _raw_capture(3, snr_db=18.0, n_msgs=9, seed=17)
    path = _write_wire(tmp_path, f"cap3.{fmt}", iq_raw, fmt)
    cases = [dict(batch=2), dict(batch=2, max_blocks=2),
             dict(start_sample=CFG.block_size + 1)]
    runs = []
    for kw in cases:
        kw.update(dtype=fmt, rate_in=6e6)
        got = list(run_resampled_fused(path, CFG, device="cpu", **kw))
        want = list(jax_run(path, JCFG, **kw))
        assert len(got) == len(want), kw
        _same_messages(_flat(got), _flat(want))
        runs.append(got)
    assert [len(r) for r in runs] == [3, 2, 2]
    assert len({t.hex for t in truth} - {m.split()[1]
                                          for m in _flat(runs[0])}) <= 1


@pytest.mark.parametrize("fmt", ["sc16", "uc8"])
def test_run_resampled_fused_channels_wire_formats_match_reference(tmp_path,
                                                                   fmt):
    """Two sc16 or uc8 captures of 1 and 2 windows through the channels
    runner: the shorter channel ends first and yields None; the same
    messages as the reference's runner."""
    from airmodes.io.stream import run_resampled_fused_channels as jax_run
    from airmodes_torch.io.stream import run_resampled_fused_channels
    paths = []
    for c, n_win in enumerate((1, 2)):
        iq_raw, _ = _raw_capture(n_win, snr_db=20.0, n_msgs=3 * n_win,
                                 seed=23 + c)
        paths.append(_write_wire(tmp_path, f"ch{c}.{fmt}", iq_raw, fmt))
    steps = list(run_resampled_fused_channels(paths, CFG, dtype=fmt,
                                              rate_in=6e6, device="cpu"))
    want = list(jax_run(paths, JCFG, dtype=fmt, rate_in=6e6))
    assert len(steps) == len(want) == 2
    assert steps[1][0] is None and steps[1][1] is not None
    for a, b in zip(steps, want):
        for ca, cb in zip(a, b):
            assert (ca is None) == (cb is None)
            _same_messages(ca or [], cb or [])
    assert sum(len(m or []) for st in steps for m in st) > 0


def test_host_path_matches_fused_path(capture3):
    """The two resampled routes of the CLI, on the same capture: the host
    path (streaming resampler -> framed blocks -> run_pipelined with int8
    quantize, batches of 2: the planar path) and the fused runner give
    the same messages under the contract."""
    from airmodes_torch.io.stream import run_pipelined, run_resampled_fused
    path, _ = capture3
    host_msgs = _flat(run_pipelined(
        sources.resampled_file_source(path, CFG, dtype="complex64",
                                      rate_in=6e6, device="cpu"),
        CFG, quantize_i8=True, batch=2, device="cpu"))
    fused_msgs = _flat(run_resampled_fused(path, CFG, dtype="complex64",
                                           rate_in=6e6, batch=2,
                                           device="cpu"))
    assert fused_msgs
    _same_messages(host_msgs, fused_msgs)


@pytest.mark.parametrize("start", [0, 70001])
def test_resampled_file_source_matches_reference(capture3, start):
    from airmodes.io.sources import resampled_file_source as jax_src
    path, _ = capture3
    want = list(jax_src(path, JCFG, dtype="complex64", rate_in=6e6,
                        start_sample=start))
    got = list(sources.resampled_file_source(path, CFG, dtype="complex64",
                                             rate_in=6e6, start_sample=start,
                                             device="cpu"))
    assert [s for _, s in got] == [s for _, s in want]
    for (a, _), (b, _) in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_rtl_sdr_2p4_to_4_fused_matches_host_path(tmp_path):
    """rtl-sdr at 2.4 Msps to 4 Msps (p/q = 5/3) at blocks of 1,024,000:
    the fused runner and the host path give the same messages, every
    frame decodes, and the front half agrees with the reference's. The
    2.4 Msps capture is a 12 Msps encoding band-limited and decimated by
    the reference's resampler; frames start at one sub-sample phase (9 of
    15 samples at 12 Msps) that decodes after the 5/3 resample (the
    reference's own path misses frames at phase 4 as the port does)."""
    from airmodes_torch.io.stream import run_pipelined, run_resampled_fused
    jc, cfg = _cfgs(channel_rate=4e6, block_size=1_024_000,
                    max_detections=64)
    frames = encoder.random_df17_frames(8, seed=33)
    iq12, truth = encoder.make_capture(frames, rate=12e6, snr_db=25.0,
                                       spacing=100_005, start=1029, seed=33,
                                       total_samples=5 * 700_000)
    iq24 = np.asarray(jpoly.resample(iq12, 1, 5))
    path = _write(tmp_path, "rtl.c64", iq24)
    fused_msgs = _flat(run_resampled_fused(path, cfg, dtype="complex64",
                                           rate_in=2.4e6, batch=2,
                                           device="cpu"))
    host_msgs = _flat(run_pipelined(
        sources.resampled_file_source(path, cfg, dtype="complex64",
                                      rate_in=2.4e6, device="cpu"),
        cfg, quantize_i8=True, batch=2, device="cpu"))
    _same_messages(host_msgs, fused_msgs)
    assert {t.hex for t in truth} <= {m.split()[1] for m in fused_msgs}
    w, _ = _windows(iq24, jc, (5, 3))[0]
    y_want, g_want = jfused.resample_quantize_planar(_planar(w), None, jc,
                                                     5, 3)
    y_got, g_got = fused.resample_quantize_planar(
        torch.from_numpy(_planar(w)), None, cfg, 5, 3)
    _front_agrees(y_got.numpy(), np.asarray(y_want), g_got.numpy(),
                  np.asarray(g_want))


# --- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_fused_step_matches_cpu(cuda, capture2):
    """The fused step on the card against the CPU: gains rtol 1e-6, int8
    >= 99.99% equal and never more than 1 apart, and the messages of
    each window under the contract."""
    from airmodes_torch.kernels import preamble as K
    _, _, wins = capture2
    x = torch.from_numpy(np.concatenate([_planar(w) for w, _ in wins]))
    y_card, g_card = fused.resample_quantize_planar(x.to(cuda), None, CFG,
                                                    P_UP, Q_DN)
    y_cpu, g_cpu = fused.resample_quantize_planar(x, None, CFG, P_UP, Q_DN)
    _front_agrees(y_card.cpu().numpy(), y_cpu.numpy(), g_card.cpu().numpy(),
                  g_cpu.numpy())
    K.reset_launches()
    on_card, gc = fused.resample_demod_packed_planar(x, None, CFG, P_UP,
                                                     Q_DN, device=cuda)
    on_card = on_card.cpu().numpy()
    assert K.DETECT_CANDS_ROUTES["B1"] > 0 and K.LAUNCHES["slice_windows"] > 0
    on_cpu, gp = fused.resample_demod_packed_planar(x, None, CFG, P_UP,
                                                    Q_DN, device="cpu")
    for j, (_, s) in enumerate(wins):
        _same_messages(
            host.table_to_messages(unpack_table(on_card[j]), s, 4e6,
                                   full_scale=float(gc[j]) / 127.0),
            host.table_to_messages(unpack_table(on_cpu.numpy()[j]), s, 4e6,
                                   full_scale=float(gp[j]) / 127.0))


@pytest.mark.gpu
def test_cuda_resampler_runs_without_tf32(cuda):
    """TF32 stays off for the resampler's matmuls, even after a caller
    turned it on: the results match the CPU to f32 rounding, not to
    TF32's 1e-3."""
    torch.backends.cuda.matmul.allow_tf32 = True
    x = _noise(1 << 16, 12)
    got = polyphase.resample(x, 2, 3, device=cuda).cpu().numpy()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    np.testing.assert_allclose(got, polyphase.resample(x, 2, 3,
                                                       device="cpu").numpy(),
                               rtol=RTOL, atol=ATOL)
