"""Planar int8 demod path of the PyTorch port against the JAX reference.

Both packages get the same int8 captures, made with numpy from fixed seeds.
The JAX side runs the Pallas kernels in interpret mode, as tests/test_pallas.py
does; the port runs its kernels' plain versions on the CPU. Discrete
results must be equal; the noise column is compared within rtol 1e-5 (the
two frameworks reduce the 128-sample mean in different orders).
"""

import dataclasses
from fractions import Fraction

import numpy as np
import pytest
import torch

from airmodes.config import DspConfig as JaxCfg
from airmodes.dsp import pipeline as JP
from airmodes.io import sources
from airmodes.kernels import preamble_pallas as JK
from airmodes.testing import encoder
from airmodes_torch.config import DspConfig
from airmodes_torch.dsp import host as thost
from airmodes_torch.dsp.pipeline import fma_f32, unpack_table
from airmodes_torch.kernels import preamble as TK

TILE = 4096
INT_COLS = [0, 1, 2, 3, 5, 6, 7, 8]    # every packed column but noise (4)


def _cfgs(**kw):
    jc = JaxCfg(**kw)
    return jc, DspConfig.from_dict(dataclasses.asdict(jc))


def _i8_blocks(iq, cfg, gain=None, n=None):
    """Frame a capture and quantize each block (AGC 120/peak unless a fixed
    gain is given), as the reference's planar tests do."""
    out = []
    for block, _ in sources.frame_blocks(iq, cfg):
        x = JP.iq_to_device_layout(block)
        g = gain if gain is not None else 120.0 / (float(np.max(np.abs(x)))
                                                   or 1.0)
        out.append(np.clip(np.round(x * g), -127, 127).astype(np.int8))
    return np.stack(out[:n])


def _planar(jc, seed, n_frames=16, snr=14.0, spacing=1200, n=2):
    frames = encoder.random_mixed_frames(n_frames, seed=seed)
    iq, truth = encoder.make_capture(frames, rate=jc.channel_rate,
                                     snr_db=snr, spacing=spacing * jc.sps,
                                     seed=seed)
    return JK.to_planar_i8(_i8_blocks(iq, jc, n=n), jc, tile=TILE), truth


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --- numerics ----------------------------------------------------------------

def _round_f32(fr: Fraction) -> float:
    """Round a dyadic rational to float32, ties to even."""
    if fr == 0:
        return 0.0
    n, e = fr.numerator, -(fr.denominator.bit_length() - 1)
    sh = n.bit_length() - 24
    if sh > 0:
        q, rem, half = n >> sh, n & ((1 << sh) - 1), 1 << (sh - 1)
        if rem > half or (rem == half and q & 1):
            q += 1
        n, e = q, e + sh
    return float(np.float32(n * 2.0 ** e))


def test_power_is_single_rounded_fma_for_every_int8_pair():
    """power_i8 takes fma(xi, xi, xq*xq) through float64; that equals one
    f32 rounding of the exact value for all 65536 int8 pairs."""
    v = np.arange(-128, 128, dtype=np.int8)
    a, b = np.meshgrid(v, v, indexing="ij")
    got = TK.power_i8(_t(a.ravel()), _t(b.ravel())).numpy().reshape(256, 256)
    x = np.arange(-128, 128).astype(np.float32) * np.float32(1.0 / 127.0)
    want = np.empty((256, 256), np.float32)
    for i, xi in enumerate(x):
        sq = Fraction(float(xi)) ** 2
        for j, xq in enumerate(x):
            want[i, j] = _round_f32(sq + Fraction(float(np.float32(xq * xq))))
    np.testing.assert_array_equal(got, want)


def _exact_fma(a, b, c) -> float:
    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    return _round_f32(v) if v >= 0 else -_round_f32(-v)


def _tie_cases(n):
    """(a, b, c) with a*b + c a hair above an f32 tie whose float64 sum
    rounds onto the tie itself, where rounding twice (to float64, then to
    f32 ties-to-even) gives the wrong neighbour: a*b = 2^-24 (1 + rho),
    0 < rho < 2^-29, and c = 1 + k 2^-23 with k even."""
    out = []
    for i in range(11863283, 11863283 + 200000):     # A ~ sqrt(2)
        A = i * 2.0 ** -23
        j = -(-(2.0 / A - 1.0) // 2.0 ** -23)        # smallest B >= 2/A
        B = 1.0 + j * 2.0 ** -23
        rho = Fraction(A) * Fraction(B) / 2 - 1
        if 0 < rho < Fraction(1, 1 << 29):
            k = 2 * len(out)
            out.append((np.float32(A), np.float32(B * 2.0 ** -25),
                        np.float32(1.0 + k * 2.0 ** -23)))
            if len(out) == n:
                return out
    raise AssertionError("too few tie cases")


def test_fma_f32_is_correctly_rounded():
    """fma_f32 == one rounding of the exact a*b + c, on seeded random f32
    triples of mixed signs and scales, and on constructed double-rounding
    ties, where the float64 detour alone rounds the wrong way."""
    rng = np.random.default_rng(11)
    n = 3000
    a = (rng.standard_normal(n) * 2.0 ** rng.integers(-8, 8, n)
         ).astype(np.float32)
    b = (rng.standard_normal(n) * 2.0 ** rng.integers(-8, 8, n)
         ).astype(np.float32)
    c = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 4, n)
         ).astype(np.float32)
    ties = _tie_cases(16)
    ta, tb, tc = (np.array(v, np.float32) for v in zip(*ties))
    naive = (ta.astype(np.float64) * tb + tc).astype(np.float32)
    want_t = np.array([_exact_fma(*t) for t in ties], np.float32)
    assert (naive != want_t).all()          # each case defeats the detour
    a, b, c = (np.concatenate([u, v]) for u, v in ((a, ta), (b, tb), (c, tc)))
    got = fma_f32(_t(a), _t(b), _t(c)).numpy()
    want = np.array([_exact_fma(*t) for t in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    # the negated ties round the other way, and a Python-float factor
    np.testing.assert_array_equal(
        fma_f32(_t(-ta), _t(tb), _t(-tc)).numpy(), -want_t)
    fifth = np.float32(0.2)
    np.testing.assert_array_equal(
        fma_f32(_t(a), float(fifth), _t(c)).numpy(),
        np.array([_exact_fma(x, fifth, z) for x, z in zip(a, c)],
                 np.float32))


# --- kernel B1 ---------------------------------------------------------------

@pytest.fixture(scope="module")
def captures():
    """One 2-block planar capture per sample rate, shared by the B1 cases."""
    out = {}
    for rate in (2e6, 4e6, 10e6):
        jc, _ = _cfgs(channel_rate=rate, block_size=1 << 14,
                      max_detections=32)
        out[rate] = _planar(jc, seed=90 + int(rate // 1e6))[0]
    return out


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("rate", [2e6, 4e6, 10e6])
@pytest.mark.parametrize("nbuf", [1, 2])
def test_detect_cands_plain_matches_jax(captures, nbuf, rate, mxu):
    """B1's plain version == preamble_detect_cands_planar(ordered=False),
    exactly, at sps 1, 2 and 5. The JAX kernel takes the noise sum as
    matmuls when mxu_window_sum is set and the port always folds; on these
    captures the candidate blocks are still identical."""
    jc, tc = _cfgs(channel_rate=rate, block_size=1 << 14, max_detections=32,
                   mxu_window_sum=mxu)
    xi, xq = captures[rate]
    want = np.asarray(JK.preamble_detect_cands_planar(
        xi, xq, jc, tile=TILE, interpret=True, ordered=False, nbuf=nbuf))
    got = TK.preamble_detect_cands_planar(_t(xi), _t(xq), tc, tile=TILE,
                                          nbuf=nbuf, ordered=False).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[:, :, 4].sum() > 0


def test_detect_cands_dense_traffic_matches_jax():
    """Dense traffic (more hits per block than K) at a low SNR, where the
    threshold decisions are marginal: candidate blocks equal exactly."""
    jc, tc = _cfgs(block_size=1 << 14, max_detections=8,
                   mxu_window_sum=False)
    (xi, xq), _ = _planar(jc, seed=7, n_frames=40, snr=9.0, spacing=700)
    want = np.asarray(JK.preamble_detect_cands_planar(
        xi, xq, jc, tile=TILE, interpret=True, ordered=False))
    got = TK.preamble_detect_cands_planar(_t(xi), _t(xq), tc, tile=TILE,
                                          ordered=False).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[0, :, 4].sum() > jc.max_detections


@pytest.mark.parametrize("per_lane", [4, 2])
def test_extract_plain_matches_jax(per_lane):
    """The per-lane first-hits extraction == _extract_cands_unordered,
    including lanes with more than 4 hits."""
    import jax
    rng = np.random.default_rng(per_lane)
    trows, tiles = 32, 3
    keep = np.zeros((tiles, trows, 128), bool)
    keep.reshape(-1)[rng.choice(keep.size, 200, replace=False)] = True
    keep[1, :9, 5] = True
    keep[2, ::2, ::8] = True
    want = np.stack([np.asarray(JK._extract_cands_unordered(
        jax.numpy.asarray(k), trows, per_lane)) for k in keep])
    got = TK._extract_plain(_t(keep.reshape(1, -1)), TILE, per_lane)[0]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("trial", range(4))
def test_compact_candidates_matches_jax(trial):
    """compact_candidates_unordered == the reference on candidate blocks
    with more than K hits and more than 4 hits in one lane column."""
    import jax
    rng = np.random.default_rng(13 + trial)
    jc, tc = _cfgs(block_size=4 * TILE, max_detections=48)
    trows, tiles = 32, 4
    keep = np.zeros((tiles, trows, 128), bool)
    keep.reshape(-1)[rng.choice(keep.size, 20 + 40 * trial,
                                replace=False)] = True
    if trial >= 1:
        keep[1, : 3 + trial, 9] = True          # per-lane spill
    if trial >= 3:
        keep[3, ::2, ::4] = True                # far more than K
    cands = np.stack([np.asarray(JK._extract_cands_unordered(
        jax.numpy.asarray(k), trows, 4)) for k in keep])
    want = [np.asarray(a) for a in JK.compact_candidates_unordered(
        jax.numpy.asarray(cands), jc, TILE)]
    got = [a.numpy() for a in TK.compact_candidates_unordered(
        _t(cands), tc, TILE)]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    # batched call: the same per block
    got2 = TK.compact_candidates_unordered(_t(np.stack([cands, cands])),
                                           tc, TILE)
    for w, g in zip(want, got2):
        np.testing.assert_array_equal(g.numpy()[1], w)


def test_unordered_candidate_padding_is_sentinel():
    """Twin of the reference test: candidate rows the kernel did not emit
    carry the sentinel and never read as hits at sample 0."""
    tile, trows = TILE, TILE // 128
    keep = np.zeros((trows, 128), bool)
    keep[3, 17] = True
    _, tc = _cfgs(block_size=tile, max_detections=8)
    cands = TK._extract_plain(_t(keep.reshape(1, -1)), tile, 2)[0]
    assert (cands[0, 2:4].numpy() == trows * 128).all()
    det_idx, valid, n_det, ovf = TK.compact_candidates_unordered(
        cands, tc, tile)
    assert det_idx[valid].tolist() == [3 * 128 + 17]
    assert int(n_det) == 1 and int(ovf) == 0


# --- kernel B2 ---------------------------------------------------------------

def _b2_inputs(rate):
    """Random planar streams of 3 channels and window starts: empty (-1)
    rows, windows at channel starts and at the last owned sample of the
    last channel, random ones, and one at each residue mod 16."""
    jc, tc = _cfgs(channel_rate=rate, block_size=1 << 13, max_detections=8)
    p = JK.planar_length(jc, TILE)
    rng = np.random.default_rng(3)
    xi = rng.integers(-128, 128, (3, p)).astype(np.int8)
    xq = rng.integers(-128, 128, (3, p)).astype(np.int8)
    last = 2 * p + jc.left_halo + jc.block_size - 1 - jc.noise_window
    base = np.array([0, -1, 5, p, p + 1000, -1, 2 * p + 128, last,
                     *rng.integers(0, 3 * p - 8192, 8),
                     *(p + 2048 + 17 * np.arange(16))], np.int32)
    return jc, tc, xi.reshape(-1, 128), xq.reshape(-1, 128), base


@pytest.mark.parametrize("rate", [2e6, 4e6, 10e6])
def test_slice_windows_plain_matches_jax(rate):
    """B2's plain version == slice_windows_planar, exactly, including
    empty (-1) rows, windows at channel starts, at the last owned sample of
    the last channel and at every residue mod 16, at sps 1, 2 and 5."""
    jc, tc, ri, rq, base = _b2_inputs(rate)
    assert sorted(set(base[base >= 0] % 16)) == list(range(16))
    want = np.asarray(JK.slice_windows_planar(ri, rq, base, jc,
                                              interpret=True))
    got = TK.slice_windows_planar(_t(ri), _t(rq), _t(base), tc)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("extra", [0, "half"])
@pytest.mark.parametrize("rate", [2e6, 4e6, 10e6])
def test_slice_windows_main_width_is_prefix(rate, extra):
    """The demod paths' B2 windows (out_rows*128 columns) are the first
    columns of the reference's (pad_rows*128), which holds only zeros past
    them, with and without the prescreen path's widening."""
    jc, tc, ri, rq, base = _b2_inputs(rate)
    extra = jc.nms_chips * jc.sps if extra == "half" else 0
    want = np.asarray(JK.slice_windows_planar(ri, rq, base, jc,
                                              interpret=True, extra=extra))
    cols = TK._slice_cols(tc, extra)
    assert cols == JK._slice_geometry(jc, extra)[1] * 128 < want.shape[1]
    got = TK._slice_windows(_t(ri), _t(rq), _t(base), tc, extra, cols)
    np.testing.assert_array_equal(got.numpy(), want[:, :cols])
    assert not want[:, cols:].any()


# --- the path end to end -----------------------------------------------------

def _packed_pair(jc, tc, xi, xq):
    want = np.asarray(JK.demod_batch_packed_planar_jit(
        xi, xq, jc, tile=TILE, interpret=True))
    got = TK.demod_batch_packed_planar(xi, xq, tc, tile=TILE,
                                       device="cpu").numpy()
    return got, want


def _assert_packed_equal(got, want):
    np.testing.assert_array_equal(got[..., INT_COLS], want[..., INT_COLS])
    np.testing.assert_allclose(got[..., :-1, 4].view(np.float32),
                               want[..., :-1, 4].view(np.float32), rtol=1e-5)
    np.testing.assert_array_equal(got[..., -1, 4], want[..., -1, 4])


def test_planar_path_matches_reference():
    """Twin of test_planar_path_matches_fast: the port's packed tables equal
    demod_batch_packed_planar_jit's in every int32 column."""
    jc, tc = _cfgs(block_size=1 << 15, max_detections=64)
    frames = encoder.random_df17_frames(16, seed=90)
    iq, _ = encoder.make_capture(frames, snr_db=14.0, spacing=2500, seed=90)
    xi, xq = JK.to_planar_i8(_i8_blocks(iq, jc), jc, tile=TILE)
    got, want = _packed_pair(jc, tc, xi, xq)
    _assert_packed_equal(got, want)
    assert (want[:, :-1, 0] >= 0).sum() >= 14


def test_planar_overflow_matches_reference():
    """More hits per block than K: n_detected, n_overflow and the kept
    earliest K equal the reference's."""
    jc, tc = _cfgs(block_size=1 << 14, max_detections=8)
    (xi, xq), _ = _planar(jc, seed=21, n_frames=30, snr=16.0, spacing=900)
    got, want = _packed_pair(jc, tc, xi, xq)
    _assert_packed_equal(got, want)
    assert want[0, -1, 1] > 0


def test_planar_decodes_ground_truth():
    """Twin of the reference test: every injected frame decodes."""
    jc, tc = _cfgs(block_size=1 << 15, max_detections=64)
    frames = encoder.random_df17_frames(6, seed=91)
    iq, truth = encoder.make_capture(frames, snr_db=22.0, spacing=4000,
                                     seed=91, total_samples=jc.block_size)
    got = set()
    for block, start in sources.frame_blocks(iq, jc):
        x = JP.iq_to_device_layout(block)
        x8 = np.clip(np.round(x * (120.0 / float(np.max(np.abs(x))))),
                     -127, 127).astype(np.int8)
        xi, xq = TK.to_planar_i8(x8, tc, tile=TILE)
        packed = TK.demod_batch_packed_planar(xi, xq, tc, tile=TILE,
                                              device="cpu").numpy()
        got |= {m.split()[1] for m in thost.table_to_messages(
            unpack_table(packed[0]), start, tc.channel_rate)}
    assert {t.hex for t in truth} <= got


def test_planar_slice_kernel_block_edge():
    """Twin of the reference test: preambles on the first, a middle and the
    last owned samples of a block decode, and the tables equal JAX's."""
    jc, tc = _cfgs(block_size=1 << 14, max_detections=16)
    frames = encoder.random_df17_frames(3, seed=9)
    iq, truth = encoder.make_capture(
        frames, snr_db=20.0, spacing=8191, start=0, seed=9,
        total_samples=2 * jc.block_size)
    positions = [t.sample_index for t in truth]
    assert positions[-1] >= jc.block_size - 2
    xi, xq = JK.to_planar_i8(_i8_blocks(iq, jc, gain=60.0, n=2), jc,
                             tile=TILE)
    got_p, want = _packed_pair(jc, tc, xi, xq)
    _assert_packed_equal(got_p, want)
    got = {(c, int(r[0])) for c in range(2) for r in got_p[c, :-1]
           if r[0] >= 0 and (r[1] >> 16) in (0, 1, 2)}
    want_pos = {(p // jc.block_size, p % jc.block_size) for p in positions}
    assert want_pos <= got, (sorted(got), sorted(want_pos))


def _odd_sps_tables_equal(rate, seed):
    """At odd sps the chip-energy scale 1/sps is inexact, and XLA on the
    CPU contracts it into the tail's pulse sum as FMAs; the port computes
    the same FMAs, so the tables are equal in every int32 column."""
    jc, tc = _cfgs(channel_rate=rate, block_size=1 << 14, max_detections=32)
    (xi, xq), _ = _planar(jc, seed=seed, n_frames=12, snr=16.0, spacing=1300)
    got, want = _packed_pair(jc, tc, xi, xq)
    _assert_packed_equal(got, want)
    assert (want[:, :-1, 0] >= 0).sum() > 0


def test_planar_sps5_matches_reference():
    _odd_sps_tables_equal(10e6, 95)


def test_planar_sps3_matches_reference():
    _odd_sps_tables_equal(6e6, 96)


def test_planar_geometry_matches_reference():
    for kw in ({}, {"block_size": 1 << 14}, {"channel_rate": 4e6},
               {"block_size": 3 * 4096, "channel_rate": 18e6}):
        jc, tc = _cfgs(**kw)
        assert TK.default_tile(tc) == JK.default_tile(jc)
        assert TK.supported_planar_tile(tc) == JK.supported_planar_tile(jc)
        assert TK.planar_length(tc) == JK.planar_length(jc)
        assert TK._planar_geometry(tc, TK.default_tile(tc)) == \
            JK._planar_geometry(jc, JK.default_tile(jc))
        assert TK._slice_geometry(tc) == JK._slice_geometry(jc)
    _, tc = _cfgs(channel_rate=20e6)
    assert TK.supported_planar_tile(tc) is None
    with pytest.raises(TypeError, match="int8"):
        TK.to_planar_i8(np.zeros((10, 2), np.float32), tc)


def test_entry_point_needs_a_card_by_default():
    """With no card, the default device raises; it never moves to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, tc = _cfgs(block_size=1 << 12, max_detections=4)
    p = TK.planar_length(tc)
    x = np.zeros((1, p), np.int8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TK.demod_batch_packed_planar(x, x, tc)


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [2e6, 4e6, 10e6])
def test_cuda_slice_windows_match_plain(cuda, rate):
    """B2 on the card equals its plain version bit for bit at both widths
    (the demod paths' and the reference's), with and without the
    prescreen path's widening, at every residue mod 16."""
    _, tc, ri, rq, base = _b2_inputs(rate)
    ri, rq, base = _t(ri), _t(rq), _t(base)
    for extra in (0, tc.nms_chips * tc.sps):
        for main in (True, False):
            cols = TK._slice_cols(tc, extra, main)
            got = TK._slice_windows(ri.to(cuda), rq.to(cuda), base.to(cuda),
                                    tc, extra, cols)
            want = TK.slice_windows_plain(ri, rq, base, tc, extra, cols)
            assert torch.equal(got.cpu(), want), (extra, main)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [2e6, 4e6])
def test_cuda_kernels_match_plain(cuda, captures, rate):
    """B1 and B2 on the card equal their plain versions and the reference."""
    jc, tc = _cfgs(channel_rate=rate, block_size=1 << 14, max_detections=32)
    xi, xq = captures[rate]
    want = np.asarray(JK.preamble_detect_cands_planar(
        xi, xq, jc, tile=TILE, interpret=True, ordered=False))
    ci = _t(xi).to(cuda)
    cq = _t(xq).to(cuda)
    got = TK.preamble_detect_cands_planar(ci, cq, tc, tile=TILE,
                                          ordered=False)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    packed = TK.demod_batch_packed_planar(ci, cq, tc, tile=TILE,
                                          device=cuda).cpu().numpy()
    ref = TK.demod_batch_packed_planar(xi, xq, tc, tile=TILE,
                                       device="cpu").numpy()
    np.testing.assert_array_equal(packed[..., INT_COLS], ref[..., INT_COLS])
    np.testing.assert_allclose(packed[..., :-1, 4].view(np.float32),
                               ref[..., :-1, 4].view(np.float32), rtol=1e-5)
