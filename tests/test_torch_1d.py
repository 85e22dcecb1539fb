"""The 1-D f32 path of the PyTorch port (kernel B6 and the full-block tail)
against the JAX reference's v1 entry points.

Both packages get the same framed blocks, made with numpy from fixed seeds.
The JAX side runs the Pallas kernels in interpret mode, as
tests/test_pallas.py does; the port runs the kernel's plain version on the
CPU. Masks and reference levels must be equal bit for bit, at every sps
the kernel serves (no sps <= 9 limit: 20 Msps is sps 10). Packed tables
must be equal in every column but noise, which is compared within rtol
1e-4: it comes from the full-block mean-centred cumsum noise floor, as on
the full-block path.
"""

import dataclasses

import numpy as np
import pytest
import torch

from airmodes.config import DspConfig as JaxCfg
from airmodes.dsp import pipeline as JP
from airmodes.io import sources
from airmodes.kernels import preamble_pallas as JK
from airmodes.testing import encoder
from airmodes_torch.config import DspConfig
from airmodes_torch.kernels import preamble as TK

TILE = 4096
INT_COLS = [0, 1, 2, 3, 5, 6, 7, 8]    # every packed column but noise (4)
RATES = [2e6, 4e6, 10e6, 20e6]          # sps 1, 2, 5, 10


def _cfgs(**kw):
    jc = JaxCfg(**kw)
    return jc, DspConfig.from_dict(dataclasses.asdict(jc))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _blocks(jc, seed, n_frames=12, snr=16.0, spacing=1300, n=2):
    """The first n framed blocks of a mixed-traffic capture, as (n, L+N+R,
    2) f32 I/Q at unit scale."""
    frames = encoder.random_mixed_frames(n_frames, seed=seed)
    iq, _ = encoder.make_capture(frames, rate=jc.channel_rate, snr_db=snr,
                                 spacing=spacing * jc.sps, seed=seed)
    out = [JP.iq_to_device_layout(b) for b, _ in sources.frame_blocks(iq, jc)]
    x = np.stack(out[:n])
    return x / np.float32(np.max(np.abs(x)) * 1.05)


@pytest.fixture(scope="module")
def captures():
    out = {}
    for rate in RATES:
        jc, _ = _cfgs(channel_rate=rate, block_size=1 << 14)
        out[rate] = _blocks(jc, seed=70 + int(rate // 1e6))
    return out


def _assert_detect_equal(got, want):
    mask, ref = (g.numpy() for g in got)
    np.testing.assert_array_equal(mask, np.asarray(want[0]))
    np.testing.assert_array_equal(ref.view(np.int32),
                                  np.asarray(want[1]).view(np.int32))
    assert mask.sum() > 0


@pytest.mark.parametrize("rate", RATES)
def test_detect_1d_plain_matches_jax(captures, rate):
    """B6's plain version == preamble_detect_pallas on one f32 block: mask
    and ref bit for bit at sps 1, 2, 5 and 10. The reference level is the
    decode tail's FMA form (`ref_chain`), read off the reference."""
    jc, tc = _cfgs(channel_rate=rate, block_size=1 << 14)
    x = captures[rate][0]
    want = JK.preamble_detect_pallas(x, jc, tile=TILE, interpret=True)
    _assert_detect_equal(TK.preamble_detect_1d(_t(x), tc, tile=TILE), want)


@pytest.mark.parametrize("rate", [2e6, 20e6])
def test_detect_1d_batch_plain_matches_jax(captures, rate):
    """B6's plain version == preamble_detect_pallas_batch on two blocks."""
    jc, tc = _cfgs(channel_rate=rate, block_size=1 << 14)
    x = captures[rate]
    want = JK.preamble_detect_pallas_batch(x, jc, tile=TILE, interpret=True)
    _assert_detect_equal(TK.preamble_detect_1d_batch(_t(x), tc, tile=TILE),
                         want)


@pytest.mark.parametrize("batch", [False, True])
def test_detect_1d_int8_and_short_input_match_jax(captures, batch):
    """int8 wire samples (the exact 1/127 scale), and a short input that
    ends in a partial 128-sample row: every sample counts, and the rest
    reads as zeros up to the reference's window end."""
    jc, tc = _cfgs(channel_rate=4e6, block_size=1 << 14)
    x = captures[4e6]
    x8 = np.clip(np.round(x * 127.0), -127, 127).astype(np.int8)
    short = x[:, : jc.left_halo + jc.block_size + 100]
    for blk in (x8, short):
        if batch:
            want = JK.preamble_detect_pallas_batch(blk, jc, tile=TILE,
                                                   interpret=True)
            got = TK.preamble_detect_1d_batch(_t(blk), tc, tile=TILE)
        else:
            want = JK.preamble_detect_pallas(blk[0], jc, tile=TILE,
                                             interpret=True)
            got = TK.preamble_detect_1d(_t(blk[0]), tc, tile=TILE)
        _assert_detect_equal(got, want)


@pytest.mark.parametrize("batch", [False, True])
def test_detect_1d_block_5x1024_matches_jax(batch):
    """A block of 5 x 1024 samples at tile 1024 (the port's CUDA form took
    only multiples of 4096 before): B6 equals the reference's mask and ref
    bit for bit."""
    jc, tc = _cfgs(block_size=5 * 1024)
    x = _blocks(jc, seed=74)
    if batch:
        want = JK.preamble_detect_pallas_batch(x, jc, tile=1024,
                                               interpret=True)
        got = TK.preamble_detect_1d_batch(_t(x), tc, tile=1024)
    else:
        want = JK.preamble_detect_pallas(x[0], jc, tile=1024, interpret=True)
        got = TK.preamble_detect_1d(_t(x[0]), tc, tile=1024)
    _assert_detect_equal(got, want)


def test_detect_1d_has_no_sps_gate():
    """B3 refuses sps 10 (the reference's 2-D row-borrow limit); B6 takes
    it, as the reference does."""
    _, tc = _cfgs(channel_rate=20e6, block_size=1 << 14)
    x = torch.zeros((1, tc.left_halo + tc.block_size + tc.right_halo, 2))
    with pytest.raises(ValueError, match="sps <= 9"):
        TK.preamble_detect_2d_batch(x, tc, tile=TILE)
    mask, _ = TK.preamble_detect_1d_batch(x, tc, tile=TILE)
    assert mask.shape == (1, tc.block_size) and int(mask.sum()) == 0


# --- the path end to end -----------------------------------------------------

def _assert_packed_equal(got, want):
    np.testing.assert_array_equal(got[..., INT_COLS], want[..., INT_COLS])
    np.testing.assert_allclose(got[..., :-1, 4].view(np.float32),
                               want[..., :-1, 4].view(np.float32), rtol=1e-4)
    np.testing.assert_array_equal(got[..., -1, 4], want[..., -1, 4])


@pytest.mark.parametrize("rate", [2e6, 10e6, 20e6])
def test_block_packed_1d_matches_reference(captures, rate):
    """demod_block_packed_1d == demod_block_packed_pallas_jit on one f32
    block, at sps 1, 5 and 10."""
    jc, tc = _cfgs(channel_rate=rate, block_size=1 << 14, max_detections=32)
    x = captures[rate][0]
    want = np.asarray(JK.demod_block_packed_pallas_jit(x, jc, tile=TILE,
                                                       interpret=True))
    got = TK.demod_block_packed_1d(x, tc, tile=TILE, device="cpu").numpy()
    _assert_packed_equal(got, want)
    assert (want[:-1, 0] >= 0).sum() >= 2


@pytest.mark.parametrize("rate", [2e6, 20e6])
def test_batch_packed_1d_matches_reference(captures, rate):
    """demod_batch_packed_1d == demod_batch_packed_pallas_jit on a batch of
    two blocks."""
    jc, tc = _cfgs(channel_rate=rate, block_size=1 << 14, max_detections=32)
    x = captures[rate]
    want = np.asarray(JK.demod_batch_packed_pallas_jit(x, jc, tile=TILE,
                                                       interpret=True))
    got = TK.demod_batch_packed_1d(x, tc, tile=TILE, device="cpu").numpy()
    _assert_packed_equal(got, want)


def test_1d_overflow_and_short_tail_match_reference():
    """More hits than K, and a short input the tail zero-pads (where
    `dsp.pipeline.demod_block` raises): tables, n_detected and n_overflow
    equal the reference's."""
    jc, tc = _cfgs(block_size=1 << 14, max_detections=8)
    x = _blocks(jc, seed=21, n_frames=30, snr=16.0, spacing=900, n=1)[0]
    for blk in (x, x[: jc.left_halo + jc.block_size]):
        want = np.asarray(JK.demod_block_packed_pallas_jit(blk, jc, tile=TILE,
                                                           interpret=True))
        got = TK.demod_block_packed_1d(blk, tc, tile=TILE,
                                       device="cpu").numpy()
        _assert_packed_equal(got, want)
        assert want[-1, 1] > 0


def test_1d_nan_sample_decodes_the_rest(captures):
    """A NaN and an Inf sample in an f32 block: the detections away from
    them decode as the reference's do (its ref-level selection is exact
    for NaN, and so is the port's gather), and the tables are equal."""
    jc, tc = _cfgs(block_size=1 << 14, max_detections=32)
    x = captures[2e6][0].copy()
    x[jc.left_halo + 9000, 1] = np.nan
    x[jc.left_halo + 3000, 0] = np.inf
    want = np.asarray(JK.demod_block_packed_pallas_jit(x, jc, tile=TILE,
                                                       interpret=True))
    got = TK.demod_block_packed_1d(x, tc, tile=TILE, device="cpu").numpy()
    _assert_packed_equal(got, want)
    ok = (want[:-1, 0] >= 0) & ((want[:-1, 1] >> 16) <= 2)
    assert ok.sum() >= 3


def test_1d_entry_points_need_a_card_by_default():
    """With no card, the default device raises; it never moves to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, tc = _cfgs(block_size=1 << 12, max_detections=4)
    x = np.zeros((tc.left_halo + tc.block_size + tc.right_halo, 2),
                 np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TK.demod_block_packed_1d(x, tc, tile=TILE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TK.demod_batch_packed_1d(x[None], tc, tile=TILE)


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [2e6, 20e6])
def test_cuda_detect_1d_matches_plain(cuda, captures, rate):
    """B6 on the card equals its plain version bit for bit, one block and a
    batch, and the 1-D path's tables equal the CPU's."""
    _, tc = _cfgs(channel_rate=rate, block_size=1 << 14, max_detections=32)
    x = _t(captures[rate])
    xc = x.to(cuda)
    for got, want in ((TK.preamble_detect_1d_batch(xc, tc, tile=TILE),
                       TK.preamble_detect_1d_batch(x, tc, tile=TILE)),
                      (TK.preamble_detect_1d(xc[0], tc, tile=TILE),
                       TK.preamble_detect_1d(x[0], tc, tile=TILE))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    got = TK.demod_batch_packed_1d(xc, tc, tile=TILE, device=cuda)
    want = TK.demod_batch_packed_1d(x, tc, tile=TILE, device="cpu")
    _assert_packed_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [2e6, 20e6])
def test_cuda_detect_1d_block_5x1024_matches_plain(cuda, rate):
    """B6 on the card at block_size 5 x 1024, tile 1024 (a ragged last
    chunk): one block and a batch equal to the plain version."""
    jc, tc = _cfgs(channel_rate=rate, block_size=5 * 1024)
    x = _t(_blocks(jc, seed=75))
    for fn, a in ((TK.preamble_detect_1d_batch, x), (TK.preamble_detect_1d,
                                                      x[0])):
        got, want = fn(a.to(cuda), tc, tile=1024), fn(a, tc, tile=1024)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
