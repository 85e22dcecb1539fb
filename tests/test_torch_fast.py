"""The f32 fast path of the PyTorch port (kernels B3 and B4, the gather
tail) against the JAX reference.

Both packages get the same framed blocks, made with numpy from fixed seeds.
The JAX side runs the Pallas kernels in interpret mode, as
tests/test_pallas.py does; the port runs the kernels' plain version on the
CPU. Masks and reference levels must be equal bit for bit; packed tables
equal in every column but noise, which is compared within rtol 1e-5 (the
two frameworks reduce the 128-sample mean in different orders).
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


def _wire(x, dtype):
    """f32 I/Q quantized to an SDR wire format at near full scale."""
    full = 127.0 if dtype == np.int8 else 32767.0
    return np.clip(np.round(x * full), -full, full).astype(dtype)


@pytest.fixture(scope="module")
def captures():
    out = {}
    for rate in (2e6, 4e6, 10e6):
        jc, _ = _cfgs(channel_rate=rate, block_size=1 << 14)
        out[rate] = _blocks(jc, seed=60 + int(rate // 1e6))
    return out


def _assert_detect_equal(got, want):
    mask, ref = (g.numpy() for g in got)
    np.testing.assert_array_equal(mask, np.asarray(want[0]))
    np.testing.assert_array_equal(ref, np.asarray(want[1]))
    assert mask.sum() > 0


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("rate", [2e6, 4e6, 10e6])
def test_detect_2d_plain_matches_jax(captures, rate, mxu):
    """B3's plain version == preamble_detect_pallas_2d on one f32 block:
    mask and ref exact at sps 1, 2 and 5. The JAX kernel sums the noise
    window with matmuls under mxu_window_sum and the port folds; the
    decisions are still equal on these blocks."""
    jc, tc = _cfgs(channel_rate=rate, block_size=1 << 14,
                   mxu_window_sum=mxu)
    x = captures[rate][0]
    want = JK.preamble_detect_pallas_2d(x, jc, tile=TILE, interpret=True)
    _assert_detect_equal(TK.preamble_detect_2d(_t(x), tc, tile=TILE), want)


@pytest.mark.parametrize("rate", [2e6, 10e6])
def test_detect_2d_batch_plain_matches_jax(captures, rate):
    """B4's plain version == preamble_detect_pallas_2d_batch on a batch of
    two f32 blocks."""
    jc, tc = _cfgs(channel_rate=rate, block_size=1 << 14)
    x = captures[rate]
    want = JK.preamble_detect_pallas_2d_batch(x, jc, tile=TILE,
                                              interpret=True)
    _assert_detect_equal(TK.preamble_detect_2d_batch(_t(x), tc, tile=TILE),
                         want)


@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("dtype", [np.int8, np.int16])
def test_detect_2d_wire_formats_match_jax(captures, dtype, batch):
    """int8 and int16 blocks go through the exact 1/127 and 1/32767
    scales first; B3 and B4 equal the reference on them."""
    jc, tc = _cfgs(block_size=1 << 14)
    x = _wire(captures[2e6], dtype)
    if batch:
        want = JK.preamble_detect_pallas_2d_batch(x, jc, tile=TILE,
                                                  interpret=True)
        got = TK.preamble_detect_2d_batch(_t(x), tc, tile=TILE)
    else:
        want = JK.preamble_detect_pallas_2d(x[0], jc, tile=TILE,
                                            interpret=True)
        got = TK.preamble_detect_2d(_t(x[0]), tc, tile=TILE)
    _assert_detect_equal(got, want)


def test_detect_2d_dense_low_snr_matches_jax():
    """Dense traffic at 9 dB, where threshold and NMS decisions are
    marginal: B4 equals the reference exactly."""
    jc, tc = _cfgs(block_size=1 << 14, mxu_window_sum=False)
    x = _blocks(jc, seed=7, n_frames=40, snr=9.0, spacing=700)
    want = JK.preamble_detect_pallas_2d_batch(x, jc, tile=TILE,
                                              interpret=True)
    _assert_detect_equal(TK.preamble_detect_2d_batch(_t(x), tc, tile=TILE),
                         want)
    assert np.asarray(want[0])[0].sum() > 10


def test_detect_2d_short_input_matches_jax(captures):
    """A short input (no right halo, a partial 128-sample row at its end)
    reads as the reference reads it: B3 drops the partial row and pads
    with zeros, B4 pads the whole block."""
    jc, tc = _cfgs(block_size=1 << 14)
    x = captures[2e6]
    short = x[:, : jc.left_halo + jc.block_size + 100]
    want = JK.preamble_detect_pallas_2d(short[0], jc, tile=TILE,
                                        interpret=True)
    _assert_detect_equal(TK.preamble_detect_2d(_t(short[0]), tc, tile=TILE),
                         want)
    want = JK.preamble_detect_pallas_2d_batch(short, jc, tile=TILE,
                                              interpret=True)
    _assert_detect_equal(TK.preamble_detect_2d_batch(_t(short), tc,
                                                     tile=TILE), want)


@pytest.mark.parametrize("batch", [False, True])
def test_detect_2d_block_5x1024_matches_jax(batch):
    """A block of 5 x 1024 samples at tile 1024, the reference's smallest
    (the port's CUDA form took only multiples of 4096 before): B3 and B4
    equal the reference's mask and ref exactly."""
    jc, tc = _cfgs(block_size=5 * 1024)
    x = _blocks(jc, seed=64)
    if batch:
        want = JK.preamble_detect_pallas_2d_batch(x, jc, tile=1024,
                                                  interpret=True)
        got = TK.preamble_detect_2d_batch(_t(x), tc, tile=1024)
    else:
        want = JK.preamble_detect_pallas_2d(x[0], jc, tile=1024,
                                            interpret=True)
        got = TK.preamble_detect_2d(_t(x[0]), tc, tile=1024)
    _assert_detect_equal(got, want)


# --- the path end to end -----------------------------------------------------

def _assert_packed_equal(got, want):
    np.testing.assert_array_equal(got[..., INT_COLS], want[..., INT_COLS])
    np.testing.assert_allclose(got[..., :-1, 4].view(np.float32),
                               want[..., :-1, 4].view(np.float32), rtol=1e-5)
    np.testing.assert_array_equal(got[..., -1, 4], want[..., -1, 4])


@pytest.mark.parametrize("rate", [2e6, 10e6])
def test_fast_block_matches_reference(captures, rate):
    """demod_block_packed_fast == demod_block_packed_fast_jit on one f32
    block (the batch-1 route of the streaming runner)."""
    jc, tc = _cfgs(channel_rate=rate, block_size=1 << 14, max_detections=32)
    x = captures[rate][0]
    want = np.asarray(JK.demod_block_packed_fast_jit(x, jc, tile=TILE,
                                                     interpret=True))
    got = TK.demod_block_packed_fast(x, tc, tile=TILE, device="cpu").numpy()
    _assert_packed_equal(got, want)
    assert (want[:-1, 0] >= 0).sum() >= 3


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_fast_batch_matches_reference(captures, dtype):
    """demod_batch_packed_fast == demod_batch_packed_fast_jit on a batch
    of two blocks, f32 and int8 (the gather tail's int8 power)."""
    jc, tc = _cfgs(block_size=1 << 14, max_detections=32)
    x = captures[2e6]
    if dtype == np.int8:
        x = _wire(x, np.int8)
    want = np.asarray(JK.demod_batch_packed_fast_jit(x, jc, tile=TILE,
                                                     interpret=True))
    got = TK.demod_batch_packed_fast(x, tc, tile=TILE, device="cpu").numpy()
    _assert_packed_equal(got, want)


def test_fast_overflow_and_short_tail_match_reference():
    """More hits than K, and a short stream-tail input (no right halo):
    the packed tables, n_detected and n_overflow equal the reference's."""
    jc, tc = _cfgs(block_size=1 << 14, max_detections=8)
    x = _blocks(jc, seed=21, n_frames=30, snr=16.0, spacing=900, n=1)[0]
    short = x[: jc.left_halo + jc.block_size]
    for blk in (x, short):
        want = np.asarray(JK.demod_block_packed_fast_jit(blk, jc, tile=TILE,
                                                         interpret=True))
        got = TK.demod_block_packed_fast(blk, tc, tile=TILE,
                                         device="cpu").numpy()
        _assert_packed_equal(got, want)
        assert want[-1, 1] > 0


def test_supported_2d_tile_and_limits_match_reference():
    for kw in ({}, {"block_size": 8192}, {"block_size": 20480},
               {"block_size": 1 << 14, "channel_rate": 18e6},
               {"noise_window": 64}, {"channel_rate": 20e6},
               {"block_size": 3 * 1024}):
        jc, tc = _cfgs(**kw)
        assert TK.supported_2d_tile(tc) == JK.supported_2d_tile(jc), kw
        try:
            JK._check_2d_limits(jc)
            raised = None
        except ValueError as e:
            raised = str(e)
        if raised is None:
            TK._check_2d_limits(tc)
        else:
            with pytest.raises(ValueError, match="sps <= 9"):
                TK._check_2d_limits(tc)
    _, tc = _cfgs(channel_rate=20e6, block_size=1 << 14)
    x = np.zeros((tc.left_halo + tc.block_size + tc.right_halo, 2),
                 np.float32)
    with pytest.raises(ValueError, match="sps <= 9"):
        TK.preamble_detect_2d(_t(x), tc, tile=TILE)
    with pytest.raises(TypeError, match="uint8"):
        TK._to_f32(_t(x.astype(np.uint8)))


def test_fast_entry_points_need_a_card_by_default():
    """With no card, the default device raises; it never moves to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, tc = _cfgs(block_size=1 << 12, max_detections=4)
    x = np.zeros((tc.left_halo + tc.block_size + tc.right_halo, 2),
                 np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TK.demod_block_packed_fast(x, tc, tile=TILE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TK.demod_batch_packed_fast(x[None], tc, tile=TILE)


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [2e6, 10e6])
def test_cuda_detect_mask_matches_plain(cuda, captures, rate):
    """B3 and B4 on the card equal their plain version bit for bit, and the
    fast path's tables equal the CPU's."""
    _, tc = _cfgs(channel_rate=rate, block_size=1 << 14, max_detections=32)
    x = _t(captures[rate])
    xc = x.to(cuda)
    for got, want in ((TK.preamble_detect_2d_batch(xc, tc, tile=TILE),
                       TK.preamble_detect_2d_batch(x, tc, tile=TILE)),
                      (TK.preamble_detect_2d(xc[0], tc, tile=TILE),
                       TK.preamble_detect_2d(x[0], tc, tile=TILE))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
    got = TK.demod_batch_packed_fast(xc, tc, tile=TILE, device=cuda)
    want = TK.demod_batch_packed_fast(x, tc, tile=TILE, device="cpu")
    _assert_packed_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("blocks", [5, 1023])
def test_cuda_detect_mask_ragged_block_matches_plain(cuda, blocks):
    """B3, B4 and B6 on the card at block_size = blocks x 1024 (the last
    4096-sample chunk ragged), one block and C = 8: mask and ref equal to
    their plain version."""
    jc, tc = _cfgs(block_size=blocks * 1024)
    n_frames = max(12, 8 * jc.block_size // 20000)
    frames = encoder.random_mixed_frames(n_frames, seed=66)
    iq, _ = encoder.make_capture(frames, rate=jc.channel_rate, snr_db=16.0,
                                 spacing=min(1300, jc.block_size // 4),
                                 seed=66)
    out = [JP.iq_to_device_layout(b) for b, _ in sources.frame_blocks(iq, jc)]
    x = _t(np.stack((out * 8)[:8]))
    xc = x.to(cuda)
    for fn in (TK.preamble_detect_2d_batch, TK.preamble_detect_1d_batch):
        for a, b in ((xc, x), (xc[:1], x[:1])):
            got, want = fn(a, tc, tile=1024), fn(b, tc, tile=1024)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
            assert int(want[0].sum()) > 0
