"""The planar path's reference options in the PyTorch port against the JAX
reference: kernel B1's variants B5o (`ordered=True`) and B5p
(`prescreen=True`), `compact_candidates`, the stage-B rescan, and the packed
tables of `ordered`, `prescreen` and `xla_gather`.

Both packages get the same int8 captures, made with numpy from fixed seeds.
The JAX side runs the Pallas kernels in interpret mode and the packed
tables through the jitted `demod_batch_packed_planar_jit` (its compiled
FMAs are what the port copies); the port runs its kernels' plain versions
on the CPU. Candidate blocks and discrete results must be equal; noise is
compared within rtol 1e-5 (the two frameworks reduce the 128-sample mean
in different orders). The reference's `mxu_window_sum` is off where the
prescreen path is compared: its stage B folds the noise sum, and only then
are its decisions exact (its docstring, caveat (a)).
"""

import dataclasses

import jax
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
    kw.setdefault("mxu_window_sum", False)
    jc = JaxCfg(**kw)
    return jc, DspConfig.from_dict(dataclasses.asdict(jc))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _planar(jc, seed, n_frames=16, snr=14.0, spacing=1200, n=2, tile=TILE):
    """The first n blocks of a mixed-traffic capture, framed, quantized
    (AGC 120/peak) and laid out planar."""
    frames = encoder.random_mixed_frames(n_frames, seed=seed)
    iq, _ = encoder.make_capture(frames, rate=jc.channel_rate, snr_db=snr,
                                 spacing=spacing * jc.sps, seed=seed)
    out = []
    for block, _ in sources.frame_blocks(iq, jc):
        x = JP.iq_to_device_layout(block)
        g = 120.0 / (float(np.max(np.abs(x))) or 1.0)
        out.append(np.clip(np.round(x * g), -127, 127).astype(np.int8))
    return JK.to_planar_i8(np.stack(out[:n]), jc, tile=tile)


@pytest.fixture(scope="module")
def captures():
    out = {}
    for rate in (2e6, 10e6):
        jc, _ = _cfgs(channel_rate=rate, block_size=1 << 14)
        out[rate] = _planar(jc, seed=30 + int(rate // 1e6))
    jc, _ = _cfgs(block_size=1 << 14)
    out["dense"] = _planar(jc, seed=7, n_frames=40, snr=9.0, spacing=700)
    return out


# --- kernels B5o and B5p -----------------------------------------------------

def _cands_pair(jc, tc, xi, xq, tile=TILE, **kw):
    want = np.asarray(JK.preamble_detect_cands_planar(
        xi, xq, jc, tile=tile, interpret=True, **kw))
    got = TK.preamble_detect_cands_planar(_t(xi), _t(xq), tc, tile=tile,
                                          **kw).numpy()
    return got, want


@pytest.mark.parametrize("prescreen", [False, True])
def test_cands_planar_default_matches_jax(captures, prescreen):
    """Called without `ordered`, preamble_detect_cands_planar equals the
    reference's called the same way, exactly: both default to the ordered
    layout (the port defaulted to the unordered one before)."""
    jc, tc = _cfgs(block_size=1 << 14)
    got, want = _cands_pair(jc, tc, *captures["dense"], prescreen=prescreen)
    np.testing.assert_array_equal(got, want)
    assert want[:, :, 4].sum() > 0


@pytest.mark.parametrize("case", [2e6, 10e6, "dense"])
def test_ordered_cands_plain_matches_jax(captures, case):
    """B5o's plain version == preamble_detect_cands_planar(ordered=True),
    exactly: the tile's earliest per_tile hits in ascending order."""
    rate = 2e6 if case == "dense" else case
    jc, tc = _cfgs(channel_rate=rate, block_size=1 << 14)
    got, want = _cands_pair(jc, tc, *captures[case], ordered=True)
    np.testing.assert_array_equal(got, want)
    assert want[:, :, 4].sum() > 0


def _lane_spill(jc):
    """One block at the default tile (131072) of a dense channel whose
    frames all start on one lane column (44 hits in it), planar int8."""
    tile = JK.default_tile(jc)
    frames = encoder.random_mixed_frames(60, seed=5)
    iq, _ = encoder.make_capture(frames, snr_db=9.0, spacing=2048, seed=5,
                                 total_samples=jc.block_size)
    x = JP.iq_to_device_layout(next(sources.frame_blocks(iq, jc))[0])
    x8 = np.clip(np.round(x * 120.0 / np.max(np.abs(x))), -127,
                 127).astype(np.int8)
    return JK.to_planar_i8(x8, jc, tile=tile)


def test_ordered_cands_lane_overflow_matches_jax():
    """At the default tile (131072: per_lane 8, per_tile 128), a dense
    channel whose frames all start on one lane column spills that lane
    past 8 hits: the ordered blocks still equal the reference's, and the
    spilled hits stay counted in row 4."""
    jc, tc = _cfgs(block_size=1 << 17)
    tile = JK.default_tile(jc)
    assert tile == 1 << 17 and JK.cand_capacity(tile) == (128, 8)
    xi, xq = _lane_spill(jc)
    got, want = _cands_pair(jc, tc, xi, xq, tile=tile, ordered=True)
    np.testing.assert_array_equal(got, want)
    assert want[0, 0, 4].max() > 8


@pytest.mark.parametrize("per_lane", [12, 40])
def test_ordered_per_lane_above_8_matches_jax(per_lane):
    """The ordered layout takes any per_lane, as the reference's
    _extract_cands does (the port raised above 8 before): the lane column
    with 44 hits keeps its first per_lane, exactly as the reference."""
    jc, tc = _cfgs(block_size=1 << 17)
    xi, xq = _lane_spill(jc)
    got, want = _cands_pair(jc, tc, xi, xq, tile=1 << 17, ordered=True,
                            per_lane=per_lane)
    np.testing.assert_array_equal(got, want)
    assert want[0, 0, 4].max() > per_lane
    assert (want[0, 0, :4] < (1 << 17)).sum() == per_lane


@pytest.mark.parametrize("case", [2e6, 10e6, "dense"])
def test_prescreen_cands_plain_matches_jax(captures, case):
    """B5p's plain version == preamble_detect_cands_planar(prescreen=True,
    ordered=False), exactly, and it keeps every hit of the full rule."""
    rate = 2e6 if case == "dense" else case
    jc, tc = _cfgs(channel_rate=rate, block_size=1 << 14)
    xi, xq = captures[case]
    got, want = _cands_pair(jc, tc, xi, xq, ordered=False, prescreen=True)
    np.testing.assert_array_equal(got, want)
    full = TK.preamble_detect_cands_planar(_t(xi), _t(xq), tc, tile=TILE,
                                           ordered=False).numpy()
    assert (want[:, :, 4] >= full[:, :, 4]).all() and want[:, :, 4].sum()


def test_ordered_prescreen_cands_match_jax(captures):
    """The two options combine, as in the reference."""
    jc, tc = _cfgs(block_size=1 << 14)
    got, want = _cands_pair(jc, tc, *captures["dense"], ordered=True,
                            prescreen=True, per_tile=32, per_lane=2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("per_tile,per_lane", [(16, 4), (40, 2), (512, 8)])
def test_extract_ordered_plain_matches_jax(per_tile, per_lane):
    """The ordered extraction == _extract_cands on tiles with lanes of more
    than per_lane hits and more hits than per_tile."""
    rng = np.random.default_rng(per_tile)
    trows, tiles = 32, 3
    keep = np.zeros((tiles, trows, 128), bool)
    keep.reshape(-1)[rng.choice(keep.size, 300, replace=False)] = True
    keep[1, :12, 5] = True
    keep[2, ::2, ::3] = True
    want = np.stack([np.asarray(JK._extract_cands(
        jax.numpy.asarray(k), trows, per_tile, per_lane)) for k in keep])
    got = TK._extract_ordered_plain(_t(keep.reshape(1, -1)), TILE,
                                    per_tile, per_lane)[0]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("trial", range(3))
def test_compact_candidates_matches_jax(trial):
    """compact_candidates == the reference's on ordered blocks: the first K
    valid entries in flat (tile, position) order, with a tile spilled past
    per_tile whose lost hits lie before a later tile's kept ones."""
    rng = np.random.default_rng(40 + trial)
    jc, tc = _cfgs(block_size=4 * TILE, max_detections=24 + 20 * trial)
    trows, tiles, per_tile = 32, 4, 16
    keep = np.zeros((tiles, trows, 128), bool)
    keep.reshape(-1)[rng.choice(keep.size, 20 + 30 * trial,
                                replace=False)] = True
    keep[0, 2:, 7] = True                        # tile 0 spills
    cands = np.stack([np.asarray(JK._extract_cands(
        jax.numpy.asarray(k), trows, per_tile, 4)) for k in keep])
    want = [np.asarray(a) for a in JK.compact_candidates(
        jax.numpy.asarray(cands), jc, TILE, per_tile=per_tile)]
    got = [a.numpy() for a in TK.compact_candidates(_t(cands), tc, TILE,
                                                    per_tile=per_tile)]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert want[3] > 0
    got2 = TK.compact_candidates(_t(np.stack([cands, cands])), tc, TILE,
                                 per_tile=per_tile)
    for w, g in zip(want, got2):
        np.testing.assert_array_equal(g.numpy()[1], w)


@pytest.mark.parametrize("rate", [2e6, 10e6])
def test_stageb_full_check_matches_jax(rate):
    """_stageb_full_check == the reference's, jitted, on widened B2 windows
    around the injected preambles and their neighbours (where the full
    rule and the NMS decide) and at random offsets."""
    jc, tc = _cfgs(channel_rate=rate, block_size=1 << 14)
    sps, half, nw = jc.sps, jc.nms_chips * jc.sps, jc.noise_window
    frames = encoder.random_mixed_frames(12, seed=50)
    iq, truth = encoder.make_capture(frames, rate=rate, snr_db=10.0,
                                     spacing=1300 * sps, seed=50,
                                     total_samples=jc.block_size)
    x = JP.iq_to_device_layout(next(sources.frame_blocks(iq, jc))[0])
    x8 = np.clip(np.round(x * 120.0 / np.max(np.abs(x))), -127,
                 127).astype(np.int8)
    xi, xq = JK.to_planar_i8(x8, jc, tile=TILE)
    pos = np.array([t.sample_index for t in truth])
    rng = np.random.default_rng(2)
    det = np.concatenate([pos[:, None] + np.arange(-half - 2, half + 3),
                          rng.integers(0, jc.block_size, (1, 40))],
                         axis=None)
    base = (jc.left_halo + det - nw - half).astype(np.int32)
    ri, rq = xi.reshape(-1, 128), xq.reshape(-1, 128)
    w2 = np.asarray(JK.slice_windows_planar(ri, rq, base, jc, interpret=True,
                                            extra=half))
    got_w = TK.slice_windows_planar(_t(ri), _t(rq), _t(base), tc, extra=half)
    np.testing.assert_array_equal(got_w.numpy(), w2)
    want = np.asarray(jax.jit(lambda w: JK._stageb_full_check(w, jc))(w2))
    got = TK._stageb_full_check(got_w, tc).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size


# --- the packed tables -------------------------------------------------------

def _assert_packed_equal(got, want):
    np.testing.assert_array_equal(got[..., INT_COLS], want[..., INT_COLS])
    np.testing.assert_allclose(got[..., :-1, 4].view(np.float32),
                               want[..., :-1, 4].view(np.float32), rtol=1e-5)
    np.testing.assert_array_equal(got[..., -1, 4], want[..., -1, 4])


def _packed_pair(jc, tc, xi, xq, **kw):
    want = np.asarray(JK.demod_batch_packed_planar_jit(
        xi, xq, jc, tile=TILE, interpret=True, **kw))
    got = TK.demod_batch_packed_planar(xi, xq, tc, tile=TILE, device="cpu",
                                       **kw).numpy()
    return got, want


@pytest.mark.parametrize("case,kw", [
    (2e6, {"ordered": True}),
    ("dense", {"ordered": True, "per_tile": 16, "per_lane": 2}),
    ("dense", {"ordered": True, "per_tile": 64, "per_lane": 12}),
    (2e6, {"prescreen": True}),
    ("dense", {"prescreen": True}),
    (10e6, {"prescreen": True}),
    ("dense", {"prescreen": True, "k2": 40}),
    (2e6, {"xla_gather": True}),
    (10e6, {"ordered": True, "xla_gather": True}),
])
def test_planar_options_match_reference(captures, case, kw):
    """The packed tables of ordered, prescreen (also at sps 5 and with k2
    given) and xla_gather == demod_batch_packed_planar_jit's, in every
    int32 column; n_detected and n_overflow as the reference counts them
    on each path."""
    rate = 2e6 if case == "dense" else case
    jc, tc = _cfgs(channel_rate=rate, block_size=1 << 14, max_detections=32)
    got, want = _packed_pair(jc, tc, *captures[case], **kw)
    _assert_packed_equal(got, want)
    assert (want[:, :-1, 0] >= 0).sum() >= 4


def test_prescreen_k2_below_k_raises(captures):
    jc, tc = _cfgs(block_size=1 << 14, max_detections=32)
    xi, xq = captures[2e6]
    with pytest.raises(ValueError, match=r"k2 \(16\) must be >= "
                                         r"max_detections \(32\)"):
        JK.demod_batch_packed_planar_jit(xi, xq, jc, tile=TILE,
                                         interpret=True, prescreen=True,
                                         k2=16)
    with pytest.raises(ValueError, match=r"k2 \(16\) must be >= "
                                         r"max_detections \(32\)"):
        TK.demod_batch_packed_planar(xi, xq, tc, tile=TILE, device="cpu",
                                     prescreen=True, k2=16)


def test_candidate_limits_raise(captures):
    """per_lane below 1, and per_tile above the 512 of the ordered rows,
    raise and name the limit; the unordered layout clamps per_lane to 4,
    as the reference does, and the ordered one to the tile's rows (a lane
    column holds no more hits)."""
    _, tc = _cfgs(block_size=1 << 14)
    xi, xq = (_t(a) for a in captures[2e6])
    with pytest.raises(ValueError, match=r"per_lane must be >= 1"):
        TK.preamble_detect_cands_planar(xi, xq, tc, tile=TILE, ordered=True,
                                        per_lane=0)
    a = TK.preamble_detect_cands_planar(xi, xq, tc, tile=TILE, ordered=True,
                                        per_lane=1000)
    b = TK.preamble_detect_cands_planar(xi, xq, tc, tile=TILE, ordered=True,
                                        per_lane=TILE // 128)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match=r"per_tile must be in \[1, 512\]"):
        TK.preamble_detect_cands_planar(xi, xq, tc, tile=TILE, ordered=True,
                                        per_tile=513)
    a = TK.preamble_detect_cands_planar(xi, xq, tc, tile=TILE, ordered=False,
                                        per_lane=16)
    b = TK.preamble_detect_cands_planar(xi, xq, tc, tile=TILE, ordered=False)
    assert torch.equal(a, b)


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [{"ordered": True},
                                {"ordered": False, "prescreen": True},
                                {"ordered": True, "prescreen": True}])
def test_cuda_variants_match_plain(cuda, captures, kw):
    """B5o and B5p on the card equal their plain versions, and the packed
    tables of each option equal the CPU's."""
    _, tc = _cfgs(block_size=1 << 14, max_detections=32)
    xi, xq = (_t(a) for a in captures["dense"])
    got = TK.preamble_detect_cands_planar(xi.to(cuda), xq.to(cuda), tc,
                                          tile=TILE, **kw)
    want = TK.preamble_detect_cands_planar(xi, xq, tc, tile=TILE, **kw)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    got = TK.demod_batch_packed_planar(xi.to(cuda), xq.to(cuda), tc,
                                       tile=TILE, device=cuda, **kw)
    want = TK.demod_batch_packed_planar(xi, xq, tc, tile=TILE, device="cpu",
                                        **kw)
    _assert_packed_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.gpu
def test_cuda_ordered_per_lane_12_matches_plain(cuda):
    """B5o on the card at per_lane 12, tile 131072, on the lane spill:
    equal to its plain version."""
    _, tc = _cfgs(block_size=1 << 17)
    xi, xq = (_t(a) for a in _lane_spill(_cfgs(block_size=1 << 17)[0]))
    kw = {"tile": 1 << 17, "ordered": True, "per_lane": 12}
    got = TK.preamble_detect_cands_planar(xi.to(cuda), xq.to(cuda), tc, **kw)
    want = TK.preamble_detect_cands_planar(xi, xq, tc, **kw)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
