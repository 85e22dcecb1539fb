"""The port's sharded demod (`airmodes_torch.dist.sharded`, one process on
the CPU) against the reference's (`airmodes.dist.sharded` on its virtual
8-device CPU mesh, planar steps with `interpret=True`): twins of
tests/test_dist.py and of the three sharded tests of
tests/test_fused_resample.py.

The contract (ROADMAP "Parity contract"): the (C, T) tables identical in
every integer field, `noise` within rtol 1e-5 on the planar path and 1e-4
on the full-block path, the same messages. The resampled steps follow
tests/test_torch_resample.py's contract instead: messages field by field,
ref_dbfs within 0.1 dB (the resampler's f32 matmuls sum in another order
than XLA's). The transfers between ranks run in tests/test_torch_multihost.py
(gloo, several processes); here one process owns every shard, and
`_exchange_halos` is also driven rank by rank with a fake transport.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from airmodes.config import DspConfig as JaxCfg
from airmodes.dist import sharded as jsharded
from airmodes.dsp.pipeline import iq_to_device_layout
from airmodes.testing import encoder
from airmodes_torch.config import DspConfig
from airmodes_torch.dist import sharded
from airmodes_torch.dsp import host
from airmodes_torch.dsp.pipeline import DetectionTable

JCFG = JaxCfg(block_size=1 << 14, max_detections=32)
FRAME = "8d4840d6202cc371c32ce0576098"


def _cfgs(**kw):
    jc = JaxCfg(**kw)
    return jc, DspConfig.from_dict(dataclasses.asdict(jc))


def _tc(jc):
    return DspConfig.from_dict(dataclasses.asdict(jc))


def _same_tables(got, want, noise_rtol):
    """Every field of the port's (C, T, ...) table against the
    reference's: exact, noise within noise_rtol."""
    for name, g, w in zip(DetectionTable._fields, got, want):
        g, w = g.cpu().numpy(), np.asarray(w)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if name == "noise":
            np.testing.assert_allclose(g, w, rtol=noise_rtol, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype),
                                          err_msg=name)


def _messages(table, cfg):
    """Every shard's wire messages (indices already global in the step),
    sorted by time."""
    arr = [np.asarray(f.cpu() if isinstance(f, torch.Tensor) else f)
           for f in table]
    n_c, n_t = arr[0].shape[:2]
    msgs = []
    for c in range(n_c):
        for t in range(n_t):
            sub = DetectionTable(*(a[c, t] for a in arr))
            msgs.extend(host.table_to_messages(sub, 0, cfg.channel_rate))
    return sorted(msgs, key=lambda m: (float(m.split()[5]), m))


def _hexes(table, cfg):
    return sorted(m.split()[1] for m in _messages(table, cfg))


def _same_messages(got, want):
    """Field by field, in order; ref_dbfs within 0.1 dB."""
    assert len(got) == len(want), (len(got), len(want))
    for a, b in zip(got, want):
        fa, fb = a.split(), b.split()
        assert fa[:4] + fa[5:] == fb[:4] + fb[5:], (a, b)
        assert abs(float(fa[4]) - float(fb[4])) <= 0.1, (a, b)


def _global_input(iq, n_chan, n_time, block):
    buf = np.zeros((n_chan, n_time * block), np.complex64)
    buf[0, : len(iq)] = iq[: n_time * block]
    return iq_to_device_layout(buf)


def _both_f32(x, jc, shape, **kw):
    """(port table, reference table) of make_sharded_demod on x."""
    jmesh = jsharded.make_mesh(*shape)
    want = jax.block_until_ready(jsharded.make_sharded_demod(jmesh, jc, **kw)(
        jsharded.shard_input(x, jmesh)))
    mesh = sharded.make_mesh(*shape, device="cpu")
    fn = sharded.make_sharded_demod(mesh, _tc(jc), **kw)
    return fn(sharded.shard_input(x, mesh)), want


@pytest.fixture(scope="module")
def capture():
    frames = encoder.random_df17_frames(24, seed=20)
    frames += [(encoder.df11_frame(0x500000 + i), 56) for i in range(6)]
    total = 8 * JCFG.block_size
    # frames planted right at shard boundaries
    iq, truth = encoder.make_capture(
        frames, snr_db=22.0, spacing=4300, start=JCFG.block_size - 130,
        seed=20, total_samples=total)
    return iq, truth


@pytest.mark.parametrize("shape,block", [((1, 8), 1 << 14),
                                         ((2, 4), 1 << 15),
                                         ((8, 1), 1 << 17)],
                         ids=["time-only", "channel-x-time", "channel-only"])
def test_sharded_demod_matches_reference(capture, shape, block):
    """Time-only, channel x time and channel-only meshes: the port's
    (C, T) tables equal the reference's, and every frame decodes."""
    iq, truth = capture
    jc, tc = _cfgs(block_size=block, max_detections=32 if block < 1 << 17
                   else 64)
    x = _global_input(iq, shape[0], shape[1], block)
    got, want = _both_f32(x, jc, shape)
    _same_tables(got, want, 1e-4)
    hexes = _hexes(got, tc)
    assert hexes == _hexes(want, tc)
    assert {t.hex for t in truth} <= set(hexes)


def _quantize_planar(iq, total):
    """complex64 stream -> (total,) int8 planar I and Q (SDR quantization),
    as tests/test_dist.py's helper."""
    buf = np.zeros(total, np.complex64)
    buf[: len(iq)] = iq
    x = iq_to_device_layout(buf)
    peak = float(np.max(np.abs(x))) or 1.0
    x8 = np.clip(np.round(x * (120.0 / peak)), -127, 127).astype(np.int8)
    return x8[:, 0], x8[:, 1]


def test_planar_sharded_matches_reference_and_unsharded(capture):
    """The planar int8 path on a (1, 8) mesh (int8 halos): tables equal
    the reference's sharded planar step's, and its messages equal the
    port's unsharded planar step over the same host-framed blocks."""
    from airmodes_torch.kernels import preamble as TK

    iq, truth = capture
    jc, tc = JCFG, _tc(JCFG)
    n_time = 8
    total = n_time * tc.block_size
    si, sq = _quantize_planar(iq, total)

    jmesh = jsharded.make_mesh(1, n_time)
    want = jax.block_until_ready(jsharded.make_sharded_demod_planar(
        jmesh, jc, interpret=True)(
        *jsharded.shard_input_planar(si[None], sq[None], jmesh)))
    mesh = sharded.make_mesh(1, n_time, device="cpu")
    got = sharded.make_sharded_demod_planar(mesh, tc)(
        *sharded.shard_input_planar(si[None], sq[None], mesh))
    _same_tables(got, want, 1e-5)

    left, right = tc.left_halo, tc.right_halo
    blocks = np.zeros((n_time, left + tc.block_size + right, 2), np.int8)
    for t in range(n_time):
        lo, hi = t * tc.block_size - left, (t + 1) * tc.block_size + right
        a, b = max(lo, 0), min(hi, total)
        blocks[t, a - lo: b - lo, 0] = si[a:b]
        blocks[t, a - lo: b - lo, 1] = sq[a:b]
    xi, xq = TK.to_planar_i8(blocks, tc)
    flat = TK.demod_batch_planar(torch.from_numpy(xi), torch.from_numpy(xq),
                                 tc)
    ref = []
    for t in range(n_time):
        sub = DetectionTable(*(f[t].numpy() for f in flat))
        ref.extend(m.split()[1] for m in host.table_to_messages(
            sub, t * tc.block_size, tc.channel_rate))
    hexes = _hexes(got, tc)
    assert hexes == sorted(ref)
    assert {t.hex for t in truth} <= set(hexes)


@pytest.mark.parametrize("start", [JCFG.block_size - 1, JCFG.block_size,
                                   2 * JCFG.block_size - 60])
def test_boundary_frame_owned_once(start):
    """A preamble at a shard boundary decodes exactly once, with the
    reference's table."""
    iq, _ = encoder.make_capture(
        [(int(FRAME, 16), 112)], snr_db=25.0, start=start, seed=21,
        total_samples=8 * JCFG.block_size)
    x = _global_input(iq, 1, 8, JCFG.block_size)
    got, want = _both_f32(x, JCFG, (1, 8))
    _same_tables(got, want, 1e-4)
    assert _hexes(got, _tc(JCFG)).count(FRAME) == 1


def test_ablate_halos_loses_a_straddling_frame():
    """ablate_halos=True (local zeros, no exchange) loses a frame whose
    body crosses a shard edge, as the reference's does, table for table;
    with the exchange the frame decodes."""
    start = JCFG.block_size - 100
    iq, _ = encoder.make_capture(
        [(int(FRAME, 16), 112)], snr_db=25.0, start=start, seed=22,
        total_samples=8 * JCFG.block_size)
    x = _global_input(iq, 1, 8, JCFG.block_size)
    got, want = _both_f32(x, JCFG, (1, 8), ablate_halos=True)
    _same_tables(got, want, 1e-4)
    assert FRAME not in _hexes(got, _tc(JCFG))
    with_halos, _ = _both_f32(x, JCFG, (1, 8))
    assert _hexes(with_halos, _tc(JCFG)).count(FRAME) == 1


@pytest.mark.parametrize("fs_in,enc_rate,decim,block_size,chan_rate",
                         [(6e6, 6e6, 1, 1 << 14, 2e6),
                          (2.4e6, 12e6, 5, 15360, 4e6)])
def test_fused_resample_demod_sharded(fs_in, enc_rate, decim, block_size,
                                      chan_rate):
    """make_sharded_resample_demod (f32) on a (1, 4) mesh against the
    reference's, with a frame straddling the first shard boundary (the
    raw-rate halo exchange); both parametrisations of
    tests/test_dist.py."""
    from airmodes.resample.polyphase import design_lowpass, rational_rate

    jc, tc = _cfgs(block_size=block_size, max_detections=32,
                   channel_rate=chan_rate)
    p, q = rational_rate(fs_in, jc.channel_rate)
    n_time = 4
    raw_block = jc.block_size * q // p
    total_raw = n_time * raw_block
    frames = encoder.random_df17_frames(10, seed=33)
    iq_enc, truth = encoder.make_capture(
        frames, rate=enc_rate, snr_db=25.0,
        spacing=(total_raw // len(frames) - 400) * decim,
        start=(raw_block - 150) * decim, seed=33,
        total_samples=total_raw * decim)
    if decim > 1:
        h = design_lowpass(16 * decim, cutoff=1.0 / decim).astype(np.float64)
        iq_enc = np.convolve(iq_enc, h, mode="same").astype(np.complex64)
        iq_raw = iq_enc[::decim].copy()
    else:
        iq_raw = iq_enc
    x = iq_to_device_layout(iq_raw)[None]

    jmesh = jsharded.make_mesh(1, n_time)
    want = jax.block_until_ready(jsharded.make_sharded_resample_demod(
        jmesh, jc, p, q)(jsharded.shard_input(x, jmesh)))
    mesh = sharded.make_mesh(1, n_time, device="cpu")
    got = sharded.make_sharded_resample_demod(mesh, tc, p, q)(
        sharded.shard_input(x, mesh))
    msgs = _messages(got, tc)
    _same_messages(msgs, _messages(want, tc))
    assert {t.hex for t in truth} <= {m.split()[1] for m in msgs}


P_UP, Q_DN = 2, 3          # 6 Msps raw -> 4 Msps (sps=2)


def _planar_raw(iq_raw, n_chan):
    return np.tile(np.stack([iq_raw.real, iq_raw.imag]).astype(
        np.float32)[None], (n_chan, 1, 1))


def test_sharded_resample_planar_mesh():
    """make_sharded_resample_demod(planar=True) on a 2x4 mesh (int8 demod
    halos, quantize at a fixed gain) against the reference's, and its f32
    twin: the same messages, every frame."""
    jc, tc = _cfgs(channel_rate=4e6, block_size=1 << 14, max_detections=16)
    n_time = 4
    raw_total = n_time * jc.block_size * Q_DN // P_UP
    frames = encoder.random_df17_frames(8, seed=9)
    iq_raw, truth = encoder.make_capture(
        frames, rate=6e6, snr_db=20.0, spacing=raw_total // 9, seed=9,
        total_samples=raw_total)
    want_hex = {t.hex for t in truth}
    x = _planar_raw(iq_raw, 2)
    gain = np.float32(120.0 / float(np.abs(iq_raw).max()))

    jmesh = jsharded.make_mesh(2, n_time)
    want = jax.block_until_ready(jsharded.make_sharded_resample_demod(
        jmesh, jc, P_UP, Q_DN, planar=True, interpret=True)(
        jsharded.shard_input_resample_planar(x, jmesh), gain))
    mesh = sharded.make_mesh(2, n_time, device="cpu")
    got = sharded.make_sharded_resample_demod(
        mesh, tc, P_UP, Q_DN, planar=True)(
        sharded.shard_input_resample_planar(x, mesh), gain)
    msgs = _messages(got, tc)
    _same_messages(msgs, _messages(want, jc))
    assert want_hex <= {m.split()[1] for m in msgs}

    x32 = np.tile(np.stack([iq_raw.real, iq_raw.imag],
                           -1).astype(np.float32)[None], (2, 1, 1))
    got32 = sharded.make_sharded_resample_demod(mesh, tc, P_UP, Q_DN)(
        sharded.shard_input(x32, mesh))
    assert want_hex <= set(_hexes(got32, tc))


def test_sharded_resample_planar_matches_unsharded_fused_step():
    """The sharded fused step equals the port's unsharded fused step
    (resample_demod_planar on host-framed raw windows) at the same gain,
    shard for shard."""
    from airmodes_torch.resample import fused

    _, tc = _cfgs(channel_rate=4e6, block_size=1 << 14, max_detections=16)
    n_time = 4
    rl, rb, rr, _ = fused.raw_geometry(tc, P_UP, Q_DN)
    frames = encoder.random_df17_frames(8, seed=19)
    iq_raw, truth = encoder.make_capture(
        frames, rate=6e6, snr_db=20.0, spacing=n_time * rb // 9, seed=19,
        total_samples=n_time * rb)
    gain = np.float32(100.0)
    mesh = sharded.make_mesh(1, n_time, device="cpu")
    got = sharded.make_sharded_resample_demod(
        mesh, tc, P_UP, Q_DN, planar=True)(
        sharded.shard_input_resample_planar(_planar_raw(iq_raw, 1), mesh),
        gain)
    padded = np.concatenate([np.zeros(rl, np.complex64), iq_raw,
                             np.zeros(rr, np.complex64)])
    want = []
    for t in range(n_time):
        w = padded[t * rb: t * rb + rl + rb + rr]
        table, _ = fused.resample_demod_planar(
            np.stack([w.real, w.imag]).astype(np.float32)[None], gain, tc,
            P_UP, Q_DN)
        sub = DetectionTable(*(f[0].numpy() for f in table))
        want.extend(host.table_to_messages(sub, t * tc.block_size,
                                           tc.channel_rate))
    assert _messages(got, tc) == sorted(
        want, key=lambda m: (float(m.split()[5]), m))
    assert {t.hex for t in truth} <= set(_hexes(got, tc))


def test_sharded_resample_per_channel_gain_on_sharded_mesh():
    """A (C,) gain vector on a channel-sharded (2, 2) mesh: each channel
    takes its own gain, as the reference's; a wrong-length vector raises
    in both."""
    jc, tc = _cfgs(channel_rate=4e6, block_size=1 << 14, max_detections=16)
    raw_total = 2 * jc.block_size * Q_DN // P_UP
    frames = encoder.random_df17_frames(4, seed=43)
    iq_raw, truth = encoder.make_capture(
        frames, rate=6e6, snr_db=20.0, spacing=raw_total // 5, seed=43,
        total_samples=raw_total)
    x = _planar_raw(iq_raw, 2)
    g0 = 120.0 / float(np.abs(iq_raw).max())
    gains = np.float32([g0, 0.5 * g0])
    jmesh = jsharded.make_mesh(2, 2)
    jfn = jsharded.make_sharded_resample_demod(jmesh, jc, P_UP, Q_DN,
                                               planar=True, interpret=True)
    want = jax.block_until_ready(
        jfn(jsharded.shard_input_resample_planar(x, jmesh), gains))
    mesh = sharded.make_mesh(2, 2, device="cpu")
    fn = sharded.make_sharded_resample_demod(mesh, tc, P_UP, Q_DN,
                                             planar=True)
    got = fn(sharded.shard_input_resample_planar(x, mesh), gains)
    msgs = _messages(got, tc)
    _same_messages(msgs, _messages(want, jc))
    assert {t.hex for t in truth} <= {m.split()[1] for m in msgs}
    bad = np.float32([g0] * 3)
    with pytest.raises(ValueError, match="gain vector"):
        jfn(jsharded.shard_input_resample_planar(x, jmesh), bad)
    with pytest.raises(ValueError, match="gain vector"):
        fn(sharded.shard_input_resample_planar(x, mesh), bad)


def test_fused_resample_demod_bad_geometry():
    """A block that is not a multiple of 128p raises in both packages."""
    jc, tc = _cfgs(block_size=(1 << 14) + 128, max_detections=16)
    with pytest.raises(ValueError):
        jsharded.make_sharded_resample_demod(jsharded.make_mesh(1, 2),
                                             jc, 5, 6)
    with pytest.raises(ValueError):
        sharded.make_sharded_resample_demod(
            sharded.make_mesh(1, 2, device="cpu"), tc, 5, 6)


def test_shard_size_mismatch_raises():
    """Mis-sized time shards raise the reference's ValueError: an f32
    shard of twice the block, a planar one of half."""
    _, tc = _cfgs(block_size=1 << 14, max_detections=16)
    mesh = sharded.make_mesh(1, 2, device="cpu")
    fn = sharded.make_sharded_demod(mesh, tc)
    big = np.zeros((1, 2 * 2 * tc.block_size, 2), np.float32)
    with pytest.raises(ValueError, match="shard owns"):
        fn(sharded.shard_input(big, mesh))
    fnp = sharded.make_sharded_demod_planar(mesh, tc)
    small = np.zeros((1, 2 * 8192), np.int8)
    with pytest.raises(ValueError, match="shard owns"):
        fnp(*sharded.shard_input_planar(small, small, mesh))
    with pytest.raises(ValueError, match="shard owns"):
        sharded._check_shard_block(100, 128)
    sharded._check_shard_block(128, 128)


def test_make_mesh_ownership(monkeypatch):
    """Rank r of W owns the contiguous run [r*n/W, (r+1)*n/W) of shards,
    row-major over (channel, time); the run must be whole rows or a part
    of one row, and the shard count a multiple of W (checked before any
    collective, so a stand-in group serves)."""
    import torch.distributed as dist
    dev = torch.device("cpu")
    runs = [sharded.Mesh(2, 4, None, dev, r, 4).local_coords
            for r in range(4)]
    assert runs == [[(0, 0), (0, 1)], [(0, 2), (0, 3)],
                    [(1, 0), (1, 1)], [(1, 2), (1, 3)]]
    m = sharded.Mesh(4, 2, None, dev, 1, 2)
    assert m.local_shape == (2, 2) and m.local_coords[0] == (2, 0)
    one = sharded.make_mesh(2, 4, device="cpu")
    assert one.local_shape == (2, 4)
    assert one.shape == {"channel": 2, "time": 4}
    monkeypatch.setattr(dist, "get_rank", lambda g: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda g: 3)
    with pytest.raises(ValueError, match="multiple"):
        sharded.make_mesh(2, 4, group="group", device="cpu")
    monkeypatch.setattr(dist, "get_world_size", lambda g: 2)
    with pytest.raises(ValueError, match="row"):
        sharded.make_mesh(3, 4, group="group", device="cpu")


def test_cuda_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded.make_mesh(1, 4)


def _by_rank(monkeypatch, meshes, run):
    """Run `run(mesh)` for every rank with transfers served in-process:
    first every rank's sends are recorded, then each rank runs again and
    its receives take them. Returns each rank's second result."""
    sent = {}

    def record(mesh, plan):
        for kind, t, peer, tag in plan:
            if kind == "send":
                assert (mesh.rank, peer, tag) not in sent
                sent[(mesh.rank, peer, tag)] = t.clone()

    def serve(mesh, plan):
        for kind, t, peer, tag in plan:
            if kind == "recv":
                t.copy_(sent.pop((peer, mesh.rank, tag)))

    monkeypatch.setattr(sharded, "_transfer", record)
    for m in meshes:
        run(m)
    monkeypatch.setattr(sharded, "_transfer", serve)
    out = [run(m) for m in meshes]
    assert not sent                    # every message received once
    return out


@pytest.mark.parametrize("shape,world", [((2, 4), 4), ((1, 8), 2),
                                         ((1, 8), 4), ((2, 4), 2)])
def test_transfers_across_ranks_match_one_process(monkeypatch, shape, world):
    """Every rank of a mesh spread over `world` ranks, with the transfers
    served in-process: each rank's halos and step-edge contexts equal the
    one-process mesh's slices. On (2, 4) over 4 ranks the halo from
    (0, 3) into (1, 0) is zeros, never rank 1's tail."""
    n, left, right = 64, 7, 5
    rng = np.random.default_rng(3)
    cpu = torch.device("cpu")
    full, prev, nxt = (torch.from_numpy(rng.integers(
        -127, 128, (shape[0], shape[1] * n), dtype=np.int8))
        for _ in range(3))
    one = sharded.Mesh(*shape, None, cpu)
    whole, = sharded._exchange_halos(one, [full], left, right)
    (lw,), (rw,) = sharded._stream_edges(one, [prev], [nxt], left, right)
    meshes = [sharded.Mesh(*shape, "group", cpu, r, world)
              for r in range(world)]

    def local(m, x):
        c, t = m.channels, m.times
        return x[c.start:c.stop, t.start * n: t.stop * n]

    halos = _by_rank(monkeypatch, meshes, lambda m: sharded._exchange_halos(
        m, [local(m, full)], left, right)[0])
    edges = _by_rank(monkeypatch, meshes, lambda m: sharded._stream_edges(
        m, [local(m, prev)], [local(m, nxt)], left, right))
    for m, got, (lc, rc) in zip(meshes, halos, edges):
        c, t = m.channels, m.times
        assert torch.equal(got, whole[c.start:c.stop, t.start:t.stop])
        if t.start == 0:
            assert torch.equal(lc[0], lw[c.start:c.stop])
        if t.stop == shape[1]:
            assert torch.equal(rc[0], rw[c.start:c.stop])
    assert not whole[1 if shape[0] > 1 else 0, 0, :left].any()
    assert torch.equal(lw, prev[:, -left:]) and torch.equal(rw, nxt[:, :right])
