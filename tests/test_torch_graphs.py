"""The port's compiled-step entry points (the `*_jit` family, captured CUDA
graphs on a card; `airmodes_torch.utils.graphs`) against the reference's
jitted programs, and the graph mechanism itself.

Parity, on the CPU, where a graphed function calls its eager function:
each `*_jit` of the port on `device="cpu"` against the reference's jitted
counterpart on the same numpy-seeded captures, under the ROADMAP parity
contract: packed tables equal in every int32 column, noise within rtol
1e-5 (1e-4 on the full-block path, whose noise floor is a mean-centered
cumsum over the whole block); the planar options as in
`test_torch_variants.py`, the reference's kernels in interpret mode; the
fused step's gains within rtol 1e-6 and its messages field by field, ref
level within 0.1 dB (as `test_torch_resample.py`: the two frameworks sum
the resampler's products in other orders); `demod_batch_jit`'s
`DetectionTable` field by field.

The mechanism, on the CPU: a stand-in graph class (`FakeGraph`: its
capture runs the function, its replay runs it again into the captured
outputs) is injected by monkeypatch, with `_on_card` answering yes, so
that the key, the input buffers, the clones, the counters and the error
paths run here. The card's own capture and replay are held by a
`gpu`-marked test and by chip_smoke phase 20.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from airmodes.config import DspConfig as JaxCfg
from airmodes.dsp import pipeline as JP
from airmodes.io import native_stream as jnative
from airmodes.io import sources as jsrc
from airmodes.kernels import preamble_pallas as JK
from airmodes.resample import fused as jfused
from airmodes.testing import encoder
from airmodes_torch.config import DspConfig
from airmodes_torch.dsp import host as thost
from airmodes_torch.dsp import pipeline as TP
from airmodes_torch.io import native_stream as tnative
from airmodes_torch.kernels import preamble as TK
from airmodes_torch.resample import fused as tfused
from airmodes_torch.utils import graphs
from torch_fake_graph import FakeGraph, _leaves, install_fake_graph

TILE = 4096
INT_COLS = [0, 1, 2, 3, 5, 6, 7, 8]    # every packed column but noise (4)


def _cfgs(**kw):
    kw.setdefault("mxu_window_sum", False)
    jc = JaxCfg(**kw)
    return jc, DspConfig.from_dict(dataclasses.asdict(jc))


def _assert_packed_equal(got, want, rtol=1e-5):
    np.testing.assert_array_equal(got[..., INT_COLS], want[..., INT_COLS])
    np.testing.assert_allclose(got[..., :-1, 4].view(np.float32),
                               want[..., :-1, 4].view(np.float32), rtol=rtol)
    np.testing.assert_array_equal(got[..., -1, 4], want[..., -1, 4])


def _blocks(jc, seed, n=2, n_frames=16, snr=14.0, spacing=1200):
    """The first n framed f32 (L+N+R, 2) blocks of a mixed capture."""
    frames = encoder.random_mixed_frames(n_frames, seed=seed)
    iq, _ = encoder.make_capture(frames, rate=jc.channel_rate, snr_db=snr,
                                 spacing=spacing * jc.sps, seed=seed)
    return np.stack([JP.iq_to_device_layout(b)
                     for b, _ in jsrc.frame_blocks(iq, jc)][:n])


def _planar(jc, seed, **kw):
    x = _blocks(jc, seed, **kw)
    q = [np.clip(np.round(b * 120.0 / (float(np.max(np.abs(b))) or 1.0)),
                 -127, 127).astype(np.int8) for b in x]
    return JK.to_planar_i8(np.stack(q), jc, tile=TILE)


@pytest.fixture(scope="module")
def captures():
    out = {}
    for rate in (2e6, 10e6):
        jc, _ = _cfgs(channel_rate=rate, block_size=1 << 14)
        out[rate] = _planar(jc, seed=60 + int(rate // 1e6))
    jc, _ = _cfgs(block_size=1 << 14)
    out["dense"] = _planar(jc, seed=8, n_frames=40, snr=9.0, spacing=700)
    return out


# --- the planar step ---------------------------------------------------------

@pytest.mark.parametrize("case,kw", [
    (2e6, {}),
    (10e6, {}),
    ("dense", {}),
    (2e6, {"ordered": True}),
    ("dense", {"prescreen": True}),
    (10e6, {"prescreen": True, "k2": 40}),
    (2e6, {"xla_gather": True}),
], ids=["default", "sps5", "dense", "ordered", "prescreen",
        "prescreen-sps5-k2", "xla_gather"])
def test_planar_jit_matches_reference(captures, case, kw):
    """demod_batch_packed_planar_jit == the reference's, at its defaults
    and with its options."""
    rate = 2e6 if case == "dense" else case
    jc, tc = _cfgs(channel_rate=rate, block_size=1 << 14, max_detections=32)
    xi, xq = captures[case]
    want = np.asarray(JK.demod_batch_packed_planar_jit(
        xi, xq, jc, tile=TILE, interpret=True, **kw))
    got = TK.demod_batch_packed_planar_jit(xi, xq, tc, tile=TILE,
                                           device="cpu", **kw).numpy()
    _assert_packed_equal(got, want)
    assert (want[:, :-1, 0] >= 0).sum() >= 4


# --- the f32 steps (B3, B4) and the 1-D steps (B6) ---------------------------

@pytest.fixture(scope="module")
def f32_blocks():
    return {rate: _blocks(_cfgs(channel_rate=rate, block_size=1 << 14)[0],
                          seed=70 + int(rate // 1e6))
            for rate in (2e6, 20e6)}


@pytest.mark.parametrize("which", ["block", "batch"])
def test_fast_jit_matches_reference(f32_blocks, which):
    """demod_{block,batch}_packed_fast_jit == the reference's B3 and B4
    steps."""
    jc, tc = _cfgs(block_size=1 << 14, max_detections=32)
    x = f32_blocks[2e6]
    if which == "block":
        x = x[0]
    ref = getattr(JK, f"demod_{which}_packed_fast_jit")
    port = getattr(TK, f"demod_{which}_packed_fast_jit")
    want = np.asarray(ref(x, jc, tile=TILE, interpret=True))
    got = port(x, tc, tile=TILE, device="cpu").numpy()
    _assert_packed_equal(got, want)
    assert (want[..., :-1, 0] >= 0).sum() >= 3


@pytest.mark.parametrize("which,rate", [("block", 2e6), ("batch", 2e6),
                                        ("batch", 20e6)])
def test_1d_jit_matches_reference(f32_blocks, which, rate):
    """demod_{block,batch}_packed_1d_jit == the reference's
    demod_{block,batch}_packed_pallas_jit (B6), also at 20 Msps."""
    jc, tc = _cfgs(channel_rate=rate, block_size=1 << 14, max_detections=32)
    x = f32_blocks[rate]
    if which == "block":
        x = x[0]
    ref = getattr(JK, f"demod_{which}_packed_pallas_jit")
    port = getattr(TK, f"demod_{which}_packed_1d_jit")
    want = np.asarray(ref(x, jc, tile=TILE, interpret=True))
    got = port(x, tc, tile=TILE, device="cpu").numpy()
    _assert_packed_equal(got, want)
    assert (want[..., :-1, 0] >= 0).sum() >= 2


# --- the full-block steps ----------------------------------------------------

def _tables_equal(got, want, noise_rtol=1e-4):
    for name, g, w in zip(want._fields, got, want):
        g, w = g.numpy(), np.asarray(w)
        if name == "noise":
            np.testing.assert_allclose(g, w, rtol=noise_rtol, atol=1e-9)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("layout", ["f32", "c64"])
def test_demod_block_jit_matches_reference(layout):
    """demod_block_jit == the reference's on every block of a capture,
    field by field, for f32 and complex64 input; demod_block_packed_jit
    packs the same table."""
    jc, tc = _cfgs(block_size=1 << 14, max_detections=32)
    frames = encoder.random_mixed_frames(16, seed=44)
    iq, _ = encoder.make_capture(frames, rate=jc.channel_rate, snr_db=16.0,
                                 spacing=1300, seed=44)
    hits = 0
    for block, _ in jsrc.frame_blocks(iq, jc):
        x = block if layout == "c64" else JP.iq_to_device_layout(block)
        want = JP.demod_block_jit(x, jc)
        _tables_equal(TP.demod_block_jit(x, tc, device="cpu"), want)
        _assert_packed_equal(
            TP.demod_block_packed_jit(x, tc, device="cpu").numpy(),
            np.asarray(JP.demod_block_packed_jit(x, jc)), rtol=1e-4)
        hits += int(np.asarray(want.n_detected))
    assert hits > 0


@pytest.fixture(scope="module")
def batch_blocks():
    jc, _ = _cfgs(block_size=1 << 14, max_detections=8)
    frames = encoder.random_mixed_frames(30, seed=21)
    iq, _ = encoder.make_capture(frames, rate=jc.channel_rate, snr_db=16.0,
                                 spacing=900, seed=21)
    return np.stack([JP.iq_to_device_layout(b)
                     for b, _ in jsrc.frame_blocks(iq, jc)][:2])


def test_demod_batch_jit_matches_reference(batch_blocks):
    """demod_batch_jit == the reference's: a DetectionTable with leading
    C, field by field, one block with more hits than K."""
    jc, tc = _cfgs(block_size=1 << 14, max_detections=8)
    want = JP.demod_batch_jit(batch_blocks, jc)
    got = TP.demod_batch_jit(batch_blocks, tc, device="cpu")
    assert isinstance(got, TP.DetectionTable)
    _tables_equal(got, want)
    assert np.asarray(want.n_overflow)[0] > 0


def test_demod_batch_packed_jit_matches_reference(batch_blocks):
    """demod_batch_packed_jit (the runners' step outside the kernels'
    gates) == the reference's jitted vmap of demod_block + pack_table."""
    jc, tc = _cfgs(block_size=1 << 14, max_detections=8)
    want = np.asarray(jax.jit(jax.vmap(
        lambda x: JP.pack_table(JP.demod_block(x, jc))))(batch_blocks))
    got = TP.demod_batch_packed_jit(batch_blocks, tc, device="cpu").numpy()
    _assert_packed_equal(got, want, rtol=1e-4)


def test_native_fallback_step_matches_reference():
    """The native runner's step outside the planar gate (20 Msps, sps 10)
    == the reference's fallback step (`_planar_step` on the CPU) on the
    same planar int8 rows."""
    jc, tc = _cfgs(channel_rate=20e6, block_size=1 << 14, max_detections=16)
    x = _blocks(jc, seed=77)
    q = np.clip(np.round(x * 120.0 / float(np.max(np.abs(x)))), -127,
                127).astype(np.int8)
    _, jstep, P = jnative._planar_step(jc)
    tstep, tP = tnative._planar_step(tc, "cpu")
    assert P == tP
    xi = np.zeros((2, P), np.int8)
    xq = np.zeros((2, P), np.int8)
    xi[:, :q.shape[1]], xq[:, :q.shape[1]] = q[..., 0], q[..., 1]
    want = np.asarray(jstep(xi, xq))
    got = tstep(torch.from_numpy(xi), torch.from_numpy(xq)).numpy()
    _assert_packed_equal(got, want, rtol=1e-4)
    assert (want[:, :-1, 0] >= 0).sum() >= 2


# --- the fused step ----------------------------------------------------------

FCFG = JaxCfg(channel_rate=4e6, block_size=1 << 16, max_detections=32)
P_UP, Q_DN = 2, 3          # 6 Msps raw -> 4 Msps (sps 2)


def _fused_windows():
    """Two channels' raw windows of a 6 Msps capture at 15 dB, planar."""
    rl, rb, rr, _ = jfused.raw_geometry(FCFG, P_UP, Q_DN)
    frames = encoder.random_df17_frames(8, seed=11)
    iq, _ = encoder.make_capture(frames, rate=6e6, snr_db=15.0,
                                 spacing=2 * rb // 9, seed=11,
                                 total_samples=2 * rb)
    fr = jsrc.buffered_framer(FCFG, geometry=(rl, rb, rr))
    wins = list(fr.push(iq)) + list(fr.flush())
    return np.stack([np.stack([w.real, w.imag]).astype(np.float32)
                     for w, _ in wins[:2]])


def _messages(packed, gains, cfg):
    out = []
    for c in range(packed.shape[0]):
        out += thost.table_to_messages(TP.unpack_table(packed[c]), 0,
                                       cfg.channel_rate,
                                       full_scale=float(gains[c]) / 127.0)
    return out


@pytest.mark.parametrize("gain", [None, 100.0, "per-channel"])
def test_fused_jit_matches_reference(gain):
    """resample_demod_packed_planar_jit == the reference's: AGC gains
    within rtol 1e-6, the same messages field by field, ref level within
    0.1 dB; with the device AGC, a scalar gain and a (C,) gain."""
    tc = DspConfig.from_dict(dataclasses.asdict(FCFG))
    x = _fused_windows()
    g = (np.float32([90.0, 140.0]) if gain == "per-channel"
         else None if gain is None else np.float32(gain))
    want, g_want = jfused.resample_demod_packed_planar_jit(
        x, g, FCFG, P_UP, Q_DN, interpret=True)
    got, g_got = tfused.resample_demod_packed_planar_jit(
        torch.from_numpy(x), g, tc, P_UP, Q_DN, device="cpu")
    np.testing.assert_allclose(g_got.numpy(), np.asarray(g_want), rtol=1e-6)
    a = _messages(got.numpy(), g_got.numpy(), tc)
    b = _messages(np.asarray(want), np.asarray(g_want), tc)
    assert len(a) == len(b) and len(b) >= 4
    for ma, mb in zip(a, b):
        fa, fb = ma.split(), mb.split()
        assert fa[:4] + fa[5:] == fb[:4] + fb[5:], (ma, mb)
        assert abs(float(fa[4]) - float(fb[4])) <= 0.1, (ma, mb)


# --- the mechanism, with a stand-in graph ------------------------------------

@pytest.fixture
def fake(monkeypatch):
    return install_fake_graph(monkeypatch.setattr)


def _affine():
    """A graphed y = x * a + b with static a, and the calls it gets."""
    calls = []

    @graphs.graphed(static_argnames=("a",))
    def f(x, b, a=2.0, device="cuda"):
        calls.append(x)
        return x * a + b, (x.sum(), [x[:1] * 0])
    return f, calls


def test_key_reuses_and_recaptures(fake):
    """Equal static values, shapes and dtypes reuse a graph; a static
    value, a shape, a dtype or None in place of a tensor captures anew."""
    f, _ = _affine()
    x = torch.arange(6, dtype=torch.float32)
    f(x, 1.0, device="cpu")
    f(x + 1, 2.0, device="cpu")
    assert len(f) == 1 and len(fake.made) == 1
    f(x, 1.0, a=3.0, device="cpu")
    assert len(f) == 2
    f(torch.arange(8, dtype=torch.float32), 1.0, device="cpu")
    assert len(f) == 3
    f(x.double(), 1.0, device="cpu")
    assert len(f) == 4
    f(x, torch.tensor([1.0, 2, 3, 4, 5, 6]), device="cpu")
    assert len(f) == 5
    f(x, 1.0, device="cpu")
    f(x, 1.0, a=3.0, device="cpu")
    assert len(f) == 5 and len(fake.made) == 5


def test_replays_compute_from_the_new_inputs(fake):
    """Every call's outputs are the function's on that call's inputs: the
    arguments are copied into the graph's input buffers."""
    f, _ = _affine()
    for k in range(4):
        x = torch.arange(6, dtype=torch.float32) * k
        y, (s, (z,)) = f(x, float(k), a=0.5, device="cpu")
        assert torch.equal(y, x * 0.5 + k)
        assert float(s) == float(x.sum()) and z.shape == (1,)
    assert fake.made[0].replays == 4


def test_outputs_of_two_calls_do_not_alias(fake):
    """Two in-flight outputs stay distinct: each call clones the graph's
    outputs, so the second replay leaves the first result as it was."""
    f, _ = _affine()
    x = torch.ones(6)
    y1, (s1, _) = f(x, 0.0, device="cpu")
    y2, (s2, _) = f(x * 3, 0.0, device="cpu")
    assert y1.data_ptr() != y2.data_ptr()
    assert torch.equal(y1, torch.full((6,), 2.0))
    assert torch.equal(y2, torch.full((6,), 6.0))
    out = _leaves(fake.made[0].out)
    for t in _leaves((y1, s1)) + _leaves((y2, s2)):
        assert all(t.data_ptr() != o.data_ptr() for o in out)


def test_static_inputs_are_not_copied(fake):
    """The buffers `static_inputs` returns hold the arguments' values and,
    passed back in, are used as they are: a write into them is what the
    next replay reads."""
    f, calls = _affine()
    x = torch.arange(6, dtype=torch.float32)
    xb, bb = f.static_inputs(x, 1.0, device="cpu")
    assert torch.equal(xb, x) and xb.data_ptr() != x.data_ptr()
    assert bb.shape == () and float(bb) == 1.0
    xb.fill_(5.0)
    y, _ = f(xb, bb, device="cpu")
    assert torch.equal(y, torch.full((6,), 11.0))
    assert calls[-1].data_ptr() == xb.data_ptr()
    assert len(f) == 1


def test_numpy_and_complex_arguments_go_over_as_tensors(fake):
    """Numpy arrays and numbers are dynamic arguments; a complex64 array
    goes over as its (..., 2) float32 view; anything else must be
    static."""
    seen = []

    @graphs.graphed()
    def g(x, device="cuda"):
        seen.append((x.dtype, tuple(x.shape)))
        return x * 1

    z = (np.arange(4) + 1j).astype(np.complex64)
    assert torch.equal(g(z, device="cpu"),
                       torch.from_numpy(z.view(np.float32).reshape(4, 2)))
    assert seen[-1] == (torch.float32, (4, 2))
    g(np.float32(2.5), device="cpu")
    assert seen[-1] == (torch.float32, ())
    with pytest.raises(TypeError, match="make it static"):
        g("a string", device="cpu")


def test_replay_adds_the_captured_launch_counts(fake):
    """A capture launches nothing: the counts its kernel wrappers bumped
    are taken back, and each replay adds them; the warm-up's launches
    ran and stay counted."""
    counts = {"k": 0, "other": 0}

    @graphs.graphed(counters=(counts,))
    def h(x, device="cuda"):
        if not FakeGraph.replaying:       # host code: warm-up and capture
            counts["k"] += 2
        return x + 1

    x = torch.zeros(3)
    h(x, device="cpu")
    assert counts == {"k": 4, "other": 0}     # warm-up 2, one replay 2
    for _ in range(3):
        h(x, device="cpu")
    assert counts["k"] == 10 and h.replays == 4


def test_nested_graphed_call_runs_inline(fake):
    """A graphed function called while another one captures runs inside
    that capture, as a jitted call inside a jit does."""
    @graphs.graphed()
    def inner(x, device="cuda"):
        return x * 2

    @graphs.graphed()
    def outer(x, device="cuda"):
        return inner(x, device=device) + 1

    assert torch.equal(outer(torch.ones(2), device="cpu"),
                       torch.full((2,), 3.0))
    assert len(outer) == 1 and len(inner) == 0


def test_a_failing_capture_raises_and_nothing_falls_back(fake, monkeypatch):
    """A capture that fails raises, caches nothing, and the next call
    captures again (and raises again): no eager result is handed back."""
    def broken(self, run):
        run()
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")
    monkeypatch.setattr(FakeGraph, "capture", broken)
    f, calls = _affine()
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capturing"):
            f(torch.ones(3), 0.0, device="cpu")
    assert len(f) == 0 and len(calls) == 4


def test_a_failing_replay_raises(fake, monkeypatch):
    f, _ = _affine()
    f(torch.ones(3), 0.0, device="cpu")

    def broken(self):
        raise RuntimeError("cudaErrorLaunchFailure")
    monkeypatch.setattr(FakeGraph, "replay", broken)
    with pytest.raises(RuntimeError, match="LaunchFailure"):
        f(torch.ones(3), 0.0, device="cpu")


def test_the_cache_is_bounded(fake, monkeypatch):
    """At most MAX_GRAPHS keys per function, the least recently used
    dropped first; cache_clear drops them all."""
    monkeypatch.setattr(graphs, "MAX_GRAPHS", 2)
    f, _ = _affine()
    for n in (2, 3, 2, 4):
        f(torch.ones(n), 0.0, device="cpu")
    assert len(f) == 2
    f(torch.ones(2), 0.0, device="cpu")
    assert len(fake.made) == 3               # 2 was kept, 3 was dropped
    f.cache_clear()
    assert len(f) == 0


def test_on_the_cpu_the_function_runs_as_called():
    """With no stand-in, a CPU call is the eager function's, with the
    caller's own arguments, and captures nothing."""
    f, calls = _affine()
    x = np.arange(3, dtype=np.float32)
    y, _ = f(x, 1.0, device="cpu")
    assert isinstance(y, np.ndarray) and np.array_equal(y, x * 2.0 + 1.0)
    assert calls[-1] is x and len(f) == 0


def test_graphed_entry_points_need_a_card_by_default():
    """The default device is the card; with none, every entry point
    raises before touching its inputs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, tc = _cfgs(block_size=1 << 12, max_detections=4)
    for call in (
            lambda: TK.demod_batch_packed_planar_jit(None, None, tc),
            lambda: TK.demod_block_packed_fast_jit(None, tc),
            lambda: TK.demod_batch_packed_fast_jit(None, tc),
            lambda: TK.demod_block_packed_1d_jit(None, tc),
            lambda: TK.demod_batch_packed_1d_jit(None, tc),
            lambda: tfused.resample_demod_packed_planar_jit(None, None, tc,
                                                            2, 3),
            lambda: TP.demod_block_jit(None, tc),
            lambda: TP.demod_block_packed_jit(None, tc),
            lambda: TP.demod_batch_jit(None, tc),
            lambda: TP.demod_batch_packed_jit(None, tc)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_planar_graph_replays_the_eager_step(cuda, captures):
    """The planar step captured on the card: every replay, with new
    inputs, equals the eager step bit for bit; two outputs in flight stay
    distinct; each replay adds B1's and B2's launches."""
    _, tc = _cfgs(block_size=1 << 14, max_detections=32)
    step = TK.demod_batch_packed_planar_jit
    step.cache_clear()
    outs = []
    for case in (2e6, "dense", 2e6):
        xi, xq = (torch.from_numpy(a).to(cuda) for a in captures[case])
        before = dict(TK.LAUNCHES)
        got = step(xi, xq, tc, tile=TILE, device=cuda)
        assert TK.LAUNCHES["slice_windows"] > before["slice_windows"]
        want = TK.demod_batch_packed_planar(xi, xq, tc, tile=TILE,
                                            device=cuda)
        assert torch.equal(got, want)
        outs.append(got)
    assert len(step) == 1
    assert not torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], outs[2])


@pytest.mark.gpu
def test_cuda_one_block_full_path_is_deterministic(cuda):
    """The full-block path on one block gives the same table every run on
    the card, and the table its row gets inside a batch: its noise floor's
    scan runs row by row (a single-row torch.cumsum takes CUB's
    device-wide scan, whose float sums vary from run to run)."""
    jc, tc = _cfgs(block_size=1 << 16, max_detections=16)
    x = torch.from_numpy(_blocks(jc, seed=5)).to(cuda)
    runs = [TP.demod_block_packed(x[0], tc, device=cuda) for _ in range(8)]
    assert all(torch.equal(runs[0], r) for r in runs)
    assert torch.equal(runs[0], TP.demod_batch_packed(x, tc, device=cuda)[0])
    assert torch.equal(runs[0], TP.demod_block_packed_jit(x[0], tc,
                                                          device=cuda))


def test_row_cumsum_is_cumsum_on_the_cpu():
    """On the CPU the row scan is torch.cumsum itself, one row or many."""
    rng = np.random.default_rng(3)
    for shape in ((1000,), (1, 1000), (3, 1000)):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        assert torch.equal(TP._row_cumsum(x), torch.cumsum(x, dim=-1))
