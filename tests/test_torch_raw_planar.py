"""The fused runners' raw path (`io/stream._RawReader`, `_raw_windows`,
`_channel_windows`) and kernel R1's plain version
(`resample.fused.raw_planar_plain`), against the route they replace: the
capture converted on the host by `io.sources.raw_file_chunks`, framed by
`buffered_framer` with the fused geometry and split into planar f32 rows.
Every window must be the same bit for bit, for each file format (sc16,
uc8, complex64), for one capture's overlapping rows and for channel rows,
through the end-of-file flush tail (a trailing partial sample included).

This file imports nothing of the JAX package, so that its `gpu` case (R1
on the card against the plain version, and the fused runner's launch
count) runs on a machine with a card and no JAX:
`python -m pytest --noconftest tests/test_torch_raw_planar.py`.
"""

import numpy as np
import pytest
import torch

from airmodes_torch.config import DspConfig
from airmodes_torch.io import sources
from airmodes_torch.io import stream as S
from airmodes_torch.resample import fused

# 6 Msps raw -> 4 Msps, blocks of 2^16 (the fused runners' CPU tests' cfg)
CFG = DspConfig(channel_rate=4e6, block_size=1 << 16, max_detections=32)
GEOM = fused.raw_geometry(CFG, 2, 3)[:3]
LEFT, BLOCK, RIGHT = GEOM
WIDTH = sum(GEOM)
FORMATS = ("sc16", "uc8", "complex64")


def _words(fmt: str, n: int, seed: int) -> np.ndarray:
    """(n, 2) words of a file format: every int16 and uint8 value's
    extremes, and for complex64 a NaN, infinities and a negative zero."""
    rng = np.random.default_rng(seed)
    if fmt == "sc16":
        w = rng.integers(-32768, 32768, (n, 2), dtype=np.int16)
        special = [[-32768, 32767], [0, -1]]
    elif fmt == "uc8":
        w = rng.integers(0, 256, (n, 2), dtype=np.uint8)
        special = [[0, 255], [127, 128]]
    else:
        w = rng.standard_normal((n, 2)).astype(np.float32)
        special = [[np.nan, -0.0], [np.inf, -np.inf]]
    w[n // 2: n // 2 + 2] = special[:n - n // 2]
    return w


def _write(tmp_path, name: str, words: np.ndarray, extra: bytes = b""):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(words.tobytes() + extra)
    return path


def _host_windows(path, fmt, in_skip=0, chunk=1 << 14):
    """The replaced route: raw_file_chunks -> buffered_framer(geometry)
    -> (2, W) f32 planes per window, with each window's raw start."""
    framer = sources.buffered_framer(CFG, geometry=GEOM)
    wins = []
    for c in sources.raw_file_chunks(path, dtype=fmt, chunk_samples=chunk,
                                     offset_samples=in_skip):
        wins += framer.push(c)
    wins += framer.flush()
    out = []
    for w, s in wins:
        x = np.empty((2, WIDTH), np.float32)
        x[0] = w.real
        x[1] = w.imag
        out.append((x, s))
    return out


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


# samples in the capture: whole blocks plus a right halo, a tail shorter
# than one block, a tail shorter than the right halo, one lone sample
LENGTHS = (3 * BLOCK + RIGHT, 3 * BLOCK + 1000, 2 * BLOCK + RIGHT // 2, 1)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("batch", (1, 2, 3))
def test_overlapping_rows_match_host_framing(tmp_path, fmt, n, batch):
    """One capture's batch buffers through the plain R1, row for row, are
    the host route's windows bit for bit, with the same raw starts; the
    rows past the last window of a partial batch are left to the
    runner."""
    path = _write(tmp_path, f"cap.{fmt}", _words(fmt, n, n + batch))
    want = _host_windows(path, fmt)
    got = []
    acc = []
    reader = S._RawReader(path, fmt, 0, GEOM)
    for owner, start, rng in S._raw_windows(reader, batch, None,
                                            pinned=False):
        assert tuple(owner.shape) == ((batch - 1) * BLOCK + WIDTH, 2)
        acc.append((owner, start, rng))
        if len(acc) == batch:
            got += _rows(acc)
            acc = []
    if acc:
        got += _rows(acc)
    assert len(got) == len(want) == -(-n // BLOCK)
    for (a, sa), (b, sb) in zip(got, want):
        assert sa == sb and _same_bits(a, b)


def _rows(acc):
    """A batch's windows as the runner's step sees them: the rows past the
    last window get an empty range, and come out as zeros."""
    owner = acc[0][0]
    assert all(o is owner for o, _, _ in acc)
    rows = (owner.shape[0] - WIDTH) // BLOCK + 1
    valid = torch.zeros((rows, 2), dtype=torch.int32)
    valid[:len(acc)] = torch.tensor([r for _, _, r in acc])
    x = fused.raw_planar_plain(owner, valid, WIDTH, BLOCK).numpy()
    assert not x[len(acc):].any()
    return [(x[j], s) for j, (_, s, _) in enumerate(acc)]


@pytest.mark.parametrize("fmt", FORMATS)
def test_channel_rows_match_host_framing(tmp_path, fmt):
    """Three captures of different lengths (one with a trailing partial
    sample), one window per channel a step: each live row is that
    channel's host window bit for bit; an ended channel's row is zeros."""
    lengths = (3 * BLOCK + 77, BLOCK + RIGHT, 2 * BLOCK)
    paths = [_write(tmp_path, f"ch{c}.{fmt}", _words(fmt, n, 40 + c),
                    extra=b"\x01" if c == 0 else b"")
             for c, n in enumerate(lengths)]
    want = [_host_windows(p, fmt) for p in paths]
    steps = list(S._channel_windows(
        [S._RawReader(p, fmt, 0, GEOM) for p in paths], None, pinned=False))
    assert len(steps) == max(len(w) for w in want) == 4
    for k, (owner, valid, starts, live) in enumerate(steps):
        x = fused.raw_planar_plain(owner, valid, WIDTH, WIDTH).numpy()
        assert x.shape == (3, 2, WIDTH)
        for c in range(3):
            assert live[c] == (k < len(want[c]))
            if live[c]:
                w, s = want[c][k]
                assert starts[c] == s and _same_bits(x[c], w)
            else:
                assert starts[c] == 0 and not x[c].any()


@pytest.mark.parametrize("fmt", FORMATS)
def test_seek_max_blocks_and_partial_sample(tmp_path, fmt):
    """A seek into the capture (`in_skip`), `max_blocks` and a file that
    ends in a partial sample: the same windows as the host route's."""
    n = 3 * BLOCK + 5000
    path = _write(tmp_path, f"cap.{fmt}", _words(fmt, n, 9), extra=b"\x07")
    skip = 1001
    want = _host_windows(path, fmt, in_skip=skip, chunk=(1 << 13) + 3)
    reader = S._RawReader(path, fmt, skip, GEOM)
    got = list(S._raw_windows(reader, 1, None, False))
    assert len(got) == len(want) == -(-(n - skip) // BLOCK)
    for item, (w, sw) in zip(got, want):
        assert item[1] == sw
        assert _same_bits(_rows([item])[0][0], w)
    reader = S._RawReader(path, fmt, skip, GEOM)
    two = list(S._raw_windows(reader, 2, 2, False))
    assert [s for _, s, _ in two] == [s for _, s in want[:2]]
    assert reader._f.closed


def test_empty_capture_has_no_window(tmp_path):
    path = _write(tmp_path, "empty.sc16", np.zeros((0, 2), np.int16),
                  extra=b"\x01\x02\x03")
    assert list(S._raw_windows(S._RawReader(path, "sc16", 0, GEOM), 2, None,
                               False)) == []


def test_raw_planar_plain_checks_its_input():
    good = torch.zeros((BLOCK + WIDTH, 2), dtype=torch.int16)
    valid = torch.tensor([[0, WIDTH], [0, WIDTH]], dtype=torch.int32)
    assert tuple(fused.raw_planar_plain(good, valid, WIDTH, BLOCK).shape) \
        == (2, 2, WIDTH)
    with pytest.raises(ValueError):
        fused.raw_planar_plain(good[:-1], valid, WIDTH, BLOCK)
    with pytest.raises(ValueError):
        fused.raw_planar_plain(good.t().contiguous().t(), valid, WIDTH, BLOCK)
    with pytest.raises(ValueError):
        fused.raw_planar_plain(good, valid[:1], WIDTH, BLOCK)
    with pytest.raises(ValueError):
        fused.raw_planar_plain(good, valid.long(), WIDTH, BLOCK)
    with pytest.raises(TypeError):
        fused.raw_planar_plain(good.to(torch.int32), valid, WIDTH, BLOCK)
    with pytest.raises(ValueError):
        S._RawReader("unused", "sc8", 0, GEOM)


@pytest.mark.parametrize("fmt", FORMATS)
def test_raw_planar_plain_zeros_outside_valid_ranges(fmt):
    """Outside each row's valid range the windows are +0.0 whatever the
    words are (a uc8 zero word is -1.0); inside, the words' conversion."""
    words = torch.from_numpy(_words(fmt, 2 * 64 + 32, 3))
    valid = torch.tensor([[5, 32], [0, 0], [17, 19]], dtype=torch.int32)
    got = fused.raw_planar_plain(words, valid, 32, 64).numpy()
    full = fused.raw_planar_plain(
        words, torch.tensor([[0, 32]] * 3, dtype=torch.int32), 32,
        64).numpy()
    for c, (lo, hi) in enumerate(valid.tolist()):
        inside = np.zeros(32, bool)
        inside[lo:hi] = True
        assert _same_bits(got[c][:, inside], full[c][:, inside])
        assert _same_bits(got[c][:, ~inside],
                          np.zeros((2, 32 - inside.sum()), np.float32))


def test_fused_runner_sends_the_files_words(tmp_path, monkeypatch):
    """run_resampled_fused converts one (n, 2) buffer of the file's words
    per batch, stride the raw block, with each row's valid range (an
    empty one past the last window of a partial batch), and hands R1's
    planar windows to the fused step's graphed entry; the channels runner
    one (C * W, 2) buffer a step, stride W."""
    calls, steps = [], []
    real = S.raw_to_planar

    def convert(raw, valid, width, stride):
        calls.append((raw.clone(), valid.clone(), stride))
        return real(raw, valid, width, stride)

    def step(x, gain, cfg, p, q, device):
        steps.append(tuple(x.shape))
        return (torch.full((x.shape[0], CFG.max_detections + 1, 9), -1,
                           dtype=torch.int32),
                torch.ones(x.shape[0]))

    monkeypatch.setattr(S, "raw_to_planar", convert)
    monkeypatch.setattr(S, "resample_demod_packed_planar_jit", step)
    monkeypatch.setattr(S, "unpack_table", lambda a: a)
    monkeypatch.setattr(S.host_mod, "table_to_messages",
                        lambda *a, **k: [])
    n = 2 * BLOCK + 10
    path = _write(tmp_path, "cap.sc16", _words("sc16", n, 5))
    out = list(S.run_resampled_fused(path, CFG, dtype="sc16", rate_in=6e6,
                                     batch=2, device="cpu"))
    assert len(out) == 3 and steps == [(2, 2, WIDTH)] * 2
    (b0, v0, s0), (b1, v1, s1) = calls
    assert b0.dtype == torch.int16 and s0 == s1 == BLOCK
    assert tuple(b0.shape) == tuple(b1.shape) == (BLOCK + WIDTH, 2)
    assert v0.tolist() == [[LEFT, WIDTH], [0, n - BLOCK + LEFT]]
    assert v1.tolist() == [[0, n - 2 * BLOCK + LEFT], [0, 0]]
    calls.clear()
    list(S.run_resampled_fused_channels([path, path], CFG, dtype="sc16",
                                        rate_in=6e6, device="cpu"))
    assert len(calls) == 3
    assert all(tuple(b.shape) == (2 * WIDTH, 2) and s == WIDTH
               for b, _, s in calls)
    assert [v.tolist() for _, v, _ in calls] == [
        [[LEFT, WIDTH]] * 2, [[0, n - BLOCK + LEFT]] * 2,
        [[0, n - 2 * BLOCK + LEFT]] * 2]


# --- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_raw_planar_matches_plain(cuda):
    """R1 on the card against its plain version, bit for bit, at the
    10 -> 2 Msps cell's shapes (a batch of 8 overlapping windows of the
    raw block's stride, and 4 channel rows), for every file format, with
    full rows, a first window's left padding, a tail, a range edge inside
    a 16-byte unit and an empty row; one launch a call."""
    from airmodes_torch.kernels import preamble as K
    left, block, right, _ = fused.raw_geometry(DspConfig(), 1, 5)
    width = left + block + right
    for fmt in FORMATS:
        for rows, stride in ((8, block), (4, width)):
            raw = torch.from_numpy(_words(fmt, (rows - 1) * stride + width,
                                          rows))
            rng = [[0, width]] * rows
            rng[0] = [left, width]
            rng[1] = [3, width - 1005]
            rng[-1] = [0, 0]
            valid = torch.tensor(rng, dtype=torch.int32)
            before = K.LAUNCHES["raw_planar"]
            got = fused.raw_to_planar(raw.to(cuda), valid.to(cuda), width,
                                      stride).cpu()
            assert K.LAUNCHES["raw_planar"] == before + 1
            want = fused.raw_planar_plain(raw, valid, width, stride)
            assert _same_bits(got.numpy(), want.numpy()), (fmt, rows)


@pytest.mark.gpu
def test_cuda_fused_runner_launches_raw_planar_once_a_step(cuda, tmp_path):
    """The fused runners on the card launch R1 once per step and give the
    messages the CPU run gives: the same frames, in order, ref_dbfs
    within 0.1 dB."""
    from airmodes_torch.kernels import preamble as K
    from airmodes_torch.testing import encoder
    frames = encoder.random_df17_frames(9, seed=17)
    iq, _ = encoder.make_capture(frames, rate=6e6, snr_db=18.0,
                                 spacing=3 * BLOCK // 10, seed=17,
                                 total_samples=5 * BLOCK)
    x = iq / float(np.max(np.abs(iq))) * 0.9
    w = np.empty((len(x), 2), np.int16)
    w[:, 0] = np.round(x.real * 32767)
    w[:, 1] = np.round(x.imag * 32767)
    path = _write(tmp_path, "cap.sc16", w)
    kw = dict(dtype="sc16", rate_in=6e6, batch=2)
    K.reset_launches()
    on_card = list(S.run_resampled_fused(path, CFG, device=cuda, **kw))
    assert K.LAUNCHES["raw_planar"] == -(-len(on_card) // 2) == 3
    on_cpu = list(S.run_resampled_fused(path, CFG, device="cpu", **kw))
    assert len(on_card) == len(on_cpu) == 5
    got = [m for b in on_card for m in b]
    want = [m for b in on_cpu for m in b]
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        fa, fb = a.split(), b.split()
        assert fa[:4] + fa[5:] == fb[:4] + fb[5:], (a, b)
        assert abs(float(fa[4]) - float(fb[4])) <= 0.1, (a, b)
    K.reset_launches()
    steps = list(S.run_resampled_fused_channels([path, path], CFG,
                                                dtype="sc16", rate_in=6e6,
                                                device=cuda))
    assert K.LAUNCHES["raw_planar"] == len(steps) == 5
