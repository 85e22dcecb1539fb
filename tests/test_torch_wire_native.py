"""The native wire-line pass (`native.WireLines`, `native/wire.cc`) against
the reference rule it stands in for, the JAX package's
`airmodes.dsp.host.table_to_messages` on `airmodes.dsp.pipeline.unpack_table`
(plain numpy), and `io.stream._drain`, which takes the pass for every row
it can and the port's copy of that rule for the others.

Rows are drawn from fixed seeds with every field the packed layout holds
varied: 56- and 112-bit frames, DF 0-31 and the empty marker 0xFF, every
status, duplicate and negative indices, words with bits above the 28 a
frame uses, and levels of +-NaN, +-inf, +-0, negative, subnormal and from
1e-38 to 3e38; full scales of 1, 120/127 and float32 AGC gains over 127;
epochs 0 and 1.7e9; rates 2, 10 and 20 Msps and two that are not whole;
start samples up to 2^45. Lines must be equal byte for byte and the
BlockStats counts equal.
"""

import dataclasses
import os
import shutil
import threading

import numpy as np
import pytest
import torch

from airmodes.dsp import host as ref_host
from airmodes.dsp.pipeline import unpack_table as ref_unpack_table
from airmodes_torch import native
from airmodes_torch.config import DspConfig
from airmodes_torch.dsp import host
from airmodes_torch.io import stream

K = 128
RATES = [2e6, 10e6, 20e6, 2e6 / 3, 2.4e6 * 5 / 3 + 0.5]
EPOCHS = [0.0, 1.7e9]
SPECIAL_LEVELS = np.array(
    [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, -1.0, -3e-3, 1e-45,
     3e-42, 1.1754942e-38, 1e-30, 1.0, 3.4e38], np.float32)


@pytest.fixture(scope="module")
def wire():
    try:
        return native.WireLines(K)
    except native.NativeUnavailable:
        pytest.skip("no C++ toolchain")


def _levels(rng, n):
    """Detection levels: most log-uniform over float32's range, the rest
    special values."""
    lv = (10.0 ** rng.uniform(-40, 38.5, n)).astype(np.float32)
    pick = rng.random(n) < 0.25
    lv[pick] = rng.choice(SPECIAL_LEVELS, int(pick.sum()))
    return lv


def _random_row(rng, k=K, nbits=(56, 112)):
    """One packed (k+1, 9) int32 table: a random share of its slots filled,
    the rest empty as the device leaves them."""
    row = np.zeros((k + 1, 9), np.int32)
    row[:, 0] = -1
    row[:, 1] = 0xFF
    n = int(rng.integers(0, k + 1))
    pool = rng.integers(-3, 1 << 20, max(n // 3, 1))
    dup = rng.random(n) < 0.3          # indices shared with another slot
    index = np.where(dup, rng.choice(pool, n), rng.integers(-2, 1 << 20, n))
    df = np.where(rng.random(n) < 0.1, 0xFF, rng.integers(0, 32, n))
    meta = (df + (rng.choice(nbits, n) << 8)
            + (rng.integers(0, 5, n) << 16))
    slots = rng.permutation(k)[:n]
    row[slots, 0] = index
    row[slots, 1] = meta
    row[slots, 2] = rng.integers(-2 ** 31, 2 ** 31, n)
    row[slots, 3] = _levels(rng, n).view(np.int32)
    row[slots, 4] = rng.integers(-2 ** 31, 2 ** 31, n)
    wide = rng.random(n) < 0.1         # bits above the frame's 28 a word
    row[slots, 5:9] = np.where(wide[:, None],
                               rng.integers(-2 ** 31, 2 ** 31, (n, 4)),
                               rng.integers(0, 1 << 28, (n, 4)))
    row[k, 0] = rng.integers(0, 1 << 16)
    row[k, 1] = rng.integers(0, 1 << 10)
    return row


def _full_scales(rng):
    gains = rng.uniform(1e-3, 1e3, 2).astype(np.float32)
    return [1.0, 120.0 / 127.0] + [float(g) / 127.0 for g in gains]


def _python_rule(row, start, rate, epoch, fs):
    """The reference's lines for one packed row, and its BlockStats counts
    as a dict."""
    stats = ref_host.BlockStats()
    msgs = ref_host.table_to_messages(ref_unpack_table(row), start, rate,
                                      epoch=epoch, full_scale=fs,
                                      stats=stats)
    return msgs, dataclasses.asdict(stats)


def _native_stats(wire):
    stats = host.BlockStats()
    for name, n in zip(native.WIRE_COUNTS, wire.counts.tolist()):
        setattr(stats, name, n)
    return dataclasses.asdict(stats)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("epoch", EPOCHS)
@pytest.mark.parametrize("rate", RATES)
def test_native_lines_match_the_python_rule(wire, rate, epoch, seed):
    """Eight random rows a case (320 over the 40 cases), each at one of
    four full scales and a start sample up to 2^45."""
    rng = np.random.default_rng([seed, RATES.index(rate), int(epoch)])
    scales = _full_scales(rng)
    for i in range(8):
        row = _random_row(rng)
        start = int(rng.integers(0, 1 << (45 if i % 2 else 24)))
        fs = scales[i % len(scales)]
        want, want_stats = _python_rule(row, start, rate, epoch, fs)
        got = wire(row, start, rate, epoch, fs)
        assert got == want, (i, start, fs)
        assert _native_stats(wire) == want_stats
        if rate == 2e6 and epoch == 0.0:
            # every field a level can give, spelled as Python spells it
            assert not any("-nan" in m for m in got)


@pytest.mark.parametrize("case", ["ties", "all_special", "one_slot",
                                  "empty", "short_table", "negative_start"])
def test_native_lines_match_on_edge_rows(wire, case):
    """Rows built by hand: every slot at one index (stable order), every
    special level, one slot, no slot, a table of 4 slots, and a start
    before sample 0 (the floor division of negative nanoseconds)."""
    rng = np.random.default_rng(7)
    k, start = K, 12345
    row = _random_row(rng)
    if case == "ties":
        row[:K, 0] = 77
        row[:K, 1] = 17 + (112 << 8) + (rng.integers(0, 4, K) << 16)
    elif case == "all_special":
        n = len(SPECIAL_LEVELS)
        row[:n, 0] = np.arange(n)
        row[:n, 1] = 11 + (56 << 8)
        row[:n, 3] = SPECIAL_LEVELS.view(np.int32)
    elif case == "one_slot":
        row[:, 0] = -1
        row[3, 0] = 5
        row[3, 1] = 0xFF + (112 << 8) + (3 << 16)
    elif case == "empty":
        row[:K, 0] = -1
    elif case == "short_table":
        k = 4
        row = _random_row(rng, k)
    elif case == "negative_start":
        start = -(1 << 21) - 1
    w = wire if k == K else native.WireLines(k)
    for rate in RATES:
        for fs in (1.0, 0.25):
            want, want_stats = _python_rule(row, start, rate, 1.7e9, fs)
            assert w(row, start, rate, 1.7e9, fs) == want, rate
            assert _native_stats(w) == want_stats


@pytest.mark.parametrize("case", ["nbits_64", "nbits_0", "huge_start",
                                  "huge_time", "float32_scale",
                                  "zero_scale", "tiny_rate"])
def test_rows_the_pass_does_not_take_go_to_the_rule(wire, case):
    """The pass returns None where the rule must decide: a frame of other
    width than 56 or 112 bits, sample counts past 2^53, a time of 1.8e10 s
    or more, a full scale of numpy's float32, and values on which the rule
    raises (a zero full scale, an emitted level with no logarithm)."""
    rng = np.random.default_rng(11)
    row = _random_row(rng)
    row[:8, 0] = np.arange(8)
    row[:8, 1] = 17 + (112 << 8)
    row[:8, 3] = np.float32(0.01).view(np.int32)
    args = [1000, 2e6, 0.0, 1.0]
    if case == "nbits_64":
        row[5, 1] = 17 + (64 << 8)
    elif case == "nbits_0":
        row[5, 1] = 17
    elif case == "huge_start":
        args[0] = 1 << 60
    elif case == "huge_time":
        args[:2] = [1 << 40, 1.0]
    elif case == "float32_scale":
        args[3] = np.float32(0.5)
    elif case == "zero_scale":
        args[3] = 0.0
    elif case == "tiny_rate":
        args[1] = 1e-300
    assert wire(row, *args) is None
    if case in ("huge_time", "nbits_0"):
        # the rule takes them: it packs the bits it is given and writes
        # any time
        msgs, _ = _python_rule(row, *args)
        assert len(msgs) >= 8


@pytest.mark.parametrize("kind", [np.int32, np.int64, np.uint64])
def test_a_numpy_integer_start_is_taken_as_an_int(wire, kind):
    """A start of numpy's integer types is formatted natively, as the rule
    formats the same start as a Python int, past 2^33 samples too, where
    nanoseconds of int64 samples would overflow."""
    rng = np.random.default_rng(13)
    row = _random_row(rng)
    for start in (1000, (1 << 31) - 1, 1 << 40):
        if start > np.iinfo(kind).max:
            continue
        want, want_stats = _python_rule(row, start, 2e6, 1.7e9, 1.0)
        assert wire(row, kind(start), 2e6, 1.7e9, 1.0) == want, start
        assert _native_stats(wire) == want_stats


def test_failed_and_empty_slots_need_no_known_width(wire):
    """Slots the rule skips (index < 0) or drops (STATUS_FAIL) are counted
    whatever their width: the pass takes the row."""
    rng = np.random.default_rng(12)
    row = _random_row(rng, nbits=(56,))
    row[:K, 1] = (row[:K, 1] & ~(0xFF << 8)) | (56 << 8)
    row[:10, 0] = np.arange(10)
    row[:10, 1] = 17 + (13 << 8) + (4 << 16)       # failed, 13 bits
    row[10:20, 0] = -1
    row[10:20, 1] = 0xFF + (13 << 8)                # empty, 13 bits
    want, want_stats = _python_rule(row, 0, 2e6, 0.0, 1.0)
    assert wire(row, 0, 2e6, 0.0, 1.0) == want
    assert _native_stats(wire) == want_stats
    assert want_stats["crc_fail"] >= 10


def test_the_pass_rejects_a_row_of_another_layout(wire):
    with pytest.raises(ValueError):
        wire(np.zeros((K + 1, 9), np.int64), 0, 2e6, 0.0, 1.0)
    with pytest.raises(ValueError):
        wire(np.zeros((K, 9), np.int32), 0, 2e6, 0.0, 1.0)


# --- the drain ---------------------------------------------------------------

def _step(seed, n=6):
    """A packed step of n random rows, its rows' (start, full_scale) with
    one row not decoded, and the fused step's float32 gains."""
    rng = np.random.default_rng(seed)
    packed = np.stack([_random_row(rng) for _ in range(n + 2)])  # padding
    rows = [(j * (1 << 20) + (1 << 40), 120.0 / 127.0) for j in range(n)]
    rows[2] = None
    gains = torch.from_numpy(rng.uniform(0.5, 500, n + 2).astype(np.float32))
    return torch.from_numpy(packed), rows, gains


def _drained(packed, rows, cfg, gains):
    stats = host.BlockStats()
    before = dict(stream.WIRE_ROWS)
    out = list(stream._drain(packed, rows, cfg, 1.7e9, stats, gains))
    used = {k: stream.WIRE_ROWS[k] - before[k] for k in before}
    return out, dataclasses.asdict(stats), used


@pytest.mark.parametrize("with_gains", [False, True])
@pytest.mark.parametrize("rate", [2e6, 20e6])
def test_drain_natively_equals_the_python_rule(wire, monkeypatch, rate,
                                               with_gains):
    """`_drain` gives the same entries and counts through the pass as with
    the library unavailable, and its count says which path ran."""
    cfg = DspConfig(channel_rate=rate, max_detections=K)
    packed, rows, gains = _step(int(rate) + with_gains)
    gains = gains if with_gains else None
    got, got_stats, used = _drained(packed, rows, cfg, gains)
    assert used == {"native": 5, "python": 0}
    for j, entry in enumerate(got):
        if rows[j] is not None:
            fs = rows[j][1] if gains is None else float(gains[j]) / 127.0
            ref, _ = _python_rule(packed.numpy()[j], rows[j][0], rate, 1.7e9,
                                  fs)
            assert entry == ref, j

    def unavailable():
        raise native.NativeUnavailable("test: no library")
    monkeypatch.setattr(native, "load", unavailable)
    monkeypatch.setattr(stream, "_PASSES", threading.local())
    want, want_stats, used = _drained(packed, rows, cfg, gains)
    assert used == {"native": 0, "python": 5}
    assert got == want and got[2] is None and got_stats == want_stats
    assert sum(map(len, filter(None, got))) == got_stats["emitted"]


def test_drain_takes_the_rule_for_a_row_the_pass_does_not(wire):
    """One row with a frame width outside {56, 112} takes the rule; the
    others the pass; the entries equal the rule's row for row."""
    cfg = DspConfig(max_detections=K)
    packed, rows, _ = _step(5)
    arr = packed.numpy()
    arr[3, :4, 0] = np.arange(4)
    arr[3, :4, 1] = 17 + (40 << 8)
    got, stats, used = _drained(packed, rows, cfg, None)
    assert used == {"native": 4, "python": 1}
    for j, entry in enumerate(got):
        if rows[j] is None:
            assert entry is None
            continue
        want, _ = _python_rule(arr[j], rows[j][0], cfg.channel_rate, 1.7e9,
                               rows[j][1])
        assert entry == want, j


def test_drain_honours_a_replaced_rule(wire, monkeypatch):
    """A function put in `table_to_messages`' place (a fault check, a
    recorder) sees every row: the drain does not format natively then."""
    cfg = DspConfig(max_detections=K)
    packed, rows, _ = _step(6)
    seen = []

    def recorder(*a, **k):
        seen.append(a[1])
        return host.RULE(*a, **k)
    want, want_stats, _ = _drained(packed, rows, cfg, None)
    monkeypatch.setattr(host, "table_to_messages", recorder)
    got, got_stats, used = _drained(packed, rows, cfg, None)
    assert used == {"native": 0, "python": 5}
    assert seen == [r[0] for r in rows if r is not None]
    assert got == want and got_stats == want_stats


def test_every_source_is_watched_for_staleness(tmp_path, monkeypatch, wire):
    """The loader rebuilds the one library when any of its sources is newer
    than it, not only `iqstream.cc`; with a source missing it loads a
    library that is there, and keeps the failure where none is, without
    trying again. The build is a copy of the library this process loaded."""
    real, clock = native._LIB, [os.path.getmtime(native._LIB)]

    def touch(path):
        clock[0] += 10
        os.utime(path, (clock[0], clock[0]))
    srcs = [str(tmp_path / n) for n in ("iqstream.cc", "wire.cc")]
    for p in srcs:
        open(p, "w").close()
        touch(p)
    lib = str(tmp_path / "libiqstream.so")
    builds = []

    def build():
        # a new file put in place, as `_build` does: writing over a library
        # this process has loaded would change its mapped code
        builds.append(lib)
        shutil.copy(real, lib + ".tmp")
        os.replace(lib + ".tmp", lib)
        touch(lib)
        return lib
    for name, value in (("_SRCS", srcs), ("_LIB", lib), ("_build", build),
                        ("_lib_error", None)):
        monkeypatch.setattr(native, name, value)

    def load():
        monkeypatch.setattr(native, "_lib", None)
        return native.load()
    assert load().wire_lines is not None and len(builds) == 1
    load()
    assert len(builds) == 1                      # nothing newer
    for n, src in enumerate(srcs):
        touch(src)
        load()
        assert len(builds) == 2 + n, src
    os.remove(srcs[1])
    load()                                       # a library, a source gone
    assert len(builds) == 3
    os.remove(lib)
    for _ in range(2):
        with pytest.raises(native.NativeUnavailable):
            load()
    assert len(builds) == 3
