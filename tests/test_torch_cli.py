"""The port's `modes_rx` CLI (`airmodes_torch.apps.modes_rx`, run with
`--device cpu`) against the reference's `airmodes.apps.modes_rx.main` on the
same captures and arguments, and the Python sources it uses
(`io.sources`: `udp_source`, `synthetic_source`, `open_source`, the
framers). Twins of the modes_rx tests of tests/test_cli.py.

Both CLIs run in-process with their module clock fixed (`time.time()` =
1.7e9), so the epoch of every message, and with it the console lines, the
SQLite rows and the stats records, compare exactly. What is compared:
- the exit code, on every path, the validation exits included;
- the console lines exactly, except `ref_dbfs` within 0.1 dB on resampled
  runs (the resampler's f32 matmul sums in another order than XLA's, so a
  +-1 int8 sample inside a pulse may move the reference level);
- the SQLite rows of every table, exactly.

On the CPU the reference's int8 runners take its full-block XLA route and
the port's take the planar route (the reference's route on its
accelerator). The planar layout keeps a bounded number of candidate hits
per tile lane column (4 on the unordered layout) and spills the rest, so
on frames that crowd a lane column the two routes differ, in the reference
as in the port (its own planar path, run in interpret mode, drops the same
frames). The int8 captures here are DF17 traffic spaced so that no lane
column spills: 8037 samples (not a multiple of 128) at 2 Msps, 40,000 raw
samples at 6 Msps.
"""

import io
import os
import re
import socket
import sqlite3
import subprocess
import sys
import threading
import time
import types
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

import airmodes.apps.modes_rx as ref_rx
from airmodes.testing import encoder
import airmodes_torch.apps.modes_rx as rx
from airmodes_torch.config import DspConfig

EPOCH = 1.7e9
CLOCK = types.SimpleNamespace(time=lambda: EPOCH, sleep=time.sleep)
TABLES = ("aircraft", "positions", "vectors", "squawks", "track")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def fixed_clock(monkeypatch):
    monkeypatch.setattr(ref_rx, "time", CLOCK)
    monkeypatch.setattr(rx, "time", CLOCK)


def _run(mod, argv):
    """(exit code, console lines, stderr) of one in-process CLI run; the
    port's runs on the CPU."""
    if mod is rx:
        argv = list(argv) + ["--device", "cpu"]
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = mod.main(list(argv))
    return rc, out.getvalue().splitlines(), err.getvalue()


def _rows(db):
    con = sqlite3.connect(db)
    try:
        return {t: sorted(con.execute(f"SELECT * FROM {t}").fetchall())
                for t in TABLES}
    finally:
        con.close()


def _both(tmp_path, argv, db=True, resampled=False):
    """Run both CLIs on argv (each with its own -d file when db); assert
    the same exit code, console lines and rows; return the port's run."""
    runs = []
    for name, mod in (("ref", ref_rx), ("port", rx)):
        extra = []
        if db:
            f = tmp_path / f"{name}.db"
            if f.exists():
                f.unlink()
            extra = ["-d", str(f)]
        runs.append(_run(mod, list(argv) + extra))
    (rc_r, out_r, _), (rc_p, out_p, err_p) = runs
    assert rc_p == rc_r, err_p
    _same_lines(out_p, out_r, resampled)
    if db and rc_r == 0:
        assert _rows(tmp_path / "port.db") == _rows(tmp_path / "ref.db")
    return runs[1]


_DBFS = re.compile(r"\((-?[0-9.]+) dBFS\)")


def _same_lines(got, want, resampled=False):
    if not resampled:
        assert got == want
        return
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert _DBFS.sub("", a) == _DBFS.sub("", b), (a, b)
        da, db = _DBFS.findall(a), _DBFS.findall(b)
        assert len(da) == len(db)
        assert all(abs(float(x) - float(y)) <= 0.1 for x, y in zip(da, db))


def _uc8(path, iq):
    x = iq / float(np.max(np.abs(iq))) * 0.9
    u = np.empty(2 * len(x), np.uint8)
    u[0::2] = np.round(x.real * 127.5 + 127.5).astype(np.uint8)
    u[1::2] = np.round(x.imag * 127.5 + 127.5).astype(np.uint8)
    u.tofile(path)
    return str(path)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """12 DF17 frames over 2^17 samples at 22 dB, complex64 and uc8."""
    d = tmp_path_factory.mktemp("cli")
    frames = encoder.random_df17_frames(12, seed=90)
    iq, truth = encoder.make_capture(frames, snr_db=22.0, spacing=8037,
                                     seed=90, total_samples=1 << 17)
    path = str(d / "cap.c64")
    iq.tofile(path)
    return path, truth, d, _uc8(d / "cap.uc8", iq)


@pytest.fixture(scope="module")
def capture6(tmp_path_factory):
    """Two 6 Msps captures (3 and 2 blocks of 2^16 at 4 Msps) of DF17
    traffic at 20 dB, for -r 6e6 --channel-rate 4e6."""
    d = tmp_path_factory.mktemp("cli6")
    paths = []
    for c, n_blocks in enumerate((3, 2)):
        total = n_blocks * (1 << 16) * 3 // 2
        frames = encoder.random_df17_frames(7, seed=60 + c)
        iq, _ = encoder.make_capture(frames, rate=6e6, snr_db=20.0,
                                     spacing=40000, seed=60 + c,
                                     total_samples=total)
        paths.append(str(d / f"cap6_{c}.c64"))
        iq.tofile(paths[-1])
    return paths


def _icaos(lines):
    return set(re.findall(r"from ([0-9a-f]{6})", "\n".join(lines)))


def _want(truth):
    return {f"{(t.frame >> 80) & 0xFFFFFF:06x}" for t in truth}


# --- the DSP paths, against the reference ------------------------------------

def test_cli_file_to_db_and_print(capture, tmp_path):
    path, truth, _, _ = capture
    rc, out, _ = _both(tmp_path, ["-s", path, "--block-size", "65536",
                                  "-l", "47.0,8.0", "--stats-interval", "0"])
    assert rc == 0 and any("Type 17" in ln for ln in out)
    assert len(_rows(tmp_path / "port.db")["aircraft"]) >= 10


def test_cli_resampled_file(tmp_path):
    """-r 4e6: the host resample path (streaming resampler -> framed
    blocks -> run_pipelined) in both packages on the CPU."""
    frames = encoder.random_df17_frames(6, seed=91)
    iq, truth = encoder.make_capture(frames, rate=4e6, snr_db=25.0,
                                     spacing=16000, seed=91)
    path = str(tmp_path / "cap4m.c64")
    iq.tofile(path)
    rc, out, _ = _both(tmp_path, ["-s", path, "-r", "4e6", "--block-size",
                                  "65536", "--stats-interval", "0"],
                       resampled=True)
    assert rc == 0 and _want(truth) <= _icaos(out)


def test_cli_resampled_int8_matches_reference(capture6, tmp_path):
    """The acceptance run: --int8 -r 6e6 --channel-rate 4e6 --block-size
    65536 -d out.db, one capture and two (the channel runner)."""
    for srcs in (capture6[:1], capture6):
        argv = []
        for p in srcs:
            argv += ["-s", p]
        rc, out, _ = _both(tmp_path, argv + [
            "--int8", "-r", "6e6", "--channel-rate", "4e6", "--block-size",
            "65536", "--stats-interval", "0"], resampled=True)
        assert rc == 0 and out
        assert _rows(tmp_path / "port.db")["aircraft"]


def test_cli_batched_int8(capture, tmp_path):
    """--batch 3 --int8 on a complex64 capture: the native runner with
    per-block AGC; every injected frame's address is printed."""
    path, truth, _, _ = capture
    rc, out, _ = _both(tmp_path, ["-s", path, "--block-size", "32768",
                                  "--batch", "3", "--int8",
                                  "--stats-interval", "0"])
    assert rc == 0 and _want(truth) <= _icaos(out)


def test_cli_int8_at_block_65536(capture, tmp_path):
    path, truth, _, _ = capture
    rc, out, _ = _both(tmp_path, ["-s", path, "--int8", "--block-size",
                                  "65536", "--stats-interval", "0"])
    assert rc == 0 and _want(truth) <= _icaos(out)


def test_cli_two_f32_channels(capture, tmp_path):
    """Two -s sources without --int8: run_channels in both packages."""
    path, truth, _, _ = capture
    rc, out, _ = _both(tmp_path, ["-s", path, "-s", path, "--block-size",
                                  "65536", "--stats-interval", "0"])
    assert rc == 0 and _want(truth) <= _icaos(out)


def test_cli_native_matches_python_path(capture, tmp_path):
    """A uc8 capture with --int8, through the native runner and through
    --no-native (the Python framer and run_pipelined), in both packages:
    the same rows."""
    _, truth, _, upath = capture
    rows = []
    for extra in ([], ["--no-native"]):
        rc, _, _ = _both(tmp_path, ["-s", upath, "--file-format", "uc8",
                                    "--int8", "--block-size", "32768",
                                    "--batch", "2", "-n",
                                    "--stats-interval", "0"] + extra)
        assert rc == 0
        rows.append(_rows(tmp_path / "port.db")["aircraft"])
    assert {f"{r[0]:06x}" for r in rows[0]} >= _want(truth)
    assert [r[0] for r in rows[0]] == [r[0] for r in rows[1]]


def test_cli_native_start_sample_resume(capture, tmp_path):
    path, _, _, _ = capture
    rc, part, _ = _both(tmp_path, ["-s", path, "--block-size", "32768",
                                   "--int8", "--batch", "2",
                                   "--start-sample", "65536",
                                   "--stats-interval", "0"])
    assert rc == 0 and part


def test_cli_int8_quiet_c64_capture_uses_agc(tmp_path):
    """A c64 capture at 2% of full scale with --int8 still decodes: the
    per-block AGC quantize path."""
    frames = encoder.random_df17_frames(8, seed=93)
    iq, truth = encoder.make_capture(frames, snr_db=22.0, spacing=7037,
                                     seed=93, total_samples=1 << 16)
    iq = (iq / float(np.max(np.abs(iq))) * 0.02).astype(np.complex64)
    path = str(tmp_path / "quiet.c64")
    iq.tofile(path)
    rc, out, _ = _both(tmp_path, ["-s", path, "--block-size", "65536",
                                  "--int8", "--batch", "2",
                                  "--stats-interval", "0"])
    assert rc == 0 and _want(truth) <= _icaos(out)


def test_cli_i8_scale_for_sc16(capture, tmp_path):
    path, truth, _, _ = capture
    iq = np.fromfile(path, np.complex64)
    iq = iq / float(np.max(np.abs(iq))) * 0.9
    s16 = np.empty(2 * len(iq), np.int16)
    s16[0::2] = np.round(iq.real * 32767).astype(np.int16)
    s16[1::2] = np.round(iq.imag * 32767).astype(np.int16)
    spath = str(tmp_path / "cap.sc16")
    s16.tofile(spath)
    rc, out, _ = _both(tmp_path, ["-s", spath, "--file-format", "sc16",
                                  "--int8", "--i8-scale", "127",
                                  "--block-size", "32768", "--batch", "2",
                                  "--stats-interval", "0"])
    assert rc == 0 and _want(truth) <= _icaos(out)


def test_cli_synthetic_source(tmp_path):
    """No -s: the synthetic source (the encoder's traffic), identical in
    both packages."""
    rc, out, _ = _both(tmp_path, ["--max-blocks", "2", "--block-size",
                                  str(1 << 16), "--stats-interval", "0"])
    assert rc == 0 and out


def test_stats_json_output(capture, tmp_path):
    """--stats-json: the same final record in both packages (the fixed
    clock makes ts and msps equal too)."""
    import json
    path, truth, _, _ = capture
    recs = []
    for name, mod in (("ref", ref_rx), ("port", rx)):
        out = tmp_path / f"{name}.ndjson"
        rc, _, _ = _run(mod, ["-s", path, "-n", "--block-size", "65536",
                              "--stats-json", str(out),
                              "--stats-interval", "3600"])
        assert rc == 0
        recs.append([json.loads(ln) for ln in out.read_text().splitlines()])
    assert recs[1] == recs[0]
    final = recs[1][-1]
    assert final["crc_ok"] >= len(truth) and final["ring_dropped"] == 0
    assert {"ts", "msps", "blocks", "preambles", "corrected", "crc_fail",
            "overflow", "ring_dropped", "emitted"} <= set(final)


def test_cli_all_file_plugins(capture, tmp_path):
    """SQLite, KML, aircraft.json, wx and stats on the native int8 path,
    with the TCP servers on OS-assigned ports: the same rows as the
    reference, every file written, and no thread left behind."""
    _, truth, _, upath = capture
    before = set(threading.enumerate())
    argv = ["-s", upath, "--file-format", "uc8", "--int8", "--block-size",
            "65536", "--batch", "2", "-n", "-P", "0", "-w", "0", "-B", "0",
            "-K", str(tmp_path / "p.kml"), "-j", str(tmp_path / "p.json"),
            "--wx", str(tmp_path / "p.wx"), "--stats-json",
            str(tmp_path / "p.stats"), "-l", "47.0,8.0",
            "--stats-interval", "0"]
    rc, _, _ = _both(tmp_path, argv)
    assert rc == 0
    assert len(_rows(tmp_path / "port.db")["aircraft"]) >= len(_want(truth))
    assert open(tmp_path / "p.kml").read().count("<Placemark") >= 1
    assert (tmp_path / "p.json").read_text().startswith("{")
    leftover = [t for t in threading.enumerate()
                if t not in before and t.is_alive()]
    assert not leftover, leftover


def test_cli_profile_writes_a_trace(capture, tmp_path):
    path, _, _, _ = capture
    logdir = tmp_path / "prof"
    rc, _, _ = _run(rx, ["-s", path, "-n", "--block-size", "65536",
                         "--max-blocks", "1", "--profile", str(logdir),
                         "--compile-cache", str(tmp_path / "cc"),
                         "--stats-interval", "0"])
    assert rc == 0
    traces = list(logdir.glob("trace_*.json"))
    assert traces and traces[0].stat().st_size > 0
    assert not (tmp_path / "cc").exists()


# --- the CLI's surface -------------------------------------------------------

def test_cli_argparser_covers_reference_options():
    """Every option of the reference, with its default; the port adds
    --device (default cuda)."""
    ref = vars(ref_rx.build_argparser().parse_args([]))
    got = vars(rx.build_argparser().parse_args([]))
    assert set(got) - set(ref) == {"device"} and got["device"] == "cuda"
    assert {k: got[k] for k in ref} == ref
    argv = ["-s", "x.c64", "-r", "8e6", "-T", "6.5", "-P", "30003",
            "-K", "k.kml", "-d", "a.db", "-w", "9988", "-m",
            "localhost:5000", "-l", "1,2", "-n", "-g", "30", "-f", "1090e6",
            "--udp-timeout", "3.5"]
    ref = vars(ref_rx.build_argparser().parse_args(argv))
    got = vars(rx.build_argparser().parse_args(argv))
    assert {k: got[k] for k in ref} == ref


@pytest.mark.parametrize("s", ["47.5,8.25", "47.5,8.25,430", None, "",
                               "47.0", "47.0,abc", "x", "1,2,3,4"])
def test_cli_location_parsing(s):
    try:
        want = ref_rx.parse_location(s)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            rx.parse_location(s)
        assert str(got.value) == str(e)
        return
    assert rx.parse_location(s) == want


def test_cli_bad_location_clean_error(capture, tmp_path):
    path, _, _, _ = capture
    for bad in ("47.0", "47.0,abc", "x"):
        assert _both(tmp_path, ["-s", path, "-l", bad], db=False)[0] == 2


@pytest.mark.parametrize("argv", [
    ["-s", "uhd"], ["-s", "osmocom"], ["-s", "/no/such/capture.c64"],
    ["-s", "udp", "--file-format", "uc8"], ["-s", "udp", "-r", "4e6"],
    ["-s", "synthetic", "-r", "4e6"], ["--block-size", "128"],
    ["--channel-rate", "3e6"]])
def test_cli_validation_exits_match_reference(argv, tmp_path):
    assert _both(tmp_path, argv + ["-n", "--stats-interval", "0"],
                 db=False)[0] == 2


def test_validation_failure_closes_registered_plugins(capture, tmp_path):
    """Every validation exit after the plugins are registered closes them
    (the kml rewrite thread outlives main() otherwise): the reference's
    four cases, the two exits of _run_multichannel that the reference
    leaks, and --pub, which the port refuses."""
    path, _, d, _ = capture
    db, kml = str(tmp_path / "leak.db"), str(tmp_path / "leak.kml")
    plug = ["-d", db, "--kml", kml, "--stats-interval", "0"]
    cases = [
        (["-s", "beast://127.0.0.1:1", "-s", path] + plug, True),
        (["-s", "beast://::1"] + plug, True),
        (["-s", path, "--file-format", "beast", "-s", path] + plug, True),
        (["-s", path, "--kml", kml, "--stats-interval", "0"], True),
        (["-s", path, "-s", "udp"] + plug, True),
        (["-s", path, "-s", "synthetic", "-r", "4e6"] + plug, True),
        (["-s", path, "--pub", "tcp://127.0.0.1:5999"] + plug, False),
    ]
    for argv, same_as_ref in cases:
        if same_as_ref:
            assert _run(ref_rx, argv)[0] == 2, argv
        before = set(threading.enumerate())
        rc, _, err = _run(rx, argv)
        assert rc == 2, argv
        leftover = [t for t in threading.enumerate()
                    if t not in before and t.is_alive()]
        assert not leftover, (argv, leftover)
    assert "pyzmq" in _run(rx, cases[-1][0])[2]


def test_cli_without_a_card_is_a_clean_error(capture):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    path, _, _, _ = capture
    err = io.StringIO()
    with redirect_stderr(err), redirect_stdout(io.StringIO()):
        rc = rx.main(["-s", path, "-n", "--stats-interval", "0"])
    assert rc == 2 and "no CUDA device" in err.getvalue()


def test_python_m_entry_point(capture6, tmp_path):
    """python -m airmodes_torch.apps.modes_rx --device cpu --int8 -r 6e6
    --channel-rate 4e6 --block-size 65536 -s <capture> -d out.db exits 0
    and writes the reference's aircraft (the wall-clock epoch of the
    subprocess differs, so the rows are compared without `seen`)."""
    db = str(tmp_path / "m.db")
    args = ["-s", capture6[0], "--int8", "-r", "6e6", "--channel-rate",
            "4e6", "--block-size", "65536", "-n", "--stats-interval", "0"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-m", "airmodes_torch.apps.modes_rx",
                          "--device", "cpu", "-d", db] + args, cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    rc, _, _ = _run(ref_rx, args + ["-d", str(tmp_path / "r.db")])
    assert rc == 0

    def rows(p):
        con = sqlite3.connect(p)
        try:
            return sorted(con.execute("SELECT icao, ident, category FROM "
                                      "aircraft").fetchall())
        finally:
            con.close()
    assert rows(db) == rows(str(tmp_path / "r.db")) != []


# --- sources -----------------------------------------------------------------

def test_framer_flush_owns_all_trailing_samples():
    from airmodes.io.sources import frame_blocks as ref_frames
    from airmodes_torch.io.sources import buffered_framer, frame_blocks
    from airmodes.config import DspConfig as JaxCfg
    cfg = DspConfig(block_size=1 << 14, max_detections=16)
    n = 2 * cfg.block_size + cfg.right_halo - 1
    rng = np.random.default_rng(3)
    iq = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
          ).astype(np.complex64)
    ref = list(ref_frames(iq, JaxCfg(block_size=1 << 14, max_detections=16)))
    fr = buffered_framer(cfg)
    got = list(fr.push(iq)) + list(fr.flush())
    assert len(got) == len(ref) == len(list(frame_blocks(iq, cfg))) == 3
    for (a, sa), (b, sb) in zip(got, ref):
        assert sa == sb
        np.testing.assert_array_equal(a, b)


def test_long_stream_soak_counters_consistent():
    """30 blocks through run_pipelined (batch 4, on_messages): the stats
    counters are consistent and every injected frame decodes once."""
    from airmodes_torch.dsp import host as host_mod
    from airmodes_torch.io import sources, stream
    cfg = DspConfig(block_size=1 << 14, max_detections=32)
    total = 30 * cfg.block_size
    frames = encoder.random_df17_frames(60, seed=55)
    iq, truth = encoder.make_capture(frames, snr_db=18.0,
                                     spacing=total // 60 - 37, seed=55,
                                     total_samples=total)
    stats = host_mod.BlockStats()
    seen = []
    blocks = list(stream.run_pipelined(sources.frame_blocks(iq, cfg), cfg,
                                       stats=stats, batch=4,
                                       on_messages=seen.append,
                                       device="cpu"))
    msgs = [m for b in blocks for m in b]
    assert seen == blocks
    hexes = [m.split()[1] for m in msgs]
    for t in truth:
        assert hexes.count(t.hex) == 1, t.hex
    assert stats.emitted == len(msgs)
    assert stats.crc_ok + stats.corrected <= stats.emitted
    assert stats.preambles >= stats.emitted and stats.overflow == 0


def test_open_source_dispatch_matches_reference(capture):
    from airmodes.config import DspConfig as JaxCfg
    from airmodes.config import SourceConfig as JaxSrc
    from airmodes.io.sources import open_source as ref_open
    from airmodes_torch.config import SourceConfig
    from airmodes_torch.io.sources import open_source
    path, _, _, _ = capture
    jc = JaxCfg(block_size=1 << 16, max_detections=16)
    cfg = DspConfig(block_size=1 << 16, max_detections=16)
    for kw in (dict(kind="file", path=path), dict(kind="synthetic")):
        got = list(open_source(SourceConfig(**kw), cfg))
        want = list(ref_open(JaxSrc(**kw), jc))
        assert [s for _, s in got] == [s for _, s in want]
        assert all(np.array_equal(a, b) for (a, _), (b, _) in zip(got,
                                                                  want))
    with pytest.raises(ValueError, match="resample"):
        open_source(SourceConfig(kind="synthetic", sample_rate=2.4e6), cfg)
    for kind, exc in (("uhd", RuntimeError), ("bogus", ValueError)):
        with pytest.raises(exc):
            open_source(SourceConfig(kind=kind), cfg)
    with pytest.raises(ValueError, match="path"):
        open_source(SourceConfig(kind="file"), cfg)


def test_framer_rejects_tiny_block():
    from airmodes_torch.io.sources import buffered_framer
    with pytest.raises(ValueError, match="left_halo"):
        buffered_framer(DspConfig(block_size=128, max_detections=4))


def _udp_pair():
    srv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    srv.bind(("127.0.0.1", 0))
    return srv, srv.getsockname()[1]


def test_udp_source_decodes_and_flushes():
    """udp_source on an injected socket: a short transmission (under one
    block) arrives whole through the timeout flush, malformed and empty
    datagrams are skipped, and the blocks equal frame_blocks of the same
    samples; every frame decodes."""
    from airmodes_torch.dsp import host as host_mod
    from airmodes_torch.dsp.pipeline import demod_block_packed, unpack_table
    from airmodes_torch.io.sources import frame_blocks, udp_source
    cfg = DspConfig(block_size=1 << 14, max_detections=16)
    frames = encoder.random_df17_frames(3, seed=91)
    iq, truth = encoder.make_capture(frames, snr_db=22.0, spacing=3000,
                                     seed=91, total_samples=12000)
    srv, port = _udp_pair()
    snd = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    snd.sendto(b"\x00" * 10, ("127.0.0.1", port))        # malformed
    raw = iq.astype(np.complex64).tobytes()
    for off in range(0, len(raw), 8192):
        snd.sendto(raw[off: off + 8192], ("127.0.0.1", port))
    snd.sendto(b"", ("127.0.0.1", port))
    snd.close()
    blocks = list(udp_source(cfg, sock=srv, timeout_s=1.0))
    # the malformed datagram keeps its one whole sample (8 zero bytes)
    want = list(frame_blocks(np.concatenate([np.zeros(1, np.complex64),
                                             iq]), cfg))
    assert len(blocks) == len(want) == 1
    assert blocks[0][1] == want[0][1] == 0
    np.testing.assert_array_equal(blocks[0][0], want[0][0])
    msgs = []
    for block, start in blocks:
        table = unpack_table(demod_block_packed(block, cfg,
                                                device="cpu").numpy())
        msgs += host_mod.table_to_messages(table, start, cfg.channel_rate)
    assert {t.hex for t in truth} <= {m.split()[1] for m in msgs}


def test_udp_source_timeout_zero_never_gives_up():
    """timeout_s=0 disables the silence timeout; the stream still ends
    through max_blocks."""
    from airmodes_torch.io.sources import udp_source
    cfg = DspConfig(block_size=1 << 12, max_detections=16)
    srv, port = _udp_pair()
    snd = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    raw = np.zeros(4 * (1 << 12), np.complex64).tobytes()
    for off in range(0, len(raw), 8192):
        snd.sendto(raw[off: off + 8192], ("127.0.0.1", port))
    snd.close()
    blocks = list(udp_source(cfg, sock=srv, timeout_s=0, max_blocks=1))
    assert len(blocks) == 1 and srv.fileno() == -1


def test_synthetic_source_matches_reference():
    from airmodes.config import DspConfig as JaxCfg
    from airmodes.io.sources import synthetic_source as ref_syn
    from airmodes_torch.io.sources import synthetic_source
    got = list(synthetic_source(DspConfig(block_size=1 << 14), n_blocks=3,
                                n_messages=20, seed=4))
    want = list(ref_syn(JaxCfg(block_size=1 << 14), n_blocks=3,
                        n_messages=20, seed=4))
    assert len(got) == len(want) == 3
    for (a, sa), (b, sb) in zip(got, want):
        assert sa == sb and np.array_equal(a, b)
