"""The port's `modes_rx` CLI (`airmodes_torch.apps.modes_rx`, run with
`--device cpu`) against the reference's `airmodes.apps.modes_rx.main` on the
same captures and arguments, and the Python sources it uses
(`io.sources`: `udp_source`, `synthetic_source`, `open_source`, the
framers). Twins of the modes_rx tests of tests/test_cli.py, with `--pub`
read by a zmq subscriber; and of the `modes_gui` and `modes_mlat` cases
of tests/test_cli.py, tests/test_mlat_net.py and tests/test_netclient.py
(`airmodes_torch.apps.modes_gui`, `modes_mlat` against the reference's:
exit codes, messages, printed rows and solutions).

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


def test_validation_failure_closes_registered_plugins(capture, tmp_path,
                                                     monkeypatch):
    """Every validation exit after the plugins are registered closes them
    (the kml rewrite thread outlives main() otherwise): the reference's
    four cases and the two exits of _run_multichannel that the reference
    leaks; with --pub the zmq relay is closed too."""
    from airmodes_torch.io import relay
    path, _, d, _ = capture
    db, kml = str(tmp_path / "leak.db"), str(tmp_path / "leak.kml")
    plug = ["-d", db, "--kml", kml, "--stats-interval", "0"]
    cases = [
        ["-s", "beast://127.0.0.1:1", "-s", path] + plug,
        ["-s", "beast://::1"] + plug,
        ["-s", path, "--file-format", "beast", "-s", path] + plug,
        ["-s", path, "--kml", kml, "--stats-interval", "0"],
        ["-s", path, "-s", "udp"] + plug,
        ["-s", path, "-s", "synthetic", "-r", "4e6"] + plug,
    ]
    relays = []
    if relay.HAVE_ZMQ:
        class Spy(relay.zmq_pubsub_iface):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                relays.append(self)

        monkeypatch.setattr(relay, "zmq_pubsub_iface", Spy)
        cases.append(["-s", "beast://::1", "--pub", "tcp://127.0.0.1:*"]
                     + plug)
    for argv in cases:
        assert _run(ref_rx, argv)[0] == 2, argv
        before = set(threading.enumerate())
        rc, _, err = _run(rx, argv)
        assert rc == 2, argv
        leftover = [t for t in threading.enumerate()
                    if t not in before and t.is_alive()]
        assert not leftover, (argv, leftover)
    assert len(relays) == relay.HAVE_ZMQ
    assert all(r._closed.is_set() and r._pub is None for r in relays)


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


# --- --pub, modes_mlat and modes_gui ------------------------------------------

import airmodes.apps.modes_gui as ref_gui  # noqa: E402
import airmodes.apps.modes_mlat as ref_mlat  # noqa: E402
import airmodes_torch.apps.modes_gui as gui  # noqa: E402
import airmodes_torch.apps.modes_mlat as mlat  # noqa: E402


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _zmq_or_skip():
    from airmodes_torch.io import relay
    import airmodes.io.relay as ref_relay
    assert relay.HAVE_ZMQ == ref_relay.HAVE_ZMQ
    if not relay.HAVE_ZMQ:
        pytest.skip("pyzmq is not installed")
    import zmq
    return zmq


def test_pub_matches_reference(capture, monkeypatch):
    """--pub: a zmq subscriber receives the same raw lines from the
    port's CLI as from the reference's, in order. The relay is the real
    one; the test only holds main until its SUB socket has joined (zmq
    drops what a PUB sends before then) and holds the close until every
    line has arrived (the relay closes with linger 0)."""
    zmq = _zmq_or_skip()
    import airmodes.io.relay as ref_relay
    from airmodes_torch.io import relay
    path = capture[0]
    runs = []
    for mod, rel in ((ref_rx, ref_relay), (rx, relay)):
        addr = f"tcp://127.0.0.1:{_free_port()}"
        sub = zmq.Context.instance().socket(zmq.SUB)
        sub.setsockopt(zmq.SUBSCRIBE, b"")
        sub.setsockopt(zmq.RCVTIMEO, 50)
        sub.connect(addr)
        got, joined, stop = [], threading.Event(), threading.Event()

        def receive():
            while not stop.is_set():
                try:
                    topic, msg = sub.recv_multipart()
                except zmq.Again:
                    continue
                if topic == b"probe":
                    joined.set()
                else:
                    got.append((topic.decode(), msg.decode()))

        class Joined(rel.zmq_pubsub_iface):
            n_sent = 0

            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                deadline = time.time() + 10
                while not joined.wait(0.01) and time.time() < deadline:
                    with self._pub_lock:
                        self._pub.send_multipart([b"probe", b""])

            def publish(self, topic, msg):
                Joined.n_sent += 1
                super().publish(topic, msg)

            def close(self):
                deadline = time.time() + 10
                while len(got) < Joined.n_sent and time.time() < deadline:
                    time.sleep(0.01)
                super().close()

        monkeypatch.setattr(rel, "zmq_pubsub_iface", Joined)
        th = threading.Thread(target=receive)
        th.start()
        try:
            rc, _, err = _run(mod, ["-s", path, "--block-size", "65536",
                                    "-n", "--stats-interval", "0",
                                    "--pub", addr])
        finally:
            stop.set()
            th.join(timeout=10)
            sub.close(linger=0)
        assert rc == 0, err
        assert joined.is_set() and len(got) == Joined.n_sent
        runs.append(got)
    assert runs[1] == runs[0]
    assert len(runs[0]) >= 10 and {t for t, _ in runs[0]} == {"dl_data"}


# modes_mlat: the stations and aircraft of tests/test_mlat_net.py
C_LIGHT = 299792458.0
STATIONS = [(47.00, 8.00, 500.0), (47.25, 8.05, 420.0),
            (46.95, 8.40, 610.0), (47.15, 8.30, 800.0)]
AIRCRAFT = (47.10, 8.20, 10000.0)


def _arrivals(pos, stations, t_emit):
    from airmodes_torch.decode import mlat as M
    p = M.llh2ecef(pos)
    return [t_emit + float(np.linalg.norm(p - M.llh2ecef(s))) / C_LIGHT
            for s in stations]


def _mlat_wire(frame, nbits, ts, synd=0):
    return (f"{frame >> (nbits - 5)} {frame:0{nbits // 4}x} {synd:06x} 0 "
            f"-20.00 {ts:.9f}")


def _mlat_run(mod, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = mod.main(argv)
    return rc, out.getvalue().splitlines(), err.getvalue()


def _solutions(lines, hexes):
    return [ln for ln in lines if ln.startswith("mlat ") and hexes in ln]


def _lat_lon(line):
    return (float(line.split("(")[1].split(",")[0]),
            float(line.split(",")[1].split(")")[0]))


@pytest.mark.parametrize("argv", [
    ["-S", "47.0,8.0@zmq://x"],                      # missing alt
    ["-S", "47.0,8.0,500"],                          # missing @URL
    ["-S", "47.0,8.0,500@beast://h:1"] * 3 + ["--min-stations", "2"],
    ["-S", "47.0,8.0,500@beast://h:1"] * 2,          # fewer than 3
    ["-S", "47.0,8.0,500@beast://h", "-S", "47.1,8.0,500@beast://h:1",
     "-S", "47.0,8.1,500@beast://h:1"],             # bad URL
])
def test_mlat_validation_exits_match_reference(argv):
    """Malformed stations, too few of them and a typo'd feed URL are
    clean CLI errors (exit 2) with the reference's message."""
    got = _mlat_run(mlat, argv)
    want = _mlat_run(ref_mlat, argv)
    assert got[0] == want[0] == 2
    assert got[2] == want[2]


def test_mlat_app_over_zmq():
    """Three zmq publishers (modes_rx --pub feeds) -> modes_mlat -> the
    reference's printed solution, line for line."""
    zmq = _zmq_or_skip()
    from airmodes_torch.io.relay import zmq_pubsub_iface
    from airmodes_torch.testing import encoder as tenc
    frame = tenc.df17_frame(0x4840D6, tenc.me_airborne_position(
        AIRCRAFT[2] / 0.3048, AIRCRAFT[0], AIRCRAFT[1], odd=False))
    other = tenc.df17_frame(0x222222, tenc.me_identification("AGE"))
    ts = _arrivals(AIRCRAFT, STATIONS[:3], 100.0)
    lines = []
    for mod in (ref_mlat, mlat):
        pubs = [zmq_pubsub_iface(pubaddr="tcp://127.0.0.1:*")
                for _ in range(3)]
        addrs = [p._pub.getsockopt(zmq.LAST_ENDPOINT).decode() for p in pubs]
        argv = [f"-S{STATIONS[i][0]},{STATIONS[i][1]},{STATIONS[i][2]}"
                f"@{addrs[i]}" for i in range(3)]
        argv += ["--alt-datum", "ellipsoid", "--max-seconds", "30",
                 "--max-solutions", "1"]
        res = []
        th = threading.Thread(target=lambda: res.append(
            _mlat_run(mod, argv)))
        th.start()
        try:
            # until the SUB sockets have joined: the three copies, then a
            # later unrelated frame that ages the window out
            while th.is_alive():
                for i in range(3):
                    pubs[i].publish("dl_data", _mlat_wire(frame, 112, ts[i]))
                time.sleep(0.1)
                pubs[0].publish("dl_data", _mlat_wire(other, 112, ts[0] + 1))
                th.join(timeout=0.3)
        finally:
            th.join(timeout=40)
            for p in pubs:
                p.close()
        rc, out, _ = res[0]
        assert rc == 0
        lines.append(_solutions(out, "4840d6")[:1])
    assert lines[1] == lines[0] and lines[0]
    lat, lon = _lat_lon(lines[0][0])
    assert abs(lat - AIRCRAFT[0]) < 0.02 and abs(lon - AIRCRAFT[1]) < 0.02


def _beast_stations(gps_time):
    from airmodes_torch.outputs.beast import output_beast
    return [output_beast(port=0, host="127.0.0.1", gps_time=gps_time)
            for _ in STATIONS]


def _printed(monkeypatch, mod):
    """The lines `mod` prints to stdout, collected apart from another
    module's (two mains run at once); stderr prints pass through."""
    lines = []

    def collect(*a, **k):
        if "file" in k:
            print(*a, **k)
        else:
            lines.append(" ".join(str(x) for x in a))

    monkeypatch.setattr(mod, "print", collect, raising=False)
    return lines


def test_mlat_over_beastgps_feeds(monkeypatch):
    """Four GPS-disciplined Beast stations -> modes_mlat solves the
    aircraft from TDOA, exit code 0, in both packages at once, each with
    its own stations. Every round stamps fresh arrivals on all four
    stations, then, after a pause, a later frame that ages the
    correlation window out, so a round that every connected feed sees
    solves whenever the connections come up."""
    from airmodes_torch.testing import encoder as tenc
    frame = tenc.df17_frame(0x4840D6, tenc.me_identification("MLAT01"))
    flushf = tenc.df17_frame(0x111111, tenc.me_identification("FLUSH"))
    stop = threading.Event()
    runs, threads, srvs = {}, [], []
    for mod in (ref_mlat, mlat):
        mine = _beast_stations(gps_time=True)
        srvs += mine

        def feeder(mine=mine):
            while not stop.is_set():
                ts = _arrivals(AIRCRAFT, STATIONS, time.time())
                for s, srv in enumerate(mine):
                    srv.output(_mlat_wire(frame, 112, ts[s]))
                stop.wait(0.3)
                t2 = time.time()
                for srv in mine:
                    srv.output(_mlat_wire(flushf, 112, t2))
                stop.wait(0.1)

        argv = []
        for (lat, lon, alt), s in zip(STATIONS, mine):
            argv += ["-S", f"{lat},{lon},{alt}@beastgps://127.0.0.1:{s.port}"]
        argv += ["--alt-datum", "ellipsoid", "--max-seconds", "60",
                 "--max-solutions", "1"]
        lines = _printed(monkeypatch, mod)
        threads += [threading.Thread(target=feeder), threading.Thread(
            target=lambda m=mod, a=argv, ln=lines: runs.__setitem__(
                m, (m.main(a), ln)))]
    for t in threads:
        t.start()
    try:
        for t in threads[1::2]:
            t.join(timeout=90)
    finally:
        stop.set()
        for t in threads:
            t.join()
        for s in srvs:
            s.close()
    for mod in (ref_mlat, mlat):
        rc, lines = runs[mod]
        assert rc == 0
        sols = _solutions(lines, "4840d6")
        assert len(sols) == 1, (mod.__name__, lines)
        assert sols[0].startswith(f"mlat {frame:028x} 4840d6 (")
        lat, lon = _lat_lon(sols[0])
        assert abs(lat - AIRCRAFT[0]) < 0.02 and abs(lon - AIRCRAFT[1]) < 0.02


def test_mlat_clock_sync_over_plain_beast_feeds():
    """Free-running receiver counters with different boot epochs (no GPS):
    --clock-sync trains per-station offsets on DF17 positions, then a DF4
    target solves near its position, in both packages."""
    from airmodes_torch.decode.altitude import encode_alt_q
    from airmodes_torch.testing import encoder as tenc
    ref_pos = (47.08, 8.12, 10000.0)
    target = (47.12, 8.28, 9500.0)
    boot = [0.0, 1234.5, 99.25, 7.75]
    tgt = tenc.df4_frame(0xABCDEF, encode_alt_q(target[2] / 0.3048))
    want_hex = f"{tgt:014x}"
    for mod in (ref_mlat, mlat):
        srvs = _beast_stations(gps_time=False)
        stop = threading.Event()

        def feeder():
            while not stop.is_set():
                t = time.time()
                batch = [(tenc.df17_frame(0x4840D6, tenc.me_airborne_position(
                    ref_pos[2] / 0.3048, ref_pos[0], ref_pos[1], odd=odd)),
                    112, ref_pos) for odd in (False, True)]
                batch.append((tgt, 56, target))
                for j, (f, n, pos) in enumerate(batch):
                    ts = _arrivals(pos, STATIONS, t + 0.02 * j)
                    for s, srv in enumerate(srvs):
                        srv.output(_mlat_wire(f, n, ts[s] + boot[s]))
                stop.wait(0.2)

        th = threading.Thread(target=feeder)
        th.start()
        argv = []
        for (lat, lon, alt), s in zip(STATIONS, srvs):
            argv += ["-S", f"{lat},{lon},{alt}@beast://127.0.0.1:{s.port}"]
        try:
            rc, out, _ = _mlat_run(mod, argv + [
                "--alt-datum", "ellipsoid", "--clock-sync", "--max-seconds",
                "90", "--max-solutions", "3"])
        finally:
            stop.set()
            th.join()
            for s in srvs:
                s.close()
        assert rc == 0, mod.__name__
        sols = _solutions(out, want_hex)
        assert sols, (mod.__name__, out)
        lat, lon = _lat_lon(sols[-1])
        assert abs(lat - target[0]) < 0.03 and abs(lon - target[1]) < 0.03


def test_mlat_http_map():
    """--http serves the solved positions as aircraft.json."""
    import json as _json
    import urllib.request
    from airmodes_torch import crc
    from airmodes_torch.decode.altitude import encode_alt_q
    from airmodes_torch.testing import encoder as tenc
    target = (47.12, 8.28, 9500.0)
    tgt = tenc.df4_frame(0xABCDEF, encode_alt_q(target[2] / 0.3048))
    flush = tenc.df17_frame(0x111111, tenc.me_identification("AGE"))
    srvs = _beast_stations(gps_time=True)
    stop = threading.Event()

    def feeder():
        while not stop.is_set():
            ts = _arrivals(target, STATIONS, time.time())
            for s, srv in enumerate(srvs):
                srv.output(_mlat_wire(tgt, 56, ts[s], crc.crc24(tgt, 56)))
            stop.wait(0.3)
            t2 = time.time()
            for srv in srvs:
                srv.output(_mlat_wire(flush, 112, t2, crc.crc24(flush, 112)))
            stop.wait(0.1)

    port = _free_port()
    argv = []
    for (lat, lon, alt), s in zip(STATIONS, srvs):
        argv += ["-S", f"{lat},{lon},{alt}@beastgps://127.0.0.1:{s.port}"]
    argv += ["--alt-datum", "ellipsoid", "--max-seconds", "15",
             "--http", str(port)]
    feed = threading.Thread(target=feeder)
    feed.start()
    res = []
    th = threading.Thread(target=lambda: res.append(_mlat_run(mlat, argv)))
    th.start()
    doc, ac = None, []
    try:
        deadline = time.time() + 15
        while time.time() < deadline and not ac:
            try:
                doc = _json.load(urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/data/aircraft.json",
                    timeout=1))
                ac = [a for a in doc["aircraft"] if a["hex"] == "abcdef"]
            except OSError:
                pass
            time.sleep(0.25)
    finally:
        th.join(timeout=20)
        stop.set()
        feed.join()
        for s in srvs:
            s.close()
    assert res and res[0][0] == 0
    assert ac and abs(ac[0]["lat"] - target[0]) < 0.03
    assert abs(ac[0]["lon"] - target[1]) < 0.03


def _gui_run(mod, argv, capsys):
    """(exit code, the aircraft rows without their last-seen column) of
    one headless modes_gui run; the port's on the CPU."""
    if mod is gui:
        argv = list(argv) + ["--device", "cpu"]
    capsys.readouterr()
    rc = mod.main(list(argv) + ["--backend", "curses"])
    out = capsys.readouterr()
    rows = [ln.rsplit(" ", 1)[0] for ln in out.out.splitlines()
            if re.match(r"^[0-9a-f]{6} ", ln)]
    return rc, rows, out.out + out.err


def test_gui_default_synthetic_source(capsys):
    """No -s: the synthetic source through build_msg_iter; the headless
    summary prints the reference's aircraft rows."""
    argv = ["--duration", "60", "--block-size", str(1 << 16),
            "--max-blocks", "2"]
    rc, rows, _ = _gui_run(gui, argv, capsys)
    want = _gui_run(ref_gui, argv, capsys)
    assert rc == want[0] == 0
    assert rows == want[1] and rows


def test_gui_resampled_file(tmp_path, capsys):
    """-r 4e6 on a 4 Msps capture frames it at the channel rate after the
    resampler: the reference's rows."""
    frames = encoder.random_df17_frames(6, seed=92)
    iq, truth = encoder.make_capture(frames, rate=4e6, snr_db=25.0,
                                     spacing=16000, seed=92)
    path = str(tmp_path / "gcap4m.c64")
    iq.tofile(path)
    argv = ["-s", path, "-r", "4e6", "--duration", "60", "--block-size",
            "65536"]
    rc, rows, _ = _gui_run(gui, argv, capsys)
    want = _gui_run(ref_gui, argv, capsys)
    assert rc == want[0] == 0
    assert rows == want[1]
    assert {r.split()[0] for r in rows} == _want(truth)


def test_gui_network_source(capsys):
    """The dashboard rides a remote beast:// feed (no local DSP)."""
    from airmodes_torch import crc
    from airmodes_torch.outputs.beast import output_beast
    frame = encoder.df17_frame(0xABC123, encoder.me_identification("GUINET"))
    synd = crc.crc24(frame, 112)
    for mod in (gui, ref_gui):
        srv = output_beast(port=0, host="127.0.0.1")
        stop = threading.Event()

        def feeder():
            while not stop.is_set():
                srv.output(f"17 {frame:028x} {synd:06x} 0 -20.00 "
                           f"{time.time():.9f}")
                stop.wait(0.05)

        t = threading.Thread(target=feeder)
        t.start()
        try:
            rc, rows, text = _gui_run(mod, ["-s", f"beast://127.0.0.1:"
                                                  f"{srv.port}",
                                            "--duration", "3.0"], capsys)
        finally:
            stop.set()
            t.join()
            srv.close()
        assert rc == 0 and "GUINET" in text, mod.__name__


def test_gui_frame_replay(tmp_path, capsys):
    """Recorded Beast frames replay through the decode stack, no DSP."""
    from airmodes_torch.outputs.beast import beast_encode
    frame = encoder.df17_frame(0xABC123, encoder.me_identification("GUIRPL"))
    p = tmp_path / "rec.beast"
    p.write_bytes(b"".join(beast_encode(f"{frame:028x}", -20.0, 1.0 + 0.1 * i)
                           for i in range(5)))
    argv = ["-s", str(p), "--file-format", "beast", "--duration", "60"]
    rc, rows, _ = _gui_run(gui, argv, capsys)
    want = _gui_run(ref_gui, argv, capsys)
    assert rc == want[0] == 0
    assert rows == want[1] and rows[0].startswith("abc123 GUIRPL")


@pytest.mark.parametrize("argv", [
    ["-s", "x.c64", "-s", "y.c64"],                 # one source only
    ["-s", "udp", "--file-format", "beast"],        # replay of a non-file
    ["-s", "udp", "-r", "4e6"],                     # resample: files only
    ["-s", "uhd"],                                  # no SDR hardware
    ["-s", "/no/such/capture.c64"],
    ["-s", "beast://rx30005"],                      # bad network URLs
    ["-s", "ftp://rx:1"],
    ["-l", "47.0"]])                                # bad location
def test_gui_validation_exits_match_reference(argv, capsys):
    rc, _, text = _gui_run(gui, argv + ["--duration", "1.0"], capsys)
    want_rc, _, want_text = _gui_run(ref_gui, argv + ["--duration", "1.0"],
                                     capsys)
    assert rc == want_rc == 2
    assert text == want_text


def test_gui_without_a_card_is_a_clean_error(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    capsys.readouterr()
    assert gui.main(["--backend", "curses", "--duration", "1.0"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
