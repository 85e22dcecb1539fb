"""The port's network frame ingestion (`airmodes_torch.io.netclient`, a copy
of `airmodes.io.netclient`), its in-process relay and profiling helpers,
and the CLI's network modes (aggregator, frame replay), against the
reference: the same inputs through both packages, compared exactly (the
Beast de-framer, the CRC acceptance of remote frames, AVR records, the GPS
and 12 MHz counter helpers, the live counter unwrap, the deduper, recorded
replay, URL parsing). Servers bind 127.0.0.1 port 0."""

import io
import random
import socket
import threading
import time
import types
from contextlib import redirect_stderr, redirect_stdout

import pytest

import airmodes.io.netclient as ref_nc
from airmodes.outputs.beast import beast_encode
from airmodes.testing import encoder
import airmodes_torch.io.netclient as nc

ICAO = 0x4840D6
DF17 = encoder.df17_frame(ICAO, encoder.me_identification("KLM1023", tc=4))
DF17_HEX = f"{DF17:028x}"
DF4_HEX = f"{encoder.df4_frame(ICAO, 0x1234):014x}"
DF11 = encoder.df11_frame(ICAO)
DF11_HEX = f"{DF11:014x}"


def _both(name, *args, **kw):
    """(port result, reference result) of module function `name`, with
    exceptions compared by class name and message."""
    out = []
    for mod in (nc, ref_nc):
        try:
            out.append(getattr(mod, name)(*args, **kw))
        except Exception as e:         # noqa: BLE001 - compared below
            out.append((type(e).__name__, str(e)))
    return out


# --- pure functions, exactly as the reference ------------------------------

def _frames_fuzz():
    rng = random.Random(99)
    cases = [DF17_HEX, DF4_HEX, DF11_HEX, f"{DF17 ^ 1:028x}",
             f"{DF11 ^ (1 << 40):014x}", "00", "xx" * 7,
             f"{17 << 51:014x}", DF17_HEX.upper(), "0x" + DF17_HEX[2:],
             f"{encoder.df24_frame(ICAO, nd=1, md=0xAB):028x}",
             f"{encoder.df11_frame(ICAO, interrogator=5):014x}"]
    for _ in range(300):
        n = rng.choice((14, 28, rng.randrange(0, 40)))
        cases.append("".join(rng.choice("0123456789abcdefxyz_")
                             for _ in range(n)))
    return cases


def test_frame_to_wire_matches_reference():
    for h in _frames_fuzz():
        for kw in ({"timestamp": 5.0},
                   {"ref_dbfs": -20.0, "timestamp": 1.7e9},
                   {"timestamp_ns": 1_700_000_000_123_456_789}):
            got, want = _both("frame_to_wire", h, **kw)
            assert got == want, (h, kw)


def test_frame_to_wire_rejects_undefined_dfs():
    from airmodes_torch import crc
    for df in (1, 2, 3, 6, 7, 8, 9, 10, 12, 13, 14, 15):
        payload = df << 27
        frame = (payload << 24) | crc.parity(payload, 32)
        assert _both("frame_to_wire", f"{frame:014x}") == [None, None], df
    for df in (19, 22, 23):
        payload = df << 83
        frame = (payload << 24) | crc.parity(payload, 88)
        assert _both("frame_to_wire", f"{frame:028x}") == [None, None], df


def _beast_streams():
    rng = random.Random(1234)
    whole = beast_encode(DF17_HEX, -20.0, 1.0)
    status = b"\x1a\x34" + bytes(6) + b"\x00" + bytes(range(14))
    esc = beast_encode(DF17_HEX, -3.0, 0x1A1A1A1A1A1A / 12e6)
    fuzz = bytearray()
    for _ in range(200):
        fuzz += bytes(rng.randrange(256) for _ in range(rng.randrange(40)))
        fuzz += whole
    return [whole + beast_encode(DF4_HEX, -3.5, 2.0),
            b"\x00garbage\x1a" + whole[:9] + whole,
            status + whole + status, esc, bytes(fuzz)]


@pytest.mark.parametrize("chunk", [1, 7, 64, 1 << 20])
def test_beast_parser_matches_reference(chunk):
    """Every stream, in chunks of 1, 7 and 64 bytes and whole: the same
    (type, counter, signal, payload) records."""
    for stream in _beast_streams():
        got, want = [], []
        p, q = nc.beast_parser(), ref_nc.beast_parser()
        for i in range(0, len(stream), chunk):
            got += p.push(stream[i: i + chunk])
            want += q.push(stream[i: i + chunk])
        assert got == want and got


@pytest.mark.parametrize("rec", [
    f"*{DF17_HEX}", f"@{0x123456789ABC:012x}{DF4_HEX}", "garbage", "",
    "@-23456789ab8d4840d6202cc371c32ce0576098;",
    "@1_234567890a8d4840d6202cc371c32ce0576098;",
    "@ 1234567890a8d4840d6202cc371c32ce0576098;",
    "@0123456789ab8d4840d6202cc371c32ce0576098", f"  *{DF11_HEX}  "])
def test_avr_to_hex_matches_reference(rec):
    got, want = _both("avr_to_hex", rec)
    assert got == want


def test_gps_counter_helpers_match_reference():
    from airmodes.outputs.beast import gps_counter
    day = 1_700_006_400.0 - (1_700_006_400.0 % 86400.0)
    for ts, now in ((1_700_000_000.123456789, 1_700_000_000.6),
                    (day + 86399.9, day + 86400.1), (day + 0.1, day + 86399.9),
                    (day + 43200.0, day + 43200.0)):
        c = gps_counter(ts)
        assert _both("split_gps_counter", c)[0] == \
            _both("split_gps_counter", c)[1]
        got, want = _both("gps_counter_to_utc_ns", c, now)
        assert got == want
        assert _both("gps_counter_to_utc", c, now)[0] == want * 1e-9
    for bad in ((100_000 << 30) | 5, (100 << 30) | 1_073_000_000):
        assert _both("split_gps_counter", bad) == [None, None]


@pytest.mark.parametrize("url", [
    "beast://rx1:30005", "avr://10.0.0.2:30002", "capture.c64",
    "beast://noport", "beast://[2001:db8::1]:30005", "beast://::1",
    "beastgps://h:30005", "beast://rx30005", "beast://:1", "avr://h:x"])
def test_parse_net_url_matches_reference(url):
    got, want = _both("parse_net_url", url)
    assert got == want


def test_client_for_url_matches_reference():
    cb = (lambda w: None)
    for url in ("beastgps://h:30005", "beast://h:30005", "avr://h:1",
                "capture.c64"):
        got, want = _both("client_for_url", url, cb)
        if want is None:
            assert got is None
            continue
        assert (got.host, got.port, got.fmt, got.timestamps) == \
            (want.host, want.port, want.fmt, want.timestamps)
    with pytest.raises(ValueError):
        nc.net_client("h", 1, cb, fmt="bogus")
    assert nc.net_client("h", 1, cb, fmt="beastgps").fmt == "beast"


def test_frame_deduper_matches_reference():
    rng = random.Random(5)
    a, b = nc.frame_deduper(0.5, max_entries=50), \
        ref_nc.frame_deduper(0.5, max_entries=50)
    now = 100.0
    for _ in range(2000):
        now += rng.random() * 0.01
        h = f"{rng.randrange(120):06x}"
        assert a.accept(h, now=now) == b.accept(h, now=now)
    assert a._last == b._last
    d = nc.frame_deduper(window_s=300.0, max_entries=100)
    for i in range(500):
        d.accept(f"{i:06x}", now=1000.0 + i * 0.01)
    assert len(d._last) <= 101
    assert not d.accept(f"{499:06x}", now=1005.0)


# --- the live client's timestamps, clock held by the test --------------------

def _clients(monkeypatch, clock, **kw):
    out = []
    for mod in (nc, ref_nc):
        monkeypatch.setattr(mod.time, "time", lambda: clock[0])
        got, reanchors = [], []
        c = mod.net_client("h", 1, got.append, fmt="beast", **kw)
        c.on_reanchor = (lambda r=reanchors: r.append(1))
        out.append((c, got, reanchors))
    return out


def test_mlat_counter_unwrap_matches_reference(monkeypatch):
    """A 12 MHz counter through the 2^47 half-range point and the 2^48
    wrap, then a 50 ppm fast day, then a true restart: the same wire
    strings and re-anchors as the reference (and none before the
    restart)."""
    clock = [1000.0]
    pair = _clients(monkeypatch, clock, timestamps="mlat")
    day = nc.MLAT_HZ * 86400
    start = (1 << 48) - day
    events = [(1000.0, start)]
    for d in range(1, 16):
        events.append((1000.0 + 86400.0 * d,
                       (start + day * d) & ((1 << 48) - 1)))
    t_last = events[-1][0] + 86400.0
    events.append((t_last, (events[-1][1] + int(day * (1 + 50e-6)))
                   & ((1 << 48) - 1)))
    events.append((t_last, 1000))
    for t, ctr in events:
        clock[0] = t
        for c, _, _ in pair:
            c._emit("8d" + "0" * 26, 100, ctr)     # parity fails: dropped
            c._emit(DF17_HEX, 0x40, ctr)
    (a, got, ra), (b, want, rb) = pair
    assert got == want and len(got) == len(events)
    assert (a.n_frames, a.n_dropped) == (b.n_frames, b.n_dropped)
    assert ra == rb == [1]


def test_gps_mode_matches_reference(monkeypatch):
    """timestamps='gps': counter-less records and counters outside the GPS
    layout drop and count; a good counter maps to UTC ns."""
    clock = [1_700_000_000.5]
    pair = _clients(monkeypatch, clock, timestamps="gps")
    for c, _, _ in pair:
        c._emit(DF17_HEX, 0x40, None)
        c._emit(DF17_HEX, 0x40, (100_000 << 30) | 5)
        c._emit(DF17_HEX, 0x40, (100 << 30) | 1_073_000_000)
        c._emit(DF17_HEX, 0x40, (43200 << 30) | 500)
        c._emit(f"{DF17 ^ 1:028x}", 0x40, (43200 << 30) | 501)
    (a, got, _), (b, want, _) = pair
    assert got == want and len(got) == 1 and len(got[0].split()) == 7
    assert (a.n_frames, a.n_dropped) == (b.n_frames, b.n_dropped) == (1, 4)


# --- recorded replay ---------------------------------------------------------

def _replay(path, **kw):
    return _both("replay_file", str(path), **kw)


def _lists(pair):
    return [list(x) if not isinstance(x, tuple) else x for x in pair]


def test_replay_files_match_reference(tmp_path):
    """Beast (classic counter, a counter reset mid-recording), Beast GPS
    (1 s spacing, midnight, a 13 h gap and several days) and AVR records:
    the same (wire, offset) pairs as the reference."""
    day = 1_700_006_400.0 - (1_700_006_400.0 % 86400.0)
    frames = [encoder.df17_frame(0x400000 + k,
                                 encoder.me_identification(f"R{k}"))
              for k in range(4)]
    files = {
        "classic.beast": (b"".join(beast_encode(h, -15.0, 100.0 + i * 0.25)
                                   for i, h in enumerate([DF17_HEX, DF4_HEX,
                                                          DF11_HEX])), {}),
        "reset.beast": (b"".join(beast_encode(f"{frames[k]:028x}", -20.0, t)
                                 for k, t in enumerate([1.0, 2.0, 5e-5,
                                                        1.00005])),
                        {"fmt": "beast"}),
        "gps.beast": (b"".join(
            beast_encode(DF17_HEX, -15.0, t, gps_time=True)
            for t in (day + 23 * 3600.0, day + 23 * 3600.0 + 10.0,
                      day + 86399.5, day + 86400.5,
                      day + 86400.0 + 12 * 3600.0,
                      day + 2 * 86400.0 + 3600.0)),
            {"fmt": "beast", "gps_time": True}),
        "rec.avr": (f"*{DF17_HEX};\n@{24_000_000:012x}{DF4_HEX};\njunk;\n"
                    .encode(), {"fmt": "avr"}),
    }
    for name, (blob, kw) in files.items():
        p = tmp_path / name
        p.write_bytes(blob)
        for epoch in (5000.0, 1.7e9):
            got, want = _lists(_replay(p, epoch=epoch, **kw))
            assert got == want and got, name
    offs = [o for _, o in nc.replay_file(str(tmp_path / "gps.beast"),
                                         fmt="beast", gps_time=True,
                                         epoch=0.0)]
    assert offs == sorted(offs)


def test_replay_streams_a_large_file(tmp_path):
    """More than one read chunk (1 MiB) of AVR records replays whole."""
    p = tmp_path / "big.avr"
    rec = f"*{DF17_HEX};\n".encode()
    p.write_bytes(rec * ((3 << 20) // len(rec) + 1))
    got, want = _lists(_replay(p, fmt="avr", epoch=1.0))
    assert got == want and len(got) == (3 << 20) // len(rec) + 1


# --- one local socket client -------------------------------------------------

def test_beast_server_to_client_roundtrip():
    """The port's output_beast server -> the port's net_client over
    loopback TCP: every frame arrives, validated and re-emitted."""
    from airmodes_torch.crc import crc24
    from airmodes_torch.outputs.beast import output_beast
    srv = output_beast(port=0, host="127.0.0.1")
    got, done = [], threading.Event()

    def cb(w):
        got.append(w)
        if len({x.split()[1] for x in got}) >= 3:
            done.set()

    cli = nc.net_client("127.0.0.1", srv.port, cb, fmt="beast").start()
    msgs = [f"{f >> (n - 5)} {f:0{n // 4}x} {crc24(f, n):06x} 0 -20.00 "
            f"1700000000.000000000"
            for f, n in ((DF17, 112), (int(DF4_HEX, 16), 56), (DF11, 56))]
    deadline = time.time() + 10
    while time.time() < deadline and not done.is_set():
        for m in msgs:                # resend until the client connects
            srv.output(m)
        done.wait(0.1)
    cli.close()
    srv.close()
    assert done.is_set(), f"only {len(got)} frames arrived"
    assert {w.split()[1] for w in got} == {DF17_HEX, DF4_HEX, DF11_HEX}
    assert cli.n_frames >= 3 and cli.n_dropped == 0


def test_net_client_reconnects_and_close_before_start():
    lsock = socket.socket()
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    port = lsock.getsockname()[1]
    got, done = [], threading.Event()
    cli = nc.net_client("127.0.0.1", port,
                        lambda w: (got.append(w), done.set()), fmt="avr",
                        reconnect_s=0.1).start()
    lsock.settimeout(10)
    c1, _ = lsock.accept()
    c1.close()
    c2, _ = lsock.accept()
    c2.sendall(f"*{DF17_HEX};\nnot a record;\n".encode())
    assert done.wait(10)
    c2.close()
    cli.close()
    lsock.close()
    assert got[0].split()[1] == DF17_HEX
    nc.net_client("127.0.0.1", 1, lambda m: None).close()


# --- relay and profiling -----------------------------------------------------

def test_local_pubsub_matches_reference():
    from airmodes.io.relay import local_pubsub as ref_bus
    from airmodes_torch.io.relay import local_pubsub
    logs = []
    for cls in (local_pubsub, ref_bus):
        bus, log = cls(), []
        cb = log.append
        bus.subscribe("a", cb)
        bus.subscribe("a", lambda m: 1 / 0)        # dropped, not fatal
        bus.subscribe("b", lambda m: log.append("b:" + m))
        bus.publish("a", "1")
        bus.publish("b", "2")
        bus.unsubscribe("a", cb)
        bus.unsubscribe("a", cb)
        bus.publish("a", "3")
        bus.publish("c", "4")
        bus.close()
        logs.append(log)
    assert logs[0] == logs[1] == ["1", "b:2"]


def _zmq_pair(relay):
    """A PUB-only and a SUB-bridged interface of `relay` over loopback."""
    import zmq
    pub = relay.zmq_pubsub_iface(pubaddr="tcp://127.0.0.1:*")
    addr = pub._pub.getsockopt(zmq.LAST_ENDPOINT).decode()
    return pub, relay.zmq_pubsub_iface(subaddr=addr)


def _until(cond, act, timeout=5.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        act()
        time.sleep(0.05)
    return cond()


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_zmq_relay_roundtrip_and_unsubscribe(pkg):
    """Twin of the reference's zmq relay tests, run on both packages'
    bridges: a message crosses PUB -> SUB; unsubscribe() releases the
    publisher-side filter and re-subscribing restores delivery; a
    PUB-only interface still feeds its local subscribers; publishes after
    close drop."""
    import airmodes.io.relay as ref_relay
    import airmodes_torch.io.relay as relay
    mod = relay if pkg == "port" else ref_relay
    assert relay.HAVE_ZMQ == ref_relay.HAVE_ZMQ
    if not relay.HAVE_ZMQ:
        pytest.skip("pyzmq is not installed")
    pub, sub = _zmq_pair(mod)
    try:
        got = []
        cb = got.append
        sub.subscribe("dl_data", cb)
        assert _until(lambda: got, lambda: pub.publish("dl_data", DF17_HEX))
        assert got[0] == DF17_HEX
        sub.unsubscribe("dl_data", cb)
        time.sleep(0.3)                  # the bridge applies UNSUBSCRIBE
        n = len(got)
        for _ in range(5):
            pub.publish("dl_data", "gone")
            time.sleep(0.05)
        assert len(got) == n
        sub.subscribe("dl_data", cb)
        assert _until(lambda: len(got) > n,
                      lambda: pub.publish("dl_data", "back"))
        assert got[-1] == "back"
    finally:
        sub.close()
        pub.close()
    only = mod.zmq_pubsub_iface(pubaddr="tcp://127.0.0.1:*")
    local = []
    only.subscribe("dl_data", local.append)
    only.publish("dl_data", "hello")
    only.close()
    only.publish("dl_data", "after close")
    assert local == ["hello"]


def test_zmq_relay_crosses_packages():
    """The port's PUB feeds the reference's SUB and back: one wire
    format."""
    import airmodes.io.relay as ref_relay
    import airmodes_torch.io.relay as relay
    if not relay.HAVE_ZMQ:
        pytest.skip("pyzmq is not installed")
    import zmq
    for a, b in ((relay, ref_relay), (ref_relay, relay)):
        pub = a.zmq_pubsub_iface(pubaddr="tcp://127.0.0.1:*")
        addr = pub._pub.getsockopt(zmq.LAST_ENDPOINT).decode()
        sub = b.zmq_pubsub_iface(subaddr=addr)
        got = []
        sub.subscribe("dl_data", got.append)
        try:
            assert _until(lambda: got,
                          lambda: pub.publish("dl_data", DF17_HEX))
            assert got[0] == DF17_HEX
        finally:
            sub.close()
            pub.close()


def test_rate_meter_and_trace(tmp_path):
    from airmodes_torch.utils.profiling import RateMeter, trace
    m = RateMeter()
    m.add(1000)
    m.add(3000)
    iv = m.interval()
    assert iv["blocks"] == 2 and iv["msps"] > 0 and iv["avg_msps"] > 0
    with trace(None):
        pass
    with trace(str(tmp_path / "t")):
        sum(range(1000))
    assert list((tmp_path / "t").glob("trace_*.json"))


# --- the CLI's network modes, against the reference --------------------------

CLOCK = types.SimpleNamespace(time=lambda: 1.7e9, sleep=time.sleep)


def _cli(monkeypatch, argv, which=("port", "ref")):
    import airmodes.apps.modes_rx as ref_rx
    import airmodes_torch.apps.modes_rx as rx
    out = {}
    for name, mod in (("port", rx), ("ref", ref_rx)):
        if name not in which:
            continue
        monkeypatch.setattr(mod, "time", CLOCK)
        o, e = io.StringIO(), io.StringIO()
        with redirect_stdout(o), redirect_stderr(e):
            rc = mod.main(list(argv))
        out[name] = (rc, o.getvalue().splitlines(), e.getvalue())
    return out


def test_modes_rx_frame_replay_cli(tmp_path, monkeypatch):
    import sqlite3
    rec = tmp_path / "rec.beast"
    rec.write_bytes(beast_encode(DF17_HEX, -15.0, 1.0) * 2 +
                    beast_encode(DF4_HEX, -15.0, 2.0))
    rows = {}
    for name in ("port", "ref"):
        db = tmp_path / f"{name}.db"
        got = _cli(monkeypatch, ["-s", str(rec), "--file-format", "beast",
                                 "-d", str(db), "--stats-interval", "0"],
                   (name,))[name]
        assert got[0] == 0
        # replay stamps frames from its own wall-clock epoch: compare the
        # console lines without their timestamps
        rows[name] = ([ln.rsplit(" [", 1)[0] for ln in got[1]],
                      sqlite3.connect(str(db)).execute(
                          "SELECT icao, ident FROM aircraft").fetchall())
    assert rows["port"] == rows["ref"]
    assert rows["port"][1] == [(ICAO, "KLM1023")]
    out = _cli(monkeypatch, ["-s", "synthetic", "--file-format", "beast",
                             "-n"])
    assert out["port"][0] == out["ref"][0] == 2


@pytest.mark.parametrize("argv", [
    ["-s", "beast://rx30005", "-n"],
    ["-s", "beast://rx:30005", "--file-format", "beast", "-n"],
    ["-s", "beast://rx:30005", "-s", "cap.c64", "-n"]])
def test_modes_rx_rejects_bad_network_use(argv, monkeypatch):
    out = _cli(monkeypatch, argv)
    assert out["port"][0] == out["ref"][0] == 2
    assert out["port"][2] == out["ref"][2]


def test_modes_rx_aggregator_dedups_overlapping_feeds(monkeypatch):
    """Two Beast feeds carrying the same frame: the port's aggregator
    publishes it once per dedup window and stops at --max-messages."""
    from airmodes_torch.crc import crc24
    from airmodes_torch.outputs.beast import output_beast
    srvs = [output_beast(port=0, host="127.0.0.1") for _ in range(2)]
    feeding = threading.Event()
    wire = (f"17 {DF17_HEX} {crc24(DF17, 112):06x} 0 -20.00 "
            f"1700000000.000000000")

    def feeder():
        while not feeding.is_set():
            for s in srvs:
                s.output(wire)
            time.sleep(0.05)

    t = threading.Thread(target=feeder, daemon=True)
    t.start()
    try:
        out = _cli(monkeypatch, [
            "-s", f"beast://127.0.0.1:{srvs[0].port}",
            "-s", f"beast://127.0.0.1:{srvs[1].port}",
            "--max-messages", "3", "--dedup-window", "0.5",
            "--stats-interval", "0"], ("port",))
    finally:
        feeding.set()
        t.join()
        for s in srvs:
            s.close()
    rc, lines, err = out["port"]
    assert rc == 0 and "3 messages from 2 feeds" in err
    assert sum("KLM1023" in ln for ln in lines) == 3
