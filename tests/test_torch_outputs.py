"""The port's output plugins (`airmodes_torch.outputs`) against the
reference's: the same wire messages go through both packages' plugins and
what each writes is compared exactly, as parametrised cases — console
lines, SBS-1 lines, SQLite rows, the KML text, the JSON document, Beast and
raw bytes, FlightGear packets, the azimuth-map and dashboard models, the wx
records and the HTTP server's JSON endpoints.

Servers bind port 0 on 127.0.0.1. A TCP client connects before the
messages go out and reads to the end of stream after the plugin closes;
UDP packets are drained without waiting (loopback delivers them during
the send). Where a plugin reads the wall clock (the SQLite commit batching,
the HTTP server's quiet-gap rebuild), only what does not depend on it is
compared; every other time comes from the messages."""

import json
import os
import socket
import sqlite3
import urllib.request

import pytest

from torch_parity import PORT, REF, T0, both, call, norm, wire
from torch_parity import traffic as _traffic

TRAFFIC = _traffic()


def _restamp(msgs, t0=T0, step=0.2):
    """The messages with fresh, rising timestamps (one clock for a stream
    built from several groups)."""
    out = []
    for i, m in enumerate(msgs):
        p = m.split()
        if len(p) >= 6:
            p[5] = f"{t0 + i * step:.9f}"
        out.append(" ".join(p))
    return out


def _wx_stream():
    """Positions, then Comm-B weather registers (BDS4,4, BDS4,5) and a
    BDS5,0 + BDS6,0 pair, for two aircraft: the wx plugin's inputs."""
    enc = REF.encoder
    from test_commb import mb_bds44, mb_bds45, mb_bds50, mb_bds60
    from airmodes.decode.altitude import encode_alt_q
    frames = []
    for icao, (la, lo) in ((0x4840D6, (47.3, 8.2)), (0x3C6586, (47.6, 8.9))):
        for odd in (False, True):
            frames.append((enc.df17_frame(icao, enc.me_airborne_position(
                33000.0, la, lo, odd=odd)), 112))
        ac = encode_alt_q(33000.0)
        for mb in (mb_bds50(roll_raw=5, trk_raw=300, gs_raw=240, tr_raw=0,
                            tas_raw=230),
                   mb_bds60(hdg_raw=150, ias=280, mach_raw=200, vrb_raw=0,
                            vri_raw=0),
                   mb_bds44(wind=(85, 270.0), temp_c=-52.25, press=1005,
                            turb=1, hum=32),
                   mb_bds45(hazards={"turb": 2, "ice": 1}, temp_c=-51.25,
                            press=220, rh_ft=2400)):
            frames.append((enc.df20_frame(icao, ac, mb=mb), 112))
    return [wire(f, n, T0 + 100.0 + 0.5 * i) for i, (f, n) in
            enumerate(frames)]


STREAM = _restamp([m for g in sorted(TRAFFIC) for m in TRAFFIC[g]]) \
    + _wx_stream()
GROUPS = sorted(TRAFFIC)


def _group_stream(group):
    return _restamp(TRAFFIC[group]) if group != "all" else STREAM


# --- console, SBS-1 ----------------------------------------------------------

@pytest.mark.parametrize("group", GROUPS + ["all"])
def test_msprint_lines_match_reference(group):
    msgs = _group_stream(group)

    def run(ns):
        lines = []
        plug = ns.outputs.output_print(my_position=(47.0, 8.0),
                                       callback=lines.append)
        for m in msgs:
            plug.output(m)
        return lines

    want, got = both(run)
    assert got == want
    if group != "malformed":
        assert want


def test_sbs1_lines_match_reference():
    def run(ns):
        p = ns.decode.parse.parse(my_position=(47.0, 8.0))
        out = []
        for m in STREAM:
            try:
                rep = p.parse(m)
            except ns.exceptions.ADSBError:
                continue
            out.append(call(ns.outputs.format_sbs1, rep))
        out.append(call(ns.outputs.sbs1.sbs_position_line, 0x4840D6, T0,
                        30000, 47.3, 8.2))
        out.append(call(ns.outputs.sbs1.sbs_position_line, None, 1e300,
                        None, 47.3, 8.2))
        return out

    want, got = both(run)
    assert got == want
    assert sum(1 for x in want if isinstance(x, str)) > 300


def _tcp_capture(make_plugin, msgs):
    """Bytes a TCP broadcast plugin sends to one client, read to EOF."""
    plug = make_plugin()
    cli = socket.create_connection(("127.0.0.1", plug.port), timeout=10)
    try:
        for m in msgs:
            plug.output(m)
        plug.close()
        cli.settimeout(10)
        data = b""
        while True:
            chunk = cli.recv(1 << 16)
            if not chunk:
                return data
            data += chunk
    finally:
        cli.close()


@pytest.mark.parametrize("plugin", ["sbs1", "raw_avr", "raw_wire", "beast",
                                    "beast_gps"])
def test_tcp_plugins_bytes_match_reference(plugin):
    msgs = STREAM + [m + " 1700000123456789012" for m in STREAM[:40]] \
        + ["17 8d4840d6202cc371c32ce0576098 000000 0 nan 1.0",
           "17 8d4840d6202cc371c32ce0576098 000000 0 -3.0 1e300", "short"]

    def run(ns):
        O = ns.outputs

        def make():
            if plugin == "sbs1":
                return O.output_sbs1(port=0, host="127.0.0.1")
            if plugin.startswith("raw"):
                return O.output_raw(port=0, host="127.0.0.1",
                                    avr_format=plugin == "raw_avr")
            return O.beast.output_beast(port=0, host="127.0.0.1",
                                        gps_time=plugin == "beast_gps")
        return _tcp_capture(make, msgs)

    want, got = both(run)
    assert got == want
    assert len(want) > 1000


def test_beast_helpers_match_reference():
    stamps = [0.0, 1.5, T0 + 0.123456789, 86399.9999999999, -5.0]

    def run(ns):
        B = ns.outputs.beast
        return ([B.signal_byte(x) for x in (-200.0, -96.0, -20.0, -0.1, 0.0,
                                             3.0, 1e30, -1e30)]
                + [B.signal_dbfs(b) for b in range(256)]
                + [B.gps_counter(t) for t in stamps]
                + [B.gps_counter_ns(n) for n in (0, 1_700_000_000_123_456_789,
                                                 86_399_999_999_999)]
                + [call(B.beast_encode, h, d, t, gps_time=g, timestamp_ns=n)
                   for h in ("8d4840d6202cc371c32ce0576098", "5d4840d61a1a1a",
                             "1a", "zz4840d6202cc3")
                   for d, t in ((-20.0, T0), (-3.0, 0.5), (float("nan"), 1.0),
                                (-20.0, 1e13))
                   for g in (False, True)
                   for n in (None, 1_700_000_000_123_456_789)])

    want, got = both(run)
    assert got == want


# --- SQLite and KML -----------------------------------------------------------

_TABLES = ("aircraft", "positions", "vectors", "squawks", "track")


def _sql_rows(db):
    con = sqlite3.connect(db)
    try:
        return {t: con.execute(f"SELECT * FROM {t} ORDER BY rowid").fetchall()
                for t in _TABLES}
    finally:
        con.close()


def _sql_run(ns, tmp, msgs, **kw):
    db = os.path.join(tmp, f"{ns.name}.db")
    plug = ns.outputs.output_sql(
        db, parser=ns.decode.parse.parse(my_position=(47.0, 8.0)), **kw)
    for m in msgs:
        plug.output(m)
    plug.close()
    return db


@pytest.mark.parametrize("opts", [{}, dict(track_keep_s=5.0)],
                         ids=["default", "short_track"])
def test_sql_rows_match_reference(tmp_path, opts):
    want, got = both(lambda ns: _sql_rows(_sql_run(ns, str(tmp_path),
                                                   STREAM, **opts)))
    assert got == want
    assert want["aircraft"] and want["positions"] and want["track"]


def test_sql_insert_merges_like_reference(tmp_path):
    def run(ns):
        db = os.path.join(str(tmp_path), f"m-{ns.name}.db")
        out = ns.outputs.output_sql(db)
        R = ns.decode.parse.AircraftReport
        base = dict(df=17, icao=0xAAA, ref_dbfs=-20.0, raw_hex="")
        out.insert(R(timestamp=1.0, speed_kt=410.0, heading_deg=95.0, **base))
        out.insert(R(timestamp=2.0, vertical_rate_fpm=-640.0, **base))
        out.insert(R(timestamp=3.0, altitude_ft=9000, altitude_gnss=True,
                     lat=47.0, lon=8.0, **base))
        out.insert(R(timestamp=4.0, squawk=7700, callsign="SQL1", **base))
        out.insert(R(df=11, icao=None, timestamp=5.0, ref_dbfs=-20.0,
                     raw_hex=""))
        out.flush()
        out.close()
        return _sql_rows(db)

    want, got = both(run)
    assert got == want


def test_kml_matches_reference(tmp_path):
    def run(ns):
        tmp = str(tmp_path)
        db = _sql_run(ns, tmp, STREAM)
        kml = os.path.join(tmp, f"{ns.name}.kml")
        k = ns.outputs.output_kml(kml, db, (47.0, 8.0), interval=3600)
        k.write_once()
        k.close()
        with open(kml) as f:
            text = f.read()
        return [ns.outputs.render_kml(db, localpos=(47.0, 8.0)),
                ns.outputs.render_kml(db), text]

    want, got = both(run)
    assert got == want
    assert "<LineString>" in want[0] and "KLM1023" in want[0]


# --- JSON, dashboard, azimuth map, wx -----------------------------------------

def test_json_document_matches_reference(tmp_path):
    def run(ns):
        path = os.path.join(str(tmp_path), f"{ns.name}.json")
        out = ns.outputs.json_out.output_json(path, interval_s=5.0,
                                              stale_s=30.0)
        docs = []
        for i, m in enumerate(STREAM):
            out.output(m)
            if i % 97 == 0 and os.path.exists(path):
                with open(path) as f:
                    docs.append(json.load(f))
        out.close()
        with open(path) as f:
            docs.append(json.load(f))
        return docs, out.n_writes

    want, got = both(run)
    assert got == want
    assert want[0][-1]["aircraft"]


def test_dashboard_and_az_map_match_reference():
    def run(ns):
        O = ns.outputs
        dash = O.output_dashboard(parser=ns.decode.parse.parse(
            my_position=(47.0, 8.0)))
        azm = O.output_az_map(my_position=(47.0, 8.0))
        snaps = []
        for i, m in enumerate(STREAM):
            dash.output(m)
            azm.output(m)
            if i % 101 == 0:
                snaps.append(dash.model.rows())
        model = dash.model
        out = [snaps, model.rows(), model.latest, model.n_gated,
               {k: v for k, v in sorted(model.aircraft.items())},
               azm.model.envelope(), azm.model.max_range(),
               [azm.model.polygon(r) for r in range(azm.model.n_alt_rings)],
               O.az_map.render_ascii(azm.model),
               O.az_map.render_ascii(azm.model, width=31)]
        model.prune(now=T0 + 120.0)
        out.append(sorted(model.aircraft))
        model.prune()
        out.append(sorted(model.aircraft))
        m = O.az_map_model()
        m.add(10.0, 30.0, alt_ft=1000.0)
        m.add(10.0, 120.0, alt_ft=36000.0)
        m.add(359.9, 250.0, alt_ft=None)
        out += [m.envelope(), m.max_range(), O.az_map.render_ascii(m)]
        return out

    want, got = both(run)
    assert got == want
    assert want[1] and want[6] > 0


def test_wx_records_match_reference(tmp_path):
    def run(ns):
        path = os.path.join(str(tmp_path), f"{ns.name}.jsonl")
        out = ns.outputs.wx.output_wx(path, declination_deg=2.5)
        for m in STREAM:
            out.output(m)
        out.close()
        W = ns.outputs.wx
        with open(path) as f:
            recs = [json.loads(ln) for ln in f]
        return (recs, out.n_obs,
                [W.derive_wind(t, 450.0, t + 7.0, 440.0)
                 for t in (0.0, 90.0, 271.0)],
                [call(W.derive_sat, tas, mach) for tas, mach in
                 ((450.0, 0.78), (0.0, 0.5), (300.0, 0.0))])

    want, got = both(run)
    assert got == want
    assert any(r.get("derived") for r in want[0])
    assert any("temperature_c" in r for r in want[0])


# --- FlightGear and quaternions -----------------------------------------------

def test_flightgear_packets_match_reference():
    def run(ns):
        rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rx.bind(("127.0.0.1", 0))
        rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
        plug = ns.outputs.output_flightgear("127.0.0.1",
                                            rx.getsockname()[1])
        pkts = []
        rx.setblocking(False)
        for m in STREAM:
            plug.output(m)
            while True:
                try:
                    pkts.append(rx.recv(1 << 16))
                except BlockingIOError:
                    break
        plug.close()
        rx.close()
        F = ns.outputs.flightgear
        return (pkts,
                [F.pack_fg_position("KLM1023", 47.3, 8.2, 30000.0, 45.0,
                                    250.0, sim_time=t) for t in (0.0, T0)],
                [F.llh2ecef(la, lo, al) for la, lo, al in
                 ((0.0, 0.0, 0.0), (47.3, 8.2, 9144.0), (-89.0, 179.0, 1.0))])

    want, got = both(run)
    assert got == want
    assert len(want[0]) > 20 and any(b"KLM1023" in p[:32] for p in want[0])


def test_quaternion_matches_reference():
    pts = [(la, lo, h) for la in (-80.0, -10.0, 0.0, 47.3)
           for lo in (-170.0, 0.0, 8.2) for h in (0.0, 91.0, 270.0)]

    def run(ns):
        Q = ns.outputs.quaternion
        return ([Q.from_lat_lon(la, lo) for la, lo, _ in pts]
                + [Q.ecef_orientation(la, lo, h) for la, lo, h in pts]
                + [Q.to_angle_axis(Q.ecef_orientation(la, lo, h))
                   for la, lo, h in pts]
                + [Q.from_euler(0.1, -0.2, 0.3),
                   Q.multiply(Q.from_axis_angle((0.0, 0.0, 1.0), 0.5),
                              Q.from_axis_angle((1.0, 0.0, 0.0), -1.0)),
                   Q.to_angle_axis((1.0, 0.0, 0.0, 0.0))])

    want, got = both(run)
    assert got == want


# --- the HTTP server ------------------------------------------------------------

def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, None, b""


def _strip_wall(doc):
    """aircraft.json less the fields a quiet-gap rebuild extrapolates from
    the wall clock ('now' and each aircraft's 'seen')."""
    return [{k: v for k, v in ac.items() if k != "seen"}
            for ac in doc["aircraft"]]


@pytest.mark.parametrize("position", [None, (47.0, 8.0)],
                         ids=["no_position", "receiver_position"])
def test_httpd_endpoints_match_reference(position):
    from airmodes.dsp.host import BlockStats as JaxStats
    from airmodes_torch.dsp.host import BlockStats

    def run(ns):
        stats = (JaxStats if ns is REF else BlockStats)(
            preambles=10, crc_ok=7, corrected=2, crc_fail=1, emitted=9)
        plug = ns.outputs.httpd.output_http(port=0, host="127.0.0.1",
                                            my_position=position,
                                            block_stats=stats)
        try:
            for m in STREAM:
                plug.output(m)
            out = {}
            for path in ("/data/receiver.json", "/data/stats.json",
                         "/data/coverage.json"):
                code, ctype, body = _get(plug.port, path)
                out[path] = (code, ctype, json.loads(body))
            code, ctype, body = _get(plug.port, "/data/aircraft.json")
            out["aircraft"] = (code, ctype, _strip_wall(json.loads(body)))
            out["page"] = _get(plug.port, "/")
            out["missing"] = _get(plug.port, "/nope")
            out["stats_doc"] = plug.stats_doc()
            return out
        finally:
            plug.close()

    want, got = both(run)
    assert got == want
    assert want["aircraft"][2] and want["/data/stats.json"][2]["messages"]
    assert want["missing"][0] == 404


def test_every_reference_plugin_has_a_counterpart():
    import inspect
    for mod in ("az_map", "beast", "flightgear", "gui_model", "httpd",
                "json_out", "kml", "msprint", "quaternion", "raw_server",
                "sbs1", "sql", "tcpserver", "wx"):
        ref = getattr(REF.outputs, mod) if hasattr(REF.outputs, mod) else \
            __import__(f"airmodes.outputs.{mod}", fromlist=["x"])
        port = __import__(f"airmodes_torch.outputs.{mod}", fromlist=["x"])
        names = {n for n, v in inspect.getmembers(ref)
                 if (inspect.isfunction(v) or inspect.isclass(v))
                 and v.__module__ == ref.__name__}
        assert names and all(hasattr(port, n) for n in names), mod
    assert sorted(REF.outputs.__all__) == sorted(PORT.outputs.__all__)
    assert norm(sorted(dir(REF.outputs))) == norm(sorted(dir(PORT.outputs)))
