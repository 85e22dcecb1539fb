"""The port's decode layer (`airmodes_torch.decode`, `exceptions`, `crc`'s
numpy helpers, `config`, the encoder) against the reference's: the same
inputs go through both packages and the results are compared exactly, as
parametrised cases. The one exception is the least-squares positions that
`decode.mlat` and `decode.mlat_net` solve, compared with rtol 1e-9 (the
reference's own tests hold them to 1e-3 degrees and tens of metres).

Vector cases follow tests/test_fields.py, test_altitude.py, test_cpr.py,
test_commb.py, test_elm.py, test_mlat.py, test_mlat_net.py and
test_parse.py. No case reads the wall clock: every CPR decode gets its
timestamp, every maintain() and flush() its `now`."""

import dataclasses
import math

import numpy as np
import pytest

from torch_parity import PORT, REF, T0, both, call, commb_payloads, norm
from torch_parity import traffic as _traffic

TRAFFIC = _traffic()


def _close(a, b, rtol):
    """Equal structures whose floats agree within rtol."""
    if isinstance(a, float) and isinstance(b, float):
        return math.isclose(a, b, rel_tol=rtol, abs_tol=0.0) or a == b
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k], rtol)
                                            for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y, rtol)
                                        for x, y in zip(a, b))
    return a == b


# --- parse: every DF and ME type the encoder makes --------------------------

@pytest.mark.parametrize("group", sorted(TRAFFIC))
@pytest.mark.parametrize("my_position", [None, (47.0, 8.0)],
                         ids=["no_position", "receiver_position"])
def test_parse_reports_match_reference(group, my_position):
    """One parser per package over the group's stream: the same report
    (`dataclasses.asdict`, every field) or the same error for every
    message, in order, CPR and ELM state included."""
    msgs = TRAFFIC[group]

    def run(ns):
        p = ns.decode.parse.parse(my_position=my_position)
        return [call(p.parse, m) for m in msgs]

    want, got = both(run)
    assert got == want
    decoded = [r for r in got if r[0] == "AircraftReport"]
    if group != "malformed":
        assert decoded, "no message of the group decoded"
    for r, m in zip(got, msgs):
        if r[0] == "AircraftReport":
            rep = REF.decode.parse.AircraftReport(**r[1])
            assert norm(dataclasses.asdict(rep)) == r[1], m


def test_parse_global_first_matches_reference():
    msgs = TRAFFIC["airborne_position"] + TRAFFIC["surface_position"]

    def run(ns):
        p = ns.decode.parse.parse(my_position=(47.0, 8.0),
                                  cpr_global_first=True)
        return [call(p.parse, m) for m in msgs]

    want, got = both(run)
    assert got == want


def test_parse_decodes_the_truth():
    """The comparison above is not vacuous: the port's reports carry the
    encoded callsign, position and squawk."""
    p = PORT.decode.parse.parse()
    reps = []
    for m in TRAFFIC["identification"] + TRAFFIC["airborne_position"]:
        try:
            reps.append(p.parse(m))
        except PORT.exceptions.ADSBError:
            pass
    assert reps[0].callsign == "KLM1023" and reps[0].icao == 0x4840D6
    fix = [r for r in reps if r.icao == 0x4840D6 and r.lat is not None]
    assert fix and abs(fix[0].lat - 47.3) < 0.02


# --- the encoder -------------------------------------------------------------

ENCODER_CASES = [
    ("df17_frame", (0x4840D6, 0x202CC371C32CE0), {}),
    ("df18_frame", (0x4840D6, 0x202CC371C32CE0), dict(cf=5)),
    ("df11_frame", (0xABCDEF,), dict(ca=4, interrogator=7)),
    ("df4_frame", (0xABCDEF, 0x1234), dict(fs=3, dr=5, um=9)),
    ("df5_frame", (0xABCDEF, 0x0F0F), dict(fs=1)),
    ("df0_frame", (0xABCDEF, 0x1234), dict(vs=1, ri=3)),
    ("df16_frame", (0xABCDEF, 0x1234), dict(mv=0x30 << 48)),
    ("df20_frame", (0xABCDEF, 0x1234), dict(mb=0x20 << 48, fs=2)),
    ("df21_frame", (0xABCDEF, 0x0F0F), dict(mb=123456789)),
    ("df24_frame", (0xABCDEF, 3, 1 << 79), dict(ke=1)),
    ("df24_segments", (0xABCDEF, bytes(range(37))), {}),
    ("df24_segments", (0xABCDEF, b""), {}),
    ("me_identification", ("KLM1023",), dict(tc=2, cat=3)),
    ("me_airborne_position", (35000.0, 47.3, 8.2), dict(odd=True, tc=12)),
    ("me_airborne_position", (None, -33.9, 151.2), dict(odd=False)),
    ("me_surface_position", (47.45, 8.56), dict(odd=True, mov=40,
                                                track_deg=271.0)),
    ("me_velocity", (1200.0, 181.0, -6400.0), dict(supersonic=True)),
    ("me_emergency_status", (5,), dict(squawk=7500)),
    ("me_ra_broadcast", (0x3FFF,), dict(rac=5, rat=1, mte=1, tti=2,
                                         tid=0x123)),
    ("me_target_state", (), dict(sel_alt_ft=36000, fms=True, baro_mb=1013.6,
                                 sel_hdg_deg=270.0, nacp=9, sil=3,
                                 nic_baro=1, modes={"vnav": True})),
    ("me_op_status", (), dict(surface=True, lw=5, trk_hdg=1, hrd=1)),
    ("me_op_status", (), dict(version=1, cc=0x8000, om=0x2000)),
    ("frame_to_chips", (0x8D4840D6202CC371C32CE0576098, 112), {}),
    ("frame_icao", (0x8D4840D6202CC371C32CE0576098, 112), {}),
    ("random_mixed_frames", (40,), dict(seed=3)),
    ("random_df17_frames", (20,), dict(seed=4)),
]


@pytest.mark.parametrize("name,args,kwargs", ENCODER_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(ENCODER_CASES)])
def test_encoder_matches_reference(name, args, kwargs):
    want, got = both(lambda ns: call(getattr(ns.encoder, name), *args,
                                     **kwargs))
    assert got == want


def test_encoder_capture_matches_reference():
    frames = REF.encoder.random_mixed_frames(12, seed=8)

    def run(ns):
        iq, truth = ns.encoder.make_capture(frames, snr_db=18.0,
                                            spacing=3000, seed=8,
                                            jitter=40)
        return iq, truth

    want, got = both(run)
    assert got == want


# --- fields ------------------------------------------------------------------

def test_fields_modes_reply_every_layout():
    rng = np.random.default_rng(11)
    cases = []
    for dfnum, layout in sorted(REF.decode.fields.MODES_LAYOUTS.items()):
        nbits = sum(w for _, w in layout)
        for _ in range(8):
            data = (dfnum << (nbits - 5)) | int(
                rng.integers(0, 1 << 52)) << (nbits - 57) \
                if nbits == 112 else (dfnum << 51) | int(
                    rng.integers(0, 1 << 51))
            cases.append((data, nbits))
    cases += [(0x8D4840D6202CC371C32CE0576098, 112), (0, 56), (0, 112),
              ((1 << 112) - 1, 112), (5, 57)]

    def run(ns):
        return [call(lambda: _fields_items(
            ns.decode.fields.modes_reply(data, nbits)))
            for data, nbits in cases]

    want, got = both(run)
    assert got == want
    assert sum(isinstance(r, dict) for r in want) >= 8 * 10


def _fields_items(f):
    return {k: f[k] for k in f.fields()}


@pytest.mark.parametrize("case", ["me_reply", "squawk", "callsign",
                                  "data_field"])
def test_fields_vectors_match_reference(case):
    rng = np.random.default_rng(12)
    mes = [(tc << 51) | (sub << 48) | int(rng.integers(0, 1 << 48))
           for tc in range(32) for sub in range(8)]
    idents = [int(v) for v in rng.integers(0, 1 << 48, 500, dtype=np.uint64)]

    def run(ns):
        F = ns.decode.fields
        if case == "me_reply":
            return [call(lambda: _fields_items(F.me_reply(me))) for me in mes]
        if case == "squawk":
            codes = [int(f"{a}{b}{c}{d}") for a in range(8) for b in range(8)
                     for c in range(8) for d in range(8)]
            return ([call(F.encode_squawk, c) for c in codes]
                    + [call(F.decode_squawk, v) for v in range(1 << 13)]
                    + [call(F.encode_squawk, 8888)])
        if case == "callsign":
            return [call(F.decode_callsign, v) for v in idents + [0]]
        f = F.data_field(0xABCD, 16, [("hi", 8), ("lo", 8)])
        return [call(lambda: f["hi"]), call(lambda: f["lo"]),
                call(lambda: f["nope"]), f.fields(),
                call(lambda: F.data_field(0x1, 8, [("a", 16)])["a"]),
                call(lambda: _fields_items(F.data_field(
                    0xF0F0, 16, [("_pad", 4), ("x", 8), ("y", 4)])))]

    want, got = both(run)
    assert got == want


# --- altitude ----------------------------------------------------------------

@pytest.mark.parametrize("case", ["decode13", "decode12", "encode_q",
                                  "encode_12bit", "gillham", "gray",
                                  "gnss12"])
def test_altitude_vectors_match_reference(case):
    def run(ns):
        A = ns.decode.altitude
        if case == "decode13":
            return [call(A.decode_alt, v, True) for v in range(1 << 13)]
        if case == "decode12":
            return [call(A.decode_alt, v, False) for v in range(1 << 12)]
        if case == "encode_q":
            return [call(A.encode_alt_q, a, b13)
                    for a in range(-1100, 51300, 25) for b13 in (True, False)]
        if case == "encode_12bit":
            return [call(A.encode_alt_12bit, a)
                    for a in range(-1100, 51300, 100)]
        if case == "gillham":
            return [call(A.encode_alt_gillham, a)
                    for a in range(-1300, 126800, 100)]
        if case == "gray":
            return [call(A.gray2bin, g) for g in range(1 << 11)]
        return [call(A.decode_alt_gnss12, v) for v in range(1 << 12)]

    want, got = both(run)
    assert got == want


# --- cpr ---------------------------------------------------------------------

def _cpr_encode_grid(ns):
    C = ns.decode.cpr
    rng = np.random.default_rng(0)
    out = []
    for _ in range(300):
        lat = float(rng.uniform(-85, 85))
        lon = float(rng.uniform(-180, 180))
        for surface in (False, True):
            even = C.cpr_encode(lat, lon, odd=False, surface=surface)
            odd = C.cpr_encode(lat, lon, odd=True, surface=surface)
            out.append((even, odd))
            for mro in (False, True):
                out.append(call(C.decode_global, even, odd,
                                most_recent_odd=mro, surface=surface))
            ref = (lat + float(rng.uniform(-0.5, 0.5)),
                   lon + float(rng.uniform(-0.5, 0.5)))
            out.append(call(C.decode_local, odd, True, ref, surface=surface))
    return out


def _cpr_boundary(ns):
    """tests/test_cpr.py: the straddling pair at an NL boundary falls
    back to a local decode on the aircraft's own position."""
    C = ns.decode.cpr
    lo, hi = 10.0, 11.0
    while hi - lo > 1e-9:
        mid = (lo + hi) / 2
        if C.nl(mid) == C.nl(lo):
            lo = mid
        else:
            hi = mid
    b = hi
    dec = C.cpr_decoder(my_location=None)
    out = [b]
    below = b - 0.03
    for args in ((below, 8.0, False, 0.0), (below, 8.0, True, 1.0),
                 (b - 0.001, 8.0, False, 2.0), (b + 0.001, 8.0, True, 2.5)):
        yz, xz = C.cpr_encode(args[0], args[1], odd=args[2], surface=False)
        out.append(call(dec.decode, 0x123456, yz, xz, int(args[2]),
                        timestamp=args[3]))
    return out


def _cpr_decoder_cases(ns):
    """The decoder scenarios of tests/test_cpr.py: cache, range check,
    eviction, southern surface pair, impossible latitude, stale pair,
    cache bound, air/ground transition, global-first."""
    C = ns.decode.cpr
    out = [[C.nl(x) for x in np.linspace(-90, 90, 721)],
           call(C.nl, 87.0), call(C.nl, -87.0),
           call(C.range_bearing, (0.0, 0.0), (1.0, 0.0)),
           call(C.range_bearing, (47.0, 8.0), (-33.9, 151.2)),
           call(C.decode_global, (0, 0), (int(round((2.0 / 3.0) * (1 << 17))),
                                          0), most_recent_odd=True)]
    dec = C.cpr_decoder(my_location=None)
    e = C.cpr_encode(47.5, 8.5, odd=False, surface=False)
    o = C.cpr_encode(47.5, 8.5, odd=True, surface=False)
    e2 = C.cpr_encode(47.51, 8.51, odd=False, surface=False)
    out += [call(dec.decode, 0xABCDEF, *e, 0, timestamp=100.0),
            call(dec.decode, 0xABCDEF, *o, 1, timestamp=101.0),
            call(dec.decode, 0xABCDEF, *e2, 0, timestamp=102.0)]
    dec = C.cpr_decoder(my_location=(0.0, 0.0), max_range_nm=100.0)
    far_e = C.cpr_encode(45.0, 45.0, odd=False, surface=False)
    far_o = C.cpr_encode(45.0, 45.0, odd=True, surface=False)
    dec.lkplist[1] = {0: (*far_e, 100.0, False)}
    out.append(call(dec.decode, 1, *far_o, 1, timestamp=100.5))
    dec = C.cpr_decoder()
    dec.lkplist[1] = {0: (1, 2, 100.0, False)}
    dec.poslist[1] = (1.0, 2.0, 100.0)
    dec.maintain(now=220.0)
    out.append((dict(dec.lkplist), dict(dec.poslist)))
    truth = (-33.95, 151.18)
    dec = C.cpr_decoder(my_location=(-33.94, 151.17))
    s0 = C.cpr_encode(*truth, odd=False, surface=True)
    s1 = C.cpr_encode(*truth, odd=True, surface=True)
    out += [call(C.cpr_decoder(my_location=None).decode, 0x123456, *s0, 0,
                 surface=True, timestamp=0.0),
            call(dec.decode, 0x123456, *s0, 0, surface=True, timestamp=0.0),
            call(dec.decode, 0x123456, *s1, 1, surface=True, timestamp=1.0)]
    dec = C.cpr_decoder(my_location=(47.0, 8.0))
    a0 = C.cpr_encode(47.2, 8.4, odd=False, surface=False)
    a1 = C.cpr_encode(47.2, 8.4, odd=True, surface=False)
    out += [call(dec.decode, 0xABC, *a0, 0, timestamp=0.0),
            call(dec.decode, 0xABC, *a1, 1, timestamp=1.0),
            call(dec.decode, 0xABC, *a1, 1, timestamp=600.0)]
    dec = C.cpr_decoder(my_location=(47.0, 8.0))
    for i in range(2000):
        call(dec.decode, 0x100000 + i, *e, 0, timestamp=float(i))
    out.append((len(dec.lkplist), len(dec.poslist), sorted(dec.poslist)[:5]))
    truth = (47.3, 8.2)
    ev_air = C.cpr_encode(*truth, odd=False, surface=False)
    od_sur = C.cpr_encode(*truth, odd=True, surface=True)
    ev_sur = C.cpr_encode(*truth, odd=False, surface=True)
    dec = C.cpr_decoder(my_location=None)
    out += [call(dec.decode, 1, *ev_air, 0, surface=False, timestamp=100.0),
            call(dec.decode, 1, *od_sur, 1, surface=True, timestamp=103.0),
            dict(dec.lkplist)]
    dec = C.cpr_decoder(my_location=(47.0, 8.0))
    out += [call(dec.decode, 2, *ev_air, 0, surface=False, timestamp=100.0),
            call(dec.decode, 2, *ev_sur, 0, surface=True, timestamp=102.0),
            call(dec.decode, 2, *od_sur, 1, surface=True, timestamp=103.0)]
    for gf in (True, False):
        dec = C.cpr_decoder(my_location=(47.0, 8.0), global_first=gf)
        ge = C.cpr_encode(*truth, odd=False, surface=False)
        go = C.cpr_encode(*truth, odd=True, surface=False)
        g2 = C.cpr_encode(47.31, 8.21, odd=False, surface=False)
        out += [call(dec.decode, 1, *ge, 0, timestamp=0.0),
                call(dec.decode, 1, *go, 1, timestamp=1.0),
                call(dec.decode, 1, *g2, 0, timestamp=2.0)]
    return out


@pytest.mark.parametrize("scenario", [_cpr_encode_grid, _cpr_boundary,
                                      _cpr_decoder_cases],
                         ids=["encode_global_local", "boundary_straddle",
                              "decoder"])
def test_cpr_matches_reference(scenario):
    want, got = both(scenario)
    assert got == want


# --- commb and acas ----------------------------------------------------------

_COMMB_FNS = ("infer", "decode", "is_bds10", "is_bds17", "is_bds20",
              "is_bds40", "is_bds44", "is_bds45", "is_bds50", "is_bds60",
              "decode_bds10", "decode_bds17", "decode_bds20", "decode_bds40",
              "decode_bds44", "decode_bds45", "decode_bds50", "decode_bds60")


@pytest.mark.parametrize("fn", _COMMB_FNS)
def test_commb_matches_reference(fn):
    mbs = commb_payloads(np.random.default_rng(13))
    want, got = both(lambda ns: [call(getattr(ns.decode.commb, fn), mb)
                                 for mb in mbs])
    assert got == want


def test_acas_matches_reference():
    rng = np.random.default_rng(14)
    mvs = [(0x30 << 48) | (int(a) << 34) | (int(r) << 30) | (int(t) << 26)
           | int(tid) for a, r, t, tid in zip(
               rng.integers(0, 1 << 14, 200), rng.integers(0, 16, 200),
               rng.integers(0, 4, 200), rng.integers(0, 1 << 26, 200))]
    mvs += [(0x30 << 48) | (1 << 29), (0x30 << 48) | (1 << 28), 0,
            0x31 << 48]

    def run(ns):
        A = ns.decode.acas
        out = []
        for mv in mvs:
            out.append(call(A.decode_mv, mv))
            ra = A.decode_mv(mv)
            out.append(call(A.summarize, ra) if ra else None)
        return out

    want, got = both(run)
    assert got == want
    assert sum(isinstance(r, str) for r in want) > 100


# --- elm ---------------------------------------------------------------------

def _elm_cases(ns):
    """The reassembler scenarios of tests/test_elm.py."""
    E = ns.decode.elm.elm_reassembler
    out = []
    e = E(timeout_s=5.0)
    data = b"A" * 20
    for i in range(2):
        out.append(e.add(0x4840D6, 0, i,
                         int.from_bytes(data[i * 10:(i + 1) * 10], "big"),
                         1.0 + i * 0.01))
    out += [e.flush(2.0), e.flush(10.0), e.flush(99.0)]
    e.add(0x4840D6, 0, 0, 7, 1.0)
    out.append(e.flush(1.0, force=True))
    e = E(timeout_s=5.0)
    e.add(1, 0, 0, 111, 1.0)
    e.add(1, 0, 2, 333, 1.1)
    out.append(e.flush(100.0))
    e.add(1, 0, 1, 222, 200.0)
    out.append(e.flush(300.0))
    e = E(timeout_s=5.0)
    e.add(1, 0, 0, 111, 1.0)
    e.add(1, 0, 1, 222, 1.1)
    out += [e.add(1, 0, 1, 222, 1.2), e.flush(100.0)]
    e = E()
    out += [e.add(1, 1, 0, 999, 1.0), e.flush(100.0, force=True)]
    e = E(max_aircraft=4)
    for i in range(10):
        e.add(0x100000 + i, 0, 0, i, float(i))
    out.append(sorted(e._buf))
    e = E(timeout_s=5.0)
    old, new = bytes(range(10)), bytes(range(100, 110))
    out += [e.add(1, 0, 2, int.from_bytes(old, "big"), 0.0),
            e.add(1, 0, 3, int.from_bytes(old, "big"), 0.1),
            e.add(1, 0, 0, int.from_bytes(new, "big"), 100.0),
            e.add(1, 0, 1, int.from_bytes(new, "big"), 100.1),
            e.flush(200.0, force=True)]
    e = E(timeout_s=1000.0, max_aircraft=2)
    e.add(0xA, 0, 0, 1, 1.0)
    e.add(0xB, 0, 0, 2, 2.0)
    e.add(0xA, 0, 0, 3, 3.0)
    out.append(sorted(e._buf))
    return out


def test_elm_matches_reference():
    want, got = both(_elm_cases)
    assert got == want
    assert [(0x4840D6, b"A" * 20)] in want


# --- mlat and mlat_net -------------------------------------------------------

STATIONS4 = [(47.0, 8.0, 500.0), (47.3, 8.5, 600.0), (46.8, 8.6, 450.0),
             (47.2, 7.7, 550.0)]
STATIONS6 = STATIONS4 + [(47.30, 8.35, 700.0), (46.90, 8.10, 550.0)]


def _replies(M, target, stations, jitter_ns=0.0, seed=0):
    rng = np.random.default_rng(seed)
    t = M.llh2ecef(target)
    return {tuple(s): float(np.linalg.norm(M.llh2ecef(s) - t) / M.C
                            + rng.standard_normal() * jitter_ns * 1e-9)
            for s in stations}


def _mlat_solver(ns):
    """tests/test_mlat.py's solver cases: exact, jittered, 3 stations with
    altitude, too few, MSL datum, leave-one-out outlier rejection."""
    M = ns.decode.mlat
    rng = np.random.default_rng(0)
    out = [[M.ecef2llh(M.llh2ecef((float(rng.uniform(-85, 85)),
                                   float(rng.uniform(-180, 180)),
                                   float(rng.uniform(0, 12000)))))
            for _ in range(50)],
           [M.llh2geoid(la, lo) for la in range(-80, 81, 20)
            for lo in range(-180, 180, 45)]]
    tgt = (47.1, 8.25, 10000.0)
    out += [call(M.mlat, _replies(M, tgt, STATIONS4)),
            call(M.mlat, _replies(M, (47.05, 8.3, 11000.0), STATIONS4,
                                  jitter_ns=30.0, seed=3)),
            call(M.mlat, _replies(M, (47.1, 8.25, 9144.0), STATIONS4[:3]),
                 altitude_ft=30000.0),
            call(M.mlat, _replies(M, tgt, STATIONS4[:2]))]
    und = M.llh2geoid(47.1, 8.25)
    t_ecef = M.llh2ecef((47.1, 8.25, 9144.0 + und))
    msl = {}
    for la, lo, alt in STATIONS4[:3]:
        s = M.llh2ecef((la, lo, alt + M.llh2geoid(la, lo)))
        msl[(la, lo, alt)] = float(np.linalg.norm(s - t_ecef) / M.C)
    out.append(call(M.mlat, msl, altitude_ft=9144.0 / 0.3048,
                    alt_datum="msl"))
    rep = _replies(M, (47.1, 8.25, 9144.0), STATIONS6)
    rep[STATIONS6[4]] += 5e-6
    out += [call(M.mlat, rep),
            call(M.mlat, rep, altitude_ft=30000.0, reject_outliers=True,
                 max_resid_m=100.0),
            call(M.mlat, {s: rep[s] for s in STATIONS6[:5]},
                 altitude_ft=30000.0, reject_outliers=True, max_resid_m=50.0)]
    return out


def _mlat_coordinator(ns):
    """tests/test_mlat.py's coordinator cases: float and ns stamps, the
    earliest-arrival and tombstone rules, malformed and poisoned input,
    duplicate stations, a stale earlier copy."""
    M = ns.decode.mlat
    enc = REF.encoder
    stations = {f"st{i}": s for i, s in enumerate(STATIONS4)}
    t_ecef = M.llh2ecef((47.1, 8.25, 9144.0))
    frame = enc.df17_frame(0x4840D6, enc.me_identification("TEST"))
    out = []

    def d(s):
        return float(np.linalg.norm(M.llh2ecef(s) - t_ecef))

    coord = M.mlat_coordinator(stations, min_stations=4)
    out.append([call(coord.report, n,
                     f"17 {frame:028x} 000000 0 -20.0 {1000.0 + d(s) / M.C:.9f}")
                for n, s in stations.items()])
    unix_ns = 1_700_000_000_000_000_000
    coord = M.mlat_coordinator(stations, min_stations=4)

    def nsmsg(s, extra=0):
        ns_ = unix_ns + int(round(d(s) / M.C * 1e9)) + extra
        return f"17 {frame:028x} 000000 0 -20.0 {ns_ * 1e-9:.9f} {ns_}"

    names = list(stations)
    for n in names[:3]:
        out += [call(coord.report, n, nsmsg(stations[n])),
                call(coord.report, n, nsmsg(stations[n], 30_000))]
    out.append(call(coord.report, names[3], nsmsg(stations[names[3]])))
    out += [call(coord.report, n, nsmsg(stations[n], 50_000)) for n in names]
    out.append(dict(coord._pending))
    coord = M.mlat_coordinator(stations)
    for m in ("17 8d4840d6 000000 0 -20.0 notanumber",
              "17 zznothex 000000 0 -20.0 1.0", "short",
              f"17 {frame:028x} 000000 0 -20.0 1e200", "4 a 000000 0 -3 1.0",
              f"17 {frame:028x} 000000 0 -20.0 nan"):
        out.append(call(coord.report, "st0", m))
    out += [call(coord.report, "unknown", "17 8d4840d6 000000 0 -20.0 1.0"),
            dict(coord._pending), coord._tb.base_ns]
    out.append(call(M.mlat_coordinator, {"a": STATIONS4[0],
                                         "b": STATIONS4[0],
                                         "c": STATIONS4[1]}))
    coord = M.mlat_coordinator(stations, min_stations=4)
    arr = {n: 1000.0 + d(stations[n]) / M.C for n in names}
    for n in names[:3]:
        out.append(call(coord.report, n,
                        f"17 {frame:028x} 000000 0 -20.0 {arr[n]:.9f}"))
    out += [call(coord.report, names[0],
                 f"17 {frame:028x} 000000 0 -20.0 {995.0:.9f}"),
            call(coord.report, names[3],
                 f"17 {frame:028x} 000000 0 -20.0 {arr[names[3]]:.9f}")]
    out.append(call(coord.prune, 2000.0))
    return out


STATIONS_NET = [(47.00, 8.00, 500.0), (47.25, 8.05, 420.0),
                (46.95, 8.40, 610.0), (47.15, 8.30, 800.0)]
AIRCRAFT = (47.10, 8.20, 10000.0)


def _arrivals(M, aircraft, stations, t_emit=100.0):
    ac = M.llh2ecef(aircraft)
    return [t_emit + float(np.linalg.norm(ac - M.llh2ecef(s))) / 299792458.0
            for s in stations]


def _w(frame, nbits, ts, status=0, synd=None):
    s = REF.crc.crc24(frame, nbits) if synd is None else synd
    return (f"{frame >> (nbits - 5)} {frame:0{nbits // 4}x} {s:06x} "
            f"{status} -20.0 {ts:.9f}")


def _sol(s):
    return norm(s)


def _mlat_net_correlator(ns):
    """tests/test_mlat_net.py's correlator cases: a 4-station frame, 3
    stations with an altitude constraint, earliest arrival and minimum
    count, AP-overlay address, ns and mixed stamps, malformed input, a
    lagged copy, duplicate stations, insertion-order aging, anonymous
    DF18, a trailing token."""
    M = ns.decode.mlat
    N = ns.decode.mlat_net
    enc = REF.encoder
    from airmodes.decode.altitude import encode_alt_q
    out = []
    corr = N.mlat_correlator(STATIONS_NET, alt_datum="ellipsoid")
    f = enc.df17_frame(0x4840D6, enc.me_identification("MLAT01"))
    ts = _arrivals(M, AIRCRAFT, STATIONS_NET)
    out.append([_sol(corr.feed(i, _w(f, 112, ts[i]))) for i in range(4)])
    out += [_sol(corr.flush(now=ts[0] + 1.0)),
            _sol(corr.flush(now=ts[0] + 2.0))]
    f4 = enc.df4_frame(0xABCDEF, encode_alt_q(AIRCRAFT[2] / 0.3048))
    corr = N.mlat_correlator(STATIONS_NET[:3], alt_datum="ellipsoid")
    for i in range(3):
        corr.feed(i, _w(f4, 56, ts[i], synd=0))
    out.append(_sol(corr.flush(now=ts[0] + 1.0)))
    corr = N.mlat_correlator(STATIONS_NET, min_stations=3,
                             alt_datum="ellipsoid")
    fp = enc.df17_frame(0x111111, enc.me_airborne_position(
        AIRCRAFT[2] / 0.3048, AIRCRAFT[0], AIRCRAFT[1], odd=False))
    corr.feed(0, _w(fp, 112, ts[0]))
    corr.feed(0, _w(fp, 112, ts[0] + 2e-6))
    corr.feed(1, _w(fp, 112, ts[1]))
    out.append(_sol(corr.flush(now=ts[0] + 1.0)))
    for i in range(3):
        corr.feed(i, _w(fp, 112, ts[i]))
    out.append(_sol(corr.flush(now=ts[0] + 1.0)))
    corr = N.mlat_correlator(STATIONS_NET, alt_datum="ellipsoid")
    fa = enc.df4_frame(0xABCDEF, encode_alt_q(30000.0))
    for i in range(4):
        corr.feed(i, _w(fa, 56, ts[i], status=3))
    out.append(_sol(corr.flush(now=ts[0] + 1.0)))
    unix_ns = 1_700_000_000_000_000_000
    t0 = _arrivals(M, AIRCRAFT, STATIONS_NET, 0.0)
    for mode in ("ns", "float", "mixed"):
        corr = N.mlat_correlator(STATIONS_NET, alt_datum="ellipsoid")
        for i in range(4):
            n_ = unix_ns + int(round(t0[i] * 1e9))
            w = f"17 {f:028x} 000000 0 -20.0 {n_ * 1e-9:.9f}"
            if mode == "ns" or (mode == "mixed" and i % 2 == 0):
                w += f" {n_}"
            corr.feed(i, w)
        out.append(_sol(corr.flush(now=1e9, force=True)))
    corr = N.mlat_correlator(STATIONS_NET, window_s=0.05,
                             clock_sync_enabled=True)
    for s in range(3):
        for m in ("17 8d4840d6202cc371c32ce0576098 zz 0 -3.0 1.5",
                  "xx 8d4840d6202cc371c32ce0576098 000000 0 -3.0 1.5",
                  "17 8d4840d6202cc371c32ce0576098 000000 0 nope 1.5",
                  "4 0 000000 0 -3.0 1.5", "4 20010380b60fc6aa 000000 0 -3.0 1.5",
                  "16 8d4840d6202cc3 000000 0 -3.0 1.6",
                  "17 8d4840d6202cc371c32ce0576098 000000 0 -3.0 nan "
                  "1755700000123456789"):
            out.append(_sol(corr.feed(s, m)))
    corr = N.mlat_correlator(STATIONS_NET, alt_datum="ellipsoid")
    for i in range(4):
        corr.feed(i, _w(f, 112, ts[i], synd=0) + " sig=-12")
    out.append(_sol(corr.flush(now=ts[0] + 1.0)))
    corr = N.mlat_correlator(STATIONS_NET, alt_datum="ellipsoid")
    t10 = _arrivals(M, AIRCRAFT, STATIONS_NET, t_emit=10.0)
    for i in range(3):
        corr.feed(i, _w(f4, 56, t10[i], synd=0))
    corr.feed(3, _w(f4, 56, t10[3] - 2.0, synd=0))
    out.append(_sol(corr.flush(now=t10[0] + 1.0)))
    out.append(call(N.mlat_correlator, [STATIONS_NET[0], STATIONS_NET[1],
                                        STATIONS_NET[0]]))
    corr = N.mlat_correlator(STATIONS_NET, alt_datum="ellipsoid",
                             window_s=0.01)
    f1 = enc.df17_frame(0x111111, enc.me_identification("AAA"))
    f2 = enc.df17_frame(0x222222, enc.me_identification("BBB"))
    for i in range(4):
        corr.feed(i, _w(f1, 112, t10[i]))
    for i in range(4):
        corr.feed(i, _w(f2, 112, t10[i] + 0.005))
    out += [_sol(corr.flush(now=t10[0] + 0.012)),
            _sol(corr.flush(now=t10[0] + 0.02))]
    corr = N.mlat_correlator(STATIONS_NET, alt_datum="ellipsoid")
    fan = enc.df18_frame(0x4840D6, enc.me_identification("ANON"), cf=1)
    for i in range(4):
        corr.feed(i, _w(fan, 112, ts[i]))
    out.append(_sol(corr.flush(now=ts[0] + 1.0)))
    tb = N.epoch_timebase()
    out += [call(tb.rel, 1e200, None), tb.base_ns, call(tb.rel, 5.0, 10 ** 30),
            tb.base_ns, call(tb.rel, 1.5, None), call(tb.abs_, 2.5)]
    out += [call(N.parse_wire_obs, m) for m in (
        _w(f, 112, 1.5), _w(f, 112, 1.5) + " 1500000000", "short",
        _w(f, 112, 1.5) + " junk", "17 zz 000000 0 -3 1.0",
        f"17 {f:028x} 000000 0 -20.0 nan")]
    out += [call(N._frame_altitude_ft, h) for h in (
        f"{f4:014x}", f"{fp:028x}", f"{f:028x}", "a", "")]
    return out


def _mlat_net_clock_sync(ns):
    """tests/test_mlat_net.py's clock_sync cases: offsets, unconverged
    stations, drift, a station reset, anchor promotion and the correlator
    over unsynchronised feeds."""
    M = ns.decode.mlat
    N = ns.decode.mlat_net
    enc = REF.encoder
    from airmodes.decode.altitude import encode_alt_q
    out = []
    sync = N.clock_sync(STATIONS_NET, min_updates=3)
    off = [0.0, 0.004, -0.0035, 0.0012]
    for pos in ((47.05, 8.10, 9000.0), (47.20, 8.25, 11000.0),
                (46.99, 8.15, 8000.0)):
        t = _arrivals(M, pos, STATIONS_NET)
        out.append(call(sync.update, {s: t[s] + off[s] for s in range(4)},
                        pos))
    out += [list(sync.offset), call(sync.correct,
                                    {s: 100.0 + off[s] for s in range(4)})]
    sync = N.clock_sync(STATIONS_NET, min_updates=3)
    t = _arrivals(M, (47.05, 8.10, 9000.0), STATIONS_NET)
    sync.update({s: t[s] for s in range(4)}, (47.05, 8.10, 9000.0))
    out += [call(sync.correct, {0: 1.0, 1: 1.0}), call(sync.correct, {0: 1.0})]
    sync = N.clock_sync(STATIONS_NET, min_updates=3)
    rates, base = [0.0, 5e-6, -3e-6, 8e-6], [0.0, 0.002, -0.001, 0.0005]
    for k in range(20):
        pos = (47.05 + 0.001 * k, 8.10, 9000.0)
        ts = _arrivals(M, pos, STATIONS_NET, 100.0 + k)
        sync.update({s: ts[s] + base[s] + rates[s] * (ts[s] - 100.0)
                     for s in range(4)}, pos)
    out += [list(sync.rate), call(sync.correct, {
        s: 130.0 + base[s] + rates[s] * 30.0 for s in range(4)})]
    sync.reset_station(2)
    out += [sync.n_updates[2], call(sync.correct, {0: 110.0, 2: 110.0}),
            call(sync.correct, {0: 110.0, 1: 110.0})]
    sync = N.clock_sync(STATIONS_NET, min_updates=3)
    for k in range(5):
        pos = (47.05 + 0.001 * k, 8.10, 9000.0)
        ts = _arrivals(M, pos, STATIONS_NET, 100.0 + k)
        out.append(call(sync.update, {s: ts[s] + base[s]
                                      for s in (1, 2, 3)}, pos))
    out.append(call(sync.correct, {s: 110.0 for s in (1, 2, 3)}))
    off = [0.0, 0.006, -0.004, 0.002]
    corr = N.mlat_correlator(STATIONS_NET, alt_datum="ellipsoid",
                             window_s=0.1, clock_sync_enabled=True)
    ref_pos, target = (47.08, 8.12, 10000.0), (47.12, 8.28, 9500.0)
    tgt = enc.df4_frame(0xABCDEF, encode_alt_q(target[2] / 0.3048))
    sols, t_emit = [], 100.0
    for k in range(6):
        for odd in (False, True):
            fr = enc.df17_frame(0x4840D6, enc.me_airborne_position(
                ref_pos[2] / 0.3048, ref_pos[0], ref_pos[1], odd=odd))
            ts = _arrivals(M, ref_pos, STATIONS_NET, t_emit)
            for s in range(4):
                sols += corr.feed(s, _w(fr, 112, ts[s] + off[s]))
            t_emit += 0.5
        ts = _arrivals(M, target, STATIONS_NET, t_emit)
        for s in range(4):
            sols += corr.feed(s, _w(tgt, 56, ts[s] + off[s]))
        t_emit += 0.5
    sols += corr.flush(now=t_emit + 10.0, force=True)
    out.append(_sol(sols))
    return out


@pytest.mark.parametrize("scenario", [_mlat_solver, _mlat_coordinator,
                                      _mlat_net_correlator,
                                      _mlat_net_clock_sync],
                         ids=["mlat_solver", "mlat_coordinator",
                              "mlat_net_correlator", "mlat_net_clock_sync"])
def test_mlat_matches_reference(scenario):
    """Least-squares positions within rtol 1e-9; everything else (which
    groups solve, station counts, addresses, errors) exactly."""
    want, got = both(scenario)
    assert _close(got, want, rtol=1e-9), (got, want)
    assert "raised" not in str(want[:3])


# --- crc, config, exceptions -------------------------------------------------

def test_crc_numpy_helpers_match_reference():
    rng = np.random.default_rng(15)
    bits = rng.integers(0, 2, (64, 112), dtype=np.uint8)

    def run(ns):
        return [ns.crc.parity_matrix(56), ns.crc.parity_matrix(112),
                ns.crc.syndrome_np(bits), ns.crc.syndrome_np(bits[:, :56]),
                ns.crc.syndrome_np(bits, 88)]

    want, got = both(run)
    assert got == want


def test_config_crosses_over_from_reference():
    from airmodes import config as J
    from airmodes_torch import config as T
    cfg = J.Config(dsp=J.DspConfig(channel_rate=4e6, block_size=1 << 16),
                   source=J.SourceConfig(kind="udp", udp_port=1234),
                   output=J.OutputConfig(sqlite_db="x.db",
                                         location=(47.0, 8.0, 400.0)),
                   mesh=J.MeshConfig(channel_axis=2))
    d = dataclasses.asdict(cfg)
    got = T.Config.from_dict(d)
    d["dsp"].pop("mxu_window_sum")
    assert dataclasses.asdict(got) == d
    assert hash(got) == hash(T.Config.from_dict(dataclasses.asdict(cfg)))
    assert T.Config.from_dict({}) == T.Config()
    for cls in ("SourceConfig", "OutputConfig", "MeshConfig"):
        assert dataclasses.asdict(getattr(T, cls)()) == \
            dataclasses.asdict(getattr(J, cls)())
    with pytest.raises(ValueError, match="unknown"):
        T.Config.from_dict({"radio": {}})
    with pytest.raises(ValueError, match="unknown"):
        T.OutputConfig.from_dict({"sbs1": 1})


def test_exceptions_match_reference():
    import inspect
    J, T = REF.exceptions, PORT.exceptions

    def tree(mod):
        return {n: [b.__name__ for b in c.__mro__]
                for n, c in inspect.getmembers(mod, inspect.isclass)}

    assert tree(T) == tree(J)
