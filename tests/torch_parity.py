"""Helpers shared by the port's decode and output parity tests
(tests/test_torch_decode.py, tests/test_torch_outputs.py): the two packages
side by side, a normal form for their results, and a traffic stream that
holds every downlink format and ME type the encoder makes.

The inputs are built once, with the reference package's encoder, and the
same strings go through both packages."""

from __future__ import annotations

import dataclasses
import importlib
import math
import types

import numpy as np

import airmodes
import airmodes.crc
import airmodes.decode
import airmodes.exceptions
import airmodes.outputs
import airmodes.testing.encoder
import airmodes_torch
import airmodes_torch.crc
import airmodes_torch.decode
import airmodes_torch.exceptions
import airmodes_torch.outputs
import airmodes_torch.testing.encoder

T0 = 1700000000.0


_SUBMODULES = ("decode.mlat_net", "decode.elm", "outputs.beast",
               "outputs.httpd", "outputs.json_out", "outputs.quaternion",
               "outputs.tcpserver", "outputs.wx")


def _ns(pkg):
    for m in _SUBMODULES:
        importlib.import_module(f"{pkg.__name__}.{m}")
    return types.SimpleNamespace(
        name=pkg.__name__, pkg=pkg, crc=pkg.crc, decode=pkg.decode,
        exceptions=pkg.exceptions, outputs=pkg.outputs,
        encoder=pkg.testing.encoder)


REF = _ns(airmodes)
PORT = _ns(airmodes_torch)


def norm(x):
    """A comparable form: dataclasses by class name and fields, numpy
    arrays and scalars as Python values, NaN as a token; exceptions by
    class name and message (the two packages have their own classes)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: norm(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, BaseException):
        return ("raised", type(x).__name__, str(x))
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), norm(x.tolist()))
    if isinstance(x, np.generic):
        return norm(x.item())
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    if isinstance(x, dict):
        return {norm(k): norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(norm(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return sorted((norm(v) for v in x), key=repr)
    return x


def call(fn, *args, **kwargs):
    """fn's result, or the exception it raised, in normal form."""
    try:
        return norm(fn(*args, **kwargs))
    except Exception as e:  # compared, not swallowed
        return norm(e)


def both(scenario):
    """Run scenario(ns) on the reference and on the port; return both
    results in normal form."""
    return norm(scenario(REF)), norm(scenario(PORT))


# --- traffic ----------------------------------------------------------------

def wire(frame: int, nbits: int, ts: float, status: int = 0,
         dbfs: float = -20.0, syndrome=None) -> str:
    """The slicer's wire string for a frame; the syndrome is the frame's
    own (0 for a clean DF17/18, the address for AP-overlaid formats)."""
    crc = airmodes.crc
    synd = crc.crc24(frame, nbits) if syndrome is None else syndrome
    return (f"{frame >> (nbits - 5)} {frame:0{nbits // 4}x} {synd:06x} "
            f"{status} {dbfs:.2f} {ts:.9f}")


def _bits(rng, n: int) -> int:
    """A random n-bit integer (n may exceed 64)."""
    return int.from_bytes(rng.bytes((n + 7) // 8), "big") & ((1 << n) - 1)


def _pack(*fields):
    mb = 0
    for value, width in fields:
        mb = (mb << width) | (value & ((1 << width) - 1))
    return mb


def commb_payloads(rng) -> list:
    """56-bit MB fields: the register shapes of tests/test_commb.py's
    vectors, each with its status bits set, plus random fields."""
    enc = airmodes.testing.encoder
    from test_commb import (mb_bds40, mb_bds44, mb_bds45, mb_bds50,
                            mb_bds60)
    out = [
        0,
        mb_bds40(mcp_ft=10000, baro_mb=1013.2, modes=(1, 0, 0), tgt=3),
        mb_bds40(mcp_ft=25600, baro_mb=1020.0),
        mb_bds40(fms_ft=33008),
        mb_bds50(roll_raw=-60, trk_raw=688, gs_raw=110, tr_raw=16,
                 tas_raw=115),
        mb_bds50(roll_raw=5, trk_raw=300, gs_raw=320, tr_raw=0, tas_raw=240),
        mb_bds50(roll_raw=400, trk_raw=0, gs_raw=100, tr_raw=0, tas_raw=100),
        mb_bds60(hdg_raw=243, ias=252, mach_raw=105, vrb_raw=-60,
                 vri_raw=-64),
        mb_bds60(hdg_raw=100, ias=900, mach_raw=100, vrb_raw=0, vri_raw=0),
        mb_bds60(hdg_raw=10, ias=252, mach_raw=105, vrb_raw=0, vri_raw=0),
        mb_bds44(wind=(85, 270.0), temp_c=-52.25, press=1005, turb=1,
                 hum=32),
        mb_bds44(wind=None, temp_c=-50.0),
        mb_bds44(wind=(400, 90.0), temp_c=-50.0),
        mb_bds45(hazards={"turb": 2, "ice": 1}, temp_c=-51.25, press=220,
                 rh_ft=2400),
        mb_bds45(hazards={"turb": 3, "ws": 2}, temp_c=-40.0, rh_ft=1600),
        mb_bds45(hazards={"turb": 1}, temp_c=-10.0),
        (0x20 << 48) | (enc.me_identification("KLM1023") & ((1 << 48) - 1)),
        (0x20 << 48) | (enc.me_identification("ABC9876") & ((1 << 48) - 1)),
        _pack((0b110000001000100000010000, 24), (0, 32)),  # BDS1,7 flags
        _pack((0x10, 8), (1 << 47, 48)),                   # BDS1,0 shape
    ]
    out += [int(v) for v in rng.integers(0, 1 << 56, 24, dtype=np.uint64)]
    return out


def traffic() -> dict:
    """name -> list of wire strings; each group starts a fresh parser.
    Together they hold every downlink format and ME type the encoder
    makes, the parser's error paths and random frames of every DF."""
    enc = airmodes.testing.encoder
    from airmodes.decode.altitude import (encode_alt_12bit,
                                          encode_alt_gillham, encode_alt_q)
    from airmodes.decode.fields import encode_squawk
    rng = np.random.default_rng(2024)
    A, B, S, D = 0x4840D6, 0xABCDEF, 0x3C6586, 0x7C1234
    g = {}

    def seq(frames, step=0.37, **kw):
        return [wire(f, n, T0 + i * step, **kw)
                for i, (f, n) in enumerate(frames)]

    def es(icao, me, df=17, cf=0):
        if df == 18:
            return enc.df18_frame(icao, me, cf=cf), 112
        return enc.df17_frame(icao, me), 112

    g["identification"] = seq(
        [es(A, enc.me_identification("KLM1023", tc=4))]
        + [es(B + tc, enc.me_identification(cs, tc=tc, cat=cat))
           for tc in (1, 2, 3, 4) for cat, cs in enumerate(
               ("SWR12", "EZY9AB", "N123", "A1B2C3D4", "", "ZZ 99"))])

    pos = []
    for icao, (lat, lon, alt) in ((A, (47.3, 8.2, 30000.0)),
                                  (B, (-33.95, 151.18, 12000.0)),
                                  (D, (86.5, -40.0, 41000.0)),
                                  (A + 1, (10.4704, 2.0, 5000.0))):
        for k in range(3):
            la, lo = lat + 0.01 * k, lon + 0.012 * k
            pos.append(es(icao, enc.me_airborne_position(alt, la, lo,
                                                         odd=k % 2 == 1)))
    for tc in range(9, 23):
        pos.append(es(A + 2, enc.me_airborne_position(
            None if tc in (20, 21) else 20000.0, 47.1, 8.3, odd=tc % 2 == 0,
            tc=tc, ss=tc % 4)))
    pos.append(es(0x3C6614, encode_alt_12bit(25000.0) << 36))
    g["airborne_position"] = seq(pos)

    surf = []
    for k, mov in enumerate((0, 1, 2, 8, 9, 13, 38, 39, 93, 94, 108, 109,
                             123, 124, 125, 127)):
        for odd in (False, True):
            surf.append(es(S, enc.me_surface_position(
                47.45 + 1e-4 * k, 8.56, odd=odd, tc=5 + k % 4, mov=mov,
                track_deg=None if k % 3 == 0 else 12.5 * k)))
    g["surface_position"] = seq(surf)

    vel = [es(A, enc.me_velocity(gs, trk, vr, supersonic=sup))
           for gs, trk, vr, sup in ((250.0, 45.0, -640.0, False),
                                    (480.0, 359.0, 2560.0, False),
                                    (0.0, 0.0, 0.0, False),
                                    (1200.0, 181.0, -6400.0, True),
                                    (35.0, 270.0, 64.0, False))]
    g["velocity"] = seq(vel)

    ara = (1 << 13) | (1 << 12) | (1 << 11) | (1 << 7)
    stat = [es(A, enc.me_emergency_status(st, squawk=sq))
            for st, sq in ((0, 1200), (1, 7700), (2, 7600), (3, 0), (4, 7600),
                           (5, 7500), (6, 0), (7, 0))]
    stat += [es(A, enc.me_ra_broadcast(a, rac=rac, rat=rat, mte=mte, tti=tti,
                                       tid=tid))
             for a, rac, rat, mte, tti, tid in (
                 (ara, 0b0100, 0, 0, 1, 0xABCDEF << 2),
                 (0b11000010000000, 0, 0, 0, 2, 0x1234567),
                 (0b01100000000000, 0, 0, 1, 0, 0), (0, 0, 1, 0, 0, 0))]
    stat += [es(A, (28 << 51) | (5 << 48) | 0xDEADBEEF),
             es(A, (29 << 51) | 0x1234567)]
    stat += [es(0xA1B2C3, enc.me_target_state(**kw)) for kw in (
        dict(sel_alt_ft=36000, baro_mb=1013.6, sel_hdg_deg=270.0, nacp=9,
             sil=3, nic_baro=1,
             modes={"autopilot": True, "vnav": True, "lnav": True}),
        dict(sel_alt_ft=12000, fms=True, modes={"approach": True,
                                                "altitude_hold": True}),
        dict(tcas_op=False), dict())]
    stat += [es(0xA1B2C3, enc.me_op_status(**kw)) for kw in (
        dict(), dict(surface=True, lw=5, trk_hdg=1, hrd=1, cc=0x123),
        dict(version=1, nacp=7, om=0x2000, cc=0x8000),
        dict(version=0), dict(surface=True, version=2, nic_sup_a=1))]
    g["status_and_intent"] = seq(stat)

    every = []
    for tc in range(32):
        for sub in range(8):
            every.append(es(D, (tc << 51) | (sub << 48)
                            | int(rng.integers(0, 1 << 48))))
    g["every_type_code"] = seq(every, step=0.05)

    d18 = []
    for cf in range(8):
        for me in (enc.me_identification("DF18X", tc=3),
                   enc.me_airborne_position(9000.0, 47.31, 8.21, odd=False),
                   enc.me_airborne_position(9000.0, 47.31, 8.21, odd=True),
                   enc.me_velocity(140.0, 90.0, 0.0)):
            d18.append(es(A, me, df=18, cf=cf))
    # anonymous-address isolation: a non-ICAO address with the same 24 bits
    # as a real aircraft must not pair CPR frames with it
    d18 += [es(A, enc.me_airborne_position(30000.0, 47.3, 8.2, odd=False)),
            es(A, enc.me_airborne_position(30000.0, 47.5, 8.4, odd=True),
               df=18, cf=1),
            es(A, enc.me_airborne_position(30000.0, 47.3, 8.2, odd=True))]
    g["df18"] = seq(d18)

    short = []
    for alt13 in (encode_alt_q(31000.0), encode_alt_gillham(12300.0),
                  0x0040, 0, encode_alt_q(-1000.0)):
        short += [(enc.df0_frame(A, alt13, vs=vs, ri=ri), 56)
                  for vs, ri in ((0, 0), (1, 3), (0, 9))]
        short += [(enc.df4_frame(A, alt13, fs=fs), 56) for fs in range(8)]
        short.append((enc.df16_frame(B, alt13, mv=0x30 << 48), 112))
    for sq in (0, 1200, 7500, 7600, 7700, 4215, 7777):
        short += [(enc.df5_frame(A, encode_squawk(sq), fs=fs), 56)
                  for fs in (0, 1, 4, 5)]
    short += [(enc.df11_frame(S + ca, ca=ca, interrogator=ii), 56)
              for ca in range(8) for ii in (0, 5)]
    g["surveillance"] = seq(short)
    g["surveillance_addr_status"] = seq(short[:20], status=3, dbfs=-31.5)

    mvs = [(0x30 << 48) | (0b11100110000000 << 34) | (1 << 26)
           | (0x7C6B1D << 2),
           (0x30 << 48) | (0b11000010000000 << 34),
           (0x30 << 48) | (0b01100000000000 << 34) | (1 << 28),
           (0x30 << 48) | (1 << 29), 0x30 << 48, 0x31 << 48, 0]
    g["acas"] = seq([(enc.df16_frame(B, encode_alt_q(31000.0), mv=mv), 112)
                     for mv in mvs])

    cb = []
    for k, mb in enumerate(commb_payloads(rng)):
        cb.append((enc.df20_frame(A + k, encode_alt_q(25000.0), mb=mb,
                                  fs=k % 6), 112))
        cb.append((enc.df21_frame(A + k, encode_squawk(7421), mb=mb), 112))
    g["commb"] = seq(cb)

    elm = []
    payload = bytes(range(1, 44))
    segs = enc.df24_segments(A, payload)
    elm += [(f, 112) for f in segs]                 # one full cycle
    elm += [(f, 112) for f in segs[1:3]]            # retransmission
    elm += [(f, 112) for f in enc.df24_segments(A, b"second")]  # restart
    elm += [(f, 112) for f in enc.df24_segments(B, payload[:25])]
    elm += [(enc.df24_frame(A, 0, 0x1234, ke=1), 112)]  # uplink ack
    elm += [(enc.df11_frame(A), 56)]                # the parse clock moves
    g["elm"] = seq(elm, step=0.6)

    ident = enc.df17_frame(A, enc.me_identification("KLM1023"))
    bad = ident ^ (1 << 40)
    g["malformed"] = [
        "", "garbage", "17", "17 8d 000000 0 -20.0",
        wire(ident, 112, T0, status=4),
        wire(bad, 112, T0 + 1),
        wire(bad, 112, T0 + 1, syndrome=0),
        f"17 {ident:028x} 000000 0 nan {T0}",
        f"17 {ident:028x} 000000 0 -20.0 inf",
        f"17 {ident:027x}z 000000 0 -20.0 {T0}",
        f"17 {ident:026x} 000000 0 -20.0 {T0}",
        f"11 {ident:028x} 000000 0 -20.0 {T0}",
        f"x7 {ident:028x} 000000 0 -20.0 {T0}",
        f"17 {ident:028x} zz 0 -20.0 {T0}",
        f"17 {ident:028x} 000000 0 -20.0 {T0} 123456789",
        f"17 {ident:028x} 000000 0 -20.0 {T0} junk",
    ]

    fuzz = []
    for df in range(32):
        nbits = 112 if df >= 16 else 56
        for _ in range(4):
            payload = (df << (nbits - 29)) | _bits(rng, nbits - 29)
            ov = 0 if rng.random() < 0.5 else int(rng.integers(0, 1 << 24))
            fuzz.append(enc.build_frame(payload, nbits - 24, overlay=ov))
    g["fuzz"] = seq(fuzz, step=0.11)

    mixed = enc.random_mixed_frames(80, seed=7)
    g["mixed_capture"] = seq(mixed, step=0.013)
    return g
