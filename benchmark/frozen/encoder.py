# Frozen copy of airmodes_torch/testing/encoder.py at commit 8b1fb463eba6: part of
# the benchmark's yardstick, which later changes to the program leave as
# it is. Only its imports were changed.
"""Mode S encoder — the inverse pipeline, used to generate golden captures.

The reference ships no tests (SURVEY.md §4); this module fills that vacuum:
message -> CRC append -> PPM chips -> preamble -> upsampled complex IQ at a
chosen SNR, with known ground truth. Everything downstream (preamble detect,
slicer, CRC/ECC, parser, CPR) is validated against captures built here.

All host-side numpy; the device never sees this code. A copy of
`airmodes.testing.encoder` (same seeds, same frames, same captures), over
the port's own `decode/` field encoders, so the port builds ground-truth
captures without importing the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import crc
from .constants import (
    CHIPS_PER_BIT,
    MAX_FRAME_BITS,
    PREAMBLE_CHIPS,
    PREAMBLE_PULSE_CHIPS,
    SHORT_FRAME_BITS,
)

PREAMBLE_CHIP_PATTERN = np.zeros(PREAMBLE_CHIPS, dtype=np.float32)
for _c in PREAMBLE_PULSE_CHIPS:
    PREAMBLE_CHIP_PATTERN[_c] = 1.0


# --- frame construction -------------------------------------------------------

def build_frame(payload: int, payload_bits: int, overlay: int = 0) -> Tuple[int, int]:
    """Append CRC-24 to a payload, XORing `overlay` into the parity field.

    overlay = 0        -> DF17-style PI (syndrome of the frame is 0)
    overlay = icao     -> DF0/4/5/16/20/21 AP field (syndrome == icao)
    overlay = II (7b)  -> DF11 PI with interrogator code (low 7 bits)
    Returns (frame_int, frame_bits_total).
    """
    p = crc.parity(payload, payload_bits) ^ overlay
    return (payload << 24) | p, payload_bits + 24


def df17_frame(icao: int, me: int, ca: int = 5) -> int:
    """DF17 extended squitter: [df:5][ca:3][aa:24][me:56][pi:24]."""
    payload = (17 << 83) | ((ca & 0x7) << 80) | ((icao & 0xFFFFFF) << 56) | (me & (1 << 56) - 1)
    frame, n = build_frame(payload, 88)
    assert n == MAX_FRAME_BITS
    return frame

def df18_frame(icao: int, me: int, cf: int = 0) -> int:
    """DF18 extended squitter / non-transponder:
    [df:5][cf:3][aa:24][me:56][pi:24]."""
    payload = (18 << 83) | ((cf & 0x7) << 80) | ((icao & 0xFFFFFF) << 56) \
        | (me & (1 << 56) - 1)
    frame, n = build_frame(payload, 88)
    assert n == MAX_FRAME_BITS
    return frame

def df11_frame(icao: int, ca: int = 5, interrogator: int = 0) -> int:
    """DF11 all-call reply: [df:5][ca:3][aa:24][pi:24]."""
    payload = (11 << 27) | ((ca & 0x7) << 24) | (icao & 0xFFFFFF)
    frame, n = build_frame(payload, 32, overlay=interrogator & 0x7F)
    assert n == SHORT_FRAME_BITS
    return frame

def df4_frame(icao: int, ac13: int, fs: int = 0, dr: int = 0, um: int = 0) -> int:
    """DF4 surveillance altitude reply: [df:5][fs:3][dr:5][um:6][ac:13][ap:24]."""
    payload = (4 << 27) | ((fs & 7) << 24) | ((dr & 0x1F) << 19) | ((um & 0x3F) << 13) | (ac13 & 0x1FFF)
    frame, _ = build_frame(payload, 32, overlay=icao & 0xFFFFFF)
    return frame

def df5_frame(icao: int, id13: int, fs: int = 0, dr: int = 0, um: int = 0) -> int:
    """DF5 surveillance identity reply: [df:5][fs:3][dr:5][um:6][id:13][ap:24]."""
    payload = (5 << 27) | ((fs & 7) << 24) | ((dr & 0x1F) << 19) | ((um & 0x3F) << 13) | (id13 & 0x1FFF)
    frame, _ = build_frame(payload, 32, overlay=icao & 0xFFFFFF)
    return frame

def df0_frame(icao: int, ac13: int, vs: int = 0, ri: int = 0) -> int:
    """DF0 short air-air ACAS: [df:5][vs:1][cc:1][_:1][sl:3][_:2][ri:4][_:2][ac:13][ap:24]."""
    payload = (0 << 27) | ((vs & 1) << 26) | ((ri & 0xF) << 15) | (ac13 & 0x1FFF)
    frame, _ = build_frame(payload, 32, overlay=icao & 0xFFFFFF)
    return frame

def df16_frame(icao: int, ac13: int, mv: int = 0, vs: int = 0,
               ri: int = 0) -> int:
    """DF16 long air-air ACAS:
    [df:5][vs:1][_:2][sl:3][_:2][ri:4][_:2][ac:13][mv:56][ap:24]."""
    payload = ((16 << 27) | ((vs & 1) << 26) | ((ri & 0xF) << 15)
               | (ac13 & 0x1FFF)) << 56 | (mv & (1 << 56) - 1)
    frame, n = build_frame(payload, 88, overlay=icao & 0xFFFFFF)
    assert n == MAX_FRAME_BITS
    return frame

def df20_frame(icao: int, ac13: int, mb: int = 0, fs: int = 0) -> int:
    """DF20 Comm-B altitude: [df:5][fs:3][dr:5][um:6][ac:13][mb:56][ap:24]."""
    payload = ((20 << 27) | ((fs & 7) << 24) | (ac13 & 0x1FFF)) << 56 | (mb & (1 << 56) - 1)
    frame, n = build_frame(payload, 88, overlay=icao & 0xFFFFFF)
    assert n == MAX_FRAME_BITS
    return frame

def df21_frame(icao: int, id13: int, mb: int = 0, fs: int = 0) -> int:
    """DF21 Comm-B identity: [df:5][fs:3][dr:5][um:6][id:13][mb:56][ap:24]."""
    payload = ((21 << 27) | ((fs & 7) << 24) | (id13 & 0x1FFF)) << 56 | (mb & (1 << 56) - 1)
    frame, n = build_frame(payload, 88, overlay=icao & 0xFFFFFF)
    assert n == MAX_FRAME_BITS
    return frame

def df24_frame(icao: int, nd: int, md: int, ke: int = 0) -> int:
    """DF24 Comm-D ELM segment: [df:2][_:1][ke:1][nd:4][md:80][ap:24]."""
    payload = (3 << 86) | ((ke & 1) << 84) | ((nd & 0xF) << 80) \
        | (md & (1 << 80) - 1)
    frame, n = build_frame(payload, 88, overlay=icao & 0xFFFFFF)
    assert n == MAX_FRAME_BITS
    return frame

def df24_segments(icao: int, data: bytes, ke: int = 0) -> list:
    """Split a Comm-D ELM payload into DF24 segment frames (10 bytes per
    80-bit MD, zero-padded; <= 16 segments — decode/elm.py reassembles)."""
    from .fieldcodes import MAX_SEGMENTS, SEGMENT_BYTES
    n = -(-len(data) // SEGMENT_BYTES)
    if not 1 <= n <= MAX_SEGMENTS:
        raise ValueError(f"ELM payload needs 1..{MAX_SEGMENTS} segments, "
                         f"got {n}")
    padded = data.ljust(n * SEGMENT_BYTES, b"\0")
    return [df24_frame(icao,
                       i, int.from_bytes(
                           padded[i * SEGMENT_BYTES:(i + 1) * SEGMENT_BYTES],
                           "big"), ke=ke)
            for i in range(n)]


# --- ME-field helpers (DF17 payload types, ref: python/parse.py layouts) -----

def me_identification(callsign: str, tc: int = 4, cat: int = 0) -> int:
    """BDS0,8 ident ME: [ftc:5][cat:3][8 x 6-bit chars]."""
    from .constants import CALLSIGN_CHARMAP
    cs = (callsign + " " * 8)[:8].upper().replace(" ", "_")
    me = (tc & 0x1F) << 51 | (cat & 7) << 48
    for i, ch in enumerate(cs):
        code = CALLSIGN_CHARMAP.index(ch)
        me |= code << (42 - 6 * i)
    return me


def me_airborne_position(alt_ft: Optional[float], lat: float, lon: float,
                         odd: bool, tc: int = 11, ss: int = 0) -> int:
    """BDS0,5 airborne position ME: [ftc:5][ss:2][nicsb:1][alt:12][t:1][f:1][lat:17][lon:17]."""
    from .fieldcodes import cpr_encode
    from .fieldcodes import encode_alt_12bit
    yz, xz = cpr_encode(lat, lon, odd=odd, surface=False)
    alt12 = 0 if alt_ft is None else encode_alt_12bit(alt_ft)
    me = (tc & 0x1F) << 51 | (ss & 3) << 49 | (alt12 & 0xFFF) << 36
    me |= (1 if odd else 0) << 34 | (yz & 0x1FFFF) << 17 | (xz & 0x1FFFF)
    return me


def me_surface_position(lat: float, lon: float, odd: bool, tc: int = 7,
                        mov: int = 0, track_deg: Optional[float] = None) -> int:
    """BDS0,6 surface position ME: [ftc:5][mov:7][gts:1][gtk:7][t:1][f:1][lat:17][lon:17].

    `mov` is the DO-260 movement code (see parse._surface_speed bands);
    track is valid (gts=1) only when track_deg is given.
    """
    from .fieldcodes import cpr_encode
    yz, xz = cpr_encode(lat, lon, odd=odd, surface=True)
    gts = 0 if track_deg is None else 1
    gtk = 0 if track_deg is None else round(track_deg % 360.0 * 128.0 / 360.0) & 0x7F
    me = (tc & 0x1F) << 51 | (mov & 0x7F) << 44 | gts << 43 | gtk << 36
    me |= (1 if odd else 0) << 34 | (yz & 0x1FFFF) << 17 | (xz & 0x1FFFF)
    return me


def me_velocity(gs_kt: float, track_deg: float, vrate_fpm: float,
                supersonic: bool = False) -> int:
    """BDS0,9 subtype 1/2 ground-velocity ME."""
    st = 2 if supersonic else 1
    scale = 4 if supersonic else 1
    tr = np.deg2rad(track_deg)
    ew = gs_kt * np.sin(tr)
    ns = gs_kt * np.cos(tr)
    s_ew = 1 if ew < 0 else 0
    s_ns = 1 if ns < 0 else 0
    v_ew = min(int(round(abs(ew) / scale)) + 1, 1023)
    v_ns = min(int(round(abs(ns) / scale)) + 1, 1023)
    s_vr = 1 if vrate_fpm < 0 else 0
    v_vr = min(int(round(abs(vrate_fpm) / 64)) + 1, 511)
    me = (19 << 51) | (st << 48)
    me |= s_ew << 42 | v_ew << 32 | s_ns << 31 | v_ns << 21
    me |= 1 << 20  # vertical rate source: baro
    me |= s_vr << 19 | v_vr << 10
    return me


def me_emergency_status(state: int, squawk: int = 0) -> int:
    """BDS6,1 subtype 1 (TC28) emergency/priority status ME."""
    from .fieldcodes import encode_squawk
    me = (28 << 51) | (1 << 48) | (state & 7) << 45
    if squawk:
        me |= (encode_squawk(squawk) & 0x1FFF) << 32
    return me


def me_ra_broadcast(ara: int, rac: int = 0, rat: int = 0, mte: int = 0,
                    tti: int = 0, tid: int = 0) -> int:
    """BDS6,1 subtype 2 (TC28) ACAS RA broadcast ME (payload = BDS3,0)."""
    return ((28 << 51) | (2 << 48) | (ara & 0x3FFF) << 34 |
            (rac & 0xF) << 30 | (rat & 1) << 29 | (mte & 1) << 28 |
            (tti & 3) << 26 | (tid & 0x3FFFFFF))


def me_target_state(sel_alt_ft: Optional[float] = None, fms: bool = False,
                    baro_mb: Optional[float] = None,
                    sel_hdg_deg: Optional[float] = None,
                    nacp: int = 0, sil: int = 0, nic_baro: int = 0,
                    modes: Optional[dict] = None, tcas_op: bool = True) -> int:
    """BDS6,2 subtype 1 (TC29) target state and status ME."""
    me = (29 << 51) | (1 << 49)
    if fms:
        me |= 1 << 47
    if sel_alt_ft is not None:
        me |= (min(int(round(sel_alt_ft / 32.0)) + 1, 0x7FF)) << 36
    if baro_mb is not None:
        me |= (min(int(round((baro_mb - 800.0) / 0.8)) + 1, 0x1FF)) << 27
    if sel_hdg_deg is not None:
        hdg9 = int(round((sel_hdg_deg % 360.0) * 256.0 / 180.0)) & 0x1FF
        me |= (1 << 26) | hdg9 << 17
    me |= (nacp & 0xF) << 13 | (nic_baro & 1) << 12 | (sil & 3) << 10
    if modes is not None:
        me |= 1 << 9
        for key, pos in (("autopilot", 8), ("vnav", 7), ("altitude_hold", 6),
                         ("approach", 4), ("lnav", 2)):
            if modes.get(key):
                me |= 1 << pos
    if tcas_op:
        me |= 1 << 3
    return me


def me_op_status(surface: bool = False, version: int = 2, nacp: int = 9,
                 sil: int = 3, gva: int = 2, nic_baro: int = 1,
                 nic_sup_a: int = 0, cc: int = 0, om: int = 0, lw: int = 0,
                 trk_hdg: int = 0, hrd: int = 0) -> int:
    """BDS6,5 (TC31) aircraft operational status ME, subtype 0/1."""
    me = (31 << 51) | ((1 if surface else 0) << 48)
    if surface:
        me |= (cc & 0xFFF) << 36 | (lw & 0xF) << 32 | (om & 0xFFFF) << 16
        me |= (version & 7) << 13 | (nic_sup_a & 1) << 12 | (nacp & 0xF) << 8
        me |= (sil & 3) << 4 | (trk_hdg & 1) << 3 | (hrd & 1) << 2
    else:
        me |= (cc & 0xFFFF) << 32 | (om & 0xFFFF) << 16
        me |= (version & 7) << 13 | (nic_sup_a & 1) << 12 | (nacp & 0xF) << 8
        me |= (gva & 3) << 6 | (sil & 3) << 4 | (nic_baro & 1) << 3
        me |= (hrd & 1) << 2
    return me


# --- modulation ---------------------------------------------------------------

def frame_to_chips(frame: int, nbits: int) -> np.ndarray:
    """Preamble + PPM-modulated data chips (float32 0/1 chip amplitudes)."""
    nchips = PREAMBLE_CHIPS + nbits * CHIPS_PER_BIT
    chips = np.zeros(nchips, dtype=np.float32)
    chips[:PREAMBLE_CHIPS] = PREAMBLE_CHIP_PATTERN
    for i in range(nbits):
        bit = (frame >> (nbits - 1 - i)) & 1
        chips[PREAMBLE_CHIPS + 2 * i + (0 if bit else 1)] = 1.0
    return chips


@dataclasses.dataclass
class GroundTruth:
    frame: int
    nbits: int
    sample_index: int       # preamble start, in samples
    amplitude: float
    snr_db: float
    sps: int = 1            # samples per chip of the capture

    @property
    def hex(self) -> str:
        return f"{self.frame:0{self.nbits // 4}x}"

    @property
    def df(self) -> int:
        return self.frame >> (self.nbits - 5)


def make_capture(
    frames: Sequence[Tuple[int, int]],
    *,
    rate: float = 2e6,
    snr_db: float = 20.0,
    noise_power: float = 1e-2,
    spacing: int = 4096,
    start: int = 1024,
    jitter: int = 0,
    seed: int = 0,
    total_samples: Optional[int] = None,
    random_phase: bool = True,
) -> Tuple[np.ndarray, List[GroundTruth]]:
    """Build a complex64 IQ capture containing `frames` at a given SNR.

    frames: list of (frame_int, nbits). SNR is per-pulse power over noise power.
    Returns (iq, ground_truth). Pulse amplitude A satisfies A^2/noise = 10^(snr/10).
    """
    from .constants import CHIP_RATE
    sps = int(round(rate / CHIP_RATE))
    assert sps >= 1
    if abs(sps * CHIP_RATE - rate) > 1e-3:   # same ABSOLUTE tolerance as
        # DspConfig.sps: a relative bound (2 Hz at 2 MHz) accepted rates
        # in the gap whose captures no DspConfig could then decode
        # silently rounding 2.4e6 to 2 Msps would hand the caller a
        # capture at a rate they did not ask for (and a later resample
        # of it decodes nothing); DspConfig.sps rejects identically
        raise ValueError(
            f"rate {rate:g} is not an integer multiple of the 2 MHz "
            f"chip rate; generate at a supported rate and resample")
    rng = np.random.default_rng(seed)

    positions = []
    pos = start
    for _ in frames:
        positions.append(pos + (int(rng.integers(0, jitter + 1)) if jitter else 0))
        pos += spacing
    n_total = total_samples or (positions[-1] if positions else 0) + 512 * sps + 8192
    amp = float(np.sqrt(noise_power * 10 ** (snr_db / 10.0)))

    noise = (rng.standard_normal(n_total) + 1j * rng.standard_normal(n_total))
    iq = (noise * np.sqrt(noise_power / 2)).astype(np.complex64)

    truth: List[GroundTruth] = []
    for (frame, nbits), p in zip(frames, positions):
        chips = frame_to_chips(frame, nbits)
        pulse = np.repeat(chips, sps).astype(np.complex64)
        phase = np.exp(2j * np.pi * rng.random()) if random_phase else 1.0
        seg = slice(p, p + pulse.size)
        if p + pulse.size > n_total:
            continue
        iq[seg] += (amp * phase * pulse).astype(np.complex64)
        truth.append(GroundTruth(frame, nbits, p, amp, snr_db, sps))
    return iq, truth


def frame_icao(frame: int, nbits: int) -> int:
    """Transmitter address of an encoded frame: the AA field for
    DF11/17/18, parity-overlay recovery otherwise (a clean AP frame's
    syndrome IS the interrogated address — crc.py module docstring)."""
    from .crc import check_frame
    df = frame >> (nbits - 5)
    if df in (11, 17, 18):
        return (frame >> (nbits - 32)) & 0xFFFFFF
    return check_frame(frame, nbits)


def random_mixed_frames(n: int, seed: int = 0) -> List[Tuple[int, int]]:
    """Mixed live-traffic frame set: ~60% DF17 plus every
    other supported downlink format — DF11 (PI, clean-syndrome
    acceptance), DF0/4/5 (56-bit length dispatch + AP-overlay address
    recovery), DF16/20/21/24 (112-bit AP-overlay) — so the bench
    exercises the slicer's DF->length dispatch and per-DF CRC acceptance
    on the real chip, like the reference's de-facto mixed-traffic replay
    (SURVEY §4; lib/slicer_impl.cc:~120 DF dispatch)."""
    from .fieldcodes import encode_alt_q
    rng = np.random.default_rng(seed + 7)
    df17 = random_df17_frames(n, seed=seed)

    def rbits(b: int) -> int:
        # rng.integers caps at int64; compose wide MB/MV/MD fields
        v = 0
        for _ in range(0, b, 32):
            v = (v << 32) | int(rng.integers(0, 1 << 32))
        return v & ((1 << b) - 1)

    out: List[Tuple[int, int]] = []
    for i in range(n):
        icao = int(rng.integers(0, 1 << 24))
        ac13 = encode_alt_q(float(rng.integers(40, 1600) * 25))
        id13 = int(rng.integers(0, 1 << 13)) & 0x1FBF   # X bit clear
        # (bit 7-of-13; the old 0x1F7F cleared A4 instead, silently
        # restricting squawk digit A to 0-3)
        k = i % 10
        if k < 6:
            out.append(df17[i])
        elif k == 6:
            out.append((df11_frame(icao, interrogator=int(
                rng.integers(0, 16))), SHORT_FRAME_BITS))
        elif k == 7:
            out.append((df4_frame(icao, ac13), SHORT_FRAME_BITS)
                       if i % 20 == 7 else
                       (df0_frame(icao, ac13), SHORT_FRAME_BITS))
        elif k == 8:
            out.append((df5_frame(icao, id13), SHORT_FRAME_BITS)
                       if i % 20 == 8 else
                       (df16_frame(icao, ac13,
                                   mv=rbits(56)),
                        MAX_FRAME_BITS))
        else:
            r = i % 30
            if r == 9:
                out.append((df20_frame(icao, ac13,
                                       mb=rbits(56)),
                            MAX_FRAME_BITS))
            elif r == 19:
                out.append((df21_frame(icao, id13,
                                       mb=rbits(56)),
                            MAX_FRAME_BITS))
            else:
                out.append((df24_frame(icao, int(rng.integers(0, 16)),
                                       rbits(80)),
                            MAX_FRAME_BITS))
    return out


def random_df17_frames(n: int, seed: int = 0) -> List[Tuple[int, int]]:
    """n random-but-valid DF17 airborne-position/ident/velocity frames."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        icao = int(rng.integers(0, 1 << 24))
        kind = i % 3
        if kind == 0:
            me = me_airborne_position(
                alt_ft=float(rng.integers(1000, 40000)),
                lat=float(rng.uniform(-60, 60)),
                lon=float(rng.uniform(-170, 170)),
                odd=bool(rng.integers(0, 2)))
        elif kind == 1:
            cs = "".join(chr(ord("A") + int(c)) for c in rng.integers(0, 26, size=6))
            me = me_identification(cs)
        else:
            me = me_velocity(float(rng.uniform(80, 500)),
                             float(rng.uniform(0, 360)),
                             float(rng.uniform(-3000, 3000)))
        out.append((df17_frame(icao, me), MAX_FRAME_BITS))
    return out
