# Frozen copy of the field encoders that the frozen encoder uses, from
# airmodes_torch/decode/altitude.py, decode/cpr.py, decode/fields.py and
# decode/elm.py at commit 8b1fb463eba6: part of the benchmark's yardstick,
# which later changes to the program leave as it is. Only the encoders
# were kept; the decoders are not part of the benchmark.
"""Field encoders of the generator's frames: altitude (Q bit), CPR
position, squawk, and the ELM segment sizes."""

from __future__ import annotations

import math
from typing import Tuple

_Q_BIT = 0x0010   # bit 4 of the 13-bit AC field

NZ = 15
NBITS = 17
SCALE = float(1 << NBITS)

SEGMENT_BYTES = 10          # 80-bit MD field
MAX_SEGMENTS = 16           # 4-bit ND


def encode_alt_q(alt_ft: float, bit13: bool = True) -> int:
    """Encode altitude with the Q bit (25 ft resolution)."""
    n = int(round((alt_ft + 1000) / 25))
    if not 0 <= n < (1 << 11):
        raise ValueError(f"altitude {alt_ft} out of Q-bit range")
    alt13 = ((n & 0x7E0) << 2) | ((n & 0x010) << 1) | (n & 0x00F) | _Q_BIT
    if bit13:
        return alt13
    return ((alt13 & 0x1F80) >> 1) | (alt13 & 0x3F)


def encode_alt_12bit(alt_ft: float) -> int:
    """12-bit AC field for DF17 BDS0,5 golden frames."""
    return encode_alt_q(alt_ft, bit13=False)


def nl(declat: float) -> int:
    """Number of longitude zones at a given latitude (closed form)."""
    if abs(declat) >= 87.0:
        return 2 if abs(declat) == 87.0 else 1
    if declat == 0.0:
        return 59
    a = 1 - math.cos(math.pi / (2 * NZ))
    b = math.cos(math.pi / 180.0 * abs(declat)) ** 2
    return int(math.floor(2 * math.pi / math.acos(1 - a / b)))


def _dlat(odd: bool, surface: bool) -> float:
    span = 90.0 if surface else 360.0
    return span / (4 * NZ - (1 if odd else 0))


def _dlon(declat: float, odd: bool, surface: bool) -> float:
    span = 90.0 if surface else 360.0
    n = max(nl(declat) - (1 if odd else 0), 1)
    return span / n


def cpr_mod(a: float, b: float) -> float:
    return a - b * math.floor(a / b)


def cpr_encode(lat: float, lon: float, odd: bool, surface: bool) -> Tuple[int, int]:
    """Encode lat/lon into 17-bit CPR YZ, XZ (ref: cpr.py cpr_encode)."""
    dlat = _dlat(odd, surface)
    yz = math.floor(SCALE * cpr_mod(lat, dlat) / dlat + 0.5)
    rlat = dlat * (yz / SCALE + math.floor(lat / dlat))
    dlon = _dlon(rlat, odd, surface)
    xz = math.floor(SCALE * cpr_mod(lon, dlon) / dlon + 0.5)
    return int(yz) & 0x1FFFF, int(xz) & 0x1FFFF


def encode_squawk(code: int) -> int:
    """Inverse of decode_squawk (testing)."""
    a, b, c, d = (code // 1000) % 10, (code // 100) % 10, (code // 10) % 10, code % 10
    id13 = 0
    for v, positions in ((a, (11, 9, 7)), (b, (5, 3, 1)), (c, (12, 10, 8)),
                         (d, (4, 2, 0))):
        for i, p in enumerate(positions):
            id13 |= ((v >> i) & 1) << p
    return id13
