"""Altitude field decoding (ref: gr-air-modes python/altitude.py).

13-bit AC field (DF0/4/16/20), transmitted bit order MSB->LSB:
    C1 A1 C2 A2 C4 A4 M B1 Q B2 D2 B4 D4
- M bit set   -> metric altitude, unsupported (raises MetricAltError)
- Q bit set   -> 25 ft resolution: alt = 25 * N - 1000 where N is the
                 11-bit value left after removing M and Q
- else        -> Gillham gray code in 100 ft increments

The 12-bit AC of DF17 BDS0,5 is the same field minus the M bit
(`decode_alt(alt, bit13=False)` inserts a zero M bit first).
"""

from __future__ import annotations

from ..exceptions import MetricAltError, ParserError

_M_BIT = 0x0040   # bit 6 of the 13-bit field
_Q_BIT = 0x0010   # bit 4


def gray2bin(g: int) -> int:
    b = g
    while g:
        g >>= 1
        b ^= g
    return b


def _insert_m_bit(alt12: int) -> int:
    """12-bit AC (no M bit) -> 13-bit AC with M = 0."""
    return ((alt12 & 0xFC0) << 1) | (alt12 & 0x03F)


def decode_alt(alt: int, bit13: bool = True) -> int:
    """Decode a 13-bit (or 12-bit when bit13=False) AC field to feet."""
    if not bit13:
        alt = _insert_m_bit(alt & 0xFFF)
    alt &= 0x1FFF
    if alt & _M_BIT:
        raise MetricAltError()
    if alt & _Q_BIT:
        # strip M (bit 6) and Q (bit 4) -> 11-bit count of 25 ft
        n = ((alt & 0x1F80) >> 2) | ((alt & 0x0020) >> 1) | (alt & 0x000F)
        return 25 * n - 1000
    # Gillham gray code. Bit positions (12 = MSB = C1):
    # C1=12 A1=11 C2=10 A2=9 C4=8 A4=7 M=6 B1=5 Q(D1)=4 B2=3 D2=2 B4=1 D4=0
    def bit(p):
        return (alt >> p) & 1
    # 500 ft gray code, MSB->LSB: D2 D4 A1 A2 A4 B1 B2 B4
    g500 = (bit(2) << 7 | bit(0) << 6 | bit(11) << 5 | bit(9) << 4 |
            bit(7) << 3 | bit(5) << 2 | bit(3) << 1 | bit(1))
    n500 = gray2bin(g500)
    # 100 ft sub-code, MSB->LSB: C1 C2 C4
    g100 = bit(12) << 2 | bit(10) << 1 | bit(8)
    n100 = gray2bin(g100)
    if n100 in (0, 5, 6):
        raise ParserError(f"invalid Gillham 100ft code {g100:03b}")
    if n100 == 7:
        n100 = 5
    if n500 % 2:
        n100 = 6 - n100
    return n500 * 500 + n100 * 100 - 1300


# --- encoder-side helpers (testing/golden captures) ---------------------------

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


def encode_alt_gillham(alt_ft: float) -> int:
    """Encode altitude as 13-bit Gillham gray code (100 ft increments)."""
    if not -1200.0 <= alt_ft <= 126700.0:
        # beyond the 8-bit 500-ft gray field: bits silently dropped and
        # the frame round-trips to a DIFFERENT altitude
        # (encode_alt_q validates identically)
        raise ValueError(f"altitude {alt_ft} outside Gillham range "
                         "[-1200, 126700] ft")
    def bin2gray(b: int) -> int:
        return b ^ (b >> 1)
    total = int(round((alt_ft + 1300) / 100))
    n500 = (total - 1) // 5
    n100 = total - 5 * n500  # 1..5
    if n500 % 2:
        n100 = 6 - n100
    if n100 == 5:
        n100 = 7
    g500 = bin2gray(n500)
    g100 = bin2gray(n100)
    def sb(v, p, q):  # bit p of v shifted to position q
        return ((v >> p) & 1) << q
    alt = 0
    # g500 MSB->LSB: D2 D4 A1 A2 A4 B1 B2 B4
    alt |= sb(g500, 7, 2) | sb(g500, 6, 0) | sb(g500, 5, 11)
    alt |= sb(g500, 4, 9) | sb(g500, 3, 7) | sb(g500, 2, 5)
    alt |= sb(g500, 1, 3) | sb(g500, 0, 1)
    alt |= sb(g100, 2, 12) | sb(g100, 1, 10) | sb(g100, 0, 8)
    return alt


def decode_alt_gnss12(alt12: int) -> int:
    """TC20-22 12-bit altitude field: GNSS height above ellipsoid, in
    feet. The field re-uses the 12-bit AC altitude ENCODING (25-ft
    Q-bit / Gillham); only the SEMANTIC changes from barometric to
    geometric — the reading dump1090-fa/readsb implement
    (decodeAC12Field -> altitude_geom). The other published reading
    (pyModeS / the-1090MHz-riddle: raw meters) caps at 4095 m, which
    cannot represent en-route traffic, so the AC12 reading is used here.
    One shared decode for the parser and the mlat altitude constraint."""
    return decode_alt(alt12, bit13=False)
