"""Generic big-endian bitfield extraction + Mode S reply layouts.

Mirrors the reference's python/parse.py `data_field` / `modes_reply` /
`me_reply` design: a packet is a big integer; each downlink format (or
DF17 ME format type code) declares an ordered list of (name, width)
fields, extracted MSB-first.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from ..exceptions import FieldNotInPacket, NoHandlerError, ParserError

FieldSpec = Sequence[Tuple[str, int]]


class data_field:
    """Big-endian bitfield extractor over an int payload of known width."""

    def __init__(self, data: int, nbits: int, layout: FieldSpec):
        self.data = data
        self.nbits = nbits
        self._fields: Dict[str, Tuple[int, int]] = {}
        pos = 0
        for name, width in layout:
            if not name.startswith("_"):
                self._fields[name] = (pos, width)
            pos += width
        if pos != nbits:
            # ParserError (an ADSBError), NOT ValueError: packets come off
            # the wire, and every consumer loop catches ADSBError to drop
            # bad messages — a 56-bit frame whose DF demands a 112-bit
            # layout must not crash the output stage (drop-and-continue)
            raise ParserError(
                f"layout covers {pos} bits, packet has {nbits}")

    def __contains__(self, name: str) -> bool:
        return name in self._fields

    def __getitem__(self, name: str) -> int:
        if name not in self._fields:
            raise FieldNotInPacket(name)
        start, width = self._fields[name]
        return (self.data >> (self.nbits - start - width)) & ((1 << width) - 1)

    def fields(self) -> List[str]:
        return list(self._fields)


# --- downlink format layouts (ref: parse.py modes_reply.types) ----------------

MODES_LAYOUTS: Dict[int, FieldSpec] = {
    0:  [("df", 5), ("vs", 1), ("cc", 1), ("_1", 1), ("sl", 3), ("_2", 2),
         ("ri", 4), ("_3", 2), ("ac", 13), ("ap", 24)],
    4:  [("df", 5), ("fs", 3), ("dr", 5), ("um", 6), ("ac", 13), ("ap", 24)],
    5:  [("df", 5), ("fs", 3), ("dr", 5), ("um", 6), ("id", 13), ("ap", 24)],
    11: [("df", 5), ("ca", 3), ("aa", 24), ("pi", 24)],
    16: [("df", 5), ("vs", 1), ("_1", 2), ("sl", 3), ("_2", 2), ("ri", 4),
         ("_3", 2), ("ac", 13), ("mv", 56), ("ap", 24)],
    17: [("df", 5), ("ca", 3), ("aa", 24), ("me", 56), ("pi", 24)],
    18: [("df", 5), ("cf", 3), ("aa", 24), ("me", 56), ("pi", 24)],
    20: [("df", 5), ("fs", 3), ("dr", 5), ("um", 6), ("ac", 13), ("mb", 56),
         ("ap", 24)],
    21: [("df", 5), ("fs", 3), ("dr", 5), ("um", 6), ("id", 13), ("mb", 56),
         ("ap", 24)],
    24: [("df", 2), ("_1", 1), ("ke", 1), ("nd", 4), ("md", 80), ("ap", 24)],
}


def modes_reply(data: int, nbits: int) -> data_field:
    df = data >> (nbits - 5)
    if df >= 24:
        df = 24
    if df not in MODES_LAYOUTS:
        raise NoHandlerError(df)
    return data_field(data, nbits, MODES_LAYOUTS[df])


# --- DF17 ME field layouts keyed by format type code (BDS registers) ----------

ME_IDENT: FieldSpec = [("ftc", 5), ("cat", 3), ("ident", 48)]                      # BDS0,8
ME_SURFACE_POS: FieldSpec = [("ftc", 5), ("mov", 7), ("gts", 1), ("gtk", 7),       # BDS0,6
                             ("time", 1), ("cpr_format", 1),
                             ("encoded_lat", 17), ("encoded_lon", 17)]
ME_AIRBORNE_POS: FieldSpec = [("ftc", 5), ("ss", 2), ("nicsb", 1), ("alt", 12),    # BDS0,5
                              ("time", 1), ("cpr_format", 1),
                              ("encoded_lat", 17), ("encoded_lon", 17)]
ME_VELOCITY_GS: FieldSpec = [("ftc", 5), ("sub", 3), ("ic", 1), ("ifr", 1),        # BDS0,9 st1/2
                             ("nuc", 3), ("s_ew", 1), ("v_ew", 10), ("s_ns", 1),
                             ("v_ns", 10), ("vrsrc", 1), ("s_vr", 1), ("vr", 9),
                             ("_1", 2), ("s_dif", 1), ("dif", 7)]
ME_VELOCITY_AS: FieldSpec = [("ftc", 5), ("sub", 3), ("ic", 1), ("ifr", 1),        # BDS0,9 st3/4
                             ("nuc", 3), ("shdg", 1), ("hdg", 10), ("ast", 1),
                             ("as_", 10), ("vrsrc", 1), ("s_vr", 1), ("vr", 9),
                             ("_1", 2), ("s_dif", 1), ("dif", 7)]
ME_STATUS_EMERG: FieldSpec = [("ftc", 5), ("sub", 3), ("es", 3),                    # BDS6,1 st1
                              ("mode_a", 13), ("_1", 32)]
ME_STATUS_RA: FieldSpec = [("ftc", 5), ("sub", 3), ("ara", 14), ("rac", 4),         # BDS6,1 st2
                           ("rat", 1), ("mte", 1), ("tti", 2), ("tid", 26)]
ME_TARGET_STATE: FieldSpec = [("ftc", 5), ("sub", 2), ("sil_sup", 1),               # BDS6,2 st1
                              ("sel_alt_type", 1), ("sel_alt", 11), ("baro", 9),
                              ("shdg", 1), ("hdg_sign", 1), ("hdg", 8),
                              ("nacp", 4), ("nic_baro", 1), ("sil", 2),
                              ("mode_status", 1), ("autopilot", 1), ("vnav", 1),
                              ("alt_hold", 1), ("_1", 1), ("approach", 1),
                              ("tcas_op", 1), ("lnav", 1), ("_2", 2)]
ME_OP_STATUS_AIR: FieldSpec = [("ftc", 5), ("sub", 3), ("cc", 16), ("om", 16),      # BDS6,5 st0
                               ("ver", 3), ("nic_sup_a", 1), ("nacp", 4),
                               ("gva", 2), ("sil", 2), ("nic_baro", 1),
                               ("hrd", 1), ("sil_sup", 1), ("_1", 1)]
ME_OP_STATUS_SURF: FieldSpec = [("ftc", 5), ("sub", 3), ("cc", 12), ("lw", 4),      # BDS6,5 st1
                                ("om", 16), ("ver", 3), ("nic_sup_a", 1),
                                ("nacp", 4), ("_1", 2), ("sil", 2),
                                ("trk_hdg", 1), ("hrd", 1), ("sil_sup", 1),
                                ("_2", 1)]
# Known TC but reserved/undecodable subtype: carried raw so downstream
# counters distinguish "reserved" from "unknown TC" (the reference carries
# MB/MV raw the same way). `sub` width matches the TC's subtype field.
ME_RESERVED_SUB3: FieldSpec = [("ftc", 5), ("sub", 3), ("raw", 48)]
ME_RESERVED_SUB2: FieldSpec = [("ftc", 5), ("sub", 2), ("raw", 49)]


def me_reply(me: int) -> data_field:
    """Dispatch a 56-bit ME field by its format type code."""
    ftc = me >> 51
    if 1 <= ftc <= 4:
        layout = ME_IDENT
    elif 5 <= ftc <= 8:
        layout = ME_SURFACE_POS
    elif ftc == 0 or (9 <= ftc <= 18) or (20 <= ftc <= 22):
        # TC0: airborne position with no position information — same layout,
        # lat/lon fields are meaningless but the altitude is valid
        layout = ME_AIRBORNE_POS
    elif ftc == 19:
        sub = (me >> 48) & 0x7
        if sub in (1, 2):
            layout = ME_VELOCITY_GS
        elif sub in (3, 4):
            layout = ME_VELOCITY_AS
        else:
            # subtypes 0, 5-7 are reserved (DO-260B 2.2.3.2.6): their bits
            # have no defined meaning, so carry raw rather than minting
            # vertical rates / GNSS-baro diffs from undefined fields
            layout = ME_RESERVED_SUB3
    elif ftc == 28:
        sub = (me >> 48) & 0x7
        if sub == 1:
            layout = ME_STATUS_EMERG
        elif sub == 2:
            layout = ME_STATUS_RA
        else:
            layout = ME_RESERVED_SUB3
    elif ftc == 29:
        # only DO-260B subtype 1 (target state and status) is decodable;
        # DO-260A subtype 0 is carried raw rather than dropped
        layout = (ME_TARGET_STATE if (me >> 49) & 0x3 == 1
                  else ME_RESERVED_SUB2)
    elif ftc == 31:
        sub = (me >> 48) & 0x7
        if sub == 0:
            layout = ME_OP_STATUS_AIR
        elif sub == 1:
            layout = ME_OP_STATUS_SURF
        else:
            # reserved subtype: carried raw like TC28/29 reserved subtypes,
            # so a future-version operational-status frame counts as
            # "reserved", not "unknown TC" (it used to NoHandlerError here)
            layout = ME_RESERVED_SUB3
    else:
        raise NoHandlerError(ftc)
    return data_field(me, 56, layout)


def decode_squawk(id13: int) -> int:
    """Decode the 13-bit identity field to a 4-digit octal squawk code.

    Transmitted bit order MSB->LSB: C1 A1 C2 A2 C4 A4 X B1 D1 B2 D2 B4 D4
    (ref: parse.py DF5/21 squawk decode).
    """
    def bit(p):
        return (id13 >> p) & 1
    a = bit(11) | bit(9) << 1 | bit(7) << 2
    b = bit(5) | bit(3) << 1 | bit(1) << 2
    c = bit(12) | bit(10) << 1 | bit(8) << 2
    d = bit(4) | bit(2) << 1 | bit(0) << 2
    return a * 1000 + b * 100 + c * 10 + d


def encode_squawk(code: int) -> int:
    """Inverse of decode_squawk (testing)."""
    a, b, c, d = (code // 1000) % 10, (code // 100) % 10, (code // 10) % 10, code % 10
    id13 = 0
    for v, positions in ((a, (11, 9, 7)), (b, (5, 3, 1)), (c, (12, 10, 8)),
                         (d, (4, 2, 0))):
        for i, p in enumerate(positions):
            id13 |= ((v >> i) & 1) << p
    return id13


def decode_callsign(ident48: int) -> str:
    """8 x 6-bit characters via the DF17 charmap (ref: parse.py charmap)."""
    from ..constants import CALLSIGN_CHARMAP
    chars = []
    for i in range(8):
        code = (ident48 >> (42 - 6 * i)) & 0x3F
        chars.append(CALLSIGN_CHARMAP[code])
    return "".join(chars).rstrip("_").replace("_", " ")
