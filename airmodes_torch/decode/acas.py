"""ACAS coordination decode: the MV field of DF16 long air-air replies.

Beyond the reference (gr-air-modes parses DF16 only for VS/altitude and
carries MV raw): when MV's VDS is 3,0 it holds the aircraft's ACTIVE
RESOLUTION ADVISORY — what TCAS is telling the crew to do right now —
per ICAO Annex 10 Vol IV (same register as Comm-B BDS3,0):

    [vds:8 = 0x30][ara:14][rac:4][rat:1][mte:1][tti:2][tid:26]
"""

from __future__ import annotations

from typing import Dict, Optional

from .fields import data_field

MV_BDS30 = [("vds", 8), ("ara", 14), ("rac", 4), ("rat", 1), ("mte", 1),
            ("tti", 2), ("tid", 26)]

_ARA_FLAGS = (  # ARA bits 2..7 (MSB first); ARA bit 1 is the RA-active /
    # single-threat indicator — descriptor flags are only meaningful when
    # it is set (Annex 10 Vol IV: bits 42-47 of the register)
    ("corrective", "RA is corrective (else preventive)"),
    ("downward_sense", "downward sense"),
    ("increased_rate", "increased rate"),
    ("sense_reversal", "sense reversal"),
    ("altitude_crossing", "altitude crossing"),
    ("positive", "positive (else vertical speed limit)"),
)

_RAC_FLAGS = (  # RAC bits 1..4 (MSB first): complements received
    "do_not_pass_below", "do_not_pass_above",
    "do_not_turn_left", "do_not_turn_right",
)


def decode_mv(mv: int) -> Optional[Dict]:
    """DF16 MV field -> active-RA report, or None when VDS != 3,0 or no RA
    is active (all-zero ARA/RAC with RAT clear)."""
    r = data_field(mv, 56, MV_BDS30)
    if r["vds"] != 0x30:
        return None
    return decode_ra(r["ara"], r["rac"], r["rat"], r["mte"], r["tti"],
                     r["tid"])


def decode_ra(ara: int, rac: int, rat: int, mte: int, tti: int,
              tid: int, bds: str = "3,0") -> Optional[Dict]:
    """Shared RA-field decode: used for BDS3,0 (DF16 MV / Comm-B) and the
    identical payload of the DF17 TC28 subtype-2 RA broadcast (BDS6,1).
    `bds` labels the CARRYING register in the returned dict (pass "6,1"
    for the TC28/2 broadcast so consumers keying on acas_ra["bds"] see the
    actual source). Returns None when no RA is active (all-zero ARA/RAC
    with RAT clear)."""
    if ara == 0 and rac == 0 and not rat:
        return None
    out: Dict = {"bds": bds}
    # ARA bit 1 (MSB): one RA is active and bits 2-7 describe it; with
    # bit 1 clear and MTE set, bits 2-7 carry the multi-threat encoding
    # instead — don't misread those as sense flags
    out["ra_active"] = bool((ara >> 13) & 1)
    if out["ra_active"]:
        for i, (key, _) in enumerate(_ARA_FLAGS):
            out[key] = bool((ara >> (12 - i)) & 1)
    complements = [name for i, name in enumerate(_RAC_FLAGS)
                   if (rac >> (3 - i)) & 1]
    if complements:
        out["complements"] = complements
    out["ra_terminated"] = bool(rat)
    out["multiple_threats"] = bool(mte)
    if tti == 1:
        out["threat_icao"] = tid >> 2      # top 24 bits of TID
    return out


def summarize(ra: Dict) -> str:
    """Short human-readable RA line (console output)."""
    bits = []
    if ra.get("ra_terminated"):
        bits.append("RA terminated")
    elif ra.get("ra_active"):
        sense = "descend" if ra.get("downward_sense") else "climb"
        kind = "corrective" if ra.get("corrective") else "preventive"
        bits.append(f"{kind} {sense}" if ra.get("positive")
                    else f"{kind} limit-{sense}")
        if ra.get("increased_rate"):
            bits.append("increase rate")
        if ra.get("sense_reversal"):
            bits.append("reversal")
        if ra.get("altitude_crossing"):
            bits.append("crossing")
    elif ra.get("multiple_threats"):
        bits.append("RA (multi-threat encoding)")
    else:
        # complements-only coordination reports (ARA inactive) carry
        # their content in the complement line appended below (
        # the old branch mislabeled them multi-threat; the
        # first fix then printed the complement list twice)
        bits.append("RA")
    if ra.get("complements"):
        bits.append("complement " + "+".join(ra["complements"]))
    if ra.get("multiple_threats") and (ra.get("ra_active")
                                       or ra.get("ra_terminated")):
        bits.append("multi-threat")
    if "threat_icao" in ra:
        bits.append(f"threat {ra['threat_icao']:06x}")
    return ", ".join(bits)
