"""Comm-B (DF20/21 MB field) BDS register inference and decoding.

The reference carries the 56-bit MB payload raw and never decodes it
(gr-air-modes python/parse.py:~parse20 keeps only the AC/ID fields) — this
module goes beyond parity: it identifies which BDS register a Comm-B reply
most plausibly carries and decodes the common airborne registers, the way
operational Mode S EHS pipelines do.

Registers (layouts per ICAO Annex 10 Vol III / Doc 9871):

- BDS1,0  data link capability report
- BDS1,7  common usage GICB capability report
- BDS2,0  aircraft identification (callsign)
- BDS4,0  selected vertical intention (MCP/FMS altitude, baro setting)
- BDS4,4  meteorological routine air report (wind, temp, pressure, humidity)
- BDS4,5  meteorological hazard report (turbulence/wind shear/microburst/
          icing/wake vortex levels, SAT, static pressure, radio height)
- BDS5,0  track and turn report (roll, track, GS, track rate, TAS)
- BDS6,0  heading and speed report (heading, IAS, Mach, vertical rates)

Unlike DF17, a Comm-B reply does not name its register: the ground
interrogator asked for it and knows. A passive receiver must infer it from
internal consistency (a status bit of 0 forces its value bits to 0,
reserved bits must be 0) and physical plausibility (|roll| < 50 deg,
IAS < 500 kt, ...). `infer(mb)` returns every register the payload is
consistent with; `decode(mb)` decodes only when the inference is UNIQUE —
reported as e.g. ``("BDS5,0", {...})`` — so a field is never attached to a
report under the wrong register.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .fields import data_field

# --- layouts -------------------------------------------------------------------

BDS20 = [("bds", 8), ("cs", 48)]

BDS40 = [("mcp_status", 1), ("mcp_alt", 12),
         ("fms_status", 1), ("fms_alt", 12),
         ("baro_status", 1), ("baro", 12),
         ("r1", 8),
         ("mode_status", 1), ("vnav", 1), ("alt_hold", 1), ("approach", 1),
         ("r2", 2),
         ("tgt_status", 1), ("tgt_source", 2)]

BDS50 = [("roll_status", 1), ("roll_sign", 1), ("roll", 9),
         ("trk_status", 1), ("trk_sign", 1), ("trk", 10),
         ("gs_status", 1), ("gs", 10),
         ("tr_status", 1), ("tr_sign", 1), ("tr", 9),
         ("tas_status", 1), ("tas", 10)]

BDS60 = [("hdg_status", 1), ("hdg_sign", 1), ("hdg", 10),
         ("ias_status", 1), ("ias", 10),
         ("mach_status", 1), ("mach", 10),
         ("vrb_status", 1), ("vrb_sign", 1), ("vrb", 9),
         ("vri_status", 1), ("vri_sign", 1), ("vri", 9)]

HAZARD_LEVELS = ("nil", "light", "moderate", "severe")

# BDS4,5: five 2-bit hazard reports, SAT, static pressure, radio height
BDS45 = [("turb_status", 1), ("turb", 2),
         ("ws_status", 1), ("ws", 2),
         ("mb_status", 1), ("mb", 2),
         ("ice_status", 1), ("ice", 2),
         ("wake_status", 1), ("wake", 2),
         ("temp_status", 1), ("temp_sign", 1), ("temp", 9),
         ("press_status", 1), ("press", 11),
         ("rh_status", 1), ("rh", 12),
         ("r1", 5)]

BDS44 = [("fom", 4),
         ("wind_status", 1), ("wind_speed", 9), ("wind_dir", 9),
         ("temp_sign", 1), ("temp", 10),
         ("press_status", 1), ("press", 11),
         ("turb_status", 1), ("turb", 2),
         ("hum_status", 1), ("hum", 6)]

# BDS1,7: one capability flag per common-usage GICB service, bits 1..24;
# bits 25..56 are reserved (zero).
BDS17_SERVICES = ("0,5", "0,6", "0,7", "0,8", "0,9", "0,A",
                  "2,0", "2,1", "4,0", "4,1", "4,2", "4,3", "4,4", "4,5",
                  "4,8", "5,0", "5,1", "5,2", "5,3", "5,4", "5,5", "5,6",
                  "5,F", "6,0")


def _f(mb: int, layout) -> data_field:
    return data_field(mb, 56, layout)


def _signed(sign: int, value: int, bits: int) -> int:
    """Two's-complement combine of a sign bit + `bits` value bits."""
    return value - (1 << bits) if sign else value


def _status_ok(r: data_field, status: str, *values: str) -> bool:
    """Status bit 0 forces all its value (and sign) bits to 0."""
    if r[status]:
        return True
    return all(r[v] == 0 for v in values)


# --- per-register consistency probes -------------------------------------------

def is_bds10(mb: int) -> bool:
    # first byte names the register; bits 10..14 reserved
    return (mb >> 48) == 0x10 and (mb >> 42) & 0x1F == 0


def is_bds17(mb: int) -> bool:
    if mb & ((1 << 32) - 1):            # bits 25..56 reserved
        return False
    flags = mb >> 32
    if flags == 0:
        return False
    return bool((flags >> 17) & 1)      # BDS2,0 capability: required of all


def is_bds20(mb: int) -> bool:
    if _f(mb, BDS20)["bds"] != 0x20:
        return False
    cs = decode_bds20(mb)["callsign_raw"]
    if "#" in cs:
        return False
    # valid idents are left-aligned with only TRAILING spaces; interior
    # gaps mark some other register's payload that happens to start 0x20
    body = cs.rstrip("_")
    return body != "" and "_" not in body


def is_bds40(mb: int) -> bool:
    r = _f(mb, BDS40)
    if r["r1"] or r["r2"]:
        return False
    return (_status_ok(r, "mcp_status", "mcp_alt")
            and _status_ok(r, "fms_status", "fms_alt")
            and _status_ok(r, "baro_status", "baro")
            and _status_ok(r, "mode_status", "vnav", "alt_hold", "approach")
            and _status_ok(r, "tgt_status", "tgt_source"))


def is_bds50(mb: int) -> bool:
    r = _f(mb, BDS50)
    if not (_status_ok(r, "roll_status", "roll_sign", "roll")
            and _status_ok(r, "trk_status", "trk_sign", "trk")
            and _status_ok(r, "gs_status", "gs")
            and _status_ok(r, "tr_status", "tr_sign", "tr")
            and _status_ok(r, "tas_status", "tas")):
        return False
    if r["roll_status"]:
        if abs(_signed(r["roll_sign"], r["roll"], 9) * 45.0 / 256.0) > 50.0:
            return False
    # plausibility bounds sized to real traffic extremes: revenue flights
    # have recorded ~800 kt GS in strong jetstreams, TAS tops out around
    # Mach 0.92 (~600 kt), and |GS - TAS| is the along-track wind
    # (record jetstream ~230 kt)
    gs = r["gs"] * 2.0 if r["gs_status"] else None
    tas = r["tas"] * 2.0 if r["tas_status"] else None
    if gs is not None and gs > 800.0:
        return False
    if tas is not None and not (80.0 <= tas <= 600.0):
        return False
    if gs is not None and tas is not None and abs(gs - tas) > 250.0:
        return False
    return True


def is_bds44(mb: int) -> bool:
    r = _f(mb, BDS44)
    if not (_status_ok(r, "wind_status", "wind_speed", "wind_dir")
            and _status_ok(r, "press_status", "press")
            and _status_ok(r, "turb_status", "turb")
            and _status_ok(r, "hum_status", "hum")):
        return False
    if not r["wind_status"]:
        return False                    # MRAR without wind is not in use
    if r["wind_speed"] > 250:
        return False
    temp = _signed(r["temp_sign"], r["temp"], 10) * 0.25
    if not (-80.0 <= temp <= 60.0):
        return False
    # MRAR carries the static pressure AT ALTITUDE: ~150 hPa at FL450 up
    # to ~1050 at sea level (a QNH-style 800+ bound would reject every
    # at-cruise report)
    if r["press_status"] and not (100 <= r["press"] <= 1100):
        return False
    if r["hum_status"] and r["hum"] * 100.0 / 64.0 > 100.0:
        return False
    return True


def is_bds45(mb: int) -> bool:
    r = _f(mb, BDS45)
    if r["r1"]:
        return False
    if not (_status_ok(r, "turb_status", "turb")
            and _status_ok(r, "ws_status", "ws")
            and _status_ok(r, "mb_status", "mb")
            and _status_ok(r, "ice_status", "ice")
            and _status_ok(r, "wake_status", "wake")
            and _status_ok(r, "temp_status", "temp_sign", "temp")
            and _status_ok(r, "press_status", "press")
            and _status_ok(r, "rh_status", "rh")):
        return False
    if not r["temp_status"]:
        return False                    # MHR without SAT is not in use
    # require pressure or radio height too: a BDS1,7 capability set with
    # "5,0" advertised (very common) mimics SAT+hazards with its low 32
    # bits zero, which would make every such 1,7 ambiguous; real MHR
    # carries at least one of these alongside SAT
    if not (r["press_status"] or r["rh_status"]):
        return False
    temp = _signed(r["temp_sign"], r["temp"], 9) * 0.25
    if not (-80.0 <= temp <= 60.0):
        return False
    # static pressure at altitude runs ~150 hPa (FL450) to ~1050 at sea level
    if r["press_status"] and not (100 <= r["press"] <= 1100):
        return False
    return True


def is_bds60(mb: int) -> bool:
    r = _f(mb, BDS60)
    if not (_status_ok(r, "hdg_status", "hdg_sign", "hdg")
            and _status_ok(r, "ias_status", "ias")
            and _status_ok(r, "mach_status", "mach")
            and _status_ok(r, "vrb_status", "vrb_sign", "vrb")
            and _status_ok(r, "vri_status", "vri_sign", "vri")):
        return False
    if r["ias_status"] and not (50.0 <= r["ias"] <= 500.0):
        return False
    if r["mach_status"] and not (0.1 <= r["mach"] * 0.004 <= 1.0):
        return False
    for st, sg, v in (("vrb_status", "vrb_sign", "vrb"),
                      ("vri_status", "vri_sign", "vri")):
        if r[st] and abs(_signed(r[sg], r[v], 9) * 32.0) > 6000.0:
            return False
    return True


# --- decoders -------------------------------------------------------------------

def decode_bds10(mb: int) -> Dict:
    return {"bds": "1,0",
            "continuation": bool((mb >> 47) & 1),
            "overlay_capability": bool((mb >> 41) & 1)}


def decode_bds17(mb: int) -> Dict:
    flags = mb >> 32
    services = [s for i, s in enumerate(BDS17_SERVICES)
                if (flags >> (23 - i)) & 1]
    return {"bds": "1,7", "gicb_services": services}


def decode_bds20(mb: int) -> Dict:
    from .fields import decode_callsign
    from ..constants import CALLSIGN_CHARMAP
    cs48 = _f(mb, BDS20)["cs"]
    raw = "".join(CALLSIGN_CHARMAP[(cs48 >> (42 - 6 * i)) & 0x3F]
                  for i in range(8))
    return {"bds": "2,0", "callsign": decode_callsign(cs48),
            "callsign_raw": raw}


def decode_bds40(mb: int) -> Dict:
    r = _f(mb, BDS40)
    out: Dict = {"bds": "4,0"}
    if r["mcp_status"]:
        out["mcp_altitude_ft"] = r["mcp_alt"] * 16.0
    if r["fms_status"]:
        out["fms_altitude_ft"] = r["fms_alt"] * 16.0
    if r["baro_status"]:
        out["baro_setting_mb"] = r["baro"] * 0.1 + 800.0
    if r["mode_status"]:
        out["vnav"] = bool(r["vnav"])
        out["alt_hold"] = bool(r["alt_hold"])
        out["approach"] = bool(r["approach"])
    if r["tgt_status"]:
        out["target_alt_source"] = ("unknown", "aircraft_alt",
                                    "fcu_mcp", "fms")[r["tgt_source"]]
    return out


def decode_bds50(mb: int) -> Dict:
    r = _f(mb, BDS50)
    out: Dict = {"bds": "5,0"}
    if r["roll_status"]:
        out["roll_deg"] = _signed(r["roll_sign"], r["roll"], 9) * 45.0 / 256.0
    if r["trk_status"]:
        trk = _signed(r["trk_sign"], r["trk"], 10) * 90.0 / 512.0
        out["track_deg"] = trk % 360.0
    if r["gs_status"]:
        out["groundspeed_kt"] = r["gs"] * 2.0
    if r["tr_status"]:
        out["track_rate_dps"] = _signed(r["tr_sign"], r["tr"], 9) * 8.0 / 256.0
    if r["tas_status"]:
        out["tas_kt"] = r["tas"] * 2.0
    return out


def decode_bds44(mb: int) -> Dict:
    r = _f(mb, BDS44)
    out: Dict = {"bds": "4,4", "fom": r["fom"]}
    if r["wind_status"]:
        out["wind_speed_kt"] = float(r["wind_speed"])
        out["wind_dir_deg"] = r["wind_dir"] * 180.0 / 256.0
    out["temperature_c"] = _signed(r["temp_sign"], r["temp"], 10) * 0.25
    if r["press_status"]:
        out["pressure_hpa"] = float(r["press"])
    if r["turb_status"]:
        out["turbulence"] = HAZARD_LEVELS[r["turb"]]
    if r["hum_status"]:
        out["humidity_pct"] = r["hum"] * 100.0 / 64.0
    return out


def decode_bds45(mb: int) -> Dict:
    r = _f(mb, BDS45)
    out: Dict = {"bds": "4,5"}
    for st, v, key in (("turb_status", "turb", "turbulence"),
                       ("ws_status", "ws", "wind_shear"),
                       ("mb_status", "mb", "microburst"),
                       ("ice_status", "ice", "icing"),
                       ("wake_status", "wake", "wake_vortex")):
        if r[st]:
            out[key] = HAZARD_LEVELS[r[v]]
    out["temperature_c"] = _signed(r["temp_sign"], r["temp"], 9) * 0.25
    if r["press_status"]:
        out["pressure_hpa"] = float(r["press"])
    if r["rh_status"]:
        out["radio_height_ft"] = r["rh"] * 16.0
    return out


def decode_bds60(mb: int) -> Dict:
    r = _f(mb, BDS60)
    out: Dict = {"bds": "6,0"}
    if r["hdg_status"]:
        hdg = _signed(r["hdg_sign"], r["hdg"], 10) * 90.0 / 512.0
        out["mag_heading_deg"] = hdg % 360.0
    if r["ias_status"]:
        out["ias_kt"] = float(r["ias"])
    if r["mach_status"]:
        out["mach"] = r["mach"] * 0.004
    if r["vrb_status"]:
        out["baro_vertical_rate_fpm"] = \
            _signed(r["vrb_sign"], r["vrb"], 9) * 32.0
    if r["vri_status"]:
        out["inertial_vertical_rate_fpm"] = \
            _signed(r["vri_sign"], r["vri"], 9) * 32.0
    return out


_REGISTERS: Tuple[Tuple[str, object, object], ...] = (
    ("BDS1,0", is_bds10, decode_bds10),
    ("BDS1,7", is_bds17, decode_bds17),
    ("BDS2,0", is_bds20, decode_bds20),
    ("BDS4,0", is_bds40, decode_bds40),
    ("BDS4,4", is_bds44, decode_bds44),
    ("BDS4,5", is_bds45, decode_bds45),
    ("BDS5,0", is_bds50, decode_bds50),
    ("BDS6,0", is_bds60, decode_bds60),
)


def infer(mb: int) -> List[str]:
    """Every register the payload is internally consistent with."""
    if mb == 0:
        return []                       # empty MB: consistent with anything
    return [name for name, probe, _ in _REGISTERS if probe(mb)]


def decode(mb: int) -> Optional[Tuple[str, Dict]]:
    """(register name, decoded fields) iff the inference is unique."""
    matches = infer(mb)
    if len(matches) != 1:
        return None
    name = matches[0]
    for reg, _, decoder in _REGISTERS:
        if reg == name:
            return name, decoder(mb)
    return None
