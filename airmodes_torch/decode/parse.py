"""Top-level Mode S message parser (ref: gr-air-modes python/parse.py class parse).

Consumes the slicer's wire string:

    "<df> <hex_frame> <syndrome_hex6> <status> <ref_dbfs> <timestamp>"

re-validates the CRC, dispatches per downlink format, decodes positions via
the stateful CPR decoder and altitudes/squawks/callsigns/velocities, and
returns an `AircraftReport`. Raises subclasses of ADSBError for undecodable
messages — the caller's loop catches and drops (skip-and-continue fault
model, SURVEY.md §5.3).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from .. import crc
from ..constants import (ANON_ICAO_BIT, AP_ADDRESS_DFS, STATUS_FAIL)
from ..exceptions import ADSBError, NoHandlerError, ParserError
from . import acas, commb, elm
from .altitude import decode_alt
from .cpr import cpr_decoder
from .fields import decode_callsign, decode_squawk, me_reply, modes_reply


@dataclasses.dataclass
class AircraftReport:
    df: int
    icao: Optional[int]
    timestamp: float
    ref_dbfs: float
    raw_hex: str
    status: int = 0
    # optional decoded content
    bds: Optional[str] = None
    callsign: Optional[str] = None
    category: Optional[int] = None
    altitude_ft: Optional[int] = None
    squawk: Optional[int] = None
    lat: Optional[float] = None
    lon: Optional[float] = None
    range_nm: Optional[float] = None
    bearing_deg: Optional[float] = None
    speed_kt: Optional[float] = None
    heading_deg: Optional[float] = None
    vertical_rate_fpm: Optional[float] = None
    speed_type: Optional[str] = None     # "GS" | "IAS" | "TAS"
    gnss_baro_diff_ft: Optional[float] = None
    on_surface: bool = False
    flight_status: Optional[int] = None
    capability: Optional[int] = None
    commb: Optional[dict] = None         # decoded Comm-B register (DF20/21)
    acas_ra: Optional[dict] = None       # active RA (DF16 MV or DF17 TC28/2)
    emergency: Optional[str] = None      # TC28/1 emergency/priority state
    tss: Optional[dict] = None           # TC29/1 target state and status
    opstatus: Optional[dict] = None      # TC31 aircraft operational status
    me_raw: Optional[int] = None         # undecoded-but-known ME, carried raw
    address_anon: bool = False           # DF18 CF=1/5: non-ICAO address
    altitude_gnss: bool = False          # altitude_ft is GNSS HAE (TC20-22)
    elm_ke: Optional[int] = None         # DF24 control (0=downlink segment)
    elm_nd: Optional[int] = None         # DF24 segment number
    elm_md: Optional[int] = None         # DF24 80-bit MD payload (raw int)
    elm_data: Optional[bytes] = None     # reassembled Comm-D ELM (decode/elm)
    elm_flushed: Optional[list] = None   # [(icao, bytes)] idle-completed ELMs

    @property
    def icao_hex(self) -> Optional[str]:
        return None if self.icao is None else format_icao(self.icao)


def format_icao(icao: int) -> str:
    """24-bit address -> display hex; anonymous (non-ICAO, DF18 CF=1/5)
    addresses render as "~xxxxxx" (the dump1090/readsb convention)."""
    if icao & ANON_ICAO_BIT:
        return f"~{icao & 0xFFFFFF:06x}"
    return f"{icao:06x}"


class parse:
    """Stateful parser; one instance per receive chain (holds the CPR cache)."""

    def __init__(self, my_position: Optional[Tuple[float, float]] = None,
                 cpr_global_first: bool = False):
        self.my_position = my_position
        self.cpr = cpr_decoder(my_position, global_first=cpr_global_first)
        self.elm = elm.elm_reassembler()
        self._elm_flush_t: Optional[float] = None

    # --- wire format ----------------------------------------------------------

    def parse(self, message: str) -> AircraftReport:
        parts = message.split()
        # >= 6: trailing fields (e.g. the int64-ns timestamp extension)
        # are ignored by the parser but must not reject the message
        if len(parts) < 6:
            raise ParserError(f"malformed slicer message: {message!r}")
        try:
            df = int(parts[0])
            hexframe = parts[1]
            syndrome = int(parts[2], 16)
            status = int(parts[3])
            ref_dbfs = float(parts[4])
            timestamp = float(parts[5])
        except ValueError:
            # non-numeric wire tokens (remote feeds are untrusted): the
            # docstring promises ADSBError subclasses only, and consumer
            # loops catch exactly that to drop-and-continue
            raise ParserError(f"malformed slicer message: {message!r}")
        import math
        if not math.isfinite(timestamp) or not math.isfinite(ref_dbfs):
            # 'nan'/'inf' PARSE as floats but poison every downstream
            # time comparison (NaN ordering is all-False: json_out's
            # write throttle froze forever, eviction heaps corrupt,
            # json.dump emits invalid bare-NaN documents)
            raise ParserError(f"non-finite wire field in {message!r}")
        if status == STATUS_FAIL:
            raise ParserError("uncorrectable frame")

        nbits = len(hexframe) * 4
        if nbits not in (56, 112):
            raise ParserError(f"bad frame length {nbits}")
        try:
            data = int(hexframe, 16)
        except ValueError:
            # the documented contract is ADSBError-only: a non-hex frame
            # token of valid length escaped as plain ValueError and killed
            # every ADSBError-catching output sink
            raise ParserError(f"non-hex frame {hexframe!r}")
        if (data >> (nbits - 5)) != df and not (df == 24 and data >> (nbits - 2) == 3):
            raise ParserError("DF mismatch between header and frame")
        # CRC re-check (ref: parse.py re-validates before dispatch). The wire
        # syndrome is post-correction, so it must match a recompute exactly;
        # for DF17/18 a clean frame has syndrome 0.
        if crc.crc24(data, nbits) != syndrome:
            raise ParserError("CRC re-check failed")
        if df in (17, 18) and syndrome != 0:
            raise ParserError(f"DF{df} with nonzero syndrome")

        report = AircraftReport(df=df, icao=None, timestamp=timestamp,
                                ref_dbfs=ref_dbfs, raw_hex=hexframe,
                                status=status)
        reply = modes_reply(data, nbits)

        # Address recovery: AP-overlaid DFs carry icao in the syndrome.
        if df in AP_ADDRESS_DFS:
            report.icao = syndrome
        elif "aa" in reply:
            report.icao = reply["aa"]

        handler = getattr(self, f"parse{df}", None)
        if handler is None:
            raise NoHandlerError(df)
        handler(reply, report)
        # ELM cycles that ended by going idle (no restart segment will ever
        # emit them) surface on whatever message arrives next — the message
        # stream is the parser's only clock
        if self._elm_flush_t is None or timestamp < self._elm_flush_t:
            # also RE-anchor on a timestamp regression (replay restart /
            # feed switch): a stale high-water mark stalled idle-ELM
            # delivery until timestamps climbed past it
            self._elm_flush_t = timestamp
        elif timestamp - self._elm_flush_t >= 1.0:
            flushed = self.elm.flush(timestamp)
            if flushed:
                report.elm_flushed = flushed
            self._elm_flush_t = timestamp
        return report

    # --- per-DF handlers (ref: parse.py parse0/4/5/11/16/17/20/21) ------------

    def parse0(self, reply, report):
        report.altitude_ft = self._alt13(reply["ac"])
        report.on_surface = bool(reply["vs"])

    def parse16(self, reply, report):
        self.parse0(reply, report)
        # DF16 MV with VDS 3,0 carries the active TCAS resolution advisory
        # (beyond the reference, which drops MV) — see decode/acas.py
        ra = acas.decode_mv(reply["mv"])
        if ra is not None:
            report.bds = "BDS3,0"
            report.acas_ra = ra

    def parse4(self, reply, report):
        report.flight_status = reply["fs"]
        report.on_surface = reply["fs"] in (1, 3)  # FS 1/3 = on ground
        report.altitude_ft = self._alt13(reply["ac"])

    def parse5(self, reply, report):
        report.flight_status = reply["fs"]
        report.on_surface = reply["fs"] in (1, 3)
        report.squawk = decode_squawk(reply["id"])

    def parse11(self, reply, report):
        report.capability = reply["ca"]

    def parse17(self, reply, report):
        report.capability = reply["ca"] if "ca" in reply else None
        self._parse_me(reply["me"], report)

    def parse18(self, reply, report):
        """DF18 dispatches on CF (DO-260B 2.2.3.2.2): only some control
        field values carry an ADS-B-format ME, and CF=1/5 use a non-ICAO
        (anonymous/track-file) address that must not pollute the
        ICAO-keyed CPR cache."""
        cf = reply["cf"]
        if cf in (1, 5):
            # ADS-B/TIS-B with "other" (non-ICAO) address: namespace the
            # key itself so EVERY ICAO-keyed consumer (CPR cache,
            # dashboard state, gate training, output plugins) is
            # collision-free, not just the CPR cache
            report.address_anon = True
            if report.icao is not None:
                report.icao |= ANON_ICAO_BIT
        if cf in (0, 1, 2, 5, 6):
            # 0/1: ADS-B (ES/NT), 2/5: fine-format TIS-B, 6: ADS-R —
            # all carry a standard ADS-B ME field
            self._parse_me(reply["me"], report)
        else:
            # 3: coarse TIS-B (different ME layout), 4: TIS-B/ADS-R
            # management, 7: reserved — known frame, undecoded payload
            report.me_raw = reply["me"]

    def parse20(self, reply, report):
        report.flight_status = reply["fs"]
        report.altitude_ft = self._alt13(reply["ac"])
        self._parse_mb(reply["mb"], report)

    def parse21(self, reply, report):
        report.flight_status = reply["fs"]
        report.squawk = decode_squawk(reply["id"])
        self._parse_mb(reply["mb"], report)

    def _parse_mb(self, mb: int, report: AircraftReport):
        """Comm-B register inference + decode (beyond the reference, which
        carries MB raw). Attached only when the register is UNIQUELY
        inferable; see decode/commb.py."""
        decoded = commb.decode(mb)
        if decoded is None:
            return
        name, fields = decoded
        report.bds = name
        report.commb = fields
        if name == "BDS2,0":
            report.callsign = fields["callsign"]

    def parse24(self, reply, report):
        """Comm-D ELM segment (the reference carries DF24 raw; segment
        reassembly here exceeds it — see decode/elm.py)."""
        report.bds = "Comm-D"
        report.elm_ke = reply["ke"]
        report.elm_nd = reply["nd"]
        report.elm_md = reply["md"]
        # cycle-restart emission; idle cycles surface via the owning app
        # calling parser.elm.flush(now) (see outputs/msprint staleness)
        report.elm_data = self.elm.add(
            report.icao, reply["ke"], reply["nd"], reply["md"],
            report.timestamp)

    # --- ME (DF17 extended squitter) -------------------------------------------

    # TC28 subtype-1 emergency/priority state encoding (DO-260B 2.2.3.2.7.8.1.1)
    EMERGENCY_STATES = ("none", "general", "lifeguard/medical", "minimum fuel",
                        "no communications", "unlawful interference",
                        "downed aircraft", "reserved")

    def _parse_me(self, me: int, report: AircraftReport):
        ftc = me >> 51
        rep = me_reply(me)
        if ftc == 0:
            # airborne position, position information unavailable: altitude only
            report.bds = "BDS0,5"
            alt12 = rep["alt"]
            if alt12:
                try:
                    report.altitude_ft = decode_alt(alt12, bit13=False)
                except ADSBError:
                    pass
            return
        if 1 <= ftc <= 4:
            report.bds = "BDS0,8"
            report.callsign = decode_callsign(rep["ident"])
            report.category = rep["cat"]
        elif 5 <= ftc <= 8:
            report.bds = "BDS0,6"
            report.on_surface = True
            self._decode_position(rep, report, surface=True)
            mov = rep["mov"]
            if mov == 1:
                # "aircraft stopped" (GS < 0.125 kt) is a real speed
                # report, distinct from mov=0 (no information)
                report.speed_kt = 0.0
                report.speed_type = "GS"
            elif 2 <= mov <= 124:
                report.speed_kt = self._surface_speed(mov)
                report.speed_type = "GS"
            if rep["gts"]:
                report.heading_deg = rep["gtk"] * 360.0 / 128.0
        elif (9 <= ftc <= 18) or (20 <= ftc <= 22):
            report.bds = "BDS0,5"
            alt12 = rep["alt"]
            if alt12:
                try:
                    # TC20-22 re-use the AC12 encoding but carry GNSS HAE
                    # (geometric), not barometric altitude — flagged so
                    # consumers keep the two apart (decode_alt_gnss12
                    # documents the encoding-reading choice)
                    if ftc >= 20:
                        from .altitude import decode_alt_gnss12
                        report.altitude_ft = decode_alt_gnss12(alt12)
                        report.altitude_gnss = True
                    else:
                        report.altitude_ft = decode_alt(alt12, bit13=False)
                except ADSBError:
                    pass
            self._decode_position(rep, report, surface=False)
        elif ftc == 19:
            report.bds = "BDS0,9"
            if "raw" in rep:   # reserved subtype (0, 5-7): bits undefined
                report.me_raw = me
            else:
                self._decode_velocity(rep, report)
        elif ftc == 28:
            report.bds = "BDS6,1"
            if rep["sub"] == 1:
                report.emergency = self.EMERGENCY_STATES[rep["es"]]
                if rep["mode_a"]:
                    report.squawk = decode_squawk(rep["mode_a"])
            elif "ara" in rep:  # subtype 2: RA broadcast (BDS3,0 payload)
                report.acas_ra = acas.decode_ra(
                    rep["ara"], rep["rac"], rep["rat"], rep["mte"],
                    rep["tti"], rep["tid"], bds="6,1")
            else:  # reserved subtype: carried raw (like the reference
                report.me_raw = me  # carries MB/MV raw), not dropped
        elif ftc == 29:
            report.bds = "BDS6,2"
            if "sel_alt" in rep:
                report.tss = self._decode_target_state(rep)
            else:  # DO-260A subtype 0 TSS: known but undecoded — carry raw
                report.me_raw = me
        elif ftc == 31:
            report.bds = "BDS6,5"
            if "raw" in rep:   # reserved subtype (2-7): carried raw
                report.me_raw = me
            else:
                report.opstatus = self._decode_op_status(rep)
                report.on_surface = rep["sub"] == 1
        else:
            raise NoHandlerError(ftc)

    @staticmethod
    def _decode_target_state(rep) -> dict:
        """TC29 subtype 1 (DO-260B target state and status, BDS6,2)."""
        out: dict = {}
        if rep["sel_alt"]:
            out["selected_altitude_ft"] = (rep["sel_alt"] - 1) * 32
            out["altitude_source"] = "FMS" if rep["sel_alt_type"] else "MCP/FCU"
        if rep["baro"]:
            out["baro_setting_mb"] = round(800.0 + (rep["baro"] - 1) * 0.8, 1)
        if rep["shdg"]:
            hdg9 = (rep["hdg_sign"] << 8) | rep["hdg"]
            out["selected_heading_deg"] = round(hdg9 * 180.0 / 256.0, 2)
        out["nacp"] = rep["nacp"]
        out["sil"] = rep["sil"]
        out["nic_baro"] = rep["nic_baro"]
        if rep["mode_status"]:
            out["autopilot"] = bool(rep["autopilot"])
            out["vnav"] = bool(rep["vnav"])
            out["altitude_hold"] = bool(rep["alt_hold"])
            out["approach"] = bool(rep["approach"])
            out["lnav"] = bool(rep["lnav"])
        out["tcas_operational"] = bool(rep["tcas_op"])
        return out

    @staticmethod
    def _decode_op_status(rep) -> dict:
        """TC31 (aircraft operational status, BDS6,5), subtype 0/1."""
        surface = rep["sub"] == 1
        out: dict = {
            "surface": surface,
            "version": rep["ver"],
            "nic_supplement_a": bool(rep["nic_sup_a"]),
            "nacp": rep["nacp"],
            "sil": rep["sil"],
            "capability_class": rep["cc"],
            "operational_modes": rep["om"],
            "heading_reference": "magnetic" if rep["hrd"] else "true",
        }
        if surface:
            out["length_width_code"] = rep["lw"]
            out["track_angle_not_heading"] = bool(rep["trk_hdg"])
        else:
            out["gva"] = rep["gva"]
            out["nic_baro"] = rep["nic_baro"]
        return out

    def _decode_position(self, rep, report, surface: bool):
        if report.icao is None:
            return
        # report.icao already carries ANON_ICAO_BIT for DF18 CF=1/5, so
        # an anonymous address equal to a real ICAO never cross-pairs
        try:
            lat, lon, rng, brg = self.cpr.decode(
                report.icao, rep["encoded_lat"], rep["encoded_lon"],
                rep["cpr_format"], surface=surface, timestamp=report.timestamp)
        except ADSBError:
            return  # position not resolvable yet; rest of report still valid
        report.lat, report.lon = lat, lon
        report.range_nm, report.bearing_deg = rng, brg

    @staticmethod
    def _surface_speed(mov: int) -> float:
        """BDS0,6 movement field -> ground speed in kt.

        DO-260 piecewise quantization: (first code, base speed, step) per
        band — codes 2-8: 0.125-1 kt by 0.125; 9-12: 1-2 by 0.25;
        13-38: 2-15 by 0.5; 39-93: 15-70 by 1; 94-108: 70-100 by 2;
        109-123: 100-175 by 5; 124: >= 175 kt.
        """
        bands = [(2, 0.125, 0.125), (9, 1.0, 0.25), (13, 2.0, 0.5),
                 (39, 15.0, 1.0), (94, 70.0, 2.0), (109, 100.0, 5.0)]
        if mov >= 124:
            return 175.0
        for first, base, step in reversed(bands):
            if mov >= first:
                return base + (mov - first) * step
        return 0.0

    def _decode_velocity(self, rep, report):
        sub = rep["sub"]
        if sub in (1, 2):
            scale = 4.0 if sub == 2 else 1.0
            v_ew, v_ns = rep["v_ew"], rep["v_ns"]
            if v_ew and v_ns:
                ew = (v_ew - 1) * scale * (-1 if rep["s_ew"] else 1)
                ns = (v_ns - 1) * scale * (-1 if rep["s_ns"] else 1)
                report.speed_kt = math.hypot(ew, ns)
                report.heading_deg = math.degrees(math.atan2(ew, ns)) % 360.0
                report.speed_type = "GS"
        elif sub in (3, 4):
            scale = 4.0 if sub == 4 else 1.0
            if rep["shdg"]:
                report.heading_deg = rep["hdg"] * 360.0 / 1024.0
            if rep["as_"]:
                report.speed_kt = (rep["as_"] - 1) * scale
                report.speed_type = "TAS" if rep["ast"] else "IAS"
        if rep["vr"]:
            report.vertical_rate_fpm = (rep["vr"] - 1) * 64.0 * \
                (-1 if rep["s_vr"] else 1)
        if rep["dif"]:
            # GNSS height above/below barometric altitude, 25 ft steps
            report.gnss_baro_diff_ft = (rep["dif"] - 1) * 25.0 * \
                (-1 if rep["s_dif"] else 1)

    # --- helpers ---------------------------------------------------------------

    @staticmethod
    def _alt13(ac13: int) -> Optional[int]:
        if ac13 == 0:
            return None
        try:
            return decode_alt(ac13, bit13=True)
        except ADSBError:
            return None
