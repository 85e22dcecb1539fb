"""Console pretty-printer (ref: gr-air-modes python/msprint.py output_print).

Formats each parsed report into human-readable lines including the reference
level in dBFS and the timestamp, e.g.

  Type 17 BDS0,5 (airborne position) from 3c6614 at (47.12345, 8.12345)
  alt 37000 ft (-23.0 dBFS)
"""

from __future__ import annotations

from typing import Callable, Optional

from ..decode.parse import AircraftReport, parse
from ..exceptions import ADSBError


class output_print:
    """Subscribe `output(msg)` to the dl_data feed; prints decoded lines."""

    def __init__(self, parser: Optional[parse] = None,
                 my_position=None,
                 callback: Callable[[str], None] = print):
        self._parser = parser or parse(my_position)
        self._cb = callback

    def output(self, msg: str) -> None:
        try:
            rep = self._parser.parse(msg)
        except ADSBError:
            return
        line = self.format_report(rep)
        if line:
            self._cb(line)
        for ln in self._flushed_lines(rep):
            self._cb(ln)

    @staticmethod
    def _commb_summary(rep: AircraftReport) -> str:
        """Inline summary of an inferred Comm-B register (DF20/21)."""
        if not rep.commb:
            return ""
        f = rep.commb
        bits = []
        if "callsign" in f:
            bits.append(f"ident {f['callsign']}")
        for key, fmt in (("mcp_altitude_ft", "sel alt {:.0f} ft"),
                         ("fms_altitude_ft", "FMS alt {:.0f} ft"),
                         ("baro_setting_mb", "QNH {:.1f} mb"),
                         ("roll_deg", "roll {:+.1f}"),
                         ("track_deg", "track {:.1f}"),
                         ("track_rate_dps", "turn {:+.2f} deg/s"),
                         ("groundspeed_kt", "GS {:.0f} kt"),
                         ("tas_kt", "TAS {:.0f} kt"),
                         ("mag_heading_deg", "hdg {:.1f}"),
                         ("ias_kt", "IAS {:.0f} kt"),
                         ("mach", "M{:.3f}"),
                         ("baro_vertical_rate_fpm", "vert {:+.0f} fpm"),
                         ("inertial_vertical_rate_fpm",
                          "ivert {:+.0f} fpm"),
                         ("wind_speed_kt", "wind {:.0f} kt"),
                         ("wind_dir_deg", "from {:.0f}"),
                         ("temperature_c", "SAT {:+.1f} C"),
                         ("pressure_hpa", "{:.0f} hPa"),
                         ("humidity_pct", "RH {:.0f}%"),
                         ("turbulence", "turb {}"),
                         ("wind_shear", "shear {}"),
                         ("microburst", "microburst {}"),
                         ("icing", "icing {}"),
                         ("wake_vortex", "wake {}"),
                         ("radio_height_ft", "RA {:.0f} ft")):
            if key in f:
                bits.append(fmt.format(f[key]))
        if "gicb_services" in f:
            bits.append("GICB " + "+".join(f["gicb_services"]))
        return f" {rep.bds} ({', '.join(bits)})" if bits else f" {rep.bds}"

    @staticmethod
    def format_report(rep: AircraftReport) -> str:
        icao = rep.icao_hex or "??????"
        tail = f"({rep.ref_dbfs:.1f} dBFS) [{rep.timestamp:.6f}]"
        if rep.df in (17, 18):
            kind = {"BDS0,8": "ident", "BDS0,5": "airborne position",
                    "BDS0,6": "surface position", "BDS0,9": "velocity",
                    "BDS6,1": "aircraft status",
                    "BDS6,2": "target state and status",
                    "BDS6,5": "operational status"}.get(rep.bds, "unknown")
            parts = [f"Type {rep.df} {rep.bds} ({kind}) from {icao}"]
            if rep.callsign:
                parts.append(f"ident {rep.callsign} (cat {rep.category})")
            if rep.emergency and rep.emergency != "none":
                parts.append(f"EMERGENCY: {rep.emergency}")
            if rep.squawk is not None:
                parts.append(f"squawk {rep.squawk:04d}")
            if rep.acas_ra:
                from ..decode import acas
                parts.append(f"RA[{acas.summarize(rep.acas_ra)}]")
            if rep.tss:
                t = rep.tss
                if "selected_altitude_ft" in t:
                    parts.append(f"sel alt {t['selected_altitude_ft']} ft"
                                 f" ({t['altitude_source']})")
                if "selected_heading_deg" in t:
                    parts.append(f"sel hdg {t['selected_heading_deg']:.0f}")
                if "baro_setting_mb" in t:
                    parts.append(f"QNH {t['baro_setting_mb']:.1f} mb")
            if rep.opstatus:
                o = rep.opstatus
                parts.append(f"ADS-B v{o['version']} NACp {o['nacp']}"
                             f" SIL {o['sil']}")
            if rep.lat is not None:
                parts.append(f"at ({rep.lat:.5f}, {rep.lon:.5f})")
                if rep.range_nm is not None:
                    parts.append(f"({rep.range_nm:.1f} NM @ {rep.bearing_deg:.0f})")
            if rep.altitude_ft is not None:
                parts.append(f"alt {rep.altitude_ft} ft")
            if rep.speed_kt is not None:
                parts.append(f"speed {rep.speed_kt:.0f} kt {rep.speed_type or ''}".rstrip())
            if rep.heading_deg is not None:
                parts.append(f"heading {rep.heading_deg:.0f}")
            if rep.vertical_rate_fpm is not None:
                parts.append(f"vert {rep.vertical_rate_fpm:+.0f} fpm")
            return " ".join(parts) + " " + tail
        if rep.df == 11:
            return f"Type 11 (all call reply) from {icao} " + tail
        if rep.df in (0, 16):
            alt = f" alt {rep.altitude_ft} ft" if rep.altitude_ft is not None else ""
            ra = ""
            if rep.acas_ra:
                from ..decode import acas
                ra = f" RA[{acas.summarize(rep.acas_ra)}]"
            kind = "short" if rep.df == 0 else "long"
            return (f"Type {rep.df} ({kind} air-air ACAS) from "
                    f"{icao}{alt}{ra} ") + tail
        if rep.df in (4, 20):
            alt = f" alt {rep.altitude_ft} ft" if rep.altitude_ft is not None else ""
            cb = output_print._commb_summary(rep)
            return f"Type {rep.df} (altitude reply) from {icao}{alt}{cb} " + tail
        if rep.df in (5, 21):
            sq = f" squawk {rep.squawk:04d}" if rep.squawk is not None else ""
            cb = output_print._commb_summary(rep)
            return f"Type {rep.df} (identity reply) from {icao}{sq}{cb} " + tail
        if rep.df == 24:
            if rep.elm_ke != 0:
                what = "uplink ELM ack"
            else:
                what = f"segment {rep.elm_nd}"
                if rep.elm_data is not None:
                    what += f", ELM complete {len(rep.elm_data)}B " \
                            f"{rep.elm_data.hex()}"
            return f"Type 24 (Comm-D {what}) from {icao} " + tail
        return f"Type {rep.df} from {icao} " + tail

    @staticmethod
    def _flushed_lines(rep) -> list:
        """Idle-completed ELMs piggybacked on this report (decode/elm)."""
        if not rep.elm_flushed:
            return []
        from ..decode.parse import format_icao
        return [f"Comm-D ELM complete (idle) from {format_icao(i)}: "
                f"{len(d)}B {d.hex()}" for i, d in rep.elm_flushed]
