"""Aircraft-derived weather feed (beyond reference).

Mode-S EHS/MRAR replies carry wind, temperature, pressure and hazard
reports (decode/commb.py BDS4,4/4,5; BDS5,0/6,0 give the wind triangle
implicitly). Meteorological services assimilate exactly this data
(AMDAR-style soundings from ordinary traffic). This plugin joins each
met-carrying reply with the aircraft's last known ADS-B position/altitude
and appends one NDJSON observation per report:

    {"ts": ..., "icao": "4840d6", "lat": ..., "lon": ..., "alt_ft": ...,
     "wind_speed_kt": ..., "wind_dir_deg": ..., "temperature_c": ...,
     "pressure_hpa": ..., "turbulence": "moderate", ...}

`modes_rx --wx FILE` ('-' for stdout).
"""

from __future__ import annotations

import json
from typing import Optional

from ..decode.parse import parse
from ..exceptions import ADSBError

# commb fields worth publishing as weather observations
_WX_FIELDS = ("wind_speed_kt", "wind_dir_deg", "temperature_c",
              "pressure_hpa", "humidity_pct", "turbulence", "wind_shear",
              "microburst", "icing", "wake_vortex")


def derive_wind(track_deg: float, gs_kt: float, heading_deg: float,
                tas_kt: float) -> tuple:
    """Wind vector from the BDS5,0/6,0 wind triangle.

    Ground velocity (track/GS) minus air velocity (heading/TAS) is the
    wind; returns (speed_kt, direction_the_wind_comes_FROM_deg). This is
    the operational Mode-S EHS wind derivation (far more aircraft carry
    5,0+6,0 than the optional 4,4 MRAR). Caveat: BDS6,0 heading is
    MAGNETIC while BDS5,0 track is true — without a declination model the
    direction carries the local declination as bias (a few degrees in
    mid-latitudes), exactly as raw operational Mode-S wind does.
    """
    import math
    tr, hd = math.radians(track_deg), math.radians(heading_deg)
    wx = gs_kt * math.sin(tr) - tas_kt * math.sin(hd)
    wy = gs_kt * math.cos(tr) - tas_kt * math.cos(hd)
    speed = math.hypot(wx, wy)
    dir_from = math.degrees(math.atan2(-wx, -wy)) % 360.0
    return speed, dir_from


def derive_sat(tas_kt: float, mach: float) -> float:
    """Static air temperature (C) from TAS and Mach.

    a = 38.967 kt * sqrt(T[K]); TAS = M * a  =>  T = (TAS / (38.967 M))^2.
    """
    return (tas_kt / (38.967 * mach)) ** 2 - 273.15


class output_wx:
    """Plugin: call output(msg) per raw wire message."""

    def __init__(self, path: str, parser: Optional[parse] = None,
                 stale_pos_s: float = 30.0, pair_window_s: float = 5.0,
                 declination_deg: float = 0.0):
        self.path = path
        self._parser = parser or parse()
        self.stale_pos_s = stale_pos_s
        self.pair_window_s = pair_window_s
        # local magnetic declination (east positive): BDS6,0 heading is
        # magnetic, BDS5,0 track is true; true heading = magnetic + decl
        self.declination_deg = declination_deg
        # icao -> (lat, lon, alt_ft, timestamp) last ADS-B fix
        self._last_fix: dict = {}
        # icao -> (track, gs, tas, ts) from BDS5,0 / (heading, mach, ts)
        # from BDS6,0 — the wind-triangle pairing state
        self._bds50: dict = {}
        self._bds60: dict = {}
        self.n_obs = 0
        self._fh = None

    def output(self, msg: str) -> None:
        try:
            rep = self._parser.parse(msg)
        except ADSBError:
            return
        if rep.icao is None:
            return
        if rep.lat is not None:
            # evict by fix AGE: an updated entry keeps its original dict
            # insertion slot, so insertion-order "FIFO" would drop
            # currently-active aircraft seconds after a fix
            self._evict_stale(self._last_fix)
            self._last_fix[rep.icao] = (rep.lat, rep.lon, rep.altitude_ft,
                                        rep.timestamp)
        if not rep.commb:
            return
        obs = {k: rep.commb[k] for k in _WX_FIELDS if k in rep.commb}
        obs.update(self._triangle(rep))
        if not obs:
            return
        rec = {"ts": round(rep.timestamp, 3), "icao": rep.icao_hex}
        fix = self._last_fix.get(rep.icao)
        if fix is not None and rep.timestamp - fix[3] <= self.stale_pos_s:
            rec["lat"], rec["lon"] = round(fix[0], 5), round(fix[1], 5)
            if fix[2] is not None:
                rec["alt_ft"] = fix[2]
        if "alt_ft" not in rec and rep.altitude_ft is not None:
            rec["alt_ft"] = rep.altitude_ft     # the reply's own AC field
        rec.update(obs)
        self._write(json.dumps(rec))
        self.n_obs += 1

    @staticmethod
    def _evict_stale(d: dict) -> None:
        """Bound a per-ICAO pairing dict by dropping the OLDEST half
        (entries end with a timestamp). A blunt clear() also dropped
        currently-active aircraft's pairing state, losing their next
        wind observation."""
        if len(d) > 4096:
            for k in sorted(d, key=lambda k: d[k][-1])[:2048]:
                del d[k]

    def _triangle(self, rep) -> dict:
        """Derived wind/SAT when this report completes a fresh 5,0+6,0
        pair for the aircraft."""
        f = rep.commb
        if rep.bds == "BDS5,0" and "track_deg" in f and \
                "groundspeed_kt" in f and "tas_kt" in f:
            self._evict_stale(self._bds50)
            self._bds50[rep.icao] = (f["track_deg"], f["groundspeed_kt"],
                                     f["tas_kt"], rep.timestamp)
        elif rep.bds == "BDS6,0" and "mag_heading_deg" in f:
            self._evict_stale(self._bds60)
            self._bds60[rep.icao] = (f["mag_heading_deg"], f.get("mach"),
                                     rep.timestamp)
        else:
            return {}
        a = self._bds50.get(rep.icao)
        b = self._bds60.get(rep.icao)
        if a is None or b is None or abs(a[3] - b[2]) > self.pair_window_s:
            return {}
        track, gs, tas, _ = a
        heading, mach, _ = b
        speed, dir_from = derive_wind(track, gs,
                                      heading + self.declination_deg, tas)
        if speed > 250.0:           # implausible: mismatched pair
            return {}
        out = {"wind_speed_kt": round(speed, 1),
               "wind_dir_deg": round(dir_from, 1),
               "derived": True}
        if mach and mach > 0.2:
            sat = derive_sat(tas, mach)
            if -90.0 <= sat <= 60.0:
                out["temperature_c"] = round(sat, 1)
        return out

    def _write(self, line: str) -> None:
        if self.path == "-":
            print(line, flush=True)
            return
        try:
            if self._fh is None:
                self._fh = open(self.path, "a")
            self._fh.write(line + "\n")
            self._fh.flush()
        except OSError:
            pass    # observation output must never stall the decode loop

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
