"""FlightGear multiplayer feeder (ref: gr-air-modes python/flightgear.py).

UDP sender speaking the FlightGear MultiPlayer protocol: struct-packed XDR
position/orientation packets that make decoded aircraft appear inside a
running FlightGear instance. Positions are converted lat/lon/alt -> ECEF and
heading -> orientation angle-axis (outputs/quaternion.py), matching the role
of the reference's vendored Quaternion.py.
"""

from __future__ import annotations

import math
import socket
import struct
import time
from typing import Dict, Optional, Tuple

from ..decode.parse import AircraftReport, parse
from ..exceptions import ADSBError
from . import quaternion

FG_MAGIC = 0x46474653          # "FGFS"
FG_VERSION = 0x00010001
FG_POS_MSG = 7
FG_MODEL = "Aircraft/737-200/Models/boeing733.xml"

def llh2ecef(lat_deg: float, lon_deg: float, alt_m: float) -> Tuple[float, float, float]:
    # one WGS-84 implementation for the whole package (decode/mlat.py)
    from ..decode.mlat import llh2ecef as _llh2ecef
    x, y, z = _llh2ecef((lat_deg, lon_deg, alt_m))
    return float(x), float(y), float(z)


def pack_fg_position(callsign: str, lat: float, lon: float, alt_ft: float,
                     heading_deg: float, speed_kt: float = 0.0,
                     sim_time: Optional[float] = None) -> bytes:
    """Build one FGFS MP position packet (header + XDR position message)."""
    alt_m = alt_ft * 0.3048
    x, y, z = llh2ecef(lat, lon, alt_m)
    ori = quaternion.to_angle_axis(
        quaternion.ecef_orientation(lat, lon, heading_deg))
    # linear velocity in ECEF from ground speed + heading (flat approx)
    spd = speed_kt * 0.514444
    hdg = math.radians(heading_deg)
    vn, ve, vd = spd * math.cos(hdg), spd * math.sin(hdg), 0.0
    lat_r, lon_r = math.radians(lat), math.radians(lon)
    # NED -> ECEF rotation
    vx = (-math.sin(lat_r) * math.cos(lon_r) * vn - math.sin(lon_r) * ve -
          math.cos(lat_r) * math.cos(lon_r) * vd)
    vy = (-math.sin(lat_r) * math.sin(lon_r) * vn + math.cos(lon_r) * ve -
          math.cos(lat_r) * math.sin(lon_r) * vd)
    vz = math.cos(lat_r) * vn - math.sin(lat_r) * vd

    model = FG_MODEL.encode()[:95]
    body = struct.pack("!96s", model)
    # time, lag — `is None`, not falsy: a legitimate 0.0 wire timestamp
    # must not jump to wall clock and break FG's motion interpolation
    t = time.time() if sim_time is None else sim_time
    body += struct.pack("!dd", t, 0.02)
    body += struct.pack("!3d", x, y, z)
    body += struct.pack("!3f", *ori)
    body += struct.pack("!3f", vx, vy, vz)
    body += struct.pack("!3f", 0.0, 0.0, 0.0)  # angular velocity
    body += struct.pack("!3f", 0.0, 0.0, 0.0)  # linear accel
    body += struct.pack("!3f", 0.0, 0.0, 0.0)  # angular accel
    body += struct.pack("!4x")                 # pad

    cs = callsign.encode()[:7]
    header = struct.pack("!II", FG_MAGIC, FG_VERSION)
    header += struct.pack("!II", FG_POS_MSG, 32 + len(body))
    header += struct.pack("!II", 0, 0)         # radar range, port (unused)
    header += struct.pack("!8s", cs)
    return header + body


class output_flightgear:
    """Plugin: decodes reports, tracks per-ICAO state, feeds FG over UDP."""

    def __init__(self, hostname: str = "localhost", port: int = 5000,
                 parser: Optional[parse] = None):
        self._parser = parser or parse()
        self._addr = (hostname, port)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        # icao -> dict of last known callsign/alt/heading/speed
        self._state: Dict[int, dict] = {}

    def output(self, msg: str) -> None:
        try:
            rep = self._parser.parse(msg)
        except ADSBError:
            return
        self.update(rep)

    def update(self, rep: AircraftReport) -> None:
        if rep.icao is None:
            return
        if rep.icao not in self._state and len(self._state) > 4096:
            # bound all-time aircraft churn: evict the half least
            # recently updated (a long-running receiver must not leak
            # one entry per ICAO ever seen)
            for k in sorted(self._state,
                            key=lambda k: self._state[k]["t"])[:2048]:
                del self._state[k]
        st = self._state.setdefault(rep.icao, {
            "callsign": None, "alt": 0.0, "heading": 0.0, "speed": 0.0})
        st["t"] = rep.timestamp
        if rep.callsign:
            st["callsign"] = rep.callsign
        if rep.altitude_ft is not None:
            st["alt"] = float(rep.altitude_ft)
        if rep.heading_deg is not None:
            st["heading"] = rep.heading_deg
        if rep.speed_kt is not None:
            st["speed"] = rep.speed_kt
        if rep.lat is None:
            return
        pkt = pack_fg_position(
            st["callsign"] or rep.icao_hex, rep.lat, rep.lon,
            st["alt"], st["heading"], st["speed"], sim_time=rep.timestamp)
        try:
            self._sock.sendto(pkt, self._addr)
        except OSError:
            pass

    def close(self) -> None:
        self._sock.close()
