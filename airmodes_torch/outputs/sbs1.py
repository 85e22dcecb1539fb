"""SBS-1 / BaseStation TCP server (ref: gr-air-modes python/sbs1.py).

TCP server on port 30003 emitting CSV "MSG,{1|2|3|4|5|6}" lines compatible
with BaseStation / Virtual Radar Server:
  MSG,1: callsign   MSG,2: surface position    MSG,3: airborne position
  MSG,4: velocity   MSG,5: altitude-only surveillance   MSG,6: squawk
Nonblocking accept; a dead client socket just gets dropped (drop-and-continue).
"""

from __future__ import annotations

import datetime
from typing import Optional

from ..decode.parse import AircraftReport, parse
from ..exceptions import ADSBError
from .tcpserver import broadcast_server


def _sbs_time(ts: float):
    """(date, time) strings, or None for timestamps datetime cannot
    represent (NaN / out-of-range values parse as floats on an untrusted
    wire but raise ValueError/OverflowError/OSError here)."""
    try:
        dt = datetime.datetime.fromtimestamp(ts, tz=datetime.timezone.utc)
    except (ValueError, OverflowError, OSError):
        return None
    return dt.strftime("%Y/%m/%d"), dt.strftime("%H:%M:%S.%f")[:-3]


def _join_line(msgtype: int, icao_s: str, d: str, t: str, fields) -> str:
    """Assemble one 22-column SBS line: 10 header + 12 trailing columns
    (BaseStation consumers parse positionally; short rows misalign)."""
    cols = ["MSG", str(msgtype), "1", "1", icao_s, "1", d, t, d, t] + fields
    return ",".join("" if c is None else str(c) for c in cols)


def sbs_position_line(icao: Optional[int], timestamp: float, alt_ft,
                      lat: float, lon: float,
                      onground: bool = False) -> Optional[str]:
    """A bare MSG,2/3 position line from raw values — for producers whose
    positions never existed as wire messages (e.g. mlat solutions in
    apps/modes_mlat); keeps the column layout in ONE place."""
    st = _sbs_time(timestamp)
    if st is None:
        return None
    d, t = st
    f = [None] * 12
    f[1] = alt_ft
    f[4], f[5] = f"{lat:.5f}", f"{lon:.5f}"
    f[11] = "-1" if onground else "0"
    from ..decode.parse import format_icao
    return _join_line(2 if onground else 3,
                      "" if icao is None else format_icao(icao).upper(),
                      d, t, f)


def format_sbs1(rep: AircraftReport) -> Optional[str]:
    """One report -> one SBS-1 CSV line (or None if nothing to say)."""
    if rep.icao is None:
        return None
    st = _sbs_time(rep.timestamp)
    if st is None:
        return None
    d, t = st
    from ..decode.parse import format_icao
    icao = format_icao(rep.icao).upper()   # anon (TIS-B) -> "~XXXXXX"

    def line(msgtype, fields):
        return _join_line(msgtype, icao, d, t, fields)

    # fields: callsign, alt, gs, trk, lat, lon, vr, squawk, alert, emerg,
    # spi, onground — 12 trailing columns, 22 total (BaseStation consumers
    # parse positionally; short rows misalign, e.g. onground read as
    # emergency)
    f = [None] * 12
    if rep.df in (17, 18):
        if rep.callsign:
            f[0] = rep.callsign
            return line(1, f)
        if rep.lat is not None:
            # the SBS altitude column is barometric: TC20-22 GNSS HAE
            # differs by geoid+pressure offsets and must not be emitted
            # there (position still goes out, altitude column empty)
            f[1] = None if rep.altitude_gnss else rep.altitude_ft
            f[4] = f"{rep.lat:.5f}"
            f[5] = f"{rep.lon:.5f}"
            f[11] = "-1" if rep.on_surface else "0"
            if rep.on_surface:
                # MSG,2 = surface position; BDS0,6 also carries movement
                if rep.speed_kt is not None:
                    f[2] = f"{rep.speed_kt:.0f}"
                if rep.heading_deg is not None:
                    f[3] = f"{rep.heading_deg:.0f}"
                return line(2, f)
            return line(3, f)
        if rep.speed_kt is not None or rep.heading_deg is not None \
                or rep.vertical_rate_fpm is not None:
            # vertical-rate-only / heading-only BDS0,9 reports are real
            # velocity messages (horizontal field flagged 'no info') —
            # gating MSG,4 on speed alone silently dropped them
            f[2] = None if rep.speed_kt is None else f"{rep.speed_kt:.0f}"
            f[3] = None if rep.heading_deg is None else f"{rep.heading_deg:.0f}"
            f[6] = None if rep.vertical_rate_fpm is None else f"{rep.vertical_rate_fpm:.0f}"
            return line(4, f)
        if rep.altitude_ft is not None and not rep.altitude_gnss:
            f[1] = rep.altitude_ft
            return line(5, f)
        if rep.squawk is not None:  # TC28/1 aircraft status (BDS6,1)
            f[7] = f"{rep.squawk:04d}"
            emerg = bool(rep.emergency and rep.emergency != "none")
            # BaseStation convention: Alert (col 18) flashes alongside
            # Emergency (col 19) on an active emergency state
            f[8] = "-1" if emerg else "0"
            f[9] = "-1" if emerg else "0"
            return line(6, f)
        return None
    if rep.df in (0, 4, 16, 20) and rep.altitude_ft is not None:
        f[1] = rep.altitude_ft
        return line(5, f)
    if rep.df in (5, 21) and rep.squawk is not None:
        f[7] = f"{rep.squawk:04d}"
        if rep.squawk in (7500, 7600, 7700):  # emergency squawks
            f[8] = "-1"
            f[9] = "-1"
        return line(6, f)
    return None


class output_sbs1:
    """TCP server plugin; call output(msg) per raw message."""

    def __init__(self, port: int = 30003, parser: Optional[parse] = None,
                 host: str = "0.0.0.0"):
        self._parser = parser or parse()
        self._srv = broadcast_server(port, host)
        self.port = self._srv.port

    def output(self, msg: str) -> None:
        try:
            rep = self._parser.parse(msg)
        except ADSBError:
            return
        lin = format_sbs1(rep)
        if lin is None:
            return
        self.send_line(lin)

    def send_line(self, lin: str) -> None:
        self._srv.broadcast((lin + "\r\n").encode())

    def close(self) -> None:
        self._srv.close()
