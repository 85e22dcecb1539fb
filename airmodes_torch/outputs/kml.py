"""KML generator for Google Earth (ref: gr-air-modes python/kml.py output_kml).

A background thread periodically re-reads the SQLite DB written by
outputs.sql and atomically rewrites a KML file with aircraft placemarks and
track lines, for a Google Earth network-link refresh.
"""

from __future__ import annotations

import os
import sqlite3
import threading
from typing import Optional, Tuple

_KML_HEADER = """<?xml version="1.0" encoding="UTF-8"?>
<kml xmlns="http://www.opengis.net/kml/2.2">
<Document>
<name>Mode S contacts</name>
<Style id="plane"><IconStyle><Icon>
<href>http://maps.google.com/mapfiles/kml/shapes/airports.png</href>
</Icon></IconStyle></Style>
"""
_KML_FOOTER = "</Document>\n</kml>\n"


def render_kml(dbname: str, localpos: Optional[Tuple[float, float]] = None) -> str:
    """One snapshot of the DB -> KML document string (placemark + track
    line per aircraft, like the reference's output_kml)."""
    db = sqlite3.connect(dbname)
    try:
        rows = db.execute(
            "SELECT p.icao, p.lat, p.lon, p.alt, a.ident FROM positions p "
            "LEFT JOIN aircraft a ON a.icao = p.icao").fetchall()
        try:
            tracks = db.execute(
                "SELECT icao, lat, lon, alt FROM track "
                "ORDER BY icao, seen").fetchall()
        except sqlite3.OperationalError:
            tracks = []          # pre-track-table database
    finally:
        db.close()
    track_by_icao = {}
    for icao, lat, lon, alt in tracks:
        track_by_icao.setdefault(icao, []).append((lat, lon, alt))
    parts = [_KML_HEADER]
    if localpos is not None:
        parts.append(
            "<Placemark><name>Receiver</name><Point><coordinates>"
            f"{localpos[1]:.6f},{localpos[0]:.6f},0</coordinates></Point></Placemark>\n")
    from ..decode.parse import format_icao
    for icao, lat, lon, alt, ident in rows:
        if lat is None or lon is None:
            continue
        name = ident or format_icao(icao)
        alt_m = (alt or 0) * 0.3048
        parts.append(
            f"<Placemark><name>{name}</name><styleUrl>#plane</styleUrl>"
            f"<description>ICAO {format_icao(icao)} alt {alt or '?'} ft</description>"
            "<Point><altitudeMode>absolute</altitudeMode><extrude>1</extrude>"
            f"<coordinates>{lon:.6f},{lat:.6f},{alt_m:.0f}</coordinates>"
            "</Point></Placemark>\n")
        hist = track_by_icao.get(icao, ())
        if len(hist) >= 2:
            coords = " ".join(
                f"{lo:.6f},{la:.6f},{(al or 0) * 0.3048:.0f}"
                for la, lo, al in hist)
            parts.append(
                f"<Placemark><name>{name} track</name><LineString>"
                "<altitudeMode>absolute</altitudeMode>"
                f"<coordinates>{coords}</coordinates>"
                "</LineString></Placemark>\n")
    parts.append(_KML_FOOTER)
    return "".join(parts)


class output_kml:
    """Thread that rewrites `filename` from `dbname` every `interval` s."""

    def __init__(self, filename: str, dbname: str,
                 localpos: Optional[Tuple[float, float]] = None,
                 interval: float = 1.0):
        self.filename = filename
        self.dbname = dbname
        self.localpos = localpos
        self.interval = interval
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def write_once(self) -> None:
        doc = render_kml(self.dbname, self.localpos)
        tmp = self.filename + ".tmp"
        with open(tmp, "w") as f:
            f.write(doc)
        os.replace(tmp, self.filename)

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.write_once()
            except (sqlite3.Error, OSError):
                continue  # drop-and-continue

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        try:
            # final rewrite: a replay shorter than one interval would
            # otherwise end with NO KML file at all (the timer never
            # fired), and a longer one would drop its last interval's
            # positions (caught by the all-plugins soak test)
            self.write_once()
        except (sqlite3.Error, OSError):
            pass
