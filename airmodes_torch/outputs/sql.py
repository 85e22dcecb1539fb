"""SQLite logger (ref: gr-air-modes python/sql.py output_sql).

Creates tables aircraft/positions/vectors and INSERT OR REPLACEs each decoded
report; a threading.Lock serializes access to the shared connection, matching
the reference's concurrency discipline (SURVEY.md §5.2).
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Optional

from ..decode.parse import AircraftReport, parse
from ..exceptions import ADSBError

_SCHEMA = """
CREATE TABLE IF NOT EXISTS aircraft (
    icao INTEGER PRIMARY KEY,
    seen REAL,
    ident TEXT,
    category INTEGER
);
CREATE TABLE IF NOT EXISTS positions (
    icao INTEGER PRIMARY KEY,
    seen REAL,
    lat REAL,
    lon REAL,
    alt INTEGER
);
CREATE TABLE IF NOT EXISTS vectors (
    icao INTEGER PRIMARY KEY,
    seen REAL,
    speed REAL,
    heading REAL,
    vertical REAL
);
CREATE TABLE IF NOT EXISTS squawks (
    icao INTEGER PRIMARY KEY,
    seen REAL,
    squawk INTEGER
);
CREATE TABLE IF NOT EXISTS track (
    icao INTEGER,
    seen REAL,
    lat REAL,
    lon REAL,
    alt INTEGER
);
CREATE INDEX IF NOT EXISTS track_icao ON track (icao, seen);
CREATE INDEX IF NOT EXISTS track_seen ON track (seen);
"""


class output_sql:
    def __init__(self, dbname: str, parser: Optional[parse] = None,
                 lock: Optional[threading.Lock] = None,
                 track_keep_s: float = 1800.0):
        self._parser = parser or parse()
        self._lock = lock or threading.Lock()
        self._track_keep_s = track_keep_s
        self._since_prune = 0
        self._since_commit = 0
        import time as _time
        self._last_commit = _time.monotonic()
        self._db = sqlite3.connect(dbname, check_same_thread=False)
        with self._lock:
            self._db.executescript(_SCHEMA)
            self._db.commit()

    def output(self, msg: str) -> None:
        try:
            rep = self._parser.parse(msg)
        except ADSBError:
            return
        self.insert(rep)

    def insert(self, rep: AircraftReport) -> None:
        if rep.icao is None:
            return
        with self._lock:
            self._db.execute(
                "INSERT INTO aircraft (icao, seen) VALUES (?, ?) "
                "ON CONFLICT(icao) DO UPDATE SET seen=excluded.seen",
                (rep.icao, rep.timestamp))
            if rep.callsign:
                self._db.execute(
                    "UPDATE aircraft SET ident=?, category=? WHERE icao=?",
                    (rep.callsign, rep.category, rep.icao))
            if rep.lat is not None:
                # alt columns are BAROMETRIC (the routing policy every
                # other consumer follows): TC20-22 GNSS HAE differs by
                # geoid+pressure offsets and flip-flopped KML track
                # altitudes by hundreds of ft
                baro = None if rep.altitude_gnss else rep.altitude_ft
                self._db.execute(
                    "INSERT INTO positions (icao, seen, lat, lon, alt) "
                    "VALUES (?, ?, ?, ?, ?) ON CONFLICT(icao) DO UPDATE "
                    "SET seen=excluded.seen, lat=excluded.lat, "
                    "lon=excluded.lon, alt=COALESCE(excluded.alt, alt)",
                    (rep.icao, rep.timestamp, rep.lat, rep.lon, baro))
                # position HISTORY feeds the KML track lines (the
                # reference's kml.py draws tracks); bounded by age
                self._db.execute(
                    "INSERT INTO track (icao, seen, lat, lon, alt) "
                    "VALUES (?, ?, ?, ?, ?)",
                    (rep.icao, rep.timestamp, rep.lat, rep.lon, baro))
                self._since_prune += 1
                if self._since_prune >= 256:
                    self._since_prune = 0
                    self._db.execute(
                        "DELETE FROM track WHERE seen < ?",
                        (rep.timestamp - self._track_keep_s,))
            if rep.speed_kt is not None or rep.vertical_rate_fpm is not None \
                    or rep.heading_deg is not None:
                # heading-only reports (BDS0,6 mov=0 / BDS0,9 sub 3-4)
                # must persist too
                # merge, don't replace: a vertical-rate-only report must not
                # null out the last known speed/heading (and vice versa)
                self._db.execute(
                    "INSERT INTO vectors (icao, seen, speed, heading, vertical) "
                    "VALUES (?, ?, ?, ?, ?) ON CONFLICT(icao) DO UPDATE SET "
                    "seen=excluded.seen, "
                    "speed=COALESCE(excluded.speed, speed), "
                    "heading=COALESCE(excluded.heading, heading), "
                    "vertical=COALESCE(excluded.vertical, vertical)",
                    (rep.icao, rep.timestamp, rep.speed_kt, rep.heading_deg,
                     rep.vertical_rate_fpm))
            if rep.squawk is not None:
                self._db.execute(
                    "INSERT OR REPLACE INTO squawks (icao, seen, squawk) "
                    "VALUES (?, ?, ?)", (rep.icao, rep.timestamp, rep.squawk))
            # batch commits: one journal write per message put synchronous
            # disk I/O on the decode fan-out thread at traffic rates;
            # readers (kml thread, tests) see data at most
            # ~1 s / 64 inserts late, and close() flushes the tail
            self._since_commit += 1
            import time as _time
            now = _time.monotonic()
            if self._since_commit >= 64 or now - self._last_commit >= 1.0:
                self._db.commit()
                self._since_commit = 0
                self._last_commit = now

    def flush(self) -> None:
        """Commit any batched tail now (readers on separate connections
        see only committed data — the kml final rewrite flushes before
        rendering)."""
        with self._lock:
            self._db.commit()
            self._since_commit = 0

    def close(self) -> None:
        with self._lock:
            self._db.commit()
            self._db.close()
