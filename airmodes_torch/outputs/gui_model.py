"""Live aircraft dashboard (ref: gr-air-modes python/gui_model.py).

Headless data model: a per-ICAO aggregator with staleness eviction feeding a
row-oriented table (the reference wraps this in a Qt QAbstractTableModel; the
optional Qt wrapper lives in apps/modes_gui.py and degrades gracefully when
PyQt is absent).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

from ..constants import AP_ADDRESS_DFS
from ..decode.parse import AircraftReport, parse
from ..exceptions import ADSBError

COLUMNS = ["icao", "ident", "squawk", "altitude_ft", "speed_kt",
           "heading_deg", "vertical_rate_fpm", "lat", "lon", "range_nm",
           "bearing_deg", "emergency", "rssi_dbfs", "last_seen"]


@dataclasses.dataclass
class AircraftState:
    icao: int
    ident: Optional[str] = None
    squawk: Optional[int] = None
    altitude_ft: Optional[int] = None        # barometric
    altitude_geom_ft: Optional[int] = None   # GNSS HAE (TC20-22)
    speed_kt: Optional[float] = None
    heading_deg: Optional[float] = None
    vertical_rate_fpm: Optional[float] = None
    lat: Optional[float] = None
    lon: Optional[float] = None
    range_nm: Optional[float] = None
    bearing_deg: Optional[float] = None
    emergency: Optional[str] = None
    rssi_dbfs: Optional[float] = None
    last_seen: float = 0.0
    n_messages: int = 0

    def row(self) -> List:
        from ..decode.parse import format_icao
        # display altitude: baro when known, else GNSS HAE (TC20-22-only
        # emitters still show an altitude in the table)
        alt = self.altitude_ft if self.altitude_ft is not None \
            else self.altitude_geom_ft
        return [format_icao(self.icao), self.ident, self.squawk, alt,
                self.speed_kt, self.heading_deg, self.vertical_rate_fpm,
                self.lat, self.lon, self.range_nm, self.bearing_deg,
                self.emergency, self.rssi_dbfs, self.last_seen]


class dashboard:
    """Per-ICAO live state keyed by address, with staleness eviction.

    icao_gate (default on; beyond reference): an AP-overlaid frame
    (DF0/4/5/16/20/21 — address recovered from the parity field, so CRC
    cannot validate it) only creates a NEW aircraft if its address was
    recently seen in a CRC-validated frame (DF11/17/18). A corrupted
    marginal frame otherwise mints a phantom aircraft whose 'address' is
    its error syndrome — bench-measured at ~1 phantom per few seconds of
    busy 15 dB traffic. Existing aircraft still take AP-overlaid updates
    (altitude/squawk), matching dump1090-class receiver behavior."""

    def __init__(self, stale_s: float = 60.0, icao_gate: bool = True):
        self.stale_s = stale_s
        self.icao_gate = icao_gate
        # update() runs on feed/net-client threads while rows()/prune()
        # run on UI threads (modes_gui) — unlocked dict iterate+insert
        # crashes with RuntimeError. RLock so build_doc (which prunes
        # under this lock via callers) can nest.
        self.lock = threading.RLock()
        self.aircraft: Dict[int, AircraftState] = {}
        self._validated: Dict[int, float] = {}  # icao -> last validated t
        self.n_gated = 0
        self._latest = 0.0          # newest wire timestamp seen
        self._n_updates = 0

    @property
    def latest(self) -> Optional[float]:
        """Newest wire timestamp seen, or None before any report — epoch-0
        replays legitimately leave _latest == 0.0, so a truthiness check
        cannot distinguish 'no data' from 'timestamp 0.0'."""
        return self._latest if self._n_updates else None

    def update(self, rep: AircraftReport,
               trusted: bool = False) -> Optional[AircraftState]:
        """trusted=True bypasses (and trains) the icao gate: the report's
        address was verified by other means than a frame CRC — e.g. an
        mlat solution, which required the same bits at >= 3 stations."""
        if rep.icao is None:
            return None
        with self.lock:
            return self._update_locked(rep, trusted)

    def _update_locked(self, rep: AircraftReport,
                       trusted: bool) -> Optional[AircraftState]:
        if trusted or rep.df not in AP_ADDRESS_DFS:
            self._validated[rep.icao] = rep.timestamp
        elif self.icao_gate and rep.icao not in self.aircraft \
                and rep.icao not in self._validated:
            self.n_gated += 1
            return None
        st = self.aircraft.setdefault(rep.icao, AircraftState(icao=rep.icao))
        st.last_seen = rep.timestamp
        self._latest = max(self._latest, rep.timestamp)
        self._n_updates += 1
        if rep.ref_dbfs:
            # 0.0 dBFS is the no-measurement placeholder (counter-less
            # AVR records, mlat solutions) — a real full-scale reading is
            # physically implausible; letting it through clobbered real
            # rssi with "full scale" in every table
            st.rssi_dbfs = rep.ref_dbfs
        st.n_messages += 1
        if rep.altitude_ft is not None:
            # GNSS HAE (TC20-22) must not overwrite barometric altitude:
            # the two differ by geoid + pressure offsets (hundreds of ft)
            # and flip-flopping between them corrupts every baro-labeled
            # output
            if rep.altitude_gnss:
                st.altitude_geom_ft = rep.altitude_ft
            else:
                st.altitude_ft = rep.altitude_ft
        for attr in ("squawk", "speed_kt", "heading_deg",
                     "vertical_rate_fpm", "lat", "lon", "range_nm",
                     "bearing_deg"):
            v = getattr(rep, attr)
            if v is not None:
                setattr(st, attr, v)
        if rep.callsign:
            st.ident = rep.callsign
        if rep.emergency is not None:
            st.emergency = None if rep.emergency == "none" else rep.emergency
        return st

    def prune(self, now: Optional[float] = None) -> None:
        # default to the newest WIRE timestamp, not wall clock: last_seen is
        # wire-timestamp based, and file replays run with epoch 0.0 — a
        # wall-clock default would evict every aircraft immediately
        now = self._latest if now is None else now
        with self.lock:
            for icao in [k for k, v in self.aircraft.items()
                         if now - v.last_seen > self.stale_s]:
                del self.aircraft[icao]
            for icao in [k for k, t in self._validated.items()
                         if now - t > self.stale_s]:
                del self._validated[icao]

    def rows(self) -> List[List]:
        with self.lock:
            return [st.row() for st in
                    sorted(self.aircraft.values(), key=lambda s: s.icao)]


class output_dashboard:
    """Plugin adapter: raw wire string -> dashboard update."""

    def __init__(self, model: Optional[dashboard] = None,
                 parser: Optional[parse] = None):
        self.model = model or dashboard()
        self._parser = parser or parse()

    def output(self, msg: str) -> None:
        try:
            rep = self._parser.parse(msg)
        except ADSBError:
            return
        self.model.update(rep)
