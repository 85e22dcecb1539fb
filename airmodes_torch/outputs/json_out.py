"""Periodic JSON snapshot of the live aircraft state (beyond reference).

Writes a dump1090-style `aircraft.json` every `interval_s` of stream
time — the format web map frontends and feeder networks consume. Rides
the same dashboard model the GUI uses; written atomically (tmp + rename)
so a reader never sees a torn file.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from ..decode.parse import format_icao, parse
from ..exceptions import ADSBError
from .gui_model import dashboard


def build_doc(dash: dashboard, now: float, prune: bool = True) -> dict:
    """dump1090 aircraft.json document from the live dashboard state.

    Prunes stale aircraft first (prune=False for display-estimate
    rebuilds whose `now` is wall-extrapolated, not stream time — see
    httpd.aircraft_doc); shared by the file writer here and the embedded
    HTTP server (outputs/httpd.py)."""
    with dash.lock:
        if prune:
            dash.prune(now)
        return _doc_locked(dash, now)


def _doc_locked(dash: dashboard, now: float) -> dict:
    return {
        "now": now,
        "aircraft": [
            {k: v for k, v in {
                "hex": format_icao(st.icao),
                "flight": st.ident,
                "squawk": None if st.squawk is None
                else f"{st.squawk:04d}",
                "alt_baro": st.altitude_ft,
                "alt_geom": st.altitude_geom_ft,
                "gs": st.speed_kt,
                "track": st.heading_deg,
                "baro_rate": st.vertical_rate_fpm,
                "lat": st.lat,
                "lon": st.lon,
                "rssi": st.rssi_dbfs,
                "emergency": st.emergency,
                "messages": st.n_messages,
                "seen": round(now - st.last_seen, 3),
            }.items() if v is not None}
            for st in sorted(dash.aircraft.values(), key=lambda s: s.icao)
        ],
    }


class output_json:
    """Plugin: call output(msg) per raw wire message."""

    def __init__(self, path: str, parser: Optional[parse] = None,
                 interval_s: float = 1.0, stale_s: float = 60.0):
        self.path = path
        self._parser = parser or parse()
        self._dash = dashboard(stale_s=stale_s)
        self.interval_s = interval_s
        self._last_write = None
        self.n_writes = 0

    def output(self, msg: str) -> None:
        try:
            rep = self._parser.parse(msg)
        except ADSBError:
            return
        self._dash.update(rep)
        now = rep.timestamp
        # also rewrite when stream time stepped BACKWARDS by more than an
        # interval (replay restart, feed switch with a different epoch):
        # otherwise writes stall until stream time catches the old
        # high-water mark. The hysteresis matters: multichannel runs
        # interleave channels whose timestamps routinely regress by one
        # block step, which must NOT defeat the once-per-interval
        # throttle with a disk write per message
        if self._last_write is None or \
                now - self._last_write >= self.interval_s or \
                now < self._last_write - self.interval_s:
            self._write(now)

    def _write(self, now: float) -> None:
        doc = build_doc(self._dash, now)
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, self.path)
        except OSError:
            return  # monitoring output must never take down the receive
            # chain (same policy as wx/_emit_stats_json); retry next tick
        self._last_write = now
        self.n_writes += 1

    def close(self) -> None:
        # `latest` is None before any report; a truthy check would also
        # skip the final write of an epoch-0 replay (timestamp 0.0)
        if self._dash.latest is not None:
            self._write(self._dash.latest)
