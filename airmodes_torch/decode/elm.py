"""Comm-D downlink ELM segment reassembly (DF24).

The reference carries DF24 raw (python/parse.py's DF24 layout
[df:2, ke:1, nd:4, md:80, ap:24] is extracted but never decoded) — this
module exceeds it the same way decode/commb.py does for Comm-B registers.

A downlink ELM is a burst of up to 16 DF24 segments from one aircraft,
each carrying 80 bits (10 bytes) of MD payload tagged with its segment
number ND; KE distinguishes a downlink ELM transmission from an uplink
ELM acknowledgement. Only the interrogator that commanded the ELM knows
the expected segment count, so a passive receiver reassembles by cycle:
segments accumulate per ICAO, and a contiguous run 0..max is emitted when
(a) a segment REPEATS (the transponder restarted the cycle), or (b) the
aircraft goes idle past a timeout (`flush`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

# KE=0: downlink ELM transmission (Comm-D segment); KE=1: uplink ELM ack
KE_DOWNLINK = 0
KE_UPLINK_ACK = 1

SEGMENT_BYTES = 10          # 80-bit MD field
MAX_SEGMENTS = 16           # 4-bit ND


@dataclasses.dataclass
class _Cycle:
    segs: Dict[int, bytes] = dataclasses.field(default_factory=dict)
    last_t: float = 0.0

    def assembled(self) -> Optional[bytes]:
        """The contiguous run 0..max, or None if segment 0 is missing or
        the run has a hole (a partial ELM is worthless: MD is opaque
        binary, a gap shifts everything after it)."""
        if not self.segs or 0 not in self.segs:
            return None
        n = max(self.segs)
        if len(self.segs) != n + 1:
            return None
        return b"".join(self.segs[i] for i in range(n + 1))


class elm_reassembler:
    """Per-ICAO Comm-D segment buffer with cycle-restart + idle emission."""

    def __init__(self, timeout_s: float = 5.0, max_aircraft: int = 256):
        self.timeout_s = timeout_s
        self.max_aircraft = max_aircraft
        self._buf: Dict[int, _Cycle] = {}

    def add(self, icao: int, ke: int, nd: int, md: int,
            timestamp: float) -> Optional[bytes]:
        """Feed one DF24 segment; returns the PREVIOUS cycle's assembled
        payload when this segment restarts the cycle, else None. Uplink
        acknowledgements (KE=1) carry no MD payload and are ignored."""
        if ke != KE_DOWNLINK:
            return None
        md_bytes = int(md).to_bytes(SEGMENT_BYTES, "big")
        cyc = self._buf.get(icao)
        out = None
        if cyc is not None and timestamp - cyc.last_t > self.timeout_s:
            # idle-timeout cycle boundary for ANY segment number: a new
            # cycle's fresh segments otherwise merged into stale leftovers
            # and minted a "complete" payload spliced from two different
            # ELM transmissions (the repeat branch below
            # already honored the timeout, new-nd segments did not)
            out = cyc.assembled()
            cyc = None
        elif cyc is not None and nd in cyc.segs:
            if cyc.segs[nd] == md_bytes:
                cyc.last_t = timestamp      # pure repeat: retransmission
                return None
            out = cyc.assembled()           # cycle restart: emit previous
            cyc = None
        if cyc is None:
            if icao not in self._buf:
                # eviction is only needed for a NET insert: a restart
                # replaces the aircraft's existing slot, and evicting
                # here dropped an unrelated aircraft's in-progress ELM
                # on every at-capacity restart
                self._evict(timestamp)
            cyc = self._buf[icao] = _Cycle()
        cyc.segs[nd] = md_bytes
        cyc.last_t = timestamp
        return out

    def flush(self, now: float, icao: Optional[int] = None,
              force: bool = False) -> List[Tuple[int, bytes]]:
        """Emit (and clear) complete cycles idle for > timeout_s; with
        force=True emit regardless of age (end of stream). Restricting to
        one `icao` flushes only that aircraft."""
        out: List[Tuple[int, bytes]] = []
        for key in list(self._buf):
            if icao is not None and key != icao:
                continue
            cyc = self._buf[key]
            if force or now - cyc.last_t > self.timeout_s:
                data = cyc.assembled()
                if data is not None:
                    out.append((key, data))
                del self._buf[key]
        return out

    def _evict(self, now: float) -> None:
        """Bound memory: drop the stalest aircraft when over capacity
        (incomplete cycles are discarded — same drop-and-continue posture
        as the rest of the decode stack)."""
        while len(self._buf) >= self.max_aircraft:
            stalest = min(self._buf, key=lambda k: self._buf[k].last_t)
            del self._buf[stalest]
