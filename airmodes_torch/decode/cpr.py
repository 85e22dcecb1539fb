"""Compact Position Reporting decode/encode (ref: gr-air-modes python/cpr.py).

Implements airborne (360-degree zones) and surface (90-degree zones) CPR:
  - nl(lat): number of longitude zones, closed form with NZ = 15
  - global decode from an even/odd frame pair (rejecting NL boundary straddles)
  - local decode from one frame plus a reference position
  - `cpr_decoder`: per-ICAO even/odd frame cache with timestamp pairing window,
    staleness eviction, and range sanity check vs. the receiver location
  - cpr_encode for golden-capture generation and the self-test vectors

Angles in degrees; 17-bit encoded lat/lon.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional, Tuple

from ..exceptions import CPRBoundaryStraddleError, CPRNoPositionError

NZ = 15
NBITS = 17
SCALE = float(1 << NBITS)

# Pairing/eviction windows (seconds); the reference pairs frames ~10 s apart.
PAIR_WINDOW_S = 10.0
EVICT_S = 60.0
# Reject fixes farther than this from the receiver (ref discards > ~180-250 NM).
MAX_RANGE_NM = 250.0

_NM_PER_DEG_LAT = 60.0


def nl(declat: float) -> int:
    """Number of longitude zones at a given latitude (closed form)."""
    if abs(declat) >= 87.0:
        return 2 if abs(declat) == 87.0 else 1
    if declat == 0.0:
        return 59
    a = 1 - math.cos(math.pi / (2 * NZ))
    b = math.cos(math.pi / 180.0 * abs(declat)) ** 2
    return int(math.floor(2 * math.pi / math.acos(1 - a / b)))


def _dlat(odd: bool, surface: bool) -> float:
    span = 90.0 if surface else 360.0
    return span / (4 * NZ - (1 if odd else 0))


def _dlon(declat: float, odd: bool, surface: bool) -> float:
    span = 90.0 if surface else 360.0
    n = max(nl(declat) - (1 if odd else 0), 1)
    return span / n


def cpr_mod(a: float, b: float) -> float:
    return a - b * math.floor(a / b)


def cpr_encode(lat: float, lon: float, odd: bool, surface: bool) -> Tuple[int, int]:
    """Encode lat/lon into 17-bit CPR YZ, XZ (ref: cpr.py cpr_encode)."""
    dlat = _dlat(odd, surface)
    yz = math.floor(SCALE * cpr_mod(lat, dlat) / dlat + 0.5)
    rlat = dlat * (yz / SCALE + math.floor(lat / dlat))
    dlon = _dlon(rlat, odd, surface)
    xz = math.floor(SCALE * cpr_mod(lon, dlon) / dlon + 0.5)
    return int(yz) & 0x1FFFF, int(xz) & 0x1FFFF


def decode_global(
    even: Tuple[int, int], odd: Tuple[int, int], most_recent_odd: bool,
    surface: bool = False, ref: Optional[Tuple[float, float]] = None,
) -> Tuple[float, float]:
    """Global decode from an even/odd (YZ, XZ) pair.

    Raises CPRBoundaryStraddleError when the pair straddles an NL boundary.
    For surface frames a reference position is required to resolve the
    90-degree quadrant ambiguity.
    """
    yz0, xz0 = even
    yz1, xz1 = odd
    lat0, lat1 = yz0 / SCALE, yz1 / SCALE
    dlat0 = _dlat(False, surface)
    dlat1 = _dlat(True, surface)

    j = math.floor(59 * lat0 - 60 * lat1 + 0.5)
    rlat0 = dlat0 * (cpr_mod(j, 60) + lat0)
    rlat1 = dlat1 * (cpr_mod(j, 59) + lat1)
    if surface:
        if ref is None:
            raise CPRNoPositionError("surface global decode needs a reference")
        # Resolve the 2-fold latitude ambiguity toward the reference BEFORE
        # any NL use: surface rlat lands in [0, 90) (the northern image); a
        # southern receiver's true latitude is that minus 90, and e.g.
        # nl(56) != nl(-34) — a zone count from the wrong hemisphere decodes
        # longitude into the wrong zone and corrupts the straddle check.
        if abs(rlat0 - 90.0 - ref[0]) < abs(rlat0 - ref[0]):
            rlat0 -= 90.0
        if abs(rlat1 - 90.0 - ref[0]) < abs(rlat1 - ref[0]):
            rlat1 -= 90.0
    else:
        if rlat0 >= 270:
            rlat0 -= 360
        if rlat1 >= 270:
            rlat1 -= 360
        if not (-90.0 <= rlat0 <= 90.0 and -90.0 <= rlat1 <= 90.0):
            # inconsistent even/odd pair (bit errors that survived ECC, or
            # an ICAO collision): an impossible latitude, not a position
            raise CPRNoPositionError(
                f"inconsistent pair: latitude {rlat0:.1f}/{rlat1:.1f}")
    if nl(rlat0) != nl(rlat1):
        raise CPRBoundaryStraddleError()

    rlat = rlat1 if most_recent_odd else rlat0
    odd_f = most_recent_odd
    nlv = nl(rlat)
    ni = max(nlv - (1 if odd_f else 0), 1)
    dlon = (90.0 if surface else 360.0) / ni
    lonf = (xz1 if odd_f else xz0) / SCALE
    m = math.floor((xz0 / SCALE) * (nlv - 1) - (xz1 / SCALE) * nlv + 0.5)
    rlon = dlon * (cpr_mod(m, ni) + lonf)
    if not surface:
        if rlon > 180:
            rlon -= 360
    else:
        # surface: latitude is already hemisphere-resolved above; pick the
        # 90-degree longitude image nearest the reference
        rlon = _nearest_surface_lon(rlon, ref[1])
    return rlat, rlon


def _nearest_surface_lon(rlon: float, ref_lon: float) -> float:
    best = None
    for k in range(4):
        lo = cpr_mod(rlon + k * 90.0 + 180.0, 360.0) - 180.0
        d = abs(cpr_mod(lo - ref_lon + 180.0, 360.0) - 180.0)
        if best is None or d < best[0]:
            best = (d, lo)
    return best[1]


def decode_local(
    frame: Tuple[int, int], odd: bool, ref: Tuple[float, float],
    surface: bool = False,
) -> Tuple[float, float]:
    """Local decode: nearest solution to `ref` within half a zone."""
    yz, xz = frame
    ref_lat, ref_lon = ref
    dlat = _dlat(odd, surface)
    j = math.floor(ref_lat / dlat) + math.floor(
        0.5 + cpr_mod(ref_lat, dlat) / dlat - yz / SCALE)
    rlat = dlat * (j + yz / SCALE)
    dlon = _dlon(rlat, odd, surface)
    m = math.floor(ref_lon / dlon) + math.floor(
        0.5 + cpr_mod(ref_lon, dlon) / dlon - xz / SCALE)
    rlon = dlon * (m + xz / SCALE)
    return rlat, rlon


def range_bearing(loc_a: Tuple[float, float], loc_b: Tuple[float, float]) -> Tuple[float, float]:
    """(range_nm, bearing_deg) from loc_a to loc_b, equirectangular approx
    (matches the reference's small-angle range/bearing math)."""
    lat_a, lon_a = loc_a
    lat_b, lon_b = loc_b
    dlat = (lat_b - lat_a) * _NM_PER_DEG_LAT
    dlon = (cpr_mod(lon_b - lon_a + 180.0, 360.0) - 180.0) * _NM_PER_DEG_LAT * \
        math.cos(math.radians((lat_a + lat_b) / 2))
    rng = math.hypot(dlat, dlon)
    bearing = math.degrees(math.atan2(dlon, dlat)) % 360.0
    return rng, bearing


class cpr_decoder:
    """Stateful per-ICAO CPR decoder (ref: cpr.py class cpr_decoder).

    decode(icao, encoded_lat, encoded_lon, cpr_format, surface, timestamp)
      -> (lat, lon, range_nm_or_None, bearing_or_None)
    Raises CPRNoPositionError / CPRBoundaryStraddleError when unresolvable.
    """

    def __init__(self, my_location: Optional[Tuple[float, float]] = None,
                 max_range_nm: float = MAX_RANGE_NM,
                 global_first: bool = False):
        """global_first=True: an aircraft's FIRST position requires an
        even/odd global pair; single frames local-decode only against the
        aircraft's own cached position, never against my_location. A
        receiver-referenced local decode is ambiguity-limited: the decoder
        returns the zone image nearest the reference, so an aircraft
        beyond half a zone (~180 NM airborne, ~45 NM surface) decodes to
        an ALIASED position that is — by construction — always inside the
        range gate, which therefore cannot reject it. The default keeps
        the reference's behavior (immediate first fix via my_location,
        self-corrected once a pair completes); global_first trades ~1
        pairing interval of first-fix latency for alias immunity."""
        self.my_location = my_location
        self.max_range_nm = max_range_nm
        self.global_first = global_first
        # icao -> {0: (yz, xz, t), 1: (yz, xz, t)}
        self.lkplist: Dict[int, dict] = {}
        # icao -> (lat, lon, t): last known position for local decode
        self.poslist: Dict[int, Tuple[float, float, float]] = {}
        self._since_maintain = 0

    def maintain(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        for icao in list(self.lkplist):
            newest = max(v[2] for v in self.lkplist[icao].values())
            if now - newest > EVICT_S:
                del self.lkplist[icao]
        for icao in list(self.poslist):
            if now - self.poslist[icao][2] > EVICT_S:
                del self.poslist[icao]

    def _check_range(self, lat: float, lon: float):
        if self.my_location is None:
            return None, None
        rng, brg = range_bearing(self.my_location, (lat, lon))
        if rng > self.max_range_nm:
            raise CPRNoPositionError(f"position {rng:.0f} NM out of range")
        return rng, brg

    def decode(self, icao: int, encoded_lat: int, encoded_lon: int,
               cpr_format: int, surface: bool = False,
               timestamp: Optional[float] = None):
        t = time.time() if timestamp is None else timestamp
        frames = self.lkplist.setdefault(icao, {})
        frames[int(cpr_format)] = (encoded_lat, encoded_lon, t,
                                   bool(surface))
        # Prune the other parity once it can no longer pair with anything
        # current (the reference prunes stale frames inside decode): a stale
        # even/odd pair must not block the my_location local-decode fallback
        # below, and lkplist must not grow without bound in a long-running
        # receiver. maintain() additionally evicts idle aircraft. A parity
        # cached from the OTHER format family is pruned too: an air/ground
        # transition otherwise global-decodes a mixed airborne/surface pair
        # (6 deg vs 1.5 deg zone sizes) into an arbitrary position that can
        # pass every sanity gate.
        other = 1 - int(cpr_format)
        if other in frames and (abs(t - frames[other][2]) > PAIR_WINDOW_S
                                or frames[other][3] != bool(surface)):
            del frames[other]
        self._since_maintain += 1
        if self._since_maintain >= 128:
            self._since_maintain = 0
            self.maintain(t)

        lat = lon = None
        # Prefer local decode when we have a recent position or receiver loc.
        ref = None
        ref_is_own = False    # ref is this aircraft's own cached position
        if icao in self.poslist and t - self.poslist[icao][2] < EVICT_S:
            ref = self.poslist[icao][:2]
            ref_is_own = True
        elif self.my_location is not None and (surface or 0 not in frames or 1 not in frames):
            ref = self.my_location

        if 0 in frames and 1 in frames and \
                abs(frames[0][2] - frames[1][2]) <= PAIR_WINDOW_S and not (
                    surface and ref is None):
            try:
                lat, lon = decode_global(
                    frames[0][:2], frames[1][:2],
                    most_recent_odd=frames[1][2] >= frames[0][2],
                    surface=surface, ref=ref if surface else None)
            except CPRBoundaryStraddleError:
                # an aircraft flying along an NL zone boundary straddles
                # on EVERY pair — without this fallback its positions
                # black out for the whole crossing even with a fresh own
                # position cached. Own-position local decode
                # is alias-safe (the aircraft moved << half a zone).
                if not ref_is_own:
                    raise
                lat, lon = decode_local(
                    (encoded_lat, encoded_lon), bool(cpr_format), ref,
                    surface)
        elif ref is not None and (ref_is_own or not self.global_first):
            # my_location-referenced local decode is zone-alias-limited
            # (see __init__); global_first restricts it to own-position
            # references. Surface global decode above still uses
            # my_location, but only to pick among 90-degree images.
            lat, lon = decode_local(
                (encoded_lat, encoded_lon), bool(cpr_format), ref, surface)
        else:
            raise CPRNoPositionError("no even/odd pair and no reference position")

        rng, brg = self._check_range(lat, lon)
        self.poslist[icao] = (lat, lon, t)
        return lat, lon, rng, brg
