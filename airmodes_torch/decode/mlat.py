"""Multilateration: TDOA hyperbolic positioning (ref: gr-air-modes python/mlat.py).

Locates an aircraft from the same frame observed at >= 3 (4 for full 3D)
receivers with synchronized (GPS/PPS-grade) timestamps. WGS-84 geodesy
(llh2ecef / ecef2llh / geoid height table) + iterative Gauss-Newton least
squares on pseudorange differences. Raises MlatNonConvergeError when the
solver diverges (caller drops the fix; drop-and-continue).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..exceptions import MlatNonConvergeError

C = 299792458.0  # m/s

# WGS-84
_A = 6378137.0
_F = 1.0 / 298.257223563
_E2 = _F * (2 - _F)

# Coarse geoid undulation table (meters), 20-degree grid, lat 90..-90 (rows)
# x lon -180..180 (cols) — role equivalent of the reference's geoid table
# (approximate to +-15 m; fine work should substitute EGM96).
_GEOID = np.array([
    [13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 13],
    [3, 1, -2, -3, -3, -3, -1, 3, 1, 5, 9, 11, 19, 27, 31, 34, 33, 34, 3],
    [2, 2, 1, -1, -3, -7, -14, -24, -27, -25, -19, 3, 24, 37, 47, 60, 61, 58, 2],
    [2, 9, 17, 10, 13, 1, -14, -30, -39, -46, -42, -21, 6, 29, 49, 65, 60, 57, 2],
    [-8, 8, 8, 1, -11, -19, -16, -18, -22, -35, -40, -26, -12, 24, 45, 63, 62, 59, -8],
    [-12, -10, -13, -20, -31, -34, -21, -16, -26, -34, -33, -35, -26, 2, 33, 59, 52, 51, -12],
    [-8, -10, -8, -11, -19, -17, -14, -12, -8, -18, -13, -9, -11, -5, 9, 28, 27, 22, -8],
    [-8, -9, -8, -10, -14, -12, -11, -10, -8, -13, -10, -8, -10, -6, 0, 10, 10, 7, -8],
    [-8, -8, -8, -8, -8, -8, -8, -8, -8, -8, -8, -8, -8, -8, -8, -8, -8, -8, -8],
    [-30, -30, -30, -30, -30, -30, -30, -30, -30, -30, -30, -30, -30, -30, -30, -30, -30, -30, -30],
], dtype=np.float64)


def llh2geoid(lat: float, lon: float) -> float:
    """Geoid height above the WGS-84 ellipsoid (coarse bilinear lookup)."""
    r = (90.0 - lat) / 20.0
    c = (lon + 180.0) / 20.0
    r = min(max(r, 0.0), _GEOID.shape[0] - 1.001)
    c = min(max(c, 0.0), _GEOID.shape[1] - 1.001)
    r0, c0 = int(r), int(c)
    fr, fc = r - r0, c - c0
    g = _GEOID
    return float(
        g[r0, c0] * (1 - fr) * (1 - fc) + g[r0 + 1, c0] * fr * (1 - fc) +
        g[r0, c0 + 1] * (1 - fr) * fc + g[r0 + 1, c0 + 1] * fr * fc)


def llh2ecef(llh: Sequence[float]) -> np.ndarray:
    """(lat_deg, lon_deg, alt_m above ellipsoid) -> ECEF meters."""
    lat, lon, alt = llh
    lat, lon = math.radians(lat), math.radians(lon)
    n = _A / math.sqrt(1 - _E2 * math.sin(lat) ** 2)
    return np.array([
        (n + alt) * math.cos(lat) * math.cos(lon),
        (n + alt) * math.cos(lat) * math.sin(lon),
        (n * (1 - _E2) + alt) * math.sin(lat),
    ])


def ecef2llh(xyz: Sequence[float]) -> Tuple[float, float, float]:
    """ECEF meters -> (lat_deg, lon_deg, alt_m), Bowring's method."""
    x, y, z = xyz
    lon = math.atan2(y, x)
    p = math.hypot(x, y)
    b = _A * (1 - _F)
    ep2 = (_A ** 2 - b ** 2) / b ** 2
    theta = math.atan2(z * _A, p * b)
    lat = math.atan2(z + ep2 * b * math.sin(theta) ** 3,
                     p - _E2 * _A * math.cos(theta) ** 3)
    n = _A / math.sqrt(1 - _E2 * math.sin(lat) ** 2)
    alt = p / math.cos(lat) - n if abs(math.degrees(lat)) < 89 else \
        z / math.sin(lat) - n * (1 - _E2)
    return math.degrees(lat), math.degrees(lon), alt


def mlat_iter(stations_ecef: np.ndarray, prange_rel: np.ndarray,
              guess: np.ndarray, max_iter: int = 20,
              tol_m: float = 0.5, raise_on_fail: bool = True) -> np.ndarray:
    """Gauss-Newton on TDOA residuals.

    stations_ecef: (N, 3); prange_rel: (N,) pseudoranges relative to station 0
    (c * (t_i - t_0)). Solves for position xyz minimizing the residual of
    range differences. Raises MlatNonConvergeError (unless raise_on_fail is
    False, when the best iterate is returned for outer constrained loops).
    """
    xyz = guess.astype(np.float64).copy()

    def residual(pos):
        d = np.linalg.norm(stations_ecef - pos, axis=1)
        return (d - d[0]) - prange_rel, d

    # Levenberg-Marquardt: ground-station TDOA geometry is near-singular in
    # the vertical, so undamped Gauss-Newton steps diverge wildly.
    lam = 1e-3
    resid, d = residual(xyz)
    cost = float(resid @ resid)
    for _ in range(max_iter * 4):
        u = (xyz - stations_ecef) / d[:, None]
        jac = (u - u[0])[1:]          # row 0 is identically zero
        r = resid[1:]
        a = jac.T @ jac + lam * np.eye(3)
        g = jac.T @ r
        try:
            delta = np.linalg.solve(a, -g)
        except np.linalg.LinAlgError:
            break
        new_xyz = xyz + delta
        new_resid, new_d = residual(new_xyz)
        new_cost = float(new_resid @ new_resid)
        if new_cost < cost:
            xyz, resid, d, cost = new_xyz, new_resid, new_d, new_cost
            lam = max(lam * 0.3, 1e-9)
            if np.linalg.norm(delta) < tol_m:
                return xyz
        else:
            lam *= 10.0
            if lam > 1e12:
                break
    if raise_on_fail:
        raise MlatNonConvergeError()
    return xyz


def _solve_items(items, altitude_ft, msl, constrain_alt=False):
    """Solve one station/arrival set; returns (xyz, max_abs_residual_m).

    constrain_alt pins the altitude for ANY set size (not just the
    3-station case): leave-one-out subsets need it so a 4-station subset
    is over-determined (3 TDOAs + altitude for 2 remaining unknowns) and
    its residual can identify an outlier — unconstrained it fits any
    timestamps exactly."""
    def to_ell(s):
        return (s[0], s[1], s[2] + llh2geoid(s[0], s[1])) if msl else s

    stations = np.array([llh2ecef(to_ell(s)) for s, _ in items])
    t0 = items[0][1]
    prange_rel = np.array([(t - t0) * C for _, t in items])

    # Seed above the station plane: planar ground-station geometry has a
    # mirror solution below ground; aircraft are above it.
    lat_c, lon_c, _ = ecef2llh(stations.mean(axis=0))
    und_c = llh2geoid(lat_c, lon_c) if msl else 0.0
    alt_m = (altitude_ft * 0.3048 + und_c) if altitude_ft is not None \
        else 8000.0
    guess = llh2ecef((lat_c, lon_c, alt_m))
    if altitude_ft is not None and (len(items) == 3 or constrain_alt):
        # alternating projection: Gauss-Newton step, then re-pin altitude
        xyz = guess.copy()
        for _ in range(25):
            xyz = mlat_iter(stations, prange_rel, xyz, max_iter=3,
                            tol_m=5.0, raise_on_fail=False)
            la, lo, _ = ecef2llh(xyz)
            xyz = llh2ecef((la, lo, alt_m))
    else:
        xyz = mlat_iter(stations, prange_rel, guess)
    d = np.linalg.norm(stations - xyz, axis=1)
    resid = (d - d[0]) - prange_rel
    return xyz, float(np.max(np.abs(resid)))


def mlat(replies: Dict[Tuple[float, float, float], float],
         altitude_ft: Optional[float] = None,
         alt_datum: str = "ellipsoid",
         reject_outliers: bool = False,
         max_resid_m: float = 300.0) -> Tuple[float, float, float]:
    """Solve a position from {station_llh: timestamp_s} observations.

    Seeds from the station centroid; with exactly 3 stations an altitude
    constraint (decoded AC field, feet) substitutes for the missing fourth
    observation. Returns (lat_deg, lon_deg, alt_m).

    alt_datum: "ellipsoid" treats station altitudes (and the returned
    altitude) as heights above the WGS-84 ellipsoid; "msl" treats them as
    mean-sea-level heights and applies the llh2geoid undulation both ways
    — surveyed station altitudes and the aircraft's baro altitude are
    MSL-referenced, and the ~+-50 m geoid offset otherwise skews the
    3-station constrained solve.

    reject_outliers (beyond reference): an over-determined set whose
    post-fit residual exceeds max_resid_m (one station's multipath copy /
    garbled counter silently BIASES a least-squares solve rather than
    failing it) is re-solved leaving each station out in turn; the best
    leave-one-out solution is accepted if its residual passes the bound.
    Identification needs the SUBSETS to stay over-determined (an exactly
    determined 4-station subset fits ANY timestamps with zero residual),
    by >= 2: dropping requires n >= 7, or n >= 6 with an altitude
    constraint (matching the code's can_drop — the identifiability
    floor);
    below that a failing bound refuses the fix rather than emitting a
    confidently wrong one. Size max_resid_m to the timestamp grade
    (~100 m for GPS/ns stamps; ~500 m for clock-sync-trained networks).
    """
    items = sorted(replies.items(), key=lambda kv: kv[1])
    if len(items) < 3:
        raise MlatNonConvergeError("need >= 3 stations")
    if len(items) == 3 and altitude_ft is None:
        # 2 TDOAs cannot fix 3 unknowns: the "solution" is whichever
        # point of the 1-D ambiguity curve lies nearest the 8 km seed —
        # a fiction that passes every residual gate. Refuse instead.
        raise MlatNonConvergeError(
            "3 stations need an altitude constraint")
    msl = alt_datum == "msl"

    try:
        xyz, max_resid = _solve_items(items, altitude_ft, msl)
        if altitude_ft is not None and len(items) == 3 \
                and max_resid > 500.0:
            raise MlatNonConvergeError()
    except MlatNonConvergeError:
        xyz, max_resid = None, float("inf")
        if not reject_outliers:
            raise
    # a redundant set must also FIT: a biased converged solve is worse
    # than no solve when rejection is requested
    if reject_outliers and max_resid > max_resid_m:
        n = len(items)
        # Identification needs the subsets over-determined by >= 2:
        # ground-station TDOA is near-singular in the vertical, and with
        # a single excess constraint a garbled timestamp leaks into
        # low-residual subset solves whose exclusion choice degenerates
        # to noise (stress runs: n=5+alt / n=6-no-alt picked a wrong
        # exclusion in ~20% of geometries; n=6+alt was right in 39/40).
        # Below the floor a tripped bound REFUSES the group — for an
        # online correlator stream, dropping an ambiguous group beats a
        # confidently wrong fix.
        can_drop = n >= 7 or (n >= 6 and altitude_ft is not None)
        if not can_drop:
            raise MlatNonConvergeError(
                f"residual {max_resid:.0f} m with no redundancy to drop")
        def to_ell(s):
            return (s[0], s[1], s[2] + llh2geoid(s[0], s[1])) if msl else s

        best = None
        for i in range(n):
            sub = items[:i] + items[i + 1:]
            try:
                # constrain_alt: a 4-station subset must use the
                # altitude pin or it is exactly determined (residual 0
                # for any timestamps) and identification degenerates to
                # float noise
                cand_xyz, cand_resid = _solve_items(sub, altitude_ft, msl,
                                                    constrain_alt=True)
            except MlatNonConvergeError:
                continue
            if cand_resid > max_resid_m:
                continue
            # held-out check: the EXCLUDED station must itself misfit
            # the subset's solution (it has to look like the outlier) —
            # a marginal geometry can absorb a garbled timestamp into a
            # low-residual subset solve, but then the excluded GOOD
            # station fits fine and this gate refuses the swap
            anchor_s, anchor_t = sub[0]
            d_i = float(np.linalg.norm(
                llh2ecef(to_ell(items[i][0])) - cand_xyz))
            d_a = float(np.linalg.norm(
                llh2ecef(to_ell(anchor_s)) - cand_xyz))
            heldout = abs((d_i - d_a) - (items[i][1] - anchor_t) * C)
            # margin: near-singular vertical geometry lets a garbled
            # timestamp leak into low-residual subsets whose excluded
            # GOOD station misfits by a little over the bound; require
            # the exclusion to look decisively outlier-sized (stress
            # runs: 5x cuts wrong exclusions ~an order of magnitude
            # while a real garble is typically 10x+ the bound)
            if heldout <= 5.0 * max_resid_m:
                continue
            if best is None or heldout > best[2]:
                best = (cand_xyz, cand_resid, heldout)
        if best is None:
            raise MlatNonConvergeError(
                "no single-station exclusion fits the bound")
        xyz, max_resid = best[0], best[1]
    if xyz is None:
        raise MlatNonConvergeError()
    lat, lon, alt = ecef2llh(xyz)
    if msl:
        alt -= llh2geoid(lat, lon)
    return lat, lon, alt


class mlat_coordinator:
    """Match the same frame heard by multiple receivers and solve TDOA.

    Receivers feed raw wire messages via report(station, message); frames
    with identical hex payloads within `window_s` of each other form one
    observation set, solved once >= min_stations copies arrive. The
    reference's remote-receiver story shipped raw messages over a TCP/zmq
    relay to one host, which is exactly how this is meant to be fed
    (io/relay.py + outputs/raw_server.py).
    """

    def __init__(self, stations, min_stations: int = 4,
                 window_s: float = 0.1, alt_datum: str = "ellipsoid"):
        # stations: {name: (lat, lon, alt_m)} — alt_datum "msl" if the
        # altitudes are surveyed MSL heights (see mlat())
        self.stations = {k: tuple(v) for k, v in dict(stations).items()}
        if len(set(self.stations.values())) != len(self.stations):
            # report() keys replies by position, so duplicate coordinates
            # would silently collapse two stations into one observation
            # (dict-last wins) — a misconfiguration; fail loudly at
            # startup like mlat_net.mlat_correlator does
            raise ValueError("duplicate station coordinates (same site "
                             "listed twice?)")
        self.min_stations = min_stations
        self.window_s = window_s
        self.alt_datum = alt_datum
        self._pending = {}  # hex -> {station: timestamp}
        self._seen_t = {}   # hex -> first timestamp
        self._all_ns = {}   # hex -> every arrival carried the ns field
        self._solved = {}   # hex -> group first-timestamp of the solve:
        # late copies of an already-solved transmission must not re-mint
        # a second (worse-geometry) group for the same frame
        self._since_prune = 0
        # internal times are epoch-relative (see mlat_net.epoch_timebase
        # for the float64-precision rationale; shared with the correlator)
        from .mlat_net import epoch_timebase
        self._tb = epoch_timebase()

    def report(self, station: str, message: str):
        """Feed one wire message from a named station; returns a position
        (lat, lon, alt_m) when this message completes an observation set.
        Malformed messages are dropped (network input from remote
        receivers is untrusted; drop-and-continue)."""
        # shared untrusted-input gate + epoch anchoring (mlat_net module;
        # two hand-kept copies drifted twice before they were extracted)
        from .mlat_net import parse_wire_obs
        obs = parse_wire_obs(message)
        if obs is None or station not in self.stations:
            return None
        hexframe, t_abs, ns = obs
        # rel() anchors from ns when present — a non-finite float field
        # must not block (or crash) an otherwise ns-grade message
        t = self._tb.rel(t_abs, ns)
        if not math.isfinite(t):
            return None     # float('nan'/'inf') parses; NaN would sail
            # through every window/residual comparison (NaN > x is False)
            # and come back as a (nan, nan, nan) "fix"
        # bound _pending in a long-running coordinator even if the caller
        # never invokes prune()
        self._since_prune += 1
        if self._since_prune >= 256:
            self._since_prune = 0
            self.prune(t)
        sol_t = self._solved.get(hexframe)
        if sol_t is not None and abs(t - sol_t) <= self.window_s:
            # a late copy of an ALREADY-solved transmission: re-creating
            # a group here would mint a second position for one frame
            # from only the late (geometrically worse) subset
            return None
        obs = self._pending.setdefault(hexframe, {})
        first = self._seen_t.setdefault(hexframe, t)
        if t - first > self.window_s:
            # stale duplicate from a much later retransmission: start over
            self._pending[hexframe] = obs = {}
            self._seen_t[hexframe] = first = t
            self._all_ns.pop(hexframe, None)
        elif first - t > self.window_s:
            # the mirror case (cf. mlat_correlator.feed): a lagged feed
            # delivering a copy of an EARLIER transmission must not wipe
            # the in-progress group — drop the stale copy instead of
            # resetting (repeated identical DF4/DF11 transmissions arrive
            # seconds apart)
            return None
        if station not in obs or t < obs[station]:
            # keep the EARLIEST arrival per station: a later own-multipath
            # copy is ~us late (= km of pseudorange); same rule as
            # mlat_correlator.feed (last-wins silently
            # diverged)
            obs[station] = t
        self._all_ns[hexframe] = self._all_ns.get(hexframe, True) \
            and ns is not None
        if len(obs) < self.min_stations:
            return None
        replies = {self.stations[s]: ts for s, ts in obs.items()}
        all_ns = self._all_ns.pop(hexframe, False)
        del self._pending[hexframe]
        del self._seen_t[hexframe]
        self._solved[hexframe] = first
        # altitude constraint from the frame itself when decodable
        # (function-level import: mlat_net imports this module at top)
        from .mlat_net import _frame_altitude_ft
        alt_ft = _frame_altitude_ft(hexframe)
        try:
            # residual bound follows the timestamp grade: ns-stamped
            # feeds have ~0 genuine residual, float-only wires carry the
            # ~238 ns quantization (~70 m pseudorange) per station
            return mlat(replies, altitude_ft=alt_ft,
                        alt_datum=self.alt_datum, reject_outliers=True,
                        max_resid_m=100.0 if all_ns else 300.0)
        except MlatNonConvergeError:
            return None

    def prune(self, now: float):
        for h in [h for h, t in self._seen_t.items()
                  if now - t > 10 * self.window_s]:
            self._pending.pop(h, None)
            self._seen_t.pop(h, None)
            self._all_ns.pop(h, None)
        for h in [h for h, t in self._solved.items()
                  if now - t > 10 * self.window_s]:
            del self._solved[h]
