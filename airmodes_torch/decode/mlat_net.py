"""Multi-receiver frame correlator for multilateration (SURVEY.md §3.5).

The reference's mlat story: N receivers with PPS-disciplined timestamps
observe the same Mode S frame; matching on the hex payload gives one
{station_position: arrival_time} set per frame, which python/mlat.py's
TDOA solver turns into a position. The reference left the correlation to
offline scripts; this module is the online correlator the modes_mlat app
drives: feed it each station's wire messages, it groups identical frames
arriving within the light-travel window and solves once enough stations
have reported.

Precision note: wire timestamps are float64 absolute seconds, whose ulp at
unix-epoch magnitude is ~0.24 us (~70 m of pseudorange). That floor is
visible in the end-to-end accuracy (~0.1-0.2 km verified); sub-ulp TDOA
would require carrying epoch-relative times through the wire format.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..constants import STATUS_ADDR
from ..exceptions import ADSBError, MlatNonConvergeError
from . import mlat as mlat_mod
from .altitude import decode_alt
from .fields import modes_reply

def parse_wire_obs(message: str) -> Optional[Tuple[str, float, Optional[int]]]:
    """Validate one wire message for TDOA use -> (hexframe, t_abs, ns)
    or None. The SINGLE untrusted-input gate shared by
    mlat_correlator.feed and mlat_coordinator.report (two hand-kept
    copies drifted twice before: length guard, trailing-token
    tolerance). Rejects: missing fields, non-numeric hex/timestamp,
    impossible frame lengths. A junk 7th token degrades to ns=None (wire
    convention: consumers accept >= 6 fields and ignore what they don't
    understand). A non-finite t_abs is RETURNED, not rejected — the
    callers differ deliberately (the coordinator accepts ns-grade
    messages with a broken float field; the correlator drops them
    because clock-sync mode re-parses the float into the CPR cache)."""
    import math
    parts = message.split()
    if len(parts) < 6:
        return None
    try:
        hexframe = parts[1]
        int(hexframe, 16)
        t_abs = float(parts[5])
    except ValueError:
        return None
    try:
        ns = int(parts[6]) if len(parts) > 6 else None
    except ValueError:
        ns = None
    if len(hexframe) not in (14, 28):
        # only 56/112-bit Mode S frames exist on the wire; other lengths
        # would reach layout extraction (negative shift counts) in
        # _frame_altitude_ft/_finish
        return None
    return hexframe, t_abs, ns


class epoch_timebase:
    """Whole-second epoch anchor converting wire times to SMALL relative
    floats: a unix-magnitude float64 quantizes at ~238 ns (~70 m of
    pseudorange), which would discard the int64-ns wire extension's
    precision right after parsing it. Anchors on the first message
    (from ns when present); shared by the correlator and coordinator."""

    def __init__(self):
        self.base_ns: Optional[int] = None

    # plausibility bound for anchoring AND per-message use: 2^35 s
    # (~year 3058) covers unix-epoch and capture-relative time domains.
    # Without it, one absurd-but-FINITE first timestamp (1e200, or a
    # 30-digit ns token — int() is arbitrary precision) anchored the
    # shared timebase so far away that every later arrival collapsed to
    # one identical float, permanently disabling the solver and
    # unbounding _pending (prune's age test always read 0).
    _MAX_S = 1 << 35

    def rel(self, t_abs: float, ns: Optional[int]) -> float:
        import math
        ok_ns = ns is not None and 0 <= ns < self._MAX_S * 1_000_000_000
        ok_t = math.isfinite(t_abs) and 0 <= t_abs < self._MAX_S
        if self.base_ns is None and (ok_ns or ok_t):
            base = ns if ok_ns else int(t_abs) * 1_000_000_000
            self.base_ns = base - base % 1_000_000_000
        if ok_ns:
            return (ns - self.base_ns) * 1e-9
        if self.base_ns is not None and ok_t:
            return t_abs - self.base_ns * 1e-9
        return math.nan  # non-finite or implausible: callers' finite
        # gates drop the message without touching the anchor

    def abs_(self, t_rel: float) -> float:
        return t_rel + (self.base_ns or 0) * 1e-9


# Same-frame arrival spread is bounded by the stations' light-travel
# separation (~1 ms per 300 km) plus clock error; 10 ms covers any
# realistic station network.
DEFAULT_WINDOW_S = 0.010


@dataclasses.dataclass
class MlatSolution:
    hexframe: str
    icao: Optional[int]
    lat: float
    lon: float
    alt_m: float
    n_stations: int
    timestamp: float          # earliest station arrival time


def _frame_altitude_ft(hexframe: str) -> Optional[float]:
    """Decoded altitude when the frame carries one — the 3-station
    altitude constraint: the 13-bit AC field (DF0/4/16/20) or the 12-bit
    BDS0,5 airborne-position altitude (DF17/18 TC 9-18, 20-22)."""
    nbits = len(hexframe) * 4
    data = int(hexframe, 16)
    df = data >> (nbits - 5)
    try:
        if df in (0, 4, 16, 20):
            rep = modes_reply(data, nbits)
            return decode_alt(rep["ac"], bit13=True)
        if df in (17, 18) and nbits == 112:
            me = modes_reply(data, nbits)["me"]
            tc = me >> 51
            if 9 <= tc <= 18 or 20 <= tc <= 22:
                alt12 = (me >> 36) & 0xFFF
                if alt12:
                    # TC20-22: same AC12 decode, geometric semantic
                    # (decode_alt_gnss12 docs) — HAE is, if anything, the
                    # BETTER altitude constraint for the ellipsoid datum
                    return decode_alt(alt12, bit13=False)
    except (ADSBError, ValueError):
        # ADSBError covers layout/length mismatches (fields.data_field
        # raises ParserError); ValueError remains for int() on garbage
        # hex digits — remote stations are untrusted input, so drop,
        # don't crash
        pass
    return None


C_LIGHT = 299792458.0


class clock_sync:
    """Per-station clock-offset estimation from ADS-B reference frames.

    Receivers with free-running counters (classic Beast) cannot TDOA
    directly: each station's timestamps carry an unknown offset (bounded
    to ~ms by the netclient's per-connection host anchoring). The fix is
    the standard mlat-server technique: an aircraft broadcasting its OWN
    position (DF17 airborne position, CPR-decoded) is a reference
    transmitter at a known location, so the expected inter-station arrival
    difference is known and the measured difference exposes the relative
    clock offset. Offsets are EWMA-tracked per station against an anchor
    station (index 0); a station participates in solving only after
    `min_updates` reference observations.
    """

    CONVERGED = 10 ** 9          # n_updates value marking the anchor

    def __init__(self, stations: Sequence[Tuple[float, float, float]],
                 anchor: int = 0, alpha: float = 0.3, min_updates: int = 3,
                 drift_span_s: float = 5.0, outlier_gate_s: float = 500e-6,
                 max_age_s: float = 60.0):
        import collections
        self._ecef = [mlat_mod.llh2ecef(s) for s in stations]
        self.anchor = anchor
        self.alpha = alpha
        self.min_updates = min_updates
        self.drift_span_s = drift_span_s
        self.outlier_gate_s = outlier_gate_s
        self.max_age_s = max_age_s
        self.offset = [0.0] * len(stations)   # station clock minus truth
        self.rate = [0.0] * len(stations)     # d(offset)/dt (counter ppm)
        self.offset_t = [0.0] * len(stations)  # time offset[] refers to
        self.n_updates = [0] * len(stations)
        self.n_updates[anchor] = self.CONVERGED  # anchor defines truth
        self.n_outliers = [0] * len(stations)
        self._consec_outliers = [0] * len(stations)
        self._anchor_misses = 0
        # recent (t, raw offset estimate) per station for the drift fit:
        # free-running 12 MHz crystals drift at ppm level (us/s), which a
        # pure offset model turns into km-scale error between references
        self._hist = [collections.deque(maxlen=32)
                      for _ in range(len(stations))]

    def reset_station(self, s: int) -> None:
        """Invalidate trained state after a feed re-anchors (reconnect or
        counter reset): the old counter->host mapping is garbage.

        Resetting the ANCHOR resets everyone else instead: every other
        offset is trained relative to the anchor's timebase, so an anchor
        timebase step invalidates them all (keeping them would make the
        outlier gate reject every subsequent anchor-referenced update
        forever, freezing the network in the old timebase)."""
        if s == self.anchor:
            for i in range(len(self.offset)):
                if i != self.anchor:
                    self.reset_station(i)
            return
        self.offset[s] = 0.0
        self.rate[s] = 0.0
        self.offset_t[s] = 0.0
        self.n_updates[s] = 0
        self._consec_outliers[s] = 0
        self._hist[s].clear()

    def _expected_delta(self, pos_ecef, s: int, r: int) -> float:
        import numpy as np
        ds = float(np.linalg.norm(pos_ecef - self._ecef[s]))
        dr = float(np.linalg.norm(pos_ecef - self._ecef[r]))
        return (ds - dr) / C_LIGHT

    def update(self, arrivals: Dict[int, float],
               pos_llh: Tuple[float, float, float]) -> None:
        """Feed one reference frame: {station: raw_arrival}, known
        transmitter position (lat, lon, alt_m)."""
        ref = None
        if self.anchor in arrivals:
            ref = self.anchor
            self._anchor_misses = 0
        else:                      # relay through any converged station
            for s in arrivals:
                if self.n_updates[s] >= self.min_updates:
                    ref = s
                    break
        if ref is None:
            # the anchor's feed is dead and nothing has converged (the
            # partially-trained case deadlocks too: n_updates between 1
            # and min_updates can never advance without a reference).
            # After persistent misses, promote a present station to
            # anchor; any partial state was relative to the DEAD anchor's
            # timebase, so everyone else resets.
            self._anchor_misses += 1
            # A station that converged and then went SILENT (feed died)
            # keeps n_updates above threshold forever; counting it here
            # would block promotion and freeze training for the live
            # stations. Treat stale-converged (no reference observation
            # for > max_age_s) as unconverged for the promotion check.
            tnow = max(arrivals.values())
            if self._anchor_misses > 20 and \
                    all(n < self.min_updates
                        or tnow - self.offset_t[i] > self.max_age_s
                        for i, n in enumerate(self.n_updates)
                        if i != self.anchor):
                self.n_updates[self.anchor] = 0
                self.anchor = min(arrivals)
                self.n_updates[self.anchor] = self.CONVERGED
                self.offset[self.anchor] = 0.0
                self.rate[self.anchor] = 0.0
                self.reset_station(self.anchor)   # resets all others
                ref = self.anchor
                self._anchor_misses = 0
            else:
                return
        pos = mlat_mod.llh2ecef(pos_llh)
        if ref != self.anchor:
            # Serving as the relay reference IS activity: rebase the
            # ref's own offset to its arrival time (value continuous via
            # the drift extrapolation, then re-anchored). Without this a
            # dead anchor freezes offset_t[ref] — after max_age_s every
            # group containing the relay is staleness-rejected while its
            # converged state blocks anchor promotion, a permanent silent
            # blackout; and the frozen base would make _offset_at
            # extrapolate over an ever-growing gap.
            tref = arrivals[ref]
            self.offset[ref] = self._offset_at(ref, tref)
            self.offset_t[ref] = tref
        for s, t in arrivals.items():
            if s == ref:
                continue
            residual = (t - arrivals[ref]) - self._expected_delta(pos, s, ref)
            if abs(residual) > 1.0:
                # a counter glitch / cross-transmission merge, never a
                # clock offset (anchoring bounds real offsets to ~ms)
                self.n_outliers[s] += 1
                continue
            est = self._offset_at(ref, t) + residual
            if self.n_updates[s] == 0:
                self.offset[s] = est
            else:
                pred = self._offset_at(s, t)
                if self.n_updates[s] >= self.min_updates and \
                        abs(est - pred) > self.outlier_gate_s:
                    # one garbled observation must not drag a converged
                    # offset by alpha x error (= km of TDOA error); cull.
                    # But consistent "outliers" mean the station's
                    # timebase genuinely STEPPED (e.g. a zmq-fed modes_rx
                    # restarted — no on_reanchor there): self-heal by
                    # resetting and re-converging instead of locking the
                    # station out forever
                    self.n_outliers[s] += 1
                    self._consec_outliers[s] += 1
                    if self._consec_outliers[s] >= 10:
                        self.reset_station(s)
                        self.offset[s] = est
                        self.offset_t[s] = t
                        self.n_updates[s] = 1
                        self._hist[s].append((t, est))
                    continue
                self.offset[s] = pred + self.alpha * (est - pred)
            self._consec_outliers[s] = 0
            self.offset_t[s] = t
            self.n_updates[s] += 1
            self._hist[s].append((t, est))
            self._fit_rate(s)

    def _fit_rate(self, s: int) -> None:
        """Least-squares slope of recent offset estimates -> drift rate.
        Needs several points spanning enough time for the slope (us-level
        estimates over ms-level spans would be noise)."""
        h = self._hist[s]
        if len(h) < 5 or h[-1][0] - h[0][0] < self.drift_span_s:
            return
        n = len(h)
        tm = sum(t for t, _ in h) / n
        om = sum(o for _, o in h) / n
        num = sum((t - tm) * (o - om) for t, o in h)
        den = sum((t - tm) ** 2 for t, _ in h)
        if den > 0:
            self.rate[s] = num / den

    def _offset_at(self, s: int, t: float) -> float:
        """Offset extrapolated to time t via the fitted drift rate."""
        return self.offset[s] + self.rate[s] * (t - self.offset_t[s])

    def correct(self, arrivals: Dict[int, float]) \
            -> Optional[Dict[int, float]]:
        """Offset-corrected arrivals, or None if any station is not yet
        converged — or has gone STALE (no reference for > max_age_s:
        extrapolating a drift fit for minutes accumulates tens of us =
        tens of km; better no solution than a confidently wrong one)."""
        for s, t in arrivals.items():
            if self.n_updates[s] < self.min_updates:
                return None
            if s != self.anchor and t - self.offset_t[s] > self.max_age_s:
                return None
        return {s: t - self._offset_at(s, t) for s, t in arrivals.items()}


class mlat_correlator:
    """Group identical frames across stations; solve when ready.

    stations: list of (lat, lon, alt) per station index. A frame's entry
    solves once `min_stations` stations have reported it AND its window
    has aged past window_s (late stations improve geometry, so the solve
    waits for the window, not the minimum).

    clock_sync_enabled: for stations WITHOUT GPS-disciplined timestamps.
    DF17 airborne-position frames (decoded via the shared parser's CPR
    state) become clock references instead of TDOA targets, and all other
    frames solve with offset-corrected arrivals once every participating
    station has converged. The correlation window must then cover the
    coarse inter-station offset (~ms anchoring jitter), not just light
    travel — pass window_s accordingly (0.05 s is a safe default; a
    corrected-spread plausibility gate in _finish rejects groups where
    the wide window merged two distinct interrogation replies)."""

    def __init__(self, stations: Sequence[Tuple[float, float, float]],
                 min_stations: int = 3, window_s: float = DEFAULT_WINDOW_S,
                 alt_datum: str = "msl", clock_sync_enabled: bool = False):
        if len(stations) < min_stations:
            raise ValueError(f"{len(stations)} stations < min_stations "
                             f"{min_stations}")
        self.stations = [tuple(s) for s in stations]
        if len(set(self.stations)) != len(self.stations):
            # _finish keys replies by position, so duplicate coordinates
            # would silently collapse (dict-last wins), shrinking the
            # observation set while n_stations still reports the larger
            # count — a misconfiguration, fail loudly at startup
            raise ValueError("duplicate station coordinates (same site "
                             "listed twice?)")
        self.min_stations = min_stations
        self.window_s = window_s
        self.alt_datum = alt_datum
        # hexframe -> {station_index: arrival_time}; _first tracks each
        # group's creation time, _heap orders (creation_time, hexframe)
        # for the O(expired)-per-message flush scan
        self._pending: Dict[str, Dict[int, float]] = {}
        self._first: Dict[str, float] = {}
        self._heap: List[Tuple[float, str]] = []
        # hexframe -> every arrival in the group carried the int64-ns wire
        # field: sizes the solver residual bound (float-only wires carry
        # ~238 ns of timestamp quantization ~ 70 m of pseudorange/station)
        self._all_ns: Dict[str, bool] = {}
        self._icao_hint: Dict[str, int] = {}
        # Internal arrival times are EPOCH-RELATIVE seconds (see
        # epoch_timebase for the float64-precision rationale)
        self._tb = epoch_timebase()
        self.sync = clock_sync(self.stations) if clock_sync_enabled else None
        self._refpos: Dict[str, Tuple[float, float, float]] = {}
        if clock_sync_enabled:
            from .parse import parse as parse_cls
            self._parser = parse_cls()   # shared CPR cache across stations
            import numpy as np
            ecef = self.sync._ecef
            self._max_baseline_s = max(
                float(np.linalg.norm(a - b)) for a in ecef for b in ecef
            ) / C_LIGHT

    def reset_station(self, station: int) -> None:
        """Invalidate one station's clock-sync state (feed reconnected:
        its counter anchor — and thus its trained offset — changed)."""
        if self.sync is not None:
            self.sync.reset_station(station)

    def feed(self, station: int, message: str) -> List[MlatSolution]:
        """One wire message ("<df> <hex> ... <timestamp>") from a station;
        returns any solutions that became ready."""
        # untrusted network input (remote stations over zmq/TCP):
        # malformed messages drop, never crash the correlator — the same
        # drop-and-continue contract the coordinator documents
        # (parse_wire_obs is the shared gate)
        import math
        obs = parse_wire_obs(message)
        if obs is None:
            return []
        hexframe, t_abs, ns = obs
        parts = message.split()
        if not math.isfinite(t_abs):
            return []   # 'nan'/'inf' parses but poisons every window
            # comparison (NaN > x is False) downstream — and in clock-sync
            # mode the message is re-parsed into the shared CPR cache,
            # where a NaN timestamp corrupts pair-window/eviction checks
            # even when the ns field supplies the arrival time
        t = self._tb.rel(t_abs, ns)
        if not math.isfinite(t):
            return []   # implausible timestamp domain (rel() refused to
            # anchor/convert): NaN must not reach the window comparisons
        # AP-overlaid DFs (0/4/5/16/20/21/24) carry the transmitter address
        # in the wire syndrome (status ADDR) — recover it so their TDOA
        # solutions are attributable, not anonymous
        try:
            if int(parts[3]) == STATUS_ADDR:
                if len(self._icao_hint) >= 4096:  # bound at INSERT time: a
                    # run that never solves (unconverged sync, sparse
                    # overlap) must not grow this dict without limit
                    for k in list(self._icao_hint)[:2048]:
                        del self._icao_hint[k]
                self._icao_hint[hexframe] = int(parts[2], 16)
        except (ValueError, IndexError):
            pass
        out: List[MlatSolution] = []
        arr = self._pending.get(hexframe)
        if arr is not None and t - min(arr.values()) > self.window_s:
            # aircraft RETRANSMIT identical frames (same DF4/DF11 bits
            # seconds apart): an arrival newer than the window belongs to
            # a new transmission — resolve the old group instead of mixing
            # arrival times across transmissions
            del self._pending[hexframe]
            self._first.pop(hexframe, None)
            out += self._finish(hexframe, arr)
            arr = None
        elif arr is not None and min(arr.values()) - t > self.window_s:
            # the mirror case: a lagged feed delivering a copy of an
            # EARLIER transmission (whose group already resolved) must not
            # merge into the current one — the keep-earliest rule would
            # replace this station's arrival with a time from the wrong
            # transmission, poisoning the solve. Drop the stale copy but
            # run the regular flush like every other feed path (analysis:
            # a stale t is the oldest time in play, so this flush can
            # never catch a group the fresher traffic's flushes missed —
            # kept purely so no path skips the aging step)
            return out + self._flush_rel(now=t)
        new_group = arr is None
        if arr is None:
            import heapq
            arr = self._pending[hexframe] = {}
            self._first[hexframe] = t
            heapq.heappush(self._heap, (t, hexframe))
        # keep the EARLIEST arrival per station (a station can see its own
        # multipath copy later)
        if station not in arr or t < arr[station]:
            arr[station] = t
        self._all_ns[hexframe] = (ns is not None if new_group else
                                  self._all_ns.get(hexframe, False)
                                  and ns is not None)
        # parse once per TRANSMISSION (group creation), not once per
        # station copy — the other copies are bit-identical
        if self.sync is not None and new_group \
                and hexframe not in self._refpos:
            try:
                rep = self._parser.parse(message)
            except (ADSBError, ValueError):
                # ValueError: parse() int()/float()s wire fields this
                # method does not itself validate (df, syndrome, dbfs) —
                # remote garbage must drop, not kill the correlator
                rep = None
            if rep is not None and rep.lat is not None \
                    and not rep.on_surface and rep.altitude_ft is not None:
                if len(self._refpos) > 4096:   # bound: FIFO-drop oldest
                    for k in list(self._refpos)[:2048]:
                        del self._refpos[k]
                self._refpos[hexframe] = (rep.lat, rep.lon,
                                          rep.altitude_ft * 0.3048)
        return out + self._flush_rel(now=t)

    def flush(self, now: float, force: bool = False) -> List[MlatSolution]:
        """Solve and clear entries whose window has aged out (or all,
        with force=True at end of stream). `now` is in the WIRE timestamp
        domain (absolute seconds, the 6th field) — internal group times
        are tbase-relative, so convert here; once an absolute `now`
        only worked by accident (any far-future value flushed everything).
        """
        if self._tb.base_ns is not None:
            now = now - self._tb.base_ns * 1e-9
        return self._flush_rel(now, force)

    def _flush_rel(self, now: float,
                   force: bool = False) -> List[MlatSolution]:
        """flush() against the internal tbase-relative clock (what feed's
        arrival times use).

        Runs on every feed() call, so it must not rescan every pending
        group per message: groups age from their CREATION time (tracked
        in _first) and expire off a creation-time min-heap — O(expired)
        per call and robust to arbitrarily out-of-order creation times
        (a lagged feed replaying old-timestamped frames must not stall
        newer groups behind it; an insertion-order early-stop scan did,
        caught by test_mlat_over_beastgps_feeds). Aging from creation
        rather than from min(arr) delays a flush by at most window_s
        (early in-window copies can lower min below the creation time).
        A heap entry is stale once its group resolved early via the
        retransmission path; the _first equality check skips it."""
        import heapq
        out: List[MlatSolution] = []
        while self._heap and (force
                              or now - self._heap[0][0] > self.window_s):
            t0, hexframe = heapq.heappop(self._heap)
            if self._first.get(hexframe) != t0:
                continue            # stale: group resolved or re-created
            arr = self._pending.pop(hexframe)
            self._first.pop(hexframe, None)
            out += self._finish(hexframe, arr)
        if force and self._pending:   # anything the heap lost track of
            for hexframe in list(self._pending):
                arr = self._pending.pop(hexframe)
                self._first.pop(hexframe, None)
                out += self._finish(hexframe, arr)
        return out

    def _finish(self, hexframe: str,
                arr: Dict[int, float]) -> List[MlatSolution]:
        """Resolve one completed arrival group: train the clock sync (if
        it was a position-known reference frame) or TDOA-solve it."""
        all_ns = self._all_ns.pop(hexframe, False)
        t0 = min(arr.values())
        if self.sync is not None:
            # leave _refpos cached: retransmissions of the same position
            # frame keep training without a re-parse
            refpos = self._refpos.get(hexframe)
            if refpos is not None:
                if len(arr) >= 2:       # reference frame: trains the sync
                    self.sync.update(arr, refpos)
                return []               # position already known; no TDOA
        if len(arr) < self.min_stations:
            return []
        if self.sync is not None:
            corrected = self.sync.correct(arr)
            if corrected is None:
                return []               # a clock is not yet converged
            arr = corrected
            # plausibility: corrected arrivals of ONE transmission cannot
            # spread more than the widest station baseline's light travel
            # (+ sync error margin). A wider spread means the wide window
            # merged two distinct interrogation replies with disjoint
            # station sets — solving it would emit a confident garbage fix
            spread = max(arr.values()) - min(arr.values())
            if spread > self._max_baseline_s + 100e-6:
                return []
        replies = {self.stations[s]: t for s, t in arr.items()}
        alt_ft = _frame_altitude_ft(hexframe)
        try:
            # reject_outliers: with redundant stations, a single garbled
            # counter / multipath copy silently BIASES least squares —
            # leave-one-out re-solve keeps the fix honest (drops the
            # group instead when nothing fits). The residual bound
            # follows the timestamp grade: clock-sync-trained offsets
            # leave ~0.1-0.2 km of genuine residual; GPS stamps leave ~0
            # only when every arrival carried the int64-ns extension —
            # float-only wires quantize at ~238 ns (~70 m/station), so
            # they get the coordinator's wider 300 m bound
            lat, lon, alt_m = mlat_mod.mlat(
                replies, alt_ft, alt_datum=self.alt_datum,
                reject_outliers=True,
                max_resid_m=500.0 if self.sync is not None
                else (100.0 if all_ns else 300.0))
        except MlatNonConvergeError:
            return []         # drop-and-continue, like the parse loop
        nbits = len(hexframe) * 4
        data = int(hexframe, 16)
        df = data >> (nbits - 5)
        icao = (data >> (nbits - 32)) & 0xFFFFFF if df in (11, 17, 18) \
            else self._icao_hint.pop(hexframe, None)
        if icao is not None and df == 18 \
                and (data >> (nbits - 8)) & 0x7 in (1, 5):
            # DF18 CF=1/5 carry a non-ICAO address: namespace it like the
            # parser does so downstream ICAO-keyed consumers (dashboard
            # via modes_mlat --http, SBS) never collide it with a real
            # aircraft
            from ..constants import ANON_ICAO_BIT
            icao |= ANON_ICAO_BIT
        # report absolute time (internal times are tbase-relative)
        t0_abs = self._tb.abs_(t0)
        return [MlatSolution(hexframe, icao, lat, lon, alt_m,
                             len(arr), t0_abs)]
