"""Network frame ingestion: Beast / AVR TCP clients feeding the decode stack.

A copy of `airmodes/io/netclient.py`. `modes_rx` can subscribe to remote
receivers speaking the standard 1090 MHz wire protocols — Beast binary
(dump1090/readsb `--net-bo-port 30005`) or AVR ASCII (`*<hex>;`) — and turn
into an aggregator. Received frames are re-validated with the same CRC
acceptance rules the slicer applies (DF11 accepts syndromes with zero
high-17 bits, DF17/18 must be parity clean, AP-overlaid DFs carry the
address in the syndrome) and re-emitted as wire strings, so every output
plugin works identically on local and remote frames. Live counters are
unwrapped per frame (a 48-bit counter wraps at 2^47 ticks), and recorded
captures replay in streamed chunks.
"""

from __future__ import annotations

import socket
import sys
import threading
import time
from typing import Callable, List, Optional, Tuple

from .. import crc
from ..constants import (AP_ADDRESS_DFS, STATUS_ADDR, STATUS_CRC_OK,
                         frame_bits_for_df)
from ..outputs.beast import ESC, MLAT_HZ, TYPE_LONG, TYPE_SHORT, signal_dbfs

_BODY_LEN = {TYPE_SHORT: 6 + 1 + 7, TYPE_LONG: 6 + 1 + 14,
             0x31: 6 + 1 + 2,   # Mode A/C: parsed but not decoded
             0x34: 6 + 1 + 14}  # radarcape status data: parsed and skipped
                                # (resyncing through its body byte-by-byte
                                # would inflate the crc-dropped counter)


def frame_to_wire(hexframe: str, ref_dbfs: float = 0.0,
                  timestamp: Optional[float] = None,
                  timestamp_ns: Optional[int] = None) -> Optional[str]:
    """Validate a received Mode S frame and build the slicer wire string.

    Returns None for frames this framework cannot accept: wrong length,
    non-hex, unknown DF length mismatch, or a parity failure under the
    slicer's per-DF acceptance rule (we have no chip confidence for remote
    frames, so no brute-force correction is attempted).

    timestamp_ns appends the int64-ns wire extension (and, if timestamp
    is omitted, derives the float field from it): float64 seconds at
    unix magnitude quantize to ~238 ns, so mlat-grade sources (GPS
    counters, 12 MHz counters) pass the exact integer through.
    """
    hexframe = hexframe.lower()
    nbits = len(hexframe) * 4
    if nbits not in (56, 112):
        return None
    # strict charset: int(x, 16) also accepts '0x' prefixes, '_'
    # separators and sign characters, which would pass the length check
    # while parsing a different bit count — garbled frames must drop
    if any(c not in "0123456789abcdef" for c in hexframe):
        return None
    data = int(hexframe, 16)
    df5 = data >> (nbits - 5)
    df = 24 if df5 >> 3 == 3 else df5
    # same DF whitelist as the slicer (dsp/pipeline.py crc_check_and_correct):
    # any other DF value is noise, not a Mode S downlink format
    if df not in (0, 4, 5, 11, 16, 17, 18, 20, 21, 24):
        return None
    # a frame whose DF implies the other length is garbled
    if frame_bits_for_df(df) != nbits:
        return None
    syndrome = crc.crc24(data, nbits)
    if df in (17, 18) and syndrome != 0:
        return None
    if df == 11 and (syndrome >> 7) != 0:
        return None
    status = STATUS_ADDR if df in AP_ADDRESS_DFS else STATUS_CRC_OK
    if timestamp is None:
        timestamp = (timestamp_ns * 1e-9 if timestamp_ns is not None
                     else time.time())
    wire = (f"{df} {hexframe} {syndrome:06x} {status} "
            f"{ref_dbfs:.2f} {timestamp:.9f}")
    if timestamp_ns is not None:
        wire += f" {timestamp_ns}"
    return wire


class beast_parser:
    """Incremental Beast binary de-framer.

    push(bytes) -> list of (type, mlat_counter, signal_byte, payload bytes).
    Handles ESC doubling, partial frames across reads, and resynchronizes
    on garbage (drop-and-continue).
    """

    def __init__(self) -> None:
        self._buf = bytearray()

    def push(self, data: bytes) -> List[Tuple[int, int, int, bytes]]:
        self._buf.extend(data)
        out: List[Tuple[int, int, int, bytes]] = []
        while True:
            frame = self._next_frame()
            if frame is None:
                return out
            out.append(frame)

    def _next_frame(self):
        while True:
            buf = self._buf
            # resync: find an ESC followed by a known type byte
            start = 0
            while True:
                i = buf.find(ESC, start)
                if i < 0:
                    del buf[:]
                    return None
                if i + 1 >= len(buf):
                    del buf[:i]
                    return None
                if buf[i + 1] in _BODY_LEN:
                    break
                # not a frame start here — advance one byte; an ESC ESC
                # pair may be garbage followed by a REAL frame-start ESC,
                # so the second ESC must itself be tried as a start
                start = i + 1
            mtype = buf[i + 1]
            need = _BODY_LEN[mtype]
            body = bytearray()
            j = i + 2
            truncated = False
            while len(body) < need:
                if j >= len(buf):
                    del buf[:i]
                    return None  # incomplete; wait for more bytes
                b = buf[j]
                if b == ESC:
                    if j + 1 >= len(buf):
                        del buf[:i]
                        return None
                    if buf[j + 1] == ESC:
                        body.append(ESC)
                        j += 2
                        continue
                    # unescaped ESC mid-body: truncated frame — drop it
                    # and restart parsing at the new frame boundary
                    del buf[:j]
                    truncated = True
                    break
                body.append(b)
                j += 1
            if truncated:
                continue
            # plausibility: a candidate whose Mode S payload length
            # contradicts its DF is a false sync (e.g. we started inside
            # the body of a frame a truncated predecessor swallowed) —
            # rescan one byte past this ESC without consuming anything
            if mtype in (TYPE_SHORT, TYPE_LONG):
                df5 = body[7] >> 3
                df = 24 if df5 >= 24 else df5
                expect = 14 if df >= 16 else 7
                if need - 7 != expect:
                    del buf[:i + 1]
                    continue
            del buf[:j]
            mlat = int.from_bytes(body[:6], "big")
            return mtype, mlat, body[6], bytes(body[7:])


def avr_to_hex(record: str) -> Optional[Tuple[str, Optional[int]]]:
    """One AVR record -> (hexframe, mlat_counter or None).

    `*<hex>` is a plain frame; `@<12-hex mlat><hex>` carries the Beast-style
    12 MHz counter (readsb/dump1090 --net-ro AVR-MLAT format).
    """
    record = record.strip()
    if record.startswith("*"):
        return record[1:].strip(), None
    if record.startswith("@") and len(record) >= 13:
        counter = record[1:13]
        # strict hex: int(x, 16) accepts '-'/'_'/whitespace, which would
        # mint a bogus (even negative) counter from a garbled record and
        # poison the mlat anchor math — same guard frame_to_wire applies
        # to the frame field
        if not all(c in "0123456789abcdefABCDEF" for c in counter):
            return None
        return record[13:].strip(), int(counter, 16)
    return None


_DAY_NS = 86400 * 1_000_000_000


def split_gps_counter(counter: int):
    """[sod:18][ns:30] GPS counter -> (seconds_of_day, nanoseconds), or
    None outside the domain (sod >= 86400 or ns >= 1e9 — an unlocked or
    free-running counter masquerading as GPS time). THE one place the
    bit layout and bounds live (three hand-kept copies drifted before:
    _emit validated, replay_file did not)."""
    sod, nanos = counter >> 30, counter & ((1 << 30) - 1)
    if sod >= 86400 or nanos >= 1_000_000_000:
        return None
    return sod, nanos


def gps_counter_to_utc_ns(counter: int, host_now: float) -> int:
    """Radarcape/GPS Beast timestamp -> absolute UTC int64 nanoseconds.

    GPS-disciplined Beast receivers replace the free-running 12 MHz counter
    with [seconds-of-UTC-day:18][nanoseconds:30]. The day epoch comes from
    the host clock, corrected so the result lands within half a day of
    arrival (handles UTC-midnight rollover between emission and receipt).
    Integer end to end: the counter's 1 ns resolution survives (a float64
    at unix magnitude quantizes to ~238 ns).
    """
    sod_ns = (counter >> 30) * 1_000_000_000 + (counter & ((1 << 30) - 1))
    host_ns = int(host_now * 1e9)
    ts = host_ns - host_ns % _DAY_NS + sod_ns
    if ts - host_ns > _DAY_NS // 2:
        ts -= _DAY_NS
    elif host_ns - ts > _DAY_NS // 2:
        ts += _DAY_NS
    return ts


def gps_counter_to_utc(counter: int, host_now: float) -> float:
    """Float-seconds view of gps_counter_to_utc_ns (display/legacy use)."""
    return gps_counter_to_utc_ns(counter, host_now) * 1e-9


class net_client:
    """TCP client pulling frames from a remote receiver into a callback.

    format: "beast" | "avr" | "auto" (sniff the first byte: 0x1A = beast).
    Each accepted frame is converted with frame_to_wire and handed to
    `callback(wire_message)`. Timestamp handling (`timestamps=`):

      "host"  arrival time at this host (default; fine for live maps)
      "mlat"  the remote 12 MHz counter, coarse-anchored to this host's
              clock at the first frame of each connection: preserves the
              counter's ~83 ns relative precision while bounding the
              inter-station offset to network latency + anchor jitter
              (~ms) — which mlat clock sync then refines to us level
      "gps"   radarcape-style GPS-disciplined counter ([sec-of-day:18]
              [ns:30]) -> absolute UTC; what mlat across stations needs
    """

    def __init__(self, host: str, port: int, callback: Callable[[str], None],
                 fmt: str = "auto", mlat_time: bool = False,
                 timestamps: str = "host", reconnect_s: float = 2.0):
        self.host, self.port = host, port
        self.callback = callback
        if fmt == "beastgps":
            fmt = "beast"     # the URL scheme name: framing is beast,
            # the GPS-ness lives in timestamps= (client_for_url
            # normalizes too; direct constructions used to fall through
            # to AVR parsing of the binary stream)
        if fmt not in ("auto", "beast", "avr"):
            raise ValueError(f"unknown net_client fmt {fmt!r} "
                             "(auto | beast | avr)")
        self.fmt = fmt
        self.timestamps = "mlat" if mlat_time else timestamps
        self.reconnect_s = reconnect_s
        self._anchor: Optional[Tuple[float, int]] = None
        self._last_counter: Optional[int] = None   # unwrap state (see
        self._unwrapped = 0                        # _emit mlat branch)
        # called (from the client thread) whenever the counter->host-clock
        # anchor changes after frames have flowed: a reconnect or a remote
        # counter reset. Consumers tracking clock offsets (mlat sync) MUST
        # invalidate this station's state then.
        self.on_reanchor: Optional[Callable[[], None]] = None
        self.n_frames = 0
        self.n_dropped = 0
        self.n_connect_failures = 0
        self._stop = threading.Event()
        self._sock: Optional[socket.socket] = None
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> "net_client":
        self._thread.start()
        return self

    # --- internals -------------------------------------------------------

    def _emit(self, hexframe: str, signal: Optional[int],
              mlat: Optional[int]) -> None:
        dbfs = signal_dbfs(signal) if signal is not None else 0.0
        ts = None
        ns = None
        if self.timestamps == "mlat":
            if mlat is None:
                # counter-less record (plain AVR '*hex;'): a host receive
                # time has ms TCP jitter — poison for us-level TDOA, so
                # drop rather than silently degrade the solve
                self.n_dropped += 1
                return
            if self._anchor is None:
                # counter is relative to remote boot (offsets between
                # stations would be unbounded); anchor it to this
                # host's clock once per connection
                self._anchor = (time.time(), mlat)
                self._last_counter = mlat
                self._unwrapped = 0
            t0, c0 = self._anchor
            if self._last_counter is None:
                # anchor was set without the unwrap state (restored from
                # a prior connection / set directly): derive it
                self._last_counter = c0
                self._unwrapped = 0
            # UNWRAPPED tick count: per-frame signed-modular steps
            # (bounded by seconds, never near 2^47) accumulate, so the
            # anchor-relative delta survives any connection lifetime —
            # the single anchor-relative signed-modular form wrapped at
            # 2^47 ticks (~11.65 days of uptime) and GUARANTEED a
            # spurious reanchor that trashed the trained mlat sync state.
            # A frame slightly below the previous counter is still a
            # slightly-early frame, not +271 days.
            half = 1 << 47
            step = ((mlat - self._last_counter + half)
                    & ((1 << 48) - 1)) - half
            self._last_counter = mlat
            self._unwrapped += step
            delta = self._unwrapped
            # a healthy counter's implied elapsed time tracks the host
            # clock; divergence (not mere age!) marks a remote counter
            # reset/re-lock without a TCP disconnect. The threshold grows
            # with elapsed time: SDR sample clocks run 30-100 ppm off, so
            # a fixed 5 s bound false-fired on a healthy day-old feed
            # (~4.3 s/day at 50 ppm) and trashed the trained mlat sync
            # state ~daily; a real reset diverges by minutes-to-days.
            # 200 ppm covers worst-case drift both ways.
            elapsed = time.time() - t0
            if abs(delta / MLAT_HZ - elapsed) > 5.0 + 200e-6 * abs(elapsed):
                self._anchor = (time.time(), mlat)
                t0, c0 = self._anchor
                delta = 0
                self._unwrapped = 0
                self._last_counter = mlat
                if self.on_reanchor is not None:
                    self.on_reanchor()
            ts = t0 + delta / MLAT_HZ
            # ns extension: anchor rounded once + exact tick scaling keeps
            # the counter's full 83.3 ns relative precision on the wire
            ns = int(round(t0 * 1e9)) + (delta * 1000) // 12
        elif self.timestamps == "gps":
            if mlat is None:
                # counter-less record: host receive time has ms TCP
                # jitter — mixing it into a GPS-grade (ns) feed silently
                # poisons the TDOA solve, so drop and count (same rule
                # as "mlat" mode)
                self.n_dropped += 1
                return
            if split_gps_counter(mlat) is None:
                # outside the GPS layout's domain: an unlocked or
                # misconfigured receiver (e.g. a classic free-running
                # counter fed through a gps:// URL) — NOT UTC-disciplined
                # time; mapping it anyway would enter the TDOA solve as
                # trusted GPS-grade stamps. Drop and count, same rule as
                # counter-less records.
                self.n_dropped += 1
                return
            ns = gps_counter_to_utc_ns(mlat, time.time())
            ts = ns * 1e-9
        wire = frame_to_wire(hexframe, ref_dbfs=dbfs, timestamp=ts,
                             timestamp_ns=ns)
        if wire is None:
            self.n_dropped += 1
            return
        self.n_frames += 1
        self.callback(wire)

    def _pump(self, sock: socket.socket) -> None:
        sock.settimeout(0.5)
        if self._anchor is not None:
            # reconnection: the previous counter->host mapping is dead
            self._anchor = None
            if self.on_reanchor is not None:
                self.on_reanchor()
        fmt = self.fmt
        beast = beast_parser()
        avr_buf = b""
        while not self._stop.is_set():
            try:
                chunk = sock.recv(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            if not chunk:
                return  # remote closed
            if fmt == "auto":
                fmt = "beast" if chunk[:1] == b"\x1a" else "avr"
            if fmt == "beast":
                for mtype, mlat, sig, payload in beast.push(chunk):
                    if mtype in (TYPE_SHORT, TYPE_LONG):
                        self._emit(payload.hex(), sig, mlat)
            else:
                avr_buf += chunk
                while True:
                    i = avr_buf.find(b";")
                    if i < 0:
                        break
                    rec = avr_buf[:i].strip().decode("ascii", "replace")
                    avr_buf = avr_buf[i + 1:]
                    got = avr_to_hex(rec)
                    if got is not None:
                        self._emit(got[0], None, got[1])
                    else:
                        # malformed AVR record: COUNT it (the beast path
                        # counts every drop; an uncounted garbage feed
                        # read as quiet airspace)
                        self.n_dropped += 1
                if len(avr_buf) > 65536:
                    # a record-less byte stream (wrong port, proxy
                    # banner, binary feed) must not grow memory at line
                    # rate forever; drop the garbage and keep listening
                    self.n_dropped += 1
                    avr_buf = b""

    def _run(self) -> None:
        logged_outage = False
        while not self._stop.is_set():
            try:
                sock = socket.create_connection(
                    (self.host, self.port), timeout=5.0)
            except OSError as e:
                # a permanently dead feed must be distinguishable from
                # quiet airspace: count every failure, log once per
                # outage (no silent infinite retry)
                self.n_connect_failures += 1
                if not logged_outage:
                    print(f"net_client: cannot connect "
                          f"{self.host}:{self.port}: {e} (retrying every "
                          f"{self.reconnect_s:.0f}s)", file=sys.stderr)
                    logged_outage = True
                if self._stop.wait(self.reconnect_s):
                    return
                continue
            if logged_outage:
                print(f"net_client: {self.host}:{self.port} connected",
                      file=sys.stderr)
            logged_outage = False
            self._sock = sock
            try:
                self._pump(sock)
            except Exception as e:     # noqa: BLE001 — drop-and-continue:
                # an exception escaping the callback must not silently
                # kill the feed thread forever (frozen stats, no
                # reconnect); log and re-enter the
                # reconnect loop
                print(f"net_client: {self.host}:{self.port} feed error: "
                      f"{e!r}; reconnecting", file=sys.stderr)
            finally:
                self._sock = None
                try:
                    sock.close()
                except OSError:
                    pass
            self._stop.wait(self.reconnect_s)

    def close(self) -> None:
        self._stop.set()
        sock = self._sock
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if self._thread.ident is not None:  # joining a never-started
            self._thread.join(timeout=5.0)  # thread raises RuntimeError
            # (client_for_url returns UNSTARTED clients; error-path
            # cleanup may close one before start)


class frame_deduper:
    """Suppress repeats of the same frame within a time window.

    Overlapping receiver feeds all deliver the same transmission; an
    aggregator's merged output should carry it once (per-feed topics stay
    undeduplicated so mlat correlation still sees every copy)."""

    def __init__(self, window_s: float = 1.0, max_entries: int = 4096):
        self.window_s = window_s
        self.max_entries = max_entries
        self._last: dict = {}  # hexframe -> last accepted arrival time

    def accept(self, hexframe: str, now: Optional[float] = None) -> bool:
        if now is None:
            now = time.time()
        prev = self._last.get(hexframe)
        if prev is not None and now - prev < self.window_s:
            return False
        if len(self._last) > self.max_entries:  # bound memory on busy feeds
            cutoff = now - self.window_s
            self._last = {k: t for k, t in self._last.items() if t >= cutoff}
            if len(self._last) > self.max_entries // 2:
                # shrink to HALF cap even when expiry freed some room:
                # when rate x window hovers at the cap, expiry frees only
                # a handful of entries and this O(n) pass re-ran every
                # few accepted frames under the aggregator lock.
                # Dropping in-window state only risks a duplicate emit,
                # never a drop.
                keep = sorted(self._last.items(), key=lambda kv: kv[1])
                self._last = dict(keep[-(self.max_entries // 2):])
        self._last[hexframe] = now
        return True


def replay_file(path: str, fmt: str = "auto",
                epoch: Optional[float] = None, gps_time: bool = False):
    """Replay a recorded Beast-binary or AVR capture as wire messages.

    Yields (wire_message, stream_offset_s). Remote MLAT counters (Beast
    always; AVR `@` records) are mapped onto `epoch` relative to the first
    frame's counter, preserving inter-frame spacing for throttled replay
    and CPR pairing windows; counter-less AVR records replay at the epoch.
    gps_time interprets counters in the radarcape [sec-of-day:18][ns:30]
    layout (a recording of `-B --beast-gps` or a real radarcape) — the
    classic interpretation would stretch 1 s of GPS spacing into 2^30/12e6
    ≈ 89.5 s. Frames failing the CRC acceptance rules are skipped.
    """
    if epoch is None:
        epoch = time.time()
    t0_ns: Optional[int] = None
    epoch_ns = int(round(epoch * 1e9))

    def counter_ns(mlat: int) -> Optional[int]:
        # integer end to end so the recording's counter precision (1 ns
        # GPS / 83 ns classic) survives onto the wire's ns field
        if gps_time:
            got = split_gps_counter(mlat)
            if got is None:
                return None   # outside the GPS domain (free-running
                # counter recorded through --beast-gps / lost lock):
                # the LIVE gps path drops these; replay used to mint
                # garbage non-monotone pseudo-times
            return got[0] * 1_000_000_000 + got[1]
        return mlat * 1000 // 12              # 12 MHz ticks -> ns

    base_ns = 0          # accumulated re-anchor offset (counter resets)
    prev_off = 0

    def ts_of(mlat: Optional[int]):
        nonlocal t0_ns, base_ns, prev_off
        if mlat is None:
            return epoch, 0.0, None
        cns = counter_ns(mlat)
        if cns is None:
            return None             # out-of-domain counter: drop frame
        if t0_ns is None:
            t0_ns = cns
        off_ns = cns - t0_ns + base_ns
        if gps_time:
            # the sec-of-day counter wraps at UTC midnight: a regression
            # vs the PREVIOUS frame (recordings are monotone to ~us, so
            # > 1 s backwards is a wrap, not reordering) crossed a day
            # boundary — accumulate WHOLE DAYS so multi-day recordings
            # and > 12 h gaps stay monotone. (The old one-shot +-12 h
            # patch vs the FIRST frame replayed a 13 h-later frame 11 h
            # BEFORE the start and aliased days 2+ onto day one. A gap
            # crossing midnight whose next-day sod exceeds the previous
            # frame's sod is inherently undetectable from sod alone.)
            while off_ns < prev_off - 1_000_000_000:
                base_ns += 86400 * 1_000_000_000
                off_ns += 86400 * 1_000_000_000
        elif off_ns < prev_off - 1_000_000_000:
            # classic 12 MHz counter reset mid-recording (remote receiver
            # restarted) or 2^48 wrap: without re-anchoring, every later
            # frame lands up to ~271 days before the epoch and throttled
            # replay / CPR pairing break (the LIVE path reanchors via its
            # 5 s divergence check; a recording has no host clock, so
            # regression > 1 s — far beyond multipath/correlation-window
            # reordering — is the signal). Stream time continues from
            # the last frame.
            base_ns = prev_off
            t0_ns = cns
            off_ns = prev_off
        prev_off = max(prev_off, off_ns)
        ns = epoch_ns + off_ns
        return ns * 1e-9, off_ns * 1e-9, ns

    # stream in chunks: reading AND parsing a multi-GB capture into
    # full-size in-memory lists before the first yield held several GB
    # resident; the beast parser is already incremental
    with open(path, "rb") as f:
        first = f.read(1 << 20)
        if fmt == "auto":
            fmt = "beast" if first[:1] == b"\x1a" else "avr"

        def chunks():
            chunk = first
            while chunk:
                yield chunk
                chunk = f.read(1 << 20)

        if fmt == "beast":
            bp = beast_parser()
            for chunk in chunks():
                for mtype, mlat, sig, payload in bp.push(chunk):
                    if mtype not in (TYPE_SHORT, TYPE_LONG):
                        continue
                    got_ts = ts_of(mlat)
                    if got_ts is None:
                        continue
                    ts, off, ns = got_ts
                    w = frame_to_wire(payload.hex(),
                                      ref_dbfs=signal_dbfs(sig),
                                      timestamp=ts, timestamp_ns=ns)
                    if w is not None:
                        yield w, off
        else:
            buf = b""
            for chunk in chunks():
                buf += chunk
                while True:
                    i = buf.find(b";")
                    if i < 0:
                        break
                    rec = buf[:i]
                    buf = buf[i + 1:]
                    got = avr_to_hex(rec.strip().decode("ascii",
                                                        "replace"))
                    if got is None:
                        continue
                    got_ts = ts_of(got[1])
                    if got_ts is None:
                        continue
                    ts, off, ns = got_ts
                    w = frame_to_wire(got[0], timestamp=ts,
                                      timestamp_ns=ns)
                    if w is not None:
                        yield w, off
                if len(buf) > 1 << 20:
                    buf = b""       # record-less garbage stream


def parse_net_url(url: str) -> Optional[Tuple[str, str, int]]:
    """'beast://host:port' | 'beastgps://...' | 'avr://...' ->
    (scheme, host, port). 'beastgps' is Beast framing with GPS-disciplined
    (radarcape) timestamps."""
    for scheme in ("beastgps", "beast", "avr"):
        prefix = scheme + "://"
        if url.startswith(prefix):
            hostport = url[len(prefix):]
            host, _, port = hostport.rpartition(":")
            if not host or not port.isdigit():
                raise ValueError(f"bad network source {url!r} "
                                 "(want scheme://host:port)")
            if host.startswith("[") and host.endswith("]"):
                # bracketed IPv6 literal: socket APIs take the bare
                # address (brackets left on, every connect gaierror'd
                # forever)
                host = host[1:-1]
            elif ":" in host:
                # a bare IPv6 address with no port mis-splits ('::1' ->
                # host '::', port 1) and retried a nonsense endpoint
                # forever instead of a clean CLI error
                raise ValueError(
                    f"bad network source {url!r}: bracket IPv6 hosts "
                    f"({scheme}://[{hostport}]:PORT)")
            return scheme, host, int(port)
    return None


def client_for_url(url: str, callback: Callable[[str], None],
                   timestamps: Optional[str] = None,
                   reconnect_s: float = 2.0) -> Optional[net_client]:
    """Build (unstarted) net_client for a beast/beastgps/avr URL, else None."""
    got = parse_net_url(url)
    if got is None:
        return None
    scheme, host, port = got
    fmt = "beast" if scheme == "beastgps" else scheme
    if timestamps is None:
        timestamps = "gps" if scheme == "beastgps" else "host"
    return net_client(host, port, callback, fmt=fmt, timestamps=timestamps,
                      reconnect_s=reconnect_s)
