"""Mode-S Beast binary output server (beyond reference).

The Beast binary protocol is the lingua franca of the 1090 MHz feeder
ecosystem (dump1090/readsb `--net-bo-port 30005`, Virtual Radar Server,
FlightAware/adsbexchange feed clients all speak it). Serving it makes this
framework a drop-in upstream for any of those consumers; the matching
client-side parser lives in the reference package's
`airmodes/io/netclient.py` (not ported yet).

Frame layout (one message):

    0x1A <type> <6-byte MLAT counter> <1-byte signal> <payload>

  type    0x32 = Mode S short (7-byte payload, 56 bits)
          0x33 = Mode S long (14-byte payload, 112 bits)
  MLAT    big-endian 48-bit counter of a 12 MHz clock at the preamble start
  signal  amplitude byte; dump1090 convention sig = 255 * 10^(dBFS/20)

Every body byte equal to 0x1A (ESC) is doubled on the wire; the type byte
is never escaped.
"""

from __future__ import annotations

import math
from typing import Optional

from .tcpserver import broadcast_server

ESC = 0x1A
TYPE_MODEAC = 0x31
TYPE_SHORT = 0x32
TYPE_LONG = 0x33
MLAT_HZ = 12_000_000
_MLAT_MASK = (1 << 48) - 1


def signal_byte(ref_dbfs: float) -> int:
    """dBFS reference level -> Beast amplitude byte (dump1090 convention).

    The input clamps BEFORE exponentiation: a hostile finite value like
    1e30 dBFS would overflow float pow (found by wire fuzz); anything
    >= 0 dBFS is full scale, anything <= -96 dB is byte 0 anyway."""
    sig = round(255.0 * 10.0 ** (min(max(ref_dbfs, -200.0), 0.0) / 20.0))
    return max(0, min(255, sig))


def signal_dbfs(byte: int) -> float:
    """Inverse of signal_byte (floor at the 1-count quantization level)."""
    return 20.0 * math.log10(max(byte, 1) / 255.0)


def gps_counter(timestamp: float) -> int:
    """UTC seconds -> radarcape GPS-disciplined counter layout
    ([seconds-of-UTC-day:18][nanoseconds:30])."""
    sod = timestamp % 86400.0
    secs = int(sod)
    ns = int(round((sod - secs) * 1e9))
    if ns >= 1_000_000_000:  # float rounding at a second boundary
        secs, ns = (secs + 1) % 86400, 0
    return (secs << 30) | ns


def gps_counter_ns(timestamp_ns: int) -> int:
    """Exact int64-ns UTC -> radarcape counter (no float round-trip: a
    unix-magnitude float64 quantizes to ~238 ns, defeating the layout's
    1 ns resolution)."""
    sod_ns = timestamp_ns % (86400 * 1_000_000_000)
    return ((sod_ns // 1_000_000_000) << 30) | (sod_ns % 1_000_000_000)


def beast_encode(hexframe: str, ref_dbfs: float, timestamp: float,
                 gps_time: bool = False,
                 timestamp_ns: Optional[int] = None) -> Optional[bytes]:
    """One Mode S frame -> escaped Beast wire bytes (None if not 56/112-bit).

    gps_time selects the radarcape GPS counter layout (absolute UTC,
    ~1 ns quantization) instead of the classic free-running 12 MHz counter
    (~83 ns) — the format mlat across stations needs. timestamp_ns (when
    the wire message carried the int64-ns extension) keeps the counter
    exact instead of float-quantized.
    """
    if not (math.isfinite(ref_dbfs) and math.isfinite(timestamp)
            and abs(timestamp) < 1e12):
        # 'nan'/'inf' parse as floats upstream and would crash the
        # counter/signal-byte int conversions below; so would a finite
        # but absurd timestamp (1e308 * 12 MHz overflows float to inf
        # before int() — found by wire fuzz). 1e12 s is ~30,000 years of
        # unix time: anything beyond is garbage, drop, don't raise.
        return None
    try:
        payload = bytes.fromhex(hexframe)
    except ValueError:
        return None
    if len(payload) == 7:
        mtype = TYPE_SHORT
    elif len(payload) == 14:
        mtype = TYPE_LONG
    else:
        return None
    if timestamp_ns is not None:
        mlat = (gps_counter_ns(timestamp_ns) if gps_time
                else timestamp_ns * MLAT_HZ // 1_000_000_000) & _MLAT_MASK
    else:
        mlat = (gps_counter(timestamp) if gps_time
                else int(timestamp * MLAT_HZ)) & _MLAT_MASK
    body = mlat.to_bytes(6, "big") + bytes([signal_byte(ref_dbfs)]) + payload
    return bytes([ESC, mtype]) + body.replace(b"\x1a", b"\x1a\x1a")


class output_beast:
    """Plugin: TCP server re-emitting each wire message as a Beast frame.

    gps_time emits radarcape-layout absolute-UTC counters (this demod's
    timestamps are absolute sample-counter time, so its Beast feed can be
    mlat-grade for a downstream correlator, e.g. modes_mlat beastgps://)."""

    def __init__(self, port: int = 30005, host: str = "0.0.0.0",
                 gps_time: bool = False):
        self._srv = broadcast_server(port, host)
        self.port = self._srv.port
        self.gps_time = gps_time

    def output(self, msg: str) -> None:
        parts = msg.split()
        if len(parts) < 6:
            return
        ns = None
        if len(parts) > 6:
            try:  # ns extension: the counter keeps the full precision
                ns = int(parts[6])
            except ValueError:
                pass
        try:   # remote feeds are untrusted: a corrupt dbfs/timestamp
            ref_dbfs = float(parts[4])
            ts = float(parts[5])
        except ValueError:
            return    # field drops the frame here, not via the bus's
            # catch-all (the plugin owns its drop-and-continue contract)
        data = beast_encode(parts[1], ref_dbfs, ts,
                            gps_time=self.gps_time, timestamp_ns=ns)
        if data is not None:
            self._srv.broadcast(data)

    def close(self) -> None:
        self._srv.close()
