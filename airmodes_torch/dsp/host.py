"""Host side of the device->host boundary.

The reference crosses C++ -> Python via a gr::msg_queue of space-separated
ASCII strings (lib/slicer_impl.cc -> python/radio.py watcher thread). Here the
device returns a fixed-shape DetectionTable per block; this module turns it
into the same kind of wire strings:

    "<df> <hex_frame> <syndrome_hex6> <status> <ref_dbfs> <timestamp>"

Timestamps are block_start_sample + detection index over the channel rate
(float seconds with sub-us fraction), matching the reference's
tag_to_timestamp semantics (sample-counter arithmetic, SURVEY.md §2.7).

A copy of `airmodes.dsp.host`: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

from ..constants import (STATUS_CORRECTED_1, STATUS_CORRECTED_2,
                         STATUS_CRC_OK, STATUS_FAIL)


@dataclasses.dataclass
class BlockStats:
    """Per-block observability counters (SURVEY.md §5.1/§5.5)."""

    samples: int = 0
    preambles: int = 0
    overflow: int = 0
    crc_ok: int = 0
    corrected: int = 0
    emitted: int = 0
    crc_fail: int = 0   # detections dropped uncorrectable (noise candidates
    #                     that passed the preamble checks but failed CRC/ECC
    #                     — the false-positive pressure gauge)
    ring_dropped: int = 0  # GAUGE, not a counter: cumulative samples the
    #                     native ring dropped on real-time (UDP) overrun,
    #                     mirrored from IQStream.dropped by the feeder (the
    #                     reference prints "O" per USRP overrun; silent
    #                     sample loss must be visible)


def quantize_i8_np(x: np.ndarray, gain: float) -> np.ndarray:
    """THE int8 quantization rule, elementwise on any float layout:
    round(f32 * gain) clipped to +-127, np.round half-to-even; NaN
    quantizes to 0 and +-inf saturates (deterministic, matching the
    native quant_i8 — NaN.astype(int8) is undefined and diverged from
    the C path). The native runtime (iqstream.cc quantize_i8
    / iq_quantize_planar_i8) implements the identical rule in C; keep
    every Python-side quantizer on this one helper so the full_scale =
    gain/127 dBFS referencing can never drift between paths."""
    y = np.clip(np.round(x * gain), -127, 127)
    return np.where(np.isnan(y), 0.0, y).astype(np.int8)


def quantize_planar_i8_np(iq: np.ndarray, gain: float):
    """Planar int8 (I, Q) view of quantize_i8_np for complex input."""
    return quantize_i8_np(iq.real, gain), quantize_i8_np(iq.imag, gain)


def _bits_to_int(bits: np.ndarray, nbits: int) -> int:
    # nbits is always byte-aligned (56/112); packbits is ~10x the Python
    # shift/or loop this replaced, on the per-message product hot path
    return int.from_bytes(np.packbits(bits[:nbits]).tobytes(), "big")


def table_to_messages(
    table,
    block_start_sample: int,
    rate: float,
    epoch: float = 0.0,
    full_scale: float = 1.0,
    stats: Optional[BlockStats] = None,
) -> List[str]:
    """Convert one (host-fetched) DetectionTable into wire strings.

    `table` fields may be numpy arrays or CPU tensors (np.asarray-able).
    Detections with STATUS_FAIL are dropped here (drop-and-continue).

    Wire format: "<df> <hex> <syndrome> <status> <ref_dbfs> <timestamp>
    [<timestamp_ns>]". The trailing int64-nanosecond field is a
    compatible extension (consumers ignore extra fields): the float
    seconds field's ulp at unix-epoch magnitude is ~238 ns (~70 m of
    TDOA pseudorange), which floors mlat accuracy; the ns field keeps
    the sample clock's full precision (epoch*1e9 rounded once + the
    sample offset scaled in integer ns).
    """
    index = np.asarray(table.index)
    status = np.asarray(table.status)
    df = np.asarray(table.df)
    nbits = np.asarray(table.nbits)
    synd = np.asarray(table.syndrome)
    ref = np.asarray(table.ref_level)
    bits = np.asarray(table.bits)

    if stats is not None:
        stats.preambles += int(np.asarray(table.n_detected))
        stats.overflow += int(np.asarray(table.n_overflow))

    msgs: List[str] = []
    epoch_ns = int(round(epoch * 1e9))
    order = np.argsort(index, kind="stable")
    for k in order:
        if index[k] < 0:
            continue
        if status[k] == STATUS_FAIL:
            if stats is not None:
                stats.crc_fail += 1
            continue
        n = int(nbits[k])
        frame = _bits_to_int(bits[k], n)
        t = epoch + (block_start_sample + int(index[k])) / rate
        ref_dbfs = 10.0 * math.log10(max(float(ref[k]), 1e-30) / (full_scale ** 2))
        # DF 24..31 are all Comm-D ELM (first two bits 11; KE/ND spill into
        # the low DF bits): normalize to 24 on the wire, the format the
        # parser dispatches on (ref: parse.py treats first-2-bits==3 as DF24)
        df_wire = min(int(df[k]), 24)
        samples = block_start_sample + int(index[k])
        irate = int(rate)
        if irate == rate:
            # INTEGER ns scaling: the float64 form (samples*1e9/rate)
            # loses ~4 ns after months of uptime (samples ~3e13 -> the
            # 1e22 intermediate has ~8e6 ulp), eroding the ns field's
            # whole purpose; every supported channel rate is integral
            # (the GPS-counter path already scales in ints)
            ns = epoch_ns + (samples * 1_000_000_000) // irate
        else:
            ns = epoch_ns + int(round(samples * 1e9 / rate))
        msgs.append(
            f"{df_wire} {frame:0{n // 4}x} {int(synd[k]) & 0xFFFFFF:06x} "
            f"{int(status[k])} {ref_dbfs:.2f} {t:.9f} {ns}")
        if stats is not None:
            stats.emitted += 1
            if status[k] == STATUS_CRC_OK:
                stats.crc_ok += 1
            elif status[k] in (STATUS_CORRECTED_1, STATUS_CORRECTED_2):
                stats.corrected += 1
    return msgs


# the rule under a second name: `io.stream._drain` formats rows natively
# only while `table_to_messages` is this function
RULE = table_to_messages
