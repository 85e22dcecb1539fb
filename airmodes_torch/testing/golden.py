"""Golden-capture verification harness: SNR sweeps + fault injection.

The port's copy of `airmodes/testing/golden.py`: a CPU numpy reference
decoder (independent of any device pipeline), SNR sweep of decode rates
through the port's `demod_block` (on the card unless the caller asks for
the CPU), and targeted bit-error injection exercising the brute-force ECC
path.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import crc
from ..config import DspConfig
from ..constants import (CHIPS_PER_BIT, MAX_FRAME_BITS, PREAMBLE_CHIPS,
                         PREAMBLE_PULSE_CHIPS, PREAMBLE_QUIET_CHIPS)
from . import encoder


# --------------------------------------------------------------------------
# CPU reference decoder (pure numpy, mirrors the pipeline's published
# detection semantics; used to cross-check the device pipeline)
# --------------------------------------------------------------------------

def reference_decode(iq: np.ndarray, cfg: Optional[DspConfig] = None
                     ) -> List[Tuple[int, str]]:
    """Decode a capture with plain numpy. Returns [(sample_index, hex)].

    Implements the same rules as airmodes_torch.dsp.pipeline (power domain,
    trailing noise window, 4 pulses, quiet chips, NMS, PPM compare, CRC with
    DF11 low-7 acceptance and DF17 low-confidence ECC) in straightforward
    sequential code: the oracle the vectorized device path must match.
    """
    cfg = cfg or DspConfig()
    sps = cfg.sps
    # zero left padding = the pipeline's zero left halo at capture start:
    # the device path scans EVERY owned sample (noise window over halo
    # zeros), but this loop starts at w+1 — without the pad a frame in
    # the first w samples would decode on device and not here.
    # Identical float sums for frames past the pad (leading zeros).
    pad = cfg.noise_window + cfg.nms_chips * sps + 2
    iq = np.concatenate([np.zeros(pad, np.complex64),
                         np.asarray(iq, np.complex64)])
    m_raw = np.abs(iq.astype(np.complex64)) ** 2
    n = len(m_raw)
    w = cfg.noise_window
    cs = np.cumsum(np.concatenate([[0.0], m_raw]).astype(np.float64))
    thresh = cfg.threshold
    # chip-energy integration (matches the pipeline at sps > 1)
    if sps > 1:
        ck = np.convolve(m_raw, np.ones(sps) / sps, "full")[sps - 1:]
        m = ck.astype(np.float64)
    else:
        m = m_raw

    out = []
    i = w + 1
    limit = n - (PREAMBLE_CHIPS + MAX_FRAME_BITS * CHIPS_PER_BIT + 2) * sps
    while i < limit:
        noise = (cs[i] - cs[i - w]) / w
        p = [m[i + c * sps] for c in PREAMBLE_PULSE_CHIPS]
        ref = sum(p) / 4.0
        ok = (p[0] > noise * thresh and m[i] >= m[i - 1] and m[i] > m[i + 1])
        if ok:
            ok = all(x > noise * thresh and x > ref * cfg.pulse_tolerance
                     for x in p)
        if ok:
            ok = all(m[i + q * sps] < ref * cfg.quiet_tolerance
                     for q in PREAMBLE_QUIET_CHIPS)
        if ok:
            # NMS window check (earliest max of ref within +-nms window)
            half = cfg.nms_chips * sps
            best = True
            # clamp to j >= w: cs[j - w] would wrap to the cumsum tail
            # for j < w, minting a NEGATIVE noise floor whose threshold
            # test passes on pure noise and wrongly suppresses a genuine
            # detection near the stream start (j < w+1 cannot itself be
            # a candidate, so excluding it matches the candidate loop)
            for j in range(max(i - half, w), i + half + 1):
                if j == i:
                    continue
                pj = [m[j + c * sps] for c in PREAMBLE_PULSE_CHIPS]
                refj = sum(pj) / 4.0
                okj = (pj[0] > ((cs[j] - cs[j - w]) / w) * thresh and
                       m[j] >= m[j - 1] and m[j] > m[j + 1] and
                       all(x > ((cs[j] - cs[j - w]) / w) * thresh and
                           x > refj * cfg.pulse_tolerance for x in pj) and
                       all(m[j + q * sps] < refj * cfg.quiet_tolerance
                           for q in PREAMBLE_QUIET_CHIPS))
                if okj and (refj > ref or (refj == ref and j < i)):
                    best = False
                    break
            ok = best
        if not ok:
            i += 1
            continue
        hexmsg = _slice_and_check(m, i, ref, cfg)
        if hexmsg is not None:
            out.append((i - pad, hexmsg))
        i += 1
    return out


def _slice_and_check(m, i, ref, cfg):
    sps = cfg.sps
    start = i + PREAMBLE_CHIPS * sps
    bits = np.zeros(MAX_FRAME_BITS, np.uint8)
    conf = np.zeros(MAX_FRAME_BITS, bool)
    level = ref * cfg.confidence_level
    for b in range(MAX_FRAME_BITS):
        # m is already chip-energy integrated at sps > 1
        e0 = m[start + 2 * b * sps]
        e1 = m[start + (2 * b + 1) * sps]
        bits[b] = e0 > e1
        conf[b] = (e0 > level) ^ (e1 > level)
    df = int("".join(map(str, bits[:5])), 2)
    nbits = 112 if df >= 16 else 56
    frame = 0
    for b in bits[:nbits]:
        frame = (frame << 1) | int(b)
    synd = crc.crc24(frame, nbits)
    if df == 11:
        return f"{frame:014x}" if (synd & 0xFFFF80) == 0 else None
    if df in (17, 18):
        if synd == 0:
            return f"{frame:028x}"
        lc = np.where(~conf[:nbits])[0]
        if len(lc) > cfg.max_lowconf_bits:
            return None
        rows = crc.syndrome_rows(nbits)

        def corrected(fixed: int) -> Optional[str]:
            # mirror the pipeline's class-flip rejection
            # (crc_check_and_correct): a flip landing in DF lanes 0-4 that
            # moves the frame across the 56/112 length-class boundary
            # contradicts the sliced length the CRC was computed over —
            # the device path sets STATUS_FAIL, so the oracle drops too
            df_out = (fixed >> (nbits - 5)) & 0x1F
            if (df_out >= 16) != (nbits == 112):
                return None
            return f"{fixed:028x}"

        # int(b): np.where yields int64 indices, and `1 << np.int64(s)`
        # computes in C-long space — OverflowError for shifts >= 63
        # instead of the 112-bit Python-int flip
        for b1 in lc:
            if rows[b1] == synd:
                return corrected(frame ^ (1 << (nbits - 1 - int(b1))))
        for x, b1 in enumerate(lc):
            for b2 in lc[x + 1:]:
                if (rows[b1] ^ rows[b2]) == synd:
                    return corrected(frame ^ (1 << (nbits - 1 - int(b1)))
                                     ^ (1 << (nbits - 1 - int(b2))))
        return None
    if df in (0, 4, 5, 16, 20, 21) or df >= 24:
        return f"{frame:0{nbits // 4}x}"
    return None


# --------------------------------------------------------------------------
# SNR sweep + fault injection
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SweepPoint:
    snr_db: float
    injected: int
    decoded: int

    @property
    def rate(self) -> float:
        return self.decoded / max(self.injected, 1)


def snr_sweep(snrs: Sequence[float], n_msgs: int = 40, seed: int = 0,
              cfg: Optional[DspConfig] = None,
              device="cuda") -> List[SweepPoint]:
    """Decode rate vs SNR through the port's full-block pipeline
    (`demod_block_jit`, a captured graph per call on a card) on `device`:
    the card unless the caller asks for the CPU."""
    from ..dsp import host
    from ..dsp.pipeline import DetectionTable, demod_block_jit
    from ..io import sources
    cfg = cfg or DspConfig(block_size=1 << 16, max_detections=64)
    points = []
    for snr in snrs:
        frames = encoder.random_df17_frames(n_msgs, seed=seed)
        # rate MUST follow cfg: generating at the 2 Msps default while
        # decoding at cfg.channel_rate lands preamble chips on wrong
        # samples and reports ~0% at every SNR with no error; a distinct
        # nonneg seed per 0.1 dB point (abs() would alias +/-snr to the
        # same noise realization)
        iq, truth = encoder.make_capture(frames, rate=cfg.channel_rate,
                                         snr_db=snr,
                                         spacing=3000 * cfg.sps,
                                         seed=seed + int(snr * 10) + 1200)
        got = set()
        for block, start in sources.frame_blocks(iq, cfg):
            table = DetectionTable(*(
                f.cpu().numpy()
                for f in demod_block_jit(block, cfg, device=device)))
            got |= {m.split()[1] for m in host.table_to_messages(
                table, start, cfg.channel_rate)}
        decoded = sum(1 for t in truth if t.hex in got)
        points.append(SweepPoint(snr, len(truth), decoded))
    return points


def inject_chip_errors(iq: np.ndarray, truth: encoder.GroundTruth,
                       bit_positions: Sequence[int],
                       mode: str = "erase") -> np.ndarray:
    """Corrupt specific data bits of one frame in a capture.

    mode "erase":    zero both chips of the bit (low confidence both ways);
    mode "flip":     move the pulse to the wrong chip (confident wrong bit);
    mode "dim":      wrong chip slightly brighter, both below the
                     confidence level (DETERMINISTIC low-confidence wrong
                     bit — erase leaves the read polarity to noise);
    mode "dim_keep": right chip slightly brighter, both below the level
                     (low-confidence but correctly-read bit).
    """
    iq = iq.copy()
    p = truth.sample_index
    amp = truth.amplitude
    sps = truth.sps            # chip offsets scale by samples-per-chip
    for b in bit_positions:
        c0 = p + (PREAMBLE_CHIPS + 2 * b) * sps
        c1 = c0 + sps
        bitval = (truth.frame >> (truth.nbits - 1 - b)) & 1
        if mode == "erase":
            iq[c0: c0 + sps] = iq[c1: c1 + sps] = 0.03 * amp
        elif mode in ("dim", "dim_keep"):
            # powers 0.36/0.25 of the reference pulse power: ordered (the
            # slicer reads the brighter chip) yet both under the default
            # 0.5*ref confidence level
            right = (c0, c1) if bitval else (c1, c0)
            hi, lo = (right[::-1] if mode == "dim" else right)
            iq[hi: hi + sps], iq[lo: lo + sps] = 0.6 * amp, 0.5 * amp
        else:
            on, off = (c0, c1) if bitval else (c1, c0)
            iq[on: on + sps], iq[off: off + sps] = 0.0, amp
    return iq
