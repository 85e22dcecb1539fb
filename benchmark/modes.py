"""A plain Mode S receiver, written from the rules that a configuration
states, for the reference that decides `correct`.

It shares no code with the program: it is neither a copy of the program's
demod, tail, compaction, wire formatter or parser, nor does it import
them. It reads int8 I/Q rows (`reference.py` frames, resamples and
quantizes them) and follows these rules, with the numbers of the
configuration's `DspConfig`:

- Power of a sample: I^2 + Q^2 of its int8 values. Every rule below is a
  comparison between sums of powers scaled by the same factors, so it is
  taken on these integers, in float64, where every sum is exact: the
  reference is the rule in exact arithmetic, not the program's float32
  rounding of it. A chip's energy E(y) is the mean power of the sps
  samples from y.
- Preamble at sample x: E(x) >= E(x - 1) and E(x) > E(x + 1) (x is a
  rising edge's peak); each of the pulses at chips 0, 2, 7, 9 has more
  energy than the noise floor times 10^(threshold_db / 10) and than the
  reference level times `pulse_tolerance`, the reference level being the
  pulses' mean and the noise floor the mean power of the `noise_window`
  samples before x; every quiet chip (1, 3-6, 8, 10-15) has less energy
  than the reference level times `quiet_tolerance`.
- Non-maximum suppression over `nms_chips` chips a side: a preamble is
  kept where its reference level is above every preamble's level in the
  half-window before it and not below any in the half-window after it.
- A block keeps its first `max_detections` preambles, in sample order.
- Bits: bit k is one where the energy of chip 16 + 2k is above that of
  chip 17 + 2k. It is of low confidence unless exactly one of the two
  chips is above the reference level times `confidence_level`.
- Downlink format (DF): the first five bits. DF 16 and up are 112 bits
  long, the others 56.
- CRC-24: the frame's bits, MSB first, as a polynomial over GF(2), divided
  by the generator x^24 + ... + x^13 + x^10 + x^3 + 1 (0x1FFF409) bit by
  bit; the remainder is the syndrome. Flipping bit i of an n-bit frame adds
  the syndrome of the n-bit frame holding that bit alone.
- Acceptance: DF 0, 4, 5, 16, 20, 21 and 24-31 carry the address in
  their parity: emitted with the syndrome as the address (status 3).
  DF 11 is accepted (status 0) when the syndrome's upper 17 bits are zero
  (the interrogator code may fill the lower 7). DF 17 and 18 are accepted
  at syndrome 0 (status 0); else, where at most `max_lowconf_bits` bits
  are of low confidence, the lowest such bit whose flip clears the
  syndrome is flipped (status 1), or else the first pair of them (lowest
  first bit, then lowest second) whose flips clear it (status 2). A
  correction that moves the DF into the other length class fails. Every
  other frame fails (status 4) and is not emitted.
- The wire format of an emitted frame: "<df> <hex> <syndrome> <status>
  <level dBFS> <seconds> <nanoseconds>": the DF of the (corrected) frame,
  24 for 24-31; the frame's n/4 hex digits; the syndrome in six hex digits
  (0 after a correction); the level 10 log10(reference level / full
  scale^2), two decimals, the full scale being the AGC gain over 127 on
  samples of unit scale (int8 over 127); the preamble's stream sample over
  the channel rate, nine decimals, and in whole nanoseconds (floor).

`fields` decodes, from the same rules, three fields of a report that the
program's parser makes: DF, the 24-bit address and the barometric altitude
in 25-foot steps.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

GENERATOR = 0x1FFF409
PULSE_CHIPS = (0, 2, 7, 9)
QUIET_CHIPS = (1, 3, 4, 5, 6, 8, 10, 11, 12, 13, 14, 15)
DATA_CHIP = 16
ADDRESS_DFS = (0, 4, 5, 16, 20, 21)
OK, FIXED_1, FIXED_2, ADDRESS, FAIL = 0, 1, 2, 3, 4


class Detections:
    """One block's preambles: owned sample `index` (ascending), reference
    level `ref` (integer power units) and the data chips' energies
    `chips` (D, 224), float64 numpy arrays; `found` counts every preamble
    of the block, kept or not."""

    def __init__(self, index, ref, chips, found):
        self.index, self.ref, self.chips, self.found = index, ref, chips, found


def detect(rows: torch.Tensor, cfg) -> List[Detections]:
    """(R, 2, W) int8 rows, owned sample d at column left_halo + d ->
    each row's preambles (the module's rules)."""
    sps = cfg.sps
    n = cfg.block_size
    nw = cfg.noise_window
    half = cfg.nms_chips * sps
    x0 = cfg.left_halo - half               # first tested column
    span = n + 2 * half                     # tested columns
    if x0 - nw < 0 or x0 - 1 < 0:
        raise ValueError("the left halo is shorter than the noise window")
    v = rows.to(torch.float64)
    power = v[:, 0] ** 2 + v[:, 1] ** 2
    cs = torch.nn.functional.pad(torch.cumsum(power, dim=1), (1, 0))
    energy = (cs[:, sps:] - cs[:, :-sps]) / sps   # E(y), y = 0 .. W - sps
    last = x0 + span - 1 + (DATA_CHIP + 224 - 1) * sps
    if last > energy.shape[1] - 1:
        raise ValueError("the right halo is shorter than a long frame")

    def e(off):
        return energy[:, x0 + off: x0 + off + span]

    floor = (cs[:, x0: x0 + span] - cs[:, x0 - nw: x0 - nw + span]) / nw
    pulses = [e(c * sps) for c in PULSE_CHIPS]
    ref = (pulses[0] + pulses[1] + pulses[2] + pulses[3]) / 4
    weakest = torch.minimum(torch.minimum(pulses[0], pulses[1]),
                            torch.minimum(pulses[2], pulses[3]))
    loudest_quiet = e(QUIET_CHIPS[0] * sps)
    for c in QUIET_CHIPS[1:]:
        loudest_quiet = torch.maximum(loudest_quiet, e(c * sps))
    ok = (pulses[0] >= e(-1)) & (pulses[0] > e(1))
    ok &= weakest > floor * (10.0 ** (cfg.threshold_db / 10.0))
    ok &= weakest > ref * cfg.pulse_tolerance
    ok &= loudest_quiet < ref * cfg.quiet_tolerance

    score = torch.where(ok, ref, torch.zeros_like(ref))
    own = score[:, half: half + n]
    before = torch.zeros_like(own)
    after = torch.zeros_like(own)
    for o in range(1, half + 1):
        before = torch.maximum(before, score[:, half - o: half - o + n])
        after = torch.maximum(after, score[:, half + o: half + o + n])
    keep = ok[:, half: half + n] & (own > before) & (own >= after)

    offs = (DATA_CHIP + torch.arange(224, device=rows.device)) * sps
    out = []
    for r in range(rows.shape[0]):
        idx = torch.nonzero(keep[r]).flatten()
        found = int(idx.numel())
        idx = idx[:cfg.max_detections]
        col = idx + cfg.left_halo
        chips = energy[r][col[:, None] + offs[None, :]]
        out.append(Detections(idx.cpu().numpy(),
                              ref[r, idx + half].cpu().numpy(),
                              chips.cpu().numpy(), found))
    return out


def syndromes(bits: np.ndarray, nbits: np.ndarray) -> np.ndarray:
    """(F, 112) 0/1 frames, their lengths (F,) -> (F,) int64 remainders
    of their first nbits bits over the generator, by long division."""
    r = np.zeros(bits.shape[0], np.int64)
    b = bits.astype(np.int64)
    for j in range(bits.shape[1]):
        nxt = (r << 1) | b[:, j]
        nxt = np.where(nxt & (1 << 24), nxt ^ GENERATOR, nxt)
        r = np.where(j < nbits, nxt, r)
    return r


def _flip_syndromes(n: int) -> np.ndarray:
    """(n,) the syndrome of each n-bit frame holding one bit alone."""
    eye = np.eye(n, 112, dtype=np.uint8)
    return syndromes(eye, np.full(n, n))


FLIP_112 = _flip_syndromes(112)


def _df(bits: np.ndarray) -> np.ndarray:
    return (bits[:, :5].astype(np.int64) * (1 << np.arange(4, -1, -1))
            ).sum(axis=1)


def decide(det: Detections, cfg):
    """A block's frames: (bits (D, 112) uint8 after correction, DF,
    length, syndrome, status, tied), each per detection. `tied` marks a
    frame whose bits or confidences hang on an exact tie (two chips, or a
    chip and the confidence level, of equal energy): the rules say
    "above", and the program's float32 rounding breaks such a tie either
    way, so its frame there is not judged on its content."""
    chips = det.chips
    on, off = chips[:, 0::2], chips[:, 1::2]
    bits = (on > off).astype(np.uint8)
    level = det.ref[:, None] * cfg.confidence_level
    sure = (on > level) != (off > level)
    df = _df(bits)
    nbits = np.where(df >= 16, 112, 56)
    synd = syndromes(bits, nbits)
    lane = np.arange(112)
    inside = lane[None, :] < np.maximum(nbits, np.where(
        (on[:, :5] == off[:, :5]).any(axis=1), 112, 0))[:, None]
    tied = (((on == off) | (on == level) | (off == level)) & inside).any(
        axis=1)
    unsure = ~sure & (lane[None, :] < nbits[:, None])
    status = np.full(df.shape, FAIL)
    status[np.isin(df, ADDRESS_DFS) | (df >= 24)] = ADDRESS
    squitter = (df == 17) | (df == 18)
    status[squitter & (synd == 0)] = OK
    status[(df == 11) & ((synd >> 7) == 0)] = OK
    fixed = np.zeros(df.shape, bool)
    try_fix = squitter & (synd != 0) & \
        (unsure.sum(axis=1) <= cfg.max_lowconf_bits)
    for k in np.nonzero(try_fix)[0]:
        pos = np.nonzero(unsure[k])[0]
        flips, st = None, FAIL
        for i in pos:
            if FLIP_112[i] == synd[k]:
                flips, st = [i], FIXED_1
                break
        if flips is None:
            for a in range(len(pos)):
                for b in range(a + 1, len(pos)):
                    if FLIP_112[pos[a]] ^ FLIP_112[pos[b]] == synd[k]:
                        flips, st = [pos[a], pos[b]], FIXED_2
                        break
                if flips is not None:
                    break
        if flips is not None:
            bits[k, flips] ^= 1
            status[k] = st
            fixed[k] = True
    df_out = _df(bits)
    status[fixed & ((df_out >= 16) != (df >= 16))] = FAIL
    synd = np.where(fixed, 0, synd)
    return bits, df_out, nbits, synd, status, tied


def emitted(det: Detections, decided, gain: float) -> List[tuple]:
    """(owned sample, "<df> <hex> <syndrome> <status> <level>" or None
    where the frame fails, tied) of each of a block's frames, in sample
    order."""
    bits, df, nbits, synd, status, tied = decided
    out = []
    for k in range(len(det.index)):
        if status[k] == FAIL:
            out.append((int(det.index[k]), None, bool(tied[k])))
            continue
        n = int(nbits[k])
        value = int("".join("1" if x else "0" for x in bits[k, :n]), 2)
        unit_level = float(det.ref[k]) / (127.0 * 127.0)
        full_scale = gain / 127.0
        dbfs = 10.0 * math.log10(max(unit_level, 1e-30) / full_scale ** 2)
        out.append((int(det.index[k]),
                    f"{min(int(df[k]), 24)} {value:0{n // 4}x} "
                    f"{int(synd[k]) & 0xFFFFFF:06x} {int(status[k])} "
                    f"{dbfs:.2f}", bool(tied[k])))
    return out


def stamp(sample: int, rate: float) -> str:
    """"<seconds> <nanoseconds>" of a stream sample."""
    if float(int(rate)) == rate:
        ns = sample * 1_000_000_000 // int(rate)
    else:
        ns = int(round(sample * 1e9 / rate))
    return f"{sample / rate:.9f} {ns}"


def messages(frames: List[tuple], block_start: int,
             rate: float) -> List[str]:
    """The wire messages of a block's `emitted` frames, its first owned
    sample at stream sample `block_start`."""
    return [f"{head} {stamp(block_start + index, rate)}"
            for index, head, _ in frames if head is not None]


def tied_stamps(frames: List[tuple], block_start: int, rate: float):
    """The stamps of a block's tied frames, emitted or not."""
    return {stamp(block_start + index, rate)
            for index, _, tied in frames if tied}


# -- three fields of a report --------------------------------------------------

def _altitude_13(ac: int) -> Optional[int]:
    """Feet of a 13-bit AC field with Q = 1 and M = 0 (25-foot steps):
    the 11 bits left once M (bit 6) and Q (bit 4) are taken out."""
    n = ((ac >> 2) & 0x7E0) | ((ac >> 1) & 0x10) | (ac & 0xF)
    return 25 * n - 1000


def fields(hexstr: str) -> Dict[str, object]:
    """The report fields that one frame decides, where these rules decide
    them: "df"; "icao" (DF 11, 17: the AA field; DF with the address in
    the parity: the syndrome); "altitude_ft" (DF 0, 4, 16, 20: the AC
    field; DF 17 airborne position with a barometric altitude, type codes
    9-18: its 12-bit field; None where the frame has none; left out where
    it is Gillham-coded, metric or GNSS, which these rules do not decode)."""
    n = 4 * len(hexstr)
    v = int(hexstr, 16)
    df = v >> (n - 5)
    out: Dict[str, object] = {"df": min(df, 24)}
    bits = np.array([(v >> (n - 1 - i)) & 1 for i in range(n)], np.uint8)
    if df in (11, 17):
        out["icao"] = (v >> (n - 32)) & 0xFFFFFF
    elif df in ADDRESS_DFS or df >= 24:
        out["icao"] = int(syndromes(np.pad(bits, (0, 112 - n))[None],
                                    np.array([n]))[0])
    if df in (0, 4, 16, 20):
        ac = (v >> (n - 32)) & 0x1FFF
        if ac == 0:
            out["altitude_ft"] = None
        elif not ac & 0x40 and ac & 0x10:
            out["altitude_ft"] = _altitude_13(ac)
    elif df == 17:
        tc = (v >> (n - 37)) & 0x1F
        if 9 <= tc <= 18:
            a12 = (v >> (n - 52)) & 0xFFF
            if a12 == 0:
                out["altitude_ft"] = None
            elif a12 & 0x10:
                out["altitude_ft"] = _altitude_13(
                    ((a12 & 0xFC0) << 1) | (a12 & 0x3F))
        elif not 20 <= tc <= 22:
            out["altitude_ft"] = None
    elif df in (5, 11, 21) or df >= 24:
        out["altitude_ft"] = None
    return out
