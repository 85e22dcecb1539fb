"""The demod pipeline's XLA stages and decode tail, in PyTorch.

The counterpart of `airmodes/dsp/pipeline.py`:

- the full-block detect path the reference leaves to XLA (`demod_block`):
  `magnitude_squared`, the trailing `noise_floor`, `chip_energy`,
  `preamble_detect` at every owned sample, `compact_detections` into the
  first K hits, `slice_bits`. No hand kernel is involved; the streaming
  runner takes this path where the f32 detect kernels' gate
  (`kernels.preamble.supported_2d_tile`) refuses the config;
- the decode tail every path shares: CRC-24 check and low-confidence ECC
  (`crc_check_and_correct`), the masking of empty table rows
  (`finalize_table`), and the packed `(K+1, 9)` int32 transfer format
  (`pack_table` on the device, `unpack_table` in numpy on the host).

Every function takes tensors with any leading batch shape, e.g. `(K, 112)`
bits for one block or `(C, K, 112)` for a batch of C blocks, and runs on
whatever device its inputs live on. The reference's onehot matmuls (TPU
gather workarounds) become gathers, sorts and integer XOR folds here: the
syndrome is exact integer arithmetic, never a float product.

Numerics: XLA on the CPU contracts `xi*xi + xq*xq` into fma(xi, xi, xq*xq)
and, at sps > 1, the chip-energy scales into the preamble's pulse sum; the
port writes the same FMAs (`fma_f32`). The noise floor's
mean and cumsum reduce in another order than XLA's, so `noise` agrees to
~1e-6 relative, not bit for bit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import crc
from ..config import DspConfig
from ..constants import (
    CHIPS_PER_BIT,
    MAX_FRAME_BITS,
    PREAMBLE_CHIPS,
    PREAMBLE_PULSE_CHIPS,
    PREAMBLE_QUIET_CHIPS,
    STATUS_ADDR,
    STATUS_CORRECTED_1,
    STATUS_CORRECTED_2,
    STATUS_CRC_OK,
    STATUS_FAIL,
)
from ..utils.graphs import graphed


class DetectionTable(NamedTuple):
    """Fixed-shape per-block output; every field has the same leading batch
    shape `B` (empty for one block)."""

    index: torch.Tensor      # (*B, K) int32 — preamble start within the owned region; -1 invalid
    bits: torch.Tensor       # (*B, K, 112) uint8 — post-ECC frame bits (MSB first)
    df: torch.Tensor         # (*B, K) int32
    nbits: torch.Tensor      # (*B, K) int32 — 56 or 112
    syndrome: torch.Tensor   # (*B, K) int32 — packed 24-bit post-correction syndrome
    status: torch.Tensor     # (*B, K) int32 — STATUS_* code
    ref_level: torch.Tensor  # (*B, K) float32 — preamble reference power
    noise: torch.Tensor      # (*B, K) float32 — noise floor at detection
    n_detected: torch.Tensor  # (*B,) int32 — preamble hits in the owned region
    n_overflow: torch.Tensor  # (*B,) int32 — hits dropped because K was exceeded


# --- f32 arithmetic the reference's compiled programs carry ------------------

def _f32(x: float) -> float:
    """x rounded to float32, as a Python float (exact in double)."""
    return float(np.float32(x))


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. "cuda" without a card raises:
    nothing moves to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def _f64(x):
    return x.to(torch.float64) if isinstance(x, torch.Tensor) else float(x)


def fma_f32(a, b, c) -> torch.Tensor:
    """Correctly rounded f32 fma(a, b, c) of f32 tensors (or f32 values
    given as Python floats; at least one argument a tensor), as __fmaf_rn
    computes it and as XLA on the CPU contracts a*b + c.

    The product of two f32 values is exact in float64, the sum is not:
    rounding it to float64 and then to f32 can round twice. TwoSum gives
    the float64 sum's exact error; where the float64 sum lies exactly on
    an f32 tie, that error decides the direction, which is what a single
    rounding of the exact value would do. Elsewhere the float64 sum
    rounds to the same f32 as the exact value."""
    p = _f64(a) * _f64(b)                               # exact
    c64 = _f64(c)
    s = p + c64
    bp = s - p
    err = (p - (s - bp)) + (c64 - bp)                   # s + err == p + c
    r = s.to(torch.float32)
    off = s - r.to(torch.float64)                       # exact
    toward = torch.where(off > 0, torch.inf, -torch.inf).to(torch.float32)
    other = torch.nextafter(r, toward)
    tie = (off != 0) & (other.to(torch.float64) - s == off)
    return torch.where(tie & (err * off > 0), other, r)


def power_f32(xi: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """f32 power fma(xi, xi, xq*xq) of unit-scale f32 I/Q."""
    return fma_f32(xi, xi, xq * xq)


def chip_sums(m: torch.Tensor, sps: int) -> torch.Tensor:
    """acc[x] = ((m[x] + m[x+1]) + ...) + m[x+sps-1] along the last axis
    (length shrinks by sps - 1); the chip energy is acc * f32(1/sps)."""
    length = m.shape[-1] - (sps - 1)
    acc = m[..., :length]
    for s in range(1, sps):
        acc = acc + m[..., s:s + length]
    return acc


def ref_chain(acc, sps: int):
    """Reference level of the decode tails and the XLA detect path from the
    four pulses' chip sums acc = (S0, S1, S2, S3): at sps > 1 XLA on the
    CPU contracts every chip-energy scale but pulse 1's into the pulse sum,
    fma(S3, s, fma(S2, s, fma(S0, s, S1*s))) * 0.25."""
    a0, a1, a2, a3 = acc
    if sps == 1:
        return (((a0 + a1) + a2) + a3) * 0.25
    s = _f32(1.0 / sps)
    r = fma_f32(a0, s, a1 * s)
    r = fma_f32(a2, s, r)
    return fma_f32(a3, s, r) * 0.25


# --- the XLA detect path -----------------------------------------------------

def iq_to_device_layout(iq):
    """Host-side: complex64 (..., N) -> float32 (..., N, 2) zero-copy view;
    other arrays pass through."""
    arr = np.ascontiguousarray(iq)
    if arr.dtype == np.complex64:
        return arr.view(np.float32).reshape(*arr.shape, 2)
    return arr


def magnitude_squared(iq: torch.Tensor) -> torch.Tensor:
    """|IQ|^2 as the reference computes it, fma(i, i, q*q) in f32, of
    complex64 or (..., 2) I/Q; int8 and int16 wire samples are scaled by
    exactly 1/127 and 1/32767 first."""
    if iq.is_complex():
        iq = torch.view_as_real(iq.to(torch.complex64))
    if iq.shape[-1] != 2:
        raise ValueError("expected (..., 2) (I, Q) layout")
    if iq.dtype == torch.uint8:
        # raw rtl-sdr bytes are offset-binary: squaring them wraps into
        # valid-shaped garbage
        raise TypeError(
            "magnitude_squared: uint8 (raw uc8 bytes) unsupported — "
            "convert offset-127 unsigned to centered int8/float32 first")
    if iq.dtype in (torch.int8, torch.int16):
        scale = 1.0 / 127.0 if iq.dtype == torch.int8 else 1.0 / 32767.0
        iq = iq.to(torch.float32) * _f32(scale)
    iq = iq.to(torch.float32)
    return power_f32(iq[..., 0], iq[..., 1])


def _row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """torch.cumsum along the last axis, each row summed in one fixed
    order. On a card a tensor that is a single row takes CUB's device-wide
    scan, whose float sums follow the timing of its look-back across
    blocks (two runs on one input differ in the last bits); stacked over
    a zero row it takes the row scan a batch takes: the same values each
    run, and the values that row gets inside a batch."""
    if x.is_cuda and x.numel() == x.shape[-1]:
        row = x.reshape(1, -1)
        both = torch.cat([row, torch.zeros_like(row)])
        return torch.cumsum(both, dim=-1)[0].reshape(x.shape)
    return torch.cumsum(x, dim=-1)


def noise_floor(mag2: torch.Tensor, window: int) -> torch.Tensor:
    """Trailing moving average: noise[i] = mean(mag2[i-window:i]) along
    the last axis; the first `window` samples reuse the first full
    window's value. The reference's mean-centered cumsum difference: the
    centering keeps the f32 running sum near zero."""
    mu = mag2.mean(dim=-1, keepdim=True)
    cs = _row_cumsum(mag2 - mu)
    cspad = torch.nn.functional.pad(cs, (1, 0))
    sums = cspad[..., window:] - cspad[..., :-window] + window * mu
    avg = sums * (1.0 / window)
    pad = avg[..., :1].expand(*avg.shape[:-1], window)
    return torch.cat([pad, avg[..., :-1]], dim=-1)


def chip_energy(mag2: torch.Tensor, sps: int) -> torch.Tensor:
    """ce[i] = mean(mag2[i : i+sps]) along the last axis, cyclic at the end
    as the reference's roll; the identity at sps == 1."""
    if sps == 1:
        return mag2
    acc = mag2
    for s in range(1, sps):
        acc = acc + torch.roll(mag2, -s, dims=-1)
    return acc * _f32(1.0 / sps)


def preamble_detect(mag2: torch.Tensor, noise: torch.Tensor, cfg: DspConfig,
                    left: int, n_owned: int):
    """The 4-pulse + quiet-chip preamble test at every owned sample,
    extended nms_chips into both halos, then non-max suppression (ties
    break toward the earliest sample). Returns (mask bool, ref_level f32)
    over the owned region, leading dims kept."""
    sps = cfg.sps
    acc = chip_sums(mag2, sps) if sps > 1 else mag2
    m = acc * _f32(1.0 / sps) if sps > 1 else mag2
    half = cfg.nms_chips * sps
    base = left - half
    n_ext = n_owned + 2 * half

    def sl(x, shift):
        return x[..., base + shift: base + shift + n_ext]

    pulses = [sl(m, c * sps) for c in PREAMBLE_PULSE_CHIPS]
    ref = ref_chain([sl(acc, c * sps) for c in PREAMBLE_PULSE_CHIPS], sps)
    nf = sl(noise, 0)
    thresh = _f32(cfg.threshold)
    ok = (pulses[0] >= sl(m, -1)) & (pulses[0] > sl(m, 1))
    ptol = _f32(cfg.pulse_tolerance)
    for p in pulses:
        ok &= (p > nf * thresh) & (p > ref * ptol)
    qtol = _f32(cfg.quiet_tolerance)
    for q in PREAMBLE_QUIET_CHIPS:
        ok &= sl(m, q * sps) < ref * qtol

    score = torch.where(ok, ref, 0.0)
    owned = score[..., half: half + n_owned]
    left_max = torch.full_like(owned, -torch.inf)
    right_max = torch.full_like(owned, -torch.inf)
    for d in range(1, half + 1):
        left_max = torch.maximum(left_max,
                                 score[..., half - d: half - d + n_owned])
        right_max = torch.maximum(right_max,
                                  score[..., half + d: half + d + n_owned])
    ok = ok[..., half: half + n_owned] & (owned > left_max) \
        & (owned >= right_max)
    return ok, ref[..., half: half + n_owned]


def compact_detections(mask: torch.Tensor, max_detections: int,
                       group: int = 1024, per_group: int = 16):
    """(..., N) bool mask -> the first-K indices (ascending, -1 past the
    valid ones), valid mask, hit count and overflow, with the reference's
    spill rule: when N allows it, each `group`-sample group keeps only its
    `per_group` earliest hits, and the rest count as overflow. The
    reference selects with top_k and onehot matmuls (TPU workarounds);
    a sort of the hit indices gives the same result."""
    n = mask.shape[-1]
    K = max_detections
    dev = mask.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    n_det = mask.sum(dim=-1, dtype=torch.int32)
    grouped = not (n % group != 0 or n < 4 * group
                   or (n // group) * per_group < K)
    if grouped:
        g = mask.reshape(*mask.shape[:-1], n // group, group)
        rank = torch.cumsum(g.to(torch.int32), dim=-1)
        kept = (g & (rank <= per_group)).reshape(mask.shape)
    else:
        kept = mask
    big = n
    key = torch.where(kept, idx, big)
    if n < K:
        key = torch.nn.functional.pad(key, (0, K - n), value=big)
    first = torch.topk(key, K, dim=-1, largest=False, sorted=True).values
    valid = first < big
    det_idx = torch.where(valid, first, -1).to(torch.int32)
    n_valid = valid.sum(dim=-1, dtype=torch.int32)
    if grouped:
        overflow = n_det - n_valid
    else:
        overflow = torch.clamp(n_det - K, min=0)
    return det_idx, valid, n_det, overflow


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx] per leading index: x (*B, N), idx (*B, *S) int."""
    lead = x.shape[:-1]
    flat = idx.reshape(*lead, -1).to(torch.int64)
    return torch.gather(x, -1, flat).reshape(idx.shape)


def slice_bits(mag2, det_idx, valid, ref_level, cfg: DspConfig, left: int):
    """224 data chips per detection; PPM compare -> bits + confidence."""
    sps = cfg.sps
    n_chips = MAX_FRAME_BITS * CHIPS_PER_BIT
    dev = mag2.device
    base = left + torch.where(valid, det_idx, 0).to(torch.int64) \
        + PREAMBLE_CHIPS * sps
    chip_offsets = torch.arange(n_chips, dtype=torch.int64, device=dev) * sps
    if sps == 1:
        energies = _take(mag2, base[..., None] + chip_offsets)
    else:
        sub = torch.arange(sps, dtype=torch.int64, device=dev)
        gathered = _take(mag2, base[..., None, None]
                         + chip_offsets[:, None] + sub)
        acc = gathered[..., 0]
        for s in range(1, sps):
            acc = acc + gathered[..., s]
        energies = acc * _f32(1.0 / sps)
    e0 = energies[..., 0::2]
    e1 = energies[..., 1::2]
    bits = e0 > e1
    level = ref_level[..., None] * _f32(cfg.confidence_level)
    confidence = (e0 > level) ^ (e1 > level)
    return bits, confidence


def demod_block(iq: torch.Tensor, cfg: DspConfig) -> DetectionTable:
    """The XLA path on the input's device: (..., L+N+R, 2) I/Q (f32, int8
    or int16) or (..., L+N+R) complex64 -> DetectionTable with the same
    leading dims. A short input raises: the framers always pad to the
    full frame, and a short one would decode misaligned."""
    left, n = cfg.left_halo, cfg.block_size
    need = left + n + cfg.right_halo
    length = iq.shape[-1] if iq.is_complex() else iq.shape[-2]
    if length < need:
        raise ValueError(
            f"block length {length} < left+block+right {need}: "
            "frame with io.sources (zero-padded halos)")
    mag2 = magnitude_squared(iq)
    noise = noise_floor(mag2, cfg.noise_window)
    mask, ref = preamble_detect(mag2, noise, cfg, left, n)
    det_idx, valid, n_det, overflow = compact_detections(
        mask, cfg.max_detections)
    safe_idx = torch.where(valid, det_idx, 0)
    ref_level = _take(ref, safe_idx)
    noise_at = _take(noise, left + safe_idx)
    bits, confidence = slice_bits(mag2, det_idx, valid, ref_level, cfg, left)
    out_bits, df, nbits, synd, status = crc_check_and_correct(
        bits, confidence, cfg)
    return finalize_table(valid, det_idx, out_bits, df, nbits, synd, status,
                          ref_level, noise_at, n_det, overflow)


def _to_device(x, dev: torch.device) -> torch.Tensor:
    """A host array (numpy; complex64 is viewed as (..., 2) f32) or a
    tensor, on `dev`; host memory goes over without blocking."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(iq_to_device_layout(x)))
    return x.to(dev, non_blocking=True)


def demod_block_packed(iq, cfg: DspConfig, device="cuda") -> torch.Tensor:
    """demod_block + pack_table: one block -> (K+1, 9) int32 on `device`.
    Runs on the card unless the caller asks for the CPU."""
    return pack_table(demod_block(_to_device(iq, resolve_device(device)),
                                  cfg))


def demod_batch(iq, cfg: DspConfig, device="cuda") -> DetectionTable:
    """demod_block over a leading channel axis: (C, L+N+R, 2) -> a
    DetectionTable with leading C, on `device`."""
    return demod_block(_to_device(iq, resolve_device(device)), cfg)


def demod_batch_packed(iq, cfg: DspConfig, device="cuda") -> torch.Tensor:
    """demod_batch + pack_table: (C, L+N+R, 2) -> (C, K+1, 9) int32."""
    return pack_table(demod_batch(iq, cfg, device=device))


# the full-block path's compiled steps: each a captured graph per key on a
# card (utils.graphs), the function itself on the CPU

@graphed(static_argnames=("cfg",))
def demod_block_jit(iq, cfg: DspConfig, device="cuda") -> DetectionTable:
    """demod_block on `device`: one block -> a DetectionTable (of tensors
    no later call overwrites)."""
    return demod_block(_to_device(iq, resolve_device(device)), cfg)


@graphed(static_argnames=("cfg",))
def demod_block_packed_jit(iq, cfg: DspConfig,
                           device="cuda") -> torch.Tensor:
    """demod_block_packed as a captured graph on a card."""
    return demod_block_packed(iq, cfg, device=device)


@graphed(static_argnames=("cfg",))
def demod_batch_jit(iq, cfg: DspConfig, device="cuda") -> DetectionTable:
    """demod_batch as a captured graph on a card: (C, L+N+R, 2) -> a
    DetectionTable with leading C."""
    return demod_batch(iq, cfg, device=device)


@graphed(static_argnames=("cfg",))
def demod_batch_packed_jit(iq, cfg: DspConfig,
                           device="cuda") -> torch.Tensor:
    """demod_batch_packed as a captured graph on a card: the runners'
    step for configs outside the kernels' gates."""
    return demod_batch_packed(iq, cfg, device=device)


@functools.lru_cache(maxsize=None)
def _crc_tables():
    """Packed syndrome rows for 112- and 56-bit frames (numpy int32).

    rows112[i] = syndrome contribution of bit i in a 112-bit frame;
    rows56 aligned into the first 56 lanes (bits 56..111 contribute 0).
    """
    r112 = crc.syndrome_rows(112).astype(np.int32)
    r56 = np.zeros(112, dtype=np.int32)
    r56[:56] = crc.syndrome_rows(56).astype(np.int32)
    return r112, r56


class CrcRows(torch.nn.Module):
    """The syndrome rows as device buffers. rows112 carries one extra zero
    entry at index 112, the "no position" value of the pair search."""

    def __init__(self):
        super().__init__()
        r112, r56 = _crc_tables()
        self.register_buffer("rows112", torch.from_numpy(
            np.concatenate([r112, np.zeros(1, np.int32)])))
        self.register_buffer("rows56", torch.from_numpy(r56.copy()))


_ROWS: dict = {}


def _crc_rows(device: torch.device) -> CrcRows:
    key = str(device)
    if key not in _ROWS:
        _ROWS[key] = CrcRows().to(device)
    return _ROWS[key]


def _xor_fold(v: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis (length <= 128) by halving: exact, and the
    order does not matter for XOR."""
    n = v.shape[-1]
    v = torch.nn.functional.pad(v, (0, 128 - n))
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] ^ v[..., h:]
    return v[..., 0]


def _df_of(bits_i: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(4, -1, -1, dtype=torch.int32, device=bits_i.device)
    return (bits_i[..., :5] << shifts).sum(dim=-1, dtype=torch.int32)


def crc_check_and_correct(bits: torch.Tensor, confidence: torch.Tensor,
                          cfg: DspConfig):
    """Per-detection CRC + the reference's acceptance/correction policy.

    bits, confidence: (*B, K, 112) bool. Returns (bits, df, nbits,
    syndrome, status) with the same rules as the reference:
    - DF (first 5 bits) selects frame length: 112 for DF >= 16, else 56.
    - DF11: accept when the HIGH 17 syndrome bits are zero.
    - DF17/18: require syndrome == 0; else flip the first low-confidence
      bit whose row equals the syndrome, else the first pair (a, b) of the
      first `max_lowconf_bits` low-confidence positions, in loop order,
      whose rows XOR to it — only when the low-confidence count is
      <= cfg.max_lowconf_bits.
    - A flip that moves the frame into the other length class fails.
    - Other DFs (AP overlaid with ICAO): emitted with syndrome as address.
    """
    dev = bits.device
    rows = _crc_rows(dev)
    rows112 = rows.rows112[:112]
    bits_i = bits.to(torch.int32)
    lane = torch.arange(112, dtype=torch.int32, device=dev)

    df = _df_of(bits_i)
    is_long = df >= 16
    nbits = torch.where(is_long, 112, 56).to(torch.int32)

    in_frame = lane < nbits[..., None]
    fbits = bits & in_frame
    synd112 = _xor_fold(torch.where(fbits, rows112, 0))
    synd56 = _xor_fold(torch.where(fbits, rows.rows56, 0))
    synd = torch.where(is_long, synd112, synd56)

    lowconf = ~confidence & in_frame
    n_lowconf = lowconf.sum(dim=-1, dtype=torch.int32)

    # single flips: the first low-confidence bit whose row is the syndrome
    # (correction is gated to long frames, so rows112 applies throughout)
    match1 = lowconf & (rows112 == synd[..., None])
    has1 = match1.any(dim=-1)
    flip1 = match1.to(torch.uint8).argmax(dim=-1)   # first maximal index

    # pair flips among the first L low-confidence positions, first (a, b)
    # in loop order; position 112 means "none" and has row 0
    L = int(cfg.max_lowconf_bits)
    cand = torch.where(lowconf, lane, 112)
    ps, rowsp = [], []
    for _ in range(L):
        p = cand.min(dim=-1).values
        ps.append(p)
        rowsp.append(rows.rows112[p.long()])
        cand = torch.where(cand == p[..., None], 112, cand)
    has2 = torch.zeros_like(has1)
    flip2_i = torch.zeros_like(synd)
    flip2_j = torch.zeros_like(synd)
    for a in range(L):
        for b in range(a + 1, L):
            m = (ps[b] < 112) & ((rowsp[a] ^ rowsp[b]) == synd) & ~has2
            flip2_i = torch.where(m, ps[a], flip2_i)
            flip2_j = torch.where(m, ps[b], flip2_j)
            has2 |= m

    ecc_allowed = ((df == 17) | (df == 18)) & (n_lowconf <= L)
    ok0 = synd == 0
    use1 = ecc_allowed & ~ok0 & has1
    use2 = ecc_allowed & ~ok0 & ~has1 & has2

    flip_mask = use1[..., None] & (lane == flip1[..., None])
    flip_mask |= use2[..., None] & ((lane == flip2_i[..., None]) |
                                    (lane == flip2_j[..., None]))
    out_bits = bits ^ flip_mask
    out_synd = torch.where(use1 | use2, 0, synd)

    df11_ok = (df == 11) & ((synd & 0xFFFF80) == 0)
    ok_long = ((df == 17) | (df == 18)) & ok0
    addr_type = ((df == 0) | (df == 4) | (df == 5) | (df == 16) |
                 (df == 20) | (df == 21) | (df >= 24))

    status = torch.full_like(synd, STATUS_FAIL)
    status = torch.where(addr_type, STATUS_ADDR, status)
    status = torch.where(ok_long, STATUS_CRC_OK, status)
    status = torch.where(use1, STATUS_CORRECTED_1, status)
    status = torch.where(use2, STATUS_CORRECTED_2, status)
    status = torch.where(df11_ok, STATUS_CRC_OK, status)

    # the emitted df describes the CORRECTED frame; a flip that changes
    # the length class contradicts the length the CRC ran over
    df_out = _df_of(out_bits.to(torch.int32))
    class_flip = (use1 | use2) & ((df_out >= 16) != is_long)
    status = torch.where(class_flip, STATUS_FAIL, status)
    return out_bits, df_out, nbits, out_synd, status.to(torch.int32)


def finalize_table(valid, det_idx, bits, df, nbits, synd, status,
                   ref_level, noise_at, n_det, overflow) -> DetectionTable:
    """Mask EMPTY table rows to a deterministic all-zero shape (index -1,
    df -1, status FAIL), so tables compare equal across paths."""
    i32 = torch.int32
    return DetectionTable(
        index=torch.where(valid, det_idx, -1).to(i32),
        bits=(bits & valid[..., None]).to(torch.uint8),
        df=torch.where(valid, df, -1).to(i32),
        nbits=torch.where(valid, nbits, 0).to(i32),
        syndrome=torch.where(valid, synd, 0).to(i32),
        status=torch.where(valid, status, STATUS_FAIL).to(i32),
        ref_level=torch.where(valid, ref_level, 0.0),
        noise=torch.where(valid, noise_at, 0.0),
        n_detected=n_det.to(i32),
        n_overflow=overflow.to(i32),
    )


# --- packed single-array output ----------------------------------------------
#
# Row k (detection k): [index, df | nbits<<8 | status<<16, syndrome,
#                       ref_level(bitcast), noise(bitcast), w0..w3]
# where w0..w3 are the 112 frame bits packed 28 per int32 word (MSB first).
# Final extra row: [n_detected, n_overflow, 0, ...].

PACKED_COLS = 9


def pack_table(table: DetectionTable) -> torch.Tensor:
    """(*B, K+1, 9) int32 — one device->host transfer per batch."""
    dev = table.index.device
    lead = table.index.shape
    words = table.bits.to(torch.int32).reshape(*lead, 4, 28)
    shifts = torch.arange(27, -1, -1, dtype=torch.int32, device=dev)
    packed_bits = (words << shifts).sum(dim=-1, dtype=torch.int32)
    # df = -1 marks empty rows; it travels as 0xFF in the low byte
    meta = (table.df & 0xFF) + (table.nbits << 8) + (table.status << 16)
    rows = torch.cat([
        table.index[..., None], meta[..., None], table.syndrome[..., None],
        table.ref_level.contiguous().view(torch.int32)[..., None],
        table.noise.contiguous().view(torch.int32)[..., None],
        packed_bits,
    ], dim=-1)
    tail = torch.zeros((*lead[:-1], 1, PACKED_COLS), dtype=torch.int32,
                       device=dev)
    tail[..., 0, 0] = table.n_detected
    tail[..., 0, 1] = table.n_overflow
    return torch.cat([rows, tail], dim=-2)


def unpack_table(arr) -> DetectionTable:
    """Host-side inverse of pack_table for one block (numpy)."""
    arr = np.asarray(arr)
    rows, tail = arr[:-1], arr[-1]
    words = rows[:, 5:9].astype(np.uint32)
    bits = ((words[:, :, None] >> (27 - np.arange(28))[None, None, :]) & 1)
    bits = bits.reshape(rows.shape[0], 112).astype(np.uint8)
    i2f = lambda x: x.astype(np.int32).view(np.float32)
    meta = rows[:, 1]
    df = meta & 0xFF
    df = np.where(df == 0xFF, -1, df)
    return DetectionTable(
        index=rows[:, 0], bits=bits, df=df,
        nbits=(meta >> 8) & 0xFF, syndrome=rows[:, 2],
        status=meta >> 16,
        ref_level=i2f(rows[:, 3].copy()), noise=i2f(rows[:, 4].copy()),
        n_detected=tail[0], n_overflow=tail[1])
