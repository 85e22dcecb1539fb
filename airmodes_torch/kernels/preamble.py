"""The demod paths with hand kernels: the planar int8 path (kernels B1, B2)
and the f32 fast path (kernels B3, B4), with the torch code between and
after them.

The counterpart of `airmodes/kernels/preamble_pallas.py`.

Planar int8 path: the host ships each channel's block as two planar int8
rows (I and Q) of `planar_length(cfg)` samples: `left_halo` samples of
history, the owned block, the right halo and a zero margin. Then, per batch
of C channels:

  B1 `preamble_detect_cands_planar`  (C, P) int8 x2 -> (C, tiles, 8, 128)
     per-lane candidate blocks (first 4 hits per tile lane column + counts)
  `compact_candidates_unordered`     -> the earliest K detections, counts
  B2 `slice_windows_planar`          -> one f32 power window per detection
  `_tail_from_power`                 -> bits, confidence, CRC/ECC, table

f32 fast path, on framed (L+N+R, 2) blocks of f32 (or int8/int16) I/Q:

  B3 `preamble_detect_2d` (one block) or B4 `preamble_detect_2d_batch`
     (C blocks)                      -> keep mask and ref per owned sample
  `dsp.pipeline.compact_detections`  -> the earliest K detections, counts
  `gather_tail`                      -> one power window per detection,
                                        then `_tail_from_power`

Each kernel wrapper launches its hand-written CUDA kernel (csrc/) when its
inputs are CUDA tensors, and runs the plain PyTorch version beside it only
when they lie on the CPU. It counts its kernel launches in `LAUNCHES`.

Numerics: the plain versions and the kernels compute the reference's f32
values bit for bit, including the FMAs that XLA on the CPU contracts: power
as fma(xi, xi, xq*xq), the trailing noise sum by the log-doubling fold,
chip energies as ((m0 + m1) + ...) * (1/sps), and the reference level as
(((p0 + p1) + p2) + p3) * 0.25 with, at sps > 1, pulse 0's chip-energy
scale contracted into the first add in the detect kernels
(`_ref_detect`) and every scale but pulse 1's in the decode tail
(`_ref_chain`). The reference may take the noise sum as two matmuls
instead (`mxu_window_sum`, "decision-equivalent", airmodes/config.py); the
port always folds.
"""

from __future__ import annotations


import numpy as np
import torch

from ..config import DspConfig
from ..constants import PREAMBLE_PULSE_CHIPS, PREAMBLE_QUIET_CHIPS
from ..dsp import pipeline as P
from ..dsp.pipeline import _f32, fma_f32, power_f32, resolve_device

_LOOKBACK = 256                            # noise window + peak/NMS lookback
_LOOKBACK_ROWS = _LOOKBACK // 128          # 2
_HALO_ROWS_I8 = 30                         # rows_w = trows + 32
CAND_PER_LANE = 4
CAND_ROWS = 8
_COUNT_ROW = 4                             # per-lane hit counts live here
DEFAULT_NBUF = 2
_CHUNK = 4096                              # owned samples per B1 CUDA block

# kernel launches since the last reset_launches(), per wrapper; only the
# CUDA paths count
LAUNCHES = {"detect_cands": 0, "slice_windows": 0, "detect_mask": 0}
# detect_mask launches by route: B3 (one block) and B4 (a batch of C > 1)
DETECT_MASK_ROUTES = {"B3": 0, "B4": 0}


def reset_launches() -> None:
    for d in (LAUNCHES, DETECT_MASK_ROUTES):
        for k in d:
            d[k] = 0


# --- geometry (copied from the reference, so the layouts agree) --------------

def default_tile(cfg: DspConfig) -> int:
    """Largest tile of the planar layout that divides the block."""
    for t in (131072, 65536, 32768, 16384, 8192, 4096):
        if cfg.block_size % t == 0:
            return t
    raise ValueError(
        f"block_size {cfg.block_size} not a multiple of 4096; "
        "the planar path needs 4096-aligned tiles")


def _check_limits(cfg: DspConfig) -> None:
    """The reference's planar gate: noise window 128, sps <= 9, and an NMS
    window of at least one sample."""
    if cfg.noise_window != 128:
        raise ValueError("the planar path fixes noise_window=128")
    if 14 * cfg.sps >= 128:
        raise ValueError(
            f"the planar path supports sps <= 9 (channel_rate <= 18 Msps); "
            f"got sps={cfg.sps}")
    if not 1 <= cfg.nms_chips * cfg.sps <= 128:
        raise ValueError(f"nms_chips*sps must be in [1, 128], got "
                         f"{cfg.nms_chips * cfg.sps}")


def supported_planar_tile(cfg: DspConfig):
    """Largest tile the planar path supports for cfg, or None."""
    try:
        _check_limits(cfg)
        return default_tile(cfg)
    except ValueError:
        return None


def cand_capacity(tile: int):
    """(per_tile, per_lane) candidate capacity for a tile size (the
    unordered layout clamps per_lane to 4)."""
    per_tile = min(512, max(16, (16 * tile) // 16384))
    per_lane = CAND_PER_LANE if tile <= 65536 else 8
    return per_tile, per_lane


def _per_lane(tile: int) -> int:
    """Hits kept per (tile, lane column): the unordered candidate layout
    caps the capacity at its 4 hit rows."""
    return min(cand_capacity(tile)[1], _COUNT_ROW)


def _slice_geometry(cfg: DspConfig, extra: int = 0):
    """(W, out_rows, pad_rows, dma_rows) of the per-detection windows."""
    W = cfg.noise_window + 242 * cfg.sps + 2 * extra
    out_rows = -(-W // 128)
    pad_rows = -(-out_rows // 8) * 8
    dma_rows = 32 * (-(-(32 + out_rows + 1) // 32))
    return W, out_rows, pad_rows, dma_rows


def _planar_geometry(cfg: DspConfig, tile: int):
    """(trows, rows_w, tiles, stride_rows) of the planar layout; the stride
    keeps the reference's DMA margin so every window read stays inside."""
    trows = tile // 128
    rows_w = _LOOKBACK_ROWS + trows + _HALO_ROWS_I8
    if rows_w % 32 or trows % 32:
        raise ValueError("tile must be a multiple of 4096")
    tiles = cfg.block_size // tile
    needed_rows = (tiles - 1) * trows + rows_w + \
        _slice_geometry(cfg, cfg.nms_chips * cfg.sps)[3]
    stride_rows = -(-needed_rows // 32) * 32
    return trows, rows_w, tiles, stride_rows


def planar_length(cfg: DspConfig, tile: int = None) -> int:
    """Per-channel padded sample count the planar path expects."""
    if tile is None:
        tile = default_tile(cfg)
    return _planar_geometry(cfg, tile)[3] * 128


def to_planar_i8(blocks: np.ndarray, cfg: DspConfig, tile: int = None):
    """Host-side: (C, L+N+R, 2) int8 (or (L+N+R, 2)) -> padded planar
    (C, P) int8 I and Q arrays. Takes int8 only: a C-cast of a unit-scale
    float block would truncate every sample to {-1, 0, 1}."""
    if np.asarray(blocks).dtype != np.int8:
        raise TypeError(
            f"to_planar_i8 takes int8 (quantized) blocks, got "
            f"{np.asarray(blocks).dtype}; quantize first")
    x = np.asarray(blocks, dtype=np.int8)
    if x.ndim == 2:
        x = x[None]
    p = planar_length(cfg, tile)
    out_i = np.zeros((x.shape[0], p), np.int8)
    out_q = np.zeros((x.shape[0], p), np.int8)
    n = min(x.shape[1], p)
    out_i[:, :n] = x[:, :n, 0]
    out_q[:, :n] = x[:, :n, 1]
    return out_i, out_q


# --- power -------------------------------------------------------------------

def power_i8(xi8: torch.Tensor, xq8: torch.Tensor) -> torch.Tensor:
    """f32 fma(xi, xi, xq*xq) with xi = int8 * f32(1/127), as the reference
    computes it. Taken in float64 and rounded once to f32, which equals
    the single-rounded FMA for every int8 pair (all 65536 are checked in
    tests/test_torch_planar.py)."""
    s = _f32(1.0 / 127.0)
    fi = xi8.to(torch.float32) * s
    fq = xq8.to(torch.float32) * s
    fi64 = fi.to(torch.float64)
    return (fi64 * fi64 + (fq * fq).to(torch.float64)).to(torch.float32)


# --- the preamble rule, shared by kernels B1, B3 and B4 ----------------------

def _ref_detect(acc0, p0, p1, p2, p3, sps: int):
    """Reference level of the detect kernels, as the reference computes it
    on the CPU: (((p0 + p1) + p2) + p3) * 0.25, where at sps > 1 XLA
    contracts the chip-energy scale of pulse 0 (acc0 * 1/sps) into the
    first add; pulses 1-3 arrive through the kernel's lane shifts and are
    not contracted."""
    if sps > 1:
        s = _f32(1.0 / sps)
        first = fma_f32(acc0, s, p1)
    else:
        first = p0 + p1
    return ((first + p2) + p3) * 0.25


def _detect_plain(m: torch.Tensor, cfg: DspConfig):
    """The detect kernels' rule on (C, >= 256 + N + halo) f32 power rows,
    owned sample d at column d + 256 -> (keep bool (C, N), ref f32 (C, N))
    over the owned samples. The decision does not depend on the tile."""
    sps = cfg.sps
    half = cfg.nms_chips * sps
    n = cfg.block_size
    ws = m
    for s in (1, 2, 4, 8, 16, 32, 64):                  # ws[y] = sum m[y:y+128]
        ws = ws[:, :-s] + ws[:, s:]
    acc = P.chip_sums(m, sps) if sps > 1 else m
    ce = acc * _f32(1.0 / sps) if sps > 1 else m

    x0 = _LOOKBACK - half                               # first test sample
    nt = n + 2 * half

    def at(arr, off):
        return arr[:, x0 + off: x0 + off + nt]

    p0, p1, p2, p3 = (at(ce, c * sps) for c in PREAMBLE_PULSE_CHIPS)
    ref = _ref_detect(at(acc, 0), p0, p1, p2, p3, sps)
    nf = at(ws, -128) * (1.0 / 128.0)
    ok = (p0 >= at(ce, -1)) & (p0 > at(ce, 1))
    pmin = torch.minimum(torch.minimum(p0, p1), torch.minimum(p2, p3))
    ok &= pmin > torch.maximum(nf * _f32(cfg.threshold),
                               ref * _f32(cfg.pulse_tolerance))
    quiet = at(ce, PREAMBLE_QUIET_CHIPS[0] * sps)
    for q in PREAMBLE_QUIET_CHIPS[1:]:
        quiet = torch.maximum(quiet, at(ce, q * sps))
    ok &= quiet < ref * _f32(cfg.quiet_tolerance)
    score = torch.where(ok, ref, 0.0)

    own = score[:, half: half + n]
    left = torch.zeros_like(own)
    right = torch.zeros_like(own)
    for o in range(1, half + 1):
        left = torch.maximum(left, score[:, half - o: half - o + n])
        right = torch.maximum(right, score[:, half + o: half + o + n])
    keep = ok[:, half: half + n] & (own > left) & (own >= right)
    return keep, ref[:, half: half + n]


# --- kernel B1: detect + per-lane candidate extraction -----------------------


def _extract_plain(keep: torch.Tensor, tile: int,
                   per_lane: int) -> torch.Tensor:
    """(C, N) bool -> (C, tiles, 8, 128) int32 candidate blocks: rows
    0..per_lane-1 the first hits of each lane column (r*128 + lane,
    ascending, sentinel trows*128), row 4 the per-lane counts."""
    C, n = keep.shape
    trows = tile // 128
    k = keep.reshape(C, n // tile, trows, 128)
    dev = keep.device
    rowidx = torch.arange(trows, dtype=torch.int32, device=dev)[:, None]
    cand = torch.where(k, rowidx, trows)
    lane = torch.arange(128, dtype=torch.int32, device=dev)
    out = torch.zeros((C, n // tile, CAND_ROWS, 128), dtype=torch.int32,
                      device=dev)
    out[:, :, :_COUNT_ROW, :] = trows * 128
    for j in range(per_lane):
        cj = cand.min(dim=2).values                     # (C, tiles, 128)
        out[:, :, j, :] = torch.where(cj < trows, cj * 128 + lane,
                                      trows * 128)
        cand = torch.where(cand == cj[:, :, None, :], trows, cand)
    out[:, :, _COUNT_ROW, :] = k.sum(dim=2, dtype=torch.int32)
    return out


def detect_cands_plain(xi8: torch.Tensor, xq8: torch.Tensor, cfg: DspConfig,
                       tile: int) -> torch.Tensor:
    """Plain PyTorch version of kernel B1 (same inputs, same output)."""
    keep, _ = _detect_plain(power_i8(xi8, xq8), cfg)
    return _extract_plain(keep, tile, _per_lane(tile))


def _detect_rhalo(cfg: DspConfig) -> int:
    """Samples the detect kernels' CUDA blocks (B1, B3/B4) stage after
    their chunk: the NMS window plus the 16 chips of the preamble test,
    rounded up to 32."""
    need = cfg.nms_chips * cfg.sps + 16 * cfg.sps
    return -(-need // 32) * 32


def detect_cands_buffers(C: int, cfg: DspConfig, tile: int):
    """Shapes of the B1 CUDA launch's buffers: (per-chunk scratch, output)."""
    tiles = cfg.block_size // tile
    return (C * tiles * (tile // _CHUNK), 5, 128), (C, tiles, CAND_ROWS, 128)


def _detect_cands_cuda(xi8, xq8, cfg, tile):
    s_shape, o_shape = detect_cands_buffers(xi8.shape[0], cfg, tile)
    scratch = torch.empty(s_shape, dtype=torch.int32, device=xi8.device)
    out = torch.empty(o_shape, dtype=torch.int32, device=xi8.device)
    launch_detect_cands(xi8, xq8, cfg, tile, scratch, out)
    return out


def launch_detect_cands(xi8, xq8, cfg, tile, scratch, out) -> None:
    """Launch B1 on contiguous CUDA inputs into the given contiguous int32
    buffers (shapes from `detect_cands_buffers`); every element of both is
    written."""
    from . import _ext
    C, p = xi8.shape
    tiles = cfg.block_size // tile
    nchunk = tile // _CHUNK
    half = cfg.nms_chips * cfg.sps
    rhalo = _detect_rhalo(cfg)
    # the last chunk stages up to planar sample block_size + 256 + rhalo
    if cfg.block_size + _LOOKBACK + rhalo > p:
        raise ValueError("planar rows too short for the detect kernel")
    if (tuple(scratch.shape), tuple(out.shape)) != \
            detect_cands_buffers(C, cfg, tile) \
            or not (scratch.is_contiguous() and out.is_contiguous()):
        raise ValueError("B1 buffers of the wrong shape or not contiguous")
    lib = _ext.lib("detect_cands")
    with torch.cuda.device(xi8.device):
        rc = lib.detect_cands_launch(
            xi8.data_ptr(), xq8.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), C, p, tile, tiles, nchunk, _per_lane(tile),
            cfg.sps,
            half, rhalo, _f32(1.0 / 127.0), _f32(cfg.threshold),
            _f32(cfg.pulse_tolerance), _f32(cfg.quiet_tolerance),
            _f32(1.0 / cfg.sps),
            torch.cuda.current_stream(xi8.device).cuda_stream)
    _ext.check(rc, "detect_cands")
    LAUNCHES["detect_cands"] += 1


def preamble_detect_cands_planar(xi8: torch.Tensor, xq8: torch.Tensor,
                                 cfg: DspConfig, tile: int = None,
                                 nbuf: int = DEFAULT_NBUF) -> torch.Tensor:
    """Kernel B1: (C, P) int8 planar I/Q (P = planar_length(cfg, tile)) ->
    (C, tiles, 8, 128) int32 unordered candidate blocks.

    `nbuf` is the reference's TPU prefetch depth; it changes nothing in
    the result, and the CUDA kernel has one form for every value."""
    if tile is None:
        tile = default_tile(cfg)
    _check_limits(cfg)
    if nbuf < 1:
        raise ValueError(f"nbuf must be >= 1, got {nbuf}")
    if cfg.block_size % tile:
        raise ValueError(f"tile {tile} does not divide the block")
    p = planar_length(cfg, tile)
    if xi8.dim() != 2 or xi8.shape != xq8.shape or xi8.shape[1] != p:
        raise ValueError(f"expected two (C, {p}) planar arrays, got "
                         f"{tuple(xi8.shape)} and {tuple(xq8.shape)}")
    if xi8.dtype != torch.int8 or xq8.dtype != torch.int8:
        raise TypeError("planar arrays must be int8")
    if xi8.device != xq8.device:
        raise ValueError("I and Q must be on one device")
    if xi8.device.type == "cpu":
        return detect_cands_plain(xi8, xq8, cfg, tile)
    if xi8.device.type != "cuda":
        raise ValueError(f"unsupported device {xi8.device}")
    return _detect_cands_cuda(xi8.contiguous(), xq8.contiguous(), cfg, tile)


def compact_candidates_unordered(cands: torch.Tensor, cfg: DspConfig,
                                 tile: int):
    """(*B, tiles, 8, 128) unordered candidate blocks -> the earliest K
    detection indices (ascending, -1 past the valid ones), valid mask,
    total hit count and overflow, each with leading shape B.

    The reference ranks within tiles with onehot matmuls (a TPU gather
    workaround); the result is the same as sorting the valid entries by
    sample index and keeping the first K, which is what this does."""
    trows = tile // 128
    sent = trows * 128
    per_lane = _per_lane(tile)
    lead = cands.shape[:-3]
    tiles = cands.shape[-3]
    dev = cands.device
    ec = cands[..., :per_lane, :].reshape(*lead, tiles, per_lane * 128)
    valid_in = ec < sent
    tbase = (torch.arange(tiles, dtype=torch.int64, device=dev)
             * tile)[:, None]
    big = torch.iinfo(torch.int64).max
    key = torch.where(valid_in, ec.to(torch.int64) + tbase, big)
    key = key.reshape(*lead, tiles * per_lane * 128)
    K = cfg.max_detections
    if key.shape[-1] < K:
        key = torch.nn.functional.pad(key, (0, K - key.shape[-1]),
                                      value=big)
    first = torch.sort(key, dim=-1).values[..., :K]
    total = valid_in.reshape(*lead, -1).sum(dim=-1, dtype=torch.int32)
    kk = torch.arange(K, dtype=torch.int32, device=dev)
    valid = kk < torch.clamp(total, max=K)[..., None]
    det_idx = torch.where(valid, first, -1).to(torch.int32)
    n_det = cands[..., _COUNT_ROW, :].sum(dim=(-2, -1), dtype=torch.int32)
    overflow = n_det - valid.sum(dim=-1, dtype=torch.int32)
    return det_idx, valid, n_det, overflow


# --- kernel B2: per-detection power windows ----------------------------------

def slice_windows_plain(ri: torch.Tensor, rq: torch.Tensor,
                        base: torch.Tensor, cfg: DspConfig) -> torch.Tensor:
    """Plain PyTorch version of kernel B2 (advanced indexing)."""
    _, out_rows, pad_rows, _ = _slice_geometry(cfg)
    fi, fq = ri.reshape(-1), rq.reshape(-1)
    total = fi.shape[0]
    j = torch.arange(out_rows * 128, dtype=torch.int64, device=base.device)
    b = base.to(torch.int64)[:, None]
    idx = b + j
    inside = (b >= 0) & (idx < total)
    safe = torch.where(inside, idx, 0)
    w = torch.where(inside, power_i8(fi[safe], fq[safe]), 0.0)
    return torch.nn.functional.pad(w, (0, (pad_rows - out_rows) * 128))


def _slice_windows_cuda(ri, rq, base, cfg):
    out = torch.empty((base.shape[0], _slice_geometry(cfg)[2] * 128),
                      dtype=torch.float32, device=ri.device)
    launch_slice_windows(ri, rq, base, cfg, out)
    return out


def launch_slice_windows(ri, rq, base, cfg, out) -> None:
    """Launch B2 on contiguous CUDA inputs into the given contiguous
    (n, pad_rows*128) f32 buffer; every element of it is written."""
    from . import _ext
    _, out_rows, pad_rows, _ = _slice_geometry(cfg)
    n = base.shape[0]
    if tuple(out.shape) != (n, pad_rows * 128) or not out.is_contiguous():
        raise ValueError("B2 output of the wrong shape or not contiguous")
    lib = _ext.lib("slice_windows")
    with torch.cuda.device(ri.device):
        rc = lib.slice_windows_launch(
            ri.data_ptr(), rq.data_ptr(), base.data_ptr(), out.data_ptr(),
            n, ri.numel(), out_rows * 128, pad_rows * 128,
            _f32(1.0 / 127.0),
            torch.cuda.current_stream(ri.device).cuda_stream)
    _ext.check(rc, "slice_windows")
    LAUNCHES["slice_windows"] += 1


def slice_windows_planar(ri: torch.Tensor, rq: torch.Tensor,
                         base: torch.Tensor, cfg: DspConfig) -> torch.Tensor:
    """Kernel B2: (rows, 128) int8 planar streams + (n,) int32 window
    starts (flat sample index; < 0 = empty row) -> (n, pad_rows*128) f32
    power windows, window sample j at column j, zeros past out_rows*128."""
    if ri.dtype != torch.int8 or rq.dtype != torch.int8 \
            or ri.shape != rq.shape:
        raise TypeError("planar streams must be two int8 arrays of one shape")
    if base.dtype != torch.int32 or base.dim() != 1:
        raise TypeError("window starts must be a (n,) int32 tensor")
    if not (ri.device == rq.device == base.device):
        raise ValueError("streams and starts must be on one device")
    if ri.device.type == "cpu":
        return slice_windows_plain(ri, rq, base, cfg)
    if ri.device.type != "cuda":
        raise ValueError(f"unsupported device {ri.device}")
    return _slice_windows_cuda(ri.contiguous(), rq.contiguous(),
                               base.contiguous(), cfg)


# --- decode tail and the batch entry points ----------------------------------

def _tail_from_power(w2: torch.Tensor, det_idx, valid, n_det, overflow,
                     cfg: DspConfig):
    """K-sized decode tail on (*B, K, >=W) f32 power windows: noise floor,
    ref level, PPM bits + confidence, CRC/ECC -> DetectionTable. The
    preamble starts at window column noise_window."""
    sps = cfg.sps
    event_off = nw = cfg.noise_window
    noise_at = w2[..., :nw].mean(dim=-1)
    acc = P.chip_sums(w2, sps) if sps > 1 else w2
    ce = acc * _f32(1.0 / sps) if sps > 1 else w2
    ref_level = P.ref_chain([acc[..., event_off + c * sps]
                            for c in PREAMBLE_PULSE_CHIPS], sps)
    chip0 = event_off + 16 * sps
    energies = ce[..., chip0: chip0 + 224 * sps: sps]
    e0 = energies[..., 0::2]
    e1 = energies[..., 1::2]
    bits = e0 > e1
    level = ref_level[..., None] * _f32(cfg.confidence_level)
    confidence = (e0 > level) ^ (e1 > level)
    out_bits, df, nbits, synd, status = P.crc_check_and_correct(
        bits, confidence, cfg)
    return P.finalize_table(valid, det_idx, out_bits, df, nbits, synd,
                            status, ref_level, noise_at, n_det, overflow)


def demod_batch_planar(xi8: torch.Tensor, xq8: torch.Tensor, cfg: DspConfig,
                       tile: int = None,
                       nbuf: int = DEFAULT_NBUF) -> P.DetectionTable:
    """Planar int8 batched demod on the inputs' device: (C, P) x2 ->
    DetectionTable with leading C (B1, compaction, B2, tail)."""
    if tile is None:
        tile = default_tile(cfg)
    cands = preamble_detect_cands_planar(xi8, xq8, cfg, tile=tile, nbuf=nbuf)
    det_idx, valid, n_det, ovf = compact_candidates_unordered(cands, cfg,
                                                              tile)
    batch, p = xi8.shape
    chan0 = torch.arange(batch, dtype=torch.int32,
                         device=xi8.device)[:, None] * p
    base = torch.where(
        valid, chan0 + cfg.left_halo + det_idx - cfg.noise_window, -1)
    w2 = slice_windows_planar(xi8.reshape(-1, 128), xq8.reshape(-1, 128),
                              base.reshape(-1).to(torch.int32), cfg)
    w2 = w2.reshape(batch, cfg.max_detections, -1)
    return _tail_from_power(w2, det_idx, valid, n_det, ovf, cfg)


def demod_batch_packed_planar(xi8, xq8, cfg: DspConfig, tile: int = None,
                              nbuf: int = DEFAULT_NBUF,
                              device="cuda") -> torch.Tensor:
    """Planar path + pack_table: (C, P) int8 x2 (numpy or tensors) ->
    (C, K+1, 9) int32 on `device`. Runs on the card unless the caller asks
    for the CPU, where it takes the kernels' plain versions."""
    dev = resolve_device(device)
    xi = P._to_device(xi8, dev)
    xq = P._to_device(xq8, dev)
    return P.pack_table(demod_batch_planar(xi, xq, cfg, tile=tile,
                                           nbuf=nbuf))


# --- the f32 front: kernels B3 and B4 ----------------------------------------
#
# The counterpart of the 2D f32 half of preamble_pallas.py. B3
# (`preamble_detect_2d`) takes one framed block (L+N+R, 2) and B4
# (`preamble_detect_2d_batch`) a batch (C, L+N+R, 2) of interleaved I/Q,
# f32 or int8/int16 wire samples unit-scaled by `_to_f32`; both give the
# keep mask (int32) and the reference level (f32) of every owned sample. One
# CUDA kernel with a batch dimension (csrc/detect_mask.cu) serves both.

_HALO_R2 = 1792       # right window margin of the reference's 2D kernels


def _to_f32(iq: torch.Tensor) -> torch.Tensor:
    """int8/int16 wire samples -> f32 at unit full scale (exactly 1/127
    and 1/32767: the host quantizers report full_scale = gain/127 on that
    assumption); float input -> f32."""
    if iq.dtype == torch.uint8:
        raise TypeError(
            "uint8 (raw uc8 bytes) are offset-binary: convert on host "
            "((u - 127.5) / 127.5, io.sources raw_file_chunks) or feed "
            "int8/int16/float32")
    if iq.dtype in (torch.int8, torch.int16):
        scale = 1.0 / 127.0 if iq.dtype == torch.int8 else 1.0 / 32767.0
        return iq.to(torch.float32) * _f32(scale)
    if iq.is_complex() or not iq.is_floating_point():
        raise TypeError(f"expected (..., 2) f32/int8/int16 I/Q, got "
                        f"{iq.dtype}")
    return iq.to(torch.float32)


def supported_2d_tile(cfg: DspConfig):
    """Largest tile the f32 detect kernels support for cfg, or None: the
    gate the streaming runner reads before it picks B3/B4 over the XLA
    path (`dsp.pipeline.demod_block`)."""
    if cfg.noise_window != 128 or 14 * cfg.sps >= 128:
        return None
    for t in (16384, 8192, 4096):
        if cfg.block_size % t == 0:
            return t
    return None


def _check_2d_limits(cfg: DspConfig) -> None:
    """The reference's 2D kernels shift by up to 14*sps lanes, which its
    TPU construction supports below 128: sps <= 9."""
    if 14 * cfg.sps >= 128:
        raise ValueError(
            f"2D/planar Pallas detect supports sps <= 9 (channel_rate <= "
            f"18 Msps); got sps={cfg.sps} — use the XLA pipeline "
            "(demod_block / demod_batch) at this rate")


def _check_2d(cfg: DspConfig, tile: int) -> int:
    """The reference's asserts; returns the padded per-channel length the
    kernels see (whole 128-sample rows up to the last tile's window)."""
    _check_2d_limits(cfg)
    if cfg.noise_window != 128:
        raise ValueError("the f32 detect kernels fix noise_window=128")
    n = cfg.block_size
    if n % tile or tile % 1024:
        raise ValueError(f"tile {tile} must divide block_size {n} and be "
                         "a multiple of 1024")
    rows_w = (_LOOKBACK + tile + _HALO_R2) // 128
    return ((n // tile - 1) * (tile // 128) + rows_w) * 128


def detect_mask_plain(x: torch.Tensor, valid: int, length: int,
                      cfg: DspConfig):
    """Plain PyTorch version of kernels B3/B4: (C, L, 2) f32 I/Q of which
    the first `valid` samples count (the rest read as zeros), padded to
    `length` -> (mask int32 (C, N), ref f32 (C, N))."""
    C = x.shape[0]
    xp = torch.zeros((C, length, 2), dtype=torch.float32, device=x.device)
    k = min(valid, length, x.shape[1])
    xp[:, :k] = x[:, :k]
    keep, ref = _detect_plain(power_f32(xp[..., 0], xp[..., 1]), cfg)
    return keep.to(torch.int32), ref


def launch_detect_mask(x, valid, cfg, mask, ref) -> None:
    """Launch B3/B4 on a contiguous CUDA (C, L, 2) f32 tensor, of which
    the first `valid` samples per channel count, into the contiguous
    (C, N) int32 mask and f32 ref buffers; every element of both is
    written."""
    from . import _ext
    C, L = x.shape[0], x.shape[1]
    n = cfg.block_size
    if n % _CHUNK:
        raise ValueError("block_size must be a multiple of 4096")
    if x.dtype != torch.float32 or x.dim() != 3 or x.shape[2] != 2 \
            or not x.is_contiguous() or x.data_ptr() % 8:
        raise ValueError("B3/B4 input must be contiguous, 8-byte aligned "
                         "(C, L, 2) f32")
    for buf, dt in ((mask, torch.int32), (ref, torch.float32)):
        if tuple(buf.shape) != (C, n) or buf.dtype != dt \
                or not buf.is_contiguous():
            raise ValueError("B3/B4 outputs of the wrong shape, type or "
                             "layout")
    lib = _ext.lib("detect_mask")
    with torch.cuda.device(x.device):
        rc = lib.detect_mask_launch(
            x.data_ptr(), mask.data_ptr(), ref.data_ptr(), C, L,
            min(int(valid), L), n, n // _CHUNK, cfg.sps,
            cfg.nms_chips * cfg.sps, _detect_rhalo(cfg), _f32(cfg.threshold),
            _f32(cfg.pulse_tolerance), _f32(cfg.quiet_tolerance),
            _f32(1.0 / cfg.sps),
            torch.cuda.current_stream(x.device).cuda_stream)
    _ext.check(rc, "detect_mask")
    LAUNCHES["detect_mask"] += 1
    DETECT_MASK_ROUTES["B3" if C == 1 else "B4"] += 1


def _detect_mask(x: torch.Tensor, valid: int, length: int,
                 cfg: DspConfig):
    """B3/B4 on x's device: the kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    if x.device.type == "cpu":
        return detect_mask_plain(x, valid, length, cfg)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    C = x.shape[0]
    mask = torch.empty((C, cfg.block_size), dtype=torch.int32,
                       device=x.device)
    ref = torch.empty((C, cfg.block_size), dtype=torch.float32,
                      device=x.device)
    x = x.contiguous()
    if x.data_ptr() % 8:            # the kernel reads 8-byte I/Q pairs
        x = x.clone()
    launch_detect_mask(x, valid, cfg, mask, ref)
    return mask, ref


def b3_operands(iq: torch.Tensor, cfg: DspConfig, tile: int = 16384):
    """B3's view of one (L, 2) block of f32/int8/int16 I/Q: (x (1, L, 2)
    f32, valid, length). As the reference, it reads whole 128-sample rows:
    a trailing partial row reads as zeros, and so does everything past the
    input, up to the padded `length`."""
    length = _check_2d(cfg, tile)
    x = _to_f32(iq)
    if x.dim() != 2 or x.shape[1] != 2:
        raise ValueError(f"expected (L, 2) I/Q, got {tuple(x.shape)}")
    return x[None], (x.shape[0] // 128) * 128, length


def b4_operands(iq: torch.Tensor, cfg: DspConfig, tile: int = 16384):
    """B4's view of a (C, L, 2) batch: (x f32, valid, length), the length
    rounded to the reference's 8-row stride; past the input reads as 0."""
    length = -(-_check_2d(cfg, tile) // 1024) * 1024
    x = _to_f32(iq)
    if x.dim() != 3 or x.shape[2] != 2:
        raise ValueError(f"expected (C, L, 2) I/Q, got {tuple(x.shape)}")
    return x, min(x.shape[1], length), length


def preamble_detect_2d(iq: torch.Tensor, cfg: DspConfig,
                       tile: int = 16384):
    """Kernel B3: one (L+N+R, 2) block of f32/int8/int16 I/Q on the card
    (or the CPU) -> (mask int32 (N,), ref f32 (N,))."""
    mask, ref = _detect_mask(*b3_operands(iq, cfg, tile), cfg)
    return mask[0], ref[0]


def preamble_detect_2d_batch(iq: torch.Tensor, cfg: DspConfig,
                             tile: int = 16384):
    """Kernel B4: (C, L+N+R, 2) f32/int8/int16 I/Q -> (mask int32 (C, N),
    ref f32 (C, N))."""
    return _detect_mask(*b4_operands(iq, cfg, tile), cfg)


# --- the fast tail -----------------------------------------------------------

def gather_tail(iq: torch.Tensor, det_idx, valid, ref, n_det, overflow,
                cfg: DspConfig) -> P.DetectionTable:
    """K-sized tail: raw (*B, L', 2) block(s) + (*B, K) detections ->
    DetectionTable. Each detection's (noise_window + 242*sps)-sample
    window is gathered from the raw block (zero-padded to L+N+R first),
    its power taken as the detect kernel takes it, and the reference
    level recomputed from it; `ref` is unused, as in the reference."""
    del ref
    sps = cfg.sps
    left, nw = cfg.left_halo, cfg.noise_window
    need = left + cfg.block_size + cfg.right_halo
    if iq.shape[-2] < need:
        iq = torch.nn.functional.pad(iq, (0, 0, 0, need - iq.shape[-2]))
    W = nw + 242 * sps
    lead = det_idx.shape[:-1]
    K = det_idx.shape[-1]
    x = iq.reshape(-1, iq.shape[-2], 2)
    start = left + torch.where(valid, det_idx, 0).to(torch.int64) - nw
    j = torch.arange(W, dtype=torch.int64, device=iq.device)
    idx = (start.reshape(x.shape[0], K)[..., None] + j).reshape(
        x.shape[0], K * W)
    win = torch.gather(x, 1, idx[..., None].expand(-1, -1, 2))
    if win.dtype == torch.int8:
        w2 = power_i8(win[..., 0], win[..., 1])
    else:
        f = _to_f32(win)
        w2 = power_f32(f[..., 0], f[..., 1])
    w2 = w2.reshape(*lead, K, W)
    return _tail_from_power(w2, det_idx, valid, n_det, overflow, cfg)


def demod_block_fast(iq: torch.Tensor, cfg: DspConfig,
                     tile: int = 16384) -> P.DetectionTable:
    """One block, (L+N+R, 2) I/Q on its device: B3, compaction, gather
    tail -> DetectionTable."""
    mask, ref = preamble_detect_2d(iq, cfg, tile=tile)
    det_idx, valid, n_det, overflow = P.compact_detections(
        mask.bool(), cfg.max_detections)
    return gather_tail(iq, det_idx, valid, ref, n_det, overflow, cfg)


def demod_batch_fast(iq: torch.Tensor, cfg: DspConfig,
                     tile: int = 16384) -> P.DetectionTable:
    """A batch, (C, L+N+R, 2) I/Q on its device: B4, compaction, gather
    tail -> DetectionTable with leading C."""
    mask, ref = preamble_detect_2d_batch(iq, cfg, tile=tile)
    det_idx, valid, n_det, overflow = P.compact_detections(
        mask.bool(), cfg.max_detections)
    return gather_tail(iq, det_idx, valid, ref, n_det, overflow, cfg)


def demod_block_packed_fast(iq, cfg: DspConfig, tile: int = 16384,
                            device="cuda") -> torch.Tensor:
    """demod_block_fast + pack_table: one block (numpy or tensor) ->
    (K+1, 9) int32 on `device`. Runs on the card unless the caller asks
    for the CPU, where it takes the kernel's plain version."""
    x = P._to_device(iq, resolve_device(device))
    return P.pack_table(demod_block_fast(x, cfg, tile=tile))


def demod_batch_packed_fast(iq, cfg: DspConfig, tile: int = 16384,
                            device="cuda") -> torch.Tensor:
    """demod_batch_fast + pack_table: (C, L+N+R, 2) -> (C, K+1, 9) int32
    on `device`."""
    x = P._to_device(iq, resolve_device(device))
    return P.pack_table(demod_batch_fast(x, cfg, tile=tile))


__all__ = [
    "CAND_ROWS", "DEFAULT_NBUF", "DETECT_MASK_ROUTES", "LAUNCHES",
    "b3_operands", "b4_operands", "cand_capacity",
    "compact_candidates_unordered", "default_tile", "demod_batch_fast",
    "demod_batch_packed_fast", "demod_batch_packed_planar",
    "demod_batch_planar", "demod_block_fast", "demod_block_packed_fast",
    "detect_cands_buffers", "detect_cands_plain", "detect_mask_plain",
    "gather_tail", "launch_detect_cands", "launch_detect_mask",
    "launch_slice_windows", "planar_length", "power_i8", "preamble_detect_2d",
    "preamble_detect_2d_batch", "preamble_detect_cands_planar",
    "reset_launches", "slice_windows_planar", "slice_windows_plain",
    "supported_2d_tile", "supported_planar_tile", "to_planar_i8",
]
