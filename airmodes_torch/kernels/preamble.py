"""The demod paths with hand kernels: the planar int8 path (kernels B1, B2
and B1's variants B5o, B5p), the f32 fast path (kernels B3, B4) and the
1-D f32 path (kernel B6), with the torch code between and after them.

The counterpart of `airmodes/kernels/preamble_pallas.py`.

Planar int8 path: the host ships each channel's block as two planar int8
rows (I and Q) of `planar_length(cfg)` samples: `left_halo` samples of
history, the owned block, the right halo and a zero margin. Then, per batch
of C channels (`demod_batch_planar` and its options):

  B1 `preamble_detect_cands_planar(ordered=False)`
                                     (C, P) int8 x2 -> (C, tiles, 8, 128)
     per-lane candidate blocks (first 4 hits per tile lane column + counts)
  `compact_candidates_unordered`     -> the earliest K detections, counts
  B2 `_slice_windows`                -> one f32 power window per detection,
                                        out_rows*128 columns wide
  `_tail_from_power`                 -> bits, confidence, CRC/ECC, table

  ordered=True: B5o, the same kernel emitting each tile's earliest
     `per_tile` hits in ascending order, read by `compact_candidates`;
  prescreen=True: B5p, the kernel with a cheaper rule (no NMS, no late
     quiet chips), K2 candidate windows from B2, the full rule on them
     (`_stageb_full_check`), the earliest K winners;
  xla_gather=True: a torch gather of the windows (`gather_tail_planar`)
     in place of B2.

f32 fast path, on framed (L+N+R, 2) blocks of f32 (or int8/int16) I/Q:

  B3 `preamble_detect_2d` (one block) or B4 `preamble_detect_2d_batch`
     (C blocks)                      -> keep mask and ref per owned sample
  `dsp.pipeline.compact_detections`  -> the earliest K detections, counts
  `gather_tail`                      -> one power window per detection,
                                        then `_tail_from_power`

1-D path (`demod_block_1d`, `demod_batch_1d`), at any sps:

  B6 `preamble_detect_1d` or `preamble_detect_1d_batch`
                                     -> keep mask and ref per owned sample
  `_full_tail`                       -> full-block power and noise floor,
                                        compaction, bits, CRC/ECC, table

Each kernel wrapper launches its hand-written CUDA kernel (csrc/) when its
inputs are CUDA tensors, and runs the plain PyTorch version beside it only
when they lie on the CPU. It counts its kernel launches in `LAUNCHES`, and
names either in a profiler trace with a range "<ID> <kernel>" (B1/B5o/B5p
detect_cands, B2 slice_windows, B3/B4/B6 detect_mask).

Numerics: the plain versions and the kernels compute the reference's f32
values bit for bit, including the FMAs that XLA on the CPU contracts: power
as fma(xi, xi, xq*xq), the trailing noise sum by the log-doubling fold,
chip energies as ((m0 + m1) + ...) * (1/sps), and the reference level as
(((p0 + p1) + p2) + p3) * 0.25 with, at sps > 1, pulse 0's chip-energy
scale contracted into the first add in the 2-D detect kernels B1, B3, B4
and B5 (`_ref_detect`) and every scale but pulse 1's in the 1-D kernel
B6, the stage-B rescan and the decode tail (`dsp.pipeline.ref_chain`).
The reference may take the noise sum as two matmuls instead
(`mxu_window_sum`, "decision-equivalent", airmodes/config.py); the port
always folds.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import DspConfig
from ..constants import PREAMBLE_PULSE_CHIPS, PREAMBLE_QUIET_CHIPS
from ..dsp import pipeline as P
from ..dsp.pipeline import _f32, fma_f32, power_f32, resolve_device
from ..utils.graphs import graphed
from ..utils.profiling import kernel_range

_LOOKBACK = 256                            # noise window + peak/NMS lookback
_LOOKBACK_ROWS = _LOOKBACK // 128          # 2
_HALO_ROWS_I8 = 30                         # rows_w = trows + 32
CAND_PER_LANE = 4
CAND_ROWS = 8
_COUNT_ROW = 4                             # per-lane hit counts live here
DEFAULT_NBUF = 2
_CHUNK = 4096                              # owned samples per detect CUDA block
_EARLY_QUIET_CHIPS = (1, 3, 4, 5, 6)       # the quiet chips B5p tests

# kernel launches since the last reset_launches(), per wrapper; only the
# CUDA paths count ("raw_planar": kernel R1 of resample.fused)
LAUNCHES = {"detect_cands": 0, "slice_windows": 0, "detect_mask": 0,
            "raw_planar": 0}
# detect_cands launches by variant: B1 (unordered), B5o (ordered=True) and
# B5p (prescreen=True)
DETECT_CANDS_ROUTES = {"B1": 0, "B5o": 0, "B5p": 0}
# detect_mask launches by route: B3 (one block), B4 (a batch of C > 1), and
# the 1-D kernel B6 on one block ("B6") or a batch ("B6 batch")
DETECT_MASK_ROUTES = {"B3": 0, "B4": 0, "B6": 0, "B6 batch": 0}
# what a graphed step's replays add to (utils.graphs)
LAUNCH_COUNTERS = (LAUNCHES, DETECT_CANDS_ROUTES, DETECT_MASK_ROUTES)


def reset_launches() -> None:
    for d in (LAUNCHES, DETECT_CANDS_ROUTES, DETECT_MASK_ROUTES):
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


def _cand_params(tile: int, ordered: bool, per_tile=None, per_lane=None):
    """(per_tile, per_lane) of a candidate layout: cand_capacity's values
    where not given, per_lane clamped to the 4 hit rows of the unordered
    layout, as the reference does, and to the tile's rows on the ordered
    one (a lane column has no more hits). The ordered rows 0..3 hold at
    most 512 hits; above that, or below 1 of either, it raises."""
    pt, pl = cand_capacity(tile)
    per_tile = pt if per_tile is None else int(per_tile)
    per_lane = pl if per_lane is None else int(per_lane)
    if per_lane < 1:
        raise ValueError(f"per_lane must be >= 1, got {per_lane}")
    per_lane = min(per_lane, _COUNT_ROW if not ordered else tile // 128)
    if ordered and not 1 <= per_tile <= _COUNT_ROW * 128:
        raise ValueError(f"per_tile must be in [1, {_COUNT_ROW * 128}] "
                         f"(rows 0..3 of the ordered layout); got {per_tile}")
    return per_tile, per_lane


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


# --- the preamble rule, shared by kernels B1, B3, B4, B5 and B6 -------------

def _ref_detect(acc0, p0, p1, p2, p3, sps: int):
    """Reference level of the 2-D detect kernels, as the reference computes
    it on the CPU: (((p0 + p1) + p2) + p3) * 0.25, where at sps > 1 XLA
    contracts the chip-energy scale of pulse 0 (acc0 * 1/sps) into the
    first add; pulses 1-3 arrive through the kernel's lane shifts and are
    not contracted."""
    if sps > 1:
        s = _f32(1.0 / sps)
        first = fma_f32(acc0, s, p1)
    else:
        first = p0 + p1
    return ((first + p2) + p3) * 0.25


def _prescreen_threshold(cfg: DspConfig) -> float:
    """B5p's threshold: f32(threshold) * f32(1 - 1e-5), one f32 product as
    the reference rounds it."""
    return _f32(np.float32(cfg.threshold) * np.float32(1.0 - 1e-5))


def _rule_ok(m: torch.Tensor, cfg: DspConfig, x0: int, nt: int,
             thresh: float, quiet_chips, chain: bool = False):
    """The preamble test without NMS on (..., L) f32 power rows at the nt
    test positions from column x0 (a test at column x reads the noise sum
    of m[x-128:x]) -> (ok bool, ref f32), each (..., nt): the peak test,
    the all-pulse threshold and tolerance, the quiet chips given. `chain`
    picks the reference level's form: `ref_chain` (1-D kernel, stage B),
    else `_ref_detect` (the 2-D kernels)."""
    sps = cfg.sps
    ws = m
    for s in (1, 2, 4, 8, 16, 32, 64):                  # ws[y] = sum m[y:y+128]
        ws = ws[..., :-s] + ws[..., s:]
    acc = P.chip_sums(m, sps) if sps > 1 else m
    ce = acc * _f32(1.0 / sps) if sps > 1 else m

    def at(arr, off):
        return arr[..., x0 + off: x0 + off + nt]

    p0, p1, p2, p3 = (at(ce, c * sps) for c in PREAMBLE_PULSE_CHIPS)
    if chain:
        ref = P.ref_chain([at(acc, c * sps) for c in PREAMBLE_PULSE_CHIPS],
                          sps)
    else:
        ref = _ref_detect(at(acc, 0), p0, p1, p2, p3, sps)
    nf = at(ws, -128) * (1.0 / 128.0)
    ok = (p0 >= at(ce, -1)) & (p0 > at(ce, 1))
    pmin = torch.minimum(torch.minimum(p0, p1), torch.minimum(p2, p3))
    ok &= pmin > torch.maximum(nf * thresh, ref * _f32(cfg.pulse_tolerance))
    quiet = at(ce, quiet_chips[0] * sps)
    for q in quiet_chips[1:]:
        quiet = torch.maximum(quiet, at(ce, q * sps))
    ok &= quiet < ref * _f32(cfg.quiet_tolerance)
    return ok, ref


def _detect_plain(m: torch.Tensor, cfg: DspConfig, chain: bool = False):
    """The detect kernels' rule on (C, >= 256 + N + halo) f32 power rows,
    owned sample d at column d + 256 -> (keep bool (C, N), ref f32 (C, N))
    over the owned samples. The decision does not depend on the tile."""
    half = cfg.nms_chips * cfg.sps
    n = cfg.block_size
    ok, ref = _rule_ok(m, cfg, _LOOKBACK - half, n + 2 * half,
                       _f32(cfg.threshold), PREAMBLE_QUIET_CHIPS, chain)
    score = torch.where(ok, ref, 0.0)
    own = score[:, half: half + n]
    left = torch.zeros_like(own)
    right = torch.zeros_like(own)
    for o in range(1, half + 1):
        left = torch.maximum(left, score[:, half - o: half - o + n])
        right = torch.maximum(right, score[:, half + o: half + o + n])
    keep = ok[:, half: half + n] & (own > left) & (own >= right)
    return keep, ref[:, half: half + n]


def _prescreen_plain(m: torch.Tensor, cfg: DspConfig) -> torch.Tensor:
    """B5p's stage-A rule on (C, >= 256 + N + halo) f32 power rows -> keep
    bool (C, N) over the owned samples: the peak test, the all-pulse
    threshold (with the reference's 1e-5 slack) and tolerance, the early
    quiet chips {1, 3..6}; no NMS. It accepts every sample the full rule
    keeps, and more."""
    ok, _ = _rule_ok(m, cfg, _LOOKBACK, cfg.block_size,
                     _prescreen_threshold(cfg), _EARLY_QUIET_CHIPS)
    return ok


# --- kernel B1 and its variants B5o, B5p: detect + candidate extraction -----


def _perlane_plain(keep: torch.Tensor, tile: int, per_lane: int):
    """(C, N) bool -> (first hits (C, tiles, per_lane, 128) int32, counts
    (C, tiles, 128) int32): each lane column's first per_lane hits of a
    tile, encoded r*128 + lane in ascending order (sentinel trows*128), and
    its hit count."""
    C, n = keep.shape
    trows = tile // 128
    k = keep.reshape(C, n // tile, trows, 128)
    dev = keep.device
    rowidx = torch.arange(trows, dtype=torch.int32, device=dev)[:, None]
    cand = torch.where(k, rowidx, trows)
    lane = torch.arange(128, dtype=torch.int32, device=dev)
    rows = []
    for _ in range(per_lane):
        cj = cand.min(dim=2).values                     # (C, tiles, 128)
        rows.append(torch.where(cj < trows, cj * 128 + lane, trows * 128))
        cand = torch.where(cand == cj[:, :, None, :], trows, cand)
    return torch.stack(rows, dim=2), k.sum(dim=2, dtype=torch.int32)


def _cand_block(first: torch.Tensor, count: torch.Tensor,
                tile: int) -> torch.Tensor:
    """(C, tiles, 8, 128) candidate blocks: `first` (C, tiles, n) in the
    flat positions of rows 0..3, the sentinel trows*128 past it, the
    counts in row 4, zeros in rows 5..7."""
    C, tiles = count.shape[:2]
    out = torch.zeros((C, tiles, CAND_ROWS * 128), dtype=torch.int32,
                      device=count.device)
    out[..., :_COUNT_ROW * 128] = (tile // 128) * 128
    out[..., :first.shape[-1]] = first
    out[..., _COUNT_ROW * 128: (_COUNT_ROW + 1) * 128] = count
    return out.reshape(C, tiles, CAND_ROWS, 128)


def _extract_plain(keep: torch.Tensor, tile: int,
                   per_lane: int) -> torch.Tensor:
    """(C, N) bool -> (C, tiles, 8, 128) int32 unordered candidate blocks:
    rows 0..per_lane-1 the first hits of each lane column (r*128 + lane,
    ascending, sentinel trows*128), row 4 the per-lane counts."""
    e, count = _perlane_plain(keep, tile, per_lane)
    return _cand_block(e.flatten(2), count, tile)


def _extract_ordered_plain(keep: torch.Tensor, tile: int, per_tile: int,
                           per_lane: int) -> torch.Tensor:
    """(C, N) bool -> (C, tiles, 8, 128) int32 ordered candidate blocks
    (`_extract_cands`): of each lane column's first per_lane hits, the
    tile's earliest per_tile in ascending order at flat positions 0.. of
    rows 0..3, the sentinel past them, row 4 the per-lane counts."""
    e, count = _perlane_plain(keep, tile, per_lane)
    first = torch.sort(e.flatten(2), dim=-1).values[..., :per_tile]
    return _cand_block(first, count, tile)


def detect_cands_plain(xi8: torch.Tensor, xq8: torch.Tensor, cfg: DspConfig,
                       tile: int, ordered: bool = True,
                       prescreen: bool = False, per_tile: int = None,
                       per_lane: int = None) -> torch.Tensor:
    """Plain PyTorch version of kernels B1, B5o (ordered) and B5p
    (prescreen), which may combine as in the reference: same inputs, same
    output."""
    per_tile, per_lane = _cand_params(tile, ordered, per_tile, per_lane)
    m = power_i8(xi8, xq8)
    keep = _prescreen_plain(m, cfg) if prescreen else _detect_plain(m, cfg)[0]
    if ordered:
        return _extract_ordered_plain(keep, tile, per_tile, per_lane)
    return _extract_plain(keep, tile, per_lane)


def _detect_rhalo(cfg: DspConfig, prescreen: bool = False) -> int:
    """Samples the detect kernels' CUDA blocks (B1, B3/B4, B5, B6) stage
    after their chunk: the 16 chips of the preamble test and, but for B5p,
    which has no NMS, the NMS window, rounded up to 32."""
    need = (0 if prescreen else cfg.nms_chips * cfg.sps) + 16 * cfg.sps
    return -(-need // 32) * 32


def detect_cands_buffers(C: int, cfg: DspConfig, tile: int):
    """Shapes of the B1/B5 CUDA launch's buffers: (per-chunk scratch: one
    keep word per lane column, bit r for the chunk's row r; output)."""
    tiles = cfg.block_size // tile
    return ((C * tiles * (tile // _CHUNK), 128),
            (C, tiles, CAND_ROWS, 128))


def _aligned16(x: torch.Tensor) -> torch.Tensor:
    """x, or a copy of it where its data is not 16-byte aligned (the
    kernels load 16 bytes at a time)."""
    return x.clone() if x.data_ptr() % 16 else x


def _detect_cands_cuda(xi8, xq8, cfg, tile, ordered, prescreen, per_tile,
                       per_lane):
    s_shape, o_shape = detect_cands_buffers(xi8.shape[0], cfg, tile)
    scratch = torch.empty(s_shape, dtype=torch.int32, device=xi8.device)
    out = torch.empty(o_shape, dtype=torch.int32, device=xi8.device)
    launch_detect_cands(xi8, xq8, cfg, tile, scratch, out, ordered=ordered,
                        prescreen=prescreen, per_tile=per_tile,
                        per_lane=per_lane)
    return out


def launch_detect_cands(xi8, xq8, cfg, tile, scratch, out,
                        ordered: bool = True, prescreen: bool = False,
                        per_tile: int = None, per_lane: int = None) -> None:
    """Launch B1 (or B5o with ordered, B5p with prescreen) on contiguous
    CUDA inputs into the given contiguous int32 buffers (shapes from
    `detect_cands_buffers`); every element of both is written. The planar
    rows must be 16-byte aligned."""
    from . import _ext
    per_tile, per_lane = _cand_params(tile, ordered, per_tile, per_lane)
    C, p = xi8.shape
    tiles = cfg.block_size // tile
    nchunk = tile // _CHUNK
    half = cfg.nms_chips * cfg.sps
    rhalo = _detect_rhalo(cfg, prescreen)
    # the last chunk stages up to planar sample block_size + 256 + rhalo
    if cfg.block_size + _LOOKBACK + rhalo > p:
        raise ValueError("planar rows too short for the detect kernel")
    if (tuple(scratch.shape), tuple(out.shape)) != \
            detect_cands_buffers(C, cfg, tile) \
            or not (scratch.is_contiguous() and out.is_contiguous()):
        raise ValueError("B1 buffers of the wrong shape or not contiguous")
    thresh = _prescreen_threshold(cfg) if prescreen else _f32(cfg.threshold)
    lib = _ext.lib("detect_cands")
    route = _cands_route(ordered, prescreen)
    with torch.cuda.device(xi8.device), \
            kernel_range(f"{route} detect_cands"):
        rc = lib.detect_cands_launch(
            xi8.data_ptr(), xq8.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), C, p, tile, tiles, nchunk, per_lane, per_tile,
            int(ordered), int(prescreen), cfg.sps, half, rhalo,
            _f32(1.0 / 127.0), thresh, _f32(cfg.pulse_tolerance),
            _f32(cfg.quiet_tolerance), _f32(1.0 / cfg.sps),
            torch.cuda.current_stream(xi8.device).cuda_stream)
    _ext.check(rc, "detect_cands")
    LAUNCHES["detect_cands"] += 1
    DETECT_CANDS_ROUTES[route] += 1


def _cands_route(ordered: bool, prescreen: bool) -> str:
    """The kernel table's ID of a detect_cands call: B1 (unordered), B5o
    (ordered) or B5p (prescreen)."""
    return "B5p" if prescreen else "B5o" if ordered else "B1"


def preamble_detect_cands_planar(xi8: torch.Tensor, xq8: torch.Tensor,
                                 cfg: DspConfig, tile: int = None,
                                 nbuf: int = DEFAULT_NBUF, *,
                                 double_buffer: bool = False,
                                 per_tile: int = None, per_lane: int = None,
                                 ordered: bool = True,
                                 prescreen: bool = False) -> torch.Tensor:
    """Kernel B1: (C, P) int8 planar I/Q (P = planar_length(cfg, tile)) ->
    (C, tiles, 8, 128) int32 candidate blocks.

    ordered=True (B5o, the default, as the reference's): the tile's
    earliest per_tile (<= 512) hits, ascending, in rows 0..3, taken from
    each lane column's first per_lane (any number). ordered=False (B1, the
    production layout the demod paths ask for): each lane column's first
    per_lane (<= 4) hits in rows 0..per_lane-1. prescreen=True (B5p): the
    stage-A rule (`_prescreen_plain`) in place of the full rule. Row 4
    holds the per-lane hit counts. `nbuf` and `double_buffer` are the
    reference's TPU prefetch depth; they change nothing in the result, and
    the CUDA kernel has one form for every value."""
    if tile is None:
        tile = default_tile(cfg)
    _check_limits(cfg)
    if nbuf < 1:
        raise ValueError(f"nbuf must be >= 1, got {nbuf}")
    if cfg.block_size % tile:
        raise ValueError(f"tile {tile} does not divide the block")
    per_tile, per_lane = _cand_params(tile, ordered, per_tile, per_lane)
    p = planar_length(cfg, tile)
    if xi8.dim() != 2 or xi8.shape != xq8.shape or xi8.shape[1] != p:
        raise ValueError(f"expected two (C, {p}) planar arrays, got "
                         f"{tuple(xi8.shape)} and {tuple(xq8.shape)}")
    if xi8.dtype != torch.int8 or xq8.dtype != torch.int8:
        raise TypeError("planar arrays must be int8")
    if xi8.device != xq8.device:
        raise ValueError("I and Q must be on one device")
    if xi8.device.type == "cpu":
        with kernel_range(f"{_cands_route(ordered, prescreen)} "
                          f"detect_cands"):
            return detect_cands_plain(xi8, xq8, cfg, tile, ordered,
                                      prescreen, per_tile, per_lane)
    if xi8.device.type != "cuda":
        raise ValueError(f"unsupported device {xi8.device}")
    xi8, xq8 = (_aligned16(a.contiguous()) for a in (xi8, xq8))
    return _detect_cands_cuda(xi8, xq8, cfg, tile, ordered, prescreen,
                              per_tile, per_lane)


def compact_candidates(cands: torch.Tensor, cfg: DspConfig, tile: int,
                       per_tile: int = None):
    """(*B, tiles, 8, 128) ORDERED candidate blocks -> the first K valid
    entries in flat (tile, position) order as detection indices (-1 past
    the valid ones), valid mask, total hit count and overflow, each with
    leading shape B.

    Each tile's list is ascending and tiles ascend, so these are ascending
    too. They are not the earliest K of all hits: a tile that spilled past
    per_tile lost hits that may be earlier than a later tile's kept ones,
    as in the reference. The reference selects by rank-onehot matmuls (a
    TPU scatter workaround); a sort of the valid entries' flat positions
    selects the same."""
    trows = tile // 128
    sent = trows * 128
    if per_tile is None:
        per_tile = cand_capacity(tile)[0]
    rows_o = -(-per_tile // 128)
    lead = cands.shape[:-3]
    tiles = cands.shape[-3]
    dev = cands.device
    ec = cands[..., :rows_o, :].reshape(*lead, tiles, rows_o * 128)
    ec = ec[..., :per_tile]
    valid_in = (ec < sent).reshape(*lead, tiles * per_tile)
    tbase = (torch.arange(tiles, dtype=torch.int32, device=dev)
             * tile)[:, None]
    vals = (ec + tbase).reshape(*lead, tiles * per_tile)
    big = tiles * per_tile
    pos = torch.arange(big, dtype=torch.int64, device=dev)
    key = torch.where(valid_in, pos, big)
    K = cfg.max_detections
    if big < K:
        key = torch.nn.functional.pad(key, (0, K - big), value=big)
    first = torch.sort(key, dim=-1).values[..., :K]
    det = torch.gather(vals, -1, first.clamp(max=big - 1))
    total = valid_in.sum(dim=-1, dtype=torch.int32)
    kk = torch.arange(K, dtype=torch.int32, device=dev)
    valid = kk < torch.clamp(total, max=K)[..., None]
    det_idx = torch.where(valid, det, -1).to(torch.int32)
    n_det = cands[..., _COUNT_ROW, :].sum(dim=(-2, -1), dtype=torch.int32)
    overflow = n_det - valid.sum(dim=-1, dtype=torch.int32)
    return det_idx, valid, n_det, overflow


def compact_candidates_unordered(cands: torch.Tensor, cfg: DspConfig,
                                 tile: int, per_lane: int = None):
    """(*B, tiles, 8, 128) unordered candidate blocks -> the earliest K
    detection indices (ascending, -1 past the valid ones), valid mask,
    total hit count and overflow, each with leading shape B.

    The reference ranks within tiles with onehot matmuls (a TPU gather
    workaround); the result is the same as sorting the valid entries by
    sample index and keeping the first K, which is what this does."""
    trows = tile // 128
    sent = trows * 128
    if per_lane is None:
        per_lane = _cand_params(tile, False)[1]
    if not 1 <= per_lane <= _COUNT_ROW:
        raise ValueError(f"the unordered layout holds 1..{_COUNT_ROW} hits "
                         f"per lane, got per_lane={per_lane}")
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

def _slice_cols(cfg: DspConfig, extra: int = 0, main: bool = True) -> int:
    """Columns of B2's output: out_rows*128 on the demod paths (`main`),
    which read none past W; pad_rows*128 (rounded up to the TPU's 8-row
    tile) in the reference's shape, which `slice_windows_planar` keeps."""
    _, out_rows, pad_rows, _ = _slice_geometry(cfg, extra)
    return (out_rows if main else pad_rows) * 128


def slice_windows_plain(ri: torch.Tensor, rq: torch.Tensor,
                        base: torch.Tensor, cfg: DspConfig, extra: int = 0,
                        cols: int = None) -> torch.Tensor:
    """Plain PyTorch version of kernel B2 (advanced indexing), `cols`
    output columns (default the reference's, `_slice_cols(main=False)`)."""
    out_len = _slice_cols(cfg, extra)
    if cols is None:
        cols = _slice_cols(cfg, extra, main=False)
    fi, fq = ri.reshape(-1), rq.reshape(-1)
    total = fi.shape[0]
    j = torch.arange(out_len, dtype=torch.int64, device=base.device)
    b = base.to(torch.int64)[:, None]
    idx = b + j
    inside = (b >= 0) & (idx < total)
    safe = torch.where(inside, idx, 0)
    w = torch.where(inside, power_i8(fi[safe], fq[safe]), 0.0)
    return torch.nn.functional.pad(w, (0, cols - out_len))


def launch_slice_windows(ri, rq, base, cfg, out, extra: int = 0) -> None:
    """Launch B2 on contiguous CUDA inputs (streams 16-byte aligned) into
    the given contiguous, 16-byte aligned (n, cols) f32 buffer, cols a
    multiple of 128 of at least out_rows*128; every element of it is
    written."""
    from . import _ext
    out_len = _slice_cols(cfg, extra)
    n = base.shape[0]
    if out.dim() != 2 or out.shape[0] != n or out.shape[1] % 128 \
            or out.shape[1] < out_len or not out.is_contiguous():
        raise ValueError("B2 output of the wrong shape or not contiguous")
    if (ri.data_ptr() | rq.data_ptr() | out.data_ptr()) % 16:
        raise ValueError("B2 streams and output must be 16-byte aligned")
    lib = _ext.lib("slice_windows")
    with torch.cuda.device(ri.device), kernel_range("B2 slice_windows"):
        rc = lib.slice_windows_launch(
            ri.data_ptr(), rq.data_ptr(), base.data_ptr(), out.data_ptr(),
            n, ri.numel(), out_len, out.shape[1], _f32(1.0 / 127.0),
            torch.cuda.current_stream(ri.device).cuda_stream)
    _ext.check(rc, "slice_windows")
    LAUNCHES["slice_windows"] += 1


def _slice_windows(ri: torch.Tensor, rq: torch.Tensor, base: torch.Tensor,
                   cfg: DspConfig, extra: int, cols: int) -> torch.Tensor:
    """B2 into `cols` columns (`_slice_cols`) on the inputs' device: the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if ri.dtype != torch.int8 or rq.dtype != torch.int8 \
            or ri.shape != rq.shape:
        raise TypeError("planar streams must be two int8 arrays of one shape")
    if base.dtype != torch.int32 or base.dim() != 1:
        raise TypeError("window starts must be a (n,) int32 tensor")
    if not (ri.device == rq.device == base.device):
        raise ValueError("streams and starts must be on one device")
    if ri.device.type == "cpu":
        with kernel_range("B2 slice_windows"):
            return slice_windows_plain(ri, rq, base, cfg, extra, cols)
    if ri.device.type != "cuda":
        raise ValueError(f"unsupported device {ri.device}")
    out = torch.empty((base.shape[0], cols), dtype=torch.float32,
                      device=ri.device)
    ri, rq = (_aligned16(a.contiguous()) for a in (ri, rq))
    launch_slice_windows(ri, rq, base.contiguous(), cfg, out, extra=extra)
    return out


def slice_windows_planar(ri: torch.Tensor, rq: torch.Tensor,
                         base: torch.Tensor, cfg: DspConfig,
                         extra: int = 0) -> torch.Tensor:
    """Kernel B2: (rows, 128) int8 planar streams + (n,) int32 window
    starts (flat sample index; < 0 = empty row) -> (n, pad_rows*128) f32
    power windows, window sample j at column j, zeros past out_rows*128,
    the reference's shape. `extra` widens the window by 2*extra samples
    (the prescreen path's stage-B windows). The demod paths ask for the
    first out_rows*128 columns only (`_slice_windows`)."""
    return _slice_windows(ri, rq, base, cfg, extra,
                          _slice_cols(cfg, extra, main=False))


# --- decode tail and the batch entry points ----------------------------------

def _tail_from_power(w2: torch.Tensor, det_idx, valid, n_det, overflow,
                     cfg: DspConfig, event_off: int = None):
    """K-sized decode tail on (*B, K, >=W) f32 power windows: noise floor,
    ref level, PPM bits + confidence, CRC/ECC -> DetectionTable. The
    preamble starts at window column `event_off` (default noise_window;
    the prescreen path's windows carry its NMS half-window before it)."""
    sps = cfg.sps
    nw = cfg.noise_window
    if event_off is None:
        event_off = nw
    noise_at = w2[..., event_off - nw: event_off].mean(dim=-1)
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


def gather_tail_planar(xi8: torch.Tensor, xq8: torch.Tensor, det_idx, valid,
                       n_det, overflow, cfg: DspConfig) -> P.DetectionTable:
    """The `xla_gather=True` tail: each detection's (noise_window +
    242*sps)-sample window gathered from its (C, P) planar int8 rows by
    torch indexing in place of kernel B2, its power taken as B2 takes it,
    then `_tail_from_power`. As the reference's dynamic slice, a start is
    clamped into its row (the planar margin keeps every real one inside)."""
    sps = cfg.sps
    nw = cfg.noise_window
    W = nw + 242 * sps
    C, p = xi8.shape
    K = det_idx.shape[-1]
    start = cfg.left_halo + torch.where(valid, det_idx, 0).to(torch.int64) \
        - nw
    start = start.clamp(0, p - W)
    j = torch.arange(W, dtype=torch.int64, device=xi8.device)
    idx = (start[..., None] + j).reshape(C, K * W)
    wi = torch.gather(xi8, 1, idx).reshape(C, K, W)
    wq = torch.gather(xq8, 1, idx).reshape(C, K, W)
    return _tail_from_power(power_i8(wi, wq), det_idx, valid, n_det,
                            overflow, cfg)


def _stageb_full_check(w2: torch.Tensor, cfg: DspConfig) -> torch.Tensor:
    """Stage B of the prescreen path: the FULL rule at a candidate and at
    its NMS neighbours within +-half, from its own (*B, K2, >= nw + 242*sps
    + 2*half) power window (candidate's preamble at column nw + half), then
    the NMS rule (strictly above every earlier qualifying neighbour, at
    least every later one) -> the surviving candidates, bool (*B, K2)."""
    nw = cfg.noise_window
    if nw != 128:
        raise ValueError("stage B fixes noise_window=128")
    half = cfg.nms_chips * cfg.sps
    ok, ref = _rule_ok(w2, cfg, nw, 2 * half + 1, _f32(cfg.threshold),
                       PREAMBLE_QUIET_CHIPS, chain=True)
    score = torch.where(ok, ref, 0.0)
    center = score[..., half]
    left_max = score[..., :half].amax(dim=-1)
    right_max = score[..., half + 1:].amax(dim=-1)
    return ok[..., half] & (center > left_max) & (center >= right_max)


def _window_bases(valid, det_idx, p: int, off: int) -> torch.Tensor:
    """(C*K,) int32 flat window starts into the (C*P,) planar streams,
    channel c's detection d at c*P + d + off; -1 for empty table rows."""
    chan0 = torch.arange(det_idx.shape[0], dtype=torch.int32,
                         device=det_idx.device)[:, None] * p
    return torch.where(valid, chan0 + det_idx + off,
                       -1).reshape(-1).to(torch.int32)


def _demod_batch_planar_prescreen(xi8, xq8, cfg: DspConfig, tile: int,
                                  nbuf: int, per_lane: int,
                                  k2: int = None) -> P.DetectionTable:
    """Two-stage planar demod: B5p -> K2 candidate windows (B2, widened by
    the NMS half-window) -> `_stageb_full_check` -> the earliest K winners
    -> the decode tail. n_detected counts the stage-B winners, n_overflow
    the stage-A spills plus the winners past K, as the reference counts
    them."""
    K = cfg.max_detections
    K2 = k2 if k2 is not None else 2 * K
    if K2 < K:
        raise ValueError(f"k2 ({K2}) must be >= max_detections ({K})")
    cfg2 = dataclasses.replace(cfg, max_detections=K2)
    half = cfg.nms_chips * cfg.sps
    nw = cfg.noise_window
    cands = preamble_detect_cands_planar(xi8, xq8, cfg, tile=tile, nbuf=nbuf,
                                         per_lane=per_lane, ordered=False,
                                         prescreen=True)
    det2, valid2, _, ovf2 = compact_candidates_unordered(cands, cfg2, tile,
                                                         per_lane=per_lane)
    batch, p = xi8.shape
    base = _window_bases(valid2, det2, p, cfg.left_halo - nw - half)
    w2 = _slice_windows(xi8.reshape(-1, 128), xq8.reshape(-1, 128), base,
                        cfg, half, _slice_cols(cfg, half))
    w2 = w2.reshape(batch, K2, -1)
    win = _stageb_full_check(w2, cfg) & valid2
    # the earliest K winners: the reference's top_k and onehot matmuls are
    # a TPU gather workaround; a sort and an index gather select the same
    big = torch.iinfo(torch.int64).max
    vals, sel = torch.sort(torch.where(win, det2.to(torch.int64), big),
                           dim=-1)
    vals, sel = vals[..., :K], sel[..., :K]
    kvalid = vals < big
    idx_sel = torch.where(kvalid, vals, 0).to(torch.int32)
    wsel = torch.gather(w2, 1, sel[..., None].expand(-1, -1, w2.shape[-1]))
    wsel = torch.where(kvalid[..., None], wsel, 0.0)
    n_win = win.sum(dim=-1, dtype=torch.int32)
    overflow = ovf2 + torch.clamp(n_win - K, min=0)
    return _tail_from_power(wsel, idx_sel, kvalid, n_win, overflow, cfg,
                            event_off=nw + half)


def demod_batch_planar(xi8: torch.Tensor, xq8: torch.Tensor, cfg: DspConfig,
                       tile: int = None, nbuf: int = DEFAULT_NBUF, *,
                       double_buffer: bool = False, per_tile: int = None,
                       per_lane: int = None, ordered: bool = False,
                       xla_gather: bool = False, prescreen: bool = False,
                       k2: int = None) -> P.DetectionTable:
    """Planar int8 batched demod on the inputs' device: (C, P) x2 ->
    DetectionTable with leading C.

    The default is the production path: B1, `compact_candidates_unordered`,
    B2, the tail. The reference's options select as it does: ordered=True
    takes B5o and `compact_candidates`; xla_gather=True gathers the windows
    with torch indexing in place of B2; prescreen=True runs the two-stage
    path (`_demod_batch_planar_prescreen`: B5p, K2 = k2 or 2K candidates,
    stage B). per_lane is clamped to 4 on the unordered and prescreen
    layouts; nbuf and double_buffer change nothing in the result."""
    if tile is None:
        tile = default_tile(cfg)
    pt, pl = cand_capacity(tile)
    per_tile = pt if per_tile is None else per_tile
    per_lane = pl if per_lane is None else per_lane
    if not ordered or prescreen:
        per_lane = min(per_lane, _COUNT_ROW)
    if prescreen:
        return _demod_batch_planar_prescreen(xi8, xq8, cfg, tile, nbuf,
                                             per_lane, k2)
    cands = preamble_detect_cands_planar(
        xi8, xq8, cfg, tile=tile, nbuf=nbuf, double_buffer=double_buffer,
        per_tile=per_tile, per_lane=per_lane, ordered=ordered)
    if ordered:
        det_idx, valid, n_det, ovf = compact_candidates(cands, cfg, tile,
                                                        per_tile=per_tile)
    else:
        det_idx, valid, n_det, ovf = compact_candidates_unordered(
            cands, cfg, tile, per_lane=per_lane)
    if xla_gather:
        return gather_tail_planar(xi8, xq8, det_idx, valid, n_det, ovf, cfg)
    batch, p = xi8.shape
    base = _window_bases(valid, det_idx, p,
                         cfg.left_halo - cfg.noise_window)
    w2 = _slice_windows(xi8.reshape(-1, 128), xq8.reshape(-1, 128), base,
                        cfg, 0, _slice_cols(cfg))
    w2 = w2.reshape(batch, cfg.max_detections, -1)
    return _tail_from_power(w2, det_idx, valid, n_det, ovf, cfg)


def demod_batch_packed_planar(xi8, xq8, cfg: DspConfig, tile: int = None,
                              nbuf: int = DEFAULT_NBUF, device="cuda", *,
                              double_buffer: bool = False,
                              per_tile: int = None, per_lane: int = None,
                              ordered: bool = False, xla_gather: bool = False,
                              prescreen: bool = False,
                              k2: int = None) -> torch.Tensor:
    """Planar path + pack_table: (C, P) int8 x2 (numpy or tensors) ->
    (C, K+1, 9) int32 on `device`, with demod_batch_planar's options. Runs
    on the card unless the caller asks for the CPU, where it takes the
    kernels' plain versions."""
    dev = resolve_device(device)
    xi = P._to_device(xi8, dev)
    xq = P._to_device(xq8, dev)
    return P.pack_table(demod_batch_planar(
        xi, xq, cfg, tile=tile, nbuf=nbuf, double_buffer=double_buffer,
        per_tile=per_tile, per_lane=per_lane, ordered=ordered,
        xla_gather=xla_gather, prescreen=prescreen, k2=k2))


@graphed(static_argnames=("cfg", "tile", "double_buffer", "nbuf",
                         "per_tile", "per_lane", "ordered", "xla_gather",
                         "prescreen", "k2"), counters=LAUNCH_COUNTERS)
def demod_batch_packed_planar_jit(xi8, xq8, cfg: DspConfig, tile: int = None,
                                  double_buffer: bool = False,
                                  nbuf: int = DEFAULT_NBUF,
                                  per_tile: int = None, per_lane: int = None,
                                  ordered: bool = False,
                                  xla_gather: bool = False,
                                  prescreen: bool = False, k2: int = None,
                                  device="cuda") -> torch.Tensor:
    """`demod_batch_packed_planar` as one captured graph per key on a card
    (`utils.graphs`), the reference's compiled int8 step: (C, P) int8 x2
    -> (C, K+1, 9) int32, the options static."""
    return demod_batch_packed_planar(
        xi8, xq8, cfg, tile=tile, nbuf=nbuf, device=device,
        double_buffer=double_buffer, per_tile=per_tile, per_lane=per_lane,
        ordered=ordered, xla_gather=xla_gather, prescreen=prescreen, k2=k2)


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
                      cfg: DspConfig, one_d: bool = False):
    """Plain PyTorch version of kernels B3/B4 (and B6 with one_d): (C, L, 2)
    f32 I/Q of which the first `valid` samples count (the rest read as
    zeros), padded to `length` -> (mask int32 (C, N), ref f32 (C, N)).
    one_d takes B6's form of the reference level (`ref_chain`)."""
    C = x.shape[0]
    xp = torch.zeros((C, length, 2), dtype=torch.float32, device=x.device)
    k = min(valid, length, x.shape[1])
    xp[:, :k] = x[:, :k]
    keep, ref = _detect_plain(power_f32(xp[..., 0], xp[..., 1]), cfg,
                              chain=one_d)
    return keep.to(torch.int32), ref


def launch_detect_mask(x, valid, cfg, mask, ref, one_d: bool = False) -> None:
    """Launch B3/B4 (B6 with one_d: its reference-level form) on a
    contiguous CUDA (C, L, 2) f32 tensor, of which the first `valid`
    samples per channel count, into the contiguous (C, N) int32 mask and
    f32 ref buffers (16-byte aligned); every element of both is written.
    The block may be any multiple of 1024 samples, as the reference's
    tiles. The kernel has no sps limit; the 2-D wrappers apply the
    reference's."""
    from . import _ext
    C, L = x.shape[0], x.shape[1]
    n = cfg.block_size
    if n % 1024:
        raise ValueError("block_size must be a multiple of 1024")
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
    with torch.cuda.device(x.device), \
            kernel_range(f"{_mask_route(C, one_d)} detect_mask"):
        rc = lib.detect_mask_launch(
            x.data_ptr(), mask.data_ptr(), ref.data_ptr(), C, L,
            min(int(valid), L), n, -(-n // _CHUNK), int(one_d), cfg.sps,
            cfg.nms_chips * cfg.sps, _detect_rhalo(cfg), _f32(cfg.threshold),
            _f32(cfg.pulse_tolerance), _f32(cfg.quiet_tolerance),
            _f32(1.0 / cfg.sps),
            torch.cuda.current_stream(x.device).cuda_stream)
    _ext.check(rc, "detect_mask")
    LAUNCHES["detect_mask"] += 1
    if one_d:
        DETECT_MASK_ROUTES["B6" if C == 1 else "B6 batch"] += 1
    else:
        DETECT_MASK_ROUTES["B3" if C == 1 else "B4"] += 1


def _mask_route(C: int, one_d: bool) -> str:
    """The kernel table's ID of a detect_mask call over C blocks: B3 (one
    block), B4 (a batch) or B6 (the 1-D form, either)."""
    return "B6" if one_d else "B3" if C == 1 else "B4"


def _detect_mask(x: torch.Tensor, valid: int, length: int,
                 cfg: DspConfig, one_d: bool = False):
    """B3/B4 (B6 with one_d) on x's device: the kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        with kernel_range(f"{_mask_route(x.shape[0], one_d)} detect_mask"):
            return detect_mask_plain(x, valid, length, cfg, one_d)
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
    launch_detect_mask(x, valid, cfg, mask, ref, one_d)
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


@graphed(static_argnames=("cfg", "tile"), counters=LAUNCH_COUNTERS)
def demod_block_packed_fast_jit(iq, cfg: DspConfig, tile: int = 16384,
                                device="cuda") -> torch.Tensor:
    """`demod_block_packed_fast` (B3) as a captured graph on a card."""
    return demod_block_packed_fast(iq, cfg, tile=tile, device=device)


@graphed(static_argnames=("cfg", "tile"), counters=LAUNCH_COUNTERS)
def demod_batch_packed_fast_jit(iq, cfg: DspConfig, tile: int = 16384,
                                device="cuda") -> torch.Tensor:
    """`demod_batch_packed_fast` (B4) as a captured graph on a card."""
    return demod_batch_packed_fast(iq, cfg, tile=tile, device=device)


# --- the 1-D f32 front: kernel B6, and its full-block tail ------------------
#
# The counterpart of the reference's v1 entry points: `preamble_detect_pallas`
# (one block) and `preamble_detect_pallas_batch` (C blocks) become
# `preamble_detect_1d` and `preamble_detect_1d_batch`, over the B3/B4 CUDA
# kernel in its 1-D mode; `demod_block_pallas` and `demod_batch_pallas`
# become `demod_block_1d` and `demod_batch_1d`. B6 decides as B3/B4 do, but
# every input sample counts, the reference level takes the tail's form, and
# there is no sps limit: it serves 20 Msps (sps 10).


def _halo_r(cfg: DspConfig) -> int:
    """Right window margin of the reference's 1-D kernels (its DMA windows
    are 1024-aligned): the preamble, peak look-ahead and NMS window."""
    half = cfg.nms_chips * cfg.sps
    need = max(16 * cfg.sps + half + 4, 130)
    r = 768
    while r < need:
        r += 1024
    return r


def b6_operands(iq: torch.Tensor, cfg: DspConfig, tile: int = 16384):
    """B6's view of (L, 2) or (C, L, 2) f32/int8/int16 I/Q: (x (C, L, 2)
    f32, valid, length). Every input sample counts up to the end of the
    last tile's window, `length`, past which the reference reads nothing;
    a shorter input reads zeros up to it."""
    if cfg.noise_window != 128:
        raise ValueError("the 1-D detect kernel fixes noise_window=128")
    n = cfg.block_size
    if n % tile or tile % 1024:
        raise ValueError(f"tile {tile} must divide block_size {n} and be "
                         "a multiple of 1024")
    length = (n // tile - 1) * tile + _LOOKBACK + tile + _halo_r(cfg)
    x = _to_f32(iq)
    if x.dim() == 2:
        x = x[None]
    if x.dim() != 3 or x.shape[2] != 2:
        raise ValueError(f"expected (L, 2) or (C, L, 2) I/Q, got "
                         f"{tuple(iq.shape)}")
    return x, min(x.shape[1], length), length


def preamble_detect_1d(iq: torch.Tensor, cfg: DspConfig, tile: int = 16384):
    """Kernel B6 on one (L+N+R, 2) block of f32/int8/int16 I/Q -> (mask
    int32 (N,), ref f32 (N,)); the reference's `preamble_detect_pallas`."""
    if iq.dim() != 2:
        raise ValueError(f"expected (L, 2) I/Q, got {tuple(iq.shape)}")
    mask, ref = _detect_mask(*b6_operands(iq, cfg, tile), cfg, one_d=True)
    return mask[0], ref[0]


def preamble_detect_1d_batch(iq: torch.Tensor, cfg: DspConfig,
                             tile: int = 16384):
    """Kernel B6 on (C, L+N+R, 2) I/Q -> (mask int32 (C, N), ref f32
    (C, N)); the reference's `preamble_detect_pallas_batch`."""
    if iq.dim() != 3:
        raise ValueError(f"expected (C, L, 2) I/Q, got {tuple(iq.shape)}")
    return _detect_mask(*b6_operands(iq, cfg, tile), cfg, one_d=True)


def _full_tail(iq: torch.Tensor, mask: torch.Tensor, ref: torch.Tensor,
               cfg: DspConfig) -> P.DetectionTable:
    """The reference's `_xla_full_tail` on (*B, L', 2) I/Q and B6's (*B, N)
    mask and ref: full-block power and noise floor, compaction, the ref
    level of each detection taken from `ref`, bits, CRC/ECC -> table.
    Unlike `dsp.pipeline.demod_block`, a short input is zero-padded to
    L+N+R, as the reference's 1-D entry points do."""
    left = cfg.left_halo
    need = left + cfg.block_size + cfg.right_halo
    if iq.shape[-2] < need:
        iq = torch.nn.functional.pad(iq, (0, 0, 0, need - iq.shape[-2]))
    mag2 = P.magnitude_squared(iq)
    noise = P.noise_floor(mag2, cfg.noise_window)
    det_idx, valid, n_det, overflow = P.compact_detections(
        mask.bool(), cfg.max_detections)
    safe_idx = torch.where(valid, det_idx, 0)
    # an index gather: exact for NaN and Inf, which is what the reference's
    # bit-pattern selection (_select_n) exists to guarantee
    ref_level = P._take(ref, safe_idx)
    noise_at = P._take(noise, left + safe_idx)
    bits, confidence = P.slice_bits(mag2, det_idx, valid, ref_level, cfg,
                                    left)
    out_bits, df, nbits, synd, status = P.crc_check_and_correct(
        bits, confidence, cfg)
    return P.finalize_table(valid, det_idx, out_bits, df, nbits, synd,
                            status, ref_level, noise_at, n_det, overflow)


def demod_block_1d(iq: torch.Tensor, cfg: DspConfig,
                   tile: int = 16384) -> P.DetectionTable:
    """One block, (L+N+R, 2) I/Q on its device: B6 and the full-block tail
    -> DetectionTable; the reference's `demod_block_pallas`."""
    mask, ref = preamble_detect_1d(iq, cfg, tile=tile)
    return _full_tail(iq, mask, ref, cfg)


def demod_batch_1d(iq: torch.Tensor, cfg: DspConfig,
                   tile: int = 16384) -> P.DetectionTable:
    """A batch, (C, L+N+R, 2) I/Q on its device: B6 and the full-block tail
    -> DetectionTable with leading C; the reference's `demod_batch_pallas`."""
    mask, ref = preamble_detect_1d_batch(iq, cfg, tile=tile)
    return _full_tail(iq, mask, ref, cfg)


def demod_block_packed_1d(iq, cfg: DspConfig, tile: int = 16384,
                          device="cuda") -> torch.Tensor:
    """demod_block_1d + pack_table: one block (numpy or tensor) -> (K+1, 9)
    int32 on `device`. Runs on the card unless the caller asks for the
    CPU, where it takes the kernel's plain version."""
    x = P._to_device(iq, resolve_device(device))
    return P.pack_table(demod_block_1d(x, cfg, tile=tile))


def demod_batch_packed_1d(iq, cfg: DspConfig, tile: int = 16384,
                          device="cuda") -> torch.Tensor:
    """demod_batch_1d + pack_table: (C, L+N+R, 2) -> (C, K+1, 9) int32 on
    `device`."""
    x = P._to_device(iq, resolve_device(device))
    return P.pack_table(demod_batch_1d(x, cfg, tile=tile))


@graphed(static_argnames=("cfg", "tile"), counters=LAUNCH_COUNTERS)
def demod_block_packed_1d_jit(iq, cfg: DspConfig, tile: int = 16384,
                              device="cuda") -> torch.Tensor:
    """`demod_block_packed_1d` (B6) as a captured graph on a card; the
    reference's `demod_block_packed_pallas_jit`."""
    return demod_block_packed_1d(iq, cfg, tile=tile, device=device)


@graphed(static_argnames=("cfg", "tile"), counters=LAUNCH_COUNTERS)
def demod_batch_packed_1d_jit(iq, cfg: DspConfig, tile: int = 16384,
                              device="cuda") -> torch.Tensor:
    """`demod_batch_packed_1d` (B6) as a captured graph on a card; the
    reference's `demod_batch_packed_pallas_jit`."""
    return demod_batch_packed_1d(iq, cfg, tile=tile, device=device)


__all__ = [
    "CAND_ROWS", "DEFAULT_NBUF", "DETECT_CANDS_ROUTES", "DETECT_MASK_ROUTES",
    "LAUNCHES", "LAUNCH_COUNTERS", "b3_operands", "b4_operands", "b6_operands",
    "cand_capacity", "compact_candidates", "compact_candidates_unordered",
    "default_tile", "demod_batch_1d", "demod_batch_fast",
    "demod_batch_packed_1d", "demod_batch_packed_1d_jit",
    "demod_batch_packed_fast", "demod_batch_packed_fast_jit",
    "demod_batch_packed_planar", "demod_batch_packed_planar_jit",
    "demod_batch_planar", "demod_block_1d", "demod_block_fast",
    "demod_block_packed_1d", "demod_block_packed_1d_jit",
    "demod_block_packed_fast", "demod_block_packed_fast_jit",
    "detect_cands_buffers", "detect_cands_plain", "detect_mask_plain",
    "gather_tail", "gather_tail_planar", "launch_detect_cands",
    "launch_detect_mask", "launch_slice_windows", "planar_length",
    "power_i8", "preamble_detect_1d", "preamble_detect_1d_batch",
    "preamble_detect_2d", "preamble_detect_2d_batch",
    "preamble_detect_cands_planar", "reset_launches",
    "slice_windows_planar", "slice_windows_plain", "supported_2d_tile",
    "supported_planar_tile", "to_planar_i8",
]
