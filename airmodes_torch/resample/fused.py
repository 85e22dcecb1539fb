"""Fused resample -> on-device int8 quantize -> planar demod, in PyTorch.

The counterpart of `airmodes/resample/fused.py`: raw-rate planar f32 I/Q in,
detection table out, with nothing on the host in between. The polyphase
group matmuls (`polyphase.resample_groups_halo`, f32 with TF32 off), the
per-channel device AGC and the int8 quantize are torch ops, as they are XLA
ops in the reference; the demod is the port's planar path,
`kernels.preamble.demod_batch_planar`, which launches kernels B1 and B2 on
a card.

The port's fused runners (`io.stream.run_resampled_fused` and
`run_resampled_fused_channels`) go one step further than the reference:
they send a capture's words as the file holds them (sc16, uc8 or
complex64), and kernel R1 (`kernels/csrc/raw_planar.cu`, `raw_to_planar`;
`raw_planar_plain` on the CPU) converts them on the card into the planar
windows that the fused step takes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DspConfig
from ..dsp.pipeline import pack_table, resolve_device
from ..io.sources import WIRE_FORMATS
from ..kernels.preamble import LAUNCH_COUNTERS, LAUNCHES
from ..utils.graphs import graphed
from ..utils.profiling import kernel_range
from .polyphase import _GROUP_PQ_CAP, resample_groups_halo

# R1's word types (its format codes) -> the file format whose words they
# are, and that format's (offset, scale), from io.sources.WIRE_FORMATS
_R1_CODES = {torch.float32: 2, torch.int16: 0, torch.uint8: 1}
_BY_DTYPE = {torch.from_numpy(np.empty(0, word)).dtype: (offset, scale)
             for word, offset, scale in WIRE_FORMATS.values()}


def quantize_i8(x: torch.Tensor, gain) -> torch.Tensor:
    """Device twin of dsp.host.quantize_i8_np: round(f32 * gain) clipped to
    +-127, round half to even (torch.round, as np.round and the native C
    quantizer). NaN quantizes to 0 and +-inf saturates. `gain` is a scalar
    or a tensor that broadcasts against x."""
    if not isinstance(gain, torch.Tensor):
        gain = float(np.float32(gain))
    y = torch.clamp(torch.round(x * gain), -127, 127)
    return torch.where(torch.isnan(y), 0.0, y).to(torch.int8)


def raw_geometry(cfg: DspConfig, p: int, q: int) -> Tuple[int, int, int, int]:
    """(raw_left, raw_block, raw_right, out_off) for the fused path.

    A raw-rate window of raw_left + raw_block + raw_right samples (all
    multiples of the input group gi = 128q, so windows stay aligned with
    the offline resampler's global groups) resamples, first/last group as
    matmul halo, to a channel-rate span that covers the demod block's
    [left_halo | block | right_halo] window; out_off is where that window
    starts inside the resampler output. Each raw halo is one gi group of
    matmul lookaround plus enough groups to cover the demod halo:

        raw_halo = gi * (ceil(halo * q / (p * gi)) + 1)
    """
    gi = 128 * q
    raw_block = cfg.block_size * q // p
    if raw_block * p != cfg.block_size * q or raw_block % gi:
        raise ValueError(
            f"block_size {cfg.block_size} not compatible with p/q={p}/{q}: "
            f"needs block_size % {128 * p} == 0")
    if p * q > _GROUP_PQ_CAP:
        raise ValueError(
            f"p/q={p}/{q}: group matrices exceed the {_GROUP_PQ_CAP} cap — "
            "resample on the host instead (rational_rate with a smaller "
            "max_denominator usually suffices)")

    def halo(h: int) -> int:
        return gi * (-(-(h * q) // (p * gi)) + 1)

    raw_left, raw_right = halo(cfg.left_halo), halo(cfg.right_halo)
    # output index of channel-rate sample (block_start - left_halo): the
    # resampler emits samples for the raw interior [raw_left - gi, ...),
    # i.e. starting at channel-rate index (raw_left - gi) * p / q (exact:
    # raw_left - gi is a multiple of gi = 128q)
    out_off = (raw_left - gi) * p // q - cfg.left_halo
    assert out_off >= 0
    return raw_left, raw_block, raw_right, out_off


def resample_quantize_planar(iqp_raw, gain, cfg: DspConfig, p: int, q: int,
                             taps_per_phase: int = 12):
    """Front half of the fused step, on the input's device: planar
    (C, 2, rawL+rawB+rawR) f32 raw -> ((C, 2, left+block+right) int8 at
    the channel rate, (C,) f32 gains). gain=None runs per-channel device
    AGC after the resample (120 over the largest finite |y| of the
    channel's window, 1.0 on a zero peak); a scalar or (C,) gain is used
    as given. p == q == 1 passes the window through: the group matmuls at
    1/1 are a half-sample interpolator, not the identity."""
    x = iqp_raw if isinstance(iqp_raw, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(iqp_raw, np.float32))
    raw_left, raw_block, raw_right, out_off = raw_geometry(cfg, p, q)
    if x.ndim == 2:
        x = x[None]
    c = x.shape[0]
    want = raw_left + raw_block + raw_right
    if x.shape[1] != 2 or x.shape[2] != want:
        raise ValueError(f"fused window must be planar (C, 2, {want}) "
                         f"(raw_geometry), got {tuple(x.shape)}")
    xc = x.reshape(2 * c, want)
    win = cfg.left_halo + cfg.block_size + cfg.right_halo
    if p == q == 1:
        lo = raw_left - cfg.left_halo
        y = xc[:, lo: lo + win]
    else:
        y = resample_groups_halo(xc, p, q, taps_per_phase)[
            :, out_off: out_off + win]
    if gain is None:
        ay = torch.abs(y.reshape(c, 2 * win))
        pk = torch.where(torch.isfinite(ay), ay, 0.0).amax(dim=1)
        gains = 120.0 / torch.where(pk == 0, 1.0, pk)
    else:
        g = torch.as_tensor(gain, dtype=torch.float32, device=x.device)
        gains = g.expand(c) if g.ndim == 0 else g
    grow = gains.repeat_interleave(2)[:, None]
    return quantize_i8(y, grow).reshape(c, 2, win), gains


def resample_demod_planar(iq_raw, gain, cfg: DspConfig, p: int, q: int,
                          taps_per_phase: int = 12, tile: int = None):
    """Fused step on the input's device: planar (C, 2, rawL+rawB+rawR) f32
    raw -> (DetectionTable with leading C, (C,) f32 gains), indices
    relative to the owned block. Each int8 plane is zero-padded to
    `planar_length(cfg, tile)` and demodulated by the planar path
    (kernels B1 and B2 on a card; their plain versions on the CPU)."""
    from ..kernels.preamble import demod_batch_planar, planar_length
    y8, gains = resample_quantize_planar(iq_raw, gain, cfg, p, q,
                                         taps_per_phase)
    win = y8.shape[2]
    plen = planar_length(cfg, tile)
    xi = F.pad(y8[:, 0], (0, plen - win))
    xq = F.pad(y8[:, 1], (0, plen - win))
    return demod_batch_planar(xi, xq, cfg, tile=tile), gains


def resample_demod_packed_planar(iq_raw, gain, cfg: DspConfig, p: int, q: int,
                                 taps_per_phase: int = 12, tile: int = None,
                                 device="cuda"):
    """Fused step + pack_table on `device`: planar (C, 2, W) f32 raw (numpy
    or a tensor; + gain, or None for the device AGC) -> ((C, K+1, 9) int32,
    (C,) f32 gains). Runs on the card unless the caller asks for the
    CPU."""
    dev = resolve_device(device)
    x = iq_raw if isinstance(iq_raw, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(iq_raw, np.float32))
    table, gains = resample_demod_planar(
        x.to(dev, non_blocking=True), gain, cfg, p, q,
        taps_per_phase=taps_per_phase, tile=tile)
    return pack_table(table), gains


@graphed(static_argnames=("cfg", "p", "q", "taps_per_phase", "tile"),
         counters=LAUNCH_COUNTERS)
def resample_demod_packed_planar_jit(iq_raw, gain, cfg: DspConfig, p: int,
                                     q: int, taps_per_phase: int = 12,
                                     tile: int = None, device="cuda"):
    """`resample_demod_packed_planar` as one captured graph per key on a
    card (`utils.graphs`), the reference's compiled fused step: planar
    (C, 2, W) f32 raw, and a gain (a number or a (C,) array, an input of
    the graph) or None (the device AGC, inside the graph) -> ((C, K+1, 9)
    int32, (C,) f32 gains)."""
    return resample_demod_packed_planar(iq_raw, gain, cfg, p, q,
                                        taps_per_phase=taps_per_phase,
                                        tile=tile, device=device)


# --- the capture's words to planar windows: kernel R1 ------------------------

def _raw_rows(raw: torch.Tensor, valid: torch.Tensor, width: int,
              stride: int) -> int:
    """Windows in a raw batch buffer: a contiguous (n, 2) tensor of a wire
    format's words with n = (rows - 1) * stride + width, and `valid` a
    (rows, 2) int32 tensor on its device."""
    if raw.dtype not in _BY_DTYPE:
        raise TypeError(f"raw words must be one of {list(_BY_DTYPE)}, "
                        f"got {raw.dtype}")
    if raw.dim() != 2 or raw.shape[1] != 2 or not raw.is_contiguous():
        raise ValueError(f"raw words must be a contiguous (n, 2) tensor, got "
                         f"{tuple(raw.shape)}")
    n = raw.shape[0]
    if n < width or (n - width) % stride:
        raise ValueError(f"{n} raw samples are not (rows - 1) * {stride} + "
                         f"{width}")
    rows = (n - width) // stride + 1
    if tuple(valid.shape) != (rows, 2) or valid.dtype != torch.int32 \
            or not valid.is_contiguous() or valid.device != raw.device:
        raise ValueError(f"valid ranges must be a contiguous ({rows}, 2) "
                         f"int32 tensor on {raw.device}")
    return rows


def raw_planar_plain(raw: torch.Tensor, valid: torch.Tensor, width: int,
                     stride: int) -> torch.Tensor:
    """Plain PyTorch version of kernel R1: (rows, 2, width) f32 planar
    windows, row c the `width` samples from sample c * stride of `raw`,
    each word converted as its format says (`io.sources.WIRE_FORMATS`)
    where the row's position lies in [valid[c, 0], valid[c, 1]), 0.0
    elsewhere."""
    rows = _raw_rows(raw, valid, width, stride)
    offset, scale = _BY_DTYPE[raw.dtype]
    x = raw.as_strided((rows, width, 2), (2 * stride, 2, 1))
    if raw.dtype != torch.float32:
        x = x.to(torch.float32)
        if offset:
            x = x - offset
        x = x * torch.tensor(scale, dtype=torch.float32)
    pos = torch.arange(width, device=raw.device)
    keep = (pos >= valid[:, :1]) & (pos < valid[:, 1:])
    x = torch.where(keep[:, :, None], x, 0.0)
    return x.permute(0, 2, 1).contiguous()


def raw_to_planar(raw: torch.Tensor, valid: torch.Tensor, width: int,
                  stride: int) -> torch.Tensor:
    """(rows, 2, width) f32 planar windows of a raw batch buffer, on its
    device: kernel R1 for CUDA tensors (raw 16-byte aligned, width and
    stride multiples of 8: `raw_geometry` gives multiples of 128), the
    plain version on the CPU."""
    if raw.device.type == "cpu":
        with kernel_range("R1 raw_planar"):
            return raw_planar_plain(raw, valid, width, stride)
    if raw.device.type != "cuda":
        raise ValueError(f"unsupported device {raw.device}")
    rows = _raw_rows(raw, valid, width, stride)
    if raw.data_ptr() % 16 or width % 8 or stride % 8:
        raise ValueError("R1 needs a 16-byte aligned buffer and a width and "
                         "stride that are multiples of 8")
    from ..kernels import _ext
    out = torch.empty((rows, 2, width), dtype=torch.float32,
                      device=raw.device)
    offset, scale = _BY_DTYPE[raw.dtype]
    with torch.cuda.device(raw.device), kernel_range("R1 raw_planar"):
        rc = _ext.lib("raw_planar").raw_planar_launch(
            raw.data_ptr(), valid.data_ptr(), out.data_ptr(),
            _R1_CODES[raw.dtype], rows, stride, width, offset, scale,
            torch.cuda.current_stream(raw.device).cuda_stream)
    _ext.check(rc, "raw_planar")
    LAUNCHES["raw_planar"] += 1
    return out
