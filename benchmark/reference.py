"""The plain reference: what the served path should emit for each block of
a cell's stream, worked out again from the captures' samples.

It imports nothing of the program: plain PyTorch and NumPy, `modes.py`,
and the benchmark's frozen configuration and filter design
(`benchmark/frozen/`). For each channel-block it
frames the row the program frames ([left halo | block | right halo] of the
looped stream), and

- on a configuration without a resampler: converts the wire samples to f32
  as the native framer does ((u - 127.5) * f32(1/127.5) for uc8), takes the
  per-block AGC gain f32(120) / peak over the framed row, and quantizes
  round(x * gain) to int8, half to even, clipped to +-127;
- with a resampler (p = 1, decimate by q): runs the polyphase FIR, output m
  = sum_k h[k] * x[q*m + len(h)//2 - k], in float64 as a direct
  convolution (not the program's group matmuls), rounds it to f32, and
  takes the device AGC over the row and the same quantize;

then finds, decodes and formats the block's frames by the plain Mode S
receiver of `modes.py`, written from the rules, which shares no code with
the program.

`levels` below 127 is the control: the same reference with each sample
held in a signed integer of `levels` steps a side (7: int4) on the same
full scale, then put back on the int8 scale for the demod. `tf32` runs the
FIR in f32 with TF32 allowed (on a card), for the record.

The stream is looped, so block b of a channel holds the same samples as
block b + period for every b >= 1 (block 0 has a zero left halo and is
never judged): the reference works out each such class once.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import modes
from .frozen.config import DspConfig
from .frozen.polyphase import fir_taps


def dsp_config(config: dict) -> DspConfig:
    return DspConfig(**config["dsp"])


def rate_ratio(config: dict) -> int:
    """Source samples per channel sample (q of a p = 1 resampler)."""
    q = config["source_rate"] / config["dsp"]["channel_rate"]
    if abs(q - round(q)) > 1e-9:
        raise ValueError("the reference resamples by a whole factor only")
    return int(round(q))


def period_blocks(config: dict, capture_samples: int) -> int:
    """Blocks after which a channel's looped stream repeats at the channel
    rate: the capture's length in channel samples, times q over the
    common factor of the two."""
    q = rate_ratio(config)
    per = capture_samples // math.gcd(capture_samples, q)
    n = dsp_config(config).block_size
    if per % n:
        raise ValueError(f"a period of {per} channel samples is not whole "
                         f"blocks of {n}")
    return per // n


def _agc_quantize(y: torch.Tensor, levels: int):
    """(C, 2, W) f32 -> ((C, 2, W) int8, (C,) f32 gains): gain = f32(120)
    / the largest finite |y| of the row (1.0 on a zero peak), round(y *
    gain) half to even, clipped to +-127; below 127 levels, a coarser
    quantizer on the same full scale."""
    a = torch.abs(y).flatten(1)
    pk = torch.where(torch.isfinite(a), a, 0.0).amax(dim=1)
    gains = torch.tensor(120.0, dtype=torch.float32,
                         device=y.device) / torch.where(pk == 0, 1.0, pk)
    x = y * gains[:, None, None]
    if levels == 127:
        q = torch.clamp(torch.round(x), -127, 127)
    else:
        s = levels / 127.0
        q = torch.clamp(torch.round(x * s), -levels, levels)
        q = torch.round(q / s)
    q = torch.where(torch.isnan(q), 0.0, q)
    return q.to(torch.int8), gains


class Reference:
    """Per-block messages of one cell's streams (see the module's
    docstring). `captures` are the channels' interleaved wire samples."""

    ROWS_PER_CALL = 8

    def __init__(self, config: dict, captures: List[np.ndarray], device,
                 levels: int = 127, tf32: bool = False):
        self.config = config
        self.cfg = dsp_config(config)
        self.q = rate_ratio(config)
        self.fmt = config["sample_format"]
        self.dev = torch.device(device)
        self.levels = levels
        self.tf32 = tf32
        self.caps = captures
        self.samples = captures[0].size // 2
        self.period = period_blocks(config, self.samples)
        self._tables: Dict[Tuple[int, int], tuple] = {}
        if self.q > 1:
            h = fir_taps(self.q).astype(np.float32 if tf32 else np.float64)
            self._w = torch.from_numpy(h[::-1].copy()).to(self.dev)

    # -- samples -------------------------------------------------------------

    def _wire(self, c: int, raw_idx: torch.Tensor) -> torch.Tensor:
        """(2, n) f32 unit-scale I and Q of stream samples raw_idx (the
        looped capture; zeros before the stream's start)."""
        data = self._dev_caps[c]
        j = torch.remainder(raw_idx, self.samples)
        iq = torch.stack([data[2 * j], data[2 * j + 1]]).to(torch.float32)
        if self.fmt == "uc8":
            k = float(np.float32(1.0) / np.float32(127.5))
            x = (iq - 127.5) * k
        else:
            x = iq * float(np.float32(1.0 / 32768.0))
        return torch.where(raw_idx[None] >= 0, x, 0.0)

    def _row(self, c: int, b: int) -> torch.Tensor:
        """(2, W) f32: channel c's row of block b at the channel rate."""
        cfg = self.cfg
        w = cfg.left_halo + cfg.block_size + cfg.right_halo
        m0 = b * cfg.block_size - cfg.left_halo
        if self.q == 1:
            return self._wire(c, torch.arange(w, device=self.dev) + m0)
        taps = self._w.numel()
        r0 = self.q * m0 + taps // 2 - (taps - 1)
        x = self._wire(c, torch.arange(self.q * (w - 1) + taps,
                                       device=self.dev) + r0)
        cudnn = torch.backends.cudnn
        was = cudnn.allow_tf32
        cudnn.allow_tf32 = self.tf32
        try:
            y = torch.nn.functional.conv1d(x.to(self._w.dtype)[:, None],
                                           self._w[None, None],
                                           stride=self.q)
        finally:
            cudnn.allow_tf32 = was
        return y[:, 0].to(torch.float32)

    def resolvable(self, s: int) -> bool:
        """Whether a frame that starts at stream sample s (at the source
        rate) can be sliced at one channel sample a chip: its chips'
        centres lie within a quarter chip of channel samples. True for
        every frame without a resampler (frames start on whole samples) or
        at more than one sample a chip; with one, channel sample m stands
        for the source samples centred on q*m + taps//2 - (taps - 1)/2."""
        if self.q == 1 or self.cfg.sps > 1:
            return True
        taps = self._w.numel()
        centre = s + (self.q - 1) / 2 - (taps // 2 - (taps - 1) / 2)
        d = centre / self.q
        return abs(d - round(d)) <= 0.25

    # -- tables --------------------------------------------------------------

    def block_class(self, b: int) -> int:
        """The block that holds the same samples as block b >= 1, in
        [period, 2 * period) so that its left halo is real samples."""
        return self.period + (b % self.period)

    def prepare(self, wanted) -> None:
        """Work out the frames of every (channel, block) in `wanted`, by
        class, ROWS_PER_CALL rows at a time."""
        todo = sorted({(c, self.block_class(b)) for c, b in wanted}
                      - set(self._tables))
        if not todo:
            return
        self._dev_caps = [torch.from_numpy(np.ascontiguousarray(
            cap)).to(self.dev) for cap in self.caps]
        try:
            for i in range(0, len(todo), self.ROWS_PER_CALL):
                part = todo[i:i + self.ROWS_PER_CALL]
                rows = torch.stack([self._row(c, b) for c, b in part])
                q8, gains = _agc_quantize(rows, self.levels)
                dets = modes.detect(q8, self.cfg)
                g = gains.cpu().numpy()
                for j, key in enumerate(part):
                    self._tables[key] = modes.emitted(
                        dets[j], modes.decide(dets[j], self.cfg),
                        float(g[j]))
        finally:
            del self._dev_caps

    def messages(self, c: int, b: int) -> List[str]:
        """The wire messages of channel c's block b (after `prepare`)."""
        return modes.messages(self._tables[(c, self.block_class(b))],
                              b * self.cfg.block_size, self.cfg.channel_rate)

    def tied(self, c: int, b: int) -> set:
        """The stamps ("<seconds> <nanoseconds>") of channel c's block b's
        frames whose content hangs on an exact tie (`modes.decide`)."""
        return modes.tied_stamps(self._tables[(c, self.block_class(b))],
                                 b * self.cfg.block_size,
                                 self.cfg.channel_rate)
