"""Probe P4: kernel B4 timed stage by stage on the card.

The counterpart of `scripts/tpu_kernel_ablate.py`. Kernel
`detect_ablate` (csrc/detect_ablate.cu) is B4 cut after each stage of its
rule; each cut writes (C, N) int32 mask and f32 ref over the owned samples,
as the script's `body` does:

  stages 0, 1  the power m (the script's code makes the two one stage):
               mask = m > 0, ref = m
  stage 2      + the 128-sample window sum ws (from each owned sample on)
  stage 3      + the pulse, peak, reference-level and threshold tests
  stage 4      + the quiet-chip maximum and its test
  stage 5      + NMS: kernel B4 itself

on `b4_operands` of C = 16 channels of int8 noise (seed 0, std 0.05 *
127, as the script makes it) at `DspConfig(block_size=1<<22,
max_detections=256)`, tile 16384. It prints each stage's ms on the card
(`probes.time_ms`) and Msps with the int8 -> f32 pass (the script's jitted
function includes it) and without it, each stage's increment over the one
before, and the host clock's median; and last, beside stage 5, kernel B4
itself (`preamble_detect_2d_batch`) on the same operands.

    python -m airmodes_torch.probes.kernel_ablate

runs on the card (`--device cuda`, the default; raises without one);
`--device cpu` runs the plain versions, host clock only. The kernel takes
the sps-1 rule only, the script's.
"""

from __future__ import annotations

import argparse
import statistics
import sys

import numpy as np
import torch

from ..config import DspConfig
from ..constants import PREAMBLE_PULSE_CHIPS, PREAMBLE_QUIET_CHIPS
from ..dsp.pipeline import _f32, power_f32, resolve_device
from ..kernels import preamble as K
from ..utils.profiling import kernel_range
from . import flush_buffer, host_ms, smi_line, time_ms

C, TILE = 16, 16384
BLOCK = 1 << 22
STAGES = (0, 1, 2, 3, 4, 5)

# kernel launches since the last reset_launches(), per stage; only the
# CUDA path counts
LAUNCHES = {s: 0 for s in STAGES}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def probe_config(block_size: int = BLOCK) -> DspConfig:
    return DspConfig(block_size=block_size, max_detections=256)


def make_input(cfg: DspConfig, channels: int = C, seed: int = 0):
    """(C, L+N+R, 2) int8 noise, std 0.05 * 127, from one seeded numpy
    generator as the script draws it (a channel at a time, which draws
    the same numbers)."""
    n_in = cfg.left_halo + cfg.block_size + cfg.right_halo
    rng = np.random.default_rng(seed)
    out = np.empty((channels, n_in, 2), np.int8)
    for c in range(channels):
        out[c] = (rng.standard_normal((n_in, 2)) * 0.05 * 127).astype(
            np.int8)
    return out


def _check_config(cfg: DspConfig) -> None:
    if cfg.sps != 1 or cfg.nms_chips * cfg.sps > 4:
        raise ValueError("the ablation kernel takes the sps-1 rule (sps 1, "
                         f"an NMS half-window <= 4); got sps={cfg.sps}")


def ablate_plain(x: torch.Tensor, valid: int, length: int, cfg: DspConfig,
                 stages: int):
    """Plain version of the cut after `stages`: (C, L, 2) f32 I/Q of which
    the first `valid` samples count, padded to `length` -> (mask int32 (C,
    N), ref f32 (C, N)), the script's `body` over the owned samples."""
    Cn = x.shape[0]
    n = cfg.block_size
    xp = torch.zeros((Cn, length, 2), dtype=torch.float32, device=x.device)
    k = min(valid, length, x.shape[1])
    xp[:, :k] = x[:, :k]
    m = power_f32(xp[..., 0], xp[..., 1])
    if stages >= 5:
        keep, ref = K._detect_plain(m, cfg)
        return keep.to(torch.int32), ref
    u = K._LOOKBACK                               # owned sample 0

    def at(arr, off):
        return arr[:, u + off: u + off + n]

    if stages <= 1:
        v = at(m, 0)
        return (v > 0).to(torch.int32), v
    ws = m
    for s in (1, 2, 4, 8, 16, 32, 64):            # ws[y] = sum m[y:y+128]
        ws = ws[..., :-s] + ws[..., s:]
    if stages == 2:
        v = at(ws, 0)
        return (v > 0).to(torch.int32), v
    p0, p1, p2, p3 = (at(m, c) for c in PREAMBLE_PULSE_CHIPS)
    ref = (((p0 + p1) + p2) + p3) * 0.25
    nf = at(ws, -128) * (1.0 / 128.0)
    ok = (p0 >= at(m, -1)) & (p0 > at(m, 1))
    pmin = torch.minimum(torch.minimum(p0, p1), torch.minimum(p2, p3))
    ok &= (pmin > nf * _f32(cfg.threshold)) & \
        (pmin > ref * _f32(cfg.pulse_tolerance))
    if stages >= 4:
        quiet = at(m, PREAMBLE_QUIET_CHIPS[0])
        for q in PREAMBLE_QUIET_CHIPS[1:]:
            quiet = torch.maximum(quiet, at(m, q))
        ok &= quiet < ref * _f32(cfg.quiet_tolerance)
    return ok.to(torch.int32), ref


def launch_ablate(x: torch.Tensor, valid: int, cfg: DspConfig, stages: int,
                  mask: torch.Tensor, ref: torch.Tensor) -> None:
    """Launch the cut after `stages` on a contiguous, 8-byte aligned CUDA
    (C, L, 2) f32 tensor into contiguous (C, N) int32 mask and f32 ref
    buffers (16-byte aligned); every element of both is written."""
    from ..kernels import _ext
    Cn, L = x.shape[0], x.shape[1]
    n = cfg.block_size
    if n % 1024:
        raise ValueError("block_size must be a multiple of 1024")
    if x.dtype != torch.float32 or x.dim() != 3 or x.shape[2] != 2 \
            or not x.is_contiguous() or x.data_ptr() % 8:
        raise ValueError("the ablation's input must be contiguous, 8-byte "
                         "aligned (C, L, 2) f32")
    for buf, dt in ((mask, torch.int32), (ref, torch.float32)):
        if tuple(buf.shape) != (Cn, n) or buf.dtype != dt \
                or not buf.is_contiguous():
            raise ValueError("ablation outputs of the wrong shape, type or "
                             "layout")
    lib = _ext.lib("detect_ablate")
    with torch.cuda.device(x.device), kernel_range("P4 detect_ablate"):
        rc = lib.detect_ablate_launch(
            x.data_ptr(), mask.data_ptr(), ref.data_ptr(), Cn, L,
            min(int(valid), L), n, -(-n // K._CHUNK), int(stages), cfg.sps,
            cfg.nms_chips * cfg.sps, K._detect_rhalo(cfg),
            _f32(cfg.threshold), _f32(cfg.pulse_tolerance),
            _f32(cfg.quiet_tolerance), _f32(1.0 / cfg.sps),
            torch.cuda.current_stream().cuda_stream)
    _ext.check(rc, "detect_ablate")
    LAUNCHES[stages] += 1


def detect_stage(x: torch.Tensor, valid: int, length: int, cfg: DspConfig,
                 stages: int):
    """The cut after `stages` on B4's operands (`b4_operands`): the kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    _check_config(cfg)
    if stages not in STAGES:
        raise ValueError(f"stages must be one of {STAGES}, got {stages}")
    if x.device.type == "cpu":
        with kernel_range("P4 detect_ablate"):
            return ablate_plain(x, valid, length, cfg, stages)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    if x.data_ptr() % 8:
        x = x.clone()
    Cn = x.shape[0]
    mask = torch.empty((Cn, cfg.block_size), dtype=torch.int32,
                       device=x.device)
    ref = torch.empty((Cn, cfg.block_size), dtype=torch.float32,
                      device=x.device)
    launch_ablate(x, valid, cfg, stages, mask, ref)
    return mask, ref


def ablate(iq: torch.Tensor, cfg: DspConfig, stages: int,
           tile: int = TILE):
    """The script's jitted step: (C, L+N+R, 2) int8 (or f32) I/Q -> the
    int8 -> f32 pass (`b4_operands`) and the cut after `stages`."""
    return detect_stage(*K.b4_operands(iq, cfg, tile), cfg, stages)


def stage_bytes(cfg: DspConfig, channels: int, tile: int = TILE) -> int:
    """Bytes each cut must move without the int8 -> f32 pass: the f32 I/Q
    pairs read (the input's samples up to the padded length) and the mask
    and ref written."""
    length = -(-K._check_2d(cfg, tile) // 1024) * 1024
    n_in = min(cfg.left_halo + cfg.block_size + cfg.right_halo, length)
    return channels * (8 * n_in + 8 * cfg.block_size)


def measure(iq: torch.Tensor, cfg: DspConfig, tile: int = TILE) -> list:
    """Each stage's {stages, ms, ms_f32, inc_ms, msps, msps_f32, host_ms},
    then the same for kernel B4 on the same operands (stages "B4"): the
    card's ms (time_ms, the L2 cache evicted before each call)
    with the int8 -> f32 pass and without, the increment over the stage
    before (without the pass), Msps over each (all None off the card),
    and the host clock's median of 5 with the pass."""
    x, valid, length = K.b4_operands(iq, cfg, tile)
    nsamp = iq.shape[0] * cfg.block_size
    on_card = iq.device.type == "cuda"
    flush = flush_buffer(iq.device) if on_card else None
    runs = [(s, lambda s=s: ablate(iq, cfg, s, tile),
             lambda s=s: detect_stage(x, valid, length, cfg, s))
            for s in STAGES]
    runs.append(("B4", lambda: K.preamble_detect_2d_batch(iq, cfg, tile),
                 lambda: K._detect_mask(x, valid, length, cfg)))
    out, prev = [], None
    for stage, with_pass, alone in runs:
        host = statistics.median(host_ms(with_pass, 5, iq.device))
        ms = time_ms(with_pass, flush=flush) if on_card else None
        ms_f32 = time_ms(alone, flush=flush) if on_card else None
        staged = on_card and prev is not None and stage != "B4"
        out.append({"stages": stage, "ms": ms, "ms_f32": ms_f32,
                    "inc_ms": ms_f32 - prev if staged else None,
                    "msps": nsamp / (ms * 1e-3) / 1e6 if on_card else None,
                    "msps_f32": nsamp / (ms_f32 * 1e-3) / 1e6 if on_card
                    else None,
                    "host_ms": host})
        prev = ms_f32
    return out


def label(stage) -> str:
    """A row of measure() by name: `stages<=s`, or `B4` for the kernel."""
    return "B4 kernel" if stage == "B4" else f"stages<={stage}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m airmodes_torch.probes.kernel_ablate",
        description="Kernel B4 timed stage by stage (P4).")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    card = smi_line() if on_card else "cpu: plain versions, host clock only"
    cfg = probe_config(BLOCK)
    _check_config(cfg)
    iq = torch.from_numpy(make_input(cfg, C)).to(dev)
    print(f"{card}; C={C} block={cfg.block_size} tile={TILE}, "
          f"{iq.numel() / 1e6:.1f} MB int8 in", flush=True)
    for r in measure(iq, cfg, TILE):
        if r["ms"] is None:
            dev_txt = "device not measured"
        else:
            inc = "" if r["inc_ms"] is None else \
                f", +{r['inc_ms']:.5f} ms"
            dev_txt = (f"{r['ms']:9.5f} ms {r['msps']:8.0f} Msps (f32 in: "
                       f"{r['ms_f32']:.5f} ms {r['msps_f32']:.0f} Msps{inc})")
        print(f"{label(r['stages']):10s} {dev_txt}  host "
              f"{r['host_ms']:9.3f} ms  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
