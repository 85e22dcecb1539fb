"""Probe P5 and the planar step's stage split: where the time of the
production planar int8 step goes, variant by variant.

The counterpart of `scripts/tpu_unordered_stage_probe.py`. Over C
channels of `DspConfig(block_size=1<<22, max_detections=256)` in the
planar layout (one seeded noise row per plane, std 0.05 * 127, broadcast
over C) it times:

  floor  kernel P5 (`step_floor`, csrc/planar_floor.cu): B1's windows
         loaded, no rule
  k      B1 (`preamble_detect_cands_planar`, ordered=False)
  kc     + `compact_candidates_unordered`
  kcg    `demod_batch_planar` (+ B2 and the tail)
  kcgx   `demod_batch_planar(xla_gather=True)` (a torch gather for B2)
  full   `demod_batch_packed_planar` (+ pack_table)

each as ms (`probes.time_ms`, the step as a caller sees it, the gaps in
which the card waits for the host's launches inside) and Gsps, and the
host clock's best of 6, as the script reports; and the card's own time per
call (time_ms with the launches queued behind a spin), which leaves those
gaps out.

    python -m airmodes_torch.probes.unordered_stage_probe [C] [TILE] [NBUF]

runs on the card (`--device cuda`, the default; raises without one) with
the script's defaults C = 64, TILE = 65536, NBUF = 2 (NBUF changes
nothing on the card: B1 has one form); `--device cpu` runs the plain
versions, host clock only.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..config import DspConfig
from ..kernels import preamble as K
from ..kernels.opcount import floor_probe_bytes
from ..dsp.pipeline import resolve_device
from ..utils.profiling import kernel_range
from . import flush_buffer, host_ms, smi_line, time_ms

C, TILE, NBUF = 64, 65536, 2
BLOCK = 1 << 22

# kernel launches since the last reset_launches(); only the CUDA path counts
LAUNCHES = {"planar_floor": 0}


def reset_launches() -> None:
    LAUNCHES["planar_floor"] = 0


def probe_config(block_size: int = BLOCK) -> DspConfig:
    return DspConfig(block_size=block_size, max_detections=256)


def make_input(cfg: DspConfig, channels: int = C, tile: int = TILE,
               device="cuda", seed: int = 0):
    """(C, P) int8 planar I and Q on `device`: one noise row per plane
    (seed, std 0.05 * 127), the same row in every channel, as the script
    makes them."""
    dev = resolve_device(device)
    p = K.planar_length(cfg, tile)
    rng = np.random.default_rng(seed)
    one_i = (rng.standard_normal(p) * 0.05 * 127).astype(np.int8)
    one_q = (rng.standard_normal(p) * 0.05 * 127).astype(np.int8)
    return tuple(torch.from_numpy(r).to(dev)[None].expand(channels, p)
                 .contiguous() for r in (one_i, one_q))


def _staged_len(cfg: DspConfig) -> int:
    """Samples B1 stages per 4096-sample chunk: lookback, chunk, halo."""
    return K._LOOKBACK + K._CHUNK + K._detect_rhalo(cfg)


def floor_plain(xi8: torch.Tensor, xq8: torch.Tensor, cfg: DspConfig,
                tile: int = TILE) -> torch.Tensor:
    """Plain version of P5: (C*tiles*8, 128) int32, each tile's (8, 128)
    candidate block filled with the planar I sample at tile * t."""
    tiles = cfg.block_size // tile
    v = xi8[:, 0:tiles * tile:tile].to(torch.int32)
    return v[:, :, None, None].expand(-1, -1, K.CAND_ROWS, 128).reshape(
        -1, 128)


def step_floor(xi8: torch.Tensor, xq8: torch.Tensor, cfg: DspConfig,
               tile: int = TILE) -> torch.Tensor:
    """P5: B1's loads with no rule -> floor_plain's output. The kernel on
    the card, the plain version for CPU tensors."""
    if cfg.block_size % tile or tile % K._CHUNK:
        raise ValueError(f"tile {tile} must divide the block and be a "
                         f"multiple of {K._CHUNK}")
    p = K.planar_length(cfg, tile)
    if xi8.dim() != 2 or xi8.shape != xq8.shape or xi8.shape[1] != p \
            or xi8.dtype != torch.int8 or xq8.dtype != torch.int8:
        raise ValueError(f"expected two (C, {p}) int8 planar arrays")
    if xi8.device != xq8.device:
        raise ValueError("I and Q must be on one device")
    if xi8.device.type == "cpu":
        with kernel_range("P5 planar_floor"):
            return floor_plain(xi8, xq8, cfg, tile)
    if xi8.device.type != "cuda":
        raise ValueError(f"unsupported device {xi8.device}")
    from ..kernels import _ext
    xi8, xq8 = (K._aligned16(a.contiguous()) for a in (xi8, xq8))
    channels = xi8.shape[0]
    tiles = cfg.block_size // tile
    nchunk = tile // K._CHUNK
    scratch = torch.empty(channels * tiles * nchunk, dtype=torch.int32,
                          device=xi8.device)
    out = torch.empty((channels * tiles * K.CAND_ROWS, 128),
                      dtype=torch.int32, device=xi8.device)
    lib = _ext.lib("planar_floor")
    with torch.cuda.device(xi8.device), kernel_range("P5 planar_floor"):
        rc = lib.planar_floor_launch(
            xi8.data_ptr(), xq8.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), channels, p, tile, tiles, nchunk,
            _staged_len(cfg), torch.cuda.current_stream().cuda_stream)
    _ext.check(rc, "planar_floor")
    LAUNCHES["planar_floor"] += 1
    return out


def floor_bytes(cfg: DspConfig, channels: int, tile: int = TILE) -> int:
    """Bytes P5 must move (`opcount.floor_probe_bytes`)."""
    return floor_probe_bytes(channels, K.planar_length(cfg, tile),
                             cfg.block_size // tile, tile // K._CHUNK,
                             K.CAND_ROWS)


def variants(cfg: DspConfig, tile: int = TILE, nbuf: int = NBUF):
    """name -> function of (xi8, xq8): the script's variants, each through
    the port's public functions."""
    def k(a, b):
        return K.preamble_detect_cands_planar(a, b, cfg, tile=tile,
                                              nbuf=nbuf, ordered=False)

    def kc(a, b):
        return K.compact_candidates_unordered(k(a, b), cfg, tile)

    return {
        "floor": lambda a, b: step_floor(a, b, cfg, tile),
        "k": k,
        "kc": kc,
        "kcg": lambda a, b: K.demod_batch_planar(a, b, cfg, tile=tile,
                                                 nbuf=nbuf),
        "kcgx": lambda a, b: K.demod_batch_planar(a, b, cfg, tile=tile,
                                                  nbuf=nbuf,
                                                  xla_gather=True),
        "full": lambda a, b: K.demod_batch_packed_planar(
            a, b, cfg, tile=tile, nbuf=nbuf, device=a.device),
    }


def measure(xi8: torch.Tensor, xq8: torch.Tensor, cfg: DspConfig,
            tile: int = TILE, nbuf: int = NBUF) -> list:
    """Each variant's {name, ms, gsps, card_ms, host_best_ms, host_ms}: ms
    by time_ms as a caller sees the call (the gaps in which the card waits
    for the host's launches inside) and Gsps over it, the card's own ms
    (time_ms with device_only), each with the L2 cache evicted before each
    call and None off the card, and the host clock's best and
    all of its 6 calls."""
    nsamp = xi8.shape[0] * cfg.block_size
    on_card = xi8.device.type == "cuda"
    flush = flush_buffer(xi8.device) if on_card else None
    out = []
    for name, fn in variants(cfg, tile, nbuf).items():
        host = host_ms(lambda: fn(xi8, xq8), 6, xi8.device)
        ms = time_ms(lambda: fn(xi8, xq8), flush=flush,
                     device_only=False) if on_card else None
        card = time_ms(lambda: fn(xi8, xq8), flush=flush) \
            if on_card else None
        out.append({"name": name, "ms": ms, "card_ms": card,
                    "host_best_ms": min(host), "host_ms": host,
                    "gsps": None if ms is None else nsamp / ms / 1e6})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m airmodes_torch.probes.unordered_stage_probe",
        description="The planar step's load floor (P5) and stage split.")
    ap.add_argument("C", type=int, nargs="?", default=C)
    ap.add_argument("TILE", type=int, nargs="?", default=TILE)
    ap.add_argument("NBUF", type=int, nargs="?", default=NBUF)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    smi = smi_line() if on_card else "cpu: plain versions, host clock only"
    cfg = probe_config(BLOCK)
    xi8, xq8 = make_input(cfg, args.C, args.TILE, dev)
    print(f"{smi}; C={args.C} TILE={args.TILE} NBUF={args.NBUF} "
          f"block={cfg.block_size}, {2 * xi8.numel() / 1e6:.1f} MB int8",
          flush=True)
    for r in measure(xi8, xq8, cfg, args.TILE, args.NBUF):
        card = "not measured" if r["card_ms"] is None else \
            f"{r['card_ms']:.5f} ms"
        dev_txt = "device not measured" if r["ms"] is None else \
            f"{r['ms']:9.5f} ms -> {r['gsps']:7.3f} Gsps, card {card}"
        print(f"{r['name']:6s} {dev_txt}  host "
              f"best={r['host_best_ms']:8.3f} ms (all "
              f"{[round(t, 3) for t in r['host_ms']]})  [{smi}]",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
