# Frozen copy of the planar layout's geometry (default_tile, _slice_geometry,
# _planar_geometry, planar_length) of airmodes_torch/kernels/preamble.py at
# commit 8b1fb463eba6: the bytes that kernel B1 reads, for its roofline. Part
# of the benchmark's yardstick; no decision of `correct` reads it.
"""Geometry of the port's planar int8 layout, for the roofline readers."""

from __future__ import annotations

_LOOKBACK_ROWS = 2
_HALO_ROWS_I8 = 30


def default_tile(cfg) -> int:
    """Largest tile of the planar layout that divides the block."""
    for t in (131072, 65536, 32768, 16384, 8192, 4096):
        if cfg.block_size % t == 0:
            return t
    raise ValueError(
        f"block_size {cfg.block_size} not a multiple of 4096; "
        "the planar path needs 4096-aligned tiles")


def _slice_geometry(cfg, extra: int = 0):
    """(W, out_rows, pad_rows, dma_rows) of the per-detection windows."""
    W = cfg.noise_window + 242 * cfg.sps + 2 * extra
    out_rows = -(-W // 128)
    pad_rows = -(-out_rows // 8) * 8
    dma_rows = 32 * (-(-(32 + out_rows + 1) // 32))
    return W, out_rows, pad_rows, dma_rows


def _planar_geometry(cfg, tile: int):
    """(trows, rows_w, tiles, stride_rows) of the planar layout."""
    trows = tile // 128
    rows_w = _LOOKBACK_ROWS + trows + _HALO_ROWS_I8
    if rows_w % 32 or trows % 32:
        raise ValueError("tile must be a multiple of 4096")
    tiles = cfg.block_size // tile
    needed_rows = (tiles - 1) * trows + rows_w + \
        _slice_geometry(cfg, cfg.nms_chips * cfg.sps)[3]
    stride_rows = -(-needed_rows // 32) * 32
    return trows, rows_w, tiles, stride_rows


def planar_length(cfg, tile: int = None) -> int:
    """Per-channel padded sample count the planar path expects."""
    if tile is None:
        tile = default_tile(cfg)
    return _planar_geometry(cfg, tile)[3] * 128
