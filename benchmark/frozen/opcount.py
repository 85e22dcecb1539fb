# Frozen copy of airmodes_torch/kernels/opcount.py at commit 8b1fb463eba6: part of
# the benchmark's yardstick, which later changes to the program leave as
# it is. Only its imports were changed.
"""The Hopper count: f32 instructions per sample of each detect kernel, and
the least time an H100 could take for a kernel's bytes and instructions.

The counterpart of `airmodes/kernels/opcount.py`, which counts the vector
passes of a traced jaxpr on a TPU. That count describes the TPU's vector
unit and has no torch counterpart; this module counts what the H100
executes instead, by hand, from the kernels' arithmetic (csrc/): an add, a
product, a compare, a min, a max or an FMA is one instruction. The bytes
a kernel must move are counted by its caller from the inputs it was
given (each input read once, each output written once).

`bound(n_bytes, n_instr)` is the larger of the bytes over the card's
memory rate and the instructions over its f32 instruction rate, with the rate
that binds. The peaks are the H100 SXM's published figures (NVIDIA data
sheet): 3.35 TB/s of HBM3, and 67 TFLOP/s of f32 outside the tensor cores,
which counts an FMA as two operations, so the card executes 33.5 T f32
instructions per second (132 SMs x 128 lanes x the clock).
"""

from __future__ import annotations

from typing import Tuple

PEAK_BYTES_S = 3.35e12
PEAK_F32_INSTR_S = 67e12 / 2
# f32 instructions B2 is charged per window sample it reads: one more than
# B1's power of an int8 pair (4)
B2_OPS_PER_WINDOW_SAMPLE = 5


def bound(n_bytes: float, n_instr: float) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations"): the larger of n_bytes over
    PEAK_BYTES_S and n_instr over PEAK_F32_INSTR_S, and which one it is."""
    mem_s, ops_s = n_bytes / PEAK_BYTES_S, n_instr / PEAK_F32_INSTR_S
    return (max(mem_s, ops_s) * 1e3,
            "bytes" if mem_s >= ops_s else "operations")


def b1_ops_per_sample(sps: int, half: int) -> int:
    """f32 instructions B1 needs per owned sample (an add, product,
    compare, min, max or FMA is one): power 4 (two int8 scalings, a
    product, an FMA), window fold 7, chip energy sps (sps > 1: sps - 1 adds
    and the scale), tests 27 (reference level 4, noise level 1, peak 2,
    pulse minimum 3, threshold and tolerance 4, quiet maximum over 12
    chips 11 and its tolerance 2), NMS 2*half maxima and 2 compares."""
    return 4 + 7 + (sps if sps > 1 else 0) + 27 + 2 * half + 2


def b1_ops_parent(sps: int, half: int) -> int:
    """The earlier yardstick of B1: operations, an FMA as two, over the
    67 TFLOP/s rate (kept to print the change of yardstick once)."""
    return 5 + 7 + (sps if sps > 1 else 0) + 28 + 2 * half + 2


def b34_ops_per_sample(sps: int, half: int) -> int:
    """As B1's, with the power of an f32 pair taking 2 (no int8 scaling)."""
    return b1_ops_per_sample(sps, half) - 2


def b5p_ops_per_sample(sps: int) -> int:
    """B5p's: B1's without the NMS and with 5 quiet chips of 12 (the quiet
    maximum 4 maxima, not 11)."""
    return 4 + 7 + (sps if sps > 1 else 0) + 27 - 7


def b6_ops_per_sample(sps: int, half: int) -> int:
    """B6's: B3/B4's, the reference level's FMA form taking one more at
    sps > 1 (a product and 3 FMAs before the final scale, not an FMA and
    2 adds)."""
    return b34_ops_per_sample(sps, half) + (1 if sps > 1 else 0)


# --- the probes (airmodes_torch/probes/) -------------------------------------

def copy_probe_cost(rows: int, lanes: int = 128) -> Tuple[int, int]:
    """(bytes, f32 instructions) of P1, y = x + 1 over (rows, lanes) f32:
    x read and y written once, one add per element."""
    return 2 * rows * lanes * 4, rows * lanes


def read_probe_cost(rows: int, lanes: int = 128, wrows: int = 144,
                    out_rows: int = 8) -> Tuple[int, int]:
    """(bytes, f32 instructions) of P2 and P3: the rows // wrows windows
    read once (the last rows % wrows rows are not read), out_rows rows
    written per window, wrows - 1 adds per column of a window."""
    steps = rows // wrows
    return (steps * (wrows + out_rows) * lanes * 4,
            steps * (wrows - 1) * lanes)


def floor_probe_bytes(channels: int, planar_len: int, tiles: int,
                      nchunk: int, cand_rows: int = 8) -> int:
    """Bytes of P5, B1's loads with no rule: the planar int8 I and Q rows
    read once, each tile's (cand_rows, 128) int32 block and each chunk's
    one-word OR written. It does no f32 arithmetic."""
    return (2 * channels * planar_len
            + channels * tiles * (cand_rows * 128 + nchunk) * 4)


def ablate_probe_instr(samples: int, stages: int, sps: int,
                       half: int) -> int:
    """f32 instructions charged to P4's cut after `stages`: B4's count at
    stage 5 (the whole kernel); the cuts before count bytes only."""
    return samples * b34_ops_per_sample(sps, half) if stages >= 5 else 0
