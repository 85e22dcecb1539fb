"""b1_roofline (%): kernel B1 (kernels/csrc/detect_cands.cu: its
detect kernel and its unordered merge, by name in the trace) against its
roofline. The bound of one call over C rows of the planar layout is the
larger of its bytes over the card's memory rate (the int8 I and Q rows
read once, the candidate blocks written once) and its f32 instructions
over the card's f32 rate (the frozen operation count per owned sample),
with the data sheet's peaks (`frozen/opcount.py`); the share is the calls'
bound over their device time."""

from benchmark.frozen import layout, opcount
from benchmark.frozen.config import DspConfig

DETECT = "detect_chunk_kernel"
MERGE = "merge_unordered_kernel"


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    t_detect, calls = tr.device_time(lambda n: DETECT in n)
    t_merge, _ = tr.device_time(lambda n: MERGE in n)
    if not calls or t_detect + t_merge <= 0:
        return None
    cfg = DspConfig(**ctx.config["dsp"])
    rows = ctx.rows_per_call
    tile = layout.default_tile(cfg)
    tiles = cfg.block_size // tile
    n_bytes = rows * (2 * layout.planar_length(cfg) + tiles * 8 * 128 * 4)
    n_instr = rows * cfg.block_size * opcount.b1_ops_per_sample(
        cfg.sps, cfg.nms_chips * cfg.sps)
    bound_ms, _ = opcount.bound(n_bytes, n_instr)
    return 100.0 * calls * bound_ms * 1e-3 / (t_detect + t_merge)
