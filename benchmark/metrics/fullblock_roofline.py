"""fullblock_roofline (%): the native int8 runners' step outside the planar
gate (the full-block demod path on the planar rows, one captured graph a
step) against the roofline of the rule it implements, whatever implements
it. Its device time: the kernels of each whole graph replay launched
inside the port's `airmodes.full_block` span (`benchmark/fullblock.py`;
copies and memsets left out), summed. The bound of one step over C rows
is the larger of its bytes over the card's memory rate (each row's L+N+R
int8 I and Q samples read once, its (K+1, 9) int32 table written once)
and its f32 instructions over the card's f32 rate (the frozen count per
owned sample of the detect rule, at the configuration's sps), with the
data sheet's peaks (`frozen/opcount.py`); the share is the steps' bound
over their summed kernel time. A trace without the span (a program that
lacks it) gives nothing to read."""

from benchmark.frozen import opcount
from benchmark.frozen.config import DspConfig
from benchmark.fullblock import replays


def read(ctx):
    found = replays(ctx.trace)
    t_sum = sum(b - a for events in found
                for _, a, b, _, cat in events if cat == "kernel") * 1e-6
    if not found or t_sum <= 0:
        return None
    cfg = DspConfig(**ctx.config["dsp"])
    rows = ctx.rows_per_call
    T = cfg.left_halo + cfg.block_size + cfg.right_halo
    n_bytes = rows * (2 * T + (cfg.max_detections + 1) * 9 * 4)
    n_instr = rows * cfg.block_size * opcount.b1_ops_per_sample(
        cfg.sps, cfg.nms_chips * cfg.sps)
    bound_ms, _ = opcount.bound(n_bytes, n_instr)
    return 100.0 * len(found) * bound_ms * 1e-3 / t_sum
