"""resample_roofline (%): the resampler of the fused step
(resample/fused.py, resample/polyphase.py) against the roofline of the
polyphase FIR it implements. Its kernels are the ones one call of the
resampler alone launched at set-up (`ctx.resampler_kernels`, in order);
in each replay of the fused step (its device events share one
correlation) the first events of those names are the resampler's. The
bound of one step counts what the FIR needs for the rows the demod reads,
whatever implements it: for each of the 2 * C planes, W = left halo +
block + right halo outputs of `taps` multiply-adds each (one f32
instruction), its q * (W - 1) + taps input samples read once and its W
outputs written once, as f32."""

from collections import Counter

from benchmark.frozen import opcount
from benchmark.frozen.config import DspConfig


def read(ctx):
    tr = ctx.trace
    res = ctx.config.get("resampler")
    if tr is None or not res or not ctx.resampler_kernels:
        return None
    want = Counter(ctx.resampler_kernels)
    t_sum, steps = 0.0, 0
    for events in tr.by_correlation().values():
        left = Counter(want)
        picked = []
        for name, a, b, _, cat in events:
            if cat == "kernel" and left[name] > 0:
                left[name] -= 1
                picked.append(b - a)
        if not +left:
            t_sum += sum(picked) * 1e-6
            steps += 1
    if not steps or t_sum <= 0:
        return None
    cfg = DspConfig(**ctx.config["dsp"])
    w = cfg.left_halo + cfg.block_size + cfg.right_halo
    planes = 2 * ctx.rows_per_call
    taps, q = res["taps"], res["q"]
    n_bytes = planes * 4 * ((q * (w - 1) + taps) + w)
    n_instr = planes * w * taps
    bound_ms, _ = opcount.bound(n_bytes, n_instr)
    return 100.0 * steps * bound_ms * 1e-3 / t_sum
