"""fetch_ms_per_step (ms): the caller's wait on the card per step, as the
host sees it: the mean length of the port's `airmodes.fetch` spans (one
step's `.cpu()` of its packed tables, and of the fused step's gains),
clipped to the traced window (`benchmark/spans.py`)."""

from benchmark.spans import mean_ms


def read(ctx):
    return mean_ms(ctx.trace, "airmodes.fetch")
