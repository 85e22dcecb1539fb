"""frame_ms_per_block.replay (ms): the host's framing time per block in the
closed-loop cells: the self time of the port's `airmodes.frame` spans (the
native framer's call on its feeder or pool thread, or the fused runner's
raw windowing on the caller's; a wait for the source's samples,
`airmodes.source_wait`, left out), summed over the traced window and over
the count of `airmodes.frame` spans (`benchmark/spans.py`)."""

from benchmark.spans import mean_ms


def read(ctx):
    return mean_ms(ctx.trace, "airmodes.frame", self_time=True)
