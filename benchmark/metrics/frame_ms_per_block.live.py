"""frame_ms_per_block.live (ms): the host's framing time per block in the
open-loop cell, as `frame_ms_per_block.replay` reads it: the self time of
the `airmodes.frame` spans of the framer pool's threads (the wait for the
live source's samples, `airmodes.source_wait`, left out) over their
count in the traced window (`benchmark/spans.py`)."""

from benchmark.spans import mean_ms


def read(ctx):
    return mean_ms(ctx.trace, "airmodes.frame", self_time=True)
