"""table_ms_per_block (ms): the host's time to turn one block's table into
wire messages: the mean length of the port's `airmodes.decode` spans
(`unpack_table` and `table_to_messages` of one row), clipped to the traced
window (`benchmark/spans.py`)."""

from benchmark.spans import mean_ms


def read(ctx):
    return mean_ms(ctx.trace, "airmodes.decode")
