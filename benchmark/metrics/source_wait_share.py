"""source_wait_share (%): the share of the host's framing time in which the
source had no block ready: the `airmodes.source_wait` spans over the
`airmodes.frame` spans that hold them, both clipped to the traced window
and summed over its threads (`benchmark/spans.py`)."""

from benchmark.spans import spans, total_ms


def read(ctx):
    found = spans(ctx.trace)
    frame, n = total_ms(found, "airmodes.frame")
    if not n or frame <= 0:
        return None
    wait, _ = total_ms(found, "airmodes.source_wait")
    return 100.0 * wait / frame
