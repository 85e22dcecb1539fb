"""result_wait_share (%): the share of the traced window in which the
native runners' caller was blocked on their dispatch queue, waiting on the
framer and the dispatch: the `airmodes.result_wait` spans, clipped to the
window, over its length (`benchmark/spans.py`). The fused runner has no
such queue."""

from benchmark.spans import spans, total_ms


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.t1 <= tr.t0:
        return None
    wait, n = total_ms(spans(tr), "airmodes.result_wait")
    if not n:
        return None
    return 100.0 * wait * 1e3 / (tr.t1 - tr.t0)
