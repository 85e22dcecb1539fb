"""decode_us_per_msg.replay (us/msg): the harness's span around the sink's
calls (the port's parse, then its SQLite insert) per message, over every
message that reached the sink in the traced window."""


def read(ctx):
    if not ctx.trace_mono or ctx.trace_mono[1] is None:
        return None
    a, b = ctx.trace_mono
    spans = [(e - s, n) for s, e, n in ctx.sink_spans if a <= s and e <= b]
    msgs = sum(n for _, n in spans)
    if not msgs:
        return None
    return 1e6 * sum(d for d, _ in spans) / msgs
