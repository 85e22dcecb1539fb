"""device_idle_share (%): the share of the traced window in which no
kernel, copy or memset ran on the card (one minus the union of the device
events' intervals over the window)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
