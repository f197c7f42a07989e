"""device_idle_pct (device, device trace): the share of the traced window
in which no kernel, copy or set ran on the device, in %."""


def read(ctx):
    s = ctx.summary
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
