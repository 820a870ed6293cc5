"""Share of the profiled sub-window in which no operation ran on the
device, %."""


def read(ctx):
    p = ctx.prof
    if p is None or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
