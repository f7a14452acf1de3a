"""``idle_share``: the share of the traced window (whole rounds, after a
synchronisation at each end) in which no device operation ran, in %:
100 · (1 − the union of the operations' intervals / the window)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
