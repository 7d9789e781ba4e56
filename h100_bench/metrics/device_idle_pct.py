"""The share of the traced window in which no kernel, copy or set ran on
the card; at a fixed arrival rate it holds the gaps between frames."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
