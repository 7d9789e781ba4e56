"""Farneback's kernels' share of their roofline: the summed least times
of B1, B2a, B2b, B8 and B15 at the cell's shapes (``rooflines.fb_bounds``)
over their summed traced time; a kernel the trace does not show counts
neither."""
from h100_bench import rooflines


def read(ctx):
    t = ctx.traffic
    bounds = rooflines.fb_bounds(t["height"], t["width"],
                                 ctx.config["cv_config"])
    return rooflines.share(ctx.trace, bounds, ctx.trace.frames)
