"""The compositor's kernels' share of their roofline: the summed least
times of K1 (the moveref layer's update) and K2 (the composite) at the
frame's size (``rooflines.comp_bounds``) over their summed traced time; a
kernel the trace does not show counts neither."""
from h100_bench import rooflines


def read(ctx):
    t = ctx.traffic
    factor = ctx.config["layers"][0].get("reset_random_factor", 0.0)
    return rooflines.share(ctx.trace,
                           rooflines.comp_bounds(t["height"], t["width"],
                                                 factor),
                           ctx.trace.frames)
