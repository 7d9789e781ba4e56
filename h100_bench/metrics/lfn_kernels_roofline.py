"""LiteFlowNet's hand-written kernels' share of their roofline: the
summed least times of A1, B7, B16, B17 and B18 at the network's input
size (``rooflines.lfn_bounds``) over their summed traced time; a kernel
the trace does not show counts neither. cuDNN's convolutions are not
among them: ``lfn_step_mfu`` covers them."""
from h100_bench import rooflines


def read(ctx):
    t = ctx.traffic
    ph, pw = rooflines.lfn_size(t["height"], t["width"],
                                ctx.config["cv_config"].get("lfn_scale", 1.0))
    return rooflines.share(ctx.trace, rooflines.lfn_bounds(ph, pw),
                           ctx.trace.frames)
