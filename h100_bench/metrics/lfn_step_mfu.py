"""The whole LiteFlowNet step's share of the card's bf16 peak: the
operations a frame of its convolutions and correlation need at the
network's input size (``rooflines.lfn_flops``), times the frames a second
the traced run's window completed, over 989 TFLOP/s (dense bf16, the H100
SXM data sheet; the run prints the card's power limit beside it)."""
from h100_bench import rooflines


def read(ctx):
    t = ctx.traffic
    ph, pw = rooflines.lfn_size(t["height"], t["width"],
                                ctx.config["cv_config"].get("lfn_scale", 1.0))
    fps = ctx.window["frames"] / ctx.window["seconds"]
    return 100.0 * rooflines.lfn_flops(ph, pw) * fps / rooflines.BF16_FLOPS
