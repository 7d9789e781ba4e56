"""The whole Farneback step's share of the card's float32 peak: the
operations a frame of B1, B2a, B2b, B8, B15 and K1's draw need at the
cell's shapes (``rooflines``), times the frames a second the traced run's
window completed, over 67 TFLOP/s."""
from h100_bench import rooflines


def read(ctx):
    t = ctx.traffic
    cv = ctx.config["cv_config"]
    factor = ctx.config["layers"][0].get("reset_random_factor", 0.0)
    ops = sum(o for _, o in rooflines.fb_bounds(t["height"], t["width"],
                                                cv).values())
    ops += rooflines.comp_bounds(t["height"], t["width"], factor)["K1"][1]
    fps = ctx.window["frames"] / ctx.window["seconds"]
    return 100.0 * ops * fps / rooflines.F32_FLOPS
