"""Device milliseconds a frame of the kernels the compositor launched: the
traced kernels whose launching Python stack passes through the port's
``compositor/`` or ``ops/compositor.py``, over the traced frames."""
PATHS = ("transflow_tpu_torch/compositor/",
         "transflow_tpu_torch/ops/compositor.py")


def read(ctx):
    seconds = ctx.trace.launched_from(*PATHS)
    return 1e3 * seconds / ctx.trace.frames if seconds > 0 else None
