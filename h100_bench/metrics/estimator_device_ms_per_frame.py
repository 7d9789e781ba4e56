"""Device milliseconds a frame of the kernels the estimator launched: the
traced kernels whose launching Python stack passes through the port's
``flow/estimators/``, over the traced frames."""
PATHS = ("transflow_tpu_torch/flow/estimators/",)


def read(ctx):
    seconds = ctx.trace.launched_from(*PATHS)
    return 1e3 * seconds / ctx.trace.frames if seconds > 0 else None
