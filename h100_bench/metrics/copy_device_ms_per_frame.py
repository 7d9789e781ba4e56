"""Device milliseconds a frame of copies (the frames' uploads and the
rendered frames' read-backs, and any copy the program makes) in the
trace, over the traced frames."""


def read(ctx):
    seconds = ctx.trace.seconds("memcpy")
    return 1e3 * seconds / ctx.trace.frames if seconds > 0 else None
