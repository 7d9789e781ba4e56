"""Host milliseconds a frame inside the Engine's step
(``Engine.process_chunk`` or ``process_frame``): the host clock around
each call of the window (which returns before the card finishes),
summed, over the window's frames. Where it nears the card's
time a frame, the host sets the pace."""


def read(ctx):
    window = ctx.window
    return 1e3 * window["host_s"] / window["frames"] if window["frames"] \
        else None
