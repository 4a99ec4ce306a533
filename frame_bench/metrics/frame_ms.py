"""frame_ms: the window's length over the frames completed in it, in ms
(host clock; a frame runs from its scene update to its pixels on the
host)."""


def read(ctx):
    return 1e3 * ctx.window_s / ctx.frames
