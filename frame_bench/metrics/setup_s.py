"""setup_s: seconds from the harness's start to the window's: imports,
the kernel library, the scene's generation and composition, the
renderer, and the warm-up frames (host clock)."""


def read(ctx):
    return ctx.setup_s
