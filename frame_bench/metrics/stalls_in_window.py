"""stalls_in_window: frame-graph captures plus bucket regrows during the
window, the program's own counters (`Renderer.graphs.captures`,
`Renderer.regrow_count`): each is a frame that stalls to capture or to
render again with larger buckets."""


def read(ctx):
    return ctx.stalls
