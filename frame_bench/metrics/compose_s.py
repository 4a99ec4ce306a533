"""compose_s: seconds the program takes to compose the scene through its
public API (`PathBuilder`, `Layer.insert`, `set_props`), a host-clock
span in the harness around the calls."""


def read(ctx):
    return ctx.compose_s
