"""transforms_ms: host ms a traced frame in the program's span
`forma.transforms`: the scene update inside the program
(`Layer.set_transform`, `Composition.set_transforms`)."""

from frame_bench import program


def read(ctx):
    return program.span_ms(ctx, "transforms")
