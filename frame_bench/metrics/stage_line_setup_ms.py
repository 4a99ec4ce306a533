"""stage_line_setup_ms: mean device ms a frame in the pipeline stage
`line_setup`: line setup: the lines transformed, culled and measured,
their virtual-line ends.  The program's own stage stamps inside the frame
graph (`forma_tpu_torch.tracing`), over every frame it rendered."""

from frame_bench import program


def read(ctx):
    return program.stage_ms("line_setup")
