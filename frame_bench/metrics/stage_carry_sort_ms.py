"""stage_carry_sort_ms: mean device ms a frame in the pipeline stage
`carry_sort`, which only the two-key route runs: the runs re-sorted from
(row, tile_x, layer) into carry-chain (row, layer, tile_x) order, and
their keys and cover rows gathered along.  The program's own stage stamps
inside the frame graph (`forma_tpu_torch.tracing`), over every frame it
rendered; 0 where no frame took the route."""

from frame_bench import two_key


def read(ctx):
    return two_key.stage_ms("carry_sort")
