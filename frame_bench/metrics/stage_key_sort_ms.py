"""stage_key_sort_ms: mean device ms a frame in the pipeline stage
`key_sort`, which only the two-key route runs: the segments' one int64
sort by (key_hi, key_lo), their payloads gathered along, and its unpack.
The program's own stage stamps inside the frame graph
(`forma_tpu_torch.tracing`), over every frame it rendered; 0 where no
frame took the route."""

from frame_bench import two_key


def read(ctx):
    return two_key.stage_ms("key_sort")
