"""frame_bench: the benchmark of `forma_tpu_torch` on one CUDA card.

One run renders one cell (a scene configuration under a traffic mix) in a
closed loop for a fixed window and prints one JSON line: the end-to-end
metrics (`--trace 0`) or the per-layer metrics (`--trace 1`), whether the
frames were correct against the plain reference in `reference/`, and the
device.  `python -m frame_bench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`; see README.md.
"""
