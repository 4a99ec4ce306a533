"""Device pipeline stages of the port, module by module beside
`forma_tpu/ops/`:

  line_setup     elementwise PyTorch over the line arrays + prefix sum
  expand_kernel  K1: per-line params onto virtual lines (csrc/expand.cu)
  rasterize      ff64 grid-crossing math, packed keys, one torch.sort
  grid_kernel    K2: per-run area|cover grids and run keys (csrc/grid.cu)
  runs           run extraction, cover-carry chains, paint units
  fold_kernel    K3: the per-tile paint fold (csrc/fold.cu)
  paint          occlusion culling + the fold dispatch
  srgb           linear -> sRGB + channel mapping + u8 pack
  pipeline       the whole frame with capacity buckets and diagnostics

u32 quantities are int64 tensors (`_u32.py`); `_build.py` compiles and
loads the kernels and counts their launches.
"""
