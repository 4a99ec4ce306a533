"""Device pipeline stages of the port, module by module beside
`forma_tpu/ops/`:

  line_setup     elementwise PyTorch over the line arrays + prefix sum
  expand_kernel  K1: per-line params onto virtual lines (csrc/expand.cu)
  rasterize_kernel
                 K4: K1 fused with the ff64 emit of packed segment keys
                 and payloads (csrc/rasterize.cu); the two-key emit of
                 int64 keys from K1's output (same source); the emit's
                 plain version
  rasterize      the packed route (K4) or the two-key route (K1 + the
                 two-key emit), then one torch.sort
  grid_kernel    K2: per-run area|cover grids and run keys (csrc/grid.cu)
  scan           the prefix scans (max, sum; segmented, reversed) of runs
                 and paint (csrc/scan.cu)
  runs           run extraction, cover-carry chains, paint units
  fold_kernel    K3: the per-tile paint fold (csrc/fold.cu), in four
                 specialisations: solid/Over, styled (gradients and blend
                 modes), textured (texture fills sampled in the fold), clip
  paint          style rows, fill (gradient, texture) and blend trees,
                 occlusion and trivial-clip passes, the fold dispatch
  srgb           linear -> sRGB + channel mapping + u8 pack
  pipeline       the whole frame with capacity buckets and diagnostics

u32 quantities are int64 tensors (`_u32.py`); `_build.py` compiles and
loads the kernels and counts their launches.
"""
