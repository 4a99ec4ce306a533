"""K2: per-run packed area|cover grids from the run-sorted segment stream.

Counterpart of `forma_tpu/ops/grid_pallas.py:272-343` (`grid_build_pallas`
with keys) and the scatter it replaces (`forma_tpu/ops/runs.py:53-96`).
Outputs, for every run r:

- grid[r, cell]: sum of area * 65536 + cover over r's segments in that
  cell, as a packed i32 (exact in any summation order: packed
  two's-complement sums equal the packing of the sums, and per-cell sums
  stay within i16, the bound the reference's tile accumulators rely on);
- rowcov[r, row]: the per-pixel-row sums of the cover half;
- runkeys[r] = (key_hi, key_lo) of r's first segment.

Rows past the last run are zero.  The CUDA kernel (`csrc/grid.cu`) runs
one thread per segment with integer atomics.
"""

from __future__ import annotations

import torch

from . import _build
from ._u32 import wrap_i32

NCELL = 256  # cells per run (16x16 tile)


def unpack_grid(grid: torch.Tensor):
    """packed i32 grid -> (area, cover) i32: the high and low 16 bits,
    both sign-extended (`forma_tpu/ops/runs.py:116-121`)."""
    g = grid.to(torch.int32)
    cover = ((g.long() & 0xFFFF) ^ 0x8000) - 0x8000
    area = wrap_i32(g.long() - cover) >> 16
    return area, cover.to(torch.int32)


def grid_build(rid, cell, area, cover, key_hi, key_lo, run_cap: int):
    """rid i32 [N] nondecreasing, gapless, clamped < run_cap; cell i32 [N]
    in [0, 256); area, cover i32 [N] (padding contributes 0); key_hi,
    key_lo int64 [N] per-segment keys, constant within a run.  Returns
    (grid i32 [run_cap, 256], rowcov i32 [run_cap, 16], runkeys int64
    [run_cap, 2]).  CUDA tensors launch `forma_grid`; CPU tensors take
    `grid_build_torch`."""
    if not rid.is_cuda:
        return grid_build_torch(rid, cell, area, cover, key_hi, key_lo, run_cap)
    n = rid.shape[0]
    for name, t in (("rid", rid), ("cell", cell), ("area", area), ("cover", cover)):
        _build.check(t, name, torch.int32, (n,))
    _build.check(key_hi, "key_hi", torch.int64, (n,))
    _build.check(key_lo, "key_lo", torch.int64, (n,))
    dev = rid.device
    grid = torch.zeros((run_cap, NCELL), dtype=torch.int32, device=dev)
    rowcov = torch.zeros((run_cap, 16), dtype=torch.int32, device=dev)
    runkeys = torch.zeros((run_cap, 2), dtype=torch.int64, device=dev)
    if n:
        _build.launch(
            "forma_grid", "grid",
            rid.data_ptr(), cell.data_ptr(), area.data_ptr(), cover.data_ptr(),
            key_hi.data_ptr(), key_lo.data_ptr(), n, run_cap,
            grid.data_ptr(), rowcov.data_ptr(), runkeys.data_ptr(),
        )
    return grid, rowcov, runkeys


def grid_build_torch(rid, cell, area, cover, key_hi, key_lo, run_cap: int):
    """Plain PyTorch version of `grid_build`: the XLA scatter of
    `runs._build_grid` (`forma_tpu/ops/runs.py:88-96`) plus first-of-run
    keys (a run's first segment is where rid steps up)."""
    dev = rid.device
    ridl = rid.long()
    val = area.long() * 65536 + cover.long()
    flat = torch.zeros(run_cap * NCELL, dtype=torch.int64, device=dev)
    flat.index_add_(0, ridl * NCELL + cell.long(), val)
    grid = wrap_i32(flat).reshape(run_cap, NCELL)
    _, cov = unpack_grid(grid)
    rowcov = cov.reshape(run_cap, 16, 16).sum(dim=2, dtype=torch.int32)

    first = torch.ones_like(rid, dtype=torch.bool)
    first[1:] = rid[1:] != rid[:-1]
    runkeys = torch.zeros((run_cap, 2), dtype=torch.int64, device=dev)
    runkeys[ridl[first]] = torch.stack([key_hi[first], key_lo[first]], dim=1)
    return grid, rowcov, runkeys
