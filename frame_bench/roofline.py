"""The work two hand kernels must do for a frame, and their least time on
one H100.

The work is counted from what the frame's own inputs need, not from how a
kernel lays its data out: each input byte read once, each output byte
written once, and the f32 operations the stage's arithmetic needs, with
the sizes taken from the frame's diagnostics vector (`Renderer.last_diag`:
virtual lines, runs, virtual units, fold depth, segments, damaged tiles)
and its size in tiles.  The same count then holds whatever implements the
stage.  The least time is the larger of the bytes over the peak memory
bandwidth and the operations over the peak f32 rate, NVIDIA's published
figures for the H100 SXM (80 GB HBM3) at its full 700 W: a card set to a
lower power limit reads a lower share (the run records its limit).
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_F32_FLOP_PER_S = 67e12  # f32 outside the tensor cores
TILE = 16
PIXELS = TILE * TILE

# The diagnostics vector's entries.
DIAG_VLINES, DIAG_RUNS, DIAG_VIRT, DIAG_K, DIAG_SEGS, DIAG_DMG = range(6)

# Paint, per unit (one layer in one tile) and pixel: the fill rule's
# coverage from the area, the carried cover and the cover prefix (7
# operations), and the Over compositing equation on four channels (22).
FOLD_FLOP_PER_UNIT_PIXEL = 7 + 22


def tiles(width: int, height: int) -> int:
    return -(-width // TILE) * -(-height // TILE)


def fold_work(diag, width: int, height: int):
    """(bytes, f32 operations) of the paint fold (K3) on a solid-fill frame.

    Reads: each run's packed area|cover grid once (256 i32), each unit's
    carried cover row (16 i32) and its run index (1 i32), each run's solid
    colour (4 f32), the clear colour; writes: every tile's linear RGBA
    pixels (f32).  Units are the runs and the virtual units (layers that
    cover a tile without a segment in it), as counted before the
    occlusion cull: the cull's drops are over-counted."""
    runs, virt = int(diag[DIAG_RUNS]), int(diag[DIAG_VIRT])
    units = runs + virt
    reads = runs * PIXELS * 4 + units * (TILE * 4 + 4) + runs * 16 + 16
    writes = tiles(width, height) * PIXELS * 16
    return reads + writes, units * PIXELS * FOLD_FLOP_PER_UNIT_PIXEL


def grid_work(diag):
    """(bytes, f32 operations) of the run grids (K2): reads each segment's
    run, cell, area and cover (4 i32) and each run's sort key (2 i64);
    writes each run's packed grid (256 i32), its cover row sums (16 i32)
    and its key.  Integer work only."""
    segs, runs = int(diag[DIAG_SEGS]), int(diag[DIAG_RUNS])
    return segs * 16 + runs * (16 + PIXELS * 4 + TILE * 4 + 16), 0


def least_seconds(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S)
