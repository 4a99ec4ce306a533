"""The roofline's work counts, by hand, for a frame of two tiles."""

import pytest

from frame_bench import roofline


def diag(runs, virt, segs):
    d = [0] * 6
    d[roofline.DIAG_RUNS], d[roofline.DIAG_VIRT], d[roofline.DIAG_SEGS] = runs, virt, segs
    return d


def test_two_tile_frame():
    # 32x16 pixels: 2 tiles.  3 runs (3 grid rows), 1 virtual unit, 10 segments.
    d = diag(runs=3, virt=1, segs=10)
    fold_bytes, fold_flop = roofline.fold_work(d, 32, 16)
    grids = 3 * 256 * 4          # each run's packed grid row, read once
    carries = 4 * (16 * 4 + 4)   # each unit's carried cover row and run index
    colours = 3 * 16 + 16        # each run's solid colour, the clear colour
    pixels = 2 * 256 * 4 * 4     # every tile's RGBA f32 pixels, written once
    assert fold_bytes == grids + carries + colours + pixels == 11600
    assert fold_flop == 4 * 256 * 29
    grid_bytes, grid_flop = roofline.grid_work(d)
    assert grid_bytes == 10 * 16 + 3 * (16 + 1024 + 64 + 16) == 3520 and grid_flop == 0
    # 11,600 bytes at 3.35 TB/s take longer than 29,696 f32 operations at 67 TFLOP/s.
    assert roofline.least_seconds(fold_bytes, fold_flop) == pytest.approx(11600 / 3.35e12)
    assert roofline.least_seconds(0, 67e12) == pytest.approx(1.0)


def test_partial_tiles_count_whole():
    assert roofline.tiles(1920, 1080) == 120 * 68
    assert roofline.tiles(17, 1) == 2
