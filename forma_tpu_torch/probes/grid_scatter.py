"""K9: the scatter probe (`tools/pallas_scatter_probe.py:run`).

    python -m forma_tpu_torch.probes.grid_scatter

The TPU probe asked how fast a kernel accumulates a stream of segments
into a [256, 256] i32 window, acc[row, cell] += val, one read-modify-write
per segment: the question of K2's untried shared-memory run window.  The
kernel (`csrc/grid_scatter.cu`, counter "grid_scatter") holds the 256 KB
window in the distributed shared memory of a thread-block cluster of
`CLUSTER` = 2 CTAs, each owning 128 rows; each of `cluster_count(n)`
clusters reads its share of the segments once and adds each one into the
rank that owns its row, then reduces its window into the output (zeroed
by a memset queued before the kernel) with bulk reductions in L2: exact
in any order, one launch, no scratch.  Segments whose row or cell lies
outside [0, 256) add nothing.  What bounds it: the remote adds and the
clusters' windows reduced in L2 (256 KB each); it reads the segments
once.  Larger clusters lost on the card (a remote add beyond a pair costs
several times as much); the design before clusters, two bands of 128 rows
whose chunks' windows a second kernel summed, reading each segment twice,
is faster there by CUDA graph (`PERF.md` section 6).

Two input modes, from a numpy seed, 2^20 segments as the tool's:
`independent` draws row, cell and val apart; `probe` has row == cell,
the pattern the tool's inputs really had (all three came from one PRNG
key at one shape, so its 2^20 segments hit the 256 diagonal cells only),
the worst contention.  val lies in [-1000, 1000) in both.

`grid_scatter` launches the kernel for CUDA tensors and takes
`grid_scatter_torch` for CPU tensors.  The entry point needs a CUDA card
and does not fall back to the CPU; it prints M segments/s for each mode
and, beside them, K2's rate on the real paris-30k frame.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import _build
from . import time_ms_graph
from .texture_fold import time_ms

WINDOW = 256  # rows (pallas_scatter_probe.py:WINDOW)
CELLS = 256
BAND_ROWS = 128  # rows per band of the plain version
N = 1 << 20  # segments (pallas_scatter_probe.py:100, run(20))
MODES = ("independent", "probe")
CLUSTER = 2  # CTAs per cluster (csrc/grid_scatter.cu: kCluster)
CLUSTERS = 64  # clusters of a full launch: 128 CTAs, one on each of ~all 132 SMs
SEGMENTS_PER_CTA = 4096  # the least share of a CTA before clusters are cut


def scatter_inputs(mode: str, n: int = N, seed: int = 0):
    """(row, cell, val) i32 [n] each: row and cell in [0, 256), val in
    [-1000, 1000); `probe` sets cell = row."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    rng = np.random.default_rng(seed)
    row = rng.integers(0, WINDOW, size=n).astype(np.int32)
    cell = row.copy() if mode == "probe" else rng.integers(0, CELLS, size=n).astype(np.int32)
    val = rng.integers(-1000, 1000, size=n).astype(np.int32)
    return torch.from_numpy(row), torch.from_numpy(cell), torch.from_numpy(val)


def cluster_count(n: int) -> int:
    """Clusters of a launch over n segments: CLUSTERS, fewer where a CTA's
    share would fall below SEGMENTS_PER_CTA, and at least one."""
    return max(1, min(CLUSTERS, -(-n // (CLUSTER * SEGMENTS_PER_CTA))))


def grid_scatter(row, cell, val):
    """row, cell, val i32 [n]; returns acc i32 [256, 256] with acc[row,
    cell] += val.  CUDA tensors (16-byte aligned: the kernel loads int4
    vectors) launch `forma_grid_scatter` over `cluster_count(n)` clusters;
    CPU tensors take `grid_scatter_torch`."""
    if row.dim() != 1:
        raise ValueError(f"row: expected a vector, got shape {tuple(row.shape)}")
    n = row.shape[0]
    check = _build.check if row.is_cuda else _build.check_shape
    for t, name in ((row, "row"), (cell, "cell"), (val, "val")):
        check(t, name, torch.int32, (n,))
    if not row.is_cuda:
        return grid_scatter_torch(row, cell, val)
    for t, name in ((row, "row"), (cell, "cell"), (val, "val")):
        _build.check_aligned(t, name, 16)
    out = torch.empty((WINDOW, CELLS), dtype=torch.int32, device=row.device)
    _build.launch("forma_grid_scatter", "grid_scatter", row.data_ptr(), cell.data_ptr(),
                  val.data_ptr(), n, cluster_count(n), out.data_ptr())
    return out


def grid_scatter_torch(row, cell, val):
    """Plain PyTorch version, band by band as the kernel splits the window:
    an int32 scatter-add of each band's segments."""
    out = torch.zeros((WINDOW, CELLS), dtype=torch.int32, device=row.device)
    ok = (row >= 0) & (row < WINDOW) & (cell >= 0) & (cell < CELLS)
    for b in range(WINDOW // BAND_ROWS):
        sel = ok & (row // BAND_ROWS == b)
        idx = (row[sel] - b * BAND_ROWS).long() * CELLS + cell[sel].long()
        out[b * BAND_ROWS:(b + 1) * BAND_ROWS].view(-1).scatter_add_(0, idx, val[sel])
    return out


def measure(device="cuda") -> dict:
    """Device time of both modes on `device` (a card; CUDA graph
    replays); returns {mode: ms}."""
    res = {}
    for mode in MODES:
        row, cell, val = (t.to(device) for t in scatter_inputs(mode))
        res[mode] = time_ms_graph(lambda: grid_scatter(row, cell, val))
    return res


def k2_paris_rate(device="cuda") -> tuple:
    """(segments, ms) of K2 on one paris-30k@1080p frame's own inputs."""
    from ..ops import grid_kernel as gk
    from . import paris_taps

    args = paris_taps(device)["grid"]
    return args[0].numel(), time_ms(lambda: gk.grid_build(*args))


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("grid_scatter: no CUDA card; this probe times the card")
    res = measure()
    print(f"card: {torch.cuda.get_device_name(0)}; {cluster_count(N)} clusters of {CLUSTER}")
    for mode in MODES:
        print(f"{N} segments, {mode:12s} {res[mode]:8.4f} ms -> "
              f"{N / res[mode] / 1e3:8.0f} M segments/s")
    segs, ms = k2_paris_rate()
    print(f"K2 grid on paris-30k@1080p: {segs} segment slots in {ms:8.4f} ms -> "
          f"{segs / ms / 1e3:8.0f} M segments/s")


if __name__ == "__main__":
    main()
