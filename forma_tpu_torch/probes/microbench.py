"""K6 and K7: the Pallas kernels of the TPU microbenchmarks
(`tools/tpu_microbench2.py`, sections 7 and 8).

    python -m forma_tpu_torch.probes.microbench

K6, `unit_stream`: a stream of U units, each folding a [2, 128] coverage
block into its tile's 256 pixels in order,

    for u in 0 .. U-1:  out[tile_of[u]] = out[tile_of[u]] * (1 - c) + c,
                        c = cov[u]

with tile_of i32 [2^18] in [0, 2^10) and cov f32 [2^18, 2, 128] in
[0, 1); out f32 [2^11, 128] (tile t is rows 2t and 2t+1).  The TPU kernel
reads `out` before it ever writes it, so its result is undefined; here
every tile starts at 0.  The kernel (`csrc/microbench.cu`, counter
"unit_stream") folds the tiles in parallel, each tile's units in
increasing u: `group_units` groups them first (a stable sort of tile_of
and a search for each tile's first unit, prep timed on its own line by the
entry point), then
`unit_stream_grouped` launches the kernel.

K7, `seg_loop`: for each of S = 2^20 segments s in [0, 256),
acc[s // 128, s % 128] += 1.0; a 256-bin histogram as f32 [2, 128]
counts.  The kernel (counter "seg_loop") is one launch over a grid sized
to the card (`seg_blocks`): per-warp shared histograms with integer
atomics, each block's sums added into a persistent counter row, and the
last block (by a ticket) writes the f32 counts and zeroes the row and the
ticket for the next call.  The row is a workspace of 257 words kept per
(device, stream) and zeroed once, so a call allocates only its output and
the pointer stays fixed under CUDA-graph capture.  Exact in any order.
Values outside [0, 256) count nowhere (the TPU kernel's address would
leave its accumulator).  `launch_floor` launches an empty kernel, the
floor K7's time is judged against.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version (`*_torch`) for CPU tensors.  The entry point needs a CUDA card and
does not fall back to the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import _build
from . import time_ms_graph
from .texture_fold import time_ms

U = 1 << 18  # units (tpu_microbench2.py:139)
T = 1 << 10  # active tiles (:140)
S = 1 << 20  # segments (:171)
BINS = 256
# K7: the least share of a block, one int4 a thread (fewer blocks than SMs
# for short inputs).
MIN_SEGS_PER_BLOCK = 256 * 4
_WORKSPACES = {}  # (device index, stream) -> K7's int32 [257], zero between calls


def unit_inputs(u: int = U, t: int = T, seed: int = 0):
    """K6's inputs at the tool's ranges: tile_of i32 [u] in [0, t), cov f32
    [u, 2, 128] in [0, 1)."""
    rng = np.random.default_rng(seed)
    tile_of = rng.integers(0, t, size=u).astype(np.int32)
    cov = rng.random((u, 2, 128), dtype=np.float32)
    return torch.from_numpy(tile_of), torch.from_numpy(cov)


def seg_inputs(s: int = S, seed: int = 0):
    """K7's input: segs i32 [s] in [0, 256)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, BINS, size=s).astype(np.int32))


def group_units(tile_of, n_tiles: int):
    """(perm i32 [U], start i32 [n_tiles + 1]): unit ids grouped by tile,
    increasing u within a tile (a stable sort); tile t's units are
    perm[start[t]:start[t + 1]].  Values of tile_of outside [0, n_tiles)
    raise."""
    vals, perm = torch.sort(tile_of, stable=True)
    if vals.numel() and (int(vals[0]) < 0 or int(vals[-1]) >= n_tiles):
        raise ValueError(f"tile_of: values must lie in [0, {n_tiles})")
    tiles = torch.arange(n_tiles + 1, dtype=vals.dtype, device=vals.device)
    start = torch.searchsorted(vals, tiles)
    return perm.to(torch.int32), start.to(torch.int32)


def unit_stream(tile_of, cov, n_tiles: int = T):
    """tile_of i32 [U]; cov f32 [U, 2, 128]; returns out f32
    [2 * n_tiles, 128]: `group_units`, then `unit_stream_grouped`."""
    perm, start = group_units(tile_of, n_tiles)
    return unit_stream_grouped(perm, start, cov)


def unit_stream_grouped(perm, start, cov):
    """perm, start from `group_units`; cov f32 [U, 2, 128]; returns f32
    [2 * n_tiles, 128].  CUDA tensors launch `forma_unit_stream`; CPU
    tensors take `unit_stream_grouped_torch`."""
    n_units, n_tiles = cov.shape[0], start.shape[0] - 1
    check = _build.check if cov.is_cuda else _build.check_shape
    check(perm, "perm", torch.int32, (n_units,))
    check(start, "start", torch.int32, (n_tiles + 1,))
    check(cov, "cov", torch.float32, (n_units, 2, 128))
    if not cov.is_cuda:
        return unit_stream_grouped_torch(perm, start, cov)
    out = torch.empty((2 * n_tiles, 128), dtype=torch.float32, device=cov.device)
    if n_tiles > 0:
        _build.launch("forma_unit_stream", "unit_stream", perm.data_ptr(), start.data_ptr(),
                      cov.data_ptr(), n_tiles, out.data_ptr())
    return out


def unit_stream_grouped_torch(perm, start, cov):
    """Plain PyTorch version: step k folds the k-th unit of every tile
    that has one, all tiles at once."""
    n_tiles = start.shape[0] - 1
    lo = start[:-1].long()
    cnt = start[1:].long() - lo
    c = cov.reshape(-1, 256)
    out = torch.zeros((n_tiles, 256), dtype=torch.float32, device=cov.device)
    for k in range(int(cnt.max()) if n_tiles else 0):
        act = torch.nonzero(cnt > k).squeeze(1)
        ck = c[perm[lo[act] + k].long()]
        out[act] = out[act] * (1.0 - ck) + ck
    return out.reshape(2 * n_tiles, 128)


def seg_blocks(n: int, sms: int) -> int:
    """K7's grid over n segments on a card of `sms` SMs: one block a SM,
    fewer where a block would take under MIN_SEGS_PER_BLOCK, at least
    one."""
    return max(1, min(sms, -(-n // MIN_SEGS_PER_BLOCK)))


def _workspace(device) -> torch.Tensor:
    """K7's counter row and ticket for the current stream of `device`,
    allocated and zeroed at its first use there (the kernel leaves it
    zero)."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    ws = _WORKSPACES.get(key)
    if ws is None:
        ws = _WORKSPACES[key] = torch.zeros(BINS + 1, dtype=torch.int32, device=device)
    return ws


def seg_loop(segs):
    """segs i32 [S]; returns f32 [2, 128] counts of each value in [0,
    256).  CUDA tensors launch `forma_seg_loop` once, over `seg_blocks`;
    CPU tensors take `seg_loop_torch`."""
    if segs.dim() != 1:
        raise ValueError(f"segs: expected a vector, got shape {tuple(segs.shape)}")
    check = _build.check if segs.is_cuda else _build.check_shape
    check(segs, "segs", torch.int32, (segs.shape[0],))
    if not segs.is_cuda:
        return seg_loop_torch(segs)
    _build.check_aligned(segs, "segs", 16)
    n = segs.shape[0]
    sms = torch.cuda.get_device_properties(segs.device).multi_processor_count
    out = torch.empty((2, 128), dtype=torch.float32, device=segs.device)
    _build.launch("forma_seg_loop", "seg_loop", segs.data_ptr(), n,
                  seg_blocks(n, sms), _workspace(segs.device).data_ptr(),
                  out.data_ptr())
    return out


def launch_floor() -> None:
    """Launches one empty kernel on the current stream (no counter: it
    ports nothing)."""
    stream = torch.cuda.current_stream().cuda_stream
    rc = _build.lib().forma_empty(stream)
    if rc != 0:
        raise RuntimeError(f"forma_empty: CUDA error {rc}")


def seg_loop_torch(segs):
    """Plain PyTorch version: an int32 scatter-add of ones, then f32."""
    ok = (segs >= 0) & (segs < BINS)
    counts = torch.zeros(BINS, dtype=torch.int32, device=segs.device)
    counts.scatter_add_(0, segs[ok].long(), torch.ones_like(segs[ok]))
    return counts.to(torch.float32).reshape(2, 128)


def measure(device="cuda") -> dict:
    """Times K6 (grouping prep and kernel apart), K7 and the empty kernel
    (`launch_floor`) at the tool's sizes on `device` (a card); returns ms
    per call: the kernels' device time (CUDA graph replays), the prep's by
    calls queued back to back (its range check reads two values back to
    the host)."""
    tile_of, cov = (x.to(device) for x in unit_inputs())
    perm, start = group_units(tile_of, T)
    res = {
        "group_units": time_ms(lambda: group_units(tile_of, T)),
        "unit_stream": time_ms_graph(lambda: unit_stream_grouped(perm, start, cov)),
    }
    del cov
    segs = seg_inputs().to(device)
    res["seg_loop"] = time_ms_graph(lambda: seg_loop(segs))
    res["launch_floor"] = time_ms_graph(launch_floor)
    return res


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("microbench: no CUDA card; this probe times the card")
    res = measure()
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"unit_stream: {U} units over {T} tiles, [2, 128] each: "
          f"{res['unit_stream']:8.4f} ms ({U / res['unit_stream'] / 1e3:8.1f} M units/s); "
          f"grouping prep (stable sort + searchsorted): {res['group_units']:8.4f} ms")
    print(f"seg_loop: {S} segments into 256 bins: {res['seg_loop']:8.4f} ms "
          f"({S / res['seg_loop'] / 1e3:8.1f} M segments/s); "
          f"an empty kernel: {res['launch_floor']:8.4f} ms")


if __name__ == "__main__":
    main()
