"""K8: the fold ablation (`tools/fold_kernel_ablate.py:run`).

    python -m forma_tpu_torch.probes.fold_ablate

The TPU tool copied the solid/Over paint fold with four pieces that
switch off one by one (the row loads, the carry expansion, the cover
prefix, the Over blend), to price each piece of a fold step.  Its inputs
are paris-shaped and synthetic (`tools/fold_kernel_bench.py`): ~324k
units over 8,160 tiles (68 rows of 120) in 255 blocks of 32, a unit
matrix u_mat i32 [U + window, 384] and per block a blkinfo row in
`paint_pallas`'s layout.  Tile t = 32 b + i folds the rows
START[b] + BASE0[b, i] + k, k < CNT[b, i], from the clear colour; per
pixel p of a row:

    g = row[p];  cover = (g << 16) >> 16;  area = (g - cover) >> 16
    exc = exclusive prefix of cover along p's 16-pixel row
    ce = row[256 + p // 16]        (what the byte-split one-hot dots give)
    da = 32 (ce + exc) + area
    cov = row[276] ? f32(512 - |(da & 1023) - 512|) * (1/512)
                   : clip(|f32(da) * (1/512)|, 0, 1)
    Over with fill = f32 bits of row[272:276]   ("no blend": dst[0] += cov)

Variants (`VARIANTS`): "no dots" sets ce = 0, "no rolls" exc = cover.
"no loads" is undefined in the tool (its `asm` scratch is never written
when loads are off); here the tile's first row is loaded once before the
loop and every step reads that held row (the kernel from shared memory,
through a volatile pointer, so the step's arithmetic stays in the loop).

The blkinfo layout is `paint_pallas`'s at TB = 32 (START, NCHUNK, KMAX,
then BASE0, CNT, X0, Y0 of 32 tiles each, 136 lanes); the tool's own
`BI` constant still describes TB = 8 and does not match its inputs.

The kernel (`csrc/fold_ablate.cu`, launch counter "fold_ablate") takes
K3 `fold`'s step, so that the pieces price the step K3 takes: one block a
tile, 128 threads of two pixels each, the cover prefix a 3-shuffle scan
of pair sums, and each chunk of units' carries, fill and rule staged in
shared memory.  `DESIGNS` are its ways of loading the rows: "direct"
reads each step's grid words from device memory as K3 does, the price of
K3's step; "tma16" copies the next chunk of 16 whole rows into shared
memory with one TMA bulk copy a row while the block folds the current
chunk.  "tma16" is the faster on the H100 and the default (`DESIGN`);
what bounds it is the rate of the step's instructions and the tail of the
deepest tiles.  Chunks of 32 or 8 rows, and the tiles folded deepest
first (a sort that costs more than it saves), lost there (`PERF.md`
section 6).

`fold_ablate` launches the kernel for CUDA tensors and takes
`fold_ablate_torch` for CPU tensors.  The entry point needs a CUDA card
and does not fall back to the CPU; it times every variant in both designs
and K3 `fold` on the real paris-30k frame, whose distance from its bound
is the question K8 serves.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import _build
from . import time_ms_graph
from .texture_fold import time_ms

# tools/fold_kernel_bench.py and forma_tpu/ops/paint_pallas.py constants
ROWS, TILES_X = 68, 120
K_SLOTS = 256
TB = 32  # tiles per block
CH = 256  # rows per DMA chunk
UW = 384  # u_mat lanes
BI_START, BI_NCHUNK, BI_KMAX = 0, 1, 2
BI_BASE0 = 8
BI_CNT0 = 8 + TB
BI_X0 = 8 + 2 * TB
BI_Y0 = 8 + 3 * TB
BI_W = 8 + 4 * TB
_PDA, _PDW = 512, 32
_RECIP = 1.0 / _PDA  # exact in f32

# name -> (loads, dots, rolls, blend), the tool's six (:193-198)
VARIANTS = {
    "full": (True, True, True, True),
    "no_loads": (False, True, True, True),
    "no_dots": (True, False, True, True),
    "no_rolls": (True, True, False, True),
    "no_blend": (True, True, True, False),
    "loads_only": (True, False, False, False),
}
# How the kernel loads the rows (csrc/fold_ablate.cu): "direct" reads each
# step's grid words from device memory as K3 does; "tma16" copies each
# chunk of 16 rows into shared memory by TMA while the block folds the
# chunk before.
DESIGNS = ("direct", "tma16")
DESIGN = "tma16"


def paris_like_depths(rng) -> np.ndarray:
    """Per-tile unit counts with paris's shape (`fold_kernel_bench.py:33-42`):
    Poisson(30) everywhere, plus 12 clustered road lines of 100-220 units,
    clipped to 250."""
    t = ROWS * TILES_X
    depth = rng.poisson(30.0, t).astype(np.int64)
    for _ in range(12):
        r0 = rng.integers(0, ROWS)
        for c in range(TILES_X):
            r = int(np.clip(r0 + rng.integers(-1, 2), 0, ROWS - 1))
            depth[r * TILES_X + c] += int(rng.integers(100, 220))
    return np.clip(depth, 0, 250)


def build_inputs(depth: np.ndarray):
    """(u_mat i32 [total + window, 384], blkinfo i32 [blocks, 136]) for
    per-tile unit counts `depth`, bit for bit as
    `fold_kernel_bench.build_inputs` builds them (random rows from seed 1),
    as CPU tensors."""
    t = depth.size
    t8 = -(-t // TB) * TB
    depth8 = np.pad(depth, (0, t8 - t))
    ust = np.zeros(t8 + 1, np.int64)
    np.cumsum(depth8, out=ust[1:])
    total = int(ust[-1])

    rng = np.random.default_rng(1)
    win = -(-(TB * K_SLOTS + CH + 8) // CH) * CH
    u_mat = np.zeros((total + win, UW), np.int32)
    u_mat[:total, 0:256] = (
        rng.integers(-40, 40, (total, 256)) * 65536
        + rng.integers(-16, 17, (total, 256))
    ).astype(np.int32)
    u_mat[:total, 256:272] = rng.integers(-16, 17, (total, 16)).astype(np.int32)
    fills = rng.random((total, 4), np.float32)
    u_mat[:total, 272:276] = fills.view(np.int32)
    u_mat[:total, 276] = rng.integers(0, 2, total).astype(np.int32)

    nblk = t8 // TB
    ust_t = ust[:t8].reshape(nblk, TB)
    cnt_t = np.minimum(depth8.reshape(nblk, TB), K_SLOTS)
    start_al = (ust_t[:, 0] // 8) * 8
    span_end = np.concatenate([ust_t[1:, 0], ust[t8:]])
    kmax = cnt_t.max(axis=1)
    nch = np.minimum(-(-(span_end - start_al) // CH), win // CH)
    nch = np.where(kmax > 0, nch, 0)
    tile_i = np.arange(t8, dtype=np.int64)
    x0_t = ((tile_i % TILES_X) * 16).reshape(nblk, TB)
    y0_t = ((tile_i // TILES_X) * 16).reshape(nblk, TB)
    blkinfo = np.concatenate(
        [
            start_al[:, None], nch[:, None], kmax[:, None],
            np.zeros((nblk, 5), np.int64),
            ust_t - start_al[:, None], cnt_t, x0_t, y0_t,
        ],
        axis=1,
    ).astype(np.int32)
    return torch.from_numpy(u_mat), torch.from_numpy(blkinfo)


def paris_inputs():
    """The tool's own inputs: paris-like depths from seed 0 (8,160 tiles)."""
    return build_inputs(paris_like_depths(np.random.default_rng(0)))


def _variant(variant: str):
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {tuple(VARIANTS)}, got {variant!r}")
    return VARIANTS[variant]


def fold_ablate(u_mat, blkinfo, clear, variant: str = "full", design: str = DESIGN):
    """u_mat i32 [U, 384]; blkinfo i32 [blocks, 136]; clear f32 [4];
    returns f32 [blocks * 32, 1024], channel-major blocks of 256 pixels.
    `design` (one of DESIGNS) chooses how the kernel loads the rows.  CUDA
    tensors launch `forma_fold_ablate`; CPU tensors take
    `fold_ablate_torch` (the result is the same in both designs)."""
    _variant(variant)
    if design not in DESIGNS:
        raise ValueError(f"design must be one of {DESIGNS}, got {design!r}")
    n_rows, nblk = u_mat.shape[0], blkinfo.shape[0]
    check = _build.check if u_mat.is_cuda else _build.check_shape
    check(u_mat, "u_mat", torch.int32, (n_rows, UW))
    check(blkinfo, "blkinfo", torch.int32, (nblk, BI_W))
    check(clear, "clear", torch.float32, (4,))
    if n_rows < 1:
        raise ValueError("u_mat: expected at least one row")
    if not u_mat.is_cuda:
        return fold_ablate_torch(u_mat, blkinfo, clear, variant)
    _build.check_aligned(u_mat, "u_mat", 16)
    out = torch.empty((nblk * TB, 1024), dtype=torch.float32, device=u_mat.device)
    if nblk:
        _build.launch(
            "forma_fold_ablate", "fold_ablate",
            u_mat.data_ptr(), blkinfo.data_ptr(), clear.data_ptr(), nblk * TB, n_rows, BI_W,
            list(VARIANTS).index(variant), DESIGNS.index(design), out.data_ptr(),
        )
    return out


def tile_rows(blkinfo):
    """(first row, row count) of each tile, int64 [blocks * 32] each."""
    first = (blkinfo[:, BI_START, None].long() + blkinfo[:, BI_BASE0:BI_BASE0 + TB]).reshape(-1)
    return first, blkinfo[:, BI_CNT0:BI_CNT0 + TB].reshape(-1).long()


def coverage_torch(row, dots: bool, rolls: bool):
    """f32 [m, 256] coverage of unit rows i32 [m, >= 277], in int32 and
    the tool's f32 expression order."""
    m = row.shape[0]
    g = row[:, 0:256]
    cover = ((g & 0xFFFF) ^ 0x8000) - 0x8000  # (g << 16) >> 16
    area = (g - cover) >> 16
    if rolls:
        c3 = cover.reshape(m, 16, 16)
        exc = (torch.cumsum(c3, dim=2, dtype=torch.int32) - c3).reshape(m, 256)
    else:
        exc = cover
    ce = row[:, 256:272].repeat_interleave(16, dim=1) if dots else 0
    da = _PDW * (ce + exc) + area
    nz = torch.clamp(torch.abs(da.to(torch.float32) * _RECIP), 0.0, 1.0)
    eo = (_PDA - torch.abs((da & (2 * _PDA - 1)) - _PDA)).to(torch.float32) * _RECIP
    return torch.where(row[:, 276:277] != 0, eo, nz)


def fold_ablate_torch(u_mat, blkinfo, clear, variant: str = "full"):
    """Plain PyTorch version of `fold_ablate`: every tile still folding
    advances one row per step, in the tool's expression order."""
    loads, dots, rolls, blend = _variant(variant)
    n_rows = u_mat.shape[0]
    first, cnt = tile_rows(blkinfo)
    n = first.numel()
    dst = clear.reshape(1, 4, 1).expand(n, 4, 256).clone()
    held = u_mat[first.clamp(max=n_rows - 1)]
    for k in range(int(cnt.max()) if n else 0):
        act = torch.nonzero(cnt > k).squeeze(1)
        row = u_mat[(first[act] + k).clamp(max=n_rows - 1)] if loads else held[act]
        cov = coverage_torch(row, dots, rolls)
        d = dst[act]
        if blend:
            fill = row[:, 272:276].contiguous().view(torch.float32)
            src_a = fill[:, 3:4] * cov
            dst_a = d[:, 3]
            inv_dst_a = 1.0 - dst_a
            inv_dst_a_src_a = inv_dst_a * src_a
            inv_src_a = 1.0 - src_a
            dst_a_src_a = dst_a * src_a
            new = [
                d[:, ch] * inv_src_a
                + (fill[:, ch:ch + 1] * inv_dst_a_src_a + fill[:, ch:ch + 1] * dst_a_src_a)
                for ch in range(3)
            ] + [dst_a * inv_src_a + src_a]
            dst[act] = torch.stack(new, dim=1)
        else:
            dst[act, 0] = d[:, 0] + cov
    return dst.reshape(n, 1024)


def addressed_rows(blkinfo) -> int:
    """Unit rows the fold reads on these inputs (each tile's rows once)."""
    return int(tile_rows(blkinfo)[1].sum())


def measure(inputs=None, device="cuda") -> dict:
    """Device time of every variant in both designs on `device` (a card;
    CUDA graph replays) at the tool's paris shape (or on `inputs`,
    (u_mat, blkinfo) from `build_inputs`); returns {design: {variant:
    ms}, "units": rows folded, "tiles": n}.  "no_loads" is one kernel in
    both designs and is timed once."""
    u_mat, blkinfo = inputs if inputs is not None else paris_inputs()
    u_mat, blkinfo = u_mat.to(device), blkinfo.to(device)
    clear = torch.ones(4, dtype=torch.float32, device=device)
    res = {"units": addressed_rows(blkinfo), "tiles": blkinfo.shape[0] * TB}
    held = None
    for design in DESIGNS:
        res[design] = {}
        for name in VARIANTS:
            if name == "no_loads" and held is not None:
                res[design][name] = held
                continue
            res[design][name] = time_ms_graph(
                lambda: fold_ablate(u_mat, blkinfo, clear, name, design))
        held = res[design]["no_loads"]
    return res


def pieces(times: dict) -> dict:
    """The cost of each piece, full minus the variant without it (ms), from
    one design's {variant: ms}."""
    return {
        "loads": times["full"] - times["no_loads"],
        "dots": times["full"] - times["no_dots"],
        "rolls": times["full"] - times["no_rolls"],
        "blend": times["full"] - times["no_blend"],
        "dots_rolls_blend": times["full"] - times["loads_only"],
    }


def k3_paris_ms(device="cuda") -> float:
    """K3 `fold` on one paris-30k@1080p frame's own inputs, ms by CUDA
    events."""
    from ..ops import fold_kernel as fk
    from . import paris_taps

    args = paris_taps(device)["fold"]
    return time_ms(lambda: fk.paint_fold(*args))


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fold_ablate: no CUDA card; this probe times the card")
    res = measure()
    print(f"card: {torch.cuda.get_device_name(0)}; {res['tiles']} tiles, "
          f"{res['units']} units folded")
    for design in DESIGNS:
        for name in VARIANTS:
            print(f"{design:6s} {name:12s} {res[design][name]:8.4f} ms")
        for piece, ms in pieces(res[design]).items():
            print(f"{design:6s} full - without {piece:16s} {ms:+8.4f} ms")
    print(f"K3 fold on paris-30k@1080p: {k3_paris_ms():8.4f} ms")


if __name__ == "__main__":
    main()
