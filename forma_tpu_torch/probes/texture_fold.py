"""K5: the texture-fold probe (`tools/texture_fold_probe.py:run`).

    python -m forma_tpu_torch.probes.texture_fold [--nblk 255] [--kmax 44]

The TPU probe asked what sampling a texture costs inside the paint fold:
per tile, a loop over k fold steps adds to each of the tile's 256 pixels
a value derived from affine coordinates,

    prm = f32(info[:, :6]) * 0.001          # ux, uy, vx, vy, tx, ty
    sx = xg*ux + (yg*vx + (tx + k));  sy = xg*uy + (yg*vy + ty)
    ix = clip(trunc(sx), 0, AW-1);    iy = clip(trunc(sy), 0, AH-1)

(xg, yg: tile-local pixel coordinates), in three modes: `base` adds (sx,
sy, sx*sy, sx-sy), the coordinates alone; `atlas_rowsel` adds the bf16
texel atlas[iy, 4*ix + ch]; `slab` adds the texel of a per-tile 32-row
slab at row oy0 = info[:, 6], column clip(ix - info[:, 7], 0, 31).  The
marginal time of a sampling mode over `base` is the cost of sampling in
the fold.  On the H100 the port's K3 samples textures in its fold; this
entry point times the probe's own shape: 255 blocks of 32 tiles (8,160
tiles, the paris frame's count) and 44 steps, and, beside it, the probe's
prep-side alternative (a [U, 32, 32, 4] window gather from a [512, 512,
4] atlas, plain PyTorch indexing).

`texture_fold` launches the CUDA kernel (`csrc/texture_probe.cu`, launch
counter "texture_probe") for CUDA tensors and takes `texture_fold_torch`
for CPU tensors.  Needs a CUDA card as a script; it does not fall back to
the CPU.
"""

from __future__ import annotations

import argparse
import statistics

import numpy as np
import torch

from ..ops import _build

TB = 32  # tiles per Pallas block (the probe's grid unit)
AH, AW = 256, 32  # the probe's atlas: [AH, AW * 4] f32
SH, SW = 32, 32  # slab rows and columns
MODES = ("base", "atlas_rowsel", "slab")


def probe_inputs(nblk: int, seed: int = 0):
    """The probe's inputs (`texture_fold_probe.py:174-180`): info i32
    [nblk * 32, 8] in [0, 24), atlas f32 [256, 128] in [0, 1)."""
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 24, size=(nblk * TB, 8)).astype(np.int32)
    atlas = rng.uniform(0, 1, (AH, AW * 4)).astype(np.float32)
    return torch.from_numpy(info), torch.from_numpy(atlas)


def texture_fold(info, atlas, mode: str, kmax: int):
    """info i32 [n, 8] (per tile: ux, uy, vx, vy, tx, ty in thousandths,
    oy0, ox0); atlas f32 [ah, 4 * aw] (ah, aw >= 32); returns f32 [n,
    1024], channel-major blocks of 256 pixels.  CUDA tensors launch
    `forma_texture_probe`; CPU tensors take `texture_fold_torch`."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if not info.is_cuda:
        return texture_fold_torch(info, atlas, mode, kmax)
    n = info.shape[0]
    ah, aw = _atlas_shape(atlas)
    _build.check(info, "info", torch.int32, (n, 8))
    _build.check(atlas, "atlas", torch.float32, (ah, 4 * aw))
    # One conversion, as the Pallas body's `.astype(bf16)`; the kernel
    # reads 4 bf16 (8 bytes) per texel.
    bf = atlas.to(torch.bfloat16)
    _build.check_aligned(bf, "atlas (bf16)", 8)
    out = torch.empty((n, 1024), dtype=torch.float32, device=info.device)
    if n:
        _build.launch(
            "forma_texture_probe", "texture_probe",
            info.data_ptr(), bf.data_ptr(), n, ah, aw, kmax, MODES.index(mode),
            out.data_ptr(),
        )
    return out


def _atlas_shape(atlas):
    if atlas.dim() != 2 or atlas.shape[1] % 4:
        raise ValueError(f"atlas must be f32 [AH, 4 * AW], got {tuple(atlas.shape)}")
    ah, aw = atlas.shape[0], atlas.shape[1] // 4
    if ah < SH or aw < SW:
        raise ValueError(f"atlas must be at least {SH}x{SW} texels, got {ah}x{aw}")
    return ah, aw


def texture_fold_torch(info, atlas, mode: str, kmax: int):
    """Plain PyTorch version of `texture_fold`: a loop over k on every
    tile at once, in the Pallas expression order."""
    ah, aw = _atlas_shape(atlas)
    f32 = torch.float32
    dev = info.device
    j = torch.arange(256, device=dev)
    xg = (j % 16).to(f32)
    yg = (j // 16).to(f32)
    prm = info[:, :6].to(f32) * 0.001
    ux, uy, vx, vy, tx, ty = (prm[:, i, None] for i in range(6))
    oy0 = info[:, 6, None].long()
    ox0 = info[:, 7, None].long()
    # The slab's start clamps into the atlas as the dynamic slice does.
    slab0 = torch.clamp(oy0, 0, ah - SH)
    at = atlas.to(torch.bfloat16).to(f32)
    acc = [torch.zeros((info.shape[0], 256), dtype=f32, device=dev) for _ in range(4)]
    for k in range(kmax):
        sx = xg * ux + (yg * vx + (tx + float(k)))
        sy = xg * uy + (yg * vy + ty)
        if mode == "base":
            texel = [sx, sy, sx * sy, sx - sy]
        else:
            ix = torch.clamp(torch.trunc(sx), 0, aw - 1).long()
            iy = torch.clamp(torch.trunc(sy), 0, ah - 1).long()
            if mode == "slab":
                # Column not offset by ox0: the Pallas slab spans all AW
                # columns from column 0 (texture_fold_probe.py:123,134).
                iy = slab0 + torch.clamp(iy - oy0, 0, SH - 1)
                ix = torch.clamp(ix - ox0, 0, SW - 1)
            texel = [at[iy, 4 * ix + ch] for ch in range(4)]
        acc = [a + t for a, t in zip(acc, texel)]
    return torch.cat(acc, dim=1)


def window_gather(atlas3, oy, ox):
    """The probe's prep-side alternative: [U, 32, 32, 4] windows of an
    [H, W, 4] atlas at (oy, ox), by plain PyTorch indexing."""
    r = torch.arange(SH, device=atlas3.device)
    c = torch.arange(SW, device=atlas3.device)
    return atlas3[(oy[:, None] + r)[:, :, None], (ox[:, None] + c)[:, None, :]]


def window_inputs(n: int = 49152, seed: int = 0):
    """`texture_fold_probe.py:195-198`: a [512, 512, 4] atlas and n
    window origins in [0, 480)."""
    rng = np.random.default_rng(seed)
    at2 = rng.uniform(0, 1, (512, 512, 4)).astype(np.float32)
    oy = rng.integers(0, 480, size=n)
    ox = rng.integers(0, 480, size=n)
    return torch.from_numpy(at2), torch.from_numpy(oy), torch.from_numpy(ox)


def time_ms(fn, batches: int = 5, per_batch: int = 10) -> float:
    """Milliseconds per call by CUDA events: median over batches of calls
    queued back to back, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_batch)
    return statistics.median(times)


def measure(nblk: int = 255, kmax: int = 44, device="cuda") -> dict:
    """Times the three modes and the window gather on `device` (a card);
    returns {mode: ms, "window_gather": ms, "tile_steps": n}."""
    info, atlas = (t.to(device) for t in probe_inputs(nblk))
    res = {"tile_steps": nblk * TB * kmax}
    for mode in MODES:
        res[mode] = time_ms(lambda: texture_fold(info, atlas, mode, kmax))
    at2, oy, ox = (t.to(device) for t in window_inputs())
    res["window_gather"] = time_ms(lambda: window_gather(at2, oy, ox), batches=3, per_batch=3)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nblk", type=int, default=255, help="blocks of 32 tiles")
    ap.add_argument("--kmax", type=int, default=44, help="fold steps per tile")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("texture_fold: no CUDA card; this probe times the card")
    res = measure(opts.nblk, opts.kmax)
    steps = res["tile_steps"]
    print(f"card: {torch.cuda.get_device_name(0)}; tile-steps: {steps} "
          f"({opts.nblk} blocks x TB={TB} x kmax={opts.kmax})")
    base = res["base"]
    print(f"base kernel (coords only):        {base:8.4f} ms")
    for mode in ("slab", "atlas_rowsel"):
        t = res[mode]
        print(f"{mode:32s}  {t:8.4f} ms  (marginal {t - base:+8.4f} ms, "
              f"{(t - base) / steps * 1e6:6.2f} ns/tile-step)")
    print(f"[U,32,32,4] window gather at U=49152 (plain PyTorch indexing): "
          f"{res['window_gather']:8.4f} ms")


if __name__ == "__main__":
    main()
