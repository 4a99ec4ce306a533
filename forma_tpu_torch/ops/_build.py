"""Builds and loads the port's CUDA kernels; counts their launches.

All kernels live in `forma_tpu_torch/csrc/*.cu`, each with a plain C entry
point that returns `cudaGetLastError()`.  At first use each source compiles
with `nvcc` for `sm_90a` into an object file, all sources at once in
parallel processes, and the objects link into ONE shared library under
`build/forma_tpu_torch/` at the repository root, keyed by a hash of the
sources and flags; it loads through `ctypes`.  `--fmad=false` keeps every
f32 mul+add unfused, so the kernels round op by op exactly like the plain
PyTorch versions.

Nothing here runs at import: the CPU tests import every module, and this
machine-independent half must stay importable without a CUDA toolkit.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "forma_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# Kernel launch counters: each wrapper adds one where it launches its
# kernel, and nowhere else.  A CUDA graph's capture launches nothing, so it
# takes back what its kernels' wrappers added (`capturing`), and each replay
# adds that again (`replayed`): the counts stay launches on the card.
LAUNCHES = {
    "expand": 0, "rasterize": 0, "emit_two_key": 0, "grid": 0, "scan": 0,
    # K3, one counter per specialisation (`fold_kernel.variant`)
    "fold": 0, "fold_styled": 0, "fold_tex": 0, "fold_clip": 0,
    # K5-K9, the probes (`probes.*`)
    "texture_probe": 0, "fold_ablate": 0, "unit_stream": 0, "seg_loop": 0,
    "grid_scatter": 0,
}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
# C signatures (pointers, sizes, stream last).
_SIGNATURES = {
    "forma_expand": [_P, _P, _I64, _I64, _P, _P, _P],
    "forma_grid": [_P, _P, _P, _P, _P, _P, _I64, _I64, _P, _P, _P, _P],
    "forma_scan": [_P, _I64, _I64, _P, _P, _I64, _I64, _I64, _P, _I64, _P],
    "forma_fold": [_P] * 13 + [_I64] * 4 + [_P, _P, _I64, _I64, _P, _P],
    "forma_rasterize": [_P] * 3 + [_I64] * 5 + [_P] + [_I64] * 2 + [_P, _P, _P],
    "forma_emit_two_key": [_P] * 3 + [_I64] * 4 + [_P] * 4,
    "forma_texture_probe": [_P, _P] + [_I64] * 5 + [_P, _P],
    "forma_fold_ablate": [_P] * 3 + [_I64] * 5 + [_P, _P],
    "forma_unit_stream": [_P] * 3 + [_I64, _P, _P],
    "forma_seg_loop": [_P, _I64, _I64, _P, _P, _P],
    "forma_empty": [_P],
    "forma_grid_scatter": [_P] * 3 + [_I64] * 2 + [_P, _P],
    # The stage stamp (`tracing.mark`), counted in no launch counter.
    "forma_stage_stamp": [_P, _I64, _I64, _I64, _P],
}

_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def capturing():
    """Around a CUDA graph's capture: yields a dict that, on exit, holds
    what `LAUNCHES` grew by inside (the graph's launches a replay), and
    takes that growth back out of `LAUNCHES`."""
    before = dict(LAUNCHES)
    grew = {}
    try:
        yield grew
    finally:
        for k, v in before.items():
            if LAUNCHES[k] != v:
                grew[k] = LAUNCHES[k] - v
            LAUNCHES[k] = v


def replayed(grew: dict) -> None:
    """Counts one replay of a graph whose capture grew `LAUNCHES` by `grew`."""
    for k, v in grew.items():
        LAUNCHES[k] += v


def row_lo_tensor(row_lo, device) -> torch.Tensor:
    """A kernel's `row_lo` argument as the int32 0-d tensor on `device`
    that it reads: a tensor is checked and passed on; an int is written
    there by a fill on the device (no upload, no sync)."""
    if isinstance(row_lo, torch.Tensor):
        check(row_lo, "row_lo", torch.int32, ())
        return row_lo
    return torch.full((), row_lo, dtype=torch.int32, device=device)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the forma_tpu_torch CUDA "
        "kernels cannot be built"
    )


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libforma_kernels.so"


def build() -> Path:
    """Compiles the kernels if the hashed library is missing; returns its
    path.  The compiler's report (registers, spills) lands beside it in
    `nvcc.log`."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cu = [p for p in _sources() if p.suffix == ".cu"]
    objs = [str(out.parent / f"{p.stem}.o") for p in cu]
    cmds = [
        [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", o, str(p)]
        for p, o in zip(cu, objs)
    ]
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    log, failed = [], None
    for c, proc in zip(cmds, procs):
        text = proc.communicate()[0]
        log.append(" ".join(c) + "\n" + text)
        if proc.returncode and failed is None:
            failed = (c, text, proc.returncode)
    with tempfile.NamedTemporaryFile(
        dir=out.parent, suffix=".so", delete=False
    ) as tmp:
        tmp_path = tmp.name
    if failed is None:
        link = [nvcc, "-shared", "-Xcompiler", "-fPIC", "-o", tmp_path, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode:
            failed = (link, proc.stdout + proc.stderr, proc.returncode)
    (out.parent / "nvcc.log").write_text("".join(log))
    if failed is not None:
        os.unlink(tmp_path)
        c, text, rc = failed
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(c)}\n{text}")
    os.replace(tmp_path, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def launch(name: str, counter: str, *args) -> None:
    """Calls kernel entry `name` on the current stream; raises on a
    non-zero CUDA status and counts the launch."""
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib(), name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
    LAUNCHES[counter] += 1


def check(t: torch.Tensor, name: str, dtype, shape) -> None:
    """Wrapper argument check: CUDA device, dtype, shape, contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    check_shape(t, name, dtype, shape)
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_shape(t: torch.Tensor, name: str, dtype, shape) -> None:
    """Wrapper argument check on any device: dtype and shape."""
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def check_aligned(t: torch.Tensor, name: str, nbytes: int) -> None:
    """Wrapper argument check for a kernel that loads `t` in `nbytes`-wide
    vectors: a view with a storage offset may start off that boundary."""
    if t.data_ptr() % nbytes:
        raise ValueError(
            f"{name}: the kernel loads it in {nbytes}-byte vectors; its data "
            f"pointer is not {nbytes}-byte aligned (pass a fresh .clone())"
        )
