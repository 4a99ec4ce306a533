"""Builds and loads the port's CUDA kernels; counts their launches.

All kernels live in `forma_tpu_torch/csrc/*.cu`, each with a plain C entry
point that returns `cudaGetLastError()`.  At first use they compile with
`nvcc` for `sm_90a` into ONE shared library under `build/forma_tpu_torch/`
at the repository root, keyed by a hash of the sources and flags, and load
through `ctypes`.  `--fmad=false` keeps every f32 mul+add unfused, so the
kernels round op by op exactly like the plain PyTorch versions.

Nothing here runs at import: the CPU tests import every module, and this
machine-independent half must stay importable without a CUDA toolkit.
"""

from __future__ import annotations

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
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# Kernel launch counters: each wrapper adds one where it launches its
# kernel, and nowhere else.
LAUNCHES = {"expand": 0, "grid": 0, "fold": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
# C signatures (pointers, sizes, stream last).
_SIGNATURES = {
    "forma_expand": [_P, _P, _I64, _I64, _P, _P, _P],
    "forma_grid": [_P, _P, _P, _P, _P, _P, _I64, _I64, _P, _P, _P, _P],
    "forma_fold": [_P] * 9 + [_I64] * 4 + [_P, _P],
}

_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    cu = [str(p) for p in _sources() if p.suffix == ".cu"]
    with tempfile.NamedTemporaryFile(
        dir=out.parent, suffix=".so", delete=False
    ) as tmp:
        tmp_path = tmp.name
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp_path, *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out.parent / "nvcc.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        os.unlink(tmp_path)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
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
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
