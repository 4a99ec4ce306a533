"""Compares the compiled K3 fold specialisations and K4 of two trees, by
SASS.

    python -m forma_tpu_torch.sass_compare DIR

Builds the CUDA kernels of this checkout and of the one in DIR (for
example a parent commit unpacked with `git archive`), each with its own
`ops/_build.py` and flags, then disassembles both trees' `fold.o` and
`rasterize.o` with `cuobjdump -sass` and compares, instruction by
instruction (addresses and encodings left out), each specialisation of
`fold_kernel`, matched by their leading template flags (a tree whose
template has more flags pads the other's with false), and K4's
`rasterize_kernel`.  Prints one line per kernel: its instruction counts
and whether the code is identical.  Needs nvcc and cuobjdump (the CUDA
toolkit), not a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import re
import subprocess
from pathlib import Path

FUNC_RE = re.compile(r"Function : (\S+)")
FLAGS_RE = re.compile(r"fold_kernelI((?:Lb[01]E)+)E")
K4_RE = re.compile(r"(?<![A-Za-z_])rasterize_kernel")
ADDR_RE = re.compile(r"/\*[0-9a-f]{4,}\*/")


def _load_build(root: Path):
    path = root / "forma_tpu_torch" / "ops" / "_build.py"
    spec = importlib.util.spec_from_file_location(f"_build_{abs(hash(root))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sass(root: Path, obj: str) -> dict:
    """{function name: [instruction, ...]} of every function in `root`'s
    build of csrc/<obj>.cu."""
    build = _load_build(root)
    path = build.build().parent / f"{obj}.o"
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = FUNC_RE.search(line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
            continue
        if cur is not None and ADDR_RE.search(line):
            ins = ADDR_RE.sub("", line.split(";")[0]).strip()
            if ins:
                funcs[cur].append(ins)
    return funcs


def fold_sass(root: Path) -> dict:
    """{template flags (tuple of bools): [instruction, ...]} of the
    fold_kernel specialisations in `root`'s build of csrc/fold.cu."""
    out = {}
    for name, ins in sass(root, "fold").items():
        flags = FLAGS_RE.search(name)
        if flags:
            out[tuple(b == "1" for b in re.findall(r"Lb([01])E", flags.group(1)))] = ins
    return out


def raster_sass(root: Path) -> list:
    """K4's instructions in `root`'s build of csrc/rasterize.cu (its name
    holds a hash of the source's path, so it is matched by its stem)."""
    (ins,) = [v for k, v in sass(root, "rasterize").items() if K4_RE.search(k)]
    return ins


def _compare(label: str, ins: list, other) -> str:
    if other is None:
        return f"{label}: {len(ins)} instructions here; not there"
    diff = sum(a != b for a, b in zip(ins, other)) + abs(len(ins) - len(other))
    return (f"{label}: {len(ins)} instructions here, {len(other)} there, "
            f"{'identical' if diff == 0 else f'{diff} differ'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    opts = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    other_root = Path(opts.other).resolve()
    here, there = fold_sass(root), fold_sass(other_root)
    width = max(len(k) for k in list(here) + list(there))

    def pad(k):
        return k + (False,) * (width - len(k))

    there = {pad(k): v for k, v in there.items()}
    for key, ins in sorted((pad(k), v) for k, v in here.items()):
        flags = "<" + ", ".join("true" if b else "false" for b in key) + ">"
        print(_compare(f"fold_kernel{flags}", ins, there.get(key)))
    print(_compare("rasterize_kernel", raster_sass(root), raster_sass(other_root)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
