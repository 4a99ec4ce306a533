"""Nothing under frame_bench/ imports JAX, jaxlib, Flax or the JAX package
(`forma_tpu`), each module's top-level name compared whole (the port,
`forma_tpu_torch`, begins with `forma_tpu`); and the reference imports
nothing of the port: neither `reference/` nor a scene module's own."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from small import ROOT, cells

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "forma_tpu"}


def imported(path: Path):
    """Top-level names of every module the file imports (absolute)."""
    return imported_names(path.read_text())


def imported_names(src: str):
    out = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
            out.add(node.args[0].value.split(".")[0])
    return out


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not imported(f) & FORBIDDEN, f


def test_the_port_is_not_caught_by_a_prefix():
    assert imported_names("import forma_tpu_torch.ops") == {"forma_tpu_torch"}
    assert not imported_names("import forma_tpu_torch") & FORBIDDEN
    assert imported_names("from forma_tpu.ops import x") & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        names = imported(f)
        assert "forma_tpu_torch" not in names and not names & FORBIDDEN, f
        # Relative imports stay inside the reference.
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.level == 1, f


@pytest.mark.parametrize("workload", cells())
def test_control_loads_nothing_of_the_program(workload):
    """The control renders the cell's frames with its scene's reference (its
    own, or `reference/`) and loads nothing of the port, of the JAX package
    or of JAX."""
    names = FORBIDDEN | {"forma_tpu_torch"}
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(Path(__file__).resolve().parent)!r})
        from frame_bench import control
        from small import SEED, bench, small
        b = bench()
        control.reading(b, {workload!r}, SEED, small({workload!r}, b), frames=(0,))
        print(sorted({{m.split(".")[0] for m in sys.modules}} & {names!r}))
    """)
    path = os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": path})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
