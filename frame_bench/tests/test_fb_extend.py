"""A configuration, a mix with its own kind of entry and of update, a
per-layer metric, and a scene with paint of its own are added as new files
and new `BENCHMARK.json` entries, with no edit to a file that is there: in
a copy of the benchmark, a run of the new cell reads the new metric, and
the benchmark's own tests pass for the new scene's cell, which its own
`compose` and `Reference` decide."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap

from small import ROOT


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "frame_bench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


# An entry no other file has: `render_into(pipelined=True)`, whose pixels
# reach the buffer one frame late.
PIPELINED = '''
"""`"entry": "pipelined"`: `Renderer.render_into(pipelined=True)` into a
damage-cached `Buffer`; a frame's pixels land one call later."""

import numpy as np

from frame_bench.entries import Entry as Base


class Entry(Base):
    lag = 1

    def __init__(self, mix, scene, comp, renderer):
        from forma_tpu_torch import BufferBuilder, LinearLayout

        super().__init__(mix, scene, comp, renderer)
        w, h = scene.width, scene.height
        self.pixels = np.zeros((h, w * 4), np.uint8)
        self.buffer = BufferBuilder(self.pixels, LinearLayout(w, w * 4, h)).layer_cache(
            renderer.create_buffer_layer_cache()).build()
        self.started = False

    def view(self):
        return self.pixels.reshape(self.scene.height, self.scene.width, 4)

    def render(self):
        self.renderer.render_into(self.comp, self.buffer, self.clear, pipelined=True)
        first, self.started = not self.started, True
        return None if first else self.view()

    def finish(self):
        if not self.started:
            return None
        self.renderer.flush_pending()
        self.started = False
        return self.view()
'''

# An update no other file has: a few layers moving, the rest still.
MARKERS = '''
"""`"update": "markers"`: every `every`-th layer moves along a circle."""

import math

import numpy as np

from frame_bench.updates import Update as Base


class Update(Base):
    def transforms(self, i):
        t = np.tile(np.asarray([1, 0, 0, 1, 0, 0], np.float32), (self.scene.layers, 1))
        a = 2 * math.pi * i / self.mix["period_frames"]
        t[::self.mix["every"], 4] = self.mix["radius"] * math.cos(a)
        t[::self.mix["every"], 5] = self.mix["radius"] * math.sin(a)
        return t
'''


# A scene no other file has: paris30k with an opacity a layer, paint that
# the benchmark's solid-fill compose and reference do not know.
VEILED = '''
"""`"scene": "veiled"`: the paris30k map with an opacity a layer, which its
own `compose` and `Reference` fold into the layer's colour."""

from dataclasses import dataclass, replace

import numpy as np

from frame_bench import compose as solid
from frame_bench.reference import Reference as Solid
from frame_bench.scenes import Scene, paris30k


@dataclass
class Veiled(Scene):
    opacity: np.ndarray = None  # f32 [L]


def build(config, seed):
    s = paris30k.build(config, seed)
    opacity = np.random.default_rng([seed, 7]).uniform(0.2, 0.6, s.layers)
    return Veiled(s.width, s.height, s.paths, s.colors, s.even_odd, s.clear,
                  opacity.astype(np.float32))


def folded(scene):
    colors = scene.colors.copy()
    colors[:, 3] *= scene.opacity
    return colors


def compose(scene):
    return solid.compose(replace(scene, colors=folded(scene)))


class Reference(Solid):
    def __init__(self, scene):
        super().__init__(scene)
        self.colors = folded(scene)
'''


def test_new_cell_from_files_only(tmp_path):
    shutil.copytree(ROOT / "frame_bench", tmp_path / "frame_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = digest(tmp_path)
    fb = tmp_path / "frame_bench"
    assert not (fb / "entries" / "pipelined.py").exists()
    assert not (fb / "updates" / "markers.py").exists()
    assert not (fb / "scenes" / "veiled.py").exists()
    (fb / "entries" / "pipelined.py").write_text(PIPELINED)
    (fb / "updates" / "markers.py").write_text(MARKERS)
    (fb / "scenes" / "veiled.py").write_text(VEILED)
    (fb / "configs" / "veiled-1080p.json").write_text(json.dumps(
        {"scene": "veiled", "width": 1920, "height": 1080, "paths": 30000, "buildings": 0.7,
         "roads": 0.2, "clear": [1.0, 1.0, 1.0, 1.0], "precision": "float32"}))
    (fb / "tests" / "small" / "veiled-1080p.json").write_text(json.dumps(
        {"width": 160, "height": 96, "paths": 300}))
    (fb / "tests" / "small" / "paris-tiny.json").write_text(json.dumps({}))  # tiny as it is
    (fb / "checks" / "veiled-1080p.static.json").write_text(json.dumps(
        {"frames": 2, "rows": 3, "mismatch_pct": 1.0, "last_rows": None}))
    (fb / "configs" / "paris-tiny.json").write_text(json.dumps(
        {"scene": "paris30k", "width": 96, "height": 64, "paths": 120, "buildings": 0.5,
         "roads": 0.3, "clear": [0.0, 0.0, 0.2, 1.0], "precision": "float32"}))
    (fb / "mixes" / "throwaway.json").write_text(json.dumps(
        {"entry": "pipelined", "update": "markers", "every": 7,
         "radius": 3.0, "period_frames": 8, "warmup_frames": 8}))
    (fb / "metrics" / "throwaway_frames.py").write_text(textwrap.dedent('''
        """throwaway_frames: frames in the window."""


        def read(ctx):
            return ctx.frames
    '''))
    (fb / "checks" / "paris-tiny.throwaway.json").write_text(json.dumps(
        {"frames": 2, "rows": 1, "last_rows": None, "mismatch_pct": 0.5}))
    bench["configs"].append({"name": "paris-tiny", "source": "https://example.org",
                             "file": "frame_bench/configs/paris-tiny.json", "reduced": [],
                             "why": "a test"})
    bench["configs"].append({"name": "veiled-1080p", "source": "https://example.org",
                             "file": "frame_bench/configs/veiled-1080p.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "paris-tiny.throwaway", "config": "paris-tiny",
                               "traffic": "throwaway", "chips": 1, "why": "a test"})
    bench["workloads"].append({"name": "veiled-1080p.static", "config": "veiled-1080p",
                               "traffic": "static", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "throwaway_frames", "unit": "frames",
                               "better": "higher", "source": "host_clock", "layer": "scene",
                               "moves": "frame_ms", "workloads": ["paris-tiny.throwaway"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = digest(tmp_path)
    assert all(after[k] == v for k, v in before.items())  # nothing edited, only added

    code = textwrap.dedent(f"""
        import json, sys
        from pathlib import Path
        sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]
        import torch
        torch.set_num_threads(1)
        from frame_bench import run
        from frame_bench.scenes import veiled
        assert run.HERE == Path({str(fb)!r})
        bench = json.loads(Path("BENCHMARK.json").read_text())
        result, checks = run.run_cell(bench, "paris-tiny.throwaway", 5, 0.2, True, Path("."),
                                      device="cpu", trace_frames=2)
        print(json.dumps({{**result, "checks": checks}}))
        # The veiled cell with the benchmark's solid-fill compose, which drops
        # the opacity, against the scene's own reference.
        del veiled.compose
        small = json.loads(Path("frame_bench/tests/small/veiled-1080p.json").read_text())
        result, checks = run.run_cell(bench, "veiled-1080p.static", 5, 0.2, False, Path("."),
                                      device="cpu", config_overrides=small)
        print(json.dumps({{**result, "checks": checks}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    throwaway, solid = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    assert throwaway["correct"] is True, throwaway["checks"]
    assert throwaway["metrics"]["throwaway_frames"]["value"] == throwaway["attempted"] > 0
    assert "update_ms" not in throwaway["metrics"]  # listed for other cells only
    assert solid["correct"] is False, solid["checks"]

    # The benchmark's own tests, in the copy, for the veiled cell: its result
    # line; each fault, and the control (the scene's own reference in
    # bfloat16), fails its check, a sound run passes; the control loads
    # nothing of the port; and every configuration has its tiny size.
    tests = fb / "tests"
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-k",
         "veiled or tiny_size", str(tests / "test_fb_cells.py"), str(tests / "test_fb_faults.py"),
         str(tests / "test_fb_imports.py")],
        cwd=tmp_path, capture_output=True, text=True, timeout=900,
        env={**os.environ, "PYTHONPATH": os.pathsep.join([str(tmp_path), str(ROOT)])})
    assert out.returncode == 0, out.stdout[-3000:]
    summary = out.stdout.strip().splitlines()[-1]
    assert summary.startswith("9 passed, ") and "skipped" not in summary, out.stdout[-3000:]
