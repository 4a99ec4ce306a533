"""A configuration, a mix with its own kind of entry and of update, and a
per-layer metric are added as new files and new `BENCHMARK.json` entries,
with no edit to a file that is there: in a copy of the benchmark, a run
of the new cell reads the new metric."""

import hashlib
import json
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


def test_new_cell_from_files_only(tmp_path):
    shutil.copytree(ROOT / "frame_bench", tmp_path / "frame_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = digest(tmp_path)
    fb = tmp_path / "frame_bench"
    assert not (fb / "entries" / "pipelined.py").exists()
    assert not (fb / "updates" / "markers.py").exists()
    (fb / "entries" / "pipelined.py").write_text(PIPELINED)
    (fb / "updates" / "markers.py").write_text(MARKERS)
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
    bench["workloads"].append({"name": "paris-tiny.throwaway", "config": "paris-tiny",
                               "traffic": "throwaway", "chips": 1, "why": "a test"})
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
        assert run.HERE == Path({str(fb)!r})
        bench = json.loads(Path("BENCHMARK.json").read_text())
        result, checks = run.run_cell(bench, "paris-tiny.throwaway", 5, 0.2, True, Path("."),
                                      device="cpu", trace_frames=2)
        print(json.dumps({{**result, "checks": checks}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["metrics"]["throwaway_frames"]["value"] == result["attempted"] > 0
    assert "update_ms" not in result["metrics"]  # listed for other cells only
