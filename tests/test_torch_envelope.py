"""The render-target envelope probe (`forma_tpu_torch.probes.envelope`, the
counterpart of `tools/envelope_probe.py:big_frames`) on the CPU at small
sizes:

- the ladder at 256x128 and 512x256 (paris-30k at paths=200, 64-pixel
  windows): every row renders, each window within 1/255 of the oracle
  (the probe raises otherwise);
- both windows of the port's frame equal to JAX's CPU render of the same
  composition bit for bit, and within 1/255 of the oracle, on the packed
  key and with the two-key route forced in the port;
- the oracle's window from the layers whose bounding boxes meet it
  (`window_orders`, `backend_numpy.render_window`) bit-equal to the full
  oracle's crop of every layer, and a layer outside the window (or moved
  there by its transform) left out (or kept);
- the ladder stops at the first `torch.cuda.OutOfMemoryError`, recorded in
  its row, while any other error propagates;
- a frame of the format's height (32768 rows, 2048 tile rows) paints its
  last tile row: the run key [rowb | layer] needs 12 + 21 bits there, and
  cut to 32 bits it sent that row's virtual units nowhere (found at
  32768x32768 on the card); a frame of the format's width (4096 tile
  columns) paints its last tile column.
"""

import numpy as np
import pytest
import torch

from forma_tpu import Color as JColor
from forma_tpu import Composition as JComposition
from forma_tpu.demos import scenes as jax_scenes
from forma_tpu.renderer import Renderer as JRenderer
from forma_tpu_torch import (
    Color, Composition, Fill, Func, Order, PathBuilder, Point, Props, Renderer, Style,
)
from forma_tpu_torch.backend_numpy import render as oracle_render
from forma_tpu_torch.backend_numpy import render_window
from forma_tpu_torch.convert import composition_from_jax
from forma_tpu_torch.ops import pipeline
from forma_tpu_torch.probes import envelope as ev
from torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

W, H, PATHS, WIN = 512, 256, 200, 64


@pytest.fixture(scope="module")
def paris():
    """(JAX composition, the port's copy) of paris-30k at paths=200, 512x256."""
    jcomp = JComposition()
    jax_scenes.paris30k(jcomp, W, H, paths=PATHS)
    return jcomp, composition_from_jax(jcomp)


@pytest.fixture(scope="module")
def jax_frame(paris):
    frame, _ = JRenderer().render_device(paris[0], W, H, JColor(1.0, 1.0, 1.0, 1.0))
    return np.asarray(frame)


def cut(frame, window):
    x0, y0, w, h = window
    return np.asarray(frame)[y0:y0 + h, x0:x0 + w].astype(np.int32)


def test_ladder_on_cpu():
    lines = []
    rows = ev.run_ladder([(256, 128), (W, H)], "cpu", paths=PATHS, window=WIN,
                         report=lines.append)
    assert [r["size"] for r in rows] == ["256x128", "512x256"]
    assert all(r["ok"] and max(r["window_max_diff"]) <= ev.TOLERANCE for r in rows)
    assert [r["route"] for r in rows] == ["packed", "packed"]
    assert rows[1]["windows"] == [[0, 0, 64, 64], [448, 192, 64, 64]]
    assert all(r["segs"] > 0 for r in rows)
    assert len(lines) == 2 and lines[1].startswith("512x256: OK, route packed")
    assert rows[1]["tensor_bytes"] == {"k3_out": 16 * W * H, "paint_copy": 16 * W * H,
                                       "srgb_planes": 12 * W * H, "u8_frame": 4 * W * H}


@pytest.mark.parametrize("two_key", [False, True])
def test_windows_equal_jax_and_oracle(paris, jax_frame, two_key, monkeypatch):
    """The port's windows equal JAX's CPU frame bit for bit (on the packed
    key, and with the two-key route forced in the port: JAX's packed frame
    is the same image) and lie within 1/255 of the oracle."""
    comp = paris[1]
    if two_key:
        monkeypatch.setattr(pipeline, "slot_bits_for", lambda *_: 0)
    frame, diag = Renderer("cpu").render_device(comp, W, H, Color(1.0, 1.0, 1.0, 1.0))
    assert ev.route(len(comp.layers), W, H) == ("two-key" if two_key else "packed")
    for win in ev.windows(W, H, WIN):
        got = cut(frame.numpy(), win)
        np.testing.assert_array_equal(got, cut(jax_frame, win))
        want = ev.oracle_window(comp, W, H, win).astype(np.int32)
        assert np.abs(got - want).max() <= ev.TOLERANCE


def test_filtered_oracle_window_equals_full_oracle(paris):
    comp = paris[1]
    clear = Color(1.0, 1.0, 1.0, 1.0)
    for win in ev.windows(W, H, WIN) + ((128, 64, 96, 80),):
        full = oracle_render(comp, W, H, clear, crop=ev.window_rect(win))
        orders = ev.window_orders(comp, win)
        assert 0 < len(orders) < len(comp.layers)
        np.testing.assert_array_equal(ev.oracle_window(comp, W, H, win), cut(full, win))
        np.testing.assert_array_equal(
            render_window(comp, W, H, ev.window_rect(win), clear)[:win[3], :win[2]],
            cut(full, win))


def rects(boxes) -> Composition:
    """One opaque rectangle a layer, (x, y, w, h) each, in order."""
    comp = Composition()
    for i, (x, y, w, h) in enumerate(boxes):
        path = (PathBuilder().move_to(Point(x, y)).line_to(Point(x, y + h))
                .line_to(Point(x + w, y + h)).line_to(Point(x + w, y)).build())
        comp.get_mut_or_insert_default(Order(i)).insert(path).set_props(
            Props(func=Func.Draw(Style(fill=Fill.Solid(Color(0.5, 0.2, 0.1 * i, 1.0))))))
    return comp


def test_window_orders_bounding_boxes():
    comp = rects([(10, 10, 8, 8), (300, 200, 8, 8), (70, 10, 8, 8)])
    win = (0, 0, 64, 64)
    assert ev.window_orders(comp, win).tolist() == [0]
    # A bounding box one pixel past the window's edge still counts.
    assert ev.window_orders(comp, (0, 0, 69, 64)).tolist() == [0, 2]
    assert ev.window_orders(comp, (0, 0, 68, 64)).tolist() == [0]
    comp.get_mut(Order(1)).set_transform([1, 0, 0, 1, -280, -180])
    assert ev.window_orders(comp, win).tolist() == [0, 1]
    comp.get_mut(Order(0)).disable()
    assert ev.window_orders(comp, win).tolist() == [1]


def test_windows_geometry():
    assert ev.windows(65536, 32768) == ((0, 0, 256, 256), (65280, 32512, 256, 256))
    assert ev.windows(300, 100, 256) == ((0, 0, 256, 100), (32, 0, 256, 100))
    assert ev.SIZES[-1] == (65536, 32768) and len(ev.SIZES) == 7


class _FailingRenderer(Renderer):
    """Renders on the CPU; raises `error` for frames wider than 256."""

    error = None

    def render_device(self, composition, width, height, *args, **kwargs):
        if width > 256:
            raise self.error
        return super().render_device(composition, width, height, *args, **kwargs)


def test_ladder_stops_at_out_of_memory(monkeypatch):
    monkeypatch.setattr(ev, "Renderer", _FailingRenderer)
    _FailingRenderer.error = torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
    lines = []
    sizes = [(256, 128), (W, H), (1024, 512)]
    rows = ev.run_ladder(sizes, "cpu", paths=50, window=WIN, report=lines.append)
    assert [r["ok"] for r in rows] == [True, False]  # 1024x512 never tried
    assert rows[1]["error"].startswith("OutOfMemoryError: CUDA out of memory (test)")
    assert lines[1] == "512x256: OUT OF MEMORY (OutOfMemoryError: CUDA out of memory (test))"
    _FailingRenderer.error = ValueError("not a memory error")
    with pytest.raises(ValueError, match="not a memory error"):
        ev.run_ladder(sizes, "cpu", paths=50, window=WIN, report=lines.append)


def test_out_of_memory_names_its_stage(monkeypatch):
    """An out-of-memory error raised inside a pipeline stage is recorded
    with the stage's name; the stages are restored after."""
    from forma_tpu_torch.ops import srgb

    def pack_srgb(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")

    monkeypatch.setattr(pipeline._srgb, "pack_srgb", pack_srgb)
    rows = ev.run_ladder([(256, 128)], "cpu", paths=50, window=WIN, report=lambda _: None)
    assert rows[0]["where"] == "in stage pack_srgb"
    assert ev.row_line(rows[0]).startswith("256x128: OUT OF MEMORY, in stage pack_srgb (")
    assert pipeline._srgb.pack_srgb is pack_srgb and srgb.pack_srgb is pack_srgb


@pytest.mark.parametrize("limit", ["height", "width"])
def test_last_tiles_at_the_format_limit(limit):
    """64 x MAX_HEIGHT, and MAX_WIDTH x 16: a full-frame rectangle and a
    small one in the last tile row (or column); the last tiles (with the
    virtual units right of the edge tiles) equal the oracle's and are
    painted as the tiles before them."""
    from forma_tpu_torch import consts

    w, h = (64, consts.MAX_HEIGHT) if limit == "height" else (consts.MAX_WIDTH, 16)
    comp = rects([(0, 0, w, h), (w - 44, h - 12, 9, 7)])
    frame, diag = Renderer("cpu").render_device(comp, w, h, Color(1.0, 1.0, 1.0, 1.0))
    rows, tiles_x = h // 16, w // 16
    assert frame.shape[:2] == (h, w) and int(diag[pipeline.DIAG_VIRT]) >= 3 * rows
    win = (w - 64, h - 32 if limit == "height" else 0, 64, min(h, 32))
    got = cut(frame.numpy(), win)
    np.testing.assert_array_equal(got, ev.oracle_window(comp, w, h, win).astype(np.int32))
    np.testing.assert_array_equal(got[-1, 32:], got[0, 32:])  # painted, as above
    np.testing.assert_array_equal(got[:, -1], got[:, 0])  # painted, as to the left
    assert tiles_x * 16 == w and (got[-1, -1] != 255).any()
