"""`Renderer.render_into` of the PyTorch port (`Renderer("cpu")`) on a
plain `Buffer`, no layer cache and no crop: `tests/test_buffers_channels.py`'s
strided buffer (the row padding untouched, the pixels equal to `render`'s
and within 1/255 of JAX's `render_into`) and its flusher (called once per
render with the written bytes)."""

import numpy as np

import forma_tpu
import forma_tpu_torch as pt
from forma_tpu.renderer import Renderer as JaxRenderer
from forma_tpu_torch import Renderer
from torch_fixtures import one_torch_thread  # noqa: F401 (autouse)


def _scene(pkg):
    comp = pkg.Composition()
    p = (pkg.PathBuilder().move_to(pkg.Point(8, 8)).line_to(pkg.Point(8, 40))
         .line_to(pkg.Point(40, 40)).line_to(pkg.Point(40, 8)).build())
    comp.get_mut_or_insert_default(pkg.Order(0)).insert(p).set_props(
        pkg.Props(func=pkg.Func.Draw(pkg.Style(fill=pkg.Fill.Solid(
            pkg.Color(0.9, 0.1, 0.2, 0.8))))))
    return comp


def test_render_into_strided_buffer():
    w, h, stride = 48, 48, 64 * 4  # a stride wider than the row
    bufs = {}
    for pkg, r in ((forma_tpu, JaxRenderer()), (pt, Renderer("cpu"))):
        comp = _scene(pkg)
        clear = pkg.Color(0.25, 0.5, 0.75, 1.0)
        buf = np.full((h, stride), 9, np.uint8)
        r.render_into(comp, pkg.Buffer(buffer=buf, layout=pkg.LinearLayout(w, stride, h)),
                      clear)
        bufs[pkg] = buf
    buf = bufs[pt]
    direct = Renderer("cpu").render(_scene(pt), w, h, pt.Color(0.25, 0.5, 0.75, 1.0))
    np.testing.assert_array_equal(buf[:, : w * 4].reshape(h, w, 4), direct)
    assert (buf[:, w * 4:] == 9).all()  # the stride padding is untouched
    assert int(np.abs(buf.astype(int) - bufs[forma_tpu].astype(int)).max()) <= 1


def test_flusher_called():
    class F(pt.Flusher):
        def __init__(self):
            self.calls = 0

        def flush(self, data):
            self.calls += 1
            assert data.size > 0

    f = F()
    buf = np.zeros((64, 64 * 4), np.uint8)
    Renderer("cpu").render_into(
        _scene(pt), pt.Buffer(buffer=buf, layout=pt.LinearLayout(64, 64 * 4, 64, flusher=f)),
        pt.Color(0.25, 0.5, 0.75, 1.0),
    )
    assert f.calls == 1
    assert buf.any()
