"""Cropped frames in the PyTorch port (`Renderer("cpu")`, every kernel's
plain version) against the JAX package on the CPU: `render(crop=)` and
`render_into(crop=)` paint the tiles of a tile-aligned rect and leave the
rest of the buffer untouched (`tests/test_crop.py`'s two cases, each
also against JAX's cropped frame).  A crop of tile rows [lo, hi) renders
a frame of hi - lo rows whose first row is global row lo: the rasterizer
shifts the rows, and K3 (`row_lo`) must evaluate gradients and textures
at the global rows again.  A solid scene cannot tell, so gradient and
texture scenes are cropped to rows away from 0, against JAX's cropped
render (<= 1/255) and the port's own full frame (equal).  K3's plain fold
with `row_lo > 0` and a tile-skip mask is held against JAX's
interpret-mode Pallas fold (`_paint_fold_pallas(row_lo=,
tile_unchanged=)`, at `tests/test_torch_paint.py`'s 1e-6), and a cropped
frame on the two-key route equals its packed frame."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import forma_tpu
import forma_tpu_torch
from forma_tpu.ops import paint as jpaint
from forma_tpu.renderer import Renderer as JaxRenderer
from forma_tpu_torch import Renderer
from forma_tpu_torch.ops import paint, pipeline
from forma_tpu_torch.ops.fold_kernel import fold_tiles
from torch_fixtures import one_torch_thread  # noqa: F401 (autouse)


def _max_diff(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def _renderer(pkg):
    return JaxRenderer() if pkg is forma_tpu else Renderer("cpu")


def _rect(pkg, x0, y0, x1, y1):
    return (pkg.PathBuilder().move_to(pkg.Point(x0, y0)).line_to(pkg.Point(x0, y1))
            .line_to(pkg.Point(x1, y1)).line_to(pkg.Point(x1, y0)).build())


def _draw(pkg, comp, order, path, fill):
    comp.get_mut_or_insert_default(pkg.Order(order)).insert(path).set_props(
        pkg.Props(func=pkg.Func.Draw(pkg.Style(fill=fill))))


def _solid_scene(pkg):
    """`tests/test_crop.py`'s scene (64x64)."""
    comp = pkg.Composition()
    tri = (pkg.PathBuilder().move_to(pkg.Point(5.5, 3.0)).line_to(pkg.Point(60.0, 10.0))
           .line_to(pkg.Point(30.0, 60.0)).build())
    _draw(pkg, comp, 0, tri, pkg.Fill.Solid(pkg.Color(0.8, 0.2, 0.1, 0.9)))
    _draw(pkg, comp, 1, _rect(pkg, 0.0, 40.0, 64.0, 64.0),
          pkg.Fill.Solid(pkg.Color(0.1, 0.3, 0.9, 0.5)))
    return comp


def _gradient_scene(pkg):
    """64x96: a linear gradient down the frame, a radial one off-centre and
    a translucent solid bar, so every tile row paints a different colour."""
    comp = pkg.Composition()
    lin = (pkg.GradientBuilder(pkg.Point(0, 0), pkg.Point(0, 96))
           .color(pkg.Color(1, 0, 0, 1)).color(pkg.Color(0, 1, 0, 0.8))
           .color(pkg.Color(0, 0, 1, 1)).build())
    rad = (pkg.GradientBuilder(pkg.Point(40, 60), pkg.Point(70, 60))
           .type(pkg.GradientType.Radial)
           .color(pkg.Color(1, 1, 0, 0.9)).color(pkg.Color(0, 1, 1, 0.3)).build())
    _draw(pkg, comp, 0, _rect(pkg, 2, 2, 62, 94), pkg.Fill.Gradient(lin))
    _draw(pkg, comp, 1, _rect(pkg, 20, 30, 60, 90), pkg.Fill.Gradient(rad))
    _draw(pkg, comp, 2, _rect(pkg, 0, 44, 64, 52), pkg.Fill.Solid(pkg.Color(0, 0, 0, 0.5)))
    return comp


def _texture_scene(pkg):
    """64x96: an 8x12 image of distinct texels stretched over the frame
    (8 pixels a texel), under a translucent solid bar."""
    rng = np.random.default_rng(5)
    texels = rng.integers(0, 256, (12 * 8, 4)).astype(int)
    texels[:, 3] = 255
    image = pkg.Image.from_srgba(texels, 8, 12)
    scale = pkg.AffineTransform(0.125, 0.0, 0.0, 0.125, 0.0, 0.0)
    comp = pkg.Composition()
    _draw(pkg, comp, 0, _rect(pkg, 0, 0, 64, 96),
          pkg.Fill.Texture(pkg.Texture(transform=scale, image=image)))
    _draw(pkg, comp, 1, _rect(pkg, 0, 44, 64, 52), pkg.Fill.Solid(pkg.Color(0, 0, 0, 0.5)))
    return comp


SCENES = {"solid": (_solid_scene, 64, 64), "gradient": (_gradient_scene, 64, 96),
          "texture": (_texture_scene, 64, 96)}


def _both(name, render):
    """`render(pkg, comp, w, h)` on each package's own build of the scene:
    (JAX's result, the port's)."""
    build, w, h = SCENES[name]
    return tuple(render(pkg, build(pkg), w, h) for pkg in (forma_tpu, forma_tpu_torch))


def test_crop_matches_full_render_inside():
    def run(pkg, comp, w, h):
        clear = pkg.Color(1.0, 1.0, 1.0, 1.0)
        full = _renderer(pkg).render(comp, w, h, clear)
        buf = np.full((h, w * 4), 7, np.uint8)  # sentinel fill
        _renderer(pkg).render_into(
            comp, pkg.Buffer(buffer=buf, layout=pkg.LinearLayout(w, w * 4, h)), clear,
            crop=pkg.Rect.new(range(16, 48), range(16, 48)),  # tiles 1..3 both ways
        )
        return full, buf.reshape(h, w, 4)

    (_, jimg), (full, img) = _both("solid", run)
    np.testing.assert_array_equal(img[16:48, 16:48], full[16:48, 16:48])
    assert (img[:16] == 7).all() and (img[48:] == 7).all()
    assert (img[16:48, :16] == 7).all() and (img[16:48, 48:] == 7).all()
    assert _max_diff(img, jimg) <= 1


def test_crop_bottom_rows():
    def run(pkg, comp, w, h):
        clear = pkg.Color(1.0, 1.0, 1.0, 1.0)
        r = _renderer(pkg)
        full = r.render(comp, w, h, clear)
        return full, r.render(comp, w, h, clear, crop=pkg.Rect.new(range(0, 64),
                                                                   range(32, 64)))

    (_, jgot), (full, got) = _both("solid", run)
    np.testing.assert_array_equal(got[32:64], full[32:64])
    assert (got[:32] == 0).all()
    assert _max_diff(got, jgot) <= 1


@pytest.mark.parametrize("name", ["gradient", "texture"])
def test_fills_cropped_away_from_row_0(name):
    """Tile rows [2, 5) and tile columns [1, 3): the port's cropped frame
    equals its full frame inside the rect, and JAX's cropped frame within
    1/255.  Without K3's row_lo the fills would shift up by 32 rows."""
    crop = (range(16, 48), range(32, 80))

    def run(pkg, comp, w, h):
        clear = pkg.Color(1.0, 1.0, 1.0, 1.0)
        r = _renderer(pkg)
        return (r.render(comp, w, h, clear),
                r.render(comp, w, h, clear, crop=pkg.Rect.new(*crop)))

    (_, jgot), (full, got) = _both(name, run)
    inside = (slice(32, 80), slice(16, 48))
    np.testing.assert_array_equal(got[inside], full[inside])
    assert (got[:32] == 0).all() and (got[80:] == 0).all()
    assert (got[32:80, :16] == 0).all() and (got[32:80, 48:] == 0).all()
    assert _max_diff(got, jgot) <= 1
    # The rows differ from each other, so a shifted fill would show.
    assert len({full[y, 30].tobytes() for y in range(32, 80, 16)}) == 3


def _fold_args(monkeypatch):
    """The positional arguments the port's pipeline hands to `fold_tiles`
    for the gradient scene (after one render grew the buckets)."""
    comp = _gradient_scene(forma_tpu_torch)
    r = Renderer("cpu")
    clear = forma_tpu_torch.Color(1.0, 1.0, 1.0, 1.0)
    r.render(comp, 64, 96, clear)
    seen = []
    real = paint.fold_tiles

    def spy(*args, **kwargs):
        seen.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(paint, "fold_tiles", spy)
    r.render(comp, 64, 96, clear)
    return seen[-1]


def test_fold_row_lo_and_skip_match_pallas(monkeypatch):
    """K3's plain fold with row_lo = 3 and every third tile skipped against
    JAX's interpret-mode Pallas fold given the same: skipped tiles stay at
    the clear colour, the others evaluate their gradients 48 rows down."""
    args = _fold_args(monkeypatch)
    (key_u, u_valid, src_u, src2_u, virt_u, grid, ci, ca, tx_s, style_s, clear,
     rows, tiles_x, k_slots, features, ms, _atlas) = args
    assert features.has_gradient
    skip = torch.arange(rows * tiles_x) % 3 == 1
    got = fold_tiles(*args, row_lo=3, tile_skip=skip).numpy()

    def j(t, dt):
        return jnp.asarray(t.numpy().astype(dt))

    zeros = jnp.zeros(key_u.shape, jnp.int32)
    want = np.asarray(jpaint._paint_fold_pallas(
        j(key_u, np.uint32), zeros, j(src_u, np.int32), j(src2_u, np.int32),
        j(virt_u, np.int32), zeros, jnp.asarray(u_valid.numpy()),
        j(grid, np.int32), j(ci, np.int32), j(ca, np.int32),
        j(style_s, np.int32), jnp.asarray(clear.numpy()),
        rows, tiles_x, k_slots, jpaint.Features(*features), ms,
        row_lo=3, tile_unchanged=jnp.asarray(skip.numpy()),
        tx_s=j(tx_s, np.int32), presorted=True, interpret=True,
    ))
    assert got.shape == want.shape == (rows * tiles_x, 16, 16, 4)
    assert np.abs(got - want).max() <= 1e-6
    assert (got[skip.numpy()] == clear.numpy()).all()
    unshifted = fold_tiles(*args).numpy()
    assert (got[~skip.numpy()] != unshifted[~skip.numpy()]).any()


@pytest.mark.parametrize("name", ["gradient", "texture"])
def test_two_key_crop_equals_packed(name, monkeypatch):
    """A cropped frame on the two-key route (`slot_bits_for` replaced by
    0: K1, the emit in PyTorch, the int64 sort, K3 in assembly mode with
    row_lo) equals the same crop on the packed key."""
    build, w, h = SCENES[name]
    comp = build(forma_tpu_torch)
    clear = forma_tpu_torch.Color(1.0, 1.0, 1.0, 1.0)
    crop = forma_tpu_torch.Rect.new(range(16, 64), range(16, 80))
    packed = Renderer("cpu").render(comp, w, h, clear, crop=crop)
    taps = {}
    monkeypatch.setattr(pipeline, "slot_bits_for", lambda *_: 0)
    r = Renderer("cpu")
    got = r.render(comp, w, h, clear, crop=crop)
    r.render_device(comp, w, h, clear, row_span=(1, 5), crop_x=(1, 4), taps=taps)
    assert taps["rasterize_sort"][10] == 0 and taps["fold"][2] is not taps["fold"][3]
    assert taps["fold"][15] == 1
    np.testing.assert_array_equal(got, packed)
