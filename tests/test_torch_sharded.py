"""The PyTorch port's multi-device frames against the JAX package's, on the
8-device virtual CPU mesh that `tests/conftest.py` forces, with
`devices=["cpu"] * 8` on the port's side (8 shards in turn on the CPU):

- the row-sharded circles frame of `tests/test_multichip.py` (64x256, 2
  tile rows a shard) and the line-sharded frames of
  `tests/test_multichip_lines.py` (circles; full-bleed and band-crossing
  geometry; `xcap` 1024, and tight buckets where blocks' starts clamp)
  bit-equal to JAX's `render_frame_sharded` / `render_frame_sharded_lines`
  on the same arguments, diag vectors included (the line path's 8
  entries);
- the full-feature scene (gradients, a texture, a clip, non-Over blends,
  EvenOdd) through both facades: bit-equal to the port's single-device
  frame and within 1/255 of JAX's sharded frame (XLA contracts into FMA
  on the CPU, `ROADMAP.md` section 3);
- `line_setup_pairs` on round-robin-permuted pairs and
  `Renderer._prepare_line_pairs` equal to JAX's;
- both facades against `render_device`, with padded tile rows, the
  exchange capacity grown from below its floor, `check_caps=False`, the
  wide-key fallback, and the line path at n = 1 against `render_frame`;
- the mesh: `all_to_all` is its own inverse, `pmax` / `psum`, the
  exchange blocks against a plain slicing of the sorted stream, and too
  few devices or a CPU shard for a CUDA renderer raise;
- the sharded frames as graphs (`torch_fixtures.py`'s stand-in graph):
  both facades, whole in one graph and one graph a card's piece,
  bit-equal to the eager facades and to JAX; meshes keyed by their
  devices; the three entry points alternating on one renderer, one graph
  a key; a grown `xcap` or line bucket superseding the old line graphs;
  no host read inside either frame; the line frame's halves called by
  hand for two groups of shards.  JAX's frames are computed once a
  module (`jax_frames`)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from forma_tpu import (
    BlendMode, Color, Composition, Fill, FillRule, Func, GradientBuilder,
    GradientType, Image, Order, PathBuilder, Point, Props, Style, Texture,
)
from forma_tpu.demos import scenes as jax_scenes
from forma_tpu.math import AffineTransform
from forma_tpu.ops import pipeline as jpipe
from forma_tpu.ops.line_setup import line_setup_pairs as jax_line_setup_pairs
from forma_tpu.renderer import Renderer as JaxRenderer
from forma_tpu_torch import RGBA, Caps, Renderer
from forma_tpu_torch.convert import composition_from_jax
from forma_tpu_torch.graphs import FrameGraphs
from forma_tpu_torch.mesh import Mesh
from forma_tpu_torch.ops import pipeline
from forma_tpu_torch.ops.line_setup import line_setup_pairs
from forma_tpu_torch.ops._u32 import from_numpy
from forma_tpu_torch.ops.paint import Features
from forma_tpu_torch.ops.rasterize_kernel import PACKED_SENTINEL, ZERO_PAYLOAD

from test_multichip import _prep_scene
from test_multichip_lines import _scene_args, custom_circle_path
from torch_fixtures import cpu_graphs, no_reads, one_torch_thread  # noqa: F401 (fixtures)

N = 8
DEVICES = ["cpu"] * N
CLEAR = Color(1.0, 1.0, 1.0, 1.0)
CHANNELS = (0, 1, 2, 3)


def _np(a):
    return {k: np.asarray(v) for k, v in a.items()} if isinstance(a, dict) else np.asarray(a)


def _port_args(args):
    """JAX arguments (a dict for the style tables) as the port's tensors on
    the CPU, u32 widened to int64 (`convert.from_jax_args` for any
    argument list)."""
    return tuple(
        {k: from_numpy(v, "cpu") for k, v in _np(a).items()} if isinstance(a, dict)
        else from_numpy(_np(a), "cpu")
        for a in args
    )


def _cat(frames) -> np.ndarray:
    return torch.cat(frames).numpy()


def _max_diff(a, b) -> int:
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(int) - b.astype(int)).max())


# -- scenes (built in the JAX package) ---------------------------------------


def _circles(n=16, width=64, height=256):
    comp = Composition()
    jax_scenes.circles(comp, n, width, height)
    return comp


def _rect(x0, y0, x1, y1):
    return (PathBuilder().move_to(Point(x0, y0)).line_to(Point(x0, y1))
            .line_to(Point(x1, y1)).line_to(Point(x1, y0)).build())


def _full_bleed(width=64, height=256):
    """`test_multichip_lines.py`'s full-bleed background left of the
    viewport and a tall triangle across all 8 row bands."""
    comp = Composition()
    bg = (PathBuilder().move_to(Point(-40.5, -7.25)).line_to(Point(-40.5, height + 3.5))
          .line_to(Point(width - 10.75, height + 3.5)).line_to(Point(width - 10.75, -7.25))
          .build())
    comp.get_mut_or_insert_default(Order(0)).insert(bg).set_props(
        Props(func=Func.Draw(Style(fill=Fill.Solid(Color(0.3, 0.5, 0.9, 1.0))))))
    tall = (PathBuilder().move_to(Point(5.1, -3.0)).line_to(Point(60.9, height * 0.5))
            .line_to(Point(8.4, height + 5.0)).build())
    comp.get_mut_or_insert_default(Order(3)).insert(tall).set_props(
        Props(func=Func.Draw(Style(fill=Fill.Solid(Color(0.9, 0.4, 0.1, 0.7))))))
    return comp


def _full_feature(width=64, height=256):
    """`test_multichip_lines.py::test_line_sharded_full_feature_scene`'s
    scene: linear and radial gradients, Multiply and Screen, a texture
    with a fractional offset, EvenOdd, and a clip across two bands."""
    comp = Composition()
    g = (GradientBuilder(Point(0.0, 0.0), Point(0.0, float(height)))
         .color(Color(0.9, 0.2, 0.1, 1.0)).color(Color(0.1, 0.3, 0.9, 1.0)).build())
    comp.get_mut_or_insert_default(Order(0)).insert(
        _rect(-20.5, -8.25, width + 6.0, height + 4.0)
    ).set_props(Props(func=Func.Draw(Style(fill=Fill.Gradient(g)))))
    rb = GradientBuilder(Point(32.0, 48.0), Point(62.0, 48.0))
    rb.type(GradientType.Radial)
    rb.color(Color(1.0, 1.0, 0.2, 1.0)).color(Color(0.2, 1.0, 0.6, 0.0))
    comp.get_mut_or_insert_default(Order(1)).insert(_rect(4.0, 20.0, 60.0, 76.0)).set_props(
        Props(func=Func.Draw(Style(fill=Fill.Gradient(rb.build()),
                                   blend_mode=BlendMode.Multiply))))
    texels = np.random.default_rng(7).integers(0, 255, size=(8, 8, 4), dtype=np.uint8)
    texels[..., 3] = 255
    tex = Texture(transform=AffineTransform(1.0, 0.0, 0.0, 1.0, -10.0, -96.0),
                  image=Image.from_srgba(texels, 8, 8))
    comp.get_mut_or_insert_default(Order(2)).insert(_rect(10.3, 96.6, 54.9, 140.2)).set_props(
        Props(func=Func.Draw(Style(fill=Fill.Texture(tex)))))
    bow = (PathBuilder().move_to(Point(8.0, 150.0)).line_to(Point(56.0, 190.0))
           .line_to(Point(8.0, 190.0)).line_to(Point(56.0, 150.0)).build())
    comp.get_mut_or_insert_default(Order(3)).insert(bow).set_props(
        Props(fill_rule=FillRule.EvenOdd,
              func=Func.Draw(Style(fill=Fill.Solid(Color(0.2, 0.9, 0.4, 0.8)),
                                   blend_mode=BlendMode.Screen))))
    comp.get_mut_or_insert_default(Order(4)).insert(
        custom_circle_path(32.0, 216.0, 30.0)).set_props(Props(func=Func.Clip(2)))
    comp.get_mut_or_insert_default(Order(5)).insert(_rect(0.0, 196.0, 64.0, 236.0)).set_props(
        Props(func=Func.Draw(Style(fill=Fill.Solid(Color(0.9, 0.9, 0.1, 0.9)),
                                   is_clipped=True))))
    comp.get_mut_or_insert_default(Order(6)).insert(_rect(16.0, 204.0, 48.0, 252.0)).set_props(
        Props(func=Func.Draw(Style(fill=Fill.Solid(Color(0.5, 0.1, 0.8, 0.6)),
                                   is_clipped=True))))
    return comp


# -- the sharded pipelines against JAX's --------------------------------------

ROW_CAPS = (2048, 2048, 2048, 8)  # `test_multichip.py`'s buckets


@pytest.fixture(scope="module")
def jax_frames():
    """JAX's sharded frames, each computed (and compiled) once a module:
    `get("rows")` is `test_multichip.py`'s circles frame (64x256, 2 tile
    rows a shard), `get("lines", scene, vline, xcap)` a line-sharded
    frame of `test_multichip_lines.py`'s circles or full-bleed scene at
    64x256; each returns (JAX's arguments, features, frame, diag)."""
    done = {}

    def get(path, scene="circles", vline=None, xcap=None):
        key = (path, scene, vline, xcap)
        if key not in done:
            mesh = jax.make_mesh((N,), ("rows",))
            if path == "rows":
                args, features = _prep_scene(64, 256)
                out = jpipe.render_frame_sharded(
                    *args, width=64, height=256, rows=2, tiles_x=4,
                    caps=jpipe.Caps(*ROW_CAPS), features=features, channels=CHANNELS,
                    mesh=mesh)
            else:
                comp = _circles() if scene == "circles" else _full_bleed()
                _, args, features = _scene_args(comp, 64, 256)
                out = jpipe.render_frame_sharded_lines(
                    *args, width=64, height=256, rows=2, tiles_x=4,
                    caps=jpipe.Caps(vline=vline, run=512, virt=512, k=8),
                    features=features, channels=CHANNELS, mesh=mesh, xcap=xcap)
            done[key] = (args, features, np.asarray(out[0]), np.asarray(out[1]))
        return done[key]

    return get


def test_row_sharded_circles_matches_jax(jax_frames):
    """`test_multichip.py`'s scene and buckets: the port's shards
    concatenated equal JAX's sharded frame, and the pmax'd diag equals
    JAX's."""
    width, rows = 64, 2
    args, features, want, want_d = jax_frames("rows")
    frames, diag = pipeline.render_frame_sharded(
        *_port_args(args), width, rows * 16 * N, rows, width // 16, Caps(*ROW_CAPS),
        Features(*features), CHANNELS, Mesh(DEVICES),
    )
    assert len(frames) == N and frames[0].shape == (rows * 16, width, 4)
    np.testing.assert_array_equal(_cat(frames), want)
    np.testing.assert_array_equal(diag.numpy(), want_d)


@pytest.mark.parametrize("scene, vline, xcap, clamped", [
    pytest.param("circles", 512, 1024, 0, id="circles"),
    pytest.param("full_bleed", 512, 1024, 0, id="full_bleed"),
    pytest.param("circles", 96, 512, 8, id="circles-clamped"),
    pytest.param("full_bleed", 48, 256, 5, id="full_bleed-clamped"),
])
def test_line_sharded_matches_jax(scene, vline, xcap, clamped, monkeypatch, jax_frames):
    """`test_multichip_lines.py`'s circles and full-bleed / band-crossing
    frames: bit-equal to JAX's, all 8 diag entries equal.  At
    `_compare`'s buckets (`xcap` 1024) no block's start clamps; at the
    tight ones `clamped` shards cut a block whose window starts at
    `s_loc - xcap`, past its destination's first segment, where the keep
    mask must match JAX's `dynamic_slice` (every frame still fits its
    buckets and `xcap`)."""
    width, height = 64, 256
    sharded, features, want, want_d = jax_frames("lines", scene, vline, xcap)
    caps = Caps(vline=vline, run=512, virt=512, k=8)
    shards_clamped = []
    cut = pipeline._exchange_blocks

    def counting(packed, payload, n, rows, shift, xcap):
        edges = torch.searchsorted(packed, (torch.arange(n + 1, dtype=torch.int32) * rows + 1) << shift)
        late = (edges[:-1] > packed.shape[0] - xcap) & (edges[1:] > edges[:-1])
        shards_clamped.append(bool(late.any()))
        return cut(packed, payload, n, rows, shift, xcap)

    monkeypatch.setattr(pipeline, "_exchange_blocks", counting)
    frames, diag = pipeline.render_frame_sharded_lines(
        *_port_args(sharded), width, height, 2, 4, caps, Features(*features),
        CHANNELS, Mesh(DEVICES), xcap,
    )
    assert sum(shards_clamped) == clamped
    np.testing.assert_array_equal(_cat(frames), want)
    d = diag.numpy()
    assert d.shape == (8,) and d[pipeline.DIAG_SEGS] > 0
    assert d[pipeline.DIAG_XPAIR] <= xcap and d[pipeline.DIAG_VLINES] <= vline
    np.testing.assert_array_equal(d, want_d)


@pytest.mark.parametrize("path", ["rows", "lines"])
def test_full_feature_scene(path):
    """Every style feature through each facade: bit-equal to the port's
    single-device frame, within 1/255 of JAX's sharded frame."""
    width, height = 64, 256
    comp = _full_feature()
    port = composition_from_jax(comp)
    method = {"rows": "render_device_sharded", "lines": "render_device_sharded_lines"}[path]
    frames, d = getattr(Renderer("cpu"), method)(port, width, height, CLEAR, devices=DEVICES)
    single, _ = Renderer("cpu").render_device(port, width, height, CLEAR)
    got = _cat(frames)
    np.testing.assert_array_equal(got, single.numpy())
    want, _ = getattr(JaxRenderer(), method)(comp, width, height, CLEAR, n_shards=N)
    assert _max_diff(got, np.asarray(want)) <= 1
    assert d[pipeline.DIAG_K] > 0


# -- the line-pair inputs ----------------------------------------------------


def test_line_setup_pairs_matches_jax():
    """Round-robin-permuted pairs of the full-bleed scene, whole and one
    shard's eighth, through both packages' `line_setup_pairs`."""
    comp = _full_bleed()
    _, sharded, _ = _scene_args(comp, 64, 256)
    shard = tuple(np.asarray(a) for a in sharded[:5])
    for cut in (slice(None), slice(2 * len(shard[0]) // N, 3 * len(shard[0]) // N)):
        pairs = tuple(np.array(a[cut]) for a in shard)
        want = jax_line_setup_pairs(*(jnp.asarray(a) for a in pairs), *sharded[5:9],
                                    64, 256, k_seg=8)
        got = line_setup_pairs(*(torch.from_numpy(a) for a in pairs),
                               *_port_args(sharded[5:9]),
                               64, 256, k_seg=8)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))


@pytest.mark.parametrize("n", [3, 8])
def test_prepare_line_pairs_matches_jax(n):
    comp = _circles(12, 64, 200)
    want = JaxRenderer()._prepare_line_pairs(comp, n)
    r = Renderer("cpu")
    got = r._prepare_line_pairs(composition_from_jax(comp), n)
    assert got[0].shape[0] % n == 0
    for g, w in zip(got, want[:5]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert r._prepare_line_pairs(composition_from_jax(comp), n)[0].shape == got[0].shape


# -- the facades against the single-device frame ------------------------------


@pytest.mark.parametrize("path", ["rows", "lines"])
def test_facade_matches_render_device(path):
    """64x200: 13 tile rows pad to 16 over 8 shards.  The line path starts
    its exchange capacity below any block (128 slots), so it must grow
    in the loop.  The diag keeps the single frame's DIAG_K, DIAG_SEGS and
    DIAG_DMG (and on the row path DIAG_VLINES: every shard sees every
    line); the other totals are one shard's at most."""
    width, height = 64, 200
    comp = composition_from_jax(_circles(24, width, height))
    single, d1 = Renderer("cpu").render_device(comp, width, height, CLEAR)
    r = Renderer("cpu")
    if path == "rows":
        frames, d = r.render_device_sharded(comp, width, height, CLEAR, devices=DEVICES)
    else:
        r._lines_n, r._caps_lines, r._xcap = N, Caps(vline=256, run=256, virt=256, k=8), 128
        frames, d = r.render_device_sharded_lines(comp, width, height, CLEAR, devices=DEVICES)
        assert r._xcap > 128 and r.regrow_count > 0
        assert r._xcap >= d[pipeline.DIAG_XPAIR] > 128
    assert len(frames) == N and torch.cat(frames).shape == (16 * 16, width, 4)
    np.testing.assert_array_equal(_cat(frames)[:height], single.numpy()[:height])
    assert r.last_diag is d
    kept = [pipeline.DIAG_K, pipeline.DIAG_SEGS, pipeline.DIAG_DMG]
    kept += [pipeline.DIAG_VLINES] if path == "rows" else []
    np.testing.assert_array_equal(d[kept], d1[kept])
    assert (d[:4] <= d1[:4]).all() and (d[1:3] < d1[1:3]).all()


def test_check_caps_false_reads_nothing_back():
    """With `check_caps=False` the diag stays a tensor, and once the
    buckets are warm the frames equal the checked ones."""
    width, height = 64, 256
    comp = composition_from_jax(_circles())
    r = Renderer("cpu")
    want, d = r.render_device_sharded_lines(comp, width, height, CLEAR, devices=DEVICES)
    frames, diag = r.render_device_sharded_lines(
        comp, width, height, CLEAR, devices=DEVICES, check_caps=False)
    assert isinstance(diag, torch.Tensor)
    np.testing.assert_array_equal(diag.numpy(), d)
    np.testing.assert_array_equal(_cat(frames), _cat(want))


def test_wide_key_routes_lines_to_rows(monkeypatch):
    """Where `slot_bits_for` gives 0 the line facade renders the
    row-sharded frame (two-key route on every shard) and equals the
    single frame."""
    width, height = 64, 256
    comp = composition_from_jax(_circles(12))
    single, _ = Renderer("cpu").render_device(comp, width, height, CLEAR)
    calls = []
    monkeypatch.setattr(pipeline, "slot_bits_for", lambda *_: 0)
    monkeypatch.setattr(pipeline, "render_frame_sharded_lines",
                        lambda *a, **k: calls.append(a))
    r = Renderer("cpu")
    frames, d = r.render_device_sharded_lines(comp, width, height, CLEAR, devices=DEVICES)
    assert not calls and d.shape == (6,)
    np.testing.assert_array_equal(_cat(frames), single.numpy())


def test_lines_at_one_shard_equal_render_frame():
    """n = 1: the exchange is an identity and the frame is `render_frame`'s,
    diag included; the one block holds every segment in the frame's rows
    (DIAG_SEGS also counts those above and below it)."""
    width, height = 64, 128
    comp = composition_from_jax(_full_bleed(width, height))
    r = Renderer("cpu")
    inputs, st_host, chans = r._frame_inputs(comp, width, height, CLEAR, RGBA)
    caps = Caps(vline=512, run=512, virt=512, k=8)
    want, want_d = pipeline.render_frame(*inputs, width, height, 8, 4, caps,
                                         st_host.features, chans)
    frames, diag = pipeline.render_frame_sharded_lines(
        *r._prepare_line_pairs(comp, 1), *inputs[3:], width, height, 8, 4, caps,
        st_host.features, chans, Mesh(["cpu"]), 4096,
    )
    np.testing.assert_array_equal(frames[0].numpy(), want.numpy())
    d = diag.numpy()
    np.testing.assert_array_equal(d[:6], want_d.numpy())
    assert 0 < d[pipeline.DIAG_XPAIR] == d[pipeline.DIAG_XRECV] < d[pipeline.DIAG_SEGS]


def test_line_sharded_refuses_a_wide_key(monkeypatch):
    width, height = 64, 128
    comp = composition_from_jax(_circles(4, width, height))
    r = Renderer("cpu")
    inputs, st_host, chans = r._frame_inputs(comp, width, height, CLEAR, RGBA)
    monkeypatch.setattr(pipeline, "slot_bits_for", lambda *_: 0)
    with pytest.raises(ValueError, match="packed key"):
        pipeline.render_frame_sharded_lines(
            *r._prepare_line_pairs(comp, 2), *inputs[3:], width, height, 4, 4,
            Caps(), st_host.features, chans, Mesh(["cpu"] * 2), 1024,
        )


# -- the mesh and the exchange -----------------------------------------------


@pytest.mark.parametrize("n, devices", [(1, ["cpu"]), (3, ["cpu"] * 3), (8, DEVICES)])
def test_all_to_all_is_its_own_inverse(n, devices):
    rng = np.random.default_rng(n)
    mesh = Mesh(devices)
    blocks = [torch.from_numpy(rng.integers(-9, 9, size=(n, 5), dtype=np.int32))
              for _ in range(n)]
    recv = mesh.all_to_all(blocks)
    for d in range(n):
        for s in range(n):
            assert torch.equal(recv[d][5 * s:5 * s + 5], blocks[s][d])
    back = mesh.all_to_all([r.reshape(n, 5) for r in recv])
    for b, w in zip(back, blocks):
        assert torch.equal(b.reshape(n, 5), w)


def test_pmax_psum():
    mesh = Mesh(["cpu"] * 3)
    vals = [torch.tensor([1, 7, 2]), torch.tensor([4, 0, 2]), torch.tensor([3, 5, 9])]
    assert mesh.pmax(vals).tolist() == [4, 7, 9]
    assert mesh.psum(vals).tolist() == [8, 12, 13]


@pytest.mark.parametrize("xcap, clamps, overflows", [(64, False, True), (256, True, False)])
def test_exchange_blocks_match_plain_slicing(xcap, clamps, overflows):
    """Random sorted streams: destination d's block is the window of xcap
    slots from its first segment (the start clamped to the stream's last
    xcap slots), holding d's segments where they lie in the window, the
    rest sentinel and zero payload; the max count is the largest
    destination's."""
    rng = np.random.default_rng(5)
    n, rows, shift, s_loc = 4, 3, 9, 512
    rowb = rng.integers(1, n * rows + 1, size=s_loc - 40)
    keys = np.sort(np.concatenate([
        (rowb << shift) | rng.integers(0, 1 << shift, size=rowb.size),
        np.full(40, PACKED_SENTINEL)])).astype(np.int32)
    payload = rng.integers(0, 1 << 30, size=s_loc).astype(np.int32)
    k, p, max_pair = pipeline._exchange_blocks(
        torch.from_numpy(keys), torch.from_numpy(payload), n, rows, shift, xcap)
    dst = np.where(keys == PACKED_SENTINEL, n, ((keys >> shift) - 1) // rows)
    counts = [int((dst == d).sum()) for d in range(n)]
    assert int(max_pair) == max(counts)
    clamped = False
    for d in range(n):
        idx = np.flatnonzero(dst == d)
        start = min(idx[0], s_loc - xcap)
        kept = idx[idx < start + xcap]
        want_k = np.full(xcap, PACKED_SENTINEL, np.int32)
        want_p = np.full(xcap, ZERO_PAYLOAD, np.int32)
        want_k[kept - start] = keys[kept]
        want_p[kept - start] = payload[kept]
        np.testing.assert_array_equal(k[d].numpy(), want_k)
        np.testing.assert_array_equal(p[d].numpy(), want_p)
        clamped |= start < idx[0]
    assert (clamped, max(counts) > xcap) == (clamps, overflows)


def test_too_few_devices_and_wrong_device_types_raise():
    r = Renderer("cpu")
    comp = composition_from_jax(_circles(4, 64, 64))
    for call in (r.render_device_sharded, r.render_device_sharded_lines):
        with pytest.raises(ValueError, match="need 8 devices, have 1"):
            call(comp, 64, 64, CLEAR, n_shards=8)
        with pytest.raises(ValueError, match="need 3 devices, have 2"):
            call(comp, 64, 64, CLEAR, n_shards=3, devices=["cpu"] * 2)
    # A CUDA renderer never places a shard on the CPU; a mesh is one type.
    r.device = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="places no shard on cpu"):
        r._shard_mesh(2, ["cpu"] * 2)
    with pytest.raises(ValueError, match="one type"):
        Mesh(["cpu", "cuda:0"])


# -- the sharded frames as graphs ---------------------------------------------

SHARDED = {"rows": "render_device_sharded", "lines": "render_device_sharded_lines"}
# JAX's frame of each case: `jax_frames`' arguments (line frames at
# `_compare`'s buckets, which every facade frame here fits as well).
GRAPH_CASES = {("rows", "circles"): ("rows",),
               ("lines", "circles"): ("lines", "circles", 512, 1024),
               ("lines", "full_bleed"): ("lines", "full_bleed", 512, 1024)}


def _graph_renderer(cpu_graphs, monkeypatch, form: str):
    """A CPU renderer whose frames go through its graphs (the stand-in
    graph): a sharded frame whole in one graph ("one_card", as when every
    shard sits on the renderer's card), or one graph a card's piece
    ("per_card", forced: on the CPU every shard shares one device)."""
    r = cpu_graphs(Renderer("cpu"))
    if form == "per_card":
        monkeypatch.setattr(r, "_one_card", lambda mesh: False)
    return r


@pytest.mark.parametrize("form", ["one_card", "per_card"])
@pytest.mark.parametrize("path, scene", list(GRAPH_CASES))
def test_graph_facades_match_eager_and_jax(path, scene, form, cpu_graphs, monkeypatch,
                                           jax_frames):
    """Both facades through `FrameGraphs`, in both forms: frames and diag
    bit-equal to the eager facade's and to JAX's sharded frame; the live
    graphs are the whole frame's one, or a card's row piece, or its line
    front and back; a second frame (on a freshly built mesh, as every
    facade call builds one) replays them and captures nothing."""
    width, height = 64, 256
    comp = composition_from_jax(_circles() if scene == "circles" else _full_bleed())
    _, _, want, want_d = jax_frames(*GRAPH_CASES[path, scene])
    r = _graph_renderer(cpu_graphs, monkeypatch, form)
    call = getattr(r, SHARDED[path])
    frames, d = call(comp, width, height, CLEAR, devices=DEVICES)
    eager, de = getattr(Renderer("cpu"), SHARDED[path])(comp, width, height, CLEAR,
                                                        devices=DEVICES)
    np.testing.assert_array_equal(_cat(frames), _cat(eager))
    np.testing.assert_array_equal(d, de)
    np.testing.assert_array_equal(_cat(frames), want)
    np.testing.assert_array_equal(d, want_d)
    pieces = {"one_card": [pipeline.render_frame_sharded if path == "rows"
                           else pipeline.render_frame_sharded_lines],
              "per_card": [pipeline.row_shards] if path == "rows"
              else [pipeline.line_front, pipeline.line_back]}[form]
    assert [k[0] for k in r.graphs._graphs] == pieces
    captures, replays = r.graphs.captures, r.graphs.replays
    again, d2 = call(comp, width, height, CLEAR, devices=DEVICES)
    assert r.graphs.captures == captures and r.graphs.replays == replays + len(pieces)
    np.testing.assert_array_equal(_cat(again), want)
    np.testing.assert_array_equal(d2, want_d)


def test_a_fresh_mesh_keys_alike():
    """Meshes of the same devices are equal and hash alike, so a frame's
    key does not change with the `Mesh` object; other devices key apart."""
    assert Mesh(DEVICES) == Mesh(DEVICES) and hash(Mesh(DEVICES)) == hash(Mesh(DEVICES))
    assert Mesh(DEVICES) != Mesh(["cpu"] * 4)
    fg = FrameGraphs("cpu")
    args = (torch.zeros(3), 64, 256, 2, 4, Caps())
    keys = [fg.key(pipeline.render_frame_sharded, (*args, Mesh(d)), {}, {})[0]
            for d in (DEVICES, DEVICES, ["cpu"] * 4)]
    assert keys[0] == keys[1] != keys[2]


def test_alternating_frames_capture_once_per_key(cpu_graphs):
    """`render_device`, the row-sharded and the line-sharded frame in turn
    on one renderer: a first round captures one graph a key and one more
    for each bucket growth (which supersedes the graph of the old
    buckets), leaving three; further rounds only replay them."""
    width, height = 64, 256
    comp = composition_from_jax(_circles())
    r = cpu_graphs(Renderer("cpu"))
    calls = (lambda: r.render_device(comp, width, height, CLEAR),
             lambda: r.render_device_sharded(comp, width, height, CLEAR, devices=DEVICES),
             lambda: r.render_device_sharded_lines(comp, width, height, CLEAR,
                                                   devices=DEVICES))
    for call in calls:
        call()
    captures = r.graphs.captures
    assert captures == 3 + r.regrow_count and len(r.graphs) == 3
    replays = r.graphs.replays
    for _ in range(2):
        for call in calls:
            call()
    assert r.graphs.captures == captures and len(r.graphs) == 3
    assert r.graphs.evictions == 0 and r.graphs.replays == replays + 6


@pytest.mark.parametrize("grown", ["xcap", "caps_lines"])
def test_line_regrow_supersedes_line_graphs(grown, cpu_graphs):
    """A line-sharded frame that outgrows its exchange capacity or its
    per-shard buckets captures again at the grown ones: the graph of the
    old ones is dropped (superseded, no eviction), `render_device`'s graph
    stays, and the frame equals the eager facade's at the same start."""
    width, height = 64, 200
    comp = composition_from_jax(_circles(24, width, height))
    start = {"xcap": (Caps(vline=512, run=512, virt=512, k=8), 128),
             "caps_lines": (Caps(vline=256, run=256, virt=256, k=4), 4096)}[grown]
    want_r = Renderer("cpu")
    r = cpu_graphs(Renderer("cpu"))
    r.render_device(comp, width, height, CLEAR)
    single, grows = r.graphs.captures, r.regrow_count
    for rr in (want_r, r):
        rr._lines_n, (rr._caps_lines, rr._xcap) = N, start
    want, wd = want_r.render_device_sharded_lines(comp, width, height, CLEAR, devices=DEVICES)
    frames, d = r.render_device_sharded_lines(comp, width, height, CLEAR, devices=DEVICES)
    grows = r.regrow_count - grows
    assert (r._xcap > start[1] if grown == "xcap" else r._caps_lines != start[0])
    assert grows > 0
    assert r.graphs.captures - single == grows + 1 and r.graphs.evictions == 0
    assert [g.buckets for g in r.graphs._graphs.values()] == [
        ("_caps", r._caps), ("_caps_lines", r._caps_lines, r._xcap)]
    np.testing.assert_array_equal(_cat(frames), _cat(want))
    np.testing.assert_array_equal(d, wd)


@pytest.mark.parametrize("path", ["rows", "lines"])
def test_sharded_frames_read_nothing_back(path, no_reads):
    """With every host read of a tensor made to raise (the plain fold's
    depth excepted: no graph runs it), both sharded frames run: nothing
    in them stops a capture."""
    width, height = 64, 256
    comp = composition_from_jax(_circles())
    r = Renderer("cpu")
    inputs, st_host, chans = r._whole_frame_inputs(comp, width, height, CLEAR, RGBA)
    pairs = r._prepare_line_pairs(comp, N)
    mesh, caps = Mesh(DEVICES), Caps(vline=512, run=512, virt=512, k=8)
    with no_reads():
        if path == "rows":
            frames, diag = pipeline.render_frame_sharded(
                *inputs, width, height, 2, 4, caps, st_host.features, chans, mesh)
        else:
            frames, diag = pipeline.render_frame_sharded_lines(
                *pairs, *inputs[3:], width, height, 2, 4, caps, st_host.features, chans,
                mesh, 1024)
    assert len(frames) == N and diag.shape == ((6,) if path == "rows" else (8,))


def test_line_halves_by_card_equal_the_one_call_frame(jax_frames):
    """`line_front` and `line_back` called by hand for two groups of
    shards, as two cards would hold them (0-3 and 4-7), with the exchange
    (`all_to_all`) and the segment sum (`psum`) between the halves: the
    frame and diag of the one-call line frame, and of JAX's."""
    width, height, rows, tiles_x = 64, 256, 2, 4
    args, features, want, want_d = jax_frames("lines", "circles", 512, 1024)
    a = _port_args(args)
    caps, mesh = Caps(vline=512, run=512, virt=512, k=8), Mesh(DEVICES)
    one, one_d = pipeline.render_frame_sharded_lines(
        *a, width, height, rows, tiles_x, caps, Features(*features), CHANNELS, mesh, 1024)
    slot_bits = pipeline.slot_bits_for(a[9]["orders"].shape[0], rows * N, tiles_x)
    groups = ((0, 1, 2, 3), (4, 5, 6, 7))
    fronts = [f for s in groups for f in pipeline.line_front(
        *a[:9], width, height, rows, tiles_x, caps, N, 1024, slot_bits, shards=s)]
    recv_k = mesh.all_to_all([f[0] for f in fronts])
    recv_p = mesh.all_to_all([f[1] for f in fronts])
    total_segs = mesh.psum([f[3] for f in fronts])
    backs = [b for s in groups for b in pipeline.line_back(
        [recv_k[i] for i in s], [recv_p[i] for i in s], [fronts[i][2] for i in s],
        [fronts[i][4] for i in s], total_segs, a[9], a[10], rows, tiles_x, caps,
        Features(*features), CHANNELS, slot_bits, shards=s)]
    frames, diag = [b[0] for b in backs], mesh.pmax([b[1] for b in backs])
    for got, got_d in ((frames, diag), (one, one_d)):
        np.testing.assert_array_equal(_cat(got), want)
        np.testing.assert_array_equal(got_d.numpy(), want_d)
