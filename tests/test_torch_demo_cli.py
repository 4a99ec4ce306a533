"""The port's demo CLI (`python -m forma_tpu_torch.demos.main`):
`tests/test_demo_cli.py`'s cases with `cpu` (`Renderer("cpu")`) in place
of `tpu`, and `oracle`; the saved PNGs equal the JAX CLI's for `oracle`
and lie within 1/255 of its `tpu` frames for `cpu` (the device bar); the
svg scene's pans equal the oracle's render of the panned composition;
`--timings` prints `profile_frame`'s line; `gpu` raises without a card;
and the atlas keeps its size under texture churn on `Renderer("cpu")`."""

import numpy as np
import pytest
import torch

from forma_tpu.demos import main as jax_main
from forma_tpu_torch.demos import main as demo_main
from torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

SIZE = ["--width", "64", "--height", "64"]
TRIANGLE = ('<svg xmlns="http://www.w3.org/2000/svg" width="64" height="64">'
            '<path d="M8 8 L56 8 L32 56 Z" fill="#3366cc"/></svg>')


@pytest.mark.parametrize(
    "argv",
    [
        ["oracle", "circles", "16", *SIZE, "--no-save"],
        ["cpu", "circles", "16", *SIZE, "--no-save"],
        ["cpu", "spaceship", *SIZE, "--frames", "2", "--no-save"],
        ["oracle", "texture", *SIZE, "--no-save"],
        ["cpu", "paris", "--paths", "50", *SIZE, "--no-save"],
        ["oracle", "spaceship", *SIZE, "--frames", "2", "--no-save"],
        ["cpu", "texture", *SIZE, "--no-save"],
        ["oracle", "paris", "--paths", "50", *SIZE, "--no-save"],
    ],
)
def test_demo_cli_smoke(argv):
    demo_main.main(argv)


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGBA"))


def _frames(tmp_path, main, device, scene, frames):
    out = tmp_path / f"{main.__name__.split('.')[0]}_{device}"
    main.main([device, *scene, *SIZE, "--frames", str(frames), "--out", str(out)])
    if frames == 1:
        return [_png(f"{out}.png")]
    return [_png(f"{out}_{i:04d}.png") for i in range(frames)]


@pytest.mark.parametrize("scene", ["circles", "svg"])
def test_frames_match_jax_cli(tmp_path, scene):
    if scene == "svg":
        (tmp_path / "t.svg").write_text(TRIANGLE)
        argv, frames = ["svg", str(tmp_path / "t.svg")], 3
    else:
        argv, frames = ["circles", "16"], 1
    oracle = _frames(tmp_path, demo_main, "oracle", argv, frames)
    for got, want in zip(oracle, _frames(tmp_path, jax_main, "oracle", argv, frames)):
        np.testing.assert_array_equal(got, want)
    cpu = _frames(tmp_path, demo_main, "cpu", argv, frames)
    for got, want in zip(cpu, _frames(tmp_path, jax_main, "tpu", argv, frames)):
        assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1
    for got, want in zip(cpu, oracle):
        assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1
    assert (oracle[0][..., :3] != 255).any()


def test_svg_pans_match_oracle(tmp_path):
    """The svg scene pans by `compose(pan_x=2 i)` through `render_into`
    with a damage cache: each frame equals the oracle's render of the
    panned composition, within 1/255."""
    from forma_tpu_torch import Color, Composition
    from forma_tpu_torch.backend_numpy import render
    from forma_tpu_torch.demos.scenes import SVG_SAMPLE
    from forma_tpu_torch.demos.svg import Svg

    (tmp_path / "s.svg").write_text(SVG_SAMPLE)
    got = _frames(tmp_path, demo_main, "cpu", ["svg", str(tmp_path / "s.svg")], 3)
    svg, comp = Svg(SVG_SAMPLE), Composition()
    svg.compose(comp)
    for i, frame in enumerate(got):
        if i:
            svg.compose(comp, pan_x=2.0 * i, pan_y=0.0)
        want = render(comp, 64, 64, clear_color=Color(1, 1, 1, 1))
        assert int(np.abs(frame.astype(int) - want.astype(int)).max()) <= 1
    assert not np.array_equal(got[0], got[2])


def test_svg_scale_and_timings(tmp_path, capsys):
    (tmp_path / "s.svg").write_text(TRIANGLE)
    demo_main.main(["cpu", "svg", str(tmp_path / "s.svg"), "-s", "0.5", *SIZE,
                    "--timings", "--out", str(tmp_path / "half")])
    out = capsys.readouterr().out
    assert out.count("\n") == 2 and "timings ms: line_setup" in out and "k_active" in out
    img = _png(tmp_path / "half.png")
    assert (img[5, 15, :3] != 255).any() and (img[40, 40, :3] == 255).all()


def test_gpu_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo_main.main(["gpu", "circles", "4", *SIZE, "--no-save"])
    with pytest.raises(SystemExit):
        demo_main.main(["tpu", "circles", "4", *SIZE, "--no-save"])


def test_texture_churn_keeps_atlas_bounded():
    """Image churn across frames: dead images leave the atlas instead of
    growing it without bound (`style_map.rs:72-137` behaviour),
    `tests/test_demo_cli.py:40-72` on `Renderer("cpu")`."""
    from forma_tpu_torch import (
        AffineTransform, Color, Composition, Fill, Func, Image, Order, PathBuilder,
        Point, Props, Renderer, Style, Texture,
    )

    comp = Composition()
    sq = (
        PathBuilder()
        .move_to(Point(4, 4)).line_to(Point(4, 44))
        .line_to(Point(44, 44)).line_to(Point(44, 4)).build()
    )
    layer = comp.get_mut_or_insert_default(Order(0))
    layer.insert(sq)
    r = Renderer("cpu")
    rng = np.random.default_rng(0)
    for _ in range(12):
        texels = rng.integers(0, 255, (3000, 64, 4), np.uint8)
        img = Image.from_srgba(texels.reshape(-1, 4), 64, 3000)  # tall image
        layer.set_props(
            Props(func=Func.Draw(Style(fill=Fill.Texture(
                Texture(transform=AffineTransform(), image=img)
            ))))
        )
        out = r.render(comp, 48, 48, Color(1, 1, 1, 1))
        assert out.shape == (48, 48, 4)
        assert (out[10, 10, :3] != 255).any()
    # 12 x 3000 rows would overflow a 4096-row atlas without the collection.
    assert len(r._style_map.allocator) <= 2
