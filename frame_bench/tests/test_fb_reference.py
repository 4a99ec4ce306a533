"""The frozen reference agrees with the port's CPU render on small seeded
scenes, and its flattening with the port's; the bfloat16 control does not; the
solid-fill scenes are composed and judged by the benchmark's own functions."""

import numpy as np
import pytest

from frame_bench.compose import compose
from frame_bench.reference import Reference
from frame_bench.reference.flatten import flatten
from frame_bench.reference.paint import round_bf16
from frame_bench.scenes import paint, paris30k, spaceship
from small import tiny

CFG = {
    "paris30k": dict(tiny("paris30k-1080p"), buildings=0.7, roads=0.2, clear=[1, 1, 1, 1]),
    "spaceship": dict(tiny("spaceship-1080p"), clear=[0, 0, 0, 1]),
}


def port_frame(scene, transforms):
    from forma_tpu_torch import Color, Order, Renderer

    comp = compose(scene)
    if transforms is not None:
        for i, row in enumerate(transforms.tolist()):
            comp.get_mut(Order(i)).set_transform(row)
    return Renderer("cpu").render(comp, scene.width, scene.height, Color(*scene.clear))


def whole(ref, transforms, lowp=None):
    rows = ref.rows(transforms, range(-(-ref.scene.height // 16)), lowp)
    return np.concatenate([rows[r] for r in sorted(rows)])


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
@pytest.mark.parametrize("name", ["paris30k", "spaceship"])
def test_reference_matches_port(name, seed):
    mod = {"paris30k": paris30k, "spaceship": spaceship}[name]
    scene = mod.build(CFG[name], seed)
    transforms = None
    if name == "spaceship":
        anim = mod.animator(scene, CFG[name], seed)
        for _ in range(7):
            transforms = anim.step(1 / 60)
    got = port_frame(scene, transforms)
    ref = Reference(scene)
    want = whole(ref, transforms)
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and np.count_nonzero(d) <= 0.001 * d.size
    low = whole(ref, transforms, round_bf16)
    if name == "paris30k":  # translucent layers over a light ground: most values move
        assert np.count_nonzero(low != want) > 0.05 * d.size


@pytest.mark.parametrize("name", ["paris30k", "spaceship"])
def test_solid_scenes_take_the_defaults(name):
    """A scene module that defines no `compose` or `Reference` of its own is
    composed and judged by the benchmark's, object for object."""
    assert paint(name) == (compose, Reference)


def test_flattening_matches_port():
    """The reference's copy flattens every path of a scene to the port's
    points, blobs of quadratic curves included."""
    from forma_tpu_torch import Point, PathBuilder

    scene = paris30k.build(CFG["paris30k"], 9)
    for verbs, pts in scene.paths[:1] + scene.paths[-20:]:
        b, k = PathBuilder(), 0
        for v in verbs:
            n = 4 if v == "Q" else 2
            p = [Point(pts[k + j], pts[k + j + 1]) for j in range(0, n, 2)]
            {"M": b.move_to, "L": b.line_to, "Q": b.quad_to}[v](*p)
            k += n
        x, y, end = b.build().push_segments_to()
        rx, ry, rend = flatten(verbs, pts)
        assert np.array_equal(x, rx) and np.array_equal(y, ry) and np.array_equal(end, rend)


def test_bf16_rounding():
    v = np.asarray([1.0, 1.0 + 2**-8, 1.0 + 3 * 2**-9, 0.1], np.float32)
    r = round_bf16(v)
    assert r[0] == 1.0 and r[1] == 1.0  # halfway: ties to the even 1.0
    assert r[2] == np.float32(1.0 + 2**-7)
    assert abs(r[3] - 0.1) < 0.1 * 2**-8 and r[3] != np.float32(0.1)
