"""Demo CLI: `python -m forma_tpu_torch.demos.main [device] {scene} [options]`.

The counterpart of `demo/src/main.rs`, and a copy of
`forma_tpu/demos/main.py` on the port: device `oracle|gpu|cpu` x scene
`circles N | svg FILE [-s SCALE] | spaceship | texture | paris`.  `oracle`
is the plain numpy renderer (`backend_numpy`), `gpu` `Renderer()` on the
CUDA card (it raises without one) and `cpu` `Renderer("cpu")`, every
kernel's plain PyTorch version.  Head-less: frames render to PNG files (or
just report timing with --no-save), with rolling min/avg/max frame stats
like the reference's window title; `--timings` prints
`Renderer.profile_frame`'s stage times.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="forma-tpu-torch-demo")
    ap.add_argument("device", choices=["oracle", "gpu", "cpu"])
    sub = ap.add_subparsers(dest="scene", required=True)

    p = sub.add_parser("circles")
    p.add_argument("count", type=int)
    p = sub.add_parser("svg")
    p.add_argument("file")
    p.add_argument("-s", "--scale", type=float, default=1.0)
    sub.add_parser("spaceship")
    sub.add_parser("texture")
    p = sub.add_parser("paris")
    p.add_argument("--paths", type=int, default=30000)

    for sp in sub.choices.values():
        sp.add_argument("--width", type=int, default=640)
        sp.add_argument("--height", type=int, default=360)
        sp.add_argument("--frames", type=int, default=1)
        sp.add_argument("--out", default="frame")
        sp.add_argument("--no-save", action="store_true")
        sp.add_argument(
            "--timings", action="store_true",
            help="print per-stage Timings (the reference's gpu::Timings "
            "window-title stats; gpu and cpu devices only)",
        )

    args = ap.parse_args(argv)

    from forma_tpu_torch import Color, Composition
    from forma_tpu_torch.demos import scenes
    from forma_tpu_torch.demos.spaceship import Spaceship

    comp = Composition()
    animate = None

    if args.scene == "circles":
        scenes.circles(comp, args.count, args.width, args.height)
    elif args.scene == "svg":
        from forma_tpu_torch.demos.svg import Svg

        svg = Svg(args.file, scale=args.scale)
        svg.compose(comp)

        def animate(i):
            svg.compose(comp, pan_x=i * 2.0, pan_y=0.0)

    elif args.scene == "spaceship":
        ship = Spaceship(width=args.width, height=args.height)
        ship.build(comp)

        def animate(i):
            ship.step()

    elif args.scene == "texture":
        _texture_scene(comp, args.width, args.height)
    else:
        scenes.paris30k(comp, args.width, args.height, paths=args.paths)

    if args.device == "oracle":
        from forma_tpu_torch.backend_numpy import render as _render

        def render():
            return _render(comp, args.width, args.height, clear_color=Color(1, 1, 1, 1))

    else:
        import numpy as np

        from forma_tpu_torch import Buffer, LinearLayout, Renderer

        renderer = Renderer("cpu" if args.device == "cpu" else None)
        # Damage cache: animated demos (spaceship) repaint only changed
        # tiles, the reference's incremental-update showcase.
        cache = renderer.create_buffer_layer_cache()
        backing = np.zeros((args.height, args.width * 4), np.uint8)
        buf = Buffer(
            buffer=backing,
            layout=LinearLayout(args.width, args.width * 4, args.height),
            layer_cache=cache,
        )

        def render():
            renderer.render_into(comp, buf, Color(1, 1, 1, 1))
            return backing.reshape(args.height, args.width, 4)

    times = []
    for i in range(args.frames):
        t0 = time.time()
        if animate is not None and i > 0:
            animate(i)
        img = render()
        times.append(time.time() - t0)
        if not args.no_save:
            from PIL import Image as PILImage

            name = f"{args.out}_{i:04d}.png" if args.frames > 1 else f"{args.out}.png"
            PILImage.fromarray(img, "RGBA").save(name)
    stats = (min(times) * 1e3, sum(times) / len(times) * 1e3, max(times) * 1e3)
    print(f"frames: {len(times)}  min/avg/max ms: {stats[0]:.1f}/{stats[1]:.1f}/{stats[2]:.1f}")

    if args.timings and args.device != "oracle":
        from forma_tpu_torch.profiling import timings_line

        t = renderer.profile_frame(comp, args.width, args.height, Color(1, 1, 1, 1))
        print(timings_line(t))


def _texture_scene(comp, width, height):
    """Rotating textured square (demo/src/demos/texture.rs)."""
    import numpy as np

    from forma_tpu_torch import (
        AffineTransform,
        Fill,
        Func,
        Image,
        Order,
        PathBuilder,
        Point,
        Props,
        Style,
        Texture,
    )

    rng = np.random.default_rng(3)
    tex_px = (rng.uniform(0, 255, (32, 32, 4))).astype(np.uint8)
    tex_px[..., 3] = 255
    image = Image.from_srgba(tex_px.reshape(-1, 4), 32, 32)
    size = min(width, height) * 0.5
    x0 = (width - size) / 2
    y0 = (height - size) / 2
    sq = (
        PathBuilder()
        .move_to(Point(x0, y0))
        .line_to(Point(x0, y0 + size))
        .line_to(Point(x0 + size, y0 + size))
        .line_to(Point(x0 + size, y0))
        .build()
    )
    comp.get_mut_or_insert_default(Order(0)).insert(sq).set_props(
        Props(
            func=Func.Draw(
                Style(
                    fill=Fill.Texture(
                        Texture(
                            transform=AffineTransform(
                                ux=32.0 / size, vy=32.0 / size, tx=-x0 * 32.0 / size,
                                ty=-y0 * 32.0 / size,
                            ),
                            image=image,
                        )
                    )
                )
            )
        )
    )


if __name__ == "__main__":
    main()
