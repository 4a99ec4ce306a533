"""forma_tpu_torch: the forma-tpu renderer on PyTorch and CUDA.

The port of `forma_tpu` (JAX on a TPU) to PyTorch, with the TPU package's
Pallas kernels rewritten as CUDA kernels for Hopper (`csrc/`).  It stands
on its own: it carries its own copy of the host scene model
(`Composition`, paths, styles, buffers; plain numpy) and imports nothing
of `forma_tpu`.  `convert.composition_from_jax` rebuilds a composition of
the JAX package as one of the port, for tests that hold the two against
each other.

    from forma_tpu_torch import (
        Color, Composition, Fill, Func, Order, PathBuilder, Point, Props,
        Renderer, Style,
    )
    comp = Composition()
    square = (PathBuilder().move_to(Point(8, 8)).line_to(Point(8, 56))
              .line_to(Point(56, 56)).line_to(Point(56, 8)).build())
    comp.get_mut_or_insert_default(Order(0)).insert(square).set_props(
        Props(func=Func.Draw(Style(fill=Fill.Solid(Color(0, 0, 0, 1))))))
    img = Renderer().render(comp, 64, 64)   # u8 [H, W, 4]

Device rule: `Renderer()` renders on the CUDA card and raises when there
is none; only an explicit `Renderer("cpu")` runs on the CPU.  Tensors on a
CUDA device run the kernels; tensors on the CPU run each kernel's plain
PyTorch version.  `Renderer(expand="fused")` (the default) rasterizes
through the fused expand + emit kernel, `expand="split"` through the
expand kernel and the PyTorch emit.  `Renderer.profile_frame` times one
frame stage by stage (`Timings`); `tracing` holds the port's own spans
and the stage stamps inside its frame graphs.

Also: `demos.svg` (the SVG front end), `backend_numpy` (the plain numpy
oracle) and the demo CLI, `python -m forma_tpu_torch.demos.main`.
"""

from .buffer import (  # noqa: F401
    BGR0,
    BGR1,
    BGRA,
    RGB0,
    RGB1,
    RGBA,
    Buffer,
    BufferBuilder,
    BufferLayerCache,
    Channel,
    Flusher,
    Layout,
    LinearLayout,
    Rect,
)
from .composition import Composition, GeomId, Layer, Order, OrderError  # noqa: F401
from .math import AffineTransform, GeomPresTransform, Point  # noqa: F401
from .ops.pipeline import Caps  # noqa: F401
from .path import Path, PathBuilder  # noqa: F401
from .profiling import Timings  # noqa: F401
from .renderer import Renderer  # noqa: F401
from .styling import (  # noqa: F401
    BlendMode,
    Color,
    Fill,
    FillRule,
    Func,
    Gradient,
    GradientBuilder,
    GradientType,
    Image,
    Props,
    Style,
    Texture,
)
