"""forma_tpu_torch: the forma-tpu renderer on PyTorch and CUDA.

The port of `forma_tpu` (JAX on a TPU) to PyTorch, with the TPU package's
Pallas kernels rewritten as CUDA kernels for Hopper (`csrc/`).  It
imports the host scene model (`Composition`, paths, styles) from
`forma_tpu`, which loads no JAX, and owns everything that touches the
device.  Tensors on a CUDA device run the kernels; tensors on the CPU run
each kernel's plain PyTorch version.

    from forma_tpu import Composition, ...
    from forma_tpu_torch import Renderer
    img = Renderer("cuda").render(comp, 1920, 1080)   # u8 [H, W, 4]
"""

from .ops.pipeline import Caps  # noqa: F401
from .renderer import Renderer  # noqa: F401
