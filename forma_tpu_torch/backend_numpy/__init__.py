"""Reference-exact NumPy backend.

A sequential, host-only implementation of the full 4-stage pipeline
(lines -> pixel segments -> sort -> paint) mirroring the reference CPU
backend operation-for-operation.  It exists to

  * pin the exact semantics against the reference's golden images, and
  * act as the differential oracle for the device backends (this package's
    CUDA kernels, the JAX package's Pallas kernels),
    the same role the CPU backend plays for the GPU backend in the
    reference (`forma/src/gpu/rasterizer/mod.rs:357-422`).

It is not a performance path.

A copy of `forma_tpu/backend_numpy/` over the port's own host scene model
(`consts`, `styling`, `buffer`, `composition`), bit-equal to it: the port's
oracle, for the demo CLI's `oracle` device and as a reference on a machine
without the JAX package.
"""

from .render import render, render_window  # noqa: F401
