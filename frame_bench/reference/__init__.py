"""The plain NumPy reference renderer the benchmark judges frames by.

A frozen copy of the renderer's numpy oracle and of its flattening, over
the benchmark's plain scene description.  It imports nothing of the
program under test (`forma_tpu_torch`) and nothing of the JAX package.
"""

from .render import Reference  # noqa: F401
