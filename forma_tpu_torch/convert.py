"""Carries the JAX package's frame state across to the port.

`from_jax_args` takes the argument tuple that `__graft_entry__._prep`
builds for `pipeline.render_frame` (geometry, transform tables, the style
table dict, the clear color), with every leaf as a numpy array
(`np.asarray` of each), and returns the same state as tensors on `device`
in the port's conventions: u32 leaves widen to int64 (`ops/_u32.py`).
"""

from __future__ import annotations

import numpy as np

from .ops._u32 import from_numpy


def from_jax_args(args, device):
    """(px, py, line_slot, g_slot, g_valid, g_t, g_has_t, st, clear) of
    numpy arrays (st a dict of them) -> the same tuple of tensors."""
    px, py, line_slot, g_slot, g_valid, g_t, g_has_t, st, clear = args
    flat = [
        from_numpy(np.asarray(a), device)
        for a in (px, py, line_slot, g_slot, g_valid, g_t, g_has_t)
    ]
    st_t = {k: from_numpy(np.asarray(v), device) for k, v in st.items()}
    return (*flat, st_t, from_numpy(np.asarray(clear), device))
