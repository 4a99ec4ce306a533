"""What the benchmark reads of the program's two-key route, the frames whose
[row | slot | tx] sort key passes 31 bits: its stage stamps, and the work
of its expansion kernel (K1, `csrc/expand.cu`), which a packed frame runs
only where the caller asks for the `split` path, never by default.

The work is counted as `roofline.py` counts K3's and K2's: from the
frame's diagnostics vector, each input and output byte once, whatever
implements the stage.
"""

from __future__ import annotations

import importlib

from . import program
from .roofline import DIAG_SEGS, DIAG_VLINES

K_SEG = 8  # pixel segments a virtual line holds at most (the port's `pipeline.K_SEG`)
PARAMS = 16  # f32 coefficients a line (and a virtual line)


def stage_ms(stage: str):
    """`program.stage_ms(stage)`; 0 where the program stamps the stage
    (`tracing.STAGES`) but none of its frames took the route; None where
    it has no such stage, as before the route stamped its own."""
    try:
        tracing = importlib.import_module("forma_tpu_torch.tracing")
    except ImportError:
        return None
    if stage not in getattr(tracing, "STAGES", ()):
        return None
    ms = program.stage_ms(stage)
    return 0.0 if ms is None else ms


def expand_work(diag):
    """(bytes, f32 operations) of the virtual-line expansion (K1).

    Writes each virtual line's params (16 f32) and its index in its line
    (i32); reads each live line's params (16 f32) and virtual-line end
    (i64) once.  The diagnostics count virtual lines V and pixel segments
    S, not lines: a line of s segments has ceil(s / K_SEG) virtual lines,
    at most s / 8 + 7 / 8, so the live lines number at least (8 V - S) / 7,
    and one while V > 0; that is the count taken.  Copies only: no f32
    operations."""
    v, segs = int(diag[DIAG_VLINES]), int(diag[DIAG_SEGS])
    lines = max(-(-(K_SEG * v - segs) // (K_SEG - 1)), min(v, 1))
    return v * (PARAMS * 4 + 4) + lines * (PARAMS * 4 + 8), 0
