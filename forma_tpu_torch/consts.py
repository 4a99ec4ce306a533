"""Global constants and the pixel-segment bit layout.

A copy of `forma_tpu/consts.py` (the JAX package's host scene model,
plain numpy): the port imports nothing of the JAX package.

This module mirrors the compile-time constants of the reference
(`forma/src/consts.rs`): the 16x16 sub-pixel grid, maximum render-target
dimensions, tile geometry and the bit-field layout of the packed pixel
segment.

The packed pixel segment is a 64-bit word laid out (msb -> lsb) as

    tile_y : tile_x : layer_id : local_x : local_y : double_area_multiplier : cover

The device pipeline keeps the same logical layout in 32-bit key words
whose sort gives the (tile_y, tile_x, layer_id, ...) ordering the reference
obtains by sorting the single u64 (`forma/src/cpu/pixel_segment.rs:161-171`).
"""

# 16x16 sub-pixels per pixel (forma/src/consts.rs:21-23).
PIXEL_WIDTH = 16
PIXEL_DOUBLE_WIDTH = PIXEL_WIDTH * 2
PIXEL_SHIFT = PIXEL_WIDTH.bit_length() - 1  # 4

PIXEL_AREA = PIXEL_WIDTH * PIXEL_WIDTH
PIXEL_DOUBLE_AREA = 2 * PIXEL_AREA  # 512

# Maximum render-target dimensions (forma/src/consts.rs:25-29).
#
# These are FORMAT limits (the bit-field layout below is derived from
# them, exactly as `BitFieldMap` derives the reference's).  The 2^21 - 1
# LAYER_LIMIT below is the key-format capacity, enforced by `Order`, not a
# measured single-frame population.
MAX_WIDTH = 1 << 16
MAX_HEIGHT = 1 << 15
MAX_WIDTH_SHIFT = 16
MAX_HEIGHT_SHIFT = 15

# Tile geometry.  The reference uses 16x16 tiles on CPU and 16x4 on GPU; both
# produce the same LAYER_LIMIT.  Both packages standardise on 16x16, which
# matches the goldens' CPU backend.
TILE_WIDTH = 16
TILE_HEIGHT = 16
TILE_WIDTH_SHIFT = 4
TILE_HEIGHT_SHIFT = 4

# Bit-field lengths, generically derived exactly like
# `BitFieldMap::new::<TW, TH>()` (forma/src/consts.rs:50-104).


def _next_pow2_bits(v: int) -> int:
    """Number of bits of the next power of two of ``v``."""
    n = 1
    while n < v:
        n <<= 1
    return n.bit_length() - 1


def bit_field_lengths(tile_width: int = TILE_WIDTH, tile_height: int = TILE_HEIGHT):
    """Lengths of (tile_y, tile_x, layer_id, local_x, local_y, mult, cover)."""
    tws = tile_width.bit_length() - 1
    ths = tile_height.bit_length() - 1
    mult_cover = _next_pow2_bits((PIXEL_WIDTH + 1) * 2)  # 6 bits
    lengths = [
        MAX_HEIGHT_SHIFT - ths,  # tile_y
        MAX_WIDTH_SHIFT - tws,  # tile_x
        0,  # layer_id, filled below
        tws,  # local_x
        ths,  # local_y
        mult_cover,  # double_area_multiplier
        mult_cover,  # cover
    ]
    lengths[2] = 64 - sum(lengths)
    return tuple(lengths)


(
    TILE_Y_BITS,
    TILE_X_BITS,
    LAYER_ID_BITS,
    LOCAL_X_BITS,
    LOCAL_Y_BITS,
    MULT_BITS,
    COVER_BITS,
) = bit_field_lengths()

assert (TILE_Y_BITS, TILE_X_BITS, LAYER_ID_BITS) == (11, 12, 21)
assert (LOCAL_X_BITS, LOCAL_Y_BITS, MULT_BITS, COVER_BITS) == (4, 4, 6, 6)

# 2^21 - 1 layers (forma/src/consts.rs:106-116).
LAYER_LIMIT = (1 << LAYER_ID_BITS) - 1

# Tile coordinates are stored biased by +1 so tile -1 (the cover-carry
# catch-all to the left of the viewport) is representable
# (forma/src/cpu/pixel_segment.rs:22-24).
TILE_BIAS = 1
