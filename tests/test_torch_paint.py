"""K3 of the PyTorch port (`forma_tpu_torch/ops/fold_kernel.py`): the
table-mode fold's plain PyTorch version against the JAX
`paint._paint_fold_pallas(..., presorted=True)` in interpret mode, on the
same per-run arrays and paint units (built by the port's own stages).
Scenes cover both fill rules, virtual (gap) units, alpha < 1 and a tile
deeper than 16 units.  Linear f32 pixels within 1e-6, 0 expected."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from forma_tpu import Color, Composition, Fill, Func, Order, PathBuilder, Point, Props, Style
from forma_tpu.ops import paint as jpaint
from forma_tpu.styling import FillRule
from forma_tpu_torch import Renderer
from forma_tpu_torch.convert import composition_from_jax
from forma_tpu_torch.ops import line_setup, paint, pipeline, rasterize, runs
from forma_tpu_torch.ops.fold_kernel import fold_tiles, paint_fold, paint_fold_torch, tile_spans

CLEAR = Color(1.0, 1.0, 1.0, 1.0)


def _rect(x0, y0, x1, y1):
    return (
        PathBuilder().move_to(Point(x0, y0)).line_to(Point(x0, y1))
        .line_to(Point(x1, y1)).line_to(Point(x1, y0)).build()
    )


def _solid(comp, order, path, rgba, fill_rule=FillRule.NonZero):
    comp.get_mut_or_insert_default(Order(order)).insert(path).set_props(
        Props(fill_rule=fill_rule, func=Func.Draw(Style(fill=Fill.Solid(Color(*rgba)))))
    )


def _alpha_multi_tile(comp):
    _solid(comp, 0, _rect(4, 4, 29, 29), (1, 0, 0, 1))
    _solid(comp, 1, _rect(20, 10, 45, 35), (0, 1, 0, 0.5))
    _solid(comp, 2, _rect(9, 18, 60, 44), (0, 0, 1, 0.8))


def _virtual_and_fill_rules(comp):
    _solid(comp, 0, _rect(2, 2, 120, 30), (0.2, 0.4, 0.9, 1))
    star = (
        PathBuilder().move_to(Point(60, 34)).line_to(Point(80, 62))
        .line_to(Point(40, 44)).line_to(Point(84, 44)).line_to(Point(44, 62)).build()
    )
    _solid(comp, 1, star, (0.9, 0.5, 0.1, 0.7), FillRule.EvenOdd)
    _solid(comp, 2, _rect(-20, 40, 140, 60), (0.1, 0.8, 0.3, 0.6), FillRule.EvenOdd)


def _deep_stack(comp):
    rng = np.random.default_rng(7)
    for i in range(40):
        x, y = (float(v) for v in rng.uniform(0, 24, 2))
        rgba = (*(float(v) for v in rng.uniform(0.1, 1.0, 3)), 0.35)
        _solid(comp, i, _rect(x, y, x + 8, y + 8), rgba)


def _fold_inputs(build, w, h):
    """Runs the port's stages up to the fold (as `pipeline._core` does)."""
    jax_comp = Composition()
    build(jax_comp)
    comp = composition_from_jax(jax_comp)
    r = Renderer("cpu")
    r.render(comp, w, h, CLEAR)  # grows the capacity buckets
    caps = r._caps
    rows, tiles_x = -(-h // 16), -(-w // 16)
    px, py, line_slot, uniq = r._prepare_geometry(comp)
    st_host, st = r._styles_cache
    g = r._geom_tables(comp, uniq, st_host.orders)
    params, slots, lengths, ends = line_setup.line_setup(px, py, line_slot, *g, w, h)
    slot_bits = pipeline.slot_bits_for(st["orders"].shape[0], rows, tiles_x)
    kh, kl, pay = rasterize.rasterize_sort(
        params, slots, lengths, ends, torch.clamp(ends[-1], max=caps.vline),
        caps.vline, 8, rows, tiles_x, 0, slot_bits=slot_bits,
    )
    run_id, num_runs, new_run = runs.extract_runs(kh, kl)
    opaque = (st["color"][:, 3] == 1.0) & (st["func"] == 0)
    rd = runs.run_data(
        kh, kl, pay, run_id, new_run, torch.clamp(num_runs, max=caps.run),
        st["pidx"], st["fill_rule"], opaque, st["func"] == 1, st["func"] == 0,
        caps.run, tiles_x,
        paint.style_pack_for_fold(st_host.features, st["pidx"], st["fill_rule"], st["color"]),
    )
    u = runs.build_units(
        rd["run_hi"], rd["run_layer"], rd["r_valid"], rd["real_flags"], rd["inv"],
        rd["key2_s"], rd["tx_s"], rd["gap_flags_s"], rd["span"], rd["cumspan"],
        torch.clamp(rd["v_total"], max=caps.virt), caps.virt,
    )
    keep = paint.cull_units_keep(u[0], u[4], u[5], u[6])
    u = paint._renumber_units(*u[:5], keep)
    clear = torch.tensor(CLEAR.to_array(), dtype=torch.float32)
    return u, rd, clear, rows, tiles_x, caps.k, int(u[7])


@pytest.mark.parametrize(
    "build, w, h",
    [(_alpha_multi_tile, 64, 48), (_virtual_and_fill_rules, 128, 64), (_deep_stack, 32, 32)],
    ids=["alpha_multi_tile", "virtual_and_fill_rules", "deep_stack"],
)
def test_fold_matches_pallas_table_mode(build, w, h):
    u, rd, clear, rows, tiles_x, k_slots, k_needed = _fold_inputs(build, w, h)
    key_u, layer_u, src_u, src2_u, virt_u, k_u, u_valid, _ = u
    if build is _deep_stack:
        assert k_needed > 16
    if build is _virtual_and_fill_rules:
        assert bool(((virt_u & paint.FLAG_VIRTUAL) != 0)[u_valid].any())

    got = fold_tiles(
        key_u, u_valid, src2_u, rd["grid"], rd["carry_in_s"], rd["carry_after_s"],
        rd["tx_s"], rd["style_s"], clear, rows, tiles_x, k_slots,
    ).numpy()

    def j(t, dt):
        return jnp.asarray(t.numpy().astype(dt))

    want = np.asarray(
        jpaint._paint_fold_pallas(
            j(key_u, np.uint32), j(layer_u, np.uint32), j(src_u, np.int32),
            j(src2_u, np.int32), j(virt_u, np.int32), j(k_u, np.int32),
            jnp.asarray(u_valid.numpy()), j(rd["grid"], np.int32),
            j(rd["carry_in_s"], np.int32), j(rd["carry_after_s"], np.int32),
            j(rd["style_s"], np.int32), jnp.asarray(clear.numpy()),
            rows, tiles_x, k_slots, jpaint.Features(), 4,
            tx_s=j(rd["tx_s"], np.int32), presorted=True, interpret=True,
        )
    )
    assert got.shape == want.shape == (rows * tiles_x, 16, 16, 4)
    assert np.abs(got - want).max() <= 1e-6
    assert (got != CLEAR.to_array()).any()  # something painted


def test_fold_cpu_dispatch_and_spans():
    """CPU tensors take the plain fold; spans cover every valid unit."""
    u, rd, clear, rows, tiles_x, k_slots, _ = _fold_inputs(_alpha_multi_tile, 64, 48)
    key_u, _, _, src2_u, _, _, u_valid, _ = u
    ust, cnt = tile_spans(key_u, u_valid, rows, tiles_x, k_slots)
    assert int(cnt.sum()) == int(u_valid.sum())
    args = (ust, cnt, src2_u, rd["grid"], rd["carry_in_s"], rd["carry_after_s"],
            rd["tx_s"], rd["style_s"], clear, tiles_x)
    assert torch.equal(paint_fold(*args), paint_fold_torch(*args))


def _fold_numpy(ust, cnt, src2, grid, ci, ca, tx_s, style, clear, tiles_x):
    """The table-mode fold tile by tile in numpy f32, one rounding per op
    (the Pallas kernel's expression tree, `paint_pallas.py:327-336,404-415`)."""
    f32 = np.float32
    recip = f32(1.0 / 512)
    out = np.zeros((len(ust), 1024), np.float32)
    for t in range(len(ust)):
        d = [np.full(256, clear[c], np.float32) for c in range(4)]
        for k in range(int(cnt[t])):
            r = int(src2[ust[t] + k])
            virt = tx_s[r] != t % tiles_x
            g = grid[r].astype(np.int64)
            cover = ((g & 0xFFFF) ^ 0x8000) - 0x8000
            area = (g - cover) >> 16
            if virt:
                cover, area = cover * 0, area * 0
            c3 = cover.reshape(16, 16)
            ce = ((ca[r] if virt else ci[r])[:, None] + np.cumsum(c3, 1) - c3).reshape(256)
            da = 32 * ce + area
            nz = np.clip(np.abs(da.astype(f32) * recip), f32(0), f32(1))
            eo = (512 - np.abs((da & 1023) - 512)).astype(f32) * recip
            cov = eo if style[r, 4] != 0 else nz
            fill = style[r, :4].astype(np.int32).view(np.float32)
            sa = fill[3] * cov
            ida_sa, isa, da_sa = (f32(1) - d[3]) * sa, f32(1) - sa, d[3] * sa
            for c in range(3):
                d[c] = d[c] * isa + (fill[c] * ida_sa + fill[c] * da_sa)
            d[3] = d[3] * isa + sa
        out[t] = np.concatenate(d)
    return out


def test_fold_is_bit_equal_to_op_by_op_numpy():
    """The plain fold rounds exactly like f32 evaluated one op at a time.
    (XLA's CPU build of the interpret-mode Pallas kernel differs from both
    by at most a few ulp on rare pixels, hence the 1e-6 bound above.)"""
    u, rd, clear, rows, tiles_x, k_slots, _ = _fold_inputs(_deep_stack, 32, 32)
    key_u, _, _, src2_u, _, _, u_valid, _ = u
    ust, cnt = tile_spans(key_u, u_valid, rows, tiles_x, k_slots)
    args = (ust, cnt, src2_u, rd["grid"], rd["carry_in_s"], rd["carry_after_s"],
            rd["tx_s"], rd["style_s"], clear)
    got = paint_fold_torch(*args, tiles_x).numpy()
    want = _fold_numpy(*(a.numpy() for a in args), tiles_x)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
