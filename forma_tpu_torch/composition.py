"""Scene model: ordered layers over a shared flattened-segment store.

A copy of `forma_tpu/composition.py` (the JAX package's host scene model,
plain numpy): the port imports nothing of the JAX package.

Mirrors `forma/src/composition/` and `forma/src/segment.rs`.  A
`Composition` maps `Order` (z-order, up to 2^21-1) to `Layer`s; every layer's
flattened geometry lives in one shared SoA `SegmentBuffer` keyed by `GeomId`,
which lets the whole scene ship to the device as three flat arrays and is
garbage-collected when at least half of it is unreferenced
(`composition/mod.rs:33,372-384`).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from . import consts
from .interner import Interner
from .math import AffineTransform, GeomPresTransform, GeomPresTransformError
from .path import Path
from .styling import Props

_LINES_GARBAGE_THRESHOLD = 2
_IDENTITY6 = np.asarray([1, 0, 0, 1, 0, 0], np.float32)


class OrderError(ValueError):
    pass


class Order:
    """Layer z-order in [0, 2^21 - 1] (`forma/src/utils/order.rs`)."""

    MAX = consts.LAYER_LIMIT

    __slots__ = ("_value",)

    def __init__(self, value: int):
        if not 0 <= value <= Order.MAX:
            raise OrderError(f"order value {value} exceeds {Order.MAX}")
        self._value = int(value)

    @staticmethod
    def new(value: int) -> "Order":
        return Order(value)

    def as_u32(self) -> int:
        return self._value

    def __eq__(self, other):
        return isinstance(other, Order) and other._value == self._value

    def __hash__(self):
        return hash(self._value)

    def __lt__(self, other):
        return self._value < other._value

    def __repr__(self):
        return f"Order({self._value})"


class GeomId(int):
    """Monotonically increasing geometry key (`segment.rs:100-134`)."""

    def next(self) -> "GeomId":
        return GeomId(self + 1)


_NONE_ID = np.int64(0)


class SegmentBuffer:
    """Shared SoA polyline store: x/y point chains, and per-point geometry ids
    where id 0 terminates a contour (`segment.rs:152-273`).

    Points are appended per path; consecutive points with the same non-zero id
    form line segments.
    """

    _serial_counter = 0

    def __init__(self):
        SegmentBuffer._serial_counter += 1
        self.serial = SegmentBuffer._serial_counter  # unique across process
        self._x: list[np.ndarray] = []
        self._y: list[np.ndarray] = []
        self._ids: list[np.ndarray] = []
        self._flat: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        self._len_cache: Optional[int] = None
        self.version = 0  # bumped on any geometry change; backends key caches on it

    def _invalidate(self):
        self._flat = None
        self._len_cache = None
        self.version += 1

    def flat(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (x, y, ids) as flat arrays."""
        if self._flat is None:
            if self._x:
                self._flat = (
                    np.concatenate(self._x),
                    np.concatenate(self._y),
                    np.concatenate(self._ids),
                )
            else:
                self._flat = (
                    np.zeros(0, np.float32),
                    np.zeros(0, np.float32),
                    np.zeros(0, np.int64),
                )
            self._x = [self._flat[0]]
            self._y = [self._flat[1]]
            self._ids = [self._flat[2]]
        return self._flat

    def __len__(self) -> int:
        """Number of line segments (points with a non-terminator id)."""
        if self._len_cache is None:
            _, _, ids = self.flat()
            self._len_cache = int(np.count_nonzero(ids))
        return self._len_cache

    def point_count(self) -> int:
        return sum(a.shape[0] for a in self._x)

    def push_path(self, geom_id: GeomId, path: Path):
        """Appends a path's flattened segments (`segment.rs:180-198`).

        ids[i] names the geometry of the line (points[i], points[i+1]); a
        terminator 0 follows the last point of every contour.
        """
        x, y, start_new_contour = path.push_segments_to()
        if x.shape[0] == 0:
            return
        ids = np.full(x.shape[0], np.int64(geom_id), dtype=np.int64)
        # A point that starts a new contour terminates the segment that would
        # otherwise connect it to the previous point (path.rs:703).
        ids[start_new_contour] = _NONE_ID
        # Points form a chain; the very last point never starts a segment.
        ids[-1] = _NONE_ID
        self._x.append(np.asarray(x, dtype=np.float32))
        self._y.append(np.asarray(y, dtype=np.float32))
        self._ids.append(ids)
        self._invalidate()

    def push_raw_segments(self, geom_id: GeomId, points: np.ndarray):
        """Test-only raw segment injection (`segment.rs:200-235` push()):
        points is [N, 2, 2] of independent line segments."""
        for (p0, p1) in points:
            x0, y0 = map(np.float32, p0)
            x1, y1 = map(np.float32, p1)
            self._x.append(np.asarray([x0, x1], dtype=np.float32))
            self._y.append(np.asarray([y0, y1], dtype=np.float32))
            self._ids.append(np.asarray([np.int64(geom_id), _NONE_ID], dtype=np.int64))
        self._invalidate()

    def retain(self, keep_fn):
        """Keeps only points whose effective geometry id satisfies keep_fn
        (`segment.rs:237-273`).  Terminator entries belong to the preceding id.
        """
        x, y, ids = self.flat()
        if ids.shape[0] == 0:
            return
        eff = ids.copy()
        none_mask = eff == _NONE_ID
        # No two consecutive terminators exist, so the previous entry's id is
        # always the owner.
        eff[none_mask] = np.roll(ids, 1)[none_mask]
        unique = np.unique(eff)
        keep_ids = {int(u) for u in unique if keep_fn(GeomId(int(u)))}
        keep = np.isin(eff, np.asarray(sorted(keep_ids), dtype=np.int64))
        self._x = [x[keep]]
        self._y = [y[keep]]
        self._ids = [ids[keep]]
        self._invalidate()


class _LayerRegistry:
    """Vectorized per-layer state: flat numpy arrays indexed by layer slot.

    Mutations write single rows in place; the device renderer builds its
    per-frame tables as pure numpy gathers instead of Python loops — the
    TPU-first answer to the reference's per-layer `InnerLayer` lookups
    (`segment.rs:291-344`).
    """

    def __init__(self, cap: int = 64):
        self.order = np.zeros(cap, np.uint32)
        self.valid = np.zeros(cap, bool)  # alive & enabled & has an order
        self.tform = np.tile(_IDENTITY6, (cap, 1))
        self.has_t = np.zeros(cap, bool)
        self.unchanged = np.zeros(cap, np.uint32)  # per-cache dirty bits
        self._free: list[int] = list(range(cap - 1, -1, -1))

    def alloc(self) -> int:
        if not self._free:
            old = self.order.shape[0]
            cap = old * 2
            self.order = np.resize(self.order, cap)
            self.valid = np.resize(self.valid, cap)
            self.tform = np.vstack([self.tform, np.tile(_IDENTITY6, (old, 1))])
            self.has_t = np.resize(self.has_t, cap)
            self.unchanged = np.resize(self.unchanged, cap)
            self.order[old:] = 0
            self.valid[old:] = False
            self.has_t[old:] = False
            self.unchanged[old:] = 0
            self._free = list(range(cap - 1, old - 1, -1))
        slot = self._free.pop()
        self.order[slot] = 0
        self.valid[slot] = False
        self.tform[slot] = _IDENTITY6
        self.has_t[slot] = False
        self.unchanged[slot] = 0
        return slot

    def free(self, slot: int):
        self.valid[slot] = False
        self._free.append(slot)


class _SharedState:
    def __init__(self):
        self.segment_buffer = SegmentBuffer()
        self.geom_id_to_order: Dict[GeomId, Optional[Order]] = {}
        self.geom_id_to_slot: Dict[GeomId, int] = {}
        self._geom_id_generator = GeomId(1)
        self.registry = _LayerRegistry()
        self.props_interner: Interner[Props] = Interner()
        # Split version counters so backends invalidate only what changed:
        # scene  — layer add/remove/order/enable + geometry registration
        # style  — props changes (style tables)
        # tform  — transform changes (cheapest: per-frame animation)
        self.scene_version = 0
        self.style_version = 0
        self.tform_version = 0

    @property
    def state_version(self) -> int:
        """Catch-all for callers that want 'anything changed'."""
        return self.scene_version + self.style_version + self.tform_version

    def new_geom_id(self) -> GeomId:
        gid = self._geom_id_generator
        self._geom_id_generator = gid.next()
        return gid


def _finalize_layer(shared: _SharedState, slot: int, geom_box: list, props_cell):
    """weakref.finalize callback: the Python analog of `Layer::drop`
    (`composition/layer.rs:356-363`) — unregisters geometry so
    `compact_geom` can collect it, frees the registry slot, releases the
    interned props.  Must not capture the Layer itself."""
    gid = geom_box[0]
    shared.geom_id_to_order.pop(gid, None)
    shared.geom_id_to_slot.pop(gid, None)
    shared.registry.free(slot)
    shared.props_interner.release(props_cell[0])
    shared.scene_version += 1


class Layer:
    """Reusable geometry + style + transform bound to an order
    (`composition/layer.rs`)."""

    def __init__(self, shared_state: _SharedState, geom_id: GeomId):
        import weakref

        self._shared = shared_state
        self._slot = shared_state.registry.alloc()
        self._geom_box = [geom_id]
        self.is_enabled_value = True
        self.order: Optional[Order] = None
        self._props_cell_box = [shared_state.props_interner.acquire(Props())]
        self.lines_count = 0
        self._finalizer = weakref.finalize(
            self, _finalize_layer, shared_state, self._slot, self._geom_box,
            self._props_cell_box,
        )

    @property
    def geom_id_value(self) -> GeomId:
        return self._geom_box[0]

    @property
    def props(self) -> Props:
        return self._props_cell_box[0].value

    @property
    def props_intern_id(self) -> int:
        return self._props_cell_box[0].id

    @property
    def affine_transform_value(self) -> Optional[GeomPresTransform]:
        """Reads from the registry — the single source of truth, so the bulk
        `Composition.set_transforms` and per-layer setters stay coherent."""
        reg = self._shared.registry
        if not reg.has_t[self._slot]:
            return None
        return GeomPresTransform(AffineTransform.from_array(reg.tform[self._slot]))

    def _sync_valid(self):
        reg = self._shared.registry
        reg.valid[self._slot] = self.is_enabled_value and self.order is not None
        if self.order is not None:
            reg.order[self._slot] = self.order.as_u32()

    # -- geometry ----------------------------------------------------------

    def insert(self, path: Path) -> "Layer":
        self._shared.scene_version += 1
        buf = self._shared.segment_buffer
        old_len = len(buf)
        buf.push_path(self.geom_id_value, path)
        self.lines_count += len(buf) - old_len
        self._shared.geom_id_to_order[self.geom_id_value] = self.order
        self._shared.geom_id_to_slot[self.geom_id_value] = self._slot
        self._shared.registry.unchanged[self._slot] = 0
        return self

    def clear(self) -> "Layer":
        self._shared.scene_version += 1
        self._shared.geom_id_to_order.pop(self.geom_id_value, None)
        self._shared.geom_id_to_slot.pop(self.geom_id_value, None)
        self._geom_box[0] = self._shared.new_geom_id()
        self._shared.geom_id_to_order[self.geom_id_value] = self.order
        self._shared.geom_id_to_slot[self.geom_id_value] = self._slot
        self.lines_count = 0
        self._shared.registry.unchanged[self._slot] = 0
        return self

    def geom_id(self) -> GeomId:
        return self.geom_id_value

    # -- state -------------------------------------------------------------

    def set_order(self, order: Optional[Order]):
        self._shared.scene_version += 1
        if order is not None and self.order != order:
            self.order = order
            self._shared.registry.unchanged[self._slot] = 0
        if order is None:
            self.order = None
        self._shared.geom_id_to_order[self.geom_id_value] = order
        self._sync_valid()

    def is_enabled(self) -> bool:
        return self.is_enabled_value

    def set_is_enabled(self, is_enabled: bool) -> "Layer":
        if self.is_enabled_value != is_enabled:
            self._shared.scene_version += 1
            self.is_enabled_value = is_enabled
            self._shared.registry.unchanged[self._slot] = 0
            self._sync_valid()
        return self

    def disable(self) -> "Layer":
        return self.set_is_enabled(False)

    def enable(self) -> "Layer":
        return self.set_is_enabled(True)

    def transform(self) -> Optional[GeomPresTransform]:
        return self.affine_transform_value

    def set_transform(self, transform) -> "Layer":
        """Sets a geometry-preserving transform; identity clears it
        (`composition/layer.rs:299-311`).  Raises `GeomPresTransformError`
        when the transform scales up (`transform.rs:109-131`)."""
        if isinstance(transform, (list, tuple)):
            transform = AffineTransform.from_array(transform)
        if isinstance(transform, AffineTransform):
            if transform.is_identity():
                gp = None
            else:
                gp = GeomPresTransform.try_new(transform)
                if gp is None:
                    raise GeomPresTransformError(
                        "transform scales up beyond the geometry-preserving limit"
                    )
        else:
            gp = transform
        reg = self._shared.registry
        if gp is None:
            new6, new_has = _IDENTITY6, False
        else:
            new6 = np.asarray(gp.as_slice(), np.float32)
            new_has = True
        if new_has != bool(reg.has_t[self._slot]) or (
            new_has and not np.array_equal(new6, reg.tform[self._slot])
        ):
            reg.unchanged[self._slot] = 0
            self._shared.tform_version += 1
            reg.tform[self._slot] = new6
            reg.has_t[self._slot] = new_has
        return self

    def set_props(self, props: Props) -> "Layer":
        if self.props != props:
            self._shared.registry.unchanged[self._slot] = 0
            self._shared.style_version += 1
            interner = self._shared.props_interner
            interner.release(self._props_cell_box[0])
            self._props_cell_box[0] = interner.acquire(props)
        return self

    def is_unchanged(self, cache_id: int) -> bool:
        return bool(int(self._shared.registry.unchanged[self._slot]) & (1 << cache_id))

    def set_is_unchanged(self, cache_id: int, is_unchanged: bool):
        reg = self._shared.registry
        if is_unchanged:
            reg.unchanged[self._slot] |= np.uint32(1 << cache_id)
        else:
            reg.unchanged[self._slot] &= np.uint32(~(1 << cache_id) & 0xFFFFFFFF)


class Composition:
    """Ordered map Order -> Layer over the shared segment store
    (`composition/mod.rs:52-398`)."""

    def __init__(self):
        self._shared = _SharedState()
        self.layers: Dict[Order, Layer] = {}
        self._osm_key = None
        self._osm = None
        self._alen_key = None
        self._alen = 0

    def create_layer(self) -> Layer:
        return Layer(self._shared, self._shared.new_geom_id())

    def _order_slot_map(self):
        """Sorted (orders u32, slots i32) arrays; rebuilt on membership change."""
        key = self._shared.scene_version
        if self._osm_key != key:
            items = sorted((o.as_u32(), l._slot) for o, l in self.layers.items())
            self._osm = (
                np.asarray([o for o, _ in items], np.uint32),
                np.asarray([s for _, s in items], np.int32),
            )
            self._osm_key = key
        return self._osm

    def set_transforms(self, orders, transforms) -> None:
        """Bulk geometry-preserving transform update — one vectorized write.

        `orders`: int array [N]; `transforms`: f32 [N, 6] rows of
        (ux, uy, vx, vy, tx, ty).  The batch equivalent of calling
        `layer.set_transform` N times; per-frame animation over thousands of
        layers stays device-bound instead of Python-bound.  Raises
        `GeomPresTransformError` if any transform scales up
        (`transform.rs:109-131`).
        """
        from .math import _MAX_SCALING_FACTOR_X, _MAX_SCALING_FACTOR_Y

        t = np.ascontiguousarray(np.asarray(transforms, np.float32).reshape(-1, 6))
        orders = np.asarray(orders, np.uint32).ravel()
        if t.shape[0] != orders.shape[0]:
            raise ValueError("orders and transforms length mismatch")
        su = t[:, 0] * t[:, 0] + t[:, 1] * t[:, 1]
        sv = t[:, 2] * t[:, 2] + t[:, 3] * t[:, 3]
        if (su > np.float32(_MAX_SCALING_FACTOR_X) ** 2).any() or (
            sv > np.float32(_MAX_SCALING_FACTOR_Y) ** 2
        ).any():
            raise GeomPresTransformError(
                "transform scales up beyond the geometry-preserving limit"
            )
        sorted_orders, sorted_slots = self._order_slot_map()
        pos = np.searchsorted(sorted_orders, orders)
        pos = np.minimum(pos, max(len(sorted_orders) - 1, 0))
        if len(sorted_orders) == 0 or not np.array_equal(sorted_orders[pos], orders):
            raise KeyError("set_transforms: some orders have no layer")
        slots = sorted_slots[pos]
        reg = self._shared.registry
        # Only rows whose transform actually changes dirty the damage caches
        # and bump the version — a caller re-sending identical transforms each
        # frame must not defeat the no-dispatch fast path (`Layer.set_transform`
        # no-ops on equality; this is its vectorized twin).
        has_t = (t != _IDENTITY6).any(axis=1)
        changed = (reg.tform[slots] != t).any(axis=1) | (reg.has_t[slots] != has_t)
        if not changed.any():
            return
        cslots = slots[changed]
        reg.tform[cslots] = t[changed]
        reg.has_t[cslots] = has_t[changed]
        reg.unchanged[cslots] = 0
        self._shared.tform_version += 1

    def is_empty(self) -> bool:
        return not self.layers

    def __len__(self) -> int:
        return len(self.layers)

    def insert(self, order: Order, layer: Layer) -> Optional[Layer]:
        if layer._shared is not self._shared:
            raise ValueError("Layer was created by a different Composition")
        layer.set_order(order)
        old = self.layers.get(order)
        self.layers[order] = layer
        if old is not None and old is not layer:
            old.set_order(None)
        return old

    def remove(self, order: Order) -> Optional[Layer]:
        layer = self.layers.pop(order, None)
        if layer is not None:
            layer.set_order(None)
            # Unlike Rust, Python has no deterministic Drop: dropping the
            # returned layer will not unregister its geometry, so do it here
            # and re-register if the caller re-inserts.
        return layer

    def get(self, order: Order) -> Optional[Layer]:
        return self.layers.get(order)

    def get_mut(self, order: Order) -> Optional[Layer]:
        return self.layers.get(order)

    def get_mut_or_insert_default(self, order: Order) -> Layer:
        if order not in self.layers:
            self.insert(order, self.create_layer())
        return self.layers[order]

    def get_order_if_stored(self, geom_id: GeomId) -> Optional[Order]:
        return self._shared.geom_id_to_order.get(geom_id)

    def layers_iter(self) -> Iterator[Tuple[Order, Layer]]:
        return iter(sorted(self.layers.items(), key=lambda kv: kv[0].as_u32()))

    # -- geometry GC ---------------------------------------------------------

    def _builder_len(self) -> int:
        return len(self._shared.segment_buffer)

    def _actual_len(self) -> int:
        # Cached per scene_version: every geometry mutation (insert/clear/
        # set_order/layer finalize) bumps it, and summing 30k layers' counts
        # per frame is measurable host overhead in the frame loop.
        sv = self._shared.scene_version
        if self._alen_key != sv:
            self._alen_key = sv
            self._alen = sum(
                layer.lines_count for layer in self.layers.values()
            )
        return self._alen

    def compact_geom(self):
        """Drops unreferenced geometry when at least half the buffer is garbage
        (`composition/mod.rs:372-384`)."""
        if self._builder_len() >= self._actual_len() * _LINES_GARBAGE_THRESHOLD:
            mapping = self._shared.geom_id_to_order
            self._shared.segment_buffer.retain(lambda gid: gid in mapping)

    # -- backend access ------------------------------------------------------

    def shared_segment_buffer(self) -> SegmentBuffer:
        return self._shared.segment_buffer

    def geom_id_to_order(self) -> Dict[GeomId, Optional[Order]]:
        return self._shared.geom_id_to_order
