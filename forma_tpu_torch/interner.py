"""Hash-consing interner for layer Props.

A copy of `forma_tpu/interner.py` (the JAX package's host scene model,
plain numpy): the port imports nothing of the JAX package.

Mirrors `forma/src/composition/interner.rs:19-60`: identical values share one
interned cell, so style tables are built per *distinct* props rather than per
layer, and `compact()` drops entries no live layer references.

Props and everything it contains are frozen (hashable) dataclasses except
`Image`, which interns by identity — the correct semantics: two Images with
equal texels are still distinct atlas entries in the reference.
"""

from __future__ import annotations

from typing import Dict, Generic, TypeVar

T = TypeVar("T")


class Interned(Generic[T]):
    """A value plus its stable intern id and a live refcount."""

    __slots__ = ("value", "id", "refs")

    def __init__(self, value: T, id_: int):
        self.value = value
        self.id = id_
        self.refs = 0

    def __repr__(self):
        return f"Interned(id={self.id}, refs={self.refs}, {self.value!r})"


class Interner(Generic[T]):
    def __init__(self):
        self._cells: Dict[T, Interned[T]] = {}
        self._next_id = 0
        self._dead = 0  # cells whose refcount has reached zero

    def get(self, value: T) -> Interned[T]:
        """Returns the shared cell for `value`, creating it on first use.

        Does NOT adjust refcounts; callers pair `acquire`/`release`.
        """
        cell = self._cells.get(value)
        if cell is None:
            cell = Interned(value, self._next_id)
            self._next_id += 1
            self._cells[value] = cell
        return cell

    def acquire(self, value: T) -> Interned[T]:
        cell = self._cells.get(value)
        if cell is None:
            cell = Interned(value, self._next_id)
            self._next_id += 1
            self._cells[value] = cell
        elif cell.refs == 0:
            self._dead -= 1  # resurrected before any compact
        cell.refs += 1
        return cell

    def release(self, cell: Interned[T]):
        cell.refs -= 1
        if cell.refs == 0:
            self._dead += 1

    def compact(self):
        """Drops unreferenced entries (`interner.rs:57-59`).

        Runs every render (`cpu/renderer.rs:114-118`), so the no-garbage
        path must be O(1): rebuilding the dict re-hashes every Props (deep
        dataclass hashes — measured ~50 ms/frame at 30k layers); instead a
        dead counter gates the sweep and only dead keys are deleted."""
        if self._dead == 0:
            return
        dead = [v for v, c in self._cells.items() if c.refs <= 0]
        for v in dead:
            del self._cells[v]
        self._dead = 0

    def __len__(self):
        return len(self._cells)
