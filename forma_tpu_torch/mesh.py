"""A one-axis device mesh and the collectives of the sharded frames.

Counterpart of `jax.make_mesh((n,), ("rows",))`, `jax.shard_map` and the
three lax collectives that `forma_tpu/ops/pipeline.py:377-566` uses
(`all_to_all`, `pmax`, `psum`), in the JAX package's single-controller
form: one Python call drives every shard, each on its own device.

A `Mesh` is an explicit tuple of devices, one per shard.  An entry may
repeat, so one card (or the CPU) can hold several shards, which then run
one after another on its stream.  A sharded frame runs once a card
(`cards`): `run` moves a piece's inputs to its card and makes that card
the current one, so that its kernels launch on that card's stream.  The
collectives are copies between the shards' devices (a copy to the device
a tensor is already on is none), which PyTorch orders after the work on
both cards' current streams.  Nothing here reads a device value on the
host.  Two meshes of the same devices are equal and hash alike, as JAX's
meshes do, so a frame graph keyed by its mesh serves every mesh built on
those devices.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch


def as_device(d) -> torch.device:
    """`d` as a device with its index: "cuda" is the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """The shards' devices, shard i on `devices[i]`."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(as_device(d) for d in devices)
        if not self.devices or len({d.type for d in self.devices}) > 1:
            raise ValueError(f"a mesh needs devices of one type, got {self.devices}")

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.devices == other.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    def cards(self) -> tuple:
        """(device, the indices of its shards) for each distinct device, in
        the order of its first shard."""
        shards = {}
        for i, d in enumerate(self.devices):
            shards.setdefault(d, []).append(i)
        return tuple((d, tuple(s)) for d, s in shards.items())

    @staticmethod
    def run(fn, device: torch.device, args: tuple, kwargs: dict):
        """`fn(*args, **kwargs)` on `device`, eagerly: the tensors of `args`
        (tensors, or tuples or dicts of them) moved there, a tensor already
        there not copied, and the card current while `fn` runs."""
        on = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
        with on:
            return fn(*_to(args, device), **kwargs)

    def all_to_all(self, blocks):
        """`blocks[s]`: shard s's [n, ...] tensor on its device, row d
        addressed to shard d.  Returns, for each shard d, the rows that
        every shard addressed to d, concatenated in source order along the
        first axis, on d's device (`jax.lax.all_to_all(x, "rows", 0, 0)`
        then a flatten of the source axis)."""
        n = self.size
        if len(blocks) != n or any(b.shape[0] != n for b in blocks):
            raise ValueError(f"all_to_all: need {n} blocks of {n} rows")
        return tuple(
            torch.cat([b[d].to(dev, non_blocking=True) for b in blocks])
            for d, dev in enumerate(self.devices)
        )

    def pmax(self, values):
        """Elementwise maximum over the shards' tensors, on shard 0's
        device."""
        return self._gather(values).amax(0)

    def psum(self, values):
        """Elementwise sum over the shards' tensors, on shard 0's device."""
        return self._gather(values).sum(0)

    def _gather(self, values):
        dev = self.devices[0]
        return torch.stack([v.to(dev, non_blocking=True) for v in values])


def _to(tree, device: torch.device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device, non_blocking=True)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tuple(_to(v, device) for v in tree)
