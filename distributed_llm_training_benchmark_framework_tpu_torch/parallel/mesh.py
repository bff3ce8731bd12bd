"""Mesh axes: the subset of the JAX package's ``parallel/mesh.py`` that ring
attention reads.

The JAX package names its mesh axes once (``MeshAxes``: ``data``, ``model``,
``seq``, ``pipe``) and builds a ``jax.sharding.Mesh`` of devices. The port
keeps the names and records each axis' width. In this slice every axis is
held in one process on one device: a ``seq`` axis of width n means that
ring attention cuts the sequence into n shards and runs its ring over them
on that device (``ops/ring_attention.py``). Axes across processes arrive
with the distributed runtime.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Canonical axis names used across the framework."""

    data: str = "data"      # data parallel / ZeRO sharding axis
    model: str = "model"    # tensor parallel axis
    seq: str = "seq"        # sequence/context parallel axis (ring attention)
    pipe: str = "pipe"      # pipeline stage axis


AXES = MeshAxes()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis name -> width; an axis that is not named has width 1."""

    shape: Dict[str, int]

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)


def make_mesh(shape: Sequence[int] = (1,), axis_names: Tuple[str, ...] = ("data",)) -> Mesh:
    """A mesh of the given widths, e.g. ``make_mesh((4,), ("seq",))``."""
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {tuple(shape)} vs axis_names {axis_names} rank mismatch")
    if len(set(axis_names)) != len(axis_names):
        raise ValueError(f"repeated axis name in {axis_names}")
    known = set(dataclasses.astuple(AXES))
    for name, width in zip(axis_names, shape):
        if name not in known:
            raise ValueError(f"unknown mesh axis {name!r} (expected one of {sorted(known)})")
        if int(width) < 1:
            raise ValueError(f"mesh axis {name!r} has width {width}; need >= 1")
    return Mesh(dict(zip(axis_names, (int(w) for w in shape))))
