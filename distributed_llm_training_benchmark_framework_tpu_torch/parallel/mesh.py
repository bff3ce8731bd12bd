"""Mesh axes of the port: names, widths, and the ``data`` axis over the
process group.

Port of ``distributed_llm_training_benchmark_framework_tpu/parallel/mesh.py``.
The JAX package names its mesh axes once (``MeshAxes``: ``data``, ``model``,
``seq``, ``pipe``) and builds a ``jax.sharding.Mesh`` of devices. The port
keeps the names and each axis' width:

- ``data`` spans the processes of the group, one card each: its width is
  the group's size (1 without a group), and when a group is up the mesh
  carries a ``torch.distributed.device_mesh.DeviceMesh`` over it, which the
  strategy arms shard and reduce over (``parallel/strategies.py``);
- ``seq`` is held in one process on one device: a width of n means that
  ring attention cuts the sequence into n shards and runs its ring over
  them on that device (``ops/ring_attention.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


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
    """Axis name -> width (an axis that is not named has width 1), and the
    ``DeviceMesh`` over ``data`` when a process group is up."""

    shape: Dict[str, int]
    device_mesh: Optional[DeviceMesh] = dataclasses.field(default=None, compare=False)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    @property
    def data_rank(self) -> int:
        """This process' index on ``data`` (0 without a group)."""
        return self.device_mesh.get_local_rank(AXES.data) if self.device_mesh else 0

    @property
    def data_group(self) -> Optional[dist.ProcessGroup]:
        return self.device_mesh.get_group(AXES.data) if self.device_mesh else None


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Tuple[str, ...] = ("data",)) -> Mesh:
    """A mesh of the given widths, e.g. ``make_mesh((4,), ("seq",))``.

    ``data`` is always the process group's size (1 without a group): it is
    added when not named, and a width given for it must equal that size.
    ``shape`` None gives every named axis but ``data`` width 1."""
    defaulted = shape is None
    if defaulted:
        shape = tuple(1 for _ in axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {tuple(shape)} vs axis_names {axis_names} rank mismatch")
    if len(set(axis_names)) != len(axis_names):
        raise ValueError(f"repeated axis name in {axis_names}")
    known = set(dataclasses.astuple(AXES))
    widths = {}
    for name, width in zip(axis_names, shape):
        if name not in known:
            raise ValueError(f"unknown mesh axis {name!r} (expected one of {sorted(known)})")
        if int(width) < 1:
            raise ValueError(f"mesh axis {name!r} has width {width}; need >= 1")
        widths[name] = int(width)
    group = dist.is_initialized()
    dp = dist.get_world_size() if group else 1
    given = None if defaulted else widths.get(AXES.data)
    if given is not None and given != dp:
        raise ValueError(
            f"mesh axis 'data' has width {given} but the process group has {dp} "
            f"process{'es' if dp > 1 else ''}: 'data' spans the group"
        )
    widths[AXES.data] = dp
    device_mesh = None
    if group:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        device_mesh = init_device_mesh(device_type, (dp,), mesh_dim_names=(AXES.data,))
    return Mesh(widths, device_mesh)


def mesh_axes_dict(mesh: Mesh) -> dict:
    """{'data': 4, 'seq': 2, ...}: the geometry identity of a mesh."""
    return {str(name): int(size) for name, size in mesh.shape.items()}
