"""Mesh axes of the port: names, widths, and the ``data`` and ``seq`` axes
over the process group.

Port of ``distributed_llm_training_benchmark_framework_tpu/parallel/mesh.py``.
The JAX package names its mesh axes once (``MeshAxes``: ``data``, ``model``,
``seq``, ``pipe``) and builds a ``jax.sharding.Mesh`` of devices. The port
keeps the names and each axis' width, one card per process. The rule
between the ``seq`` axis and the group:

- **With a group of world > 1, ``seq`` rides the group.** ``world % n == 0``
  is required for a ``seq`` width n (else "not divisible", as JAX refuses
  it), and ``data`` has width ``dp = world // n``. Ranks are in JAX's
  data-major order (``make_mesh((dp, sp, ...))``): rank r sits at
  ``data = r // n``, ``seq = r % n``, so a ``seq`` group is n consecutive
  ranks. The mesh carries a 2-D ``DeviceMesh`` ``("data", "seq")``; each
  rank holds ``S/n`` of the sequence, and ring or Ulysses attention
  exchange blocks over ``seq_group`` (``ops/ring_attention.py``,
  ``ops/ulysses_attention.py``).
- **Without a group, or at world 1, the n shards are held in one process**
  on its one device (``seq_in_process``) and ``dp = 1``: the attention cuts
  the sequence into n shards and runs them all on that device. With a group
  of one rank the mesh carries the 1-D ``data`` ``DeviceMesh`` the arms wrap
  the model over.
- At ``seq`` width 1, ``data`` is the whole group (1-D ``DeviceMesh``) or 1.

The strategy arms shard and reduce over ``data`` and ``seq``
(``parallel/strategies.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
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
    ``DeviceMesh`` over the group when one is up: ``("data",)``, or
    ``("data", "seq")`` when ``seq`` rides the group."""

    shape: Dict[str, int]
    device_mesh: Optional[DeviceMesh] = dataclasses.field(default=None, compare=False)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    @property
    def seq_in_process(self) -> bool:
        """True when the ``seq`` shards are all held in this process (no
        group, a group of one rank, or ``seq`` width 1)."""
        return self.device_mesh is None or AXES.seq not in (self.device_mesh.mesh_dim_names or ())

    @property
    def world(self) -> int:
        """Processes (cards) of the mesh: ``data`` x ``seq`` over the group."""
        return self.size(AXES.data) * (1 if self.seq_in_process else self.size(AXES.seq))

    @property
    def rank(self) -> int:
        """This process' rank in the group (0 without a group)."""
        return dist.get_rank() if self.device_mesh else 0

    @property
    def data_rank(self) -> int:
        """This process' index on ``data`` (0 without a group)."""
        return self.device_mesh.get_local_rank(AXES.data) if self.device_mesh else 0

    @property
    def data_group(self) -> Optional[dist.ProcessGroup]:
        return self.device_mesh.get_group(AXES.data) if self.device_mesh else None

    @property
    def seq_rank(self) -> int:
        """This process' index on ``seq`` when ``seq`` rides the group, else 0."""
        return 0 if self.seq_in_process else self.device_mesh.get_local_rank(AXES.seq)

    @property
    def seq_shard(self) -> Tuple[int, int]:
        """(this rank's ``seq`` index, the ``seq`` width) when ``seq`` rides
        the group; (0, 1) when this process holds the whole sequence."""
        return (0, 1) if self.seq_in_process else (self.seq_rank, self.size(AXES.seq))

    @property
    def seq_group(self) -> Optional[dist.ProcessGroup]:
        """The n ranks that hold one sequence (None when ``seq`` is held in
        process)."""
        return None if self.seq_in_process else self.device_mesh.get_group(AXES.seq)

    @property
    def group(self) -> Optional[dist.ProcessGroup]:
        """Every rank of the mesh (the whole process group), or None."""
        return dist.group.WORLD if self.device_mesh else None


def replicate_seq_shard_data(mesh: Mesh) -> DeviceMesh:
    """The (``seq``, ``data``) ``DeviceMesh`` over the same ranks as
    ``mesh``'s data-major one: FSDP2 takes a 2-D mesh as (replicate, shard),
    and the arms replicate over ``seq`` and shard over ``data``. A
    ``DeviceMesh`` cannot be sliced into another dim order, so it is built
    from the transposed rank grid (collective: every rank calls it)."""
    dp, n = mesh.size(AXES.data), mesh.size(AXES.seq)
    grid = torch.arange(dp * n).view(dp, n).t()  # grid[s, d] = d * n + s
    return DeviceMesh(mesh.device_mesh.device_type, grid, mesh_dim_names=(AXES.seq, AXES.data))


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Tuple[str, ...] = ("data",)) -> Mesh:
    """A mesh of the given widths, e.g. ``make_mesh((4,), ("seq",))``.

    ``data`` is the process group's size divided by the ``seq`` width when
    ``seq`` rides the group (see the module docstring), else the group's size
    (1 without a group): it is added when not named, and a width given for
    it must equal that. ``shape`` None gives every named axis but ``data``
    width 1."""
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
    world = dist.get_world_size() if group else 1
    sp = widths.get(AXES.seq, 1)
    seq_over_group = world > 1 and sp > 1
    if seq_over_group and world % sp:
        # JAX's message; the port's tensor, pipeline and expert widths are 1.
        raise ValueError(f"world_size={world} not divisible by "
                         f"tensor*sequence*pipeline*expert parallel={sp}")
    dp = world // sp if seq_over_group else world
    given = None if defaulted else widths.get(AXES.data)
    if given is not None and given != dp:
        raise ValueError(
            f"mesh axis 'data' has width {given} but the process group has {world} "
            f"process{'es' if world > 1 else ''}"
            + (f" over seq width {sp}: 'data' is world // seq = {dp}" if seq_over_group
               else ": 'data' spans the group")
        )
    widths[AXES.data] = dp
    device_mesh = None
    if group:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        if seq_over_group:
            device_mesh = init_device_mesh(device_type, (dp, sp),
                                           mesh_dim_names=(AXES.data, AXES.seq))
        else:
            device_mesh = init_device_mesh(device_type, (dp,), mesh_dim_names=(AXES.data,))
    return Mesh(widths, device_mesh)


def mesh_axes_dict(mesh: Mesh) -> dict:
    """{'data': 4, 'seq': 2, ...}: the geometry identity of a mesh."""
    return {str(name): int(size) for name, size in mesh.shape.items()}
