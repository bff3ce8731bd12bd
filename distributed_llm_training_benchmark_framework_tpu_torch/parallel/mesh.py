"""Mesh axes of the port: names, widths, and the ``data``, ``seq``,
``model``, ``pipe`` and ``expert`` axes over the process group.

Port of ``distributed_llm_training_benchmark_framework_tpu/parallel/mesh.py``.
The JAX package names its mesh axes once (``MeshAxes``: ``data``, ``model``,
``seq``, ``pipe``, ``expert``) and builds a ``jax.sharding.Mesh`` of
devices. The port keeps the names and each axis' width, one card per
process. The rule between the ``seq``, ``model``, ``pipe`` and ``expert``
axes and the group:

- **With a group of world > 1, ``seq``, ``model``, ``pipe`` and ``expert``
  ride the group.** ``world % (n * tp * pp * ep) == 0`` is required for a
  ``seq`` width n, a ``model`` width tp, a ``pipe`` width pp and an
  ``expert`` width ep (else "not divisible", as JAX refuses it), and
  ``data`` has width ``dp = world // (n * tp * pp * ep)``. Ranks are in
  JAX's data-major order (``make_mesh((dp, sp, tp, pp, ep))``), ``expert``
  fastest: rank r sits at ``expert = r % ep``, ``pipe = (r // ep) % pp``,
  ``model = (r // (ep * pp)) % tp``, ``seq = (r // (ep * pp * tp)) % n``,
  ``data = r // (n * tp * pp * ep)``. The mesh carries a ``DeviceMesh``
  over the axes that ride the group, in that order (``("data",)``,
  ``("data", "seq")``, ``("data", "pipe")``, ``("data", "expert")``, ...).
  Each rank holds ``S/n`` of the sequence, and ring or Ulysses attention
  exchange blocks over ``seq_group`` (``ops/ring_attention.py``,
  ``ops/ulysses_attention.py``); each holds its ``model`` index's shard of
  the Megatron layout (``parallel/strategies.py``, ``parallel/tensor.py``),
  its ``pipe`` index's layers (``parallel/pipeline.py``) and its ``expert``
  index's E/ep experts (``models/moe.py``). The batch rows shard over
  ``data`` x ``expert``: member ``d * ep + e`` of ``batch_group`` takes its
  own rows (JAX's ``batch_partition_spec``).
- **Without a group, or at world 1, the n ``seq`` shards are held in one
  process** on its one device (``seq_in_process``) and ``dp = 1``: the
  attention cuts the sequence into n shards and runs them all on that
  device. ``model``, ``pipe`` and ``expert`` have no such form: a width
  above 1 needs a group (JAX has no one-device tensor, pipeline or expert
  parallelism either). With a group of one rank the mesh carries the 1-D
  ``data`` ``DeviceMesh`` the arms wrap the model over.
- At ``seq``, ``model``, ``pipe`` and ``expert`` width 1, ``data`` is the
  whole group (1-D ``DeviceMesh``) or 1.

The strategy arms shard and reduce over ``data``, ``seq`` and ``expert``,
never over ``model`` or ``pipe``; the expert leaves reduce over ``data``
only, and the leaves every pipeline stage holds (embedding, final norm,
head) are summed over ``pipe`` after the arm's reduction
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
    expert: str = "expert"  # expert parallel axis (MoE)


AXES = MeshAxes()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis name -> width (an axis that is not named has width 1), and the
    ``DeviceMesh`` over the group when one is up: ``("data",)``, with
    ``"seq"``, ``"model"``, ``"pipe"`` and ``"expert"`` after it, in that
    order, when they ride the group. ``replica_group``: the ranks that share
    this rank's ``model`` and ``pipe`` indices (the data x seq x expert
    ranks the arms reduce over) when ``model`` or ``pipe`` rides the group;
    ``expert_batch_group``: the dp * ep ranks that share this rank's
    ``seq``, ``model`` and ``pipe`` indices when ``expert`` rides the
    group."""

    shape: Dict[str, int]
    device_mesh: Optional[DeviceMesh] = dataclasses.field(default=None, compare=False)
    replica_group: Optional[dist.ProcessGroup] = dataclasses.field(default=None, compare=False)
    expert_batch_group: Optional[dist.ProcessGroup] = dataclasses.field(default=None,
                                                                        compare=False)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def _rides(self, axis: str) -> bool:
        return self.device_mesh is not None and axis in (self.device_mesh.mesh_dim_names or ())

    @property
    def seq_in_process(self) -> bool:
        """True when the ``seq`` shards are all held in this process (no
        group, a group of one rank, or ``seq`` width 1)."""
        return not self._rides(AXES.seq)

    @property
    def world(self) -> int:
        """Processes (cards) of the mesh: ``data`` x ``seq`` x ``model`` x
        ``pipe`` x ``expert`` over the group."""
        return (self.size(AXES.data) * (1 if self.seq_in_process else self.size(AXES.seq))
                * self.size(AXES.model) * self.size(AXES.pipe) * self.size(AXES.expert))

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
        """The dp ranks that share this rank's ``seq``, ``model``, ``pipe``
        and ``expert`` indices."""
        return self.device_mesh.get_group(AXES.data) if self.device_mesh else None

    @property
    def expert_shard(self) -> Tuple[int, int]:
        """(this rank's ``expert`` index, the ``expert`` width)."""
        e = self.device_mesh.get_local_rank(AXES.expert) if self._rides(AXES.expert) else 0
        return e, self.size(AXES.expert)

    @property
    def expert_group(self) -> Optional[dist.ProcessGroup]:
        """The ep ranks of one ``data`` index, whose experts together make a
        layer's (None at ``expert`` width 1)."""
        return self.device_mesh.get_group(AXES.expert) if self._rides(AXES.expert) else None

    @property
    def batch_shard(self) -> Tuple[int, int]:
        """(this rank's member index ``d * ep + e``, dp * ep): its share of
        the batch rows, which shard over ``data`` x ``expert``."""
        e, ep = self.expert_shard
        return self.data_rank * ep + e, self.size(AXES.data) * ep

    @property
    def batch_group(self) -> Optional[dist.ProcessGroup]:
        """The dp * ep ranks that hold distinct rows of the batch: the
        ``data`` group at ``expert`` width 1."""
        return self.expert_batch_group if self.expert_batch_group is not None else self.data_group

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
    def model_rank(self) -> int:
        """This process' index on ``model`` (0 at ``model`` width 1)."""
        return self.device_mesh.get_local_rank(AXES.model) if self._rides(AXES.model) else 0

    @property
    def model_shard(self) -> Tuple[int, int]:
        """(this rank's ``model`` index, the ``model`` width)."""
        return self.model_rank, self.size(AXES.model)

    @property
    def model_group(self) -> Optional[dist.ProcessGroup]:
        """The tp ranks that hold the shards of one layer (None at ``model``
        width 1)."""
        return self.device_mesh.get_group(AXES.model) if self._rides(AXES.model) else None

    @property
    def pipe_shard(self) -> Tuple[int, int]:
        """(this rank's ``pipe`` index, the ``pipe`` width): its pipeline
        stage."""
        s = self.device_mesh.get_local_rank(AXES.pipe) if self._rides(AXES.pipe) else 0
        return s, self.size(AXES.pipe)

    @property
    def pipe_group(self) -> Optional[dist.ProcessGroup]:
        """The pp ranks that hold the stages of one pipeline (None at
        ``pipe`` width 1)."""
        return self.device_mesh.get_group(AXES.pipe) if self._rides(AXES.pipe) else None

    @property
    def pipe_neighbours(self) -> Tuple[int, int]:
        """The global ranks of the previous and the next stage on the
        ``pipe`` ring (stage s - 1 and s + 1, mod the width): the ranks
        whose other indices equal this rank's, ``expert`` width apart."""
        s, pp = self.pipe_shard
        stride = self.size(AXES.expert)
        r = self.rank
        return r + ((s - 1) % pp - s) * stride, r + ((s + 1) % pp - s) * stride

    @property
    def group(self) -> Optional[dist.ProcessGroup]:
        """Every rank of the mesh (the whole process group), or None."""
        return dist.group.WORLD if self.device_mesh else None

    @property
    def arm_group(self) -> Optional[dist.ProcessGroup]:
        """The data x seq x expert ranks an arm replicates the non-expert
        leaves over and averages them over: the whole group, or
        ``replica_group`` when ``model`` or ``pipe`` rides it."""
        return self.replica_group if self.replica_group is not None else self.group


def replicate_seq_shard_data(mesh: Mesh) -> DeviceMesh:
    """The (``seq``, ``data``) ``DeviceMesh`` of this rank's ``model`` and
    ``pipe`` indices, over the same ranks as ``mesh``'s data-major one:
    FSDP2 takes a 2-D mesh as (replicate, shard), and the arms replicate
    over ``seq`` and shard over ``data``. A ``DeviceMesh`` cannot be sliced
    into another dim order, so it is built from the transposed rank grid
    (collective: every rank calls it); with ``model`` or ``pipe`` in the
    group, from the (model, pipe, seq, data) grid, sliced to this rank's
    ``model`` and ``pipe`` indices."""
    dp, n = mesh.size(AXES.data), mesh.size(AXES.seq)
    tp, pp = mesh.size(AXES.model), mesh.size(AXES.pipe)
    device_type = mesh.device_mesh.device_type
    if tp * pp == 1:
        grid = torch.arange(dp * n).view(dp, n).t()  # grid[s, d] = d * n + s
        return DeviceMesh(device_type, grid, mesh_dim_names=(AXES.seq, AXES.data))
    grid = torch.arange(dp * n * tp * pp).view(dp, n, tp, pp).permute(2, 3, 1, 0)  # [m, p, s, d]
    full = DeviceMesh(device_type, grid,
                      mesh_dim_names=(AXES.model, AXES.pipe, AXES.seq, AXES.data))
    return full[(AXES.seq, AXES.data)]


def replicate_expert_shard_data(mesh: Mesh) -> DeviceMesh:
    """The (``expert``, ``data``) ``DeviceMesh`` of a (data, expert) mesh,
    for FSDP2's (replicate, shard) order: the non-expert leaves replicate
    over ``expert`` and shard over ``data`` (JAX shards them over ``data``
    only). Built from the transposed rank grid, as
    :func:`replicate_seq_shard_data` (collective)."""
    dp, ep = mesh.size(AXES.data), mesh.size(AXES.expert)
    grid = torch.arange(dp * ep).view(dp, ep).t()  # grid[e, d] = d * ep + e
    return DeviceMesh(mesh.device_mesh.device_type, grid,
                      mesh_dim_names=(AXES.expert, AXES.data))


def shard_data_mesh(mesh: Mesh) -> DeviceMesh:
    """The ``DeviceMesh`` FSDP2 shards the non-expert leaves over: ``data``
    (1-D), or (``seq``, ``data``) when ``seq`` rides the group, or
    (``expert``, ``data``) when ``expert`` does; of this rank's ``model``
    and ``pipe`` indices."""
    if mesh.expert_group is not None:
        if not mesh.seq_in_process or mesh.model_group is not None:
            raise ValueError("an 'expert' axis beside a 'seq' or 'model' axis over the process "
                             "group is not ported (ROADMAP Queue 1 item 12)")
        return replicate_expert_shard_data(mesh)
    if not mesh.seq_in_process:
        return replicate_seq_shard_data(mesh)
    if mesh.device_mesh.ndim == 1:
        return mesh.device_mesh
    return mesh.device_mesh[AXES.data]


def _group_of(world: int, key) -> dist.ProcessGroup:
    """This rank's group among the ranks grouped by ``key(rank)``
    (collective: every rank makes every group, in the same order)."""
    mine = None
    for k in sorted({key(r) for r in range(world)}):
        g = dist.new_group([r for r in range(world) if key(r) == k])
        if key(dist.get_rank()) == k:
            mine = g
    return mine


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Tuple[str, ...] = ("data",)) -> Mesh:
    """A mesh of the given widths, e.g. ``make_mesh((2, 2), ("seq", "pipe"))``.

    ``data`` is the process group's size divided by the ``seq``, ``model``,
    ``pipe`` and ``expert`` widths when they ride the group (see the module
    docstring),
    else the group's size (1 without a group): it is added when not named,
    and a width given for it must equal that. ``shape`` None gives every
    named axis but ``data`` width 1."""
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
    sp, tp = widths.get(AXES.seq, 1), widths.get(AXES.model, 1)
    pp, ep = widths.get(AXES.pipe, 1), widths.get(AXES.expert, 1)
    width = sp * tp * pp * ep
    for axis, what, w in ((AXES.model, "tensor", tp), (AXES.pipe, "pipeline", pp),
                          (AXES.expert, "expert", ep)):
        if w > 1 and world == 1:
            raise ValueError(
                f"{what} parallelism ({axis} width {w}) needs a process group of a multiple "
                f"of {width} ranks, one card each (launch them with torchrun); this "
                "process has " + ("a group of one rank" if group else "no group")
            )
    over_group = world > 1 and width > 1
    if over_group and world % width:
        # JAX's message.
        raise ValueError(f"world_size={world} not divisible by "
                         f"tensor*sequence*pipeline*expert parallel={width}")
    dp = world // width if over_group else world
    given = None if defaulted else widths.get(AXES.data)
    if given is not None and given != dp:
        raise ValueError(
            f"mesh axis 'data' has width {given} but the process group has {world} "
            f"process{'es' if world > 1 else ''}"
            + (f" over seq x model x pipe x expert width {width}: 'data' is world // (seq x "
               f"model x pipe x expert) = {dp}" if over_group else ": 'data' spans the group")
        )
    widths[AXES.data] = dp
    device_mesh = replica = batch = None
    if group:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        sp_group = sp if world > 1 else 1
        dims = [(AXES.data, dp), (AXES.seq, sp_group), (AXES.model, tp), (AXES.pipe, pp),
                (AXES.expert, ep)]
        dims = dims[:1] + [(a, w) for a, w in dims[1:] if w > 1]
        device_mesh = init_device_mesh(device_type, tuple(w for _, w in dims),
                                       mesh_dim_names=tuple(a for a, _ in dims))
        if tp * pp > 1:
            replica = _group_of(world, lambda r: (r // ep) % (pp * tp))
        if ep > 1:
            batch = (dist.group.WORLD if sp_group * tp * pp == 1
                     else _group_of(world, lambda r: (r // ep) % (sp_group * tp * pp)))
    return Mesh(widths, device_mesh, replica, batch)


def mesh_axes_dict(mesh: Mesh) -> dict:
    """{'data': 4, 'seq': 2, ...}: the geometry identity of a mesh."""
    return {str(name): int(size) for name, size in mesh.shape.items()}
