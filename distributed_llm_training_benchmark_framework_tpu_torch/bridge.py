"""Weights across the two packages, through numpy.

The JAX package keeps its parameters as a pytree: top-level leaves (``wte``,
``wpe``, ``lnf_scale``, ``lnf_bias``, ``lm_head``) and, under ``blocks``,
every per-layer leaf stacked on a leading layer axis. The port holds the
same leaves with the same names, one ``Block`` module per layer. So the
mapping is fixed: ``params[name]`` <-> ``model.<name>`` and
``params["blocks"][leaf][i]`` <-> ``model.blocks[i].<leaf>``, or, for the
expert leaves of a MoE block, ``model.blocks[i].experts.<leaf>``.

A caller turns the JAX tree into numpy first
(``jax.tree.map(np.asarray, params)``); this module imports no JAX.

Under a strategy arm (``parallel.strategies.apply_strategy``) weights are
loaded before the arm lays the model out; ``export_params`` takes the
model as the arm returns it (a DDP wrapper, or FSDP2's sharded leaves,
which it gathers: a collective that every rank of the group must call).

Leaves cross in the model's parameter dtype: a bf16 JAX leaf goes into a
bf16 parameter exactly (through fp32, which holds every bf16 value), and a
bf16 model exports bf16 leaves (``ml_dtypes.bfloat16`` arrays, numpy's
form of JAX's bf16, imported only then).

Under tensor parallelism (a model built at a ``model`` rank's local widths)
``load_jax_params`` keeps this rank's shard of each global leaf, by the
layout rules (``parallel.strategies.tp_axis``), and ``export_params``
gathers the shards over the ``model`` group back into global leaves (a
collective again: every rank calls it). Under an ``expert`` axis likewise:
a rank keeps its slice of each expert leaf's experts axis (axis 0 of a
layer's leaf), and the export gathers the slices over the ``expert`` group.

A pipeline stage (``pipe`` axis) holds the layers ``model.layer_ids``:
``blocks.<i>`` maps to global layer ``layer_ids[i]``, the load takes those
rows and the export gathers every stage's layers over the ``pipe`` group.
JAX keeps an interleaved run's stacked layers in ``layer_permutation``
order (its ``train/step.py``: row r holds global layer ``perm[r]``); the
load and the export take that order as ``layer_order`` and invert or apply
it.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .models.tinygpt import TinyGPT
from .parallel.strategies import expert_axis, tp_axis


def leaf_map(model: TinyGPT) -> Iterator[Tuple[Tuple[str, ...], torch.nn.Parameter]]:
    """Yield (JAX path, port parameter) for every port parameter; a block
    path is ("blocks", leaf, global layer index)."""
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            yield ("blocks", parts[-1], model.layer_ids[int(parts[1])]), p
        else:
            yield (name,), p


def _jax_leaf_paths(params: Dict) -> set:
    paths = {(k,) for k in params if k != "blocks"}
    paths |= {("blocks", k) for k in params.get("blocks", {})}
    return paths


@torch.no_grad()
def load_jax_params(model: TinyGPT, params_np: Dict,
                    layer_order: Optional[Sequence[int]] = None) -> TinyGPT:
    """Fill ``model`` from a JAX param tree given as numpy arrays, its
    stacked row r holding global layer ``layer_order[r]`` (None: layer r).

    Every JAX leaf must map onto the model and every model parameter must be
    filled; shapes must agree exactly (a leaf that ``model`` shards: this
    rank's shard of it). Raises ValueError otherwise."""
    want = _jax_leaf_paths(params_np)
    used = set()
    m, t = model.tp
    e, ep = model.ep
    row = None if layer_order is None else np.argsort(np.asarray(layer_order))
    for (path, p), (name, _) in zip(leaf_map(model), model.named_parameters()):
        if path[0] == "blocks":
            _, leaf, i = path
            if leaf not in params_np.get("blocks", {}):
                raise ValueError(f"JAX tree has no blocks/{leaf}")
            arr = np.asarray(params_np["blocks"][leaf])[i if row is None else row[i]]
            used.add(("blocks", leaf))
        else:
            if path[0] not in params_np:
                raise ValueError(f"JAX tree has no {path[0]}")
            arr = np.asarray(params_np[path[0]])
            used.add(path)
        for ax, i, n in ((tp_axis(name, model.config.kv_heads, t), m, t),
                         (expert_axis(name, ep), e, ep)):
            if ax is not None:
                arr = np.split(arr, n, axis=ax)[i]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{'/'.join(map(str, path))}: shape {arr.shape} vs {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)).to(p.dtype))
    if used != want:
        raise ValueError(f"JAX leaves with no port counterpart: {sorted(want - used)}")
    return model


def leaf_key(path: Tuple) -> str:
    """A JAX path as one string: ``wte``, ``blocks/wqkv/<global layer>``."""
    return "/".join(str(part) for part in path)


def shard_axes(model: TinyGPT, name: str) -> List[Tuple[int, int, int, Optional[dist.ProcessGroup]]]:
    """(axis, this rank's index, width, group) for each of the ``model`` and
    ``expert`` axes that shard the port parameter ``name``."""
    (m, t), (e, ep) = model.tp, model.ep
    axes = ((tp_axis(name, model.config.kv_heads, t), m, t, model.model_group),
            (expert_axis(name, ep), e, ep, model.expert_group))
    return [(ax, i, n, group) for ax, i, n, group in axes if ax is not None]


def global_shape(model: TinyGPT, name: str, p: torch.Tensor) -> List[int]:
    """The global shape of the leaf whose local part (or DTensor) is ``p``."""
    shape = list(p.shape)
    for ax, _, n, _ in shard_axes(model, name):
        shape[ax] *= n
    return shape


def gather_leaf(model: TinyGPT, name: str, p: torch.Tensor) -> torch.Tensor:
    """The global leaf of which ``p`` is this rank's part: a DTensor's full
    tensor, then the ``model`` and ``expert`` shards gathered (collectives
    that every rank of those groups calls)."""
    if isinstance(p, DTensor):
        p = p.full_tensor()
    for ax, _, n, group in shard_axes(model, name):
        parts = [torch.empty_like(p) for _ in range(n)]
        dist.all_gather(parts, p.contiguous(), group=group)
        p = torch.cat(parts, dim=ax)
    return p


def local_leaf(model: TinyGPT, name: str, full: torch.Tensor) -> torch.Tensor:
    """This rank's ``model`` / ``expert`` part of a global leaf (a view; the
    inverse of ``gather_leaf`` up to a DTensor's ``data`` sharding)."""
    for ax, i, n, _ in shard_axes(model, name):
        full = full.chunk(n, dim=ax)[i]
    return full


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype != torch.bfloat16:
        return t.numpy()
    import ml_dtypes  # numpy has no bf16 of its own

    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def export_params(model: torch.nn.Module, layer_order: Optional[Sequence[int]] = None,
                  pipe_group: Optional[dist.ProcessGroup] = None) -> Dict:
    """The reverse direction: the model's parameters as a JAX-shaped numpy
    tree (block leaves stacked on a leading layer axis, row r global layer
    ``layer_order[r]``, None: layer r) in the parameters' dtype, whole
    leaves on every rank, copied (later steps do not change them). A
    pipeline stage gathers the other stages' layers over ``pipe_group``."""
    out: Dict = {}
    stacks: Dict[str, list] = {}
    inner = getattr(model, "module", model)
    for (path, p), (name, _) in zip(leaf_map(inner), inner.named_parameters()):
        arr = _numpy(gather_leaf(inner, name, p.detach()).to("cpu", copy=True))
        if path[0] == "blocks":
            stacks.setdefault(path[1], []).append((path[2], arr))
        else:
            out[path[0]] = arr
    if pipe_group is not None:
        parts: List[Dict[str, list]] = [None] * dist.get_world_size(pipe_group)
        dist.all_gather_object(parts, stacks, group=pipe_group)
        stacks = {leaf: [item for part in parts for item in part[leaf]] for leaf in stacks}
    out["blocks"] = {}
    for leaf, items in stacks.items():
        by_layer = dict(items)
        order = sorted(by_layer) if layer_order is None else layer_order
        out["blocks"][leaf] = np.stack([by_layer[int(g)] for g in order])
    return out
