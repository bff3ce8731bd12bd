"""Weights across the two packages, through numpy.

The JAX package keeps its parameters as a pytree: top-level leaves (``wte``,
``wpe``, ``lnf_scale``, ``lnf_bias``, ``lm_head``) and, under ``blocks``,
every per-layer leaf stacked on a leading layer axis. The port holds the
same leaves with the same names, one ``Block`` module per layer. So the
mapping is fixed: ``params[name]`` <-> ``model.<name>`` and
``params["blocks"][leaf][i]`` <-> ``model.blocks[i].<leaf>``.

A caller turns the JAX tree into numpy first
(``jax.tree.map(np.asarray, params)``); this module imports no JAX.

Under a strategy arm (``parallel.strategies.apply_strategy``) weights are
loaded before the arm lays the model out; ``export_params`` takes the
model as the arm returns it (a DDP wrapper, or FSDP2's sharded leaves,
which it gathers: a collective that every rank of the group must call).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from .models.tinygpt import TinyGPT


def leaf_map(model: TinyGPT) -> Iterator[Tuple[Tuple[str, ...], torch.nn.Parameter]]:
    """Yield (JAX path, port parameter) for every port parameter; a block
    path is ("blocks", leaf, layer index)."""
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            yield ("blocks", parts[2], int(parts[1])), p
        else:
            yield (name,), p


def _jax_leaf_paths(params: Dict) -> set:
    paths = {(k,) for k in params if k != "blocks"}
    paths |= {("blocks", k) for k in params.get("blocks", {})}
    return paths


@torch.no_grad()
def load_jax_params(model: TinyGPT, params_np: Dict) -> TinyGPT:
    """Fill ``model`` from a JAX param tree given as numpy arrays.

    Every JAX leaf must map onto the model and every model parameter must be
    filled; shapes must agree exactly. Raises ValueError otherwise."""
    want = _jax_leaf_paths(params_np)
    used = set()
    for path, p in leaf_map(model):
        if path[0] == "blocks":
            _, leaf, i = path
            if leaf not in params_np.get("blocks", {}):
                raise ValueError(f"JAX tree has no blocks/{leaf}")
            arr = np.asarray(params_np["blocks"][leaf])[i]
            used.add(("blocks", leaf))
        else:
            if path[0] not in params_np:
                raise ValueError(f"JAX tree has no {path[0]}")
            arr = np.asarray(params_np[path[0]])
            used.add(path)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{'/'.join(map(str, path))}: shape {arr.shape} vs {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
    if used != want:
        raise ValueError(f"JAX leaves with no port counterpart: {sorted(want - used)}")
    return model


def export_params(model: torch.nn.Module) -> Dict:
    """The reverse direction: the model's parameters as a JAX-shaped numpy
    tree (block leaves stacked on a leading layer axis), whole leaves on
    every rank, copied (later steps do not change them)."""
    out: Dict = {}
    stacks: Dict[str, list] = {}
    for path, p in leaf_map(getattr(model, "module", model)):
        p = p.detach()
        if isinstance(p, DTensor):
            p = p.full_tensor()
        arr = p.to("cpu", torch.float32, copy=True).numpy()
        if path[0] == "blocks":
            stacks.setdefault(path[1], []).append((path[2], arr))
        else:
            out[path[0]] = arr
    out["blocks"] = {
        leaf: np.stack([a for _, a in sorted(items, key=lambda t: t[0])])
        for leaf, items in stacks.items()
    }
    return out
