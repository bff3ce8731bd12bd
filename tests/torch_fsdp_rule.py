"""JAX's FSDP placement rule as the port's tests read it: the axis of a
port leaf that the JAX package's ``param_partition_specs`` shards over
``data``, and the elements one ``data`` rank of an FSDP2 arm holds of it
(``parallel/strategies.fsdp_data_axis`` is the port's copy of the rule).
Imports the JAX package; holds no test."""

import math
from types import SimpleNamespace

import jax

from distributed_llm_training_benchmark_framework_tpu.parallel import strategies as jstrat


def jax_data_axis(port_name, shape, n_layer, mesh_shape, kv_heads=None):
    """The axis of the port leaf ``port_name`` (its global shape, one layer)
    that JAX's rule puts ``data`` on at ``mesh_shape``, or None."""
    parts = port_name.split(".")
    block = parts[0] == "blocks"
    leaf = jax.ShapeDtypeStruct((n_layer, *shape) if block else tuple(shape), "float32")
    tree = {"blocks": {parts[-1]: leaf}} if block else {port_name: leaf}
    specs = jstrat.param_partition_specs(tree, SimpleNamespace(shape=dict(mesh_shape)), True,
                                         kv_heads=kv_heads)
    spec = tuple(specs["blocks"][parts[-1]] if block else specs[port_name])
    if "data" not in spec:
        return None
    ax = spec.index("data")
    if block:
        return ax - 1 if ax > 0 else None
    return ax


def fsdp_local_numel(port_name, shape, n_layer, mesh_shape, d, kv_heads=None):
    """The elements ``data`` index ``d`` holds of the leaf: its chunk of
    JAX's ``data`` axis (torch.chunk's split), or the whole leaf."""
    dp = mesh_shape["data"]
    ax = jax_data_axis(port_name, shape, n_layer, mesh_shape, kv_heads)
    n = math.prod(shape)
    if ax is None or dp == 1:
        return n
    c = -(-shape[ax] // dp)
    return n // shape[ax] * min(c, max(0, shape[ax] - d * c))
