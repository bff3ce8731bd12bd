"""Per-card device-memory footprint of one training arm: refuse before
building what cannot fit, and pick zero3's remat policy.

Port of ``distributed_llm_training_benchmark_framework_tpu/utils/memory.py``
(``HBMEstimate``, ``estimate_hbm``, ``check_fits``, ``format_breakdown``,
``resolve_auto_remat``; the JAX package's ahead-of-time compile probe has no
counterpart, since there is no XLA here).

- **Parameter, gradient and optimizer bytes are those of the layout the
  port holds on rank 0** (``parallel/strategies.apply_strategy``), in the
  model's parameter dtype (fp32, or bf16 under ``param_dtype`` "bf16" and
  host offload; gradients and AdamW moments follow it, as optax's do),
  from the parameter shapes of the model built on the meta device. Under
  host offload the optimizer term is 0: masters and moments live on the
  host (JAX's rule); the bf16 parameters and gradients stay. Without a
  process group, and under ddp, every rank holds whole params, grads and
  both AdamW moments. fsdp / zero3 (FSDP2) keep rank 0's chunk of every
  leaf on the axis JAX's rule shards over ``data``
  (``parallel/strategies.fsdp_data_axis``), ceil(n / dp) of its n rows
  there, or the whole leaf where the rule finds no axis, for all three. zero2
  holds its buckets' replicated flat buffers (one per block and one for the
  leaves outside the blocks, each padded to a multiple of dp), flat
  gradient buffers of the same sizes plus the shards they are
  reduce-scattered into, and the moments of the shards. AdamW's step
  counters are host scalars and are not counted.
- **Activations and logits use the JAX package's analytic formula**: per
  layer ``(10 + F/D widths of the MLP) * B * S * D`` compute-dtype bytes,
  the O(S^2) scores only for the materialized 'reference' attention, remat
  collapsing the per-layer term, and the fp32 logits plus their cotangent.
- **Under a (data, seq) mesh** (``seq`` over the group) the layout is
  sharded over ``data`` only, as the arms lay it out, and the activation
  term keeps JAX's formula at the global ``seq_len``: it does not divide by
  ``seq``, though each rank holds S/n of the sequence. That over-count is
  the JAX package's, kept as it is.
- **Under a ``model``, ``pipe`` or ``expert`` axis** (tensor, pipeline or
  expert parallelism; JAX's ``_EP_RULES`` put ``expert`` on the experts
  axis of the expert leaves, its pipeline rule ``pipe`` on the layer axis
  of the block leaves) the parameter, gradient
  and AdamW-moment bytes are the JAX package's: its layout rules
  (``parallel/strategies.param_partition_specs``, copied with the
  composed-mesh hygiene of a (data, model) mesh) over JAX's leaves, each
  leaf's bytes divided by the widths its spec shards it over; params by the
  arm's spec, grads sharded when the arm shards them, moments sharded when
  the arm shards the optimizer state (optax's step counters, a few bytes,
  are not counted). The activation term divides by tp as JAX's does (the
  logits term does not, as in JAX), and counts the stage's ``L // pp``
  layers of one micro-batch: JAX's term, though a GPipe stage holds all M
  micro-batches' activations at once (an under-count kept as JAX has it).
- **Under the scan layer loop** (``TinyGPTConfig.scan_layers``) the state
  bytes are JAX's as above at every mesh, by the rule's ``scan_stacked``
  form, as JAX's ``estimate_hbm`` reads ``scan_layers``.
- The device-resident synthetic table is int64 here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..models.tinygpt import TinyGPT, normalize_remat
from ..parallel.mesh import AXES
from ..parallel.strategies import (
    fsdp_data_axis,
    jax_leaf_name,
    param_partition_specs,
    zero2_bucket,
)

# Device memory per card in bytes, matched by substring against the device
# name: 80 GB (decimal) for both H100 parts, from NVIDIA's data sheet.
_HBM_BYTES = (
    ("H100", 80 * 10**9),
)


def device_hbm_bytes(device_kind: str) -> Optional[int]:
    """Device memory of a card, or None if unknown (the CPU)."""
    for name, nbytes in _HBM_BYTES:
        if name.lower() in device_kind.lower():
            return nbytes
    return None


@dataclasses.dataclass
class HBMEstimate:
    params: int
    grads: int
    opt_state: int
    activations: int
    logits: int
    dataset: int

    @property
    def total(self) -> int:
        return (self.params + self.grads + self.opt_state
                + self.activations + self.logits + self.dataset)

    def breakdown(self) -> Dict[str, float]:
        gib = 1024**3
        return {
            "params_gib": self.params / gib,
            "grads_gib": self.grads / gib,
            "opt_state_gib": self.opt_state / gib,
            "activations_gib": self.activations / gib,
            "logits_gib": self.logits / gib,
            "dataset_gib": self.dataset / gib,
            "total_gib": self.total / gib,
        }


def param_shapes(model_config) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of the model's parameters, from a build on the meta
    device."""
    unrolled = dataclasses.replace(model_config, scan_layers=False)
    with torch.device("meta"):
        return [(name, tuple(p.shape)) for name, p in TinyGPT(unrolled).named_parameters()]


def param_itemsize(model_config) -> int:
    return torch.empty((), dtype=model_config.param_dtype).element_size()


def state_bytes(shapes: List[Tuple[str, Tuple[int, ...]]], strategy, dp: int, wrapped: bool,
                item: int = 4, n_layer: int = 1, kv_heads: int = 1) -> Tuple[int, int, int]:
    """(params, grads, AdamW moments) bytes rank 0 holds, leaves (name,
    shape) of ``item`` bytes per element of a model of ``n_layer`` layers,
    under the arm's layout over ``dp`` ranks (``wrapped``: a process group
    is up, so the arm's wrapper runs); no moments on the device under host
    offload."""
    moments = 0 if strategy.offload_opt_state else 2
    n = sum(math.prod(s) for _, s in shapes)
    if not wrapped or not strategy.shard_grads:
        return n * item, n * item, moments * n * item
    if strategy.shard_params:
        local = 0
        for name, s in shapes:
            ax = fsdp_data_axis(name, s, {"data": dp}, kv_heads, n_layer) if dp > 1 else None
            local += math.prod(s) if ax is None else math.prod(s) // s[ax] * -(-s[ax] // dp)
        return local * item, local * item, moments * local * item
    buckets: Dict[str, int] = {}
    for name, s in shapes:
        buckets[zero2_bucket(name)] = buckets.get(zero2_bucket(name), 0) + math.prod(s)
    size = sum(-(-b // dp) for b in buckets.values())
    return size * dp * item, (size * dp + size) * item, moments * size * item


def jax_leaf_shapes(model_config) -> Dict[str, Tuple[int, ...]]:
    """The JAX package's leaves of the model, global shapes: {``wte``: (V, D),
    ``blocks/wqkv``: (L, D, 3, D), ...}, block leaves stacked on a layer axis."""
    with torch.device("meta"):
        model = TinyGPT(dataclasses.replace(model_config, scan_layers=False))
    out = {}
    for name, p in model.named_parameters():
        leaf = jax_leaf_name(name)
        if leaf.startswith("blocks/"):
            out[leaf] = (model_config.n_layer, *p.shape)
        else:
            out[leaf] = tuple(p.shape)
    return out


def spec_state_bytes(model_config, strategy, mesh_shape: Dict[str, int]) -> Tuple[int, int, int]:
    """(params, grads, AdamW moments) bytes of one card by the JAX
    package's layout rules over ``mesh_shape`` (leaves in the parameter
    dtype; see the module docstring), in their ``scan_stacked`` form under
    the scan layer loop, as JAX's ``estimate_hbm`` takes them."""
    shapes = jax_leaf_shapes(model_config)
    item = param_itemsize(model_config)

    def total(shard: bool) -> int:
        specs = param_partition_specs(shapes, mesh_shape, shard, kv_heads=model_config.kv_heads,
                                      scan_stacked=model_config.scan_layers)
        out = 0
        for name, shape in shapes.items():
            factor = math.prod(mesh_shape.get(ax, 1) for ax in specs[name] if ax is not None)
            out += item * math.prod(shape) // factor
        return out

    params = total(strategy.shard_params)
    grads = total(strategy.shard_params or strategy.shard_grads)
    if strategy.offload_opt_state:
        return params, grads, 0
    moments = 2 * (total(True) if strategy.shard_opt_state else params)
    return params, grads, moments


def estimate_hbm(model_config: Any, strategy: Any, mesh: Any, per_device_batch: int,
                 seq_len: int, dataset_size: int = 0) -> HBMEstimate:
    """Estimate rank 0's device-memory footprint of one training arm."""
    cfg = model_config
    dp = mesh.size(AXES.data) if mesh is not None else 1
    tp = mesh.size(AXES.model) if mesh is not None else 1
    ep = mesh.size(AXES.expert) if mesh is not None else 1
    pp = mesh.size(AXES.pipe) if mesh is not None else 1
    wrapped = mesh is not None and mesh.device_mesh is not None
    if tp > 1 or ep > 1 or pp > 1 or cfg.scan_layers:
        mesh_shape = dict(mesh.shape) if mesh is not None else {}
        params_b, grads_b, opt_b = spec_state_bytes(cfg, strategy, mesh_shape)
    else:
        params_b, grads_b, opt_b = state_bytes(param_shapes(cfg), strategy, dp, wrapped,
                                               param_itemsize(cfg), cfg.n_layer, cfg.kv_heads)

    # Analytic activations of one micro-batch's forward and backward (the
    # JAX package's formula and coefficients).
    B = per_device_batch
    S, D, L, H, V = seq_len, cfg.n_embd, cfg.n_layer, cfg.n_head, cfg.vocab_size
    cbytes = torch.empty((), dtype=cfg.compute_dtype).element_size()
    F = cfg.mlp_dim
    mlp_widths = (2 if cfg.mlp_act == "swiglu" else 1) * F / D
    dense_per_layer = int((10 + mlp_widths) * B * S * D) * cbytes
    # Megatron TP shards the head and MLP activations.
    dense_per_layer = dense_per_layer // tp
    if cfg.attention_impl == "reference":
        dense_per_layer += 2 * B * (H // tp) * S * S * 4
    layers_here = L // pp
    pol = normalize_remat("full" if cfg.remat == "auto" else cfg.remat)
    if pol == "full":
        act_b = layers_here * 2 * B * S * D * cbytes + dense_per_layer
    elif pol == "dots":
        act_b = layers_here * 11 * B * S * D * cbytes + dense_per_layer
    else:
        act_b = layers_here * dense_per_layer
    logits_b = 2 * B * S * V * 4
    dataset_b = dataset_size * seq_len * 8  # the int64 table on the device
    return HBMEstimate(params=params_b, grads=grads_b, opt_state=opt_b,
                       activations=act_b, logits=logits_b, dataset=dataset_b)


def format_breakdown(est: HBMEstimate, device_kind: str) -> str:
    b = est.breakdown()
    cap = device_hbm_bytes(device_kind)
    lines = [
        "Estimated per-chip HBM footprint:",
        f"  params:      {b['params_gib']:7.2f} GiB",
        f"  grads:       {b['grads_gib']:7.2f} GiB",
        f"  opt state:   {b['opt_state_gib']:7.2f} GiB",
        f"  activations: {b['activations_gib']:7.2f} GiB (analytic)",
        f"  logits:      {b['logits_gib']:7.2f} GiB",
        f"  dataset:     {b['dataset_gib']:7.2f} GiB",
        f"  total:       {b['total_gib']:7.2f} GiB"
        + (f" / {cap / 1024**3:.0f} GiB {device_kind}" if cap else ""),
    ]
    return "\n".join(lines)


# The estimate must stay below this share of the card before a cheaper remat
# policy is chosen (the JAX package's margin, kept until the port's own
# estimate-vs-measured bias is known).
AUTO_REMAT_MARGIN = 0.70


def check_fits(est: HBMEstimate, device_kind: str, margin: float = 0.95) -> Optional[str]:
    """A refusal message if the estimate exceeds ``margin`` of the card's
    memory, else None. Unknown devices (the CPU) are never refused."""
    cap = device_hbm_bytes(device_kind)
    if cap is None or est.total <= cap * margin:
        return None
    b = est.breakdown()
    hints = []
    if b["opt_state_gib"] + b["grads_gib"] > 0.4 * b["total_gib"]:
        hints.append("a sharded arm (fsdp/zero3) or more cards")
    if b["activations_gib"] > 0.3 * b["total_gib"]:
        hints.append("remat, a smaller --per-device-batch, or --attention flash")
    hint = f" Try {' and '.join(hints)}." if hints else ""
    return (
        f"Estimated footprint {b['total_gib']:.1f} GiB exceeds "
        f"{cap / 1024**3:.0f} GiB on {device_kind} (margin {margin:.0%}).{hint}\n"
        f"{format_breakdown(est, device_kind)}"
    )


def resolve_auto_remat(model_config: Any, strategy: Any, mesh: Any, per_device_batch: int,
                       seq_len: int, dataset_size: int = 0, device_kind: str = "") -> Any:
    """Resolve a strategy's remat "auto" to the cheapest policy that fits:
    "none", then "dots", then "full", each held to ``AUTO_REMAT_MARGIN`` of
    the card by :func:`check_fits`; "full" when none does (the loop's
    pre-flight then refuses). Other strategies come back unchanged; an
    unknown device (the CPU) resolves to "none"."""
    if strategy.remat != "auto":
        return strategy
    for pol in ("none", "dots", "full"):
        cand = dataclasses.replace(strategy, remat=pol)
        est = estimate_hbm(dataclasses.replace(model_config, remat=pol), cand, mesh,
                           per_device_batch, seq_len, dataset_size=dataset_size)
        if check_fits(est, device_kind, margin=AUTO_REMAT_MARGIN) is None:
            return cand
    return dataclasses.replace(strategy, remat="full")
