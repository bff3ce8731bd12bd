"""Per-card device-memory footprint of one training arm: refuse before
building what cannot fit, and pick zero3's remat policy.

Port of ``distributed_llm_training_benchmark_framework_tpu/utils/memory.py``
(``HBMEstimate``, ``estimate_hbm``, ``check_fits``, ``format_breakdown``,
``resolve_auto_remat``; the JAX package's ahead-of-time compile probe has no
counterpart, since there is no XLA here).

- **Parameter, gradient and optimizer bytes are those of the layout the
  port holds on rank 0** (``parallel/strategies.apply_strategy``), fp32
  throughout, from the parameter shapes of the model built on the meta
  device. Without a process group, and under ddp, every rank holds whole
  params, grads and both AdamW moments. fsdp / zero3 (FSDP2) keep rank 0's
  rows of dim 0 of every leaf, ceil(d0 / dp) of them, for all three. zero2
  holds the replicated flat buffer (padded to a multiple of dp), a flat
  gradient buffer of the same size plus the shard it is reduce-scattered
  into, and the moments of one shard. AdamW's step counters are host
  scalars and are not counted.
- **Activations and logits use the JAX package's analytic formula**: per
  layer ``(10 + F/D widths of the MLP) * B * S * D`` compute-dtype bytes,
  the O(S^2) scores only for the materialized 'reference' attention, remat
  collapsing the per-layer term, and the fp32 logits plus their cotangent.
- The device-resident synthetic table is int64 here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..models.tinygpt import TinyGPT, normalize_remat
from ..parallel.mesh import AXES

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


def param_shapes(model_config) -> List[Tuple[int, ...]]:
    """Shapes of the model's parameters, from a build on the meta device."""
    with torch.device("meta"):
        return [tuple(p.shape) for p in TinyGPT(model_config).parameters()]


def state_bytes(shapes: List[Tuple[int, ...]], strategy, dp: int,
                wrapped: bool) -> Tuple[int, int, int]:
    """(params, grads, AdamW moments) bytes rank 0 holds, fp32 leaves of
    ``shapes``, under the arm's layout over ``dp`` ranks (``wrapped``: a
    process group is up, so the arm's wrapper runs)."""
    item = 4
    n = sum(math.prod(s) for s in shapes)
    if not wrapped or not strategy.shard_grads:
        return n * item, n * item, 2 * n * item
    if strategy.shard_params:
        local = sum(-(-s[0] // dp) * math.prod(s[1:]) for s in shapes)
        return local * item, local * item, 2 * local * item
    size = -(-n // dp)
    return size * dp * item, (size * dp + size) * item, 2 * size * item


def estimate_hbm(model_config: Any, strategy: Any, mesh: Any, per_device_batch: int,
                 seq_len: int, dataset_size: int = 0) -> HBMEstimate:
    """Estimate rank 0's device-memory footprint of one training arm."""
    cfg = model_config
    dp = mesh.size(AXES.data) if mesh is not None else 1
    wrapped = mesh is not None and mesh.device_mesh is not None
    params_b, grads_b, opt_b = state_bytes(param_shapes(cfg), strategy, dp, wrapped)

    # Analytic activations of one micro-batch's forward and backward (the
    # JAX package's formula and coefficients).
    B = per_device_batch
    S, D, L, H, V = seq_len, cfg.n_embd, cfg.n_layer, cfg.n_head, cfg.vocab_size
    cbytes = torch.empty((), dtype=cfg.compute_dtype).element_size()
    F = cfg.mlp_dim
    mlp_widths = (2 if cfg.mlp_act == "swiglu" else 1) * F / D
    dense_per_layer = int((10 + mlp_widths) * B * S * D) * cbytes
    if cfg.attention_impl == "reference":
        dense_per_layer += 2 * B * H * S * S * 4
    pol = normalize_remat("full" if cfg.remat == "auto" else cfg.remat)
    if pol == "full":
        act_b = L * 2 * B * S * D * cbytes + dense_per_layer
    elif pol == "dots":
        act_b = L * 11 * B * S * D * cbytes + dense_per_layer
    else:
        act_b = L * dense_per_layer
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
