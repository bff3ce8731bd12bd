"""Strategy arms: the optimizer recipe and the sharding layout over ``data``.

Port of ``distributed_llm_training_benchmark_framework_tpu/parallel/strategies.py``
(``StrategyConfig``, ``STRATEGIES``, ``make_optimizer``). An arm is data:
an optimizer recipe plus a (params, grads, optimizer state) layout over the
mesh's ``data`` axis. The JAX package states the layout as sharding specs
and lets XLA derive the collectives; the port builds each layout on
``torch.distributed`` (``apply_strategy``):

- **ddp**   params, grads and AdamW state replicated: ``DistributedDataParallel``
  all-reduces (averages) the grads in the last micro-batch's backward
  (``no_sync`` on the others);
- **fsdp**  params, grads and AdamW state sharded on ``data``: FSDP2
  ``fully_shard`` on every block and then on the root (which keeps ``wte``,
  ``wpe``, the final norm and ``lm_head``, so the tied ``wte`` stays one
  parameter); weights are all-gathered per use and grads reduce-scattered;
- **zero2** params replicated, grads and AdamW state sharded: one bucket
  per (block, dtype, sharded kind) and one for the leaves outside the
  blocks, each a flat buffer padded to a multiple of the ``data`` width
  that holds the params as views, beside another for the grads. In the
  last micro-batch's backward a parameter's post-accumulate-grad hook
  counts down its bucket, and the bucket's reduce-scatter into this rank's
  shard starts (asynchronously) as soon as its last gradient lands, so each
  block's reduce-scatter overlaps the backward of the blocks before it, as
  JAX's per-block grad spec (``zero2_block_grad_spec``) lets XLA schedule
  it; after the backward the arm waits for them and averages. AdamW
  updates each shard of the params in place, and an all-gather per bucket
  refills the replicated buffers (DeepSpeed ZeRO stage 2's semantics, as
  in JAX);
- **zero3** like fsdp, with per-layer remat ``auto`` (resolved against the
  memory model by the loop, ``utils/memory.resolve_auto_remat``).

ddp and fsdp run bare AdamW; zero2 and zero3 add the 5-step warmup and the
clip. Without a process group (one device, no launcher) every arm is its
optimizer recipe on the plain model, with no wrapper.

When ``seq`` rides the group (a (data, seq) mesh of dp * n ranks,
``parallel/mesh.py``), the ranks of a ``seq`` group hold parts of one
example: parameters are replicated over ``seq`` and, for fsdp / zero3,
sharded over ``data`` only, and the AdamW state is sharded over ``data``
only, as JAX's ``param_partition_specs`` puts only ``data`` on a leaf. The
gradients are averaged over all dp * n ranks, which is JAX's global-mean
gradient because every rank's loss is a mean over the same count of
targets (``train/step.py``). ddp is DDP over the whole group; fsdp / zero3
are FSDP2 over a 2-D mesh whose replicate dim is ``seq`` and whose shard
dim is ``data`` (``mesh.replicate_shard_data``: FSDP2 takes (replicate,
shard) while the ranks are data-major); zero2 reduce-scatters over
``data``, all-reduces over ``seq`` and divides once by dp * n. The clip's
norm is the full gradient's in every arm: each rank's shards are summed
over ``data``, whose ranks together hold the whole gradient.

Under tensor parallelism (``model`` rides the group, a (data, seq, model)
mesh) each rank holds its ``model`` index's shard of the Megatron layout
(JAX's ``_TP_RULES``, below, with the kv-head-aligned GQA rule; the model
is built at those local widths, ``models/tinygpt.py``). Every arm lays out
and reduces those local shards over the data x seq ranks of its ``model``
index only, never over ``model``: ddp is DDP over that group
(``Mesh.arm_group``), fsdp / zero3 FSDP2 over the ``data`` (or (seq,
data)) sub-mesh of its ``model`` index (``mesh.shard_data_mesh``), zero2's
flat buffers over ``data`` and ``seq`` as above. Leaves replicated over
``model`` get gradients equal on every ``model`` rank (the "f" operators of
``parallel/tensor.py``; where a rank sees only part of a replicated leaf's
gradient, the model sums it over ``model`` in its backward). The clip's
norm counts each element once: the squares of ``model``-sharded leaves
are summed over ``model``, replicated leaves counted once, as optax's
global norm over the whole tree.

Under expert parallelism (an ``expert`` axis of width ep over the group;
``models/moe.py``) the batch rows shard over data x expert and each rank
holds its E/ep experts, JAX's ``_EP_RULES``. The leaves outside the experts
are replicated over ``expert`` and their gradients averaged over the dp *
sp * ep ranks of the arm (``Mesh.arm_group``; sp the ``seq`` width when it
rides the group, else 1); the expert leaves are summed over the ranks that
hold the same experts, ``data`` and ``seq`` (``expert_reduce``), and
divided by dp * sp * ep: the all-to-all's backward has already brought
every member's token gradients to the expert's owner, and each member's
loss is a mean over its own tokens. ddp is DDP over the arm's group with
the expert leaves ignored by DDP and all-reduced by hand; fsdp / zero3
wrap each block's experts in FSDP2 over the ``data`` mesh, or (seq, data)
(``mesh.expert_shard_mesh``: its average, then a division by ep), and the
rest over the (seq x expert, data) mesh, replicate over ``seq`` and
``expert`` and shard over ``data`` (HSDP; JAX's ``shard_params`` shards
over ``data`` only); zero2's buckets part the expert leaves from the rest:
both reduce-scatter over ``data`` and all-reduce over ``seq``, the rest
then over ``expert``, and both divide by dp * sp * ep. The clip's norm
sums the expert leaves' squares over ``expert`` as it sums tp's over
``model``; beside ``model`` an expert leaf that ``model`` shards (``moe_w1``,
``moe_b1``, ``moe_w2``: JAX's ``_TP_RULES``) is summed over both
(``shard_axes``), and beside ``pipe`` a stage's expert leaves over
``expert`` and ``pipe``.

Under pipeline parallelism (a ``pipe`` axis of width pp over the group;
``parallel/pipeline.py``) each rank holds its stage's blocks and, replicated
on every stage, the leaves outside the blocks (JAX's
``pipeline_param_specs``). Every arm lays out and reduces the stage's
parameters over the data x seq ranks of its ``pipe`` index, as above, with
the whole schedule of a step as the accumulation: ddp runs it under
``no_sync`` and then all-reduces the gradients once (DDP's reducer wants a
forward / backward pair per micro-batch, which a schedule does not give);
zero2 arms a block's bucket for the schedule's last backward unit of that
block (``Optimizer.last_backward``); FSDP2 reduce-scatters in every
backward unit, as it does in every micro-batch without a pipeline. After
the arm's reduction the replicated leaves' gradients are summed over
``pipe`` (the first stage holds the embedding's share, the last the
head's), so they stay equal on every stage. The clip's norm sums the
blocks' squares over ``pipe`` and counts the replicated leaves once.
Beside a ``model`` axis (JAX's layout: the blocks' Megatron shards, ``wte``
and ``lm_head`` whole on every ``model`` rank) each arm works over the
data x seq ranks of one (``model``, ``pipe``) index, and the clip sums the
squares of a stage's ``model``-sharded leaves over ``model`` and then all
of the stage's own leaves over ``pipe``.

fsdp / zero3 shard each leaf on the axis JAX's ``param_partition_specs``
puts ``data`` on (``fsdp_data_axis``, FSDP2's ``shard_placement_fn``), not
on dim 0 padded to the ``data`` width, whose padded buffers grew with the
width; a leaf JAX leaves replicated over ``data`` stays whole
(``_fully_shard``).

The recipe equals optax's ``chain(clip_by_global_norm(c), adamw(schedule))``:

- clip: with g_norm = sqrt(sum of squares over every gradient), each
  gradient becomes ``(g / g_norm) * c`` when ``g_norm >= c`` and stays as it
  is otherwise (optax's formula; ``torch.nn.utils.clip_grad_norm_`` divides
  by ``g_norm + 1e-6`` and does not match). Where the grads are shards of
  one gradient (fsdp, zero2, zero3), the squares of every rank's shard are
  summed over ``data`` (zero2's padding is zero and adds nothing). The
  squares of fp32 gradients are summed in fp64 and the norm rounded once to
  fp32, so it does not depend on how the gradient is cut into shards or
  buckets (optax sums in fp32; the two differ in the last bit at most);
- AdamW: ``torch.optim.AdamW``, whose update equals optax ``adamw``: decay
  decoupled and scaled by lr, bias correction from step 1, eps outside the
  square root, decay on every leaf. AdamW is elementwise, so on a shard
  (a flat one, or a DTensor's) it computes what optax computes per leaf;
- learning rate: optax ``linear_schedule(0, lr, warmup_steps)`` evaluated at
  the update count before each update, so update 0 runs at lr 0 and update
  ``warmup_steps`` onwards at the full rate.

``param_dtype`` "bf16" stores the parameters, and so their gradients and
AdamW moments, in bf16 (the model is built so, ``train/loop.py``); the
recipe is the same. ``offload_opt_state`` keeps fp32 masters and the AdamW
moments in host memory and runs the update there (``parallel/offload.py``)
over the same local tensors the arm would update on the device: ddp's
whole parameters, zero2's shards of the flat buffers, fsdp / zero3's
DTensor shards, each under ``model`` a tp shard. Its clip is JAX's offload
clip, a scale ``c / max(g_norm, c)`` from an fp32 norm, which the host
folds into the gradient's fp32 upcast.

The arms are also read from JSON (``load_strategy_config`` over
``configs/strategies/*.json``; ``from_deepspeed_config`` over a DeepSpeed
config), with the JAX package's defaults, mappings and messages.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
from typing import Any, ContextManager, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor import DTensor, Shard
from torch.nn.parallel import DistributedDataParallel

from .mesh import AXES, Mesh, expert_shard_mesh, shard_data_mesh
from .offload import HostOffload


@dataclasses.dataclass(frozen=True)
class StrategyConfig:
    """One strategy arm = optimizer recipe + sharding layout + remat policy
    (the JAX package's fields, with its defaults)."""

    name: str
    learning_rate: float = 1e-4
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.01
    # The DeepSpeed arms use a 5-step warmup and clip 1.0; the torch arms
    # neither.
    warmup_steps: int = 0
    grad_clip: Optional[float] = None
    # Layout over the mesh's 'data' axis.
    shard_params: bool = False
    shard_grads: bool = False
    shard_opt_state: bool = False
    # Per-layer remat: "none" | "dots" | "full" | "auto" (resolved by the
    # loop against utils.memory before the model is built).
    remat: str = "none"
    # Compute dtype of the model: 'bf16' | 'f32'.
    precision: str = "bf16"
    # Parameter (and so gradient and AdamW-moment) storage dtype: 'f32' |
    # 'bf16'.
    param_dtype: str = "f32"
    # ZeRO-Offload: fp32 masters and AdamW moments in host memory, the update
    # on the host, a bf16 compute copy on the device (parallel/offload.py).
    offload_opt_state: bool = False
    # The offload arm's delayed update: the host applies the previous step's
    # gradients while the device runs this step (parameters one step stale).
    offload_delayed_update: bool = False

    def describe(self) -> str:
        bits = [
            f"params={'sharded' if self.shard_params else 'replicated'}",
            f"grads={'reduce-scatter' if self.shard_grads else 'all-reduce'}",
            f"opt_state={'sharded' if self.shard_opt_state else 'replicated'}",
        ]
        if self.remat != "none":
            bits.append(f"remat={self.remat}")
        if self.param_dtype != "f32":
            bits.append(f"param_dtype={self.param_dtype}")
        if self.offload_opt_state:
            bits.append("opt_offload=pinned_host")
        if self.offload_delayed_update:
            bits.append("delayed_update")
        return f"{self.name}: " + ", ".join(bits)


STRATEGIES: Dict[str, StrategyConfig] = {
    "ddp": StrategyConfig(name="ddp"),
    "fsdp": StrategyConfig(
        name="fsdp", shard_params=True, shard_grads=True, shard_opt_state=True
    ),
    "zero2": StrategyConfig(
        name="zero2", shard_grads=True, shard_opt_state=True, warmup_steps=5, grad_clip=1.0,
    ),
    "zero3": StrategyConfig(
        name="zero3", shard_params=True, shard_grads=True, shard_opt_state=True,
        warmup_steps=5, grad_clip=1.0, remat="auto",
    ),
}


def get_strategy(name: str) -> StrategyConfig:
    if name not in STRATEGIES:
        raise ValueError(f"Unknown strategy {name!r} (expected one of {sorted(STRATEGIES)})")
    return STRATEGIES[name]


def check_ported(strategy: StrategyConfig) -> None:
    """Refuse a strategy the port cannot run, as the JAX package refuses it."""
    if strategy.param_dtype not in ("f32", "bf16"):
        raise ValueError(
            f"{strategy.name}: invalid param_dtype {strategy.param_dtype!r} in strategy config "
            "(expected 'f32' or 'bf16')"
        )
    if strategy.offload_delayed_update and not strategy.offload_opt_state:
        raise ValueError(
            f"{strategy.name}: offload_delayed_update requires offload_opt_state (it schedules "
            "the HOST optimizer update; there is nothing to delay on a device-resident "
            "optimizer)"
        )
    if strategy.precision not in ("bf16", "f32"):
        raise ValueError(f"{strategy.name}: precision must be 'bf16' or 'f32', "
                         f"got {strategy.precision!r}")
    layout = (strategy.shard_params, strategy.shard_grads, strategy.shard_opt_state)
    if layout not in ((False, False, False), (True, True, True), (False, True, True)):
        raise ValueError(
            f"{strategy.name}: layout params/grads/opt_state sharded = {layout} is none of "
            "ddp's, fsdp's (zero3's) or zero2's"
        )


def param_torch_dtype(strategy: StrategyConfig) -> torch.dtype:
    """The model's parameter dtype under ``strategy``: bf16 under
    ``param_dtype`` "bf16" and under host offload, whose device parameters
    are a bf16 compute copy of the host masters (JAX's
    ``_resolve_model_config``)."""
    if strategy.param_dtype == "bf16" or strategy.offload_opt_state:
        return torch.bfloat16
    return torch.float32


# ---------------------------------------------------------------------------
# Strategy configs from JSON (JAX parallel/strategies.py)
# ---------------------------------------------------------------------------


def _normalize_remat_field(value: Any) -> str:
    """JSON remat field: bool (legacy, True="full"), a model policy string,
    or "auto" (resolved against the memory model before reaching the model)."""
    if value == "auto":
        return value
    from ..models.tinygpt import normalize_remat  # the model imports this module

    try:
        return normalize_remat(value)
    except ValueError:
        raise ValueError(
            f"invalid remat value {value!r} in strategy config "
            "(expected bool or one of 'none'/'dots'/'full'/'auto')"
        )


def load_strategy_config(path: str) -> StrategyConfig:
    """A strategy arm from a JSON file (``configs/strategies/*.json``):

        {"strategy": "zero2",
         "optimizer": {"lr": 1e-4, "betas": [0.9, 0.999], "eps": 1e-8,
                        "weight_decay": 0.01},
         "scheduler": {"warmup_steps": 5},
         "grad_clip": 1.0,
         "precision": "bf16",
         "sharding": {"params": false, "grads": true, "opt_state": true},
         "remat": false}

    Fields left out keep the named arm's defaults (or StrategyConfig's for
    an unknown name); ``param_dtype`` and ``offload_opt_state`` are read
    too."""
    with open(path) as f:
        raw = json.load(f)
    name = raw.get("strategy")
    base = (get_strategy(name) if name in STRATEGIES
            else StrategyConfig(name=name or os.path.basename(path)))
    opt = raw.get("optimizer", {})
    sched = raw.get("scheduler", {})
    shard = raw.get("sharding", {})
    pdtype = raw.get("param_dtype", base.param_dtype)
    if pdtype not in ("f32", "bf16"):
        raise ValueError(
            f"invalid param_dtype {pdtype!r} in strategy config "
            "(expected 'f32' or 'bf16')"
        )
    return dataclasses.replace(
        base,
        learning_rate=float(opt.get("lr", base.learning_rate)),
        betas=tuple(opt.get("betas", base.betas)),
        eps=float(opt.get("eps", base.eps)),
        weight_decay=float(opt.get("weight_decay", base.weight_decay)),
        warmup_steps=int(sched.get("warmup_steps", base.warmup_steps)),
        grad_clip=raw.get("grad_clip", base.grad_clip),
        precision=raw.get("precision", base.precision),
        param_dtype=pdtype,
        shard_params=bool(shard.get("params", base.shard_params)),
        shard_grads=bool(shard.get("grads", base.shard_grads)),
        shard_opt_state=bool(shard.get("opt_state", base.shard_opt_state)),
        remat=_normalize_remat_field(raw.get("remat", base.remat)),
        offload_opt_state=bool(raw.get("offload_opt_state", base.offload_opt_state)),
    )


def is_deepspeed_config(raw: Any) -> bool:
    """True when a JSON dict looks like a DeepSpeed config rather than the
    native strategy format (which always carries a "strategy" key)."""
    if not isinstance(raw, dict) or "strategy" in raw:
        return False
    return any(k in raw for k in ("zero_optimization", "train_micro_batch_size_per_gpu",
                                  "gradient_clipping", "bf16", "fp16"))


def from_deepspeed_config(raw: Dict[str, Any], strategy_name: str) -> StrategyConfig:
    """The arm ``strategy_name`` with a DeepSpeed config's recipe:

    - ``optimizer.params.{lr,betas,eps,weight_decay}``: the AdamW recipe
      (type Adam or AdamW only);
    - ``scheduler.params.warmup_num_steps`` (WarmupLR, WarmupDecayLR): the
      linear warmup;
    - ``gradient_clipping``: the global-norm clip (0 disables it);
    - ``bf16.enabled`` / ``fp16.enabled``: bf16 compute;
    - ``zero_optimization.stage``: checked against the arm (zero2 / zero3);
    - ``zero_optimization.offload_optimizer.device``: "cpu" / "nvme" turn
      host offload on, "none" off; absent, the arm's default.

    A numeric field "auto" (HF Trainer's) keeps the arm's default. Batch
    keys are not read: the batch geometry comes from the caller."""
    base = get_strategy(strategy_name)

    def section(key):
        val = raw.get(key, {})
        if not isinstance(val, dict):
            raise ValueError(f"DeepSpeed config section {key!r} must be an object, got {val!r}")
        return val

    def num(container, key, fallback, cast=float):
        val = container.get(key, None)
        if val is None or val == "auto":
            return fallback
        try:
            return cast(val)
        except (TypeError, ValueError):
            raise ValueError(f"DeepSpeed config field {key!r} has non-numeric value {val!r}")

    zero = section("zero_optimization")
    stage = num(zero, "stage", None, int)
    expected = {"zero2": 2, "zero3": 3}.get(strategy_name)
    if stage is not None and expected is not None and stage != expected:
        raise ValueError(
            f"--strategy {strategy_name} but DeepSpeed config sets "
            f"zero_optimization.stage={stage}"
        )
    opt_section = section("optimizer")
    opt_type = opt_section.get("type", "AdamW")
    if str(opt_type).lower() not in ("adam", "adamw"):
        raise ValueError(
            f"DeepSpeed optimizer type {opt_type!r} is not supported "
            "(only Adam/AdamW map onto this framework's optimizer)"
        )
    opt = opt_section.get("params", {})
    if not isinstance(opt, dict):
        raise ValueError(
            f"DeepSpeed config field 'optimizer.params' must be an object, got {opt!r}"
        )
    sched = section("scheduler")
    sched_params = sched.get("params", {})
    if not isinstance(sched_params, dict):
        raise ValueError(
            f"DeepSpeed config field 'scheduler.params' must be an object, "
            f"got {sched_params!r}"
        )
    warmup = base.warmup_steps
    if sched.get("type", "WarmupLR") in ("WarmupLR", "WarmupDecayLR"):
        warmup = num(sched_params, "warmup_num_steps", base.warmup_steps, int)
    betas = opt.get("betas", None)
    if betas is None or betas == "auto":
        betas = base.betas
    elif not (isinstance(betas, (list, tuple)) and len(betas) == 2
              and all(isinstance(b, (int, float)) for b in betas)):
        raise ValueError(f"DeepSpeed config field 'betas' must be [b1, b2], got {betas!r}")
    precision = base.precision
    if section("bf16").get("enabled") or section("fp16").get("enabled"):
        precision = "bf16"
    grad_clip = num(raw, "gradient_clipping", base.grad_clip)
    if grad_clip is not None and grad_clip <= 0:
        grad_clip = None  # DeepSpeed: 0 disables clipping
    ds_off = zero.get("offload_optimizer")
    if isinstance(ds_off, dict) and "device" in ds_off:
        offload = ds_off["device"] not in (None, "none")
    else:
        offload = base.offload_opt_state
    return dataclasses.replace(
        base,
        learning_rate=num(opt, "lr", base.learning_rate),
        betas=tuple(betas),
        eps=num(opt, "eps", base.eps),
        weight_decay=num(opt, "weight_decay", base.weight_decay),
        warmup_steps=warmup,
        grad_clip=grad_clip,
        precision=precision,
        offload_opt_state=offload,
    )


# ---------------------------------------------------------------------------
# The Megatron layout over 'model' (JAX parallel/strategies.py)
# ---------------------------------------------------------------------------

# JAX's _TP_RULES: leaf path -> the axes that shard over 'model', on JAX's
# leaves, whose block leaves carry a leading layer axis. Column-parallel
# q/k/v and MLP up (output features), row-parallel attention out and MLP
# down (input features), the vocabulary of the embedding and the head, and
# inside each expert column-parallel w1 and row-parallel w2.
_TP_RULES = {
    "wte": (0,),
    "lm_head": (0,),
    "blocks/wqkv": (3,),
    "blocks/bqkv": (2,),
    "blocks/wq": (2,),
    "blocks/bq": (1,),
    "blocks/wkv": (3,),
    "blocks/bkv": (2,),
    "blocks/wo": (1,),
    "blocks/wfc": (2,),
    "blocks/bfc": (1,),
    "blocks/wgu": (3,),
    "blocks/bgu": (2,),
    "blocks/wproj": (1,),
    "blocks/moe_w1": (3,),
    "blocks/moe_b1": (2,),
    "blocks/moe_w2": (2,),
}
_KV_LEAVES = ("blocks/wkv", "blocks/bkv")

# JAX's _EP_RULES: the experts axis of each expert leaf, which shards over
# 'expert'; the router stays replicated.
_EP_RULES = {
    "blocks/moe_w1": 1,
    "blocks/moe_b1": 1,
    "blocks/moe_w2": 1,
    "blocks/moe_b2": 1,
}

# JAX's composed-mesh hygiene (a >1 'model' axis beside a >1 'data' axis):
# leaves below this many elements per layer stay replicated over 'data'.
_COMPOSED_MIN_SHARD_ELEMENTS = 4096

# JAX's scan-carry rule: under the scan layer loop on a composed mesh these
# stacked column-parallel leaves stay model-only (replicated over 'data').
_COMPOSED_CONTRACTION_DATA_SKIP = frozenset({"blocks/wq"})


def kv_aligned(kv_heads: int, tp: int) -> bool:
    """JAX's kv-head-aligned rule: ``wkv`` / ``bkv`` shard over ``model``
    only when its width divides ``kv_heads``; else they stay replicated
    (each rank then uses its own query heads' slice of k and v)."""
    return kv_heads % tp == 0


def jax_leaf_name(port_name: str) -> str:
    """``blocks.3.wqkv`` -> ``blocks/wqkv``, ``blocks.3.experts.moe_w1`` ->
    ``blocks/moe_w1``; top-level names stay."""
    parts = port_name.split(".")
    return f"blocks/{parts[-1]}" if parts[0] == "blocks" else port_name


def expert_axis(port_name: str, ep: int) -> Optional[int]:
    """The axis of a port parameter (one layer's leaf) that shards over
    ``expert`` at width ``ep`` (the experts axis, 0), or None."""
    return 0 if ep > 1 and jax_leaf_name(port_name) in _EP_RULES else None


def tp_axis(port_name: str, kv_heads: int, tp: int, pp: int = 1) -> Optional[int]:
    """The axis of a port parameter (one layer's leaf, no layer axis) that
    shards over ``model`` at width ``tp``, or None (replicated). Beside a
    ``pipe`` axis of width ``pp`` > 1 ``wte`` and ``lm_head`` stay
    replicated over ``model``, as JAX's ``param_partition_specs`` keeps them."""
    if tp == 1:
        return None
    name = jax_leaf_name(port_name)
    if name not in _TP_RULES or (name in _KV_LEAVES and not kv_aligned(kv_heads, tp)):
        return None
    if pp > 1 and name in ("wte", "lm_head"):
        return None
    ax = _TP_RULES[name][0]
    return ax - 1 if name.startswith("blocks/") else ax


def check_tp(config, tp: int) -> None:
    """Refuse a ``model`` width that does not split the heads, the MLP and
    the vocabulary. GSPMD pads such a split; the port refuses it."""
    bad = [f"{what}={n}" for what, n in (("n_head", config.n_head), ("mlp_dim", config.mlp_dim),
                                          ("vocab_size", config.vocab_size)) if n % tp]
    if bad:
        raise ValueError(f"tensor parallelism of width {tp} must divide n_head, the MLP width "
                         f"and the vocabulary; not a multiple of {tp}: {', '.join(bad)}")


def _shard_largest_free_axis(spec: list, shape: Tuple[int, ...], n_shards: int,
                             is_block_leaf: bool, composed: bool = False) -> None:
    """JAX's FSDP rule: 'data' on the largest unsharded divisible axis,
    tensor axes before the layer axis of a stacked block leaf; on a composed
    (data x model) mesh only before the leaf's 'model' axis, and never on a
    leaf of fewer than ``_COMPOSED_MIN_SHARD_ELEMENTS`` per layer that
    'model' does not shard."""
    if composed:
        per_layer = shape[1:] if is_block_leaf and len(shape) > 1 else shape
        if "model" not in spec and math.prod(per_layer) < _COMPOSED_MIN_SHARD_ELEMENTS:
            return
    axes = list(range(len(shape)))
    candidates = axes[1:] + axes[:1] if is_block_leaf and len(shape) > 1 else axes
    if composed and "model" in spec:
        candidates = [ax for ax in candidates if ax < spec.index("model")]
    best = None
    for ax in candidates:
        if spec[ax] is None and shape[ax] % n_shards == 0 and shape[ax] >= n_shards:
            if best is None or shape[ax] > shape[best]:
                best = ax
    if best is not None:
        spec[best] = "data"


def param_partition_specs(shapes: Dict[str, Tuple[int, ...]], mesh_shape: Dict[str, int],
                          shard: bool, kv_heads: Optional[int] = None,
                          scan_stacked: bool = False) -> Dict[str, tuple]:
    """JAX's ``param_partition_specs`` over JAX-shaped leaves: {leaf path:
    shape, block leaves stacked on a layer axis} -> {leaf path: spec}, a
    spec being a tuple of axis names or None per dimension. Under a ``pipe``
    axis the layer axis of the block leaves shards over ``pipe`` (contiguous
    stages) and ``wte`` / ``lm_head`` stay replicated over ``model``, as in
    JAX. ``scan_stacked`` (the scan layer loop): on a composed (data x
    model) mesh the ``_COMPOSED_CONTRACTION_DATA_SKIP`` leaves stay
    model-only."""
    n_data, n_model = mesh_shape.get("data", 1), mesh_shape.get("model", 1)
    n_pipe, n_expert = mesh_shape.get("pipe", 1), mesh_shape.get("expert", 1)
    kv_misaligned = kv_heads is not None and kv_heads % n_model != 0
    specs = {}
    for name, shape in shapes.items():
        spec = [None] * len(shape)
        if n_pipe > 1 and name.startswith("blocks/"):
            spec[0] = "pipe"
        if n_expert > 1 and name in _EP_RULES and shape[_EP_RULES[name]] % n_expert == 0:
            spec[_EP_RULES[name]] = "expert"
        if n_model > 1:
            for ax in _TP_RULES.get(name, ()):
                if name in _KV_LEAVES and kv_misaligned:
                    continue
                if name in ("wte", "lm_head") and n_pipe > 1:
                    continue
                if spec[ax] is None and shape[ax] % n_model == 0:
                    spec[ax] = "model"
        skip = scan_stacked and n_model > 1 and name in _COMPOSED_CONTRACTION_DATA_SKIP
        if shard and n_data > 1 and not skip:
            _shard_largest_free_axis(spec, shape, n_data, name.startswith("blocks/"),
                                     composed=n_model > 1)
        specs[name] = tuple(spec)
    return specs


def fsdp_data_axis(port_name: str, shape: Tuple[int, ...], mesh_shape: Dict[str, int],
                   kv_heads: int, n_layer: int, scan_stacked: bool = False) -> Optional[int]:
    """The axis of a port parameter (``shape``: this rank's ``model`` /
    ``expert`` part of one layer's leaf) that JAX's ``param_partition_specs``
    shards over ``data`` at ``mesh_shape``, or None where JAX leaves the
    leaf replicated over ``data``. The rule sees the JAX leaf: global widths,
    block leaves stacked on a layer axis. Where JAX picks that layer axis
    (no tensor axis divides, or on a composed mesh none comes before the
    leaf's ``model`` axis), the unrolled port, which holds each layer as a
    leaf of its own, keeps the leaf replicated too. ``scan_stacked`` (the
    scan loop, whose port holds the block leaves stacked): the rule's
    ``scan_stacked`` form, and a block leaf's axis counts the layer axis (0
    is the layer axis)."""
    name = jax_leaf_name(port_name)
    tp, ep = mesh_shape.get("model", 1), mesh_shape.get("expert", 1)
    glob = list(shape)
    for ax, n in ((tp_axis(port_name, kv_heads, tp, mesh_shape.get("pipe", 1)), tp),
                  (expert_axis(port_name, ep), ep)):
        if ax is not None:
            glob[ax] *= n
    block = name.startswith("blocks/")
    jax_shape = (n_layer, *glob) if block else tuple(glob)
    spec = param_partition_specs({name: jax_shape}, mesh_shape, True, kv_heads,
                                 scan_stacked)[name]
    if "data" not in spec:
        return None
    ax = spec.index("data")
    if scan_stacked or not block:
        return ax
    return ax - 1 if ax > 0 else None


def linear_schedule(init_value: float, end_value: float, transition_steps: int):
    """optax.linear_schedule: count -> lr, clamped to [0, transition_steps]."""

    def schedule(count: int) -> float:
        c = min(max(count, 0), transition_steps)
        return (init_value - end_value) * (1.0 - c / transition_steps) + end_value

    return schedule


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (a view), or the tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def _all_reduce_flat(tensors: List[torch.Tensor], group: dist.ProcessGroup) -> None:
    """Sum ``tensors`` over ``group`` in place, one all-reduce per dtype."""
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        part = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in part])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in part:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def _zero_grads(params: Iterable[torch.Tensor], set_to_none: bool) -> None:
    for p in params:
        if p.grad is None:
            continue
        if set_to_none:
            p.grad = None
        else:
            p.grad.zero_()


def _total_norm(grads: List[torch.Tensor], f32: bool) -> torch.Tensor:
    """The 2-norm of ``grads`` together. fp32 gradients: squares summed in
    fp64 (an fp64 norm), so the clip's fp32 norm does not depend on how the
    gradient is cut into shards or buckets; ``f32``: accumulated in fp32
    over the fp32 values of bf16 gradients (optax's norm of their upcast)."""
    if all(g.dtype == torch.float32 for g in grads):
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads, 2,
                                                                         dtype=torch.float64)))
    if not f32:
        return torch.nn.utils.get_total_norm(grads, norm_type=2.0)
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]))


#: The largest norm whose square fits fp32: past it JAX's fp32 sum of squares
#: (``global_norm_f32``) is inf, and so are the sentinel's values here.
F32_NORM_LIMIT = math.sqrt(torch.finfo(torch.float32).max)


def _f32_sum_semantics(norm: torch.Tensor) -> torch.Tensor:
    """``norm`` as an fp32 sum of squares gives it: inf once the squares
    overflow fp32 (an fp64 sum, or the CPU's double accumulation, keeps a
    flipped exponent finite; the sentinel must see it as JAX does)."""
    return torch.where(norm > F32_NORM_LIMIT, torch.full_like(norm, math.inf), norm)


class Optimizer:
    """Global-norm clip (optional) + AdamW under the arm's lr schedule, over
    ``.grad`` of the given parameters. ``count`` is optax's update count.

    ``norm_group``: the group whose ranks hold the other shards of every
    gradient (None: each rank holds whole gradients). ``shard_groups`` and
    ``shard_keys`` (one tuple of flags per parameter, one flag per group):
    the ranks of each flagged group hold the other parts of the parameter,
    and it is replicated over the others: ``model`` under tensor
    parallelism (its sharded leaves), ``expert`` under expert parallelism
    (the expert leaves), ``pipe`` under pipeline parallelism (the stage's
    own blocks, not the leaves every stage holds) (``shard_axes``).
    ``pipe_group`` and ``pipe_shared``
    (one flag per parameter): under a pipeline, the flagged parameters are
    held by every stage, and ``finish_grads`` sums their gradients over
    ``pipe_group`` after the arm's reduction. ``data_replicated`` (one flag
    per parameter): the flagged gradients are whole on every rank of
    ``norm_group`` (leaves an FSDP2 arm keeps out of its shards), so the
    norm counts them once.

    Under ``offload_opt_state`` there is no device AdamW: ``host``
    (``parallel/offload.HostOffload``) holds the fp32 masters and moments of
    the same local tensors and runs the update; ``step`` hands it the
    gradients and the clip's scale. Its delayed form starts the host's
    worker in ``zero_grad``, at the start of a step, and joins it in
    ``step``.

    ``track_grad_norm`` (the numerics sentinel): each ``step`` leaves the
    fp32 global norm of the gradients it was given, before the clip, in
    ``grad_norm`` (a 0-d device tensor; reading it is the caller's sync).
    Where the gradients are fp32 it is the clip's own norm; bf16 gradients,
    or no clip, take one fp32 pass of their own. ``param_norm`` is the fp32
    global norm of the parameters over the same groups (the sentinel's
    checksum). Both are inf where JAX's fp32 sum of squares overflows."""

    def __init__(self, strategy: StrategyConfig, params: Iterable[torch.nn.Parameter],
                 norm_group: Optional[dist.ProcessGroup] = None,
                 shard_groups: Tuple[dist.ProcessGroup, ...] = (),
                 shard_keys: Optional[List[Tuple[bool, ...]]] = None,
                 pipe_group: Optional[dist.ProcessGroup] = None,
                 pipe_shared: Optional[List[bool]] = None,
                 data_replicated: Optional[List[bool]] = None):
        self.strategy = strategy
        self.params = [p for p in params]
        self.norm_group = norm_group
        self.shard_groups = tuple(shard_groups)
        self.shard_keys = shard_keys or [(False,) * len(self.shard_groups)] * len(self.params)
        self.pipe_group = pipe_group
        self.pipe_shared = pipe_shared or [False] * len(self.params)
        self.data_replicated = data_replicated or [False] * len(self.params)
        if strategy.warmup_steps > 0:
            self.schedule = linear_schedule(0.0, strategy.learning_rate, strategy.warmup_steps)
        else:
            self.schedule = lambda count: strategy.learning_rate
        self.adamw: Optional[torch.optim.AdamW] = None
        self.host: Optional[HostOffload] = None
        if strategy.offload_opt_state:
            self.host = HostOffload(strategy, [_local(p) for p in self.params], self.schedule)
        else:
            # DTensors and plain tensors in groups of their own: the foreach
            # update refuses a list that mixes them (FSDP2's shards beside
            # the leaves it leaves whole, or the scan loop's stacked leaves).
            kinds = [[p for p in self.params if isinstance(p, DTensor) == d] for d in (True, False)]
            self.adamw = torch.optim.AdamW(
                [{"params": ps} for ps in kinds if ps], lr=strategy.learning_rate,
                betas=strategy.betas, eps=strategy.eps, weight_decay=strategy.weight_decay,
            )
        self.count = 0
        self.track_grad_norm = False
        self.grad_norm: Optional[torch.Tensor] = None

    def zero_grad(self) -> None:
        _zero_grads(self.params, set_to_none=True)
        if self.host is not None:
            self.host.begin_step()

    def sync_context(self, last: bool) -> ContextManager:
        """Wrap one micro-batch's forward and backward; ``last`` is the last
        micro-batch of the step. A pipeline schedule wraps the whole step in
        ``sync_context(last=False)``."""
        return contextlib.nullcontext()

    def last_backward(self, buckets: Iterable[str]) -> None:
        """Under a pipeline schedule: the next backward unit is the step's
        last one for the blocks ``buckets`` (``zero2_bucket`` names). Only
        zero2 acts on it."""

    def _grads(self) -> List[torch.Tensor]:
        return [_local(p.grad) for p in self.params if p.grad is not None]

    @torch.no_grad()
    def finish_grads(self, grad_accum: int) -> None:
        """After the last micro-batch: the summed grads become their mean;
        under a pipeline the replicated leaves' gradients are summed over
        ``pipe`` (a stage that never used a leaf adds zeros)."""
        if grad_accum > 1:
            torch._foreach_div_(self._grads(), float(grad_accum))
        if self.pipe_group is None:
            return
        for p, shared in zip(self.params, self.pipe_shared):
            if shared and p.grad is None:
                p.grad = torch.zeros_like(p)
        _all_reduce_flat([_local(p.grad) for p, shared in zip(self.params, self.pipe_shared)
                          if shared], self.pipe_group)

    def _global_norm(self, grads: List[torch.Tensor], f32: bool = False) -> torch.Tensor:
        norm = _total_norm(grads, f32)
        if self.norm_group is None:
            return norm
        sq = norm * norm
        dist.all_reduce(sq, group=self.norm_group)
        return sq.sqrt()

    def _global_norm_sharded(self, f32: bool = False,
                             tensors: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """The norm over every element once: each parameter's squares
        summed over the groups its key flags, then (shards of one gradient)
        over ``norm_group``; the ``data_replicated`` leaves' squares join
        after that sum. ``tensors``: one per parameter, laid out as it
        (default: the grads)."""
        parts: Dict[Tuple[Tuple[bool, ...], bool], List[torch.Tensor]] = {}
        if tensors is None:
            tensors = [p.grad for p in self.params]
        for t, key, whole in zip(tensors, self.shard_keys, self.data_replicated):
            if t is not None:
                parts.setdefault((key, whole), []).append(_local(t))
        norms = {slot: _total_norm(grads, f32) for slot, grads in parts.items()}
        zero = torch.zeros_like(next(iter(norms.values())))
        totals = {}
        for whole in (False, True):
            if whole and not any(self.data_replicated):
                totals[whole] = zero
                continue
            # The groups still to sum over -> the squares summed so far. The
            # keys are the parameters', alike on every rank, so every rank
            # issues the same all-reduces: one per group, of the sums whose
            # remaining groups differ.
            pending: Dict[frozenset, torch.Tensor] = {}
            for key in sorted(set(self.shard_keys)):
                rest = frozenset(i for i, flag in enumerate(key) if flag)
                sq = norms[key, whole] ** 2 if (key, whole) in norms else zero
                pending[rest] = pending[rest] + sq if rest in pending else sq
            for i, group in enumerate(self.shard_groups):
                merged: Dict[frozenset, torch.Tensor] = {}
                for rest in [r for r in pending if i in r]:
                    sq = pending.pop(rest)
                    merged[rest - {i}] = merged[rest - {i}] + sq if rest - {i} in merged else sq
                summed = torch.stack(list(merged.values()) or [zero])
                dist.all_reduce(summed, group=group)
                for rest, sq in zip(merged, summed):
                    pending[rest] = pending[rest] + sq if rest in pending else sq
            totals[whole] = pending.get(frozenset(), zero)
        total = totals[False]
        if self.norm_group is not None:
            dist.all_reduce(total, group=self.norm_group)
        return (total + totals[True]).sqrt()

    def _clip_norm(self, f32: bool = False,
                   tensors: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """The clip's global norm: fp32 (an fp64 sum of fp32 gradients'
        squares rounded once), or the bf16 gradients' own dtype.
        ``tensors`` as for ``_global_norm_sharded``."""
        if not self.shard_groups and not any(self.data_replicated):
            local = (self._grads() if tensors is None
                     else [_local(t) for t in tensors if t is not None])
            norm = self._global_norm(local, f32)
        else:
            norm = self._global_norm_sharded(f32, tensors)
        return norm.float() if norm.dtype == torch.float64 else norm

    @torch.no_grad()
    def param_norm(self) -> torch.Tensor:
        """The fp32 global L2 norm of the parameters, every element counted
        once (collective over the norm groups): JAX's ``make_param_norm_fn``."""
        return _f32_sum_semantics(
            self._clip_norm(f32=True, tensors=[p.detach() for p in self.params]))

    def _note_grad_norm(self, g_norm: Optional[torch.Tensor]) -> None:
        """Keep the pre-clip fp32 norm for the sentinel: ``g_norm`` when it
        is fp32 already (the clip's), else one fp32 pass."""
        if self.track_grad_norm:
            self.grad_norm = _f32_sum_semantics(
                g_norm if g_norm is not None and g_norm.dtype == torch.float32
                else self._clip_norm(f32=True))

    @torch.no_grad()
    def clip(self) -> None:
        """optax clip_by_global_norm, in place on ``.grad``."""
        c = self.strategy.grad_clip
        if c is None:
            self._note_grad_norm(None)
            return
        grads = self._grads()
        g_norm = self._clip_norm()
        self._note_grad_norm(g_norm)
        trigger = g_norm < c
        one = torch.ones((), dtype=g_norm.dtype, device=g_norm.device)
        # (g / g_norm) * c when clipping, g / 1 * 1 otherwise: no host sync.
        torch._foreach_div_(grads, torch.where(trigger, one, g_norm))
        torch._foreach_mul_(grads, torch.where(trigger, one, one * c))

    @torch.no_grad()
    def clip_scale(self) -> Optional[torch.Tensor]:
        """The offload arm's clip (JAX ``offload_update_and_apply``): the
        fp32 scale ``c / max(g_norm, c)`` of the fp32 global norm, a 0-d
        tensor on the device, or None without a clip. The gradients stay as
        they are; the host folds the scale into their upcast."""
        c = self.strategy.grad_clip
        if c is None:
            self._note_grad_norm(None)
            return None
        g_norm = self._clip_norm(f32=True)
        self._note_grad_norm(g_norm)
        return torch.div(torch.full_like(g_norm, c), torch.clamp(g_norm, min=c))

    def step(self) -> None:
        if self.host is not None:
            self.host.step([_local(p.grad) for p in self.params], self.clip_scale())
        else:
            self.clip()
            for group in self.adamw.param_groups:
                group["lr"] = self.schedule(self.count)
            self.adamw.step()
        self.count += 1


class _DDPOptimizer(Optimizer):
    """ddp: DDP all-reduces the grads in the last micro-batch's backward only.
    The grads are views into DDP's buckets (``gradient_as_bucket_view``) and
    stay so: they are zeroed in place, where grads set to None would be
    allocated anew by the micro-batches before the all-reduce, beside the
    buckets. Under expert parallelism DDP ignores the expert leaves
    (``experts``: their parameters), whose grads ``finish_grads`` sums over
    each group of ``expert_reduce`` (``data``, and ``seq`` when it rides
    the group: the ranks that hold the same experts) and divides by
    ``ranks``. Under a
    pipeline (``explicit``) every backward runs under ``no_sync`` and
    ``finish_grads`` averages the gradients over DDP's group itself."""

    def __init__(self, strategy: StrategyConfig, ddp: DistributedDataParallel,
                 experts: List[torch.nn.Parameter] = (),
                 expert_reduce: Tuple[dist.ProcessGroup, ...] = (), ranks: int = 1,
                 explicit: bool = False, **shards):
        super().__init__(strategy, ddp.module.parameters(), **shards)
        self.ddp = ddp
        self.experts, self.expert_reduce, self.ranks = list(experts), expert_reduce, ranks
        self.explicit = explicit

    def zero_grad(self) -> None:
        _zero_grads(self.params, set_to_none=False)
        if self.host is not None:
            self.host.begin_step()

    def sync_context(self, last: bool) -> ContextManager:
        return contextlib.nullcontext() if last and not self.explicit else self.ddp.no_sync()

    @torch.no_grad()
    def finish_grads(self, grad_accum: int) -> None:
        for p in self.experts:
            for group in self.expert_reduce:
                dist.all_reduce(p.grad, group=group)
            p.grad.div_(self.ranks)
        if self.explicit:
            experts = {id(p) for p in self.experts}
            grads = [_local(p.grad) for p in self.params
                     if p.grad is not None and id(p) not in experts]
            _all_reduce_flat(grads, self.ddp.process_group)
            torch._foreach_div_(grads, float(dist.get_world_size(self.ddp.process_group)))
        super().finish_grads(grad_accum)


class _FSDPOptimizer(Optimizer):
    """fsdp / zero3: FSDP2 averages each gradient over its mesh; the experts'
    mesh is ``data`` only, so their gradients are divided by the ``expert``
    width ``ep`` as well (dp * ep in all, times ``seq`` when it rides the
    group). ``kept_out`` maps each tuple of groups to the leaves FSDP2
    ignores (``fsdp_data_axis`` None), whose gradients ``finish_grads``
    averages over those groups by hand. ``scan_shared``: under the scan
    loop, the stacked leaves ``_FSDPScanArm`` shards, whose gradients its
    backward has summed over the arm's ranks; ``finish_grads`` divides them
    by the count of those ranks."""

    def __init__(self, strategy: StrategyConfig, model: torch.nn.Module,
                 experts: List[torch.nn.Parameter], ep: int,
                 kept_out: Dict[Tuple[dist.ProcessGroup, ...], List[torch.nn.Parameter]],
                 scan_shared: Tuple[List[torch.nn.Parameter], int] = ([], 1), **kw):
        super().__init__(strategy, model.parameters(), **kw)
        self.experts, self.ep, self.kept_out = experts, ep, kept_out
        self.scan_shared = scan_shared

    @torch.no_grad()
    def finish_grads(self, grad_accum: int) -> None:
        for groups, params in self.kept_out.items():
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in params]
            for group in groups:
                _all_reduce_flat(grads, group)
            torch._foreach_div_(grads, float(math.prod(dist.get_world_size(g) for g in groups)))
        params, ranks = self.scan_shared
        if params:
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            torch._foreach_div_([p.grad for p in params], float(ranks))
        if self.experts:
            torch._foreach_div_([_local(p.grad) for p in self.experts], float(self.ep))
        super().finish_grads(grad_accum)


def zero2_bucket(port_name: str) -> str:
    """The block whose zero2 bucket holds a parameter (``blocks.<i>``), or
    "" for the leaves outside the blocks."""
    parts = port_name.split(".")
    return ".".join(parts[:2]) if parts[0] == "blocks" else ""


@dataclasses.dataclass(eq=False)
class _Bucket:
    """One zero2 bucket: its block (``zero2_bucket``), the flat params (the
    parameters, ``params``, are views into it, laid end to end in order;
    None under the scan loop, where ``params`` are a layer's slices of the
    stacked leaves), the flat grads, this rank's shard of the grads, the
    groups its shard is all-reduced over after the reduce-scatter, the
    leaves' port names, and the reduce-scatter's arming (the backward that
    lands the step's last gradients), count-down and work."""

    key: str
    flat: Optional[torch.Tensor]
    grads: torch.Tensor
    shard_grad: torch.Tensor
    params: List[torch.Tensor]
    replicas: Tuple[dist.ProcessGroup, ...]
    names: List[str]
    armed: bool = False
    pending: int = 0
    work: Any = None


class _Zero2Optimizer(Optimizer):
    """zero2 by hand (see the module docstring). AdamW steps over this rank's
    shard of each bucket's flat buffer, a view into it, so its update lands
    in the replicated params in place; the all-gathers fill in the other
    shards.

    Under the scan loop (``ScanBlocks``) a stacked leaf cannot also be views
    into per-layer buckets, so a layer's buckets hold its slices' grads and
    this rank's shard of its params as tensors of their own: the layer's
    gradients are copied into its buckets where they are ready, inside the
    backward (``_Zero2ScanArm``), and after the update the all-gathered
    shards are copied back into the stacked leaves. The leaves outside the
    blocks keep the unrolled buckets."""

    def __init__(self, strategy: StrategyConfig, model: torch.nn.Module, mesh: Mesh):
        self.group = mesh.data_group
        dp, rank = dist.get_world_size(self.group), dist.get_rank(self.group)
        self.dp, self.rank = dp, rank
        seq, expert = mesh.seq_group, mesh.expert_group
        self.ranks = dp * math.prod(dist.get_world_size(g) for g in (seq, expert)
                                    if g is not None)
        scan = getattr(model, "scan", False)
        named = list(model.layer_parameters()) if scan else list(model.named_parameters())
        groups, keys = shard_axes(model, mesh, [name for name, _ in named])
        expert_at = groups.index(expert) if expert is not None else None
        # One bucket per (block, dtype, kind): the groups that hold its
        # leaves' other parts (the clip sums their squares over them).
        by_key: Dict[tuple, List[Tuple[str, torch.Tensor]]] = {}
        for (name, p), sharded in zip(named, keys):
            by_key.setdefault((zero2_bucket(name), p.dtype, sharded), []).append((name, p))
        self.buckets: List[_Bucket] = []
        shards = []
        with torch.no_grad():
            for (key, dtype, sharded), items in by_key.items():
                params = [p for _, p in items]
                n = sum(p.numel() for p in params)
                size = -(-n // dp)  # one rank's shard; the padding is zero
                device = params[0].device
                grads = torch.zeros(size * dp, dtype=dtype, device=device)
                if scan and key != "":
                    flat = None
                    whole = torch.cat([p.reshape(-1) for p in params]
                                      + [grads.new_zeros(size * dp - n)])
                    shard = torch.nn.Parameter(whole[rank * size:(rank + 1) * size].clone())
                else:
                    flat = torch.zeros(size * dp, dtype=dtype, device=device)
                    offset = 0
                    for p in params:
                        k = p.numel()
                        flat[offset:offset + k].copy_(p.reshape(-1))
                        p.data = flat[offset:offset + k].view_as(p)
                        p.grad = grads[offset:offset + k].view_as(p)
                        offset += k
                    shard = torch.nn.Parameter(flat[rank * size:(rank + 1) * size])
                shard.grad = torch.zeros(size, dtype=dtype, device=device)
                shards.append(shard)
                is_expert = expert_at is not None and sharded[expert_at]
                replicas = tuple(g for g in (seq, None if is_expert else expert) if g is not None)
                bucket = _Bucket(key, flat, grads, shard.grad, params, replicas,
                                 [name for name, _ in items])
                if flat is not None:
                    for p in params:
                        p.register_post_accumulate_grad_hook(
                            functools.partial(self._ready, bucket))
                self.buckets.append(bucket)
        pipe = {}
        if mesh.pipe_group is not None:
            pipe = dict(pipe_group=mesh.pipe_group, pipe_shared=[key == "" for key, _, _ in by_key])
        super().__init__(strategy, shards, norm_group=self.group, shard_groups=groups,
                         shard_keys=[sharded for _, _, sharded in by_key], **pipe)
        if scan:
            model.blocks.arm = _Zero2ScanArm(self, model.blocks)

    @torch.no_grad()
    def reload_shards(self) -> None:
        """Under the scan loop, copy this rank's shard of each layer's
        params from the stacked leaves again (after a checkpoint load or a
        fault injection wrote them); the unrolled shards are views of them
        already."""
        for b, shard in zip(self.buckets, self.params):
            if b.flat is None:
                whole = torch.cat([p.reshape(-1) for p in b.params]
                                  + [b.grads.new_zeros(b.grads.numel() - sum(
                                      p.numel() for p in b.params))])
                shard.copy_(whole[self.rank * shard.numel():(self.rank + 1) * shard.numel()])

    def feed(self, b: _Bucket, grads: List[Optional[torch.Tensor]]) -> None:
        """Under the scan loop: a layer's gradients for the bucket ``b``
        (one per leaf, None where a leaf has none) are ready in the
        backward: add them into its flat grads, and in the bucket's last
        backward start its reduce-scatter."""
        offset = 0
        for p, g in zip(b.params, grads):
            k = p.numel()
            if g is not None:
                b.grads[offset:offset + k].add_(g.reshape(-1))
            offset += k
        if b.armed:
            self._launch(b)

    def zero_grad(self) -> None:
        # The params' grads are views into the flat buffers: keep them.
        for b in self.buckets:
            b.grads.zero_()
        if self.host is not None:
            self.host.begin_step()

    def sync_context(self, last: bool) -> ContextManager:
        for b in self.buckets:
            b.armed, b.pending, b.work = last, len(b.params), None
        return contextlib.nullcontext()

    def last_backward(self, buckets: Iterable[str]) -> None:
        keys = set(buckets)
        for b in self.buckets:
            if b.key in keys:
                b.armed, b.pending = True, len(b.params)

    def _launch(self, b: _Bucket) -> None:
        b.work = dist.reduce_scatter_tensor(b.shard_grad, b.grads, group=self.group,
                                            async_op=True)

    def _ready(self, b: _Bucket, _param: torch.Tensor) -> None:
        """A parameter's gradient has landed; in the bucket's last backward,
        its reduce-scatter starts with its last one."""
        if not b.armed:
            return
        b.pending -= 1
        if b.pending == 0:
            self._launch(b)

    @torch.no_grad()
    def finish_grads(self, grad_accum: int) -> None:
        # The reduce-scatters sum each bucket over data; then the sum over
        # seq (and, for the non-expert leaves, expert) when those ride the
        # group, and one division by every rank that contributed.
        for b in self.buckets:
            if b.work is None:  # a bucket none of whose params had a gradient
                self._launch(b)
        for b in self.buckets:
            b.work.wait()
            b.work = None
            for g in b.replicas:
                dist.all_reduce(b.shard_grad, group=g)
            b.shard_grad.div_(self.ranks)
            b.armed = False
        super().finish_grads(grad_accum)

    def step(self) -> None:
        super().step()
        with torch.no_grad():
            for b, shard in zip(self.buckets, self.params):
                if b.flat is not None:
                    dist.all_gather_into_tensor(b.flat, shard, group=self.group)
                    continue
                whole = torch.empty(shard.numel() * self.dp, dtype=shard.dtype,
                                    device=shard.device)
                dist.all_gather_into_tensor(whole, shard, group=self.group)
                offset = 0
                for p in b.params:
                    p.copy_(whole[offset:offset + p.numel()].view_as(p))
                    offset += p.numel()


class _Slices(torch.autograd.Function):
    """Every layer's slices of the stacked leaves, one node for all of them,
    whose backward gives the stacked leaves no gradient: zero2's buckets
    take the layers' gradients (``_Feed``)."""

    @staticmethod
    def forward(ctx, n_layers: int, *stacked: torch.Tensor):
        ctx.set_materialize_grads(False)
        ctx.n = len(stacked)
        return tuple(p[i] for p in stacked for i in range(n_layers))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) * (1 + ctx.n)


class _Feed(torch.autograd.Function):
    """The identity on one layer's slices; its backward, where the layer's
    gradients are all ready, hands them to the layer's zero2 buckets."""

    @staticmethod
    def forward(ctx, arm: "_Zero2ScanArm", i: int, *slices: torch.Tensor):
        ctx.set_materialize_grads(False)
        ctx.arm, ctx.i = arm, i
        return tuple(t.view_as(t) for t in slices)

    @staticmethod
    def backward(ctx, *grads):
        ctx.arm.feed(ctx.i, grads)
        return (None, None) + (None,) * len(grads)


class _Zero2ScanArm:
    """zero2's layer hooks on ``ScanBlocks`` (``_Zero2Optimizer``): the
    slices come from one ``_Slices`` node, and each layer's run passes them
    through ``_Feed``, which copies the layer's gradients into its buckets
    in the backward."""

    def __init__(self, opt: _Zero2Optimizer, blocks) -> None:
        self.opt = opt
        self.leaf_names = list(blocks.leaf_names)
        # Layer i -> [(bucket, the index in leaf_names of each of its leaves)].
        self.layer_buckets: Dict[int, List[Tuple[_Bucket, List[int]]]] = {}
        for b in opt.buckets:
            if b.flat is None:
                i = int(b.key.split(".")[1])
                at = [self.leaf_names.index(name.split(".", 2)[2]) for name in b.names]
                self.layer_buckets.setdefault(i, []).append((b, at))

    def unstack(self, blocks) -> Dict[str, Sequence[torch.Tensor]]:
        n = len(blocks)
        flat = _Slices.apply(n, *[blocks.stacked(leaf) for leaf in self.leaf_names])
        return {leaf: flat[j * n:(j + 1) * n] for j, leaf in enumerate(self.leaf_names)}

    def run_layer(self, i: int, slices: Dict[str, torch.Tensor], remat: str, body):
        out = _Feed.apply(self, i, *[slices[leaf] for leaf in self.leaf_names])
        return body(dict(zip(self.leaf_names, out)))

    def feed(self, i: int, grads) -> None:
        for b, at in self.layer_buckets[i]:
            self.opt.feed(b, [grads[j] for j in at])

    def shard(self, leaf: str, part: torch.Tensor) -> torch.Tensor:
        return part

    def unshard(self, leaf: str, part: torch.Tensor) -> torch.Tensor:
        return part


class _LayerGather:
    """One layer's gathered leaves under ``_FSDPScanArm``: gathered in the
    forward (``_GatherLayer``), and again at most once in the backward
    where a saved tensor asks for them (``full``), released when the
    layer's backward is done."""

    def __init__(self, arm: "_FSDPScanArm", chunks: List[torch.Tensor]) -> None:
        self.arm, self.chunks, self.cache = arm, chunks, None

    def full(self) -> List[torch.Tensor]:
        if self.cache is None:
            with torch.no_grad():
                self.cache = self.arm.gather(self.chunks)
        return self.cache


class _GatherLayer(torch.autograd.Function):
    """All-gather one layer's shares of the ``data``-sharded stacked leaves
    (one collective for all of them); the backward reduce-scatters their
    gradients (summed over ``data``) back to the shares."""

    @staticmethod
    def forward(ctx, layer: _LayerGather, *chunks: torch.Tensor):
        ctx.layer = layer
        return tuple(layer.arm.gather(list(chunks)))

    @staticmethod
    def backward(ctx, *grads):
        ctx.layer.cache = None
        return (None,) + tuple(ctx.layer.arm.reduce_scatter(list(grads)))


class _Regather:
    """A saved tensor that lives in a gathered leaf: packed as where it sits
    (leaf, size, stride, offset) and rebuilt from the layer's gather."""

    def __init__(self, layer: _LayerGather, j: int, t: torch.Tensor) -> None:
        self.layer, self.j = layer, j
        self.geometry = (t.size(), t.stride(), t.storage_offset())

    def get(self) -> torch.Tensor:
        return self.layer.full()[self.j].as_strided(*self.geometry)


class _FSDPScanArm:
    """fsdp / zero3 under the scan loop: JAX's FSDP schedule over stacked
    leaves, by hand. A stacked leaf that JAX's ``param_partition_specs(...,
    scan_stacked=True)`` shards over ``data`` (``fsdp_data_axis``; on a
    tensor axis or, where none qualifies, the layer axis) is held as this
    rank's 1/dp share of each layer's elements (the layer's slice
    flattened, padded to a multiple of dp, rank r's r-th block): the bytes
    of JAX's placement, whichever axis it picks. Each layer's run gathers
    its shares of every such leaf in one all-gather over ``data``, frees
    them after the layer (the tensors its backward saves from them are
    packed as their place in the gather and rebuilt by one all-gather in
    the backward, or, under remat, the recompute gathers again), and its
    backward reduce-scatters their gradients; the stacked leaf's gradient
    is this rank's shares. A stacked leaf JAX keeps replicated over
    ``data`` stays whole (``replicated``). At ``data`` width 1 every leaf
    is "sharded" over the one rank (the gather is a copy), as FSDP2 runs
    at width 1. Under an ``expert`` axis the shares of the leaves every
    expert rank holds (all but ``experts.*``) are summed over ``expert`` as
    well, as FSDP2 replicates the unrolled blocks over it; the expert
    leaves' over ``data`` (and ``seq``) only, the ranks that hold the same
    experts."""

    def __init__(self, blocks, mesh: Mesh, kv_heads: int, n_layer: int) -> None:
        self.group, self.seq_group = mesh.data_group, mesh.seq_group
        self.expert_group = mesh.expert_group
        self.dp, self.rank = dist.get_world_size(self.group), dist.get_rank(self.group)
        self.leaf_names = list(blocks.leaf_names)
        self.sharded: List[str] = []
        self.layout: Dict[str, Tuple[Tuple[int, ...], int, int]] = {}  # shape, numel, share
        with torch.no_grad():
            for leaf in self.leaf_names:
                p = blocks.stacked(leaf)
                shape = tuple(p.shape[1:])
                if self.dp > 1 and fsdp_data_axis(f"blocks.0.{leaf}", shape, mesh.shape,
                                                  kv_heads, n_layer, scan_stacked=True) is None:
                    continue
                n = math.prod(shape)
                share = -(-n // self.dp)
                self.sharded.append(leaf)
                self.layout[leaf] = (shape, n, share)
                whole = p.new_zeros(p.shape[0], share * self.dp)
                whole[:, :n] = p.reshape(p.shape[0], n)
                local = torch.nn.Parameter(
                    whole[:, self.rank * share:(self.rank + 1) * share].clone(),
                    requires_grad=p.requires_grad)
                owner, name = ((blocks.experts, leaf.split(".", 1)[1])
                               if leaf.startswith("experts.") else (blocks, leaf))
                owner.register_parameter(name, local)
        self.replicated = [leaf for leaf in self.leaf_names if leaf not in self.layout]
        blocks.arm = self

    # -- the collectives -----------------------------------------------------

    def gather(self, chunks: List[torch.Tensor]) -> List[torch.Tensor]:
        """One layer's shares (one per sharded leaf) -> its whole slices,
        each in a storage of its own."""
        sizes = [c.numel() for c in chunks]
        flat = torch.cat([c.reshape(-1) for c in chunks])
        out = flat.new_empty(flat.numel() * self.dp)
        dist.all_gather_into_tensor(out, flat, group=self.group)
        rows = out.view(self.dp, -1)
        full, offset = [], 0
        for leaf, k in zip(self.sharded, sizes):
            shape, n, _ = self.layout[leaf]
            full.append(rows[:, offset:offset + k].clone().view(-1)[:n].view(shape))
            offset += k
        return full

    def reduce_scatter(self, grads: List[Optional[torch.Tensor]]) -> List[torch.Tensor]:
        """One layer's whole-slice gradients -> this rank's shares, summed
        over ``data`` (and over ``seq`` where it rides the group, as FSDP2's
        replicate dim sums each backward's)."""
        shares = [self.layout[leaf][2] for leaf in self.sharded]
        ref = next(g for g in grads if g is not None)
        buf = ref.new_zeros(self.dp, sum(shares))
        offset = 0
        for leaf, g, k in zip(self.sharded, grads, shares):
            n = self.layout[leaf][1]
            if g is not None:
                padded = g.new_zeros(k * self.dp)
                padded[:n] = g.reshape(-1)
                buf[:, offset:offset + k] = padded.view(self.dp, k)
            offset += k
        out = buf.new_empty(sum(shares))
        dist.reduce_scatter_tensor(out, buf.view(-1), group=self.group)
        if self.seq_group is not None:
            dist.all_reduce(out, group=self.seq_group)
        parts = list(torch.split(out, shares))
        if self.expert_group is not None:
            shared = [t for leaf, t in zip(self.sharded, parts) if not leaf.startswith("experts.")]
            _all_reduce_flat(shared, self.expert_group)
        return parts

    # -- ScanBlocks' hooks -----------------------------------------------------

    def unstack(self, blocks) -> Dict[str, Sequence[torch.Tensor]]:
        return {leaf: blocks.stacked(leaf).unbind(0) for leaf in self.leaf_names}

    def run_layer(self, i: int, slices: Dict[str, torch.Tensor], remat: str, body):
        chunks = [slices[leaf] for leaf in self.sharded]
        layer = _LayerGather(self, [c.detach() for c in chunks])
        full = _GatherLayer.apply(layer, *chunks)
        w = dict(slices)
        w.update(zip(self.sharded, full))
        if remat != "none":
            return body(w)  # inside a checkpoint, whose recompute gathers again
        where = {t.untyped_storage().data_ptr(): j for j, t in enumerate(full)}
        del full

        def pack(t: torch.Tensor):
            j = where.get(t.untyped_storage().data_ptr())
            return t if j is None else _Regather(layer, j, t)

        def unpack(obj):
            return obj.get() if isinstance(obj, _Regather) else obj

        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            return body(w)

    def shard(self, leaf: str, part: torch.Tensor) -> torch.Tensor:
        if leaf not in self.layout:
            return part
        _, n, share = self.layout[leaf]
        flat = part.new_zeros(share * self.dp)
        flat[:n] = part.reshape(-1)
        return flat[self.rank * share:(self.rank + 1) * share]

    def unshard(self, leaf: str, part: torch.Tensor) -> torch.Tensor:
        if leaf not in self.layout:
            return part
        shape, n, share = self.layout[leaf]
        out = part.new_empty(share * self.dp)
        dist.all_gather_into_tensor(out, part.contiguous(), group=self.group)
        return out[:n].view(shape)


def make_optimizer(strategy: StrategyConfig, params: Iterable[torch.nn.Parameter]) -> Optimizer:
    """The arm's optimizer over ``params`` (see the module docstring)."""
    return Optimizer(strategy, params)


def shard_axes(model: torch.nn.Module, mesh: Mesh, names: Optional[List[str]] = None
               ) -> Tuple[Tuple[dist.ProcessGroup, ...], List[Tuple[bool, ...]]]:
    """The groups whose ranks hold other parts of some leaves (``model``,
    ``expert``, ``pipe``, those that ride the group) and, per parameter of
    ``model`` (in ``parameters()`` order; or per name of ``names``), which
    of them hold its other parts: ``model`` the leaves it shards
    (``tp_axis``), ``expert`` the expert leaves, ``pipe`` a stage's own
    blocks (not the leaves every stage holds)."""
    tp, ep, kv = mesh.size(AXES.model), mesh.size(AXES.expert), model.config.kv_heads
    pp = mesh.size(AXES.pipe)
    if names is None:
        names = [name for name, _ in model.named_parameters()]
    axes = [(mesh.model_group, lambda n: tp_axis(n, kv, tp, pp) is not None),
            (mesh.expert_group, lambda n: expert_axis(n, ep) is not None),
            (mesh.pipe_group, lambda n: zero2_bucket(n) != "")]
    axes = [(g, f) for g, f in axes if g is not None]
    return tuple(g for g, _ in axes), [tuple(f(n) for _, f in axes) for n in names]


def _fully_shard(model: torch.nn.Module, strategy: StrategyConfig, mesh: Mesh,
                 experts: List[torch.nn.Module], shards: Dict[str, Any]):
    """fsdp / zero3: FSDP2 on each block (its experts on the ``data`` mesh
    first, under an ``expert`` axis) and then on the root, each leaf sharded
    on the axis JAX's ``param_partition_specs`` puts ``data`` on
    (``fsdp_data_axis``), so no leaf is padded to the ``data`` width. A leaf
    JAX leaves replicated over ``data`` (no axis the width divides; on a
    composed (data x model) mesh a vector-like leaf, or one whose only free
    axes follow its ``model`` axis) is kept out of the shards
    (``ignored_params``): it stays whole on every rank, its gradient is
    averaged over the ranks FSDP2 would have averaged it over (``data``
    for an expert leaf, else the arm's group), and the clip counts it once.
    Padding it instead would grow its bytes with the width. At ``data``
    width 1 every leaf is its own whole shard. Under the scan loop the
    stacked block leaves are ``_FSDPScanArm``'s (one layer gathered at a
    time) and FSDP2 shards the root's leaves only."""
    n_layer, kv = model.config.n_layer, model.config.kv_heads
    scan = getattr(model, "scan", False)
    hand, whole = [], []  # under the scan loop: the stacked leaves it shards, keeps whole
    whole_experts = []  # of ``whole``, the expert leaves under an ``expert`` axis
    if scan:
        arm = _FSDPScanArm(model.blocks, mesh, kv, n_layer)
        hand = [model.blocks.stacked(leaf) for leaf in arm.sharded]
        whole = [model.blocks.stacked(leaf) for leaf in arm.replicated]
        if experts:
            whole_experts = [p for leaf, p in zip(arm.replicated, whole)
                             if leaf.startswith("experts.")]
    stacked = {id(p) for p in hand + whole}
    named = [(name, p) for name, p in model.named_parameters() if id(p) not in stacked]
    if mesh.size(AXES.data) > 1:
        axis = {p: fsdp_data_axis(name, tuple(p.shape), mesh.shape, kv, n_layer)
                for name, p in named}
    else:
        axis = {p: 0 for _, p in named}
    ignored = {p for p, ax in axis.items() if ax is None}
    expert_ids = {id(p) for m in experts for p in m.parameters()}
    kept_out: Dict[Tuple[dist.ProcessGroup, ...], List[torch.nn.Parameter]] = {}
    for _, p in named:
        if p in ignored:
            groups = expert_reduce(mesh) if id(p) in expert_ids else (mesh.arm_group,)
            kept_out.setdefault(groups, []).append(p)
    for p in whole:
        groups = expert_reduce(mesh) if any(p is e for e in whole_experts) else (mesh.arm_group,)
        kept_out.setdefault(groups, []).append(p)
    ignored |= set(hand) | set(whole)
    hand_ids = {id(p) for p in hand}
    flags = [p in ignored and id(p) not in hand_ids for _, p in model.named_parameters()]

    def shard(module: torch.nn.Module, device_mesh) -> None:
        fully_shard(module, mesh=device_mesh, shard_placement_fn=lambda p: Shard(axis[p]),
                    ignored_params=ignored)

    shard_mesh = shard_data_mesh(mesh)
    if not scan:
        expert_mesh = expert_shard_mesh(mesh) if experts else None
        for block in model.blocks:
            if experts:
                shard(block.experts, expert_mesh)
            shard(block, shard_mesh)
    shard(model, shard_mesh)
    # fully_shard replaced the parameters: take the experts' afterwards.
    # Under the scan loop the arm's shares are divided with ``hand``, and
    # the expert leaves kept whole divided as FSDP2's experts are.
    expert_params = whole_experts if scan else [p for m in experts for p in m.parameters()]
    return model, _FSDPOptimizer(strategy, model, expert_params, mesh.size(AXES.expert), kept_out,
                                 (hand, dist.get_world_size(mesh.arm_group)),
                                 norm_group=mesh.data_group, data_replicated=flags, **shards)


def _expert_modules(model: torch.nn.Module) -> List[torch.nn.Module]:
    """The modules that hold the expert leaves: each block's ``experts``, or
    under the scan loop the stacked ones' (``ScanBlocks.experts``)."""
    if getattr(model, "scan", False):
        return [model.blocks.experts] if hasattr(model.blocks, "experts") else []
    return [block.experts for block in model.blocks if hasattr(block, "experts")]


def expert_reduce(mesh: Mesh) -> Tuple[dist.ProcessGroup, ...]:
    """The groups the expert leaves' gradients are summed over under an
    ``expert`` axis: ``data``, and ``seq`` when it rides the group (the
    ranks that hold the same experts; the all-to-all's backward has brought
    the other ``expert`` ranks' token gradients already)."""
    return tuple(g for g in (mesh.data_group, mesh.seq_group) if g is not None)


def apply_strategy(model: torch.nn.Module, strategy: StrategyConfig,
                   mesh: Optional[Mesh]) -> Tuple[torch.nn.Module, Optimizer]:
    """Lay the model out as the arm asks over ``mesh``'s ``data`` axis, and
    its ``seq`` and ``expert`` axes when they ride the group, and return
    (the model to call, its optimizer); under a ``model`` or ``pipe`` axis
    the model holds this rank's shards or stage already and the arm lays
    those out over the data x seq ranks of its ``model`` and ``pipe``
    indices. Without a process group (no
    ``mesh.device_mesh``) the model is returned as it is. Weights must be
    loaded before this call (``bridge.load_jax_params``)."""
    check_ported(strategy)
    if mesh is None or mesh.device_mesh is None:
        return model, make_optimizer(strategy, model.parameters())
    if (strategy.shard_grads and mesh.size(AXES.data) > 1 and dist.get_backend() == "gloo"
            and next(model.parameters()).device.type == "cuda"):
        raise ValueError(
            f"the {strategy.name} arm gathers and reduce-scatters over 'data', which gloo cannot "
            "carry for CUDA tensors (its TCP transport reads the device pointer as host memory); "
            "run it over NCCL, one card per rank, or on the CPU")
    groups, keys = shard_axes(model, mesh)
    shards = dict(shard_groups=groups, shard_keys=keys) if groups else {}
    if mesh.pipe_group is not None:
        shared = [zero2_bucket(name) == "" for name, _ in model.named_parameters()]
        shards.update(pipe_group=mesh.pipe_group, pipe_shared=shared)
    experts = _expert_modules(model) if mesh.expert_group is not None else []
    if strategy.shard_params:
        return _fully_shard(model, strategy, mesh, experts, shards)
    if strategy.shard_grads:
        return model, _Zero2Optimizer(strategy, model, mesh)
    device = next(model.parameters()).device
    expert_params = [p for m in experts for p in m.parameters()]
    if experts:
        DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(
            model, [name for name, _ in model.named_parameters() if ".experts." in name])
    ddp = DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        process_group=mesh.arm_group, broadcast_buffers=False, gradient_as_bucket_view=True,
    )
    return ddp, _DDPOptimizer(strategy, ddp, expert_params, expert_reduce(mesh),
                              dist.get_world_size(mesh.arm_group),
                              explicit=mesh.pipe_group is not None, **shards)
