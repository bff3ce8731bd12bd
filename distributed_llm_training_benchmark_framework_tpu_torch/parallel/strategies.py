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
dim is ``data`` (``mesh.replicate_seq_shard_data``: FSDP2 takes (replicate,
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

Under expert parallelism (an ``expert`` axis of width ep over the group,
a (data, expert) mesh; ``models/moe.py``) the batch rows shard over data x
expert and each rank holds its E/ep experts, JAX's ``_EP_RULES``. The
leaves outside the experts are replicated over ``expert`` and their
gradients averaged over the dp * ep ranks (``Mesh.batch_group``); the
expert leaves are summed over ``data`` only and divided by dp * ep: the
all-to-all's backward has already brought every member's token gradients
to the expert's owner, and each member's loss is a mean over its own rows.
ddp is DDP over the batch group with the expert leaves ignored by DDP and
all-reduced over ``data`` by hand; fsdp / zero3 wrap each block's experts
in FSDP2 over the ``data`` mesh (its average over dp, then a division by
ep) and the rest over the (expert, data) mesh, replicate over ``expert`` and shard
over ``data`` (HSDP; JAX's ``shard_params`` shards over ``data`` only);
zero2's buckets part the expert leaves from the rest: both reduce-scatter
over ``data``, the rest then all-reduce over ``expert``, and both divide by
dp * ep. The clip's norm sums the expert leaves' squares over ``expert``
as it sums tp's over ``model``.

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
from typing import Any, ContextManager, Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor import DTensor
from torch.nn.parallel import DistributedDataParallel

from .mesh import AXES, Mesh, shard_data_mesh
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
# inside each expert column-parallel w1 and row-parallel w2 (the memory
# model's spec rule reads them; MoE over a 'model' axis on the group is
# refused, models/tinygpt.py).
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


def tp_axis(port_name: str, kv_heads: int, tp: int) -> Optional[int]:
    """The axis of a port parameter (one layer's leaf, no layer axis) that
    shards over ``model`` at width ``tp``, or None (replicated)."""
    if tp == 1:
        return None
    name = jax_leaf_name(port_name)
    if name not in _TP_RULES or (name in _KV_LEAVES and not kv_aligned(kv_heads, tp)):
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
                          shard: bool, kv_heads: Optional[int] = None) -> Dict[str, tuple]:
    """JAX's ``param_partition_specs`` (the unrolled layer loop) over
    JAX-shaped leaves: {leaf path: shape, block leaves stacked on a layer
    axis} -> {leaf path: spec}, a spec being a tuple of axis names or None
    per dimension. Under a ``pipe`` axis the layer axis of the block leaves
    shards over ``pipe`` (contiguous stages) and ``wte`` / ``lm_head`` stay
    replicated over ``model``, as in JAX."""
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
        if shard and n_data > 1:
            _shard_largest_free_axis(spec, shape, n_data, name.startswith("blocks/"),
                                     composed=n_model > 1)
        specs[name] = tuple(spec)
    return specs


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


class Optimizer:
    """Global-norm clip (optional) + AdamW under the arm's lr schedule, over
    ``.grad`` of the given parameters. ``count`` is optax's update count.

    ``norm_group``: the group whose ranks hold the other shards of every
    gradient (None: each rank holds whole gradients). ``shard_group`` and
    ``shard_flags`` (one flag per parameter): the ranks of ``shard_group``
    hold the other shards of the flagged parameters, and the rest are
    replicated over it: ``model`` under tensor parallelism, ``pipe`` under
    pipeline parallelism (the blocks), ``expert`` under expert parallelism
    (never two of them wider than 1). ``pipe_group`` and ``pipe_shared``
    (one flag per parameter): under a pipeline, the flagged parameters are
    held by every stage, and ``finish_grads`` sums their gradients over
    ``pipe_group`` after the arm's reduction.

    Under ``offload_opt_state`` there is no device AdamW: ``host``
    (``parallel/offload.HostOffload``) holds the fp32 masters and moments of
    the same local tensors and runs the update; ``step`` hands it the
    gradients and the clip's scale. Its delayed form starts the host's
    worker in ``zero_grad``, at the start of a step, and joins it in
    ``step``."""

    def __init__(self, strategy: StrategyConfig, params: Iterable[torch.nn.Parameter],
                 norm_group: Optional[dist.ProcessGroup] = None,
                 shard_group: Optional[dist.ProcessGroup] = None,
                 shard_flags: Optional[List[bool]] = None,
                 pipe_group: Optional[dist.ProcessGroup] = None,
                 pipe_shared: Optional[List[bool]] = None):
        self.strategy = strategy
        self.params = [p for p in params]
        self.norm_group = norm_group
        self.shard_group = shard_group
        self.shard_flags = shard_flags or [False] * len(self.params)
        self.pipe_group = pipe_group
        self.pipe_shared = pipe_shared or [False] * len(self.params)
        if strategy.warmup_steps > 0:
            self.schedule = linear_schedule(0.0, strategy.learning_rate, strategy.warmup_steps)
        else:
            self.schedule = lambda count: strategy.learning_rate
        self.adamw: Optional[torch.optim.AdamW] = None
        self.host: Optional[HostOffload] = None
        if strategy.offload_opt_state:
            self.host = HostOffload(strategy, [_local(p) for p in self.params], self.schedule)
        else:
            self.adamw = torch.optim.AdamW(
                self.params, lr=strategy.learning_rate, betas=strategy.betas,
                eps=strategy.eps, weight_decay=strategy.weight_decay,
            )
        self.count = 0

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

    def _global_norm_sharded(self, f32: bool = False) -> torch.Tensor:
        """The norm over every element once: the flagged leaves' squares
        summed over ``shard_group``, the replicated ones' counted once,
        then (shards of one gradient) summed over ``norm_group``."""
        parts = {True: [], False: []}
        for p, sharded in zip(self.params, self.shard_flags):
            if p.grad is not None:
                parts[sharded].append(_local(p.grad))
        norms = {sharded: _total_norm(grads, f32) for sharded, grads in parts.items() if grads}
        some = next(iter(norms.values()))
        sq = {sharded: norms[sharded] ** 2 if sharded in norms else torch.zeros_like(some)
              for sharded in (True, False)}
        dist.all_reduce(sq[True], group=self.shard_group)
        total = sq[True] + sq[False]
        if self.norm_group is not None:
            dist.all_reduce(total, group=self.norm_group)
        return total.sqrt()

    def _clip_norm(self, f32: bool = False) -> torch.Tensor:
        """The clip's global norm: fp32 (an fp64 sum of fp32 gradients'
        squares rounded once), or the bf16 gradients' own dtype."""
        if self.shard_group is None:
            norm = self._global_norm(self._grads(), f32)
        else:
            norm = self._global_norm_sharded(f32)
        return norm.float() if norm.dtype == torch.float64 else norm

    @torch.no_grad()
    def clip(self) -> None:
        """optax clip_by_global_norm, in place on ``.grad``."""
        c = self.strategy.grad_clip
        if c is None:
            return
        grads = self._grads()
        g_norm = self._clip_norm()
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
            return None
        g_norm = self._clip_norm(f32=True)
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
    ``expert_reduce`` (the ``data`` group) and divides by ``ranks``. Under a
    pipeline (``explicit``) every backward runs under ``no_sync`` and
    ``finish_grads`` averages the gradients over DDP's group itself."""

    def __init__(self, strategy: StrategyConfig, ddp: DistributedDataParallel,
                 experts: List[torch.nn.Parameter] = (),
                 expert_reduce: Optional[dist.ProcessGroup] = None, ranks: int = 1,
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
            dist.all_reduce(p.grad, group=self.expert_reduce)
            p.grad.div_(self.ranks)
        if self.explicit:
            grads = self._grads()
            _all_reduce_flat(grads, self.ddp.process_group)
            torch._foreach_div_(grads, float(dist.get_world_size(self.ddp.process_group)))
        super().finish_grads(grad_accum)


class _FSDPOptimizer(Optimizer):
    """fsdp / zero3: FSDP2 averages each gradient over its mesh; the experts'
    mesh is ``data`` only, so their gradients are divided by the ``expert``
    width ``ep`` as well (dp * ep in all)."""

    def __init__(self, strategy: StrategyConfig, model: torch.nn.Module,
                 experts: List[torch.nn.Parameter], ep: int, **kw):
        super().__init__(strategy, model.parameters(), **kw)
        self.experts, self.ep = experts, ep

    @torch.no_grad()
    def finish_grads(self, grad_accum: int) -> None:
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
    parameters are views into it), the flat grads, this rank's shard of the
    grads, the groups its shard is all-reduced over after the
    reduce-scatter, and the reduce-scatter's arming (the backward that
    lands the step's last gradients), count-down and work."""

    key: str
    flat: torch.Tensor
    grads: torch.Tensor
    shard_grad: torch.Tensor
    n_params: int
    replicas: Tuple[dist.ProcessGroup, ...]
    armed: bool = False
    pending: int = 0
    work: Any = None


class _Zero2Optimizer(Optimizer):
    """zero2 by hand (see the module docstring). AdamW steps over this rank's
    shard of each bucket's flat buffer, a view into it, so its update lands
    in the replicated params in place; the all-gathers fill in the other
    shards."""

    def __init__(self, strategy: StrategyConfig, model: torch.nn.Module, mesh: Mesh):
        self.group = mesh.data_group
        dp, rank = dist.get_world_size(self.group), dist.get_rank(self.group)
        seq, expert = mesh.seq_group, mesh.expert_group
        self.ranks = dp * math.prod(dist.get_world_size(g) for g in (seq, expert)
                                    if g is not None)
        names = [name for name, _ in model.named_parameters()]
        flags = _shard_flags(model, mesh)
        # One bucket per (block, dtype, kind): sharded over 'model' / an
        # expert leaf (the clip counts their squares over that group), or not.
        by_key: Dict[tuple, List[torch.nn.Parameter]] = {}
        for name, p, sharded in zip(names, model.parameters(), flags):
            by_key.setdefault((zero2_bucket(name), p.dtype, sharded), []).append(p)
        self.buckets: List[_Bucket] = []
        shards = []
        with torch.no_grad():
            for (key, dtype, sharded), params in by_key.items():
                n = sum(p.numel() for p in params)
                size = -(-n // dp)  # one rank's shard; the padding is zero
                device = params[0].device
                flat = torch.zeros(size * dp, dtype=dtype, device=device)
                grads = torch.zeros_like(flat)
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
                is_expert = sharded and expert is not None
                replicas = tuple(g for g in (seq, None if is_expert else expert) if g is not None)
                bucket = _Bucket(key, flat, grads, shard.grad, len(params), replicas)
                for p in params:
                    p.register_post_accumulate_grad_hook(functools.partial(self._ready, bucket))
                self.buckets.append(bucket)
        pipe = {}
        if mesh.pipe_group is not None:
            pipe = dict(pipe_group=mesh.pipe_group, pipe_shared=[key == "" for key, _, _ in by_key])
        super().__init__(strategy, shards, norm_group=self.group, shard_group=_shard_group(mesh),
                         shard_flags=[sharded for _, _, sharded in by_key], **pipe)

    def zero_grad(self) -> None:
        # The params' grads are views into the flat buffers: keep them.
        for b in self.buckets:
            b.grads.zero_()
        if self.host is not None:
            self.host.begin_step()

    def sync_context(self, last: bool) -> ContextManager:
        for b in self.buckets:
            b.armed, b.pending, b.work = last, b.n_params, None
        return contextlib.nullcontext()

    def last_backward(self, buckets: Iterable[str]) -> None:
        keys = set(buckets)
        for b in self.buckets:
            if b.key in keys:
                b.armed, b.pending = True, b.n_params

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
                dist.all_gather_into_tensor(b.flat, shard, group=self.group)


def make_optimizer(strategy: StrategyConfig, params: Iterable[torch.nn.Parameter]) -> Optimizer:
    """The arm's optimizer over ``params`` (see the module docstring)."""
    return Optimizer(strategy, params)


def _shard_group(mesh: Mesh) -> Optional[dist.ProcessGroup]:
    """The group whose ranks hold the other shards of the sharded leaves:
    ``model``, ``pipe`` or ``expert`` (never two of them wider than 1), or
    None."""
    for group in (mesh.model_group, mesh.pipe_group):
        if group is not None:
            return group
    return mesh.expert_group


def _shard_flags(model: torch.nn.Module, mesh: Mesh) -> List[bool]:
    """Per parameter of ``model`` (in ``parameters()`` order): whether the
    ``model`` axis shards it (``tp_axis``), a ``pipe`` axis (a block leaf:
    each stage holds its own layers) or, under an ``expert`` axis, it is an
    expert leaf."""
    tp, ep, kv = mesh.size(AXES.model), mesh.size(AXES.expert), model.config.kv_heads
    pp = mesh.size(AXES.pipe)
    return [tp_axis(name, kv, tp) is not None or expert_axis(name, ep) is not None
            or (pp > 1 and zero2_bucket(name) != "") for name, _ in model.named_parameters()]


def _expert_modules(model: torch.nn.Module) -> List[torch.nn.Module]:
    return [block.experts for block in model.blocks if hasattr(block, "experts")]


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
    group = mesh.data_group
    shards = {}
    if _shard_group(mesh) is not None:
        shards = dict(shard_group=_shard_group(mesh), shard_flags=_shard_flags(model, mesh))
    if mesh.pipe_group is not None:
        shared = [zero2_bucket(name) == "" for name, _ in model.named_parameters()]
        shards.update(pipe_group=mesh.pipe_group, pipe_shared=shared)
    experts = _expert_modules(model) if mesh.expert_group is not None else []
    if strategy.shard_params:
        shard_mesh = shard_data_mesh(mesh)
        for block in model.blocks:
            if experts:
                fully_shard(block.experts, mesh=mesh.device_mesh[AXES.data])
            fully_shard(block, mesh=shard_mesh)
        fully_shard(model, mesh=shard_mesh)
        # fully_shard replaced the parameters: take the experts' afterwards.
        return model, _FSDPOptimizer(strategy, model, [p for m in experts for p in m.parameters()],
                                     mesh.size(AXES.expert), norm_group=group, **shards)
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
    return ddp, _DDPOptimizer(strategy, ddp, expert_params, group,
                              mesh.size(AXES.data) * mesh.size(AXES.expert),
                              explicit=mesh.pipe_group is not None, **shards)
