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
- **zero2** params replicated, grads and AdamW state sharded: per dtype one
  flat buffer padded to a multiple of the ``data`` width holds the params
  as views, another the grads; after the last micro-batch the grads are
  reduce-scattered (averaged) into this rank's shard, AdamW updates that
  shard of the params in place, and an all-gather refills the replicated
  buffer (DeepSpeed ZeRO stage 2's semantics, as in JAX);
- **zero3** like fsdp, with per-layer remat ``auto`` (resolved against the
  memory model by the loop, ``utils/memory.resolve_auto_remat``).

ddp and fsdp run bare AdamW; zero2 and zero3 add the 5-step warmup and the
clip. Without a process group (one device, no launcher) every arm is its
optimizer recipe on the plain model, with no wrapper.

The recipe equals optax's ``chain(clip_by_global_norm(c), adamw(schedule))``:

- clip: with g_norm = sqrt(sum of squares over every gradient), each
  gradient becomes ``(g / g_norm) * c`` when ``g_norm >= c`` and stays as it
  is otherwise (optax's formula; ``torch.nn.utils.clip_grad_norm_`` divides
  by ``g_norm + 1e-6`` and does not match). Where the grads are shards of
  one gradient (fsdp, zero2, zero3), the squares of every rank's shard are
  summed over ``data`` (zero2's padding is zero and adds nothing);
- AdamW: ``torch.optim.AdamW``, whose update equals optax ``adamw``: decay
  decoupled and scaled by lr, bias correction from step 1, eps outside the
  square root, decay on every leaf. AdamW is elementwise, so on a shard
  (a flat one, or a DTensor's) it computes what optax computes per leaf;
- learning rate: optax ``linear_schedule(0, lr, warmup_steps)`` evaluated at
  the update count before each update, so update 0 runs at lr 0 and update
  ``warmup_steps`` onwards at the full rate.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import ContextManager, Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor import DTensor
from torch.nn.parallel import DistributedDataParallel

from .mesh import Mesh


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
    # Parameter storage dtype. The port holds 'f32' only (bf16 parameters:
    # ROADMAP Queue 1 item 0).
    param_dtype: str = "f32"
    # The host-offload arm (JAX: TPU only); not ported (ROADMAP Queue 1
    # item 10, third bullet).
    offload_opt_state: bool = False
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
    """Refuse what the port does not run yet, naming where it is queued."""
    if strategy.offload_opt_state or strategy.offload_delayed_update:
        raise ValueError(
            f"{strategy.name}: offload_opt_state / offload_delayed_update (the host-offload "
            "arm) is not ported yet (ROADMAP Queue 1 item 10, third bullet); the JAX "
            "package runs it on a TPU only"
        )
    if strategy.param_dtype != "f32":
        raise ValueError(
            f"{strategy.name}: param_dtype {strategy.param_dtype!r} is not ported yet "
            "(ROADMAP Queue 1 item 0); the port holds fp32 parameters"
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


def linear_schedule(init_value: float, end_value: float, transition_steps: int):
    """optax.linear_schedule: count -> lr, clamped to [0, transition_steps]."""

    def schedule(count: int) -> float:
        c = min(max(count, 0), transition_steps)
        return (init_value - end_value) * (1.0 - c / transition_steps) + end_value

    return schedule


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (a view), or the tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


class Optimizer:
    """Global-norm clip (optional) + AdamW under the arm's lr schedule, over
    ``.grad`` of the given parameters. ``count`` is optax's update count.

    ``norm_group``: the group whose ranks hold the other shards of every
    gradient (None: each rank holds whole gradients)."""

    def __init__(self, strategy: StrategyConfig, params: Iterable[torch.nn.Parameter],
                 norm_group: Optional[dist.ProcessGroup] = None):
        self.strategy = strategy
        self.params = [p for p in params]
        self.norm_group = norm_group
        self.adamw = torch.optim.AdamW(
            self.params, lr=strategy.learning_rate, betas=strategy.betas,
            eps=strategy.eps, weight_decay=strategy.weight_decay,
        )
        if strategy.warmup_steps > 0:
            self.schedule = linear_schedule(0.0, strategy.learning_rate, strategy.warmup_steps)
        else:
            self.schedule = lambda count: strategy.learning_rate
        self.count = 0

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def sync_context(self, last: bool) -> ContextManager:
        """Wrap one micro-batch's forward and backward; ``last`` is the last
        micro-batch of the step."""
        return contextlib.nullcontext()

    def _grads(self) -> List[torch.Tensor]:
        return [_local(p.grad) for p in self.params if p.grad is not None]

    @torch.no_grad()
    def finish_grads(self, grad_accum: int) -> None:
        """After the last micro-batch: the summed grads become their mean."""
        if grad_accum > 1:
            torch._foreach_div_(self._grads(), float(grad_accum))

    def _global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        norm = torch.nn.utils.get_total_norm(grads, norm_type=2.0)
        if self.norm_group is None:
            return norm
        sq = norm * norm
        dist.all_reduce(sq, group=self.norm_group)
        return sq.sqrt()

    @torch.no_grad()
    def clip(self) -> None:
        """optax clip_by_global_norm, in place on ``.grad``."""
        c = self.strategy.grad_clip
        if c is None:
            return
        grads = self._grads()
        g_norm = self._global_norm(grads)
        trigger = g_norm < c
        one = torch.ones((), dtype=g_norm.dtype, device=g_norm.device)
        # (g / g_norm) * c when clipping, g / 1 * 1 otherwise: no host sync.
        torch._foreach_div_(grads, torch.where(trigger, one, g_norm))
        torch._foreach_mul_(grads, torch.where(trigger, one, one * c))

    def step(self) -> None:
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
    buckets."""

    def __init__(self, strategy: StrategyConfig, ddp: DistributedDataParallel):
        super().__init__(strategy, ddp.module.parameters())
        self.ddp = ddp

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=False)

    def sync_context(self, last: bool) -> ContextManager:
        return contextlib.nullcontext() if last else self.ddp.no_sync()


class _Zero2Optimizer(Optimizer):
    """zero2 by hand (see the module docstring). AdamW steps over this rank's
    shard of each flat buffer, a view into it, so its update lands in the
    replicated params in place; the all-gather fills in the other shards."""

    def __init__(self, strategy: StrategyConfig, model: torch.nn.Module,
                 group: dist.ProcessGroup):
        dp, rank = dist.get_world_size(group), dist.get_rank(group)
        self.group = group
        self.buckets = []  # (flat params, flat grads, shard of the grads)
        shards = []
        by_dtype: Dict[torch.dtype, List[torch.nn.Parameter]] = {}
        for p in model.parameters():
            by_dtype.setdefault(p.dtype, []).append(p)
        with torch.no_grad():
            for dtype, params in by_dtype.items():
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
                self.buckets.append((flat, grads, shard.grad))
        super().__init__(strategy, shards, norm_group=group)

    def zero_grad(self) -> None:
        # The params' grads are views into the flat buffers: keep them.
        for _, grads, _ in self.buckets:
            grads.zero_()

    @torch.no_grad()
    def finish_grads(self, grad_accum: int) -> None:
        for _, grads, shard_grad in self.buckets:
            dist.reduce_scatter_tensor(shard_grad, grads, op=dist.ReduceOp.AVG,
                                       group=self.group)
        super().finish_grads(grad_accum)

    def step(self) -> None:
        super().step()
        with torch.no_grad():
            for (flat, _, _), shard in zip(self.buckets, self.params):
                dist.all_gather_into_tensor(flat, shard, group=self.group)


def make_optimizer(strategy: StrategyConfig, params: Iterable[torch.nn.Parameter]) -> Optimizer:
    """The arm's optimizer over ``params`` (see the module docstring)."""
    return Optimizer(strategy, params)


def apply_strategy(model: torch.nn.Module, strategy: StrategyConfig,
                   mesh: Optional[Mesh]) -> Tuple[torch.nn.Module, Optimizer]:
    """Lay the model out as the arm asks over ``mesh``'s ``data`` axis and
    return (the model to call, its optimizer). Without a process group
    (no ``mesh.device_mesh``) the model is returned as it is. Weights must
    be loaded before this call (``bridge.load_jax_params``)."""
    check_ported(strategy)
    if mesh is None or mesh.device_mesh is None:
        return model, make_optimizer(strategy, model.parameters())
    group = mesh.data_group
    if strategy.shard_params:
        for block in model.blocks:
            fully_shard(block, mesh=mesh.device_mesh)
        fully_shard(model, mesh=mesh.device_mesh)
        return model, Optimizer(strategy, model.parameters(), norm_group=group)
    if strategy.shard_grads:
        return model, _Zero2Optimizer(strategy, model, group)
    device = next(model.parameters()).device
    ddp = DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        process_group=group, broadcast_buffers=False, gradient_as_bucket_view=True,
    )
    return ddp, _DDPOptimizer(strategy, ddp)
