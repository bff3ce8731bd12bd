"""Strategy arms and the optimizer recipe, single-device subset.

Port of ``distributed_llm_training_benchmark_framework_tpu/parallel/strategies.py``
(``StrategyConfig``, ``STRATEGIES``, ``make_optimizer``). On one device an
arm is its optimizer recipe: ddp and fsdp run bare AdamW, zero2 and zero3
add the 5-step warmup and the clip. Sharding comes with the multi-GPU slice.

The recipe equals optax's ``chain(clip_by_global_norm(c), adamw(schedule))``:

- clip: with g_norm = sqrt(sum of squares over every gradient), each
  gradient becomes ``(g / g_norm) * c`` when ``g_norm >= c`` and stays as it
  is otherwise (optax's formula; ``torch.nn.utils.clip_grad_norm_`` divides
  by ``g_norm + 1e-6`` and does not match);
- AdamW: ``torch.optim.AdamW``, whose update equals optax ``adamw``: decay
  decoupled and scaled by lr, bias correction from step 1, eps outside the
  square root, decay on every leaf;
- learning rate: optax ``linear_schedule(0, lr, warmup_steps)`` evaluated at
  the update count before each update, so update 0 runs at lr 0 and update
  ``warmup_steps`` onwards at the full rate.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class StrategyConfig:
    """One strategy arm's optimizer recipe."""

    name: str
    learning_rate: float = 1e-4
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.01
    warmup_steps: int = 0
    grad_clip: Optional[float] = None


STRATEGIES: Dict[str, StrategyConfig] = {
    "ddp": StrategyConfig(name="ddp"),
    "fsdp": StrategyConfig(name="fsdp"),
    "zero2": StrategyConfig(name="zero2", warmup_steps=5, grad_clip=1.0),
    "zero3": StrategyConfig(name="zero3", warmup_steps=5, grad_clip=1.0),
}


def get_strategy(name: str) -> StrategyConfig:
    if name not in STRATEGIES:
        raise ValueError(f"Unknown strategy {name!r} (expected one of {sorted(STRATEGIES)})")
    return STRATEGIES[name]


def linear_schedule(init_value: float, end_value: float, transition_steps: int):
    """optax.linear_schedule: count -> lr, clamped to [0, transition_steps]."""

    def schedule(count: int) -> float:
        c = min(max(count, 0), transition_steps)
        return (init_value - end_value) * (1.0 - c / transition_steps) + end_value

    return schedule


class Optimizer:
    """Global-norm clip (optional) + AdamW under the arm's lr schedule, over
    ``.grad`` of the given parameters. ``count`` is optax's update count."""

    def __init__(self, strategy: StrategyConfig, params: Iterable[torch.nn.Parameter]):
        self.strategy = strategy
        self.params = [p for p in params]
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

    @torch.no_grad()
    def clip(self) -> None:
        """optax clip_by_global_norm, in place on ``.grad``."""
        c = self.strategy.grad_clip
        if c is None:
            return
        grads = [p.grad for p in self.params if p.grad is not None]
        g_norm = torch.nn.utils.get_total_norm(grads, norm_type=2.0)
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


def make_optimizer(strategy: StrategyConfig, params: Iterable[torch.nn.Parameter]) -> Optimizer:
    """The arm's optimizer over ``params`` (see the module docstring)."""
    return Optimizer(strategy, params)
