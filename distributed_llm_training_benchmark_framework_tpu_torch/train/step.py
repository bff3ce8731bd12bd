"""One optimizer step: the non-pipelined branch of the JAX train step.

Port of ``distributed_llm_training_benchmark_framework_tpu/train/step.py``
(``make_train_step``, lines 354-362 and 400-501, single device):

- the step's batch is gathered from the device-resident table,
  rows ``(step*G + arange(G)) % size`` laid out (accum, micro, S);
- targets are the inputs, unshifted;
- one forward/backward per micro-batch; ``.grad`` sums the gradients in the
  parameter dtype, then they are divided by accum; the loss is the mean of
  the micro losses;
- clip and AdamW (``parallel.strategies.Optimizer``).

Dropout randomness comes from explicit generators seeded from ``seed``: one
uint32 attention-dropout seed per (step, micro, layer) from a CPU generator
(a host integer, so no device sync), and the embedding / MLP masks from a
generator on the training device. JAX draws from its own PRNG, which no
torch generator reproduces, so with dropout > 0 the two agree only
statistically; with dropout 0 they agree step for step.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..data.synthetic import step_batch
from ..models.tinygpt import TinyGPT
from ..parallel.strategies import Optimizer


class TrainStep:
    def __init__(self, model: TinyGPT, optimizer: Optimizer, *, grad_accum: int,
                 micro_batch: int, seed: int, device: torch.device):
        self.model = model
        self.optimizer = optimizer
        self.grad_accum = grad_accum
        self.micro_batch = micro_batch
        self.device = device
        self.seed_gen = torch.Generator().manual_seed(seed)
        self.mask_gen = torch.Generator(device=device).manual_seed(seed)

    def _attn_seeds(self) -> Optional[List[int]]:
        c = self.model.config
        if c.dropout == 0.0:
            return None
        return torch.randint(0, 2**32, (c.n_layer,), generator=self.seed_gen,
                             dtype=torch.int64).tolist()

    def __call__(self, table: torch.Tensor, step: int) -> torch.Tensor:
        """Run optimizer step ``step``; returns the mean loss as a 0-d tensor
        on the device (reading it is the caller's sync point)."""
        batch = step_batch(table, step, self.grad_accum, self.micro_batch)
        gen = self.mask_gen if self.model.config.dropout > 0.0 else None
        self.optimizer.zero_grad()
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for micro in batch:
            _, loss = self.model(micro, micro, attn_seeds=self._attn_seeds(), generator=gen)
            loss.backward()
            loss_sum += loss.detach()
        if self.grad_accum > 1:
            with torch.no_grad():
                torch._foreach_div_(
                    [p.grad for p in self.optimizer.params if p.grad is not None],
                    float(self.grad_accum),
                )
        self.optimizer.step()
        return loss_sum / self.grad_accum
