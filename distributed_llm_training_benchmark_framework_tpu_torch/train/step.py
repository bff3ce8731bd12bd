"""One optimizer step: the non-pipelined branch of the JAX train step.

Port of ``distributed_llm_training_benchmark_framework_tpu/train/step.py``
(``make_train_step``, lines 315-331 and 400-501):

- the step's global batch is gathered from the device-resident table,
  rows ``(step*G + arange(G)) % size`` laid out (accum, global micro, S),
  G = accum * global micro and global micro = per-device batch * dp; rank
  r of the ``data`` axis takes rows ``[r*pd, (r+1)*pd)`` of each micro-batch
  (JAX shards that dimension over ``data``) and keys the attention mask
  from its first global row;
- targets are the inputs, unshifted;
- one forward/backward per micro-batch; ``.grad`` sums the gradients in the
  parameter dtype (the arm reduces them over ``data``: ``Optimizer``'s
  ``sync_context`` and ``finish_grads``), then they are divided by accum;
  the loss is the mean of the micro losses, and over ranks;
- clip and AdamW (``parallel.strategies.Optimizer``).

Dropout randomness comes from explicit generators seeded from ``seed``: one
uint32 attention-dropout seed per (step, micro, layer) from a CPU generator
(a host integer, so no device sync, and the same on every rank), and the
embedding / MLP masks from a generator on the training device. JAX draws
from its own PRNG, which no torch generator reproduces, so with dropout > 0
the two agree only statistically; with dropout 0 they agree step for step.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from ..data.synthetic import step_batch
from ..parallel.mesh import AXES, Mesh
from ..parallel.strategies import Optimizer


class TrainStep:
    def __init__(self, model: torch.nn.Module, optimizer: Optimizer, *, grad_accum: int,
                 micro_batch: int, seed: int, device: torch.device,
                 mesh: Optional[Mesh] = None):
        self.model = model
        # A DDP wrapper keeps the model (and its config) on ``.module``.
        self.config = getattr(model, "module", model).config
        self.optimizer = optimizer
        self.grad_accum = grad_accum
        self.micro_batch = micro_batch
        self.device = device
        self.dp = mesh.size(AXES.data) if mesh is not None else 1
        self.rank = mesh.data_rank if mesh is not None else 0
        self.loss_group = mesh.data_group if mesh is not None else None
        self.seed_gen = torch.Generator().manual_seed(seed)
        self.mask_gen = torch.Generator(device=device).manual_seed(seed)

    def _attn_seeds(self) -> Optional[List[int]]:
        c = self.config
        if c.dropout == 0.0:
            return None
        return torch.randint(0, 2**32, (c.n_layer,), generator=self.seed_gen,
                             dtype=torch.int64).tolist()

    def __call__(self, table: torch.Tensor, step: int) -> torch.Tensor:
        """Run optimizer step ``step``; returns the mean loss as a 0-d tensor
        on the device (reading it is the caller's sync point)."""
        batch = step_batch(table, step, self.grad_accum, self.micro_batch * self.dp)
        if self.dp > 1:
            batch = batch[:, self.rank * self.micro_batch:(self.rank + 1) * self.micro_batch]
        gen = self.mask_gen if self.config.dropout > 0.0 else None
        self.optimizer.zero_grad()
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for j, micro in enumerate(batch):
            with self.optimizer.sync_context(last=j == self.grad_accum - 1):
                _, loss = self.model(micro, micro, attn_seeds=self._attn_seeds(), generator=gen,
                                     batch_offset=self.rank * self.micro_batch)
                loss.backward()
            loss_sum += loss.detach()
        self.optimizer.finish_grads(self.grad_accum)
        self.optimizer.step()
        if self.loss_group is not None:
            dist.all_reduce(loss_sum, op=dist.ReduceOp.SUM, group=self.loss_group)
            return loss_sum / (self.grad_accum * self.dp)
        return loss_sum / self.grad_accum
