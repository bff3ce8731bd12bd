"""One optimizer step: the JAX train step, its pipelined branches included.

Port of ``distributed_llm_training_benchmark_framework_tpu/train/step.py``
(``make_train_step``, lines 315-331 and 355-501):

- the step's global batch is gathered from the device-resident table,
  rows ``(step*G + arange(G)) % size`` laid out (accum, global micro, S),
  G = accum * global micro and global micro = per-device batch * dp; rank
  (d, s) of the (``data``, ``seq``) mesh takes rows ``[d*pd, (d+1)*pd)``
  of each micro-batch (JAX shards that dimension over ``data``) and, when
  ``seq`` rides the group, columns ``[s*S/n, (s+1)*S/n)`` (JAX shards the
  sequence over ``seq``); it keys the attention mask from its first global
  row;
- targets are the inputs, unshifted, so no token crosses a shard boundary
  and every rank counts the same pd * S/n targets: the mean of the ranks'
  mean losses is the global mean, and so is the mean of their gradients;
- one forward/backward per micro-batch; ``.grad`` sums the gradients in the
  parameter dtype (the arm reduces them over ``data`` x ``seq``:
  ``Optimizer``'s ``sync_context`` and ``finish_grads``), then they are
  divided by accum; the loss is the mean of the micro losses, and over every
  rank of the group;
- clip and AdamW (``parallel.strategies.Optimizer``). On the device, or
  under host offload (``parallel/offload.py``) on the host: the gradients
  (bf16, as the parameters) and the clip's fp32 scale are copied to host
  memory, AdamW updates the fp32 masters there, and the bf16 compute copy is
  copied back into the parameters before the next step's forward. The
  serial form does that inside ``optimizer.step``; the delayed form starts
  the host update of the previous step's gradients in ``zero_grad`` (so it
  runs while this step's forward and backward run on the device) and joins
  it in ``step``.

Under expert parallelism the batch rows shard over ``data`` x ``expert``
(JAX's ``batch_partition_spec``): the global micro-batch is pd * dp * ep
rows and member ``d * ep + e`` takes rows ``[(d*ep + e)*pd, ...)``, keyed
from its first row. The MoE layers exchange tokens over the ``expert``
group (``models/moe.py``); every member's loss is a mean over its own rows.

Under tensor parallelism the ``model`` ranks of a (data, seq) place take the
same rows and columns, the same seeds and the same masks (the batch is
replicated over ``model``, as JAX's batch spec names no ``model`` axis);
each computes the whole loss (``parallel/tensor.py``'s vocab-parallel loss),
so the mean over every rank of the group is still the global mean.

Dropout randomness comes from one CPU generator seeded from ``seed`` (host
integers, so no device sync, and the same on every rank, as the ranks of a
ring must agree): per (step, micro) one uint32 attention-dropout seed per
layer, then n_layer + 1 site seeds for the embedding / MLP masks (the
embedding's and each layer's). Each global batch row draws its mask from
its own generator seeded from (site seed, row), at the full sequence
length, and a rank draws only its rows and keeps only its columns
(``TinyGPT.forward``'s ``global_batch``): a run over a (data, seq) group
draws the masks of the one-process run of the same global batch, and a
rank's masks do not grow with ``data``. JAX draws from its own PRNG, which
no torch generator reproduces, so with dropout > 0 the two agree only
statistically; with dropout 0 they agree step for step.

Under pipeline parallelism (a ``pipe`` axis, ``parallel/pipeline.py``) the
step's (accum, batch, S) micro-batches are the schedule's M microbatches
("the pipeline IS the gradient accumulation", as JAX says): every stage of
a (data, seq) place takes the same rows and columns, the schedule runs its
forward and backward units (each microbatch's loss entering as loss / M),
and the arm reduces and steps. The step draws, per microbatch, the attention
seeds of all n_layer layers and n_layer + 1 mask seeds (the embedding's and
each layer's) from the CPU generator, the same on every rank, and each
stage uses those of its layers, so every schedule draws the same masks,
and the same as the step without a pipeline.
The loss is the last stage's mean (plus, with experts, every stage's aux
term), summed over the group and divided by M and the ranks of one stage.

The streaming input path (``data/prefetch.py``) hands the step this rank's
rows already cut, ``(accum, micro, S/n)``: ``run_batch`` takes them as
they are (JAX's ``from_table=False``), where ``__call__`` gathers them
from the table.

With ``sentinel`` (the numerics sentinel, JAX ``train/step.py:459``) a step
off a pipeline also leaves the fp32 global norm of its averaged gradients,
before the clip, in ``optimizer.grad_norm`` (``parallel.strategies.
Optimizer``'s ``track_grad_norm``): a 0-d device tensor the loop reads at
its fenced boundary with the loss, so it adds no host sync. A pipelined
step leaves None, as JAX's pipelined arms return no norm. ``param_checksum`` is the
parameters' fp32 global norm (JAX ``make_param_norm_fn``).

``reseed(seed, k)`` puts the dropout seeds' generator on a fresh stream, the
k-th replay's: the sentinel's rollback restores the generator with the
parameters, and a replay of the synthetic path must not redraw the
poisoned pass's masks (JAX folds ``k * steps`` into the step index, whose
keys feed its dropout).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from ..data.synthetic import step_batch
from ..parallel.mesh import Mesh
from ..parallel.pipeline import Pipeline
from ..parallel.strategies import Optimizer


class TrainStep:
    def __init__(self, model: torch.nn.Module, optimizer: Optimizer, *, grad_accum: int,
                 micro_batch: int, seed: int, device: torch.device,
                 mesh: Optional[Mesh] = None, pipeline: Optional[Pipeline] = None,
                 sentinel: bool = False):
        self.model = model
        # A DDP wrapper keeps the model (and its config) on ``.module``.
        self.config = getattr(model, "module", model).config
        self.optimizer = optimizer
        self.grad_accum = grad_accum
        self.micro_batch = micro_batch
        self.device = device
        # This rank's member index over data x expert and their count.
        self.member, self.members = mesh.batch_shard if mesh is not None else (0, 1)
        self.seq_shard = mesh.seq_shard if mesh is not None else (0, 1)
        self.loss_group = mesh.group if mesh is not None else None
        self.world = mesh.world if mesh is not None else 1
        self.seed_gen = torch.Generator().manual_seed(seed)
        self.pipeline = pipeline
        # The ranks of one pipeline stage (the whole group without a pipeline).
        self.stage_ranks = self.world // (mesh.size("pipe") if mesh is not None else 1)
        optimizer.track_grad_norm = sentinel and pipeline is None

    def reseed(self, seed: int, k: int) -> None:
        """The dropout seeds' generator on the stream of replay ``k`` (>= 1):
        the seed ``seed + k * 0x9E3779B97F4A7C15`` modulo 2**63, a stream no
        earlier pass drew from."""
        self.seed_gen.manual_seed((seed + k * 0x9E3779B97F4A7C15) % 2**63)

    def param_checksum(self) -> torch.Tensor:
        """The parameters' fp32 global L2 norm, a 0-d device tensor
        (collective over the arm's groups)."""
        return self.optimizer.param_norm()

    def _attn_seeds(self) -> Optional[List[int]]:
        c = self.config
        if c.dropout == 0.0:
            return None
        return torch.randint(0, 2**32, (c.n_layer,), generator=self.seed_gen,
                             dtype=torch.int64).tolist()

    def _mask_seeds(self) -> Optional[List[int]]:
        c = self.config
        if c.dropout == 0.0:
            return None
        return torch.randint(0, 2**62, (c.n_layer + 1,), generator=self.seed_gen,
                             dtype=torch.int64).tolist()

    def __call__(self, table: torch.Tensor, step: int) -> torch.Tensor:
        """Run optimizer step ``step``; returns the mean loss as a 0-d tensor
        on the device (reading it is the caller's sync point)."""
        return self.run_batch(self.rows(table, step))

    def run_batch(self, batch: torch.Tensor) -> torch.Tensor:
        """One optimizer step over this rank's rows ``batch`` (accum, micro,
        S/n); returns the mean loss as ``__call__`` does."""
        loss_sum = self.accumulate_batch(batch)
        self.optimizer.step()
        if self.loss_group is None:
            return loss_sum / self.grad_accum
        dist.all_reduce(loss_sum, op=dist.ReduceOp.SUM, group=self.loss_group)
        return loss_sum / (self.grad_accum * self.stage_ranks)

    def rows(self, table: torch.Tensor, step: int) -> torch.Tensor:
        """This rank's rows and columns of step ``step``'s global batch."""
        global_micro = self.micro_batch * self.members
        row0 = self.member * self.micro_batch
        batch = step_batch(table, step, self.grad_accum, global_micro)
        if self.members > 1:
            batch = batch[:, row0:row0 + self.micro_batch]
        s, n = self.seq_shard
        if n > 1:
            cols = batch.shape[-1] // n
            batch = batch[..., s * cols:(s + 1) * cols]
        return batch

    def accumulate(self, table: torch.Tensor, step: int) -> torch.Tensor:
        """Step ``step``'s forward and backward over its micro-batches, and
        the arm's reduction (``.grad`` then holds the step's gradient, as the
        optimizer takes it) -> this rank's sum of the micro-batches' losses
        (under a pipeline: zero on all but the last stage, plus this stage's
        aux term)."""
        return self.accumulate_batch(self.rows(table, step))

    def accumulate_batch(self, batch: torch.Tensor) -> torch.Tensor:
        """``accumulate`` over this rank's rows ``batch``."""
        global_micro = self.micro_batch * self.members
        row0 = self.member * self.micro_batch
        if self.pipeline is not None:
            return self._pipelined(batch, row0, global_micro)
        self.optimizer.zero_grad()
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for j, micro in enumerate(batch):
            # The pipeline's order of draws: one micro-batch's attention
            # seeds, then its mask seeds.
            attn_seeds = self._attn_seeds()
            with self.optimizer.sync_context(last=j == self.grad_accum - 1):
                _, loss = self.model(micro, micro, attn_seeds=attn_seeds,
                                     mask_seeds=self._mask_seeds(), batch_offset=row0,
                                     global_batch=global_micro)
                loss.backward()
            loss_sum += loss.detach()
        self.optimizer.finish_grads(self.grad_accum)
        return loss_sum

    def _pipelined(self, batch: torch.Tensor, row0: int, global_micro: int) -> torch.Tensor:
        c = self.config
        seeds = [(self._attn_seeds(), self._mask_seeds()) for _ in range(self.grad_accum)]

        def call(inp, targets, unit, micro):
            return self.model(inp, targets, unit=unit, attn_seeds=seeds[micro][0],
                              batch_offset=row0, global_batch=global_micro)

        self.optimizer.zero_grad()
        aux_coef = c.router_aux_coef / c.n_layer if c.n_experts > 0 else 0.0
        n_blocks = len(getattr(self.model, "module", self.model).blocks)
        loss_sum, aux_sum = self.pipeline.run(call, self.optimizer, batch, c.compute_dtype,
                                              c.n_embd, [m for _, m in seeds], aux_coef,
                                              n_blocks)
        # Each microbatch's loss entered as loss / M: the gradient is the mean.
        self.optimizer.finish_grads(1)
        return loss_sum if aux_sum is None else loss_sum + aux_coef * aux_sum
