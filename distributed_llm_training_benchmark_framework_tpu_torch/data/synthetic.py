"""Seeded synthetic token dataset: zero I/O, reproducible, device-resident.

Port of ``distributed_llm_training_benchmark_framework_tpu/data/synthetic.py``:
a (size, seq_len) table of token ids drawn uniformly from the vocabulary
with a fixed seed (42), targets equal to the inputs, unshifted (the
reference's parity quirk). The values come from
``np.random.default_rng(seed)``, since ``jax.random.randint`` cannot be
reproduced outside JAX; parity tests hand both sides the same table.

The table lives on the training device; each step gathers its rows there
(``step_batch``), as the JAX train step does in-graph.
"""

from __future__ import annotations

import numpy as np
import torch


class SyntheticDataset:
    def __init__(self, vocab_size: int = 32000, seq_len: int = 2048, size: int = 1000,
                 seed: int = 42):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.size = size
        self.seed = seed
        self.data = np.random.default_rng(seed).integers(
            0, vocab_size, (size, seq_len), dtype=np.int64
        )

    def __len__(self) -> int:
        return self.size

    def to_device(self, device) -> torch.Tensor:
        """The whole table as an int64 tensor on ``device``."""
        return torch.from_numpy(self.data).to(device)


def step_batch(table: torch.Tensor, step: int, grad_accum: int, micro_batch: int) -> torch.Tensor:
    """Rows ``(step*G + arange(G)) % size`` of the device table, laid out
    (accum, micro, S) with G = accum * micro (JAX ``train/step.py``)."""
    G = grad_accum * micro_batch
    rows = (step * G + torch.arange(G, device=table.device)) % table.shape[0]
    return table.index_select(0, rows).reshape(grad_accum, micro_batch, table.shape[1])
