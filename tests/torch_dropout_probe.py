"""Read the attention-dropout mask back out of the forward kernels K1 / K4
and their plain versions (helpers for the ``test_torch_*`` files).

With q = k = 0 every score is 0, so every live p is exactly 1 and a row's
max is 0 wherever the row has a live key. With Dh 64 and v the identity on
one 64-key tile t (zero elsewhere), the unnormalized accumulator at (row, d)
is the dropped p of the key at column d of tile t: bf16(1 / (1 - rate)) if
that element is live and kept, else exactly 0. K4 writes that accumulator
(o); K1 writes out = o / l and lse = log(l), so o = out * l.
"""

import torch

from distributed_llm_training_benchmark_framework_tpu_torch.ops import flash_attention as fa
from distributed_llm_training_benchmark_framework_tpu_torch.ops import ring_attention as ra

DH = 64


def kept_value(rate: float) -> float:
    """What a kept live element contributes: bf16(1 / (1 - rate)), as the
    kernels round the dropped p before the product."""
    return torch.tensor(1.0 / (1.0 - rate)).to(torch.bfloat16).item()


def probe_inputs(bh: int, s: int, key_tile: int, device):
    q = torch.zeros(bh, s, DH, dtype=torch.bfloat16, device=device)
    v = torch.zeros_like(q)
    v[:, key_tile * DH:(key_tile + 1) * DH] = torch.eye(DH, dtype=torch.bfloat16, device=device)
    return q, q.clone(), v


def flash_probe(bh: int, s: int, key_tile: int, causal: bool, rate: float, seed: int, device):
    """K1 (``fa.flash_fwd``: the kernel on a CUDA device, the plain version on
    the CPU) on the probe: (out, l) with l = exp(lse) (the row max is 0)."""
    q, k, v = probe_inputs(bh, s, key_tile, device)
    out, lse = fa.flash_fwd(q, k, v, causal, rate, seed)
    return out, torch.exp(lse)


def ring_probe(qoff, koff, bhv, key_tile: int, causal: bool, rate: float, seed: int, device):
    """K4 (``ra.ring_fwd_block``) on the probe: (m, l, o)."""
    sl = qoff.numel() * DH
    q, k, v = probe_inputs(bhv.numel(), sl, key_tile, device)
    return ra.ring_fwd_block(q, k, v, causal, rate, seed, qoff, koff, bhv)


def coords(qoff, koff, key_tile: int, device):
    """Global rows of every q row and global columns of key tile ``key_tile``."""
    rows = fa._tile_coords(qoff, qoff.numel() * DH, device)
    cols = fa._tile_coords(koff, koff.numel() * DH, device)
    return rows, cols[key_tile * DH:(key_tile + 1) * DH], cols


def live_mask(rows, cols, causal: bool):
    live = rows[:, None] >= cols[None, :]
    return live if causal else torch.ones_like(live)
