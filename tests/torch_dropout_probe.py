"""Read the attention-dropout mask back out of the attention kernels (the
forward K1 / K4, the backward K2 / K3 and their ring modes K2′ / K3′) and
their plain versions (helpers for the ``test_torch_*`` files).

Forward. With q = k = 0 every score is 0, so every live p is exactly 1 and
a row's max is 0 wherever the row has a live key. With Dh 64 and v the
identity on one 64-key tile t (zero elsewhere), the unnormalized
accumulator at (row, d) is the dropped p of the key at column d of tile t:
bf16(1 / (1 - rate)) if that element is live and kept, else exactly 0. K4
writes that accumulator (o); K1 writes out = o / l and lse = log(l), so
o = out * l.

Backward, with lse = delta = 0 and q = 0, so every live p is again 1:

- dk/dv (K3): k = v = 0 and dO the identity on one q tile t, so dv at
  (key, d) is the dropped p of (q row 64 t + d, key): dv is the dropped
  p^T of that q tile (and dk is 0, since dp = 0);
- dq (K2): dO and v with every row e_0, so dp = 1 everywhere, and k the
  identity on one key tile t, so dq at (row, d) is ds of (row, key 64 t +
  d) = bf16(scale / (1 - rate)) where live and kept, else exactly 0: the
  tile's dropped ds.
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


def bwd_probe(kernel: str, bh: int, s: int, tile: int, causal: bool, rate: float, seed: int,
              device, offsets=(None, None, None), out_dtype=None):
    """K2's (``kernel`` "dq", ``fa.flash_bwd_dq``) or K3's ("dkv",
    ``fa.flash_bwd_dkv``) probe on tile ``tile``, offsets None meaning plain
    flash's identity: (the read-back tensor, what a kept live element reads
    there, dk or None). In dq that value is bf16(scale / (1 - rate)) with
    scale 1/8 (Dh 64), a power of two: bf16(1 / (1 - rate)) / 8 exactly."""
    z = torch.zeros(bh, s, DH, dtype=torch.bfloat16, device=device)
    stats = torch.zeros(bh, s, dtype=torch.float32, device=device)
    eye = z.clone()
    eye[:, tile * DH:(tile + 1) * DH] = torch.eye(DH, dtype=torch.bfloat16, device=device)
    if kernel == "dq":
        e0 = z.clone()
        e0[..., 0] = 1.0
        dq = fa.flash_bwd_dq(z, eye, e0, e0, stats, stats, causal, rate, seed, *offsets,
                             out_dtype=out_dtype)
        return dq, kept_value(rate) / 8.0, None
    dk, dv = fa.flash_bwd_dkv(z, z, z, eye, stats, stats, causal, rate, seed, *offsets,
                              out_dtype=out_dtype)
    return dv, kept_value(rate), dk


def bwd_coords(kernel: str, qoff, koff, tile: int, device):
    """(rows, cols, transposed) of a backward probe's read-back: dq reads
    every q row against the key tile's columns; dv reads the q tile's rows
    against every key, transposed (keys along dv's rows)."""
    rows, tile_cols, cols = coords(qoff, koff, tile, device)
    if kernel == "dq":
        return rows, tile_cols, False
    return rows[tile * DH:(tile + 1) * DH], cols, True
