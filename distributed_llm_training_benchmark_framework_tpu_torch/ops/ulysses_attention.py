"""Ulysses sequence parallelism: all-to-all head redistribution around flash.

Port of ``distributed_llm_training_benchmark_framework_tpu/ops/ulysses_attention.py``
(the DeepSpeed-Ulysses construction; ring attention, ``ops/ring_attention.py``,
is the other sequence-parallel attention). With the sequence cut into n
shards, an all-to-all re-shards each of q, k and v from sequence-sharded
(B, S/n, H, Dh) to head-sharded (B, S, H/n, Dh). Each shard then runs the
ordinary flash attention (``ops/flash_attention.py``, the kernels K1-K3)
over the FULL sequence for its H/n heads, and a reverse all-to-all restores
the sequence sharding of the output. No attention arithmetic changes, so
this module adds no kernel: at rate 0 every head's output is flash's bit
for bit. It needs ``H % n == 0``.

Dropout: each attention shard runs flash on a per-shard seed
(:func:`_shard_seed`) folded from the shard's index over the mesh
(:func:`_global_shard_index`: the ``data`` index, then the ``model`` index,
each when its axis is wider than 1, then the ``seq`` index; under tensor
parallelism a rank holds H/tp heads and splits those over ``seq``), with
local batch*head ids from 0, as JAX
calls flash there with no offsets. The mask is therefore a pure function
of (seed, shard ids), unbiased and decorrelated across head groups and
batch shards, and NOT the mask flash draws on the whole sequence for the
same seed (ring attention keeps that property instead).

Two forms, as for the ring:

- :func:`ulysses_attention` takes full (B, S, H, Dh) tensors and holds all n
  shards in one process on their one device: JAX's tiled all-to-all hands
  head chunk g to seq index g, so head group g is shard g, and each group is
  one ``flash_attention`` call on (B, S, H/n, Dh) with its folded seed; the
  outputs are joined on the head axis.
- :func:`ulysses_attention_sharded` takes this rank's (B, S/n, H, Dh) shard
  of a ``torch.distributed`` ``seq`` group and exchanges it with
  ``all_to_all_single`` (an autograd function whose backward is the
  reverse exchange).
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .flash_attention import _M32, flash_attention

_GOLDEN = 0x9E3779B9


def _shard_seed(seed: int, shard: int) -> int:
    """Per-shard dropout seed: seed + (shard + 1) * 0x9E3779B9, in uint32."""
    return (int(seed) + (int(shard) + 1) * _GOLDEN) & _M32


def _global_shard_index(seq_index: int, seq_width: int, data_rank: int = 0,
                        data_width: int = 1, model_rank: int = 0, model_width: int = 1) -> int:
    """This attention shard's index over the mesh, JAX's flattening of
    (``batch_axis``, ``heads_axis``, ``seq``): ``(data_rank * model_width +
    model_rank) * n + seq_index``, the ``data`` and ``model`` axes folded in
    only when wider than 1 (JAX ``resolve_seq_mesh`` names them only then)."""
    idx = data_rank if data_width > 1 else 0
    if model_width > 1:
        idx = idx * model_width + model_rank
    return idx * seq_width + seq_index


def check_heads(H: int, n: int) -> None:
    """Refuse a head count that n shards cannot split, with JAX's message."""
    if H % n:
        raise ValueError(
            f"Ulysses needs heads % seq_parallel == 0, got H={H}, n={n} "
            "(use ring attention past the head count)"
        )


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all over a ``seq`` group of n ranks, (B, S/n, H, Dh)
    <-> (B, S, H/n, Dh): ``to_heads`` sends head chunk j to rank j and joins
    the received sequence shards in rank order; the other direction undoes
    it. Each is the other's backward."""

    @staticmethod
    def forward(ctx, x, group, to_heads: bool):
        ctx.group, ctx.to_heads = group, to_heads
        return _exchange(x, group, to_heads)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g.contiguous(), ctx.group, not ctx.to_heads), None, None


def _exchange(x: torch.Tensor, group, to_heads: bool) -> torch.Tensor:
    n = dist.get_world_size(group)
    if to_heads:
        B, Sl, H, D = x.shape
        # (n, B, Sl, H/n, D): chunk j goes to rank j.
        send = x.reshape(B, Sl, n, H // n, D).permute(2, 0, 1, 3, 4).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        # recv[j] is rank j's sequence shard of this rank's heads.
        return recv.permute(1, 0, 2, 3, 4).reshape(B, n * Sl, H // n, D)
    B, S, Hl, D = x.shape
    send = x.reshape(B, n, S // n, Hl, D).permute(1, 0, 2, 3, 4).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # recv[j] is this rank's sequence shard of rank j's heads.
    return recv.permute(1, 2, 0, 3, 4).reshape(B, S // n, n * Hl, D)


def ulysses_attention_sharded(q, k, v, group=None, causal: bool = False,
                              dropout_rate: float = 0.0, dropout_seed: Optional[int] = None,
                              batch_shard: Optional[Tuple[int, int]] = None,
                              head_shard: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Ulysses on this rank's (B, S/n, H, Dh) sequence shard, rank s of the
    ``seq`` ``group`` (default: the world) holding shard s -> this rank's
    (B, S/n, H, Dh) output shard (JAX ``ulysses_attention_sharded`` inside
    ``shard_map``). ``batch_shard`` is (this rank's ``data`` index, the
    ``data`` width) and ``head_shard`` (its ``model`` index, the ``model``
    width; H is then its H/tp heads), both folded into the dropout seed
    (None: no such axis). The seed is folded even at n = 1, as JAX folds it
    there."""
    n, s = dist.get_world_size(group), dist.get_rank(group)
    B, Sl, H, D = q.shape
    check_heads(H, n)
    qg, kg, vg = (_AllToAll.apply(t, group, True) for t in (q, k, v))
    seed, rate = None, 0.0
    if dropout_rate > 0.0 and dropout_seed is not None:
        data_rank, data_width = batch_shard if batch_shard is not None else (0, 1)
        model_rank, model_width = head_shard if head_shard is not None else (0, 1)
        seed = _shard_seed(int(dropout_seed) & _M32,
                           _global_shard_index(s, n, data_rank, data_width, model_rank,
                                               model_width))
        rate = dropout_rate
    out = flash_attention(qg, kg, vg, causal=causal, dropout_rate=rate, dropout_seed=seed)
    return _AllToAll.apply(out, group, False)


def ulysses_attention(q, k, v, causal: bool = False, dropout_rate: float = 0.0,
                      dropout_seed: Optional[int] = None, seq_shards: int = 1,
                      data_rank: int = 0, data_width: int = 1,
                      batch_offset: int = 0) -> torch.Tensor:
    """Ulysses over full (B, S, H, Dh) tensors -> (B, S, H, Dh), the
    ``seq_shards`` shards held in this process (JAX ``ulysses_attention``
    under a mesh whose ``seq`` axis has that width and whose ``data`` axis
    places these rows at ``data_rank`` of ``data_width``). With
    ``seq_shards == 1`` it is :func:`flash_attention` with no seed fold
    (keyed from the global batch index ``batch_offset`` of row 0), as JAX
    falls back without a ``seq`` axis. A rate > 0 without a seed warns and
    runs at rate 0, as JAX's does."""
    if seq_shards == 1:
        return flash_attention(q, k, v, causal=causal, dropout_rate=dropout_rate,
                               dropout_seed=dropout_seed, batch_offset=batch_offset)
    B, S, H, D = q.shape
    if seq_shards < 1 or S % seq_shards:
        raise ValueError(f"sequence length {S} does not split into seq_shards={seq_shards}")
    check_heads(H, seq_shards)
    if dropout_seed is None:
        if dropout_rate > 0.0:
            warnings.warn(
                "ulysses_attention: dropout_rate > 0 with dropout_seed=None; dropout is "
                "DISABLED (deterministic attention). Pass a uint32 dropout_seed to enable "
                "it.", stacklevel=2,
            )
        dropout_rate = 0.0
    Hg = H // seq_shards
    outs = []
    for g in range(seq_shards):
        heads = slice(g * Hg, (g + 1) * Hg)
        seed = None
        if dropout_rate > 0.0:
            seed = _shard_seed(int(dropout_seed) & _M32,
                               _global_shard_index(g, seq_shards, data_rank, data_width))
        outs.append(flash_attention(q[:, :, heads], k[:, :, heads], v[:, :, heads],
                                    causal=causal, dropout_rate=dropout_rate, dropout_seed=seed))
    return torch.cat(outs, dim=2)
