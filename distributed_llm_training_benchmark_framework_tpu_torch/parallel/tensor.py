"""Tensor parallelism's collectives over the ``model`` group, as autograd
functions.

The JAX package has no such module: it states the Megatron layout as
sharding specs (``parallel/strategies.py``, ``_TP_RULES``) and GSPMD derives
every collective the layout needs. The port holds each rank's shards as
ordinary tensors, so it issues them itself (Shoeybi et al. 2019, "f" and
"g"). They add no feature; each is what GSPMD inserts at the same place:

- :func:`copy_to_model` ("f"): identity forward, all-reduce (sum) of the
  gradient backward. It stands before each column-parallel projection: every
  rank reads the replicated stream, and each contributes the part of its
  gradient that its own columns see. It also wraps a replicated weight
  whose gradient each rank only sees a part of (a ``wkv`` that the
  ``model`` width does not split by kv heads; under the collective matmul,
  every leaf used on the sequence-sharded stream), so the gradient is summed
  over ``model`` once, in the backward.
- :func:`reduce_from_model` ("g"): all-reduce (sum) forward, identity
  backward, after each row-parallel projection. The callers reduce the fp32
  partial product and round to the compute dtype after it, as JAX's einsum
  keeps ``preferred_element_type=f32`` and GSPMD reduces its fp32 output.
- :func:`reduce_scatter_seq` / :func:`all_gather_seq`: the sequence-sharded
  stream of the collective matmul (``ops/collective_matmul.py``) enters and
  leaves the model: sum and keep this rank's columns / gather the columns;
  each is the other's backward.
- :func:`vocab_parallel_embedding`: a lookup into this rank's ``V/tp`` rows,
  zero for the tokens it does not own, summed over ``model``.
- :func:`vocab_parallel_cross_entropy`: the mean cross-entropy over this
  rank's fp32 logits of its ``V/tp`` vocabulary rows: all-reduce MAX of the
  row maxima, SUM of the exponentials and SUM of the gold logit (one rank
  owns each target); ``ignore_index`` -1 adds nothing on any rank. The
  backward needs no collective: each rank's logits get softmax - one-hot
  over its own rows.

The vocabulary-parallel pair runs without a ``pipe`` axis only: beside
``pipe`` JAX keeps ``wte`` / ``lm_head`` whole on every ``model`` rank, and
the model looks up and scores the whole vocabulary with no collective.

A remat recompute (``models/tinygpt.py``) runs a forward collective again,
with the same result; a gradient's all-reduce runs in the backward only,
once.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Sum over the group and keep this rank's block of ``dim`` (an
    all-reduce and a slice)."""
    full = x.contiguous().clone()
    dist.all_reduce(full, group=group)
    return full.chunk(dist.get_world_size(group), dim=dim)[dist.get_rank(group)].contiguous()


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, sum_grads):
        ctx.group, ctx.dim, ctx.sum_grads = group, dim, sum_grads
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grads:
            return _scatter(g, ctx.group, ctx.dim), None, None, None
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, dim=ctx.dim)[r].contiguous(), None, None, None


def copy_to_model(x: Optional[torch.Tensor],
                  group: Optional[dist.ProcessGroup]) -> Optional[torch.Tensor]:
    """"f": identity forward, gradient summed over ``group`` (None: x)."""
    return x if group is None or x is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """"g": x summed over ``group``, gradient passed as it is (None: x)."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def reduce_scatter_seq(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """(B, S, ...) partial sums -> this rank's (B, S/tp, ...) block of their sum."""
    return _ReduceScatter.apply(x, group, 1)


def all_gather_dim(x: torch.Tensor, group: dist.ProcessGroup, dim: int,
                   sum_grads: bool = True) -> torch.Tensor:
    """This rank's block of ``dim`` -> the whole, blocks in rank order; the
    backward sums the gradient over the group (each rank's consumer saw a
    part of it) and keeps this rank's block, or with ``sum_grads`` False
    only keeps the block (every rank's consumer is the same, replicated)."""
    return _AllGather.apply(x, group, dim, sum_grads)


def all_gather_seq(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """This rank's (B, S/tp, ...) block -> the (B, S, ...) whole, in rank order."""
    return all_gather_dim(x, group, 1)


def vocab_parallel_embedding(idx: torch.Tensor, w_local: torch.Tensor, v0: int,
                             group: dist.ProcessGroup, reduce: bool = True) -> torch.Tensor:
    """Rows of the embedding (V, D) for token ids ``idx``, from this rank's
    rows ``[v0, v0 + V/tp)`` in ``w_local``: zeros where another rank owns
    the token, summed over ``group`` (exact: one term is nonzero). With
    ``reduce`` False the partial lookup is returned unsummed (the caller
    reduces it another way)."""
    local = idx - v0
    owned = (local >= 0) & (local < w_local.shape[0])
    rows = w_local[torch.where(owned, local, 0)]
    rows = torch.where(owned[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                           device=rows.device))
    return reduce_from_model(rows, group) if reduce else rows


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, v0, group):
        Vl = logits.shape[-1]
        ctx.shape = logits.shape
        logits = logits.reshape(-1, Vl).float()
        targets = targets.reshape(-1)
        valid = targets != -1
        local = targets - v0
        owned = valid & (local >= 0) & (local < Vl)
        safe = torch.where(owned, local, 0)
        m = logits.amax(dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(logits - m[:, None])
        sumexp = e.sum(dim=-1)
        gold = torch.where(owned, logits.gather(1, safe[:, None].long())[:, 0], 0.0)
        stats = torch.stack((sumexp, gold))
        dist.all_reduce(stats, group=group)
        sumexp, gold = stats[0], stats[1]
        logz = m + torch.log(sumexp)
        count = valid.sum().clamp_min(1)
        loss = torch.where(valid, logz - gold, 0.0).sum() / count
        ctx.save_for_backward(e, sumexp, safe, owned, valid, count)
        return loss

    @staticmethod
    def backward(ctx, g):
        e, sumexp, safe, owned, valid, count = ctx.saved_tensors
        grad = e / sumexp[:, None]
        grad.scatter_add_(1, safe[:, None].long(),
                          -owned.to(grad.dtype)[:, None])
        grad = grad * (valid.to(grad.dtype) * (g / count))[:, None]
        return grad.reshape(ctx.shape), None, None, None


def vocab_parallel_cross_entropy(logits_local: torch.Tensor, targets: torch.Tensor, v0: int,
                                 group: dist.ProcessGroup) -> torch.Tensor:
    """Mean CE over positions where target != -1, from this rank's fp32
    logits ``(..., V/tp)`` of vocabulary rows ``[v0, v0 + V/tp)``: the
    same value on every rank of ``group``, and the gradient of this rank's
    logits."""
    return _VocabParallelCE.apply(logits_local, targets, v0, group)
