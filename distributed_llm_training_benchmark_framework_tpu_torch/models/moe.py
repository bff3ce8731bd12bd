"""Mixture-of-Experts MLP: top-k routing with capacity, the dispatch, the
Switch load-balance statistics, and expert parallelism over the process
group.

Port of ``distributed_llm_training_benchmark_framework_tpu/models/moe.py``
(``capacity``, ``_route``, ``_expert_ffn``, ``_aux_stats``, the einsum and
all-to-all formulations and the selector ``moe_mlp``). The routing math is
JAX's, cast for cast:

- router logits are fp32: the tokens in the compute dtype, upcast, times
  the fp32 router, one ``aten.mm`` on 2-D operands (remat "dots" keeps it,
  as JAX's ``dots_with_no_batch_dims_saveable`` keeps the einsum);
- softmax in fp32; the top k experts of each token by probability, ties to
  the lower expert index (``jax.lax.top_k``'s order: a stable descending
  sort, where ``torch.topk`` promises none); the chosen gates renormalised
  by ``max(sum, 1e-9)``;
- each (token, choice) takes the next slot of its expert, counted in
  token-major, choice-major order; a position at or past the capacity C is
  dropped (combine weight 0; a token whose every choice drops adds nothing,
  and only the residual carries it). ``drop_frac`` is the dropped share of
  the assignments;
- the combine weights are the gates rounded to the compute dtype, and the
  output is their fp32 sum of the expert outputs, rounded once;
- the expert FFN rounds each product to the compute dtype and adds the
  bias there, with exact-erf GELU between.

Two forms compute the layer. :func:`moe_mlp_plain` is JAX's
``_moe_mlp_einsum`` in torch, the one-hot (N, E, C) dispatch and combine
tensors and two dense einsums: the plain version the tests hold the main
path to. :func:`moe_mlp` is the main path: it gathers each kept token into
its (expert, slot) row of an (E, C, D) buffer and gathers the expert
outputs back by index, never forming the (N, E, C) one-hot, whose two
einsums cost N*E*C*D multiply-adds each (about half the expert FFN at the
1.18B row's shape). Each slot holds one token and the combine sums at most
k exact products, so the two forms give the same output bit for bit when
the products are exact (bf16 operands, k 2).

Over the process group (``ExpertGroups``):

- **expert width ep > 1** (JAX's ``_moe_mlp_a2a``): the batch is sharded
  over (data, expert) and each member routes its own tokens with a
  per-member capacity; the (E, C, D) buffer goes out by one all-to-all over
  the ``expert`` group, the member's E/ep experts run on (E/ep, ep*C, D),
  and one all-to-all brings it back. Both hops are ``_AllToAll``, whose
  backward is the reverse exchange. ``f``, ``p`` and ``drop_frac`` are
  averaged over the token-sharding ranks (``lax.pmean``);
- **expert width 1 with data > 1**: JAX routes the global micro-batch under
  GSPMD, with C = capacity(global N) and positions counted over every data
  rank's tokens in global row order. Each rank therefore offsets its
  positions by the assignments of the data ranks before it (an all-gather
  of per-expert counts) and averages ``f``, ``p`` and ``drop_frac`` over the
  data group, so every rank drops what JAX drops.

The averaged ``p`` is a differentiable all-reduce whose backward is the
same average of the gradients: each rank's loss holds E * sum(f * p), and
the arm's mean over ranks then gives the gradient of the global statistic
(a detached average would be off by the group's size).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

DISPATCH_MODES = ("auto", "alltoall", "einsum")
AUX_MODES = ("switch", "overflow")


def capacity(n_tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    c = int(factor * top_k * n_tokens / n_experts + 0.999)
    return max(c, top_k)


@dataclasses.dataclass(frozen=True)
class ExpertGroups:
    """Where a MoE layer's tokens and experts sit over the process group.

    ``ep``: the ``expert`` width; ``expert_group``: the ep ranks of one
    ``data`` index (the all-to-all's); ``stat_group``: the ranks whose
    tokens make up the routed batch, over which ``f``, ``p`` and
    ``drop_frac`` are averaged; ``offset_group``: at ep 1 over ``data`` > 1,
    the data ranks in row order, over which positions and capacity are
    global. All None: one process routes its own tokens, as JAX on one
    device."""

    ep: int = 1
    expert_group: Optional[dist.ProcessGroup] = None
    stat_group: Optional[dist.ProcessGroup] = None
    offset_group: Optional[dist.ProcessGroup] = None


class Route(NamedTuple):
    probs: torch.Tensor       # (N, E) fp32 router probabilities
    expert_idx: torch.Tensor  # (N, K) chosen experts, best first
    gates: torch.Tensor       # (N, K) fp32, renormalised
    slot: torch.Tensor        # (N, K) this rank's position in its expert's buffer
    keep: torch.Tensor        # (N, K) bool: position < capacity
    drop_frac: torch.Tensor   # fp32 scalar: dropped share of the assignments


class _AllToAll(torch.autograd.Function):
    """Equal blocks of dim 0 to each rank of ``group``; the backward sends
    the gradient's blocks back the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


class _MeanOver(torch.autograd.Function):
    """The mean over ``group``, forward and backward (a differentiable
    ``lax.pmean``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g / dist.get_world_size(ctx.group), None


def _mean_over(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    return x if group is None else _MeanOver.apply(x, group)


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest, ties to the lower index (a stable
    descending sort keeps equal values in index order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def route(xt: torch.Tensor, router: torch.Tensor, top_k: int, cap: int,
          offset_group: Optional[dist.ProcessGroup] = None) -> Route:
    """JAX's ``_route`` on this rank's tokens ``xt`` (N, D), capacity
    ``cap``; with ``offset_group``, positions count the assignments of the
    group's lower ranks first (global routing over the group's rows)."""
    N, E = xt.shape[0], router.shape[1]
    logits = torch.mm(xt.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, top_k)
    gates = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    onehot = F.one_hot(expert_idx, E)  # (N, K, E)
    flat = onehot.reshape(N * top_k, E)
    # Prior assignments per expert: a scan along the N*K assignments, run on
    # the transposed (E, N*K) copy (down the rows of (N*K, E) a CUDA scan
    # has only E columns to spread over: 0.67 ms per call at the 1.18B row's
    # layer on an H100, chip_smoke.py phase 18).
    prior = flat.t().contiguous().cumsum(1).t() - flat
    slot = (prior.reshape(N, top_k, E) * onehot).sum(-1)
    pos = slot
    if offset_group is not None:
        counts = flat.sum(0)
        every = torch.empty(dist.get_world_size(offset_group) * E, dtype=counts.dtype,
                            device=counts.device)
        dist.all_gather_into_tensor(every, counts, group=offset_group)
        before = every.view(-1, E)[:dist.get_rank(offset_group)].sum(0)
        pos = slot + before[expert_idx]
    keep = pos < cap
    drop_frac = (1.0 - keep.float()).mean()
    return Route(probs, expert_idx, gates, slot, keep, drop_frac)


def expert_ffn(xin: torch.Tensor, w1, b1, w2, b2, cd: torch.dtype) -> torch.Tensor:
    """JAX's ``_expert_ffn``: (E', C', D) -> (E', C', D), batched over the
    experts, each product rounded to ``cd`` and its bias added there."""
    h = torch.bmm(xin, w1.to(cd)) + b1.to(cd)[:, None, :]
    h = F.gelu(h)  # exact erf
    return torch.bmm(h, w2.to(cd)) + b2.to(cd)[:, None, :]


def aux_stats(probs: torch.Tensor, expert_idx: torch.Tensor, n_experts: int):
    """Switch statistics on the top-1 assignment -> (f, p), each (E,)."""
    f = F.one_hot(expert_idx[:, 0], n_experts).float().mean(0)
    return f, probs.mean(0)


def _aux(r: Route, n_experts: int, mode: str, group: Optional[dist.ProcessGroup]):
    if mode == "overflow":
        return r.drop_frac if group is None else _mean_over(r.drop_frac.detach(), group)
    f, p = aux_stats(r.probs, r.expert_idx, n_experts)
    if group is not None:
        f = _mean_over(f.detach(), group)
        p = _mean_over(p, group)
    return n_experts * (f * p).sum()


def plain_dispatch(r: Route, n_experts: int, cap: int, dtype: torch.dtype):
    """JAX's one-hot (N, E, C) dispatch and combine tensors in ``dtype``."""
    disp = (F.one_hot(r.expert_idx, n_experts).to(dtype)[:, :, :, None]
            * F.one_hot(torch.where(r.keep, r.slot, cap), cap + 1).to(dtype)[:, :, None, :cap])
    return disp.sum(1), (disp * r.gates.to(dtype)[:, :, None, None]).sum(1)


def moe_mlp_plain(c, x: torch.Tensor, router, w1, b1, w2, b2,
                  aux_mode: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``_moe_mlp_einsum`` (without its dropout, which the block
    applies) in one process: (B, S, D) -> (output, aux)."""
    B, S, D = x.shape
    N, E, cd = B * S, c.n_experts, c.compute_dtype
    cap = capacity(N, E, c.expert_top_k, c.capacity_factor)
    xt = x.reshape(N, D)
    r = route(xt, router, c.expert_top_k, cap)
    dispatch, combine = plain_dispatch(r, E, cap, xt.dtype)
    xin = torch.einsum("nd,nec->ecd", xt.float(), dispatch.float()).to(cd)
    out = expert_ffn(xin, w1, b1, w2, b2, cd)
    y = torch.einsum("ecd,nec->nd", out.float(), combine.float()).to(x.dtype)
    return y.reshape(B, S, D), _aux(r, E, aux_mode or c.moe_aux_mode, None)


def _dispatch(xt: torch.Tensor, r: Route, n_experts: int, cap: int) -> torch.Tensor:
    """Each kept (token, choice) into row e*C + slot of an (E, C, D) buffer;
    dropped ones into a spare last row, cut off."""
    N, K = r.slot.shape
    D = xt.shape[1]
    rows = torch.where(r.keep, r.expert_idx * cap + r.slot, n_experts * cap).reshape(N * K)
    src = xt[:, None, :].expand(N, K, D).reshape(N * K, D)
    buf = xt.new_zeros(n_experts * cap + 1, D).index_add(0, rows, src)
    return buf[:-1].view(n_experts, cap, D)


def _combine(out: torch.Tensor, r: Route, cap: int, dtype: torch.dtype) -> torch.Tensor:
    """sum_k gate_k * out[e_k, slot_k] in fp32 (gates rounded to the
    compute dtype, dropped choices weighted 0), rounded to ``dtype``."""
    N, K = r.slot.shape
    rows = torch.where(r.keep, r.expert_idx * cap + r.slot, 0).reshape(N * K)
    picked = out.reshape(-1, out.shape[-1]).index_select(0, rows).view(N, K, -1).float()
    w = torch.where(r.keep, r.gates.to(out.dtype), 0).float()
    y = picked[:, 0] * w[:, 0, None]
    for k in range(1, K):
        y = y + picked[:, k] * w[:, k, None]
    return y.to(dtype)


def check_dispatch(c, groups: ExpertGroups) -> None:
    """JAX's selector's refusal: ``moe_dispatch`` "alltoall" needs an
    ``expert`` width > 1 dividing the experts; "einsum" (global routing
    over every token-sharding rank) is not ported at ep > 1."""
    if c.moe_dispatch == "alltoall" and not (groups.ep > 1 and c.n_experts % groups.ep == 0):
        raise ValueError(
            "moe_dispatch='alltoall' needs an in-scope mesh with a >1 'expert' axis, "
            f"n_experts % ep == 0, batch % (dp*ep) == 0, and no model/seq/pipe axes > 1 "
            f"(got expert width {groups.ep}, n_experts {c.n_experts})")
    if c.moe_dispatch == "einsum" and groups.ep > 1:
        raise ValueError(
            "moe_dispatch='einsum' at expert width > 1 (routing the tokens of every "
            "(data, expert) member together) is not ported; use 'auto' or 'alltoall' "
            "(ROADMAP Queue 1 item 12)")


def moe_mlp(c, x: torch.Tensor, router: torch.Tensor, ffn: Callable[[torch.Tensor], torch.Tensor],
            groups: ExpertGroups = ExpertGroups(),
            aux_mode: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE layer on this rank's tokens x (B, S, D) -> (output, aux):
    index dispatch, ``ffn`` over this rank's experts ((E/ep, ep*C, D) ->
    same), index combine; the all-to-all hops at ep > 1 (see the module
    docstring). ``aux_mode`` None: the config's."""
    B, S, D = x.shape
    N, E, ep = B * S, c.n_experts, groups.ep
    check_dispatch(c, groups)
    rows = dist.get_world_size(groups.offset_group) if groups.offset_group is not None else 1
    cap = capacity(N * rows, E, c.expert_top_k, c.capacity_factor)
    xt = x.reshape(N, D)
    r = route(xt, router, c.expert_top_k, cap, groups.offset_group)
    xin = _dispatch(xt, r, E, cap)
    if ep == 1:
        out = ffn(xin)
    else:
        e_loc = E // ep
        xin = _AllToAll.apply(xin.reshape(ep, e_loc, cap, D), groups.expert_group)
        out = ffn(xin.transpose(0, 1).reshape(e_loc, ep * cap, D))
        out = out.reshape(e_loc, ep, cap, D).transpose(0, 1)
        out = _AllToAll.apply(out, groups.expert_group).reshape(E, cap, D)
    y = _combine(out, r, cap, x.dtype)
    return y.reshape(B, S, D), _aux(r, E, aux_mode or c.moe_aux_mode, groups.stat_group)
