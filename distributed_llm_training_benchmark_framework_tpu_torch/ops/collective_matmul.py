"""Collective matmul: the tensor-parallel projections' communication as a
point-to-point ring over the ``model`` group.

Port of ``distributed_llm_training_benchmark_framework_tpu/ops/collective_matmul.py``
(Wang et al., ASPLOS'23). The plain tensor-parallel layout keeps the
residual stream replicated over ``model`` and pays a bulk all-reduce after
each row-parallel projection (``parallel/tensor.py``). The collective-matmul
form changes the projection itself:

- the residual stream between projections rides SEQUENCE-sharded over
  ``model`` (norms, residual adds and dropout are elementwise over the
  feature dim, so they stay local);
- entering a column-parallel projection (attention q/k/v, MLP up), the
  sequence chunks rotate one hop per step around the ring while each hop's
  chunk feeds one partial product (:func:`ag_proj_sharded`): every rank ends
  with all S rows of its own feature columns;
- leaving a row-parallel projection (attention out, MLP down), an fp32
  accumulator rotates instead, each hop adding the partial product of the
  chunk its next owner keeps (:func:`rs_proj_sharded`), and lands on its
  chunk's owner with every partial folded in.

Each hop is ``batch_isend_irecv`` to the next rank of the group, the
partial products are fp32 (``torch.mm(..., out_dtype=torch.float32)`` on the
card, upcast operands elsewhere), and the result is cast once at the end, as
JAX's ``preferred_element_type`` products and fp32 accumulator do. The hops
are autograd functions (a send to the next rank, whose backward sends to
the previous one), so the backward is the transposed ring, as JAX derives
it through ``ppermute``. The products are library GEMMs, as they are
``einsum``s outside any Pallas kernel in JAX.

Two forms, as in JAX:

- :func:`ag_proj_sharded` / :func:`rs_proj_sharded` take this rank's chunk
  (or full rows) and its weight shard: the model's form
  (``models/tinygpt.py`` under ``tp_collective_matmul``);
- :func:`ag_proj` / :func:`rs_proj` take global activations and weights,
  run the ring on this rank's parts and return the global result (gathered
  over the group), or the plain product when ``group`` is None or of width
  1, or the sequence does not split over it: JAX's own inert behaviour
  without a ``model`` axis, not a device fallback. Their inputs and result
  are replicated over the group, as JAX's global arrays are one value: the
  gradients each rank gets are the whole function's. ``aligned_units``
  (``kv_heads`` for the GQA kv projection) keeps a weight whose features the
  width does not split by those units replicated, as the kv-head-aligned
  rule of ``parallel/strategies.py`` does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.tensor import all_gather_dim, copy_to_model


def _sendrecv(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` to the rank ``step`` ahead in ``group`` and return what the
    rank ``step`` behind sent."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    buf = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, (r + step) % n), group),
           dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, (r - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return buf


class _Hop(torch.autograd.Function):
    """One ring hop (JAX ``ppermute`` along j -> j+1); backward: j -> j-1."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sendrecv(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _sendrecv(g, ctx.group, -1), None


class MMF32(torch.autograd.Function):
    """bf16 x2d (M, K) times w (N, K) transposed -> fp32 (M, N) in one GEMM
    on the card: the forward of JAX's einsum(..., preferred_element_type=
    f32) without rounding to bf16. Its backward is two bf16 GEMMs on the
    bf16-rounded gradient (the overload with ``out_dtype`` has no autograd
    formula). The LM head (``models/tinygpt.py``) and the tensor-parallel
    products use it."""

    @staticmethod
    def forward(ctx, x2d, w):
        ctx.save_for_backward(x2d, w)
        return torch.mm(x2d, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2d, w = ctx.saved_tensors
        g = g.to(x2d.dtype)
        return torch.mm(g, w), torch.mm(g.t(), x2d)


def proj_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, ...) with fp32 products and sum, both operands in
    the compute dtype (JAX's einsum with ``preferred_element_type=f32``)."""
    w2d = w.reshape(w.shape[0], -1)
    lead = x.shape[:-1]
    if x.dtype == torch.float32:
        out = torch.matmul(x, w2d)
    elif x.device.type == "cuda":
        out = MMF32.apply(x.reshape(-1, x.shape[-1]), w2d.t()).reshape(*lead, -1)
    else:
        out = torch.matmul(x.float(), w2d.float())
    return out.reshape(*lead, *w.shape[1:])


def bmm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, M, K) @ w (E, K, N) -> fp32 (E, M, N), batched as ``proj_f32``
    (on the card one fp32-output GEMM per batch entry: the row-parallel
    ``moe_w2`` of each expert)."""
    if x.dtype == torch.float32:
        return torch.bmm(x, w)
    if x.device.type == "cuda":
        return torch.stack([MMF32.apply(x[e], w[e].t()) for e in range(x.shape[0])])
    return torch.bmm(x.float(), w.float())


def ag_proj_sharded(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """All-gather side: x (B, S/n, D), this rank's sequence chunk, and w
    (D, F_l) or (D, C, F_l), its feature shard -> (B, S, ..., F_l) in x's
    dtype: every row of the sequence for this rank's features, the chunks
    rotating around the ring."""
    n = dist.get_world_size(group)
    if n == 1:
        return proj_f32(x, w).to(x.dtype)
    idx = dist.get_rank(group)
    rows = [None] * n
    chunk = x
    for i in range(n):
        # After i hops along j -> j+1 this chunk came from rank (idx - i).
        rows[(idx - i) % n] = proj_f32(chunk, w)
        if i < n - 1:
            chunk = _Hop.apply(chunk, group)
    return torch.cat(rows, dim=1).to(x.dtype)


def rs_proj_sharded(y: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """Reduce-scatter side: y (B, S, F_l), every row of this rank's
    features, and w (F_l, D), its row shard -> (B, S/n, D) in y's dtype:
    this rank's chunk of the product summed over the group, in an fp32
    accumulator that rotates around the ring. At step i rank j adds chunk
    ``(j - i + n - 1) % n``, so each hop lands on the rank that adds the
    same chunk next, and after n - 1 hops on its owner (JAX's schedule)."""
    n = dist.get_world_size(group)
    if n == 1:
        return proj_f32(y, w).to(y.dtype)
    S = y.shape[1]
    if S % n:
        raise ValueError(f"rs_proj_sharded: sequence length {S} does not divide the "
                         f"'model' ring size {n}")
    idx, sl = dist.get_rank(group), S // n
    acc = None
    for i in range(n):
        ci = (idx - i + n - 1) % n
        part = proj_f32(y[:, ci * sl:(ci + 1) * sl], w)
        acc = part if acc is None else _Hop.apply(acc, group) + part
    return acc.to(y.dtype)


def _width(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _feature_sharded(w: torch.Tensor, n: int, aligned_units: Optional[int]) -> bool:
    """Whether w's last (feature) dim shards over n ranks: it must divide,
    and so must ``aligned_units`` (the kv-head-aligned rule)."""
    if w.shape[-1] % n:
        return False
    return aligned_units is None or aligned_units % n == 0


def ag_proj(x: torch.Tensor, w: torch.Tensor, group=None,
            aligned_units: Optional[int] = None) -> torch.Tensor:
    """Column-parallel projection of global x (B, S, D) by global w (D, F)
    or (D, C, F) -> the global (B, S, ..., F), through the ring on this
    rank's sequence chunk and feature shard (gathered back over the
    group); the plain product without a ``model`` group wider than 1 or
    when S does not split."""
    n = _width(group)
    if n == 1 or x.shape[1] % n:
        return proj_f32(x, w).to(x.dtype)
    r = dist.get_rank(group)
    x, w = copy_to_model(x, group), copy_to_model(w, group)
    chunk = x.chunk(n, dim=1)[r]
    if not _feature_sharded(w, n, aligned_units):
        # Every rank computes the whole output; each answers for its own
        # rows of it, so the gradient is counted once.
        out = ag_proj_sharded(chunk, w, group).chunk(n, dim=1)[r]
        return all_gather_dim(out, group, 1, sum_grads=False)
    out = ag_proj_sharded(chunk, w.chunk(n, dim=-1)[r], group)
    return all_gather_dim(out, group, out.dim() - 1, sum_grads=False)


def rs_proj(y: torch.Tensor, w: torch.Tensor, group=None) -> torch.Tensor:
    """Row-parallel projection of global y (B, S, F) by global w (F, D) ->
    the global (B, S, D), through the ring on this rank's feature shard
    (the chunks gathered back over the group); the plain product without a
    ``model`` group wider than 1, or when S or F does not split."""
    n = _width(group)
    if n == 1 or y.shape[1] % n or w.shape[0] % n:
        return proj_f32(y, w).to(y.dtype)
    r = dist.get_rank(group)
    y, w = copy_to_model(y, group), copy_to_model(w, group)
    out = rs_proj_sharded(y.chunk(n, dim=-1)[r], w.chunk(n, dim=0)[r], group)
    return all_gather_dim(out, group, 1, sum_grads=False)
