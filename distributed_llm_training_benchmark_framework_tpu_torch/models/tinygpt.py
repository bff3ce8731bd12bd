"""TinyGPT: the benchmark transformer, as ``nn.Module``s.

Port of ``distributed_llm_training_benchmark_framework_tpu/models/tinygpt.py``
(the forward path and the loss, per-layer remat, the dispatch to
sequence-parallel ring and Ulysses attention, and the Mixture-of-Experts MLP
of ``models/moe.py``). One config covers both families: the reference
TinyGPT (learned positions, LayerNorm, exact-erf GELU, biases, tied head,
non-causal, dropout 0.1) and, through ``models.llama``, the Llama family
(RMSNorm, RoPE, SwiGLU, GQA, no bias, untied head, causal).

Parameters keep the JAX leaf names and per-layer shapes, so ``bridge.py``
maps ``params["blocks"][leaf][i]`` to ``blocks.<i>.<leaf>`` one to one:
``wqkv`` (D, 3, D), ``wq`` (D, H*Dh), ``wkv`` (D, 2, Hkv*Dh), ``wo`` (D, D),
``wfc`` (D, F), ``wgu`` (D, 2, F), ``wproj`` (F, D), biases and norm scales.
With ``n_experts`` E > 0 (the GELU family only, as in JAX) every block's MLP
is the routed expert layer: the block holds ``router`` (D, E) and, in its
child module ``experts`` (kept apart so an arm can wrap the experts on a mesh
of their own), ``moe_w1`` (E, D, F), ``moe_b1`` (E, F), ``moe_w2`` (E, F, D)
and ``moe_b2`` (E, D), in place of ``wfc`` / ``bfc`` / ``wproj`` / ``bproj``;
the loss gains ``router_aux_coef`` times the Switch statistic averaged over
the layers. Under an ``expert`` axis of width ep a rank holds its E/ep
experts (``experts.<leaf>`` axis 0) and the layer exchanges tokens over the
``expert`` group (``models/moe.py``).

Numerics follow JAX's explicit casts (no ``torch.autocast``): parameters
are stored in ``config.param_dtype`` (fp32, or bf16 as JAX's
``param_dtype``) and cast to the compute dtype where they are used; the
residual stream is in the compute dtype; norm statistics, the softmax of the
reference attention, the logits and the loss are fp32.

Remat (``config.remat``, JAX's policies) wraps each block in
``torch.utils.checkpoint`` (non-reentrant): ``full`` recomputes the whole
block in the backward; ``dots`` keeps the outputs of the x @ W products
(``aten.mm`` / ``aten.addmm``, JAX's ``dots_with_no_batch_dims_saveable``)
and recomputes the rest, attention included. A block's MLP dropout mask is
drawn from its site seed before the block runs and passed in, so a
recompute reuses it (checkpoint restores only the default generators);
the attention mask is a hash of a host seed and needs nothing.

The LM head gives fp32 logits from bf16 operands without rounding them to
bf16. On a CUDA device it is one bf16 GEMM with fp32 output
(``torch.mm(..., out_dtype=torch.float32)``; its backward is two bf16 GEMMs
on the bf16-rounded logits gradient, since that overload has no autograd
formula). Elsewhere it upcasts the bf16 operands and multiplies in fp32.

Tensor parallelism (a ``model`` axis of width tp over the process group,
``parallel/mesh.py``) builds the model at its rank's local widths of the
Megatron layout (``parallel/strategies.py``'s rules): H/tp query heads, and
kv_heads/tp kv heads or, when tp does not divide kv_heads, all of them
(this rank takes its own query heads' k/v after the consecutive-block
repeat); F/tp MLP features; V/tp rows of ``wte`` / ``lm_head``. The stream
stays replicated over ``model``: "f" (``parallel/tensor.copy_to_model``)
before each column-parallel projection, and after each row-parallel one the
fp32 partial product summed over ``model`` ("g") and rounded once to the
compute dtype. The embedding is vocab-parallel and so is the loss;
``forward`` returns this rank's vocabulary slice of the logits. The
attention keys its dropout mask by global head ids (``head_offset``). With
``tp_collective_matmul`` the stream rides sequence-sharded over ``model``
between projections, which run as the rings of
``ops/collective_matmul.py``. At tp 1 none of this runs: the model is the
one above, operation for operation.

Pipeline parallelism (a ``pipe`` axis of width P over the process group,
``parallel/pipeline.py``) builds one stage: the blocks of its layers only,
the contiguous ``[s*L/P, (s+1)*L/P)`` under gpipe / 1f1b, or under the
interleaved schedule (``virtual_stages`` V) the chunks ``{v*P + s}`` of
``L/(P*V)`` layers each, in ``layer_permutation``'s order; ``blocks.<i>``
holds global layer ``layer_ids[i]``. The leaves outside the blocks are on
every stage, as JAX's ``pipeline_param_specs`` replicates them. A schedule
calls the model one unit at a time (``StageUnit``): ``embed``, a chunk's
blocks (``run_blocks``) and the final norm, head and loss (``head_loss``).
A unit's embedding and MLP dropout masks come from one seed per site and
micro-batch (``mask_seeds``: the embedding's, then layer l's at 1 + l), so
every schedule and every recompute of a unit draws the same masks, as JAX
folds the global layer into its key; the attention seeds are indexed by
global layer as well. The whole model's forward takes the same seeds.

Within a site, global batch row r draws its keep-mask at the full
sequence from a generator seeded ``row_seed(site seed, r)``, and keeps its
rank's columns of it in a buffer of their own. So a row's mask does not
depend on which rank draws it (every layout of one global batch draws the
same masks), and a rank draws and keeps only its own rows and columns: its
masks do not grow with ``data``, as JAX draws each device's shard only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..ops.collective_matmul import MMF32, ag_proj_sharded, proj_f32, rs_proj_sharded
from ..ops.flash_attention import (
    dropout_keep,
    dropout_threshold,
    flash_attention,
)
from ..ops.ring_attention import ring_attention, ring_attention_sharded
from ..ops.ulysses_attention import ulysses_attention, ulysses_attention_sharded
from ..parallel.interleaved import layer_permutation
from ..parallel.mesh import AXES, Mesh
from ..parallel.pipeline import StageUnit
from ..parallel.strategies import check_tp, expert_axis, kv_aligned, tp_axis
from ..parallel.tensor import (
    all_gather_seq,
    copy_to_model,
    reduce_from_model,
    reduce_scatter_seq,
    vocab_parallel_cross_entropy,
    vocab_parallel_embedding,
)
from .moe import AUX_MODES, DISPATCH_MODES, ExpertGroups, expert_ffn, moe_mlp

ATTENTION_IMPLS = ("reference", "flash", "ring", "ulysses")
REMAT_POLICIES = ("none", "dots", "full")


def normalize_remat(value) -> str:
    """Normalize a remat policy: accepts "none"/"dots"/"full" or a legacy
    bool (True = "full"). "auto" must be resolved
    (``utils.memory.resolve_auto_remat``) before it reaches the model."""
    if isinstance(value, bool):
        return "full" if value else "none"
    if value in REMAT_POLICIES:
        return value
    raise ValueError(
        f"invalid remat policy {value!r} (expected one of {REMAT_POLICIES}, "
        "a bool, or 'auto' resolved upstream)"
    )


@dataclasses.dataclass(frozen=True)
class TinyGPTConfig:
    """The fields of the JAX ``TinyGPTConfig`` that this path reads."""

    vocab_size: int = 32000
    n_embd: int = 768
    n_head: int = 12
    n_layer: int = 12
    block_size: int = 4096
    dropout: float = 0.1
    causal: bool = False
    attention_impl: str = "reference"
    compute_dtype: torch.dtype = torch.bfloat16
    # Storage dtype of every parameter (JAX's ``param_dtype``): fp32, or bf16
    # under a strategy's ``param_dtype`` "bf16" or host offload.
    param_dtype: torch.dtype = torch.float32
    norm: str = "layernorm"
    norm_eps: float = 1e-5
    pos_embed: str = "learned"
    rope_theta: float = 10000.0
    mlp_act: str = "gelu"
    mlp_hidden: Optional[int] = None
    n_kv_head: Optional[int] = None
    bias: bool = True
    tie_embeddings: bool = True
    # Zigzag causal load balancing of ring attention: None = auto (on for
    # causal rings with even shards), True = force, False = contiguous.
    ring_zigzag: Optional[bool] = None
    # Per-layer rematerialization policy (REMAT_POLICIES, or a bool).
    remat: object = "none"
    # Collective-matmul tensor parallelism (ops/collective_matmul.py): the
    # stream rides sequence-sharded over 'model' between projections; inert
    # at 'model' width 1.
    tp_collective_matmul: bool = False
    # Mixture-of-Experts MLP (0 = dense; models/moe.py), JAX's fields and
    # defaults: experts, top-k, capacity factor, the aux loss coefficient,
    # the aux channel ('switch' or 'overflow') and the dispatch ('auto',
    # 'alltoall', 'einsum').
    n_experts: int = 0
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_aux_mode: str = "switch"
    moe_dispatch: str = "auto"

    @property
    def head_dim(self) -> int:
        if self.n_embd % self.n_head:
            raise ValueError(f"n_embd={self.n_embd} not divisible by n_head={self.n_head}")
        return self.n_embd // self.n_head

    @property
    def kv_heads(self) -> int:
        return self.n_kv_head if self.n_kv_head is not None else self.n_head

    @property
    def mlp_dim(self) -> int:
        return self.mlp_hidden if self.mlp_hidden is not None else 4 * self.n_embd

    def __post_init__(self):
        if self.norm not in ("layernorm", "rmsnorm"):
            raise ValueError(f"norm must be 'layernorm'|'rmsnorm', got {self.norm!r}")
        if self.pos_embed not in ("learned", "rope"):
            raise ValueError(f"pos_embed must be 'learned'|'rope', got {self.pos_embed!r}")
        if self.mlp_act not in ("gelu", "swiglu"):
            raise ValueError(f"mlp_act must be 'gelu'|'swiglu', got {self.mlp_act!r}")
        if self.n_kv_head is not None and self.n_head % self.n_kv_head != 0:
            raise ValueError(f"n_kv_head={self.n_kv_head} must divide n_head={self.n_head}")
        if self.n_experts > 0 and self.mlp_act != "gelu":
            raise ValueError(
                "MoE blocks are defined for the dense-GELU MLP only "
                "(n_experts > 0 with mlp_act='swiglu' is not supported)"
            )
        if self.moe_aux_mode not in AUX_MODES:
            raise ValueError(f"moe_aux_mode must be one of {AUX_MODES}, got {self.moe_aux_mode!r}")
        if self.moe_dispatch not in DISPATCH_MODES:
            raise ValueError(
                f"moe_dispatch must be one of {DISPATCH_MODES}, got {self.moe_dispatch!r}")
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(
                f"attention_impl must be one of {ATTENTION_IMPLS}, got {self.attention_impl!r}"
            )


# Tier table of the reference TinyGPT (JAX models/tinygpt.py get_model_config).
TIERS = {
    "A": dict(vocab_size=32000, n_embd=1024, n_head=16, n_layer=16),  # ~236M
    "B": dict(vocab_size=32000, n_embd=2048, n_head=32, n_layer=32),  # ~1.68B
    "S": dict(vocab_size=512, n_embd=128, n_head=4, n_layer=2),       # CPU tests
}


def get_model_config(tier: str, seq_len: int, **overrides) -> TinyGPTConfig:
    """Tier table; ``block_size = seq_len`` as in the reference."""
    if tier not in TIERS:
        raise ValueError(f"Unknown tier: {tier!r} (expected one of {sorted(TIERS)})")
    kw = dict(TIERS[tier], block_size=seq_len)
    kw.update(overrides)
    return TinyGPTConfig(**kw)


# ---------------------------------------------------------------------------
# Functional pieces (same names and math as the JAX module)
# ---------------------------------------------------------------------------


def _layer_norm(x, scale, bias, eps):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)  # population variance
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _rms_norm(x, scale, eps):
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def _rope(x: torch.Tensor, theta: float, offset: int = 0) -> torch.Tensor:
    """Rotary embedding, rotate-half convention, fp32 math; x (B, S, H, Dh)
    holds the positions [offset, offset + S) of the sequence."""
    S, Dh = x.shape[1], x.shape[-1]
    half = Dh // 2
    inv_freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device)
                                * 2.0 / Dh))
    pos = torch.arange(offset, offset + S, dtype=torch.float32, device=x.device)
    freqs = pos[:, None] * inv_freq[None, :]
    cos = torch.cos(freqs)[None, :, None, :]
    sin = torch.sin(freqs)[None, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat((x1 * cos - x2 * sin, x2 * cos + x1 * sin), dim=-1).to(x.dtype)


_M64 = (1 << 64) - 1


def row_seed(seed: int, row: int) -> int:
    """The generator seed of global batch row ``row`` at a dropout site
    seeded ``seed``: splitmix64's finalizer over seed + (row + 1) times the
    golden ratio, cut to 63 bits."""
    z = (seed + (row + 1) * 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 1


def draw_mask_seeds(generator: torch.Generator, n_layer: int) -> List[int]:
    """One site seed each for the embedding and the ``n_layer`` MLPs (layer
    l's at 1 + l), drawn from ``generator`` (a device generator's draw is
    read back to the host)."""
    return torch.randint(0, 2**62, (n_layer + 1,), generator=generator,
                         device=generator.device, dtype=torch.int64).tolist()


def _dropout_mask(seed: Optional[int], rate: float, rows: range, row_shape: Tuple[int, ...],
                  cols: slice, device) -> Optional[torch.Tensor]:
    """Keep mask of inverted dropout for the global batch rows ``rows`` of
    the site seeded ``seed`` (None: no dropout), shape (len(rows), the
    columns ``cols`` of ``row_shape[0]``, *row_shape[1:]). Row r is drawn at
    ``row_shape`` (the full sequence) from a generator seeded
    ``row_seed(seed, r)`` and its window written into a buffer of exactly
    the kept size, so no kept mask holds a larger storage alive."""
    if rate == 0.0 or seed is None:
        return None
    n_cols = len(range(row_shape[0])[cols])
    keep = torch.empty((len(rows), n_cols, *row_shape[1:]), dtype=torch.bool, device=device)
    for i, r in enumerate(rows):
        gen = torch.Generator(device=device).manual_seed(row_seed(seed, r))
        torch.lt(torch.rand(row_shape, generator=gen, device=device)[cols], 1.0 - rate,
                 out=keep[i])
    return keep


def _apply_dropout(x: torch.Tensor, mask: Optional[torch.Tensor], rate: float):
    if mask is None:
        return x
    keep = 1.0 - rate
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def reference_attention(q, k, v, causal: bool = False, dropout_rate: float = 0.0,
                        dropout_seed: Optional[int] = None, batch_offset: int = 0,
                        head_offset: int = 0, n_heads: Optional[int] = None) -> torch.Tensor:
    """Materialized softmax(q k^T / sqrt(Dh)) v with fp32 softmax, (B, S, H, Dh).

    Attention-probability dropout uses the flash kernels' coordinate-hash mask
    for ``dropout_seed`` (the JAX 'reference' path draws a bernoulli mask from
    its own key, which no torch generator reproduces), keyed from the global
    batch index ``batch_offset`` of row 0 and, under tensor parallelism, the
    global index ``head_offset`` of head 0 of ``n_heads``, as in flash."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    S = q.shape[1]
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0 and dropout_seed is not None:
        B, H = q.shape[0], q.shape[2]
        n = H if n_heads is None else n_heads
        idx = torch.arange(S, dtype=torch.int64, device=q.device)
        bh = ((batch_offset + torch.arange(B, dtype=torch.int64, device=q.device))[:, None] * n
              + head_offset
              + torch.arange(H, dtype=torch.int64, device=q.device)[None, :]).reshape(B * H)
        keep = dropout_keep(int(dropout_seed), bh[:, None, None],
                            idx[None, :, None], idx[None, None, :],
                            dropout_threshold(dropout_rate)).reshape(B, H, S, S)
        probs = torch.where(keep, probs / (1.0 - dropout_rate), 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


def _logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 logits (B, S, V) from x (B, S, D) and head w (V, D), both in the
    compute dtype (see the module docstring)."""
    B, S, D = x.shape
    if x.dtype == torch.float32:
        return torch.matmul(x, w.t())
    if x.device.type == "cuda":
        return MMF32.apply(x.reshape(B * S, D), w).reshape(B, S, -1)
    return torch.matmul(x.float(), w.float().t())


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE over positions where target != -1 (ignore_index=-1)."""
    V = logits.shape[-1]
    logits = logits.reshape(-1, V).float()
    targets = targets.reshape(-1)
    valid = targets != -1
    safe = torch.where(valid, targets, 0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, safe[:, None].long())[:, 0]
    nll = torch.where(valid, logz - gold, 0.0)
    return nll.sum() / valid.sum().clamp_min(1)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

AttentionFn = Callable[..., torch.Tensor]


def _param(dtype: torch.dtype, *shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=dtype))


class Experts(nn.Module):
    """This rank's E/ep experts of one layer (the JAX leaves ``moe_w1``,
    ``moe_b1``, ``moe_w2``, ``moe_b2``); ``forward`` is the expert FFN over
    their (E/ep, C', D) buffer."""

    def __init__(self, c: TinyGPTConfig, n_local: int):
        super().__init__()
        D, Fm, pd = c.n_embd, c.mlp_dim, c.param_dtype
        self.cd = c.compute_dtype
        self.moe_w1, self.moe_b1 = _param(pd, n_local, D, Fm), _param(pd, n_local, Fm)
        self.moe_w2, self.moe_b2 = _param(pd, n_local, Fm, D), _param(pd, n_local, D)

    def forward(self, xin: torch.Tensor) -> torch.Tensor:
        return expert_ffn(xin, self.moe_w1, self.moe_b1, self.moe_w2, self.moe_b2, self.cd)


class Block(nn.Module):
    """One pre-norm transformer layer holding the JAX leaves of its slice, at
    this ``model`` rank's local widths under tensor parallelism (``tp``:
    (index, width); ``group``: the ``model`` group, None at width 1) and its
    experts under an ``expert`` axis (``moe``: the layer's groups).
    ``forward`` returns the stream, and with experts (stream, aux)."""

    def __init__(self, c: TinyGPTConfig, tp: Tuple[int, int] = (0, 1),
                 group: Optional[torch.distributed.ProcessGroup] = None,
                 moe: ExpertGroups = ExpertGroups(), layer_id: int = 0):
        super().__init__()
        self.moe = moe
        self.layer_id = layer_id  # the global layer this block is
        self.c = c
        m, t = tp
        self.group = group
        self.cmm = c.tp_collective_matmul and t > 1
        D, H, Hkv, Dh, Fm = c.n_embd, c.n_head, c.kv_heads, c.head_dim, c.mlp_dim
        # Local widths: query heads, their first global index, kv heads.
        self.n_head, self.head0 = H // t, m * (H // t)
        self.kv_sharded = kv_aligned(Hkv, t)
        self.n_kv = Hkv // t if self.kv_sharded else Hkv
        Dl, Fl = self.n_head * Dh, Fm // t
        pd = c.param_dtype
        self.ln1_scale, self.ln2_scale = _param(pd, D), _param(pd, D)
        if c.norm == "layernorm":
            self.ln1_bias, self.ln2_bias = _param(pd, D), _param(pd, D)
        if Hkv == H:
            self.wqkv = _param(pd, D, 3, Dl)
            if c.bias:
                self.bqkv = _param(pd, 3, Dl)
        else:
            self.wq = _param(pd, D, Dl)
            self.wkv = _param(pd, D, 2, self.n_kv * Dh)
            if c.bias:
                self.bq = _param(pd, Dl)
                self.bkv = _param(pd, 2, self.n_kv * Dh)
        self.wo = _param(pd, Dl, D)
        if c.bias:
            self.bo = _param(pd, D)
        if c.n_experts > 0:
            self.router = _param(pd, D, c.n_experts)
            self.experts = Experts(c, c.n_experts // moe.ep)
            return
        if c.mlp_act == "swiglu":
            self.wgu = _param(pd, D, 2, Fl)
            if c.bias:
                self.bgu = _param(pd, 2, Fl)
        else:
            self.wfc = _param(pd, D, Fl)
            if c.bias:
                self.bfc = _param(pd, Fl)
        self.wproj = _param(pd, Fl, D)
        if c.bias:
            self.bproj = _param(pd, D)

    def _rep(self, p: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """A leaf replicated over ``model`` and used on the sequence-sharded
        stream of the collective matmul, where each rank sees part of its
        gradient: summed over ``model`` in the backward (else p itself)."""
        return copy_to_model(p, self.group) if self.cmm and p is not None else p

    def _norm(self, x, which: str):
        c = self.c
        scale = self._rep(getattr(self, f"{which}_scale"))
        if c.norm == "rmsnorm":
            return _rms_norm(x, scale, c.norm_eps)
        return _layer_norm(x, scale, self._rep(getattr(self, f"{which}_bias")), c.norm_eps)

    def _proj(self, h, w, b=None):
        """h (..., K) @ w (K, ...) in the compute dtype, plus an optional bias."""
        cd = self.c.compute_dtype
        out = torch.matmul(h, w.reshape(w.shape[0], -1).to(cd))
        out = out.reshape(*h.shape[:-1], *w.shape[1:])
        return out if b is None else out + b.to(cd)

    def _col(self, h, w, b=None):
        """Column-parallel projection: the stream h (after "f") by this
        rank's output features, or, under the collective matmul, the ring
        over h's sequence chunks (full rows out)."""
        if not self.cmm:
            return self._proj(h, w, b)
        cd = self.c.compute_dtype
        out = ag_proj_sharded(h, w.to(cd), self.group)
        return out if b is None else out + b.to(cd)

    def _row(self, h, w, b=None):
        """Row-parallel projection by this rank's input features: the fp32
        partial product summed over ``model``, rounded once, plus the
        replicated bias; under the collective matmul the ring's reduce to
        this rank's sequence chunk. At ``model`` width 1, ``_proj``."""
        if self.group is None:
            return self._proj(h, w, b)
        cd = self.c.compute_dtype
        if self.cmm:
            out = rs_proj_sharded(h, w.to(cd), self.group)
        else:
            out = reduce_from_model(proj_f32(h, w.to(cd)), self.group).to(cd)
        b = self._rep(b)
        return out if b is None else out + b.to(cd)

    def forward(self, x, attention: AttentionFn, attn_seed: Optional[int],
                drop_mask: Optional[torch.Tensor], batch_offset: int = 0, pos_offset: int = 0,
                moe_aux_mode: Optional[str] = None):
        """One layer; ``drop_mask`` is the MLP dropout's keep mask (None: no
        dropout), ``batch_offset`` the global batch index of row 0 and
        ``pos_offset`` the global position of column 0; ``moe_aux_mode``
        None: the config's."""
        c = self.c
        B = x.shape[0]
        H, Dh = self.n_head, c.head_dim
        h = self._norm(x, "ln1")
        if not self.cmm:
            h = copy_to_model(h, self.group)
        if c.kv_heads == c.n_head:
            qkv = self._col(h, self.wqkv, getattr(self, "bqkv", None))  # (B, S, 3, H*Dh)
            S = qkv.shape[1]
            q, k, v = (qkv[:, :, i].reshape(B, S, H, Dh) for i in range(3))
        else:
            wkv, bkv = self.wkv, getattr(self, "bkv", None)
            if not self.kv_sharded:
                # Replicated over 'model', but each rank uses only its own
                # heads' k/v: the gradient is summed over 'model'.
                wkv, bkv = copy_to_model(wkv, self.group), copy_to_model(bkv, self.group)
            q = self._col(h, self.wq, getattr(self, "bq", None))
            kv = self._col(h, wkv, bkv)
            S = q.shape[1]
            q = q.reshape(B, S, H, Dh)
            k = kv[:, :, 0].reshape(B, S, self.n_kv, Dh)
            v = kv[:, :, 1].reshape(B, S, self.n_kv, Dh)
        if c.pos_embed == "rope":
            q, k = _rope(q, c.rope_theta, pos_offset), _rope(k, c.rope_theta, pos_offset)
        if c.kv_heads != c.n_head:
            rep = c.n_head // c.kv_heads
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
            if not self.kv_sharded and self.group is not None:
                k, v = (t[:, :, self.head0:self.head0 + H] for t in (k, v))
        rate = c.dropout if attn_seed is not None else 0.0
        attn = attention(q, k, v, causal=c.causal, dropout_rate=rate, dropout_seed=attn_seed,
                         batch_offset=batch_offset)
        x = x + self._row(attn.reshape(B, S, H * Dh), self.wo, getattr(self, "bo", None))

        h = self._norm(x, "ln2")
        if c.n_experts > 0:
            h, aux = moe_mlp(c, h, self.router, self.experts, self.moe, moe_aux_mode)
            return x + _apply_dropout(h, drop_mask, c.dropout), aux
        if not self.cmm:
            h = copy_to_model(h, self.group)
        if c.mlp_act == "swiglu":
            gu = self._col(h, self.wgu, getattr(self, "bgu", None))  # (B, S, 2, F)
            h = F.silu(gu[:, :, 0]) * gu[:, :, 1]
        else:
            h = F.gelu(self._col(h, self.wfc, getattr(self, "bfc", None)))  # exact erf
        h = self._row(h, self.wproj, getattr(self, "bproj", None))
        h = _apply_dropout(h, drop_mask, c.dropout)
        return x + h


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """Selective checkpoint policy of remat "dots": keep x @ W outputs."""
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(policy: str):
    if policy == "dots":
        return create_selective_checkpoint_contexts(_save_dots)
    return contextlib.nullcontext(), contextlib.nullcontext()


def _ulysses_group(q, k, v, causal, dropout_rate, dropout_seed, batch_offset, group,
                   batch_shard, head_shard):
    """Ulysses' group form under the blocks' attention signature: its mask is
    keyed by the seed folded from ``batch_shard`` and ``head_shard``, with no
    batch offset (JAX calls flash there with none)."""
    return ulysses_attention_sharded(q, k, v, group, causal, dropout_rate, dropout_seed,
                                     batch_shard, head_shard)


class TinyGPT(nn.Module):
    """Embedding (+ learned positions) -> blocks -> final norm -> LM head.

    ``mesh`` gives the width of the ``seq`` axis that ring and Ulysses
    attention shard the sequence over (None: width 1, where both are flash,
    as in JAX without a ``seq`` axis). When ``seq`` rides the process group
    (``Mesh.seq_in_process`` false), this rank's forward runs on its
    contiguous columns ``[s*S/n, (s+1)*S/n)`` of the sequence, s its ``seq``
    index: positions (learned, or RoPE's) are global, and the attention
    exchanges blocks over the ``seq`` group; the zigzag layout of a causal
    ring stays inside the ring. Otherwise all n shards run in this process
    on full-length activations. A ``model`` axis of width tp > 1 builds this
    rank's shards of the Megatron layout (see the module docstring), an
    ``expert`` axis of width ep > 1 this rank's E/ep experts of each
    layer; a ``pipe`` axis this rank's stage (see the module docstring),
    ``virtual_stages`` chunks of it (1 but under the interleaved
    schedule)."""

    def __init__(self, config: TinyGPTConfig, mesh: Optional[Mesh] = None,
                 virtual_stages: int = 1):
        super().__init__()
        c = self.config = config
        m, t = mesh.model_shard if mesh is not None else (0, 1)
        if t > 1:
            check_tp(c, t)
        s, pp = mesh.pipe_shard if mesh is not None else (0, 1)
        self.pipe = (s, pp)
        if c.n_layer % pp:
            raise ValueError(f"n_layer={c.n_layer} not divisible by pipe={pp}")
        per_stage = c.n_layer // pp
        # Global layer of each local block (layer_permutation's rows of this
        # stage: contiguous at one chunk); ``chunk`` v is blocks [v*Lc, (v+1)*Lc).
        self.layer_ids = [int(g) for g in layer_permutation(c.n_layer, pp, virtual_stages)[
            s * per_stage:(s + 1) * per_stage]]
        self.chunk_layers = per_stage // virtual_stages
        self.tp, self.model_group = (m, t), (mesh.model_group if t > 1 else None)
        self.cmm = c.tp_collective_matmul and t > 1
        self.ep = mesh.expert_shard if mesh is not None else (0, 1)
        moe = _expert_groups(c, mesh)
        self.expert_group = moe.expert_group
        D, V, pd = c.n_embd, c.vocab_size, c.param_dtype
        self.wte = _param(pd, V // t, D)
        if c.pos_embed == "learned":
            self.wpe = _param(pd, c.block_size, D)
        self.blocks = nn.ModuleList(Block(c, self.tp, self.model_group, moe, g)
                                    for g in self.layer_ids)
        self.lnf_scale = _param(pd, D)
        if c.norm == "layernorm":
            self.lnf_bias = _param(pd, D)
        if not c.tie_embeddings:
            self.lm_head = _param(pd, V // t, D)
        # The attention every block calls; the config picks it. A check that
        # compares against another implementation assigns this attribute.
        self.attention: AttentionFn = reference_attention
        seq = mesh.size(AXES.seq) if mesh is not None else 1
        over_group = mesh is not None and not mesh.seq_in_process
        self.seq_shard = mesh.seq_shard if mesh is not None else (0, 1)
        # Under tensor parallelism the attention keys its mask by global heads.
        heads = dict(head_offset=m * (c.n_head // t), n_heads=c.n_head) if t > 1 else {}
        impl = c.attention_impl
        if t > 1 and seq == 1 and impl in ("ring", "ulysses"):
            impl = "flash"  # both are flash at seq width 1, as in JAX
        if impl == "flash":
            self.attention = (functools.partial(flash_attention, **heads) if heads
                              else flash_attention)
        elif impl == "reference" and heads:
            self.attention = functools.partial(reference_attention, **heads)
        elif impl == "ring" and over_group:
            self.attention = functools.partial(ring_attention_sharded, group=mesh.seq_group,
                                               zigzag=c.ring_zigzag, **heads)
        elif impl == "ring":
            self.attention = functools.partial(ring_attention, seq_shards=seq,
                                               zigzag=c.ring_zigzag)
        elif impl == "ulysses" and over_group:
            self.attention = functools.partial(
                _ulysses_group, group=mesh.seq_group,
                batch_shard=(mesh.data_rank, mesh.size(AXES.data)), head_shard=(m, t))
        elif impl == "ulysses":
            self.attention = functools.partial(ulysses_attention, seq_shards=seq)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "TinyGPT":
        """normal(0, 0.02) for matrices and embeddings, zeros for biases, ones
        for norm scales (the JAX init scheme; the values differ), drawn in
        fp32 and cast to the parameter dtype, as JAX's ``.astype``. A bias
        is a leaf whose name, less a ``moe_`` prefix, starts with ``b``
        (``bqkv``, ``moe_b1``, ...) or ends with ``_bias``. Under tensor or
        expert parallelism each leaf is drawn at its global shape and this
        rank keeps its shard, and a pipeline stage draws the whole model's
        leaves in the whole model's order and keeps its layers', so every
        layout of a seed holds the same weights."""
        (m, t), (e, ep) = self.tp, self.ep
        for name, p, shape in self._whole_model_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if p is None:
                if not (leaf.endswith("_scale") or leaf.removeprefix("moe_").startswith("b")
                        or leaf.endswith("_bias")):
                    torch.randn(shape, generator=generator, device=generator.device)
            elif leaf.endswith("_scale"):
                p.fill_(1.0)
            elif leaf.removeprefix("moe_").startswith("b") or leaf.endswith("_bias"):
                p.zero_()
            else:
                shards = [(tp_axis(name, self.config.kv_heads, t), m, t),
                          (expert_axis(name, ep), e, ep)]
                shards = [(ax, i, n) for ax, i, n in shards if ax is not None]
                shape = list(p.shape)
                for ax, _, n in shards:
                    shape[ax] *= n
                w = torch.randn(shape, generator=generator, device=generator.device) * 0.02
                for ax, i, n in shards:
                    w = w.chunk(n, dim=ax)[i]
                p.copy_(w)
        return self

    def _whole_model_parameters(self):
        """(name in the whole model, this rank's parameter or None, its
        shape) in the whole model's parameter order: this model's own at
        ``pipe`` width 1; a stage's blocks by their global layer ids."""
        if self.pipe[1] == 1:
            for name, p in self.named_parameters():
                yield name, p, p.shape
            return
        local = dict(self.named_parameters())
        where = {g: i for i, g in enumerate(self.layer_ids)}
        with torch.device("meta"):
            whole = TinyGPT(self.config)
        for name, w in whole.named_parameters():
            parts = name.split(".")
            if parts[0] == "blocks":
                i = where.get(int(parts[1]))
                p = None if i is None else local[".".join(["blocks", str(i), *parts[2:]])]
            else:
                p = local[name]
            yield name, p, w.shape

    def forward(
        self,
        idx: torch.Tensor,  # (B, S) token ids
        targets: Optional[torch.Tensor] = None,  # (B, S), -1 = ignore
        *,
        attn_seeds: Optional[Sequence[int]] = None,
        mask_seeds: Optional[Sequence[int]] = None,
        batch_offset: int = 0,
        global_batch: Optional[int] = None,
        unit: Optional[StageUnit] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """-> (fp32 logits (B, S, V), fp32 loss or None), over this rank's
        columns of the sequence when ``seq`` rides the group (the loss is
        then the mean over them); under tensor parallelism the logits are
        this rank's vocabulary rows ``[m*V/tp, (m+1)*V/tp)`` only, (B, S,
        V/tp), and the loss is the whole vocabulary's. With experts the loss
        adds ``router_aux_coef`` times the layers' mean aux (JAX's).

        ``attn_seeds`` gives one uint32 attention-dropout seed per layer and
        ``mask_seeds`` the embedding / MLP dropout masks' site seeds (the
        embedding's, then layer l's at 1 + l; ``draw_mask_seeds`` draws
        them from a generator); both None means deterministic (no dropout
        anywhere), as in JAX without a key. ``batch_offset`` is the global
        batch index of row 0 of ``idx`` (a data-parallel rank's first row),
        which keys the attention mask and the rows' embedding / MLP masks.
        ``global_batch``: the rows of the global batch (None: this call's B
        rows are the whole batch, rows 0..B-1); each row's mask is drawn at
        the full sequence length and cut to this rank's columns, so every
        layout of the same global batch draws the same masks.

        ``unit``: one unit of a pipeline stage instead (``run_unit``); a
        schedule calls the model so, through the arm's wrapper."""
        if unit is not None:
            return self.run_unit(idx, targets, unit, attn_seeds, batch_offset, global_batch)
        c = self.config
        x, aux = self._trunk(idx, attn_seeds, mask_seeds, batch_offset, global_batch)
        logits, loss = self._head(x, targets)
        if loss is not None and c.n_experts > 0:
            loss = loss + c.router_aux_coef * aux / c.n_layer
        return logits, loss

    def _head(self, x: torch.Tensor, targets: Optional[torch.Tensor]):
        """Final norm, LM head and (with ``targets``) the cross-entropy:
        (fp32 logits, loss or None)."""
        c = self.config
        m, t = self.tp
        group = self.model_group
        lnf = (copy_to_model(self.lnf_scale, group if self.cmm else None),
               copy_to_model(getattr(self, "lnf_bias", None), group if self.cmm else None))
        if c.norm == "rmsnorm":
            x = _rms_norm(x, lnf[0], c.norm_eps)
        else:
            x = _layer_norm(x, lnf[0], lnf[1], c.norm_eps)
        if self.cmm:
            x = all_gather_seq(x, group)
        else:
            x = copy_to_model(x, group)
        w = self.wte if c.tie_embeddings else self.lm_head
        logits = _logits(x, w.to(c.compute_dtype))
        if targets is None:
            return logits, None
        if group is None:
            loss = cross_entropy(logits, targets)
        else:
            loss = vocab_parallel_cross_entropy(logits, targets, m * (c.vocab_size // t), group)
        return logits, loss

    def _mask_geometry(self, B: int, S: int, batch_offset: int,
                       global_batch: Optional[int]):
        """(this rank's columns of the stream, the global rows of the
        dropout masks, a row's drawn shape) for B rows of S tokens (before
        the collective matmul's cut)."""
        s, n = self.seq_shard
        m, t = self.tp
        cols = slice(s * S, (s + 1) * S)
        if self.cmm:
            cols = slice(m * (S // t), (m + 1) * (S // t))
        row0 = batch_offset if global_batch is not None else 0
        return cols, range(row0, row0 + B), (S * n, self.config.n_embd)

    def embed(self, idx: torch.Tensor, mask_seed: Optional[int],
              batch_offset: int = 0, global_batch: Optional[int] = None) -> torch.Tensor:
        """Token (+ learned position) embedding and its dropout, from the
        site seed ``mask_seed`` (None: no dropout) -> the stream in the
        compute dtype."""
        c = self.config
        B, S = idx.shape
        s, n = self.seq_shard
        m, t = self.tp
        group = self.model_group
        if S * n > c.block_size:
            raise ValueError(f"Sequence {S * n} exceeds block size {c.block_size}")
        v0 = m * (c.vocab_size // t)
        cols, rows, row_shape = self._mask_geometry(B, S, batch_offset, global_batch)
        if group is None:
            tok = self.wte[idx]
        elif self.cmm:
            if S % t:
                raise ValueError(f"tp_collective_matmul: sequence {S} does not split over "
                                 f"model width {t}")
            # Summed over 'model' and cut to this rank's chunk of the sequence.
            tok = reduce_scatter_seq(vocab_parallel_embedding(idx, self.wte, v0, group,
                                                              reduce=False), group)
        else:
            tok = vocab_parallel_embedding(idx, self.wte, v0, group)
        if c.pos_embed == "learned":
            x = (tok + copy_to_model(self.wpe, group if self.cmm else None)[cols][None]).to(
                c.compute_dtype)
        else:
            x = tok.to(c.compute_dtype)
        return _apply_dropout(x, _dropout_mask(mask_seed, c.dropout, rows, row_shape, cols,
                                               x.device), c.dropout)

    def run_blocks(self, x: torch.Tensor, blocks: Sequence[int],
                   attn_seeds: Optional[Sequence[int]],
                   mask_seeds: Optional[Sequence[int]], batch_offset: int = 0,
                   global_batch: Optional[int] = None, moe_aux_mode: Optional[str] = None):
        """The local blocks ``blocks`` (indices into ``self.blocks``) over the
        stream x -> (the stream, their summed MoE aux or None). Block i's
        attention seed is ``attn_seeds[layer_ids[i]]`` and its MLP mask's site
        seed ``mask_seeds[1 + layer_ids[i]]``, both indexed by global layer
        (None: no dropout)."""
        c = self.config
        s, n = self.seq_shard
        m, t = self.tp
        B = x.shape[0]
        S = x.shape[1] * (t if self.cmm else 1)
        pos0 = s * S
        cols, rows, row_shape = self._mask_geometry(B, S, batch_offset, global_batch)
        remat = normalize_remat(c.remat)
        aux = None
        for i in blocks:
            block = self.blocks[i]
            seed = attn_seeds[block.layer_id] if attn_seeds is not None else None
            mask_seed = mask_seeds[1 + block.layer_id] if mask_seeds is not None else None
            args = (x, self.attention, seed if c.dropout > 0.0 else None,
                    _dropout_mask(mask_seed, c.dropout, rows, row_shape, cols, x.device),
                    batch_offset, pos0, moe_aux_mode)
            if remat == "none":
                x = block(*args)
            else:
                x = checkpoint(block, *args, use_reentrant=False,
                               context_fn=functools.partial(_remat_context, remat))
            if c.n_experts > 0:
                x, layer_aux = x
                aux = layer_aux if aux is None else aux + layer_aux
        return x, aux

    def _trunk(self, idx, attn_seeds, mask_seeds, batch_offset, global_batch,
               moe_aux_mode: Optional[str] = None):
        """Embedding and blocks -> (the stream before the final norm, the
        layers' summed MoE aux or None); masks from the site seeds
        ``mask_seeds`` (None: no dropout)."""
        x = self.embed(idx, mask_seeds[0] if mask_seeds is not None else None, batch_offset,
                       global_batch)
        return self.run_blocks(x, range(len(self.blocks)), attn_seeds, mask_seeds, batch_offset,
                               global_batch, moe_aux_mode)

    def head_loss(self, x: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """Final norm, head and cross-entropy over the stream x: the mean
        loss without the MoE aux (the last stage's piece of a pipeline)."""
        return self._head(x, targets)[1]

    def run_unit(self, inp: torch.Tensor, targets: Optional[torch.Tensor], unit: StageUnit,
                 attn_seeds: Optional[Sequence[int]], batch_offset: int,
                 global_batch: Optional[int]):
        """One pipeline unit (``parallel/pipeline.StageUnit``): ``inp`` is the
        tokens when the unit embeds, else the stream; then chunk
        ``unit.chunk``'s blocks (None: none), then with ``unit.head`` the
        loss against ``targets`` -> (the stream or the loss, the chunk's MoE
        aux or None). Masks come from ``unit.mask_seeds``."""
        c = self.config
        seeds = [int(v) for v in unit.mask_seeds] if c.dropout > 0.0 and unit.mask_seeds else None
        if unit.embed:
            x = self.embed(inp, seeds[0] if seeds is not None else None, batch_offset,
                           global_batch)
        else:
            x = inp
        aux = None
        if unit.chunk is not None:
            lc = self.chunk_layers
            local = range(unit.chunk * lc, (unit.chunk + 1) * lc)
            x, aux = self.run_blocks(x, local, attn_seeds, seeds, batch_offset, global_batch)
        if unit.head:
            x = self.head_loss(x, targets)
        return x, aux


@torch.no_grad()
def moe_overflow_fraction(model: TinyGPT, idx: torch.Tensor, batch_offset: int = 0,
                          global_batch: Optional[int] = None, pipeline=None) -> torch.Tensor:
    """JAX's diagnostic: the mean fraction of (token, choice) assignments the
    capacity limit drops, averaged over the layers, from one dropout-free
    forward with the aux channel in overflow mode (over the group: the
    mean over the token-sharding ranks, as the layer averages it). Under a
    pipeline of contiguous stages (``pipeline``: this rank's
    ``parallel.pipeline.Pipeline``) the forward runs through the stages in
    order and the layers' fractions are summed over ``pipe``."""
    if pipeline is None:
        _, aux = model._trunk(idx, None, None, batch_offset, global_batch, "overflow")
    else:
        n = len(model.blocks)
        aux = pipeline.forward_only(
            lambda: model.embed(idx, None, batch_offset, global_batch),
            lambda x: model.run_blocks(x, range(n), None, None, batch_offset,
                                       global_batch, "overflow"),
            (*idx.shape, model.config.n_embd), model.config.compute_dtype)
    return aux / model.config.n_layer


def _expert_groups(c: TinyGPTConfig, mesh: Optional[Mesh]) -> ExpertGroups:
    """The MoE layers' groups over ``mesh`` (``models/moe.py``), after the
    refusals of what is not ported."""
    _, ep = mesh.expert_shard if mesh is not None else (0, 1)
    if ep > 1 and c.n_experts == 0:
        raise ValueError("expert_parallel > 1 requires --num-experts > 0")
    if ep > 1 and c.n_experts % ep:
        raise ValueError(f"n_experts={c.n_experts} not divisible by expert_parallel={ep}")
    if ep > 1 and mesh.device_mesh is None:
        raise ValueError(f"expert parallelism (expert width {ep}) needs a process group")
    if c.n_experts == 0 or mesh is None or mesh.device_mesh is None:
        return ExpertGroups()
    if not mesh.seq_in_process or mesh.size(AXES.model) > 1:
        raise ValueError(
            "MoE with a 'seq' or 'model' axis over the process group is not ported "
            "(it needs routing across sequence shards; ROADMAP Queue 1 item 12)")
    if ep > 1:
        return ExpertGroups(ep, mesh.expert_group, mesh.batch_group)
    if mesh.size(AXES.data) > 1:
        return ExpertGroups(1, None, mesh.data_group, mesh.data_group)
    return ExpertGroups()


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
