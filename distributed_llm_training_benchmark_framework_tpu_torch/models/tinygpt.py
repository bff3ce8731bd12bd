"""TinyGPT: the benchmark transformer, as ``nn.Module``s.

Port of ``distributed_llm_training_benchmark_framework_tpu/models/tinygpt.py``
(the forward path and the loss, per-layer remat, and the dispatch to
sequence-parallel ring attention; MoE is not ported yet). One config
covers both families: the reference TinyGPT (learned positions, LayerNorm, exact-erf
GELU, biases, tied head, non-causal, dropout 0.1) and, through
``models.llama``, the Llama family (RMSNorm, RoPE, SwiGLU, GQA, no bias,
untied head, causal).

Parameters keep the JAX leaf names and per-layer shapes, so ``bridge.py``
maps ``params["blocks"][leaf][i]`` to ``blocks.<i>.<leaf>`` one to one:
``wqkv`` (D, 3, D), ``wq`` (D, H*Dh), ``wkv`` (D, 2, Hkv*Dh), ``wo`` (D, D),
``wfc`` (D, F), ``wgu`` (D, 2, F), ``wproj`` (F, D), biases and norm scales.

Numerics follow JAX's explicit casts (no ``torch.autocast``): parameters
stay fp32 and are cast to the compute dtype where they are used; the
residual stream is in the compute dtype; norm statistics, the softmax of the
reference attention, the logits and the loss are fp32.

Remat (``config.remat``, JAX's policies) wraps each block in
``torch.utils.checkpoint`` (non-reentrant): ``full`` recomputes the whole
block in the backward; ``dots`` keeps the outputs of the x @ W products
(``aten.mm`` / ``aten.addmm``, JAX's ``dots_with_no_batch_dims_saveable``)
and recomputes the rest, attention included. A block's MLP dropout mask is
drawn from the explicit generator before the block runs and passed in, so
a recompute reuses it (checkpoint restores only the default generators);
the attention mask is a hash of a host seed and needs nothing.

The LM head gives fp32 logits from bf16 operands without rounding them to
bf16. On a CUDA device it is one bf16 GEMM with fp32 output
(``torch.mm(..., out_dtype=torch.float32)``; its backward is two bf16 GEMMs
on the bf16-rounded logits gradient, since that overload has no autograd
formula). Elsewhere it upcasts the bf16 operands and multiplies in fp32.
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

from ..ops.flash_attention import (
    dropout_keep,
    dropout_threshold,
    flash_attention,
)
from ..ops.ring_attention import ring_attention
from ..parallel.mesh import AXES, Mesh

ATTENTION_IMPLS = ("reference", "flash", "ring")
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


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, rotate-half convention, fp32 math; x (B, S, H, Dh)."""
    S, Dh = x.shape[1], x.shape[-1]
    half = Dh // 2
    inv_freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device)
                                * 2.0 / Dh))
    freqs = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv_freq[None, :]
    cos = torch.cos(freqs)[None, :, None, :]
    sin = torch.sin(freqs)[None, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat((x1 * cos - x2 * sin, x2 * cos + x1 * sin), dim=-1).to(x.dtype)


def _dropout_mask(shape, rate: float, generator: Optional[torch.Generator],
                  device) -> Optional[torch.Tensor]:
    """Keep mask of inverted dropout, drawn from an explicit generator (None:
    no dropout)."""
    if rate == 0.0 or generator is None:
        return None
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def _apply_dropout(x: torch.Tensor, mask: Optional[torch.Tensor], rate: float):
    if mask is None:
        return x
    keep = 1.0 - rate
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]):
    """Inverted dropout with a mask drawn from an explicit generator."""
    return _apply_dropout(x, _dropout_mask(x.shape, rate, generator, x.device), rate)


def reference_attention(q, k, v, causal: bool = False, dropout_rate: float = 0.0,
                        dropout_seed: Optional[int] = None,
                        batch_offset: int = 0) -> torch.Tensor:
    """Materialized softmax(q k^T / sqrt(Dh)) v with fp32 softmax, (B, S, H, Dh).

    Attention-probability dropout uses the flash kernels' coordinate-hash mask
    for ``dropout_seed`` (the JAX 'reference' path draws a bernoulli mask from
    its own key, which no torch generator reproduces), keyed from the global
    batch index ``batch_offset`` of row 0 as in flash."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    S = q.shape[1]
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0 and dropout_seed is not None:
        B, H = q.shape[0], q.shape[2]
        idx = torch.arange(S, device=q.device)
        bh = batch_offset * H + torch.arange(B * H, device=q.device)
        keep = dropout_keep(int(dropout_seed), bh[:, None, None],
                            idx[None, :, None], idx[None, None, :],
                            dropout_threshold(dropout_rate)).reshape(B, H, S, S)
        probs = torch.where(keep, probs / (1.0 - dropout_rate), 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


class _LogitsMM(torch.autograd.Function):
    """bf16 x bf16 -> fp32 logits in one GEMM (CUDA): the forward of JAX's
    einsum(..., preferred_element_type=f32) without rounding to bf16."""

    @staticmethod
    def forward(ctx, x2d, w):
        ctx.save_for_backward(x2d, w)
        return torch.mm(x2d, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2d, w = ctx.saved_tensors
        g = g.to(x2d.dtype)
        return torch.mm(g, w), torch.mm(g.t(), x2d)


def _logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 logits (B, S, V) from x (B, S, D) and head w (V, D), both in the
    compute dtype (see the module docstring)."""
    B, S, D = x.shape
    if x.dtype == torch.float32:
        return torch.matmul(x, w.t())
    if x.device.type == "cuda":
        return _LogitsMM.apply(x.reshape(B * S, D), w).reshape(B, S, -1)
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


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=torch.float32))


class Block(nn.Module):
    """One pre-norm transformer layer holding the JAX leaves of its slice."""

    def __init__(self, c: TinyGPTConfig):
        super().__init__()
        self.c = c
        D, H, Hkv, Dh, Fm = c.n_embd, c.n_head, c.kv_heads, c.head_dim, c.mlp_dim
        self.ln1_scale, self.ln2_scale = _param(D), _param(D)
        if c.norm == "layernorm":
            self.ln1_bias, self.ln2_bias = _param(D), _param(D)
        if Hkv == H:
            self.wqkv = _param(D, 3, D)
            if c.bias:
                self.bqkv = _param(3, D)
        else:
            self.wq = _param(D, H * Dh)
            self.wkv = _param(D, 2, Hkv * Dh)
            if c.bias:
                self.bq = _param(H * Dh)
                self.bkv = _param(2, Hkv * Dh)
        self.wo = _param(D, D)
        if c.bias:
            self.bo = _param(D)
        if c.mlp_act == "swiglu":
            self.wgu = _param(D, 2, Fm)
            if c.bias:
                self.bgu = _param(2, Fm)
        else:
            self.wfc = _param(D, Fm)
            if c.bias:
                self.bfc = _param(Fm)
        self.wproj = _param(Fm, D)
        if c.bias:
            self.bproj = _param(D)

    def _norm(self, x, which: str):
        c = self.c
        scale = getattr(self, f"{which}_scale")
        if c.norm == "rmsnorm":
            return _rms_norm(x, scale, c.norm_eps)
        return _layer_norm(x, scale, getattr(self, f"{which}_bias"), c.norm_eps)

    def _proj(self, h, w, b=None):
        """h (..., K) @ w (K, ...) in the compute dtype, plus an optional bias."""
        cd = self.c.compute_dtype
        out = torch.matmul(h, w.reshape(w.shape[0], -1).to(cd))
        out = out.reshape(*h.shape[:-1], *w.shape[1:])
        return out if b is None else out + b.to(cd)

    def forward(self, x, attention: AttentionFn, attn_seed: Optional[int],
                drop_mask: Optional[torch.Tensor], batch_offset: int = 0):
        """One layer; ``drop_mask`` is the MLP dropout's keep mask (None: no
        dropout) and ``batch_offset`` the global batch index of row 0."""
        c = self.c
        B, S, D = x.shape
        h = self._norm(x, "ln1")
        if c.kv_heads == c.n_head:
            qkv = self._proj(h, self.wqkv, getattr(self, "bqkv", None))  # (B, S, 3, D)
            q, k, v = (qkv[:, :, i].reshape(B, S, c.n_head, c.head_dim) for i in range(3))
        else:
            q = self._proj(h, self.wq, getattr(self, "bq", None))
            kv = self._proj(h, self.wkv, getattr(self, "bkv", None))
            q = q.reshape(B, S, c.n_head, c.head_dim)
            k = kv[:, :, 0].reshape(B, S, c.kv_heads, c.head_dim)
            v = kv[:, :, 1].reshape(B, S, c.kv_heads, c.head_dim)
        if c.pos_embed == "rope":
            q, k = _rope(q, c.rope_theta), _rope(k, c.rope_theta)
        if c.kv_heads != c.n_head:
            rep = c.n_head // c.kv_heads
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        rate = c.dropout if attn_seed is not None else 0.0
        attn = attention(q, k, v, causal=c.causal, dropout_rate=rate, dropout_seed=attn_seed,
                         batch_offset=batch_offset)
        x = x + self._proj(attn.reshape(B, S, D), self.wo, getattr(self, "bo", None))

        h = self._norm(x, "ln2")
        if c.mlp_act == "swiglu":
            gu = self._proj(h, self.wgu, getattr(self, "bgu", None))  # (B, S, 2, F)
            h = F.silu(gu[:, :, 0]) * gu[:, :, 1]
        else:
            h = F.gelu(self._proj(h, self.wfc, getattr(self, "bfc", None)))  # exact erf
        h = self._proj(h, self.wproj, getattr(self, "bproj", None))
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


class TinyGPT(nn.Module):
    """Embedding (+ learned positions) -> blocks -> final norm -> LM head.

    ``mesh`` gives the width of the ``seq`` axis that ring attention shards
    the sequence over (None: width 1, where ring attention is flash, as in
    JAX without a ``seq`` axis)."""

    def __init__(self, config: TinyGPTConfig, mesh: Optional[Mesh] = None):
        super().__init__()
        c = self.config = config
        D, V = c.n_embd, c.vocab_size
        self.wte = _param(V, D)
        if c.pos_embed == "learned":
            self.wpe = _param(c.block_size, D)
        self.blocks = nn.ModuleList(Block(c) for _ in range(c.n_layer))
        self.lnf_scale = _param(D)
        if c.norm == "layernorm":
            self.lnf_bias = _param(D)
        if not c.tie_embeddings:
            self.lm_head = _param(V, D)
        # The attention every block calls; the config picks it. A check that
        # compares against another implementation assigns this attribute.
        self.attention: AttentionFn = reference_attention
        if c.attention_impl == "flash":
            self.attention = flash_attention
        elif c.attention_impl == "ring":
            seq = mesh.size(AXES.seq) if mesh is not None else 1
            self.attention = functools.partial(ring_attention, seq_shards=seq,
                                               zigzag=c.ring_zigzag)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "TinyGPT":
        """normal(0, 0.02) for matrices and embeddings, zeros for biases, ones
        for norm scales (the JAX init scheme; the values differ)."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("_scale"):
                p.fill_(1.0)
            elif leaf.startswith("b") or leaf.endswith("_bias"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=generator.device) * 0.02)
        return self

    def forward(
        self,
        idx: torch.Tensor,  # (B, S) token ids
        targets: Optional[torch.Tensor] = None,  # (B, S), -1 = ignore
        *,
        attn_seeds: Optional[Sequence[int]] = None,
        generator: Optional[torch.Generator] = None,
        batch_offset: int = 0,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """-> (fp32 logits (B, S, V), fp32 loss or None).

        ``attn_seeds`` gives one uint32 attention-dropout seed per layer and
        ``generator`` draws the embedding / MLP dropout masks; both None means
        deterministic (no dropout anywhere), as in JAX without a key.
        ``batch_offset`` is the global batch index of row 0 of ``idx`` (a
        data-parallel rank's first row), which keys the attention mask."""
        c = self.config
        B, S = idx.shape
        if S > c.block_size:
            raise ValueError(f"Sequence {S} exceeds block size {c.block_size}")
        tok = self.wte[idx]
        if c.pos_embed == "learned":
            x = (tok + self.wpe[:S][None]).to(c.compute_dtype)
        else:
            x = tok.to(c.compute_dtype)
        x = _dropout(x, c.dropout, generator)
        seeds: List[Optional[int]] = (
            list(attn_seeds) if attn_seeds is not None else [None] * c.n_layer
        )
        remat = normalize_remat(c.remat)
        for block, seed in zip(self.blocks, seeds):
            args = (x, self.attention, seed if c.dropout > 0.0 else None,
                    _dropout_mask(x.shape, c.dropout, generator, x.device), batch_offset)
            if remat == "none":
                x = block(*args)
            else:
                x = checkpoint(block, *args, use_reentrant=False,
                               context_fn=functools.partial(_remat_context, remat))
        if c.norm == "rmsnorm":
            x = _rms_norm(x, self.lnf_scale, c.norm_eps)
        else:
            x = _layer_norm(x, self.lnf_scale, self.lnf_bias, c.norm_eps)
        w = self.wte if c.tie_embeddings else self.lm_head
        logits = _logits(x, w.to(c.compute_dtype))
        loss = cross_entropy(logits, targets) if targets is not None else None
        return logits, loss


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
