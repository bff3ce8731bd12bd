"""Flash attention: hand-written Hopper kernels, their plain PyTorch versions,
and the ``torch.autograd.Function`` that ties them together.

Port of ``distributed_llm_training_benchmark_framework_tpu/ops/flash_attention.py``.
Three CUDA C++ kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) replace
the three Pallas TPU kernels there:

========================  ====================================  ===========================
wrapper                   replaces (JAX package, same file)     bound on the H100
========================  ====================================  ===========================
``flash_fwd``             ``_flash_fwd_kernel``                 4*BH*S^2*Dh tensor FLOPs
``flash_bwd_dq``          ``_bwd_dq_kernel``                    6*BH*S^2*Dh tensor FLOPs
``flash_bwd_dkv``         ``_bwd_dkv_kernel``                   8*BH*S^2*Dh tensor FLOPs
========================  ====================================  ===========================

The two backward wrappers also serve the ring backward (``ops/ring_attention.py``,
JAX ``_block_bwd_kernel``): with ``out_dtype=torch.float32`` they launch the
same kernels in their fp32-output mode with the ring's global offsets, and
count those launches apart, as the modes ``flash_bwd_dq_fp32`` and
``flash_bwd_dkv_fp32``.

Each count halves when causal; with dropout each kernel also evaluates the
coordinate hash (about 10 integer operations) per live score element. The
bytes each kernel must move (its inputs once, its outputs once) take a few
microseconds at 3.35 TB/s, so all three are bound by operations. All
three run Hopper wgmma mainloops on the PTX helpers of
``csrc/sm90_ptx.cuh``: one warpgroup per 64-row tile, the tiles it walks
TMA-fed through two shared-memory stages, both products over the head dim
with operands in shared memory, and the probabilities, ds and the fp32
accumulators (out; dq; dk and dv) in registers, the bf16 p or ds being the
register operand of the product that follows. The forward (and the ring's
block forward K4) is ``csrc/flash_fwd_sm90.cuh``; the backward pair,
``csrc/flash_bwd.cu``, keeps JAX's two kernels (no atomics), whose source
note gives the bound and the design.

Every wrapper works on (BH, S, Dh) tensors. On a CPU tensor it runs its
plain PyTorch version (the tests' path); on a CUDA tensor it launches the
kernel or raises; there is no fallback. Each kernel launch adds one to its
mode's count in ``_build.LAUNCHES`` and nowhere else.

The dropout mask is the JAX package's stateless coordinate hash
(``mix32`` / ``dropout_keep`` / ``dropout_threshold`` below), bit-identical
to JAX for the same uint32 seed. torch has no full uint32 arithmetic, so
the plain version computes it in int64 and masks with 0xFFFFFFFF after
every multiply (an int64 product that wraps keeps the right low 32 bits).

Layout: the public :func:`flash_attention` takes (B, S, H, Dh) like the JAX
one and transposes to (B*H, S, Dh) for the kernels.

Under data parallelism a rank holds rows ``[b_off, b_off + B)`` of the
global batch and passes ``batch_offset=b_off``: the mask is keyed by the
global batch*head id ``(b_off + b) * H + h``, so each rank drops what one
process on the whole batch would. K2 and K3 take those ids as their
``bhv`` vector (:func:`_global_bh_vec`). K1's first instance takes none:
the hash adds ``bh * 0x9E3779B9`` to the seed before its first mix, so K1
runs on the seed ``seed + bh_offset * 0x9E3779B9`` (mod 2^32), which keys
local id ``bh`` exactly as the global id ``bh + bh_offset``.

Under tensor parallelism a rank holds heads ``[h_off, h_off + H)`` of
``n_heads`` (``head_offset``, ``n_heads``): its local row ``b * H + h`` is
the global id ``(b_off + b) * n_heads + h_off + h``, which no single
offset gives once B > 1. Then all three kernels take the ids as a vector:
K1 through its second instance, ``flash_fwd_bhv`` (the same mainloop,
reading ``bhv[blockIdx.x]`` for its hash base; counted as its own mode),
K2 and K3 as above.
"""

from __future__ import annotations

import functools
import math
import warnings
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30
TILE = 64  # rows of a q tile and of a k tile in the CUDA kernels (kTile)
HEAD_DIMS = (64, 128)
_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Dropout hash (plain PyTorch; the kernels inline csrc/dropout_hash.cuh)
# ---------------------------------------------------------------------------


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3-style 32-bit finalizer on int64 tensors holding uint32 values."""
    x = x & _M32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _M32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def dropout_keep(seed, bh, rows, cols, threshold: int) -> torch.Tensor:
    """Keep mask of the coordinate hash; arguments broadcast as in JAX.

    ``seed`` is an int or an int64 tensor holding a uint32; ``bh``, ``rows``
    and ``cols`` are int64 tensors of absolute coordinates."""
    base = mix32(seed + bh * 0x9E3779B9)
    rowbase = mix32(base + rows * 0x85EBCA6B)
    return mix32(rowbase + cols) < threshold


def dropout_threshold(rate: float) -> int:
    """keep iff hash < min(floor((1 - rate) * 2^32), 2^32 - 1)."""
    return min(int((1.0 - rate) * 2**32), 2**32 - 1)


def _tile_coords(offsets: Optional[torch.Tensor], S: int, device) -> torch.Tensor:
    """Absolute row (or col) index of each of S positions from per-tile bases
    of S / len(offsets) rows each (None: identity). The kernels take 64-row
    tiles; a plain version also takes finer ones (one row each, say)."""
    local = torch.arange(S, device=device, dtype=torch.int64)
    if offsets is None:
        return local
    if S % offsets.numel():
        raise ValueError(f"{offsets.numel()} tile bases do not tile {S} positions")
    tile = S // offsets.numel()
    return offsets.to(device=device, dtype=torch.int64).repeat_interleave(tile) + local % tile


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------


def _global_bh_vec(B: int, H: int, b_off: int, h_off: int, n_heads: int,
                   device=None) -> torch.Tensor:
    """(B*H,) int32 of GLOBAL batch*heads indices, flash's b*H + h keying."""
    b = b_off + torch.arange(B, dtype=torch.int32, device=device)
    hh = h_off + torch.arange(H, dtype=torch.int32, device=device)
    return (b[:, None] * n_heads + hh[None, :]).reshape(B * H)


def flash_forward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool, dropout_rate: float, seed: int, bh_offset: int = 0,
    bhv: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialized forward with the kernel's exact mask and normalizer
    semantics (JAX ``_jnp_reference_forward``): (BH, S, Dh) -> (out, lse).
    The mask keys row ``i`` of q by the global batch*head id ``bhv[i]``
    when the vector is given, else ``bh_offset + i``. Differentiable with
    ordinary autograd."""
    BH, S, D = q.shape
    scale = 1.0 / math.sqrt(D)
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]
    mask = rows >= cols
    if causal:
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if dropout_rate > 0.0:
        bh = (bhv.to(device=q.device, dtype=torch.int64) if bhv is not None
              else bh_offset + torch.arange(BH, device=q.device))[:, None, None]
        keep = dropout_keep(seed, bh, rows[None], cols[None], dropout_threshold(dropout_rate))
        p_acc = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)), 0.0)
    else:
        p_acc = p
    l_safe = torch.where(l == 0.0, 1.0, l)
    acc = torch.matmul(p_acc.to(q.dtype).float(), v.float())
    out = (acc / l_safe).to(q.dtype)
    lse = (m + torch.log(l_safe))[..., 0]
    return out, lse


def _plain_bwd_blocks(q, k, v, dout, lse, delta, causal, dropout_rate, seed,
                      qoff, koff, bhv, block_k):
    """Yield (k0, kb, p, pd, ds) per k block: the probability tile math shared
    by both backward kernels (JAX ``_jnp_blockwise_bwd``), fp32 throughout,
    ds rounded to the operand dtype."""
    BH, S, D = q.shape
    scale = 1.0 / math.sqrt(D)
    rows = _tile_coords(qoff, S, q.device)
    cols_all = _tile_coords(koff, k.shape[1], q.device)
    bh = (bhv.to(torch.int64) if bhv is not None
          else torch.arange(BH, device=q.device))[:, None, None]
    qf, dof = q.float(), dout.float()
    for k0 in range(0, k.shape[1], block_k):
        kb, vb = k[:, k0:k0 + block_k].float(), v[:, k0:k0 + block_k].float()
        cols = cols_all[k0:k0 + block_k]
        s = torch.matmul(qf, kb.transpose(1, 2)) * scale
        mask = rows[:, None] >= cols[None, :]
        if causal:
            s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - lse[:, :, None])
        if causal:
            p = torch.where(mask, p, 0.0)
        dp = torch.matmul(dof, vb.transpose(1, 2))
        if dropout_rate > 0.0:
            keep = dropout_keep(seed, bh, rows[None, :, None], cols[None, None, :],
                                dropout_threshold(dropout_rate))
            inv = 1.0 / (1.0 - dropout_rate)
            pd = torch.where(keep, p * inv, 0.0)
            dp = torch.where(keep, dp * inv, 0.0)
        else:
            pd = p
        ds = (p * (dp - delta[:, :, None]) * scale).to(q.dtype)
        yield k0, kb, pd, ds


def _plain_block_k(S: int) -> int:
    for b in (512, 256, 128, 64, 32, 16, 8, 4, 2, 1):
        if b <= S and S % b == 0:
            return b
    return S


def flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal, dropout_rate, seed,
                       qoff=None, koff=None, bhv=None, out_dtype=None):
    """dq = sum over k blocks of ds . k (plain PyTorch version of K2 and,
    with ``out_dtype=torch.float32``, of K2′), in ``out_dtype`` (default
    q's dtype)."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for _k0, kb, _pd, ds in _plain_bwd_blocks(
        q, k, v, dout, lse, delta, causal, dropout_rate, seed,
        qoff, koff, bhv, _plain_block_k(q.shape[1]),
    ):
        dq += torch.matmul(ds.float(), kb)
    return dq.to(out_dtype or q.dtype)


def flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal, dropout_rate, seed,
                        qoff=None, koff=None, bhv=None, out_dtype=None):
    """dk = ds^T . q and dv = (D*p)^T . dO per k block (plain version of K3
    and, with ``out_dtype=torch.float32``, of K3′), in ``out_dtype`` (default
    k's and v's dtype)."""
    dk, dv = [], []
    qf, dof = q.float(), dout.float()
    for _k0, _kb, pd, ds in _plain_bwd_blocks(
        q, k, v, dout, lse, delta, causal, dropout_rate, seed,
        qoff, koff, bhv, _plain_block_k(q.shape[1]),
    ):
        dv.append(torch.matmul(pd.to(q.dtype).float().transpose(1, 2), dof))
        dk.append(torch.matmul(ds.float().transpose(1, 2), qf))
    return (torch.cat(dk, dim=1).to(out_dtype or k.dtype),
            torch.cat(dv, dim=1).to(out_dtype or v.dtype))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _dropout_args(dropout_rate: float, seed: int):
    if dropout_rate > 0.0:
        return 1, seed & _M32, dropout_threshold(dropout_rate), 1.0 / (1.0 - dropout_rate)
    return 0, 0, 0, 1.0


def _check_cuda(*tensors: torch.Tensor) -> None:
    """Refuse what the kernels do not take: raise, never fall back."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(
            f"flash kernels run on CUDA tensors (the plain version serves CPU "
            f"tensors); got device {q.device}"
        )
    BH, S, D = q.shape
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"tensors on different devices: {t.device} vs {q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash kernels take bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("flash kernels take contiguous (BH, S, Dh) tensors")
        if tuple(t.shape) != (BH, S, D):
            raise ValueError(f"shape mismatch: {tuple(t.shape)} vs {(BH, S, D)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported by the kernels (need one of {HEAD_DIMS})")
    if S % TILE != 0:
        raise ValueError(f"sequence length {S} must be a multiple of the tile size {TILE}")


def _row_stats(q: torch.Tensor, *stats: torch.Tensor):
    """lse / delta as contiguous fp32 (BH, S) tensors on q's device."""
    out = []
    for t in stats:
        if t.device != q.device or tuple(t.shape) != tuple(q.shape[:2]):
            raise ValueError(
                f"row statistics must be (BH, S) = {tuple(q.shape[:2])} on {q.device}, "
                f"got {tuple(t.shape)} on {t.device}"
            )
        out.append(t.float().contiguous())
    return out


def _out_dtype(out_dtype: Optional[torch.dtype]) -> torch.dtype:
    out = out_dtype or torch.bfloat16
    if out not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the backward kernels write bfloat16 or float32, not {out}")
    return out


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def offset_seed(seed: int, bh_offset: int) -> int:
    """The seed that keys local batch*head id ``bh`` as the hash keys
    ``bh + bh_offset`` under ``seed`` (see the module docstring)."""
    return (seed + bh_offset * 0x9E3779B9) & _M32


def flash_fwd(q, k, v, causal: bool, dropout_rate: float, seed: int, bh_offset: int = 0,
              bhv: Optional[torch.Tensor] = None):
    """K1: (BH, S, Dh) q, k, v -> (out bf16 (BH, S, Dh), lse fp32 (BH, S)).
    Row ``i`` of q is the global batch*head ``bh_offset + i`` for the mask,
    or ``bhv[i]`` when the (BH,) id vector is given: then K1's ``bhv``
    instance launches, counted as ``flash_fwd_bhv``."""
    if _on_cpu(q):
        return flash_forward_plain(q, k, v, causal, dropout_rate, seed, bh_offset, bhv)
    _check_cuda(q, k, v)
    BH, S, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((BH, S), dtype=torch.float32, device=q.device)
    lib = _build.load()["flash_fwd"]
    if bhv is None:
        dropout, seed32, thr, inv = _dropout_args(dropout_rate, offset_seed(seed, bh_offset))
        code = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            BH, S, D, int(causal), dropout, 1.0 / math.sqrt(D), seed32, thr, inv, _stream(q),
        )
        _build.check("flash_fwd", code, "flash_fwd launch")
        _build.launched("flash_fwd")
        return out, lse
    _, _, bv = _offset_args(q, None, None, bhv)
    dropout, seed32, thr, inv = _dropout_args(dropout_rate, seed)
    code = lib.flash_fwd_bhv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        bv.data_ptr(), BH, S, D, int(causal), dropout, 1.0 / math.sqrt(D), seed32, thr, inv,
        _stream(q),
    )
    _build.check("flash_fwd", code, "flash_fwd_bhv launch")
    _build.launched("flash_fwd_bhv")
    return out, lse


@functools.lru_cache(maxsize=64)
def _offset_bh_ids(BH: int, bh_offset: int, device: torch.device) -> torch.Tensor:
    """Global batch*head ids ``bh_offset + arange(BH)`` (a rank's rows), made
    once per shape, offset and device (as ``_identity_offsets``)."""
    return _global_bh_vec(1, BH, 0, bh_offset, BH, device)


@functools.lru_cache(maxsize=64)
def _identity_offsets(BH: int, S: int, device: torch.device):
    """Plain flash's tile bases and batch*head ids, made once per shape and
    device: a wrapper passes them on every launch, and making them anew is
    three more device operations per launch on the host's critical path."""
    tiles = torch.arange(S // TILE, dtype=torch.int32, device=device) * TILE
    return tiles, tiles, torch.arange(BH, dtype=torch.int32, device=device)


def _offset_args(q, qoff, koff, bhv):
    """The int32 tile bases and batch*head ids a kernel takes: the given
    vectors (the ring's), or plain flash's identity where one is None."""
    BH, S, _ = q.shape
    given = (qoff, koff, bhv)
    ident = (_identity_offsets(BH, S, q.device) if any(t is None for t in given)
             else (None, None, None))
    out = []
    for t, want, idn in zip(given, (S // TILE, S // TILE, BH), ident):
        if t is None:
            t = idn
        elif t.dtype != torch.int32 or t.device != q.device or not t.is_contiguous():
            t = t.to(device=q.device, dtype=torch.int32).contiguous()
        if t.shape != (want,):
            raise ValueError(f"offset vector of shape {tuple(t.shape)}, expected {(want,)}")
        out.append(t)
    return out


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool, dropout_rate: float, seed: int,
                 qoff=None, koff=None, bhv=None, out_dtype=None):
    """K2: dq (BH, S, Dh). ``qoff``/``koff`` are per-64-row-tile global bases
    and ``bhv`` the global batch*head ids (None: identity, plain flash).
    ``out_dtype`` bfloat16 (default) or float32; float32 is K2′, the ring's
    launch, counted as the mode ``flash_bwd_dq_fp32``."""
    if _on_cpu(q):
        return flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal, dropout_rate, seed,
                                  qoff, koff, bhv, out_dtype)
    _check_cuda(q, k, v, dout)
    out = _out_dtype(out_dtype)
    BH, S, D = q.shape
    qo, ko, bv = _offset_args(q, qoff, koff, bhv)
    lse, delta = _row_stats(q, lse, delta)
    dq = torch.empty(q.shape, dtype=out, device=q.device)
    dropout, seed32, thr, inv = _dropout_args(dropout_rate, seed)
    lib = _build.load()["flash_bwd"]
    code = lib.flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), qo.data_ptr(), ko.data_ptr(), bv.data_ptr(),
        BH, S, D, int(causal), dropout, int(out == torch.float32), 1.0 / math.sqrt(D),
        seed32, thr, inv, _stream(q),
    )
    _build.check("flash_bwd", code, "flash_bwd_dq launch")
    _build.launched("flash_bwd_dq_fp32" if out == torch.float32 else "flash_bwd_dq")
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool, dropout_rate: float, seed: int,
                  qoff=None, koff=None, bhv=None, out_dtype=None):
    """K3: (dk, dv), each (BH, S, Dh); offsets and ``out_dtype`` as for
    :func:`flash_bwd_dq` (float32 is K3′)."""
    if _on_cpu(q):
        return flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal, dropout_rate, seed,
                                   qoff, koff, bhv, out_dtype)
    _check_cuda(q, k, v, dout)
    out = _out_dtype(out_dtype)
    BH, S, D = q.shape
    qo, ko, bv = _offset_args(q, qoff, koff, bhv)
    lse, delta = _row_stats(q, lse, delta)
    dk = torch.empty(k.shape, dtype=out, device=k.device)
    dv = torch.empty(v.shape, dtype=out, device=v.device)
    dropout, seed32, thr, inv = _dropout_args(dropout_rate, seed)
    lib = _build.load()["flash_bwd"]
    code = lib.flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), qo.data_ptr(), ko.data_ptr(),
        bv.data_ptr(), BH, S, D, int(causal), dropout, int(out == torch.float32),
        1.0 / math.sqrt(D), seed32, thr, inv, _stream(q),
    )
    _build.check("flash_bwd", code, "flash_bwd_dkv launch")
    _build.launched("flash_bwd_dkv_fp32" if out == torch.float32 else "flash_bwd_dkv")
    return dk, dv


# Zeroes every kernel's count, the ring kernels' included.
reset_launch_counts = _build.reset_launch_counts


def launch_counts() -> dict:
    """Launches of K1-K3 in their bf16 mode, the flash path's (the ring's
    are in ``ops.ring_attention.launch_counts``)."""
    return {m: _build.LAUNCHES[m] for m in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}


def head_shard_launch_counts() -> dict:
    """Launches of the head-shard path: K1's ``bhv`` instance and K2-K3 in
    their bf16 mode (K1's first instance counts in :func:`launch_counts`)."""
    return {m: _build.LAUNCHES[m] for m in ("flash_fwd_bhv", "flash_bwd_dq", "flash_bwd_dkv")}


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * out) in fp32, computed outside the kernels as in JAX."""
    return (dout.float() * out.float()).sum(dim=-1)


class FlashAttentionFunction(torch.autograd.Function):
    """(BH, S, Dh) flash attention: K1 forward; delta in plain torch, then K2
    and K3 backward. Saves (q, k, v, out, lse), the seed and either
    ``bh_offset``, the global batch*head id of row 0 (at 0 the kernels take
    their identity ids), or ``bhv``, every row's global id (a head
    shard's)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, dropout_rate: float, seed: int,
                bh_offset: int = 0, bhv: Optional[torch.Tensor] = None):
        out, lse = flash_fwd(q, k, v, causal, dropout_rate, seed, bh_offset, bhv)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.dropout_rate, ctx.seed = causal, dropout_rate, seed
        ctx.bh_offset, ctx.bhv = bh_offset, bhv
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = attention_delta(out, dout)
        bhv = ctx.bhv
        if bhv is None and ctx.bh_offset:
            bhv = _offset_bh_ids(q.shape[0], ctx.bh_offset, q.device)
        args = (q, k, v, dout, lse, delta, ctx.causal, ctx.dropout_rate, ctx.seed)
        dq = flash_bwd_dq(*args, bhv=bhv)
        dk, dv = flash_bwd_dkv(*args, bhv=bhv)
        return dq, dk, dv, None, None, None, None, None


def _to_bhsd(t: torch.Tensor) -> torch.Tensor:
    B, S, H, D = t.shape
    return t.transpose(1, 2).reshape(B * H, S, D).contiguous()


def _from_bhsd(t: torch.Tensor, B: int, H: int) -> torch.Tensor:
    BH, S, D = t.shape
    return t.reshape(B, H, S, D).transpose(1, 2)


def _resolve_dropout(dropout_rate: float, dropout_seed: Optional[int], api: str):
    if dropout_seed is None:
        if dropout_rate > 0.0:
            warnings.warn(
                f"{api}: dropout_rate > 0 with dropout_seed=None; dropout is "
                "DISABLED (deterministic attention). Pass a uint32 dropout_seed "
                "to enable it.", stacklevel=3,
            )
        return 0.0, 0
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    return dropout_rate, int(dropout_seed) & _M32


def _head_shard_ids(B: int, H: int, batch_offset: int, head_offset: int,
                    n_heads: Optional[int], device) -> Optional[torch.Tensor]:
    """Global batch*head ids of a head shard (None for a rank that holds
    every head: its ids are ``batch_offset * H`` plus the local row)."""
    n = H if n_heads is None else n_heads
    if head_offset == 0 and n == H:
        return None
    if head_offset < 0 or head_offset + H > n:
        raise ValueError(f"heads [{head_offset}, {head_offset + H}) do not lie in the "
                         f"{n} heads of the layer")
    return _global_bh_vec(B, H, batch_offset, head_offset, n, device)


def flash_attention(q, k, v, causal: bool = False, dropout_rate: float = 0.0,
                    dropout_seed: Optional[int] = None, batch_offset: int = 0,
                    head_offset: int = 0, n_heads: Optional[int] = None) -> torch.Tensor:
    """Multi-head flash attention over (B, S, H, Dh) inputs -> (B, S, H, Dh).

    ``dropout_rate`` > 0 with a uint32 ``dropout_seed`` drops attention
    probabilities inside the kernels with the coordinate-hash mask; with
    ``dropout_seed=None`` the rate is ignored (with a warning), as in JAX.
    ``batch_offset``: the global batch index of row 0 (a data-parallel
    rank's first row); ``head_offset`` / ``n_heads``: the global index of
    head 0 and the layer's head count (a tensor-parallel rank's head shard;
    default: these are all the heads). Together they key the mask (see the
    module docstring)."""
    B, S, H, D = q.shape
    rate, seed = _resolve_dropout(dropout_rate, dropout_seed, "flash_attention")
    bhv = _head_shard_ids(B, H, batch_offset, head_offset, n_heads, q.device)
    out = FlashAttentionFunction.apply(
        _to_bhsd(q), _to_bhsd(k), _to_bhsd(v), causal, rate, seed, batch_offset * H, bhv,
    )
    return _from_bhsd(out, B, H)


def flash_attention_plain(q, k, v, causal: bool = False, dropout_rate: float = 0.0,
                          dropout_seed: Optional[int] = None, batch_offset: int = 0,
                          head_offset: int = 0, n_heads: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`flash_attention` on any device,
    differentiated by ordinary autograd. Never on the training path: it is
    what a check on the card compares the kernels with."""
    B, S, H, D = q.shape
    rate, seed = _resolve_dropout(dropout_rate, dropout_seed, "flash_attention_plain")
    bhv = _head_shard_ids(B, H, batch_offset, head_offset, n_heads, q.device)
    out, _ = flash_forward_plain(_to_bhsd(q), _to_bhsd(k), _to_bhsd(v), causal, rate, seed,
                                 batch_offset * H, bhv)
    return _from_bhsd(out, B, H)
