"""The five attention-forward variants of the head-dim-64 microbench:
hand-written Hopper kernels and their plain PyTorch versions.

Port of the Pallas TPU kernels in ``scripts/microbench_flash_fwd.py`` (TPU
layout experiments that sit outside the JAX package). One CUDA C++ source,
``csrc/fwd_variants.cu``, holds all five:

===================  ===================================  =============================
wrapper              replaces (microbench_flash_fwd.py)   computes
===================  ===================================  =============================
``fwd_current``      ``_fwd_kernel_current`` (``:83``)    softmax attention forward
``fwd_headpair``     ``_fwd_kernel_headpair`` (``:140``)  the same, two heads per CTA
``fwd_kt``           ``_fwd_kernel_kt`` (``:199``)        the same, k as (BH, Dh, S)
``fwd_matmul_only``  ``_fwd_kernel_matmul_only``          bf16(Σ bf16(scale·q·kᵀ)·v)
                     (``:258``)
``fwd_qscaled``      ``_fwd_kernel_qscaled`` (``:303``)   softmax, scale folded into q
===================  ===================================  =============================

All are non-causal with no dropout, bf16 in and out, scale 1/sqrt(Dh), and
no lse. On the H100 each is bound by its 4*BH*S^2*Dh tensor FLOPs; the
softmax variants' BH*S^2 exponentials come close behind at Dh 64.

All five run the flash forward's Hopper wgmma mainloop
(``csrc/flash_fwd_sm90.cuh``, K1's). K5, K6 and K7 give K1's output
(``flash_attention.flash_fwd`` at rate 0, non-causal) bit for bit: K5
(``fwd_current``) is the loop's plain instance, K7 (``fwd_kt``) reads kᵀ
through a transposed (MN-major) operand descriptor, K6 (``fwd_headpair``)
runs two warpgroups per CTA, one per head of the pair. K9 (``fwd_qscaled``)
multiplies the q tile in shared memory by bf16(scale) before the first
product and leaves the scores unscaled; at Dh 64 (scale 2⁻³) it equals K5
bit for bit. K8 (``fwd_matmul_only``) is the loop's matmul-only instance:
K5's tiles and products with P = bf16(scale·s) in place of the softmax.

Every plain version keeps its Pallas kernel's roundings: fp32 scores, fp32
max and sum, p rounded to bf16 before p·v, fp32 accumulation, one cast of
the output. They compute the softmax in one pass where the kernels rescale
online; the two agree to about 2e-3 rel-Frobenius (p is rounded to bf16 at
a different running max).

Each wrapper takes bfloat16 contiguous (BH, S, Dh) tensors (k as (BH, Dh, S)
for ``fwd_kt``), with Dh 64 or 128, S a multiple of 64 (the kernels' tile)
and, for ``fwd_headpair``, an even BH; it refuses anything else on every
device. On a CPU tensor it runs its plain version; on a CUDA tensor it
launches its kernel or raises. Each launch adds one to
``_build.LAUNCHES[<wrapper name>]`` and nothing else does.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .flash_attention import HEAD_DIMS, TILE, _stream


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------


def _scale(q: torch.Tensor) -> float:
    return 1.0 / math.sqrt(q.shape[-1])


def _softmax_forward(q, k, v, scale) -> torch.Tensor:
    """out = bf16((bf16(exp(s - max)) · v) / sum), s = q·kᵀ (× ``scale``)."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2))
    if scale is not None:
        s = s * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / p.sum(dim=-1, keepdim=True)).to(q.dtype)


def fwd_current_plain(q, k, v) -> torch.Tensor:
    """K5: softmax attention, the scale applied to the fp32 scores."""
    return _softmax_forward(q, k, v, _scale(q))


def fwd_headpair_plain(q, k, v) -> torch.Tensor:
    """K6: K5's function; refuses an odd BH, as the JAX microbench does."""
    _check_even_bh(q)
    return fwd_current_plain(q, k, v)


def fwd_kt_plain(q, kt, v) -> torch.Tensor:
    """K7: K5's function with k given transposed, (BH, Dh, S)."""
    return _softmax_forward(q, kt.transpose(1, 2), v, _scale(q))


def fwd_qscaled_plain(q, k, v) -> torch.Tensor:
    """K9: q·bf16(scale) rounded to bf16 first, the scores left unscaled.
    At Dh 64 the scale is 2^-3 and this equals K5 bit for bit; at Dh 128
    bf16(1/sqrt(128)) = 0.08837890625 and it differs by about an ulp."""
    qs = (q.float() * float(torch.tensor(_scale(q), dtype=torch.bfloat16))).to(q.dtype)
    return _softmax_forward(qs, k, v, None)


def fwd_matmul_only_plain(q, k, v) -> torch.Tensor:
    """K8: the two products alone, bf16(Σ bf16(scale·q·kᵀ)·v), fp32 sums."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * _scale(q)
    return torch.matmul(s.to(v.dtype).float(), v.float()).to(q.dtype)


def sdpa_materialized_plain(q, k, v) -> torch.Tensor:
    """The microbench's reference (JAX ``xla_sdpa``): fp32 scores, softmax
    normalized before p is cast to bf16, then p·v. A plain reference, not a
    kernel."""
    p = torch.softmax(torch.matmul(q.float(), k.float().transpose(1, 2)) * _scale(q), dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


PLAIN = {
    "fwd_current": fwd_current_plain,
    "fwd_headpair": fwd_headpair_plain,
    "fwd_kt": fwd_kt_plain,
    "fwd_matmul_only": fwd_matmul_only_plain,
    "fwd_qscaled": fwd_qscaled_plain,
}


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_even_bh(q: torch.Tensor) -> None:
    if q.shape[0] % 2:
        raise ValueError(f"the headpair variant pairs heads: BH must be even, got {q.shape[0]}")


def _check(q, k, v, kt: bool = False) -> None:
    """Refuse what the kernels do not take, on every device."""
    if q.dim() != 3:
        raise ValueError(f"the forward variants take (BH, S, Dh) tensors, got {tuple(q.shape)}")
    BH, S, D = q.shape
    want_k = (BH, D, S) if kt else (BH, S, D)
    for name, t, shape in (("q", q, (BH, S, D)), ("k", k, want_k), ("v", v, (BH, S, D))):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"the forward variants take bfloat16, got {name} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the forward variants take contiguous tensors; {name} is not")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != q.device:
            raise ValueError(f"tensors on different devices: {t.device} vs {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the forward variants run on cpu or cuda tensors, got {q.device}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported by the kernels (need one of {HEAD_DIMS})")
    if S % TILE:
        raise ValueError(f"sequence length {S} must be a multiple of the tile size {TILE}")


def _run(name: str, q, k, v) -> torch.Tensor:
    """The plain version for CPU tensors; else launch the kernel ``name``."""
    if q.device.type == "cpu":
        return PLAIN[name](q, k, v)
    BH, S, D = q.shape
    out = torch.empty_like(q)
    lib = _build.load()["fwd_variants"]
    code = getattr(lib, name)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                              BH, S, D, _scale(q), _stream(q))
    _build.check("fwd_variants", code, f"{name} launch")
    _build.launched(name)
    return out


def fwd_current(q, k, v) -> torch.Tensor:
    """K5 (``_fwd_kernel_current``): (BH, S, Dh) -> out (BH, S, Dh)."""
    _check(q, k, v)
    return _run("fwd_current", q, k, v)


def fwd_headpair(q, k, v) -> torch.Tensor:
    """K6 (``_fwd_kernel_headpair``): K5's function, heads 2p and 2p+1 in one
    CTA; BH must be even."""
    _check(q, k, v)
    _check_even_bh(q)
    return _run("fwd_headpair", q, k, v)


def fwd_kt(q, kt, v) -> torch.Tensor:
    """K7 (``_fwd_kernel_kt``): K5's function with ``kt`` = kᵀ, (BH, Dh, S)."""
    _check(q, kt, v, kt=True)
    return _run("fwd_kt", q, kt, v)


def fwd_matmul_only(q, k, v) -> torch.Tensor:
    """K8 (``_fwd_kernel_matmul_only``): bf16(Σ bf16(scale·q·kᵀ)·v)."""
    _check(q, k, v)
    return _run("fwd_matmul_only", q, k, v)


def fwd_qscaled(q, k, v) -> torch.Tensor:
    """K9 (``_fwd_kernel_qscaled``): K5's function with the scale folded into
    q in bf16."""
    _check(q, k, v)
    return _run("fwd_qscaled", q, k, v)


WRAPPERS = {
    "fwd_current": fwd_current,
    "fwd_headpair": fwd_headpair,
    "fwd_kt": fwd_kt,
    "fwd_matmul_only": fwd_matmul_only,
    "fwd_qscaled": fwd_qscaled,
}
VARIANTS = tuple(WRAPPERS)


def launch_counts() -> dict:
    """Launches of K5-K9 since the last ``_build.reset_launch_counts``."""
    return {n: _build.LAUNCHES[n] for n in VARIANTS}
