"""Analytic model-FLOPs accounting and MFU.

Port of ``distributed_llm_training_benchmark_framework_tpu/utils/flops.py``:
``forward_flops_per_token`` / ``train_flops_per_token`` are the same
formulas (matmul terms only, backward = 2x forward, causal attention charged
at S/2; a MoE layer counts its k active experts and the router, JAX's
``2*k*(2*D*F) + 2*D*E``). The peak table holds NVIDIA cards only.
"""

from __future__ import annotations

from typing import Optional

# bf16 dense peak TFLOP/s per card (NVIDIA H100 data sheet, no sparsity).
# Matched by substring against torch.cuda.get_device_name(); order matters
# (the PCIe part before the generic H100 name, which the SXM part carries,
# e.g. "NVIDIA H100 80GB HBM3").
_PEAK_TFLOPS_BF16 = (
    ("H100 PCIe", 756.0),
    ("H100", 989.0),
)


def device_peak_tflops(device_kind: str) -> Optional[float]:
    """bf16 dense peak TFLOP/s for a device name, or None if unknown (CPU)."""
    for name, peak in _PEAK_TFLOPS_BF16:
        if name.lower() in device_kind.lower():
            return peak
    return None


def forward_flops_per_token(config) -> float:
    """Analytic forward FLOPs per token (same formula as the JAX package)."""
    D, L, V, S = config.n_embd, config.n_layer, config.vocab_size, config.block_size
    H = config.n_head
    Hkv = config.kv_heads
    Fm = config.mlp_dim
    Dh = D // H
    if config.n_experts > 0:
        mlp = 2 * config.expert_top_k * (2 * D * Fm) + 2 * D * config.n_experts
    elif config.mlp_act == "swiglu":
        mlp = 2 * (2 * D * Fm + Fm * D)
    else:
        mlp = 2 * (D * Fm + Fm * D)
    attn_tokens = S / 2 if config.causal else S
    per_layer = (
        2 * D * (H * Dh)
        + 2 * D * (2 * Hkv * Dh)
        + 2 * (H * Dh) * D
        + mlp
        + 4 * attn_tokens * (H * Dh)
    )
    return float(L * per_layer + 2 * D * V)


def train_flops_per_token(config) -> float:
    """fwd + bwd FLOPs per token (bwd = 2x fwd)."""
    return 3.0 * forward_flops_per_token(config)


def achieved_tflops_per_sec(tokens_per_sec_per_chip: float, flops_per_token: float) -> float:
    return tokens_per_sec_per_chip * flops_per_token / 1e12


def mfu_pct(tokens_per_sec_per_chip: float, flops_per_token: float,
            device_kind: str) -> Optional[float]:
    """Model-FLOPs utilization in percent, or None for unknown devices."""
    peak = device_peak_tflops(device_kind)
    if peak is None or flops_per_token <= 0 or tokens_per_sec_per_chip <= 0:
        return None
    return 100.0 * achieved_tflops_per_sec(tokens_per_sec_per_chip, flops_per_token) / peak
