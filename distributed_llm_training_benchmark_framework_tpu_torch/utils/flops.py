"""Analytic model-FLOPs accounting and MFU.

Port of ``distributed_llm_training_benchmark_framework_tpu/utils/flops.py``:
``forward_flops_per_token`` / ``train_flops_per_token`` are the same
formulas (matmul terms only, backward = 2x forward, causal attention charged
at S/2; a MoE layer counts its k active experts and the router, JAX's
``2*k*(2*D*F) + 2*D*E``). The peak table holds NVIDIA cards only.
``tokens_per_dollar`` is JAX's, over JAX's price table (Cloud TPU list
prices): the repo holds no cited price for an NVIDIA card, so on the H100
it is None, as JAX's is for a device it has no price for.
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


# Public on-demand US-region list prices, USD per chip-hour (Cloud TPU pricing
# page, mid-2025; multi-chip pod types priced per chip): JAX's table, copied.
# The reference's cost-efficiency metric (reference README.md:270-276) uses
# its cloud's A10 on-demand rate the same way. Same substring-match
# convention as the peak table; order matters. An NVIDIA card's price joins
# only with a cited source in the repo.
_ONDEMAND_USD_PER_CHIP_HR = (
    ("TPU v6 lite", 2.70),  # Trillium / v6e
    ("TPU v6", 2.70),
    ("TPU v5 lite", 1.20),  # v5e
    ("TPU v5e", 1.20),
    ("TPU v5p", 4.20),
    ("TPU v5", 4.20),
    ("TPU v4", 3.22),
    ("TPU v3", 2.00),
    ("TPU v2", 1.125),
)


def device_usd_per_chip_hour(device_kind: str) -> Optional[float]:
    """On-demand $/chip-hour for a device kind, or None if unknown."""
    for name, price in _ONDEMAND_USD_PER_CHIP_HR:
        if name.lower() in device_kind.lower():
            return price
    return None


def tokens_per_dollar(tokens_per_sec_per_chip: float, device_kind: str) -> Optional[float]:
    """Tokens processed per on-demand dollar, or None without a price."""
    price = device_usd_per_chip_hour(device_kind)
    if price is None or tokens_per_sec_per_chip <= 0:
        return None
    return tokens_per_sec_per_chip * 3600.0 / price
