"""Llama family: a configuration of the shared transformer (``models.tinygpt``).

Port of ``distributed_llm_training_benchmark_framework_tpu/models/llama.py``:
RMSNorm, rotary positions, SwiGLU MLP, grouped-query attention, no biases,
untied LM head, causal, no dropout. Head dim 128 at tiers A and B.
"""

from __future__ import annotations

from .tinygpt import TinyGPTConfig

# (vocab, d_model, n_head, n_kv_head, n_layer, mlp_hidden)
TIERS = {
    "A": dict(vocab_size=32000, n_embd=1024, n_head=8, n_kv_head=4,
              n_layer=16, mlp_hidden=2816),    # ~255M params
    "B": dict(vocab_size=32000, n_embd=2048, n_head=16, n_kv_head=8,
              n_layer=32, mlp_hidden=5632),    # ~1.62B params
    "S": dict(vocab_size=512, n_embd=128, n_head=2, n_kv_head=1,
              n_layer=2, mlp_hidden=352),      # CPU tests
}


def get_llama_config(tier: str, seq_len: int, **overrides) -> TinyGPTConfig:
    """Llama-family tier table (same call shape as ``get_model_config``)."""
    if tier not in TIERS:
        raise ValueError(f"Unknown llama tier: {tier!r} (expected one of {sorted(TIERS)})")
    kw = dict(TIERS[tier])
    kw.update(
        block_size=seq_len, causal=True, norm="rmsnorm", pos_embed="rope",
        mlp_act="swiglu", bias=False, tie_embeddings=False, dropout=0.0,
    )
    kw.update(overrides)
    return TinyGPTConfig(**kw)
