from .llama import get_llama_config
from .tinygpt import TinyGPT, TinyGPTConfig, count_params, draw_mask_seeds, get_model_config

MODEL_FAMILIES = ("tinygpt", "llama")


def get_config(model_family: str, tier: str, seq_len: int, **overrides) -> TinyGPTConfig:
    """The config of ``model_family`` at ``tier`` (the two tier tables)."""
    if model_family == "tinygpt":
        return get_model_config(tier, seq_len, **overrides)
    if model_family == "llama":
        return get_llama_config(tier, seq_len, **overrides)
    raise ValueError(f"unknown model family {model_family!r} (expected one of {MODEL_FAMILIES})")


__all__ = [
    "MODEL_FAMILIES", "TinyGPT", "TinyGPTConfig", "count_params", "draw_mask_seeds",
    "get_config", "get_llama_config", "get_model_config",
]
