"""The port's llama against Hugging Face ``LlamaForCausalLM``, as
``tests/test_llama_family.py::test_logits_parity_vs_hf_transformers`` holds
the JAX package's.

HF's model is built from a local ``LlamaConfig`` (no download) with the
JAX package's init weights (``init_params``) copied in; the port's model
takes the same weights through ``bridge.load_jax_params``. Both run fp32
on the same token ids, and the logits agree at ``atol=2e-4, rtol=2e-3``
(JAX's test's tolerance): the rotate-half RoPE, RMSNorm, SiLU gating, the
GQA grouping (tier S: 2 query heads over 1 kv head; and 4 over 2) and the
untied head, through the reference attention and through flash's plain
version (what the kernels are held to on the card).
"""

import jax
import numpy as np
import pytest
import torch

from distributed_llm_training_benchmark_framework_tpu.models import llama as jllama
from distributed_llm_training_benchmark_framework_tpu.models.tinygpt import init_params
from distributed_llm_training_benchmark_framework_tpu_torch import bridge
from distributed_llm_training_benchmark_framework_tpu_torch.models import TinyGPT, get_config

transformers = pytest.importorskip("transformers")

S = 64
HEADS = {"tierS": {}, "gqa4x2": {"n_head": 4, "n_kv_head": 2}}


def _hf_model(cfg, params):
    hf_cfg = transformers.LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.n_embd, intermediate_size=cfg.mlp_dim,
        num_hidden_layers=cfg.n_layer, num_attention_heads=cfg.n_head,
        num_key_value_heads=cfg.kv_heads, max_position_embeddings=cfg.block_size,
        rms_norm_eps=cfg.norm_eps, rope_theta=cfg.rope_theta, attention_bias=False,
        mlp_bias=False, tie_word_embeddings=False, attention_dropout=0.0)
    model = transformers.LlamaForCausalLM(hf_cfg).eval()

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    b = params["blocks"]
    with torch.no_grad():
        model.model.embed_tokens.weight.copy_(t(params["wte"]))
        model.model.norm.weight.copy_(t(params["lnf_scale"]))
        model.lm_head.weight.copy_(t(params["lm_head"]))
        for i, layer in enumerate(model.model.layers):
            layer.input_layernorm.weight.copy_(t(b["ln1_scale"][i]))
            layer.post_attention_layernorm.weight.copy_(t(b["ln2_scale"][i]))
            # (in, out) leaves; a Linear stores (out, in).
            layer.self_attn.q_proj.weight.copy_(t(b["wq"][i]).T)
            layer.self_attn.k_proj.weight.copy_(t(b["wkv"][i, :, 0]).T)
            layer.self_attn.v_proj.weight.copy_(t(b["wkv"][i, :, 1]).T)
            layer.self_attn.o_proj.weight.copy_(t(b["wo"][i]).T)
            layer.mlp.gate_proj.weight.copy_(t(b["wgu"][i, :, 0]).T)
            layer.mlp.up_proj.weight.copy_(t(b["wgu"][i, :, 1]).T)
            layer.mlp.down_proj.weight.copy_(t(b["wproj"][i]).T)
    return model


@pytest.mark.parametrize("heads", list(HEADS))
@pytest.mark.parametrize("attention", ["reference", "flash"])
def test_logits_equal_hf_llama(heads, attention):
    jcfg = jllama.get_llama_config("S", S, **HEADS[heads])
    params = jax.tree.map(np.asarray, init_params(jcfg, jax.random.key(0)))
    hf = _hf_model(jcfg, params)
    model = TinyGPT(get_config("llama", "S", S, compute_dtype=torch.float32,
                               attention_impl=attention, **HEADS[heads]))
    bridge.load_jax_params(model, params)
    assert model.config.kv_heads == jcfg.kv_heads < model.config.n_head
    idx = np.array(jax.random.randint(jax.random.key(7), (2, S), 0, jcfg.vocab_size))
    with torch.no_grad():
        ours = model(torch.from_numpy(idx))[0].numpy()
        theirs = hf(torch.from_numpy(idx)).logits.numpy()
    np.testing.assert_allclose(ours, theirs, atol=2e-4, rtol=2e-3)
