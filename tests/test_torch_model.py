"""The port's model against the JAX model at tier S, through the bridge.

Same weights (the JAX init, carried over by ``bridge.load_jax_params``), same
batch; logits, loss and every gradient are compared for both families, fp32
and bf16 compute, and both attention implementations. The port runs on the
CPU (its plain attention versions); JAX runs flash in Pallas interpret mode.
Tolerances: 2e-3 for fp32 logits/loss, 3e-2 for bf16 (one bf16 ulp at the
logits' magnitude), 5e-3 for gradients (those of tests/test_attention_ops.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_training_benchmark_framework_tpu.models import llama as jllama
from distributed_llm_training_benchmark_framework_tpu.models import tinygpt as jtiny
from distributed_llm_training_benchmark_framework_tpu_torch import bridge
from distributed_llm_training_benchmark_framework_tpu_torch.models import (
    TinyGPT,
    draw_mask_seeds,
    get_config,
)

S = 64
JAX_CONFIG = {"tinygpt": jtiny.get_model_config, "llama": jllama.get_llama_config}
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-3), "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _pair(family, dtype="f32", impl="reference", **kw):
    jdt, tdt, _ = DTYPES[dtype]
    jc = JAX_CONFIG[family]("S", S, dropout=0.0, compute_dtype=jdt, attention_impl=impl, **kw)
    params = jtiny.init_params(jc, jax.random.key(0))
    model = TinyGPT(get_config(family, "S", S, dropout=0.0, compute_dtype=tdt,
                               attention_impl=impl, **kw))
    bridge.load_jax_params(model, jax.tree.map(np.asarray, params))
    return jc, params, model


@pytest.mark.parametrize("family", ["tinygpt", "llama"])
def test_bridge_maps_every_leaf_once_and_round_trips(family):
    _, params, model = _pair(family)
    jax_np = jax.tree.map(np.asarray, params)
    paths = [path for path, _ in bridge.leaf_map(model)]
    assert len(paths) == len(set(paths))
    n_jax = sum(1 for k in jax_np if k != "blocks") + sum(
        v.shape[0] for v in jax_np["blocks"].values())
    assert len(paths) == n_jax
    back = bridge.export_params(model)
    assert jax.tree.structure(back) == jax.tree.structure(jax_np)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax_np)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        bridge.load_jax_params(model, {**jax_np, "extra_leaf": np.zeros(3)})


@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("family", ["tinygpt", "llama"])
def test_logits_loss_grads_match_jax(family, dtype, impl):
    jc, params, model = _pair(family, dtype, impl)
    tol = DTYPES[dtype][2]
    rng = np.random.default_rng(1)
    idx = rng.integers(0, jc.vocab_size, (2, S)).astype(np.int32)
    tgt = idx.copy()
    tgt[0, :5] = -1  # ignore_index

    def jloss(p):
        logits, loss = jtiny.forward(jc, p, jnp.asarray(idx), jnp.asarray(tgt))
        return loss, logits

    (j_loss, j_logits), j_grads = jax.value_and_grad(jloss, has_aux=True)(params)
    t_logits, t_loss = model(torch.from_numpy(idx).long(), torch.from_numpy(tgt).long())
    t_loss.backward()
    assert t_logits.dtype == torch.float32
    np.testing.assert_allclose(t_logits.detach().numpy(), np.asarray(j_logits), rtol=tol, atol=tol)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=tol, atol=tol)
    g = jax.tree.map(np.asarray, j_grads)
    for path, p in bridge.leaf_map(model):
        want = g[path[0]] if len(path) == 1 else g["blocks"][path[1]][path[2]]
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=5e-3, atol=5e-3,
                                   err_msg="/".join(map(str, path)))


def test_causal_tinygpt_and_dropout_paths_run():
    """Options off the bench path still run: causal TinyGPT, and dropout with
    explicit seeds (masks differ from JAX's, so only shapes and
    finiteness are checked)."""
    model = TinyGPT(get_config("tinygpt", "S", S, causal=True, dropout=0.1,
                               attention_impl="flash"))
    model.init_weights(torch.Generator().manual_seed(0))
    idx = torch.randint(0, 512, (2, S), generator=torch.Generator().manual_seed(0))
    logits, loss = model(idx, idx, attn_seeds=[1, 2],
                         mask_seeds=draw_mask_seeds(torch.Generator().manual_seed(0),
                                                    model.config.n_layer))
    assert logits.shape == (2, S, 512) and torch.isfinite(loss)
