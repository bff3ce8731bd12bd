"""Per-layer remat of the port's model (``models/tinygpt.py``).

``dots`` and ``full`` recompute in the backward what ``none`` keeps, so
with the same weights and seeds they must give the same gradients, at
dropout 0.1 too: the MLP mask is drawn from its site seed before the block
runs, since ``torch.utils.checkpoint`` restores no explicit generator and a
recompute that drew its own would drop other elements. At dropout 0 the gradients
are also held to the JAX model's under the same policy (tier S, fp32,
flash attention, the tolerance of tests/test_torch_model.py: 5e-3).
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


def _grads(family, remat, dropout, params=None):
    model = TinyGPT(get_config(family, "S", S, dropout=dropout, compute_dtype=torch.float32,
                               attention_impl="flash", remat=remat))
    if params is None:
        model.init_weights(torch.Generator().manual_seed(0))
    else:
        bridge.load_jax_params(model, params)
    idx = torch.randint(0, model.config.vocab_size, (2, S),
                        generator=torch.Generator().manual_seed(1))
    seeds = [11, 12] if dropout > 0 else None
    masks = (draw_mask_seeds(torch.Generator().manual_seed(3), model.config.n_layer)
             if dropout > 0 else None)
    _, loss = model(idx, idx, attn_seeds=seeds, mask_seeds=masks)
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}, idx


@pytest.mark.parametrize("remat", ["dots", "full", True])
@pytest.mark.parametrize("family", ["tinygpt", "llama"])
def test_remat_gradients_equal_none_with_dropout(family, remat):
    loss, want, _ = _grads(family, "none", 0.1)
    got_loss, got, _ = _grads(family, remat, 0.1)
    assert got_loss == loss
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("remat", ["dots", "full"])
@pytest.mark.parametrize("family", ["tinygpt", "llama"])
def test_remat_gradients_match_jax_remat(family, remat):
    jc = JAX_CONFIG[family]("S", S, dropout=0.0, compute_dtype=jnp.float32,
                            attention_impl="flash", remat=remat)
    params = jtiny.init_params(jc, jax.random.key(0))
    loss, got, idx = _grads(family, remat, 0.0, jax.tree.map(np.asarray, params))
    b = jnp.asarray(idx.numpy().astype(np.int32))
    j_loss, j_grads = jax.value_and_grad(lambda p: jtiny.forward(jc, p, b, b)[1])(params)
    np.testing.assert_allclose(loss, float(j_loss), rtol=2e-3, atol=2e-3)
    g = jax.tree.map(np.asarray, j_grads)
    model = TinyGPT(get_config(family, "S", S))
    for path, p in bridge.leaf_map(model):
        name = ".".join(map(str, (path[0], path[2], path[1]))) if len(path) == 3 else path[0]
        want = g[path[0]] if len(path) == 1 else g["blocks"][path[1]][path[2]]
        np.testing.assert_allclose(got[name].numpy(), want, rtol=5e-3, atol=5e-3, err_msg=name)


def test_remat_none_keeps_what_it_kept():
    """Policy "none" and a legacy False run no checkpoint; an unknown policy
    is refused when the model runs."""
    for remat in ("none", False):
        loss, _, _ = _grads("tinygpt", remat, 0.1)
        assert np.isfinite(loss)
    with pytest.raises(ValueError, match="invalid remat policy"):
        _grads("tinygpt", "auto", 0.0)
