"""Three optimizer steps of the port's train step against the JAX recipe.

Both families, per-device batch 2 x grad-accum 2, dropout 0, fp32 compute,
flash attention, the zero2 optimizer, and the same batch table (the JAX
package's ``SyntheticDataset``, handed over as numpy). The JAX side is
``tinygpt.loss_fn`` + ``strategies.make_optimizer`` composed exactly as
``train/step.py`` composes them for one device: the step's rows gathered
as (accum, micro, S), grads summed over micro-batches and divided by
accum, the mean loss, then clip + AdamW. Losses agree to 1e-5 relative.
Params agree to 1e-5 relative plus 2e-6 absolute, 5% of the largest
learning-rate step taken here (4e-5): Adam divides each gradient element by
its own running RMS, so an element whose gradient is near zero moves by a
fraction of a step that fp32 rounding differences between the two
backward passes can change.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_llm_training_benchmark_framework_tpu.data.synthetic import (
    SyntheticDataset as JaxSyntheticDataset,
)
from distributed_llm_training_benchmark_framework_tpu.models import llama as jllama
from distributed_llm_training_benchmark_framework_tpu.models import tinygpt as jtiny
from distributed_llm_training_benchmark_framework_tpu.parallel import strategies as jstrat
from distributed_llm_training_benchmark_framework_tpu_torch import bridge
from distributed_llm_training_benchmark_framework_tpu_torch.models import TinyGPT, get_config
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import strategies as tstrat
from distributed_llm_training_benchmark_framework_tpu_torch.train.step import TrainStep

S, MICRO, ACCUM, STEPS = 64, 2, 2, 3
JAX_CONFIG = {"tinygpt": jtiny.get_model_config, "llama": jllama.get_llama_config}


@pytest.mark.parametrize("family", ["tinygpt", "llama"])
def test_three_steps_match_jax(family):
    jc = JAX_CONFIG[family]("S", S, dropout=0.0, compute_dtype=jnp.float32,
                            attention_impl="flash")
    params = jtiny.init_params(jc, jax.random.key(0))
    table = JaxSyntheticDataset(jc.vocab_size, S, size=10, seed=42).data
    tx = jstrat.make_optimizer(jstrat.get_strategy("zero2"))
    state = tx.init(params)
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: jtiny.loss_fn(jc, p, b, b)))

    model = TinyGPT(get_config(family, "S", S, dropout=0.0, compute_dtype=torch.float32,
                               attention_impl="flash"))
    bridge.load_jax_params(model, jax.tree.map(np.asarray, params))
    step_fn = TrainStep(model, tstrat.make_optimizer(tstrat.get_strategy("zero2"),
                                                     model.parameters()),
                        grad_accum=ACCUM, micro_batch=MICRO, seed=0, device=torch.device("cpu"))
    t_table = torch.from_numpy(table.astype(np.int64))

    for step in range(STEPS):
        G = ACCUM * MICRO
        rows = (step * G + np.arange(G)) % table.shape[0]
        batch = jnp.asarray(table[rows].reshape(ACCUM, MICRO, S))
        loss_sum, grads = 0.0, jax.tree.map(jnp.zeros_like, params)
        for j in range(ACCUM):
            loss, g = grad_fn(params, batch[j])
            loss_sum += loss
            grads = jax.tree.map(jnp.add, grads, g)
        grads = jax.tree.map(lambda g: g / ACCUM, grads)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)

        t_loss = step_fn(t_table, step)
        np.testing.assert_allclose(t_loss.item(), float(loss_sum / ACCUM), rtol=1e-5,
                                   err_msg=f"loss, step {step}")
        got = bridge.export_params(model)
        want = jax.tree.map(np.asarray, params)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=2e-6, err_msg=f"params, step {step}")
