"""The port's zero2 optimizer against optax on a tier-S parameter tree.

Six updates of ``make_optimizer(get_strategy("zero2"))`` on both sides from
the same parameters and the same numpy gradients: the 5-step linear warmup
(update 0 at lr 0) and one update whose gradients are 1e3 times larger, so
that the global-norm clip is active there and inactive elsewhere. Params
agree to 1e-6 relative, plus an absolute 3e-9: 3e-5 of one 1e-4 learning-
rate step. optax evaluates Adam's bias correction 1 - 0.999^t in fp32, where
the cancellation leaves up to 2e-5 relative error for t <= 6 (torch uses
double), and that error reaches the update of a near-zero leaf, such as a
bias, unscaled.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from distributed_llm_training_benchmark_framework_tpu.models import tinygpt as jtiny
from distributed_llm_training_benchmark_framework_tpu.parallel import strategies as jstrat
from distributed_llm_training_benchmark_framework_tpu_torch import bridge
from distributed_llm_training_benchmark_framework_tpu_torch.models import TinyGPT, get_config
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import strategies as tstrat

SCALES = (1e-4, 1e-4, 1e-4, 1e-1, 1e-4, 1e-4)  # update 3: clip active


def _setup():
    jc = jtiny.get_model_config("S", 64)
    params = jax.tree.map(np.asarray, jtiny.init_params(jc, jax.random.key(0)))
    model = TinyGPT(get_config("tinygpt", "S", 64))
    bridge.load_jax_params(model, params)
    return params, model


def test_strategy_table_matches_jax():
    for name, s in tstrat.STRATEGIES.items():
        j = jstrat.get_strategy(name)
        for f in ("learning_rate", "betas", "eps", "weight_decay", "warmup_steps",
                  "grad_clip"):
            assert getattr(s, f) == getattr(j, f), (name, f)
    with pytest.raises(ValueError):
        tstrat.get_strategy("nope")


def test_schedule_matches_optax():
    sched = tstrat.linear_schedule(0.0, 1e-4, 5)
    ref = optax.linear_schedule(init_value=0.0, end_value=1e-4, transition_steps=5)
    for count in range(9):
        assert sched(count) == pytest.approx(float(ref(count)), rel=1e-6, abs=1e-12)
    assert sched(0) == 0.0


def test_zero2_updates_match_optax():
    params, model = _setup()
    tx = jstrat.make_optimizer(jstrat.get_strategy("zero2"))
    state = tx.init(params)
    update = jax.jit(tx.update)
    opt = tstrat.make_optimizer(tstrat.get_strategy("zero2"), model.parameters())
    rng = np.random.default_rng(0)
    jp = params
    for step, scale in enumerate(SCALES):
        grads = jax.tree.map(
            lambda x: (scale * rng.standard_normal(x.shape)).astype(np.float32), jp)
        norm = float(optax.global_norm(grads))
        assert (norm > 1.0) == (scale > 1e-3), norm  # the clip fires exactly at update 3
        updates, state = update(grads, state, jp)
        jp = jax.tree.map(np.asarray, optax.apply_updates(jp, updates))
        for path, p in bridge.leaf_map(model):
            g = grads[path[0]] if len(path) == 1 else grads["blocks"][path[1]][path[2]]
            p.grad = torch.from_numpy(np.array(g))
        opt.step()
        got = bridge.export_params(model)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=3e-9, err_msg=f"update {step}")
        if step == 0:  # lr 0: nothing moved
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
                np.testing.assert_array_equal(a, b)
