"""The port's Mixture-of-Experts layer and MoE model against the JAX
package, in one process on the CPU (``models/moe.py``).

Tier S with 4 experts (top-2, capacity factor 1.25, JAX's defaults), S 64,
inputs from numpy seeds. Tolerances, per test:

- routing decisions (expert ids, the one-hot dispatch tensor, the drop
  fraction, capacity) are exact: the same experts and slots. The router
  probabilities, and so the combine weights, agree within 2e-5 relative:
  XLA and the CPU GEMM sum the logits' D products in other orders, and the
  softmax carries those fp32 roundings into the probabilities;
- the index form (the main path) against the one-hot plain form: bit for
  bit at bf16 compute, where each combine sums k 2 exact products; at fp32
  compute within 2^-22 of the largest magnitude, where the plain form's
  GEMM may fuse a product into its sum (one fp32 rounding less);
- outputs and gradients against JAX's einsum formulation (``jax.grad``):
  fp32 within 1e-5 of the largest magnitude; bf16 within 2e-2 of it (each
  of the layer's bf16 roundings, 2^-8 relative, in another order than
  XLA's);
- the whole model, forward and loss, with ``tests/test_torch_model.py``'s
  tolerances (2e-3 fp32, 3e-2 bf16). At bf16 the router reads a stream
  whose bf16 roundings differ from XLA's by an ulp, and JAX's init (router
  0.02) leaves top-2 choices a few ulps apart, so some tokens would pick
  other experts on the two sides; the bf16 case scales the routers by 25
  (logit gaps of order 1), as training makes them, so both sides route
  alike. Three zero2 steps with
  ``tests/test_torch_train_step.py``'s (loss 1e-5 relative, params 1e-5
  relative plus 2e-6 absolute).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_llm_training_benchmark_framework_tpu.data.synthetic import (
    SyntheticDataset as JaxSyntheticDataset,
)
from distributed_llm_training_benchmark_framework_tpu.models import moe as jmoe
from distributed_llm_training_benchmark_framework_tpu.models import tinygpt as jtiny
from distributed_llm_training_benchmark_framework_tpu.parallel import strategies as jstrat
from distributed_llm_training_benchmark_framework_tpu.utils import flops as jflops
from distributed_llm_training_benchmark_framework_tpu_torch import bridge
from distributed_llm_training_benchmark_framework_tpu_torch.models import (
    TinyGPT,
    count_params,
    get_config,
)
from distributed_llm_training_benchmark_framework_tpu_torch.models import moe as tmoe
from distributed_llm_training_benchmark_framework_tpu_torch.models.tinygpt import (
    moe_overflow_fraction,
)
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import strategies as tstrat
from distributed_llm_training_benchmark_framework_tpu_torch.train.step import TrainStep
from distributed_llm_training_benchmark_framework_tpu_torch.utils import flops as tflops

S, E, D, F = 64, 4, 128, 512
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
LAYER_TOL = {"f32": 1e-5, "bf16": 2e-2}
MODEL_TOL = {"f32": 2e-3, "bf16": 3e-2}
LEAVES = ("router", "moe_w1", "moe_b1", "moe_w2", "moe_b2")


def configs(dtype="f32", **kw):
    jdt, tdt = DTYPES[dtype]
    kw = dict(n_experts=E, dropout=0.0, attention_impl="reference", **kw)
    return (jtiny.get_model_config("S", S, compute_dtype=jdt, **kw),
            get_config("tinygpt", "S", S, compute_dtype=tdt, **kw))


def layer_inputs(seed=0, router_scale=0.02, B=2):
    rng = np.random.default_rng(seed)
    shapes = dict(router=(D, E), moe_w1=(E, D, F), moe_b1=(E, F), moe_w2=(E, F, D), moe_b2=(E, D))
    layer = {k: (0.02 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
    layer["router"] *= router_scale / 0.02
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    dy = rng.standard_normal((B, S, D)).astype(np.float32)
    return x, layer, dy


def torch_layer(c, x, layer, plain=False, aux_mode=None):
    """The port's layer on torch leaves -> (y, aux, x leaf, {leaf: tensor})."""
    tx = torch.from_numpy(x).requires_grad_()
    tl = {k: torch.from_numpy(v).requires_grad_() for k, v in layer.items()}
    xc = tx.to(c.compute_dtype)
    if plain:
        y, aux = tmoe.moe_mlp_plain(c, xc, *(tl[k] for k in LEAVES), aux_mode=aux_mode)
    else:
        def ffn(xin):
            return tmoe.expert_ffn(xin, *(tl[k] for k in LEAVES[1:]), c.compute_dtype)

        y, aux = tmoe.moe_mlp(c, xc, tl["router"], ffn, aux_mode=aux_mode)
    return y, aux, tx, tl


@pytest.mark.parametrize("n,e,k,factor", [(128, 4, 2, 1.0), (10, 8, 2, 1.0), (2048, 8, 2, 1.25),
                                          (1024, 8, 2, 1.25), (64, 4, 1, 0.5), (7, 3, 2, 8.0)])
def test_capacity_is_jaxs(n, e, k, factor):
    assert tmoe.capacity(n, e, k, factor) == jmoe.capacity(n, e, k, factor)
    assert tmoe.capacity(2048, 8, 2, 1.25) == 640  # the 1.18B row's layer


@pytest.mark.parametrize("case", ["random", "ties", "overflow"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_route_is_jaxs_exactly(dtype, case):
    """Expert ids, the one-hot dispatch tensor and the drop fraction equal
    JAX's ``_route``, the combine tensor and the probabilities within fp32
    roundings (module docstring); "ties": a zero router gives every
    expert probability 1/E and both sides pick experts 0 and 1 (the lower
    index first); "overflow": capacity factor 0.5 drops assignments."""
    factor = 0.5 if case == "overflow" else 1.25
    jc, tc = configs(dtype, capacity_factor=factor)
    x, layer, _ = layer_inputs(1, router_scale=0.0 if case == "ties" else 0.5)
    N = x.shape[0] * S
    cap = tmoe.capacity(N, E, 2, factor)
    xt = x.reshape(N, D)
    jd, jcomb, jprobs, jidx, jdrop = jmoe._route(jc, jnp.asarray(xt).astype(jc.compute_dtype),
                                                 jnp.asarray(layer["router"]), cap)
    r = tmoe.route(torch.from_numpy(xt).to(tc.compute_dtype), torch.from_numpy(layer["router"]),
                   2, cap)
    td, tcomb = tmoe.plain_dispatch(r, E, cap, tc.compute_dtype)
    np.testing.assert_array_equal(r.expert_idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(td.float().numpy(), np.asarray(jd, np.float32))
    np.testing.assert_allclose(tcomb.float().numpy(), np.asarray(jcomb, np.float32), rtol=2e-5)
    np.testing.assert_allclose(r.probs.numpy(), np.asarray(jprobs), rtol=2e-5)
    assert r.drop_frac.item() == float(jdrop)
    if case == "ties":
        assert (r.expert_idx.numpy() == [0, 1]).all()
    if case == "overflow":
        assert 0.0 < r.drop_frac.item() < 1.0
        # A slot holds one token; a dropped choice has no slot.
        assert td.sum(0).max().item() == 1.0
        assert td.sum().item() == r.keep.sum().item()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_index_form_equals_the_plain_form(dtype):
    _, tc = configs(dtype, capacity_factor=0.75)
    x, layer, dy = layer_inputs(2, router_scale=0.5)
    (yi, ai, xi, li), (yp, ap, xp, lp) = (torch_layer(tc, x, layer, plain=p) for p in (False, True))
    if dtype == "bf16":
        assert torch.equal(yi, yp)
    else:
        assert (yi - yp).abs().max() <= 2 ** -22 * yp.abs().max()
    assert torch.equal(ai, ap)
    for y, aux in ((yi, ai), (yp, ap)):
        (torch.sum(y.float() * torch.from_numpy(dy)) + aux).backward()
    tol = LAYER_TOL[dtype]
    for name, a, b in [("x", xi.grad, xp.grad)] + [(k, li[k].grad, lp[k].grad) for k in LEAVES]:
        assert (a - b).abs().max() <= tol * b.abs().max(), name


@pytest.mark.parametrize("aux_mode", ["switch", "overflow"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layer_and_gradients_match_jaxs_einsum_formulation(dtype, aux_mode):
    jc, tc = configs(dtype, capacity_factor=0.75, moe_aux_mode=aux_mode)
    x, layer, dy = layer_inputs(3, router_scale=0.5)

    def jf(x, lay):
        y, aux = jmoe._moe_mlp_einsum(jc, lay, x.astype(jc.compute_dtype), None, True)
        return jnp.sum(y.astype(jnp.float32) * dy) + aux, (y, aux)

    (_, (jy, jaux)), (jgx, jgl) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in layer.items()})
    for plain in (False, True):
        y, aux, tx, tl = torch_layer(tc, x, layer, plain=plain)
        (torch.sum(y.float() * torch.from_numpy(dy)) + aux).backward()
        tol = LAYER_TOL[dtype]
        want_y = np.asarray(jy, np.float32)
        assert np.abs(y.detach().float().numpy() - want_y).max() <= tol * np.abs(want_y).max()
        np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
        if aux_mode == "overflow":
            assert aux.item() == float(jaux) and aux.item() > 0
        for name, got, want in [("x", tx.grad, jgx)] + [(k, tl[k].grad, jgl[k]) for k in LEAVES]:
            want = np.asarray(want, np.float32)
            assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max(), (name, plain)


def _pair(dtype="f32", router_scale=1.0, **kw):
    jc, tc = configs(dtype, **kw)
    params = jtiny.init_params(jc, jax.random.key(0))
    params["blocks"]["router"] = params["blocks"]["router"] * router_scale
    model = TinyGPT(tc)
    bridge.load_jax_params(model, jax.tree.map(np.asarray, params))
    return jc, params, model


def test_moe_leaves_cross_the_bridge_and_init_zeroes_their_biases():
    _, params, model = _pair()
    names = [n for n, _ in model.named_parameters() if n.startswith("blocks.0.")]
    assert "blocks.0.router" in names and "blocks.0.experts.moe_w1" in names
    assert not any(n.split(".")[-1] in ("wfc", "bfc", "wproj", "bproj") for n in names)
    back = bridge.export_params(model)
    want = jax.tree.map(np.asarray, params)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    model.init_weights(torch.Generator().manual_seed(0))
    blk = model.blocks[0]
    assert blk.experts.moe_b1.abs().sum() == 0 and blk.experts.moe_b2.abs().sum() == 0
    assert 0.015 < blk.experts.moe_w1.std().item() < 0.025 and blk.router.std().item() > 0.015
    assert count_params(model) == jtiny.count_params(params)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_model_forward_and_loss_match_jax(dtype):
    jc, params, model = _pair(dtype, router_scale=25.0 if dtype == "bf16" else 1.0)
    idx = np.random.default_rng(4).integers(0, jc.vocab_size, (2, S)).astype(np.int32)
    j_logits, j_loss = jtiny.forward(jc, params, jnp.asarray(idx), jnp.asarray(idx))
    _, j_ce = jtiny.forward(dataclasses.replace(jc, router_aux_coef=0.0), params,
                            jnp.asarray(idx), jnp.asarray(idx))
    t_idx = torch.from_numpy(idx).long()
    with torch.no_grad():
        t_logits, t_loss = model(t_idx, t_idx)
    tol = MODEL_TOL[dtype]
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), rtol=tol, atol=tol)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=tol, atol=tol)
    assert 0 < float(j_loss) - float(j_ce) < 0.1  # the aux term is in the loss


def test_overflow_fraction_matches_jax():
    jc, params, model = _pair(capacity_factor=0.5)
    idx = np.random.default_rng(5).integers(0, jc.vocab_size, (2, S)).astype(np.int32)
    want = float(jtiny.moe_overflow_fraction(jc, params, jnp.asarray(idx)))
    got = moe_overflow_fraction(model, torch.from_numpy(idx).long()).item()
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-6)
    jc8, params8, model8 = _pair(capacity_factor=8.0)
    assert float(jtiny.moe_overflow_fraction(jc8, params8, jnp.asarray(idx))) == 0.0
    assert moe_overflow_fraction(model8, torch.from_numpy(idx).long()).item() == 0.0


def test_three_train_steps_match_jax():
    """As ``tests/test_torch_train_step.py``: zero2's recipe, per-device
    batch 2 x accum 2, fp32 compute, dropout 0."""
    MICRO, ACCUM = 2, 2
    jc, params, model = _pair()
    table = JaxSyntheticDataset(jc.vocab_size, S, size=10, seed=42).data
    tx = jstrat.make_optimizer(jstrat.get_strategy("zero2"))
    state = tx.init(params)
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: jtiny.loss_fn(jc, p, b, b)))
    step_fn = TrainStep(model, tstrat.make_optimizer(tstrat.get_strategy("zero2"),
                                                     model.parameters()),
                        grad_accum=ACCUM, micro_batch=MICRO, seed=0, device=torch.device("cpu"))
    t_table = torch.from_numpy(table.astype(np.int64))
    for step in range(3):
        G = ACCUM * MICRO
        batch = jnp.asarray(table[(step * G + np.arange(G)) % table.shape[0]].reshape(
            ACCUM, MICRO, S))
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
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jax.tree.map(np.asarray, params))):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=2e-6, err_msg=f"params, step {step}")


@pytest.mark.parametrize("tier,experts,k", [("S", 4, 2), ("A", 8, 2), ("A", 8, 1)])
def test_flops_and_parameter_count_are_jaxs(tier, experts, k):
    jc = jtiny.get_model_config(tier, 2048, n_experts=experts, expert_top_k=k)
    tc = get_config("tinygpt", tier, 2048, n_experts=experts, expert_top_k=k)
    assert tflops.forward_flops_per_token(tc) == jflops.forward_flops_per_token(jc)
    with torch.device("meta"):
        n = count_params(TinyGPT(tc))
    assert n == jtiny.count_params(jax.eval_shape(lambda: jtiny.init_params(jc, jax.random.key(0))))
    if tier == "A":
        assert n == 1_176_635_392  # the README's 1.18B


def test_swiglu_and_bad_modes_are_refused_as_jax_refuses_them():
    with pytest.raises(ValueError) as jerr:
        jtiny.get_model_config("S", S, n_experts=4, mlp_act="swiglu")
    with pytest.raises(ValueError) as terr:
        get_config("llama", "S", S, n_experts=4)
    assert str(terr.value) == str(jerr.value)
    for bad in (dict(moe_aux_mode="x"), dict(moe_dispatch="x")):
        with pytest.raises(ValueError):
            get_config("tinygpt", "S", S, n_experts=4, **bad)
    _, tc = configs(moe_dispatch="alltoall")
    x, layer, _ = layer_inputs()
    with pytest.raises(ValueError, match="moe_dispatch='alltoall' needs an in-scope mesh"):
        torch_layer(tc, x, layer)
