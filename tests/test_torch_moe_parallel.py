"""Expert parallelism over gloo ranks on the CPU, against JAX's train step
on a mesh of the same widths (``models/moe.py``, ``parallel/mesh.py``,
``parallel/strategies.py``).

A module fixture starts the ranks once (``tests/torch_moe_worker.py``) for
three geometries, (data, expert) = (1, 2), (2, 2) and (2, 1): ddp and zero2
everywhere, fsdp and zero3 at (2, 2), tier S with 4 experts, fp32 compute,
dropout 0, per-device batch 1 x accum 2, from the JAX init, 3 steps. (2, 1)
is the global-routing case: JAX routes the whole micro-batch under GSPMD,
so each port rank offsets its slots by the data ranks before it. The JAX
side is ``tinygpt.loss_fn`` under a (data, seq, model, pipe, expert) mesh
of the conftest's virtual CPU devices (the mesh ``tests/test_moe.py``
builds), whose MoE layers take the all-to-all formulation at expert 2 and
the einsum one at expert 1, plus ``strategies.make_optimizer`` of the arm's
recipe, composed as JAX's train step composes them (as
``tests/test_torch_tp.py`` does, which keeps each step's gradient for the
Adam-eps exception). ddp and fsdp share bare AdamW, zero2 and zero3 the
warmup and the clip. Both sides run the reference attention (the port's
flash is the same arithmetic on the CPU).

The training runs scale the routers of the JAX init by 25
(``ROUTER_SCALE``), as ``tests/test_torch_moe.py`` scales them for its bf16
forward: JAX's init leaves top-2 margins down to 5e-5 in probability, and
after bare AdamW's first full-rate step some token's choice lies within an
fp32 rounding of a tie, which XLA and the port (other summation orders of
the logits) break apart, both rightly (the losses part by 1e-4). The
gradients are taken at the init itself.

Tolerances are ``tests/test_torch_arms.py``'s: loss 1e-5 relative, params
1e-5 relative plus 2e-6 absolute on every element whose gradient has stayed
above 10 Adam eps, the others held to what Adam can move them (lr per step
taken; ``tests/test_torch_tp.py`` says why). Under bare AdamW a token's
choice or its slot at the capacity margin can still flip between the two
sides in a later step, which moves the gradient of a few weights it feeds
by a percent; so up to ``TIE_SHARE`` (1e-4) of a leaf's elements may leave
the 1e-5 band, every element staying within lr per step taken (one element
of 32,763 in ``wo`` at (1, 2) under ddp: 2.17e-6 where the band is
2.02e-6). Gradients after the arm's reduction (one micro-batch, ddp)
against ``jax.grad`` of the global loss on the same mesh:
1e-5 of each leaf's largest magnitude; the clip's norm against the norm of
JAX's whole gradient: 1e-5 relative. Without ranks: ``estimate_hbm`` of the
1.18B MoE model under an ``expert`` axis equals JAX's, and the options'
refusals are JAX's.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding

from distributed_llm_training_benchmark_framework_tpu.analysis.validate_results import (
    validate_result,
)
from distributed_llm_training_benchmark_framework_tpu.data.synthetic import (
    SyntheticDataset as JaxSyntheticDataset,
)
from distributed_llm_training_benchmark_framework_tpu.models import tinygpt as jtiny
from distributed_llm_training_benchmark_framework_tpu.parallel import make_mesh as jmake_mesh
from distributed_llm_training_benchmark_framework_tpu.parallel import strategies as jstrat
from distributed_llm_training_benchmark_framework_tpu.train.step import _resolve_model_config
from distributed_llm_training_benchmark_framework_tpu.utils import memory as jmemory
from distributed_llm_training_benchmark_framework_tpu_torch.models import get_config
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import Mesh, make_mesh
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import strategies as tstrat
from distributed_llm_training_benchmark_framework_tpu_torch.train.loop import build_run
from distributed_llm_training_benchmark_framework_tpu_torch.utils import memory as tmemory

from torch_moe_worker import (
    ACCUM,
    ARMS,
    EXPERTS,
    GEOMETRIES,
    GRAD_ARMS,
    MICRO,
    S,
    STEPS,
    scaled,
    spawn_ranks,
    wait_ranks,
)

RECIPE = {"ddp": "ddp", "fsdp": "ddp", "zero2": "zero2", "zero3": "zero2"}
NEAR_EPS = 10 * 1e-8  # tests/test_torch_tp.py's "well above" Adam's eps
TIE_SHARE = 1e-4  # of a leaf's elements; see the module docstring

AXES5 = ("data", "seq", "model", "pipe", "expert")
TRAINED = [(mode, arm) for mode, (dp, ep) in GEOMETRIES.items() for arm in ARMS[dp * ep]]
GRADED = [(mode, arm) for mode, (dp, ep) in GEOMETRIES.items() for arm in GRAD_ARMS[dp * ep]]


def jax_config(**kw):
    return jtiny.get_model_config("S", S, dropout=0.0, compute_dtype=jnp.float32,
                                  attention_impl="reference", n_experts=EXPERTS, **kw)


def leaves(tree):
    out = [(k, v) for k, v in tree.items() if k != "blocks"]
    return out + [(f"blocks.{k}", v) for k, v in tree["blocks"].items()]


def jax_reference(dp, ep, table, init, recipes):
    """On a (dp, 1, 1, 1, ep) mesh: ({recipe: (per-step losses, final
    params, the elements whose gradient has been under 10 Adam eps, the sum
    of the learning rates)} from ``scaled(init)``, {aux coefficient: the
    gradient of the global loss on rows 0..dp*ep at ``init``})."""
    mesh = jmake_mesh((dp, 1, 1, 1, ep), AXES5, devices=jax.devices()[:dp * ep])
    rows_on = NamedSharding(mesh, jstrat.batch_partition_spec(mesh))
    place = jstrat.named(mesh, jstrat.param_partition_specs(init, mesh, shard=False))
    fns = {}
    for aux in (0.01, 0.0) if ep > 1 else (0.01,):
        jc = jax_config(router_aux_coef=aux)
        with jax.set_mesh(mesh):
            fns[aux] = jax.jit(jax.value_and_grad(lambda p, b, jc=jc: jtiny.loss_fn(jc, p, b, b)))

    def value_and_grad(params, rows, aux=0.01):
        with jax.set_mesh(mesh):
            loss, g = fns[aux](jax.device_put(params, place), jax.device_put(rows, rows_on))
        return float(loss), jax.tree.map(np.asarray, g)

    grads = {aux: value_and_grad(init, table[:dp * ep], aux)[1] for aux in fns}
    out, G = {}, ACCUM * MICRO * dp * ep
    for recipe in recipes:
        arm = dataclasses.replace(jstrat.get_strategy(recipe), precision="f32", remat="none")
        tx = jstrat.make_optimizer(arm)
        update = jax.jit(lambda g, st, p, tx=tx: (lambda u, st: (optax.apply_updates(p, u), st))(
            *tx.update(g, st, p)))
        params = scaled(init)
        state = tx.init(params)
        small = jax.tree.map(lambda p: np.zeros(p.shape, bool), init)
        losses, lr_sum = [], 0.0
        for step in range(STEPS):
            batch = table[(step * G + np.arange(G)) % table.shape[0]].reshape(ACCUM, -1, S)
            parts = [value_and_grad(params, batch[j]) for j in range(ACCUM)]
            losses.append(sum(loss for loss, _ in parts) / ACCUM)
            g = jax.tree.map(lambda *gs: sum(gs) / ACCUM, *(g for _, g in parts))
            small = jax.tree.map(lambda m, g: m | (np.abs(g) < NEAR_EPS), small, g)
            params, state = update(g, state, params)
            params = jax.tree.map(np.asarray, params)
            lr_sum += arm.learning_rate * (min(1.0, step / arm.warmup_steps)
                                           if arm.warmup_steps else 1.0)
        out[recipe] = (losses, params, small, lr_sum)
    return out, grads


@pytest.fixture(scope="module")
def runs(tmp_path_factory, eight_devices):
    """({mode: every rank's json}, {mode: rank 0's arrays}, {mode: JAX's
    recipes}, {mode: {aux: JAX's gradient}})."""
    tmp = tmp_path_factory.mktemp("moe")
    init = jax.tree.map(np.asarray, jtiny.init_params(jax_config(), jax.random.key(42)))
    table = JaxSyntheticDataset(512, S, size=16, seed=42).data
    np.savez(tmp / "inputs.npz", table=table, **dict(leaves(init)))
    procs = {mode: spawn_ranks(dp * ep, tmp / "inputs.npz", tmp / mode, mode)
             for mode, (dp, ep) in GEOMETRIES.items()}
    recipes, grads = {}, {}
    for mode, (dp, ep) in GEOMETRIES.items():
        recipes[mode], grads[mode] = jax_reference(
            dp, ep, table, init, sorted({RECIPE[a] for a in ARMS[dp * ep]}))
    ranks, rank0 = {}, {}
    for mode, ps in procs.items():
        wait_ranks(ps)
        ranks[mode] = [json.loads((tmp / f"{mode}.rank{r}.json").read_text())
                       for r in range(len(ps))]
        rank0[mode] = np.load(tmp / f"{mode}.rank0.npz")
    return ranks, rank0, recipes, grads


@pytest.mark.parametrize("mode,arm", TRAINED)
def test_arm_matches_jaxs_step_on_the_same_mesh(runs, mode, arm):
    ranks, rank0, recipes, _ = runs
    want_losses, want, small, lr_sum = recipes[mode][RECIPE[arm]]
    for r in ranks[mode]:
        assert r["losses"][arm] == ranks[mode][0]["losses"][arm]
    np.testing.assert_allclose(ranks[mode][0]["losses"][arm], want_losses, rtol=1e-5)
    tiny = dict(leaves(small))
    for key, leaf in leaves(want):
        got, near = rank0[mode][f"{arm}.{key}"], tiny[key]
        diff = np.abs(got - leaf)
        out = ~near & (diff > 2e-6 + 1e-5 * np.abs(leaf))
        assert out.mean() <= TIE_SHARE, (key, int(out.sum()), diff[out].max())
        assert (diff <= lr_sum).all(), key


def test_members_take_rows_data_major_with_expert_fastest(runs):
    for mode, (dp, ep) in GEOMETRIES.items():
        assert [tuple(r["batch_shard"]) for r in runs[0][mode]] == [
            (r, dp * ep) for r in range(dp * ep)]


def _grad_close(got, want, key):
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), key


@pytest.mark.parametrize("mode", list(GEOMETRIES))
def test_gradients_after_the_arm_are_the_global_ones(runs, mode):
    _, rank0, _, grads = runs
    for key, leaf in leaves(grads[mode][0.01]):
        _grad_close(rank0[mode][f"grad.ddp.{key}"], leaf, key)


@pytest.mark.parametrize("mode", ["ep2", "dp2ep2"])
def test_router_gradient_through_the_averaged_aux_is_the_global_one(runs, mode):
    """The aux term's share of the router's gradient (with coefficient 0.01
    against 0) is far above the tolerance, so a detached average of ``p``
    (that share divided by the member count) would fail."""
    _, rank0, _, grads = runs
    got = rank0[mode]["grad.ddp.blocks.router"]
    got_no_aux = rank0[mode]["grad.no_aux.blocks.router"]
    want, want_no_aux = grads[mode][0.01]["blocks"]["router"], grads[mode][0.0]["blocks"]["router"]
    _grad_close(got, want, "router")
    _grad_close(got_no_aux, want_no_aux, "router, no aux")
    share = want - want_no_aux
    assert np.abs(share).max() > 100 * 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got - got_no_aux, share, atol=1e-5 * np.abs(want).max())


def test_expert_leaves_are_divided_by_data_times_expert(runs):
    """At (2, 2) the expert leaves' gradients, summed over ``data`` only
    (the all-to-all's backward brought every member's tokens to the owner),
    are the global mean's: divided by dp * ep = 4, not by dp."""
    _, rank0, _, grads = runs
    for leaf in ("moe_w1", "moe_b1", "moe_w2", "moe_b2"):
        want = grads["dp2ep2"][0.01]["blocks"][leaf]
        got = rank0["dp2ep2"][f"grad.ddp.blocks.{leaf}"]
        _grad_close(got, want, leaf)
        np.testing.assert_allclose(np.abs(got).sum() / np.abs(want).sum(), 1.0, rtol=1e-4)


@pytest.mark.parametrize("mode,arm", GRADED)
def test_clip_norm_counts_every_element_once(runs, mode, arm):
    """Expert leaves' squares summed over ``expert`` as well: the norm of
    JAX's whole gradient."""
    ranks, _, _, grads = runs
    want = np.sqrt(sum(np.square(v.astype(np.float64)).sum()
                       for _, v in leaves(grads[mode][0.01])))
    for r in ranks[mode]:
        np.testing.assert_allclose(r["norms"][arm], want, rtol=1e-5)


def test_moe_beside_model_or_seq_on_the_group_is_refused(runs):
    """No longer refused: MoE beside a ``model`` or a ``seq`` axis on the
    group trains as the one-process run of the same global batch does (the
    layers route the global micro-batch): losses equal on both ranks and
    within 1e-5 relative of it. ``tests/test_torch_moe_composed.py`` holds
    these geometries against JAX's step."""
    ranks = runs[0]["ep2"]
    assert set(ranks[0]["composed"]) == {"model", "seq"}
    for axis, (got, want) in ranks[0]["composed"].items():
        assert all(r["composed"][axis][0] == got for r in ranks), axis
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=axis)


def test_expert_row_validates_and_carries_the_moe_keys(runs):
    row = runs[0]["ep2"][0]["row"]
    assert (row["world_size"], row["expert_parallel"], row["n_experts"]) == (2, 2, EXPERTS)
    assert 0.0 <= row["expert_overflow_pct"] <= 60.0
    assert row["expert_overflow_pct"] == round(row["expert_overflow_pct"], 4)
    assert validate_result(row, "moe ep2") == []
    # Both members hold distinct rows: a step takes pd * accum * S * dp * ep tokens.
    assert row["tokens_per_sec"] == pytest.approx(
        MICRO * ACCUM * S * 2 / row["mean_step_time_sec"])


def test_expert_options_are_refused_as_jax_refuses_them():
    with pytest.raises(ValueError, match=r"^expert_parallel > 1 requires --num-experts > 0$"):
        build_run(tier="S", seq_len=S, expert_parallel=2, device="cpu")
    with pytest.raises(ValueError, match=r"^n_experts=6 not divisible by expert_parallel=4$"):
        build_run(tier="S", seq_len=S, n_experts=6, expert_parallel=4, device="cpu")
    with pytest.raises(ValueError, match="does not support MoE models"):
        build_run(tier="S", seq_len=S, n_experts=4, tp_collective_matmul=True, device="cpu")
    with pytest.raises(ValueError, match="expert parallelism .* needs a process group"):
        make_mesh((2,), ("expert",))


# (data, expert, the axis beside them at width 2): the ids of the meshes
# without one stay "data-expert".
ESTIMATE_MESHES = [pytest.param(d, e, None, id=f"{d}-{e}") for d, e in ((1, 2), (2, 2), (1, 8))] + [
    pytest.param(d, e, axis, id=f"{d}-{e}-{axis}")
    for d, e, axis in ((1, 2, "model"), (2, 2, "model"), (1, 2, "seq"), (2, 2, "seq"),
                       (1, 2, "pipe"), (2, 2, "pipe"))]


@pytest.mark.parametrize("arm", sorted(jstrat.STRATEGIES))
@pytest.mark.parametrize("data,expert,beside", ESTIMATE_MESHES)
def test_estimate_under_an_expert_axis_is_jaxs(data, expert, beside, arm):
    """The 1.18B MoE model (tier A, 8 experts): params, grads, activations
    and logits equal JAX's ``estimate_hbm`` on the same mesh (its spec rule
    with ``_EP_RULES``, and ``_TP_RULES`` on the experts beside ``model``),
    the AdamW moments its optimizer state less optax's scalar counters;
    also with a ``model``, ``seq`` or ``pipe`` axis of width 2 beside the
    ``expert`` one."""
    widths = {"data": data, "expert": expert, **({beside: 2} if beside else {})}
    shape = tuple(widths.get(a, 1) for a in AXES5)
    jstrategy = jstrat.get_strategy(arm)
    jmesh = jmake_mesh(shape, AXES5, devices=jax.devices()[:int(np.prod(shape))])
    jcfg = _resolve_model_config(jtiny.get_model_config("A", 2048, n_experts=8,
                                                        scan_layers=False), jstrategy, jmesh)
    want = jmemory.estimate_hbm(jcfg, jstrategy, jmesh, 1, 2048)
    opt = jstrat.make_optimizer(jstrategy)
    shapes = jax.eval_shape(lambda: jtiny.init_params(jcfg, jax.random.key(0)))
    scalars = sum(np.dtype(x.dtype).itemsize for x in
                  jax.tree_util.tree_leaves(jax.eval_shape(opt.init, shapes)) if x.shape == ())
    strategy = tstrat.get_strategy(arm)
    # JAX's CPU pipelines compute in fp32 (``_resolve_model_config``).
    cd = torch.float32 if jcfg.compute_dtype == jnp.float32 else torch.bfloat16
    got = tmemory.estimate_hbm(get_config("tinygpt", "A", 2048, n_experts=8, remat=strategy.remat,
                                          compute_dtype=cd), strategy, Mesh(widths), 1, 2048)
    assert (got.params, got.grads, got.activations, got.logits) == (
        want.params, want.grads, want.activations, want.logits)
    assert got.opt_state == want.opt_state - scalars
