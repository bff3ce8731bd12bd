"""The scan layer loop (``--layer-loop scan``) beside an ``expert`` axis,
over gloo ranks on the CPU: the stacked expert leaves (``blocks.experts.*``,
E/ep experts on each rank, the experts axis after the layer axis), both
dispatches, and the arms' reductions of them under scan.

A module fixture starts the ranks once (``tests/torch_scan_composed_worker.py``)
for (data, model, pipe, expert) = (1, 1, 1, 2), (2, 1, 1, 2), (1, 2, 1, 2)
and (1, 1, 2, 2): tier S at S 64 with 4 layers and 4 experts, fp32
compute, reference attention, per-device batch 1 x accum 4, from the JAX
init with the routers scaled by 25 (``tests/test_torch_moe_parallel.py``
says why). Every run goes under both loops in one process:

- **against the port's own unrolled run, bit for bit**: step 0's gradient
  after the arm's reduction gathered to JAX's leaves, the clip's norm (every
  element counted once), both steps' losses and the params after them; at
  (expert 2) ddp, zero2 and fsdp under the index (all-to-all) dispatch and
  zero2 and fsdp under ``moe_dispatch="einsum"`` (the global routing); at
  (data 2, expert 2) zero2, fsdp and zero3, fsdp's hand shares of the
  expert leaves reduced over ``data`` only and of the others over ``data``
  and ``expert``; MoE beside ``model`` at (model 2, expert 2) under ddp and
  zero2; and (pipe 2, expert 2) under gpipe, ddp, zero2 and fsdp, a stage's
  expert leaves stacked over its own layers;
- DDP ignores the stacked expert leaves, which the arm reduces itself;
  fsdp at (data 2, expert 2) holds JAX's bytes of each stacked leaf;
- a ``bitflip@0`` given zero2's optimizer reaches the shards it keeps
  apart from the stacked leaves;
- **against JAX**, two geometries, under JAX's default ``scan_layers=True``
  on the conftest's virtual devices: zero2 at (expert 2) under the index
  dispatch (``loss_fn`` on the mesh, JAX's all-to-all form) and (pipe 2,
  expert 2) (``pipeline_loss_fn``; zero2's trajectory, ddp's gradient),
  each composed with ``make_optimizer`` of the arm's recipe as JAX's train
  step composes them. Tolerances of ``tests/test_torch_moe_composed.py``:
  losses and the clip's norm 1e-5 relative, gradients 1e-5 of each leaf's
  largest magnitude, params 1e-5 relative plus 2e-6 absolute on every
  element whose gradient stayed above 10 Adam eps, up to ``TIE_SHARE`` of a
  leaf's elements outside that band but within lr per step taken;
- an (expert 2) zero2 run saved under scan resumes under the unrolled loop
  with the straight run's losses (``run_benchmark``, dropout 0.1).

Without ranks: ``estimate_hbm`` under scan at (expert 2) and (data 2,
expert 2) equals JAX's.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding

from distributed_llm_training_benchmark_framework_tpu.data.synthetic import (
    SyntheticDataset as JaxSyntheticDataset,
)
from distributed_llm_training_benchmark_framework_tpu.models import tinygpt as jtiny
from distributed_llm_training_benchmark_framework_tpu.parallel import make_mesh as jmake_mesh
from distributed_llm_training_benchmark_framework_tpu.parallel import pipeline as jpipe
from distributed_llm_training_benchmark_framework_tpu.parallel import strategies as jstrat
from distributed_llm_training_benchmark_framework_tpu.train.step import _resolve_model_config
from distributed_llm_training_benchmark_framework_tpu.utils import memory as jmemory
from distributed_llm_training_benchmark_framework_tpu_torch.models import get_config
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import strategies as tstrat
from distributed_llm_training_benchmark_framework_tpu_torch.parallel.mesh import Mesh
from distributed_llm_training_benchmark_framework_tpu_torch.utils import memory as tmemory
from distributed_llm_training_benchmark_framework_tpu_torch.utils.memory import jax_leaf_shapes

from torch_scan_composed_worker import (
    ACCUM,
    EXPERTS,
    GEOMETRIES,
    MICRO,
    N_LAYER,
    RUNS,
    S,
    STEPS,
    flat,
    spawn_ranks,
    wait_ranks,
    world_of,
)
from torch_threads import one_thread  # noqa: F401  (autouse)

MODES = ("ep2", "dp2ep2", "tp2ep2", "pp2ep2")
AXES5 = ("data", "seq", "model", "pipe", "expert")
ROUTER_SCALE = 25.0
NEAR_EPS = 10 * 1e-8
TIE_SHARE = 1e-4  # of a leaf's elements; tests/test_torch_moe_parallel.py says why
PAIRS = [(mode, run) for mode in MODES for run in GEOMETRIES[mode][2]]
# mode -> (the scan run whose trajectory JAX's zero2 recipe holds, the run
# whose step-0 gradient JAX's holds)
JAX_HELD = {"ep2": ("zero2.index", "ddp.index"), "pp2ep2": ("zero2.gpipe", "ddp.gpipe")}
EXPERT_LEAVES = ("moe_w1", "moe_b1", "moe_w2", "moe_b2")


def jax_config():
    return jtiny.get_model_config("S", S, n_layer=N_LAYER, n_experts=EXPERTS, dropout=0.0,
                                  compute_dtype=jnp.float32, attention_impl="reference")


def leaves(tree):
    return list(flat("", tree).items())


def jax_reference(mode, init, table):
    """On the mode's (data, seq, model, pipe, expert) mesh: (step 0's loss
    and gradient, zero2's recipe: per-step losses, final params, the
    elements whose gradient has been under 10 Adam eps, the lr sum)."""
    dp, tp, pp, ep = GEOMETRIES[mode][0]
    shape = (dp, 1, tp, pp, ep)
    mesh = jmake_mesh(shape, AXES5, devices=jax.devices()[:int(np.prod(shape))])
    jc = jax_config()
    if pp > 1:
        fn = jax.jit(jax.value_and_grad(lambda p, b: jpipe.pipeline_loss_fn(jc, mesh, p, b)))

        def value_and_grad(params, batch):
            with jax.set_mesh(mesh):
                loss, g = fn(params, jnp.asarray(batch))
            return float(loss), jax.tree.map(np.asarray, g)
    else:
        rows_on = NamedSharding(mesh, jstrat.batch_partition_spec(mesh))
        place = jstrat.named(mesh, jstrat.param_partition_specs(init, mesh, shard=False))
        fn = jax.jit(jax.value_and_grad(lambda p, b: jtiny.loss_fn(jc, p, b, b)))

        def value_and_grad(params, batch):
            with jax.set_mesh(mesh):
                params = jax.device_put(params, place)
                parts = [fn(params, jax.device_put(batch[j], rows_on)) for j in range(ACCUM)]
            return (sum(float(v) for v, _ in parts) / ACCUM,
                    jax.tree.map(lambda *gs: np.asarray(sum(gs) / ACCUM), *(g for _, g in parts)))

    G = ACCUM * MICRO * dp * ep

    def batch(step):
        return table[(step * G + np.arange(G)) % table.shape[0]].reshape(ACCUM, -1, S)

    first = value_and_grad(init, batch(0))
    arm = dataclasses.replace(jstrat.get_strategy("zero2"), precision="f32", remat="none")
    tx = jstrat.make_optimizer(arm)
    update = jax.jit(lambda g, st, p: (lambda u, st: (optax.apply_updates(p, u), st))(
        *tx.update(g, st, p)))
    params, state = init, tx.init(init)
    small = jax.tree.map(lambda p: np.zeros(p.shape, bool), init)
    losses, lr_sum = [], 0.0
    for step in range(STEPS):
        loss, g = first if step == 0 else value_and_grad(params, batch(step))
        losses.append(loss)
        small = jax.tree.map(lambda m, g: m | (np.abs(g) < NEAR_EPS), small, g)
        params, state = update(g, state, params)
        params = jax.tree.map(np.asarray, params)
        lr_sum += arm.learning_rate * (min(1.0, step / arm.warmup_steps)
                                       if arm.warmup_steps else 1.0)
    return first, (losses, params, small, lr_sum)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, eight_devices):
    """({mode: every rank's record}, {mode: rank 0's arrays}, {mode: JAX's
    reference})."""
    tmp = tmp_path_factory.mktemp("scan_moe")
    init = jax.tree.map(np.asarray, jtiny.init_params(jax_config(), jax.random.key(42)))
    init["blocks"]["router"] = init["blocks"]["router"] * ROUTER_SCALE
    table = JaxSyntheticDataset(512, S, size=16, seed=42).data
    np.savez(tmp / "inputs.npz", table=table, **flat("moe", init))
    procs = {mode: spawn_ranks(world_of(mode), tmp / "inputs.npz", tmp / mode, mode)
             for mode in MODES}
    ref = {mode: jax_reference(mode, init, table) for mode in JAX_HELD}
    ranks, rank0 = {}, {}
    for mode, ps in procs.items():
        wait_ranks(ps)
        ranks[mode] = [json.loads((tmp / f"{mode}.rank{r}.json").read_text())
                       for r in range(len(ps))]
        rank0[mode] = np.load(tmp / f"{mode}.rank0.npz")
    return ranks, rank0, ref


@pytest.mark.parametrize("mode,run", PAIRS, ids=[f"{m}-{r}" for m, r in PAIRS])
def test_scan_equals_the_unrolled_run_bit_for_bit(runs, mode, run):
    for rec in runs[0][mode]:
        got = rec["runs"][run]
        assert got["grad_diff"] == [] and got["param_diff"] == []
        assert got["scan"]["losses"] == got["unrolled"]["losses"]
        assert len(got["scan"]["losses"]) == STEPS
        assert got["scan"]["norm"] == got["unrolled"]["norm"]


@pytest.mark.parametrize("mode", MODES)
def test_bitflip_reaches_the_zero2_shards_under_scan(runs, mode):
    """zero2's scan form updates shards it keeps apart from the stacked
    leaves: the injector, given the optimizer as the loop gives it, copies
    the poisoned leaves into them, so the flip persists as it does unrolled
    (one rank of the pipeline holds the flipped element)."""
    flips = {}
    for r in runs[0][mode]:
        for run, rec in r["runs"].items():
            if "bitflip" in rec["scan"]:
                assert rec["scan"]["bitflip"]["agree"], run
                flips[run] = flips.get(run, 0) + rec["scan"]["bitflip"]["flipped_here"]
    assert flips and all(n >= 1 for n in flips.values()), flips


@pytest.mark.parametrize("mode", list(JAX_HELD))
def test_scan_gradient_and_norm_are_jaxs(runs, mode):
    """Step 0 under JAX's scan step: ddp's gradient after the arm (the
    expert leaves summed over the ranks that hold the same experts), and
    the clip norm of every arm under JAX's dispatch, the norm of JAX's
    whole gradient."""
    ranks, rank0, ref = runs
    (loss, grads), _ = ref[mode]
    _, run = JAX_HELD[mode]
    for key, leaf in leaves(grads):
        got = rank0[mode][f"{run}.grad{key}"]
        assert np.abs(got - leaf).max() <= 1e-5 * np.abs(leaf).max(), key
    want = np.sqrt(sum(np.square(v.astype(np.float64)).sum() for _, v in leaves(grads)))
    for r in ranks[mode]:
        np.testing.assert_allclose(r["runs"][run]["scan"]["losses"][0], loss, rtol=1e-5)
        for name, rec in r["runs"].items():
            if RUNS[name][3].get("moe_dispatch", "auto") == "auto":
                np.testing.assert_allclose(rec["scan"]["norm"], want, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("mode", list(JAX_HELD))
def test_zero2_under_scan_trains_as_jaxs_step(runs, mode):
    ranks, rank0, ref = runs
    want_losses, want, small, lr_sum = ref[mode][1]
    run, _ = JAX_HELD[mode]
    for r in ranks[mode]:
        assert r["runs"][run]["scan"]["losses"] == ranks[mode][0]["runs"][run]["scan"]["losses"]
    np.testing.assert_allclose(ranks[mode][0]["runs"][run]["scan"]["losses"], want_losses,
                               rtol=1e-5)
    tiny = dict(leaves(small))
    for key, leaf in leaves(want):
        got, near = rank0[mode][f"{run}.params{key}"], tiny[key]
        diff = np.abs(got - leaf)
        out = ~near & (diff > 2e-6 + 1e-5 * np.abs(leaf))
        assert out.mean() <= TIE_SHARE, (key, int(out.sum()), diff[out].max())
        assert (diff <= lr_sum).all(), key


@pytest.mark.parametrize("mode", MODES)
def test_ddp_ignores_the_stacked_expert_leaves(runs, mode):
    for r in runs[0][mode]:
        for run, rec in r["runs"].items():
            if run.startswith("ddp."):
                assert rec["scan"]["ddp_ignores"] == sorted(
                    f"blocks.experts.{leaf}" for leaf in EXPERT_LEAVES)
                assert len(rec["unrolled"]["ddp_ignores"]) == 4 * len(EXPERT_LEAVES) // (
                    GEOMETRIES[mode][0][2])


def test_fsdp_holds_jaxs_bytes_of_each_stacked_leaf(runs):
    """(data 2, expert 2): an expert leaf's experts axis over ``expert``,
    ``data`` on a tensor axis of every leaf; a rank holds that share."""
    cfg = get_config("tinygpt", "S", S, n_layer=N_LAYER, n_experts=EXPERTS)
    shapes = jax_leaf_shapes(cfg)
    mesh = {"data": 2, "expert": 2}
    specs = tstrat.param_partition_specs(shapes, mesh, True, cfg.kv_heads, scan_stacked=True)
    for r in runs[0]["dp2ep2"]:
        for run in ("fsdp.index", "zero3.index"):
            for leaf, got in r["runs"][run]["scan"]["held"].items():
                name = f"blocks/{leaf.removeprefix('experts.')}"
                factor = int(np.prod([mesh[a] for a in specs[name] if a is not None]))
                assert ("expert" in specs[name]) == leaf.startswith("experts."), name
                assert got == 4 * int(np.prod(shapes[name])) // factor, (run, leaf)


def test_checkpoint_saved_under_scan_resumes_unrolled(runs):
    for r in runs[0]["ep2"]:
        ck = r["checkpoints"]
        assert len(ck["straight"]) == 6
        assert ck["scan->unrolled"] == ck["straight"]


@pytest.mark.parametrize("arm", sorted(jstrat.STRATEGIES))
@pytest.mark.parametrize("data,expert", [(1, 2), (2, 2)])
def test_estimate_hbm_under_scan_beside_expert_is_jaxs(eight_devices, data, expert, arm):
    """The 1.18B MoE model (tier A, 8 experts) under JAX's
    ``scan_layers=True``: params, grads, activations and logits equal JAX's
    ``estimate_hbm``, the AdamW moments its optimizer state less optax's
    scalar counters."""
    jstrategy = jstrat.get_strategy(arm)
    jmesh = jmake_mesh((data, 1, 1, 1, expert), AXES5, devices=jax.devices()[:data * expert])
    jcfg = _resolve_model_config(jtiny.get_model_config("A", 2048, n_experts=8,
                                                        scan_layers=True), jstrategy, jmesh)
    want = jmemory.estimate_hbm(jcfg, jstrategy, jmesh, 1, 2048)
    opt = jstrat.make_optimizer(jstrategy)
    shapes = jax.eval_shape(lambda: jtiny.init_params(jcfg, jax.random.key(0)))
    scalars = sum(np.dtype(x.dtype).itemsize for x in
                  jax.tree_util.tree_leaves(jax.eval_shape(opt.init, shapes)) if x.shape == ())
    strategy = tstrat.get_strategy(arm)
    got = tmemory.estimate_hbm(get_config("tinygpt", "A", 2048, n_experts=8, remat=strategy.remat,
                                          scan_layers=True), strategy,
                               Mesh({"data": data, "expert": expert}), 1, 2048)
    assert (got.params, got.grads, got.activations, got.logits) == (
        want.params, want.grads, want.activations, want.logits)
    assert got.opt_state == want.opt_state - scalars
