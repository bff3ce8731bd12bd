"""The scan layer loop (``--layer-loop scan``) beside a ``pipe`` axis, over
gloo ranks on the CPU: a stage's ``ScanBlocks`` (its layers stacked in
``layer_permutation`` order), gpipe, lockstep 1F1B with its stage-input
recompute and interleaved 1F1B at V 2 over stacked leaves, and the arms'
scan forms under ``pipe``.

A module fixture starts the ranks once (``tests/torch_scan_composed_worker.py``)
for (data, model, pipe) = (1, 1, 2), (2, 1, 2) and (1, 2, 2): tier S at S
64 with 4 layers, fp32 compute, reference attention, per-device batch 1 x
accum 4 (the schedules' M 4), from the JAX init. Every run goes under both
loops in one process:

- **against the port's own unrolled run, bit for bit**: step 0's gradient
  after the arm's reduction, gathered to JAX's leaves by global layer, the
  clip's norm, both steps' losses and the params after them; each schedule
  under ddp and zero2 at (pipe 2), zero2 interleaved at dropout 0.1 too;
  zero2 under each schedule, fsdp under gpipe and interleaved, and zero3
  (remat full) under 1f1b at (data 2, pipe 2); zero2 / gpipe and ddp /
  interleaved at (model 2, pipe 2);
- the messages per step and direction keep their law, M (P - 1) or M (P V
  - 1) summed over a pipeline's stages, and zero2 starts every block
  bucket's reduce-scatter inside the schedule, as unrolled;
- zero2's scan form keeps its shards apart from the stacked leaves: a
  ``bitflip@0`` given the optimizer reaches them, as it reaches the
  unrolled arm's views;
- under fsdp at (data 2, pipe 2) a stage holds of each stacked leaf the
  bytes of JAX's spec (``pipe`` on the layer axis, ``data`` on a tensor
  axis);
- **against JAX**, one geometry: interleaved V 2 at (pipe 2) under JAX's
  default ``scan_layers=True``, its own ``interleaved_loss_and_grads`` on
  the conftest's virtual devices for the gradient and the loss, and the
  ddp recipe (``loss_fn`` averaged over the micro-batches, bare AdamW) for
  both steps; tolerances of ``tests/test_torch_pipeline.py``: loss 1e-5
  relative, gradients 1e-5 of each leaf's largest magnitude, params 1e-5
  relative plus 2e-6 absolute where the gradient stayed above 10 Adam eps
  (the others within lr per step taken);
- a (pipe 2) zero2 run saved under the unrolled loop resumes under scan
  with the straight run's losses (``run_benchmark``, dropout 0.1).

Without ranks: a stage under scan draws the whole model's weights of its
layers (gpipe's halves, interleaved's chunks), as the unrolled stage does;
``estimate_hbm`` under scan at (data 2, pipe 2) equals JAX's.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_llm_training_benchmark_framework_tpu.data.synthetic import (
    SyntheticDataset as JaxSyntheticDataset,
)
from distributed_llm_training_benchmark_framework_tpu.models import tinygpt as jtiny
from distributed_llm_training_benchmark_framework_tpu.parallel import interleaved as jint
from distributed_llm_training_benchmark_framework_tpu.parallel import make_mesh as jmake_mesh
from distributed_llm_training_benchmark_framework_tpu.parallel import strategies as jstrat
from distributed_llm_training_benchmark_framework_tpu.train.step import _resolve_model_config
from distributed_llm_training_benchmark_framework_tpu.utils import memory as jmemory
from distributed_llm_training_benchmark_framework_tpu_torch import bridge
from distributed_llm_training_benchmark_framework_tpu_torch.models import TinyGPT, get_config
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import strategies as tstrat
from distributed_llm_training_benchmark_framework_tpu_torch.parallel.interleaved import (
    layer_permutation,
)
from distributed_llm_training_benchmark_framework_tpu_torch.parallel.mesh import Mesh
from distributed_llm_training_benchmark_framework_tpu_torch.parallel.pipeline import (
    expected_messages,
)
from distributed_llm_training_benchmark_framework_tpu_torch.utils import memory as tmemory
from distributed_llm_training_benchmark_framework_tpu_torch.utils.memory import jax_leaf_shapes

from torch_scan_composed_worker import (
    ACCUM,
    GEOMETRIES,
    MICRO,
    N_LAYER,
    RUNS,
    S,
    STEPS,
    V,
    flat,
    spawn_ranks,
    wait_ranks,
    world_of,
)
from torch_threads import one_thread  # noqa: F401  (autouse)

MODES = ("pp2", "dp2pp2", "tp2pp2")
AXES5 = ("data", "seq", "model", "pipe", "expert")
NEAR_EPS = 10 * 1e-8
PAIRS = [(mode, run) for mode in MODES for run in GEOMETRIES[mode][2]]


def jax_config():
    return jtiny.get_model_config("S", S, n_layer=N_LAYER, dropout=0.0,
                                  compute_dtype=jnp.float32, attention_impl="reference")


def batch_rows(table, step, dp):
    G = ACCUM * MICRO * dp
    return table[(step * G + np.arange(G)) % table.shape[0]].reshape(ACCUM, MICRO * dp, S)


def leaves(tree):
    return list(flat("", tree).items())


def jax_interleaved(init, batch):
    """JAX's own interleaved schedule at (pipe 2), V 2: (loss, gradient in
    layer order)."""
    mesh = jmake_mesh((1, 1, 1, 2, 1), AXES5, devices=jax.devices()[:2])
    perm = jint.layer_permutation(N_LAYER, 2, V)
    permuted = {**init, "blocks": {k: v[perm] for k, v in init["blocks"].items()}}
    with jax.set_mesh(mesh):
        loss, grads = jax.jit(lambda p: jint.interleaved_loss_and_grads(
            jax_config(), mesh, p, jnp.asarray(batch), virtual=V))(permuted)
    grads = jax.tree.map(np.asarray, grads)
    inverse = np.argsort(perm)
    return float(loss), {**grads, "blocks": {k: v[inverse] for k, v in grads["blocks"].items()}}


def jax_ddp_recipe(init, table):
    """JAX's ddp recipe at (data 1): per-step losses, the final params, the
    elements whose gradient has been under 10 Adam eps, the lr sum."""
    cfg = jax_config()
    arm = jstrat.get_strategy("ddp")
    tx = jstrat.make_optimizer(arm)
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: jtiny.loss_fn(cfg, p, b, b)))
    params, state = init, tx.init(init)
    small = jax.tree.map(lambda p: np.zeros(p.shape, bool), init)
    losses, lr_sum = [], 0.0
    for step in range(STEPS):
        batch = batch_rows(table, step, 1)
        parts = [grad_fn(params, batch[j]) for j in range(ACCUM)]
        losses.append(sum(float(v) for v, _ in parts) / ACCUM)
        g = jax.tree.map(lambda *gs: np.asarray(sum(gs) / ACCUM), *(g for _, g in parts))
        small = jax.tree.map(lambda m, g: m | (np.abs(g) < NEAR_EPS), small, g)
        updates, state = tx.update(g, state, params)
        params = jax.tree.map(np.asarray, optax.apply_updates(params, updates))
        lr_sum += arm.learning_rate * (min(1.0, step / arm.warmup_steps)
                                       if arm.warmup_steps else 1.0)
    return losses, params, small, lr_sum


@pytest.fixture(scope="module")
def runs(tmp_path_factory, eight_devices):
    """({mode: every rank's record}, {mode: rank 0's arrays}, JAX's
    interleaved (loss, gradient), JAX's ddp recipe)."""
    tmp = tmp_path_factory.mktemp("scan_pipe")
    init = jax.tree.map(np.asarray, jtiny.init_params(jax_config(), jax.random.key(42)))
    table = JaxSyntheticDataset(512, S, size=16, seed=42).data
    np.savez(tmp / "inputs.npz", table=table, **flat("l4", init))
    procs = {mode: spawn_ranks(world_of(mode), tmp / "inputs.npz", tmp / mode, mode)
             for mode in MODES}
    interleaved = jax_interleaved(init, batch_rows(table, 0, 1))
    recipe = jax_ddp_recipe(init, table)
    ranks, rank0 = {}, {}
    for mode, ps in procs.items():
        wait_ranks(ps)
        ranks[mode] = [json.loads((tmp / f"{mode}.rank{r}.json").read_text())
                       for r in range(len(ps))]
        rank0[mode] = np.load(tmp / f"{mode}.rank0.npz")
    return ranks, rank0, interleaved, recipe


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


@pytest.mark.parametrize("mode", MODES)
def test_messages_per_step_keep_their_law_under_scan(runs, mode):
    dp, tp, pp, _ = GEOMETRIES[mode][0]
    ranks = runs[0][mode]
    for run in GEOMETRIES[mode][2]:
        want = expected_messages(RUNS[run][1], pp, ACCUM, V)
        for place in range(dp * tp):
            stages = ranks[place * pp:(place + 1) * pp]
            assert [r["stage"] for r in stages] == [[s, pp] for s in range(pp)]
            for loop in ("unrolled", "scan"):
                for direction in (0, 1):
                    sent = sum(r["runs"][run][loop]["sent"][direction] for r in stages)
                    assert sent == want, (run, loop, direction)


@pytest.mark.parametrize("mode", MODES)
def test_zero2_reduce_scatters_each_block_inside_the_schedule_under_scan(runs, mode):
    """A layer's bucket is armed for its chunk's last backward unit, and the
    ``_Feed`` node of that unit starts it: every block bucket of the stage
    has started before the schedule ends."""
    for r in runs[0][mode]:
        for run in GEOMETRIES[mode][2]:
            if RUNS[run][0] == "zero2":
                launched, blocks = r["runs"][run]["scan"]["launched"]
                assert launched == blocks >= N_LAYER // 2, run
                assert r["runs"][run]["unrolled"]["launched"] == [launched, blocks], run


def test_fsdp_stage_holds_jaxs_bytes_of_each_stacked_leaf(runs):
    """(data 2, pipe 2): ``pipe`` takes the layer axis, so ``data`` goes on a
    tensor axis (the layer-axis fallback is closed): each rank holds
    1 / (pipe * data) of the leaf, as JAX's spec gives it."""
    cfg = get_config("tinygpt", "S", S, n_layer=N_LAYER)
    shapes = jax_leaf_shapes(cfg)
    mesh = {"data": 2, "pipe": 2}
    specs = tstrat.param_partition_specs(shapes, mesh, True, cfg.kv_heads, scan_stacked=True)
    for r in runs[0]["dp2pp2"]:
        for run in ("fsdp.gpipe", "fsdp.interleaved", "zero3.1f1b"):
            held = r["runs"][run]["scan"]["held"]
            for leaf, got in held.items():
                name = f"blocks/{leaf}"
                assert specs[name][0] == "pipe" and "data" in specs[name][1:], name
                want = 4 * int(np.prod(shapes[name])) // (mesh["pipe"] * mesh["data"])
                assert got == want, (run, leaf)


def test_interleaved_under_scan_matches_jaxs_own_schedule(runs):
    """Step 0: the loss and the gradient after ddp's reduction, against
    JAX's ``interleaved_loss_and_grads`` on its scan-stacked params."""
    ranks, rank0, (loss, grads) = runs[:3]
    for r in ranks["pp2"]:
        np.testing.assert_allclose(r["runs"]["ddp.interleaved"]["scan"]["losses"][0], loss,
                                   rtol=1e-5)
    for key, leaf in leaves(grads):
        got = rank0["pp2"][f"ddp.interleaved.grad{key}"]
        assert np.abs(got - leaf).max() <= 1e-5 * np.abs(leaf).max(), key


def test_interleaved_under_scan_trains_as_jaxs_recipe(runs):
    ranks, rank0 = runs[:2]
    want_losses, want, small, lr_sum = runs[3]
    for r in ranks["pp2"]:
        np.testing.assert_allclose(r["runs"]["ddp.interleaved"]["scan"]["losses"], want_losses,
                                   rtol=1e-5)
    tiny = dict(leaves(small))
    for key, leaf in leaves(want):
        got, near = rank0["pp2"][f"ddp.interleaved.params{key}"], tiny[key]
        np.testing.assert_allclose(got[~near], leaf[~near], rtol=1e-5, atol=2e-6, err_msg=key)
        assert (np.abs(got[near] - leaf[near]) <= lr_sum).all(), key


def test_checkpoint_saved_unrolled_resumes_under_scan(runs):
    for r in runs[0]["pp2"]:
        ck = r["checkpoints"]
        assert len(ck["straight"]) == 6
        assert ck["unrolled->scan"] == ck["straight"]


@pytest.mark.parametrize("schedule,virtual", [("gpipe", 1), ("interleaved", 2)])
def test_a_scan_stage_draws_the_whole_models_weights_of_its_layers(monkeypatch, schedule,
                                                                  virtual):
    """Stacked in ``layer_permutation`` order, each row the global layer the
    unrolled stage's ``blocks.<i>`` holds, with the same weights."""
    cfg = get_config("tinygpt", "S", 64, n_layer=8, dropout=0.0)
    perm = layer_permutation(8, 2, virtual)
    for stage in range(2):
        monkeypatch.setattr(Mesh, "pipe_shard", property(lambda self, s=stage: (s, 2)))
        models = [TinyGPT(dataclasses.replace(cfg, scan_layers=scan), Mesh({"pipe": 2}),
                          virtual_stages=virtual).init_weights(torch.Generator().manual_seed(5))
                  for scan in (False, True)]
        unrolled, scan = models
        assert scan.scan and scan.layer_ids == [int(g) for g in perm[stage * 4:(stage + 1) * 4]]
        assert scan.layer_ids == unrolled.layer_ids
        for i in range(4):
            for leaf in scan.blocks.leaf_names:
                assert torch.equal(scan.blocks.stacked(leaf)[i],
                                   getattr(unrolled.blocks[i], leaf)), (stage, i, leaf)
        got, want = bridge.export_params(scan), bridge.export_params(unrolled)
        for key, leaf in leaves(want):
            np.testing.assert_array_equal(dict(leaves(got))[key], leaf)


@pytest.mark.parametrize("arm", sorted(jstrat.STRATEGIES))
def test_estimate_hbm_under_scan_beside_pipe_is_jaxs(eight_devices, arm):
    """Tier A at (data 2, pipe 2) under JAX's ``scan_layers=True``: params,
    grads, activations and logits equal JAX's ``estimate_hbm``, the AdamW
    moments its optimizer state less optax's scalar counters."""
    jstrategy = jstrat.get_strategy(arm)
    jmesh = jmake_mesh((2, 1, 1, 2, 1), AXES5, devices=jax.devices()[:4])
    jcfg = _resolve_model_config(jtiny.get_model_config("A", 2048, scan_layers=True),
                                 jstrategy, jmesh)
    # JAX runs a CPU pipeline in fp32; the estimate is of the card's bf16 run.
    jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.bfloat16)
    want = jmemory.estimate_hbm(jcfg, jstrategy, jmesh, 1, 2048)
    opt = jstrat.make_optimizer(jstrategy)
    shapes = jax.eval_shape(lambda: jtiny.init_params(jcfg, jax.random.key(0)))
    scalars = sum(np.dtype(x.dtype).itemsize for x in
                  jax.tree_util.tree_leaves(jax.eval_shape(opt.init, shapes)) if x.shape == ())
    strategy = tstrat.get_strategy(arm)
    got = tmemory.estimate_hbm(get_config("tinygpt", "A", 2048, remat=strategy.remat,
                                          scan_layers=True), strategy,
                               Mesh({"data": 2, "pipe": 2}), 1, 2048)
    assert (got.params, got.grads, got.activations, got.logits) == (
        want.params, want.grads, want.activations, want.logits)
    assert got.opt_state == want.opt_state - scalars
