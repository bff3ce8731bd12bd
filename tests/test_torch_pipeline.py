"""Pipeline parallelism over gloo ranks on the CPU, against the JAX package
(``parallel/pipeline.py``, ``parallel/interleaved.py``, the stage form of
``models/tinygpt.py``, the arms under ``pipe`` in
``parallel/strategies.py``).

A module fixture starts the ranks once (``tests/torch_pipe_worker.py``) for
three geometries, (data, seq, pipe) = (1, 1, 2), (2, 1, 2) and (1, 2, 2):
tier S at S 64, fp32 compute (JAX's CPU pipelines run fp32), dropout 0,
per-device batch 1 x accum 4 (the schedules' M 4), from the JAX init
through ``bridge.load_jax_params``; gpipe and 1f1b on the 2-layer model,
interleaved on a 4-layer one at V 2 (the 2-layer one has no two chunks per
stage). The JAX side runs on the conftest's virtual CPU devices:

- at (pipe 2) the port's gradient under each schedule (ddp, after the arm's
  reduction) against JAX's own schedules on a (1, 1, 1, 2, 1) mesh:
  ``pipeline_loss_fn`` under ``jax.value_and_grad`` for gpipe,
  ``pipeline_loss_and_grads_1f1b`` for 1f1b and
  ``interleaved_loss_and_grads`` (its params stacked in
  ``layer_permutation`` order, its gradients put back in layer order) for
  interleaved;
- the other cases against ``jax.grad`` of ``tinygpt.loss_fn`` averaged over
  the M microbatches on the same params (JAX's own tests equate that with
  its schedules): the MoE model (4 experts) under each schedule, (data 2,
  pipe 2), and the ring under each schedule and Ulysses under gpipe at
  (seq 2, pipe 2) (both equal attention over the whole sequence);
- 3 steps of every arm at (data 2, pipe 2), and of ddp and zero2 at (pipe
  2), under each schedule, and of every arm under 1f1b with the ring at
  (seq 2, pipe 2), against JAX's recipe of the arm (``loss_fn`` +
  ``make_optimizer`` composed as its train step composes them,
  ``tests/test_torch_arms.py``); FSDP2 so reshards and gathers around the
  1f1b and interleaved recompute, zero2 arms each block's bucket at its
  own last backward unit.

Tolerances are ``tests/test_torch_arms.py``'s: loss 1e-5 relative,
gradients 1e-5 of each leaf's largest magnitude, params 1e-5 relative plus
2e-6 absolute on every element whose gradient stayed above 10 Adam eps
(the others within lr per step taken); the clip's norm against the norm of
JAX's whole gradient, 1e-5 relative (the replicated leaves counted once).
At dropout 0.1 the three schedules draw the same masks (seeded per
microbatch and global layer), so their losses agree to 1e-5 relative.
bf16 parameters and the serial and delayed host-offload arms under 1f1b
at (pipe 2) are held to the port's own one-process run of the same arm: losses within
``tests/test_torch_offload.py``'s 1e-4 relative, params within what
``tests/test_torch_arms.py`` allows the offload arm over two ranks (lr per
step taken, 99% of each leaf within 2^-5 of it) plus a bf16 step: the
pipeline sums the shared embedding's two shares (first stage, last stage)
in another order, so bf16 rounds them differently. Messages sent per step
and direction, summed over a pipeline's stages, equal M * (P - 1) (gpipe,
1f1b) and M * (P * V - 1) (interleaved). zero2 starts every block's
reduce-scatter inside the schedule. The row validates and carries the
three pipeline keys.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_llm_training_benchmark_framework_tpu.analysis.validate_results import (
    validate_result,
)
from distributed_llm_training_benchmark_framework_tpu.data.synthetic import (
    SyntheticDataset as JaxSyntheticDataset,
)
from distributed_llm_training_benchmark_framework_tpu.models import tinygpt as jtiny
from distributed_llm_training_benchmark_framework_tpu.parallel import interleaved as jint
from distributed_llm_training_benchmark_framework_tpu.parallel import make_mesh as jmake_mesh
from distributed_llm_training_benchmark_framework_tpu.parallel import pipeline as jpipe
from distributed_llm_training_benchmark_framework_tpu.parallel import strategies as jstrat
from distributed_llm_training_benchmark_framework_tpu_torch import bridge
from distributed_llm_training_benchmark_framework_tpu_torch.models import TinyGPT
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import strategies as tstrat
from distributed_llm_training_benchmark_framework_tpu_torch.parallel.pipeline import (
    expected_messages,
)
from distributed_llm_training_benchmark_framework_tpu_torch.train.step import TrainStep

from torch_pipe_worker import (
    ACCUM,
    CONFIGS,
    GEOMETRIES,
    MICRO,
    NORM_ARMS,
    OFFLOAD_RUNS,
    S,
    SCHEDULE_CONFIG,
    SEQ_RUNS,
    STEPS,
    TRAJECTORIES,
    V,
    config,
    spawn_ranks,
    strategy,
    wait_ranks,
)
from torch_threads import one_thread  # noqa: F401  (autouse)

AXES5 = ("data", "seq", "model", "pipe", "expert")
RECIPE = {"ddp": "ddp", "fsdp": "ddp", "zero2": "zero2", "zero3": "zero2"}
NEAR_EPS = 10 * 1e-8
BF16_STEP = 2.0 ** -7
TRAINED = [(mode, arm, schedule) for mode, runs in TRAJECTORIES.items()
           for arm, schedule in runs]
NORMED = [(mode, arm, schedule) for mode in NORM_ARMS for schedule in SCHEDULE_CONFIG
          for arm in (NORM_ARMS[mode] if mode == "pp2" or schedule == "gpipe" else ("ddp",))]


def jax_config(label, **kw):
    n_layer, experts = CONFIGS[label]
    return jtiny.get_model_config("S", S, n_layer=n_layer, n_experts=experts, dropout=0.0,
                                  compute_dtype=jnp.float32, attention_impl="reference", **kw)


def leaves(tree):
    out = [(k, v) for k, v in tree.items() if k != "blocks"]
    return out + [(f"blocks.{k}", v) for k, v in tree["blocks"].items()]


def batch_rows(table, step, dp):
    G = ACCUM * MICRO * dp
    return table[(step * G + np.arange(G)) % table.shape[0]].reshape(ACCUM, MICRO * dp, S)


@functools.lru_cache(maxsize=None)
def _value_and_grad(label):
    cfg = jax_config(label)
    return jax.jit(jax.value_and_grad(lambda p, b: jtiny.loss_fn(cfg, p, b, b)))


def mean_value_and_grad(label, params, batch):
    """JAX's loss and gradient averaged over the microbatches of ``batch``."""
    fn = _value_and_grad(label)
    parts = [fn(params, batch[j]) for j in range(batch.shape[0])]
    loss = sum(float(v) for v, _ in parts) / len(parts)
    return loss, jax.tree.map(lambda *gs: np.asarray(sum(gs) / len(gs)), *(g for _, g in parts))


def jax_schedules(init, batch):
    """{schedule: (loss, gradient)} from JAX's own schedules at (pipe 2)."""
    mesh = jmake_mesh((1, 1, 1, 2, 1), AXES5, devices=jax.devices()[:2])
    cfg2, cfg4 = jax_config("l2"), jax_config("l4")
    perm = jint.layer_permutation(4, 2, V)
    inverse = np.argsort(perm)
    permuted = {**init["l4"], "blocks": {k: v[perm] for k, v in init["l4"]["blocks"].items()}}
    with jax.set_mesh(mesh):
        out = {
            "gpipe": jax.jit(jax.value_and_grad(
                lambda p: jpipe.pipeline_loss_fn(cfg2, mesh, p, batch)))(init["l2"]),
            "1f1b": jax.jit(lambda p: jpipe.pipeline_loss_and_grads_1f1b(
                cfg2, mesh, p, batch))(init["l2"]),
            "interleaved": jax.jit(lambda p: jint.interleaved_loss_and_grads(
                cfg4, mesh, p, batch, virtual=V))(permuted),
        }
    out = {k: (float(v), jax.tree.map(np.asarray, g)) for k, (v, g) in out.items()}
    loss, grads = out["interleaved"]
    out["interleaved"] = (loss, {**grads, "blocks": {k: v[inverse]
                                                     for k, v in grads["blocks"].items()}})
    return out


def jax_recipe(recipe, label, init, table, dp):
    """JAX's recipe of an arm at (data dp): (per-step losses, final params,
    the elements whose gradient has been under 10 Adam eps, the lr sum)."""
    arm = jstrat.get_strategy(recipe)
    tx = jstrat.make_optimizer(arm)
    update = jax.jit(lambda g, st, p: (lambda u, st: (optax.apply_updates(p, u), st))(
        *tx.update(g, st, p)))
    params, state = init, tx.init(init)
    small = jax.tree.map(lambda p: np.zeros(p.shape, bool), init)
    losses, lr_sum = [], 0.0
    for step in range(STEPS):
        loss, g = mean_value_and_grad(label, params, batch_rows(table, step, dp))
        losses.append(loss)
        small = jax.tree.map(lambda m, g: m | (np.abs(g) < NEAR_EPS), small, g)
        params, state = update(g, state, params)
        params = jax.tree.map(np.asarray, params)
        lr_sum += arm.learning_rate * (min(1.0, step / arm.warmup_steps)
                                       if arm.warmup_steps else 1.0)
    return losses, params, small, lr_sum


def one_process(init, table, **change):
    """The port's own one-process run of zero2 on the 2-layer model under
    ``change`` (bf16 parameters, host offload): (losses, final params)."""
    strat = strategy("zero2", **change)
    model = TinyGPT(config("l2", param_dtype=tstrat.param_torch_dtype(strat)))
    bridge.load_jax_params(model, init)
    model, opt = tstrat.apply_strategy(model, strat, None)
    step_fn = TrainStep(model, opt, grad_accum=ACCUM, micro_batch=MICRO, seed=0,
                        device=torch.device("cpu"))
    t = torch.from_numpy(table.astype(np.int64))
    return [step_fn(t, s).item() for s in range(STEPS)], bridge.export_params(model)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, eight_devices):
    tmp = tmp_path_factory.mktemp("pipe")
    init = {label: jax.tree.map(np.asarray, jtiny.init_params(jax_config(label),
                                                              jax.random.key(42)))
            for label in CONFIGS}
    table = JaxSyntheticDataset(512, S, size=16, seed=42).data
    arrays = {"table": table}
    for label, params in init.items():
        arrays.update({f"{label}.{k}": v for k, v in leaves(params)})
    np.savez(tmp / "inputs.npz", **arrays)
    procs = {mode: spawn_ranks(dp * sp * pp, tmp / "inputs.npz", tmp / mode, mode)
             for mode, (dp, sp, pp) in GEOMETRIES.items()}
    ref = {"schedules": jax_schedules(init, batch_rows(table, 0, 1))}
    for dp in (1, 2):
        for label in CONFIGS:
            ref[label, dp] = mean_value_and_grad(label, init[label], batch_rows(table, 0, dp))
        for recipe in ("ddp", "zero2"):
            for label in ("l2", "l4"):
                ref[recipe, label, dp] = jax_recipe(recipe, label, init[label], table, dp)
    for label, change in OFFLOAD_RUNS.items():
        ref[label] = one_process(init["l2"], table, **change)
    ranks, rank0 = {}, {}
    for mode, ps in procs.items():
        wait_ranks(ps)
        ranks[mode] = [json.loads((tmp / f"{mode}.rank{r}.json").read_text())
                       for r in range(len(ps))]
        rank0[mode] = np.load(tmp / f"{mode}.rank0.npz")
    return ranks, rank0, ref


def _grads_close(arrays, label, want):
    for key, leaf in leaves(want):
        got = arrays[f"{label}.{key}"]
        assert np.abs(got - leaf).max() <= 1e-5 * np.abs(leaf).max(), (label, key)


def _norm(grads):
    return np.sqrt(sum(np.square(v.astype(np.float64)).sum() for _, v in leaves(grads)))


@pytest.mark.parametrize("schedule", list(SCHEDULE_CONFIG))
def test_gradients_equal_jaxs_own_schedule(runs, schedule):
    ranks, rank0, ref = runs
    loss, grads = ref["schedules"][schedule]
    for r in ranks["pp2"]:
        np.testing.assert_allclose(r["losses"][f"grad.{schedule}"], loss, rtol=1e-5)
    _grads_close(rank0["pp2"], f"grad.{schedule}", grads)


@pytest.mark.parametrize("schedule", list(SCHEDULE_CONFIG))
def test_moe_under_each_schedule_equals_jaxs_gradient(runs, schedule):
    """Each stage sums its layers' aux over the units it ran and seeds its
    gradient coef / (n_layer * M): the router's gradient carries the aux."""
    ranks, rank0, ref = runs
    loss, grads = ref["moe", 1]
    for r in ranks["pp2"]:
        np.testing.assert_allclose(r["losses"][f"moe.{schedule}"], loss, rtol=1e-5)
    _grads_close(rank0["pp2"], f"grad.moe.{schedule}", grads)


@pytest.mark.parametrize("schedule", list(SCHEDULE_CONFIG))
def test_data_and_pipe_gradient_is_the_global_one(runs, schedule):
    ranks, rank0, ref = runs
    loss, grads = ref[SCHEDULE_CONFIG[schedule], 2]
    for r in ranks["dp2pp2"]:
        np.testing.assert_allclose(r["losses"][f"grad.{schedule}"], loss, rtol=1e-5)
    _grads_close(rank0["dp2pp2"], f"grad.{schedule}", grads)


@pytest.mark.parametrize("label,schedule,attention", SEQ_RUNS)
def test_seq_and_pipe_gradient_equals_whole_sequence_attention(runs, label, schedule,
                                                               attention):
    ranks, rank0, ref = runs
    loss, grads = ref[SCHEDULE_CONFIG[schedule], 1]
    for r in ranks["sp2pp2"]:
        np.testing.assert_allclose(r["losses"][label], loss, rtol=1e-5)
    _grads_close(rank0["sp2pp2"], f"grad.{label}", grads)


@pytest.mark.parametrize("mode,arm,schedule", TRAINED)
def test_arm_matches_its_jax_recipe_under_the_pipeline(runs, mode, arm, schedule):
    ranks, rank0, ref = runs
    dp = GEOMETRIES[mode][0]
    want_losses, want, small, lr_sum = ref[RECIPE[arm], SCHEDULE_CONFIG[schedule], dp]
    label = f"{arm}.{schedule}"
    for r in ranks[mode]:
        assert r["losses"][label] == ranks[mode][0]["losses"][label]
    np.testing.assert_allclose(ranks[mode][0]["losses"][label], want_losses, rtol=1e-5)
    tiny = dict(leaves(small))
    for key, leaf in leaves(want):
        got, near = rank0[mode][f"{label}.{key}"], tiny[key]
        np.testing.assert_allclose(got[~near], leaf[~near], rtol=1e-5, atol=2e-6, err_msg=key)
        assert (np.abs(got[near] - leaf[near]) <= lr_sum).all(), key


@pytest.mark.parametrize("mode,arm,schedule", NORMED)
def test_clip_norm_counts_the_replicated_leaves_once(runs, mode, arm, schedule):
    """The blocks' squares summed over ``pipe``, the embedding, final norm
    and head counted once (every stage holds them): the norm of JAX's whole
    gradient. Counting them once per stage would add wte's share again."""
    ranks, _, ref = runs
    dp = GEOMETRIES[mode][0]
    grads = ref["schedules"][schedule][1] if mode == "pp2" else ref[SCHEDULE_CONFIG[schedule],
                                                                    dp][1]
    want = _norm(grads)
    wte = np.square(grads["wte"].astype(np.float64)).sum()
    assert np.sqrt(want ** 2 + wte) > want * (1 + 1e-3)
    for r in ranks[mode]:
        np.testing.assert_allclose(r["norms"][f"{arm}.{schedule}"], want, rtol=1e-5)


@pytest.mark.parametrize("mode", list(NORM_ARMS))
def test_zero2_reduce_scatters_each_block_inside_the_schedule(runs, mode):
    """zero2 arms a block's bucket for that block's last backward unit (a
    different tick per chunk under interleaved), so every block bucket has
    started its reduce-scatter before the schedule ends; the leaves every
    stage holds wait for ``finish_grads``."""
    for r in runs[0][mode]:
        for schedule, (launched, blocks) in r["zero2_launched"].items():
            assert blocks == (2 if schedule == "interleaved" else 1)
            assert launched == blocks, (schedule, launched, blocks)


def test_schedules_draw_the_same_masks_at_dropout(runs):
    ranks, _, ref = runs
    for r in ranks["pp2"]:
        gpipe = r["losses"]["dropout.gpipe"]
        for schedule in ("1f1b", "interleaved"):
            np.testing.assert_allclose(r["losses"][f"dropout.{schedule}"], gpipe, rtol=1e-5)
        # The masks are on: the first step's loss is not the dropout-free one.
        assert abs(gpipe[0] - ref["l4", 1][0]) > 1e-3


@pytest.mark.parametrize("label", list(OFFLOAD_RUNS))
def test_bf16_and_offload_compose_with_the_pipeline(runs, label):
    ranks, rank0, ref = runs
    want_losses, want = ref[label]
    for r in ranks["pp2"]:
        np.testing.assert_allclose(r["losses"][label], want_losses, rtol=1e-4)
    lr_sum = sum(1e-4 * min(1.0, s / 5) for s in range(STEPS))
    for key, leaf in leaves(want):
        leaf = leaf.astype(np.float64)
        diff = np.abs(rank0["pp2"][f"{label}.{key}"].astype(np.float64) - leaf)
        step = BF16_STEP * np.abs(leaf)
        assert (diff <= lr_sum + step).all(), key
        assert (diff <= 2 ** -5 * lr_sum + step).mean() >= 0.99, key


@pytest.mark.parametrize("mode", list(GEOMETRIES))
def test_messages_per_step_follow_the_law(runs, mode):
    """Summed over one pipeline's stages: M * (P - 1) per direction, or M *
    (P * V - 1) under interleaved; every place of (data, seq) runs its own
    pipeline."""
    ranks = runs[0][mode]
    dp, sp, pp = GEOMETRIES[mode]
    for key in ranks[0]["sent"]:
        schedule = key.split(".")[-1]
        want = expected_messages(schedule, pp, ACCUM, V)
        for place in range(dp * sp):
            stages = ranks[place * pp:(place + 1) * pp]
            assert [r["stage"] for r in stages] == [[s, pp] for s in range(pp)]
            for direction in (0, 1):
                assert sum(r["sent"][key][direction] for r in stages) == want, (key, direction)


def test_row_validates_and_carries_the_pipeline_keys(runs):
    row = runs[0]["pp2"][0]["row"]
    assert (row["world_size"], row["pipeline_parallel"], row["pipeline_schedule"],
            row["virtual_stages"]) == (2, 2, "gpipe", 1)
    assert validate_result(row, "pipe 2 gpipe") == []
    # One pipeline of two stages takes one place's rows: dp = world // pp = 1.
    assert row["tokens_per_sec"] == pytest.approx(MICRO * ACCUM * S / row["mean_step_time_sec"])
