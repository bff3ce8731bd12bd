"""Pipelines beside tensor parallelism over gloo ranks on the CPU, against
the JAX package (``parallel/pipeline.py``, the stage form of
``models/tinygpt.py`` under ``model``, the arms per stage in
``parallel/strategies.py``).

A module fixture starts the ranks once (``tests/torch_pipe_worker.py``,
its ``TP_GEOMETRIES``) for (data, model, pipe) = (1, 2, 2) under gpipe,
1f1b and interleaved and (2, 2, 2) under gpipe: tier S at S 64, fp32
compute, dropout 0, per-device batch 1 x accum 4 (the schedules' M 4),
from the JAX init through ``bridge.load_jax_params``; gpipe and 1f1b on
the 2-layer model, interleaved on a 4-layer one at V 2. Each stage holds
its layers' Megatron shards and, as JAX's ``param_partition_specs`` lays
them out under ``pipe``, the whole ``wte`` on every ``model`` rank. Held
against ``jax.grad`` of ``tinygpt.loss_fn`` averaged over the M
microbatches on the same params and JAX's recipe of the arm
(``tests/test_torch_pipeline.py``'s references; JAX's own
``tests/test_pipeline.py::test_pp_composes_with_tp_subprocess`` equates
that recipe with its tp x pp trajectory), at ``tests/test_torch_arms.py``'s
tolerances: the gradient after the arm's reduction (ddp), the clip's norm
(ddp and zero2: the blocks' squares summed over ``model`` where ``model``
shards them and over ``pipe``, the leaves every stage holds counted once),
3 steps of ddp and zero2; each rank's leaf shapes against JAX's specs on a
(1, 1, 2, 2) mesh; messages per step and direction M * (P - 1) (gpipe,
1f1b) and M * (P * V - 1) (interleaved) on every pipeline.
"""

import json

import jax
import numpy as np
import pytest

from distributed_llm_training_benchmark_framework_tpu.data.synthetic import (
    SyntheticDataset as JaxSyntheticDataset,
)
from distributed_llm_training_benchmark_framework_tpu.models import tinygpt as jtiny
from distributed_llm_training_benchmark_framework_tpu.parallel import make_mesh as jmake_mesh
from distributed_llm_training_benchmark_framework_tpu.parallel import strategies as jstrat
from distributed_llm_training_benchmark_framework_tpu_torch.parallel.interleaved import (
    layer_permutation,
)
from distributed_llm_training_benchmark_framework_tpu_torch.parallel.pipeline import (
    expected_messages,
)

from test_torch_pipeline import (
    AXES5,
    RECIPE,
    _grads_close,
    _norm,
    batch_rows,
    jax_config,
    jax_recipe,
    leaves,
    mean_value_and_grad,
)
from torch_pipe_worker import (
    ACCUM,
    S,
    SCHEDULE_CONFIG,
    TP_ARMS,
    TP_GEOMETRIES,
    TP_SCHEDULES,
    V,
    spawn_ranks,
    wait_ranks,
)
from torch_threads import one_thread  # noqa: F401  (autouse)

CASES = [(mode, schedule) for mode, schedules in TP_SCHEDULES.items() for schedule in schedules]
ARM_CASES = [(mode, arm, schedule) for mode, schedule in CASES for arm in TP_ARMS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe_tp")
    init = {label: jax.tree.map(np.asarray, jtiny.init_params(jax_config(label),
                                                              jax.random.key(42)))
            for label in ("l2", "l4")}
    table = JaxSyntheticDataset(512, S, size=16, seed=42).data
    arrays = {"table": table}
    for label, params in init.items():
        arrays.update({f"{label}.{k}": v for k, v in leaves(params)})
    np.savez(tmp / "inputs.npz", **arrays)
    procs = {mode: spawn_ranks(dp * tp * pp, tmp / "inputs.npz", tmp / mode, mode)
             for mode, (dp, tp, pp) in TP_GEOMETRIES.items()}
    ref = {}
    for mode, schedule in CASES:
        dp, label = TP_GEOMETRIES[mode][0], SCHEDULE_CONFIG[schedule]
        if (label, dp) not in ref:
            ref[label, dp] = mean_value_and_grad(label, init[label], batch_rows(table, 0, dp))
        for arm in TP_ARMS:
            if (RECIPE[arm], label, dp) not in ref:
                ref[RECIPE[arm], label, dp] = jax_recipe(RECIPE[arm], label, init[label],
                                                         table, dp)
    ranks, rank0 = {}, {}
    for mode, ps in procs.items():
        wait_ranks(ps)
        ranks[mode] = [json.loads((tmp / f"{mode}.rank{r}.json").read_text())
                       for r in range(len(ps))]
        rank0[mode] = np.load(tmp / f"{mode}.rank0.npz")
    return ranks, rank0, ref, init


@pytest.mark.parametrize("mode,schedule", CASES)
def test_gradient_is_the_global_one(runs, mode, schedule):
    ranks, rank0, ref, _ = runs
    loss, grads = ref[SCHEDULE_CONFIG[schedule], TP_GEOMETRIES[mode][0]]
    for r in ranks[mode]:
        np.testing.assert_allclose(r["losses"][f"grad.{schedule}"], loss, rtol=1e-5)
    _grads_close(rank0[mode], f"grad.{schedule}", grads)


@pytest.mark.parametrize("mode,arm,schedule", ARM_CASES)
def test_arm_matches_its_jax_recipe(runs, mode, arm, schedule):
    ranks, rank0, ref, _ = runs
    dp = TP_GEOMETRIES[mode][0]
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


@pytest.mark.parametrize("mode,arm,schedule", ARM_CASES)
def test_clip_norm_counts_every_element_once(runs, mode, arm, schedule):
    """Summing the replicated ``wte`` over ``model`` or ``pipe``, or a block's
    replicated norm scale over ``model``, would add its share again."""
    ranks, _, ref, _ = runs
    grads = ref[SCHEDULE_CONFIG[schedule], TP_GEOMETRIES[mode][0]][1]
    want = _norm(grads)
    wte = np.square(grads["wte"].astype(np.float64)).sum()
    assert np.sqrt(want ** 2 + wte) > want * (1 + 1e-3)
    for r in ranks[mode]:
        np.testing.assert_allclose(r["norms"][f"{arm}.{schedule}"], want, rtol=1e-5)


@pytest.mark.parametrize("schedule", TP_SCHEDULES["tp2pp2"])
def test_leaf_shapes_equal_jaxs_specs(runs, schedule, eight_devices):
    """Each rank's leaves are its shards of JAX's layout on a (1, 1, 2, 2)
    mesh: the blocks' 'model' axes split, the layer axis over 'pipe' (the
    stage's layers in ``layer_permutation`` order under interleaved), and
    ``wte`` whole on every 'model' rank."""
    ranks, _, _, init = runs
    label = SCHEDULE_CONFIG[schedule]
    params = init[label]
    mesh = jmake_mesh((1, 1, 2, 2, 1), AXES5, devices=jax.devices()[:4])
    specs = jstrat.param_partition_specs(params, mesh, shard=False,
                                         kv_heads=jax_config(label).n_head)
    assert tuple(specs["wte"]) in ((), (None, None))
    n_layer = params["blocks"]["wqkv"].shape[0]
    for r in ranks["tp2pp2"]:
        (stage, pp), (m, tp) = r["stage"], r["model"]
        shapes = r["shapes"][schedule]
        virtual = V if schedule == "interleaved" else 1
        mine = layer_permutation(n_layer, pp, virtual)[stage * (n_layer // pp):
                                                      (stage + 1) * (n_layer // pp)]
        for key, leaf in leaves(params):
            spec = tuple(specs["blocks"][key.split(".", 1)[1]] if key.startswith("blocks.")
                         else specs[key])
            spec = spec + (None,) * (leaf.ndim - len(spec))
            want = [n // tp if ax == "model" else n for n, ax in zip(leaf.shape, spec)]
            if key.startswith("blocks."):
                assert spec[0] == "pipe", key
                for i in range(len(mine)):
                    assert shapes[f"blocks.{i}.{key.split('.', 1)[1]}"] == want[1:], key
                assert f"blocks.{len(mine)}.{key.split('.', 1)[1]}" not in shapes
            else:
                assert shapes[key] == want, key


@pytest.mark.parametrize("mode", list(TP_GEOMETRIES))
def test_messages_per_step_follow_the_law(runs, mode):
    """Every (data, model) place runs its own pipeline of P stages, pipe
    fastest in the rank order."""
    ranks = runs[0][mode]
    dp, tp, pp = TP_GEOMETRIES[mode]
    for schedule in TP_SCHEDULES[mode]:
        want = expected_messages(schedule, pp, ACCUM, V)
        for place in range(dp * tp):
            stages = ranks[place * pp:(place + 1) * pp]
            assert [r["stage"] for r in stages] == [[s, pp] for s in range(pp)]
            assert {r["model"][0] for r in stages} == {place % tp}
            for direction in (0, 1):
                assert sum(r["sent"][schedule][direction] for r in stages) == want, (
                    schedule, direction)
