"""Tensor parallelism across processes: the trainer over gloo ranks laid out
(data 2, model 2), with a (model 2) case beside it, against JAX's train step
on a mesh of the same widths, and against the port's own one-process run.

A module fixture starts the ranks once (``tests/torch_tp_worker.py``,
``train`` mode): for each family and arm, tier S at S 64, fp32 compute,
dropout 0, per-device batch 1 x accum 2, from the JAX init, 3 steps; over
(model 2) zero2 only. The families are TinyGPT, Llama tier S (2 query / 1
kv heads: a ``model`` width of 2 does not split the kv heads, so ``wkv``
stays replicated and each rank takes its query heads' k/v) and Llama at 4
query / 2 kv heads (aligned: ``wkv`` splits by kv heads). The JAX side is
``tinygpt.loss_fn`` under a (data, seq, model) mesh of the conftest's
virtual CPU devices with the params laid out by its
``param_partition_specs`` (GSPMD partitions the step Megatron-style), plus
``strategies.make_optimizer`` of the arm's recipe, composed as JAX's train
step composes them (as ``tests/test_torch_seq_parallel.py`` does). ddp and
fsdp share bare AdamW, zero2 and zero3 the warmup and the clip.

Tolerances are ``tests/test_torch_arms.py``'s: loss 1e-5 relative, params
1e-5 relative plus 2e-6 absolute on every element whose gradient has stayed
well above Adam's eps (1e-8), and the others held to what Adam can move them
(lr per step taken). "Well above" is 10 eps here: Adam's first update is
lr * g / (|g| + eps), whose slope lr * eps / (|g| + eps)^2 turns a gradient's
fp32 rounding of 1e-9 into 2.5e-6 at |g| = eps and under 1e-7 past 10 eps.
One element of Llama's ``wgu`` (4 / 2 heads, bare AdamW) has a first
gradient of 1.008e-8; the (data, model) all-reduces sum it in another order
than GSPMD does.
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
from distributed_llm_training_benchmark_framework_tpu.models import llama as jllama
from distributed_llm_training_benchmark_framework_tpu.models import tinygpt as jtiny
from distributed_llm_training_benchmark_framework_tpu.parallel import make_mesh as jmake_mesh
from distributed_llm_training_benchmark_framework_tpu.parallel import strategies as jstrat
from distributed_llm_training_benchmark_framework_tpu_torch.models import (
    TinyGPT,
    count_params,
    get_config,
)
from distributed_llm_training_benchmark_framework_tpu_torch import bridge
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import make_mesh
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import strategies as tstrat
from distributed_llm_training_benchmark_framework_tpu_torch.train import run_benchmark
from distributed_llm_training_benchmark_framework_tpu_torch.train.step import TrainStep

from test_torch_arms_worker import (
    OFFLOAD_IN_SHARE,
    OFFLOAD_LOSS_RTOL,
    OFFLOAD_LR_SHARE,
    master_tree,
)

from torch_tp_worker import (
    ACCUM,
    ARMS,
    F32_ZERO2,
    FAMILIES,
    MICRO,
    S,
    STEPS,
    TP,
    spawn_ranks,
    wait_ranks,
)

JAX_CONFIG = {"tinygpt": (jtiny.get_model_config, {}), "llama": (jllama.get_llama_config, {}),
              "llama4": (jllama.get_llama_config, {"n_head": 4, "n_kv_head": 2})}
RECIPE = {"ddp": "ddp", "fsdp": "ddp", "zero2": "zero2", "zero3": "zero2"}
DP = {4: 2, 2: 1}  # world -> data width at model width TP
ADAM_EPS = 1e-8
NEAR_EPS = 10 * ADAM_EPS  # see the module docstring
TRAINED = [(w, f, a) for w in (4, 2) for f in FAMILIES for a in ARMS[w]]


def jax_config(family, **kw):
    get, over = JAX_CONFIG[family]
    return get("S", S, dropout=0.0, compute_dtype=jnp.float32, **over, **kw)


def jax_params(family):
    return jax.tree.map(np.asarray, jtiny.init_params(jax_config(family, attention_impl="flash"),
                                                      jax.random.key(0)))


def jax_recipes(family, mesh_shape, recipes, table, init, impl="flash"):
    """{recipe: (per-step losses, final params, the elements whose gradient
    has been under Adam's eps, the sum of the learning rates)} of the JAX
    recipe on a (data, seq, model) mesh of ``mesh_shape`` at global
    micro-batch data * MICRO, the params laid out by JAX's specs."""
    jc = jax_config(family, attention_impl=impl)
    dp = mesh_shape[0]
    mesh = jmake_mesh(mesh_shape, ("data", "seq", "model"),
                      devices=jax.devices()[:int(np.prod(mesh_shape))])
    specs = jstrat.param_partition_specs(init, mesh, shard=False, kv_heads=jc.kv_heads)
    place = jstrat.named(mesh, specs)
    rows_on = NamedSharding(mesh, jstrat.batch_partition_spec(mesh))
    with jax.set_mesh(mesh):
        grad_fn = jax.jit(jax.value_and_grad(lambda p, b: jtiny.loss_fn(jc, p, b, b)))
    out = {}
    for recipe in recipes:
        arm = jstrat.get_strategy(recipe)
        tx = jstrat.make_optimizer(arm)

        @jax.jit
        def update(grads, state, params, tx=tx):
            updates, state = tx.update(grads, state, params)
            return optax.apply_updates(params, updates), state

        params = jax.tree.map(jnp.asarray, init)
        state = tx.init(params)
        small = jax.tree.map(lambda p: np.zeros(p.shape, bool), params)
        losses, lr_sum = [], 0.0
        for step in range(STEPS):
            G = ACCUM * MICRO * dp
            rows = (step * G + np.arange(G)) % table.shape[0]
            batch = table[rows].reshape(ACCUM, MICRO * dp, -1)
            loss_sum, grads = 0.0, jax.tree.map(lambda p: np.zeros(p.shape, p.dtype), params)
            with jax.set_mesh(mesh):
                laid = jax.device_put(params, place)
                for j in range(ACCUM):
                    loss, g = grad_fn(laid, jax.device_put(batch[j], rows_on))
                    loss_sum += float(loss)
                    grads = jax.tree.map(lambda a, b: a + np.asarray(b), grads, g)
            grads = jax.tree.map(lambda g: g / ACCUM, grads)
            small = jax.tree.map(lambda m, g: m | (np.abs(np.asarray(g)) < NEAR_EPS), small,
                                 grads)
            params, state = update(grads, state, jax.tree.map(np.asarray, params))
            warmup = arm.warmup_steps
            lr_sum += arm.learning_rate * (min(1.0, step / warmup) if warmup else 1.0)
            losses.append(loss_sum / ACCUM)
        out[recipe] = (losses, jax.tree.map(np.asarray, params), small, lr_sum)
    return out


def assert_params_match(rank0, label, params, small, lr_sum):
    leaves = [(k, params[k], small[k]) for k in params if k != "blocks"]
    leaves += [(f"blocks.{k}", v, small["blocks"][k]) for k, v in params["blocks"].items()]
    for key, leaf, tiny in leaves:
        got = rank0[f"{label}.{key}"]
        np.testing.assert_allclose(got[~tiny], leaf[~tiny], rtol=1e-5, atol=2e-6, err_msg=key)
        assert (np.abs(got[tiny] - leaf[tiny]) <= lr_sum).all(), key


def write_inputs(path, families, table, **extra):
    init = {family: jax_params(family) for family in families}
    arrays = {"table": table, **extra}
    for family, p in init.items():
        arrays.update({f"{family}.{k}": v for k, v in p.items() if k != "blocks"})
        arrays.update({f"{family}.blocks.{k}": v for k, v in p["blocks"].items()})
    np.savez(path, **arrays)
    return init


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({world: every rank's json}, {world: rank 0's arrays}, {(family,
    world): the JAX recipes}, the one-process run's per-step losses at
    dropout 0.1, the JAX init)."""
    tmp = tmp_path_factory.mktemp("tp")
    table = JaxSyntheticDataset(512, S, size=10, seed=42).data
    init = write_inputs(tmp / "inputs.npz", FAMILIES, table)
    procs = {w: spawn_ranks(w, tmp / "inputs.npz", tmp / f"w{w}", "train") for w in DP}
    # Meanwhile, the JAX runs and the port's one-process run at dropout 0.1.
    jax_runs = {(f, w): jax_recipes(f, (DP[w], 1, TP), sorted({RECIPE[a] for a in ARMS[w]}),
                                    table, init[f])
                for w in DP for f in FAMILIES}
    one_process = []
    run_benchmark(strategy=F32_ZERO2, tier="S", seq_len=S, steps=STEPS, warmup_steps=1,
                  per_device_batch=2, grad_accum=ACCUM, dropout=0.1, device="cpu",
                  loss_log=one_process)
    one_process_offload = _one_process_offload(init["tinygpt"], table)
    ranks, rank0 = {}, {}
    for w, ps in procs.items():
        wait_ranks(ps)
        ranks[w] = [json.loads((tmp / f"w{w}.rank{r}.json").read_text()) for r in range(w)]
        rank0[w] = np.load(tmp / f"w{w}.rank0.npz")
    return ranks, rank0, jax_runs, one_process, init, one_process_offload


def _one_process_offload(params, table):
    """zero2 with the serial offload arm in one process (bf16 parameters
    from the JAX init): every step's loss and the final masters."""
    strat = dataclasses.replace(F32_ZERO2, offload_opt_state=True)
    mesh = make_mesh()
    model = TinyGPT(get_config("tinygpt", "S", S, dropout=0.0, compute_dtype=torch.float32,
                               param_dtype=torch.bfloat16), mesh=mesh)
    bridge.load_jax_params(model, jax.tree.map(np.asarray, params))
    model, opt = tstrat.apply_strategy(model, strat, mesh)
    step_fn = TrainStep(model, opt, grad_accum=ACCUM, micro_batch=MICRO, seed=0,
                        device=torch.device("cpu"), mesh=mesh)
    t_table = torch.from_numpy(table.astype(np.int64))
    losses = [step_fn(t_table, step).item() for step in range(STEPS)]
    return losses, master_tree(model, opt, mesh)


@pytest.mark.parametrize("world", [4, 2])
def test_mesh_lays_ranks_out_data_major_model_fastest(runs, world):
    """Rank r sits at data r // tp, model r % tp; the group has dp * tp ranks."""
    for r, res in enumerate(runs[0][world]):
        assert res["mesh"] == [DP[world], r // TP, r % TP, world]


@pytest.mark.parametrize("world,family,arm", TRAINED)
def test_losses_and_params_match_jax(runs, world, family, arm):
    ranks, rank0, jax_runs = runs[0][world], runs[1][world], runs[2]
    label = f"{family}.{arm}"
    want_losses, params, small, lr_sum = jax_runs[family, world][RECIPE[arm]]
    for res in ranks:  # the step's loss is the mean over every rank, on every rank
        assert res["losses"][label] == ranks[0]["losses"][label]
    np.testing.assert_allclose(ranks[0]["losses"][label], want_losses, rtol=1e-5)
    assert_params_match(rank0, label, params, small, lr_sum)


@pytest.mark.parametrize("family", FAMILIES)
def test_each_rank_holds_its_megatron_shards(runs, family):
    """ddp and zero2 keep whole local leaves: column-parallel leaves split
    their output features, row-parallel ones their input features, wte /
    lm_head their vocabulary rows; norms, row-parallel biases and a kv
    projection the width does not split by kv heads stay whole."""
    D, V = 128, 512
    H, Hkv = {"tinygpt": (4, 4), "llama": (2, 1), "llama4": (4, 2)}[family]
    Dh = D // H
    F = 4 * D if family == "tinygpt" else 352
    want = {"wte": [V // TP, D], "blocks.0.wo": [D // TP, D], "blocks.0.ln1_scale": [D],
            "blocks.0.wproj": [F // TP, D]}
    if family == "tinygpt":
        want.update({"blocks.0.wqkv": [D, 3, D // TP], "blocks.0.bqkv": [3, D // TP],
                     "blocks.0.wfc": [D, F // TP], "blocks.0.bproj": [D], "wpe": [S, D]})
    else:
        kv = Hkv * Dh // TP if Hkv % TP == 0 else Hkv * Dh
        want.update({"blocks.0.wq": [D, H * Dh // TP], "blocks.0.wkv": [D, 2, kv],
                     "blocks.0.wgu": [D, 2, F // TP], "lm_head": [V // TP, D]})
    for world in (4, 2):
        for res in runs[0][world]:
            for arm in ("ddp", "zero2"):
                if arm in ARMS[world]:
                    shapes = res["shapes"][f"{family}.{arm}"]
                    assert {k: shapes[k] for k in want} == want, (world, arm)
            if world == 4:  # FSDP2 keeps rows ceil(d0 / dp) of each local leaf
                shapes = res["shapes"][f"{family}.fsdp"]
                assert shapes["wte"] == [V // TP // 2, D]


@pytest.mark.parametrize("world,family,arm", TRAINED)
def test_clip_norm_counts_each_element_once(runs, world, family, arm):
    """The clip's global norm on every rank equals the norm of the whole
    gradient (gathered over ``data`` and ``model``): the squares of the
    ``model``-sharded leaves summed over ``model``, the replicated ones
    counted once, as optax's norm over the whole tree. AdamW hardly sees a
    uniform scale of its gradient, so the trained params cannot show a wrong
    norm; this does."""
    for res in runs[0][world]:
        got, want = res["norms"][f"{family}.{arm}"]
        assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("family", FAMILIES)
def test_load_then_export_round_trips_the_jax_tree(runs, family):
    """``load_jax_params`` keeps each rank's shards; ``export_params``
    (every rank calls it) gathers them over ``model`` and FSDP2's ``data``
    back into JAX's leaves, bit for bit."""
    init, rank0 = runs[4][family], runs[1][4]
    for k, v in init.items():
        if k != "blocks":
            np.testing.assert_array_equal(rank0[f"{family}.roundtrip.{k}"], v)
    for k, v in init["blocks"].items():
        np.testing.assert_array_equal(rank0[f"{family}.roundtrip.blocks.{k}"], v)


def test_dropout_run_equals_the_one_process_run(runs):
    """At dropout 0.1 and per-device batch 2 the tp-2 run draws the
    one-process run's masks: the embedding and MLP masks drawn whole on both
    ``model`` ranks, the attention's keyed by global batch*head ids (at B 2 a
    single offset would key the second row's heads wrongly). Both compute in
    fp32 from the same seeded weights (each rank keeps its shards of the
    same global draw)."""
    np.testing.assert_allclose(runs[0][2][0]["dropout_losses"], runs[3], rtol=1e-5)
    assert runs[0][2][1]["dropout_losses"] == runs[0][2][0]["dropout_losses"]


def test_tp_row_validates_and_counts_chips(runs):
    row = runs[0][2][0]["row"]
    assert (row["world_size"], row["tensor_parallel"], row["tp_collective_matmul"]) == (2, TP,
                                                                                          False)
    tokens = 2 * ACCUM * S  # dp = world // tp = 1
    assert row["tokens_per_sec"] * row["mean_step_time_sec"] == pytest.approx(tokens)
    with torch.device("meta"):  # the global model's count, not a rank's shards
        assert row["n_params"] == count_params(TinyGPT(get_config("tinygpt", "S", S)))
    assert validate_result(row, f"tp{TP} ws2") == []


@pytest.mark.parametrize("world", [4, 2])
def test_a_world_that_model_does_not_divide_is_refused_with_jaxs_message(runs, world):
    for res in runs[0][world]:
        assert res["refusal"] == (f"world_size={world} not divisible by "
                                  "tensor*sequence*pipeline*expert parallel=3")


def test_offload_arm_over_model_2_matches_one_process(runs):
    """zero2 with the serial host-offload arm over (data 1, model 2): each
    rank's host holds the masters of its tp shards; per-step losses and the
    gathered masters against one process, under
    ``tests/test_torch_arms.py``'s offload limits (the tp ranks' bf16
    gradients of the replicated leaves are summed over ``model`` in bf16,
    where one process rounds the whole gradient once)."""
    want_losses, want = runs[5]
    ranks, rank0 = runs[0][2], runs[1][2]
    assert ranks[1]["offload_losses"] == ranks[0]["offload_losses"]
    np.testing.assert_allclose(ranks[0]["offload_losses"], want_losses, rtol=OFFLOAD_LOSS_RTOL)
    recipe = jstrat.get_strategy("zero2")
    lr_sum = sum(recipe.learning_rate * min(1.0, s / recipe.warmup_steps) for s in range(STEPS))
    for key, leaf in [(k, v) for k, v in want.items() if k != "blocks"] + [
            (f"blocks.{k}", v) for k, v in want["blocks"].items()]:
        diff = np.abs(rank0[f"offload.{key}"] - leaf)
        assert (diff <= lr_sum + 1e-7).all(), key
        assert (diff <= OFFLOAD_LR_SHARE * lr_sum + 1e-7).mean() >= OFFLOAD_IN_SHARE, key
