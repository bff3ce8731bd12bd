"""The four strategy arms (ddp, fsdp, zero2, zero3) over gloo on the CPU,
against the JAX recipe of each arm at the same global batch.

A module fixture starts the ranks once (``tests/test_torch_arms_worker.py``, two
ranks and, for the padding of uneven shards, three: tier S's vocabulary of
512 does not split in three): every arm trains tier S TinyGPT at S 64, fp32
compute, flash attention (its plain versions on the CPU), dropout 0,
per-device batch 1 x grad-accum 2, from the JAX init, for 3 steps; zero3
also with remat "dots" and "full". The JAX side is ``tinygpt.loss_fn`` +
``strategies.make_optimizer(get_strategy(arm))`` composed as in
``tests/test_torch_train_step.py``, at global micro-batch ``world``, with
the data-parallel reduction: each rank's rows give a loss and a gradient,
and both are averaged over the ranks, as a JAX ``data`` mesh sums its
devices' partial gradients. Tolerances are that test's: loss 1e-5
relative, params 1e-5 relative plus 2e-6 absolute, on every element whose
gradient has stayed above Adam's eps (1e-8). Adam moves an element by
lr * m / (sqrt(v) + eps), so below eps the update follows the gradient's
rounding: at three ranks wte[215, 55] has |g| = 1.3e-9, under the fp32
rounding of the sums that make it, and under bare AdamW (lr 1e-4 from the
first step) it lands 1.7e-5 from JAX's. Such elements (the k bias, whose
gradient is zero, and a handful of others) are held to what Adam can move
them: lr per step taken.

At two ranks the workers also train ddp, zero2 and zero3 under the serial
host-offload arm (bf16 parameters from the JAX init), held to one process's
offload run at the same global batch, and run zero2 with offload through
``run_benchmark``, whose row must pass JAX's validator.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from distributed_llm_training_benchmark_framework_tpu.analysis.validate_results import (
    validate_result,
)
from distributed_llm_training_benchmark_framework_tpu.data.synthetic import (
    SyntheticDataset as JaxSyntheticDataset,
)
from distributed_llm_training_benchmark_framework_tpu.models import tinygpt as jtiny
from distributed_llm_training_benchmark_framework_tpu.parallel import strategies as jstrat
import torch

from distributed_llm_training_benchmark_framework_tpu_torch import bench as tbench
from distributed_llm_training_benchmark_framework_tpu_torch import bridge
from distributed_llm_training_benchmark_framework_tpu_torch.models import TinyGPT
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import make_mesh
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import strategies as tstrat
from distributed_llm_training_benchmark_framework_tpu_torch.train.step import TrainStep

from test_torch_arms_worker import (
    OFFLOAD_ARMS,
    OFFLOAD_IN_SHARE,
    OFFLOAD_LOSS_RTOL,
    OFFLOAD_LR_SHARE,
    _strategy,
    master_tree,
    offload_config,
    spawn_ranks,
    wait_ranks,
)
from torch_fsdp_rule import fsdp_local_numel
from torch_threads import one_thread  # noqa: F401  (autouse)

S, MICRO, ACCUM, STEPS = 64, 1, 2, 3
WORLDS = (2, 3)
ADAM_EPS = 1e-8
LABELS = {"ddp": "ddp", "fsdp": "fsdp", "zero2": "zero2", "zero3": "zero3",
          "zero3_dots": "zero3", "zero3_full": "zero3"}
# The optimizer recipe of each arm: bare AdamW, or warmup + clip.
RECIPE = {"ddp": "ddp", "fsdp": "ddp", "zero2": "zero2", "zero3": "zero2"}
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "attention_impl", "dropout",
              "model_tflops_per_sec_per_chip", "mfu_pct", "peak_hbm_gb", "peak_hbm_method",
              "device_kind", "mean_step_time_sec", "loss_first_window", "loss_last_window",
              "wall_time_total_sec", "time_in_compile_sec", "time_in_timed_sec",
              "n_anomalies", "tokens_per_dollar",
              # The memory anatomy, on every row (JAX's bench.py:186-199).
              "hbm_estimate_gib", "hbm_measured", "hbm_measured_reason", "hbm_attribution",
              "hbm_attribution_source", "hbm_reference_gib", "hbm_model_drift_frac"}


def _jax_setup():
    jc = jtiny.get_model_config("S", S, dropout=0.0, compute_dtype=jnp.float32,
                                attention_impl="flash")
    params = jtiny.init_params(jc, jax.random.key(0))
    table = JaxSyntheticDataset(jc.vocab_size, S, size=10, seed=42).data
    return jc, params, table


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({world: (rank 0's json, rank 0's arrays, every rank's losses)},
    {(recipe, world): the JAX recipe's steps})."""
    tmp = tmp_path_factory.mktemp("arms")
    _, params, table = _jax_setup()
    p = jax.tree.map(np.asarray, params)
    flat = {k: v for k, v in p.items() if k != "blocks"}
    flat.update({f"blocks.{k}": v for k, v in p["blocks"].items()})
    inputs = tmp / "inputs.npz"
    np.savez(inputs, table=table, **flat)
    procs = {w: spawn_ranks(w, inputs, tmp / f"w{w}", "parity") for w in WORLDS}
    # The JAX side meanwhile: ddp and fsdp share bare AdamW, zero2 and
    # zero3 the warmup and the clip; and the one-process offload runs.
    recipes = {(arm, w): _jax_recipe(arm, w) for arm in ("ddp", "zero2") for w in WORLDS}
    recipes.update({(arm, "offload"): _one_process_offload(arm, p, table)
                    for arm in OFFLOAD_ARMS})
    out = {}
    for w, ps in procs.items():
        wait_ranks(ps)
        ranks = [json.loads((tmp / f"w{w}.rank{r}.json").read_text()) for r in range(w)]
        out[w] = (ranks[0], np.load(tmp / f"w{w}.rank0.npz"), [r["losses"] for r in ranks])
    return out, recipes


def _jax_recipe(arm, world):
    """Per step: (loss, params as numpy, the elements whose gradient has
    been under Adam's eps, the sum of the learning rates so far) of the JAX
    recipe at global micro ``world``, each micro-batch's loss and gradient
    the mean of the ranks'."""
    jc, params, table = _jax_setup()
    recipe = jstrat.get_strategy(arm)
    tx = jstrat.make_optimizer(recipe)
    state = tx.init(params)
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: jtiny.loss_fn(jc, p, b, b)))
    small = jax.tree.map(lambda p: np.zeros(p.shape, bool), params)
    lr_sum, out = 0.0, []
    for step in range(STEPS):
        G = ACCUM * MICRO * world
        rows = (step * G + np.arange(G)) % table.shape[0]
        batch = jnp.asarray(table[rows].reshape(ACCUM, MICRO * world, S))
        loss_sum, grads = 0.0, jax.tree.map(jnp.zeros_like, params)
        for j in range(ACCUM):
            parts = [grad_fn(params, batch[j, r * MICRO:(r + 1) * MICRO]) for r in range(world)]
            loss_sum += sum(loss for loss, _ in parts) / world
            g = jax.tree.map(lambda *gs: sum(gs) / world, *(g for _, g in parts))
            grads = jax.tree.map(jnp.add, grads, g)
        grads = jax.tree.map(lambda g: g / ACCUM, grads)
        small = jax.tree.map(lambda m, g: m | (np.abs(np.asarray(g)) < ADAM_EPS), small, grads)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        warmup = recipe.warmup_steps
        lr_sum += recipe.learning_rate * (min(1.0, step / warmup) if warmup else 1.0)
        out.append((float(loss_sum / ACCUM), jax.tree.map(np.asarray, params), small, lr_sum))
    return out


def _one_process_offload(arm, params, table):
    """The serial offload arm in one process at the group's global batch
    (micro-batches of 2 rows): every step's loss and the final masters."""
    mesh = make_mesh()
    model = TinyGPT(offload_config(), mesh=mesh)
    bridge.load_jax_params(model, params)
    model, opt = tstrat.apply_strategy(model, _strategy(arm, "none", offload_opt_state=True),
                                       mesh)
    step_fn = TrainStep(model, opt, grad_accum=ACCUM, micro_batch=MICRO * 2, seed=0,
                        device=torch.device("cpu"), mesh=mesh)
    t_table = torch.from_numpy(table.astype(np.int64))
    losses = [step_fn(t_table, step).item() for step in range(STEPS)]
    return losses, master_tree(model, opt, mesh)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("label", sorted(LABELS))
def test_arm_matches_its_jax_recipe(runs, label, world):
    res, arrays, rank_losses = runs[0][world]
    want = runs[1][RECIPE[LABELS[label]], world]
    fields = ("learning_rate", "betas", "eps", "weight_decay", "warmup_steps", "grad_clip")
    arm, shared = jstrat.get_strategy(LABELS[label]), jstrat.get_strategy(RECIPE[LABELS[label]])
    assert [getattr(arm, f) for f in fields] == [getattr(shared, f) for f in fields]
    for losses in rank_losses:  # the step's loss is the mean over ranks on every rank
        assert losses[label] == rank_losses[0][label]
    for step, (loss, params, small, lr_sum) in enumerate(want):
        np.testing.assert_allclose(res["losses"][label][step], loss, rtol=1e-5,
                                   err_msg=f"loss, step {step}")
        for key, leaf, tiny in [(k, params[k], small[k]) for k in params if k != "blocks"] + [
                (f"blocks.{k}", v, small["blocks"][k]) for k, v in params["blocks"].items()]:
            got = arrays[f"{label}.{step}.{key}"]
            msg = f"{key}, step {step}"
            np.testing.assert_allclose(got[~tiny], leaf[~tiny], rtol=1e-5, atol=2e-6, err_msg=msg)
            assert (np.abs(got[tiny] - leaf[tiny]) <= lr_sum).all(), msg


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("label", sorted(LABELS))
def test_local_state_has_the_arms_size(runs, label, world):
    """Rank 0's params and AdamW moments: ddp whole; fsdp / zero3 rank 0's
    chunk of each leaf on the axis JAX's rule puts ``data`` on (the whole
    leaf where it finds none); zero2 whole params and the moments of its
    shards of the padded flat buffers, one per block and one for the leaves
    outside the blocks."""
    size = runs[0][world][0]["sizes"][label]
    n = size["param_global"]
    sharded = sum(fsdp_local_numel(name, s, 2, {"data": world}, 0)
                  for name, s in zip(size["leaf_names"], size["leaf_shapes"]))
    buckets = {}
    for name, shape in zip(size["leaf_names"], size["leaf_shapes"]):
        buckets[tstrat.zero2_bucket(name)] = buckets.get(tstrat.zero2_bucket(name), 0) + int(
            np.prod(shape))
    assert sorted(buckets) == ["", "blocks.0", "blocks.1"] and sum(buckets.values()) == n
    flat_shard = sum(-(-b // world) for b in buckets.values())
    arm = LABELS[label]
    want = {"ddp": (n, n), "fsdp": (sharded, sharded), "zero3": (sharded, sharded),
            "zero2": (n, flat_shard)}[arm]
    assert (size["param_local"], size["moments"]) == want
    if arm == "zero2" or (arm in ("fsdp", "zero3") and world == 2):
        # About 1/world of the model; at width 3 JAX's rule finds no axis of
        # most tier-S leaves that 3 divides, and fsdp / zero3 keep them whole.
        assert size["moments"] <= n / world + n * 0.02
    if arm == "zero2" and world == 3:
        assert flat_shard * world > n  # the flat buffers are padded


def test_zero2_reduce_scatters_each_bucket_once_inside_the_last_backward(runs):
    """Tier S has blocks 0 and 1 and the leaves outside them (""): each
    bucket's reduce-scatter starts in the last micro-batch's backward, as
    soon as its block's gradients have landed, before the backward of the
    block below starts; the outer leaves' (the tied embedding's gradient
    lands last) ends it. The first micro-batch launches none."""
    events = [tuple(e) for e in runs[0][2][0]["zero2_events"]]
    assert events == [("bwd", 1), ("bwd", 0),
                      ("bwd", 1), ("rs", "blocks.1", True), ("bwd", 0), ("rs", "blocks.0", True),
                      ("rs", "", True)]


def test_zero2_buckets_equal_the_single_buffer_form_at_two_ranks(runs):
    """At two ranks each element's reduce-scatter adds the same two
    addends whatever the buckets: per-step losses and params equal the
    single flat buffer's bit for bit."""
    res, arrays, rank_losses = runs[0][2]
    assert res["losses"]["zero2"] == res["losses"]["zero2_single"]
    keys = [k.split(".", 2)[2] for k in arrays.files if k.startswith("zero2.0.")]
    assert "blocks.moe_w1" not in keys and len(keys) > 10
    for step in range(STEPS):
        for key in keys:
            np.testing.assert_array_equal(arrays[f"zero2.{step}.{key}"],
                                          arrays[f"zero2_single.{step}.{key}"], err_msg=key)


@pytest.mark.parametrize("arm", ["ddp", "fsdp", "zero2", "zero3"])
def test_world_row_of_the_arm_validates(runs, arm):
    row = runs[0][2][0]["rows"][arm]
    assert (row["strategy"], row["world_size"], row["per_device_batch"]) == (arm, 2, MICRO)
    assert validate_result(row, f"{arm} ws2") == []


@pytest.mark.parametrize("arm", ["ddp", "fsdp", "zero2", "zero3"])
def test_bench_line_and_its_row_validate(arm, capsys):
    """The bench CLI's line for each arm (no process group): exactly one JSON
    line with today's keys, made from a result row that the validator
    passes (the line itself carries the contract keys, not the row
    schema)."""
    (result,) = tbench.main(["--device", "cpu", "--tier", "S", "--seq-len", "64", "--steps",
                             "3", "--warmup-steps", "1", "--strategy", arm, "--flagship",
                             "off", "--skip-preflight"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == BENCH_KEYS
    row = result.to_dict()
    assert (row["strategy"], row["world_size"]) == (arm, 1)
    assert line["value"] == round(row["tokens_per_sec"] / row["world_size"], 2)
    assert line["loss_last_window"] == round(row["loss_last_window"], 4)
    assert validate_result(row, f"bench {arm}") == []


def test_bench_default_line_keeps_todays_keys(capsys):
    """No strategy or geometry flag and no group: the line and its
    flagship object carry exactly the keys they carried before the flags,
    with the memory anatomy's beside them (every row carries it)."""
    results = tbench.main(["--device", "cpu", "--tier", "S", "--seq-len", "64", "--steps",
                           "2", "--warmup-steps", "1", "--skip-preflight"])
    (line,) = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert set(line) == BENCH_KEYS | {"flagship"}
    assert set(line["flagship"]) == BENCH_KEYS | {
        "model_family", "strategy", "tier", "seq_len", "per_device_batch", "grad_accum",
        "layer_loop"}
    assert [(r.strategy, r.world_size, r.model_family) for r in results] == [
        ("zero2", 1, "tinygpt"), ("zero2", 1, "llama")]


def test_bench_refuses_a_world_size_that_is_not_the_groups():
    with pytest.raises(ValueError, match="world_size=2 but the process group has 1"):
        tbench.main(["--device", "cpu", "--tier", "S", "--seq-len", "64", "--steps", "2",
                     "--warmup-steps", "1", "--world-size", "2", "--flagship", "off",
                     "--skip-preflight"])
    args = tbench.build_parser().parse_args([])
    assert (args.strategy, args.per_device_batch, args.grad_accum, args.world_size,
            args.model_family, args.flagship, args.attention, args.dropout,
            args.sync_every) == ("zero2", 1, 4, None, "tinygpt", "auto", "flash", None, 10)


@pytest.mark.parametrize("arm", OFFLOAD_ARMS)
def test_offload_arm_over_two_ranks_matches_one_process(runs, arm):
    """The serial offload arm over two gloo ranks against one process at the
    same global batch: per-step losses within ``OFFLOAD_LOSS_RTOL`` (the tp
    phase's limit), the same on both ranks; the gathered fp32 masters after
    3 steps within what Adam can move an element, lr per step taken, and
    ``OFFLOAD_IN_SHARE`` of every leaf's elements within ``OFFLOAD_LR_SHARE``
    of that. The two runs' bf16 gradients are different roundings: each rank
    rounds its own rows' gradient to bf16 and the reduction sums and divides
    in bf16, where one process rounds the two rows' sum once. Adam's step
    hardly sees a few bf16 steps of its gradient (2^-5 of lr covers them)
    but follows the sign of an element whose rows nearly cancel, which the
    rounding decides."""
    res, arrays, rank_losses = runs[0][2]
    want_losses, want = runs[1][arm, "offload"]
    label = f"{arm}_offload"
    for losses in rank_losses:
        assert losses[label] == rank_losses[0][label]
    np.testing.assert_allclose(res["losses"][label], want_losses, rtol=OFFLOAD_LOSS_RTOL)
    recipe = jstrat.get_strategy(arm)
    lr_sum = sum(recipe.learning_rate * (min(1.0, s / recipe.warmup_steps)
                                         if recipe.warmup_steps else 1.0) for s in range(STEPS))
    for key, leaf in [(k, v) for k, v in want.items() if k != "blocks"] + [
            (f"blocks.{k}", v) for k, v in want["blocks"].items()]:
        diff = np.abs(arrays[f"{label}.{key}"] - leaf)
        assert (diff <= lr_sum + 1e-7).all(), key
        assert (diff <= OFFLOAD_LR_SHARE * lr_sum + 1e-7).mean() >= OFFLOAD_IN_SHARE, key


def test_offload_row_at_world_2_validates(runs):
    """zero2 with host offload over two ranks through ``run_benchmark``: the
    row carries JAX's offload keys and passes JAX's validator; with
    ``sync_every`` 1 its step-time CV is held to the offload allowance."""
    row = runs[0][2][0]["rows"]["zero2_offload"]
    assert (row["strategy"], row["world_size"], row["param_dtype"], row["offload_opt_state"],
            row["offload_delayed_update"], row["offload_dpu_start_step"]) == (
        "zero2", 2, "f32", True, False, 0)
    assert validate_result(row, "zero2 offload ws2") == []
    timed = dict(row, sync_every=1, step_time_cv_pct=20.0)
    assert validate_result(timed, "offload, cv 20%") == []
    assert validate_result(dict(timed, offload_opt_state=False), "device, cv 20%")
