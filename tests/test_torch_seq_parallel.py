"""Sequence parallelism across processes: the trainer over gloo ranks laid
out (data 2, seq 2), with a (data 1, seq 2) case beside it, against JAX's
train step on a mesh of the same widths, and against the port's own
one-process form.

A module fixture starts the ranks once (``tests/torch_seq_parallel_worker.py``,
``train`` mode): for each family, attention (ring, Ulysses) and arm, tier S
at S 128 (learned positions and RoPE at offsets that differ across the two
``seq`` shards), fp32 compute, dropout 0, per-device batch 1 x accum 2, from
the JAX init, 3 steps; over (data 1, seq 2) zero2 only. The JAX side is
``tinygpt.loss_fn`` under a (data, seq) mesh of the conftest's virtual CPU
devices, where its ring or Ulysses attention finds the mesh as in a run,
plus ``strategies.make_optimizer`` of the arm's recipe, composed as JAX's
train step composes them (as ``tests/test_torch_arms.py`` does; one case is
also held against ``train.step.create_train_state``'s ``step_fn``, the step
JAX's ``run_benchmark`` runs). ddp and fsdp share bare AdamW, zero2 and
zero3 the warmup and the clip, so the JAX side runs one arm of each recipe.

Tolerances are ``tests/test_torch_arms.py``'s: loss 1e-5 relative, params
1e-5 relative plus 2e-6 absolute on every element whose gradient has stayed
above Adam's eps (1e-8), and the others held to what Adam can move them (lr
per step taken): Adam moves an element by lr * m / (sqrt(v) + eps), so below
eps the update follows the gradient's rounding. The port averages the
ranks' mean losses and gradients over dp * n ranks; JAX takes the global
mean over the batch. They agree because the targets are the inputs, so
every rank counts the same targets.
"""

import dataclasses
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
from distributed_llm_training_benchmark_framework_tpu.models import llama as jllama
from distributed_llm_training_benchmark_framework_tpu.models import tinygpt as jtiny
from distributed_llm_training_benchmark_framework_tpu.parallel import make_mesh as jmake_mesh
from distributed_llm_training_benchmark_framework_tpu.parallel import strategies as jstrat
from distributed_llm_training_benchmark_framework_tpu.train.step import (
    _resolve_model_config,
    create_train_state,
)
from distributed_llm_training_benchmark_framework_tpu.utils import memory as jmemory
from distributed_llm_training_benchmark_framework_tpu.utils import metrics as jmetrics
from distributed_llm_training_benchmark_framework_tpu_torch.models import get_config
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import make_mesh
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import strategies as tstrat
from distributed_llm_training_benchmark_framework_tpu_torch.parallel.mesh import Mesh
from distributed_llm_training_benchmark_framework_tpu_torch.train import run_benchmark
from distributed_llm_training_benchmark_framework_tpu_torch.utils import memory as tmemory
from distributed_llm_training_benchmark_framework_tpu_torch.utils import metrics as tmetrics

from torch_seq_parallel_worker import (
    ACCUM,
    ARMS,
    F32_ZERO2,
    FAMILIES,
    IMPLS,
    MICRO,
    S,
    SP,
    STEPS,
    spawn_ranks,
    wait_ranks,
)

JAX_CONFIG = {"tinygpt": jtiny.get_model_config, "llama": jllama.get_llama_config}
RECIPE = {"ddp": "ddp", "fsdp": "ddp", "zero2": "zero2", "zero3": "zero2"}
DP = {4: 2, 2: 1}  # world -> data width, seq width SP
ADAM_EPS = 1e-8
TRAINED = [(w, f, i, a) for w in (4, 2) for f in FAMILIES for i in IMPLS for a in ARMS[w]]


def _jax_params(family):
    jc = JAX_CONFIG[family]("S", S, dropout=0.0, attention_impl="flash")
    return jax.tree.map(np.asarray, jtiny.init_params(jc, jax.random.key(0)))


def _mesh(dp):
    return jmake_mesh((dp, SP), ("data", "seq"), devices=jax.devices()[:dp * SP])


def _jax_recipes(family, impl, dp, recipes, table, init):
    """{recipe: (per-step losses, final params, the elements whose gradient
    has been under Adam's eps, the sum of the learning rates)} of the JAX
    recipe on a (dp, SP) mesh at global micro-batch dp * MICRO, from the
    params ``init``."""
    jc = JAX_CONFIG[family]("S", S, dropout=0.0, compute_dtype=jnp.float32,
                            attention_impl=impl)
    mesh = _mesh(dp)
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
            batch = jnp.asarray(table[rows].reshape(ACCUM, MICRO * dp, S))
            loss_sum, grads = 0.0, jax.tree.map(lambda p: np.zeros(p.shape, p.dtype), params)
            for j in range(ACCUM):
                with jax.set_mesh(mesh):
                    loss, g = grad_fn(params, batch[j])
                loss_sum += float(loss)
                # On the host: eager ops on the mesh's shardings would each compile.
                grads = jax.tree.map(lambda a, b: a + np.asarray(b), grads, g)
            grads = jax.tree.map(lambda g: g / ACCUM, grads)
            small = jax.tree.map(lambda m, g: m | (np.abs(np.asarray(g)) < ADAM_EPS), small,
                                 grads)
            params, state = update(grads, state, params)
            warmup = arm.warmup_steps
            lr_sum += arm.learning_rate * (min(1.0, step / warmup) if warmup else 1.0)
            losses.append(loss_sum / ACCUM)
        out[recipe] = (losses, jax.tree.map(np.asarray, params), small, lr_sum)
    return out


def _jax_run_benchmark_step(family, impl, recipe, dp, table):
    """Per-step losses of ``create_train_state``'s ``step_fn`` (JAX's
    ``run_benchmark`` step) on a (dp, SP) mesh, from the init of key 0."""
    jc = JAX_CONFIG[family]("S", S, dropout=0.0, attention_impl=impl)
    strategy = dataclasses.replace(jstrat.get_strategy(recipe), precision="f32")
    st = create_train_state(jc, strategy, _mesh(dp), seed=0, grad_accum=ACCUM,
                            deterministic_dropout=True, from_table=True,
                            global_micro=MICRO * dp, seq_len=S)
    params, opt_state, losses = st.params, st.opt_state, []
    for step in range(STEPS):
        params, opt_state, loss = st.step_fn(params, opt_state, jnp.asarray(table), step)
        losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({world: every rank's json}, {world: rank 0's arrays}, {(family, impl,
    world): the JAX recipes}, {(impl, world): the one-process run's per-step
    losses at dropout 0.1}, the losses of JAX's run_benchmark step)."""
    tmp = tmp_path_factory.mktemp("seqpar")
    table = JaxSyntheticDataset(512, S, size=10, seed=42).data
    arrays = {"table": table}
    init = {family: _jax_params(family) for family in FAMILIES}
    for family, p in init.items():
        arrays.update({f"{family}.{k}": v for k, v in p.items() if k != "blocks"})
        arrays.update({f"{family}.blocks.{k}": v for k, v in p["blocks"].items()})
    np.savez(tmp / "inputs.npz", **arrays)
    procs = {w: spawn_ranks(w, tmp / "inputs.npz", tmp / f"w{w}", "train") for w in DP}
    # Meanwhile, the JAX runs and the port's one-process runs at dropout 0.1.
    jax_runs = {(f, i, w): _jax_recipes(f, i, DP[w], sorted({RECIPE[a] for a in ARMS[w]}),
                                        table, init[f])
                for w in DP for f in FAMILIES for i in IMPLS}
    step_losses = _jax_run_benchmark_step("tinygpt", "ring", "zero2", 2, table)
    one_process = {}
    for impl, w in (("ring", 4), ("ring", 2), ("ulysses", 2)):
        losses = []
        run_benchmark(strategy=F32_ZERO2, tier="S", seq_len=S, steps=STEPS, warmup_steps=1,
                      per_device_batch=MICRO * DP[w], grad_accum=ACCUM, attention_impl=impl,
                      sequence_parallel=SP, dropout=0.1, device="cpu", loss_log=losses)
        one_process[impl, w] = losses
    ranks, rank0 = {}, {}
    for w, ps in procs.items():
        wait_ranks(ps)
        ranks[w] = [json.loads((tmp / f"w{w}.rank{r}.json").read_text()) for r in range(w)]
        rank0[w] = np.load(tmp / f"w{w}.rank0.npz")
    return ranks, rank0, jax_runs, one_process, step_losses


@pytest.mark.parametrize("world", [4, 2])
def test_mesh_lays_ranks_out_data_major(runs, world):
    """Rank r sits at data r // n, seq r % n; the group has dp * n ranks."""
    for r, res in enumerate(runs[0][world]):
        assert res["mesh"] == [DP[world], r // SP, r % SP, world]


@pytest.mark.parametrize("world,family,impl,arm", TRAINED)
def test_losses_and_params_match_jax(runs, world, family, impl, arm):
    ranks, rank0, jax_runs = runs[0][world], runs[1][world], runs[2]
    label = f"{family}.{impl}.{arm}"
    want_losses, params, small, lr_sum = jax_runs[family, impl, world][RECIPE[arm]]
    for res in ranks:  # the step's loss is the mean over every rank, on every rank
        assert res["losses"][label] == ranks[0]["losses"][label]
    np.testing.assert_allclose(ranks[0]["losses"][label], want_losses, rtol=1e-5)
    leaves = [(k, params[k], small[k]) for k in params if k != "blocks"]
    leaves += [(f"blocks.{k}", v, small["blocks"][k]) for k, v in params["blocks"].items()]
    for key, leaf, tiny in leaves:
        got = rank0[f"{label}.{key}"]
        np.testing.assert_allclose(got[~tiny], leaf[~tiny], rtol=1e-5, atol=2e-6, err_msg=key)
        assert (np.abs(got[tiny] - leaf[tiny]) <= lr_sum).all(), key


def test_jax_recipe_is_run_benchmarks_step(runs):
    """The composed JAX recipe takes the losses of the step JAX's
    ``run_benchmark`` runs (``create_train_state``), on (data 2, seq 2)."""
    np.testing.assert_allclose(runs[2]["tinygpt", "ring", 4]["zero2"][0], runs[4], rtol=1e-6)


@pytest.mark.parametrize("world,family,impl,arm", TRAINED)
def test_local_state_has_the_arms_size(runs, world, family, impl, arm):
    """Replicated over ``seq``, sharded over ``data`` only: ddp whole;
    fsdp / zero3 the rows of dim 0 of each leaf that its ``data`` index d
    holds over dp (FSDP2's chunks of ceil(d0 / dp)), not over dp * n;
    zero2 whole params and the moments of its shard of the flat buffer
    padded to dp. The bytes each rank at ``data`` index 0 holds equal
    ``estimate_hbm``'s (rank 0's layout)."""
    dp, label = DP[world], f"{family}.{impl}.{arm}"
    for r, res in enumerate(runs[0][world]):
        d = r // SP
        size = res["sizes"][label]
        n = size["param_global"]
        sharded = sum(min(-(-s[0] // dp), max(0, s[0] - d * -(-s[0] // dp)))
                      * int(np.prod(s[1:])) for s in size["leaf_shapes"])
        want = {"ddp": (n, n), "fsdp": (sharded, sharded), "zero3": (sharded, sharded),
                "zero2": (n, -(-n // dp))}[arm]
        assert (size["param_local"], size["moments"]) == want
        if d == 0:
            assert res["bytes"][label]["held"] == res["bytes"][label]["estimate"]


@pytest.mark.parametrize("world,impl", [(4, "ring"), (2, "ring"), (2, "ulysses")])
def test_dropout_run_equals_the_one_process_run(runs, world, impl):
    """At dropout 0.1 the group run draws the one-process run's masks: the
    embedding and MLP masks for the whole global micro-batch at full length,
    sliced; the ring's attention mask keyed by global coordinates; Ulysses'
    by the same folded seeds where ``data`` has width 1. The one-process run
    trains the same global batch (per-device batch dp x 1) with all n shards
    on one device. Both compute in fp32: in bf16 each rank's weight
    gradients round to bf16 over its own tokens, which moves the third
    step's loss by ~1e-5."""
    np.testing.assert_allclose(runs[0][world][0]["dropout_losses"][impl],
                               runs[3][impl, world], rtol=1e-5)


@pytest.mark.parametrize("world", [4, 2])
@pytest.mark.parametrize("impl", IMPLS)
def test_group_row_validates_and_counts_chips(runs, world, impl):
    row = runs[0][world][0]["rows"][impl]
    assert (row["world_size"], row["sequence_parallel"], row["attention_impl"],
            row["ring_zigzag"]) == (world, SP, impl, "auto")
    assert all(np.isfinite(runs[0][world][0]["dropout_losses"][impl]))
    tokens = MICRO * ACCUM * S * DP[world]
    assert row["tokens_per_sec"] * row["mean_step_time_sec"] == pytest.approx(tokens)
    assert validate_result(row, f"{impl} ws{world} sp{SP}") == []


def test_accounting_is_jaxs():
    """dp = world // n over the group, 1 in one process; tokens/s/chip is
    tokens/s over world; JAX's tokens_per_step at that dp."""
    for world, sp, dp in ((4, 2, 2), (2, 2, 1), (1, 4, 1), (3, 1, 3)):
        r = tmetrics.compute_result(
            strategy="zero2", world_size=world, seq_len=S, tier="S", steps=2,
            per_device_batch=2, grad_accum=3, step_times=[0.5], losses=[1.0], peak_gb=0.0,
            peak_method="unavailable", sequence_parallel=sp)
        assert r.tokens_per_sec * 0.5 == jmetrics.tokens_per_step(2, 3, S, dp)
        if world > 1:
            assert world // sp == dp  # JAX's dp = world // (tp * sp * pp * ep)


@pytest.mark.parametrize("arm", sorted(jstrat.STRATEGIES))
@pytest.mark.parametrize("family", FAMILIES)
def test_activation_and_logits_terms_are_jaxs_on_data_and_seq(family, arm):
    """JAX's estimate on a (data 2, seq 2) mesh keeps the global seq_len in
    its activation term (no division by seq); the port's is the same."""
    jstrategy = jstrat.get_strategy(arm)
    jmesh = jmake_mesh((2, 2), ("data", "seq"), devices=jax.devices()[:4])
    jcfg = _resolve_model_config(JAX_CONFIG[family]("A", 2048, attention_impl="ring"),
                                 jstrategy, jmesh)
    want = jmemory.estimate_hbm(jcfg, jstrategy, jmesh, 1, 2048)
    strategy = tstrat.get_strategy(arm)
    got = tmemory.estimate_hbm(get_config(family, "A", 2048, attention_impl="ring",
                                          remat=strategy.remat),
                               strategy, Mesh({"data": 2, "seq": 2}), 1, 2048)
    assert (got.activations, got.logits) == (want.activations, want.logits)


@pytest.mark.parametrize("kw,match", [
    (dict(sequence_parallel=2, attention_impl="flash"), "requires attention_impl 'ring' or "
     "'ulysses'"),
    (dict(sequence_parallel=2, attention_impl="reference"), "requires attention_impl 'ring'"),
    (dict(sequence_parallel=3, attention_impl="ulysses", seq_len=66),
     r"Ulysses needs heads % seq_parallel == 0, got H=4, n=3"),
])
def test_run_benchmark_refuses_what_jax_refuses(kw, match):
    kw = {"seq_len": 64, **kw}
    with pytest.raises(ValueError, match=match):
        run_benchmark(tier="S", steps=2, warmup_steps=1, device="cpu", **kw)


@pytest.mark.parametrize("world", [4, 2])
def test_a_world_that_seq_does_not_divide_is_refused_with_jaxs_message(runs, world):
    for res in runs[0][world]:
        assert res["refusal"] == (f"world_size={world} not divisible by "
                                  "tensor*sequence*pipeline*expert parallel=3")


def test_in_process_mesh_has_one_data_rank():
    mesh = make_mesh((4,), ("seq",))
    assert (mesh.size("data"), mesh.size("seq"), mesh.world, mesh.seq_in_process,
            mesh.seq_group, mesh.seq_rank) == (1, 4, 1, True, None, 0)
