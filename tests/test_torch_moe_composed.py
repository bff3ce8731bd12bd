"""The MoE model beside every other axis over gloo ranks on the CPU, against
JAX's train step on a mesh of the same widths (``models/moe.py``'s global
routing, the experts' F/tp columns, ``parallel/strategies.py``'s
reductions under ``seq``, ``model``, ``pipe`` and ``expert``).

A module fixture starts every geometry's ranks once
(``tests/torch_moe_composed_worker.py``): (data, seq, model, pipe, expert)
= (1, 2, 1, 1, 1) with the ring, (1, 1, 2, 1, 1), (1, 1, 1, 1, 2) and (2, 1,
1, 1, 2) under ``moe_dispatch="einsum"``, (1, 1, 2, 1, 2), and (1, 1, 1, 2,
2) and (1, 2, 1, 2, 1) (the ring) under gpipe; ddp and zero2 everywhere,
fsdp and zero3 at (2, 1, 1, 1, 2); tier S with 4 experts, fp32 compute, dropout 0, per-device batch 1 x
accum 2, 3 steps from the JAX init with the routers scaled by
``ROUTER_SCALE`` (``tests/test_torch_moe_parallel.py`` says why), and step
0's gradient at the init itself. None of
these is JAX's all-to-all form: JAX's selector sends each to
``_moe_mlp_einsum`` under GSPMD, which routes the global micro-batch (a
pipeline stage's under ``pipe``, each ``seq`` shard its own window, as
``seq`` is manual in JAX's pipeline region). The JAX side is ``tinygpt.loss_fn``
(``pipeline.pipeline_loss_fn`` under ``pipe``) on a mesh of the conftest's
virtual CPU devices, plus ``strategies.make_optimizer`` of the arm's recipe
composed as JAX's train step composes them.

Tolerances are ``tests/test_torch_moe_parallel.py``'s: losses 1e-5
relative and equal on every rank; params 1e-5 relative plus 2e-6 absolute
on every element whose gradient has stayed above 10 Adam eps, up to
``TIE_SHARE`` of a leaf's elements outside that band but within lr per
step taken; step 0's gradient after the arm (ddp) within 1e-5 of each
leaf's largest magnitude; the clip's norm within 1e-5 relative of the norm
of JAX's whole gradient; the loop's overflow diagnostic within 1e-6
relative of JAX's on the same mesh. Without ranks: the routing of each geometry's
ranks (the slots, keeps and drop fraction of every rank's tokens, their
table of counts summed as the all-reduce sums it) equals JAX's ``_route``
on the global array, exactly. Launched through ``runtime.launch`` on two
gloo ranks, the harness trains the MoE model beside ``model`` and beside
``seq`` and writes rows the port's validator passes.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding

import chip_smoke
from distributed_llm_training_benchmark_framework_tpu.data.synthetic import (
    SyntheticDataset as JaxSyntheticDataset,
)
from distributed_llm_training_benchmark_framework_tpu.models import moe as jmoe
from distributed_llm_training_benchmark_framework_tpu.models import tinygpt as jtiny
from distributed_llm_training_benchmark_framework_tpu.parallel import make_mesh as jmake_mesh
from distributed_llm_training_benchmark_framework_tpu.parallel import pipeline as jpipe
from distributed_llm_training_benchmark_framework_tpu.parallel import strategies as jstrat
from distributed_llm_training_benchmark_framework_tpu_torch.analysis.validate_results import (
    validate_result,
)
from distributed_llm_training_benchmark_framework_tpu_torch.models import moe as tmoe

from torch_moe_composed_worker import (
    ACCUM,
    ARMS,
    AXES5,
    EXPERTS,
    GEOMETRIES,
    MICRO,
    REPO,
    S,
    STEPS,
    scaled,
    spawn_ranks,
    wait_ranks,
)
from torch_threads import one_thread  # noqa: F401  (autouse)

RECIPE = {"ddp": "ddp", "fsdp": "ddp", "zero2": "zero2", "zero3": "zero2"}
NEAR_EPS = 10 * 1e-8  # tests/test_torch_tp.py's "well above" Adam's eps
TIE_SHARE = 1e-4  # of a leaf's elements; tests/test_torch_moe_parallel.py says why
TRAINED = [(mode, arm) for mode in GEOMETRIES for arm in ARMS[mode]]
PKG = "distributed_llm_training_benchmark_framework_tpu_torch"
# label -> the harness's flags beside --num-experts 4 on two ranks
HARNESS = {"tp2": ["--tensor-parallel", "2"],
           "sp2": ["--sequence-parallel", "2", "--attention", "ring"]}


def jax_config(mode):
    _, dispatch, attention = GEOMETRIES[mode]
    return jtiny.get_model_config("S", S, dropout=0.0, compute_dtype=jnp.float32,
                                  attention_impl=attention, n_experts=EXPERTS,
                                  moe_dispatch=dispatch)


def leaves(tree):
    out = [(k, v) for k, v in tree.items() if k != "blocks"]
    return out + [(f"blocks.{k}", v) for k, v in tree["blocks"].items()]


@functools.lru_cache(maxsize=None)
def _update(recipe):
    arm = dataclasses.replace(jstrat.get_strategy(recipe), precision="f32", remat="none")
    tx = jstrat.make_optimizer(arm)
    return arm, tx, jax.jit(lambda g, st, p: (lambda u, st: (optax.apply_updates(p, u), st))(
        *tx.update(g, st, p)))


def jax_reference(mode, table, init):
    """On the mode's mesh: {recipe: (per-step losses, final params, the
    elements whose gradient has been under 10 Adam eps, the sum of the
    learning rates)} from ``scaled(init)``, step 0's gradient at ``init``,
    and the loop's overflow diagnostic (``moe_overflow_fraction``) on step
    0's first micro-batch at ``scaled(init)``."""
    shape = GEOMETRIES[mode][0]
    mesh = jmake_mesh(shape, AXES5, devices=jax.devices()[:int(np.prod(shape))])
    jc = jax_config(mode)
    members = shape[0] * shape[4]
    if shape[3] > 1:
        fn = jax.jit(jax.value_and_grad(lambda p, b: jpipe.pipeline_loss_fn(jc, mesh, p, b)))

        def value_and_grad(params, batch):
            with jax.set_mesh(mesh):
                loss, g = fn(params, batch)
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

    out, G = {}, ACCUM * MICRO * members
    first = value_and_grad(init, table[np.arange(G) % table.shape[0]].reshape(ACCUM, -1, S))[1]
    with jax.set_mesh(mesh):
        rows = jax.device_put(table[:MICRO * members],
                              NamedSharding(mesh, jstrat.batch_partition_spec(mesh)))
        overflow = float(jax.jit(functools.partial(jtiny.moe_overflow_fraction, jc))(
            scaled(init), rows))
    for recipe in sorted({RECIPE[a] for a in ARMS[mode]}):
        arm, tx, update = _update(recipe)
        params = scaled(init)
        state = tx.init(params)
        small = jax.tree.map(lambda p: np.zeros(p.shape, bool), init)
        losses, lr_sum = [], 0.0
        for step in range(STEPS):
            batch = table[(step * G + np.arange(G)) % table.shape[0]].reshape(ACCUM, -1, S)
            loss, g = value_and_grad(params, batch)
            losses.append(loss)
            small = jax.tree.map(lambda m, g: m | (np.abs(g) < NEAR_EPS), small, g)
            params, state = update(g, state, params)
            params = jax.tree.map(np.asarray, params)
            lr_sum += arm.learning_rate * (min(1.0, step / arm.warmup_steps)
                                           if arm.warmup_steps else 1.0)
        out[recipe] = (losses, params, small, lr_sum)
    return out, first, overflow


def harness(tmp, label):
    """The harness at tier S with 4 experts on two gloo ranks through the
    launcher, with ``HARNESS[label]``'s flags: the process, its results dir."""
    results = tmp / f"harness_{label}"
    cmd = [sys.executable, "-m", f"{PKG}.runtime.launch", "--nproc", "2", "--",
           sys.executable, "-m", f"{PKG}.train.harness", "--device", "cpu",
           "--strategy", "zero2", "--world-size", "2", "--tier", "S", "--seq-len", str(S),
           "--steps", "4", "--warmup-steps", "2", "--sync-every", "2", "--per-device-batch",
           "1", "--grad-accum", "2", "--num-experts", str(EXPERTS), "--results-dir", str(results), *HARNESS[label]]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, results


@pytest.fixture(scope="module")
def runs(tmp_path_factory, eight_devices):
    """({mode: every rank's json}, {mode: rank 0's arrays}, {mode: JAX's
    recipes}, {mode: JAX's step-0 gradient}, {label: (exit code, stderr,
    the row)}, {mode: JAX's overflow diagnostic})."""
    tmp = tmp_path_factory.mktemp("moe_composed")
    init = jax.tree.map(np.asarray, jtiny.init_params(jax_config("tp2"), jax.random.key(42)))
    table = JaxSyntheticDataset(512, S, size=16, seed=42).data
    np.savez(tmp / "inputs.npz", table=table, **dict(leaves(init)))
    procs = {mode: spawn_ranks(int(np.prod(shape)), tmp / "inputs.npz", tmp / mode, mode)
             for mode, (shape, _, _) in GEOMETRIES.items()}
    launched = {label: harness(tmp, label) for label in HARNESS}
    recipes, grads, overflows = {}, {}, {}
    for mode in GEOMETRIES:
        recipes[mode], grads[mode], overflows[mode] = jax_reference(mode, table, init)
    ranks, rank0 = {}, {}
    for mode, ps in procs.items():
        wait_ranks(ps)
        ranks[mode] = [json.loads((tmp / f"{mode}.rank{r}.json").read_text())
                       for r in range(len(ps))]
        rank0[mode] = np.load(tmp / f"{mode}.rank0.npz")
    rows = {}
    for label, (proc, results) in launched.items():
        _, err = proc.communicate(timeout=300)
        found = sorted(results.glob("result_*.json"))
        rows[label] = (proc.returncode, err[-3000:],
                       json.loads(found[0].read_text()) if found else None)
    return ranks, rank0, recipes, grads, rows, overflows


@pytest.mark.parametrize("mode,arm", TRAINED)
def test_arm_matches_jaxs_step_on_the_same_mesh(runs, mode, arm):
    ranks, rank0, recipes = runs[:3]
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


@pytest.mark.parametrize("mode", list(GEOMETRIES))
def test_gradients_after_the_arm_are_jaxs(runs, mode):
    """Step 0's gradient (ddp): the expert leaves summed over the ranks that
    hold the same experts, the rest averaged over the arm's group, each
    model-sharded expert leaf gathered over ``model``."""
    _, rank0, _, grads = runs[:4]
    for key, leaf in leaves(grads[mode]):
        got = rank0[mode][f"grad.ddp.{key}"]
        assert np.abs(got - leaf).max() <= 1e-5 * np.abs(leaf).max(), key


@pytest.mark.parametrize("mode,arm", TRAINED)
def test_clip_norm_counts_every_element_once(runs, mode, arm):
    """Expert leaves' squares summed over ``expert``, and over ``model`` and
    ``pipe`` too where those shard them: the norm of JAX's whole gradient."""
    ranks, _, _, grads = runs[:4]
    want = np.sqrt(sum(np.square(v.astype(np.float64)).sum() for _, v in leaves(grads[mode])))
    for r in ranks[mode]:
        np.testing.assert_allclose(r["norms"][arm], want, rtol=1e-5)


@pytest.mark.parametrize("mode", list(GEOMETRIES))
def test_overflow_diagnostic_is_jaxs(runs, mode):
    """The loop's diagnostic routes as JAX's does on the same mesh (under
    ``pipe`` outside the pipeline's stages: beside ``seq``, the whole
    sequence), the same on every rank."""
    for r in runs[0][mode]:
        np.testing.assert_allclose(r["overflow"], runs[5][mode], rtol=1e-6)
    assert 0.0 <= runs[5][mode] < 1.0
    # Not vacuous: the capacity drops assignments in all but one geometry.
    assert sum(v > 0.0 for v in runs[5].values()) >= len(GEOMETRIES) - 1


@pytest.mark.parametrize("mode", list(GEOMETRIES))
def test_each_rank_holds_its_experts_columns(runs, mode):
    """E/ep experts at F/tp columns; rows over data x expert."""
    shape = dict(zip(AXES5, GEOMETRIES[mode][0]))
    E, F, D = EXPERTS // shape["expert"], 4 * 128 // shape["model"], 128
    for r, res in enumerate(runs[0][mode]):
        for name, got in res["shapes"].items():
            leaf = name.rsplit(".", 1)[1]
            assert got == {"moe_w1": [E, D, F], "moe_b1": [E, F], "moe_w2": [E, F, D],
                           "moe_b2": [E, D]}[leaf], name
        assert res["members"][1] == shape["data"] * shape["expert"]


@pytest.mark.parametrize("label", list(HARNESS))
def test_harness_trains_moe_beside_model_and_seq(runs, label):
    code, err, row = runs[4][label]
    assert code == 0, err
    assert row["n_experts"] == EXPERTS and row["world_size"] == 2
    assert 0.0 <= row["expert_overflow_pct"] <= 60.0
    assert validate_result(row, f"moe {label}") == []


def _simulated_route(mode, x, router, cap):
    """Route the global (B, S, D) array ``x`` as the mode's ranks do: each
    (member, seq shard) routes its rows and columns, with the table of
    counts summed over them -> {(member, shard): Route}."""
    shape = dict(zip(AXES5, GEOMETRIES[mode][0]))
    members = shape["data"] * shape["expert"]
    shards = shape["seq"] if shape["pipe"] == 1 else 1
    B, Sg, D = x.shape
    b, s = B // members, Sg // shards
    parts = {(m, k): torch.from_numpy(x[m * b:(m + 1) * b, k * s:(k + 1) * s]).reshape(-1, D)
             for m in range(members) for k in range(shards)}
    units = {key: tmoe.TokenUnits(key[0], members, key[1], shards) for key in parts}
    table = sum(tmoe.unit_table(tmoe.route(xt, router, 2, cap).expert_idx, EXPERTS,
                                units[key], b) for key, xt in parts.items())
    with chip_smoke.recording_loads(tmoe) as loads:
        routed = {key: tmoe.route(xt, router, 2, cap, units[key], b, table)
                  for key, xt in parts.items()}
    return routed, (b, s), loads


@pytest.mark.parametrize("mode", list(GEOMETRIES))
def test_routing_over_the_ranks_is_jaxs_on_the_global_array(mode):
    """Capacity factor 0.5, so drops fall across rank boundaries: every
    rank's keeps and global slots equal JAX's ``_route`` on the global
    array; a rank's local slots number its kept choices of an expert
    0, 1, ... in its own order; the drop fraction averaged over the ranks
    is JAX's, and so are the per-expert loads ``chip_smoke.py`` records
    (``recording_loads``)."""
    shape = dict(zip(AXES5, GEOMETRIES[mode][0]))
    members = shape["data"] * shape["expert"]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2 * members, S, 128)).astype(np.float32)
    router = rng.standard_normal((128, EXPERTS)).astype(np.float32) * 0.5
    jc = dataclasses.replace(jax_config(mode), capacity_factor=0.5)
    N = x.shape[0] * S
    cap = tmoe.capacity(N, EXPERTS, 2, 0.5)
    jd, _, _, jidx, jdrop = jmoe._route(jc, jnp.asarray(x.reshape(N, -1)), jnp.asarray(router),
                                        cap)
    jd, jidx = np.asarray(jd), np.asarray(jidx)
    jkeep = np.take_along_axis(jd.sum(-1), jidx, axis=1) > 0  # (N, K)
    jpos = np.take_along_axis(jd.argmax(-1), jidx, axis=1)
    routed, (b, s), loads = _simulated_route(mode, x, torch.from_numpy(router), cap)
    n_ids = np.arange(N).reshape(x.shape[0], S)
    drops = []
    for (m, k), r in routed.items():
        ids = n_ids[m * b:(m + 1) * b, k * s:(k + 1) * s].reshape(-1)
        np.testing.assert_array_equal(r.expert_idx.numpy(), jidx[ids])
        np.testing.assert_array_equal(r.keep.numpy(), jkeep[ids])
        keep = r.keep.numpy()
        np.testing.assert_array_equal(r.pos.numpy()[keep], jpos[ids][keep])
        for e in range(EXPERTS):
            mine = (r.expert_idx.numpy() == e) & keep
            assert sorted(r.slot.numpy()[mine]) == list(range(mine.sum()))
        drops.append(r.drop_frac.item())
    assert 0.0 < float(jdrop) < 1.0
    np.testing.assert_allclose(np.mean(drops), float(jdrop), rtol=1e-6)
    # The recorded loads, summed over the ranks: JAX's per-expert counts.
    assert len(loads) == len(routed)
    np.testing.assert_array_equal(sum(a for a, _ in loads).numpy(),
                                  np.bincount(jidx.reshape(-1), minlength=EXPERTS))
    np.testing.assert_array_equal(sum(k for _, k in loads).numpy(),
                                  jd.sum((0, 2)).astype(np.int64))
