"""The scan layer loop (``--layer-loop scan``; ``models/tinygpt.ScanBlocks``)
against the JAX package's ``scan_layers=True``, at tier S.

- **The model**, one process: logits, loss and every gradient (the stacked
  leaves' against JAX's stacked gradients) for both families and MoE,
  fp32, reference attention, dropout 0: tolerances of
  ``tests/test_torch_model.py`` (2e-3 loss and logits, 5e-3 gradients).
  The port's scan equals its unrolled form bit for bit (``torch.equal``)
  with dropout 0.1 from the same explicit seeds, under every remat policy
  and with MoE; JAX draws its embedding and MLP masks from its own keys,
  which no torch generator reproduces (ROADMAP Queue 3), so dropout > 0 is
  held there.
- **Autograd**: one node of a forward consumes each stacked leaf (``unbind``,
  whose backward writes the stacked gradient once), not one per layer.
- **The arms** over gloo (``tests/torch_scan_worker.py``, every geometry
  started at once): at data 2, ddp / fsdp / zero2 / zero3 (remat full:
  the gather inside the checkpoint) each step's loss against JAX's recipe at the same global batch
  with JAX's ``scan_layers=True`` (1e-5 relative) and the final params
  (1e-5 relative + 2e-6, Adam's small-gradient elements to lr per step, as
  ``tests/test_torch_arms.py``); fsdp at (data 4, model 2), JAX's audit
  geometry, likewise; and in every geometry, ddp / fsdp / zero2 at (data
  2, model 2) with 4 layers, the collective matmul, ring attention over
  the group, MoE and the host-offload arm included, the scan run's losses
  equal the unrolled run's bit for bit (the unrolled runs are held
  against JAX by the files of those compositions).
- **Placement**: ``param_partition_specs(..., scan_stacked=...)`` equals
  JAX's on the JAX leaves of both families over several meshes;
  ``blocks/wq`` is model-only under scan on (data 2, model 2) and
  data-sharded unrolled; where only the layer axis qualifies (``wo`` at 4
  layers on (data 2, model 2)) the scan loop shards it: each rank holds
  half its bytes.
- zero2's stacked leaves hold no gradient of their own (its buckets take
  the layers'); a checkpoint saved under one loop resumes under the other
  (zero2, fsdp, over two ranks) and the losses equal the straight run's.
- ``estimate_hbm`` under scan equals JAX's on every arm and mesh here.
- The audit arm ``llama-fsdp-dp4-tp2-scan`` equals its frozen collective
  and memory budgets, its counts obey the per-layer gather law, and its
  state exceeds ``llama-fsdp-dp4-tp2``'s by ``blocks/wq``'s data-sharded
  share.
- Beside ``pipe`` and ``expert`` the scan loop builds and trains: the
  harness, whose default loop is scan as JAX's, takes steps at (pipe 2)
  and (expert 2) over two gloo ranks through ``runtime.launch`` (the
  geometries held against the unrolled loop and JAX:
  ``tests/test_torch_scan_pipe.py``, ``tests/test_torch_scan_moe.py``), and
  ``LAYER_LOOP=scan`` plans every arm of the suite.
"""

import dataclasses
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_llm_training_benchmark_framework_tpu.data.synthetic import (
    SyntheticDataset as JaxSyntheticDataset,
)
from distributed_llm_training_benchmark_framework_tpu.models import llama as jllama
from distributed_llm_training_benchmark_framework_tpu.models import tinygpt as jtiny
from distributed_llm_training_benchmark_framework_tpu.parallel import make_mesh as jmake_mesh
from distributed_llm_training_benchmark_framework_tpu.parallel import strategies as jstrat
from distributed_llm_training_benchmark_framework_tpu.train.step import _resolve_model_config
from distributed_llm_training_benchmark_framework_tpu.utils import memory as jmemory
from distributed_llm_training_benchmark_framework_tpu_torch import bridge
from distributed_llm_training_benchmark_framework_tpu_torch.analysis.static import (
    collective_audit as audit,
)
from distributed_llm_training_benchmark_framework_tpu_torch.models import (
    TinyGPT,
    draw_mask_seeds,
    get_config,
)
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import strategies as tstrat
from distributed_llm_training_benchmark_framework_tpu_torch.parallel.mesh import Mesh
from distributed_llm_training_benchmark_framework_tpu_torch.utils import memory as tmemory
from distributed_llm_training_benchmark_framework_tpu_torch.utils.memory import jax_leaf_shapes

from torch_scan_worker import ACCUM, GEOMETRIES, MICRO, S, STEPS, spawn_ranks, wait_ranks
from torch_threads import one_thread  # noqa: F401  (autouse)

JAX_CONFIG = {"tinygpt": jtiny.get_model_config, "llama": jllama.get_llama_config}
ADAM_EPS = 1e-8
# The optimizer recipe of each arm label: bare AdamW, or warmup + clip.
RECIPE = {"ddp": "ddp", "fsdp": "ddp", "zero2": "zero2", "zero3": "zero2", "zero3_full": "zero2"}
# The worker's params keys: (family, JAX config change).
FAMILIES = {"tinygpt": ("tinygpt", {}), "llama": ("llama", {}), "llama4": ("llama", {"n_layer": 4}),
            "tinygpt_moe": ("tinygpt", {"n_experts": 4})}


def _jax_config(key, **kw):
    family, change = FAMILIES[key]
    return JAX_CONFIG[family]("S", S, dropout=0.0, compute_dtype=jnp.float32,
                              attention_impl="reference", scan_layers=True, **change, **kw)


def _pair(family, **kw):
    jc = _jax_config(family, **kw)
    params = jtiny.init_params(jc, jax.random.key(0))
    model = TinyGPT(get_config(family, "S", S, dropout=0.0, compute_dtype=torch.float32,
                               attention_impl="reference", scan_layers=True, **kw))
    bridge.load_jax_params(model, jax.tree.map(np.asarray, params))
    return jc, params, model


# ---------------------------------------------------------------------------
# The model in one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family,kw", [("tinygpt", {}), ("llama", {}),
                                       ("tinygpt", {"n_experts": 4})],
                         ids=["tinygpt", "llama", "tinygpt-moe"])
def test_scan_loss_and_grads_match_jax(family, kw):
    jc, params, model = _pair(family, **kw)
    assert jc.scan_layers and model.scan
    rng = np.random.default_rng(1)
    idx = rng.integers(0, jc.vocab_size, (2, S)).astype(np.int32)
    tgt = idx.copy()
    tgt[0, :5] = -1

    def jloss(p):
        logits, loss = jtiny.forward(jc, p, jnp.asarray(idx), jnp.asarray(tgt))
        return loss, logits

    (j_loss, j_logits), j_grads = jax.value_and_grad(jloss, has_aux=True)(params)
    t_logits, t_loss = model(torch.from_numpy(idx).long(), torch.from_numpy(tgt).long())
    t_loss.backward()
    np.testing.assert_allclose(t_logits.detach().numpy(), np.asarray(j_logits), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=2e-3, atol=2e-3)
    g = jax.tree.map(np.asarray, j_grads)
    for leaf in model.blocks.leaf_names:
        got = model.blocks.stacked(leaf).grad.numpy()
        want = g["blocks"][leaf.removeprefix("experts.")]
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3, err_msg=leaf)
    for name, p in model.named_parameters():
        if not name.startswith("blocks."):
            np.testing.assert_allclose(p.grad.numpy(), g[name], rtol=5e-3, atol=5e-3,
                                       err_msg=name)


def _loss_and_grads(family, scan, remat, **kw):
    c = get_config(family, "S", S, dropout=0.1, scan_layers=scan, remat=remat, **kw)
    model = TinyGPT(c).init_weights(torch.Generator().manual_seed(0))
    idx = torch.randint(0, c.vocab_size, (2, S), generator=torch.Generator().manual_seed(1))
    seeds = draw_mask_seeds(torch.Generator().manual_seed(3), c.n_layer)
    _, loss = model(idx, idx, attn_seeds=[11 + i for i in range(c.n_layer)], mask_seeds=seeds)
    loss.backward()
    if not scan:
        return loss, {name: p.grad for name, p in model.named_parameters()}
    grads = {name: p.grad for name, p in model.named_parameters()
             if not name.startswith("blocks.")}
    for leaf in model.blocks.leaf_names:
        for i, g in enumerate(model.blocks.stacked(leaf).grad):
            grads[f"blocks.{i}.{leaf}"] = g
    return loss, grads


@pytest.mark.parametrize("family,remat,kw", [
    ("tinygpt", "none", {}), ("llama", "none", {}), ("tinygpt", "dots", {}),
    ("llama", "full", {}), ("tinygpt", "none", {"n_experts": 4})],
    ids=["tinygpt", "llama", "tinygpt-dots", "llama-full", "tinygpt-moe"])
def test_scan_equals_unrolled_bit_for_bit_with_dropout(family, remat, kw):
    loss_u, grads_u = _loss_and_grads(family, False, remat, **kw)
    loss_s, grads_s = _loss_and_grads(family, True, remat, **kw)
    assert torch.equal(loss_u, loss_s)
    assert set(grads_u) == set(grads_s)
    for name, g in grads_u.items():
        assert torch.equal(g, grads_s[name]), name


def _consumers(loss, params):
    """{name: the autograd nodes of the graph whose inputs include the
    parameter's gradient accumulator}."""
    acc, seen, stack = {}, set(), [loss.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            var = getattr(nxt, "variable", None)
            if var is not None:
                acc[id(var)] = acc.get(id(var), 0) + 1
            elif nxt is not None:
                stack.append(nxt)
    return {name: acc.get(id(p), 0) for name, p in params}


@pytest.mark.parametrize("n_layer", [2, 4])
def test_one_autograd_node_consumes_each_stacked_leaf(n_layer):
    c = get_config("llama", "S", S, dropout=0.0, scan_layers=True, n_layer=n_layer)
    model = TinyGPT(c).init_weights(torch.Generator().manual_seed(0))
    idx = torch.randint(0, c.vocab_size, (1, S), generator=torch.Generator().manual_seed(1))
    _, loss = model(idx, idx)
    stacked = [(leaf, model.blocks.stacked(leaf)) for leaf in model.blocks.leaf_names]
    assert _consumers(loss, stacked) == {leaf: 1 for leaf, _ in stacked}
    # What the slices would cost taken one layer at a time: n_layer consumers.
    one_by_one = model.blocks.stacked("wo")
    loss2 = sum(one_by_one[i].sum() for i in range(n_layer))
    assert _consumers(loss2, [("wo", one_by_one)]) == {"wo": n_layer}


HARNESS_GEOMETRIES = {"pp2": ["--pipeline-parallel", "2", "--pipeline-schedule", "1f1b"],
                      "ep2": ["--num-experts", "4", "--expert-parallel", "2"]}


def test_scan_builds_and_steps_beside_pipe_and_expert(tmp_path):
    """The harness with no ``--layer-loop`` (scan, JAX's default) on two
    gloo ranks at (pipe 2) and (expert 2): each finishes its steps and
    writes a row that names the scan loop."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from distributed_llm_training_benchmark_framework_tpu_torch.train.loop import build_run

    with pytest.raises(ValueError, match="unknown layer_loop"):
        build_run(tier="S", seq_len=S, device="cpu", layer_loop="while")
    repo = Path(__file__).resolve().parents[1]
    pkg = "distributed_llm_training_benchmark_framework_tpu_torch"
    env = dict(os.environ, PYTHONPATH=str(repo), OMP_NUM_THREADS="1")
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    procs = {}
    for label, flags in HARNESS_GEOMETRIES.items():
        cmd = [sys.executable, "-m", f"{pkg}.runtime.launch", "--nproc", "2", "--",
               sys.executable, "-m", f"{pkg}.train.harness", "--device", "cpu",
               "--strategy", "zero2", "--world-size", "2", "--tier", "S", "--seq-len", "32",
               "--steps", "3", "--warmup-steps", "1", "--sync-every", "1",
               "--per-device-batch", "1", "--grad-accum", "2", "--heartbeat-sec", "0",
               "--results-dir", str(tmp_path / label), *flags]
        procs[label] = subprocess.Popen(cmd, cwd=repo, env=env, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True)
    for label, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, (label, err[-3000:])
        (row,) = [json.loads(p.read_text()) for p in (tmp_path / label).glob("result_*.json")]
        assert row["layer_loop"] == "scan" and row["world_size"] == 2, label


# ---------------------------------------------------------------------------
# Placement and the memory model
# ---------------------------------------------------------------------------


def _jax_shapes(family, **kw):
    jc = JAX_CONFIG[family]("S", S, **kw)
    return jc, jax.eval_shape(lambda: jtiny.init_params(jc, jax.random.key(0)))


MESHES = [{"data": 2, "model": 2}, {"data": 4, "model": 2}, {"data": 8}, {"data": 2},
          {"data": 2, "model": 4}]


@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("family,n_layer", [("tinygpt", 2), ("llama", 2), ("llama", 4),
                                            ("llama", 8)])
def test_placement_is_jaxs(family, n_layer, scan):
    jc, shapes = _jax_shapes(family, n_layer=n_layer)
    flat = {name: tuple(shape) for name, shape in jax_leaf_shapes(
        get_config(family, "S", S, n_layer=n_layer)).items()}
    for mesh in MESHES:
        for shard in (True, False):
            want = jstrat.param_partition_specs(shapes, SimpleNamespace(shape=mesh), shard,
                                                kv_heads=jc.kv_heads, scan_stacked=scan)
            got = tstrat.param_partition_specs(flat, mesh, shard, kv_heads=jc.kv_heads,
                                               scan_stacked=scan)
            want = {k: tuple(v) for k, v in want.items() if k != "blocks"} | {
                f"blocks/{k}": tuple(v) for k, v in want["blocks"].items()}
            assert {k: tuple(v) + (None,) * (len(flat[k]) - len(v)) for k, v in want.items()} \
                == got, (mesh, shard)


def test_wq_is_model_only_under_scan_and_the_layer_axis_fallback_shards():
    cfg = get_config("llama", "S", S, n_layer=4)
    mesh = {"data": 2, "model": 2}
    shapes = jax_leaf_shapes(cfg)
    for scan, want in ((True, (None, None, "model")), (False, (None, "data", "model"))):
        spec = tstrat.param_partition_specs(shapes, mesh, True, cfg.kv_heads, scan)
        assert spec["blocks/wq"] == want
        assert spec["blocks/wo"] == ("data", "model", None)
    # The port's rule for one layer's local leaf: wo's data axis is the layer
    # axis, which the unrolled port cannot shard and the scan loop does.
    wo = (cfg.n_embd // 2, cfg.n_embd)
    assert tstrat.fsdp_data_axis("blocks.0.wo", wo, mesh, cfg.kv_heads, 4) is None
    assert tstrat.fsdp_data_axis("blocks.0.wo", wo, mesh, cfg.kv_heads, 4,
                                 scan_stacked=True) == 0
    wq = (cfg.n_embd, cfg.n_embd // 2)
    assert tstrat.fsdp_data_axis("blocks.0.wq", wq, mesh, cfg.kv_heads, 4) == 0
    assert tstrat.fsdp_data_axis("blocks.0.wq", wq, mesh, cfg.kv_heads, 4,
                                 scan_stacked=True) is None


ESTIMATES = [("tinygpt", 1, 1), ("tinygpt", 2, 1), ("tinygpt", 2, 2), ("llama", 2, 2),
             ("llama", 4, 2)]


@pytest.mark.parametrize("arm", sorted(jstrat.STRATEGIES))
@pytest.mark.parametrize("family,data,model", ESTIMATES)
def test_estimate_hbm_under_scan_is_jaxs(family, data, model, arm):
    jstrategy = jstrat.get_strategy(arm)
    jmesh = jmake_mesh((data, 1, model), ("data", "seq", "model"),
                       devices=jax.devices()[:data * model])
    jcfg = _resolve_model_config(JAX_CONFIG[family]("A", 2048, scan_layers=True), jstrategy,
                                 jmesh)
    want = jmemory.estimate_hbm(jcfg, jstrategy, jmesh, 1, 2048)
    strategy = tstrat.get_strategy(arm)
    got = tmemory.estimate_hbm(get_config(family, "A", 2048, remat=strategy.remat,
                                          scan_layers=True),
                               strategy, Mesh({"data": data, "model": model}), 1, 2048)
    opt = jstrat.make_optimizer(jstrategy)
    shapes = jax.eval_shape(lambda: jtiny.init_params(jcfg, jax.random.key(0)))
    scalars = sum(np.dtype(x.dtype).itemsize for x in
                  jax.tree_util.tree_leaves(jax.eval_shape(opt.init, shapes)) if x.shape == ())
    assert (got.params, got.grads, got.activations, got.logits) == (
        want.params, want.grads, want.activations, want.logits)
    assert got.opt_state == want.opt_state - scalars


# ---------------------------------------------------------------------------
# The arms over gloo
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({geometry: (rank 0's record, rank 0's arrays, every rank's record)},
    {(recipe, params key, world): the JAX recipe's steps})."""
    tmp = tmp_path_factory.mktemp("scan")
    table = JaxSyntheticDataset(512, S, size=10, seed=42).data
    arrays = {"table": table}
    for key in FAMILIES:
        p = jax.tree.map(np.asarray, jtiny.init_params(_jax_config(key), jax.random.key(0)))
        arrays.update({f"{key}.{k}": v for k, v in p.items() if k != "blocks"})
        arrays.update({f"{key}.blocks.{k}": v for k, v in p["blocks"].items()})
    inputs = tmp / "inputs.npz"
    np.savez(inputs, **arrays)
    procs = {g: spawn_ranks(spec[0], inputs, tmp / g, g) for g, spec in GEOMETRIES.items()}
    recipes = {}
    for recipe, key, world in (("ddp", "tinygpt", 2), ("zero2", "tinygpt", 2),
                               ("ddp", "llama", 4)):
        recipes[recipe, key, world] = _jax_recipe(recipe, key, world, table)
    out = {}
    for g, ps in procs.items():
        wait_ranks(ps)
        ranks = [json.loads((tmp / f"{g}.rank{r}.json").read_text()) for r in range(len(ps))]
        out[g] = (ranks[0], np.load(tmp / f"{g}.rank0.npz"), ranks)
    return out, recipes


def _jax_recipe(recipe_name, key, world, table):
    """Per step: (loss, params, the elements whose gradient has been under
    Adam's eps, the sum of the learning rates so far) of JAX's recipe under
    ``scan_layers=True`` at global micro ``world`` (each micro-batch's loss
    and gradient the mean of the ranks')."""
    jc = _jax_config(key)
    params = jtiny.init_params(jc, jax.random.key(0))
    recipe = jstrat.get_strategy(recipe_name)
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
            grads = jax.tree.map(jnp.add, grads,
                                 jax.tree.map(lambda *gs: sum(gs) / world, *(g for _, g in parts)))
        grads = jax.tree.map(lambda g: g / ACCUM, grads)
        small = jax.tree.map(lambda m, g: m | (np.abs(np.asarray(g)) < ADAM_EPS), small, grads)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        warmup = recipe.warmup_steps
        lr_sum += recipe.learning_rate * (min(1.0, step / warmup) if warmup else 1.0)
        out.append((float(loss_sum / ACCUM), jax.tree.map(np.asarray, params), small, lr_sum))
    return out


JAX_HELD = [("dp2", label, "tinygpt", 2) for label in ("ddp", "fsdp", "zero2",
                                                       "zero3_full")] + [
    ("fsdp_tp", "fsdp", "llama", 4)]


@pytest.mark.parametrize("geometry,label,key,world", JAX_HELD,
                         ids=[f"{g}-{lb}" for g, lb, _, _ in JAX_HELD])
def test_arm_under_scan_matches_jaxs_scan_step(runs, geometry, label, key, world):
    rec, arrays, ranks = runs[0][geometry]
    want = runs[1][RECIPE[label], key, world]
    for r in ranks:  # the step's loss is the mean over ranks on every rank
        assert r["losses"][label]["scan"] == rec["losses"][label]["scan"]
    got = rec["losses"][label]["scan"]
    np.testing.assert_allclose(got, [loss for loss, *_ in want], rtol=1e-5)
    _, params, small, lr_sum = want[-1]
    for k, leaf, tiny in [(k, params[k], small[k]) for k in params if k != "blocks"] + [
            (f"blocks.{k}", v, small["blocks"][k]) for k, v in params["blocks"].items()]:
        have = arrays[f"{label}.{k}"]
        np.testing.assert_allclose(have[~tiny], leaf[~tiny], rtol=1e-5, atol=2e-6, err_msg=k)
        assert (np.abs(have[tiny] - leaf[tiny]) <= lr_sum).all(), k


SCAN_VS_UNROLLED = [(g, label) for g, spec in GEOMETRIES.items() for label in spec[4]]


@pytest.mark.parametrize("geometry,label", SCAN_VS_UNROLLED,
                         ids=[f"{g}-{lb}" for g, lb in SCAN_VS_UNROLLED])
def test_scan_run_equals_the_unrolled_run_bit_for_bit(runs, geometry, label):
    for rec in runs[0][geometry][2]:
        losses = rec["losses"][label]
        assert losses["scan"] == losses["unrolled"] and len(losses["scan"]) == STEPS


def test_fsdp_shards_the_layer_axis_fallback_and_keeps_wq_whole(runs):
    """(data 2, model 2), Llama at 4 layers: ``wo`` (JAX: data on the layer
    axis) holds half its bytes on each rank, ``blocks/wq`` (model-only under
    scan) all of them; zero2 holds every stacked leaf whole."""
    rec = runs[0]["tp2"][0]
    cfg = get_config("llama", "S", S, n_layer=4)
    wo = 4 * (cfg.n_embd // 2) * cfg.n_embd * 4
    wq = 4 * cfg.n_embd * (cfg.n_embd // 2) * 4
    assert rec["stacked_bytes"]["fsdp"]["wo"] == wo // 2
    assert rec["stacked_bytes"]["fsdp"]["wq"] == wq
    assert rec["stacked_bytes"]["zero2"]["wo"] == wo
    assert not any(rec["zero2_stacked_grads"])


@pytest.mark.parametrize("arm", ["zero2", "fsdp"])
def test_checkpoint_resumes_across_layer_loops(runs, arm):
    for rec in runs[0]["dp2"][2]:
        ck = rec["checkpoints"][arm]
        assert ck["scan->unrolled"] == ck["straight"] and ck["unrolled->scan"] == ck["straight"]


# ---------------------------------------------------------------------------
# The audit arm
# ---------------------------------------------------------------------------


SCAN_ARM = "llama-fsdp-dp4-tp2-scan"


def test_scan_audit_arm_passes_audit_and_memory():
    budgets = audit.load_budgets()
    spec = audit.ROSTER[SCAN_ARM]
    report = audit.audit_arm(spec)
    assert audit.diff_against_budget(report, budgets) == []
    memory = audit.audit_arm_memory(spec)
    assert audit.diff_memory_against_budget(memory, budgets) == []
    assert memory.replicated_bytes == memory.expected_replicated_bytes
    # The schedule's law, per micro-batch (the arm runs one): one all-gather
    # of each layer's shares in the forward and one reduce-scatter of its
    # gradients in the backward. The backward needs no gather again: at
    # bf16 compute it keeps the bf16 casts of the gathered weights, and no
    # fp32 gathered tensor is saved (a saved one is gathered again, once).
    layers = get_config("llama", "S", 64).n_layer
    assert spec.grad_accum == 1
    assert report.collectives["all-gather"] == layers
    assert report.collectives["reduce-scatter"] == layers
    assert report.group_sizes["all-gather"] == {"4": layers}


def test_scan_audit_arms_state_exceeds_the_unrolled_arms_by_wqs_share():
    scan = audit.audit_arm_memory(audit.ROSTER[SCAN_ARM])
    unrolled = audit.audit_arm_memory(audit.ROSTER["llama-fsdp-dp4-tp2"])
    cfg = get_config("llama", "S", 64)
    wq = cfg.n_layer * cfg.n_embd * (cfg.n_embd // 2)  # this model rank's elements
    share = wq - wq // 4  # what data 4 would have sharded away, of each of 4 copies
    # The unrolled arm holds each layer's leaves apart: one AdamW step counter
    # (a 4-byte scalar) more per block leaf and layer beyond the first.
    leaves = len(TinyGPT(dataclasses.replace(cfg, scan_layers=True)).blocks.leaf_names)
    counters = 4 * leaves * (cfg.n_layer - 1)
    assert scan.argument_bytes - unrolled.argument_bytes == 4 * 4 * share - counters
    assert scan.replicated_bytes - unrolled.replicated_bytes == 4 * 4 * wq


def test_suite_under_scan_plans_every_arm():
    """``LAYER_LOOP=scan`` reaches every arm of the suite's plan, the
    composition arms over ``pipe`` and ``expert`` included: no SKIP line."""
    import os
    import subprocess
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, LAYER_LOOP="scan", SUITE_DRY_RUN="1", DEVICE="cpu",
               WORLD_SIZES="1 4", TIER="S", SKIP_CHAOS="1")
    res = subprocess.run(["bash", "scripts/torch_run_all_benchmarks.sh"], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert not [ln for ln in res.stdout.splitlines() if ln.startswith("SKIP ")]
    planned = [ln for ln in res.stdout.splitlines() if ln.startswith("PLAN ")]
    assert len(planned) == 8 + 14
    for arm in ("pp2-gpipe", "pp2-1f1b", "pp2-interleaved", "moe-ep2", "moe8-ep2"):
        assert sum(ln.split()[2].endswith(f"-{arm}") for ln in planned) == 1, arm
