"""The pipeline's bookkeeping against the JAX package, without ranks
(``parallel/interleaved.py``, ``parallel/pipeline.py``, ``utils/memory.py``,
``bridge.py``):

- ``build_schedule(P, V, M)`` equals JAX's, every table and every slot
  count, over P in {2, 3, 4}, V in {1, 2, 3}, M in {1, ..., 8}; so do its
  ``bubble_fraction`` and ``layer_permutation``;
- ``pipeline_schedule_meta`` equals JAX's (``train/step.py``) on a mesh of
  the same widths, and ``pipeline_bubble_bound`` JAX's
  (``analysis/static/hlo_audit.py``);
- the message law: one step sends M * (P - 1) messages per direction
  (gpipe, 1f1b) or M * (P * V - 1) (interleaved), as many as the
  interleaved tables' F units and non-embedding B units;
- ``estimate_hbm`` under a ``pipe`` axis equals JAX's (its spec rule puts
  ``pipe`` on the layer axis of the block leaves; activations of the
  stage's ``L // pp`` layers);
- a stage builds its layers: contiguous under gpipe / 1f1b, the chunks
  ``{v * P + s}`` in ``layer_permutation``'s order under interleaved, and
  every layout of a seed holds the same weights;
- the bridge loads and exports a tree stacked in ``layer_permutation``
  order (JAX's interleaved layout) and round-trips it;
- the refusals: JAX's messages where JAX refuses (an unknown schedule,
  ``n_layer % pipe``, ``n_layer % (pipe * virtual)``, the collective
  matmul), the port's own for a pipeline at world 1 and beside a ``model``
  axis or an ``expert`` axis wider than 1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_training_benchmark_framework_tpu.analysis.static import hlo_audit
from distributed_llm_training_benchmark_framework_tpu.models import tinygpt as jtiny
from distributed_llm_training_benchmark_framework_tpu.parallel import interleaved as jint
from distributed_llm_training_benchmark_framework_tpu.parallel import make_mesh as jmake_mesh
from distributed_llm_training_benchmark_framework_tpu.parallel import pipeline as jpipe
from distributed_llm_training_benchmark_framework_tpu.parallel import strategies as jstrat
from distributed_llm_training_benchmark_framework_tpu.train import loop as jloop
from distributed_llm_training_benchmark_framework_tpu.train.step import (
    _resolve_model_config,
)
from distributed_llm_training_benchmark_framework_tpu.train.step import (
    pipeline_schedule_meta as jax_meta,
)
from distributed_llm_training_benchmark_framework_tpu.utils import memory as jmemory
from distributed_llm_training_benchmark_framework_tpu_torch import bridge
from distributed_llm_training_benchmark_framework_tpu_torch.models import TinyGPT, get_config
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import Mesh
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import interleaved as tint
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import pipeline as tpipe
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import strategies as tstrat
from distributed_llm_training_benchmark_framework_tpu_torch.train.loop import build_run
from distributed_llm_training_benchmark_framework_tpu_torch.utils import memory as tmemory

AXES5 = ("data", "seq", "model", "pipe", "expert")
TABLES = ("kind", "unit_m", "unit_v", "f_src", "b_src", "b_head", "resid_rw", "park_f",
          "park_b", "send_f", "send_b")


@pytest.mark.parametrize("M", range(1, 9))
@pytest.mark.parametrize("V", (1, 2, 3))
@pytest.mark.parametrize("P", (2, 3, 4))
def test_interleaved_tables_are_jaxs(P, V, M):
    got, want = tint.build_schedule(P, V, M), jint.build_schedule(P, V, M)
    assert (got.P, got.V, got.M, got.ticks) == (want.P, want.V, want.M, want.ticks)
    for name in TABLES:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    for name in ("pend_f_slots", "pend_b_slots", "resid_slots"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.bubble_fraction == want.bubble_fraction
    # The message law: every F unit sends, every B unit but position 0's.
    j = got.unit_v * P + np.arange(P)[None, :]
    assert int(got.send_f.sum()) == tpipe.expected_messages("interleaved", P, M, V)
    assert int(got.send_b.sum()) == int(((got.kind == tint.BWD) & (j != 0)).sum())
    assert int(got.send_b.sum()) == tpipe.expected_messages("interleaved", P, M, V)


@pytest.mark.parametrize("n_layer,P,V", [(2, 2, 1), (4, 2, 2), (16, 2, 2), (12, 3, 2),
                                         (12, 2, 3), (16, 4, 2), (8, 4, 1)])
def test_layer_permutation_is_jaxs(n_layer, P, V):
    np.testing.assert_array_equal(tint.layer_permutation(n_layer, P, V),
                                  jint.layer_permutation(n_layer, P, V))


@pytest.mark.parametrize("schedule", tpipe.SCHEDULES)
@pytest.mark.parametrize("pipe,accum,virtual", [(2, 4, 2), (2, 1, 3), (4, 8, 2)])
def test_schedule_meta_and_bubble_bound_are_jaxs(eight_devices, schedule, pipe, accum,
                                                 virtual):
    jmesh = jmake_mesh((1, 1, 1, pipe, 1), AXES5, devices=jax.devices()[:pipe])
    mesh = Mesh({"data": 1, "pipe": pipe})
    want = jax_meta(jmesh, accum, schedule, virtual)
    assert tpipe.pipeline_schedule_meta(mesh, accum, schedule, virtual) == want
    args = (schedule, want["stages"], want["microbatches"], want["virtual"])
    assert tpipe.pipeline_bubble_bound(*args) == hlo_audit.pipeline_bubble_bound(*args)
    assert tpipe.pipeline_schedule_meta(Mesh({"data": 1}), accum, schedule) is None
    positions = pipe * want["virtual"]
    assert tpipe.expected_messages(schedule, pipe, accum, want["virtual"]) == (
        accum * (positions - 1))


def test_meta_refuses_an_unknown_schedule_as_jax_does(eight_devices):
    jmesh = jmake_mesh((1, 1, 1, 2, 1), AXES5, devices=jax.devices()[:2])
    with pytest.raises(ValueError) as want:
        jax_meta(jmesh, 4, "zerobubble")
    with pytest.raises(ValueError) as got:
        tpipe.pipeline_schedule_meta(Mesh({"data": 1, "pipe": 2}), 4, "zerobubble")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arm", sorted(jstrat.STRATEGIES))
@pytest.mark.parametrize("data,pipe", [(1, 2), (2, 2), (1, 4)])
def test_estimate_under_a_pipe_axis_is_jaxs(eight_devices, data, pipe, arm):
    """Tier A: params, grads, activations and logits equal JAX's
    ``estimate_hbm`` on the same mesh, the AdamW moments its optimizer state
    less optax's scalar counters."""
    jstrategy = jstrat.get_strategy(arm)
    jmesh = jmake_mesh((data, 1, 1, pipe, 1), AXES5, devices=jax.devices()[:data * pipe])
    jcfg = _resolve_model_config(jtiny.get_model_config("A", 2048, scan_layers=False),
                                 jstrategy, jmesh)
    if jcfg.compute_dtype != jnp.bfloat16:
        # JAX runs a CPU pipeline in fp32 (an XLA:CPU workaround); the
        # estimate is of the card's bf16 run.
        jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.bfloat16)
    want = jmemory.estimate_hbm(jcfg, jstrategy, jmesh, 1, 2048)
    opt = jstrat.make_optimizer(jstrategy)
    shapes = jax.eval_shape(lambda: jtiny.init_params(jcfg, jax.random.key(0)))
    scalars = sum(np.dtype(x.dtype).itemsize for x in
                  jax.tree_util.tree_leaves(jax.eval_shape(opt.init, shapes)) if x.shape == ())
    strategy = tstrat.get_strategy(arm)
    got = tmemory.estimate_hbm(get_config("tinygpt", "A", 2048, remat=strategy.remat), strategy,
                               Mesh({"data": data, "pipe": pipe}), 1, 2048)
    assert (got.params, got.grads, got.activations, got.logits) == (
        want.params, want.grads, want.activations, want.logits)
    assert got.opt_state == want.opt_state - scalars


@pytest.mark.parametrize("schedule,virtual", [("gpipe", 1), ("interleaved", 2)])
def test_a_stage_holds_its_layers_with_the_whole_models_weights(monkeypatch, schedule,
                                                                 virtual):
    """Every stage of a seed holds the whole model's weights of its layers:
    the contiguous halves under gpipe, chunks {v*P + s} under interleaved."""
    cfg = get_config("tinygpt", "S", 64, n_layer=8, dropout=0.0)
    whole = TinyGPT(cfg).init_weights(torch.Generator().manual_seed(5))
    want = bridge.export_params(whole)
    perm = tint.layer_permutation(8, 2, virtual)
    for stage in range(2):
        monkeypatch.setattr(Mesh, "pipe_shard", property(lambda self, s=stage: (s, 2)))
        model = TinyGPT(cfg, Mesh({"data": 1, "pipe": 2}), virtual_stages=virtual)
        model.init_weights(torch.Generator().manual_seed(5))
        assert model.layer_ids == [int(g) for g in perm[stage * 4:(stage + 1) * 4]]
        if schedule == "gpipe":
            assert model.layer_ids == list(range(stage * 4, stage * 4 + 4))
        got = bridge.export_params(model)
        for leaf, stack in got["blocks"].items():
            np.testing.assert_array_equal(stack, want["blocks"][leaf][sorted(model.layer_ids)])
        for key in ("wte", "wpe", "lnf_scale", "lnf_bias"):
            np.testing.assert_array_equal(got[key], want[key])


def test_bridge_round_trips_the_interleaved_layout(monkeypatch):
    """JAX keeps an interleaved run's stacked layers in ``layer_permutation``
    order: a tree in that order loads to the right global layers (a whole
    model, and stage 1 of 2 at V 2) and exports back in either order."""
    cfg = get_config("tinygpt", "S", 64, n_layer=4, dropout=0.0)
    jcfg = jtiny.get_model_config("S", 64, n_layer=4, dropout=0.0)
    init = jax.tree.map(np.asarray, jtiny.init_params(jcfg, jax.random.key(3)))
    perm = tint.layer_permutation(4, 2, 2)
    permuted = {**init, "blocks": {k: v[perm] for k, v in init["blocks"].items()}}
    model = bridge.load_jax_params(TinyGPT(cfg), permuted, layer_order=perm)
    plain = bridge.export_params(model)
    again = bridge.export_params(model, layer_order=perm)
    for leaf in init["blocks"]:
        np.testing.assert_array_equal(plain["blocks"][leaf], init["blocks"][leaf])
        np.testing.assert_array_equal(again["blocks"][leaf], permuted["blocks"][leaf])
    monkeypatch.setattr(Mesh, "pipe_shard", property(lambda self: (1, 2)))
    stage = bridge.load_jax_params(TinyGPT(cfg, Mesh({"data": 1, "pipe": 2}), virtual_stages=2),
                                   permuted, layer_order=perm)
    assert stage.layer_ids == [1, 3]
    for i, g in enumerate(stage.layer_ids):
        np.testing.assert_array_equal(stage.blocks[i].wqkv.detach().numpy(),
                                      init["blocks"]["wqkv"][g])


def _refusal(**kw):
    with pytest.raises(ValueError) as e:
        build_run(tier="S", seq_len=64, device="cpu", pipeline_parallel=2, **kw)
    return str(e.value)


def test_refusals_are_jaxs(eight_devices):
    """JAX's messages for what JAX refuses; the port's own for a pipeline at
    world 1 and beside ``model`` or an ``expert`` axis wider than 1."""
    with pytest.raises(ValueError) as want:
        jax_meta(jmake_mesh((1, 1, 1, 2, 1), AXES5, devices=jax.devices()[:2]), 4, "zb")
    assert _refusal(pipeline_schedule="zb") == str(want.value)
    with pytest.raises(ValueError) as want:
        jint.layer_permutation(2, 2, 2)
    assert _refusal(pipeline_schedule="interleaved", virtual_stages=2) == str(want.value)
    jcfg = jtiny.get_model_config("S", 64, dropout=0.0)
    with pytest.raises(ValueError) as want:
        jpipe.pipeline_loss_fn(jcfg, jmake_mesh((1, 1, 1, 4, 1), AXES5,
                                                devices=jax.devices()[:4]),
                               jtiny.init_params(jcfg, jax.random.key(0)),
                               np.zeros((4, 1, 64), np.int32))
    with pytest.raises(ValueError) as got:
        build_run(tier="S", seq_len=64, device="cpu", pipeline_parallel=4)
    assert str(got.value) == str(want.value) == "n_layer=2 not divisible by pipe=4"
    with pytest.raises(ValueError) as want:
        jloop.run_benchmark(strategy="zero2", tier="S", seq_len=64, steps=2, warmup_steps=1,
                            per_device_batch=1, grad_accum=2, world_size=2,
                            pipeline_parallel=2, tp_collective_matmul=True)
    assert _refusal(tp_collective_matmul=True) == str(want.value)
    assert "needs a process group" in _refusal()
    assert "pipeline parallelism (pipe width 2)" in _refusal()
    msg = _refusal(tensor_parallel=2)
    assert "beside tensor parallelism is not ported" in msg and "item 13" in msg
    msg = _refusal(n_experts=4, expert_parallel=2)
    assert "beside an 'expert' axis wider than 1 is not ported" in msg and "item 12" in msg
