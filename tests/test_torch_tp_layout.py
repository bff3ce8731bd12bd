"""Tensor parallelism without ranks: the port's copy of JAX's layout rules,
its memory model and accounting under a ``model`` axis, the head-shard
masks, and JAX's refusals.

- ``parallel/strategies.param_partition_specs`` (the port's copy, with the
  kv-head-aligned rule and the composed-mesh hygiene) gives JAX's specs on
  JAX's own trees, and ``tp_axis`` names the axis JAX shards over
  ``model`` on every leaf of both families;
- ``estimate_hbm`` equals JAX's at tier A on (model 2), (data 2, model 2)
  and, for Llama, whose 4 kv heads 8 ranks do not split, (model 8): params,
  grads, AdamW moments (JAX's optimizer state less optax's scalar
  counters), activations and logits;
- ``compute_result`` counts tokens per step at JAX's ``dp = world // (tp *
  sp)``;
- Ulysses' shard index folds ``data``, ``model`` and ``seq`` as JAX's
  ``_global_shard_index`` does on a (data, seq, model) mesh;
- a head shard of flash (plain versions) and of the reference attention
  equals the matching rows of the whole layer at dropout 0.1 and B 2;
- the refusals.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_llm_training_benchmark_framework_tpu.models import llama as jllama
from distributed_llm_training_benchmark_framework_tpu.models import tinygpt as jtiny
from distributed_llm_training_benchmark_framework_tpu.ops import ulysses_attention as jua
from distributed_llm_training_benchmark_framework_tpu.parallel import make_mesh as jmake_mesh
from distributed_llm_training_benchmark_framework_tpu.parallel import strategies as jstrat
from distributed_llm_training_benchmark_framework_tpu.train.step import _resolve_model_config
from distributed_llm_training_benchmark_framework_tpu.utils import memory as jmemory
from distributed_llm_training_benchmark_framework_tpu.utils import metrics as jmetrics
from distributed_llm_training_benchmark_framework_tpu_torch.models import get_config
from distributed_llm_training_benchmark_framework_tpu_torch.models.tinygpt import (
    reference_attention,
)
from distributed_llm_training_benchmark_framework_tpu_torch.ops import flash_attention as tfa
from distributed_llm_training_benchmark_framework_tpu_torch.ops import ulysses_attention as tua
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import make_mesh
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import strategies as tstrat
from distributed_llm_training_benchmark_framework_tpu_torch.parallel.mesh import Mesh
from distributed_llm_training_benchmark_framework_tpu_torch.train import run_benchmark
from distributed_llm_training_benchmark_framework_tpu_torch.utils import memory as tmemory
from distributed_llm_training_benchmark_framework_tpu_torch.utils import metrics as tmetrics

JAX_CONFIG = {"tinygpt": jtiny.get_model_config, "llama": jllama.get_llama_config}
AXES = ("data", "seq", "model")


def _jmesh(data, model):
    return jmake_mesh((data, 1, model), AXES, devices=jax.devices()[:data * model])


def _jax_shapes(family, tier):
    jc = JAX_CONFIG[family](tier, 64, scan_layers=False)
    return jc, jax.eval_shape(lambda: jtiny.init_params(jc, jax.random.key(0)))


def _flat(tree):
    out = {k: v for k, v in tree.items() if k != "blocks"}
    out.update({f"blocks/{k}": v for k, v in tree["blocks"].items()})
    return out


MESHES = [(1, 2), (2, 2), (4, 2), (1, 8), (2, 4)]


@pytest.mark.parametrize("shard", [False, True])
@pytest.mark.parametrize("data,model", MESHES)
@pytest.mark.parametrize("family,tier", [("tinygpt", "A"), ("llama", "A"), ("llama", "S")])
def test_specs_are_jaxs(family, tier, data, model, shard):
    jc, shapes = _jax_shapes(family, tier)
    want = jstrat.param_partition_specs(shapes, _jmesh(data, model), shard=shard,
                                        kv_heads=jc.kv_heads)
    got = tstrat.param_partition_specs(
        {k: tuple(v.shape) for k, v in _flat(shapes).items()},
        {"data": data, "seq": 1, "model": model}, shard, kv_heads=jc.kv_heads)
    assert got == {k: tuple(v) + (None,) * (len(_flat(shapes)[k].shape) - len(v))
                   for k, v in _flat(want).items()}


@pytest.mark.parametrize("model", [2, 4, 8])
@pytest.mark.parametrize("family", ["tinygpt", "llama"])
def test_tp_axis_is_where_jax_puts_model(family, model):
    """Every port leaf's ``model`` axis (one layer, no layer axis) is JAX's
    (stacked leaves: one more axis); Llama tier A's 4 kv heads keep wkv
    replicated at 8."""
    jc, shapes = _jax_shapes(family, "A")
    specs = _flat(jstrat.param_partition_specs(shapes, _jmesh(1, model), shard=False,
                                               kv_heads=jc.kv_heads))
    cfg = get_config(family, "A", 64)
    with torch.device("meta"):
        from distributed_llm_training_benchmark_framework_tpu_torch.models import TinyGPT
        names = [n for n, _ in TinyGPT(cfg).named_parameters()]
    for name in names:
        leaf = tstrat.jax_leaf_name(name)
        spec = tuple(specs[leaf])
        want = spec.index("model") if "model" in spec else None
        if want is not None and leaf.startswith("blocks/"):
            want -= 1
        assert tstrat.tp_axis(name, cfg.kv_heads, model) == want, name
    assert tstrat.tp_axis("blocks.0.wkv", cfg.kv_heads, 8) is (None if family == "llama" else 2)


def _jax_moment_bytes(jc, jstrategy, jmesh):
    """JAX's optimizer-state bytes less the scalar leaves (optax counters)."""
    opt = jstrat.make_optimizer(jstrategy)
    shapes = jax.eval_shape(lambda: jtiny.init_params(jc, jax.random.key(0)))
    scalars = sum(np.dtype(x.dtype).itemsize for x in
                  jax.tree_util.tree_leaves(jax.eval_shape(opt.init, shapes)) if x.shape == ())
    return jmemory.estimate_hbm(jc, jstrategy, jmesh, 1, 2048).opt_state - scalars


ESTIMATES = [("tinygpt", 1, 2), ("tinygpt", 2, 2), ("llama", 1, 2), ("llama", 2, 2),
             ("llama", 1, 8)]


@pytest.mark.parametrize("arm", sorted(jstrat.STRATEGIES))
@pytest.mark.parametrize("family,data,model", ESTIMATES)
def test_estimate_is_jaxs(family, data, model, arm):
    jstrategy = jstrat.get_strategy(arm)
    jmesh = _jmesh(data, model)
    jcfg = _resolve_model_config(JAX_CONFIG[family]("A", 2048, scan_layers=False), jstrategy,
                                 jmesh)
    want = jmemory.estimate_hbm(jcfg, jstrategy, jmesh, 1, 2048)
    strategy = tstrat.get_strategy(arm)
    got = tmemory.estimate_hbm(get_config(family, "A", 2048, remat=strategy.remat), strategy,
                               Mesh({"data": data, "model": model}), 1, 2048)
    assert (got.params, got.grads, got.activations, got.logits) == (
        want.params, want.grads, want.activations, want.logits)
    assert got.opt_state == _jax_moment_bytes(jcfg, jstrategy, jmesh)


def test_accounting_is_jaxs():
    """dp = world // (tp * sp): a tp group computes one example."""
    for world, tp, sp, dp in ((4, 2, 1, 2), (2, 2, 1, 1), (8, 2, 2, 2), (8, 8, 1, 1)):
        r = tmetrics.compute_result(
            strategy="zero2", world_size=world, seq_len=64, tier="S", steps=2,
            per_device_batch=2, grad_accum=3, step_times=[0.5], losses=[1.0], peak_gb=0.0,
            peak_method="unavailable", sequence_parallel=sp, tensor_parallel=tp)
        assert r.tokens_per_sec * 0.5 == jmetrics.tokens_per_step(2, 3, 64, dp)
        assert world // (tp * sp) == dp and r.tensor_parallel == tp


def test_ulysses_shard_index_is_jaxs():
    """On a (data 2, seq 2, model 2) mesh: JAX's flattening of (batch_axis,
    heads_axis, seq) against the port's, device by device."""
    mesh = jmake_mesh((2, 2, 2), AXES, devices=jax.devices()[:8])
    spec = P(("data", "seq", "model"))
    fn = jax.shard_map(lambda x: x * 0 + jua._global_shard_index(("data", "model", "seq")),
                       mesh=mesh, in_specs=spec, out_specs=spec)
    want = np.asarray(jax.jit(fn)(jnp.zeros(8, jnp.uint32)))
    got = [tua._global_shard_index(r // 2 % 2, 2, r // 4, 2, r % 2, 2) for r in range(8)]
    assert list(want) == got
    # Axes of width 1 are not folded (resolve_seq_mesh names them only when wider).
    assert tua._global_shard_index(1, 2, 0, 1, 1, 1) == 1


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tp", [2, 4])
def test_head_shards_equal_the_whole_layers_rows(tp, causal):
    """At dropout 0.1 and B 2 each shard's global head ids key the hash as
    the whole layer does: flash's plain versions (what every wrapper runs on
    a CPU tensor) and the reference attention, forward."""
    g = torch.Generator().manual_seed(0)
    B, S, H, D = 2, 64, 8, 16
    q, k, v = (torch.randn(B, S, H, D, generator=g) for _ in range(3))
    kw = dict(causal=causal, dropout_rate=0.1, dropout_seed=77, batch_offset=1)
    full = tfa.flash_attention(q, k, v, **kw)
    ref = reference_attention(q, k, v, **kw)
    Hl = H // tp
    for m in range(tp):
        heads = slice(m * Hl, (m + 1) * Hl)
        part = [t[:, :, heads] for t in (q, k, v)]
        shard = dict(kw, head_offset=m * Hl, n_heads=H)
        torch.testing.assert_close(tfa.flash_attention(*part, **shard), full[:, :, heads],
                                   rtol=0, atol=0)
        torch.testing.assert_close(reference_attention(*part, **shard), ref[:, :, heads],
                                   rtol=0, atol=0)


def test_tp_needs_a_group():
    with pytest.raises(ValueError, match=r"tensor parallelism \(model width 2\) needs a "
                                         r"process group .* this process has no group"):
        make_mesh((2,), ("model",))
    with pytest.raises(ValueError, match="needs a process group"):
        run_benchmark(tier="S", seq_len=64, steps=2, warmup_steps=1, device="cpu",
                      tensor_parallel=2)


@pytest.mark.parametrize("family,tp,bad", [("tinygpt", 3, "n_head=4, mlp_dim=512, "
                                                       "vocab_size=512"),
                                           ("llama", 4, "n_head=2"),
                                           ("llama", 64, "n_head=2, mlp_dim=352")])
def test_a_width_that_does_not_split_the_model_is_refused(family, tp, bad):
    """GSPMD pads an uneven split (JAX's tests lay tier S's 4 heads over
    8); the port refuses it, naming what the width does not split."""
    with pytest.raises(ValueError, match=f"not a multiple of {tp}: {bad}$"):
        tstrat.check_tp(get_config(family, "S", 64), tp)


def test_collective_matmul_with_sequence_parallelism_is_refused_with_jaxs_words():
    with pytest.raises(ValueError, match=r"--tp-collective-matmul cannot compose with sequence "
                                         r"parallelism \(both want to own the sequence axis"):
        run_benchmark(tier="S", seq_len=64, steps=2, warmup_steps=1, device="cpu",
                      attention_impl="ring", sequence_parallel=2, tp_collective_matmul=True)


def test_ulysses_splits_the_rank_s_heads():
    """Ulysses divides H/tp heads over seq, as JAX's check sees the local H."""
    with pytest.raises(ValueError, match=r"Ulysses needs heads % seq_parallel == 0, got H=1"):
        tua.check_heads(get_config("llama", "S", 64).n_head // 2, 2)
