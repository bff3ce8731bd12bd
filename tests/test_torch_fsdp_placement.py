"""FSDP2's placement by JAX's rule (``parallel/strategies.fsdp_data_axis``,
``_fully_shard``) and the GC110 growth laws it keeps.

FSDP2 used to shard every leaf on dim 0, padded to a multiple of the
``data`` width: at tier S (dim 0 of 3, 64, 128 or 512) the padded
all-gather and reduce-scatter buffers grew with the width, and so did the
per-rank temps of ``fsdp-dp8`` (+15.5% from world 64 to 256). Each leaf
now shards on the axis JAX's ``param_partition_specs`` puts ``data`` on,
and a leaf it leaves replicated stays whole (``ignored_params``). Held:

- the memory audit over ``fsdp-dp8`` and ``zero3-dp8`` at worlds 64 and
  256 exits 0 (temps flat, the sharded state shrinking);
- the shrink law: the whole state shrinks between tiers that replicate
  nothing; where a tier replicates, the replicated state equals what JAX's
  specs leave whole, and the sharded rest is above 0 and shrinks;
- rank 0's local shapes under a fake group equal its shards of JAX's
  specs (the JAX package's ``param_partition_specs``) on ``data``, and on
  ``model`` for the composed llama arm; the leaves JAX replicates are whole,
  plain tensors, flagged ``data_replicated`` for the clip.
"""

import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import pytest
import torch
from torch.distributed.tensor import DTensor

from distributed_llm_training_benchmark_framework_tpu.parallel import strategies as jstrat
from distributed_llm_training_benchmark_framework_tpu_torch.analysis.static import (
    collective_audit,
)
from distributed_llm_training_benchmark_framework_tpu_torch.models import TinyGPT
from distributed_llm_training_benchmark_framework_tpu_torch.parallel.strategies import (
    jax_leaf_name,
)
from distributed_llm_training_benchmark_framework_tpu_torch.train.loop import build_run

from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
# (strategy, family, world, tensor_parallel)
LAYOUTS = [("fsdp", "tinygpt", 8, 1), ("zero3", "tinygpt", 256, 1), ("fsdp", "tinygpt", 3, 1),
           ("fsdp", "llama", 8, 2)]


def test_memory_audit_holds_its_growth_laws_at_worlds_64_and_256():
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_llm_training_benchmark_framework_tpu_torch.analysis"
         ".static", "--memory", "--topology", "world-64,world-256", "--arms",
         "fsdp-dp8,zero3-dp8"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "growth-law" not in proc.stderr
    assert ", 0 finding(s)" in proc.stderr


def _tiers(*entries):
    return {t: {"fsdp-dp8": {"temp_bytes": 100, "argument_bytes": a, "replicated_bytes": r,
                             "expected_replicated_bytes": x}}
            for t, (a, r, x) in zip(("world-16", "world-64", "world-256"), entries)}


@pytest.mark.parametrize("entries,found", [
    # world-256 replicates what JAX's specs leave whole; the rest shrinks.
    (((400, 0, 0), (100, 0, 0), (2000, 1960, 1960)), []),
    # The whole state must shrink where nothing is replicated.
    (((400, 0, 0), (400, 0, 0)), ["did not shrink"]),
    # Every leaf left whole: more than the specs say, and nothing sharded.
    (((400, 0, 0), (100, 0, 0), (2000, 2000, 1960)), ["departs from JAX's rule",
                                                      "did not shrink"]),
    # The replicated part as JAX's, but the sharded rest grew.
    (((400, 0, 0), (100, 0, 0), (2100, 1960, 1960)), ["did not shrink"]),
])
def test_shrink_law_holds_the_replicated_state_to_jaxs_specs(entries, found):
    got = collective_audit.memory_growth_law_findings(_tiers(*entries))
    assert len(got) == len(found) and all(f in g for f, g in zip(found, got)), got


@pytest.mark.parametrize("strategy,family,world,tp", LAYOUTS)
def test_local_shapes_are_shards_of_jaxs_specs(strategy, family, world, tp):
    with collective_audit.fake_group(world, 0):
        run = build_run(strategy=strategy, tier="S", seq_len=64, model_family=family,
                        per_device_batch=1, grad_accum=1, device="cpu", world_size=world,
                        tensor_parallel=tp, dataset_size=16)
        model, opt = run.model, run.step_fn.optimizer
        cfg = model.config
        with torch.device("meta"):
            whole = dict(TinyGPT(cfg).named_parameters())
        tree = {"blocks": {}}
        for name, p in whole.items():
            leaf = jax_leaf_name(name)
            if leaf.startswith("blocks/"):
                tree["blocks"][leaf[7:]] = jax.ShapeDtypeStruct((cfg.n_layer, *p.shape),
                                                                "float32")
            else:
                tree[leaf] = jax.ShapeDtypeStruct(tuple(p.shape), "float32")
        widths = {"data": world // tp, "model": tp}
        specs = jstrat.param_partition_specs(tree, SimpleNamespace(shape=widths), True,
                                             kv_heads=cfg.kv_heads)
        replicated = dict(zip([n for n, _ in model.named_parameters()], opt.data_replicated))
        kept = 0
        for name, p in model.named_parameters():
            leaf = jax_leaf_name(name)
            spec = tuple(specs["blocks"][leaf[7:]])[1:] if leaf.startswith("blocks/") else \
                tuple(specs[leaf])
            spec = spec + (None,) * (p.dim() - len(spec))
            want = []
            for n, ax in zip(whole[name].shape, spec):
                if ax == "model":
                    n //= tp
                elif ax == "data":
                    n = -(-n // widths["data"])  # rank 0's chunk
                want.append(n)
            local = p.to_local() if isinstance(p, DTensor) else p
            assert list(local.shape) == want, (name, spec)
            assert replicated[name] == ("data" not in spec), name
            assert isinstance(p, DTensor) == ("data" in spec), name
            kept += "data" not in spec
        assert kept == sum(opt.data_replicated)
        if (strategy, world) == ("zero3", 256):
            assert replicated["blocks.0.wqkv"] and not replicated["wte"]
