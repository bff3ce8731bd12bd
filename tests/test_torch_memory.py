"""The port's memory model (``utils/memory.py``).

- At one device its activation and logits terms are the JAX package's
  (``utils/memory.estimate_hbm``), for both families, every arm and both
  attention paths that keep O(S) or O(S^2) per layer.
- At two gloo ranks its parameter, gradient and AdamW-moment bytes are
  what rank 0 of each arm really holds after a step (unique storages of
  its params, grads and moments; ``tests/test_torch_arms_worker.py``), at
  f32 and bf16 parameters and under host offload (no moments on the
  device).
- ``resolve_auto_remat`` walks none -> dots -> full and stops at the first
  policy that fits 70% of the card, at capacities worked out by hand; on
  an H100 80 GB it resolves zero3 at the parity row to a policy that
  ``check_fits`` passes.
"""

import dataclasses
import json

import jax
import pytest

from distributed_llm_training_benchmark_framework_tpu.models import llama as jllama
from distributed_llm_training_benchmark_framework_tpu.models import tinygpt as jtiny
from distributed_llm_training_benchmark_framework_tpu.parallel import make_mesh as jmake_mesh
from distributed_llm_training_benchmark_framework_tpu.parallel import strategies as jstrat
from distributed_llm_training_benchmark_framework_tpu.train.step import _resolve_model_config
from distributed_llm_training_benchmark_framework_tpu.utils import memory as jmemory
from distributed_llm_training_benchmark_framework_tpu_torch.models import get_config
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import make_mesh
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import strategies as tstrat
from distributed_llm_training_benchmark_framework_tpu_torch.train.loop import DATASET_SIZE
from distributed_llm_training_benchmark_framework_tpu_torch.utils import memory as tmemory

from test_torch_arms_worker import spawn_ranks, wait_ranks

JAX_CONFIG = {"tinygpt": jtiny.get_model_config, "llama": jllama.get_llama_config}
H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("impl", ["flash", "reference"])
@pytest.mark.parametrize("arm", sorted(jstrat.STRATEGIES))
@pytest.mark.parametrize("family", ["tinygpt", "llama"])
def test_activation_and_logits_terms_are_jaxs(family, arm, impl):
    jstrategy = jstrat.get_strategy(arm)
    jmesh = jmake_mesh((1,), ("data",), devices=jax.devices()[:1])
    jcfg = _resolve_model_config(JAX_CONFIG[family]("A", 2048, attention_impl=impl),
                                 jstrategy, jmesh)
    want = jmemory.estimate_hbm(jcfg, jstrategy, jmesh, 2, 2048)
    strategy = tstrat.get_strategy(arm)
    got = tmemory.estimate_hbm(get_config(family, "A", 2048, attention_impl=impl,
                                          remat=strategy.remat),
                               strategy, make_mesh(), 2, 2048)
    assert (got.activations, got.logits) == (want.activations, want.logits)


def test_state_bytes_are_what_rank0_holds(tmp_path):
    """Every arm and family at f32 and bf16 parameters and under host
    offload (``.bf16``, ``.offload``), over two gloo ranks."""
    wait_ranks(spawn_ranks(2, "-", tmp_path / "held", "bytes"))
    held = json.loads((tmp_path / "held.rank0.json").read_text())
    assert len(held) == 24
    for key, r in held.items():
        assert r["held"] == r["estimate"], key
    # zero2 holds the flat gradient buffer and the shard it is reduced into.
    p, g, m = held["tinygpt.zero2"]["held"]
    assert g == p + p // 2 and m == p
    for family in ("tinygpt", "llama"):
        for arm in ("ddp", "fsdp", "zero2", "zero3"):
            f32 = held[f"{family}.{arm}"]["held"]
            # bf16 halves params, grads and moments; offload also drops the moments.
            assert held[f"{family}.{arm}.bf16"]["held"] == [b // 2 for b in f32], (family, arm)
            assert held[f"{family}.{arm}.offload"]["held"] == [f32[0] // 2, f32[1] // 2, 0]


def _parity_row(**kw):
    return get_config("tinygpt", "A", 2048, attention_impl="flash", **kw)


def test_resolve_auto_remat_walks_none_dots_full(monkeypatch):
    """Tier A TinyGPT, S 2048, b1, bf16, flash, one device. Per layer the dense
    term is (10 + 4) * 2048 * 1024 * 2 bytes = 58,720,256; over 16 layers
    "none" keeps all of it, "dots" 16 * 11 * 2048 * 1024 * 2 + one layer's
    = 796,917,760, "full" 16 * 2 * 2048 * 1024 * 2 + one layer's =
    192,937,984. The rest (params, grads, moments, logits, table) is the
    same for every policy."""
    strategy, mesh = tstrat.get_strategy("zero3"), make_mesh()
    cfg = _parity_row()
    base = tmemory.estimate_hbm(cfg, dataclasses.replace(strategy, remat="none"), mesh, 1,
                                2048, DATASET_SIZE)
    act = {"none": 16 * 58_720_256, "dots": 796_917_760, "full": 192_937_984}
    assert base.activations == act["none"]
    rest = base.total - base.activations
    for pol, want in (("none", "none"), ("dots", "dots"), ("full", "full")):
        # A card on which `pol` just stays under 70% and every policy that
        # keeps more does not.
        cap = int((rest + act[pol]) / 0.70) + 1
        monkeypatch.setattr(tmemory, "_HBM_BYTES", (("test card", cap),))
        got = tmemory.resolve_auto_remat(cfg, strategy, mesh, 1, 2048, DATASET_SIZE,
                                         "test card")
        assert got.remat == want, (pol, cap)
    monkeypatch.setattr(tmemory, "_HBM_BYTES", (("test card", rest),))
    assert tmemory.resolve_auto_remat(cfg, strategy, mesh, 1, 2048, DATASET_SIZE,
                                      "test card").remat == "full"  # nothing fits
    assert tmemory.resolve_auto_remat(cfg, strategy, mesh, 1, 2048, DATASET_SIZE,
                                      "cpu").remat == "none"
    zero2 = tstrat.get_strategy("zero2")
    assert tmemory.resolve_auto_remat(cfg, zero2, mesh, 1, 2048, DATASET_SIZE, "x") is zero2


def test_zero3_at_the_parity_row_fits_an_h100():
    assert tmemory.device_hbm_bytes(H100) == 80 * 10**9
    strategy = tstrat.get_strategy("zero3")
    got = tmemory.resolve_auto_remat(_parity_row(dropout=0.1), strategy, make_mesh(), 1, 2048,
                                     DATASET_SIZE, H100)
    est = tmemory.estimate_hbm(_parity_row(dropout=0.1, remat=got.remat), got, make_mesh(), 1,
                               2048, DATASET_SIZE)
    assert got.remat in ("none", "dots", "full")
    assert tmemory.check_fits(est, H100) is None
    assert tmemory.check_fits(dataclasses.replace(est, activations=80 * 10**9), H100)


def test_format_breakdown_is_jaxs():
    est = tmemory.HBMEstimate(1, 2, 3, 4, 5, 6)
    jest = jmemory.HBMEstimate(1, 2, 3, 4, 5, 6)
    assert tmemory.format_breakdown(est, "cpu") == jmemory.format_breakdown(jest, "cpu")
    assert est.breakdown() == jest.breakdown()
