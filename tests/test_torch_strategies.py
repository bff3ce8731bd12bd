"""The port's strategy table, its descriptions, its remat policies and its
refusals, against the JAX package's (``parallel/strategies.py``,
``models/tinygpt.normalize_remat``)."""

import dataclasses

import pytest
import torch

from distributed_llm_training_benchmark_framework_tpu.models import tinygpt as jtiny
from distributed_llm_training_benchmark_framework_tpu.parallel import strategies as jstrat
from distributed_llm_training_benchmark_framework_tpu_torch.models import TinyGPT, get_config
from distributed_llm_training_benchmark_framework_tpu_torch.models import tinygpt as ttiny
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import make_mesh
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import strategies as tstrat
from distributed_llm_training_benchmark_framework_tpu_torch.train import run_benchmark

FIELDS = [f.name for f in dataclasses.fields(jstrat.StrategyConfig)]


def test_strategy_fields_are_jaxs():
    assert [f.name for f in dataclasses.fields(tstrat.StrategyConfig)] == FIELDS


@pytest.mark.parametrize("arm", sorted(jstrat.STRATEGIES))
def test_strategies_equal_jaxs_field_by_field(arm):
    assert sorted(tstrat.STRATEGIES) == sorted(jstrat.STRATEGIES)
    port, jax_arm = tstrat.get_strategy(arm), jstrat.get_strategy(arm)
    for f in FIELDS:
        assert getattr(port, f) == getattr(jax_arm, f), f


@pytest.mark.parametrize("change", [
    {}, {"remat": "dots"}, {"remat": "full"}, {"param_dtype": "bf16"},
    {"offload_opt_state": True}, {"offload_delayed_update": True},
    {"shard_params": True, "remat": "auto", "param_dtype": "bf16"},
])
@pytest.mark.parametrize("arm", sorted(jstrat.STRATEGIES))
def test_describe_equals_jaxs(arm, change):
    port = dataclasses.replace(tstrat.get_strategy(arm), **change)
    jax_arm = dataclasses.replace(jstrat.get_strategy(arm), **change)
    assert port.describe() == jax_arm.describe()


@pytest.mark.parametrize("value", [True, False, "none", "dots", "full", "auto", "bogus",
                                   None, 1, 0, "Full"])
def test_normalize_remat_accepts_and_refuses_what_jax_does(value):
    try:
        want = jtiny.normalize_remat(value)
    except ValueError:
        with pytest.raises(ValueError, match="invalid remat policy"):
            ttiny.normalize_remat(value)
    else:
        assert ttiny.normalize_remat(value) == want
    assert ttiny.REMAT_POLICIES == jtiny.REMAT_POLICIES


@pytest.mark.parametrize("change,match", [
    ({"offload_opt_state": True}, "ROADMAP Queue 1 item 10"),
    ({"offload_delayed_update": True}, "ROADMAP Queue 1 item 10"),
    ({"param_dtype": "bf16"}, "ROADMAP Queue 1 item 0"),
    ({"shard_params": True, "shard_grads": False}, "none of ddp's"),
])
def test_unported_arms_are_refused(change, match):
    strat = dataclasses.replace(tstrat.get_strategy("zero2"), **change)
    model = TinyGPT(get_config("tinygpt", "S", 64))
    with pytest.raises(ValueError, match=match):
        tstrat.apply_strategy(model, strat, make_mesh())
    with pytest.raises(ValueError, match=match):
        run_benchmark(strategy=strat, tier="S", seq_len=64, steps=2, warmup_steps=1,
                      device="cpu")


@pytest.mark.parametrize("arm", sorted(tstrat.STRATEGIES))
def test_without_a_group_an_arm_is_its_recipe_on_the_plain_model(arm):
    model = TinyGPT(get_config("tinygpt", "S", 64))
    got, opt = tstrat.apply_strategy(model, tstrat.get_strategy(arm), make_mesh())
    assert got is model and type(opt) is tstrat.Optimizer and opt.norm_group is None
    assert all(type(p) is torch.nn.Parameter for p in model.parameters())
