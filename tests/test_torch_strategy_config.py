"""The port's strategy-config loaders against the JAX package's.

``load_strategy_config`` over every ``configs/strategies/*.json`` and over
files that change one field at a time, and ``from_deepspeed_config`` /
``is_deepspeed_config`` over a table of DeepSpeed dicts: the port gives the
same ``StrategyConfig``, field by field, or the same ``ValueError`` message
as JAX. Every loaded arm passes the port's ``check_ported`` (JAX loads no
arm the port cannot run).
"""

import dataclasses
import json
import re
from pathlib import Path

import pytest

from distributed_llm_training_benchmark_framework_tpu.parallel import strategies as jstrat
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import strategies as tstrat

CONFIGS = sorted((Path(__file__).resolve().parents[1] / "configs" / "strategies").glob("*.json"))
FIELDS = [f.name for f in dataclasses.fields(jstrat.StrategyConfig)]


def _same(port, jax_arm):
    for f in FIELDS:
        assert getattr(port, f) == getattr(jax_arm, f), f


def _same_outcome(port_call, jax_call):
    """Both return equal configs, or both raise ValueError with one message."""
    try:
        want = jax_call()
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            port_call()
        return None
    got = port_call()
    _same(got, want)
    return got


def test_every_config_file_is_read():
    assert [p.stem for p in CONFIGS] == ["ddp", "fsdp", "zero2", "zero3"]


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_load_strategy_config_equals_jaxs(path):
    got = _same_outcome(lambda: tstrat.load_strategy_config(str(path)),
                        lambda: jstrat.load_strategy_config(str(path)))
    _same(got, tstrat.get_strategy(path.stem))  # the files are the table's arms
    tstrat.check_ported(got)


@pytest.mark.parametrize("change", [
    {"param_dtype": "bf16"}, {"param_dtype": "f16"}, {"offload_opt_state": True},
    {"remat": True}, {"remat": False}, {"remat": "dots"}, {"remat": "bogus"},
    {"strategy": "custom"}, {"strategy": None}, {"grad_clip": None},
    {"optimizer": {"lr": 3e-4, "betas": [0.8, 0.95]}}, {"scheduler": {"warmup_steps": 2}},
    {"sharding": {"params": True}}, {"precision": "f32"},
])
def test_load_strategy_config_field_by_field(tmp_path, change):
    raw = json.loads((CONFIGS[2]).read_text())  # zero2
    raw.update(change)
    path = tmp_path / "arm.json"
    path.write_text(json.dumps(raw))
    _same_outcome(lambda: tstrat.load_strategy_config(str(path)),
                  lambda: jstrat.load_strategy_config(str(path)))


DEEPSPEED = {
    "zero2_full": ("zero2", {
        "train_micro_batch_size_per_gpu": 4, "gradient_clipping": 0.5, "bf16": {"enabled": True},
        "optimizer": {"type": "AdamW", "params": {"lr": 3e-4, "betas": [0.8, 0.99], "eps": 1e-6,
                                                  "weight_decay": 0.1}},
        "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 7}},
        "zero_optimization": {"stage": 2}}),
    "auto_fields": ("zero2", {
        "gradient_clipping": "auto", "optimizer": {"type": "Adam", "params": {
            "lr": "auto", "betas": "auto", "eps": "auto", "weight_decay": "auto"}},
        "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": "auto"}}}),
    "clipping_0": ("zero3", {"gradient_clipping": 0}),
    "stage_mismatch": ("zero3", {"zero_optimization": {"stage": 2}}),
    "stage_for_ddp": ("ddp", {"zero_optimization": {"stage": 3}}),
    "sgd": ("zero2", {"optimizer": {"type": "SGD", "params": {"lr": 0.1}}}),
    "non_numeric_lr": ("zero2", {"optimizer": {"params": {"lr": "fast"}}}),
    "non_numeric_stage": ("zero2", {"zero_optimization": {"stage": "two"}}),
    "bad_betas": ("zero2", {"optimizer": {"params": {"betas": [0.9]}}}),
    "params_not_object": ("zero2", {"optimizer": {"params": [1e-4]}}),
    "sched_params_not_object": ("zero2", {"scheduler": {"params": 5}}),
    "other_scheduler": ("zero2", {"scheduler": {"type": "OneCycle",
                                                "params": {"warmup_num_steps": 9}}}),
    "offload_cpu": ("zero3", {"zero_optimization": {"stage": 3,
                                                    "offload_optimizer": {"device": "cpu"}}}),
    "offload_nvme": ("zero2", {"zero_optimization": {"offload_optimizer": {"device": "nvme"}}}),
    "offload_none": ("zero3", {"zero_optimization": {"offload_optimizer": {"device": "none"}}}),
    "offload_absent": ("zero3", {"zero_optimization": {"stage": 3}}),
    "offload_no_device": ("zero3", {"zero_optimization": {"offload_optimizer": {}}}),
    "bf16_shorthand": ("zero2", {"bf16": True}),
    "fp16_enabled": ("ddp", {"fp16": {"enabled": True}, "train_batch_size": 8}),
}


@pytest.mark.parametrize("case", sorted(DEEPSPEED))
def test_from_deepspeed_config_equals_jaxs(case):
    arm, raw = DEEPSPEED[case]
    assert tstrat.is_deepspeed_config(raw) == jstrat.is_deepspeed_config(raw)
    got = _same_outcome(lambda: tstrat.from_deepspeed_config(raw, arm),
                        lambda: jstrat.from_deepspeed_config(raw, arm))
    if got is not None:
        tstrat.check_ported(got)
    if case.startswith("offload_"):
        assert got.offload_opt_state == (case in ("offload_cpu", "offload_nvme"))


@pytest.mark.parametrize("raw", [
    {}, {"strategy": "zero2", "gradient_clipping": 1.0}, {"gradient_clipping": 1.0},
    {"train_micro_batch_size_per_gpu": 1}, {"bf16": {"enabled": False}}, {"fp16": {}},
    {"zero_optimization": {}}, {"optimizer": {}}, [], "zero2", None,
])
def test_is_deepspeed_config_equals_jaxs(raw):
    assert tstrat.is_deepspeed_config(raw) == jstrat.is_deepspeed_config(raw)
