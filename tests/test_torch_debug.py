"""Debug mode (``runtime/debug.py``; the harness's ``--debug`` /
``BENCH_DEBUG=1``) against JAX's ``runtime/debug.py``: the same switch,
the strict NCCL settings set in the environment (where the caller has not
set them), and autograd's anomaly mode, under which a NaN made in the
backward raises at the operation that made it, as JAX's NaN check raises
at the primitive. The harness sets it before the process group starts
(``tests/test_torch_harness.py``) and the row carries it."""

import pytest
import torch

from distributed_llm_training_benchmark_framework_tpu.runtime import debug as jdebug
from distributed_llm_training_benchmark_framework_tpu_torch.runtime import debug as tdebug
from distributed_llm_training_benchmark_framework_tpu_torch.utils import metrics as tmetrics


@pytest.fixture
def clean_env(monkeypatch):
    for key in list(tdebug.DEBUG_ENV) + ["BENCH_DEBUG"]:
        # setenv first, so that the undo restores the key's absence too:
        # ``delenv`` of an absent key records nothing, and what
        # ``enable_debug`` sets would outlive the test (a DETAIL debug mode
        # in every later subprocess of the worker, the fake process group of
        # the static audit included, which cannot wrap a ``FakeStore``).
        monkeypatch.setenv(key, "")
        monkeypatch.delenv(key)
    was = torch.is_anomaly_enabled()
    yield monkeypatch
    torch.autograd.set_detect_anomaly(was)


@pytest.mark.parametrize("value", [None, "0", "", "false", "1", "yes"])
def test_bench_debug_switch_is_jaxs(clean_env, value):
    if value is not None:
        clean_env.setenv("BENCH_DEBUG", value)
    assert tdebug.debug_requested() == jdebug.debug_requested()
    assert tdebug.debug_requested() == (value not in (None, "0", "", "false"))


def test_enable_debug_sets_the_environment_and_anomaly_mode(clean_env):
    import os

    clean_env.setenv("TORCH_NCCL_BLOCKING_WAIT", "0")  # the caller's own stays
    tdebug.enable_debug()
    assert os.environ["TORCH_DISTRIBUTED_DEBUG"] == "DETAIL"
    assert os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] == "1"
    assert os.environ["TORCH_NCCL_BLOCKING_WAIT"] == "0"
    assert torch.is_anomaly_enabled()


def test_a_nan_made_in_the_backward_raises_under_debug(clean_env):
    def nan_backward():
        x = torch.zeros(3, requires_grad=True)
        (x.sqrt() * 0.0).sum().backward()  # sqrt's gradient at 0 is inf; inf * 0 = nan
        return x.grad

    assert torch.isnan(nan_backward()).all()  # silent without debug mode
    tdebug.enable_debug()
    with pytest.raises(RuntimeError, match="returned nan values"):
        nan_backward()


def test_the_row_carries_debug_and_the_layer_loop():
    kw = dict(strategy="zero2", world_size=1, seq_len=64, tier="S", steps=2,
              per_device_batch=1, grad_accum=1, step_times=[0.5], losses=[1.0], peak_gb=0.0,
              peak_method="unavailable")
    row = tmetrics.compute_result(**kw)
    assert (row.debug, row.layer_loop) == (False, "unrolled")
    row = tmetrics.compute_result(debug=True, layer_loop="scan", **kw)
    assert (row.debug, row.layer_loop) == (True, "scan")
