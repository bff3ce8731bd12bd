"""The port's memory anatomy against JAX's.

``reconcile``, ``result_fields``, ``reconcile_from_result_row`` and the
``--result`` CLI are JAX's: on the same estimate bytes, compile-time
accounting and measured peak (seeded) they give JAX's output exactly. The
sources differ by design: eager PyTorch has no compile-time accounting
(``compile_memory_fields`` is None, ``xla_temp`` stays 0) and the measured
peak is the CUDA allocator's, null with JAX's reason on the CPU. The row
maps the fields as JAX's ``compute_result`` does, refuses unknown keys,
and ``analysis.ATTRIBUTION_CLASSES`` is the module's one definition.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from distributed_llm_training_benchmark_framework_tpu.analysis import (
    memory_anatomy as jmem,
)
from distributed_llm_training_benchmark_framework_tpu.utils import memory as jmemory
from distributed_llm_training_benchmark_framework_tpu.utils import metrics as jmetrics
from distributed_llm_training_benchmark_framework_tpu_torch import analysis as tanalysis
from distributed_llm_training_benchmark_framework_tpu_torch.analysis import (
    make_report as treport,
    memory_anatomy as tmem,
    validate_results as tvalid,
)
from distributed_llm_training_benchmark_framework_tpu_torch.utils import memory as tmemory
from distributed_llm_training_benchmark_framework_tpu_torch.utils import metrics as tmetrics

sys.path.insert(0, os.path.dirname(__file__))
from torch_threads import one_thread  # noqa: E402,F401  (autouse)

GIB = 1024**3


def _estimate(seed):
    """Seeded per-class bytes of a plausible arm (0.1-12 GiB each)."""
    rng = np.random.default_rng(seed)
    b = [int(x) for x in rng.integers(GIB // 10, 12 * GIB, 6)]
    return (tmemory.HBMEstimate(*b), jmemory.HBMEstimate(*b))


def _sources(seed, measured, compiled):
    rng = np.random.default_rng(1000 + seed)
    est = _estimate(seed)[0]
    m = int(est.total * rng.uniform(0.7, 1.4)) if measured else None
    cm = None
    if compiled:
        temp = int(rng.integers(GIB, 40 * GIB))
        cm = {"argument_bytes": int(rng.integers(GIB, 9 * GIB)), "output_bytes": GIB // 3,
              "temp_bytes": temp, "alias_bytes": GIB // 5,
              "peak_bytes": int(rng.integers(5 * GIB, 60 * GIB))}
    return m, cm


CASES = [(seed, measured, compiled) for seed in range(3) for measured in (False, True)
         for compiled in (False, True)]


@pytest.mark.parametrize("seed,measured,compiled", CASES)
def test_reconcile_and_result_fields_equal_jax(seed, measured, compiled):
    test, jest = _estimate(seed)
    m, cm = _sources(seed, measured, compiled)
    reason = "allocator" if measured else "backend exposes no memory_stats()"
    port = tmem.reconcile(test, compile_mem=cm, measured_bytes=m, measured_reason=reason)
    jax = jmem.reconcile(jest, compile_mem=cm, measured_bytes=m, measured_reason=reason)
    assert port == jax
    assert sum(port["attribution_bytes"].values()) == port["reference_bytes"]
    fields = tmem.result_fields(port, est_breakdown=test.breakdown())
    assert fields == jmem.result_fields(jax, est_breakdown=jest.breakdown())
    assert tmem.format_report(port).splitlines()[0] == jmem.format_report(jax).splitlines()[0]
    # Offline: the stored row rebuilds the same books on both sides.
    row = dict(fields)
    assert tmem.reconcile_from_result_row(row) == jmem.reconcile_from_result_row(row)


@pytest.mark.parametrize("seed", range(3))
def test_result_cli_equals_jax(seed, tmp_path, capsys):
    test, _ = _estimate(seed)
    m, _ = _sources(seed, True, False)
    fields = tmem.result_fields(tmem.reconcile(test, measured_bytes=m),
                                est_breakdown=test.breakdown())
    path = tmp_path / "result_x.json"
    path.write_text(json.dumps(fields))
    outs = []
    for mod in (jmem, tmem):
        assert mod.main(["--result", str(path), "--json"]) == 0
        outs.append(json.loads(capsys.readouterr().out))
    assert outs[0] == outs[1]
    (tmp_path / "old.json").write_text("{}")
    assert tmem.main(["--result", str(tmp_path / "old.json")]) == 1
    assert tmem.main(["--result", str(tmp_path / "none.json")]) == 2


def test_sources_of_the_port():
    assert tmem.compile_memory_fields() is None
    assert tmem.measured_peak_bytes(device=torch.device("cpu")) == (
        None, "backend exposes no memory_stats()")
    if not torch.cuda.is_initialized():
        assert tmem.measured_peak_bytes() == (None, "backend exposes no memory_stats()")
    assert tanalysis.ATTRIBUTION_CLASSES is tmem.ATTRIBUTION_CLASSES == jmem.ATTRIBUTION_CLASSES
    assert treport._HBM_CLASSES is tmem.ATTRIBUTION_CLASSES


def test_shared_process_guard_is_jaxs(monkeypatch):
    """The allocator's mark must rise above what the arm held when its peak
    was reset; otherwise the measurement is null with JAX's reason."""
    monkeypatch.setattr(tmetrics, "peak_hbm_bytes", lambda: 5 * GIB)
    assert tmem.measured_peak_bytes(4 * GIB) == (5 * GIB, "allocator")
    assert tmem.measured_peak_bytes(None) == (5 * GIB, "allocator")
    got, reason = tmem.measured_peak_bytes(5 * GIB)
    assert got is None and "predates this arm" in reason
    monkeypatch.setattr(jmetrics, "peak_hbm_bytes", lambda: 5 * GIB)
    assert jmem.measured_peak_bytes(5 * GIB) == (got, reason)
    # An earlier arm's live tensors are not this arm's: the port takes them off.
    assert tmem.measured_peak_bytes(4 * GIB, held_bytes=GIB) == (4 * GIB, "allocator")


def _row(mod, **over):
    kw = dict(strategy="zero2", world_size=1, seq_len=128, tier="S", steps=10,
              per_device_batch=2, grad_accum=1, step_times=[0.1] * 8, losses=[5.0] * 8)
    kw.update(over)
    if mod is tmetrics:
        return mod.compute_result(peak_gb=0.0, peak_method="unavailable", **kw)
    return mod.compute_result(rank=0, **kw)


@pytest.mark.parametrize("measured", [False, True], ids=["cpu", "card"])
def test_compute_result_maps_memory_fields_as_jax(measured):
    test, _ = _estimate(7)
    m, _ = _sources(7, measured, False)
    reason = "allocator" if measured else "backend exposes no memory_stats()"
    fields = tmem.result_fields(tmem.reconcile(test, measured_bytes=m, measured_reason=reason),
                                est_breakdown=test.breakdown())
    port = _row(tmetrics, memory_anatomy=dict(fields)).to_dict()
    jax = _row(jmetrics, memory_anatomy=dict(fields)).to_dict()
    for k in tmetrics.MEMORY_ANATOMY_FIELDS:
        assert port[k] == jax[k] == fields[k], k
    assert [k for k in port if k in fields] == list(fields)
    bad = [f for f in tvalid.validate_result(port, "row") if "hbm_" in f]
    assert bad == []
    with pytest.raises(ValueError, match="unknown memory_anatomy keys"):
        _row(tmetrics, memory_anatomy={"hbm_bogus": 1.0})
    empty = _row(tmetrics).to_dict()
    assert (empty["hbm_attribution"], empty["hbm_measured_reason"]) == (None, "")
