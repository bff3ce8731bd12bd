"""The port's loop, bench entry, accounting and import boundary, on the CPU."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from distributed_llm_training_benchmark_framework_tpu.models import llama as jllama
from distributed_llm_training_benchmark_framework_tpu.models import tinygpt as jtiny
from distributed_llm_training_benchmark_framework_tpu.utils import flops as jflops
from distributed_llm_training_benchmark_framework_tpu.utils import metrics as jmetrics
from distributed_llm_training_benchmark_framework_tpu_torch.models import get_config
from distributed_llm_training_benchmark_framework_tpu_torch.train import run_benchmark
from distributed_llm_training_benchmark_framework_tpu_torch.utils import flops as tflops
from distributed_llm_training_benchmark_framework_tpu_torch.utils import metrics as tmetrics
from distributed_llm_training_benchmark_framework_tpu_torch.utils import platform as tplatform
from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
PKG = "distributed_llm_training_benchmark_framework_tpu_torch"
JAX_PKG = "distributed_llm_training_benchmark_framework_tpu"
BENCH = [sys.executable, "-m", f"{PKG}.bench"]
SMALL = ["--tier", "S", "--seq-len", "64", "--steps", "3", "--warmup-steps", "1"]


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", **kw)
    return env


def test_run_benchmark_cpu_tier_s():
    r = run_benchmark(tier="S", seq_len=64, steps=3, warmup_steps=1, device="cpu",
                      sync_every=1)
    assert r.tokens_per_sec > 0 and r.steps == 3 and r.device_kind == "cpu"
    assert r.loss_first_window > 0 and torch.isfinite(torch.tensor(r.mean_loss))
    assert r.peak_hbm_method == "unavailable" and r.mfu_pct == 0.0
    assert r.attention_impl == "flash" and r.dropout == 0.1
    with pytest.raises(ValueError):
        run_benchmark(tier="S", seq_len=64, steps=1, warmup_steps=1, device="cpu")


def test_run_benchmark_writes_result_file_and_markers(tmp_path, capsys):
    r = run_benchmark(tier="S", seq_len=64, steps=2, warmup_steps=1, device="cpu",
                      model_family="llama", results_dir=str(tmp_path))
    path = tmp_path / "result_zero2_ws1_seq64_tierS_llama.json"
    assert json.loads(path.read_text())["tokens_per_sec"] == r.tokens_per_sec
    out = capsys.readouterr().out
    block = out.split(tmetrics.MARKER_START, 1)[1].split(tmetrics.MARKER_END, 1)[0]
    assert json.loads(block)["model_family"] == "llama"
    assert tmetrics.MARKER_START == jmetrics.MARKER_START
    assert tmetrics.MARKER_END == jmetrics.MARKER_END


def test_bench_cpu_prints_one_contract_line():
    proc = subprocess.run(BENCH + ["--device", "cpu"] + SMALL, capture_output=True,
                          text=True, env=_env(), timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, proc.stdout
    row = json.loads(lines[0])
    assert row["metric"] == "tinygpt_tierS_seq64_tokens_per_sec_per_chip"
    for key in ("value", "unit", "vs_baseline", "attention_impl", "dropout", "mfu_pct",
                "peak_hbm_gb", "peak_hbm_method", "flagship"):
        assert key in row, key
    assert row["vs_baseline"] == pytest.approx(row["value"] / 4536.75, abs=1e-3)
    flag = row["flagship"]
    assert flag["metric"] == "llama_tierS_seq64_tokens_per_sec_per_chip"
    assert (flag["per_device_batch"], flag["grad_accum"], flag["dropout"]) == (2, 2, 0.0)


def test_bench_without_device_refuses_cpu_fallback():
    proc = subprocess.run(BENCH + SMALL + ["--skip-preflight"], capture_output=True,
                          text=True, timeout=300, env=_env(CUDA_VISIBLE_DEVICES=""), cwd=REPO)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_resolve_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tplatform.resolve_device(None)
    with pytest.raises(RuntimeError):
        tplatform.resolve_device("cuda")
    assert tplatform.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("tier", ["A", "B", "S"])
@pytest.mark.parametrize("family", ["tinygpt", "llama"])
def test_flops_identical_to_jax(family, tier):
    jc = (jtiny.get_model_config if family == "tinygpt" else jllama.get_llama_config)(tier, 2048)
    tc = get_config(family, tier, 2048)
    assert tflops.forward_flops_per_token(tc) == jflops.forward_flops_per_token(jc)
    assert tflops.train_flops_per_token(tc) == jflops.train_flops_per_token(jc)


def test_peaks_and_slugs():
    assert tflops.device_peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert tflops.device_peak_tflops("NVIDIA H100 PCIe") == 756.0
    assert tplatform.device_peak_hbm_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    assert tplatform.device_peak_hbm_gbps("NVIDIA H100 PCIe") == 2000.0
    assert tflops.device_peak_tflops("cpu") is None
    assert tflops.device_peak_tflops("TPU v5 lite") is None
    for fam in ("tinygpt", "llama"):
        assert tmetrics.arm_slug("zero2", 1, 2048, "A", fam) == jmetrics.arm_slug(
            "zero2", 1, 2048, "A", fam)
    assert tmetrics.tokens_per_step(2, 2, 2048, 1) == jmetrics.tokens_per_step(2, 2, 2048, 1)


def test_package_imports_with_jax_blocked():
    """Every module of the port imports with jax, optax and the JAX package
    made unimportable."""
    code = (
        "import sys, importlib, pkgutil\n"
        f"for m in ('jax', 'optax', 'flax', '{JAX_PKG}'):\n"
        "    sys.modules[m] = None\n"
        f"import {PKG} as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=_env(), timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.strip()) >= 15


def test_no_port_file_imports_jax_or_the_jax_package():
    files = sorted((REPO / PKG).rglob("*.py")) + [REPO / "chip_smoke.py"]
    banned = ("jax", "optax", "flax", JAX_PKG)
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in banned, f"{f}: imports {m}"
