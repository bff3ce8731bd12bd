"""Benchmark result row and its stdout-marker export.

Port of the subset of ``distributed_llm_training_benchmark_framework_tpu/utils/metrics.py``
that the bench row reads: ``arm_slug``, ``tokens_per_step``,
``BenchmarkResult``, ``compute_result`` and the
``BENCHMARK_RESULT_JSON_START`` / ``_END`` emission. The field names are
the JAX package's, so ``analysis/validate_results.py`` checks a port row as
it checks a JAX one; ``h2d_gbps_per_gpu`` is the reference's fp32
transfer proxy, ``batch*accum*seq*4`` bytes per step time. Peak device memory is
``torch.cuda.max_memory_allocated`` (``peak_hbm_method =
"torch_cuda_max_memory_allocated"``); a CPU run reports 0.0 and
``"unavailable"``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

import torch

from . import flops as flops_mod

MARKER_START = "BENCHMARK_RESULT_JSON_START"
MARKER_END = "BENCHMARK_RESULT_JSON_END"


def arm_slug(strategy: str, world_size: int, seq_len: int, tier: str,
             model_family: str = "tinygpt") -> str:
    fam = "" if model_family == "tinygpt" else f"_{model_family}"
    return f"{strategy}_ws{world_size}_seq{seq_len}_tier{tier}{fam}"


def tokens_per_step(per_device_batch: int, grad_accum: int, seq_len: int, dp: int) -> int:
    """Global tokens one optimizer step consumes."""
    return per_device_batch * grad_accum * seq_len * dp


def measure_peak_memory(dev: torch.device) -> tuple[float, str]:
    """Peak allocated device memory in GB since the last reset, with provenance."""
    if dev.type == "cuda":
        return torch.cuda.max_memory_allocated(dev) / 1e9, "torch_cuda_max_memory_allocated"
    return 0.0, "unavailable"


@dataclasses.dataclass
class BenchmarkResult:
    strategy: str
    world_size: int
    rank: int
    seq_len: int
    tier: str
    steps: int
    per_device_batch: int
    grad_accum: int
    tokens_per_sec: float
    mean_step_time_sec: float
    mean_loss: float
    peak_vram_gb: float
    h2d_gbps_per_gpu: float = 0.0
    peak_hbm_gb: float = 0.0
    peak_hbm_method: str = "unavailable"
    device_kind: str = ""
    backend: str = ""
    n_params: int = 0
    attention_impl: str = "reference"
    dropout: float = 0.0
    causal: bool = False
    model_family: str = "tinygpt"
    flops_per_token: float = 0.0
    model_tflops_per_sec_per_chip: float = 0.0
    mfu_pct: float = 0.0  # 0.0 when the device's peak is unknown (CPU)
    sync_every: int = 1
    step_time_p50_sec: float = 0.0
    step_time_p95_sec: float = 0.0
    step_time_max_sec: float = 0.0
    step_time_cv_pct: float = 0.0
    # Means of the first / last loss_window_steps timed per-step losses.
    loss_first_window: float = 0.0
    loss_last_window: float = 0.0
    loss_window_steps: int = 0
    wall_time_total_sec: float = 0.0
    time_in_init_sec: float = 0.0
    time_in_warmup_sec: float = 0.0
    time_in_timed_sec: float = 0.0
    # Sequence shards of ring attention. The port holds them all in one
    # process on its card, so they add nothing to world_size, which counts
    # the processes (cards) of the data-parallel group.
    sequence_parallel: int = 1
    # Ring-attention zigzag layout mode ('auto'/'on'/'off'), run identity.
    ring_zigzag: str = "auto"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def result_filename(self) -> str:
        return "result_" + arm_slug(self.strategy, self.world_size, self.seq_len, self.tier,
                                    self.model_family) + ".json"


def compute_result(*, strategy: str, world_size: int, seq_len: int, tier: str, steps: int,
                   per_device_batch: int, grad_accum: int, step_times: List[float],
                   losses: List[float], peak_gb: float, peak_method: str,
                   device_kind: str = "", backend: str = "", n_params: int = 0,
                   attention_impl: str = "reference", dropout: float = 0.0,
                   causal: bool = False, model_family: str = "tinygpt",
                   flops_per_token: float = 0.0, sync_every: int = 1,
                   phase_times: Optional[Dict[str, float]] = None,
                   wall_time_total_sec: float = 0.0, sequence_parallel: int = 1,
                   ring_zigzag: str = "auto") -> BenchmarkResult:
    mean_step = sum(step_times) / len(step_times) if step_times else 0.0
    mean_loss = sum(losses) / len(losses) if losses else 0.0
    if losses:
        lw = max(1, min(10, len(losses) // 5))
        loss_first, loss_last = sum(losses[:lw]) / lw, sum(losses[-lw:]) / lw
    else:
        lw, loss_first, loss_last = 0, 0.0, 0.0
    step_tokens = tokens_per_step(per_device_batch, grad_accum, seq_len, world_size)
    tps = step_tokens / mean_step if mean_step > 0 else 0.0
    h2d = per_device_batch * grad_accum * seq_len * 4 / mean_step / 1e9 if mean_step > 0 else 0.0
    tps_per_chip = tps / world_size if world_size else 0.0
    mfu = flops_mod.mfu_pct(tps_per_chip, flops_per_token, device_kind)
    if step_times:
        ts = sorted(step_times)
        n = len(ts)
        p50, p95, t_max = ts[n // 2], ts[min(n - 1, int(0.95 * (n - 1) + 0.5))], ts[-1]
        var = sum((t - mean_step) ** 2 for t in step_times) / n
        cv = 100.0 * var ** 0.5 / mean_step if mean_step > 0 else 0.0
    else:
        p50 = p95 = t_max = cv = 0.0
    pt = phase_times or {}
    return BenchmarkResult(
        strategy=strategy, world_size=world_size, rank=0, seq_len=seq_len, tier=tier,
        steps=steps, per_device_batch=per_device_batch, grad_accum=grad_accum,
        tokens_per_sec=tps, mean_step_time_sec=mean_step, mean_loss=mean_loss,
        peak_vram_gb=peak_gb, h2d_gbps_per_gpu=h2d, peak_hbm_gb=peak_gb,
        peak_hbm_method=peak_method,
        device_kind=device_kind, backend=backend, n_params=n_params,
        attention_impl=attention_impl, dropout=dropout, causal=causal,
        model_family=model_family, flops_per_token=flops_per_token,
        model_tflops_per_sec_per_chip=flops_mod.achieved_tflops_per_sec(
            tps_per_chip, flops_per_token),
        mfu_pct=mfu if mfu is not None else 0.0, sync_every=sync_every,
        step_time_p50_sec=p50, step_time_p95_sec=p95, step_time_max_sec=t_max,
        step_time_cv_pct=cv, loss_first_window=loss_first, loss_last_window=loss_last,
        loss_window_steps=lw, wall_time_total_sec=round(wall_time_total_sec, 4),
        time_in_init_sec=round(pt.get("init", 0.0), 4),
        time_in_warmup_sec=round(pt.get("warmup", 0.0), 4),
        time_in_timed_sec=round(pt.get("timed", 0.0), 4),
        sequence_parallel=sequence_parallel, ring_zigzag=ring_zigzag,
    )


def emit_result(result: BenchmarkResult, results_dir: str) -> str:
    """Write result_<slug>.json and print the marker-delimited JSON block."""
    payload = json.dumps(result.to_dict(), indent=2)
    print("\n" + "=" * 80)
    print("Benchmark Results:")
    print(f"  Device:           {result.device_kind}")
    print(f"  Tokens/sec:       {result.tokens_per_sec:,.0f}")
    if result.mfu_pct > 0:
        print(f"  Model TFLOP/s/chip: {result.model_tflops_per_sec_per_chip:.1f}"
              f"  (MFU {result.mfu_pct:.1f}%)")
    print(f"  Mean step time:   {result.mean_step_time_sec:.4f}s")
    print(f"  Peak memory:      {result.peak_hbm_gb:.2f} GB ({result.peak_hbm_method})")
    print(f"  Mean loss:        {result.mean_loss:.4f}")
    print("=" * 80 + "\n")
    os.makedirs(results_dir, exist_ok=True)
    path = os.path.join(results_dir, result.result_filename())
    with open(path, "w") as f:
        f.write(payload)
    print(f"Results saved to: {path}")
    print(MARKER_START)
    print(payload)
    print(MARKER_END)
    return path
