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

Chip accounting follows JAX's ``compute_result``: a step consumes
``per_device_batch * grad_accum`` sequences per data-parallel replica, and
tokens/s/chip is tokens/s over ``world_size``, the processes (cards) of the
group. A sequence-parallel run is one of two forms (``parallel/mesh.py``):

- ``seq`` over the group (``world_size`` > 1): the ``seq`` ranks jointly
  compute one example, so ``dp = world_size // sequence_parallel``;
- ``seq`` in one process (``world_size`` 1): the n shards share the one
  card, ``dp = 1``, and ``sequence_parallel`` is stamped beside it.

A tensor-parallel run's ``model`` ranks also compute one example jointly,
and so do a pipeline's stages (JAX's ``utils/metrics.py``): ``dp =
max(world_size // (tensor_parallel * sequence_parallel * pipeline_parallel
* expert_parallel), 1)``, the validator's formula
(``analysis/validate_results.py``); MFU is over all ``world_size`` cards.
A pipelined row stamps ``pipeline_parallel``, ``pipeline_schedule`` and
``virtual_stages`` (1 unless the schedule is interleaved). The row stamps ``tensor_parallel`` and,
``tp_collective_matmul`` as it was asked for (inert at tp 1, and stamped
all the same), as JAX's ``BenchmarkResult`` does, and so its
``param_dtype``, ``offload_opt_state``, ``offload_delayed_update`` and
``offload_dpu_start_step``. Expert-parallel members hold distinct rows
(the batch shards over data x expert), so a step takes ``pd * accum * S *
dp * ep`` tokens (JAX's ``tokens_per_step``); a MoE row stamps
``expert_parallel``, ``n_experts`` and ``expert_overflow_pct`` (None for a
dense row). ``remat_policy`` is the policy the run executed with (a
strategy's ``auto`` resolved).

The run-time layer's keys (JAX's ``utils/metrics.py``): ``resumed``,
``n_restarts``, ``resume_step``, ``resume_baseline_loss`` and
``resume_geometry_changed`` (a run that restored a checkpoint, from the
checkpoint directory's restart ledger), ``time_in_compile_sec`` (the
recorder's ``compile`` phase: the first dispatched step up to its fence,
the lazy ``nvcc`` build of the kernels included), ``time_in_checkpoint_sec``
and ``n_anomalies`` (the recorder's NaN-loss and step-time-spike events);
the numerics sentinel's ``n_rollbacks`` and ``rollback_steps_replayed``; and
the input path's ``data_mode`` ("synthetic", or "stream" under
``--data-path``), ``data_stall_frac`` (the share of the timed steps' wall
spent waiting for input; None on the synthetic path), ``data_stall_sec``,
``records_consumed``, ``records_skipped`` (corrupt records healed) and
``stream_cursor_start`` / ``stream_cursor_end`` (-1 off the stream).

The analysis tied to the backend adds JAX's step-anatomy fields
(``anatomy_compute_frac``, ``comms_exposed_frac``, ``comms_overlap_frac``,
``anatomy_idle_frac``, ``bubble_frac``, the roofline percentages and
``straggler_skew_pct``: ``analysis/step_anatomy.result_fields``, set only
on a run that traced with ``profile_dir``), its memory-anatomy fields
(``hbm_estimate``, ``hbm_measured`` and its reason, ``hbm_attribution``
and its source, ``hbm_reference_gib``, ``hbm_model_drift_frac``:
``analysis/memory_anatomy.result_fields``, on every run) and
``time_in_trace_sec`` (the recorder's ``trace`` phase: the profiler's
start, stop and export). ``compute_result`` refuses keys of either
mapping that the row does not have, as JAX's does.
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

#: ``analysis.step_anatomy.result_fields`` keys, in the row's order.
STEP_ANATOMY_FIELDS = (
    "anatomy_compute_frac", "comms_exposed_frac", "comms_overlap_frac",
    "anatomy_idle_frac", "bubble_frac", "roofline_flops_pct_of_peak",
    "roofline_hbm_pct_of_peak", "straggler_skew_pct",
)
#: ``analysis.memory_anatomy.result_fields`` keys, in the row's order.
MEMORY_ANATOMY_FIELDS = (
    "hbm_estimate", "hbm_measured", "hbm_measured_reason", "hbm_attribution",
    "hbm_attribution_source", "hbm_reference_gib", "hbm_model_drift_frac",
)


def arm_slug(strategy: str, world_size: int, seq_len: int, tier: str,
             model_family: str = "tinygpt") -> str:
    fam = "" if model_family == "tinygpt" else f"_{model_family}"
    return f"{strategy}_ws{world_size}_seq{seq_len}_tier{tier}{fam}"


def tokens_per_step(per_device_batch: int, grad_accum: int, seq_len: int, dp: int,
                    expert_parallel: int = 1) -> int:
    """Global tokens one optimizer step consumes."""
    return per_device_batch * grad_accum * seq_len * dp * expert_parallel


def peak_hbm_bytes() -> Optional[int]:
    """The CUDA allocator's high-water mark on the current card, or None when
    this process has not touched a card (the recorder's sample)."""
    return torch.cuda.max_memory_allocated() if torch.cuda.is_initialized() else None


def hbm_bytes_in_use() -> Optional[int]:
    """Bytes the CUDA allocator holds now, or None (see ``peak_hbm_bytes``)."""
    return torch.cuda.memory_allocated() if torch.cuda.is_initialized() else None


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
    # A run that restored a checkpoint (--resume): how many resumes the
    # checkpoint directory's ledger counts, the restored step, the loss
    # recorded at its save, and whether it was saved under another mesh.
    resumed: bool = False
    n_restarts: int = 0
    resume_step: int = -1
    resume_baseline_loss: float = 0.0
    resume_geometry_changed: bool = False
    # Phase attribution (telemetry.TelemetryRecorder): disjoint phases.
    wall_time_total_sec: float = 0.0
    time_in_init_sec: float = 0.0
    time_in_compile_sec: float = 0.0
    time_in_warmup_sec: float = 0.0
    time_in_timed_sec: float = 0.0
    time_in_checkpoint_sec: float = 0.0
    time_in_trace_sec: float = 0.0
    # NaN-loss and step-time-spike events the recorder screened.
    n_anomalies: int = 0
    # Step anatomy (analysis/step_anatomy.py): the timed device steps of a
    # --profile-dir trace split into compute + exposed comms + idle (which
    # sum to 1; overlapped collective time is inside compute, and
    # comms_overlap_frac is a fraction OF collective time), the pipeline
    # bubble, the roofline position and the skew across device lanes. None
    # on a run without a trace, or whose trace has no device step.
    anatomy_compute_frac: Optional[float] = None
    comms_exposed_frac: Optional[float] = None
    comms_overlap_frac: Optional[float] = None
    anatomy_idle_frac: Optional[float] = None
    bubble_frac: Optional[float] = None
    roofline_flops_pct_of_peak: Optional[float] = None
    roofline_hbm_pct_of_peak: Optional[float] = None
    straggler_skew_pct: Optional[float] = None
    # Memory anatomy (analysis/memory_anatomy.py): the estimate's breakdown
    # (GiB), the allocator's peak (GiB; None with a reason on the CPU), the
    # reference peak attributed over the classes with a signed residual,
    # and |reference - analytic| / analytic.
    hbm_estimate: Optional[Dict[str, float]] = None
    hbm_measured: Optional[float] = None
    hbm_measured_reason: str = ""
    hbm_attribution: Optional[Dict[str, float]] = None
    hbm_attribution_source: str = ""
    hbm_reference_gib: Optional[float] = None
    hbm_model_drift_frac: Optional[float] = None
    # The numerics sentinel's in-process rollbacks and the steps they
    # replayed (replayed steps stay out of the step-time distribution).
    n_rollbacks: int = 0
    rollback_steps_replayed: int = 0
    # Sequence shards of ring / Ulysses attention: over the group when
    # world_size > 1 (world_size = dp * sequence_parallel), else all held in
    # one process on its card (world_size 1). See the module docstring.
    sequence_parallel: int = 1
    # Ring-attention zigzag layout mode ('auto'/'on'/'off'), run identity.
    ring_zigzag: str = "auto"
    # Tensor-parallel ('model') width over the group, and whether its
    # projections ran as collective matmuls (ops/collective_matmul.py).
    tensor_parallel: int = 1
    tp_collective_matmul: bool = False
    # Parameter storage dtype ('f32'/'bf16') and the host-offload arm: run
    # identity for arms of one (strategy, tier, seq) geometry (JAX's keys).
    param_dtype: str = "f32"
    offload_opt_state: bool = False
    offload_delayed_update: bool = False
    offload_dpu_start_step: int = 0
    # Expert-parallel width, experts per MoE layer (0: dense), and the
    # measured share (%) of (token, choice) assignments the capacity drops
    # on the trained params (None for a dense row).
    expert_parallel: int = 1
    n_experts: int = 0
    # The remat policy the run executed with ("none"/"dots"/"full"; a
    # strategy's "auto" resolved by the memory model), JAX's key.
    remat_policy: str = "none"
    expert_overflow_pct: Optional[float] = None
    # Pipeline ('pipe') width over the group, its schedule (meaningful when
    # pipeline_parallel > 1) and the interleaved schedule's chunks per stage.
    pipeline_parallel: int = 1
    pipeline_schedule: str = "gpipe"
    virtual_stages: int = 1
    # The input path: identity, and on the stream the measured wait for
    # input, the records consumed and healed, and the cursor pair (a resume
    # must start where the checkpoint's sidecar left off).
    data_mode: str = "synthetic"
    data_stall_frac: Optional[float] = None
    data_stall_sec: float = 0.0
    records_consumed: int = 0
    records_skipped: int = 0
    stream_cursor_start: int = -1
    stream_cursor_end: int = -1

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
                   ring_zigzag: str = "auto", tensor_parallel: int = 1,
                   tp_collective_matmul: bool = False, param_dtype: str = "f32",
                   offload_opt_state: bool = False, offload_delayed_update: bool = False,
                   offload_dpu_start_step: int = 0, expert_parallel: int = 1,
                   n_experts: int = 0, remat_policy: str = "none",
                   expert_overflow_pct: Optional[float] = None, pipeline_parallel: int = 1,
                   pipeline_schedule: str = "gpipe",
                   virtual_stages: int = 1, resumed: bool = False, n_restarts: int = 0,
                   resume_step: int = -1, resume_baseline_loss: float = 0.0,
                   resume_geometry_changed: bool = False,
                   n_anomalies: int = 0, n_rollbacks: int = 0,
                   rollback_steps_replayed: int = 0, data_mode: str = "synthetic",
                   data_stall_frac: Optional[float] = None, data_stall_sec: float = 0.0,
                   records_consumed: int = 0, records_skipped: int = 0,
                   stream_cursor_start: int = -1,
                   stream_cursor_end: int = -1,
                   step_anatomy: Optional[Dict[str, Any]] = None,
                   memory_anatomy: Optional[Dict[str, Any]] = None) -> BenchmarkResult:
    mean_step = sum(step_times) / len(step_times) if step_times else 0.0
    mean_loss = sum(losses) / len(losses) if losses else 0.0
    if losses:
        lw = max(1, min(10, len(losses) // 5))
        loss_first, loss_last = sum(losses[:lw]) / lw, sum(losses[-lw:]) / lw
    else:
        lw, loss_first, loss_last = 0, 0.0, 0.0
    dp = max(world_size // (tensor_parallel * sequence_parallel * pipeline_parallel
                            * expert_parallel), 1)
    step_tokens = tokens_per_step(per_device_batch, grad_accum, seq_len, dp, expert_parallel)
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
    # The analyses' result_fields keys: unknown keys are refused rather
    # than dropped, so an engine and the row cannot drift apart (JAX's rule).
    anatomy = dict(step_anatomy or {})
    anatomy_fields = {k: anatomy.pop(k, None) for k in STEP_ANATOMY_FIELDS}
    if anatomy:
        raise ValueError(f"unknown step_anatomy keys {sorted(anatomy)} (the engine's "
                         "result_fields and BenchmarkResult must agree)")
    mem = dict(memory_anatomy or {})
    mem_fields = {k: mem.pop(k, None) for k in MEMORY_ANATOMY_FIELDS}
    for k in ("hbm_measured_reason", "hbm_attribution_source"):
        mem_fields[k] = mem_fields[k] or ""
    if mem:
        raise ValueError(f"unknown memory_anatomy keys {sorted(mem)} (the engine's "
                         "result_fields and BenchmarkResult must agree)")
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
        time_in_compile_sec=round(pt.get("compile", 0.0), 4),
        time_in_warmup_sec=round(pt.get("warmup", 0.0), 4),
        time_in_timed_sec=round(pt.get("timed", 0.0), 4),
        time_in_checkpoint_sec=round(pt.get("checkpoint", 0.0), 4),
        time_in_trace_sec=round(pt.get("trace", 0.0), 4),
        resumed=resumed, n_restarts=n_restarts, resume_step=resume_step,
        resume_baseline_loss=round(resume_baseline_loss, 6),
        resume_geometry_changed=resume_geometry_changed, n_anomalies=n_anomalies,
        sequence_parallel=sequence_parallel, ring_zigzag=ring_zigzag,
        tensor_parallel=tensor_parallel,
        tp_collective_matmul=tp_collective_matmul, param_dtype=param_dtype,
        offload_opt_state=offload_opt_state, offload_delayed_update=offload_delayed_update,
        offload_dpu_start_step=offload_dpu_start_step, expert_parallel=expert_parallel,
        n_experts=n_experts, remat_policy=remat_policy,
        expert_overflow_pct=expert_overflow_pct,
        pipeline_parallel=pipeline_parallel, pipeline_schedule=pipeline_schedule,
        virtual_stages=virtual_stages, n_rollbacks=n_rollbacks,
        rollback_steps_replayed=rollback_steps_replayed, data_mode=data_mode,
        data_stall_frac=data_stall_frac, data_stall_sec=data_stall_sec,
        records_consumed=records_consumed, records_skipped=records_skipped,
        stream_cursor_start=stream_cursor_start, stream_cursor_end=stream_cursor_end,
        **anatomy_fields, **mem_fields,
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
    if result.hbm_attribution is not None:
        attr = result.hbm_attribution
        measured = (f"{result.hbm_measured:.2f} GiB measured" if result.hbm_measured is not None
                    else f"measured n/a ({result.hbm_measured_reason})")
        drift = (f", model drift {100.0 * result.hbm_model_drift_frac:.1f}%"
                 if result.hbm_model_drift_frac is not None else "")
        print(f"  HBM anatomy:      {measured}; {result.hbm_attribution_source} peak "
              f"{result.hbm_reference_gib or 0:.2f} GiB = params {attr.get('params', 0):.2f} + "
              f"grads {attr.get('grads', 0):.2f} + opt {attr.get('opt_state', 0):.2f} + act "
              f"{attr.get('activations', 0):.2f} + data {attr.get('dataset', 0):.2f} + xla-temp "
              f"{attr.get('xla_temp', 0):.2f} {attr.get('unattributed', 0):+.2f} "
              f"residual{drift}")
    print(f"  Mean loss:        {result.mean_loss:.4f}")
    if result.data_mode == "stream":
        print(f"  Data path:        stream — stall "
              f"{100.0 * (result.data_stall_frac or 0.0):.1f}% of timed wall "
              f"({result.data_stall_sec:.2f}s), {result.records_consumed} records consumed "
              f"(cursor {result.stream_cursor_start} -> {result.stream_cursor_end}), "
              f"{result.records_skipped} skipped/quarantined")
    if result.comms_exposed_frac is not None:
        anatomy = (f"  Step anatomy:     compute "
                   f"{100.0 * (result.anatomy_compute_frac or 0):.1f}% / exposed comms "
                   f"{100.0 * result.comms_exposed_frac:.1f}% / idle "
                   f"{100.0 * (result.anatomy_idle_frac or 0):.1f}%")
        if result.comms_overlap_frac is not None:
            anatomy += (f"  (overlap {100.0 * result.comms_overlap_frac:.1f}% of collective "
                        "time)")
        if result.bubble_frac is not None:
            anatomy += f"  bubble {100.0 * result.bubble_frac:.1f}%"
        print(anatomy)
    if result.n_rollbacks > 0:
        print(f"  ROLLBACKS:        {result.n_rollbacks} sentinel rollback(s), "
              f"{result.rollback_steps_replayed} step(s) replayed — healed run, never a "
              "regression baseline")
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
