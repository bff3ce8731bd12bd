"""The timed benchmark loop.

Port of the core of ``distributed_llm_training_benchmark_framework_tpu/train/loop.py``
(``run_benchmark``): lay out the arm over the mesh, resolve zero3's remat
and refuse what cannot fit before building anything (``utils/memory``),
build the model, optimizer and device-resident table, run
``warmup_steps`` untimed steps, then the timed steps in windows of
``sync_every`` steps fenced by ``torch.cuda.synchronize()`` (each step of a
window is charged the window's mean), and compute the result row.
Telemetry, checkpoints, fault injection, the numerics sentinel and the
streaming input path are not ported yet.

``world_size`` is the size of the process group the caller
(``runtime.setup_distributed``, or torchrun through the bench entry) made,
one card per process, or 1 without a group. Every rank runs this loop;
rank 0 alone prints and emits the row, which carries the group's size and
the highest peak memory of any rank.

The ``seq``, ``model``, ``pipe`` and ``expert`` axes ride the group by the
mesh's rule (``parallel/mesh.py``): ``world % (n * tp * pp * ep) == 0`` and
``data`` has width ``world // (n * tp * pp * ep)``.

``sequence_parallel`` n > 1 runs ring or Ulysses attention over n sequence
shards: with a group of world > 1 the shards ride the group (each rank
holding S/n of the sequence); without a group, or at world 1, all n are
held in one process on its card. The row stamps
``sequence_parallel`` beside ``world_size`` either way
(``utils/metrics.py`` says how each form is accounted).

``n_experts`` E > 0 makes every block's MLP a top-k routed expert layer
(``models/moe.py``); ``expert_parallel`` ep > 1 puts an ``expert`` axis on
the group, each rank holding E/ep experts
and its own rows of a global micro-batch of ``pd * dp * ep``, with JAX's
checks (``train/loop.py:464-479``). After the timed steps a MoE row gets
``expert_overflow_pct``: the capacity's dropped share of the assignments on
the trained params, from one dropout-free forward of the first step's
micro-batch (JAX's diagnostic). There is no CLI flag for either, as the
JAX ``bench.py`` has none.

``tensor_parallel`` tp > 1 lays the model out Megatron-style over a
``model`` axis of the group (``parallel/tensor.py``), which needs a group:
there is no one-process form.
``tp_collective_matmul`` runs its projections as the rings of
``ops/collective_matmul.py`` (inert at tp 1, and stamped on the row either
way, as in JAX). The row stamps ``tensor_parallel``.

``pipeline_parallel`` pp > 1 puts a ``pipe`` axis on the group, each rank
holding one stage (which needs a group), and trains under
``pipeline_schedule`` "gpipe", "1f1b" or "interleaved" (``virtual_stages``
chunks per stage, 2 by default) with the step's ``grad_accum`` micro-batches
as the schedule's microbatches (``parallel/pipeline.py``,
``parallel/interleaved.py``), with JAX's checks (``train/loop.py:464-546``):
``n_layer`` divisible by pp (by pp * V under interleaved), a known schedule,
no ``tp_collective_matmul``. A ``model`` axis or an ``expert`` axis wider
than 1 beside ``pipe`` is refused (ROADMAP Queue 1 items 13 and 12). The
row stamps ``pipeline_parallel``, ``pipeline_schedule`` and
``virtual_stages`` (1 unless interleaved). The MoE overflow diagnostic runs
through the stages under gpipe and 1f1b and, as in JAX, is skipped under
interleaved.

The model's parameters are bf16 when the strategy's ``param_dtype`` is
"bf16" or it offloads its optimizer state (``offload_opt_state``: fp32
masters and AdamW on the host, ``parallel/offload.py``), as JAX's
``_resolve_model_config`` decides. ``offload_dpu_start_step`` k > 0 runs
the delayed offload arm's first k steps as serial host updates and switches
to the delayed update at step k, at a sync boundary, from an empty pending
slot (JAX's ``--offload-dpu-start-step``). The port has no resume, so JAX's
refusal of the knob under ``--resume`` has nothing to refuse.

Runs on ``cuda`` unless ``device="cpu"`` is passed; with no CUDA device and
no explicit ``cpu`` it raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Union

import torch
import torch.distributed as dist

from ..data.synthetic import SyntheticDataset, step_batch
from ..models import TinyGPT, TinyGPTConfig, count_params, get_config
from ..models.tinygpt import moe_overflow_fraction
from ..ops.ulysses_attention import check_heads
from ..parallel.mesh import AXES, Mesh, make_mesh
from ..parallel.pipeline import Pipeline, check_pipeline
from ..parallel.strategies import (
    StrategyConfig,
    apply_strategy,
    check_ported,
    check_tp,
    get_strategy,
    param_torch_dtype,
)
from ..utils import flops as flops_mod
from ..utils import memory as memory_mod
from ..utils import metrics as metrics_mod
from ..utils.platform import device_kind, resolve_device
from .step import TrainStep

DATASET_SIZE = 1000  # rows of the synthetic table (the reference's size)
LOG_EVERY = 10


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class Run:
    """Everything one benchmark arm trains with."""

    device: torch.device
    config: TinyGPTConfig
    strategy: StrategyConfig  # remat resolved
    model: torch.nn.Module  # the arm's wrapper (DDP) or the TinyGPT itself
    table: torch.Tensor
    step_fn: TrainStep
    mesh: Mesh


def _ring_overrides(attention_impl: str, sequence_parallel: int, causal: bool,
                    ring_zigzag: Optional[bool]) -> dict:
    """The JAX loop's checks of the sequence-parallel options
    (``train/loop.py:482-530``) and the config overrides they give."""
    if sequence_parallel < 1:
        raise ValueError(f"sequence_parallel must be >= 1, got {sequence_parallel}")
    if sequence_parallel > 1 and attention_impl not in ("ring", "ulysses"):
        raise ValueError(
            "sequence_parallel > 1 requires attention_impl 'ring' or 'ulysses'; got "
            f"{attention_impl!r}"
        )
    overrides = {}
    if causal:
        overrides["causal"] = True
    if ring_zigzag is not None:
        # The knob has a consumer only on a real ring; refuse rather than run
        # flash while the row records the setting.
        if attention_impl != "ring":
            raise ValueError(
                f"ring_zigzag={'on' if ring_zigzag else 'off'} requires attention_impl "
                f"'ring' (the zigzag layout is a ring-attention property); got "
                f"{attention_impl!r}"
            )
        if ring_zigzag and sequence_parallel <= 1:
            raise ValueError(
                "ring_zigzag on requires sequence_parallel > 1: with one sequence shard "
                "there is no ring to balance"
            )
        overrides["ring_zigzag"] = ring_zigzag
    return overrides


def _tp_overrides(tensor_parallel: int, sequence_parallel: int,
                  tp_collective_matmul: bool, n_experts: int) -> dict:
    """The JAX loop's checks of the tensor-parallel options
    (``train/loop.py:471-477,533-558``; the pipeline's refusal of the
    collective matmul is ``parallel/pipeline.check_pipeline``'s) and the
    config override they give."""
    if tensor_parallel < 1:
        raise ValueError(f"tensor_parallel must be >= 1, got {tensor_parallel}")
    if not tp_collective_matmul:
        return {}
    if sequence_parallel > 1:
        raise ValueError(
            "--tp-collective-matmul cannot compose with sequence parallelism (both want to own "
            "the sequence axis; the ring/ulysses arms already overlap their comms)"
        )
    if n_experts > 0:
        raise ValueError(
            "--tp-collective-matmul does not support MoE models (the expert dispatch owns the "
            "token layout; dense MLPs only)"
        )
    return {"tp_collective_matmul": True}


def _moe_overrides(n_experts: int, expert_parallel: int) -> dict:
    """The JAX loop's checks of the MoE options (``train/loop.py:464-470``)
    and the config override they give."""
    if expert_parallel < 1:
        raise ValueError(f"expert_parallel must be >= 1, got {expert_parallel}")
    if expert_parallel > 1 and n_experts == 0:
        raise ValueError("expert_parallel > 1 requires --num-experts > 0")
    if n_experts > 0 and expert_parallel > 1 and n_experts % expert_parallel != 0:
        raise ValueError(f"n_experts={n_experts} not divisible by "
                         f"expert_parallel={expert_parallel}")
    return {"n_experts": n_experts} if n_experts > 0 else {}


def build_run(*, strategy: Union[str, StrategyConfig] = "zero2", tier: str = "A",
              seq_len: int = 2048, model_family: str = "tinygpt", per_device_batch: int = 1,
              grad_accum: int = 4, attention_impl: str = "flash",
              dropout: Optional[float] = None, sequence_parallel: int = 1,
              causal: bool = False, ring_zigzag: Optional[bool] = None, seed: int = 42,
              device: Optional[str] = None, world_size: Optional[int] = None,
              tensor_parallel: int = 1, tp_collective_matmul: bool = False,
              n_experts: int = 0, expert_parallel: int = 1, pipeline_parallel: int = 1,
              pipeline_schedule: str = "gpipe", virtual_stages: int = 2) -> Run:
    """Model (initialised from ``seed``, the same on every rank and, under
    tensor parallelism, the same global weights), the arm's layout and
    optimizer, device-resident table and train step of one arm;
    ``run_benchmark`` and the step profiler share it. ``causal`` turns
    causal masking on (Llama is causal anyway); ``ring_zigzag`` None is
    auto; ``world_size`` None is the process group's size, and another
    value than that size is refused; ``tensor_parallel``,
    ``tp_collective_matmul``, ``n_experts``, ``expert_parallel``,
    ``pipeline_parallel``, ``pipeline_schedule`` and ``virtual_stages`` as
    in the module docstring."""
    dev = resolve_device(device)
    strat = get_strategy(strategy) if isinstance(strategy, str) else strategy
    check_ported(strat)
    group_size = dist.get_world_size() if dist.is_initialized() else 1
    if world_size is not None and world_size != group_size:
        raise ValueError(
            f"world_size={world_size} but the process group has {group_size} process"
            f"{'es' if group_size > 1 else ''} (one card each); launch {world_size} processes "
            "(torchrun --nproc_per_node) or leave world_size unset"
        )
    overrides = {"attention_impl": attention_impl,
                 "compute_dtype": torch.bfloat16 if strat.precision == "bf16" else torch.float32,
                 "param_dtype": param_torch_dtype(strat)}
    overrides.update(_ring_overrides(attention_impl, sequence_parallel, causal, ring_zigzag))
    overrides.update(_moe_overrides(n_experts, expert_parallel))
    check_pipeline(pipeline_parallel, pipeline_schedule, virtual_stages,
                   get_config(model_family, tier, seq_len).n_layer, tensor_parallel,
                   expert_parallel, tp_collective_matmul)
    overrides.update(_tp_overrides(tensor_parallel, sequence_parallel, tp_collective_matmul,
                                   n_experts))
    if dropout is not None:
        overrides["dropout"] = dropout
    cfg = get_config(model_family, tier, seq_len, **overrides)
    if tensor_parallel > 1:
        check_tp(cfg, tensor_parallel)
    if attention_impl == "ulysses":
        check_heads(cfg.n_head // tensor_parallel, sequence_parallel)
    axes = [(AXES.seq, sequence_parallel), (AXES.model, tensor_parallel),
            (AXES.pipe, pipeline_parallel), (AXES.expert, expert_parallel)]
    axes = axes[:1] + [(a, w) for a, w in axes[1:] if w > 1]
    mesh = make_mesh(tuple(w for _, w in axes), tuple(a for a, _ in axes))
    kind = device_kind(dev)
    strat = memory_mod.resolve_auto_remat(cfg, strat, mesh, per_device_batch, seq_len,
                                          DATASET_SIZE, kind)
    cfg = dataclasses.replace(cfg, remat=strat.remat)
    est = memory_mod.estimate_hbm(cfg, strat, mesh, per_device_batch, seq_len, DATASET_SIZE)
    if mesh.rank == 0:
        print(f"Strategy: {strat.describe()}")
        print(f"Mesh: {mesh.shape} over {kind!r}")
        print(memory_mod.format_breakdown(est, kind))
    refusal = memory_mod.check_fits(est, kind)
    if refusal is not None:
        raise ValueError(refusal)
    interleaved = pipeline_parallel > 1 and pipeline_schedule == "interleaved"
    with torch.device(dev):
        model = TinyGPT(cfg, mesh=mesh, virtual_stages=virtual_stages if interleaved else 1)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    model, optimizer = apply_strategy(model, strat, mesh)
    table = SyntheticDataset(cfg.vocab_size, seq_len, DATASET_SIZE, seed).to_device(dev)
    pipeline = None
    if pipeline_parallel > 1:
        pipeline = Pipeline(pipeline_schedule, mesh, grad_accum, dev, virtual_stages)
    step_fn = TrainStep(model, optimizer, grad_accum=grad_accum,
                        micro_batch=per_device_batch, seed=seed, device=dev, mesh=mesh,
                        pipeline=pipeline)
    return Run(dev, cfg, strat, model, table, step_fn, mesh)


def _check_dpu_start(strategy: StrategyConfig, start: int, steps: int,
                     warmup_steps: int) -> None:
    """JAX's checks of ``offload_dpu_start_step`` (``train/loop.py:655-695``)."""
    if start < 0:
        raise ValueError(f"--offload-dpu-start-step must be >= 0, got {start}")
    if start == 0:
        return
    if not strategy.offload_delayed_update:
        raise ValueError("--offload-dpu-start-step requires --offload-delayed-update")
    if start >= steps:
        raise ValueError(
            f"--offload-dpu-start-step {start} >= --steps {steps}: the delayed phase would "
            "never begin (drop the knob for a fully-serial run)"
        )
    if start > warmup_steps and (not dist.is_initialized() or dist.get_rank() == 0):
        print(
            f"WARNING: --offload-dpu-start-step {start} > --warmup-steps {warmup_steps}: timed "
            "windows will mix serial and delayed step times into one result row; set the "
            "start step inside the untimed warmup for clean timing"
        )


def _global_params(cfg: TinyGPTConfig, model: torch.nn.Module, mesh: Mesh) -> int:
    """The model's parameter count (a ``model``, ``pipe`` or ``expert`` rank
    holds only its shards: count the global model, built on the meta
    device)."""
    if all(mesh.size(a) == 1 for a in (AXES.model, AXES.pipe, AXES.expert)):
        return count_params(model)
    with torch.device("meta"):
        return count_params(TinyGPT(cfg))


def _overflow_pct(run: "Run", micro: int) -> float:
    """JAX's ``expert_overflow_pct``: the diagnostic on the first step's
    micro-batch of the global batch (``batch_for_step(0, global_micro)``),
    this rank's rows of it, in percent, rounded to 4 places."""
    step_fn, inner = run.step_fn, getattr(run.model, "module", run.model)
    global_micro = micro * step_fn.members
    row0 = step_fn.member * micro
    rows = step_batch(run.table, 0, 1, global_micro)[0, row0:row0 + micro]
    frac = moe_overflow_fraction(inner, rows, row0, global_micro, step_fn.pipeline)
    return round(float(frac) * 100.0, 4)


def _max_over_ranks(value: float, mesh: Mesh, dev: torch.device) -> float:
    if mesh.group is None:
        return value
    t = torch.tensor([value], dtype=torch.float64,
                     device=dev if dist.get_backend() == "nccl" else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return float(t.item())


def run_benchmark(
    *,
    strategy: Union[str, StrategyConfig] = "zero2",
    tier: str = "A",
    seq_len: int = 2048,
    model_family: str = "tinygpt",
    steps: int = 100,
    warmup_steps: int = 5,
    per_device_batch: int = 1,
    grad_accum: int = 4,
    attention_impl: str = "flash",
    dropout: Optional[float] = None,
    sequence_parallel: int = 1,
    causal: bool = False,
    ring_zigzag: Optional[bool] = None,
    sync_every: int = 10,
    seed: int = 42,
    device: Optional[str] = None,
    results_dir: Optional[str] = None,
    world_size: Optional[int] = None,
    loss_log: Optional[List[float]] = None,
    tensor_parallel: int = 1,
    tp_collective_matmul: bool = False,
    offload_dpu_start_step: int = 0,
    offload_log: Optional[dict] = None,
    n_experts: int = 0,
    expert_parallel: int = 1,
    pipeline_parallel: int = 1,
    pipeline_schedule: str = "gpipe",
    virtual_stages: int = 2,
    pipeline_log: Optional[dict] = None,
) -> metrics_mod.BenchmarkResult:
    """Train ``steps`` optimizer steps (the first ``warmup_steps`` untimed)
    and return the result row (on every rank); with ``results_dir`` rank 0
    also writes ``result_<arm>.json`` there and prints the marker-delimited
    JSON. ``sequence_parallel``, ``causal``, ``ring_zigzag`` and
    ``world_size``, ``tensor_parallel``, ``tp_collective_matmul``,
    ``n_experts``, ``expert_parallel``, ``pipeline_parallel``,
    ``pipeline_schedule`` and ``virtual_stages`` as for :func:`build_run`;
    ``offload_dpu_start_step`` as in the module
    docstring. ``loss_log``, when given, gets every step's loss (mean over
    ranks) appended in order, warmup included; ``offload_log``, when given
    to an offload arm, gets the host arm's per-step times and bytes
    (``parallel/offload.HostOffload.stats``); ``pipeline_log``, when given
    to a pipelined run, gets this rank's stage, the messages it sent per
    step in each direction and the ms per step it waited in receives."""
    if steps <= warmup_steps:
        raise ValueError(f"steps={steps} leaves no timed step after warmup_steps={warmup_steps}")
    asked = get_strategy(strategy) if isinstance(strategy, str) else strategy
    _check_dpu_start(asked, offload_dpu_start_step, steps, warmup_steps)
    if offload_dpu_start_step > 0:
        # Serial host updates first; the optimizer switches at the start step.
        strategy = dataclasses.replace(asked, offload_delayed_update=False)
    t_start = time.perf_counter()
    run = build_run(strategy=strategy, tier=tier, seq_len=seq_len, model_family=model_family,
                    per_device_batch=per_device_batch, grad_accum=grad_accum,
                    attention_impl=attention_impl, dropout=dropout,
                    sequence_parallel=sequence_parallel, causal=causal,
                    ring_zigzag=ring_zigzag, seed=seed, device=device,
                    world_size=world_size, tensor_parallel=tensor_parallel,
                    tp_collective_matmul=tp_collective_matmul, n_experts=n_experts,
                    expert_parallel=expert_parallel, pipeline_parallel=pipeline_parallel,
                    pipeline_schedule=pipeline_schedule, virtual_stages=virtual_stages)
    dev, cfg, strat, model, table, step_fn, mesh = (
        run.device, run.config, run.strategy, run.model, run.table, run.step_fn, run.mesh)
    is_main = mesh.rank == 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    phase = {"init": time.perf_counter() - t_start, "warmup": 0.0, "timed": 0.0}

    timed_times, timed_losses, pending = [], [], []
    t_window = time.perf_counter()

    def sync_window():
        nonlocal t_window
        _sync(dev)
        now = time.perf_counter()
        dt = (now - t_window) / len(pending)
        for s, loss in pending:
            lf = float(loss)
            if loss_log is not None:
                loss_log.append(lf)
            if s >= warmup_steps:
                timed_times.append(dt)
                timed_losses.append(lf)
            if s % LOG_EVERY == 0 and is_main:
                print(f"[Step {s:04d}] Loss: {lf:.4f}, Time: {dt:.3f}s")
        phase["timed" if pending[0][0] >= warmup_steps else "warmup"] += now - t_window
        pending.clear()
        t_window = now

    for step in range(steps):
        if offload_dpu_start_step > 0 and step == offload_dpu_start_step:
            if pending:
                sync_window()
            step_fn.optimizer.host.begin_delayed()
            if is_main:
                print(f"[Step {step:04d}] delayed-update phase begins")
        pending.append((step, step_fn(table, step)))
        if len(pending) >= sync_every or step == warmup_steps - 1 or step == steps - 1:
            sync_window()

    if offload_log is not None and step_fn.optimizer.host is not None:
        offload_log.update(step_fn.optimizer.host.stats())
    if pipeline_log is not None and step_fn.pipeline is not None:
        transport = step_fn.pipeline.transport
        pipeline_log.update(stage=step_fn.pipeline.stage,
                            sent_per_step=[n / steps for n in transport.sent],
                            wait_ms_per_step=1e3 * transport.wait_s / steps,
                            host_staged=transport.staged)
    peak_gb, peak_method = metrics_mod.measure_peak_memory(dev)
    interleaved = pipeline_parallel > 1 and pipeline_schedule == "interleaved"
    overflow = None
    if cfg.n_experts > 0 and interleaved:
        if is_main:
            print("NOTE: MoE overflow diagnostic skipped under the interleaved schedule (its "
                  "stages hold permuted layer chunks; JAX skips it there too)")
    elif cfg.n_experts > 0:
        overflow = _overflow_pct(run, per_device_batch)
    peak_gb = _max_over_ranks(peak_gb, mesh, dev)
    result = metrics_mod.compute_result(
        strategy=strat.name, world_size=mesh.world, seq_len=seq_len, tier=tier,
        steps=steps,
        per_device_batch=per_device_batch, grad_accum=grad_accum,
        step_times=timed_times, losses=timed_losses, peak_gb=peak_gb,
        peak_method=peak_method, device_kind=device_kind(dev), backend=dev.type,
        n_params=_global_params(cfg, model, mesh), attention_impl=cfg.attention_impl,
        dropout=cfg.dropout, causal=cfg.causal, model_family=model_family,
        flops_per_token=flops_mod.train_flops_per_token(cfg), sync_every=sync_every,
        phase_times=phase, wall_time_total_sec=time.perf_counter() - t_start,
        sequence_parallel=sequence_parallel,
        ring_zigzag={None: "auto", True: "on", False: "off"}[cfg.ring_zigzag],
        tensor_parallel=tensor_parallel, tp_collective_matmul=tp_collective_matmul,
        param_dtype=strat.param_dtype, offload_opt_state=strat.offload_opt_state,
        offload_delayed_update=asked.offload_delayed_update,
        offload_dpu_start_step=offload_dpu_start_step, expert_parallel=expert_parallel,
        n_experts=n_experts, expert_overflow_pct=overflow, pipeline_parallel=pipeline_parallel,
        pipeline_schedule=pipeline_schedule,
        virtual_stages=virtual_stages if interleaved else 1,
    )
    if results_dir is not None and is_main:
        metrics_mod.emit_result(result, results_dir)
    return result
