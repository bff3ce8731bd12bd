"""The timed benchmark loop.

Port of the core of ``distributed_llm_training_benchmark_framework_tpu/train/loop.py``
(``run_benchmark``): lay out the arm over the mesh, resolve zero3's remat
and refuse what cannot fit before building anything (``utils/memory``),
build the model, optimizer and device-resident table, run
``warmup_steps`` untimed steps, then the timed steps in windows of
``sync_every`` steps fenced by ``torch.cuda.synchronize()`` (each step of a
window is charged the window's mean), and compute the result row.

The run-time layer (JAX's ``train/loop.py`` hooks) rides the same fenced
boundaries, so it adds no device sync and no collective to a timed window:

- the flight recorder (``telemetry.TelemetryRecorder``) streams
  ``telemetry_<arm>.jsonl`` beside the result and prints heartbeats; its
  phases ``init`` / ``compile`` (the first dispatched step up to its fence,
  the kernels' lazy build included) / ``warmup`` / ``timed`` /
  ``checkpoint`` / ``finalize`` give the row's ``time_in_*_sec``, and a
  ``step_window`` event and a heartbeat close every sync window;
- periodic saves (``runtime.checkpoint``) at fenced boundaries, and a
  final one; ``resume`` restores the newest valid step and continues at
  the next (``NothingToResume`` past the end, with no telemetry trail);
- the SIGTERM guard is polled at each boundary (across ranks over the
  group's store: ``faults.preemption``); a preemption saves an emergency
  checkpoint (or commits the async one in flight), sends the final
  heartbeat and raises ``Preempted``; one during the last window
  publishes the row instead;
- the hang watchdog is beaten at each boundary, a peer's hang flag is
  polled there, and the fault injector fires at exact boundaries;
- the numerics sentinel (``sentinel``, ``faults.NumericsSentinel``) judges
  every step's loss and fp32 grad norm (read at the boundary with the loss)
  and, every ``sentinel_checksum_every`` steps and before every save, the
  parameters' checksum. A trip is healed at the top of the next iteration,
  before anything dispatches: the newest valid checkpoint is restored (or,
  at world 1 with no checkpoint cadence, the host snapshot taken before the
  first dispatch), the step cursor rewinds (``_StepCursor``), the poisoned
  tail leaves the timed lists, and the run replays; a save over an open
  trip is skipped. On the synthetic path a replay reads the table at
  ``step + k * steps`` after k rollbacks and reseeds the dropout
  generator (``TrainStep.reseed``), so it draws fresh rows and masks; on
  the stream it re-consumes the same records;
- the streaming input path (``data_path``: ``data/stream.py`` behind
  ``data/prefetch.py``) replaces the table. The prefetcher's ``get`` is the
  one blocking pull inside the timed loop; its waits give the row's
  ``data_stall_frac``. Every save writes the stream's cursor of the
  consumed batches in a ``stream_<step>.json`` sidecar, from which a resume
  (or a rollback) continues. A wait past ``data_stall_timeout_sec`` on any
  rank stops every rank at the same boundary (the ranks agree over the
  group's store before each step): an emergency save with its sidecar, a
  fatal ``data_stall`` event and ``DataStalled`` (exit 78);
- ``profile_dir`` (JAX's ``--profile-dir``): rank 0 runs ``torch.profiler``
  from the warmup boundary to the end of the timed steps (phase ``trace``
  around its start and its stop and export), with a ``ProfilerStep#N``
  marker per step, and the row gets the trace's step anatomy
  (``analysis/step_anatomy.py``); every run's row gets the memory anatomy
  (``analysis/memory_anatomy.py``: the estimate against the allocator's
  peak).

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
checks (``train/loop.py:464-479``). The MoE model composes with every
other axis as in JAX: beside ``seq``, ``model`` or ``pipe``, or under
``moe_dispatch`` "einsum", the layers route the global micro-batch (JAX's
einsum form), and beside ``model`` each rank holds its experts' F/tp
columns. After the timed steps a MoE row gets
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
no ``tp_collective_matmul``. A ``model`` axis beside ``pipe`` runs
JAX's layout (the blocks' Megatron shards, ``wte`` / ``lm_head`` replicated
over ``model``); an ``expert`` axis beside ``pipe`` puts each stage's
experts over it, and the stage's MoE layers route its micro-batch over
data x expert, as JAX's einsum form does under its pipeline. The
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
slot (JAX's ``--offload-dpu-start-step``), refused with ``resume`` as JAX
refuses it (the two phases hold different optimizer state).

Runs on ``cuda`` unless ``device="cpu"`` is passed; with no CUDA device and
no explicit ``cpu`` it raises.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import time
import warnings
from typing import List, Optional, Union

import torch
import torch.distributed as dist

from ..data.prefetch import DataStallTimeout, HostPrefetcher
from ..data.stream import STREAM_STATE_SCHEMA_VERSION, DataStalled, ShardedTokenStream
from ..data.synthetic import SyntheticDataset, step_batch
from ..faults import (
    DATA_KINDS,
    FaultInjector,
    HangWatchdog,
    NothingToResume,
    NumericsSentinel,
    Preempted,
    PreemptionGuard,
    SentinelTripped,
    parse_fault_spec,
)
from ..faults.watchdog import abort_on_peer_hang
from ..models import TinyGPT, TinyGPTConfig, count_params, get_config
from ..models.tinygpt import moe_overflow_fraction
from ..ops.ulysses_attention import check_heads
from ..parallel.mesh import AXES, Mesh, make_mesh, mesh_axes_dict
from ..parallel.pipeline import Pipeline, check_pipeline
from ..parallel.strategies import (
    StrategyConfig,
    apply_strategy,
    check_ported,
    check_tp,
    get_strategy,
    param_torch_dtype,
)
from ..runtime import distributed as dist_rt
from ..runtime.checkpoint import BenchmarkCheckpointer, TrainState
from ..telemetry import TelemetryRecorder
from ..utils import flops as flops_mod
from ..utils import memory as memory_mod
from ..utils import metrics as metrics_mod
from ..utils.platform import device_kind, resolve_device
from .step import TrainStep

DATASET_SIZE = 1000  # rows of the synthetic table (the reference's size)
LOG_EVERY = 10
#: How much longer than the stall timeout a rank waits for a starving
#: peer's verdict before the step (``runtime.distributed.agree_data_ready``).
DATA_AGREE_SLACK_SEC = 60.0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _start_trace(dev: torch.device, step: int) -> torch.profiler.profile:
    """Start ``torch.profiler`` (host and, on the card, CUDA activity) with a
    ``ProfilerStep#<step>`` marker open: a schedule that records every step
    makes ``profile.step`` mark the steps."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=acts, schedule=lambda _: torch.profiler.ProfilerAction.RECORD)
    prof.step_num = step
    with warnings.catch_warnings():
        # One cycle, so its note that a cycle clears its events is moot;
        # acc_events=True would silence it too, but it makes stop() turn
        # every event into a Python object (parity: 64 s instead of 7 s).
        warnings.filterwarnings("ignore", message="Warning: Profiler clears events")
        prof.start()
    return prof


def _trace_step(prof: torch.profiler.profile, step: int) -> None:
    """Close the open step marker and open ``ProfilerStep#<step>``: the
    loop's own step number, also after a rollback rewinds it."""
    prof.step_num = step - 1
    prof.step()


def _stop_trace(prof: torch.profiler.profile, profile_dir: str) -> dict:
    """Stop the profiler and export its Chrome trace into ``profile_dir`` as
    ``tensorboard_trace_handler`` names it (``<host>_<pid>.<ms>.pt.trace.json``);
    -> the file's path and bytes and the stop's and export's seconds."""
    t0 = time.perf_counter()
    prof.stop()
    t1 = time.perf_counter()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"{socket.gethostname()}_{os.getpid()}."
                                     f"{time.time_ns() // 1_000_000}.pt.trace.json")
    prof.export_chrome_trace(path)
    return {"path": path, "bytes": os.path.getsize(path), "stop_sec": round(t1 - t0, 4),
            "export_sec": round(time.perf_counter() - t1, 4)}


@dataclasses.dataclass
class Run:
    """Everything one benchmark arm trains with."""

    device: torch.device
    config: TinyGPTConfig
    strategy: StrategyConfig  # remat resolved
    model: torch.nn.Module  # the arm's wrapper (DDP) or the TinyGPT itself
    table: Optional[torch.Tensor]  # None on the streaming input path
    step_fn: TrainStep
    mesh: Mesh
    estimate: Optional[memory_mod.HBMEstimate] = None  # the pre-flight memory model


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
              pipeline_schedule: str = "gpipe", virtual_stages: int = 2,
              dataset_size: int = DATASET_SIZE, skip_memory_check: bool = False,
              sentinel: bool = False, synthetic: bool = True,
              n_layer: Optional[int] = None, layer_loop: str = "unrolled") -> Run:
    """Model (initialised from ``seed``, the same on every rank and, under
    tensor parallelism, the same global weights), the arm's layout and
    optimizer, device-resident table and train step of one arm;
    ``run_benchmark`` and the step profiler share it. ``causal`` turns
    causal masking on (Llama is causal anyway); ``ring_zigzag`` None is
    auto; ``world_size`` None is the process group's size, and another
    value than that size is refused; ``tensor_parallel``,
    ``tp_collective_matmul``, ``n_experts``, ``expert_parallel``,
    ``pipeline_parallel``, ``pipeline_schedule`` and ``virtual_stages`` as
    in the module docstring; ``dataset_size`` rows in the synthetic table
    (``synthetic`` False: no table, the streaming input path feeds the
    step); ``skip_memory_check`` attempts a run the memory model refuses;
    ``sentinel`` makes the step keep its gradient norm for the numerics
    sentinel; ``n_layer`` overrides the tier's depth (the static audit's
    interleaved arm, as JAX's audit overrides its config); ``layer_loop``
    "scan" holds the block leaves stacked (JAX's ``scan_layers``;
    ``models/tinygpt.ScanBlocks``), "unrolled" one module per layer."""
    if layer_loop not in ("scan", "unrolled"):
        raise ValueError(f"unknown layer_loop {layer_loop!r}")
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
                 "param_dtype": param_torch_dtype(strat), "scan_layers": layer_loop == "scan"}
    overrides.update(_ring_overrides(attention_impl, sequence_parallel, causal, ring_zigzag))
    overrides.update(_moe_overrides(n_experts, expert_parallel))
    if n_layer is not None:
        overrides["n_layer"] = n_layer
    check_pipeline(pipeline_parallel, pipeline_schedule, virtual_stages,
                   get_config(model_family, tier, seq_len, **overrides).n_layer,
                   tensor_parallel, expert_parallel, tp_collective_matmul)
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
                                          dataset_size, kind)
    cfg = dataclasses.replace(cfg, remat=strat.remat)
    est = memory_mod.estimate_hbm(cfg, strat, mesh, per_device_batch, seq_len, dataset_size)
    if mesh.rank == 0:
        print(f"Strategy: {strat.describe()}")
        print(f"Mesh: {mesh.shape} over {kind!r}")
        print(memory_mod.format_breakdown(est, kind))
    refusal = memory_mod.check_fits(est, kind)
    if refusal is not None and skip_memory_check:
        if mesh.rank == 0:
            print(f"WARNING (--skip-memory-check): {refusal}")
    elif refusal is not None:
        raise ValueError(f"{refusal}\nPass --skip-memory-check to attempt the run anyway.")
    interleaved = pipeline_parallel > 1 and pipeline_schedule == "interleaved"
    with torch.device(dev):
        model = TinyGPT(cfg, mesh=mesh, virtual_stages=virtual_stages if interleaved else 1)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    model, optimizer = apply_strategy(model, strat, mesh)
    table = (SyntheticDataset(cfg.vocab_size, seq_len, dataset_size, seed).to_device(dev)
             if synthetic else None)
    pipeline = None
    if pipeline_parallel > 1:
        pipeline = Pipeline(pipeline_schedule, mesh, grad_accum, dev, virtual_stages)
    step_fn = TrainStep(model, optimizer, grad_accum=grad_accum,
                        micro_batch=per_device_batch, seed=seed, device=dev, mesh=mesh,
                        pipeline=pipeline, sentinel=sentinel)
    return Run(dev, cfg, strat, model, table, step_fn, mesh, est)


def _check_dpu_start(strategy: StrategyConfig, start: int, steps: int,
                     warmup_steps: int, resume: bool = False) -> None:
    """JAX's checks of ``offload_dpu_start_step`` (``train/loop.py:655-695``)."""
    if start < 0:
        raise ValueError(f"--offload-dpu-start-step must be >= 0, got {start}")
    if start == 0:
        return
    if not strategy.offload_delayed_update:
        raise ValueError("--offload-dpu-start-step requires --offload-delayed-update")
    if resume:
        raise ValueError(
            "--offload-dpu-start-step is incompatible with --resume (the serial and delayed "
            "phases checkpoint different optimizer-state layouts); restart the run, or drop "
            "the start-step knob"
        )
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
    this rank's rows and columns of it, in percent, rounded to 4 places."""
    step_fn, inner = run.step_fn, getattr(run.model, "module", run.model)
    global_micro = micro * step_fn.members
    row0 = step_fn.member * micro
    rows = step_batch(run.table, 0, 1, global_micro)[0, row0:row0 + micro]
    s, n = step_fn.seq_shard
    rows = rows[:, s * (rows.shape[1] // n):(s + 1) * (rows.shape[1] // n)]
    frac = moe_overflow_fraction(inner, rows, row0, global_micro, step_fn.pipeline)
    return round(float(frac) * 100.0, 4)


def _max_over_ranks(value: float, mesh: Mesh, dev: torch.device) -> float:
    if mesh.group is None:
        return value
    t = torch.tensor([value], dtype=torch.float64,
                     device=dev if dist.get_backend() == "nccl" else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return float(t.item())


def _make_recorder(*, strategy: Union[str, StrategyConfig], world_size: Optional[int],
                   tensor_parallel: int, sequence_parallel: int, pipeline_parallel: int,
                   expert_parallel: int, pipeline_schedule: str, virtual_stages: int,
                   n_experts: int, causal: bool, ring_zigzag: Optional[bool],
                   tp_collective_matmul: bool, seq_len: int, tier: str, model_family: str,
                   per_device_batch: int, grad_accum: int, attention_impl: str,
                   results_dir: Optional[str], telemetry: bool, heartbeat_sec: float,
                   steps: int, data_path: Optional[str]) -> TelemetryRecorder:
    """The run's flight recorder, made from ``run_benchmark``'s arguments
    before any check or device work, so that even a refused run leaves a
    ``run_aborted`` trail."""
    name = strategy if isinstance(strategy, str) else strategy.name
    world = world_size if world_size is not None else dist_rt.get_world_size()
    tp, sp = int(tensor_parallel), int(sequence_parallel)
    pp, ep = int(pipeline_parallel), int(expert_parallel)
    dp = max(world // max(tp * sp * pp * ep, 1), 1)
    rank = dist_rt.get_rank()
    interleaved = pp > 1 and pipeline_schedule == "interleaved"
    meta = {
        "strategy": name, "world_size": world, "rank": rank, "seq_len": seq_len,
        "tier": tier, "model_family": model_family,
        "per_device_batch": per_device_batch, "grad_accum": grad_accum,
        "attention_impl": attention_impl, "tensor_parallel": tp,
        "sequence_parallel": sp, "pipeline_parallel": pp,
        "pipeline_schedule": pipeline_schedule,
        "virtual_stages": int(virtual_stages) if interleaved else 1,
        "expert_parallel": ep, "n_experts": int(n_experts),
        "causal": bool(causal),
        "ring_zigzag": {None: "auto", True: "on", False: "off"}[ring_zigzag],
    }
    if data_path:
        # Stream identity in every heartbeat (synthetic runs omit the key, as
        # in JAX, so their bytes stay as they were).
        meta["data_mode"] = "stream"
    if tp_collective_matmul:
        meta["tp_collective_matmul"] = True
    sup_attempt = os.environ.get("BENCH_SUPERVISED_ATTEMPT", "")
    if sup_attempt.isdigit() and int(sup_attempt) > 1:
        # A supervisor's recovery attempt (runtime/supervisor.py) rides
        # run_meta and every heartbeat, as in JAX; a first attempt and an
        # unsupervised run omit the key.
        meta["supervised_attempt"] = int(sup_attempt)
    rec = TelemetryRecorder(
        metrics_mod.arm_slug(name, world, seq_len, tier, model_family),
        results_dir=results_dir, is_main=rank == 0, enabled=bool(telemetry),
        heartbeat_every_sec=float(heartbeat_sec),
        tokens_per_step=metrics_mod.tokens_per_step(
            per_device_batch, grad_accum, seq_len, dp, ep),
        total_steps=int(steps), rank=rank, meta=meta)
    rec.begin_phase("init")
    return rec


class _StepCursor:
    """The loop's step iterator: ``start .. stop - 1`` like the ``range`` it
    replaces, which the sentinel's rollback rewinds (:meth:`rollback`).
    ``replay_until`` is the highest step measured once already: replayed
    steps up to it stay out of the timed step-time distribution (their
    windows hold the restore; the poisoned measurements were dropped)."""

    def __init__(self, start: int, stop: int):
        self.next_step = start
        self.stop = stop
        self.replay_until = -1

    def __iter__(self) -> "_StepCursor":
        return self

    def __next__(self) -> int:
        if self.next_step >= self.stop:
            raise StopIteration
        s = self.next_step
        self.next_step = s + 1
        return s

    def rollback(self, to_step: int, tripped_at: int) -> None:
        self.next_step = to_step + 1
        self.replay_until = max(self.replay_until, tripped_at)


def _host_copy(sd: dict) -> dict:
    """A host copy of a ``TrainState.state_dict()`` (whose entries may alias
    the live tensors)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}


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
    dataset_size: int = DATASET_SIZE,
    skip_memory_check: bool = False,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    checkpoint_async: bool = False,
    resume: bool = False,
    telemetry: bool = True,
    heartbeat_sec: float = 30.0,
    inject_fault: Optional[str] = None,
    hang_timeout_sec: float = 0.0,
    sentinel: bool = False,
    sentinel_checksum_every: int = 0,
    data_path: Optional[str] = None,
    data_stall_timeout_sec: float = 60.0,
    runtime_log: Optional[dict] = None,
    profile_dir: Optional[str] = None,
    layer_loop: str = "unrolled",
    debug: bool = False,
) -> metrics_mod.BenchmarkResult:
    """Train ``steps`` optimizer steps (the first ``warmup_steps`` untimed)
    and return the result row (on every rank); with ``results_dir`` rank 0
    also writes ``result_<arm>.json`` there and prints the marker-delimited
    JSON, and every rank streams its telemetry beside it.
    ``sequence_parallel``, ``causal``, ``ring_zigzag`` and
    ``world_size``, ``tensor_parallel``, ``tp_collective_matmul``,
    ``n_experts``, ``expert_parallel``, ``pipeline_parallel``,
    ``pipeline_schedule``, ``virtual_stages``, ``dataset_size`` and
    ``skip_memory_check`` as for :func:`build_run`;
    ``offload_dpu_start_step`` as in the module docstring. ``loss_log``,
    when given, gets every step's loss (mean over ranks) appended in order,
    warmup included (from the first step run, after a resume; a rollback
    drops the losses of the steps it undoes, so the list holds the healed
    run's);
    ``offload_log``, when given to an offload arm, gets the host arm's
    per-step times and bytes (``parallel/offload.HostOffload.stats``);
    ``pipeline_log``, when given to a pipelined run, gets this rank's stage,
    the messages it sent per step in each direction and the ms per step it
    waited in receives.

    The run-time layer (module docstring): ``checkpoint_dir`` with
    ``checkpoint_every`` N saves every N steps and at the end,
    ``checkpoint_async`` makes the periodic saves asynchronous, ``resume``
    restores the newest valid step; ``telemetry`` and ``heartbeat_sec``
    drive the flight recorder; ``inject_fault`` arms one fault
    (``faults.parse_fault_spec``; ``INJECT_FAULT`` when None);
    ``hang_timeout_sec`` > 0 arms the hang watchdog; ``sentinel`` arms the
    numerics sentinel, with a parameter checksum every
    ``sentinel_checksum_every`` steps (0: none); ``data_path`` trains on the
    shard stream under that directory instead of the synthetic table, and
    a wait for a batch past ``data_stall_timeout_sec`` stops the run
    (``DataStalled``). ``runtime_log``, when given, gets the sentinel's
    per-checksum device ms and each rollback's restore wall, and the stream
    path's per-step waits.

    ``profile_dir``, as JAX's: rank 0 traces the timed window with
    ``torch.profiler`` (from the warmup boundary to the last timed step,
    one ``ProfilerStep#N`` marker per step; the card's CUDA activity too),
    exports the Chrome trace into the directory, writes
    ``cost_analysis.json`` beside it and puts the step anatomy
    (``analysis/step_anatomy.py``) into the row and a ``step_anatomy``
    telemetry event. Every run, traced or not, reconciles its memory
    (``analysis/memory_anatomy.py``) into the row and a ``memory_anatomy``
    event. Both are best-effort, as in JAX: a failure prints a WARNING
    and leaves the fields null.

    ``layer_loop`` as for :func:`build_run`; ``debug`` is stamped on the row
    (the harness's ``--debug`` turns debug mode on before the process
    group starts: ``runtime/debug.py``).

    This wrapper owns the recorder, the SIGTERM guard and the watchdog: any
    exception that escapes the run is recorded as ``run_aborted`` with its
    phase and last step, and the guard and the watchdog are taken down in
    ``finally`` (the bench runs several rows in one process), and so is a
    prefetch thread."""
    recorder = _make_recorder(
        strategy=strategy, world_size=world_size, tensor_parallel=tensor_parallel,
        sequence_parallel=sequence_parallel, pipeline_parallel=pipeline_parallel,
        expert_parallel=expert_parallel, pipeline_schedule=pipeline_schedule,
        virtual_stages=virtual_stages, n_experts=n_experts, causal=causal,
        ring_zigzag=ring_zigzag, tp_collective_matmul=tp_collective_matmul, seq_len=seq_len,
        tier=tier, model_family=model_family, per_device_batch=per_device_batch,
        grad_accum=grad_accum, attention_impl=attention_impl, results_dir=results_dir,
        telemetry=telemetry, heartbeat_sec=heartbeat_sec, steps=steps, data_path=data_path)
    dist_rt.begin_run()
    guard = PreemptionGuard()
    rank = dist_rt.get_rank()
    watchdog = HangWatchdog(hang_timeout_sec, recorder=recorder, rank=rank)
    # The input stream, its prefetch thread and the profiler, stopped in
    # ``finally``.
    live: dict = {"stream": None, "prefetch": None, "prof": None}
    try:
        if steps <= warmup_steps:
            raise ValueError(
                f"steps={steps} leaves no timed step after warmup_steps={warmup_steps}")
        is_main = rank == 0
        chaos = FaultInjector(
            parse_fault_spec(inject_fault if inject_fault is not None
                             else os.environ.get("INJECT_FAULT")),
            recorder=recorder, is_main=is_main, rank=rank)
        _check_runtime_options(checkpoint_dir, checkpoint_every, checkpoint_async, resume,
                               chaos, sentinel, sentinel_checksum_every, data_path,
                               data_stall_timeout_sec)
        asked = get_strategy(strategy) if isinstance(strategy, str) else strategy
        _check_dpu_start(asked, offload_dpu_start_step, steps, warmup_steps, resume)
        if offload_dpu_start_step > 0:
            # Serial host updates first; the optimizer switches at the start step.
            strategy = dataclasses.replace(asked, offload_delayed_update=False)
        use_stream = data_path is not None
        stream = None
        if use_stream:
            # The stream's open proves the shard set complete before any
            # device work: a missing shard is refused here, by name.
            stream = live["stream"] = ShardedTokenStream(data_path, seq_len=seq_len,
                                                         injector=chaos)
            if is_main:
                print(f"ShardedTokenStream: {stream.describe()}")
        # What the process already holds on the card (an earlier arm's
        # tensors): not this arm's, so the memory anatomy takes it off the peak.
        held_bytes = metrics_mod.hbm_bytes_in_use()
        built = build_run(
            strategy=strategy, tier=tier, seq_len=seq_len, model_family=model_family,
            per_device_batch=per_device_batch, grad_accum=grad_accum,
            attention_impl=attention_impl, dropout=dropout, sequence_parallel=sequence_parallel,
            causal=causal, ring_zigzag=ring_zigzag, seed=seed, device=device,
            world_size=world_size, tensor_parallel=tensor_parallel,
            tp_collective_matmul=tp_collective_matmul, n_experts=n_experts,
            expert_parallel=expert_parallel, pipeline_parallel=pipeline_parallel,
            pipeline_schedule=pipeline_schedule, virtual_stages=virtual_stages,
            dataset_size=dataset_size, skip_memory_check=skip_memory_check,
            sentinel=sentinel, synthetic=not use_stream, layer_loop=layer_loop)
        dev, cfg, strat, model, table, step_fn, mesh = (
            built.device, built.config, built.strategy, built.model, built.table, built.step_fn,
            built.mesh)
        inner = getattr(model, "module", model)
        interleaved = pipeline_parallel > 1 and pipeline_schedule == "interleaved"
        numerics = NumericsSentinel(recorder=recorder, is_main=is_main) if sentinel else None
        if numerics is not None and pipeline_parallel > 1 and is_main:
            print("SENTINEL: grad-norm guard unavailable on pipelined arms (their step returns "
                  "no norm, as JAX's); loss-envelope and checksum guards remain active")
        ckpt = state = None
        if checkpoint_dir is not None or numerics is not None:
            state = TrainState(model, step_fn.optimizer, step_fn)
        start_step, n_restarts, resume_step = 0, 0, -1
        resume_baseline_loss, resume_geometry_changed = 0.0, False
        if checkpoint_dir is not None:
            # The physical layer layout: interleaved stages hold permuted chunks;
            # gpipe / 1f1b / no pipeline share the contiguous layout.
            ckpt = BenchmarkCheckpointer(
                checkpoint_dir, save_every=checkpoint_every,
                layout={"layer_layout": (f"interleaved:pp={pipeline_parallel}:v={virtual_stages}"
                                         if interleaved else "contiguous")},
                geometry={"mesh_axes": mesh_axes_dict(mesh), "world_size": mesh.world},
                async_save=checkpoint_async)
            if resume:
                # Digests are checked newest first, torn steps quarantined; an
                # empty or all-torn directory is a cold start (the retrying
                # orchestration passes --resume on every retry).
                restored = ckpt.restore_latest(state)
                if restored is not None:
                    resume_step = restored
                    start_step = resume_step + 1
                    if start_step >= steps:
                        # A zero-step row would publish 0 tokens/s over the real
                        # result; the refusal leaves no telemetry trail beside it.
                        recorder.discard()
                        raise NothingToResume(
                            f"--resume found checkpoint step {resume_step} but --steps {steps} "
                            "leaves no steps to run: the run already completed (or the "
                            "checkpoint belongs to a longer configuration). Nothing to measure "
                            "— not publishing a zero-step row.")
                    recorder.note("checkpoint_restored", **ckpt.last_restore)
                    resume_geometry_changed = ckpt.last_resume_geometry_changed
                    n_restarts = ckpt.note_restart(geometry_changed=resume_geometry_changed)
                    resume_baseline_loss = float(ckpt.step_meta(resume_step).get("last_loss")
                                                 or 0.0)
                    recorder.note_resume(step=resume_step, n_restarts=n_restarts,
                                         baseline_loss=resume_baseline_loss or None,
                                         geometry_changed=resume_geometry_changed,
                                         source_geometry=ckpt.last_resume_source_geometry)
                    if is_main:
                        stitch = ", geometry changed" if resume_geometry_changed else ""
                        print(f"Resumed from checkpoint at step {resume_step} "
                              f"(restart #{n_restarts}{stitch})")
                elif is_main:
                    print("Resume requested but no valid checkpoint found — cold start")

        # The streaming input path: the records of every step's global batch
        # are consecutive from the cursor; each rank reads its own rows.
        global_micro = per_device_batch * step_fn.members
        records_per_step = grad_accum * global_micro
        cursor_start = 0
        data_meta: List[Optional[dict]] = [None]  # resume meta of the last CONSUMED batch
        data_wait_win, data_wait_timed = [0.0], [0.0]

        def start_prefetch(first_step: int) -> None:
            live["prefetch"] = HostPrefetcher(
                stream, grad_accum=grad_accum, global_micro=global_micro, seq_len=seq_len,
                start_step=first_step, stop_step=steps, device=dev,
                row0=step_fn.member * per_device_batch, micro=per_device_batch,
                seq_shard=step_fn.seq_shard, injector=chaos).start()

        if use_stream:
            # The restored step's sidecar is the authoritative position (its
            # cursor is geometry-free); without one, the closed form, exact
            # for a resume at the same geometry.
            cursor_start = start_step * records_per_step
            if ckpt is not None and resume_step >= 0:
                side = ckpt.read_stream_state(resume_step)
                if side is not None:
                    cursor_start = int(side.get("cursor", cursor_start))
                elif is_main:
                    print("WARNING: resumed checkpoint has no stream-state sidecar; using the "
                          f"closed-form cursor {cursor_start} (exact only for same-geometry "
                          "resumes)")
            stream.seek(cursor_start)
            start_prefetch(start_step)
            if is_main:
                print(f"Streaming data path: cursor {cursor_start}, {records_per_step} "
                      f"records/step, stall timeout {data_stall_timeout_sec:g}s")

        # The sentinel's rollback target when there is no checkpoint cadence:
        # the state before the first dispatch, on the host (world 1 only: a
        # rollback on one rank alone would leave its peers in the next
        # collective; never across the offload's serial -> delayed switch,
        # whose optimizer state changes form).
        mem_snapshot = None
        if (numerics is not None and offload_dpu_start_step == 0 and mesh.world == 1
                and (ckpt is None or checkpoint_every <= 0)):
            mem_snapshot = (_host_copy(state.state_dict()), start_step - 1)
            if is_main:
                print("SENTINEL: no checkpoint cadence — holding an in-memory params/opt-state "
                      "snapshot as the rollback target")
        prior_peak_bytes = None
        if dev.type == "cuda":
            # This arm's peak from here: the bytes it holds now are the
            # memory anatomy's floor for "this run raised the mark".
            torch.cuda.reset_peak_memory_stats(dev)
            prior_peak_bytes = metrics_mod.peak_hbm_bytes()
        _sync(dev)
        trace: dict = {}  # the exported trace (rank 0, profile_dir)

        # Timed stats keyed by step, so a rollback can drop a poisoned tail.
        timed_times, timed_losses, pending = [], [], []
        logged: List[int] = []  # the step of each loss_log entry
        last_loss: List[Optional[float]] = [None]
        cursor = _StepCursor(start_step, steps)

        def note_commits() -> None:
            for entry in ckpt.drain_commits():
                recorder.note("checkpoint_saved", **entry)

        def sync_window(t_start: float) -> None:
            """Fence the window and charge each of its steps the window's mean;
            the sentinel judges each step's loss and grad norm, then the
            telemetry boundary (window event, heartbeat, the stream's
            quarantine and stall events), the watchdog's beat and, last, the
            injector's boundary faults (a fault's trail records the window it
            killed)."""
            if not pending:
                return
            _sync(dev)
            dt = (time.perf_counter() - t_start) / len(pending)
            losses = []
            for s, loss, g_norm in pending:
                lf = float(loss)
                losses.append(lf)
                if loss_log is not None:
                    loss_log.append(lf)
                    logged.append(s)
                if s >= warmup_steps:
                    if s > cursor.replay_until:
                        timed_times.append((s, dt))
                    timed_losses.append((s, lf))
                if s % LOG_EVERY == 0 and is_main:
                    print(f"[Step {s:04d}] Loss: {lf:.4f}, Time: {dt:.3f}s")
                if numerics is not None:
                    numerics.observe(s, lf, float(g_norm) if g_norm is not None else None)
            last = pending[-1][0]
            prefetch = live["prefetch"]
            recorder.step_window(
                last_step=last, losses=losses, window_mean_step_time_sec=dt,
                data_wait_sec=round(data_wait_win[0], 6) if prefetch is not None else None,
                records_skipped=((data_meta[0] or {}).get("records_skipped")
                                 if prefetch is not None else None))
            if prefetch is not None:
                # One data_corrupt_record event per healed record, and a
                # non-fatal data_stall event for a window that starved for
                # more than half its wall.
                for entry in stream.drain_quarantine():
                    recorder.note("data_corrupt_record", step=last, **entry)
                window_wall = dt * len(losses)
                if data_wait_win[0] > max(0.5 * window_wall, 0.05):
                    recorder.note("data_stall", step=last, fatal=False,
                                  wait_sec=round(data_wait_win[0], 6),
                                  window_sec=round(window_wall, 6))
                data_wait_win[0] = 0.0
            last_loss[0] = losses[-1]
            pending.clear()
            watchdog.beat(last)
            chaos.at_boundary(last)

        last_checksum = [start_step]

        def observe_checksum(at_step: int) -> None:
            """The parameter checksum at a fenced boundary (device work off
            the timed path: the caller restarts the window clock)."""
            t0 = time.perf_counter()
            value = float(step_fn.param_checksum())
            if runtime_log is not None:
                runtime_log.setdefault("checksum_ms", []).append(
                    1e3 * (time.perf_counter() - t0))
            numerics.observe_param_checksum(at_step, value)

        def prepare_rollback() -> int:
            """Restore the last validated checkpoint (or the in-memory
            snapshot) for the open trip -> the restored step. Raises
            ``SentinelTripped`` when healing is impossible: no checkpoint
            behind the run and no snapshot, or MAX_ROLLBACKS spent."""
            trip = numerics.trip
            if not numerics.rollback_allowed:
                raise SentinelTripped(
                    trip["kind"], trip["step"],
                    f"{trip['detail']}; {numerics.n_rollbacks} rollback(s) already spent — "
                    "persistent numerics failure, not a transient")
            t0 = time.perf_counter()
            if ckpt is not None:
                recorder.begin_phase("checkpoint")
                restored = ckpt.restore_latest(state)
                if restored is not None:
                    wall = 1e3 * (time.perf_counter() - t0)
                    recorder.note("checkpoint_restored", rollback=True, wall_ms=wall,
                                  **ckpt.last_restore)
                    if runtime_log is not None:
                        runtime_log.setdefault("restore_wall_ms", []).append(wall)
                    return restored
            if mem_snapshot is not None:
                recorder.begin_phase("checkpoint")
                snap, snap_step = mem_snapshot
                state.load_state_dict(snap)
                _sync(dev)
                wall = 1e3 * (time.perf_counter() - t0)
                recorder.note("checkpoint_restored", rollback=True, source="memory",
                              step=snap_step, wall_ms=wall)
                if runtime_log is not None:
                    runtime_log.setdefault("restore_wall_ms", []).append(wall)
                if is_main:
                    print("SENTINEL: rolling back to the in-memory snapshot (no checkpoint "
                          "cadence)")
                return snap_step
            raise SentinelTripped(
                trip["kind"], trip["step"],
                f"{trip['detail']}; " + ("no validated checkpoint committed yet"
                                         if ckpt is not None else
                                         "no --checkpoint-dir (and no in-memory snapshot on "
                                         "this run shape) to roll back to"))

        def rewind_stream(rb_step: int) -> None:
            """The replay's input: stop the prefetcher (joined: its thread
            advances ``stream.cursor`` as it reads ahead), seek to the
            restored step's sidecar cursor (the closed form without one), and
            start a new prefetcher at ``rb_step + 1``. The replay re-consumes
            the same records: the poison was the device state, not the
            stream."""
            live["prefetch"].stop(join=True)
            rewind = cursor_start + max(rb_step + 1 - start_step, 0) * records_per_step
            if ckpt is not None and rb_step >= 0:
                side = ckpt.read_stream_state(rb_step)
                if side is not None:
                    rewind = int(side.get("cursor", rewind))
            stream.seek(rewind)
            data_meta[0] = None
            start_prefetch(rb_step + 1)
            if is_main:
                print(f"SENTINEL: stream rewound to cursor {rewind} — replaying records from "
                      f"step {rb_step + 1}", flush=True)

        def roll_back_if_tripped() -> bool:
            """The whole heal of an open trip: restore, drop the poisoned tail
            from the timed lists (and ``loss_log``), record the rollback,
            rewind the step cursor and the input (the stream's cursor, or the
            dropout generator on a fresh stream: the synthetic path also
            folds the replay count into the table's row index)."""
            if numerics.trip is None:
                return False
            tripped_at = numerics.trip["step"]
            rb_step = prepare_rollback()
            timed_times[:] = [e for e in timed_times if e[0] <= rb_step]
            timed_losses[:] = [e for e in timed_losses if e[0] <= rb_step]
            if loss_log is not None:
                keep = [i for i, s in enumerate(logged) if s <= rb_step]
                loss_log[:] = [loss_log[i] for i in keep]
                logged[:] = [logged[i] for i in keep]
            numerics.note_rollback(from_step=tripped_at, to_step=rb_step)
            recorder.begin_phase("timed" if rb_step + 1 >= warmup_steps else "warmup")
            cursor.rollback(rb_step, tripped_at)
            if live["prefetch"] is not None:
                rewind_stream(rb_step)
            else:
                step_fn.reseed(seed, numerics.data_reseeds)
            return True

        def stream_state_for(at_step: int) -> Optional[dict]:
            """The stream sidecar of a boundary at ``at_step``: the records
            delivered to training through it (closed form from the run's own
            consumption, never the prefetcher's read-ahead position)."""
            if stream is None:
                return None
            delivered = cursor_start + max(at_step + 1 - start_step, 0) * records_per_step
            return {"schema_version": STREAM_STATE_SCHEMA_VERSION, "cursor": delivered,
                    "records_skipped": (data_meta[0] or {}).get("records_skipped",
                                                                stream.records_skipped),
                    "total_records": stream.total_records}

        def data_stall_stop(at_step: int, waited: float) -> None:
            """The input starved the loop past the timeout, at a fenced
            boundary (the device state is healthy): save with the stream
            sidecar (not over an open sentinel trip), emit the fatal
            ``data_stall`` event and a final heartbeat, record ``run_aborted
            reason=data_stall`` and raise ``DataStalled`` (exit 78 in the
            harness; the sidecar makes the retry consume exactly the records
            not consumed)."""
            saved = None
            if (ckpt is not None and at_step >= max(start_step, 0)
                    and (numerics is None or numerics.trip is None)):
                recorder.begin_phase("checkpoint")
                try:
                    ckpt.finalize_pending()
                    note_commits()
                    if ckpt.latest_step() == at_step:
                        saved = at_step
                    else:
                        ckpt.save(at_step, state, force=True,
                                  meta={"last_loss": last_loss[0], "emergency": True,
                                        "reason": "data_stall"},
                                  stream_state=stream_state_for(at_step))
                        note_commits()
                        saved = at_step
                        if is_main:
                            print(f"Emergency checkpoint saved at step {at_step} (data stall)")
                except Exception as e:
                    recorder.note("checkpoint_failed", step=at_step, error=str(e),
                                  emergency=True)
                    if is_main:
                        print(f"WARNING: emergency checkpoint at step {at_step} failed ({e}); "
                              "aborting as a plain data-stall partial")
            recorder.note("data_stall", step=at_step + 1, fatal=True, wait_sec=round(waited, 3),
                          timeout_sec=data_stall_timeout_sec)
            recorder.emergency_heartbeat(reason="data_stall",
                                         extra={"emergency_checkpoint_step": saved})
            recorder.abort("data_stall")
            raise DataStalled(at_step + 1, waited, saved_step=saved)

        def emergency_stop(at_step: int) -> None:
            """SIGTERM landed: at this fenced boundary (nothing pending), save
            (or, with async saves, commit the one in flight), send the final
            heartbeat, record ``run_aborted reason=preempted`` and raise."""
            saved = None
            if (ckpt is not None and ckpt.async_save and at_step >= max(start_step, 0)
                    and (ckpt.pending_async_step() is not None or ckpt.latest_step() is not None)):
                recorder.begin_phase("checkpoint")
                try:
                    flushed = ckpt.finalize_pending()
                    note_commits()
                    saved = ckpt.latest_step() if flushed is None else flushed
                    recorder.note("emergency_flush", mode="async-delta", step=at_step,
                                  committed_step=saved,
                                  steps_delta=at_step - saved if saved is not None else None)
                    if is_main:
                        print(f"Emergency flush: async checkpoint at step {saved} committed "
                              f"(preempted at boundary {at_step}; {at_step - saved} step(s) of "
                              "recompute on resume)")
                except Exception as e:
                    recorder.note("checkpoint_failed", step=at_step, error=str(e), emergency=True)
                    saved = None
                    if is_main:
                        print(f"WARNING: emergency async flush at step {at_step} failed ({e}); "
                              "aborting as a plain partial")
            elif ckpt is not None and at_step >= max(start_step, 0):
                if ckpt.latest_step() == at_step:
                    saved = at_step
                else:
                    recorder.begin_phase("checkpoint")
                    try:
                        ckpt.save(at_step, state, force=True,
                                  meta={"last_loss": last_loss[0], "emergency": True,
                                        "reason": "preempted"},
                                  stream_state=stream_state_for(at_step))
                        note_commits()
                        saved = at_step
                        if is_main:
                            print(f"Emergency checkpoint saved at step {at_step} (preempted)")
                    except Exception as e:
                        recorder.note("checkpoint_failed", step=at_step, error=str(e),
                                      emergency=True)
                        if is_main:
                            print(f"WARNING: emergency checkpoint at step {at_step} failed ({e}); "
                                  "aborting as a plain partial")
            recorder.emergency_heartbeat(reason="preempted",
                                         extra={"emergency_checkpoint_step": saved})
            recorder.abort("preempted")
            raise Preempted(at_step, saved)

        if guard.requested and dist_rt.get_world_size() <= 1:
            emergency_stop(start_step - 1)

        watchdog.start()
        # The first dispatched step up to its fence: the kernels' lazy build
        # and the allocator's first growth.
        recorder.begin_phase("compile")
        t_window = time.perf_counter()
        for step in cursor:
            # Sentinel boundary work first (nothing pending: the previous
            # iteration ended at a fenced boundary): an open trip is rolled
            # back before anything dispatches on the poisoned state.
            if numerics is not None and not pending:
                rolled = roll_back_if_tripped()
                if (not rolled and sentinel_checksum_every > 0
                        and step - last_checksum[0] >= sentinel_checksum_every):
                    last_checksum[0] = step
                    observe_checksum(step - 1)
                    rolled = roll_back_if_tripped()
                    t_window = time.perf_counter()
                if rolled:
                    t_window = time.perf_counter()
                    continue
            if profile_dir and step == warmup_steps and is_main and live["prof"] is None:
                # The trace covers the timed window, as JAX's: it starts at
                # the warmup boundary, fenced, its start charged to 'trace'.
                sync_window(t_window)
                recorder.begin_phase("trace")
                live["prof"] = _start_trace(dev, step)
                t_window = time.perf_counter()
            elif live["prof"] is not None:
                _trace_step(live["prof"], step)
            if step == warmup_steps and step > start_step:
                if sync_every > 1:
                    sync_window(t_window)
                recorder.begin_phase("timed")
                t_window = time.perf_counter()
            if offload_dpu_start_step > 0 and step == offload_dpu_start_step:
                sync_window(t_window)
                step_fn.optimizer.host.begin_delayed()
                if is_main:
                    print(f"[Step {step:04d}] delayed-update phase begins")
                t_window = time.perf_counter()
            # The sentinel's proof faults poison the state just before step N.
            chaos.corrupt_params(step, inner, step_fn.optimizer)
            chaos.corrupt_opt_state(step, step_fn.optimizer)
            if live["prefetch"] is not None:
                # The one blocking pull on the input path inside the timed
                # loop: its wait feeds data_stall_frac; a starvation past the
                # timeout on any rank stops every rank at this boundary.
                try:
                    batch, meta, waited = live["prefetch"].get(step,
                                                               timeout=data_stall_timeout_sec)
                    starved = None
                except DataStallTimeout as e:
                    batch, meta, waited, starved = None, None, e.waited_sec, e.waited_sec
                starved = dist_rt.agree_data_ready(
                    step, starved, data_stall_timeout_sec + DATA_AGREE_SLACK_SEC,
                    generation=numerics.n_rollbacks if numerics is not None else 0)
                if starved is not None:
                    sync_window(t_window)
                    data_stall_stop(step - 1, starved)
                data_meta[0] = meta
                data_wait_win[0] += waited
                if step >= warmup_steps:
                    data_wait_timed[0] += waited
                if runtime_log is not None:
                    runtime_log.setdefault("data_wait_ms", []).append(1e3 * waited)
                loss = step_fn.run_batch(batch)
            else:
                # After k rollbacks the synthetic path reads the table at
                # step + k * steps: a replay draws fresh rows (as JAX folds it).
                loss = step_fn(table, step + (numerics.data_reseeds * steps
                                              if numerics is not None else 0))
            pending.append((step, chaos.corrupt_loss(step, loss), step_fn.optimizer.grad_norm))
            if step == start_step and step < warmup_steps:
                sync_window(t_window)
                recorder.begin_phase("warmup")
                t_window = time.perf_counter()
            if len(pending) >= sync_every or step == steps - 1:
                sync_window(t_window)
                if recorder.phase in ("compile", "trace"):
                    # A first step that is also timed (warmup 0, or a resume
                    # past warmup, which may also trace): its window holds the
                    # compile, and everything after is 'timed'.
                    recorder.begin_phase("timed")
                t_window = time.perf_counter()
            if (ckpt is not None and ckpt.should_save(step)
                    and step >= offload_dpu_start_step):
                sync_window(t_window)
                if numerics is not None and numerics.trip is None:
                    # The pre-save checksum, whatever the cadence: no save may
                    # persist a state the checksum guard would reject.
                    last_checksum[0] = step
                    observe_checksum(step)
                if numerics is not None and numerics.trip is not None:
                    # Saving now would checkpoint the poison; the rollback runs
                    # at the top of the next iteration.
                    if is_main:
                        print(f"SENTINEL: skipping checkpoint save at step {step} (open "
                              f"{numerics.trip['kind']} trip)")
                else:
                    recorder.begin_phase("checkpoint")
                    try:
                        chaos.maybe_fail_save()
                        ckpt.save(step, state, meta={"last_loss": last_loss[0]},
                                  stream_state=stream_state_for(step))
                        note_commits()
                        if is_main:
                            mode = " (async dispatch)" if ckpt.async_save else ""
                            print(f"Checkpoint saved at step {step}{mode}")
                        chaos.after_save(ckpt, step)
                    except OSError as e:
                        recorder.note("checkpoint_failed", step=step, error=str(e))
                        if is_main:
                            print(f"WARNING: checkpoint save at step {step} failed ({e}); "
                                  "continuing without")
                recorder.begin_phase("timed" if step >= warmup_steps else "warmup")
                t_window = time.perf_counter()
            if not pending:
                peer = watchdog.peer_hang()
                if peer is not None:
                    watchdog.disarm()
                    abort_on_peer_hang(recorder, step, peer)
                target = guard.coordinate(step)
                if target is not None and target <= step < steps - 1:
                    emergency_stop(step)

        sync_window(t_window)
        watchdog.beat(steps - 1)
        if live["prof"] is not None:
            # Stopping serializes the trace: seconds for a long run, so it
            # is charged to 'trace', not to the phase the loop left open.
            recorder.begin_phase("trace")
            prof, live["prof"] = live["prof"], None
            trace = _stop_trace(prof, profile_dir)
            recorder.note("profile_trace", **trace)
            print(f"Profiler trace: {trace['path']} ({trace['bytes']} bytes; stop "
                  f"{trace['stop_sec']:.2f} s, export {trace['export_sec']:.2f} s)")
        if numerics is not None and numerics.trip is not None:
            # A trip at the last boundary: no step is left to replay the
            # poison out of, and publishing would put it in the row.
            trip = numerics.trip
            raise SentinelTripped(trip["kind"], trip["step"],
                                  f"{trip['detail']}; tripped at the final boundary — nothing "
                                  "left to replay, not publishing a poisoned row")
        if guard.requested and is_main:
            print("NOTE: preemption requested during the final window; all steps completed — "
                  "publishing the result before exiting")
        if ckpt is not None:
            recorder.begin_phase("checkpoint")
            if steps - 1 not in (ckpt.latest_step(), ckpt.pending_async_step()):
                if numerics is not None:
                    # The final state is what every later --resume restores.
                    observe_checksum(steps - 1)
                    if numerics.trip is not None:
                        trip = numerics.trip
                        raise SentinelTripped(
                            trip["kind"], trip["step"],
                            f"{trip['detail']}; final-state checksum failed — not committing "
                            "a poisoned final checkpoint")
                try:
                    chaos.maybe_fail_save()
                    ckpt.save(steps - 1, state, force=True, meta={"last_loss": last_loss[0]},
                              stream_state=stream_state_for(steps - 1))
                except OSError as e:
                    recorder.note("checkpoint_failed", step=steps - 1, error=str(e))
                    if is_main:
                        print(f"WARNING: final checkpoint save failed ({e})")
            ckpt.close()
            note_commits()
            watchdog.beat(steps - 1)
        recorder.begin_phase("finalize")
        dist_rt.barrier()
        watchdog.disarm()
        if live["prefetch"] is not None:
            # Every step consumed its batch: release the thread and the files.
            live["prefetch"].stop()
            stream.close()

        if offload_log is not None and step_fn.optimizer.host is not None:
            offload_log.update(step_fn.optimizer.host.stats())
        if pipeline_log is not None and step_fn.pipeline is not None:
            transport = step_fn.pipeline.transport
            pipeline_log.update(stage=step_fn.pipeline.stage,
                                       sent_per_step=[n / steps for n in transport.sent],
                                       wait_ms_per_step=1e3 * transport.wait_s / steps,
                                       host_staged=transport.staged)
        peak_gb, peak_method = metrics_mod.measure_peak_memory(dev)
        # The anatomies read the peak before the MoE diagnostic's forward, as
        # JAX's loop does.
        memory_anatomy = _memory_anatomy(built.estimate, prior_peak_bytes, held_bytes, dev,
                                         recorder, is_main)
        dp = max(mesh.world // (tensor_parallel * sequence_parallel * pipeline_parallel
                                * expert_parallel), 1)
        step_anatomy = _step_anatomy(
            trace, profile_dir, recorder,
            cost_flops_per_token=flops_mod.train_flops_per_token(cfg),
            step_tokens=metrics_mod.tokens_per_step(per_device_batch, grad_accum, seq_len, dp,
                                                    expert_parallel),
            kind=device_kind(dev), world=mesh.world,
            pipeline_schedule=pipeline_schedule if pipeline_parallel > 1 else None)
        overflow = None
        if cfg.n_experts > 0 and interleaved:
            if is_main:
                print("NOTE: MoE overflow diagnostic skipped under the interleaved schedule (its "
                      "stages hold permuted layer chunks; JAX skips it there too)")
        elif cfg.n_experts > 0 and use_stream:
            if is_main:
                print("NOTE: MoE overflow diagnostic skipped on the streaming data path (its "
                      "probe batch is the synthetic table's; JAX skips it there too)")
        elif cfg.n_experts > 0:
            overflow = _overflow_pct(built, per_device_batch)
        peak_gb = _max_over_ranks(peak_gb, mesh, dev)
        step_times = [dt for _s, dt in timed_times]
        losses = [lf for _s, lf in timed_losses]
        # The stream's row accounting: data_stall_frac is the share of the
        # timed steps' wall spent waiting for input; the cursor pair is the
        # measured position (the last consumed batch's snapshot).
        data_stall_frac, stream_cursor_end, records_consumed, records_skipped = None, -1, 0, 0
        if use_stream:
            timed_total = sum(step_times)
            data_stall_frac = (max(0.0, min(data_wait_timed[0] / timed_total, 1.0))
                               if timed_total > 0 else 0.0)
            stream_cursor_end = (data_meta[0] or {}).get("cursor", cursor_start)
            records_consumed = stream_cursor_end - cursor_start
            records_skipped = stream.records_skipped
        result = metrics_mod.compute_result(
            strategy=strat.name, world_size=mesh.world, seq_len=seq_len, tier=tier,
            steps=steps, per_device_batch=per_device_batch, grad_accum=grad_accum,
            step_times=step_times, losses=losses, peak_gb=peak_gb,
            peak_method=peak_method, device_kind=device_kind(dev), backend=dev.type,
            n_params=_global_params(cfg, model, mesh), attention_impl=cfg.attention_impl,
            dropout=cfg.dropout, causal=cfg.causal, model_family=model_family,
            flops_per_token=flops_mod.train_flops_per_token(cfg), sync_every=sync_every,
            phase_times=recorder.phase_times(), wall_time_total_sec=recorder.wall_time_total(),
            sequence_parallel=sequence_parallel,
            ring_zigzag={None: "auto", True: "on", False: "off"}[cfg.ring_zigzag],
            tensor_parallel=tensor_parallel,
            tp_collective_matmul=tp_collective_matmul,
            param_dtype=strat.param_dtype, offload_opt_state=strat.offload_opt_state,
            offload_delayed_update=asked.offload_delayed_update,
            offload_dpu_start_step=offload_dpu_start_step,
            expert_parallel=expert_parallel, n_experts=n_experts, remat_policy=cfg.remat,
            expert_overflow_pct=overflow, pipeline_parallel=pipeline_parallel,
            pipeline_schedule=pipeline_schedule,
            virtual_stages=virtual_stages if interleaved else 1,
            resumed=resume_step >= 0, n_restarts=n_restarts, resume_step=resume_step,
            resume_baseline_loss=resume_baseline_loss,
            resume_geometry_changed=resume_geometry_changed, n_anomalies=recorder.n_anomalies,
            n_rollbacks=numerics.n_rollbacks if numerics is not None else 0,
            rollback_steps_replayed=(numerics.rollback_steps_replayed
                                     if numerics is not None else 0),
            data_mode="stream" if use_stream else "synthetic",
            data_stall_frac=round(data_stall_frac, 6) if data_stall_frac is not None else None,
            data_stall_sec=round(data_wait_timed[0], 4), records_consumed=records_consumed,
            records_skipped=records_skipped,
            stream_cursor_start=cursor_start if use_stream else -1,
            stream_cursor_end=stream_cursor_end,
            step_anatomy=step_anatomy, memory_anatomy=memory_anatomy,
            layer_loop=layer_loop, debug=bool(debug),
        )
        if results_dir is not None and is_main:
            metrics_mod.emit_result(result, results_dir)
        recorder.close("ok")
        return result
    except BaseException as e:
        watchdog.join_firing()
        recorder.abort(f"exception:{type(e).__name__}: {e}")
        raise
    finally:
        watchdog.disarm()
        guard.uninstall()
        if live["prof"] is not None:
            # A run that died inside the traced window: the process's
            # profiler must not stay on under the next run.
            live["prof"].stop()
        if live["prefetch"] is not None:
            live["prefetch"].stop(join=True)
        if live["stream"] is not None:
            live["stream"].close()


def _step_anatomy(trace: dict, profile_dir: Optional[str], recorder: TelemetryRecorder, *,
                  cost_flops_per_token: float, step_tokens: int, kind: str, world: int,
                  pipeline_schedule: Optional[str]) -> Optional[dict]:
    """The row's step-anatomy fields from the trace this run exported (None
    when it exported none): the cost JSON beside it (the model's FLOPs of a
    step), the analysis clipped to the telemetry's timed phase, a
    ``step_anatomy`` event with the exposed time by collective class, and
    the report printed. Best-effort, as in JAX: a trace the engine cannot
    read (a CPU run's has no device step) leaves the fields null."""
    if not trace:
        return None
    try:
        from ..analysis import profile_summary, step_anatomy as anatomy_mod

        cost = anatomy_mod.cost_from_model(cost_flops_per_token, step_tokens, device_kind=kind,
                                           world_size=world)
        if cost is not None:
            anatomy_mod.write_cost_json(profile_dir, cost)
        report = anatomy_mod.analyze_profile_dir(
            profile_dir, run=profile_summary.run_name(trace["path"]),
            telemetry_path=recorder.path, cost=cost, pipeline_schedule=pipeline_schedule)
        fields = anatomy_mod.result_fields(report)
        recorder.note("step_anatomy", **fields,
                      comms_exposed_by_class=anatomy_mod.exposed_by_class_fracs(report))
        print(anatomy_mod.format_report(report))
        return fields
    except Exception as e:  # never fail a measured run on its analysis
        print(f"WARNING: step-anatomy attribution skipped: {e}")
        return None


def _memory_anatomy(est: memory_mod.HBMEstimate, prior_peak_bytes: Optional[int],
                    held_bytes: Optional[int], dev: torch.device, recorder: TelemetryRecorder,
                    is_main: bool) -> Optional[dict]:
    """The row's memory-anatomy fields: the estimate reconciled with the
    allocator's peak on the card (the estimate alone on the CPU), a
    ``memory_anatomy`` event and, on rank 0, the report. Best-effort, as in
    JAX."""
    try:
        from ..analysis import memory_anatomy as memano

        measured, reason = memano.measured_peak_bytes(prior_peak_bytes, device=dev,
                                                      held_bytes=held_bytes)
        report = memano.reconcile(est, compile_mem=memano.compile_memory_fields(),
                                  measured_bytes=measured, measured_reason=reason)
        fields = memano.result_fields(report, est_breakdown=est.breakdown())
        recorder.note("memory_anatomy", **fields)
        if is_main:
            print(memano.format_report(report))
        return fields
    except Exception as e:  # never fail a measured run on its accounting
        if is_main:
            print(f"WARNING: memory-anatomy reconciliation skipped: {e}")
        return None


def _check_runtime_options(checkpoint_dir: Optional[str], checkpoint_every: int,
                           checkpoint_async: bool, resume: bool, chaos: FaultInjector,
                           sentinel: bool = False, sentinel_checksum_every: int = 0,
                           data_path: Optional[str] = None,
                           data_stall_timeout_sec: float = 60.0) -> None:
    """Refuse a run-time option that would have no effect: every accepted
    option is live."""
    if checkpoint_every < 0:
        raise ValueError(f"--checkpoint-every must be >= 0, got {checkpoint_every}")
    if checkpoint_dir is None:
        given = [flag for flag, on in (("--checkpoint-every", checkpoint_every > 0),
                                       ("--checkpoint-async", checkpoint_async),
                                       ("--resume", resume)) if on]
        if given:
            raise ValueError(f"{', '.join(given)} need{'s' if len(given) == 1 else ''} "
                             "--checkpoint-dir (there is nowhere to save or resume from)")
    if sentinel_checksum_every < 0:
        raise ValueError(
            f"--sentinel-checksum-every must be >= 0, got {sentinel_checksum_every}")
    if sentinel_checksum_every > 0 and not sentinel:
        raise ValueError("--sentinel-checksum-every needs --sentinel on (the checksum is one of "
                         "the sentinel's guards)")
    if data_path is not None and data_stall_timeout_sec <= 0:
        # A non-positive timeout would call every batch wait a fatal stall.
        raise ValueError(f"--data-stall-timeout-sec must be > 0, got {data_stall_timeout_sec}")
    spec = chaos.spec
    if spec is not None and spec.kind in DATA_KINDS and data_path is None:
        # Without the stream the data hooks have no consumer: the run would
        # pass off an inert injection as a survived one.
        raise ValueError(
            f"--inject-fault {spec} is a streaming-data fault and requires --data-path "
            "(without the stream the injector's data hooks have no consumer and the chaos run "
            "is inert)")
    if spec is not None and spec.kind in ("torn-checkpoint", "enospc-on-save") and (
            checkpoint_dir is None):
        raise ValueError(f"--inject-fault {spec} fires on checkpoint saves and needs "
                         "--checkpoint-dir")
