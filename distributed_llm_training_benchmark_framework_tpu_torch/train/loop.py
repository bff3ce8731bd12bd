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

``world_size`` is the width of the ``data`` axis: the size of the process
group the caller (``runtime.setup_distributed``, or torchrun through the
bench entry) made, one card per process, or 1 without a group. Every rank
runs this loop; rank 0 alone prints and emits the row, which carries the
group's size and the highest peak memory of any rank.

``sequence_parallel`` > 1 runs ring attention over that many sequence
shards. In this port all of them are held on the one device, in one process
(``ops/ring_attention.py``), so it composes with a ``data`` width of 1
only, and the row stamps ``sequence_parallel`` beside ``world_size``.

Runs on ``cuda`` unless ``device="cpu"`` is passed; with no CUDA device and
no explicit ``cpu`` it raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Union

import torch
import torch.distributed as dist

from ..data.synthetic import SyntheticDataset
from ..models import TinyGPT, TinyGPTConfig, count_params, get_config
from ..parallel.mesh import AXES, Mesh, make_mesh
from ..parallel.strategies import StrategyConfig, apply_strategy, check_ported, get_strategy
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
    if sequence_parallel > 1 and attention_impl != "ring":
        raise ValueError(
            "sequence_parallel > 1 requires attention_impl 'ring' (the port has no "
            f"Ulysses attention yet); got {attention_impl!r}"
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


def build_run(*, strategy: Union[str, StrategyConfig] = "zero2", tier: str = "A",
              seq_len: int = 2048, model_family: str = "tinygpt", per_device_batch: int = 1,
              grad_accum: int = 4, attention_impl: str = "flash",
              dropout: Optional[float] = None, sequence_parallel: int = 1,
              causal: bool = False, ring_zigzag: Optional[bool] = None, seed: int = 42,
              device: Optional[str] = None, world_size: Optional[int] = None) -> Run:
    """Model (initialised from ``seed``, the same on every rank), the arm's
    layout and optimizer, device-resident table and train step of one arm;
    ``run_benchmark`` and the step profiler share it. ``causal`` turns
    causal masking on (Llama is causal anyway); ``ring_zigzag`` None is
    auto; ``world_size`` None is the process group's size, and another
    value than that size is refused."""
    dev = resolve_device(device)
    strat = get_strategy(strategy) if isinstance(strategy, str) else strategy
    check_ported(strat)
    mesh = make_mesh((sequence_parallel,), (AXES.seq,))
    dp = mesh.size(AXES.data)
    if world_size is not None and world_size != dp:
        raise ValueError(
            f"world_size={world_size} but the process group has {dp} process"
            f"{'es' if dp > 1 else ''} (one card each); launch {world_size} processes "
            "(torchrun --nproc_per_node) or leave world_size unset"
        )
    if sequence_parallel > 1 and dp > 1:
        raise ValueError(
            "sequence_parallel > 1 with world_size > 1 is not ported yet: the port holds "
            "every sequence shard in one process (ROADMAP Queue 1 item 11, the "
            "multi-process sequence-parallel trainer)"
        )
    overrides = {"attention_impl": attention_impl,
                 "compute_dtype": torch.bfloat16 if strat.precision == "bf16" else torch.float32}
    overrides.update(_ring_overrides(attention_impl, sequence_parallel, causal, ring_zigzag))
    if dropout is not None:
        overrides["dropout"] = dropout
    cfg = get_config(model_family, tier, seq_len, **overrides)
    kind = device_kind(dev)
    strat = memory_mod.resolve_auto_remat(cfg, strat, mesh, per_device_batch, seq_len,
                                          DATASET_SIZE, kind)
    cfg = dataclasses.replace(cfg, remat=strat.remat)
    est = memory_mod.estimate_hbm(cfg, strat, mesh, per_device_batch, seq_len, DATASET_SIZE)
    if mesh.data_rank == 0:
        print(f"Strategy: {strat.describe()}")
        print(f"Mesh: {mesh.shape} over {kind!r}")
        print(memory_mod.format_breakdown(est, kind))
    refusal = memory_mod.check_fits(est, kind)
    if refusal is not None:
        raise ValueError(refusal)
    with torch.device(dev):
        model = TinyGPT(cfg, mesh=mesh)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    model, optimizer = apply_strategy(model, strat, mesh)
    table = SyntheticDataset(cfg.vocab_size, seq_len, DATASET_SIZE, seed).to_device(dev)
    step_fn = TrainStep(model, optimizer, grad_accum=grad_accum,
                        micro_batch=per_device_batch, seed=seed, device=dev, mesh=mesh)
    return Run(dev, cfg, strat, model, table, step_fn, mesh)


def _max_over_ranks(value: float, mesh: Mesh, dev: torch.device) -> float:
    if mesh.data_group is None:
        return value
    t = torch.tensor([value], dtype=torch.float64,
                     device=dev if dist.get_backend() == "nccl" else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.data_group)
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
) -> metrics_mod.BenchmarkResult:
    """Train ``steps`` optimizer steps (the first ``warmup_steps`` untimed)
    and return the result row (on every rank); with ``results_dir`` rank 0
    also writes ``result_<arm>.json`` there and prints the marker-delimited
    JSON. ``sequence_parallel``, ``causal``, ``ring_zigzag`` and
    ``world_size`` as for :func:`build_run`. ``loss_log``, when given, gets
    every step's loss (mean over ranks) appended in order, warmup included."""
    if steps <= warmup_steps:
        raise ValueError(f"steps={steps} leaves no timed step after warmup_steps={warmup_steps}")
    t_start = time.perf_counter()
    run = build_run(strategy=strategy, tier=tier, seq_len=seq_len, model_family=model_family,
                    per_device_batch=per_device_batch, grad_accum=grad_accum,
                    attention_impl=attention_impl, dropout=dropout,
                    sequence_parallel=sequence_parallel, causal=causal,
                    ring_zigzag=ring_zigzag, seed=seed, device=device,
                    world_size=world_size)
    dev, cfg, strat, model, table, step_fn, mesh = (
        run.device, run.config, run.strategy, run.model, run.table, run.step_fn, run.mesh)
    is_main = mesh.data_rank == 0
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
        pending.append((step, step_fn(table, step)))
        if len(pending) >= sync_every or step == warmup_steps - 1 or step == steps - 1:
            sync_window()

    peak_gb, peak_method = metrics_mod.measure_peak_memory(dev)
    peak_gb = _max_over_ranks(peak_gb, mesh, dev)
    result = metrics_mod.compute_result(
        strategy=strat.name, world_size=mesh.size(AXES.data), seq_len=seq_len, tier=tier,
        steps=steps,
        per_device_batch=per_device_batch, grad_accum=grad_accum,
        step_times=timed_times, losses=timed_losses, peak_gb=peak_gb,
        peak_method=peak_method, device_kind=device_kind(dev), backend=dev.type,
        n_params=count_params(model), attention_impl=cfg.attention_impl,
        dropout=cfg.dropout, causal=cfg.causal, model_family=model_family,
        flops_per_token=flops_mod.train_flops_per_token(cfg), sync_every=sync_every,
        phase_times=phase, wall_time_total_sec=time.perf_counter() - t_start,
        sequence_parallel=sequence_parallel,
        ring_zigzag={None: "auto", True: "on", False: "off"}[cfg.ring_zigzag],
    )
    if results_dir is not None and is_main:
        metrics_mod.emit_result(result, results_dir)
    return result
