"""The timed benchmark loop.

Port of the core of ``distributed_llm_training_benchmark_framework_tpu/train/loop.py``
(``run_benchmark``): build the model, optimizer and device-resident table,
run ``warmup_steps`` untimed steps, then the timed steps in windows of
``sync_every`` steps fenced by ``torch.cuda.synchronize()`` (each step of a
window is charged the window's mean), and compute the result row.
Telemetry, checkpoints, fault injection, the numerics sentinel and the
streaming input path are not ported yet.

``sequence_parallel`` > 1 runs ring attention over that many sequence
shards. In this port all of them are held on the one device, in one process
(``ops/ring_attention.py``), so the row keeps ``world_size`` 1 and stamps
``sequence_parallel`` beside it.

Runs on ``cuda`` unless ``device="cpu"`` is passed; with no CUDA device and
no explicit ``cpu`` it raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Union

import torch

from ..data.synthetic import SyntheticDataset
from ..models import TinyGPT, TinyGPTConfig, count_params, get_config
from ..parallel.mesh import AXES, make_mesh
from ..parallel.strategies import StrategyConfig, get_strategy, make_optimizer
from ..utils import flops as flops_mod
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
    strategy: StrategyConfig
    model: TinyGPT
    table: torch.Tensor
    step_fn: TrainStep


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
              device: Optional[str] = None) -> Run:
    """Model (initialised from ``seed``), optimizer, device-resident table and
    train step of one arm; ``run_benchmark`` and the step profiler share it.
    ``causal`` turns causal masking on (Llama is causal anyway);
    ``ring_zigzag`` None is auto."""
    dev = resolve_device(device)
    strat = get_strategy(strategy) if isinstance(strategy, str) else strategy
    overrides = {"attention_impl": attention_impl}
    overrides.update(_ring_overrides(attention_impl, sequence_parallel, causal, ring_zigzag))
    if dropout is not None:
        overrides["dropout"] = dropout
    cfg = get_config(model_family, tier, seq_len, **overrides)
    mesh = make_mesh((sequence_parallel,), (AXES.seq,))
    with torch.device(dev):
        model = TinyGPT(cfg, mesh=mesh)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    optimizer = make_optimizer(strat, model.parameters())
    table = SyntheticDataset(cfg.vocab_size, seq_len, DATASET_SIZE, seed).to_device(dev)
    step_fn = TrainStep(model, optimizer, grad_accum=grad_accum,
                        micro_batch=per_device_batch, seed=seed, device=dev)
    return Run(dev, cfg, strat, model, table, step_fn)


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
) -> metrics_mod.BenchmarkResult:
    """Train ``steps`` optimizer steps (the first ``warmup_steps`` untimed)
    on one device and return the result row; with ``results_dir`` also
    write ``result_<arm>.json`` there and print the marker-delimited JSON.
    ``sequence_parallel``, ``causal`` and ``ring_zigzag`` as for
    :func:`build_run`."""
    if steps <= warmup_steps:
        raise ValueError(f"steps={steps} leaves no timed step after warmup_steps={warmup_steps}")
    t_start = time.perf_counter()
    run = build_run(strategy=strategy, tier=tier, seq_len=seq_len, model_family=model_family,
                    per_device_batch=per_device_batch, grad_accum=grad_accum,
                    attention_impl=attention_impl, dropout=dropout,
                    sequence_parallel=sequence_parallel, causal=causal,
                    ring_zigzag=ring_zigzag, seed=seed, device=device)
    dev, cfg, strat, model, table, step_fn = (
        run.device, run.config, run.strategy, run.model, run.table, run.step_fn)
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
            if s >= warmup_steps:
                timed_times.append(dt)
                timed_losses.append(lf)
            if s % LOG_EVERY == 0:
                print(f"[Step {s:04d}] Loss: {lf:.4f}, Time: {dt:.3f}s")
        phase["timed" if pending[0][0] >= warmup_steps else "warmup"] += now - t_window
        pending.clear()
        t_window = now

    for step in range(steps):
        pending.append((step, step_fn(table, step)))
        if len(pending) >= sync_every or step == warmup_steps - 1 or step == steps - 1:
            sync_window()

    peak_gb, peak_method = metrics_mod.measure_peak_memory(dev)
    result = metrics_mod.compute_result(
        strategy=strat.name, world_size=1, seq_len=seq_len, tier=tier, steps=steps,
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
    if results_dir is not None:
        metrics_mod.emit_result(result, results_dir)
    return result
