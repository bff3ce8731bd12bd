#!/usr/bin/env python3
"""Where one training step of the PyTorch port spends its time on the card.

    python3 scripts/torch_step_profile.py [--rows parity flagship parity_ring flagship_ring
                                                  parity_ulysses flagship_ulysses
                                                  parity_s8192 flagship_s8192 moe moe_bf16
                                                  parity_pd2 flagship_dots flagship_full]
                                          [--arms ddp fsdp zero2 zero3]
                                          [--steps 3]
                                          [--out chiprun_out/torch_step_profile.json]

For each row (parity: TinyGPT tier A b1 x accum 4, dropout 0.1; flagship:
Llama tier A b2 x accum 2; both S 2048, zero2, flash attention; and the
sequence-parallel rows parity_ring: TinyGPT b1 x accum 1, dropout 0.1 and
flagship_ring: Llama b1 x accum 2, both S 8192 over 4 ring shards on the
one card, parity_ulysses / flagship_ulysses, the same geometry over 4
Ulysses head groups, and parity_s8192 / flagship_s8192, the same geometry
through flash attention with no sequence shards: the work Ulysses does
around the same kernels, in one process, is the difference; and moe /
moe_bf16: the parity row with 8 experts, top-2, capacity 1.25, the 1.18B
MoE model, at fp32 and bf16 parameters; parity_pd2: the parity row at b2 x
accum 2, two rows a micro-batch, each drawing its own dropout masks;
flagship_dots / flagship_full: the flagship under remat dots / full)
it builds the run exactly as ``train.loop.run_benchmark`` does, takes 3
warmup steps, times ``--steps`` steps on the host clock (synchronised), and
profiles the same number of steps with ``torch.profiler``. It reports, per
step: the wall time, the device-busy time (sum of kernel, memcpy and memset
time on the card), the idle share (1 - busy / unprofiled wall), the device time by
class (``analysis.profile_summary.op_class``: each hand kernel by name, the
ring's backward pair being the flash pair in its fp32 mode; GEMMs; NCCL
collectives by JAX's class names; memcpy; memset; everything else) and the
ten longest kernels. The rows run without a process group, as the bench
does on one card. ``--arms`` then profiles the parity row once more under
each named strategy arm inside a single-rank NCCL group
(``runtime.setup_distributed``), where the arm wraps the model (rows
``parity:<arm>+group``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import socket
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

ROWS = {
    "parity": dict(model_family="tinygpt", per_device_batch=1, grad_accum=4, seq_len=2048),
    "flagship": dict(model_family="llama", per_device_batch=2, grad_accum=2, seq_len=2048),
    "parity_ring": dict(model_family="tinygpt", per_device_batch=1, grad_accum=1,
                        seq_len=8192, attention_impl="ring", sequence_parallel=4),
    "flagship_ring": dict(model_family="llama", per_device_batch=1, grad_accum=2,
                          seq_len=8192, attention_impl="ring", sequence_parallel=4),
    "parity_ulysses": dict(model_family="tinygpt", per_device_batch=1, grad_accum=1,
                           seq_len=8192, attention_impl="ulysses", sequence_parallel=4),
    "flagship_ulysses": dict(model_family="llama", per_device_batch=1, grad_accum=2,
                             seq_len=8192, attention_impl="ulysses", sequence_parallel=4),
    "parity_s8192": dict(model_family="tinygpt", per_device_batch=1, grad_accum=1,
                         seq_len=8192),
    "flagship_s8192": dict(model_family="llama", per_device_batch=1, grad_accum=2,
                           seq_len=8192),
    "moe": dict(model_family="tinygpt", per_device_batch=1, grad_accum=4, seq_len=2048,
                n_experts=8),
    "moe_bf16": dict(model_family="tinygpt", per_device_batch=1, grad_accum=4, seq_len=2048,
                     n_experts=8, param_dtype="bf16"),
    "parity_pd2": dict(model_family="tinygpt", per_device_batch=2, grad_accum=2, seq_len=2048),
    "flagship_dots": dict(model_family="llama", per_device_batch=2, grad_accum=2, seq_len=2048,
                          remat="dots"),
    "flagship_full": dict(model_family="llama", per_device_batch=2, grad_accum=2, seq_len=2048,
                          remat="full"),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def kernel_class(name: str) -> str:
    """The device op's class, by the package's ``op_class``, so that this
    script and a row's step anatomy cannot disagree on a class."""
    from distributed_llm_training_benchmark_framework_tpu_torch.analysis.profile_summary import (
        op_class,
    )

    return op_class(name)


def device_events(prof):
    """(name, device microseconds) of every kernel, memcpy and memset that ran
    on the card; ranges that only annotate the device timeline (such as
    ``Optimizer.step#AdamW.step``) are left out, so nothing counts twice."""
    out = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(e, "is_user_annotation", False) or e.name.startswith("Optimizer."):
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        out.append((e.name, us))
    return out


def profile_row(name: str, steps: int, strategy: str = "zero2") -> dict:
    import dataclasses

    from distributed_llm_training_benchmark_framework_tpu_torch.parallel import get_strategy
    from distributed_llm_training_benchmark_framework_tpu_torch.train.loop import build_run

    row = dict(ROWS[name])
    arm = get_strategy(strategy)
    arm = dataclasses.replace(arm, param_dtype=row.pop("param_dtype", "f32"),
                              remat=row.pop("remat", arm.remat))
    run = build_run(tier="A", device="cuda", strategy=arm, **row)
    step = 0
    for _ in range(3):
        run.step_fn(run.table, step).item()
        step += 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        run.step_fn(run.table, step)
        step += 1
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        for _ in range(steps):
            run.step_fn(run.table, step)
            step += 1
        torch.cuda.synchronize()
        prof_wall_ms = 1e3 * (time.perf_counter() - t1) / steps
    events = device_events(prof)
    by_class = defaultdict(float)
    by_kernel = defaultdict(lambda: [0.0, 0])
    for kname, us in events:
        by_class[kernel_class(kname)] += us / 1e3 / steps
        by_kernel[kname][0] += us / 1e3 / steps
        by_kernel[kname][1] += 1
    busy = sum(by_class.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "row": name,
        "strategy": strategy,
        "remat": run.strategy.remat,
        "world_size": run.mesh.size("data"),
        **ROWS[name],
        "steps_timed": steps,
        "wall_ms_per_step": wall_ms,
        "profiled_wall_ms_per_step": prof_wall_ms,
        "device_busy_ms_per_step": busy if events else None,
        # Against the unprofiled wall: the profiler's own host cost stretches
        # the profiled steps, which would inflate the idle share.
        "idle_share": (1.0 - busy / wall_ms) if events else None,
        "idle_share_profiled": (1.0 - busy / prof_wall_ms) if events else None,
        "device_ms_per_step_by_class": dict(by_class),
        "kernel_launches_per_step": len(events) / steps,
        # Every device operation's count per step, by name: two trees'
        # operations compare name by name.
        "calls_per_step_by_kernel": {k[:160]: v[1] / steps for k, v in sorted(by_kernel.items())},
        "top_kernels": [
            {"name": k[:120], "ms_per_step": v[0], "calls_per_step": v[1] / steps}
            for k, v in top
        ],
    }


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rows", nargs="*", default=list(ROWS), choices=list(ROWS))
    p.add_argument("--arms", nargs="*", default=[], choices=["ddp", "fsdp", "zero2", "zero3"])
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--out", default="chiprun_out/torch_step_profile.json")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_step_profile: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    from distributed_llm_training_benchmark_framework_tpu_torch.runtime import distributed as rt

    report = {"card": smi, "torch": torch.__version__, "rows": []}
    todo = [(name, "zero2") for name in args.rows] + [("parity", arm) for arm in args.arms]
    for i, (name, strategy) in enumerate(todo):
        if i == len(args.rows):
            assert rt.setup_distributed(num_processes=1, process_id=0,
                                        master_port=_free_port())
        r = profile_row(name, args.steps, strategy)
        if i >= len(args.rows):
            r["row"] = name = f"{name}:{strategy}+group"
        report["rows"].append(r)
        print(f"{name}: wall {r['wall_ms_per_step']:.2f} ms/step (profiled "
              f"{r['profiled_wall_ms_per_step']:.2f}), device busy "
              f"{r['device_busy_ms_per_step']} ms, idle share {r['idle_share']}, "
              f"{r['kernel_launches_per_step']:.0f} device ops/step", flush=True)
        print("  by class (ms/step): " + json.dumps(
            {k: round(v, 3) for k, v in r["device_ms_per_step_by_class"].items()}), flush=True)
        for k in r["top_kernels"]:
            print(f"    {k['ms_per_step']:9.3f} ms  x{k['calls_per_step']:.0f}  {k['name']}")
        gc.collect()
        torch.cuda.empty_cache()
    if args.arms:
        rt.cleanup_distributed()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(smi)
    print(json.dumps({k: v for k, v in report.items() if k != "rows"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
