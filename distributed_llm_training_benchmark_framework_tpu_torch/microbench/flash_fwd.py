"""Head-dim-64 attention-forward microbench on one card: the port of
``scripts/microbench_flash_fwd.py``.

    python -m distributed_llm_training_benchmark_framework_tpu_torch.microbench.flash_fwd \\
        [--bh 16 --seq 2048 --dim 64 --reps 25 --device cuda]

Times, by default at the tier-A attention block (BH 16, S 2048, Dh 64, bf16):

  matmul_floor       K8, the two products alone, no softmax
  flash_current      K5, the softmax forward
  flash_headpair     K6, K5 with two heads per CTA
  flash_kt           K7, K5 with k given as (BH, Dh, S)
  flash_qscaled      K9, K5 with the scale folded into q
  flash_production   K1 through ``ops.flash_attention`` (rate 0, non-causal):
                     the forward the training rows run
  sdpa_materialized  the plain reference: fp32 scores, softmax, bf16 p·v
  torch_sdpa         torch's scaled_dot_product_attention, a yardstick that
                     no path of the port calls

K5-K9 run K1's Hopper wgmma mainloop (``csrc/flash_fwd_sm90.cuh``), so
the layouts are measured against ``flash_production``, the same design, and
``matmul_floor`` (K8, the loop's matmul-only instance) against
``flash_current`` sets one design's products beside its softmax.

Each line gives the time in ms (CUDA events around each launch, median of
``--reps`` after 5 warmup launches), its share of the card's bf16 peak for
4·BH·S²·Dh FLOPs (``utils/flops.py``), and max |Δ| against
``sdpa_materialized`` (``matmul_floor`` computes another function: against
its own plain version). The first line is the card's name and power limit
from nvidia-smi.

With ``--device cpu`` the wrappers get CPU tensors and so run the plain
versions; every time and share then reads "not measured". Without a card
and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
from typing import Callable, List

import numpy as np
import torch

from ..ops import flash_attention as fa
from ..ops import fwd_variants as fv
from ..utils import flops, platform

WARMUP = 5
NOT_MEASURED = "not measured"


def median_ms(fn: Callable[[], object], reps: int, warmup: int = WARMUP) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def make_inputs(BH: int, S: int, D: int, device: torch.device, seed: int = 0):
    """q, k, v as the JAX microbench makes them: float64 numpy standard
    normals from ``seed``, drawn in that order, rounded to bf16."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((BH, S, D)))
            .to(device=device, dtype=torch.bfloat16) for _ in range(3)]


def variants(q, k, v):
    """(name, wrapper's launch-count key or None, fn, reference key) per line."""
    kt = k.transpose(1, 2).contiguous()
    q4, k4, v4 = (t.transpose(0, 1).unsqueeze(0) for t in (q, k, v))  # (1, S, BH, Dh)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return [
        ("matmul_floor", "fwd_matmul_only", lambda: fv.fwd_matmul_only(q, k, v), "plain"),
        ("flash_current", "fwd_current", lambda: fv.fwd_current(q, k, v), "sdpa"),
        ("flash_headpair", "fwd_headpair", lambda: fv.fwd_headpair(q, k, v), "sdpa"),
        ("flash_kt", "fwd_kt", lambda: fv.fwd_kt(q, kt, v), "sdpa"),
        ("flash_qscaled", "fwd_qscaled", lambda: fv.fwd_qscaled(q, k, v), "sdpa"),
        ("flash_production", "flash_fwd",
         lambda: fa.flash_attention(q4, k4, v4)[0].transpose(0, 1), "sdpa"),
        ("sdpa_materialized", None, lambda: fv.sdpa_materialized_plain(q, k, v), "sdpa"),
        ("torch_sdpa", None, lambda: sdpa(q[None], k[None], v[None])[0], "sdpa"),
    ]


def run(BH: int, S: int, D: int, reps: int, device: torch.device) -> List[dict]:
    """One row per variant: ``ms`` and ``pct_peak`` (None off the card),
    ``max_abs`` against its reference, and ``launches``, the launches the
    row made of its kernel (``kernel``; none off the card)."""
    q, k, v = make_inputs(BH, S, D, device)
    refs = {"sdpa": fv.sdpa_materialized_plain(q, k, v),
            "plain": fv.fwd_matmul_only_plain(q, k, v)}
    on_card = device.type == "cuda"
    peak = flops.device_peak_tflops(platform.device_kind(device))
    work = 4 * BH * S * S * D
    rows = []
    for name, kernel, fn, ref in variants(q, k, v):
        ms = median_ms(fn, reps) if on_card else None
        out = fn()
        rows.append(dict(
            name=name, kernel=kernel, ms=ms,
            pct_peak=None if ms is None or not peak else 100 * work / (ms * 1e-3) / (peak * 1e12),
            max_abs=(out.float() - refs[ref].float()).abs().max().item(),
            ref="sdpa_materialized" if ref == "sdpa" else "its plain version",
            launches=(WARMUP + reps + 1) if on_card else 0,
        ))
    return rows


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distributed_llm_training_benchmark_framework_tpu_torch.microbench.flash_fwd")
    p.add_argument("--bh", type=int, default=16)
    p.add_argument("--seq", type=int, default=2048)
    p.add_argument("--dim", type=int, default=64, choices=fa.HEAD_DIMS)
    p.add_argument("--reps", type=int, default=25)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def main(argv=None) -> List[dict]:
    """Print the table (see the module docstring) and return its rows."""
    ap = build_parser()
    args = ap.parse_args(argv)
    BH, S, D = args.bh, args.seq, args.dim
    if S % fa.TILE:
        ap.error(f"--seq must be a multiple of the kernels' tile, {fa.TILE} (got {S})")
    if BH % 2:
        ap.error(f"--bh must be even for the headpair variant (got {BH})")
    device = platform.resolve_device(args.device)
    kind = platform.device_kind(device)
    print(nvidia_smi_line() if device.type == "cuda" else "device cpu: no card, no nvidia-smi line")
    peak = flops.device_peak_tflops(kind)
    gflop = 4 * BH * S * S * D / 1e9
    print(f"shapes BH={BH} S={S} Dh={D} bf16 on {kind}, {gflop:.3f} GFLOP; " + (
        f"no bf16 peak known for {kind}" if not peak else
        f"bf16 peak {peak:.0f} TFLOP/s, tensor bound {gflop / peak:.5f} ms"))
    rows = run(BH, S, D, args.reps, device)
    for r in rows:
        ms = f"time {NOT_MEASURED}" if r["ms"] is None else f"{r['ms']:9.5f} ms"
        pct = (f"share of peak {NOT_MEASURED}" if r["pct_peak"] is None
               else f"{r['pct_peak']:5.1f}% of bf16 peak")
        print(f"{r['name']:18s} {ms}  {pct}  max|Δ| vs {r['ref']} {r['max_abs']:.3e}",
              flush=True)
    return rows


if __name__ == "__main__":
    main()
