"""Headline benchmark of the port: the parity row plus the flagship llama row.

    python -m distributed_llm_training_benchmark_framework_tpu_torch.bench

Prints exactly ONE JSON line on stdout, the contract of the repo-root
``bench.py``: ``metric`` (``{family}_tier{T}_seq{S}_tokens_per_sec_per_chip``),
``value``, ``unit``, ``vs_baseline`` (against the reference's best published
per-GPU throughput, DeepSpeed ZeRO-2 on 4x A10: 18,147 / 4 = 4,536.75
tokens/s/GPU), the visibility keys ``attention_impl``, ``dropout``,
``mfu_pct``, ``peak_hbm_gb``, ``peak_hbm_method``, ``device_kind``, and a
``"flagship"`` sub-object: the llama family at per-device batch 2 x
grad-accum 2 with flash attention and its native dropout 0. Progress goes
to stderr.

Both rows use the zero2 recipe and flash attention; the parity row runs
per-device batch 1 x grad-accum 4 with the family's dropout 0.1. Runs on the
CUDA device unless ``--device cpu`` is given; with no GPU and no
``--device cpu`` it fails rather than fall back. The graftcheck preflight,
``--remat-sweep`` and the regress registry of the JAX bench are not part of
the port yet; it writes to no registry.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from .train.loop import run_benchmark

REFERENCE_BEST_TOKENS_PER_SEC_PER_GPU = 18147.0 / 4

STRATEGY = "zero2"
PARITY_PER_DEVICE_BATCH = 1
PARITY_GRAD_ACCUM = 4
SYNC_EVERY = 10

FLAGSHIP_FAMILY = "llama"
FLAGSHIP_PER_DEVICE_BATCH = 2
FLAGSHIP_GRAD_ACCUM = 2
FLAGSHIP_LAYER_LOOP = "unrolled"  # eager PyTorch runs the layers as a Python loop


def measure_row(args, *, model_family: str, per_device_batch: int, grad_accum: int) -> dict:
    """Run one arm and return its contract-shaped row."""
    with contextlib.redirect_stdout(sys.stderr):
        result = run_benchmark(
            strategy=STRATEGY, tier=args.tier, seq_len=args.seq_len,
            model_family=model_family, steps=args.steps, warmup_steps=args.warmup_steps,
            per_device_batch=per_device_batch, grad_accum=grad_accum,
            attention_impl="flash", sync_every=SYNC_EVERY, device=args.device,
        )
    per_chip = result.tokens_per_sec / result.world_size
    return {
        "metric": f"{model_family}_tier{args.tier}_seq{args.seq_len}_tokens_per_sec_per_chip",
        "value": round(per_chip, 2),
        "unit": "tokens/sec/chip",
        "vs_baseline": round(per_chip / REFERENCE_BEST_TOKENS_PER_SEC_PER_GPU, 3),
        "attention_impl": result.attention_impl,
        "dropout": result.dropout,
        "model_tflops_per_sec_per_chip": round(result.model_tflops_per_sec_per_chip, 2),
        "mfu_pct": round(result.mfu_pct, 2),
        "peak_hbm_gb": round(result.peak_hbm_gb, 2),
        "peak_hbm_method": result.peak_hbm_method,
        "device_kind": result.device_kind,
        "mean_step_time_sec": round(result.mean_step_time_sec, 5),
        "loss_first_window": round(result.loss_first_window, 4),
        "loss_last_window": round(result.loss_last_window, 4),
        "wall_time_total_sec": round(result.wall_time_total_sec, 2),
        "time_in_timed_sec": round(result.time_in_timed_sec, 2),
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m distributed_llm_training_benchmark_framework_tpu_torch.bench")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--tier", default="A")
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--warmup-steps", type=int, default=5)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    payload = measure_row(args, model_family="tinygpt",
                          per_device_batch=PARITY_PER_DEVICE_BATCH, grad_accum=PARITY_GRAD_ACCUM)
    payload["flagship"] = {
        **measure_row(args, model_family=FLAGSHIP_FAMILY,
                      per_device_batch=FLAGSHIP_PER_DEVICE_BATCH, grad_accum=FLAGSHIP_GRAD_ACCUM),
        "model_family": FLAGSHIP_FAMILY,
        "strategy": STRATEGY,
        "tier": args.tier,
        "seq_len": args.seq_len,
        "per_device_batch": FLAGSHIP_PER_DEVICE_BATCH,
        "grad_accum": FLAGSHIP_GRAD_ACCUM,
        "layer_loop": FLAGSHIP_LAYER_LOOP,
    }
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
