"""Headline benchmark of the port: the parity row plus the flagship llama row.

    python -m distributed_llm_training_benchmark_framework_tpu_torch.bench [--strategy ARM] ...
    torchrun --nproc_per_node N -m distributed_llm_training_benchmark_framework_tpu_torch.bench ...

Prints exactly ONE JSON line on stdout (rank 0), the contract of the
repo-root ``bench.py``: ``metric`` (``{family}_tier{T}_seq{S}_tokens_per_sec_per_chip``),
``value``, ``unit``, ``vs_baseline`` (against the reference's best published
per-GPU throughput, DeepSpeed ZeRO-2 on 4x A10: 18,147 / 4 = 4,536.75
tokens/s/GPU), the visibility keys ``attention_impl``, ``dropout``,
``mfu_pct``, ``peak_hbm_gb``, ``peak_hbm_method``, ``device_kind``, and a
``"flagship"`` sub-object: the llama family at per-device batch 2 x
grad-accum 2 with flash attention and its native dropout 0. Progress goes
to stderr.

The flags are the JAX bench's (``bench.py:250-266``) that have a consumer
here, with its defaults: ``--strategy`` (zero2), ``--per-device-batch`` (1),
``--grad-accum`` (4), ``--world-size`` (the process group's size: one card
per process, 1 without a launcher; another value is refused),
``--model-family``, ``--flagship auto|on|off`` (auto: the flagship row
runs when the top row is tinygpt), ``--attention``, ``--dropout`` (the
family's own by default), ``--sync-every`` and ``--tp-collective-matmul``
(the tensor-parallel projections as collective matmuls: inert without a
``model`` axis, and stamped on both rows when given, as JAX's bench does).
Like the JAX bench, it has no parameter-dtype or host-offload flag (those
arms run through ``run_benchmark``'s strategy) and no sequence- or
tensor-parallel width flag, so
``--attention ulysses`` runs at ``seq`` width 1, where Ulysses is flash
attention bit for bit, and every run is at ``model`` width 1. The flagship
row pins flash, the family's dropout and its b2 x accum 2, under the same
strategy. Under a launcher (torchrun's
``WORLD_SIZE``, or the JAX package's ``NUM_PROCESSES``) the bench joins the
process group (``runtime.setup_distributed``: NCCL, or gloo with
``--device cpu``) and every arm lays its model out over it.

Runs on the CUDA device unless ``--device cpu`` is given; with no GPU and no
``--device cpu`` it fails rather than fall back. The graftcheck preflight,
``--layer-loop``, ``--profile-dir``, ``--remat-sweep`` and the regress
registry of the JAX bench are not part of the port yet; it writes to no
registry.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from .models import MODEL_FAMILIES
from .parallel.strategies import STRATEGIES
from .runtime import distributed as dist_rt
from .train.loop import run_benchmark

REFERENCE_BEST_TOKENS_PER_SEC_PER_GPU = 18147.0 / 4

FLAGSHIP_FAMILY = "llama"
FLAGSHIP_PER_DEVICE_BATCH = 2
FLAGSHIP_GRAD_ACCUM = 2
FLAGSHIP_LAYER_LOOP = "unrolled"  # eager PyTorch runs the layers as a Python loop


def measure_row(args, *, model_family: str, per_device_batch: int, grad_accum: int,
                attention_impl: str, dropout):
    """Run one arm; return its contract-shaped row and the result row it
    was made from."""
    with contextlib.redirect_stdout(sys.stderr):
        result = run_benchmark(
            strategy=args.strategy, tier=args.tier, seq_len=args.seq_len,
            model_family=model_family, steps=args.steps, warmup_steps=args.warmup_steps,
            per_device_batch=per_device_batch, grad_accum=grad_accum,
            attention_impl=attention_impl, dropout=dropout, sync_every=args.sync_every,
            device=args.device, world_size=args.world_size,
            tp_collective_matmul=args.tp_collective_matmul,
        )
    per_chip = result.tokens_per_sec / result.world_size
    extra = {"tp_collective_matmul": True} if result.tp_collective_matmul else {}
    return result, {
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
        **extra,
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m distributed_llm_training_benchmark_framework_tpu_torch.bench")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--tier", default="A")
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--warmup-steps", type=int, default=5)
    p.add_argument("--strategy", default="zero2", choices=sorted(STRATEGIES))
    p.add_argument("--per-device-batch", type=int, default=1)
    p.add_argument("--grad-accum", type=int, default=4)
    p.add_argument("--world-size", type=int, default=None,
                   help="default: the process group's size (1 without a launcher)")
    p.add_argument("--model-family", default="tinygpt", choices=list(MODEL_FAMILIES))
    p.add_argument("--flagship", default="auto", choices=["auto", "on", "off"])
    p.add_argument("--attention", default="flash",
                   choices=["reference", "flash", "ring", "ulysses"])
    p.add_argument("--dropout", type=float, default=None)
    p.add_argument("--sync-every", type=int, default=10)
    p.add_argument("--tp-collective-matmul", action="store_true",
                   help="run the tensor-parallel projections as collective matmuls (needs a "
                        ">1 'model' axis to have any effect)")
    return p


def main(argv=None):
    """Run the rows and print the line (rank 0); returns the result rows
    the line was made from."""
    args = build_parser().parse_args(argv)
    made_group = dist_rt.setup_distributed(device=args.device)
    try:
        top, payload = measure_row(args, model_family=args.model_family,
                                   per_device_batch=args.per_device_batch,
                                   grad_accum=args.grad_accum, attention_impl=args.attention,
                                   dropout=args.dropout)
        results = [top]
        if args.flagship == "on" or (args.flagship == "auto"
                                     and args.model_family != FLAGSHIP_FAMILY):
            flagship, row = measure_row(args, model_family=FLAGSHIP_FAMILY,
                                        per_device_batch=FLAGSHIP_PER_DEVICE_BATCH,
                                        grad_accum=FLAGSHIP_GRAD_ACCUM, attention_impl="flash",
                                        dropout=None)
            results.append(flagship)
            payload["flagship"] = {
                **row,
                "model_family": FLAGSHIP_FAMILY,
                "strategy": args.strategy,
                "tier": args.tier,
                "seq_len": args.seq_len,
                "per_device_batch": FLAGSHIP_PER_DEVICE_BATCH,
                "grad_accum": FLAGSHIP_GRAD_ACCUM,
                "layer_loop": FLAGSHIP_LAYER_LOOP,
            }
        if dist_rt.is_main_process():
            print(json.dumps(payload))
        return results
    finally:
        if made_group:
            dist_rt.cleanup_distributed()


if __name__ == "__main__":
    main()
