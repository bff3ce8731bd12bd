#!/usr/bin/env python3
"""How the host-offload arm's intra-op thread count moves the parity row.

    python3 scripts/torch_offload_threads.py [--threads 8 7 6 4] [--rounds 2]
                                             [--out build/offload_threads.json]

The parity row (TinyGPT tier A, S 2048, b1 x accum 4, zero2, dropout 0.1,
3 warmup + 10 timed steps through ``run_benchmark``) at ``param_dtype``
bf16 (no host work: the device-only yardstick), then under the serial and
the delayed offload arm at each thread count of ``--threads``
(the host update's fused AdamW and its copies run on these threads: the
serial arm's through ``torch.set_num_threads``, the delayed worker's
through ``HostOffload.worker_threads``, set here on every instance in
place of its default of all cores but two; the step's dispatch thread runs
no intra-op work), in ``--rounds`` rounds, each round in the reverse order
of the one before.
Prints per run: tokens/s, step ms, the host update's ms, the time the step
waited for the delayed worker, and the copies' ms (medians over the timed
steps, ``parallel/offload.HostOffload.stats``); then the card's name and
power limit, and writes every run to ``--out``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from distributed_llm_training_benchmark_framework_tpu_torch.parallel import (  # noqa: E402
    get_strategy,
    offload,
)
from distributed_llm_training_benchmark_framework_tpu_torch.train import run_benchmark  # noqa: E402

WARMUP, TIMED = 3, 10
WAYS = {
    "bf16": dict(param_dtype="bf16"),
    "serial": dict(offload_opt_state=True),
    "delayed": dict(offload_opt_state=True, offload_delayed_update=True),
}


def one(way: str, threads: int) -> dict:
    torch.set_num_threads(threads)
    init = offload.HostOffload.__init__

    def with_threads(self, *args, **kw):
        init(self, *args, **kw)
        self.worker_threads = threads

    offload.HostOffload.__init__ = with_threads
    stats: dict = {}
    try:
        res = run_benchmark(strategy=dataclasses.replace(get_strategy("zero2"), **WAYS[way]),
                            tier="A", seq_len=2048, steps=WARMUP + TIMED, warmup_steps=WARMUP,
                            per_device_batch=1, grad_accum=4, attention_impl="flash",
                            sync_every=5, device="cuda", offload_log=stats)
    finally:
        offload.HostOffload.__init__ = init
    med = lambda key: statistics.median(stats[key][-TIMED:]) if stats.get(key) else None
    out = dict(way=way, threads=threads, tokens_per_sec=res.tokens_per_sec,
               step_ms=1e3 * res.mean_step_time_sec, host_update_ms=med("host_update_ms"),
               wait_ms=med("wait_ms"), d2h_ms=med("d2h_ms"), h2d_ms=med("h2d_ms"))
    print(json.dumps(out), flush=True)
    torch.cuda.empty_cache()
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--threads", type=int, nargs="*", default=[8, 7, 6, 4])
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--out", default="build/offload_threads.json")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_offload_threads: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cores = os.cpu_count()
    runs = [one("bf16", cores)]  # also builds the kernels
    order = [(way, n) for n in args.threads for way in ("serial", "delayed")]
    for r in range(args.rounds):
        runs.append(one("bf16", cores))
        for way, n in (order if r % 2 == 0 else order[::-1]):
            runs.append(one(way, n))
    torch.set_num_threads(cores)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{cores} cores; {smi}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": smi, "cores": cores, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
