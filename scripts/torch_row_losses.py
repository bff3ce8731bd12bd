#!/usr/bin/env python3
"""Every step's loss of the port's training rows, at full precision, from a
given source tree: whether a change kept a row's numerics bit for bit.

    python3 scripts/torch_row_losses.py [--tree DIR] [--rows parity flagship ...]
                                        [--steps 13] [--out build/row_losses.json]

``--tree`` is the root of a checkout whose package is imported (default:
this script's own repo), so one call compares two trees on one card:
``--tree build/parent`` for a ``git archive`` of the parent unpacked there.
Each row is ``scripts/torch_step_profile.py``'s, trained through
``train.loop.run_benchmark`` with its defaults (seed 42, zero2, no process
group) for ``--steps`` steps (the first 3 untimed), every step's loss
logged (``loss_log``). Prints the card's name and power limit and one JSON
object ``{row: [loss, ...]}``, and writes it to ``--out``. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from torch_step_profile import ROWS  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--tree", default=os.path.dirname(HERE))
    p.add_argument("--rows", nargs="*", default=list(ROWS), choices=list(ROWS))
    p.add_argument("--steps", type=int, default=13)
    p.add_argument("--out", default="build/row_losses.json")
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        print("torch_row_losses: needs a CUDA device", file=sys.stderr)
        return 2
    from distributed_llm_training_benchmark_framework_tpu_torch.train import run_benchmark

    torch.backends.cuda.matmul.allow_tf32 = False
    losses = {}
    for name in args.rows:
        log: list = []
        run_benchmark(tier="A", steps=args.steps, warmup_steps=3, sync_every=5, device="cuda",
                      loss_log=log, **ROWS[name])
        losses[name] = log
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"tree": os.path.abspath(args.tree), "losses": losses}, f, indent=2)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    print(json.dumps(losses))
    return 0


if __name__ == "__main__":
    sys.exit(main())
